"""The port's DROID trajectories (`vjepa2_tpu_torch/data/droid.py`) and the
`DroidTrainer` from disk (`train/droid_loop.py`) against the JAX package's
on the same files and seeds.

The files are written in ``tmp_path``: each trajectory directory holds a
``trajectory.h5`` (h5py: the robot state and each camera's extrinsics), a
metadata ``.json`` naming the two views under ``recordings/MP4/`` and the
two mp4 recordings (cv2, 15 fps); a space-delimited CSV lists the
directories. Checked: `poses_to_diffs` and `transform_to_camera_frame`
within 1e-12; samples bit-equal (clips, actions, states, extrinsics,
indices) at ``camera_frame`` False and True; `droid_collate`; the loader at
0 spawned workers against JAX's, at 2 against the same dataset drawing in
process from each worker's stream; h5py named when it is missing; the
trainer's first 3 losses from disk on `tests/test_torch_droid_loop.py`'s
tiny AC config against JAX's `DroidTrainer` on JAX's own batches (rtol
1e-5, that file's). JAX's faults pinned (ROADMAP queue C): the metadata
``.json`` taken in `os.listdir` order, and every epoch replaying epoch 0.
"""

import builtins
import json
import os

import numpy as np
import pytest
import torch
import yaml

import test_torch_droid_loop as droid_loop_tests
from test_torch_data_video import write_video
from vjepa2_tpu.core.config import PretrainConfig as JaxConfig
from vjepa2_tpu.data import droid as jdroid
from vjepa2_tpu.data import loader as jloader
from vjepa2_tpu.data import samplers as js
from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu.train import droid as jtrain
from vjepa2_tpu.train import droid_loop as jloop
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.data import droid as tdroid
from vjepa2_tpu_torch.data import loader as tloader
from vjepa2_tpu_torch.data import samplers as ts
from vjepa2_tpu_torch.data import transforms as tt
from vjepa2_tpu_torch.hub.converter import load_droid_state
from vjepa2_tpu_torch.train import droid_loop as loop

h5py = pytest.importorskip("h5py", reason="the trajectories are written with h5py")
pytest.importorskip("cv2", reason="the recordings are written with cv2")

CAMERAS = ("11111111", "22222222")
FRAMES, H, W, FPS = 40, 48, 64, 15.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_trajectory(root, name: str, seed: int, frames: int = FRAMES, h: int = H,
                     w: int = W, fps: float = FPS) -> str:
    """A DROID trajectory directory: ``trajectory.h5``, ``metadata_<name>.json``
    and one mp4 a camera."""
    path = os.path.join(str(root), name)
    os.makedirs(os.path.join(path, "recordings", "MP4"))
    rng = np.random.default_rng(seed)
    with h5py.File(os.path.join(path, "trajectory.h5"), "w") as f:
        state = f.create_group("observation/robot_state")
        xyz = np.cumsum(rng.normal(scale=0.01, size=(frames, 3)), axis=0)
        angles = rng.uniform(-np.pi, np.pi, size=(frames, 3))
        state["cartesian_position"] = np.concatenate([xyz, angles], axis=1)
        state["gripper_position"] = rng.uniform(0, 1, size=frames)
        extr = f.create_group("observation/camera_extrinsics")
        for cam in CAMERAS:
            for side in ("left", "right"):
                extr[f"{cam}_{side}"] = np.concatenate(
                    [rng.normal(size=(frames, 3)), rng.uniform(-np.pi, np.pi, (frames, 3))], 1)
    meta = {}
    for i, (view, cam) in enumerate(zip(("left_mp4_path", "right_mp4_path"), CAMERAS)):
        write_video(os.path.join(path, "recordings", "MP4", f"{cam}.mp4"), frames, h, w,
                    seed=seed * 10 + i, fps=fps)
        meta[view] = f"gs://droid/{name}/recordings/MP4/{cam}.mp4"
    with open(os.path.join(path, f"metadata_{name}.json"), "w") as f:
        json.dump(meta, f)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four trajectories, the third 50 frames long; ``paths.csv`` lists them
    twice (8 rows: 4 batches of 2)."""
    root = tmp_path_factory.mktemp("droid")
    dirs = [write_trajectory(root, f"traj{i}", seed=i, frames=50 if i == 2 else FRAMES)
            for i in range(4)]
    (root / "paths.csv").write_text("".join(f"{d}\n" for d in dirs * 2))
    return root


def _datasets(data, **kw):
    kw = dict(frames_per_clip=4, fps=4, frameskip=1, seed=3, **kw)
    return (tdroid.DROIDVideoDataset(str(data / "paths.csv"),
                                     transform=tt.VideoTransform(crop_size=32), **kw),
            jdroid.DROIDVideoDataset(str(data / "paths.csv"),
                                     transform=jt.VideoTransform(crop_size=32), **kw))


def test_poses_to_diffs_and_camera_frame_match_jax():
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.normal(size=(9, 3)), rng.uniform(-np.pi, np.pi, (9, 3)),
                            rng.uniform(0, 1, (9, 1))], axis=1)
    extr = np.concatenate([rng.normal(size=(9, 3)), rng.uniform(-np.pi, np.pi, (9, 3))], 1)
    np.testing.assert_allclose(tdroid.poses_to_diffs(poses), jdroid.poses_to_diffs(poses),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdroid.transform_to_camera_frame(poses, extr),
                               jdroid.transform_to_camera_frame(poses, extr), rtol=0, atol=1e-12)


@pytest.mark.parametrize("camera_frame", [False, True])
def test_samples_match_jax(data, camera_frame):
    """Each sample (the view, window and crop drawn from one stream, in
    JAX's order) bit-equal: 4 frames at 4 of the videos' 15 fps (a frame
    step of 4), clips [4, 32, 32, 3], actions [3, 7], states [4, 7]."""
    t, j = _datasets(data, camera_frame=camera_frame)
    assert t.samples == list(j.samples) and len(t) == 8
    for i in (0, 1, 2, 3, 2, 0):
        got, want = t[i], j[i]
        assert got[0].shape == (4, 32, 32, 3) and got[1].shape == (3, 7)
        assert got[2].shape == (4, 7) and got[3].shape == (4, 6)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert np.all(np.diff(got[4]) == 4)


def test_collate_matches_jax(data):
    t, j = _datasets(data)
    got = tdroid.droid_collate([t[i] for i in range(3)])
    want = jdroid.droid_collate([j[i] for i in range(3)])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_loader_zero_workers_matches_jax(data):
    t, j = _datasets(data)
    kw = dict(batch_size=2, num_workers=0, epoch_len=2)
    got = list(tloader.DataLoader(t, ts.DistributedSampler(8, 1, 0, seed=5),
                                  collate_fn=tdroid.droid_collate, **kw))
    want = list(jloader.DataLoader(j, js.DistributedSampler(8, 1, 0, seed=5),
                                   collate_fn=jdroid.droid_collate, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_loader_two_spawned_workers(data):
    """Two spawned workers, in the sampler's order: batch b from worker
    b % 2, whose dataset draws from ``SeedSequence([seed, rank, worker,
    epoch])``; the same batches drawn in process from those streams."""
    t, _ = _datasets(data)
    sampler = ts.DistributedSampler(8, 1, 0, seed=5)
    got = list(tloader.DataLoader(t, sampler, batch_size=1, num_workers=2, ordered=True,
                                  seed=7, epoch_len=4, collate_fn=tdroid.droid_collate))
    order = list(sampler)
    streams = {w: np.random.default_rng([7, 0, w, 0]) for w in range(2)}
    assert len(got) == 4
    for b, batch in enumerate(got):
        t.rng = streams[b % 2]
        want = tdroid.droid_collate([t[order[b]]])
        for a, w in zip(batch, want):
            np.testing.assert_array_equal(a, w)


def test_without_h5py_the_dataset_names_it(data, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        tdroid.DROIDVideoDataset(str(data / "paths.csv"))


def test_metadata_json_jax_takes_listdir_order(tmp_path, monkeypatch):
    """A directory with two metadata files: the port reads the first in
    sorted order whatever `os.listdir` returns; JAX reads the first that
    `os.listdir` returns, which depends on the file system (ROADMAP queue C)."""
    path = write_trajectory(tmp_path, "traj", seed=0)
    with open(os.path.join(path, "a_metadata.json"), "w") as f:
        json.dump({"left_mp4_path": "a"}, f)
    listdir = os.listdir
    for order in (sorted, lambda names: sorted(names, reverse=True)):
        monkeypatch.setattr(os, "listdir", lambda p, order=order: order(listdir(p)))
        port = tdroid.DROIDVideoDataset.__new__(tdroid.DROIDVideoDataset)
        jax_ds = jdroid.DROIDVideoDataset.__new__(jdroid.DROIDVideoDataset)
        assert port._metadata(path) == {"left_mp4_path": "a"}
        jax_meta = jax_ds._metadata(path)
        assert (jax_meta == {"left_mp4_path": "a"}) == (order is sorted)


def _raw(folder, data, **overrides) -> dict:
    """`tests/test_torch_droid_loop.py`'s tiny AC config, reading ``paths.csv``
    (4 frames at 4 fps, batch 2, in process)."""
    return droid_loop_tests._raw(folder, {"data.datasets": [str(data / "paths.csv")],
                                          "data.fps": 4, "data.num_workers": 0, **overrides})


def test_droid_epoch_replay_jax_replays_every_epoch(data, tmp_path):
    """JAX's `DroidTrainer.make_loader` builds the same loader every epoch,
    so every epoch draws epoch 0's order, views, windows and crops; the
    port's loader of epoch 1 draws its own (ROADMAP queue C)."""
    raw = _raw(tmp_path / "run", data)
    jtrainer = jloop.DroidTrainer(JaxConfig.from_dict(raw))
    jax_epochs = [list(jtrainer.make_loader()) for _ in range(2)]
    trainer = loop.DroidTrainer(PretrainConfig.from_dict(raw), device="cpu")
    port_epochs = [list(trainer.make_loader(e)) for e in range(2)]
    assert len(port_epochs[0]) == len(jax_epochs[0]) == droid_loop_tests.IPE
    for p, j in zip(port_epochs[0], jax_epochs[0]):  # epoch 0: JAX's batches
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a, b)
    same = lambda x, y: all(np.array_equal(a, b) for bx, by in zip(x, y)  # noqa: E731
                            for a, b in zip(bx, by))
    assert same(jax_epochs[0], jax_epochs[1])
    assert not same(port_epochs[0], port_epochs[1])


def test_first_losses_from_disk_match_jax(data, tmp_path, monkeypatch):
    """The `DroidTrainer` through `cli.main` on ``paths.csv``: the epoch's
    3 losses against JAX's `DroidTrainer` reading the same files (its own
    batches), from the same weights (rtol 1e-5)."""
    raw, jraw = _raw(tmp_path / "port", data), _raw(tmp_path / "jax", data)
    jtrainer = jloop.DroidTrainer(JaxConfig.from_dict(jraw))
    d = raw["data"]
    B, T, S = d["batch_size"], d["dataset_fpcs"][0], d["crop_size"]
    params, target, _ = jtrain.init_droid_params(
        jtrainer.encoder, jtrainer.predictor, raw["meta"]["seed"], (B, T, S, S, 3),
        train_encoder=jtrainer.hp.enc_lr_scale > 0)
    jax_losses = []
    jit_step = jloop.jit_droid_train_step

    def recording(step_fn, mesh, grad_accum=1):
        fn = jit_step(step_fn, mesh, grad_accum)

        def step(state, *batch):
            state, m = fn(state, *batch)
            jax_losses.append(float(m["loss"]))
            return state, m

        return step

    monkeypatch.setattr(jloop, "jit_droid_train_step", recording)
    jtrainer.run(epochs=1)

    init = loop.DroidTrainer.init_state
    monkeypatch.setattr(loop.DroidTrainer, "init_state",
                        lambda self: load_droid_state(init(self), params, target))
    steps = droid_loop_tests._Steps(monkeypatch)
    seen = []
    make = loop.DroidTrainer.make_loader
    monkeypatch.setattr(loop.DroidTrainer, "make_loader",
                        lambda self, epoch=0: seen.append(make(self, epoch)) or seen[-1])
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    droid_loop_tests._main(path, "--epochs", "1")
    assert isinstance(seen[0].dataset, tdroid.DROIDVideoDataset)
    assert len(steps.losses) == len(jax_losses) == droid_loop_tests.IPE
    np.testing.assert_allclose(steps.losses, jax_losses, rtol=1e-5)
