"""The port's `Pretrainer` reading video manifests from disk
(`vjepa2_tpu_torch/train/loop.py` `make_loader`, through `cli.main`) on the
shipped `configs/train/smoke-tiny.yaml` with ``data.datasets`` set to a CSV
of videos written with cv2: epoch 0's clips bit-equal to the batches of
JAX's own `Pretrainer.make_loader` on the same config, and the first 3
losses within `test_torch_loop.py::test_first_losses_match_jax`'s
tolerance of JAX's steps from the same weights; the uint8 route
(``normalize_on_device``) trains; a run preempted mid-epoch and resumed
through two spawned workers is bit-equal to an uninterrupted one, clip for
clip; and epoch 1 draws other clips than epoch 0 (JAX's replays epoch 0,
ROADMAP queue C)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_loop as tl
from test_torch_data_video import write_video
from vjepa2_tpu.core.config import PretrainConfig as JaxConfig
from vjepa2_tpu.masks.multiblock3d import MaskCollator as JaxCollator
from vjepa2_tpu.train import loop as jloop
from vjepa2_tpu.train import pretrain as jpre
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.core.provenance import PreemptionGuard
from vjepa2_tpu_torch.hub.converter import load_pretrain_state
from vjepa2_tpu_torch.train import loop

pytest.importorskip("cv2", reason="the test videos are written with cv2")
IPE = tl.IPE


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory) -> str:
    """Four 30 fps videos of 60-75 frames at 72 x 96, 12 rows with labels."""
    root = tmp_path_factory.mktemp("pretrain_data")
    paths = [write_video(root / f"v{i}.mp4", 60 + 5 * i, 72, 96, seed=i) for i in range(4)]
    out = root / "train.csv"
    out.write_text("".join(f"{p} {i % 5}\n" for i, p in enumerate(paths * 3)))
    return str(out)


def _raw(folder, manifest, overrides=None) -> dict:
    return tl._raw(folder, {"data.datasets": [manifest], **(overrides or {})})


def _write(tmp_path, name, manifest, overrides=None):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(_raw(tmp_path / name, manifest, overrides)))
    return path


def _jax_batches(raw) -> list:
    """JAX's `Pretrainer.make_loader` on the same config (its first epoch)."""
    trainer = types.SimpleNamespace(synthetic_data=False, cfg=JaxConfig.from_dict(raw),
                                    hp=types.SimpleNamespace(ipe=IPE))
    return list(jloop.Pretrainer.make_loader(trainer))


def test_first_losses_from_disk_match_jax(tmp_path, monkeypatch, manifest):
    raw = _raw(tmp_path / "run", manifest)
    d, m = raw["data"], raw["model"]
    fpc, bs = d["dataset_fpcs"][0], d["batch_size"]
    jenc, jpred = jpre.build_models(
        m["model_name"], crop_size=d["crop_size"], num_frames=fpc,
        pred_depth=m["pred_depth"], pred_embed_dim=m["pred_embed_dim"],
        pred_num_heads=m["pred_num_heads"], use_rope=True, num_mask_tokens=len(raw["mask"]),
        dtype=jnp.float32)
    jcoll = JaxCollator(raw["mask"], dataset_fpcs=[fpc], crop_size=(d["crop_size"],) * 2,
                        seed=raw["meta"]["seed"])
    jcoll.step()
    me0, mp0 = jcoll(fpc, bs)
    params, target = jpre.init_params(jenc, jpred, raw["meta"]["seed"],
                                      (bs, fpc, d["crop_size"], d["crop_size"], 3),
                                      jnp.asarray(me0[0]), jnp.asarray(mp0[0]))
    jbatches = _jax_batches(raw)  # JAX's side first, before the port's run

    init = loop.Pretrainer.init_state
    monkeypatch.setattr(loop.Pretrainer, "init_state",
                        lambda self: load_pretrain_state(init(self), params, target))
    steps = tl._Steps(monkeypatch)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    tl._main(path, "--epochs", "1")
    assert len(steps.losses) == IPE == len(jbatches)

    hp = tl._jax_hparams(raw)
    tx = jpre.make_optimizer(hp)
    state = JaxState.create(params, target, tx)
    step = jax.jit(jpre.make_train_step(jenc, jpred, tx, hp, mask_indices=[0, 1]))
    losses = []
    for (clips_list, _, _), (clips, me, mp) in zip(jbatches, steps.inputs):
        jcoll.step()
        jme, jmp = jcoll(fpc, bs)
        assert clips.dtype == torch.float32 and clips.shape == (bs, fpc, 64, 64, 3)
        assert np.array_equal(clips.numpy(), clips_list[0])  # the same clips from disk
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(me + mp, jme + jmp))
        state, metrics = step(state, jnp.asarray(clips_list[0]), tuple(map(jnp.asarray, jme)),
                              tuple(map(jnp.asarray, jmp)))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(steps.losses, losses, rtol=1e-5)


def test_uint8_clips_train_normalised_on_the_device(tmp_path, monkeypatch, manifest):
    """``normalize_on_device``: the loader's clips stay uint8 (JAX's batches
    bit-equal) and the step normalises them (`train.pretrain._device_normalize`)."""
    raw = _raw(tmp_path / "run", manifest, {"data.normalize_on_device": True})
    jbatches = _jax_batches(raw)
    steps = tl._Steps(monkeypatch)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    tl._main(path, "--epochs", "1")
    for (clips_list, _, _), (clips, _, _) in zip(jbatches, steps.inputs):
        assert clips.dtype == torch.uint8 and np.array_equal(clips.numpy(), clips_list[0])
    assert len(steps.losses) == IPE and np.isfinite(steps.losses).all()


def test_preempted_run_from_disk_resumes_bit_equal(tmp_path, monkeypatch, manifest):
    """Two spawned workers, preempted at step IPE + 1 (mid-epoch 1) and
    resumed: the resumed epoch skips the batches already trained and then
    sees the uninterrupted run's clips, step for step, and ends in its state.
    Epoch 1's clips are not epoch 0's."""
    over = {"meta.load_checkpoint": True, "data.num_workers": 2}
    path = _write(tmp_path, "run", manifest, over)
    guard = PreemptionGuard(install=False)
    steps = tl._Steps(monkeypatch, hook=lambda n, m: guard._handler() if n == IPE + 1 else None)
    cfg = PretrainConfig.from_dict(yaml.safe_load(path.read_text()))
    out = loop.Pretrainer(cfg, device="cpu").run(preemption_guard=guard)
    assert out["preempted"] and out["step"] == IPE + 1
    steps.hook = None
    out = loop.Pretrainer(cfg, device="cpu").run()
    assert not out["preempted"] and out["step"] == 2 * IPE
    resumed, resumed_inputs = steps.state, list(steps.inputs)
    steps.inputs.clear()
    tl._main(_write(tmp_path, "straight", manifest, over))
    tl._assert_bit_equal(resumed, steps.state)
    straight = steps.inputs
    assert len(straight) == 2 * IPE and len(resumed_inputs) == 2 * IPE
    for a, b in zip(resumed_inputs, straight):
        assert torch.equal(a[0], b[0])
    assert not any(torch.equal(straight[i][0], straight[IPE + i][0]) for i in range(IPE))
