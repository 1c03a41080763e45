"""The port's `VideoDataset` (`vjepa2_tpu_torch/data/video_dataset.py`) and
its transforms and augmentations against the JAX package's on the same
manifests and videos (written with cv2; both sides decode them with the
same backend): the samples, labels and ``clip_indices`` of space-delimited,
``::``-delimited (paths with spaces) and ``.npy`` manifests; the clips after
`VideoTransform` at one seed, bit-equal on the native crop (``use_native``)
and within `test_torch_transforms.py`'s tolerance on the numpy resize,
over ``fps``, ``frame_step``, ``duration``, one and two clips,
``allow_clip_overlap``, ``filter_short_videos``, fixed windows,
``normalize_on_device`` (uint8 clips) and the retry on a missing file;
RandAugment and random erasing under one seed; and three departures from
JAX, each named after JAX's fault (ROADMAP queue C): the ``::`` manifests
JAX misreads, every epoch replaying epoch 0, and spawned workers sharing one
random stream."""

import pickle

import numpy as np
import pytest
import torch

from test_torch_data_video import write_video
from test_torch_transforms import _close
from vjepa2_tpu.data import augment as jaug
from vjepa2_tpu.data import loader as jloader
from vjepa2_tpu.data import manager as jmanager
from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu.data import video_dataset as jvd
from vjepa2_tpu_torch.data import augment as taug
from vjepa2_tpu_torch.data import loader as tloader
from vjepa2_tpu_torch.data import manager as tmanager
from vjepa2_tpu_torch.data import transforms as tt
from vjepa2_tpu_torch.data import video_dataset as tvd

pytest.importorskip("cv2", reason="the test videos are written with cv2")

# (frames, height, width, fps): widths of 64 and 80 px (RGB rows a multiple of
# 16 bytes, see `test_torch_data_video.py::test_native_decoder_row_spill`)
VIDEOS = [(60, 48, 64, 30.0), (90, 40, 80, 24.0), (20, 48, 64, 30.0), (120, 48, 64, 30.0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four videos, and manifests naming them: a space CSV (8 rows, labels),
    a ``::`` CSV whose paths hold 1 and 2 spaces (copies of the videos), an
    ``.npy`` list, and a CSV with a missing file in its second row."""
    root = tmp_path_factory.mktemp("data")
    paths = [write_video(root / f"v{i}.mp4", f, h, w, seed=i, fps=fps)
             for i, (f, h, w, fps) in enumerate(VIDEOS)]
    spaced = []
    for i, name in enumerate(["my clip.mp4", "the long one.mp4"]):
        (root / name).write_bytes(open(paths[i], "rb").read())
        spaced.append(str(root / name))
    space = root / "space.csv"
    space.write_text("".join(f"{p} {i % 3}\n" for i, p in enumerate(paths * 2)))
    colons = root / "colons.csv"
    colons.write_text(f"{spaced[0]}::4\n{paths[3]}::7\n{spaced[1]}::1\n")
    npy = root / "list.npy"
    np.save(npy, np.asarray(paths[::-1]))
    missing = root / "missing.csv"
    missing.write_text(f"{paths[0]} 1\n{root / 'gone.mp4'} 2\n{paths[1]} 0\n{paths[3]} 1\n")
    return {"paths": paths, "space": str(space), "colons": str(colons), "npy": str(npy),
            "missing": str(missing), "root": root}


@pytest.mark.parametrize("manifest", ["space", "colons", "npy"])
def test_manifests_match_jax(data, manifest):
    got = tvd.VideoDataset([data[manifest]], frame_step=4)
    want = jvd.VideoDataset([data[manifest]], frame_step=4)
    assert got.samples == [str(s) for s in want.samples] and len(got.samples) > 2
    assert got.labels == [int(x) for x in want.labels]
    assert got.num_samples_per_dataset == want.num_samples_per_dataset


def test_quoted_path_with_spaces(data):
    p = data["root"] / "quoted.csv"
    p.write_text(f'"{data["root"] / "my clip.mp4"}" 3\n{data["paths"][0]} 5\n')
    got, want = tvd.VideoDataset([str(p)]), jvd.VideoDataset([str(p)])
    assert got.samples == list(want.samples) and got.labels == [3, 5] == list(want.labels)


def test_double_colon_manifest_jax_misreads(data):
    """JAX reads a CSV with pandas' space delimiter and takes ``::`` only on a
    ParserError: a ``::`` manifest whose paths hold no space gives one column
    (IndexError), and one whose paths all hold as many spaces splits them
    there. The port takes ``::`` wherever every row holds it."""
    root, (p0, p1) = data["root"], data["paths"][:2]
    plain = root / "plain.csv"
    plain.write_text(f"{p0}::2\n{p1}::5\n")
    with pytest.raises(IndexError):
        jvd.VideoDataset([str(plain)])
    got = tvd.VideoDataset([str(plain)])
    assert got.samples == [p0, p1] and got.labels == [2, 5]
    even = root / "even.csv"
    a, b = root / "a b.mp4", root / "c d.mp4"
    even.write_text(f"{a}::2\n{b}::5\n")
    want = jvd.VideoDataset([str(even)])
    assert list(want.samples) == [str(root / "a"), str(root / "c")]  # JAX's split
    got = tvd.VideoDataset([str(even)])
    assert got.samples == [str(a), str(b)] and got.labels == [2, 5]
    bad = root / "bad.csv"
    bad.write_text(f"{p0} 1\n{p1}\n")
    with pytest.raises(ValueError, match="no label"):
        tvd.VideoDataset([str(bad)])


DATASETS = {
    "fps": dict(fps=4, frame_step=None),
    "frame_step": dict(frame_step=2),
    "duration": dict(duration=1.5, frame_step=None),
    "two_clips": dict(frame_step=3, num_clips=2),
    "two_clips_overlap": dict(frame_step=8, num_clips=2, allow_clip_overlap=True),
    "short_partitions": dict(frame_step=9, num_clips=2),
    "filter_short": dict(frame_step=4, frames_per_clip=8, filter_short_videos=True),
    "fixed_window": dict(frame_step=3, random_clip_sampling=False),
}


def _pair(manifest, seed=0, transform=None, **kw):
    """(port, JAX) datasets over one manifest with equal transforms."""
    kw = {"frames_per_clip": 4, **kw}
    t = transform or {}
    return (tvd.VideoDataset([manifest], transform=tt.VideoTransform(**t), seed=seed, **kw),
            jvd.VideoDataset([manifest], transform=jt.VideoTransform(**t), seed=seed, **kw))


def _assert_items(got, want, exact=True, n=None):
    for i in range(n or len(want)):
        (gc, gl, gi), (wc, wl, wi) = got[i], want[i]
        assert gl == wl and len(gc) == len(wc) == len(gi) == len(wi)
        for a, b in zip(gi, wi):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(gc, wc):
            if a.dtype == np.uint8 or exact:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                _close(a, b)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_clips_match_jax(data, name):
    tf = dict(crop_size=32, horizontal_flip=True, use_native=True)
    got, want = _pair(data["space"], seed=3, transform=tf, **DATASETS[name])
    _assert_items(got, want)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("on_device", [False, True], ids=["float", "uint8"])
def test_transform_routes_match_jax(data, use_native, on_device):
    """Float clips bit-equal on the native crop, within one level on the
    numpy resize (cv2 on JAX's side); uint8 clips (``normalize_on_device``)
    bit-equal: the native crop on both sides, or the numpy resize against
    cv2's (one level off on a few pixels: held as `test_torch_transforms.py`
    holds it)."""
    tf = dict(crop_size=40, horizontal_flip=True, motion_shift=True, use_native=use_native,
              normalize_on_device=on_device)
    got, want = _pair(data["space"], seed=1, transform=tf, frame_step=2)
    if use_native or not on_device:
        _assert_items(got, want, exact=use_native)
        return
    for i in range(4):  # uint8 through the numpy resize: within one level
        a, b = got[i][0][0], want[i][0][0]
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_missing_file_retries_as_jax(data):
    got, want = _pair(data["missing"], seed=5, transform=dict(crop_size=32, use_native=True),
                      frame_step=2)
    _assert_items(got, want)  # row 1 resamples a random row on both sides


@pytest.mark.parametrize("cfg", ["rand-m7-n4-mstd0.5", "rand-m9-n2", "rand-m5-n6-mstd1.0"])
@pytest.mark.parametrize("seed", [0, 11])
def test_rand_augment_matches_jax(cfg, seed):
    clip = np.random.default_rng(seed).integers(0, 256, (3, 36, 44, 3), dtype=np.uint8)
    got = taug.RandAugment.from_config(cfg)(clip, np.random.default_rng(seed))
    want = jaug.RandAugment.from_config(cfg)(clip.copy(), np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("seed", [0, 3, 8])
def test_random_erasing_matches_jax(dtype, seed):
    clip = np.random.default_rng(seed).integers(0, 256, (2, 40, 30, 3)).astype(dtype)
    got = taug.RandomErasing(probability=0.9)(clip, np.random.default_rng(seed))
    want = jaug.RandomErasing(probability=0.9)(clip.copy(), np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


def test_augmenting_transform_matches_jax(data):
    tf = dict(crop_size=32, auto_augment=True, rand_erase_prob=0.5, use_native=True)
    got, want = _pair(data["space"], seed=2, transform=tf, frame_step=2)
    _assert_items(got, want, n=4)


def test_epoch_replay_jax_replays_every_epoch(data):
    """JAX's loop builds every epoch's loader with ``seed=meta.seed`` and never
    sets an epoch: each epoch's order, windows and crops are epoch 0's. The
    port's `DataLoader.set_epoch` draws them anew; its epoch 0 is JAX's."""
    tf = dict(crop_size=32, use_native=True)
    kw = dict(data_paths=[data["space"]], batch_size=2, frame_step=2, frames_per_clip=4,
              num_workers=0, ipe=3, seed=7)

    def jax_epoch():
        _, ld, _ = jmanager.init_video_data(transform=jt.VideoTransform(**tf), **kw)
        return list(ld)

    def port_epoch(epoch):
        _, ld, _ = tmanager.init_video_data(transform=tt.VideoTransform(**tf), **kw)
        ld.set_epoch(epoch)
        return list(ld), list(ld.batched_indices())

    j0, j1 = jax_epoch(), jax_epoch()
    (p0, i0), (p1, i1) = port_epoch(0), port_epoch(1)
    for a, b, c in zip(j0, j1, p0):  # JAX replays; the port's epoch 0 is JAX's
        for x, y, z in zip(jax_flat(a), jax_flat(b), jax_flat(c)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    assert i0 != i1
    assert not all(np.array_equal(x, y) for a, b in zip(p0, p1)
                   for x, y in zip(jax_flat(a), jax_flat(b)))


def jax_flat(batch):
    clips, labels, ci = batch
    return [*clips, labels, *ci]


def test_worker_stream_jax_siblings_share_draws(data):
    """Every spawned worker unpickles the parent's dataset, its ``rng``
    included, and JAX reseeds only numpy's global generator: two workers
    draw the same windows and crops for different samples. The port's
    workers each draw from their own stream."""
    tf = dict(crop_size=32, use_native=True)
    for mod, transforms, seed_fn in (
            (jvd, jt, lambda ds, w: np.random.seed(
                np.random.SeedSequence([0, 0, w]).generate_state(4))),
            (tvd, tt, lambda ds, w: tloader.seed_worker(ds, 0, 0, w, 0))):
        parent = mod.VideoDataset([data["space"]], frames_per_clip=4, frame_step=2,
                                  transform=transforms.VideoTransform(**tf))
        w0, w1 = (pickle.loads(pickle.dumps(parent)) for _ in range(2))
        seed_fn(w0, 0)
        seed_fn(w1, 1)
        # rows 0 and 4 name the same video: equal draws give equal clips
        same = (np.array_equal(w0[0][2][0], w1[4][2][0])
                and np.array_equal(w0[0][0][0], w1[4][0][0]))
        assert same == (mod is jvd), mod.__name__


def test_collate_matches_jax(data):
    ds = tvd.VideoDataset([data["space"]], frames_per_clip=4, frame_step=3, num_clips=2,
                          transform=tt.VideoTransform(crop_size=32, use_native=True))
    samples = [ds[i] for i in range(3)]
    for a, b in zip(jax_flat(tloader.default_collate(samples)),
                    jax_flat(jloader.default_collate(samples))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
