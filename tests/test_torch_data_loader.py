"""The port's `DataLoader`, `FpcBucketSampler` and `init_video_data`
(`vjepa2_tpu_torch/data/{loader,manager}.py`) against the JAX package's on
the same manifests: batches equal at 0 workers (mixed fpcs included); at 2
spawned workers with ``ordered=True`` the same batches in the same order on
a dataset that draws nothing; ``epoch_len`` and ``drop_last``; and the
port's own guarantees: a worker's failure raises in the trainer, its
batches do not depend on the workers' race (batch ``b`` to worker
``b % n``), ``monitor_dir`` writes each worker's resource rows, and
importing the data modules in a spawned child initialises no CUDA and
builds nothing."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_data_dataset import jax_flat
from test_torch_data_video import write_video
from vjepa2_tpu.data import loader as jloader
from vjepa2_tpu.data import manager as jmanager
from vjepa2_tpu.data import samplers as js
from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu.data import video_dataset as jvd
from vjepa2_tpu_torch.data import loader as tloader
from vjepa2_tpu_torch.data import manager as tmanager
from vjepa2_tpu_torch.data import samplers as ts
from vjepa2_tpu_torch.data import transforms as tt
from vjepa2_tpu_torch.data import video_dataset as tvd

pytest.importorskip("cv2", reason="the test videos are written with cv2")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three 48 x 64 videos; ``a.csv`` lists them 3 times (9 rows), ``b.csv``
    twice (6 rows, another fpc in the mixed case)."""
    root = tmp_path_factory.mktemp("loader")
    paths = [write_video(root / f"v{i}.mp4", n, 48, 64, seed=i)
             for i, n in enumerate((50, 70, 90))]
    (root / "a.csv").write_text("".join(f"{p} {i}\n" for i, p in enumerate(paths * 3)))
    (root / "b.csv").write_text("".join(f"{p} {i + 10}\n" for i, p in enumerate(paths * 2)))
    return root


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for x, y in zip(jax_flat(a), jax_flat(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mixed", [False, True], ids=["one_fpc", "mixed_fpcs"])
def test_zero_workers_match_jax(data, mixed):
    paths = [str(data / "a.csv"), str(data / "b.csv")]
    kw = dict(data_paths=paths, batch_size=2, frame_step=2, num_workers=0, ipe=5, seed=4,
              dataset_fpcs=[4, 6] if mixed else [4, 4])
    tf = dict(crop_size=32, horizontal_flip=True, use_native=True)
    _, tl, _ = tmanager.init_video_data(transform=tt.VideoTransform(**tf), **kw)
    _, jl, _ = jmanager.init_video_data(transform=jt.VideoTransform(**tf), **kw)
    got, want = list(tl), list(jl)
    _batches_equal(got, want)
    assert (tl.batch_sampler is not None) == mixed
    fpcs = {b[0][0].shape[1] for b in got}
    assert fpcs == ({4, 6} if mixed else {4})


def test_fpc_buckets_match_jax():
    fpc_of = (lambda i: 4 if i % 3 else 8)
    for seed in (0, 5):
        got = list(tloader.FpcBucketSampler(ts.DistributedSampler(40, 1, 0, seed=seed),
                                            fpc_of, 3))
        want = list(jloader.FpcBucketSampler(js.DistributedSampler(40, 1, 0, seed=seed),
                                             fpc_of, 3))
        assert got == want and all(len({fpc_of(i) for i in b}) == 1 for b in got)


def _plain(mod, data):
    """A dataset that draws nothing: fixed windows, no transform."""
    return mod.VideoDataset([str(data / "a.csv")], frames_per_clip=4, frame_step=3,
                            random_clip_sampling=False)


def test_two_spawned_workers_ordered_match_jax(data):
    kw = dict(batch_size=2, num_workers=2, ordered=True, epoch_len=4)
    got = list(tloader.DataLoader(_plain(tvd, data), ts.DistributedSampler(9, 1, 0, seed=1),
                                  **kw))
    want = list(jloader.DataLoader(_plain(jvd, data), js.DistributedSampler(9, 1, 0, seed=1),
                                   **kw))
    _batches_equal(got, want)


def test_spawned_batches_do_not_depend_on_the_race(data):
    """Random crops through two workers: ordered twice, and unordered, give
    the same batches (each batch's draws come from its worker's stream, in
    that worker's order)."""
    def run(ordered):
        ds = tvd.VideoDataset([str(data / "a.csv")], frames_per_clip=4, frame_step=2,
                              transform=tt.VideoTransform(crop_size=24, use_native=True))
        ld = tloader.DataLoader(ds, ts.DistributedSampler(9, 1, 0, seed=2), batch_size=2,
                                num_workers=2, ordered=ordered, epoch_len=4, seed=3)
        return list(ld)

    a, b, c = run(True), run(True), run(False)
    _batches_equal(a, b)
    key = (lambda batch: batch[1].tolist())  # the labels name the rows of a.csv
    _batches_equal(sorted(c, key=key), sorted(a, key=key))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("epoch_len", [None, 2])
def test_epoch_len_and_drop_last_match_jax(data, drop_last, epoch_len):
    kw = dict(batch_size=4, drop_last=drop_last, epoch_len=epoch_len)
    got = list(tloader.DataLoader(_plain(tvd, data), ts.DistributedSampler(9, 1, 0), **kw))
    want = list(jloader.DataLoader(_plain(jvd, data), js.DistributedSampler(9, 1, 0), **kw))
    _batches_equal(got, want)
    assert len(got) == (epoch_len or (2 if drop_last else 3))


def test_a_worker_failure_raises_in_the_trainer(data):
    """A transform that raises on every clip (the builtin ``int`` takes no
    ``rng``): the worker's exception is raised where the batch is awaited."""
    ds = tvd.VideoDataset([str(data / "a.csv")], frames_per_clip=4, frame_step=3, transform=int)
    ld = tloader.DataLoader(ds, range(9), batch_size=2, num_workers=2, ordered=True)
    with pytest.raises(TypeError, match="rng"):
        list(ld)


def test_monitor_dir_writes_worker_rows(data, tmp_path):
    ld = tloader.DataLoader(_plain(tvd, data), ts.DistributedSampler(9, 1, 0), batch_size=3,
                            num_workers=2, monitor_dir=str(tmp_path / "mon"), epoch_len=2)
    assert len(list(ld)) == 2
    for w in range(2):
        rows = (tmp_path / "mon" / f"worker_{w}.csv").read_text().splitlines()
        assert rows[0].startswith("ts,cpu_percent,rss_mb")


IMPORT_PROBE = """
import multiprocessing as mp, sys

def child(q):
    import importlib, pkgutil, torch
    import vjepa2_tpu_torch.data as data
    names = [m.name for m in pkgutil.walk_packages(data.__path__, "vjepa2_tpu_torch.data.")]
    for name in names:
        importlib.import_module(name)
    from vjepa2_tpu_torch.data import native
    heavy = sorted(m for m in sys.modules if m.startswith(("vjepa2_tpu_torch.ops",
                   "vjepa2_tpu_torch.models", "vjepa2_tpu_torch._build", "jax", "vjepa2_tpu.")))
    q.put((len(names), torch.cuda.is_initialized(), native._LIB is None, heavy))

if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=child, args=(q,))
    p.start()
    print(q.get(timeout=120))
    p.join()
"""


def test_a_spawned_child_imports_the_data_modules_without_cuda_or_a_build(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(IMPORT_PROBE)
    res = subprocess.run([sys.executable, str(script)], cwd=ROOT, capture_output=True,
                         text=True, timeout=180, env={"PYTHONPATH": str(ROOT),
                                                      "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    n, cuda_init, not_built, heavy = eval(res.stdout.strip().splitlines()[-1])
    assert n >= 9 and not cuda_init and not_built and heavy == []


def _shm_segments() -> set:
    return {p.name for p in Path("/dev/shm").glob("psm_*")}


def test_large_batches_pass_through_shared_memory(data):
    """Batches of 4.9 MB (over `SHARED_MIN_BYTES`) reach the trainer from two
    workers equal to the in-process loader's (fixed windows, and whole-frame
    crops: no draw changes a clip), and a loader closed early leaves no
    segment behind."""
    def loader(workers):
        tf = tt.VideoTransform(crop_size=160, random_resize_scale=(1.0, 1.0),
                               random_resize_aspect_ratio=(4 / 3, 4 / 3), use_native=True)
        ds = tvd.VideoDataset([str(data / "a.csv")], frames_per_clip=4, frame_step=2,
                              transform=tf, random_clip_sampling=False)
        return tloader.DataLoader(ds, ts.DistributedSampler(9, 1, 0, seed=1), batch_size=4,
                                  num_workers=workers, ordered=True)

    before = _shm_segments()
    got, want = list(loader(2)), list(loader(0))
    assert got[0][0][0].nbytes >= tloader.SHARED_MIN_BYTES
    _batches_equal(got, want)
    it = iter(loader(2))
    next(it)
    it.close()
    assert _shm_segments() <= before
