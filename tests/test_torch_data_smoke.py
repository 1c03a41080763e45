"""`chip_smoke.py`'s data phases on the CPU at a small size: phase
disk_data writes mp4 files where cv2 is present (each read back through the
port's `VideoReader`) and else the `.npy` double, whose `NpyVideoDataset`
goes through the port's loader with spawned workers (the workers unpickle
it) and reads only the frames asked for; phase train_disk's config dict
equals `configs/train/vitl16/pretrain-256px-16f.yaml` after its overrides.
The other layouts (DROID trajectories, EK100 annotations, ImageNet
folders): where the host has no h5py (the H100 host has none), the
trajectory double `DroidDouble` reads what `DROIDVideoDataset` reads from
the h5 files of the same arrays, and goes through spawned workers as the
DROID trainer's loader builds it; without a decoder, the EK100 and DROID
doubles read the `.npy` videos; the EK100 and ImageNet files go through
`cli.eval`'s loaders."""

import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import chip_smoke
from vjepa2_tpu_torch.cli import eval as cli_eval
from vjepa2_tpu_torch.data import transforms as tt
from vjepa2_tpu_torch.data import video
from vjepa2_tpu_torch.data.droid import droid_collate
from vjepa2_tpu_torch.data.loader import DataLoader
from vjepa2_tpu_torch.data.manager import init_video_data
from vjepa2_tpu_torch.data.samplers import DistributedSampler
from vjepa2_tpu_torch.train import droid_loop

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DISK_FRAMES", 60)
    monkeypatch.setattr(chip_smoke, "DISK_HW", (48, 64))
    monkeypatch.setattr(chip_smoke, "IMAGE_HW", (60, 80))


def _batches(data, workers):
    with chip_smoke.disk_datasets(data):
        ds, ld, _ = init_video_data([data["train"]], 4, transform=tt.VideoTransform(crop_size=32),
                                    fps=4, num_workers=workers, ordered=True, ipe=2)
        return type(ds), list(ld)


def test_disk_data_writes_the_npy_double(tmp_path, small, monkeypatch):
    monkeypatch.setattr(video, "_cv2", lambda: None)
    data = chip_smoke.phase_disk_data(str(tmp_path))
    assert data["decoder"] == "npy-double"
    rows = (tmp_path / "train.csv").read_text().splitlines()
    assert len(rows) == chip_smoke.DISK_VIDEOS * chip_smoke.DISK_REPEATS
    assert len((tmp_path / "bench.csv").read_text().splitlines()) == 8 * 18
    path = rows[0].split(" ")[0]
    reader = chip_smoke.NpyVideoDataset([data["train"]], frame_step=2).open_video(path)
    assert len(reader) == 60 and reader.avg_fps == 30.0
    np.testing.assert_array_equal(reader.get_batch([5, 1]), np.load(path)[[5, 1]])
    cls, spawned = _batches(data, workers=2)
    _, inline = _batches(data, workers=0)
    assert cls is chip_smoke.NpyVideoDataset and len(spawned) == len(inline) == 2
    for a, b in zip(spawned, inline):  # the same samples and windows; crops per worker
        assert a[0][0].shape == (4, 16, 32, 32, 3)
        np.testing.assert_array_equal(a[1], b[1])


def test_disk_data_writes_videos_where_cv2_is(tmp_path, small):
    pytest.importorskip("cv2")
    data = chip_smoke.phase_disk_data(str(tmp_path))
    assert data["decoder"] == video.available_backends()[0]
    _, batches = _batches(data, workers=0)
    assert [b[0][0].shape for b in batches] == [(4, 16, 32, 32, 3)] * 2


def test_train_disk_config_is_the_shipped_yaml():
    shipped = yaml.safe_load((ROOT / chip_smoke.TRAIN_DISK_CONFIG_FILE).read_text())
    assert chip_smoke.TRAIN_DISK_CONFIG == shipped
    raw = chip_smoke.overridden(shipped, {"data.datasets": ["m.csv"],
                                          **chip_smoke.TRAIN_DISK_OVERRIDES})
    assert raw["data"]["datasets"] == ["m.csv"] and raw["optimization"]["ipe"] == 2
    assert raw["data"]["batch_size"] == 24 and raw["data"]["num_workers"] == 8


def _droid_batches(data, workers):
    """The DROID trainer's dataset (as `DroidTrainer.make_loader` builds it,
    at 32 px) under `disk_datasets`, 2 batches of 8 through ``workers``."""
    with chip_smoke.disk_datasets(data):
        ds = droid_loop.DROIDVideoDataset(data["droid"], frames_per_clip=8, frameskip=1, fps=4,
                                          transform=tt.VideoTransform(crop_size=32), seed=234)
        loader = DataLoader(ds, DistributedSampler(len(ds), 1, 0, seed=234), batch_size=8,
                            num_workers=workers, collate_fn=droid_collate, ordered=True,
                            epoch_len=2)
        return ds, list(loader)


def test_droid_double_reads_what_h5py_reads(tmp_path, small, monkeypatch):
    """The same trajectories written twice, with h5py and (h5py hidden) as
    the double's ``trajectory.npz``: equal samples in process; the double
    through 2 spawned workers, [8, 8, 32, 32, 3] clips, 7 actions and 8
    states an example."""
    pytest.importorskip("h5py")
    pytest.importorskip("cv2")
    (tmp_path / "h5").mkdir()
    (tmp_path / "npz").mkdir()
    real = chip_smoke.phase_disk_data(str(tmp_path / "h5"))
    monkeypatch.setitem(sys.modules, "h5py", None)
    data = chip_smoke.phase_disk_data(str(tmp_path / "npz"))
    assert (real["trajectory_reader"], data["trajectory_reader"]) == ("h5py", "npz-double")
    monkeypatch.delitem(sys.modules, "h5py")
    ds_h5, inline_h5 = _droid_batches(real, 0)
    ds, inline = _droid_batches(data, 0)
    assert type(ds_h5) is droid_loop.DROIDVideoDataset and type(ds) is chip_smoke.DroidDouble
    assert len(ds) == chip_smoke.DROID_TRAJECTORIES * chip_smoke.DROID_IPE
    for a, b in zip(inline, inline_h5):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    _, spawned = _droid_batches(data, 2)
    assert len(spawned) == 2
    clips, actions, states, extr = spawned[0]
    assert clips.shape == (8, 8, 32, 32, 3) and actions.shape == (8, 7, 7)
    assert states.shape == (8, 8, 7) and extr.shape == (8, 8, 6)


def test_npy_doubles_read_ek100_and_droid(tmp_path, small, monkeypatch):
    """No decoder: the EK100 annotations' clips through `NpyEpicKitchens`
    and the DROID views through `DroidDouble`'s `.npy` reader."""
    monkeypatch.setattr(video, "_cv2", lambda: None)
    data = chip_smoke.phase_disk_data(str(tmp_path))
    _, batches = _droid_batches(data, 0)
    assert batches[0][0].shape == (8, 8, 32, 32, 3)
    data_c = {"annotations_train": data["ek100_train"], "annotations_val": data["ek100_val"],
              "num_workers": 0}
    with chip_smoke.disk_datasets(data):
        sizes, _, (train, val) = cli_eval.make_anticipation_loaders(data_c, 16, 4, 32, 2)
    assert type(train.dataset) is chip_smoke.NpyEpicKitchens
    assert sizes[:2] == (chip_smoke.EK100_IDS, chip_smoke.EK100_IDS)
    clips, at, verbs, _, _ = next(iter(val))
    assert clips.shape == (16, 4, 32, 32, 3) and verbs.max() < chip_smoke.EK100_IDS


def test_imagenet_folders_feed_the_in1k_loaders(tmp_path, small):
    data = chip_smoke.phase_disk_data(str(tmp_path))
    train, val = cli_eval.make_image_eval_loaders(
        {"root": data["in1k_train"], "root_val": data["in1k_val"], "num_workers": 0}, 64, 32,
        1000, 2)
    assert len(train.dataset) == chip_smoke.IMAGE_TRAIN and len(val.dataset) == chip_smoke.IMAGE_VAL
    batches = list(train)
    assert len(batches) == 2 and batches[0][0].shape == (64, 32, 32, 3)
    assert sorted(set(np.concatenate([b[1] for b in batches]))) == list(
        range(chip_smoke.IMAGE_CLASSES))
