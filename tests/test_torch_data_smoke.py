"""`chip_smoke.py`'s video phases on the CPU at a small size: phase
disk_data writes mp4 files where cv2 is present (each read back through the
port's `VideoReader`) and else the `.npy` double, whose `NpyVideoDataset`
goes through the port's loader with spawned workers (the workers unpickle
it) and reads only the frames asked for; and phase train_disk's config dict
equals `configs/train/vitl16/pretrain-256px-16f.yaml` after its overrides."""

from pathlib import Path

import numpy as np
import pytest
import yaml

import chip_smoke
from vjepa2_tpu_torch.data import transforms as tt
from vjepa2_tpu_torch.data import video
from vjepa2_tpu_torch.data.manager import init_video_data

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DISK_FRAMES", 60)
    monkeypatch.setattr(chip_smoke, "DISK_HW", (48, 64))


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
    assert len((tmp_path / "bench.csv").read_text().splitlines()) == 8 * 24
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
    assert raw["data"]["datasets"] == ["m.csv"] and raw["optimization"]["ipe"] == 3
    assert raw["data"]["batch_size"] == 24 and raw["data"]["num_workers"] == 8
