"""The port's eval loaders from disk (`vjepa2_tpu_torch/cli/eval.py`
`make_video_eval_loaders`) against the JAX package's on the same manifests
(videos written with cv2): the train and val batches equal (clips [B, nc,
T, S, S, 3], labels, clip indices) at one and two segments; `cli.eval`
running the shipped SSv2 config, shrunk as ``--tiny`` shrinks it, with
``dataset_train`` / ``dataset_val`` on disk through spawned workers; and the
IN1K and EK100 runs reading their data paths (`tests/test_torch_data_imagenet.py`
and `test_torch_data_ek100.py` hold their data to JAX's)."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_data_video import write_video
from vjepa2_tpu.cli import eval as jcli
from vjepa2_tpu_torch.cli import eval as cli

pytest.importorskip("cv2", reason="the test videos are written with cv2")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_data")
    paths = [write_video(root / f"v{i}.mp4", 40 + 10 * i, 48, 64, seed=i) for i in range(3)]
    (root / "train.csv").write_text("".join(f"{p} {i % 4}\n" for i, p in enumerate(paths * 3)))
    (root / "val.csv").write_text("".join(f"{p} {i}\n" for i, p in enumerate(paths)))
    return {"dataset_train": str(root / "train.csv"), "dataset_val": str(root / "val.csv")}


@pytest.mark.parametrize("segments", [1, 2])
def test_video_eval_loaders_match_jax(manifests, segments):
    data_c = {**manifests, "frame_step": 2, "num_workers": 0}
    args = (data_c, 2, 4, 32, segments, 4, 3)
    got = [list(ld) for ld in cli.make_video_eval_loaders(*args)]
    want = [list(ld) for ld in jcli.make_video_eval_loaders(*args)]
    assert [len(g) for g in got] == [len(w) for w in want] == [3, 1]
    for g, w in zip(got, want):
        for (gc, gl, gi), (wc, wl, wi) in zip(g, w):
            assert gc.shape == (2, segments, 4, 32, 32, 3) and gc.dtype == wc.dtype
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gi, wi)


def _ssv2_tiny(manifests) -> dict:
    raw = cli.shrink_config(yaml.safe_load((ROOT / "configs/eval/vitl/ssv2.yaml").read_text()))
    raw["experiment"]["data"].update(manifests, num_workers=2)
    return raw


def test_cli_eval_reads_video_manifests(manifests, tmp_path):
    path = tmp_path / "ssv2.yaml"
    path.write_text(yaml.safe_dump(_ssv2_tiny(manifests)))
    out = cli.main(["--fname", str(path), "--device", "cpu", "--epochs", "1"])
    assert 0.0 <= out["top1"] <= 1.0 and len(out["top1_per_probe"]) == 2


@pytest.mark.parametrize("name", ["in1k", "ek100"])
def test_image_and_ek100_paths_run(manifests, name, monkeypatch):
    """A data path in the IN1K or EK100 config (refused until their loaders
    were ported) reaches the loader of that data: a folder for IN1K, the
    annotations for EK100, read here from paths that hold no data."""
    raw = cli.shrink_config(yaml.safe_load((ROOT / f"configs/eval/vitl/{name}.yaml").read_text()))
    key, maker = {"in1k": ("root", "make_image_eval_loaders"),
                  "ek100": ("annotations_train", "make_anticipation_loaders")}[name]
    raw["experiment"]["data"][key] = manifests["dataset_val"]
    seen = {}

    class _Reached(Exception):
        pass

    def reached(data_c, *args, **kw):
        seen.update(data_c=data_c, synthetic=kw.get("synthetic"))
        raise _Reached

    monkeypatch.setattr(cli, maker, reached)
    args = cli.argparse.Namespace(checkpoint=None, epochs=None, synthetic_data=False,
                                  val_only=False, device=torch.device("cpu"))
    with pytest.raises(_Reached):
        cli.EVALS[raw["eval_name"]](copy.deepcopy(raw), args)
    assert seen["data_c"][key] == manifests["dataset_val"] and not seen["synthetic"]
