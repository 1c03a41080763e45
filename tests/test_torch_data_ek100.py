"""The port's EPIC-Kitchens-100 anticipation data
(`vjepa2_tpu_torch/data/epickitchens.py`) and `cli.eval`'s EK100 run from
annotations against the JAX package's on the same files and seeds.

Three videos written with cv2 (15 fps) in ``tmp_path``; annotation CSVs
with numeric verb and noun ids 1-12, so that ids past 9 test the label
spaces' numeric sort (pandas types the columns; a sort of the strings would
put "10" before "2"). Checked: the label spaces equal JAX's; samples (clip,
anticipation time, verb, noun, action; a val label missing from the train
space maps to 0) and `anticipation_collate` bit-equal; the shard stream's
batches at epochs 0 and 1 and its node split; `cli.eval`'s EK100 eval from
the annotations at `shrink_config` size, through 2 spawned workers. JAX's
val set on the training transform is pinned (ROADMAP queue C)."""

import copy
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from test_torch_data_video import write_video
from vjepa2_tpu.data import epickitchens as jek
from vjepa2_tpu.data import transforms as jt
from vjepa2_tpu_torch.cli import eval as cli
from vjepa2_tpu_torch.data import epickitchens as tek
from vjepa2_tpu_torch.data import transforms as tt

pytest.importorskip("cv2", reason="the test videos are written with cv2")
ROOT = Path(__file__).resolve().parents[1]
COLUMNS = "video_path,start_sec,stop_sec,verb,noun,action"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``train.csv``: 12 actions over 3 videos of 60-80 frames, verbs 1-12
    and nouns 2-12 in no order; ``val.csv``: 4 actions, one with a verb
    (13) and one with a noun (1) the train set lacks."""
    root = tmp_path_factory.mktemp("ek100")
    videos = [write_video(root / f"v{i}.mp4", 60 + 10 * i, 48, 64, seed=i, fps=15.0)
              for i in range(3)]
    rng = np.random.default_rng(0)
    verbs = [3, 11, 1, 10, 2, 12, 5, 9, 4, 7, 8, 6]
    rows = []
    for i, verb in enumerate(verbs):
        start = float(rng.uniform(1.5, 3.0))
        noun = int(rng.integers(2, 13))
        rows.append(f"{videos[i % 3]},{start:.3f},{start + 0.8:.3f},{verb},{noun},{i}")
    (root / "train.csv").write_text("\n".join([COLUMNS, *rows]) + "\n")
    val = [rows[0], rows[5], f"{videos[1]},2.000,2.500,13,4,20",
           f"{videos[2]},2.500,3.100,10,1,21"]
    (root / "val.csv").write_text("\n".join([COLUMNS, *val]) + "\n")
    return root


def _label_spaces(data):
    port = tek.build_action_label_space(tek.read_annotations(str(data / "train.csv"))[1])
    jax = jek.build_action_label_space(pd.read_csv(data / "train.csv"))
    return port, jax


def test_label_space_matches_jax_past_nine(data):
    port, jax = _label_spaces(data)
    assert port == jax
    assert list(port["verb_to_idx"]) == list(range(1, 13))  # numeric, not "1", "10", "11"
    assert port["verb_to_idx"][10] == 9
    assert all(type(k) is int for k in port["verb_to_idx"])


def _datasets(data, csv="train.csv", **kw):
    kw = dict(frames_per_clip=4, frame_step=2, anticipation_time_range=(0.5, 1.0),
              anticipation_point_range=(0.0, 0.5), seed=2, **kw)
    return (tek.EpicKitchensAnticipation(str(data / csv),
                                         transform=tt.VideoTransform(crop_size=32), **kw),
            jek.EpicKitchensAnticipation(str(data / csv),
                                         transform=jt.VideoTransform(crop_size=32), **kw))


def _samples_equal(got, want):
    np.testing.assert_array_equal(got.clip, want.clip)
    assert got.clip.dtype == want.clip.dtype
    assert (got.anticipation_time, got.verb, got.noun, got.action) == (
        want.anticipation_time, want.verb, want.noun, want.action)


@pytest.mark.parametrize("split", ["train", "val"])
def test_samples_and_collate_match_jax(data, split):
    """Every row in order, then a few again (the stream goes on); the val
    set on the train set's label space."""
    if split == "val":
        port_space, jax_space = _label_spaces(data)
        t, j = _datasets(data, "val.csv", label_space=port_space)
        j.label_space = jax_space
    else:
        t, j = _datasets(data)
    order = [*range(len(t)), 0, 2]
    got, want = [t[i] for i in order], [j[i] for i in order]
    for g, w in zip(got, want):
        _samples_equal(g, w)
    if split == "val":
        assert (got[2].verb, got[3].noun) == (0, 0)  # ids the train set lacks
    for a, b in zip(tek.anticipation_collate(got), jek.anticipation_collate(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _streams(data, **kw):
    kw = dict(frames_per_clip=4, fps=5.0, batch_size=3, seed=4, **kw)
    return (tek.EpicKitchensShardStream(str(data / "train.csv"),
                                        transform=tt.VideoTransform(crop_size=32), **kw),
            jek.EpicKitchensShardStream(str(data / "train.csv"),
                                        transform=jt.VideoTransform(crop_size=32), **kw))


@pytest.mark.parametrize("node", [(0, 1), (0, 2), (1, 2)], ids=["one", "rank0of2", "rank1of2"])
def test_shard_stream_matches_jax_at_two_epochs(data, node):
    rank, world = node
    t, j = _streams(data, rank=rank, world_size=world)
    orders = []
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        orders.append(list(tek.split_by_node(t.shards, rank, world)))
        assert orders[-1] == list(jek.split_by_node(j.shards, rank, world))
        got, want = list(t), list(j)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    if world == 1:
        assert sorted(orders[0]) == sorted(orders[1]) and orders[0] != orders[1]


def _ek100_tiny(data, **extra) -> dict:
    raw = cli.shrink_config(yaml.safe_load((ROOT / "configs/eval/vitl/ek100.yaml").read_text()))
    raw["experiment"]["data"].update(annotations_train=str(data / "train.csv"),
                                     annotations_val=str(data / "val.csv"), **extra)
    return raw


def _args():
    return cli.argparse.Namespace(checkpoint=None, epochs=None, synthetic_data=False,
                                  val_only=False, device=torch.device("cpu"))


def test_cli_eval_reads_ek100_annotations(data, monkeypatch):
    """The shipped EK100 config, shrunk as ``--tiny`` shrinks it, from the
    annotations through 2 spawned workers: the label spaces of the train
    set (12 verbs), recalls in [0, 100] percent."""
    seen = {}
    init = cli.make_anticipation_loaders

    def spy(*args, **kw):
        out = init(*args, **kw)
        seen["sizes"], seen["valid"] = out[0], out[1]
        return out

    monkeypatch.setattr(cli, "make_anticipation_loaders", spy)
    raw = _ek100_tiny(data, num_workers=2)
    out = cli.EVALS[raw["eval_name"]](copy.deepcopy(raw), _args())
    port_space, _ = _label_spaces(data)
    assert seen["sizes"] == (12, len(port_space["noun_to_idx"]), 12)
    assert seen["valid"] == set(range(12))
    for head in ("verb", "noun", "action"):
        assert 0.0 <= out[head]["recall"] <= 100.0  # percent


def test_ek100_val_set_jax_takes_the_training_transform(data):
    """JAX's launcher builds the val set with the training `VideoTransform`
    (random resized crops and flips, `cli/eval.py:388-390`); the port keeps
    it (ROADMAP queue C): a val row read twice from two streams gives two
    crops, where an eval transform would give one."""
    _, _, (_, val) = cli.make_anticipation_loaders(
        _ek100_tiny(data, num_workers=0)["experiment"]["data"], 2, 4, 32, 2)
    ds = val.dataset
    assert type(ds.transform) is tt.VideoTransform and ds.transform.random_resize_scale != (1, 1)
    clips = []
    for seed in (0, 1):
        ds.rng = np.random.default_rng(seed)
        clips.append(ds[0].clip)
    assert not np.array_equal(*clips)
