"""The port's in-process evals (`vjepa2_tpu_torch/evals/online.py`
`make_online_eval`, run by `train/loop.py`'s `Pretrainer` at
``meta.eval_freq``) against the JAX package's `make_online_eval`.

A video ViT at `vit_tiny` widths (192, 3 heads of 64, RoPE; depth 2, 4
frames at 64 px), JAX's weights crossed with
`hub.converter.state_dict_from_flax`; eval YAMLs written from the shipped
SSv2 and IN1K configs (batch 2, 4 classes, 2 probes with 3 heads), probed
online at ipe 3. The probes' initial state is JAX's (its vmapped init cannot
be drawn in torch), given through `probe_grid_from_flax` /
`adam_state_from_optax`. Checked: each eval's top-1 equal to JAX's, on
synthetic clips, on a video manifest (cv2 files, in process) and on
synthetic images; the `Pretrainer` on `configs/train/smoke-tiny.yaml` with
``evals`` and ``meta.eval_freq`` 1 runs its probes after each epoch's
checkpoint, logs them to ``eval_log_r0.csv``, and gives the losses and
weights of the same run without evals, bit for bit.
"""

import csv
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_loop as loop_tests
from test_torch_data_video import write_video
from vjepa2_tpu.evals import online as jonline
from vjepa2_tpu.evals import probes as jprobes
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu_torch.evals import online, probes
from vjepa2_tpu_torch.hub.converter import (adam_state_from_optax, probe_grid_from_flax,
                                            state_dict_from_flax)
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

ROOT = Path(__file__).resolve().parents[1]
S, T = 64, 4
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, use_rope=True, uniform_power=True)
PROBES = [{"lr": 5e-3, "weight_decay": 0.01, "final_weight_decay": 0.01},
          {"lr": 1e-3, "start_lr": 2e-4, "warmup": 0.5, "weight_decay": 0.1,
           "final_weight_decay": 0.3}]
IPE = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _encoders():
    jenc = JaxViT(**ENC)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.zeros((1, T, S, S, 3)))["params"]
    enc = VisionTransformer(**ENC)
    enc.load_state_dict(state_dict_from_flax(params))
    return jenc, params, enc.requires_grad_(False)


def eval_yaml(tmp_path, name: str, **data) -> str:
    """The shipped ``configs/eval/vitl/<name>.yaml`` at the tiny encoder's
    size: batch 2, 4 classes, 2 probes of 3 heads; ``data`` overrides."""
    cfg = yaml.safe_load((ROOT / f"configs/eval/vitl/{name}.yaml").read_text())
    exp = cfg["experiment"]
    exp["classifier"]["num_heads"] = 3
    exp["data"].update(num_classes=4, **data)
    exp["optimization"].update(batch_size=2, multihead_kwargs=PROBES)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    root = tmp_path_factory.mktemp("online")
    paths = [write_video(root / f"v{i}.mp4", 40 + 8 * i, 48, 64, seed=i) for i in range(3)]
    (root / "train.csv").write_text("".join(f"{p} {i % 4}\n" for i, p in enumerate(paths * 2)))
    (root / "val.csv").write_text("".join(f"{p} {i}\n" for i, p in enumerate(paths)))
    return {"dataset_train": str(root / "train.csv"), "dataset_val": str(root / "val.csv"),
            "frame_step": 2, "num_workers": 0}


@pytest.mark.parametrize("case", ["synthetic", "manifest", "image"])
def test_online_eval_matches_jax(tmp_path, manifests, monkeypatch, case):
    if case == "image":
        path = eval_yaml(tmp_path, "in1k")
    else:
        path = eval_yaml(tmp_path, "ssv2", **(manifests if case == "manifest" else {}))
    jenc, params, enc = _encoders()
    inits = []
    jinit = jprobes.ProbeGrid.init

    def jax_init(grid, shape):
        out = jinit(grid, shape)
        inits.append(jax.tree_util.tree_map(np.array, out))
        return out

    monkeypatch.setattr(jprobes.ProbeGrid, "init", jax_init)
    want = jonline.make_online_eval([path], ipe=IPE)(jenc, params, 0)
    states = iter(inits)

    def port_init(grid):
        p, opt, step = next(states)
        return probe_grid_from_flax(p), adam_state_from_optax(opt), int(step)

    monkeypatch.setattr(probes.ProbeGrid, "init", port_init)
    got = online.make_online_eval([path], ipe=IPE)(enc, 0)
    assert len(inits) == 1 and list(got) == [yaml.safe_load(Path(path).read_text()).get(
        "tag", path)]
    assert got == want and 0.0 <= next(iter(got.values())) <= 1.0


def test_families_without_a_runner_are_skipped(tmp_path):
    cfg = {"eval_name": "some_other_family", "experiment": {}}
    path = tmp_path / "other.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert online.make_online_eval([str(path)])(_encoders()[2], 0) == {}


def _pretrain(tmp_path, name, evals=()) -> None:
    overrides = {"optimization.epochs": 2, **({"meta.eval_freq": 1} if evals else {})}
    raw = loop_tests._raw(tmp_path / name, overrides)
    raw["evals"] = list(evals)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    loop_tests._main(path)


def test_pretrainer_runs_evals_and_keeps_its_losses(tmp_path, monkeypatch):
    """``evals`` (the tiny SSv2 YAML, synthetic clips) with ``meta.eval_freq``
    1 over 2 epochs: the probes run after each epoch, on the target encoder
    and with the predictor; the losses, the three models and AdamW's state
    equal those of the run without evals; 2 rows in ``eval_log_r0.csv``."""
    steps = loop_tests._Steps(monkeypatch)
    calls = []
    make = online.make_online_eval

    def counted(paths, **kw):
        fn = make(paths, **kw)

        def run(encoder, epoch, **ctx):
            calls.append((epoch, encoder, ctx.get("predictor")))
            return fn(encoder, epoch, **ctx)

        return run

    monkeypatch.setattr(loop_tests.loop, "make_online_eval", counted)
    _pretrain(tmp_path, "plain")
    plain_losses, plain = list(steps.losses), steps.state
    _pretrain(tmp_path, "evals", evals=[eval_yaml(tmp_path, "ssv2")])
    assert [c[0] for c in calls] == [0, 1]
    assert calls[-1][1] is steps.state.target_encoder
    assert calls[-1][2] is steps.state.predictor
    assert len(plain_losses) == 2 * loop_tests.IPE
    assert steps.losses[len(plain_losses):] == plain_losses
    a, b = loop_tests._tensors(steps.state), loop_tests._tensors(plain)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with open(tmp_path / "evals" / "eval_log_r0.csv") as f:
        rows = [r for r in csv.reader(f) if r and r[0] != "epoch"]
    assert [(int(r[0]), r[1]) for r in rows] == [(0, "ssv2-vitl16"), (1, "ssv2-vitl16")]
    assert all(0.0 <= float(r[2]) <= 1.0 for r in rows)
    assert not (tmp_path / "plain" / "eval_log_r0.csv").exists()
