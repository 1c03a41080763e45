"""The port's AC post-training loop as a whole: `train/droid_loop.py`
(`DroidTrainer`, `SyntheticDroidLoader`, `droid_hparams`) driven through
`cli/main.py --device cpu` (the ``vjepa_droid`` app) on
`configs/train/smoke-tiny.yaml` turned into a DROID config (vit_tiny as the
frozen target, 4 frames at 32 px, batch 2, the AC predictor at width 192
with 3 heads of 64 and depth 2, ``auto_steps`` 2, fp32), written into a
temporary directory with ``optimization.ipe`` 3 and ``mesh.data`` 1.

* JAX parity: the first losses against the JAX package's `DroidTrainer`
  (`vjepa2_tpu/train/droid_loop.py:59`) run on the same config, from the
  same weights (`hub.converter.load_droid_state` of JAX's
  `init_droid_params`) and the same synthetic trajectories, the 3 losses of
  the epoch: rtol 1e-5 (as `test_torch_droid_step.py`).
* The hyper-parameters of the shipped `configs/train/vitg16/droid-256px-8f.yaml`
  and of the test config as JAX's trainer derives them; the synthetic
  trajectories equal to JAX's.
* Resume: 2 epochs straight against 1 epoch, a new run and 1 more: the
  predictor, the target and AdamW's moments bit-equal; the CSV's rows and
  the checkpoints. ``meta.read_checkpoint``: the target from a torch
  checkpoint's ``target_encoder`` (else ``encoder``) entry, unchanged after
  the run. A NaN loss aborts the run; the refusals (the ring, which the AC
  predictor lacks, and JAX's: a mesh wider than the world); the
  trainer reads ``data.datasets`` (`tests/test_torch_data_droid.py` holds
  its trajectories from disk to JAX's).
"""

import csv
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from vjepa2_tpu.core.config import PretrainConfig as JaxConfig
from vjepa2_tpu.train import droid as jdroid
from vjepa2_tpu.train import droid_loop as jloop
from vjepa2_tpu_torch.cli import main as cli
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.hub.converter import load_droid_state
from vjepa2_tpu_torch.train import droid_loop as loop

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs/train/smoke-tiny.yaml"
IPE = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(folder, overrides=None) -> dict:
    raw = yaml.safe_load(SMOKE.read_text())
    return chip_smoke.overridden(raw, {"app": "vjepa_droid", "folder": str(folder),
                                       "optimization.ipe": IPE, "loss.auto_steps": 2,
                                       "mesh.data": 1, "data.batch_size": 2,
                                       "data.crop_size": 32, **(overrides or {})})


def _write(tmp_path, name, overrides=None) -> Path:
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(_raw(tmp_path / name, overrides)))
    return path


def _main(path, *extra):
    return cli.main(["--fname", str(path), "--device", "cpu", *extra])


class _Steps:
    """Wraps the DroidTrainer's step: records each call's loss and the last
    state it updated; ``hook(n, metrics)`` runs after step n."""

    def __init__(self, monkeypatch, hook=None):
        self.losses, self.state, self.hook = [], None, hook
        make = loop.DroidTrainer._step_fn

        def step_fn(trainer):
            fn = make(trainer)

            def step(state, *batch):
                metrics = fn(state, *batch)
                self.losses.append(metrics["loss"].item())
                self.state = state
                if self.hook is not None:
                    metrics = self.hook(len(self.losses), metrics) or metrics
                return metrics

            return step

        monkeypatch.setattr(loop.DroidTrainer, "_step_fn", step_fn)


def _tensors(state) -> dict:
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("predictor", "target_encoder") for k, v in sd[m].items()}
    for i, s in sd["optimizer"]["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in s.items()})
    return out


def _csv_rows(folder) -> list[list[str]]:
    with open(Path(folder) / "droid_log_r0.csv") as f:
        return [r for r in csv.reader(f) if r and r[0] != "epoch"]


def test_first_losses_match_jax(tmp_path, monkeypatch):
    raw = _raw(tmp_path / "port")
    jraw = _raw(tmp_path / "jax")
    jtrainer = jloop.DroidTrainer(JaxConfig.from_dict(jraw))
    d = raw["data"]
    B, T, S = d["batch_size"], d["dataset_fpcs"][0], d["crop_size"]
    # the JAX trainer's own init (`droid_loop.py:128-131`), the same call
    params, target, _ = jdroid.init_droid_params(
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
    steps = _Steps(monkeypatch)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    _main(path, "--epochs", "1")
    assert len(steps.losses) == len(jax_losses) == IPE
    np.testing.assert_allclose(steps.losses, jax_losses, rtol=1e-5)


@pytest.mark.parametrize("name", ["shipped", "test"])
def test_hparams_and_trajectories_as_jax(tmp_path, name):
    if name == "shipped":
        raw = chip_smoke.overridden(chip_smoke.DROID_CONFIG, {"folder": str(tmp_path)})
    else:
        raw = _raw(tmp_path)
    jtrainer = jloop.DroidTrainer(JaxConfig.from_dict(raw))
    hp = loop.droid_hparams(PretrainConfig.from_dict(raw))
    want = {k: v for k, v in vars(jtrainer.hp).items() if k != "enc_lr_scale"}
    assert vars(hp) == want
    if name == "shipped":  # ipe 300: warmup 1 epoch, anneal 2, 12 epochs
        assert (hp.warmup_steps, hp.anneal_steps, hp.total_steps) == (300, 600, 3600)
    d = raw["data"]
    args = (d["batch_size"], max(d["dataset_fpcs"]), d["crop_size"], 2, raw["meta"]["seed"])
    for a, b in zip(next(iter(loop.SyntheticDroidLoader(*args))),
                    next(iter(jloop.SyntheticDroidLoader(*args)))):
        assert np.array_equal(a, b)


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, monkeypatch):
    steps = _Steps(monkeypatch)
    out = _main(_write(tmp_path, "straight", {"meta.load_checkpoint": True}))
    straight = steps.state
    assert out["step"] == straight.step == 2 * IPE and np.isfinite(out["loss"])
    path = _write(tmp_path, "resumed", {"meta.load_checkpoint": True})
    _main(path, "--epochs", "1")
    first = steps.state
    assert first.step == IPE
    _main(path)
    assert steps.state is not first  # a new trainer, restored from the checkpoint
    a, b = _tensors(steps.state), _tensors(straight)
    assert steps.state.step == straight.step
    assert sorted(a) == sorted(b) and any(k.endswith("exp_avg") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for name in ("straight", "resumed"):
        rows = _csv_rows(tmp_path / name)
        assert [(int(r[0]), int(r[1])) for r in rows] == [(e, i) for e in range(2)
                                                          for i in range(IPE)]
        assert all(np.isfinite(float(r[2])) for r in rows)
    assert sorted(os.listdir(tmp_path / "resumed" / "ckpt")) == sorted([f"{IPE}.pt",
                                                                       f"{2 * IPE}.pt"])


@pytest.mark.parametrize("keys", [("target_encoder", "encoder"), ("encoder",)])
def test_read_checkpoint_is_the_frozen_target(tmp_path, monkeypatch, keys):
    """``meta.read_checkpoint``: a torch checkpoint's ``target_encoder``
    (else ``encoder``) entry, reference names with a ``module.`` prefix,
    becomes the target and stays bit-equal through the steps."""
    probe = loop.DroidTrainer(PretrainConfig.from_dict(_raw(tmp_path / "probe")), device="cpu")
    weights = {}
    for i, key in enumerate(keys):
        gen = torch.Generator().manual_seed(100 + i)
        probe.target_encoder.reset_parameters(gen)
        weights[key] = {f"module.{k}": v.clone()
                        for k, v in probe.target_encoder.state_dict().items()}
    ckpt = tmp_path / "pretrained.pt"
    torch.save(weights, ckpt)
    steps = _Steps(monkeypatch)
    _main(_write(tmp_path, "run", {"meta.read_checkpoint": str(ckpt)}), "--epochs", "1")
    got = steps.state.target_encoder.state_dict()
    want = weights[keys[0]]
    assert sorted(f"module.{k}" for k in got) == sorted(want)
    for k, v in got.items():
        assert torch.equal(v, want[f"module.{k}"]), k


def test_nan_loss_aborts_the_run(tmp_path, monkeypatch):
    _Steps(monkeypatch, hook=lambda n, m: {**m, "loss": torch.tensor(float("nan"))})
    with pytest.raises(AssertionError, match="non-finite loss at itr 0"):
        _main(_write(tmp_path, "run"))


@pytest.mark.parametrize("overrides, error, match", [
    ({"mesh.model": 2, "model.context_parallel": True}, NotImplementedError,
     "no context-parallel route"),
    ({"mesh.fsdp": 2}, AssertionError, "mesh 1x2x1x1 > 1 devices"),
    ({"mesh.data": 2}, AssertionError, "> 1 devices"),
])
def test_refusals(tmp_path, overrides, error, match):
    """The ring, which the AC predictor has no route for, and JAX's `resolve`
    assertions in one process: an ``fsdp`` or a data axis wider than the
    world. Parameter sharding and tensor parallelism run
    (`tests/test_torch_model_parallel.py`)."""
    with pytest.raises(error, match=match):
        loop.DroidTrainer(PretrainConfig.from_dict(_raw(tmp_path / "run", overrides)),
                          device="cpu")


def test_data_datasets_is_read(tmp_path):
    """``data.datasets`` names the trajectories on disk (refused until the
    DROID data was ported): the trainer's loader reads that CSV, and
    ``--synthetic-data`` keeps the synthetic trajectories."""
    from vjepa2_tpu_torch.data.droid import DROIDVideoDataset

    csv_path = tmp_path / "droid_paths.csv"
    csv_path.write_text("/data/droid/traj_0\n/data/droid/traj_1\n")
    raw = _raw(tmp_path / "run", {"data.datasets": [str(csv_path)]})
    trainer = loop.DroidTrainer(PretrainConfig.from_dict(raw), device="cpu")
    loader = trainer.make_loader(1)
    assert isinstance(loader.dataset, DROIDVideoDataset) and loader.epoch == 1
    assert loader.dataset.samples == ["/data/droid/traj_0", "/data/droid/traj_1"]
    trainer.synthetic_data = True
    assert isinstance(trainer.make_loader(0), loop.SyntheticDroidLoader)


class _Built(Exception):
    """Raised in place of building the models: the trainer got that far."""


def test_fp32_on_the_card_builds(tmp_path, monkeypatch):
    """An fp32 config on the card (a card faked here): the `DroidTrainer`
    refuses nothing and builds its models in fp32 on the card with the
    flash routes (the fp32 flash kernels take the AC predictor's
    frame-causal segment ids)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = {}

    def build_droid_models(**kw):
        built.update(kw)
        raise _Built

    monkeypatch.setattr(loop, "build_droid_models", build_droid_models)
    raw = _raw(tmp_path / "run")
    assert raw["meta"]["dtype"] == "float32"
    with pytest.raises(_Built):
        loop.DroidTrainer(PretrainConfig.from_dict(raw), device="cuda")
    assert built["dtype"] == torch.float32 and built["device"] == torch.device("cuda")
    assert built["use_flash"] and built["use_rope"]


def test_without_a_device_the_cli_fails_on_entry_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device visible"):
        cli.main(["--fname", str(_write(tmp_path, "run"))])
    assert not (tmp_path / "run").exists()
