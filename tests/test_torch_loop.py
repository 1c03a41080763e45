"""The port's pretraining loop as a whole: `train/loop.py` (`Pretrainer`,
`SyntheticVideoLoader`, `group_fpc_batches`) driven through
`cli/main.py --device cpu` on `configs/train/smoke-tiny.yaml` (vit_tiny, 4
frames at 64 px, batch 4, two mask configs, fp32), with the run folder in a
temporary directory and ``optimization.ipe`` 3.

* JAX parity: the first 3 losses against the JAX package's `make_train_step`
  from the same weights (`hub.converter.load_pretrain_state`), the same
  `SyntheticVideoLoader` clips and the same collator masks: rtol 1e-5 (as
  `test_torch_pretrain_step.py`).
* Resume: 2 epochs straight against 1 epoch, a new run and 1 more epoch:
  parameters, target and AdamW moments bit-equal; a mid-epoch preemption
  (`PreemptionGuard` set by hand) resumes to the same bits; SIGTERM through
  the CLI exits 75; a NaN loss aborts the run; the CSV's rows.
* Multi-fpc: `group_fpc_batches` against JAX's on one stream,
  `make_multifpc_train_step` against JAX's from the same weights (loss and
  grad norm rtol 1e-5, EMA target atol 1e-6) and as the mean of its
  per-bucket losses (rtol 1e-6, `tests/train/test_multifpc.py:83`), and the
  `Pretrainer` grouping two fpcs into one step.
* The refusals (several cards, in-process evals), the
  action-conditioned app running through the same CLI on the smoke config
  (`tests/test_torch_droid_loop.py` holds it to JAX), and `chip_smoke.py`'s
  four config dicts equal to their YAML files after the overrides it
  prints (``SMOKE``: `configs/train/smoke-tiny.yaml`, which the card's
  phase train_fp32 runs); and fp32 on the card passing the `Pretrainer`'s
  checks (it builds in fp32 on the card).
"""

import csv
import functools
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from vjepa2_tpu.masks.multiblock3d import MaskCollator as JaxCollator
from vjepa2_tpu.train import loop as jloop
from vjepa2_tpu.train import pretrain as jpre
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.cli import main as cli
from vjepa2_tpu_torch.core.config import PretrainConfig
from vjepa2_tpu_torch.core.provenance import PreemptionGuard
from vjepa2_tpu_torch.hub.converter import load_pretrain_state, state_dict_from_flax
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.train import loop
from vjepa2_tpu_torch.train import pretrain as tpre
from vjepa2_tpu_torch.train.state import TrainState

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
    return chip_smoke.overridden(raw, {"folder": str(folder), "optimization.ipe": IPE,
                                       **(overrides or {})})


def _write(tmp_path, name, overrides=None) -> Path:
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(_raw(tmp_path / name, overrides)))
    return path


def _main(path, *extra):
    return cli.main(["--fname", str(path), "--device", "cpu", *extra])


class _Steps:
    """Wraps the Pretrainer's step functions: records each call's inputs and
    loss, and the last state it updated; ``hook(n)`` runs after step n."""

    def __init__(self, monkeypatch, hook=None):
        self.inputs, self.losses, self.state, self.hook = [], [], None, hook
        make = loop.Pretrainer._step_fn

        def step_fn(trainer, fpc):
            fn = make(trainer, fpc)

            def step(state, clips, me, mp):
                self.inputs.append((clips.clone(), [m.clone() for m in me],
                                    [m.clone() for m in mp]))
                metrics = fn(state, clips, me, mp)
                self.losses.append(metrics["loss"].item())
                self.state = state
                if self.hook is not None:
                    metrics = self.hook(len(self.losses), metrics) or metrics
                return metrics

            return step

        monkeypatch.setattr(loop.Pretrainer, "_step_fn", step_fn)


def _tensors(state: TrainState) -> dict:
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("encoder", "predictor", "target_encoder")
           for k, v in sd[m].items()}
    for i, s in sd["optimizer"]["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in s.items()})
    return out


def _assert_bit_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb) and any(k.endswith("exp_avg") for k in ta)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _csv_rows(folder, name="log_r0.csv") -> list[list[str]]:
    with open(Path(folder) / name) as f:
        return [r for r in csv.reader(f) if r and r[0] != "epoch"]


def _jax_hparams(raw: dict) -> jpre.PretrainHParams:
    """The JAX Pretrainer's hyper-parameters for a config (`loop.py:156-170`)."""
    o = raw["optimization"]
    c = jloop.PretrainConfig.from_dict(raw).optimization
    return jpre.PretrainHParams(
        lr=c.lr, start_lr=c.start_lr, final_lr=c.final_lr, warmup_epochs=c.warmup,
        epochs=c.epochs, ipe=o["ipe"], ipe_scale=c.ipe_scale, wd=c.weight_decay,
        final_wd=c.final_weight_decay, ema=tuple(c.ema), betas=tuple(c.betas), eps=c.eps,
        loss_exp=raw["loss"]["loss_exp"])


def test_first_losses_match_jax(tmp_path, monkeypatch):
    raw = _raw(tmp_path / "run")
    d, m = raw["data"], raw["model"]
    fpc, bs = d["dataset_fpcs"][0], d["batch_size"]
    jenc, jpred = jpre.build_models(
        m["model_name"], crop_size=d["crop_size"], num_frames=fpc,
        pred_depth=m["pred_depth"], pred_embed_dim=m["pred_embed_dim"],
        pred_num_heads=m["pred_num_heads"], use_rope=True, num_mask_tokens=len(raw["mask"]),
        dtype=jnp.float32)
    jcoll = JaxCollator(raw["mask"], dataset_fpcs=[fpc], crop_size=(d["crop_size"],) * 2,
                        seed=raw["meta"]["seed"])
    # the JAX Pretrainer's init_state: one collator step for the init
    # shapes (`loop.py:258-260`); the loop's steps go on from there
    jcoll.step()
    me0, mp0 = jcoll(fpc, bs)
    params, target = jpre.init_params(jenc, jpred, raw["meta"]["seed"],
                                      (bs, fpc, d["crop_size"], d["crop_size"], 3),
                                      jnp.asarray(me0[0]), jnp.asarray(mp0[0]))

    init = loop.Pretrainer.init_state
    monkeypatch.setattr(loop.Pretrainer, "init_state",
                        lambda self: load_pretrain_state(init(self), params, target))
    steps = _Steps(monkeypatch)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    _main(path, "--epochs", "1")
    assert len(steps.losses) == IPE

    hp = _jax_hparams(raw)
    tx = jpre.make_optimizer(hp)
    state = JaxState.create(params, target, tx)
    step = jax.jit(jpre.make_train_step(jenc, jpred, tx, hp, mask_indices=[0, 1]))
    jclips = jloop.SyntheticVideoLoader(bs, [fpc], d["crop_size"], IPE, raw["meta"]["seed"])
    losses = []
    for (clips_list, _, _), (clips, me, mp) in zip(jclips, steps.inputs):
        jcoll.step()
        jme, jmp = jcoll(fpc, bs)
        # the same clips and masks on both sides
        assert np.array_equal(clips.numpy(), clips_list[0])
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(me + mp, jme + jmp))
        state, metrics = step(state, jnp.asarray(clips_list[0]), tuple(map(jnp.asarray, jme)),
                              tuple(map(jnp.asarray, jmp)))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(steps.losses, losses, rtol=1e-5)


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, monkeypatch):
    steps = _Steps(monkeypatch)
    _main(_write(tmp_path, "straight", {"meta.load_checkpoint": True}))
    straight = steps.state
    assert straight.step == 2 * IPE
    path = _write(tmp_path, "resumed", {"meta.load_checkpoint": True})
    _main(path, "--epochs", "1")
    assert steps.state.step == IPE
    first = steps.state
    _main(path)
    assert steps.state is not first  # a new trainer, restored from the checkpoint
    _assert_bit_equal(steps.state, straight)
    for name in ("straight", "resumed"):
        rows = _csv_rows(tmp_path / name)
        assert [(int(r[0]), int(r[1])) for r in rows] == [(e, i) for e in range(2)
                                                          for i in range(IPE)]
        assert all(np.isfinite(float(r[2])) for r in rows)
    ckpts = sorted(os.listdir(tmp_path / "resumed" / "ckpt"))
    assert ckpts == [f"{IPE}.pt", f"{2 * IPE}.pt"]


def test_preemption_resumes_to_the_same_step(tmp_path, monkeypatch):
    path = _write(tmp_path, "run", {"meta.load_checkpoint": True})
    guard = PreemptionGuard(install=False)
    steps = _Steps(monkeypatch, hook=lambda n, m: guard._handler() if n == IPE + 1 else None)
    cfg = PretrainConfig.from_dict(yaml.safe_load(path.read_text()))
    out = loop.Pretrainer(cfg, device="cpu").run(preemption_guard=guard)
    assert out["preempted"] and out["step"] == IPE + 1  # mid-epoch 1
    steps.hook = None
    out = loop.Pretrainer(cfg, device="cpu").run()
    assert not out["preempted"] and out["step"] == 2 * IPE
    resumed = steps.state
    _main(_write(tmp_path, "straight", {"meta.load_checkpoint": True}))
    _assert_bit_equal(resumed, steps.state)
    assert len(_csv_rows(tmp_path / "run")) == 2 * IPE


def test_sigterm_checkpoints_and_exits_75(tmp_path, monkeypatch):
    previous = signal.getsignal(signal.SIGTERM)
    _Steps(monkeypatch, hook=lambda n, m: os.kill(os.getpid(), signal.SIGTERM) if n == 2
           else None)
    try:
        with pytest.raises(SystemExit) as exit_:
            _main(_write(tmp_path, "run"))
        after = signal.getsignal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert exit_.value.code == 75
    assert after is previous  # the guard is gone with its run
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == ["2.pt"]


@pytest.mark.parametrize("ending", ["returns", "raises"])
def test_the_cli_gives_sigterm_back(tmp_path, monkeypatch, ending):
    """After `cli.main` returns or raises, SIGTERM reaches the handler that
    was there before the run (a library caller or a test run stops on it)."""
    if ending == "raises":
        _Steps(monkeypatch, hook=lambda n, m: {**m, "loss": torch.tensor(float("nan"))})

    def before(signum, frame):
        pass

    previous = signal.signal(signal.SIGTERM, before)
    try:
        if ending == "returns":
            _main(_write(tmp_path, "run"))
        else:
            with pytest.raises(AssertionError, match="non-finite loss"):
                _main(_write(tmp_path, "run"))
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_nan_loss_aborts_the_run(tmp_path, monkeypatch):
    _Steps(monkeypatch, hook=lambda n, m: {**m, "loss": torch.tensor(float("nan"))})
    with pytest.raises(AssertionError, match="non-finite loss at itr 0"):
        _main(_write(tmp_path, "run"))


def test_without_a_device_the_cli_fails_on_entry_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device visible"):
        cli.main(["--fname", str(_write(tmp_path, "run"))])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("overrides, match", [
    ({"mesh.model": 2}, "A12"),
    ({"mesh.model": 4, "model.context_parallel": True}, "A12"),
    ({"mesh.fsdp": 2}, "A12"),
    ({"mesh.pipe": 2}, "A12"),
    ({"evals": ["configs/eval/vitl/ssv2.yaml"], "meta.eval_freq": 1}, "A10"),
])
def test_refusals(tmp_path, overrides, match):
    raw = _raw(tmp_path / "run")
    if "meta.eval_freq" in overrides:
        raw["meta"]["eval_freq"] = 1
    raw = chip_smoke.overridden(raw, {k: v for k, v in overrides.items()
                                      if k not in ("evals", "meta.eval_freq")})
    raw["evals"] = overrides.get("evals", [])
    with pytest.raises(NotImplementedError, match=match):
        loop.Pretrainer(PretrainConfig.from_dict(raw), device="cpu")


class _Built(Exception):
    """Raised in place of building the models: the trainer got that far."""


def test_fp32_on_the_card_builds(tmp_path, monkeypatch):
    """The shipped fp32 smoke config on the card (a card faked here): the
    `Pretrainer` refuses nothing and builds its models in fp32 on the card
    (the fp32 flash kernels take RoPE and kv_valid)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = {}

    def build_models(**kw):
        built.update(kw)
        raise _Built

    monkeypatch.setattr(loop, "build_models", build_models)
    raw = _raw(tmp_path / "run")
    assert raw["meta"]["dtype"] == "float32"
    with pytest.raises(_Built):
        loop.Pretrainer(PretrainConfig.from_dict(raw), device="cuda")
    assert built["dtype"] == torch.float32 and built["device"] == torch.device("cuda")
    assert built["use_flash"] and built["use_rope"]


def test_refusals_of_the_cli(tmp_path):
    # the action-conditioned app runs (it was refused until ROADMAP A9):
    # the smoke config as a DROID run, 2 epochs of IPE steps, finite loss
    out = _main(_write(tmp_path, "droid", {"loss.auto_steps": 2}), "--app", "vjepa_droid")
    assert out["step"] == 2 * IPE and np.isfinite(out["loss"])
    assert len(_csv_rows(tmp_path / "droid", "droid_log_r0.csv")) == 2 * IPE
    with pytest.raises(SystemExit, match="A12"):
        _main(_write(tmp_path, "run"), "--num-processes", "2")


@pytest.mark.parametrize("name", ["LOOP", "ACCUM", "DROID", "SMOKE"])
def test_chip_smoke_configs_are_the_shipped_files(name):
    held = getattr(chip_smoke, f"{name}_CONFIG")
    overrides = {"folder": "/tmp/x", **getattr(chip_smoke, f"{name}_OVERRIDES")}
    shipped = yaml.safe_load((ROOT / getattr(chip_smoke, f"{name}_CONFIG_FILE")).read_text())
    assert chip_smoke.overridden(held, overrides) == chip_smoke.overridden(shipped, overrides)
    assert held == shipped
    # the overrides change only what they name
    changed = chip_smoke.overridden(shipped, overrides)
    for key, value in overrides.items():
        *path, leaf = key.split(".")
        node, orig = changed, shipped
        for part in path:
            node, orig = node[part], orig[part]
        assert node[leaf] == value
        node[leaf] = orig[leaf]
    assert changed == shipped


# -- multi-fpc --------------------------------------------------------------

def _fpc_stream(fpcs, batch=2):
    rs = np.random.RandomState(0)
    for f in fpcs:
        yield [rs.rand(batch, f, 8, 8, 3)], np.zeros(batch), [None]


@pytest.mark.parametrize("fpcs, max_pending", [([4, 4, 8, 4, 8, 8, 4, 8], 8),
                                               ([4] * 20 + [8], 3)])
def test_group_fpc_batches_as_jax(fpcs, max_pending):
    got = list(loop.group_fpc_batches(_fpc_stream(fpcs), [8, 4], max_pending=max_pending))
    want = list(jloop.group_fpc_batches(_fpc_stream(fpcs), [8, 4], max_pending=max_pending))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert [np.asarray(b[0][0]).shape[1] for b in g] == [4, 8]  # sorted fpc order
        for bg, bw in zip(g, w):
            assert np.array_equal(bg[0][0], bw[0][0])


MF_S, MF_B = 32, 2
MF_ENC = dict(img_size=(MF_S, MF_S), patch_size=16, num_frames=8, tubelet_size=2, embed_dim=64,
              depth=1, num_heads=2, use_rope=True)
MF_PRED = dict(img_size=(MF_S, MF_S), patch_size=16, num_frames=8, tubelet_size=2,
               embed_dim=64, predictor_embed_dim=32, depth=1, num_heads=2,
               use_mask_tokens=True, num_mask_tokens=2, zero_init_mask_tokens=False,
               use_rope=True)
MF_MASKS = [{"aspect_ratio": (0.75, 1.5), "num_blocks": 2, "spatial_scale": (0.7, 0.7),
             "temporal_scale": (1.0, 1.0)}]


@functools.lru_cache(maxsize=1)
def _multifpc_setup():
    """Two buckets (4 and 8 frames), one mask config, JAX's initial weights."""
    coll = MaskCollator(MF_MASKS, dataset_fpcs=[4, 8], crop_size=(MF_S, MF_S))
    coll.step()
    rs = np.random.RandomState(0)
    clips, me, mp = [], [], []
    for f in (4, 8):
        a, b = coll(f, MF_B)
        clips.append(rs.rand(MF_B, f, MF_S, MF_S, 3).astype(np.float32))
        me.append(a)
        mp.append(b)
    from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT

    jenc = JaxViT(**MF_ENC, dtype=jnp.float32)
    jpred = JaxPredictor(**{k: v for k, v in MF_PRED.items() if k != "zero_init_mask_tokens"},
                         zero_init_mask_tokens=False, dtype=jnp.float32)
    params, target = jpre.init_params(jenc, jpred, 0, (MF_B, 8, MF_S, MF_S, 3),
                                      jnp.asarray(me[1][0]), jnp.asarray(mp[1][0]))
    return jenc, jpred, params, target, clips, me, mp


def _port_multifpc_state():
    _, _, params, target, *_ = _multifpc_setup()
    enc, pred = VisionTransformer(**MF_ENC, use_flash=True), VisionTransformerPredictor(
        **MF_PRED, use_flash=True)
    hp = tpre.PretrainHParams(ipe=4, epochs=1, warmup_epochs=0)
    state = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    return load_pretrain_state(state, params, target), hp


def _port_inputs(clips, me, mp):
    return (tuple(torch.from_numpy(c) for c in clips),
            tuple([torch.from_numpy(x) for x in m] for m in me),
            tuple([torch.from_numpy(x) for x in m] for m in mp))


def test_multifpc_step_matches_jax():
    jenc, jpred, params, target, clips, me, mp = _multifpc_setup()
    hp_j = jpre.PretrainHParams(ipe=4, epochs=1, warmup_epochs=0)
    tx = jpre.make_optimizer(hp_j)
    step_j = jax.jit(jpre.make_multifpc_train_step(jenc, jpred, tx, hp_j, num_mask_cfgs=1))
    state_j, metrics_j = step_j(JaxState.create(params, target, tx), tuple(map(jnp.asarray, clips)),
                                tuple(tuple(map(jnp.asarray, m)) for m in me),
                                tuple(tuple(map(jnp.asarray, m)) for m in mp))
    state, hp = _port_multifpc_state()
    metrics = tpre.make_multifpc_train_step(hp, num_mask_cfgs=1)(state,
                                                                 *_port_inputs(clips, me, mp))
    np.testing.assert_allclose(metrics["loss"].item(), float(metrics_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(metrics_j["grad_norm"]),
                               rtol=1e-5)
    want = state_dict_from_flax(state_j.target_params)
    for k, v in state.target_encoder.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    assert state.step == int(state_j.step) == 1


def test_multifpc_loss_is_pair_mean():
    *_, clips, me, mp = _multifpc_setup()
    state, hp = _port_multifpc_state()
    multi = tpre.make_multifpc_train_step(hp, num_mask_cfgs=1)(state,
                                                              *_port_inputs(clips, me, mp))
    single = []
    for bi in range(2):
        state, hp = _port_multifpc_state()
        c, e, p = _port_inputs(clips, me, mp)
        single.append(tpre.make_train_step(hp, mask_indices=[bi])(state, c[bi], e[bi], p[bi]))
    np.testing.assert_allclose(multi["loss"].item(),
                               (single[0]["loss"].item() + single[1]["loss"].item()) / 2,
                               rtol=1e-6)


def test_pretrainer_multifpc_within_step(tmp_path):
    raw = _raw(tmp_path / "run", {"data.dataset_fpcs": [4, 8], "data.crop_size": 32,
                                  "optimization.ipe": 6})
    raw["optimization"]["multifpc_within_step"] = True
    trainer = loop.Pretrainer(PretrainConfig.from_dict(raw), device="cpu")
    assert trainer.multifpc
    assert trainer._step_fn(4) is not trainer._step_fn(8)
    out = trainer.run(epochs=1)
    assert np.isfinite(out["loss"])
    # ipe=6 raw batches alternating 2 fpcs -> 3 grouped steps
    assert out["step"] == 3
