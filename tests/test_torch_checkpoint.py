"""The port's checkpoints (`vjepa2_tpu_torch/core/checkpoint.py`) keep the
JAX manager's semantics (`vjepa2_tpu/core/checkpoint.py` on Orbax) and two
rules of their own making: writes are atomic and restores exact.

Mirrors `tests/core/test_checkpoint_milestones.py:14,30` (the rolling window
and ``keep_period``), then: a save cut before its rename leaves the previous
latest step whole; a `TrainState` (two small models after two AdamW steps)
comes back bit-equal, the moments and per-parameter step counts included,
and the next step from it is bit-equal to the next step of the original;
`save_params` / `load_params` with its retry.
"""

import os

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.core import checkpoint as ckpt_mod
from vjepa2_tpu_torch.core.checkpoint import CheckpointManager, load_params, save_params
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.train import pretrain as tpre
from vjepa2_tpu_torch.train.state import TrainState

S, T, B = 32, 4, 2


def test_keep_period_survives_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, keep_period=5)
    state = {"w": torch.zeros(2, 2), "step": torch.zeros((), dtype=torch.int32)}
    for step in range(1, 11):
        mgr.save(step, {**state, "step": torch.tensor(step, dtype=torch.int32)})
    steps = mgr.all_steps()
    # milestones (5, 10) are permanent; the rolling window keeps the last 2
    assert 5 in steps and 10 in steps, steps
    assert 9 in steps or 10 in steps  # rolling window tail
    assert 1 not in steps and 2 not in steps, steps
    # milestone restore returns the right step
    restored = mgr.restore(state, step=5)
    assert int(restored["step"]) == 5


def test_no_keep_period_rolls(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    state = {"w": torch.zeros(2, 2)}
    for step in range(1, 6):
        mgr.save(step, state)
    assert mgr.all_steps() == [4, 5]
    assert mgr.latest_step() == 5


def test_every_saved_step_is_written(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step in (3, 4, 7):
        mgr.save(step, {"w": torch.full((1,), float(step))})
    assert mgr.all_steps() == [3, 4, 7]
    assert float(mgr.restore({"w": torch.zeros(1)}, step=4)["w"]) == 4.0


def test_restore_without_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(1)})


def test_save_cut_before_rename_keeps_previous_latest(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": torch.ones(3)})

    def killed(src, dst):
        raise KeyboardInterrupt("killed before os.replace")

    monkeypatch.setattr(ckpt_mod.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, {"w": torch.full((3,), 2.0)})
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore(None)["w"], torch.ones(3))
    # nothing half-written is left beside the steps
    assert sorted(os.listdir(mgr.directory)) == ["1.pt"]
    mgr.save(2, {"w": torch.full((3,), 2.0)})
    assert mgr.latest_step() == 2


def _state(seed):
    common = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, use_rope=True,
                  use_flash=True)
    enc = VisionTransformer(embed_dim=64, depth=1, num_heads=2, **common)
    pred = VisionTransformerPredictor(embed_dim=64, predictor_embed_dim=32, depth=1,
                                      num_heads=2, use_mask_tokens=True, num_mask_tokens=1,
                                      **common)
    tpre.init_params(enc, pred, torch.Generator().manual_seed(seed))
    hp = tpre.PretrainHParams(ipe=4, epochs=2, warmup_epochs=1)
    return TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred)), hp


def _batch(i):
    rng = np.random.RandomState(i)
    clips = torch.from_numpy(rng.rand(B, T, S, S, 3).astype(np.float32))
    me = [torch.from_numpy(np.tile(np.array([0, 2, 5, 7]), (B, 1)))]
    mp = [torch.from_numpy(np.tile(np.array([1, 3, 4, 6]), (B, 1)))]
    return clips, me, mp


def _tensors(state):
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in ("encoder", "predictor", "target_encoder")
           for k, v in sd[m].items()}
    for i, s in sd["optimizer"]["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in s.items()})
    return out


def test_train_state_round_trip_is_bit_exact(tmp_path):
    state, hp = _state(0)
    step = tpre.make_train_step(hp)
    for i in range(2):
        step(state, *_batch(i))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state)

    restored, _ = _state(1)  # other weights, empty moments
    assert restored.optimizer.state_dict()["state"] == {}
    restored = mgr.restore(restored)
    assert restored.step == state.step == 2
    want, got = _tensors(state), _tensors(restored)
    assert sorted(got) == sorted(want)
    assert any(k.endswith("exp_avg_sq") for k in got) and any(k.endswith(".step") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # the next step continues exactly where the original does
    m_a = step(state, *_batch(2))
    m_b = step(restored, *_batch(2))
    assert torch.equal(m_a["loss"], m_b["loss"])
    for k, v in _tensors(state).items():
        assert torch.equal(_tensors(restored)[k], v), k


def test_save_and_load_params_with_retry(tmp_path, monkeypatch):
    path = str(tmp_path / "release" / "encoder.pt")
    save_params(path, {"w": torch.arange(4.0)})
    calls, sleeps = [], []
    load = torch.load

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("storage hiccup")
        return load(*args, **kwargs)

    monkeypatch.setattr(ckpt_mod.torch, "load", flaky)
    monkeypatch.setattr(ckpt_mod.time, "sleep", sleeps.append)
    assert torch.equal(load_params(path)["w"], torch.arange(4.0))
    assert len(calls) == 2 and sleeps == [1.0]
    monkeypatch.setattr(ckpt_mod.torch, "load", lambda *a, **k: (_ for _ in ()).throw(
        OSError("gone")))
    with pytest.raises(OSError, match="gone"):
        load_params(path, retries=3, backoff=2.0)
    assert sleeps == [1.0, 1.0, 2.0, 4.0]
