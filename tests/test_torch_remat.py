"""Activation checkpointing in the port (`models/modules.py`:
`resolve_remat_policy`, `remat_call`, `checkpoint_name`) against its own
no-remat models and against the JAX package's remat models.

Small sizes: 4 frames at 32 px (8 tokens), depth 2, fp32, RoPE. Two routes:
the DN route (encoder 64 wide, 2 heads of 32; predictor 32 wide, 2 heads of
16) and the BHND route (encoder 160 wide, 2 heads of 80; predictor 64 wide,
2 heads of 32, on the DN kernels); both flash routes run their kernels' plain
versions here, through the dispatcher ops the policies see.

For each policy (full, save_attn, save_attn_qkv, save_attn_qkv_h) and route:
* the port's gradients are bit-equal to its own gradients without remat;
* the encoder's gradients are within atol 1e-6 + rtol 1e-4 (of each leaf's
  largest entry, as `test_torch_pretrain_step.py`) of JAX's encoder with
  ``use_activation_checkpointing`` and the same policy (as
  `tests/ops/test_remat_policy.py:218` builds it, ``use_flash=False``);
* the backward recomputes what the policy does not keep: per block with
  gradients, the attention forward (under full only), the qkv GEMM (full and
  save_attn) and the fc1 GEMM (all but save_attn_qkv_h); the EMA-target-like
  forward under ``no_grad`` neither checkpoints nor recomputes.
The fused route (B7, B8) with save_attn_qkv_h behaves as JAX's with
``FUSE_LN_MLP``: it keeps no fc1 pre-activation (B8 recomputes), keeps what
save_attn_qkv keeps (no B7, no attention forward), logs that once, and
computes the same gradients as without remat.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vjepa2_tpu.models.modules import resolve_remat_policy as jax_resolve
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models import modules
from vjepa2_tpu_torch.models.modules import REMAT_SAVES, resolve_remat_policy
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.ops import ln_mlp

S, T, B = 32, 4, 2
POLICIES = ("full", "save_attn", "save_attn_qkv", "save_attn_qkv_h")
# (encoder width, heads, predictor width, heads)
ROUTES = {"dn": (64, 2, 32, 2), "bhnd": (160, 2, 64, 2)}
FUSED = (64, 2, 64, 2)  # B7 and the BHND kernels rope-free at heads of 32
# (qkv, fc1) GEMMs and attention forwards each block with gradients
# recomputes in the backward, by policy
RECOMPUTED = {"none": (0, 0, 0), "full": (1, 1, 1), "save_attn": (1, 1, 0),
              "save_attn_qkv": (0, 1, 0), "save_attn_qkv_h": (0, 0, 0)}


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.rand(B, T, S, S, 3).astype(np.float32)
    me = np.tile(np.array([0, 2, 3, 5, 6]), (B, 1))
    mp = np.tile(np.array([1, 4, 7]), (B, 1))
    return x, me, mp


def _port_models(route, policy, fuse=False):
    ed, eh, pd, ph = FUSED if fuse else ROUTES[route]
    common = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2,
                  uniform_power=True, use_rope=True, use_flash=True,
                  use_activation_checkpointing=policy != "none",
                  remat_policy=None if policy in ("none", "full") else policy,
                  fuse_ln_qkv=fuse, fuse_ln_mlp=fuse)
    enc = VisionTransformer(embed_dim=ed, depth=2, num_heads=eh, **common)
    pred = VisionTransformerPredictor(embed_dim=ed, predictor_embed_dim=pd, depth=2,
                                      num_heads=ph, use_mask_tokens=True, num_mask_tokens=1,
                                      zero_init_mask_tokens=False, **common)
    gen = torch.Generator().manual_seed(0)
    enc.reset_parameters(gen)
    pred.reset_parameters(gen)
    return enc, pred


class _Recomputes(TorchDispatchMode):
    """Counts, while active, the qkv GEMMs, the fc1 GEMMs and the attention
    forwards (told apart by the transposed weight's shape [C, 3C] / [C, 4C])."""

    def __init__(self):
        super().__init__()
        self.qkv = self.fc1 = self.attn = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten, ops = torch.ops.aten, torch.ops.vjepa2
        if func in (ops.flash_fwd_dn.default, ops.flash_fwd_bhnd.default):
            self.attn += 1
        elif func is aten.baddbmm.default:  # the DN route's qkv projection
            self.qkv += 1
        elif func is aten.addmm.default:
            c, n = args[2].shape
            self.qkv += n == 3 * c
            self.fc1 += n == 4 * c
        elif func is ops.ln_qkv.default:
            self.qkv += 1
        return func(*args, **(kwargs or {}))


def _port_grads(route, policy, fuse=False):
    """(encoder + predictor gradients, the recompute counts of the backward,
    the encoder-only gradients)."""
    x, me, mp = _inputs()
    enc, pred = _port_models(route, policy, fuse)
    xt, met, mpt = torch.from_numpy(x), torch.from_numpy(me), torch.from_numpy(mp)
    with torch.no_grad():  # the EMA target's pass: no checkpoint, nothing saved
        count = _Recomputes()
        with count:
            enc(xt)
        assert (count.qkv, count.fc1, count.attn) == (2, 0 if fuse else 2, 2)
    loss = (pred(enc(xt, [met]), met, mpt, 0).float() ** 2).mean()
    count = _Recomputes()
    with count:
        loss.backward()
    grads = [p.grad.clone() for m in (enc, pred) for p in m.parameters()]
    enc.zero_grad()
    (enc(xt, [met]).float() ** 2).mean().backward()
    enc_grads = {k: p.grad.clone() for k, p in enc.named_parameters()}
    return grads, (count.qkv, count.fc1, count.attn), enc_grads, enc


def _jax_encoder_grads(route, policy):
    ed, eh, _, _ = ROUTES[route]
    x, me, _ = _inputs()
    jx, jme = jnp.asarray(x), jnp.asarray(me)
    enc = JaxViT(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=ed,
                 depth=2, num_heads=eh, uniform_power=True, use_rope=True,
                 use_activation_checkpointing=True, remat_policy=policy, dtype=jnp.float32)
    variables = enc.init(jax.random.PRNGKey(0), jx, [jme])

    def loss(params):
        return (enc.apply({"params": params}, jx, [jme]).astype(jnp.float32) ** 2).mean()

    grads = jax.block_until_ready(jax.jit(jax.grad(loss))(variables["params"]))
    return variables, grads


def test_resolve_remat_policy_names_and_error():
    assert resolve_remat_policy(None) == resolve_remat_policy("full") == frozenset()
    assert jax_resolve(None) is None and jax_resolve("full") is None
    assert resolve_remat_policy("save_attn") == {"flash_out", "flash_lse"}
    assert resolve_remat_policy("save_attn_qkv") == {"flash_out", "flash_lse", "flash_qkv"}
    assert resolve_remat_policy("save_attn_qkv_h") == {"flash_out", "flash_lse", "flash_qkv",
                                                       "mlp_h"}
    assert set(REMAT_SAVES) == {"save_attn", "save_attn_qkv", "save_attn_qkv_h"}
    for name in REMAT_SAVES:
        assert jax_resolve(name) is not None
    with pytest.raises(ValueError) as port_err:
        resolve_remat_policy("save_everything")
    with pytest.raises(ValueError) as jax_err:
        jax_resolve("save_everything")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_bit_equal_and_match_jax(route, policy):
    ref, counts_ref, _, _ = _port_grads(route, "none")
    grads, counts, enc_grads, enc = _port_grads(route, policy)
    assert counts_ref == (0, 0, 0)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)
    # 4 blocks with gradients: 2 encoder, 2 predictor
    assert counts == tuple(4 * n for n in RECOMPUTED[policy]), counts

    variables, grads_j = _jax_encoder_grads(route, policy)
    # the port's encoder from JAX's initial weights, under the same policy
    enc.load_state_dict(state_dict_from_flax(variables))
    enc.zero_grad()
    x, me, _ = _inputs()
    (enc(torch.from_numpy(x), [torch.from_numpy(me)]).float() ** 2).mean().backward()
    want = {k: np.asarray(v) for k, v in state_dict_from_flax(grads_j).items()}
    assert sorted(want) == sorted(k for k, _ in enc.named_parameters())
    for k, p in enc.named_parameters():
        tol = 1e-4 * np.abs(want[k]).max()
        np.testing.assert_allclose(p.grad.numpy(), want[k], atol=1e-6 + tol, rtol=1e-4,
                                   err_msg=k)
    del enc_grads


def test_fused_save_attn_qkv_h_acts_as_save_attn_qkv(monkeypatch, caplog):
    calls = []
    fwd = ln_mlp._fwd
    monkeypatch.setattr(ln_mlp, "_fwd", lambda *a: calls.append(1) or fwd(*a))
    monkeypatch.setattr(modules, "_FUSED_MLP_H_LOGGED", False)
    ref, counts_ref, _, _ = _port_grads("fused", "none", fuse=True)
    with caplog.at_level(logging.INFO, logger="vjepa2_tpu_torch.models.modules"):
        calls.clear()
        grads_h, counts_h, _, _ = _port_grads("fused", "save_attn_qkv_h", fuse=True)
    assert sum("keeps what 'save_attn_qkv' keeps" in r.message for r in caplog.records) == 1
    b8_calls_h = len(calls)
    calls.clear()
    grads_qkv, counts_qkv, _, _ = _port_grads("fused", "save_attn_qkv", fuse=True)
    # B7 and the attention forward are kept, B8 (no "mlp_h") recomputes
    assert counts_ref == (0, 0, 0)
    assert counts_h == counts_qkv == (0, 0, 0)
    assert b8_calls_h == len(calls)
    # B8 runs in the no-grad pass (2 blocks), the forward of the 4 blocks
    # with gradients and their recompute, then the encoder's 2 and theirs
    assert b8_calls_h == 2 + (4 + 4) + (2 + 2), b8_calls_h
    for g, q, r in zip(grads_h, grads_qkv, ref):
        assert torch.equal(g, r) and torch.equal(q, r)
