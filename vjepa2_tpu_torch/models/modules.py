"""Transformer building blocks (counterpart of `vjepa2_tpu/models/modules.py`).

Parameters keep the reference's state-dict names (`attn.qkv.weight`,
`mlp.fc1.bias`, `norm1.weight`, ...) and live in fp32; each module computes
in its ``dtype`` (the JAX package's ``param_dtype=float32`` plus ``dtype``).
LayerNorm runs in fp32 whatever the compute dtype.

Attention has four routes, as in JAX:
* the fused LayerNorm route (``ln=(gamma, beta)``, from `Block` with
  ``fuse_ln_qkv``; JAX's ``FUSE_LN_QKV``, `modules.py:498-515`): the
  pre-attention LayerNorm, the qkv projection and the split-half RoPE run as
  one kernel (B7, `ops/ln_qkv.py`) and attention runs the BHND flash kernels
  rope-free at any width they take (32-104); it comes before the DN route;
* the DN route (``use_flash``, head width 16-64): the qkv projection emits
  [B, H, Dh, N] directly and attention runs the DN flash kernels B1/B2
  (`ops/flash_attention_dn.py`);
* the BHND route (``use_flash``, head width 80, 88 or 104: ViT-H, the
  16-head ViT-g): q, k and v are [B, H, N, Dh] views of the qkv output
  [B, N, 3, H, Dh], with no copy, and attention runs the BHND flash kernels
  B3/B4-B5 (`ops/flash_attention.py`), whose output is laid out as the
  projection reads it;
* the plain route: [B, H, N, Dh] operands and the plain attention math,
  with interleaved-convention RoPE tables.
On both flash routes the split-half RoPE permutation is applied to the q and
k rows of ``qkv.weight`` (v stays canonical); JAX applies it to the
activations on the BHND route (`modules.py:483-487`), which is the same
function.

With ``fuse_ln_mlp`` (JAX's ``FUSE_LN_MLP``) the pre-MLP LayerNorm, fc1 and
GELU run as one kernel (B8, `ops/ln_mlp.py`). Both fusions are off by
default, as in JAX; `parse_ln_fusions` reads the ``--fuse-ln`` list. The
fused LayerNorm uses the two-pass variance, the unfused module the fast one,
so the two routes differ by that rounding, as in JAX.

Gradients come from autograd, through the kernels' `autograd.Function`s on
the flash and fused routes.

Activation checkpointing (`remat_call`, JAX's ``nn.remat(Block, policy=)``)
runs a block under `torch.utils.checkpoint` (non-reentrant) and recomputes
it in the backward. The policies of `resolve_remat_policy` keep some
tensors instead, by the names JAX gives them: the flash kernels' (out, lse)
are the outputs of the dispatcher ops ``torch.ops.vjepa2.flash_fwd_dn`` and
``flash_fwd_bhnd``; q, k and v ("flash_qkv") and the fc1 pre-activation
("mlp_h") are the outputs of the one GEMM (or of B7, ``torch.ops.vjepa2.ln_qkv``)
that a `checkpoint_name` region encloses. A selective checkpoint context
caches those outputs in the forward and hands them back in the recompute,
which then launches neither the kernel nor the GEMM.

The AC predictor's blocks (`ACBlock`, `ACAttention`; JAX `modules.py:629-909`)
reuse `Attention`'s projections and routes with frame-causal segment ids.

Not ported yet: drop_path, context parallelism and SwiGLU.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import threading

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from vjepa2_tpu_torch.ops.attention import attend_bhdn, attend_bhnd, sdpa
from vjepa2_tpu_torch.ops.flash_attention import BHND_HEAD_WIDTHS, bhnd_head_supported
from vjepa2_tpu_torch.ops.flash_attention_dn import dn_head_eligible
from vjepa2_tpu_torch.ops.ln_mlp import ln_mlp
from vjepa2_tpu_torch.ops.ln_qkv import ln_qkv
from vjepa2_tpu_torch.ops.rope import expand_rope_cache, rope_from_ids, separate_positions

# std of a standard normal truncated to [-2, 2]; JAX's truncated_normal
# divides by it so the truncated draw has the requested std
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float = 0.02, scale: float = 1.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """In-place init as JAX's ``truncated_normal(std, lower=-2, upper=2)``,
    times ``scale`` (the residual rescale at init)."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(std / _TRUNC_STD * scale)


def init_linear_(layer: nn.Linear, std: float = 0.02, scale: float = 1.0,
                 generator: torch.Generator | None = None) -> None:
    trunc_normal_(layer.weight, std, scale, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (fp32 parameters cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def parse_ln_fusions(csv: str) -> tuple[bool, bool]:
    """(fuse_ln_qkv, fuse_ln_mlp) from a comma list ('qkv,mlp', 'qkv', 'mlp',
    or '' for neither): the counterpart of JAX's `set_ln_fusions`
    (`vjepa2_tpu/models/modules.py:88`), which sets module globals where the
    port passes the flags to the blocks' constructors."""
    sel = {s.strip() for s in csv.split(",") if s.strip()}
    unknown = sel - {"qkv", "mlp"}
    if unknown:
        raise ValueError(f"unknown LN fusion(s) {sorted(unknown)}: "
                         "expected a comma list drawn from 'qkv','mlp'")
    return "qkv" in sel, "mlp" in sel


def qkv_row_perm(head_perm, num_heads: int, head_dim: int, device=None) -> torch.Tensor:
    """Row order of ``qkv.weight`` ([3*dim, C]) that applies the split-half
    head permutation to the q and k thirds and leaves v alone:
    new row (part, h, d) = old row (part, h, head_perm[d]) for q and k."""
    dim = num_heads * head_dim
    heads = np.arange(num_heads)[:, None] * head_dim
    qk = (heads + np.asarray(head_perm)[None, :]).reshape(-1)
    idx = np.concatenate([qk, dim + qk, 2 * dim + np.arange(dim)])
    return torch.as_tensor(idx, dtype=torch.long, device=device)


logger = logging.getLogger(__name__)

# What each remat policy keeps, by JAX's names (`save_only_these_names`,
# `vjepa2_tpu/models/modules.py:102-134`); None and 'full' keep nothing.
REMAT_SAVES = {
    "save_attn": frozenset({"flash_out", "flash_lse"}),
    "save_attn_qkv": frozenset({"flash_out", "flash_lse", "flash_qkv"}),
    "save_attn_qkv_h": frozenset({"flash_out", "flash_lse", "flash_qkv", "mlp_h"}),
}


def resolve_remat_policy(name) -> frozenset:
    """The names a remat policy keeps (`modules.py:102`): None / 'full'
    recompute the whole block (nothing kept); 'save_attn' keeps the flash
    kernels' (out, lse), so the backward never launches the attention
    forward again; 'save_attn_qkv' also keeps q, k and v; 'save_attn_qkv_h'
    also keeps the MLP's fc1 pre-activation. Only blocks that take gradients
    save anything."""
    if name in (None, "full"):
        return frozenset()
    if name in REMAT_SAVES:
        return REMAT_SAVES[name]
    raise ValueError(
        f"unknown remat_policy {name!r}: expected one of "
        "None/'full', 'save_attn', 'save_attn_qkv', 'save_attn_qkv_h'")


_FUSED_MLP_H_LOGGED = False


def block_remat(use_activation_checkpointing: bool, remat_policy, fuse_ln_mlp: bool = False):
    """The ``saves`` a model passes to `remat_call`: None without activation
    checkpointing, else `resolve_remat_policy`'s names. With the fused MLP
    route (B8) 'save_attn_qkv_h' has no fc1 pre-activation to keep and keeps
    what 'save_attn_qkv' keeps, as JAX's does with ``FUSE_LN_MLP`` on; that
    is logged once."""
    global _FUSED_MLP_H_LOGGED
    if not use_activation_checkpointing:
        return None
    saves = resolve_remat_policy(remat_policy)
    if fuse_ln_mlp and "mlp_h" in saves and not _FUSED_MLP_H_LOGGED:
        _FUSED_MLP_H_LOGGED = True
        logger.info("remat_policy 'save_attn_qkv_h' with the fused MLP route: B8 keeps no "
                    "fc1 pre-activation, so the policy keeps what 'save_attn_qkv' keeps")
    return saves


# The checkpoint name of the ops this thread runs now (`checkpoint_name`).
_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the GEMM (``addmm``, ``baddbmm``, ``mm``, ``bmm``) or the B7 op run
    inside with ``name`` for the remat policy (JAX's `checkpoint_name`): each
    region encloses exactly one of them, whose output is the named tensor.
    Without gradients nothing checkpoints (`remat_call`), so nothing is
    tagged, and a trace without them (`torch.export`, whose CEM loop body
    dynamo traces) never touches the thread-local."""
    if not torch.is_grad_enabled():
        yield
        return
    prev = getattr(_TAG, "name", None)
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = prev


def _remat_policy(saves: frozenset):
    aten = torch.ops.aten
    flash = ({torch.ops.vjepa2.flash_fwd_dn.default, torch.ops.vjepa2.flash_fwd_bhnd.default}
             if "flash_out" in saves else set())
    producers = {aten.addmm.default, aten.baddbmm.default, aten.mm.default, aten.bmm.default,
                 torch.ops.vjepa2.ln_qkv.default}

    def policy(ctx, func, *args, **kwargs):
        if func in flash or (getattr(_TAG, "name", None) in saves and func in producers):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_call(block: nn.Module, saves, *args):
    """``block(*args)``, under activation checkpointing when ``saves`` is not
    None and autograd records (a block without gradients, such as the EMA
    target's, neither checkpoints nor recomputes). ``saves``: the names the
    policy keeps (`block_remat`); empty recomputes the whole block. The
    blocks draw no random numbers, so no RNG state is stashed."""
    if saves is None or not torch.is_grad_enabled():
        return block(*args)
    kwargs = {"context_fn": _remat_policy(saves)} if saves else {}
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


class LayerNorm(nn.Module):
    """LayerNorm in fp32 whatever the input dtype (eps 1e-6), with JAX's
    fast-variance formula: var = max(E[x^2] - E[x]^2, 0)
    (`vjepa2_tpu/models/modules.py:184-188`). Output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(self.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2; with ``ln=(gamma, beta)`` the input is the
    pre-LayerNorm stream and LN -> fc1 -> GELU runs as B8 (`ops/ln_mlp.py`)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int | None = None,
                 dtype=torch.float32, device=None, init_std: float = 0.02,
                 out_init_scale: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.out_init_scale = out_init_scale
        self.fc1 = nn.Linear(in_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim or in_dim, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_linear_(self.fc1, self.init_std, 1.0, generator)
        init_linear_(self.fc2, self.init_std, self.out_init_scale, generator)

    def forward(self, x: torch.Tensor, ln=None) -> torch.Tensor:
        if ln is not None:  # no "mlp_h" here, as in JAX (`modules.py:228-238`)
            h = ln_mlp(x, ln[0], ln[1], self.fc1.weight.to(self.dtype), self.fc1.bias.float())
            return dense(self.fc2, h, self.dtype)
        with checkpoint_name("mlp_h"):
            h = dense(self.fc1, x, self.dtype)
        return dense(self.fc2, F.gelu(h), self.dtype)


class Attention(nn.Module):
    """Self-attention with optional factorized 3D RoPE.

    With ``use_flash`` the layer takes the DN route (head width 16-64) or the
    BHND route (head width 80, 88 or 104), as JAX's `modules.py:515-546`
    does, whatever the dtype and the device: on the card bf16 and fp32
    operands each have their kernels on both routes (the DN route's fp32
    ones take RoPE tables shared or per example, kv_valid, and
    `ACAttention`'s frame-causal segment ids with the stack pad's keys on
    `PAD_SEGMENT`). With RoPE it needs the split-half ``rope_expanded``
    tables and the matching ``qkv_perm`` (`qkv_row_perm`). Other widths have
    no flash kernel and raise. Without ``use_flash`` it takes the plain
    route, with RoPE from the interleaved ``rope_cache``.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, use_rope: bool = False,
                 use_flash: bool = False, dtype=torch.float32, device=None,
                 init_std: float = 0.02, proj_init_scale: float = 1.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.use_rope, self.use_flash = use_rope, use_flash
        self.dtype = dtype
        self.init_std, self.proj_init_scale = init_std, proj_init_scale
        if use_flash and not (dn_head_eligible(self.head_dim)
                              or bhnd_head_supported(self.head_dim)):
            raise NotImplementedError(
                f"use_flash at head width {self.head_dim}: the flash kernels take 16, 32, 48 "
                f"and 64 (DN) and {', '.join(map(str, BHND_HEAD_WIDTHS))} (BHND)")
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_linear_(self.qkv, self.init_std, 1.0, generator)
        init_linear_(self.proj, self.init_std, self.proj_init_scale, generator)

    def forward(self, x, rope_cache=None, rope_expanded=None, qkv_perm=None, kv_valid=None,
                ln=None, segment_ids=None):
        """``kv_valid``: the number of real tokens when the model stack-padded
        the sequence; keys at or past it are masked (pad query rows are the
        model's to slice off). ``ln=(gamma, beta)``: x is the pre-LayerNorm
        stream and the fused route runs (B7, then the BHND flash kernels
        rope-free); `Block` passes it only with ``use_flash``.
        ``segment_ids`` ([N] int): query i attends key j iff seg[i] >=
        seg[j] (`ACAttention`'s frame-causal ids), on the plain, DN and BHND
        routes."""
        if ln is not None:
            return self._fused_forward(x, ln, rope_expanded, qkv_perm, kv_valid)
        B, N, C = x.shape
        H, Dh, dt = self.num_heads, self.head_dim, self.dtype
        if not self.use_flash:
            if self.use_rope and rope_cache is None:
                raise ValueError("the plain route with RoPE needs rope_cache")
            q, k, v = dense(self.qkv, x, dt).view(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)
            out = attend_bhnd(q, k, v, rope_cache=rope_cache if self.use_rope else None,
                              segment_ids=segment_ids, kv_valid=kv_valid)
            return dense(self.proj, out.transpose(1, 2).reshape(B, N, C), dt)
        if self.use_rope and (rope_expanded is None or qkv_perm is None):
            raise ValueError("the flash routes with RoPE need rope_expanded and qkv_perm")
        w, b = self.qkv.weight, self.qkv.bias
        if self.use_rope:
            w = w[qkv_perm]
            b = None if b is None else b[qkv_perm]
        rope = rope_expanded if self.use_rope else None
        if dn_head_eligible(Dh):
            # contract straight into [B, 3*dim, N]: q, k, v come out [B, H, Dh, N]
            wt, xt = w.to(dt).expand(B, -1, -1), x.to(dt).transpose(1, 2)
            bt = None if b is None else b.to(dt)[:, None]
            with checkpoint_name("flash_qkv"):
                y = torch.bmm(wt, xt) if bt is None else torch.baddbmm(bt, wt, xt)
            q, k, v = y.view(B, 3, H, Dh, N).unbind(1)
            out = attend_bhdn(q, k, v, rope_expanded=rope, use_flash=True, kv_valid=kv_valid,
                              segment_ids=segment_ids)
            out = out.permute(0, 3, 1, 2).reshape(B, N, C)  # rows (h, d), as proj expects
        else:
            xt, wt, bt = x.to(dt), w.to(dt), None if b is None else b.to(dt)
            with checkpoint_name("flash_qkv"):
                y = F.linear(xt, wt, bt)
            q, k, v = y.view(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4).unbind(0)
            out = attend_bhnd(q, k, v, rope_expanded=rope, use_flash=True, kv_valid=kv_valid,
                              segment_ids=segment_ids)
            out = out.transpose(1, 2).reshape(B, N, C)  # a view of the kernel's output
        return dense(self.proj, out, dt)

    def _fused_forward(self, x, ln, rope_expanded, qkv_perm, kv_valid):
        """LN + qkv + RoPE as one kernel (B7; the bias in fp32, the q/k rows
        permuted to the split-half layout under RoPE), then attention
        rope-free (`modules.py:498-515`)."""
        B, N, C = x.shape
        w, b = self.qkv.weight, self.qkv.bias
        rope = rope_expanded if self.use_rope else None
        if self.use_rope:
            if rope_expanded is None or qkv_perm is None:
                raise ValueError("the fused route with RoPE needs rope_expanded and qkv_perm")
            w = w[qkv_perm]
            b = None if b is None else b[qkv_perm]
        b = torch.zeros(3 * self.dim, device=w.device) if b is None else b.float()
        w = w.to(self.dtype)
        with checkpoint_name("flash_qkv"):
            q, k, v = ln_qkv(x, ln[0], ln[1], w, b, rope, num_heads=self.num_heads,
                             head_dim=self.head_dim)
        out = attend_bhnd(q, k, v, use_flash=self.use_flash, kv_valid=kv_valid)
        return dense(self.proj, out.transpose(1, 2).reshape(B, N, C), self.dtype)


class Block(nn.Module):
    """Pre-norm transformer block (reference `modules.py:500-563`).

    ``fuse_ln_qkv`` / ``fuse_ln_mlp``: run norm1 inside B7 and norm2 inside B8
    (JAX's ``FUSE_LN_QKV`` / ``FUSE_LN_MLP``, `modules.py:794-846`). The qkv
    fusion applies only on the flash route with RoPE off or pre-expanded;
    the MLP fusion whenever its flag is on. The state dict is the same
    either way."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 use_rope: bool = False, use_flash: bool = False, layer_id: int = 0,
                 dtype=torch.float32, device=None, init_std: float = 0.02,
                 fuse_ln_qkv: bool = False, fuse_ln_mlp: bool = False):
        super().__init__()
        self.fuse_ln_qkv, self.fuse_ln_mlp = fuse_ln_qkv, fuse_ln_mlp
        rescale = 1.0 / math.sqrt(2.0 * (layer_id + 1))
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, use_rope, use_flash, dtype, device,
                              init_std, proj_init_scale=rescale)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device,
                       init_std=init_std, out_init_scale=rescale)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.norm1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x, rope_cache=None, rope_expanded=None, qkv_perm=None, kv_valid=None):
        # the gate of `modules.py:798-805`; the port has no mask, causal or CP route here
        fuse_qkv = (self.fuse_ln_qkv and self.attn.use_flash
                    and (not self.attn.use_rope or rope_expanded is not None))
        if fuse_qkv:
            x = x + self.attn(x, rope_cache, rope_expanded, qkv_perm, kv_valid,
                              ln=(self.norm1.weight, self.norm1.bias))
        else:
            x = x + self.attn(self.norm1(x), rope_cache, rope_expanded, qkv_perm, kv_valid)
        if self.fuse_ln_mlp:
            return x + self.mlp(x, ln=(self.norm2.weight, self.norm2.bias))
        return x + self.mlp(self.norm2(x))


# The segment id of stack-pad tokens in a frame-causal sequence: no real
# query (seg < it) attends a pad key; the pad query rows are sliced off. The
# DN wrappers take no kv_valid with segment ids (`flash_attention_dn._normalize`).
PAD_SEGMENT = torch.iinfo(torch.int32).max


def build_ac_rope_cache(head_dim: int, T: int, h_patches: int, w_patches: int,
                        cond_tokens: int, grid_size: int, device=None):
    """Interleaved-convention (cos, sin) [T * (A + HW), rot] for the AC
    sequence (JAX `modules.py:629`): per frame t, A conditioning tokens with
    ids (t, 0, 0), then the HW frame tokens with (t, row * snap, col * snap),
    snap = grid_size / patches."""
    A, HW = cond_tokens, h_patches * w_patches
    frame, row, col = separate_positions(torch.arange(T * HW, device=device), h_patches,
                                         w_patches)
    row = row.to(torch.float32) * (grid_size / h_patches)
    col = col.to(torch.float32) * (grid_size / w_patches)
    cond_t = torch.arange(T, dtype=torch.float32, device=device)[:, None].expand(T, A)
    zeros = torch.zeros(T, A, device=device)

    def interleave(frame_vals, cond_vals):
        return torch.cat([cond_vals, frame_vals.reshape(T, HW)], dim=1).reshape(-1)

    return rope_from_ids(interleave(frame.to(torch.float32), cond_t), interleave(row, zeros),
                         interleave(col, zeros), head_dim)


def ac_rope_tables(head_dim: int, num_heads: int, T: int, h_patches: int, w_patches: int,
                   cond_tokens: int, grid_size: int, use_flash: bool, device=None, pad: int = 0):
    """(rope_cache, rope_expanded, qkv_perm) of an AC sequence, as
    `vision_transformer.rope_tables` gives them for the encoder: the
    interleaved cache for the plain route, or the split-half tables (``pad``
    zero rows appended for the stack pad) and the qkv row permutation."""
    cache = build_ac_rope_cache(head_dim, T, h_patches, w_patches, cond_tokens, grid_size,
                                device)
    if not use_flash:
        return cache, None, None
    (cos, sin), perm = expand_rope_cache(cache, head_dim)
    if pad:
        cos, sin = F.pad(cos, (0, 0, 0, pad)), F.pad(sin, (0, 0, 0, pad))
    return None, (cos, sin), qkv_row_perm(perm, num_heads, head_dim, device)


def frame_segments(T: int, tokens_per_frame: int, device=None, pad: int = 0) -> torch.Tensor:
    """Frame-causal segment ids [T * tokens_per_frame + pad] int32: each
    token its frame's index, ``pad`` trailing tokens `PAD_SEGMENT`."""
    seg = torch.arange(T * tokens_per_frame, device=device, dtype=torch.int32)
    seg = seg // tokens_per_frame
    return F.pad(seg, (0, pad), value=PAD_SEGMENT) if pad else seg


class ACAttention(Attention):
    """Attention over interleaved (conditioning + frame) tokens, frame-causal
    (JAX `modules.py:660`): [B, T * (A + HW), C], A conditioning tokens
    leading each frame group. The projections and routes are `Attention`'s
    (state-dict names ``qkv.*`` and ``proj.*``), always with RoPE; query i
    attends key j iff frame(i) >= frame(j), as segment ids. JAX's
    ``is_frame_causal=False`` (full attention) has no caller and is not
    ported.

    The model hands in the tables and ids it built once for all its blocks
    (stack-padded on the flash routes); called alone, the layer builds them
    for the unpadded sequence.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, grid_size: int = 16,
                 use_flash: bool = False, dtype=torch.float32, device=None,
                 init_std: float = 0.02, proj_init_scale: float = 1.0):
        super().__init__(dim, num_heads, qkv_bias, True, use_flash, dtype, device, init_std,
                         proj_init_scale)
        self.grid_size = grid_size

    def forward(self, x, T: int, h_patches: int, w_patches: int, cond_tokens: int,
                rope_cache=None, rope_expanded=None, qkv_perm=None, segment_ids=None):
        if rope_cache is None and rope_expanded is None:
            rope_cache, rope_expanded, qkv_perm = ac_rope_tables(
                self.head_dim, self.num_heads, T, h_patches, w_patches, cond_tokens,
                self.grid_size, self.use_flash, x.device)
            segment_ids = frame_segments(T, cond_tokens + h_patches * w_patches, x.device)
        return super().forward(x, rope_cache, rope_expanded, qkv_perm,
                               segment_ids=segment_ids)


class ACBlock(nn.Module):
    """Pre-norm block with `ACAttention` (JAX `modules.py:858`); with
    ``fuse_ln_mlp`` norm2, fc1 and GELU run as B8 (JAX's ``FUSE_LN_MLP``,
    `modules.py:906-914`). State-dict names as `Block`'s."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 grid_size: int = 16, use_flash: bool = False, layer_id: int = 0,
                 dtype=torch.float32, device=None, init_std: float = 0.02,
                 fuse_ln_mlp: bool = False):
        super().__init__()
        self.fuse_ln_mlp = fuse_ln_mlp
        rescale = 1.0 / math.sqrt(2.0 * (layer_id + 1))
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = ACAttention(dim, num_heads, qkv_bias, grid_size, use_flash, dtype, device,
                                init_std, proj_init_scale=rescale)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device,
                       init_std=init_std, out_init_scale=rescale)

    reset_parameters = Block.reset_parameters

    def forward(self, x, T: int, h_patches: int, w_patches: int, cond_tokens: int,
                rope_cache=None, rope_expanded=None, qkv_perm=None, segment_ids=None):
        x = x + self.attn(self.norm1(x), T, h_patches, w_patches, cond_tokens, rope_cache,
                          rope_expanded, qkv_perm, segment_ids)
        if self.fuse_ln_mlp:
            return x + self.mlp(x, ln=(self.norm2.weight, self.norm2.bias))
        return x + self.mlp(self.norm2(x))


class CrossAttention(nn.Module):
    """Query tokens cross-attend into a sequence (reference `modules.py:566-594`;
    no output projection, as in the reference)."""

    def __init__(self, dim: int, num_heads: int = 12, qkv_bias: bool = True,
                 dtype=torch.float32, device=None, init_std: float = 0.02):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.init_std = init_std
        self.q = nn.Linear(dim, dim, bias=qkv_bias, device=device)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_linear_(self.q, self.init_std, 1.0, generator)
        init_linear_(self.kv, self.init_std, 1.0, generator)

    def forward(self, q, x):
        B, n, C = q.shape
        N = x.shape[1]
        H = self.num_heads
        qh = dense(self.q, q, self.dtype).view(B, n, H, C // H)
        kv = dense(self.kv, x, self.dtype).view(B, N, 2, H, C // H)
        return sdpa(qh, kv[:, :, 0], kv[:, :, 1]).reshape(B, n, C)


class CrossAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dtype=torch.float32, device=None, init_std: float = 0.02,
                 mlp_init_scale: float = 1.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.xattn = CrossAttention(dim, num_heads, qkv_bias, dtype, device, init_std)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device,
                       init_std=init_std, out_init_scale=mlp_init_scale)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.norm1.reset_parameters()
        self.xattn.reset_parameters(generator)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, q, x):
        q = q + self.xattn(q, self.norm1(x))
        return q + self.mlp(self.norm2(q))
