"""Flash attention over [B, H, N, D] ("BHND") operands — kernels B3, B4 and B5.

Counterpart of `vjepa2_tpu/ops/flash_attention.py`: the forward
(`_fwd_kernel:166`, `_flash_fwd_bhnd:257`), both backwards (the one-pass
`_bwd_fused_kernel:511` and the two-pass `_dq_kernel:361` / `_dkv_kernel:434`,
chosen in `_flash_bwd_bhnd:613` by a TPU scoped-VMEM rule), and the
differentiable entry points `flash_attention_bhnd:988` and the BNHD
`flash_attention:1148`. JAX runs them in the operands' dtype; so does the
port: bf16 and fp32 operands each have their kernels.

`flash_attention_bhnd` is a `torch.autograd.Function` (`FlashAttentionBHND`):
its forward saves (q, k, v, out, lse) and its backward is
`flash_attention_bhnd_bwd`. On a CUDA tensor each launches its hand-written
Hopper kernel or raises: bf16 operands `csrc/flash_fwd_bhnd.cu` and
`csrc/flash_bwd_bhnd.cu`; fp32 operands `csrc/flash_fp32.cuh` (3xTF32 on
the tensor cores after a split pre-pass that also rotates q and k). Both
take every feature: RoPE, kv_valid, segment ids with key-side ids of their
own and the causal mask. On a CPU tensor they run
`flash_attention_bhnd_plain` and `flash_attention_bhnd_bwd_plain`, the plain
versions of both. There is no other route. One CUDA backward
serves both TPU backwards: it computes their one function, with no gate.
Segment ids and RoPE tables stay outside autograd: they get no gradient.

The TPU-only pieces have no counterpart: block plans (`pick_block`,
`FWD_CAP_WIDE`, `block_h`), the fp32 segment columns and `_seg_mask` (the
CUDA kernels compare int32 ids as integers, where the TPU kernels cast them
to fp32, exact only below 2**24), and `_mosaic_available`. A row with no key
to attend gives output 0 and lse -inf (the TPU kernel's finite -1e30 mask
averages v there).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from vjepa2_tpu_torch import _build
from vjepa2_tpu_torch.ops.attention import attention_mask, softmax_attention
from vjepa2_tpu_torch.ops.rope import expand_rope_tables, rope_rotate, rope_rotate_t

# Head widths the CUDA kernels take: ViT-H 1280/16, vit_giant 1408/16,
# vit_gigantic 1664/16, and the ViT-L encoder's 64 and the predictor's 32,
# which the fused LayerNorm route (`models.modules.Attention`, ``ln=``) sends
# here rope-free; the unfused route sends heads of 16-64 to the DN kernels
# (`flash_attention_dn`).
BHND_HEAD_WIDTHS = (32, 64, 80, 88, 104)

# Kernel launches since the last reset, forward (B3) and backward (B4/B5),
# bf16 and fp32 apart; `chip_smoke.py` reads them to show the main path went
# through the kernels.
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_FP32 = 0
LAUNCHES_BWD_FP32 = 0


def bhnd_head_supported(d: int) -> bool:
    """Whether the CUDA kernels take head width ``d``."""
    return d in BHND_HEAD_WIDTHS


def _batch_ids(ids, batch: int, length: int, name: str):
    """[N] / [1, N] / [B, N] integer ids -> [B, N], broadcast explicitly."""
    ids = ids if ids.ndim == 2 else ids[None]
    if ids.shape[1] != length or ids.shape[0] not in (1, batch):
        raise ValueError(f"{name} {tuple(ids.shape)} do not fit [{batch}, {length}]")
    if ids.is_floating_point():
        raise TypeError(f"{name} must be integers (they compare exactly)")
    return ids.expand(batch, length)


def _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len):
    """Validate the arguments; return (cos, sin, seg_q [B, N], seg_k [B, M])."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, H, N, D]")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if segment_ids is not None and causal:
        # the kernels apply segments or token-causal, as in JAX (`:1033-1039`);
        # frame-causal attention rides segment ids alone
        raise ValueError("segment_ids and causal=True cannot be combined; encode "
                         "causality in the segment ids instead")
    if kv_valid_len is not None and not 0 < kv_valid_len <= M:
        raise ValueError(f"kv_valid_len {kv_valid_len} outside (0, {M}]")
    seg_q = seg_k = None
    if segment_ids is not None:
        seg_q = _batch_ids(segment_ids, B, N, "segment_ids")
        if seg_kv is not None:
            seg_k = _batch_ids(seg_kv, B, M, "seg_kv")
        elif N == M:
            seg_k = seg_q
        else:
            raise ValueError("segment_ids with N != M need seg_kv for the keys")
    elif seg_kv is not None:
        raise ValueError("seg_kv without segment_ids: give the query side's ids too")
    cos = sin = None
    if rope_expanded is not None:
        cos, sin = rope_expanded
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        if (N != M or tuple(cos.shape[1:]) != (N, D) or sin.shape != cos.shape
                or cos.shape[0] not in (1, B)):
            raise ValueError(f"rope tables {tuple(cos.shape)} do not fit q {tuple(q.shape)}")
    return cos, sin, seg_q, seg_k


def _expand(q, k, rope_tables):
    """Interleaved-convention tables [N|B, N, rot] -> (q and k permuted to the
    split-half layout, the split-half fp32 tables, the permutation)."""
    cos, sin = rope_tables
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin, perm = expand_rope_tables(cos, sin, q.shape[-1])
    perm = torch.as_tensor(perm, device=q.device)
    return q[..., perm], k[..., perm], (cos.float(), sin.float()), perm


def _mask(n, m, device, seg_q, seg_k, causal, kv_valid_len):
    mask = attention_mask(n, m, device, kv_valid_len)
    if seg_q is not None:
        seg = seg_q.to(device)[:, None, :, None] >= seg_k.to(device)[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if causal:
        tri = torch.ones(n, m, dtype=torch.bool, device=device).tril()
        mask = tri if mask is None else mask & tri
    return mask


def _rotated(q, k, cos, sin, dtype=None):
    """q and k rotated in fp32 and rounded to their dtype (then cast to
    ``dtype``), as the kernels' prologues round them."""
    if cos is None:
        return (q, k) if dtype is None else (q.to(dtype), k.to(dtype))
    cos = cos.to(device=q.device, dtype=torch.float32)[:, None]
    sin = sin.to(device=q.device, dtype=torch.float32)[:, None]
    qr = rope_rotate(q.float(), cos, sin).to(q.dtype)
    kr = rope_rotate(k.float(), cos, sin).to(k.dtype)
    return (qr, kr) if dtype is None else (qr.to(dtype), kr.to(dtype))


def _plain_fwd(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    qr, kr = _rotated(q, k, cos, sin)
    mask = _mask(q.shape[2], k.shape[2], q.device, seg_q, seg_k, causal, kv_valid_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return softmax_attention(qr, kr, v, scale, mask)


def _plain_bwd(q, k, v, out, lse, do, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    qr, kr = _rotated(q, k, cos, sin, torch.float32)
    vf, of, dof = v.float(), out.float(), do.float()
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    lse = lse.float()[..., None]
    p = torch.exp(torch.matmul(qr, kr.transpose(-1, -2)) * scale - lse)
    keep = ~torch.isneginf(lse)
    mask = _mask(q.shape[2], k.shape[2], q.device, seg_q, seg_k, causal, kv_valid_len)
    if mask is not None:
        keep = keep & mask
    p = torch.where(keep, p, 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qr)
    dq = torch.matmul(ds, kr)
    if cos is not None:
        cos = cos.to(device=q.device, dtype=torch.float32)[:, None]
        sin = sin.to(device=q.device, dtype=torch.float32)[:, None]
        dq = rope_rotate_t(dq, cos, sin)
        dk = rope_rotate_t(dk, cos, sin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bhnd_plain(q, k, v, segment_ids=None, causal: bool = False,
                               scale: float | None = None, rope_tables=None, rope_expanded=None,
                               kv_valid_len: int | None = None, seg_kv=None):
    """Plain PyTorch version of the kernel: (out [B, H, N, D], lse [B, H, N]).

    RoPE rotates q and k in fp32 and rounds them to the compute dtype; the
    scores take the scale in fp32 (the kernel instead folds scale*log2(e)
    into q before rounding, `flash_attention.py:209-217`).
    """
    if rope_tables is not None:
        q, k, rope_expanded, _ = _expand(q, k, rope_tables)
    norm = _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len)
    return _plain_fwd(q, k, v, scale, *norm, causal, kv_valid_len)


def flash_attention_bhnd_bwd_plain(q, k, v, out, lse, do, segment_ids=None,
                                   causal: bool = False, scale: float | None = None,
                                   rope_tables=None, rope_expanded=None,
                                   kv_valid_len: int | None = None, seg_kv=None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in q's
    dtype, the math shared by `_bwd_fused_kernel` and `_dq_kernel` /
    `_dkv_kernel` plus `_flash_bwd_bhnd`, in fp32.

    p is recomputed from the given lse (0 where lse is -inf or the pair is
    masked), so a ring hop may pass a global lse; delta = rowsum(do * out);
    dv = p^T do; ds = p (dp - delta) scale with dp = do v^T; dk = ds^T q_rot;
    dq = ds k_rot; then the RoPE adjoint (`rope_rotate_t`).
    """
    return _bwd_with_tables(_plain_bwd, q, k, v, out, lse, do, segment_ids, causal, scale,
                            rope_tables, rope_expanded, kv_valid_len, seg_kv)


def _bwd_with_tables(core, q, k, v, out, lse, do, segment_ids, causal, scale, rope_tables,
                     rope_expanded, kv_valid_len, seg_kv):
    """``core`` on normalised arguments; with interleaved ``rope_tables`` it
    runs in the split-half layout and dq, dk are permuted back."""
    perm = None
    if rope_tables is not None:
        q, k, rope_expanded, perm = _expand(q, k, rope_tables)
    norm = _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len)
    dq, dk, dv = core(q, k, v, out, lse, do, scale, *norm, causal, kv_valid_len)
    if perm is not None:
        inv = torch.argsort(perm)
        dq, dk = dq[..., inv], dk[..., inv]
    return dq, dk, dv


def operand_dtype(family: str, **tensors) -> torch.dtype:
    """The operands' one dtype, bf16 or fp32 (each has its kernels, in the
    BHND and the DN ``family``); raises on anything else."""
    dtypes = {name: t.dtype for name, t in tensors.items()}
    if len(set(dtypes.values())) != 1 or next(iter(dtypes.values())) not in (torch.bfloat16,
                                                                               torch.float32):
        raise TypeError(f"the {family} flash kernels on CUDA take bf16 or fp32 operands of one "
                        f"dtype; got {dtypes}")
    return next(iter(dtypes.values()))


def _check_cuda(D, **tensors) -> torch.dtype:
    """The operands' one dtype, bf16 or fp32; raises on anything else."""
    if not bhnd_head_supported(D):
        raise ValueError(f"head width {D}: the BHND flash kernels take "
                         f"{', '.join(map(str, BHND_HEAD_WIDTHS))}")
    return operand_dtype("BHND", **tensors)


def _side_inputs(dev, cos, sin, seg_q, seg_k):
    """RoPE tables as [B|1, N, D] contiguous fp32 and segment ids as [B, N|M]
    int32, on ``dev``; plus their strides (t_b, t_n, t_d, segq_b, segk_b),
    batch stride 0 when shared."""
    t_b = t_n = t_d = segq_b = segk_b = 0
    if cos is not None:
        cos = cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = sin.to(device=dev, dtype=torch.float32).contiguous()
        t_b = cos.stride(0) if cos.shape[0] > 1 else 0
        t_n, t_d = cos.stride(1), cos.stride(2)
    if seg_q is not None:
        seg_q = seg_q.to(device=dev, dtype=torch.int32).contiguous()
        seg_k = seg_k.to(device=dev, dtype=torch.int32).contiguous()
        segq_b, segk_b = seg_q.stride(0), seg_k.stride(0)
    return cos, sin, seg_q, seg_k, (t_b, t_n, t_d, segq_b, segk_b)


# What the Hopper entry points (B1, B3, the BHND backward, B8) return,
# launching nothing, when an operand that TMA reads is not `tma_ready`
# (`csrc/bhnd_hopper.cuh:kNotTmaReady`); the wrapper then calls again with a
# copy (`tma_operand`; B1: a buffer its prologue copies v into).
NOT_TMA_READY = -1


def tma_ready(t) -> bool:
    """Whether the kernels' TMA loads can read ``t`` in place: unit stride
    along d, every other stride (of a dim longer than 1) a positive multiple
    of 8 elements (16 bytes), and a 16-byte aligned base. The C entry points
    check the same rule (`tma_ok`); the wrappers apply it only when one
    refuses."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(s > 0 and s % 8 == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def tma_operand(t):
    """``t`` itself when `tma_ready`, else a contiguous copy (a fresh, aligned
    allocation), so the kernel still runs."""
    return t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def padded_queries(n: int) -> int:
    """N rounded up to the backward's dQ block of 128 queries: the length of
    its delta and lse*log2(e) scratch rows."""
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=256)
def bwd_scratch(B: int, H: int, N: int, M: int, D: int, rope: bool) -> tuple[tuple, int]:
    """The backward's scratch: byte offsets (256-aligned) of q_s, q_u, k_rot,
    delta and lse*log2(e) in one buffer (None for a piece that is not
    needed), and its size. q_u and k_rot exist only with RoPE (without it the
    kernels read q and k in place)."""
    tokens = padded_queries(N)
    sizes = [B * H * N * D * 2, B * H * N * D * 2 * rope, B * H * M * D * 2 * rope,
             B * H * tokens * 4, B * H * tokens * 4]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(None if size == 0 else total)
        total += -(-size // 256) * 256
    return tuple(offsets), total


def _launch(name, argtypes, tensors, tma, ints, stride_of, floats, dev):
    """Call a BHND entry point. ``tensors``: its pointer arguments (tensors,
    raw scratch addresses or None); ``tma``: the indices of those it reads by
    TMA; ``stride_of``: (indices of the tensors whose strides fill the strides
    array, then the side strides). If it refuses an operand as not TMA-ready,
    the TMA-read operands that are not are copied and it is called again."""
    lib, fn = _build.function(name, argtypes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for attempt in range(2):
        flat = [s for i in stride_of[0] for s in tensors[i].stride()] + list(stride_of[1])
        strides = (ctypes.c_longlong * len(flat))(*flat)
        with torch.cuda.device(dev):
            err = fn(*map(_build.ptr, tensors), *ints, strides, *floats, stream)
        if err != NOT_TMA_READY or attempt:
            break
        tensors = [tma_operand(t) if i in tma else t for i, t in enumerate(tensors)]
    _build.check(lib, err, name)


def vec4_ready(t) -> bool:
    """Whether the fp32 pre-pass's 16-byte reads can take ``t`` in place: unit
    stride along d, every other stride (of a dim longer than 1) a multiple of
    4 elements, and a 16-byte aligned base. The C entry points check the
    same rule."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(s % 4 == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def vec4_operand(t):
    """``t`` itself when `vec4_ready`, else a contiguous copy (a fresh,
    aligned allocation)."""
    return t if vec4_ready(t) else t.clone(memory_format=torch.contiguous_format)


def split_operand(t):
    """A [B, H, n, D] operand as the fp32 pre-pass reads it: ``t`` itself
    when it is unit-stride along the tokens (the DN layout, read by scalar
    loads at any other strides and alignment), else `vec4_operand`."""
    if t.stride(-1) != 1 and t.stride(-2) == 1:
        return t
    return vec4_operand(t)


def fp32_stat_rows(n: int) -> int:
    """N rounded up to the fp32 dQ launch's 64-query block: the length of the
    backward's delta and lse*log2(e) rows."""
    return -(-n // 64) * 64


@functools.lru_cache(maxsize=256)
def fp32_scratch(B: int, H: int, N: int, M: int, D: int, backward: bool) -> tuple[tuple, int]:
    """The fp32 kernels' scratch (`csrc/flash_fp32_split.cu`): (name, byte
    offset) pairs (256-aligned) in one buffer, and its size, of each operand's tf32 split
    copies, hi and lo: token-major [2, B, H, n, D] (``*_nat``) and
    feature-major [2, B, H, D, n rounded up to 8] (``*_tr``); the backward's
    delta and lse*log2(e) rows [B, H, `fp32_stat_rows`]. The forward splits q
    and k token-major and v feature-major; the backward q, k, v, do token-major
    and q, k, do feature-major. M: the keys the kernels run over (kv_valid
    where the call has it: only those are split)."""
    def nat(n):
        return 2 * B * H * n * D * 4

    def tr(n):
        return 2 * B * H * D * (-(-n // 8) * 8) * 4

    if backward:
        stats = B * H * fp32_stat_rows(N) * 4
        sizes = {"q_nat": nat(N), "q_tr": tr(N), "k_nat": nat(M), "k_tr": tr(M),
                 "v_nat": nat(M), "do_nat": nat(N), "do_tr": tr(N), "delta": stats,
                 "lse2": stats}
    else:
        sizes = {"q_nat": nat(N), "k_nat": nat(M), "v_tr": tr(M)}
    offsets, total = [], 0
    for name, size in sizes.items():
        offsets.append((name, total))
        total += -(-size // 256) * 256
    return tuple(offsets), total


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FP32_ARGTYPES = {
    "vjepa2_flash_fp32_prepass_fwd": _build.launcher_argtypes(8, 5, 0),
    "vjepa2_flash_fwd_fp32": _build.launcher_argtypes(8, 6, 1),
    "vjepa2_flash_fp32_prepass_bwd": _build.launcher_argtypes(17, 6, 0),
    "vjepa2_flash_bwd_fp32_dq": [_P] * 13 + [_I] * 8 + [_L] * 7 + [_F] * 2 + [_P],
    "vjepa2_flash_bwd_fp32_dkdv": [_P] * 15 + [_I] * 9 + [_L] * 7 + [_F] * 2 + [_P],
    "vjepa2_flash_fp32_plan": _build.launcher_argtypes(3, 7, 0),
}


def _call_fp32(name, *args, dev):
    """Call an fp32 entry point on ``dev``'s current stream with ``args``
    (tensors, addresses, ints, a strides array, floats, in its order)."""
    lib, fn = _build.function(name, _FP32_ARGTYPES[name])
    args = [_build.ptr(a) if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, name)


def _strides(*tensors, extra=()):
    """The element strides of ``tensors``, one after another, then ``extra``,
    as a C array."""
    flat = [s for t in tensors for s in t.stride()] + list(extra)
    return (ctypes.c_longlong * len(flat))(*flat)


def _scratch(dev, B, H, N, M, D, backward):
    """The scratch buffer (the caller holds it until the launches are
    enqueued; the allocator then reuses it in stream order) and each piece's
    device address."""
    offsets, size = fp32_scratch(B, H, N, M, D, backward)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    return buf, {name: buf.data_ptr() + off for name, off in offsets}


# The fp32 kernels' blocks and tiles (`csrc/flash_fp32_*.cu`): the forward
# takes blocks of 128 queries and tiles of 64 keys (32 above Dh 64), dQ
# blocks of 64 queries and tiles of 32 keys, dK/dV blocks of 64 keys and
# tiles of 32 queries. A masked plan's entry is a tile's index, with
# PARTIAL_TILE set where one of its pairs is masked.
FP32_FWD_BLOCK, FP32_BWD_BLOCK, FP32_BWD_TILE = 128, 64, 32
PARTIAL_TILE = 1 << 16
_I32 = torch.iinfo(torch.int32)


def fp32_fwd_key_tile(d: int) -> int:
    """Keys a tile of the fp32 forward at head width ``d``."""
    return 64 if d <= 64 else 32


def _id_bounds(ids, n: int, size: int):
    """(min, max) of ids [B', n] over blocks of ``size`` (a ragged last
    block's missing entries left out), [B', ceil(n / size)] each."""
    nb, pad = -(-n // size), -(-n // size) * size - n
    lo = F.pad(ids, (0, pad), value=_I32.max).view(ids.shape[0], nb, size).amin(-1)
    hi = F.pad(ids, (0, pad), value=_I32.min).view(ids.shape[0], nb, size).amax(-1)
    return lo, hi


def mask_tile_plan(seg_q, seg_k, causal: bool, n: int, m: int, block: int, tile: int,
                   keys_major: bool = False, device=None):
    """The masked fp32 kernels' plan, as `csrc/flash_fp32_split.cu`'s
    `flash_fp32_plan_kernel` builds it on the card (this is its plain
    version, which the tests hold it to): for each block of ``block`` queries
    (of keys with ``keys_major``, as dK/dV runs), the tiles of ``tile`` keys
    (queries) that hold an attended pair, in order, each with PARTIAL_TILE
    set where one of its pairs is masked (the kernel tests those pair by
    pair, and skips the test on the others): int32 [B|1, n_blocks, 1 +
    n_tiles], the count, then the entries, -1 past the count.

    seg_q [B, n] and seg_k [B, >= m] integer ids: query i attends key j iff
    seg_q[i] >= seg_k[j]; ``causal``: iff j <= i, the same predicate on
    positions. ``m``: the keys the kernels run over (kv_valid); a key tile
    reaching past it is partial (its ragged edge) in the query-major plans.
    A tile is live iff the block's largest query id reaches the tile's
    smallest key id, and full iff its smallest reaches the tile's largest."""
    if seg_q is not None:
        q_ids, k_ids = seg_q.to(torch.int32), seg_k[:, :m].to(torch.int32)
    else:
        q_ids = torch.arange(n, device=device, dtype=torch.int32)[None]
        k_ids = torch.arange(m, device=device, dtype=torch.int32)[None]
    q_lo, q_hi = _id_bounds(q_ids, n, tile if keys_major else block)
    k_lo, k_hi = _id_bounds(k_ids, m, block if keys_major else tile)
    if keys_major:  # [B, key blocks, query tiles]
        live = q_hi[:, None, :] >= k_lo[:, :, None]
        full = q_lo[:, None, :] >= k_hi[:, :, None]
    else:  # [B, query blocks, key tiles]; a key tile past m is partial
        live = q_hi[:, :, None] >= k_lo[:, None, :]
        complete = (torch.arange(k_lo.shape[1], device=k_lo.device) + 1) * tile <= m
        full = (q_lo[:, :, None] >= k_hi[:, None, :]) & complete
    n_tiles = live.shape[-1]
    if n_tiles >= PARTIAL_TILE:
        raise ValueError(f"{n_tiles} tiles: the plan's entries hold tile indices below "
                         f"{PARTIAL_TILE}")
    idx = torch.arange(n_tiles, device=live.device, dtype=torch.int32)
    entries = torch.where(live, idx + PARTIAL_TILE * (~full).to(torch.int32), -1)
    order = torch.sort(torch.where(live, idx, n_tiles), dim=-1).indices
    entries = torch.gather(entries, -1, order)
    count = live.sum(-1, dtype=torch.int32)[..., None]
    return torch.cat([count, entries], -1).contiguous()


def _plan_cuda(seg_q, seg_k, causal, n, m, block, tile, keys_major, dev):
    """(`mask_tile_plan`'s plan built on the card by `flash_fp32_plan_kernel`,
    its batch stride (0 when shared), its row width); (None, 0, 0) when
    nothing is masked. seg_q, seg_k: `_side_inputs`' int32 ids, or None."""
    if seg_q is None and not causal:
        return None, 0, 0
    rows, cols = (m, n) if keys_major else (n, m)
    bp = 1 if seg_q is None else seg_q.shape[0]
    plan = torch.empty((bp, -(-rows // block), 1 + -(-cols // tile)), dtype=torch.int32,
                       device=dev)
    plan_b = plan.stride(0) if bp > 1 else 0
    segq_b, segk_b = (0, 0) if seg_q is None else (seg_q.stride(0), seg_k.stride(0))
    _call_fp32("vjepa2_flash_fp32_plan", seg_q, seg_k, plan, bp, n, m, block, tile,
               int(keys_major), plan.shape[2], _strides(extra=(segq_b, segk_b, plan_b)), dev=dev)
    return plan, plan_b, plan.shape[2]


def _fp32_side(q, k, cos, sin, seg_q, seg_k, kv_valid_len):
    """What the fp32 entry points take beside the operands: the tables as
    `_side_inputs` lays them out (None without RoPE), their (batch, row,
    feature) strides, the keys the kernels run over (kv_valid, else M), then
    the segment ids as `_side_inputs` lays them out (int32 [B, N] and [B, M],
    None without) and their batch strides."""
    cos, sin, seg_q, seg_k, (t_b, t_n, t_d, segq_b, segk_b) = _side_inputs(q.device, cos, sin,
                                                                         seg_q, seg_k)
    Mv = k.shape[2] if kv_valid_len is None else kv_valid_len
    return cos, sin, (t_b, t_n, t_d if cos is not None else 1), Mv, seg_q, seg_k, (segq_b, segk_b)


def fp32_forward(q, k, v, out, lse, scale, cos, sin, tables, Mv, seg_q, seg_k, seg_b, causal):
    """The fp32 forward's launches (`csrc/flash_fp32_split.cu`, which rotates
    q and k with RoPE, then `csrc/flash_fp32_fwd.cu` over the first ``Mv``
    keys, masking by segment ids and the causal mask) into ``out`` and
    ``lse``. q, k, v and out are [B, H, n, D] views, each unit-stride along
    d or along the tokens (a DN call passes its [B, H, D, n] tensors
    transposed); the side inputs as `_fp32_side` gives them: tables
    [B|1, N, D] or [B|1, D, N] at ``tables`` = (t_b, t_n, t_d), int32 ids
    at batch strides ``seg_b``."""
    B, H, N, D = q.shape
    dev = q.device
    plan, plan_b, plan_w = _plan_cuda(seg_q, seg_k, causal, N, Mv, FP32_FWD_BLOCK,
                                      fp32_fwd_key_tile(D), False, dev)
    q, k, v = map(split_operand, (q, k, v))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    buf, at = _scratch(dev, B, H, N, Mv, D, False)
    _call_fp32("vjepa2_flash_fp32_prepass_fwd", q, k, v, cos, sin, at["q_nat"], at["k_nat"],
               at["v_tr"], B, H, D, N, Mv, _strides(q, k, v, extra=tables), dev=dev)
    _call_fp32("vjepa2_flash_fwd_fp32", at["q_nat"], at["k_nat"], at["v_tr"], out, lse, seg_q,
               seg_k, plan, B, H, D, N, Mv, int(causal),
               _strides(out, extra=(*seg_b, plan_b, plan_w)), scale * _build.LOG2E, dev=dev)


def fp32_backward(q, k, v, out, lse, do, dq, dk, dv, dn, scale, cos, sin, tables, Mv, seg_q,
                  seg_k, seg_b, causal):
    """The fp32 backward's launches (`csrc/flash_fp32_split.cu`, then
    `csrc/flash_fp32_dq.cu` and `csrc/flash_fp32_dkdv.cu`, dq and dk through
    the RoPE adjoint in their epilogues, p 0 where the masks say) into dq,
    dk and dv: contiguous [B, H, N|M, D], or with ``dn`` [B, H, D, N|M], dk
    and dv zero at and past ``Mv``. Operands and side inputs as
    `fp32_forward` takes them; lse [B, H, N] contiguous fp32."""
    B, H, N, D = q.shape
    M = k.shape[2]
    dev = q.device
    plans = [_plan_cuda(seg_q, seg_k, causal, N, Mv, FP32_BWD_BLOCK, FP32_BWD_TILE, keys_major,
                        dev) for keys_major in (False, True)]
    q, k, v, out, do = map(split_operand, (q, k, v, out, do))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qscale, Np = scale * _build.LOG2E, fp32_stat_rows(N)
    buf, at = _scratch(dev, B, H, N, Mv, D, True)
    _call_fp32("vjepa2_flash_fp32_prepass_bwd", q, k, v, out, do, lse, cos, sin,
               *(at[n] for n in ("q_nat", "q_tr", "k_nat", "k_tr", "v_nat", "do_nat", "do_tr",
                                 "delta", "lse2")),
               B, H, D, N, Mv, Np, _strides(q, k, v, out, do, extra=tables), dev=dev)
    # dQ, then dK/dV, on one stream, from the pre-pass's copies and statistics
    _call_fp32("vjepa2_flash_bwd_fp32_dq",
               *(at[n] for n in ("q_nat", "k_nat", "v_nat", "do_nat", "k_tr", "delta", "lse2")),
               cos, sin, seg_q, seg_k, plans[0][0], dq, B, H, D, N, Mv, Np, int(causal),
               int(dn), *tables, *seg_b, *plans[0][1:], scale, qscale, dev=dev)
    _call_fp32("vjepa2_flash_bwd_fp32_dkdv",
               *(at[n] for n in ("q_nat", "k_nat", "v_nat", "do_nat", "q_tr", "do_tr", "delta",
                                 "lse2")),
               cos, sin, seg_q, seg_k, plans[1][0], dk, dv, B, H, D, N, Mv, M, Np,
               int(causal), int(dn), *tables, *seg_b, *plans[1][1:], scale, qscale, dev=dev)


def _flash_fwd_fp32(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    """The fp32 forward (`fp32_forward`): out in BNHD memory seen as BHND, as
    the bf16 kernel writes it, and lse."""
    global LAUNCHES_FP32
    B, H, N, D = q.shape
    cos, sin, tables, Mv, seg_q, seg_k, seg_b = _fp32_side(q, k, cos, sin, seg_q, seg_k,
                                                           kv_valid_len)
    out = torch.empty((B, N, H, D), dtype=torch.float32, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    fp32_forward(q, k, v, out, lse, scale, cos, sin, tables, Mv, seg_q, seg_k, seg_b, causal)
    LAUNCHES_FP32 += 1
    return out, lse


def _flash_bwd_fp32(q, k, v, out, lse, do, scale, cos, sin, seg_q, seg_k, causal,
                    kv_valid_len):
    """The fp32 backward (`fp32_backward`): dq, dk, dv contiguous, dk and dv
    zero at and past kv_valid."""
    global LAUNCHES_BWD_FP32
    cos, sin, tables, Mv, seg_q, seg_k, seg_b = _fp32_side(q, k, cos, sin, seg_q, seg_k,
                                                           kv_valid_len)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=q.device) for t in (q, k, v))
    fp32_backward(q, k, v, out, lse, do, dq, dk, dv, False, scale, cos, sin, tables, Mv, seg_q,
                  seg_k, seg_b, causal)
    LAUNCHES_BWD_FP32 += 1
    return dq, dk, dv


def _flash_fwd_cuda(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    global LAUNCHES
    B, H, N, D = q.shape
    M = k.shape[2]
    if _check_cuda(D, q=q, k=k, v=v) == torch.float32:
        return _flash_fwd_fp32(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len)
    dev = q.device
    cos, sin, seg_q, seg_k, side = _side_inputs(dev, cos, sin, seg_q, seg_k)
    # BNHD memory seen as BHND: the output projection reads it as [B, N, H*D]
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    # with RoPE the prologue writes bf16(rot(k)) here
    kr = torch.empty((B, H, M, D), dtype=q.dtype, device=dev) if cos is not None else None
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    # TMA reads q, v and, rope-free, k as they lie; the RoPE prologue reads k at any strides
    tma = (0, 2) if cos is not None else (0, 1, 2)
    _launch("vjepa2_flash_fwd_bhnd_bf16", _build.launcher_argtypes(10, 7, 1),
            [q, k, v, cos, sin, seg_q, seg_k, out, lse, kr], tma,
            (B, H, D, N, M, kv_lim, int(causal)), ((0, 1, 2, 7), side), (scale * _build.LOG2E,),
            dev)
    LAUNCHES += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, out, lse, do, scale, cos, sin, seg_q, seg_k, causal,
                    kv_valid_len):
    global LAUNCHES_BWD
    B, H, N, D = q.shape
    M = k.shape[2]
    dtype = _check_cuda(D, q=q, k=k, v=v, out=out, do=do)
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, N):
        raise ValueError(f"out {tuple(out.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous fp32 [B, H, N], as the forward returns it")
    dev = q.device
    if any(t.device != dev for t in (out, lse, do)):
        raise ValueError("q, k, v, out, lse and do must be on one device")
    if dtype == torch.float32:
        return _flash_bwd_fp32(q, k, v, out, lse, do, scale, cos, sin, seg_q, seg_k, causal,
                               kv_valid_len)
    cos, sin, seg_q, seg_k, side = _side_inputs(dev, cos, sin, seg_q, seg_k)
    rope = cos is not None
    dq = torch.empty((B, H, N, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, H, M, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, H, M, D), dtype=q.dtype, device=dev)
    offsets, size = bwd_scratch(B, H, N, M, D, rope)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    pieces = [None if off is None else base + off for off in offsets]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kv_lim = M if kv_valid_len is None else kv_valid_len
    # TMA reads v, do and, rope-free, q and k as they lie; the prologue reads the rest
    tma = (2, 4) if rope else (0, 1, 2, 4)
    _launch("vjepa2_flash_bwd_bhnd_bf16", _build.launcher_argtypes(18, 7, 2),
            [q, k, v, out, do, lse, cos, sin, seg_q, seg_k, dq, dk, dv, *pieces], tma,
            (B, H, D, N, M, kv_lim, int(causal)), ((0, 1, 2, 3, 4), side),
            (scale, scale * _build.LOG2E), dev)
    LAUNCHES_BWD += 1
    return dq, dk, dv


def _device(*tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("q, k and v must be on one device")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no BHND flash route for device {dev}")
    return dev.type


def _fwd(q, k, v, *args):
    """The forward on normalised arguments: the kernel or, on the CPU, its
    plain version, whose out is laid out as the kernel writes it
    (`_fwd_fake`)."""
    if _device(q, k, v) == "cuda":
        return _flash_fwd_cuda(q, k, v, *args)
    out, lse = _plain_fwd(q, k, v, *args)
    return _out_layout(out).copy_(out), lse.contiguous()


def _out_layout(q):
    """An empty [B, H, N, D] tensor like ``q`` laid out [B, N, H, D], as the
    kernels write out: the projection reads it as [B, N, H * D] in place."""
    B, H, N, D = q.shape
    return q.new_empty((B, N, H, D)).transpose(1, 2)


def _fwd_fake(q, k, v, scale, cos, sin, seg_q, seg_k, causal, kv_valid_len):
    """The forward's outputs without the work, for tracing (`torch.export`):
    out as `_out_layout` and lse [B, H, N] fp32. Operands on different
    devices raise, as in the real forward."""
    _device(q, k, v)
    B, H, N, _ = q.shape
    return _out_layout(q), q.new_empty((B, H, N), dtype=torch.float32)


def _bwd(q, k, v, *args):
    """The backward on normalised arguments, dispatched as `_fwd`."""
    return (_plain_bwd if _device(q, k, v) == "cpu" else _flash_bwd_cuda)(q, k, v, *args)


def flash_attention_bhnd_bwd(q, k, v, out, lse, do, segment_ids=None, causal: bool = False,
                             scale: float | None = None, rope_tables=None, rope_expanded=None,
                             kv_valid_len: int | None = None, seg_kv=None):
    """The backward of `flash_attention_bhnd`: (dq, dk, dv) from the forward's
    inputs, an (out, lse) pair and the cotangent ``do`` of out. ``lse`` may be
    a global one, as a ring hop's backward passes it (with ``seg_kv``).

    A CUDA tensor launches the B4/B5 kernel (bf16, any strides) or its fp32
    counterpart or raises; a CPU tensor takes
    `flash_attention_bhnd_bwd_plain`.
    """
    return _bwd_with_tables(_bwd, q, k, v, out, lse, do, segment_ids, causal, scale,
                            rope_tables, rope_expanded, kv_valid_len, seg_kv)


# The forward on normalised arguments is one dispatcher op,
# ``torch.ops.vjepa2.flash_fwd_bhnd``, so that a selective remat policy can keep
# its (out, lse) (JAX's "flash_out" and "flash_lse" names,
# `flash_attention.py:1133-1134`) and the recompute launches nothing
# (`models.modules.resolve_remat_policy`); its fake kernel lets `torch.export`
# trace it into a graph as one node (`hub.export`).
_LIB = torch.library.Library("vjepa2", "FRAGMENT")
_LIB.define("flash_fwd_bhnd(Tensor q, Tensor k, Tensor v, float? scale, Tensor? cos, "
            "Tensor? sin, Tensor? seg_q, Tensor? seg_k, bool causal, int? kv_valid_len) "
            "-> (Tensor, Tensor)")
_LIB.impl("flash_fwd_bhnd", _fwd, "CompositeExplicitAutograd")
torch.library.register_fake("vjepa2::flash_fwd_bhnd", _fwd_fake, lib=_LIB)


class FlashAttentionBHND(torch.autograd.Function):
    """B3 forward, B4/B5 backward (`_flash_attention_core:803`,
    `_core_fwd:816`, `_core_bwd:826`). The forward saves (q, k, v, out, lse);
    lse is an output without a gradient; tables and segment ids get none."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len):
        norm = _normalize(q, k, v, rope_expanded, segment_ids, seg_kv, causal, kv_valid_len)
        ctx.args = (scale, *norm, causal, kv_valid_len)
        out, lse = torch.ops.vjepa2.flash_fwd_bhnd(q, k, v, *ctx.args)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_bhnd(q, k, v, segment_ids=None, causal: bool = False,
                         scale: float | None = None, rope_tables=None, rope_expanded=None,
                         kv_valid_len: int | None = None, seg_kv=None,
                         return_lse: bool = False):
    """Flash attention over [B, H, N, D] tensors. Differentiable in q, k, v.

    segment_ids: [N] or [B, N] int; query i attends to key j iff
    seg[i] >= seg[j] (frame-causal); ``seg_kv`` gives the keys their own ids
    (a ring hop's keys). causal: token-causal, key j <= query i; exclusive
    with segment ids. rope_tables: interleaved-convention (cos, sin) [N, rot]
    or [B, N, rot], applied to unrotated q and k. rope_expanded: split-half
    (cos, sin) [B|1, N, D] from `ops.rope.expand_rope_cache`, with q and k
    already carrying its head-dim permutation. kv_valid_len: number of real
    keys; keys at or beyond it are masked.

    Returns out [B, H, N, D] (and lse [B, H, N] fp32 with ``return_lse``).
    A CUDA tensor launches the kernels (head width 32, 64, 80, 88 or 104;
    bf16 or fp32) or raises; a CPU tensor takes the plain versions.
    """
    if rope_tables is not None:
        q, k, rope_expanded, _ = _expand(q, k, rope_tables)  # differentiable gathers
    out, lse = FlashAttentionBHND.apply(q, k, v, scale, rope_expanded, segment_ids, seg_kv,
                                        causal, kv_valid_len)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, segment_ids=None, causal: bool = False, scale: float | None = None,
                    rope_tables=None, kv_valid_len: int | None = None):
    """BNHD convenience wrapper: q, k, v [B, N, H, D] -> [B, N, H, D]."""
    out = flash_attention_bhnd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               segment_ids=segment_ids, causal=causal, scale=scale,
                               rope_tables=rope_tables, kv_valid_len=kv_valid_len)
    return out.transpose(1, 2)
