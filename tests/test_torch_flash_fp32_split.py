"""The arithmetic of the fp32 flash kernels (`vjepa2_tpu_torch/csrc/flash_fp32.cuh`:
3xTF32 on the tensor cores) emulated on the CPU, against the JAX package's
B3/B4/B5 Pallas kernels in interpret mode on the same fp32 inputs (JAX runs
them in the operands' dtype, `flash_attention.py:202`), as
`tests/test_torch_flash_fp32.py` runs them.

The emulation: every operand of a product is split into two tf32 parts,
hi = rna(x) and lo = rna(x - hi), rounded by integer operations on the fp32
bits to nearest with ties away from zero (as ``cvt.rna.tf32.f32`` does), and
a product is lo·hi + hi·lo + hi·hi summed in fp32; P and dS are split the
same way before they meet V, dO, K and Q. The softmax is the kernels' base-2
one; the emulation takes whole rows where the kernels take tiles (the
sums' order is not what this file tests). The backward is given the emulated
forward's out and lse, as the kernels are given the forward kernel's.

With RoPE the emulation rotates q and k in fp32 before their split, as the
pre-pass does (`rope_rotate`: each product and sum rounded once, the
kernels' `rope_pair`), and takes dq and dk through the adjoint
(`rope_rotate_t`, as the dQ and dK/dV epilogues do); with kv_valid it runs
over the first kv_valid keys, as the kernels do, and dk, dv are zero past
them.

Cases: head widths 64 and 88 at N = 320 (B = 1, H = 2), and a peaked softmax
at 88 (q scaled so that the scores reach ±40); the pretrain step's features
at head widths 32 and 64, B = 2, N = 128: split-half tables shared and per
example with kv_valid M - 1 and M - 5 (against JAX's `flash_attention_bhnd`
with ``rope_expanded`` and ``kv_valid_len``). Tolerances, the kernels'
(`chip_smoke.py`: FP32_REL_L2, FP32_MAX_ABS, FP32_LSE_ATOL): out and the
gradients within 2e-5 relative L2 and 1e-4·max|JAX| absolute, lse within
1e-5 absolute. In the peaked case lse is held to 1e-6·max|lse| instead:
there |lse| ≈ 40, where an fp32 ulp is 3.8e-6 and fp32 itself, the plain
PyTorch scores against JAX's kernel, differs by 1.5-1.9e-5. The same
emulation with one TF32 product (hi·hi) misses every one of these
tolerances, so the file tells the two apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu_torch.ops.rope import rope_rotate, rope_rotate_t

B, H, N = 1, 2, 320
REL_L2, MAX_ABS, LSE_ATOL, PEAKED_LSE_RTOL = 2e-5, 1e-4, 1e-5, 1e-6
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (6 pytest workers share
    the host; see `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero: add half of the 13 dropped bits' unit to the magnitude, then drop
    them (an overflow rounds to inf, as it should)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, b, parts: int = 3):
    """a @ b from tf32 parts in fp32: lo·hi + hi·lo + hi·hi (3), or hi·hi (1)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if parts == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _prepass(q, k, v, rope, kv):
    """The pre-pass's view of the operands: q and k rotated in fp32 with the
    split-half tables [B|1, N, D] (or as they are), k and v cut to the first
    kv keys (or whole)."""
    if rope is not None:
        cos, sin = (t[:, None] for t in rope)
        q, k = rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
    return q, k[:, :, :kv], v[:, :, :kv]


def emulated_fwd(q, k, v, parts=3, rope=None, kv=None):
    q, k, v = _prepass(q, k, v, rope, kv)
    scale = q.shape[-1] ** -0.5
    s = product(q, k.transpose(-1, -2), parts) * np.float32(scale * LOG2E)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    out = product(p, v, parts) / l
    lse = (m + torch.log2(l)).squeeze(-1) * np.float32(1 / LOG2E)
    return out, lse


def emulated_bwd(q, k, v, out, lse, do, parts=3, rope=None, kv=None):
    M = k.shape[2]
    q, k, v = _prepass(q, k, v, rope, kv)
    scale = np.float32(q.shape[-1] ** -0.5)
    s = product(q, k.transpose(-1, -2), parts) * np.float32(scale * LOG2E)
    p = torch.exp2(s - (lse * np.float32(LOG2E))[..., None])
    dp = product(do, v.transpose(-1, -2), parts)
    ds = p * (dp - (do * out).sum(-1, keepdim=True)) * scale
    dq, dk = product(ds, k, parts), product(ds.transpose(-1, -2), q, parts)
    dv = product(p.transpose(-1, -2), do, parts)
    if rope is not None:  # the epilogues' adjoint, with the keys' table rows
        cos, sin = (t[:, None] for t in rope)
        dq, dk = rope_rotate_t(dq, cos, sin), rope_rotate_t(dk, cos[:, :, :k.shape[2]],
                                                           sin[:, :, :k.shape[2]])
    pad = (0, 0, 0, M - k.shape[2])  # dK/dV writes zeros past kv_valid
    return dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)


def _inputs(D, peak, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(4))
    if peak:
        s = np.einsum("bhnd,bhmd->bhnm", q, k) * D ** -0.5
        q = (q * np.float32(peak / np.abs(s).max())).astype(np.float32)
    return q, k, v, do


def _jax(q, k, v, do):
    """JAX's forward (out, lse) and gradients, fetched as numpy."""
    block = jfa.pick_block(N, 64)
    fwd = jfa._flash_fwd_bhnd(*map(jnp.asarray, (q, k, v)), None, None, None, None, None,
                              block_q=block, block_k=block, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bhnd(
        q, k, v, block_q=64, block_k=64, interpret=True), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return [np.asarray(x) for x in jax.block_until_ready((*fwd, *grads))]


def _errors(got, want):
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            np.abs(got - want).max() / np.abs(want).max())


ROPE_B, ROPE_N = 2, 128


def _jax_rope(q, k, v, do, rope, kv):
    """JAX's forward and gradients with split-half tables and kv_valid."""
    cos, sin = map(jnp.asarray, rope)
    fwd = jfa._flash_fwd_bhnd(*map(jnp.asarray, (q, k, v)), None, cos, sin, cos, sin,
                              kv_valid=kv, block_q=64, block_k=64, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bhnd(
        q, k, v, rope_expanded=(cos, sin), kv_valid_len=kv, block_q=64, block_k=64,
        interpret=True), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return [np.asarray(x) for x in jax.block_until_ready((*fwd, *grads))]


@pytest.mark.parametrize("D,peak", [(64, 0), (88, 0), (88, 40)])
def test_3xtf32_holds_the_kernels_tolerances_and_1xtf32_does_not(D, peak):
    q, k, v, do = _inputs(D, peak, seed=D + peak)
    _hold_and_miss(_jax(q, k, v, do), q, k, v, do, peak)


@pytest.mark.parametrize("kv_gap", [1, 5])
@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("D", [32, 64])
def test_3xtf32_with_rope_and_kv_valid(D, per_example, kv_gap):
    """The pre-pass's rotation, the epilogues' adjoint and the valid-key
    count with the 3xTF32 products: within the kernels' tolerances of JAX's
    kernels; one TF32 product misses them."""
    rng = np.random.RandomState(D + kv_gap + per_example)
    q, k, v, do = (rng.randn(ROPE_B, 2, ROPE_N, D).astype(np.float32) for _ in range(4))
    rope = tuple(rng.uniform(-1, 1, (ROPE_B if per_example else 1, ROPE_N, D))
                 .astype(np.float32) for _ in range(2))
    kv = ROPE_N - kv_gap
    want = _jax_rope(q, k, v, do, rope, kv)
    _hold_and_miss(want, q, k, v, do, 0, dict(rope=tuple(map(torch.from_numpy, rope)), kv=kv))


def _hold_and_miss(want, q, k, v, do, peak, features=None):
    """The emulation with 3 TF32 products within the kernels' tolerances of
    JAX's (out, lse, dq, dk, dv); with 1, every output outside them."""
    features = features or {}
    lse_tol = PEAKED_LSE_RTOL * np.abs(want[1]).max() if peak else LSE_ATOL
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    for parts in (3, 1):
        out, lse = emulated_fwd(tq, tk, tv, parts, **features)
        grads = emulated_bwd(tq, tk, tv, out, lse, tdo, parts, **features)
        errs = {name: _errors(g, w) for name, g, w in
                zip(("out", "dq", "dk", "dv"), (out, *grads), (want[0], *want[2:]))}
        lse_err = np.abs(lse.double().numpy() - want[1]).max()
        if parts == 3:
            assert lse_err <= lse_tol, lse_err
            for name, (rel, mx) in errs.items():
                assert rel <= REL_L2 and mx <= MAX_ABS, (name, rel, mx)
        else:  # one TF32 product: every output misses
            assert lse_err > lse_tol, lse_err
            for name, (rel, mx) in errs.items():
                assert rel > REL_L2 and mx > MAX_ABS, (name, rel, mx)


def test_tf32_rounding_is_to_nearest_ties_away():
    """The integer rounding against exact cases: 1 + 2^-11 (a tie) rounds away
    to 1 + 2^-10, just below it to 1; negatives mirror; hi + lo holds x to
    2^-22 (lo rounds x - hi, which is exact in fp32, to tf32 in turn)."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    hi, lo = split(x)
    assert hi.tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0]
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()
