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
them. With segment ids and the causal mask the emulation masks as the
kernels do: the ids compared as integers (seg_q[i] >= seg_k[j]), key j <= i
under causal, a masked score -inf before the running max (a row with no
key: out 0, lse -inf) and p = 0 in the backward, where lse * log2(e) is +inf
for such a row, as the pre-pass writes it.

Cases: head widths 64 and 88 at N = 320 (B = 1, H = 2), and a peaked softmax
at 88 (q scaled so that the scores reach ±40); the pretrain step's features
at head widths 32 and 64, B = 2, N = 128: split-half tables shared and per
example with kv_valid M - 1 and M - 5 (against JAX's `flash_attention_bhnd`
with ``rope_expanded`` and ``kv_valid_len``); the masks at N = 128: the AC
predictor's frame-causal ids with pad keys on int32-max at head width 64
(with and without RoPE), a ring hop's key-side ids (M = 192 != N) with a
global lse given to the backward at 80, and the causal mask at 88.
Tolerances, the kernels'
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


def kernel_mask(N, M, seg_q=None, seg_k=None, causal=False):
    """The kernels' predicate, True = attend, [B|1, 1, N, M] (None when
    nothing is masked): int32 ids compared as integers, key j <= query i
    under causal."""
    mask = None
    if seg_q is not None:
        mask = seg_q[:, None, :, None] >= seg_k[:, None, None, :]
    if causal:
        tri = torch.ones(N, M, dtype=torch.bool).tril()
        mask = tri if mask is None else mask & tri
    return mask


def _masked(x, mask, kv):
    """-inf where ``mask`` (cut to the first kv keys) is False."""
    return x if mask is None else x.masked_fill(~mask[..., :x.shape[-1]], float("-inf"))


def emulated_fwd(q, k, v, parts=3, rope=None, kv=None, mask=None):
    q, k, v = _prepass(q, k, v, rope, kv)
    scale = q.shape[-1] ** -0.5
    s = _masked(product(q, k.transpose(-1, -2), parts) * np.float32(scale * LOG2E), mask, kv)
    m = s.amax(-1, keepdim=True)
    empty = torch.isneginf(m)  # no key to attend: the running max stays -inf
    m = m.masked_fill(empty, 0.0)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True).masked_fill(empty, 1.0)
    out = product(p, v, parts) / l
    lse = ((m + torch.log2(l)) * np.float32(1 / LOG2E)).masked_fill(empty, float("-inf"))
    return out, lse.squeeze(-1)


def emulated_bwd(q, k, v, out, lse, do, parts=3, rope=None, kv=None, mask=None):
    M = k.shape[2]
    q, k, v = _prepass(q, k, v, rope, kv)
    scale = np.float32(q.shape[-1] ** -0.5)
    s = product(q, k.transpose(-1, -2), parts) * np.float32(scale * LOG2E)
    lse2 = (lse * np.float32(LOG2E)).masked_fill(torch.isneginf(lse), float("inf"))
    p = torch.exp2(_masked(s - lse2[..., None], mask, kv))
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


def _hold_and_miss(want, q, k, v, do, peak, features=None, given=None):
    """The emulation with 3 TF32 products within the kernels' tolerances of
    JAX's (out, lse, dq, dk, dv); with 1, every output outside them. The
    backward is given the emulated forward's (out, lse), or ``given(out,
    lse)``'s pair, as JAX's was."""
    features = features or {}
    lse_tol = PEAKED_LSE_RTOL * np.abs(want[1]).max() if peak else LSE_ATOL
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    for parts in (3, 1):
        out, lse = emulated_fwd(tq, tk, tv, parts, **features)
        pair = (out, lse) if given is None else given(out, lse)
        grads = emulated_bwd(tq, tk, tv, *pair, tdo, parts, **features)
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


MASK_B, MASK_N = 2, 128
PAD_SEGMENT = np.iinfo(np.int32).max


def _mask_inputs(D, seed, M=MASK_N):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(MASK_B, 2, MASK_N, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(MASK_B, 2, M, D).astype(np.float32) for _ in range(2))
    return q, k, v, do, rng


@pytest.mark.parametrize("rope", [False, True])
def test_3xtf32_with_frame_causal_segments(rope):
    """The AC predictor's frame-causal ids at head width 64: 2 frames of 60
    tokens and 8 pad tokens on int32-max (pad queries attend every key, no
    real query a pad key), with and without shared RoPE tables."""
    q, k, v, do, rng = _mask_inputs(64, seed=7 + rope)
    seg = np.concatenate([np.repeat(np.arange(2), 60), np.full(8, PAD_SEGMENT)])
    seg = np.tile(seg.astype(np.int32), (MASK_B, 1))
    tables = tuple(rng.uniform(-1, 1, (1, MASK_N, 64)).astype(np.float32) for _ in range(2))
    kw_j = dict(segment_ids=jnp.asarray(seg))
    features = dict(mask=kernel_mask(MASK_N, MASK_N, torch.from_numpy(seg),
                                     torch.from_numpy(seg)))
    if rope:
        kw_j["rope_expanded"] = tuple(map(jnp.asarray, tables))
        features["rope"] = tuple(map(torch.from_numpy, tables))
    cos, sin = kw_j.get("rope_expanded", (None, None))
    fwd = jfa._flash_fwd_bhnd(*map(jnp.asarray, (q, k, v)), kw_j["segment_ids"], cos, sin, cos,
                              sin, block_q=64, block_k=64, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bhnd(
        q, k, v, block_q=64, block_k=64, interpret=True, **kw_j), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in jax.block_until_ready((*fwd, *vjp(jnp.asarray(do))))]
    _hold_and_miss(want, q, k, v, do, 0, features)


def test_3xtf32_ring_hop_seg_kv_and_a_given_lse():
    """A ring hop at head width 80: the keys carry their own ids (M = 192
    != N), and the backward is given the ring's global lse and out, as
    `ring_attention.py:91-104` passes them (every query sees a key of the
    hop: JAX's kernel averages v over a row with none)."""
    M = MASK_N + 64
    q, k, v, do, rng = _mask_inputs(80, seed=11, M=M)
    seg = np.sort(rng.randint(1, 6, (MASK_B, MASK_N)), axis=1).astype(np.int32)
    seg_kv = np.sort(rng.randint(0, 6, (MASK_B, M)), axis=1).astype(np.int32)
    seg_kv[:, 0] = 0
    shift = torch.from_numpy(rng.randn(MASK_B, 2, MASK_N).astype(np.float32))

    def given(out, lse):  # the ring's (out, lse) from this hop's and another's
        glob = torch.logaddexp(lse, shift)
        return out * torch.exp(lse - glob)[..., None], glob

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    mask = kernel_mask(MASK_N, M, torch.from_numpy(seg), torch.from_numpy(seg_kv))
    out, lse = emulated_fwd(tq, tk, tv, mask=mask)
    out_g, lse_g = given(out, lse)
    fwd = jfa._flash_fwd_bhnd(*map(jnp.asarray, (q, k, v, seg)), None, None, None, None,
                              seg_kv=jnp.asarray(seg_kv), block_q=64, block_k=64, interpret=True)
    grads = jfa._flash_bwd_bhnd(*map(jnp.asarray, (q, k, v, seg)), None, None, None, None,
                                *map(jnp.asarray, (out_g.numpy(), lse_g.numpy(), do)),
                                seg_kv=jnp.asarray(seg_kv), block_q=64, block_k=64,
                                interpret=True)
    want = [np.asarray(x) for x in jax.block_until_ready((*fwd, *grads))]
    _hold_and_miss(want, q, k, v, do, 0, dict(mask=mask), given)


def test_3xtf32_with_the_causal_mask():
    """The token-causal mask (key j <= query i) at head width 88."""
    q, k, v, do, _ = _mask_inputs(88, seed=13)
    fwd = jfa._flash_fwd_bhnd(*map(jnp.asarray, (q, k, v)), None, None, None, None, None,
                              causal=True, block_q=64, block_k=64, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bhnd(
        q, k, v, causal=True, block_q=64, block_k=64, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in jax.block_until_ready((*fwd, *vjp(jnp.asarray(do))))]
    _hold_and_miss(want, q, k, v, do, 0, dict(mask=kernel_mask(MASK_N, MASK_N, causal=True)))


def test_emulated_masks_give_empty_rows_zero_and_no_gradient():
    """A query whose id is below every key's: the emulation's out 0, lse
    -inf and dq 0, as the kernels (and `flash_attention_bhnd_plain`) give."""
    q, k, v, do, _ = _mask_inputs(64, seed=17)
    seg_q = torch.ones(MASK_B, MASK_N, dtype=torch.int32)
    seg_q[:, :5] = 0
    mask = kernel_mask(MASK_N, MASK_N, seg_q, torch.ones_like(seg_q))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = emulated_fwd(tq, tk, tv, mask=mask)
    dq, dk, dv = emulated_bwd(tq, tk, tv, out, lse, tdo, mask=mask)
    assert not out[:, :, :5].any() and torch.isneginf(lse[:, :, :5]).all()
    assert not dq[:, :, :5].any()
    assert all(torch.isfinite(g).all() for g in (out, dq, dk, dv))


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
