"""The hand-written fp32 BHND flash kernels (`vjepa2_tpu_torch/csrc/flash_fp32.cuh`:
3xTF32 on wgmma; the split pre-pass, the forward, and the dQ and dK/dV
backward launches) against their plain PyTorch versions on the card (TF32
off): every head width of `BHND_HEAD_WIDTHS` at N in {1, 63, 64, 65, 2048}
(ragged edges of the 64- and 128-row blocks and 32- and 64-row tiles),
M != N, ragged lengths that are no multiple of 8 (the transposed copies'
permutation groups), inputs whose 13 low mantissa bits are all set (what
an unrounded tf32 operand would drop), a peaked softmax (scores to ±40),
one 36,864-token head (the ViT-g/384 probes') against the plain version
over query chunks, operands as views of one qkv output and an unaligned
view (copied, still launched), two calls bit-equal forward and backward,
the pretrain step's features (split-half RoPE tables, shared and per
example, and kv_valid in {1, M - 1, M - 63} at every width and at N in
{1, 63, 64, 65, 2048}, on qkv views too; dk and dv exactly zero past
kv_valid), segment ids (the AC predictor's frame-causal ids with pad keys
on int32-max, random ids per example), ids at 2**24 and 2**24 + 1 (which
must stay apart), a ring hop's key-side ids with a given lse, the causal
mask (N = M, N < M, N > M), rows with no key to attend (out 0, lse -inf, no
gradient), two calls with segments bit-equal, and the masked kernels' tile
plan built on the card against its plain version; mixed dtypes refused,
bf16 calls still on the bf16 kernels (the
launch counters), and `Attention` (rope-free, and with RoPE and kv_valid at
heads of 80 and 88 with per-example tables, as the masked ViT-H and ViT-g
encoders run it; narrower heads take the DN route) and a `ProbeGrid` on the
card taking the fp32 kernels on the route of its head width.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_fp32_cuda.py -q

Tolerances, those of `chip_smoke.py`'s phase kernel_fp32: fp32 on both
sides, the kernel summing three TF32 products a tile with an online
rescale, the plain version whole rows through cuBLAS: out and gradients
within 2e-5 relative L2 and 1e-4 x max|plain| absolute, lse within 1e-5
absolute; in the peaked case lse within 1e-6 x max|lse| (|lse| reaches 40,
where an fp32 ulp is 3.8e-6; `tests/test_torch_flash_fp32_split.py`).
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.evals import probes
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

pytestmark = pytest.mark.cuda

REL_L2, MAX_ABS, LSE_ATOL, PEAKED_LSE_RTOL = 2e-5, 1e-4, 1e-5, 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)


def _lse_close(lse, want, tol):
    """lse within ``tol``; -inf exactly where the plain version has it (a row
    with no key to attend)."""
    empty = torch.isneginf(want)
    assert torch.equal(torch.isneginf(lse), empty)
    assert (lse - want)[~empty].abs().max().item() <= tol


def _close(got, want, name):
    got, want = got.double(), want.double()
    rel = ((got - want).norm() / want.norm()).item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all(), name
    assert rel <= REL_L2 and err <= MAX_ABS * want.abs().max().item(), (name, rel, err)


def _check(q, k, v, do, lse_tol=LSE_ATOL, **kw):
    """Kernel forward and backward against the plain versions (``kw``: RoPE
    tables, kv_valid_len). With one key p = 1 and dp = delta, so dq and dk
    are 0 but for rounding on both sides: each row's dp - delta is a
    rounding residue (~1e-6 at unit-variance inputs), and dk sums N of them,
    so there they are held to 1e-5 x sqrt(N) absolute (1e-5 at N = 1). Past
    kv_valid dk and dv are exactly 0."""
    before = (fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32)
    out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    out_p, lse_p = fa.flash_attention_bhnd_plain(q, k, v, **kw)
    grads = fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)
    want = fa.flash_attention_bhnd_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32) == (before[0] + 1, before[1] + 1)
    assert out.dtype == lse.dtype == torch.float32
    _close(out, out_p, "out")
    _lse_close(lse, lse_p, lse_tol)
    keys = kw.get("kv_valid_len") or k.shape[2]
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        if name != "dq":
            assert not g[:, :, keys:].any(), name
            g, w = g[:, :, :keys], w[:, :, :keys]
        if keys == 1 and name != "dv":
            tol = 1e-5 * q.shape[2] ** 0.5
            assert max(g.abs().max().item(), w.abs().max().item()) <= tol, name
        else:
            _close(g, w, name)


@pytest.mark.parametrize("N", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("D", fa.BHND_HEAD_WIDTHS)
def test_fp32_kernels_match_plain(dev, D, N):
    B, H = (1, 2) if N == 2048 else (2, 3)
    q, k, v, do = (_randn((B, H, N, D), dev, s) for s in range(4))
    _check(q, k, v, do)


def _tables(dev, B, N, D, per_example, seed):
    """Split-half (cos, sin) [B|1, N, D] of real 3D RoPE angles: positions
    0..N-1 shared, or per example a random subset of a 16 x 16 x 16 grid
    (as masked contexts and predictor sequences take them)."""
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    rng = np.random.RandomState(seed)
    pos = (np.stack([np.sort(rng.choice(4096, N, replace=False)) for _ in range(B)])
           if per_example else np.arange(N)[None])
    return expand_rope_cache(build_rope_cache(torch.from_numpy(pos).to(dev), D, 16, 16), D)[0]


def _kv_valids(N):
    return sorted({kv for kv in (1, N - 1, N - 63) if kv > 0})


@pytest.mark.parametrize("N", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("D", fa.BHND_HEAD_WIDTHS)
def test_fp32_rope_and_kv_valid_match_plain(dev, D, N):
    """RoPE with shared and per-example tables, each with every kv_valid of
    {1, N - 1, N - 63} that is positive, and without one."""
    B, H = (1, 2) if N == 2048 else (2, 3)
    q, k, v, do = (_randn((B, H, N, D), dev, s) for s in range(4))
    for per_example in (False, True):
        tables = _tables(dev, B, N, D, per_example, seed=N + D)
        for kv in [None, *_kv_valids(N)]:
            _check(q, k, v, do, rope_expanded=tables, kv_valid_len=kv)


@pytest.mark.parametrize("D", [32, 64])
def test_fp32_kv_valid_without_rope_and_on_qkv_views(dev, D):
    """kv_valid alone (the fused route's narrow heads), and RoPE + kv_valid
    on q, k, v as views of one [B, N, 3, H, D] projection output, the route
    `Attention` takes."""
    q, k, v, do = (_randn((2, 3, 584, D), dev, s) for s in range(4))
    for kv in (578, 521):
        _check(q, k, v, do, kv_valid_len=kv)
    y = _randn((8, 176, 3 * 16 * D), dev, 4)
    qv, kv_, vv = y.view(8, 176, 3, 16, D).permute(2, 0, 3, 1, 4).unbind(0)
    assert all(fa.vec4_ready(t) for t in (qv, kv_, vv))
    _check(qv, kv_, vv, _randn((8, 16, 176, D), dev, 5),
           rope_expanded=_tables(dev, 8, 176, D, True, seed=D), kv_valid_len=173)


@pytest.mark.parametrize("D", [32, 64])
def test_fp32_rope_two_calls_are_bit_equal(dev, D):
    q, k, v, do = (_randn((2, 4, 1664, D), dev, s) for s in range(4))
    kw = dict(rope_expanded=_tables(dev, 2, 1664, D, True, seed=1), kv_valid_len=1662)
    out1, lse1 = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    out2, lse2 = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    g1 = fa.flash_attention_bhnd_bwd(q, k, v, out1, lse1, do, **kw)
    g2 = fa.flash_attention_bhnd_bwd(q, k, v, out1, lse1, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_fp32_cross_lengths_and_qkv_views(dev):
    """M != N, and q, k, v as views of one [B, N, 3, H, D] projection output,
    as `Attention` makes them (strides multiples of 4: read in place)."""
    q = _randn((2, 4, 100, 88), dev, 0)
    k, v = _randn((2, 4, 300, 88), dev, 1), _randn((2, 4, 300, 88), dev, 2)
    _check(q, k, v, _randn((2, 4, 100, 88), dev, 3))
    y = _randn((2, 130, 3 * 4 * 64), dev, 4)
    qv, kv, vv = y.view(2, 130, 3, 4, 64).permute(2, 0, 3, 1, 4).unbind(0)
    assert all(fa.vec4_ready(t) for t in (qv, kv, vv))
    _check(qv, kv, vv, _randn((2, 4, 130, 64), dev, 5))


@pytest.mark.parametrize("N,M", [(1001, 777), (37, 1201)])
@pytest.mark.parametrize("D", [64, 88])
def test_fp32_ragged_lengths(dev, D, N, M):
    """N and M no multiple of the tiles or of 8 (the transposed copies pad
    each to a multiple of 8 and permute tokens in groups of 8), M != N."""
    q, do = _randn((1, 3, N, D), dev, 0), _randn((1, 3, N, D), dev, 1)
    k, v = _randn((1, 3, M, D), dev, 2), _randn((1, 3, M, D), dev, 3)
    _check(q, k, v, do)


def _low_bits_set(x):
    """x with its 13 low mantissa bits set: the bits a tf32 operand that was
    not rounded first would drop (wgmma reads the top 19)."""
    return (x.view(torch.int32) | 0x1FFF).view(torch.float32)


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_low_mantissa_bits(dev, D):
    q, k, v, do = (_low_bits_set(_randn((2, 2, 300, D), dev, s)) for s in range(4))
    _check(q, k, v, do)


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_peaked_softmax(dev, D):
    """q scaled so that the scores reach ±40: p is nearly one-hot and lse is
    near 40, held to 1e-6 x max|lse| (fp32's own rounding there)."""
    q, k, v, do = (_randn((1, 2, 500, D), dev, s) for s in range(4))
    s = (q @ k.transpose(-1, -2)).abs().amax() * D ** -0.5
    q = q * (40.0 / s)
    lse = fa.flash_attention_bhnd_plain(q, k, v)[1]
    _check(q, k, v, do, lse_tol=PEAKED_LSE_RTOL * lse.abs().max().item())


def test_fp32_one_long_head(dev):
    """One ViT-g/384 probe head: [1, 1, 36864, 88], against the plain version
    over 4096-query chunks (its whole [N, N] scores and their gradients would
    hold ~27 GB): out, lse and dq row by row, dk and dv the sums of the
    chunks' partials."""
    N, D, rows = 36864, 88, 4096
    q, k, v, do = (_randn((1, 1, N, D), dev, s) for s in range(4))
    out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True)
    dq, dk, dv = fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do)
    want_dk, want_dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(0, N, rows):
        sl = slice(r, r + rows)
        out_p, lse_p = fa.flash_attention_bhnd_plain(q[:, :, sl], k, v)
        _close(out[:, :, sl], out_p, "out")
        assert (lse[:, :, sl] - lse_p).abs().max().item() <= LSE_ATOL
        g = fa.flash_attention_bhnd_bwd_plain(q[:, :, sl], k, v, out[:, :, sl], lse[:, :, sl],
                                              do[:, :, sl])
        _close(dq[:, :, sl], g[0], "dq")
        want_dk += g[1]
        want_dv += g[2]
    _close(dk, want_dk, "dk")
    _close(dv, want_dv, "dv")


def test_fp32_unaligned_view_is_copied(dev):
    base = _randn((2 * 2 * 70 * 64 + 1,), dev, 6)
    q = base[1:].view(2, 2, 70, 64)  # a 4-byte offset: not 16-byte aligned
    assert not fa.vec4_ready(q)
    k, v, do = (_randn((2, 2, 70, 64), dev, s) for s in (7, 8, 9))
    _check(q, k, v, do)


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_two_calls_are_bit_equal(dev, D):
    q, k, v, do = (_randn((1, 4, 1000, D), dev, s) for s in range(4))
    out1, lse1 = fa.flash_attention_bhnd(q, k, v, return_lse=True)
    out2, lse2 = fa.flash_attention_bhnd(q, k, v, return_lse=True)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    g1 = fa.flash_attention_bhnd_bwd(q, k, v, out1, lse1, do)
    g2 = fa.flash_attention_bhnd_bwd(q, k, v, out1, lse1, do)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _frame_ids(dev, frames, tokens, pad):
    """The AC predictor's frame-causal ids: ``frames`` groups of ``tokens``,
    then ``pad`` pad tokens on `PAD_SEGMENT` (int32-max)."""
    return tm.frame_segments(frames, tokens, dev, pad)


@pytest.mark.parametrize("frames,tokens,pad", [(1, 258, 6), (2, 258, 4), (7, 258, 2)])
@pytest.mark.parametrize("D", [64, 88])
def test_fp32_frame_causal_segments_match_plain(dev, D, frames, tokens, pad):
    """The AC rows as the predictor runs them: a CEM rollout's 1 and 2
    frames and the DROID step's 7, stack-padded with pad keys no real query
    attends, with and without RoPE."""
    N = frames * tokens + pad
    q, k, v, do = (_randn((2, 3, N, D), dev, s) for s in range(4))
    seg = _frame_ids(dev, frames, tokens, pad)
    _check(q, k, v, do, segment_ids=seg)
    _check(q, k, v, do, segment_ids=seg, rope_expanded=_tables(dev, 1, N, D, False, seed=D))


@pytest.mark.parametrize("D", [32, 80, 104])
def test_fp32_random_segments_per_example(dev, D):
    """Random ids per example [B, N] (sorted and not), every width."""
    rng = np.random.RandomState(D)
    q, k, v, do = (_randn((3, 2, 333, D), dev, s) for s in range(4))
    ids = rng.randint(0, 5, (3, 333))
    ids[1] = np.sort(ids[1])
    _check(q, k, v, do, segment_ids=torch.from_numpy(ids).to(dev, torch.int32))


def test_fp32_ids_past_2_24_stay_apart(dev):
    """Query ids 2**24 against key ids alternating 2**24 and 2**24 + 1: an
    fp32 cast would round both to 2**24 and attend every key."""
    q, k, v, do = (_randn((1, 2, 256, 64), dev, s) for s in range(4))
    big = 1 << 24
    seg_q = torch.full((256,), big, dtype=torch.int32, device=dev)
    seg_k = big + torch.arange(256, device=dev, dtype=torch.int32) % 2
    _check(q, k, v, do, segment_ids=seg_q, seg_kv=seg_k)
    half = fa.flash_attention_bhnd(q, k, v, segment_ids=seg_q, seg_kv=seg_k)
    _close(half, fa.flash_attention_bhnd_plain(q, k[:, :, ::2], v[:, :, ::2])[0], "even keys")


@pytest.mark.parametrize("D", [64, 80])
def test_fp32_ring_hop_seg_kv_given_lse(dev, D):
    """A ring hop: the keys' own ids (M != N) and a backward given a global
    lse, larger than the hop's own, as `ring_attention` passes it."""
    N, M = 1024, 640
    rng = np.random.RandomState(D)
    q, do = _randn((2, 3, N, D), dev, 0), _randn((2, 3, N, D), dev, 1)
    k, v = _randn((2, 3, M, D), dev, 2), _randn((2, 3, M, D), dev, 3)
    seg_q = torch.from_numpy(np.sort(rng.randint(0, 4, (2, N)))).to(dev, torch.int32)
    seg_k = torch.from_numpy(np.sort(rng.randint(0, 4, (2, M)))).to(dev, torch.int32)
    kw = dict(segment_ids=seg_q, seg_kv=seg_k)
    _check(q, k, v, do, **kw)
    out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    glob = lse + torch.from_numpy(rng.rand(2, 3, N).astype(np.float32)).to(dev)
    grads = fa.flash_attention_bhnd_bwd(q, k, v, out, glob, do, **kw)
    want = fa.flash_attention_bhnd_bwd_plain(q, k, v, out, glob, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        _close(g, w, name)


@pytest.mark.parametrize("N,M", [(1024, 1024), (100, 300), (300, 100), (65, 65), (1, 1)])
@pytest.mark.parametrize("D", [64, 80, 88])
def test_fp32_causal_matches_plain(dev, D, N, M):
    """The token-causal mask (key j <= query i): square, more keys, fewer
    keys (dK/dV blocks past the last query write zeros), ragged."""
    q, do = _randn((2, 2, N, D), dev, 0), _randn((2, 2, N, D), dev, 1)
    k, v = _randn((2, 2, M, D), dev, 2), _randn((2, 2, M, D), dev, 3)
    _check(q, k, v, do, causal=True)


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_rows_with_no_key(dev, D):
    """Queries whose id is below every key's: out 0, lse -inf, dq 0, and
    nothing of theirs in dk or dv; the other rows as the plain version."""
    N = 300
    q, k, v, do = (_randn((2, 2, N, D), dev, s) for s in range(4))
    seg_q = torch.ones(N, dtype=torch.int32, device=dev)
    seg_q[::3] = 0
    seg_k = torch.ones(N, dtype=torch.int32, device=dev)
    kw = dict(segment_ids=seg_q, seg_kv=seg_k)
    _check(q, k, v, do, **kw)
    out, lse = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    assert not out[:, :, ::3].any() and torch.isneginf(lse[:, :, ::3]).all()
    dq, dk, dv = fa.flash_attention_bhnd_bwd(q, k, v, out, lse, do, **kw)
    assert not dq[:, :, ::3].any()
    keep = seg_q == 1
    sub = fa.flash_attention_bhnd_bwd(q[:, :, keep], k, v, out[:, :, keep], lse[:, :, keep],
                                      do[:, :, keep])
    _close(dk, sub[1], "dk")
    _close(dv, sub[2], "dv")


@pytest.mark.parametrize("keys_major", [False, True])
@pytest.mark.parametrize("kind", ["frame-causal", "random", "causal"])
def test_fp32_plan_kernel_matches_its_plain_version(dev, kind, keys_major):
    """`flash_fp32_plan_kernel` (the masked kernels' tile plan, built on the
    card) against `mask_tile_plan`, its plain version, entry for entry: the
    AC rows, short and ragged lengths, M != N, kv_valid, and a row of more
    than 128 tiles (the kernel compacts 128 at a time)."""
    rng = np.random.RandomState(len(kind) + keys_major)
    shapes = [(1808, 1808), (264, 264), (100, 300), (300, 100), (9000, 9000)]
    blocks = [(64, 32)] if keys_major else [(128, 64), (128, 32), (64, 32)]
    for n, m in shapes:
        seg_q = seg_k = None
        if kind == "frame-causal":
            seg_q = tm.frame_segments(n // 258 or 1, 258, dev)[:n]
            seg_q = torch.nn.functional.pad(seg_q, (0, n - seg_q.numel()),
                                            value=tm.PAD_SEGMENT)[None].repeat(2, 1)
            seg_k = tm.frame_segments(m // 258 or 1, 258, dev)[:m]
            seg_k = torch.nn.functional.pad(seg_k, (0, m - seg_k.numel()),
                                            value=tm.PAD_SEGMENT)[None].repeat(2, 1)
        elif kind == "random":
            seg_q = torch.from_numpy(rng.randint(0, 6, (3, n))).to(dev, torch.int32)
            seg_k = torch.from_numpy(rng.randint(0, 6, (3, m))).to(dev, torch.int32)
        for mv in (m, m - 5):
            for block, tile in blocks:
                got = fa._plan_cuda(seg_q, seg_k, kind == "causal", n, mv, block, tile,
                                    keys_major, dev)[0]
                want = fa.mask_tile_plan(seg_q, seg_k, kind == "causal", n, mv, block, tile,
                                         keys_major, device=dev)
                assert torch.equal(got, want), (n, m, mv, block, tile)


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_segments_two_calls_are_bit_equal(dev, D):
    q, k, v, do = (_randn((2, 4, 1808, D), dev, s) for s in range(4))
    kw = dict(segment_ids=_frame_ids(dev, 7, 258, 2))
    out1, lse1 = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    out2, lse2 = fa.flash_attention_bhnd(q, k, v, return_lse=True, **kw)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    g1 = fa.flash_attention_bhnd_bwd(q, k, v, out1, lse1, do, **kw)
    g2 = fa.flash_attention_bhnd_bwd(q, k, v, out1, lse1, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_fp32_refuses_mixed_dtypes_and_other_widths(dev):
    q, k = _randn((1, 2, 64, 64), dev, 0), _randn((1, 2, 64, 64), dev, 1, torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_bhnd(q, k, k)
    with pytest.raises(ValueError, match="head width 16"):
        x = _randn((1, 2, 64, 16), dev, 2)
        fa.flash_attention_bhnd(x, x, x)


def test_bf16_calls_still_take_the_bf16_kernels(dev):
    counts = lambda: (fa.LAUNCHES, fa.LAUNCHES_BWD, fa.LAUNCHES_FP32,  # noqa: E731
                      fa.LAUNCHES_BWD_FP32)
    for dtype, want in ((torch.bfloat16, (1, 1, 0, 0)), (torch.float32, (0, 0, 1, 1))):
        leaves = [_randn((2, 2, 128, 80), dev, s, dtype).requires_grad_() for s in range(3)]
        before = counts()
        out = fa.flash_attention_bhnd(*leaves)
        torch.autograd.grad(out, leaves, torch.ones_like(out))
        assert tuple(a - b for a, b in zip(counts(), before)) == want, dtype


def test_fp32_attention_module_takes_the_bhnd_route(dev):
    """An fp32 `Attention` at Dh 80 with ``use_flash`` on the card: the fp32
    BHND kernels (heads of 16-64 take the DN route's, at fp32 as at bf16:
    `tests/test_torch_flash_dn_fp32_cuda.py`), forward and backward, against
    the plain route with the same weights."""
    flash = tm.Attention(320, 4, use_flash=True, device=dev)
    flash.reset_parameters(torch.Generator(dev).manual_seed(0))
    plain = tm.Attention(320, 4, device=dev)
    plain.load_state_dict(flash.state_dict())
    x = _randn((2, 200, 320), dev, 1)
    before = (fdn.LAUNCHES, fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32)
    outs, grads = [], []
    for m in (flash, plain):
        xi = x.clone().requires_grad_()
        y = m(xi)
        outs.append(y)
        grads.append(torch.autograd.grad(y, xi, torch.ones_like(y))[0])
    assert (fdn.LAUNCHES, fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32) == (
        before[0], before[1] + 1, before[2] + 1)
    _close(outs[0], outs[1], "out")
    _close(grads[0], grads[1], "dx")


@pytest.mark.parametrize("heads,D", [(16, 80), (16, 88)])
def test_fp32_rope_attention_module_takes_the_bhnd_route(dev, heads, D):
    """An fp32 `Attention` with RoPE and ``use_flash`` on the card, as the
    masked ViT-H (heads of 80) and 16-head ViT-g (88) encoders run it:
    per-example split-half tables, q/k rows permuted, a stack-padded
    sequence with kv_valid; the fp32 BHND kernels, forward and backward,
    against the plain route with the interleaved tables on the same weights
    (rows past kv_valid are the model's to drop). Heads of 32 and 64 take
    the DN route (`tests/test_torch_flash_dn_fp32_cuda.py`)."""
    from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache

    dim, N, kv = heads * D, 176, 173
    flash = tm.Attention(dim, heads, use_rope=True, use_flash=True, device=dev)
    flash.reset_parameters(torch.Generator(dev).manual_seed(0))
    plain = tm.Attention(dim, heads, use_rope=True, device=dev)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.RandomState(D)
    pos = torch.from_numpy(np.stack([np.sort(rng.choice(2048, N, replace=False))
                                     for _ in range(2)])).to(dev)
    cache = build_rope_cache(pos, D, 16, 16)
    expanded, perm = expand_rope_cache(cache, D)
    x = _randn((2, N, dim), dev, 1)
    before = (fdn.LAUNCHES, fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32)
    outs, grads = [], []
    for m, kw in ((flash, dict(rope_expanded=expanded, qkv_perm=tm.qkv_row_perm(perm, heads, D, dev))),
                  (plain, dict(rope_cache=cache))):
        xi = x.clone().requires_grad_()
        y = m(xi, kv_valid=kv, **kw)[:, :kv]
        outs.append(y)
        grads.append(torch.autograd.grad(y, xi, torch.ones_like(y))[0])
    assert (fdn.LAUNCHES, fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32) == (
        before[0], before[1] + 1, before[2] + 1)
    _close(outs[0], outs[1], "out")
    _close(grads[0], grads[1], "dx")


def test_probe_grid_on_the_card_takes_the_fp32_kernels(dev):
    """`ProbeGrid` on the card builds its probes with ``use_flash``: a train
    step launches the fp32 forward and backward once a self-attention block
    a probe, on the route its head width takes (80: the BHND kernels; 16
    and 64: B1/B2 at fp32, the DN route); at a head width no kernel takes
    the grid refuses to build."""
    cfgs = [probes.ProbeConfig(lr=1e-3, weight_decay=0.01)] * 2
    labels = torch.tensor([0, 1, 4], device=dev)
    counts = lambda: (fa.LAUNCHES_FP32, fa.LAUNCHES_BWD_FP32, fdn.LAUNCHES_FP32,  # noqa: E731
                      fdn.LAUNCHES_BWD_FP32)
    for dim, heads, want in ((160, 2, (4, 4, 0, 0)), (128, 2, (0, 0, 4, 4)),
                             (64, 4, (0, 0, 4, 4))):
        grid = probes.ProbeGrid(cfgs, embed_dim=dim, num_classes=5, num_heads=heads, depth=3,
                                device=dev)
        assert all(blk.attn.use_flash for blk in grid.model.pooler.blocks)
        params, opt, step = grid.init()
        before = counts()
        _, _, _, metrics = grid.train_step(params, opt, step, _randn((3, 96, dim), dev, 0), labels)
        assert tuple(a - b for a, b in zip(counts(), before)) == want, dim // heads
        assert torch.isfinite(metrics["loss"]).all()
    with pytest.raises(NotImplementedError, match="head width 24"):
        probes.ProbeGrid(cfgs, embed_dim=48, num_classes=5, num_heads=2, depth=2, device=dev)
