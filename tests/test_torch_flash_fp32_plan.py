"""The pure-Python planning around the fp32 flash kernels
(`vjepa2_tpu_torch/ops/flash_attention.py`), on the CPU: the scratch that
holds the split pre-pass's tf32 copies and the backward's row statistics
(`fp32_scratch`, `fp32_stat_rows`; with kv_valid, planned for the valid
keys only), laid out as the C entry points read it
(`csrc/flash_fp32_split.cu`: token-major [2, B, H, n, D] and feature-major
[2, B, H, D, n rounded up to 8], hi then lo; statistics [B, H, Np]), and
which operands the pre-pass's 16-byte reads take in place (`vec4_ready`).
The kernels themselves run only on the card (`test_torch_flash_fp32_cuda.py`)."""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.ops import flash_attention as fa


def _pad8(n):
    return -(-n // 8) * 8


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,H,N,M,D", [(1, 16, 36864, 36864, 88), (64, 16, 2048, 2048, 64),
                                       (2, 3, 1001, 777, 104), (1, 1, 1, 1, 32)])
def test_scratch_pieces_fit_their_layouts(B, H, N, M, D, backward):
    """Each piece has the bytes its layout needs, starts 256-byte aligned
    (TMA wants 16) and overlaps no other; the buffer holds them all."""
    pieces, size = fa.fp32_scratch(B, H, N, M, D, backward)
    nat = {"q": N, "k": M, "v": M, "do": N}
    need = {}
    for name, _ in pieces:
        op, _, kind = name.partition("_")
        if kind == "nat":
            need[name] = 2 * B * H * nat[op] * D * 4
        elif kind == "tr":
            need[name] = 2 * B * H * D * _pad8(nat[op]) * 4
        else:  # delta, lse2
            need[name] = B * H * fa.fp32_stat_rows(N) * 4
    names = [name for name, _ in pieces]
    want = (["q_nat", "q_tr", "k_nat", "k_tr", "v_nat", "do_nat", "do_tr", "delta", "lse2"]
            if backward else ["q_nat", "k_nat", "v_tr"])
    assert names == want
    spans = sorted((off, off + need[name]) for name, off in pieces)
    assert all(off % 256 == 0 for off, _ in spans)
    assert all(end <= nxt for (_, end), (nxt, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= size < spans[-1][1] + 256


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N,kv", [(584, 578), (176, 173), (1664, 1662), (65, 1)])
def test_kv_valid_plans_only_the_valid_keys(N, kv, backward):
    """With kv_valid the wrappers run the kernels over the first kv_valid
    keys (`_fp32_side`), and plan the scratch for those: the key-side copies
    hold kv_valid rows, the query side and the statistics are unchanged."""
    B, H, D = 8, 16, 64
    q = k = torch.zeros(1, 1, N, D)
    assert fa._fp32_side(q, k, None, None, None, None, kv)[3] == kv
    assert fa._fp32_side(q, k, None, None, None, None, None)[3] == N
    cut, size = fa.fp32_scratch(B, H, N, kv, D, backward)
    cut, full = dict(cut), dict(fa.fp32_scratch(B, H, N, N, D, backward)[0])
    names = list(cut)
    for name in names[:names.index("k_nat") + 1]:  # q's pieces come first, as laid out
        assert cut[name] == full[name], name
    key_bytes = {"k_nat": 2 * B * H * kv * D * 4, "k_tr": 2 * B * H * D * _pad8(kv) * 4,
                 "v_nat": 2 * B * H * kv * D * 4, "v_tr": 2 * B * H * D * _pad8(kv) * 4}
    ends = sorted(cut.values()) + [size]
    for name, want in key_bytes.items():
        if name in cut:
            nxt = min(off for off in ends if off > cut[name])
            assert want <= nxt - cut[name] < want + 256, name


@pytest.mark.parametrize("n,rows", [(1, 64), (64, 64), (65, 128), (36864, 36864)])
def test_stat_rows_cover_the_dq_blocks(n, rows):
    """The statistics rows reach the end of the last 64-query dQ block, and
    each 32-query dK/dV tile's bulk copy stays inside them."""
    assert fa.fp32_stat_rows(n) == rows
    assert all(q0 + 32 <= rows for q0 in range(0, n, 32))


def test_vec4_ready_takes_qkv_views_and_copies_the_rest():
    """q, k, v as views of one fp32 [B, N, 3, H, D] projection output are
    read in place at every head width; a 4-byte-offset view is copied."""
    for D in fa.BHND_HEAD_WIDTHS:
        qkv = torch.zeros(2, 130, 3, 4, D)
        for t in qkv.permute(2, 0, 3, 1, 4).unbind(0):
            assert fa.vec4_ready(t) and fa.vec4_operand(t) is t
    flat = torch.arange(1 + 2 * 70 * 64, dtype=torch.float32)
    t = flat[1:].view(1, 2, 70, 64)
    assert not fa.vec4_ready(t)
    c = fa.vec4_operand(t)
    assert c is not t and c.is_contiguous() and torch.equal(c, t)


@pytest.mark.parametrize("shared", [True, False])
def test_segment_ids_are_laid_out_for_the_kernels(shared):
    """The fp32 kernels read the ids as int32 rows [B, N] and [B, M] at a
    batch stride (`_fp32_side` through `_side_inputs`): ids given as [N]
    or [B, N] in any integer dtype, key-side ids of their own (M != N, a
    ring hop), values past 2**24 kept exact; the valid-key count beside
    them unchanged."""
    B, N, M = 3, 70, 45
    q, k = torch.zeros(B, 2, N, 32), torch.zeros(B, 2, M, 32)
    rng = np.random.RandomState(int(shared))
    ids_q = torch.from_numpy(rng.randint(0, 4, (1 if shared else B, N))) + (1 << 24)
    ids_k = torch.from_numpy(rng.randint(0, 4, (1 if shared else B, M))) + (1 << 24)
    _, _, seg_q, seg_k = fa._normalize(q, k, k, None, ids_q, ids_k, False, None)
    *_, Mv, sq, sk, (sq_b, sk_b) = fa._fp32_side(q, k, None, None, seg_q, seg_k, M - 2)
    assert Mv == M - 2
    for got, ids, n, stride in ((sq, ids_q, N, sq_b), (sk, ids_k, M, sk_b)):
        assert got.dtype == torch.int32 and got.shape == (B, n) and got.is_contiguous()
        assert stride == n and torch.equal(got.long(), ids.expand(B, n))
    none = fa._fp32_side(q, k, None, None, None, None, None)
    assert none[4] is None and none[5] is None and none[6] == (0, 0)


def _brute_plan(mask, m, block, tile, keys_major):
    """The plan by definition from a pair mask [B', n, m] (True = attend):
    per block, the tiles holding an attended pair, partial unless all their
    pairs are (query-major: and the tile ends at or before m)."""
    if keys_major:
        mask = mask.transpose(1, 2)
    rows, cols = mask.shape[1:]
    nb, nt = -(-rows // block), -(-cols // tile)
    out = torch.full((mask.shape[0], nb, 1 + nt), -1, dtype=torch.int32)
    for b in range(mask.shape[0]):
        for i in range(nb):
            live = []
            for t in range(nt):
                sub = mask[b, i * block:(i + 1) * block, t * tile:(t + 1) * tile]
                if sub.any():
                    full = bool(sub.all()) and (keys_major or (t + 1) * tile <= m)
                    live.append(t + (0 if full else fa.PARTIAL_TILE))
            out[b, i, 0] = len(live)
            out[b, i, 1:1 + len(live)] = torch.tensor(live, dtype=torch.int32)
    return out


@pytest.mark.parametrize("kind", ["frame-causal", "random", "past 2**24", "causal"])
@pytest.mark.parametrize("N,M", [(300, 300), (100, 257), (257, 100)])
def test_mask_tile_plan_lists_the_attended_tiles(kind, N, M):
    """`mask_tile_plan` against its definition on the pair mask, for the
    forward's blocks and tiles (128 x 64 and 128 x 32), dQ's (64 x 32) and
    dK/dV's keys-major ones, with and without kv_valid: the AC predictor's
    frame-causal ids with pad rows on int32-max, random ids, ids past 2**24
    (compared as integers) and the causal mask (the same predicate on
    positions)."""
    rng = np.random.RandomState(N + M)
    causal, seg_q, seg_k = kind == "causal", None, None
    if kind == "frame-causal":
        seg_q = torch.from_numpy(np.arange(N) // 97).int()[None].repeat(2, 1)
        seg_q[:, -3:] = torch.iinfo(torch.int32).max
        seg_k = torch.from_numpy(np.arange(M) // 97).int()[None].repeat(2, 1)
    elif kind != "causal":
        base = (1 << 24) if kind == "past 2**24" else 0
        seg_q = torch.from_numpy(rng.randint(0, 3, (2, N)) + base).int()
        seg_k = torch.from_numpy(rng.randint(0, 3, (2, M)) + base).int()
    for mv in (M, M - 5):
        if causal:
            mask = (torch.arange(mv)[None, :] <= torch.arange(N)[:, None])[None]
        else:
            mask = seg_q[:, :, None] >= seg_k[:, None, :mv]
        for block, tile, keys_major in ((128, 64, False), (128, 32, False), (64, 32, False),
                                        (64, 32, True)):
            got = fa.mask_tile_plan(seg_q, seg_k, causal, N, mv, block, tile, keys_major)
            assert torch.equal(got, _brute_plan(mask, mv, block, tile, keys_major)), (
                mv, block, tile, keys_major)


def test_mask_tile_plan_skips_the_ac_rows_masked_tiles():
    """At the DROID step's AC rows (7 frames of 258 tokens and 2 pad tokens,
    1808) the forward's plan skips the key tiles no query of a block attends
    and marks most of the rest full: the pair-by-pair test runs only where
    a frame boundary crosses a tile."""
    from vjepa2_tpu_torch.models.modules import frame_segments

    seg = frame_segments(7, 258, pad=2)[None]
    plan = fa.mask_tile_plan(seg, seg, False, 1808, 1808, 128, 64)
    counts, entries = plan[0, :, 0], plan[0, :, 1:]
    live = int(counts.sum())
    partial = int(((entries >= 0) & (entries >= fa.PARTIAL_TILE)).sum())
    assert live < 0.7 * counts.numel() * entries.shape[1]
    assert partial < 0.4 * live
    assert counts[-1] == entries.shape[1]  # the pad queries attend every key
