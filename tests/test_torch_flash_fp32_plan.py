"""The pure-Python planning around the fp32 flash kernels
(`vjepa2_tpu_torch/ops/flash_attention.py`), on the CPU: the scratch that
holds the split pre-pass's tf32 copies and the backward's row statistics
(`fp32_scratch`, `fp32_stat_rows`; with kv_valid, planned for the valid
keys only), laid out as the C entry points read it
(`csrc/flash_fp32_split.cu`: token-major [2, B, H, n, D] and feature-major
[2, B, H, D, n rounded up to 8], hi then lo; statistics [B, H, Np]), and
which operands the pre-pass's 16-byte reads take in place (`vec4_ready`).
The kernels themselves run only on the card (`test_torch_flash_fp32_cuda.py`)."""

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
    assert fa._fp32_side(q, k, None, None, None, False, kv)[3] == kv
    assert fa._fp32_side(q, k, None, None, None, False, None)[3] == N
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
