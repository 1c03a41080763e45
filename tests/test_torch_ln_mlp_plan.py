"""The host side of B8, the fused LayerNorm + fc1 + GELU on wgmma and TMA
(`vjepa2_tpu_torch/ops/ln_mlp.py`), on the CPU: the wrapper hands the kernel
x and W as rows of C elements (`.contiguous()`); the entry point refuses an
operand its 2-D TMA maps cannot read (an unaligned base, by `tma_ready`'s
rule), and the wrapper then calls again with `tma_operand`'s copy. The shape
checks that run before any launch. The kernel, its tiles and its persistent
grid run only on the card (`test_torch_ln_cuda.py`, ragged row counts
included)."""

import pytest
import torch

from vjepa2_tpu_torch.ops import ln_mlp
from vjepa2_tpu_torch.ops.flash_attention import tma_operand, tma_ready
from vjepa2_tpu_torch.ops.layernorm import LN_WIDTHS

PAIRS = [(384, 1536), (1024, 4096), (1280, 5120), (1408, 6144)]


@pytest.mark.parametrize("shape", [(8, 2048, 1024), (1, 1, 384), (16384, 1408)])
def test_contiguous_aligned_operands_are_read_in_place(shape):
    t = torch.zeros(shape, dtype=torch.bfloat16)
    assert t.data_ptr() % 16 == 0
    assert tma_ready(t) and tma_operand(t) is t


@pytest.mark.parametrize("C,hidden", PAIRS)
@pytest.mark.parametrize("operand", ["x", "w"])
def test_model_operands_are_read_in_place(C, hidden, operand):
    """x [B, N, C] and fc1.weight [hidden, C] as the model holds them."""
    t = (torch.zeros(2, 40, C, dtype=torch.bfloat16) if operand == "x"
         else torch.zeros(hidden, C, dtype=torch.bfloat16))
    assert t.contiguous() is t and tma_ready(t)


@pytest.mark.parametrize("rows", [1, 37, 130, 1003])
def test_ragged_row_counts_are_read_in_place(rows):
    """Any row count: TMA zero-fills the rows past R of the last tile."""
    x = torch.zeros(1, rows, 1024, dtype=torch.bfloat16)
    assert tma_ready(x)


@pytest.mark.parametrize("offset", [1, 3, 4])
def test_unaligned_slice_is_copied(offset):
    """A contiguous x whose base is not 16-byte aligned is refused by the
    entry point and copied to a fresh aligned tensor with the same values."""
    flat = torch.arange(8 + 2 * 40 * 384, dtype=torch.float32).to(torch.bfloat16)
    x = flat[offset: offset + 2 * 40 * 384].view(2, 40, 384)
    assert x.data_ptr() % 16 and x.contiguous() is x and not tma_ready(x)
    c = tma_operand(x)
    assert c is not x and c.is_contiguous() and c.data_ptr() % 16 == 0 and torch.equal(c, x)


@pytest.mark.parametrize("case", ["transposed_w", "strided_rows", "broadcast"])
def test_strided_operands_are_copied(case):
    """The kernel's maps step rows of exactly C elements: a transposed W, rows
    with a gap, or a broadcast x is made contiguous before the call."""
    if case == "transposed_w":
        t = torch.zeros(1024, 4096, dtype=torch.bfloat16).t()
    elif case == "strided_rows":
        t = torch.zeros(2, 40, 1032, dtype=torch.bfloat16)[..., :1024]
    else:
        t = torch.zeros(1, 1, 384, dtype=torch.bfloat16).expand(2, 40, 384)
    c = t.contiguous()
    assert c is not t and c.is_contiguous() and torch.equal(c, t) and tma_ready(c)


def test_widths_are_whole_chunk_pairs_and_column_tiles():
    """The kernel's mainloop takes K in pairs of 64-wide chunks (C a multiple
    of 128) and its tiles are 256 columns wide (hidden a multiple of 256)."""
    assert all(C % 128 == 0 for C in LN_WIDTHS)
    assert all(h % 256 == 0 for h in ln_mlp.MLP_HIDDEN_WIDTHS)


def test_widths_pair_as_the_models_do():
    assert [(C, h) for C, h in PAIRS] == list(zip(LN_WIDTHS, ln_mlp.MLP_HIDDEN_WIDTHS))


@pytest.mark.parametrize("bad", ["w_width", "bias", "gamma"])
def test_shape_checks(bad):
    """Shapes that do not fit raise before any launch."""
    x = torch.zeros(1, 4, 384, dtype=torch.bfloat16)
    gamma, beta = torch.ones(384), torch.zeros(384)
    w, bias = torch.zeros(1536, 384, dtype=torch.bfloat16), torch.zeros(1536)
    if bad == "w_width":
        w = torch.zeros(1536, 256, dtype=torch.bfloat16)
    elif bad == "bias":
        bias = torch.zeros(1024)
    else:
        gamma = torch.ones(256)
    with pytest.raises(ValueError):
        ln_mlp.ln_mlp(x, gamma, beta, w, bias)
