"""B1 and B2 on fp32 operands, as the port runs them on the card (the 3xTF32
kernels of `vjepa2_tpu_torch/csrc/flash_fp32.cuh` on the DN layout), emulated
on the CPU against the JAX package's DN kernels `_flash_fwd_bhdn` and
`_flash_bwd_bhdn` in interpret mode on the same fp32 inputs (JAX runs them in
the operands' dtype, as `tests/test_torch_flash_dn.py` runs them).

The emulation is `tests/test_torch_flash_fp32_split.py`'s (every product
lo·hi + hi·lo + hi·hi of tf32 parts rounded as ``cvt.rna`` rounds, the
softmax in base 2, RoPE before the split and its adjoint after, kv_valid's
key count, the masks on the scores), taken through the DN layout as the
kernels take it: the pre-pass reads the [B, H, D, N] operands and writes
their token-major split (the emulation's [B, H, N, D] operands), with the
tables [B|1, D, N] read along the tokens; delta is the sum over D of dO·O;
out, dq, dk and dv leave D-major. Cases: head widths 16, 32, 48 and 64
(B = 2, H = 2, N = 128), RoPE tables shared and per example with kv_valid,
the AC predictor's frame-causal ids with the pad keys on int32-max (with
RoPE), and a row with no key (key-side ids the DN wrapper cannot express,
but the kernels' launches take: out 0, lse -inf, no gradient, against the
port's plain BHND version, since JAX's kernels average v there).

Tolerances, the kernels' (`chip_smoke.py`: FP32_REL_L2, FP32_MAX_ABS,
FP32_LSE_ATOL): out and the gradients within 2e-5 relative L2 and
1e-4·max|JAX| absolute, lse within 1e-5 absolute. The same emulation with
one TF32 product (hi·hi) misses every one of them at head width 64.

Also here: `Attention`'s route depends on the head width alone, not on the
dtype or the device (DN at heads of 16-64, BHND at 80, 88 and 104).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_fp32_split import emulated_bwd, emulated_fwd, kernel_mask
from vjepa2_tpu.ops.flash_attention_dn import _flash_bwd_bhdn, _flash_fwd_bhdn
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.ops import flash_attention as fa

B, H, N = 2, 2, 128
REL_L2, MAX_ABS, LSE_ATOL = 2e-5, 1e-4, 1e-5
PAD_SEGMENT = np.iinfo(np.int32).max


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (6 pytest workers share
    the host; see `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dn(t):
    """[B, H, n, D] <-> [B, H, D, n], contiguous: the DN layout's store."""
    return t.transpose(2, 3).contiguous()


def emulated_dn_fwd(q, k, v, parts=3, rope=None, kv=None, mask=None):
    """The kernels' forward on DN operands: the pre-pass's token-major copies
    of q, k and v ([B, H, D, n] read along the tokens), tables [B|1, D, N]
    (given here [B|1, N, D]) read along the tokens, out stored D-major."""
    out, lse = emulated_fwd(_dn(q), _dn(k), _dn(v), parts, rope=rope, kv=kv, mask=mask)
    return _dn(out), lse


def emulated_dn_bwd(q, k, v, out, lse, do, parts=3, rope=None, kv=None, mask=None):
    """The kernels' backward on DN operands: delta over D of dO·O (the
    emulation's rowsum over the token-major copies' features), dq, dk and dv
    stored D-major, dk and dv zero past kv_valid."""
    grads = emulated_bwd(_dn(q), _dn(k), _dn(v), _dn(out), lse, _dn(do), parts, rope=rope, kv=kv,
                         mask=mask)
    return tuple(_dn(g) for g in grads)


def _jax(q, k, v, do, rope=None, kv=None, seg=None):
    """JAX's DN forward (out, lse) and backward given them, as numpy."""
    segq = segk = cos = sin = None
    if seg is not None:  # the kernels' fp32 side layouts (exact below 2**24)
        sf = jnp.asarray(seg.astype(np.float32))
        segq, segk = sf[:, None, :], sf[:, :, None]
    if rope is not None:  # the JAX kernels read [B|1, D, N] tables
        cos, sin = (jnp.asarray(t.transpose(0, 2, 1)) for t in rope)
    args = [jnp.asarray(t) for t in (q, k, v)] + [segq, segk, cos, sin, cos, sin]
    blocks = dict(block_q=128, block_k=64, interpret=True, kv_valid=kv)
    out, lse = _flash_fwd_bhdn(*args, **blocks)
    grads = _flash_bwd_bhdn(*args, out, lse, jnp.asarray(do), **blocks)
    out, lse, *grads = jax.block_until_ready((out, lse, *grads))
    return [np.asarray(out), np.asarray(lse)[:, :, 0], *map(np.asarray, grads)]


def _errors(got, want):
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            np.abs(got - want).max() / np.abs(want).max())


def _hold(want, q, k, v, do, parts=3, **features):
    """The emulation on DN operands against JAX's (out, lse, dq, dk, dv): with
    3 TF32 products within the kernels' tolerances (True), or with 1 every
    output outside them (the returned flags all False)."""
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = emulated_dn_fwd(tq, tk, tv, parts, **features)
    grads = emulated_dn_bwd(tq, tk, tv, out, lse, tdo, parts, **features)
    kv = features.get("kv")
    if kv is not None and parts == 3:  # dK/dV writes zeros past kv_valid
        assert not grads[1][..., kv:].any() and not grads[2][..., kv:].any()
    flags = [np.abs(lse.double().numpy() - want[1]).max() <= LSE_ATOL]
    for got, w in zip((out, *grads), (want[0], *want[2:])):
        rel, mx = _errors(got, w)
        flags += [rel <= REL_L2, mx <= MAX_ABS]
    return flags


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, D, N).astype(np.float32) for _ in range(4)] + [rng]


@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_dn_3xtf32_holds_the_kernels_tolerances(D):
    q, k, v, do, _ = _inputs(D, seed=D)
    want = _jax(q, k, v, do)
    assert all(_hold(want, q, k, v, do)), D
    if D == 64:  # one TF32 product misses every tolerance
        assert not any(_hold(want, q, k, v, do, parts=1))


@pytest.mark.parametrize("D", [16, 32, 48, 64])
@pytest.mark.parametrize("per_example", [False, True])
def test_dn_3xtf32_with_rope_and_kv_valid(D, per_example):
    """The pre-pass's rotation (tables read along the tokens), the
    epilogues' adjoint and kv_valid's key count, D-major stores."""
    q, k, v, do, rng = _inputs(D, seed=D + 100 * per_example)
    rope = tuple(rng.uniform(-1, 1, (B if per_example else 1, N, D)).astype(np.float32)
                 for _ in range(2))
    kv = N - 5
    want = _jax(q, k, v, do, rope=rope, kv=kv)
    assert all(_hold(want, q, k, v, do, rope=tuple(map(torch.from_numpy, rope)), kv=kv))


@pytest.mark.parametrize("D", [48, 64])
def test_dn_3xtf32_with_frame_causal_ids_and_pad_keys(D):
    """The AC predictor's ids at fp32: 2 frames of 60 tokens and 8 pad tokens
    on int32-max (pad queries attend every key, no real query a pad key),
    with shared RoPE tables."""
    q, k, v, do, rng = _inputs(D, seed=7 + D)
    seg = np.concatenate([np.repeat(np.arange(2), 60), np.full(8, PAD_SEGMENT)])
    seg = np.tile(seg.astype(np.int32), (B, 1))
    rope = tuple(rng.uniform(-1, 1, (1, N, D)).astype(np.float32) for _ in range(2))
    want = _jax(q, k, v, do, rope=rope, seg=seg)
    ids = torch.from_numpy(seg)
    assert all(_hold(want, q, k, v, do, rope=tuple(map(torch.from_numpy, rope)),
                     mask=kernel_mask(N, N, ids, ids)))


def test_dn_3xtf32_row_with_no_key():
    """Queries whose id is below every key's (key-side ids, as the kernels'
    launches take them): out 0, lse -inf, dq 0 on those rows, the D-major
    results within the tolerances of the port's plain BHND version."""
    q, k, v, do, _ = _inputs(32, seed=17)
    seg_q = torch.ones(B, N, dtype=torch.int32)
    seg_q[:, :5] = 0
    seg_k = torch.ones(B, N, dtype=torch.int32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    mask = kernel_mask(N, N, seg_q, seg_k)
    out, lse = emulated_dn_fwd(tq, tk, tv, mask=mask)
    dq, dk, dv = emulated_dn_bwd(tq, tk, tv, out, lse, tdo, mask=mask)
    assert not out[..., :5].any() and torch.isneginf(lse[..., :5]).all()
    assert not dq[..., :5].any()
    kw = {"segment_ids": seg_q, "seg_kv": seg_k}
    bq, bk, bv = (t.transpose(2, 3) for t in (tq, tk, tv))
    want_out, want_lse = fa.flash_attention_bhnd_plain(bq, bk, bv, **kw)
    want = fa.flash_attention_bhnd_bwd_plain(bq, bk, bv, out.transpose(2, 3), lse,
                                             tdo.transpose(2, 3), **kw)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    assert (lse - want_lse)[..., 5:].abs().max().item() <= LSE_ATOL
    for got, w in zip((out, dq, dk, dv), (want_out, *want)):
        rel, mx = _errors(got, w.transpose(2, 3))
        assert rel <= REL_L2 and mx <= MAX_ABS, (rel, mx)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that says it is on the card: `Attention`'s route must
    not look."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("head_dim,route", [(16, "dn"), (32, "dn"), (48, "dn"), (64, "dn"),
                                            (80, "bhnd"), (88, "bhnd"), (104, "bhnd")])
def test_attention_route_depends_on_the_head_width_alone(monkeypatch, head_dim, route):
    """With ``use_flash``, `Attention` takes the DN route at heads of 16-64
    and the BHND route at 80, 88 and 104, as JAX does (`modules.py:515-546`),
    at fp32 and bf16 and on a tensor that says it is on the card."""
    taken = []

    def recorder(name):
        def attend(q, k, v, **kw):
            taken.append(name)
            return torch.zeros_like(v)
        return attend

    monkeypatch.setattr(tm, "attend_bhdn", recorder("dn"))
    monkeypatch.setattr(tm, "attend_bhnd", recorder("bhnd"))
    for dtype in (torch.float32, torch.bfloat16):
        attn = tm.Attention(2 * head_dim, 2, use_flash=True, dtype=dtype)
        x = torch.zeros(1, 8, 2 * head_dim)
        for inp in (x, x.as_subclass(_ClaimsCuda)):
            attn(inp)
    assert taken == [route] * 4
