"""The port's ring attention (`ops/ring_attention.py`) against the JAX
package's `seq_sharded_attention` (`vjepa2_tpu/ops/ring_attention.py`) on a
``model`` mesh of R virtual CPU devices (its XLA hops, as JAX's own tests
run it), at R = 2 and 4, on JAX's test shapes (`tests/ops/test_ring_attention.py`:
B 2, H 2, D 16, N 64; N 60 for the pad onto the ring), fp32.

* The in-process ring (`in_process_ring`: the R shards held in one process,
  each hop B3's plain version, each backward hop the BHND backward's) gives
  the forward and dq, dk, dv of JAX's ring, without and with frame-causal
  segment ids and with N not a multiple of R * 8, within the BHND parity
  tests' fp32 tolerances (atol 2e-5, rtol 1e-4; the hops sum in another
  order than one softmax).
* 2 and 4 spawned gloo processes (`seq_sharded_attention` over their group)
  give the in-process ring's bits: the same hops in the same order, the
  same merge.
* Under a selective remat policy the recompute takes the ring's (out, lse)
  from the forward (`torch.ops.vjepa2.ring_fwd` runs once) and the gradients
  are bit-equal to those without remat.
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from test_torch_distributed import spawn
from vjepa2_tpu_torch.models.modules import _remat_policy, resolve_remat_policy
from vjepa2_tpu_torch.ops import ring_attention as ra

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(N, seed, B=2, H=2, D=16):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, N, H, D).astype(np.float32) for _ in range(4))
    return q, k, v, w


def _segments(N, frames=4):
    return np.repeat(np.arange(frames, dtype=np.int32), N // frames)


def _port(apply, q, k, v, w, seg=None):
    """out [B, N, H, D] and (dq, dk, dv) of sum(out * w), through ``apply``
    (which takes [B, H, N, D])."""
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2).requires_grad_() for x in (q, k, v))
    out = apply(qt, kt, vt, None if seg is None else torch.from_numpy(seg))
    grads = torch.autograd.grad((out * torch.from_numpy(w).transpose(1, 2)).sum(), (qt, kt, vt))
    return [out.detach().transpose(1, 2)] + [g.transpose(1, 2) for g in grads]


CASES = [("plain", 64, False), ("frame_causal", 64, True), ("pad", 60, False)]


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("name, N, frame_causal", CASES)
def test_in_process_ring_matches_jax(R, name, N, frame_causal):
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu.ops.ring_attention import seq_sharded_attention

    q, k, v, w = _inputs(N, seed=R + N)
    seg = _segments(N) if frame_causal else None
    mesh = make_mesh(MeshConfig(data=8 // R, fsdp=1, model=R))
    japply = seq_sharded_attention(mesh, "model")
    jseg = None if seg is None else jnp.asarray(seg)

    def loss(a, b, c):
        return jnp.sum(japply(a, b, c, jseg) * jnp.asarray(w))

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = [jax.jit(lambda a, b, c: japply(a, b, c, jseg))(jq, jk, jv)]
    want += list(jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv))
    want = [np.asarray(jax.block_until_ready(x)) for x in want]

    got = _port(ra.in_process_ring(R), q, k, v, w, seg)
    assert got[0].shape == (2, N, 2, 16)
    for g, x, what in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), x, atol=ATOL, rtol=RTOL, err_msg=what)


def _process_ring(rank, world, N, frame_causal):
    from vjepa2_tpu_torch.core import distributed

    q, k, v, w = _inputs(N, seed=world + N)
    seg = _segments(N) if frame_causal else None
    apply = ra.seq_sharded_attention(distributed.world_group())
    return _port(apply, q, k, v, w, seg)


@pytest.mark.parametrize("R, N, frame_causal", [(2, 64, True), (4, 60, False)])
def test_process_ring_gives_the_in_process_bits(tmp_path, R, N, frame_causal):
    q, k, v, w = _inputs(N, seed=R + N)
    want = _port(ra.in_process_ring(R), q, k, v, w, _segments(N) if frame_causal else None)
    for rank, got in enumerate(spawn(_process_ring, R, tmp_path, N, frame_causal)):
        for g, x, what in zip(got, want, ("out", "dq", "dk", "dv")):
            assert torch.equal(g, x), f"{what} on rank {rank}"


def test_remat_keeps_the_rings_out_and_lse(monkeypatch):
    """'save_attn' keeps the ring's (out, lse): the recompute runs no hop, and
    the gradients are those without remat, bit for bit; 'full' runs the ring
    again."""
    q, k, v, w = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(64, seed=9))
    apply = ra.in_process_ring(4)
    calls = []
    real = ra.ring_forward
    monkeypatch.setattr(ra, "ring_forward", lambda *a: calls.append(1) or real(*a))

    def run(saves):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))

        def f(a, b, c):
            return (apply(a, b, c) * w).sum()

        if saves is None:
            loss = f(qq, kk, vv)
        else:
            kwargs = {"context_fn": _remat_policy(saves)} if saves else {}
            loss = checkpoint(f, qq, kk, vv, use_reentrant=False, **kwargs)
        calls.clear()
        grads = torch.autograd.grad(loss, (qq, kk, vv))
        return grads, len(calls)

    plain, n_plain = run(None)
    kept, n_kept = run(resolve_remat_policy("save_attn"))
    full, n_full = run(frozenset())
    assert (n_plain, n_kept, n_full) == (0, 0, 1)
    for a, b, c in zip(plain, kept, full):
        assert torch.equal(a, b) and torch.equal(a, c)
