"""The port's BHND flash attention on fp32 operands (the frozen probes'
route) on the CPU, where the wrappers take their plain versions, against the
JAX package's B3/B4/B5 Pallas kernels in interpret mode on the same fp32
inputs (JAX runs them in the operands' dtype, `flash_attention.py:202`):

* out and lse against `_flash_fwd_bhnd` at head widths 64 and 88, N = 200
  (ragged to the CUDA kernels' 64-row tile; JAX takes 40-row blocks);
* dq, dk, dv through `torch.autograd` against `jax.vjp` of
  `flash_attention_bhnd` (its default backward; both B4 and B5 hold the
  port's fp32 backward in `tests/test_torch_flash_bhnd_bwd.py`);
* an `AttentiveClassifier` (depth 4, heads of 88 as ViT-g/384's probes, 4
  of them where those have 16, 200 tokens) built with ``use_flash=True``
  against JAX's probe on the same weights (`hub.converter.probe_grid_from_flax`,
  whose state-dict keys the flash model keeps): its logits; and a
  `ProbeGrid` train step with its blocks on the flash route (the card's;
  plain on the CPU by default): the loss and probe 0's gradients (read from
  Adam's first moment, m = (1 - b1) g after one step from zero). The JAX
  probe's programs take most of this file's time, so one width runs, at 4
  heads (at Dh 64 the CPU takes the DN route's plain version, the same
  function).

Tolerances: fp32 on both sides, the kernels in base 2 over 40- and 64-wide
blocks, the plain versions in base e over whole rows: out, gradients and
logits within 1e-5 relative L2, lse within 1e-5 absolute; the step's loss
within 1e-5 relative. The CUDA kernels themselves run in
`tests/test_torch_flash_fp32_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vjepa2_tpu.evals import probes as jprobes
from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu_torch.evals import probes
from vjepa2_tpu_torch.hub.converter import probe_grid_from_flax
from vjepa2_tpu_torch.models.attentive_pooler import AttentiveClassifier
from vjepa2_tpu_torch.ops import flash_attention as fa

B, H, N = 1, 2, 200
REL_L2, LSE_ATOL, LOSS_RTOL = 1e-5, 1e-5, 1e-5
PROBE_B, PROBE_N, PROBE_HEADS, CLASSES = 2, 200, 4, 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, N, D).astype(np.float32) for _ in range(4)]  # q, k, v, do


def _jax_result(fn, *arrays, **kw):
    """fn on copies of the numpy arrays, finished and fetched before the
    port's side runs (`tests/test_torch_flash_bhnd_bwd.py`)."""
    out = fn(*(jnp.array(a, copy=True) for a in arrays), **kw)
    return [np.array(o) for o in jax.block_until_ready(out)]


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_forward_matches_jax_kernel(D):
    q, k, v, _ = _inputs(D)
    block = jfa.pick_block(N, 64)  # JAX's blocks divide N; the CUDA kernels mask their edge
    out_j, lse_j = _jax_result(
        lambda q, k, v: jfa._flash_fwd_bhnd(q, k, v, None, None, None, None, None,
                                            block_q=block, block_k=block, interpret=True),
        q, k, v)
    out_t, lse_t = fa.flash_attention_bhnd(*map(torch.from_numpy, (q, k, v)), return_lse=True)
    assert out_t.dtype == lse_t.dtype == torch.float32
    assert _rel(out_t.numpy(), out_j) <= REL_L2
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("D", [64, 88])
def test_fp32_gradients_match_jax_kernels(D):
    q, k, v, do = _inputs(D, seed=1)

    def jax_grads(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bhnd(
            q, k, v, block_q=64, block_k=64, interpret=True), q, k, v)
        return vjp(do)

    want = _jax_result(jax_grads, q, k, v, do)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention_bhnd(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), w) <= REL_L2, name


PROBE_DH = 88
PROBE_CFG = dict(lr=2e-3, weight_decay=0.05, final_wd=0.2)


@pytest.fixture(scope="module")
def jax_probe():
    """JAX's one-probe grid (depth 4, heads of 88) and its initial state."""
    grid = jprobes.ProbeGrid([jprobes.ProbeConfig(**PROBE_CFG)],
                             embed_dim=PROBE_HEADS * PROBE_DH, num_classes=CLASSES,
                             num_heads=PROBE_HEADS, depth=4, total_steps=4, seed=0)
    # one probe's init, stacked to [1, ...], and optax's Adam state for it: the
    # grid's state at its init (`ProbeGrid.init` vmaps the same, slower to build)
    one = jax.jit(grid.model.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, PROBE_N, PROBE_HEADS * PROBE_DH)))["params"]
    params = jax.tree_util.tree_map(lambda a: a[None], one)
    opt = jax.vmap(optax.scale_by_adam().init)(params)
    return grid, *(jax.tree_util.tree_map(np.array, t) for t in (params, opt)), jnp.int32(0)


def _features(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(PROBE_B, PROBE_N, PROBE_HEADS * PROBE_DH).astype(np.float32),
            rs.randint(0, CLASSES, size=PROBE_B))


def test_flash_probe_logits_match_jax(jax_probe):
    jgrid, jparams, _, _ = jax_probe
    feats, _ = _features(0)
    one = jax.tree_util.tree_map(lambda a: a[0], jparams)
    (want,) = _jax_result(lambda x: (jgrid.model.apply({"params": one}, x),), feats)

    model = AttentiveClassifier(embed_dim=PROBE_HEADS * PROBE_DH, num_heads=PROBE_HEADS,
                                depth=4, num_classes=CLASSES, use_flash=True)
    assert all(blk.attn.use_flash for blk in model.pooler.blocks)
    stacked = probe_grid_from_flax(jparams)
    assert set(stacked) == set(model.state_dict())  # the flash route keeps the keys
    model.load_state_dict({k: v[0] for k, v in stacked.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    assert got.shape == (PROBE_B, CLASSES)
    assert _rel(got.numpy(), want) <= REL_L2


def test_flash_probe_grid_step_matches_jax(jax_probe):
    """One step of the one-probe grid with ``use_flash=True``, from JAX's
    initial state."""
    jgrid, jparams, jopt, jstep = jax_probe
    tgrid = probes.ProbeGrid([probes.ProbeConfig(**PROBE_CFG)],
                             embed_dim=PROBE_HEADS * PROBE_DH, num_classes=CLASSES,
                             num_heads=PROBE_HEADS, depth=4, total_steps=4, seed=0)
    for blk in tgrid.model.pooler.blocks:  # the card's route, on the CPU
        blk.attn.use_flash = True
    params, opt = probe_grid_from_flax(jparams), {
        "mu": probe_grid_from_flax(jopt.mu), "nu": probe_grid_from_flax(jopt.nu),
        "count": torch.zeros(1, dtype=torch.int32)}
    feats, labels = _features(1)
    # copies: JAX's step donates its state
    _, jopt2, _, jm = jgrid.train_step(*(jax.tree_util.tree_map(jnp.array, t)
                                         for t in (jparams, jopt, jstep)),
                                       jnp.asarray(feats), jnp.asarray(labels))
    want_loss = np.asarray(jm["loss"])
    want_mu = probe_grid_from_flax(jax.tree_util.tree_map(np.asarray, jopt2.mu))
    _, opt, _, metrics = tgrid.train_step(params, opt, 0, torch.from_numpy(feats),
                                          torch.from_numpy(labels))
    np.testing.assert_allclose(metrics["loss"].numpy(), want_loss, rtol=LOSS_RTOL)
    names = sorted(want_mu)
    got = np.concatenate([opt["mu"][k][0].numpy().ravel() for k in names])
    want = np.concatenate([want_mu[k][0].numpy().ravel() for k in names])
    assert _rel(got, want) <= REL_L2
