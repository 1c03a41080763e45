"""Parameter sharding, tensor parallelism and the pipeline's CLI run across
processes (`core/sharding.py`, `ops/tensor_parallel.py`, `core/pipeline.py`)
against the JAX package's on its 8-virtual-device mesh and against one port
process. Every rank is a spawned process on gloo over a FileStore in
``tmp_path``, one thread each; the functions the ranks run import no JAX.
`tests/test_torch_pipeline.py` holds the 8-rank steps with these helpers.

Tolerances as `tests/test_torch_data_parallel.py`'s: loss and grad norm rtol
1e-5; gradients (gathered whole) atol 1e-6 + 1e-4 of each leaf's largest
entry against the one-process step's; the EMA target atol 1e-6 of JAX's;
the DROID predictor within 1e-3 relative L2 of JAX's update (Adam's eps
amplifies rounding, `tests/test_torch_droid_step.py`); the gathered state
bit-equal on every rank.

* `param_placement` against JAX's `param_spec` for every parameter of the
  encoder, the predictor and the AC predictor (names through
  `hub.converter`), with tp, with cp and with neither, and on the cases of
  JAX's `tests/core/test_mesh.py:32-57`; `global_norm` over shards against
  ``optax.global_norm`` at ``fsdp 2 x model 2``.
* FSDP (4 ranks, ``data 2 x fsdp 2``): the pretrain step against JAX's on
  ``make_mesh(MeshConfig(data=2, fsdp=2))``; ``grad_accum`` 2 against the
  whole batch; a checkpoint written at ``fsdp 2`` restored at ``fsdp 2``
  and in one process, bit-equal.
* 2 ranks: each attention route's (plain, DN, BHND, fused) output and
  gradients under TP against the whole layer; the remat policies: under
  ``save_attn_qkv`` the recompute runs no TP collective, under ``full`` it
  does, the gradients bit-equal to no remat. The q/k/v rows of a rank with
  the RoPE permutation (no process).
* ``cli.main`` on ``smoke-pipeline.yaml``'s 8 ranks (``data 2 x pipe 4``, 2
  steps): finite losses as JAX's `test_smoke_pipeline_config_end_to_end`
  checks, the checkpoint restored bit-equal on the mesh and in one process,
  the online evals' gathered encoder; then at ``data 2 x fsdp 2 x model 2``,
  the pretraining app and the DROID app (the AC predictor's heads on
  ``model``).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_data_parallel import (GRAD_ATOL, HP, MASK_CFGS, PRED, RTOL, UPDATE_REL_L2, ENC,
                                      _assert_grads, _flax_sd, _jax_sharded_step, _masks,
                                      _port_step, _spawn_plain)
from test_torch_distributed import spawn
from vjepa2_tpu_torch.core import distributed

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bit_equal_ranks(dicts, what):
    for r, d in enumerate(dicts[1:], start=1):
        for k, v in d.items():
            assert torch.equal(v, dicts[0][k]), f"{what} {k} on rank {r}"


def _near_update(got, want, before, what):
    """``got`` within 1e-3 relative L2 of the update ``want - before``."""
    for k, w in want.items():
        update = (w - before[k]).norm()
        assert (got[k] - w).norm() <= UPDATE_REL_L2 * update + 1e-12, f"{what} {k}"


# ---------------------------------------------------------------- placement

def _jax_spec_as_port(spec, name, ndim):
    """A JAX PartitionSpec over the flax leaf -> the port's tuple over its dims."""
    from vjepa2_tpu_torch.core.mesh import _torch_to_flax_dims

    entries = list(spec) + [None] * (ndim - len(spec))
    out = [None] * ndim
    for i, d in enumerate(_torch_to_flax_dims(name, ndim)):
        e = entries[i]
        out[d] = tuple(e) if isinstance(e, (tuple, list)) else e
    return tuple(out)


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class _K:
    def __init__(self, key):
        self.key = key


def _port_name(path):
    """A flax leaf path -> the port's state-dict name (`hub.converter`)."""
    import re

    parts = []
    for p in path[:-1]:
        m = re.fullmatch(r"(.+)_(\d+)", p)
        parts += [m.group(1), m.group(2)] if m else [p]
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(parts + [leaf])


@functools.lru_cache(maxsize=1)
def _jax_trees():
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.models.ac_predictor import vit_ac_predictor
    from vjepa2_tpu.models.predictor import VisionTransformerPredictor
    from vjepa2_tpu.models.vision_transformer import VisionTransformer, vit_tiny

    me, mp = _masks(MASK_CFGS[1:], 4, 32, 2)
    clips = jnp.zeros((2, 4, 32, 32, 3))
    enc = VisionTransformer(img_size=(32, 32), patch_size=16, num_frames=4, tubelet_size=2,
                            embed_dim=64, depth=2, num_heads=2, use_rope=True,
                            dtype=jnp.float32)
    ev = jax.jit(lambda c, m: enc.init(jax.random.PRNGKey(0), c, [m]))(clips, jnp.asarray(me[0]))
    z = enc.apply(ev, clips, [jnp.asarray(me[0])])
    pred = VisionTransformerPredictor(img_size=(32, 32), patch_size=16, num_frames=4,
                                      tubelet_size=2, embed_dim=64, predictor_embed_dim=32,
                                      depth=1, num_heads=2, use_mask_tokens=True,
                                      num_mask_tokens=2, use_rope=True)
    pv = jax.jit(lambda z, a, b: pred.init(jax.random.PRNGKey(1), z, a, b, 0))(
        z, jnp.asarray(me[0]), jnp.asarray(mp[0]))
    tiny = vit_tiny(img_size=(32, 32), num_frames=2, tubelet_size=2, use_rope=True)
    ac = vit_ac_predictor(img_size=(32, 32), patch_size=16, num_frames=4, tubelet_size=2,
                          embed_dim=192, predictor_embed_dim=64, depth=1, num_heads=2)
    x = jnp.zeros((1, 2 * 4, 192))
    av = jax.jit(lambda x: ac.init(jax.random.PRNGKey(2), x, jnp.zeros((1, 2, 7)),
                                   jnp.zeros((1, 2, 7))))(x)
    return {"encoder": ev["params"], "predictor": pv["params"], "ac_predictor": av["params"]}


_MESH_CASES = [("blocks_0/attn/qkv/kernel", (64, 192)), ("blocks_0/attn/proj/kernel", (64, 64)),
               ("blocks_0/mlp/fc1/kernel", (64, 256)), ("blocks_0/mlp/fc2/kernel", (256, 64)),
               ("blocks_0/mlp/fc2/kernel", (64, 256)), ("blocks_0/mlp/fc3/kernel", (256, 64)),
               ("norm/scale", (64,)), ("patch_embed/proj/kernel", (2, 16, 16, 3, 64)),
               ("patch_embed/proj/kernel", (16, 16, 3, 64)),  # the image tokenizer
               ("blocks_0/mlp/fc2/kernel", (64, 176))]  # SwiGLU's fc2: column-parallel


@pytest.mark.parametrize("tp, cp", [(True, False), (False, True), (False, False)])
def test_param_placement_matches_jax_param_spec(tp, cp):
    from vjepa2_tpu.core.mesh import param_spec

    from vjepa2_tpu_torch.core.mesh import param_placement

    n = 0
    trees = _jax_trees()
    for tree in trees.values():
        for path, leaf in _flax_leaves(tree):
            name = _port_name(path)
            if path[-1] == "mask_tokens":  # [num, P] -> mask_tokens.j [1, 1, P]
                want = ((None, None) + (("fsdp", "model") if cp else "fsdp",))
                assert param_placement(f"{name}.0", (1, 1, leaf.shape[1]), tp=tp, cp=cp) == want
                continue
            spec = param_spec(tuple(_K(p) for p in path), leaf, tp=tp, cp=cp)
            shape = _port_shape(name, leaf.shape)
            assert param_placement(name, shape, tp=tp, cp=cp) == _jax_spec_as_port(
                spec, name, len(shape)), name
            n += 1
    assert n > 40
    for path, shape in _MESH_CASES:
        name = _port_name(tuple(path.split("/")))
        spec = param_spec(tuple(_K(p) for p in path.split("/")), np.zeros(shape), tp=tp, cp=cp)
        assert param_placement(name, _port_shape(name, shape), tp=tp, cp=cp) == \
            _jax_spec_as_port(spec, name, len(shape)), path
    if tp:
        with pytest.raises(ValueError):
            param_placement("x.weight", (4, 4), tp=True, cp=True)


def _port_shape(name, flax_shape):
    from vjepa2_tpu_torch.core.mesh import _torch_to_flax_dims

    order = _torch_to_flax_dims(name, len(flax_shape))
    shape = [0] * len(flax_shape)
    for i, d in enumerate(order):
        shape[d] = flax_shape[i]
    return tuple(shape)


def _norm_rank(rank, world, full):
    from vjepa2_tpu_torch.core.mesh import MeshConfig, make_mesh, state_group
    from vjepa2_tpu_torch.core.optim import global_norm

    mesh = make_mesh(MeshConfig(data=1, fsdp=2, model=2), device_type="cpu")
    f, m = mesh.get_local_rank("fsdp"), mesh.get_local_rank("model")
    a, b, c = full
    shards = [a.chunk(2, 0)[f].chunk(2, 1)[m],  # fsdp x model: 1 copy
              b,                                 # whole: 4 copies
              c.chunk(2, 1)[f]]                  # fsdp only: 2 copies (model)
    return float(global_norm(shards, state_group(mesh), [1, 4, 2]))


def test_global_norm_over_shards_matches_optax(tmp_path):
    import jax.numpy as jnp
    import optax

    rs = np.random.RandomState(3)
    full = [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((8, 6), (6,), (5, 4))]
    want = float(optax.global_norm([jnp.asarray(t.numpy()) for t in full]))
    for got in spawn(_norm_rank, 4, tmp_path, full):
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------------ steps

def _full_grads(par, state):
    """Every trained parameter's gradient gathered whole, on every rank."""
    out = {}
    for key, m in state.trained().items():
        local = dict(m.named_parameters())
        for n, (shape, rule, owner) in par.layouts[key].params.items():
            p = local.get(n)
            if owner is None and p.grad is None:  # unused everywhere (a mask token)
                continue
            out[f"{key}.{n}"] = par.gather(None if p is None else p.grad, rule, owner, shape,
                                           torch.device("cpu"))
    return out


def _sharded_state(par, enc_cfg, pred_cfg, hp, weights, cp_attend=None):
    from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
    from vjepa2_tpu_torch.train import pretrain as tpre
    from vjepa2_tpu_torch.train.state import TrainState

    enc = VisionTransformer(**enc_cfg, cp_attend=cp_attend)
    pred = VisionTransformerPredictor(**pred_cfg, cp_attend=cp_attend)
    enc.load_state_dict(weights[0])
    pred.load_state_dict(weights[1])
    target = par.place(enc, pred)
    return TrainState(0, enc, pred, target, tpre.make_optimizer(hp, enc, pred), par)


def _rows(par, batch, index=None):
    """This rank's rows of the global batch (its data group's share)."""
    g = par.dp_group
    n = 1 if g is None else torch.distributed.get_world_size(g)
    i = 0 if g is None else torch.distributed.get_rank(g)
    b = batch // n
    return slice(i * b, (i + 1) * b)


def _step_on_mesh(axes, enc_cfg, pred_cfg, hp_kw, weights, clips, me, mp, grad_accum=1,
                  pipe_mb=2, keep_state=False, cp=False):
    """The port's pretrain step on ``axes`` (data, fsdp, model, pipe):
    (metrics, gathered gradients, gathered state dict[, the state]); with
    ``cp`` the ``model`` axis rings the attention and ZeRO shards over
    ``(fsdp, model)``."""
    from vjepa2_tpu_torch.core.mesh import MeshConfig, make_mesh, model_group
    from vjepa2_tpu_torch.core.sharding import Parallel
    from vjepa2_tpu_torch.ops.ring_attention import seq_sharded_attention
    from vjepa2_tpu_torch.train import pretrain as tpre

    mesh = make_mesh(MeshConfig(*axes), device_type="cpu")
    par = Parallel(mesh, cp=cp, pipe_microbatches=pipe_mb)
    hp = tpre.PretrainHParams(**hp_kw)
    ring = seq_sharded_attention(model_group(mesh)) if cp else None
    state = _sharded_state(par, enc_cfg, pred_cfg, hp, weights, ring)
    grads = {}

    def keep(opt_step, step):
        grads.update(_full_grads(par, state))
        opt_step(step)

    state.optimizer.step = functools.partial(keep, state.optimizer.step)
    rows = _rows(par, clips.shape[0])
    c, e, p = (torch.from_numpy(clips[rows]), [torch.from_numpy(m[rows]) for m in me],
               [torch.from_numpy(m[rows]) for m in mp])
    if grad_accum > 1:
        b = c.shape[0] // grad_accum
        c = c.reshape(grad_accum, b, *c.shape[1:])
        e, p = [m.reshape(grad_accum, b, -1) for m in e], [m.reshape(grad_accum, b, -1) for m in p]
    metrics = tpre.make_train_step(hp, grad_group=par.dp_group, grad_accum=grad_accum)(
        state, c, e, p)
    out = ({k: float(v) for k, v in metrics.items()}, grads, state.state_dict())
    return out + (state,) if keep_state else out


def _flat_params(sd):
    return {**{f"encoder.{k}": v for k, v in sd["encoder"].items()},
            **{f"predictor.{k}": v for k, v in sd["predictor"].items()}}


def _hold(got, one, jm=None, target_j=None):
    """A sharded step (metrics, grads, gathered sd) against the one-process
    step's (metrics, grads, params, target) and JAX's metrics / target."""
    metrics, g, sd = got[:3]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k], one[0][k], rtol=RTOL, err_msg=k)
        if jm is not None:
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL, err_msg=k)
    _assert_grads(g, one[1])
    if target_j is not None:
        for k, t in sd["target_encoder"].items():
            np.testing.assert_allclose(t.numpy(), target_j[k].numpy(), atol=1e-6, err_msg=k)


def _fsdp_rank(rank, world, weights, clips, me, mp, ckpt_dir):
    from vjepa2_tpu_torch.core.checkpoint import CheckpointManager

    axes = (2, 2, 1, 1)
    step = _step_on_mesh(axes, ENC, PRED, HP, weights, clips, me, mp, keep_state=True)
    accum = _step_on_mesh(axes, ENC, PRED, HP, weights, clips, me, mp, grad_accum=2)[:3]
    state = step[3]
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(1, state)
    fresh = _step_on_mesh(axes, ENC, PRED, HP, weights, clips, me, mp, keep_state=True)[3]
    restored = mgr.restore(fresh).state_dict()
    return step[:3], accum, restored


def test_fsdp_step_matches_jax_accumulates_and_restores_anywhere(tmp_path):
    from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT

    from vjepa2_tpu_torch.core.checkpoint import CheckpointManager
    from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
    from vjepa2_tpu_torch.train import pretrain as tpre
    from vjepa2_tpu_torch.train.state import TrainState

    me, mp = _masks(MASK_CFGS, 4, 64, 8)
    clips = np.random.RandomState(0).rand(8, 4, 64, 64, 3).astype(np.float32)
    weights, jm, jstate = _jax_sharded_step(
        (2, 2, 1, 1), JaxViT(**dict(ENC, use_flash=False)),
        JaxPredictor(**dict(PRED, use_flash=False)), HP, clips, me, mp)
    one = _port_step(0, 1, ENC, PRED, HP, weights, clips, me, mp, slice(None))
    ckpt = tmp_path / "ckpt"
    ranks = spawn(_fsdp_rank, 4, tmp_path, weights, clips, me, mp, str(ckpt))
    target_j = _flax_sd(jstate.target_params)
    for step, accum, restored in ranks:
        _hold(step, one, jm, target_j)
        _hold(accum, one)
    _bit_equal_ranks([_flat_params(r[0][2]) for r in ranks], "parameter")
    # the file (rank 0's gather) restored at fsdp 2 and in one process
    saved = torch.load(ckpt / "1.pt", weights_only=True)
    assert saved["encoder"].keys() == ranks[0][0][2]["encoder"].keys()
    enc, pred = VisionTransformer(**ENC), VisionTransformerPredictor(**PRED)
    hp = tpre.PretrainHParams(**HP)
    plain = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    plain = CheckpointManager(str(ckpt)).restore(plain)
    for what, sd in [("mesh", r[2]) for r in ranks] + [("one process", plain.state_dict())]:
        for key in ("encoder", "predictor", "target_encoder"):
            for k, v in saved[key].items():
                assert torch.equal(sd[key][k], v), f"{what} {key}.{k}"
        assert sd["optimizer"]["param_groups"] == saved["optimizer"]["param_groups"]
        for i, st in saved["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(sd["optimizer"]["state"][i][k], v), f"{what} moment {i} {k}"


# ------------------------------------------------------ routes and remat

def _layer(kind):
    """(block, its input, rope args) for a route: a Block whose attention
    takes the plain, DN (heads of 32), BHND (heads of 80) or fused route, or
    a SwiGLU block on the DN route (hidden 344: fc1 and fc2 cut by rows, fc3
    by columns)."""
    from vjepa2_tpu_torch.models.modules import Block

    heads, dh = {"plain": (4, 32), "dn": (4, 32), "bhnd": (2, 80), "fused": (4, 32),
                 "swiglu": (4, 32)}[kind]
    dim = heads * dh
    blk = Block(dim, heads, use_rope=True, use_flash=kind != "plain", fuse_ln_qkv=kind == "fused",
                fuse_ln_mlp=kind == "fused", use_silu=kind == "swiglu")
    blk.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 24, dim).astype(np.float32))
    return blk, x


def _route_args(blk, n):
    from vjepa2_tpu_torch.models.vision_transformer import rope_tables

    pos = torch.arange(n)
    heads = blk.attn.num_heads
    return rope_tables(pos, blk.attn.head_dim, heads, 2, 3, blk.attn.use_flash) + (None,)


def _run_block(blk, x, saves=None):
    from vjepa2_tpu_torch.models.modules import remat_call

    x = x.clone().requires_grad_()
    out = remat_call(blk, saves, x, *_route_args(blk, x.shape[1]))
    w = torch.from_numpy(np.random.RandomState(3).randn(*out.shape).astype(np.float32))
    return out, x, w


def _routes_rank(rank, world):
    from vjepa2_tpu_torch.core.sharding import Parallel
    from vjepa2_tpu_torch.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu_torch.models.modules import resolve_remat_policy
    from vjepa2_tpu_torch.ops import tensor_parallel as tpm

    par = Parallel(make_mesh(MeshConfig(data=1, model=2), device_type="cpu"))
    out = {}
    for kind in ROUTES:
        blk, x = _layer(kind)
        blk.attn.shard_heads_(par.tp)
        blk.mlp.shard_hidden_(par.tp)
        y, xx, w = _run_block(blk, x)
        (y * w).sum().backward()
        grads = {n: (par.tp.gather(p.grad, *_tp_rule(n, kind)) if _tp_rule(n, kind) else p.grad)
                 for n, p in blk.named_parameters()}
        out[kind] = (y.detach(), xx.grad, grads)
    remat = {}
    for policy in (None, "save_attn_qkv", "full"):
        blk, x = _layer("dn")
        blk.attn.shard_heads_(par.tp)
        blk.mlp.shard_hidden_(par.tp)
        saves = None if policy is None else resolve_remat_policy(policy)
        y, xx, w = _run_block(blk, x, saves)
        before = dict(tpm.CALLS)
        (y * w).sum().backward()
        calls = {k: tpm.CALLS[k] - before[k] for k in before}
        remat[policy] = (calls, xx.grad, {n: p.grad.clone() for n, p in blk.named_parameters()})
    out["remat"] = remat
    return out


def _tp_rule(name, kind):
    from vjepa2_tpu_torch.core.sharding import _SWIGLU_TP_RULES, _TP_RULES

    return (_SWIGLU_TP_RULES if kind == "swiglu" else _TP_RULES).get(name)


ROUTES = ("plain", "dn", "bhnd", "fused", "swiglu")


def test_each_route_under_tensor_parallelism_and_remat(tmp_path):
    ranks = spawn(_routes_rank, 2, tmp_path)
    for kind in ROUTES:
        blk, x = _layer(kind)
        y, xx, w = _run_block(blk, x)
        (y * w).sum().backward()
        for r in ranks:
            got_y, got_dx, got_g = r[kind]
            np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), atol=2e-5, rtol=1e-5,
                                       err_msg=kind)
            np.testing.assert_allclose(got_dx.numpy(), xx.grad.numpy(), atol=2e-5, rtol=1e-4,
                                       err_msg=kind)
            for n, p in blk.named_parameters():
                tol = GRAD_ATOL + 1e-4 * p.grad.abs().max().item()
                np.testing.assert_allclose(got_g[n].numpy(), p.grad.numpy(), atol=tol,
                                           rtol=1e-4, err_msg=f"{kind} {n}")
    for r in ranks:
        remat = r["remat"]
        # the selective policy keeps the forward's reductions (proj, fc2);
        # 'full' reruns proj's, whose sum the backward reads (the recompute
        # stops before fc2's, which it does not); no weight is gathered (the
        # heads divide the group)
        assert remat[None][0] == {"tp_all_reduce": 0, "tp_all_gather": 0}
        assert remat["save_attn_qkv"][0] == {"tp_all_reduce": 0, "tp_all_gather": 0}
        assert remat["full"][0] == {"tp_all_reduce": 1, "tp_all_gather": 0}
        for policy in ("save_attn_qkv", "full"):
            assert torch.equal(remat[policy][1], remat[None][1]), policy
            for n, g in remat[None][2].items():
                assert torch.equal(remat[policy][2][n], g), f"{policy} {n}"


def test_qkv_rows_are_each_ranks_heads_with_the_rope_permutation():
    """`TensorParallel.rows(w, 3)` takes rank r's heads' rows of q, k and v
    (not a contiguous third), and the split-half RoPE permutation of the
    local heads (`qkv_row_perm` at H / R heads) applied to them is the
    whole layer's permutation restricted to those heads."""
    from vjepa2_tpu_torch.models.modules import qkv_row_perm
    from vjepa2_tpu_torch.ops.tensor_parallel import TensorParallel, unshard

    H, Dh, C, R = 4, 8, 16, 2
    w = torch.arange(3 * H * Dh * C, dtype=torch.float32).reshape(3 * H * Dh, C)
    head_perm = np.random.RandomState(0).permutation(Dh)
    full = w[qkv_row_perm(head_perm, H, Dh)]
    shards = []
    for r in range(R):
        tp = TensorParallel.__new__(TensorParallel)
        tp.size, tp.rank = R, r
        local = tp.rows(w, 3)
        heads = range(r * H // R, (r + 1) * H // R)
        want = torch.cat([w[part * H * Dh + h * Dh: part * H * Dh + (h + 1) * Dh]
                          for part in range(3) for h in heads])
        assert torch.equal(local, want)
        assert torch.equal(local[qkv_row_perm(head_perm, H // R, Dh)], tp.rows(full, 3))
        shards.append(local)
    assert torch.equal(unshard(shards, 0, 3), w)


# -------------------------------------------------------------- the CLI

def _cli_pipe_rank(rank, world, store, cfg_path, out_dir):
    from vjepa2_tpu_torch.cli import main as cli
    from vjepa2_tpu_torch.core.config import PretrainConfig
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
    from vjepa2_tpu_torch.train.loop import Pretrainer

    torch.set_num_threads(1)
    flags = ["--num-processes", str(world), "--process-id", str(rank), "--device", "cpu"]
    first = cli.main(["--fname", cfg_path, "--coordinator", f"file://{store}-1", *flags])
    raw = yaml.safe_load(Path(cfg_path).read_text())
    raw["folder"] += "-tp"
    raw["mesh"] = {"data": 2, "fsdp": 2, "model": 2}
    tp_cfg = f"{cfg_path}-tp.yaml"
    if rank == 0:
        Path(tp_cfg).write_text(yaml.safe_dump(raw))
    sharded = cli.main(["--fname", tp_cfg, "--coordinator", f"file://{store}-3", *flags])
    droid = cli.main(["--fname", tp_cfg, "--coordinator", f"file://{store}-4", "--app",
                      "vjepa_droid", *flags])
    distributed.init_distributed(f"file://{store}-2", world, rank, device="cpu")
    raw = yaml.safe_load(Path(cfg_path).read_text())
    raw["meta"]["load_checkpoint"] = True
    trainer = Pretrainer(PretrainConfig.from_dict(raw), device="cpu")
    state = trainer.restore_or_init()
    restored = state.state_dict()
    target, _ = trainer.eval_models(state)
    plain = isinstance(target, VisionTransformer) and target.pipeline is None and all(
        isinstance(b, type(target.blocks[0])) for b in target.blocks)
    distributed.destroy()
    torch.save((first, restored, plain, trainer.layout.parallel.sizes, sharded, droid),
               f"{out_dir}/out{rank}.pt")


def test_smoke_pipeline_config_through_cli_main_on_eight_ranks(tmp_path):
    """JAX's `test_smoke_pipeline_config_end_to_end` (`tests/train/test_pipeline_loop.py:19`)
    on the port: the shipped config's mesh (data 2 x pipe 4, 2 microbatches)
    over 8 processes, 2 steps: finite losses, the same on every rank; the
    checkpoint restored on the mesh and in one process (mesh.pipe 1) bit-equal
    to the file; the online evals get the gathered plain encoder. Then the
    same config at ``mesh {data 2, fsdp 2, model 2}`` through ``cli.main``,
    as a pretraining run and as a DROID run: 2 steps each, finite losses, the
    same on every rank."""
    from vjepa2_tpu_torch.core.config import PretrainConfig
    from vjepa2_tpu_torch.train.loop import Pretrainer

    raw = yaml.safe_load((ROOT / "configs/train/smoke-pipeline.yaml").read_text())
    assert raw["mesh"] == {"data": 2, "fsdp": 1, "model": 1, "pipe": 4, "pipe_microbatches": 2}
    raw["folder"] = str(tmp_path / "run")
    raw["optimization"]["ipe"] = 2
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    outs = _spawn_plain(_cli_pipe_rank, 8, tmp_path, str(tmp_path / "store"), str(cfg))
    saved = torch.load(tmp_path / "run" / "ckpt" / "2.pt", weights_only=True)
    for first, restored, plain, sizes, sharded, droid in outs:
        assert sizes == {"data": 2, "fsdp": 1, "model": 1, "pipe": 4}
        assert first["step"] == 2 and np.isfinite(first["loss"])
        assert first["loss"] == outs[0][0]["loss"]
        for run, i in ((sharded, 4), (droid, 5)):
            assert run["step"] == 2 and np.isfinite(run["loss"])
            assert run["loss"] == outs[0][i]["loss"]
        assert plain
        for key in ("encoder", "predictor", "target_encoder"):
            assert restored[key].keys() == saved[key].keys()
            for k, v in saved[key].items():
                assert torch.equal(restored[key][k], v), f"{key}.{k}"
    raw["mesh"] = {"data": -1, "fsdp": 1, "model": 1, "pipe": 1, "pipe_microbatches": 1}
    raw["meta"]["load_checkpoint"] = True
    one = Pretrainer(PretrainConfig.from_dict(raw), device="cpu").restore_or_init().state_dict()
    for key in ("encoder", "predictor", "target_encoder"):
        for k, v in saved[key].items():
            assert torch.equal(one[key][k], v), f"{key}.{k}"
