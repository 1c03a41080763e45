"""GPipe stages (`core/pipeline.py`), alone and with tensor parallelism and
parameter sharding, and tensor parallelism on the DROID step, against the
JAX package. The in-process transport (`InProcessPipe`, stage after stage in
this process) against JAX's sequential encoder as JAX's
`tests/core/test_pipeline.py:71-120` holds its pipeline: unmasked at M 1, 2
and 4 microbatches, masked, and the gradients. Then one spawn of 8 gloo
ranks (`tests/test_torch_model_parallel.py`'s helpers and tolerances), each
mesh built in turn over the same ranks:

* the pretrain step at ``data 2 x fsdp 2 x model 2`` against JAX's
  `tests/core/test_mesh.py:118-150` on the same mesh (vit_tiny's widths,
  depth cut to 2: its 3 heads do not divide 2, the gathered-weight route;
  the predictor's 2 heads split);
* the DROID step at ``dp 2 x fsdp 2 x tp 2`` against JAX's
  `tests/train/test_droid_multichip.py:42-67` on that mesh (losses and grad
  norm rtol 1e-5, the predictor within 1e-3 relative L2 of JAX's update),
  and its ``grad_accum`` 2 (`:70`) against the same;
* the pipeline at `tests/core/test_pipeline.py`'s widths (64 wide, depth 4,
  2 heads, batch 8, 2 microbatches): ``pipe 4 x data 2`` (the step `:122`,
  ``grad_accum`` 2 `:176`, multi-fpc `:333`, and the process transport's
  encoder output and gradients bit-equal to the in-process transport's),
  ``pipe 2 x data 2 x model 2`` (`:229`) and ``pipe 2 x model 2 x fsdp 2``
  (`:282`), and context parallelism at ``data 4 x model 2`` with ZeRO over
  the ring (JAX's ``cp=True`` rule), each against JAX's unsharded step
  (loss, grad norm, EMA target) and the port's one-process step (the
  gradients gathered whole).
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_data_parallel import RTOL, _flax_sd, _jax_sharded_step, _masks, _port_step
from test_torch_distributed import spawn
from test_torch_model_parallel import (MASK_CFGS, _bit_equal_ranks, _flat_params, _hold,
                                       _near_update, _rows, _sharded_state, _step_on_mesh)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def _jax_encoder():
    """JAX's sequential encoder at the pipeline widths (`tests/core/test_pipeline.py:37`),
    its weights as the port's, and the clips and masks of its tests."""
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT

    enc = JaxViT(**dict(P_ENC, use_flash=False, dtype=jnp.float32))
    clips = np.random.RandomState(0).rand(PB, PT, PS, PS, 3).astype(np.float32)
    variables = jax.jit(lambda c: enc.init(jax.random.PRNGKey(0), c))(jnp.asarray(clips))
    n_tok = (PT // 2) * (PS // 16) ** 2
    rs = np.random.RandomState(1)
    masks = np.stack([np.sort(rs.choice(n_tok, n_tok // 2, replace=False))
                      for _ in range(PB)]).astype(np.int64)
    apply = jax.jit(lambda v, c: enc.apply(v, c))
    out = np.asarray(apply(variables, clips))
    out_masked = np.asarray(jax.jit(lambda v, c, m: enc.apply(v, c, [m]))(
        variables, clips, jnp.asarray(masks, jnp.int32)))
    grads = jax.jit(jax.grad(lambda v, c: (enc.apply(v, c) ** 2).mean()))(variables, clips)
    return _flax_sd(variables), clips, masks, out, out_masked, _flax_sd(grads)


def _in_process_encoder(n_microbatch):
    from vjepa2_tpu_torch.core.pipeline import InProcessPipe, Pipeline
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

    enc = VisionTransformer(**P_ENC)
    enc.load_state_dict(_jax_encoder()[0])
    enc.pipeline_(Pipeline(InProcessPipe(4), n_microbatch, P_ENC["depth"]))
    return enc


@pytest.mark.parametrize("n_microbatch", [1, 2, 4])
def test_in_process_pipeline_encode_matches_jax_unmasked(n_microbatch):
    _, clips, _, want, _, _ = _jax_encoder()
    with torch.no_grad():
        got = _in_process_encoder(n_microbatch)(torch.from_numpy(clips))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_in_process_pipeline_encode_matches_jax_masked():
    _, clips, masks, _, want, _ = _jax_encoder()
    with torch.no_grad():
        got = _in_process_encoder(2)(torch.from_numpy(clips), [torch.from_numpy(masks)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_in_process_pipeline_gradients_match_jax():
    """The gradients of mean(out^2) through the schedule, every stage under
    full remat (JAX's `jax.checkpoint` around each stage), against JAX's
    sequential encoder's at `tests/core/test_pipeline.py:100`'s tolerance."""
    _, clips, _, _, _, want = _jax_encoder()
    enc = _in_process_encoder(2)
    enc.remat = frozenset()
    (enc(torch.from_numpy(clips)) ** 2).mean().backward()
    for n, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=n)


def test_in_process_pipeline_with_swiglu_matches_jax():
    """A SwiGLU encoder in 4 stages of 2 microbatches (the stages' blocks are
    the encoder's, built with its ``use_silu`` / ``wide_silu``, as JAX's
    stage `Block`, `core/pipeline.py:223-224`): the masked forward and the
    gradients of mean(out^2) under full remat against JAX's sequential
    SwiGLU encoder, at the tolerances of the tests above."""
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
    from vjepa2_tpu_torch.core.pipeline import InProcessPipe, Pipeline
    from vjepa2_tpu_torch.models.modules import SwiGLUFFN
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

    cfg = dict(P_ENC, use_silu=True)
    jenc = JaxViT(**dict(cfg, use_flash=False, dtype=jnp.float32))
    _, clips, masks, _, _, _ = _jax_encoder()
    variables = jax.jit(lambda c: jenc.init(jax.random.PRNGKey(0), c))(jnp.asarray(clips))
    want = jax.jit(lambda v, c, m: jenc.apply(v, c, [m]))(variables, clips,
                                                          jnp.asarray(masks, jnp.int32))
    grads = jax.jit(jax.grad(lambda v, c: (jenc.apply(v, c) ** 2).mean()))(variables, clips)
    enc = VisionTransformer(**cfg)
    enc.load_state_dict(_flax_sd(variables))
    enc.pipeline_(Pipeline(InProcessPipe(4), 2, cfg["depth"]))
    assert all(isinstance(b.mlp, SwiGLUFFN) for b in enc.blocks)
    with torch.no_grad():
        got = enc(torch.from_numpy(clips), [torch.from_numpy(masks)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    enc.remat = frozenset()
    (enc(torch.from_numpy(clips)) ** 2).mean().backward()
    want = _flax_sd(grads)
    for n, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=n)


# the pipeline widths of `tests/core/test_pipeline.py` (and test_mesh's TP step's predictor)
PS, PT, PB = 32, 4, 8
P_ENC = dict(img_size=(PS, PS), patch_size=16, num_frames=PT, tubelet_size=2, embed_dim=64,
             depth=4, num_heads=2, use_rope=True, uniform_power=True, use_flash=True)
P_PRED = dict(img_size=(PS, PS), patch_size=16, num_frames=PT, tubelet_size=2, embed_dim=64,
              predictor_embed_dim=64, depth=2, num_heads=2, use_mask_tokens=True,
              num_mask_tokens=2, use_rope=True, uniform_power=True, use_flash=True)
P_HP = dict(epochs=1, ipe=10, warmup_epochs=0)
# `tests/core/test_mesh.py:118-150`: vit_tiny's widths (3 heads, depth cut to 2) and a
# 64-wide predictor of 2 heads
T_ENC = dict(img_size=(PS, PS), patch_size=16, num_frames=PT, tubelet_size=2, embed_dim=192,
             depth=2, num_heads=3, use_rope=True, uniform_power=True, use_flash=True)
T_PRED = dict(img_size=(PS, PS), patch_size=16, num_frames=PT, tubelet_size=2, embed_dim=192,
              predictor_embed_dim=64, depth=1, num_heads=2, use_mask_tokens=True,
              num_mask_tokens=1, use_rope=True, uniform_power=True, use_flash=True)
ONE_MASK = MASK_CFGS[1:]


def _multifpc_on_mesh(axes, weights, clips_tup, me_tup, mp_tup):
    from vjepa2_tpu_torch.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu_torch.core.sharding import Parallel
    from vjepa2_tpu_torch.train import pretrain as tpre

    par = Parallel(make_mesh(MeshConfig(*axes), device_type="cpu"), pipe_microbatches=2)
    hp = tpre.PretrainHParams(**P_HP)
    state = _sharded_state(par, P_ENC, P_PRED, hp, weights)
    rows = _rows(par, PB)
    metrics = tpre.make_multifpc_train_step(hp, 1, grad_group=par.dp_group)(
        state, tuple(torch.from_numpy(c[rows]) for c in clips_tup),
        tuple([torch.from_numpy(m[rows]) for m in me] for me in me_tup),
        tuple([torch.from_numpy(m[rows]) for m in mp] for mp in mp_tup))
    return {k: float(v) for k, v in metrics.items()}, state.state_dict()


def _pipe_encode_bits(axes, weights, clips, masks):
    """The pipelined encoder (process transport): the masked forward and the
    gradients of mean(out^2), gathered."""
    from vjepa2_tpu_torch.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu_torch.core.sharding import Parallel
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer

    par = Parallel(make_mesh(MeshConfig(*axes), device_type="cpu"), pipe_microbatches=2)
    enc = VisionTransformer(**P_ENC)
    enc.load_state_dict(weights[0])
    par.split_("encoder", enc, "blocks", pipelined=True)
    par.shard_("encoder", enc, "blocks")
    out = enc(torch.from_numpy(clips), [torch.from_numpy(masks)])
    (out.square().mean()).backward()
    par.finish_gradients([(f"encoder.{n}", p) for n, p in enc.named_parameters()])
    lay = par.layouts["encoder"]
    local = dict(enc.named_parameters())
    grads = {n: par.gather(None if local.get(n) is None else local[n].grad, rule, owner, shape,
                           torch.device("cpu"))
             for n, (shape, rule, owner) in lay.params.items()}
    return out.detach(), grads


def _droid_on_mesh(axes, weights, batch, grad_accum=1):
    from vjepa2_tpu_torch.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu_torch.core.sharding import Parallel
    from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
    from vjepa2_tpu_torch.models.vision_transformer import vit_tiny
    from vjepa2_tpu_torch.train import droid as tdroid
    from test_torch_data_parallel import D_ENC, D_HP, D_PRED

    par = Parallel(make_mesh(MeshConfig(*axes), device_type="cpu"))
    enc = vit_tiny(**D_ENC, use_flash=True).requires_grad_(False)
    pred = vit_ac_predictor(**D_PRED, use_flash=True)
    enc.load_state_dict(weights[0])
    pred.load_state_dict(weights[1])
    tpf = tdroid.tokens_per_frame(enc)
    par.place_droid(enc, pred)
    hp = tdroid.DroidHParams(**D_HP)
    state = tdroid.DroidState(0, pred, enc, tdroid.make_droid_optimizer(hp, pred), par)
    rows = _rows(par, batch[0].shape[0])
    xs = [torch.from_numpy(x[rows]) for x in batch]
    if grad_accum > 1:
        xs = [x.reshape(grad_accum, x.shape[0] // grad_accum, *x.shape[1:]) for x in xs]
    step = tdroid.make_droid_train_step(hp, tpf, grad_group=par.dp_group, grad_accum=grad_accum)
    metrics = step(state, *xs)
    return {k: float(v) for k, v in metrics.items()}, state.state_dict()["predictor"]


def _eight_rank(rank, world, tp_args, droid_args, pp_args):
    out = {}
    out["tp"] = _step_on_mesh((2, 2, 2, 1), T_ENC, T_PRED, P_HP, *tp_args)
    out["droid"] = _droid_on_mesh((2, 2, 2, 1), *droid_args)
    out["droid_accum"] = _droid_on_mesh((2, 2, 2, 1), *droid_args, grad_accum=2)
    weights, clips, me, mp, fpc_args, enc_clips, enc_masks = pp_args
    out["pp"] = _step_on_mesh((2, 1, 1, 4), P_ENC, P_PRED, P_HP, weights, clips, me, mp)
    out["pp_accum"] = _step_on_mesh((2, 1, 1, 4), P_ENC, P_PRED, P_HP, weights, clips, me, mp,
                                    grad_accum=2, pipe_mb=2)
    out["pp_tp"] = _step_on_mesh((2, 1, 2, 2), P_ENC, P_PRED, P_HP, weights, clips, me, mp)
    out["pp_all"] = _step_on_mesh((1, 2, 2, 2), P_ENC, P_PRED, P_HP, weights, clips, me, mp)
    out["pp_multifpc"] = _multifpc_on_mesh((2, 1, 1, 4), weights, *fpc_args)
    out["pp_encode"] = _pipe_encode_bits((2, 1, 1, 4), weights, enc_clips, enc_masks)
    out["cp_zero"] = _step_on_mesh((4, 1, 2, 1), P_ENC, P_PRED, P_HP, weights, clips, me, mp,
                                   cp=True)
    return out


def _jax_step(enc_cfg, pred_cfg, clips, me, mp, mesh_axes=None):
    """JAX's pretrain step, unsharded or on ``mesh_axes``, from JAX's init."""
    import jax

    from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
    from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT

    jenc = JaxViT(**dict(enc_cfg, use_flash=False))
    jpred = JaxPredictor(**dict(pred_cfg, use_flash=False))
    mesh = mesh_axes or jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1),
                                          ("pipe", "data", "fsdp", "model"))
    return _jax_sharded_step(mesh, jenc, jpred, P_HP, clips, me, mp)


def _one_multifpc(weights, clips_tup, me_tup, mp_tup):
    from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
    from vjepa2_tpu_torch.train import pretrain as tpre
    from vjepa2_tpu_torch.train.state import TrainState

    enc, pred = VisionTransformer(**P_ENC), VisionTransformerPredictor(**P_PRED)
    enc.load_state_dict(weights[0])
    pred.load_state_dict(weights[1])
    hp = tpre.PretrainHParams(**P_HP)
    state = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    metrics = tpre.make_multifpc_train_step(hp, 1)(
        state, tuple(map(torch.from_numpy, clips_tup)),
        tuple([torch.from_numpy(m) for m in me] for me in me_tup),
        tuple([torch.from_numpy(m) for m in mp] for mp in mp_tup))
    return ({k: float(v) for k, v in metrics.items()},
            {**{f"encoder.{k}": v for k, v in enc.state_dict().items()},
             **{f"predictor.{k}": v for k, v in pred.state_dict().items()}})


def test_tensor_parallel_droid_and_pipelines_on_eight_ranks(tmp_path):
    """The 8-rank checks of the module docstring, one spawn."""
    from vjepa2_tpu_torch.core.pipeline import InProcessPipe, Pipeline
    from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
    from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
    from test_torch_data_parallel import _droid_batch

    # TP: `tests/core/test_mesh.py:118-150` (batch 4), JAX on data 2 x fsdp 2 x model 2
    me_t, mp_t = _masks(ONE_MASK, PT, PS, 4)
    clips_t = np.random.RandomState(0).rand(4, PT, PS, PS, 3).astype(np.float32)
    w_t, jm_t, js_t = _jax_step(T_ENC, T_PRED, clips_t, me_t, mp_t, (2, 2, 2, 1))
    one_t = _port_step(0, 1, T_ENC, T_PRED, P_HP, w_t, clips_t, me_t, mp_t, slice(None))
    # DROID: JAX's dp 2 x fsdp 2 x tp 2 step (`test_droid_multichip.py:42-67`)
    droid_j = _jax_droid((2, 2, 2, 1))
    # the pipeline: `tests/core/test_pipeline.py`'s widths, JAX's unsharded step
    me_p, mp_p = _masks(ONE_MASK, PT, PS, PB)
    clips_p = np.random.RandomState(2).rand(PB, PT, PS, PS, 3).astype(np.float32)
    w_p, jm_p, js_p = _jax_step(P_ENC, P_PRED, clips_p, me_p, mp_p)
    one_p = _port_step(0, 1, P_ENC, P_PRED, P_HP, w_p, clips_p, me_p, mp_p, slice(None))
    coll = MaskCollator(ONE_MASK, dataset_fpcs=[2, PT], crop_size=(PS, PS))
    coll.step()
    (me2, mp2), (me4, mp4) = coll(2, PB), coll(PT, PB)
    rs = np.random.RandomState(4)
    fpc_args = ((rs.rand(PB, 2, PS, PS, 3).astype(np.float32),
                 rs.rand(PB, PT, PS, PS, 3).astype(np.float32)), (me2, me4), (mp2, mp4))
    n_tok = (PT // 2) * (PS // 16) ** 2
    enc_masks = np.stack([np.sort(rs.choice(n_tok, n_tok // 2, replace=False))
                          for _ in range(PB)])
    enc_clips = rs.rand(PB, PT, PS, PS, 3).astype(np.float32)

    ranks = spawn(_eight_rank, 8, tmp_path, (w_t, clips_t, me_t, mp_t),
                  (droid_j[0], _droid_batch()),
                  (w_p, clips_p, me_p, mp_p, fpc_args, enc_clips, enc_masks))

    target_t = _flax_sd(js_t.target_params)
    target_p = _flax_sd(js_p.target_params)
    for r in ranks:
        _hold(r["tp"], one_t, jm_t, target_t)
        for case in ("pp", "pp_tp", "pp_all"):
            _hold(r[case], one_p, jm_p, target_p)
        _hold(r["pp_accum"], one_p, jm_p)
        jd, before, after = droid_j[1:]
        for case in ("droid", "droid_accum"):
            metrics, pred_sd = r[case]
            for k in ("loss", "loss_teacher_forcing", "loss_rollout", "grad_norm"):
                np.testing.assert_allclose(metrics[k], jd[k], rtol=RTOL, err_msg=k)
            _near_update(pred_sd, after, before, case)
        _hold(r["cp_zero"], one_p, jm_p, target_p)
    for case in ("tp", "pp", "pp_tp", "pp_all", "pp_accum", "cp_zero"):
        _bit_equal_ranks([_flat_params(r[case][2]) for r in ranks], case)
    _bit_equal_ranks([r["droid"][1] for r in ranks], "droid")
    # multi-fpc: the one-process multi-fpc step (held to JAX's in test_torch_loop.py)
    m_one, p_one = _one_multifpc(w_p, *fpc_args)
    before = {**{f"encoder.{k}": v for k, v in w_p[0].items()},
              **{f"predictor.{k}": v for k, v in w_p[1].items()}}
    for r in ranks:
        metrics, sd = r["pp_multifpc"]
        np.testing.assert_allclose(metrics["loss"], m_one["loss"], rtol=RTOL)
        np.testing.assert_allclose(metrics["grad_norm"], m_one["grad_norm"], rtol=RTOL)
        _near_update(_flat_params(sd), p_one, before, "multifpc")
    # the process transport gives the in-process transport's bits
    enc = VisionTransformer(**P_ENC)
    enc.load_state_dict(w_p[0])
    enc.pipeline_(Pipeline(InProcessPipe(4), 2, 4))
    out = enc(torch.from_numpy(enc_clips), [torch.from_numpy(enc_masks)])
    out.square().mean().backward()
    for r in ranks:
        got_out, got_grads = r["pp_encode"]
        assert torch.equal(got_out, out.detach())
        for n, p in enc.named_parameters():
            assert torch.equal(got_grads[n], p.grad), n


def _jax_droid(axes):
    """JAX's DROID step on ``axes``: (the initial weights as the port's,
    JAX's metrics, the predictor before and after)."""
    import jax
    import jax.numpy as jnp

    from vjepa2_tpu.core.mesh import MeshConfig, make_mesh
    from vjepa2_tpu.models.ac_predictor import vit_ac_predictor as jax_ac
    from vjepa2_tpu.models.vision_transformer import vit_tiny as jax_tiny
    from vjepa2_tpu.train import droid as jdroid
    from vjepa2_tpu.train.pretrain import shard_state
    from vjepa2_tpu.train.state import TrainState as JaxState
    from test_torch_data_parallel import D_B, D_ENC, D_HP, D_PRED, D_S, D_T, _droid_batch

    encoder = jax_tiny(**D_ENC)
    predictor = jax_ac(**D_PRED, num_frames=2 * D_T, tubelet_size=2)
    hp = jdroid.DroidHParams(**D_HP)
    params, enc_params, tpf = jdroid.init_droid_params(encoder, predictor, 0,
                                                       (D_B, D_T, D_S, D_S, 3))
    tx = jdroid.make_droid_optimizer(hp, params_like=params)
    state = JaxState(step=jnp.zeros([], jnp.int32), params=params, target_params=enc_params,
                     opt_state=tx.init(params))
    mesh = make_mesh(MeshConfig(*axes[:3]), devices=jax.devices()[:int(np.prod(axes))])
    step = jdroid.jit_droid_train_step(
        jdroid.make_droid_train_step(encoder, predictor, tx, hp, tpf), mesh)
    weights = (_flax_sd(enc_params), _flax_sd(params["predictor"]))
    new, jm = step(shard_state(state, mesh), *_droid_batch(), None)
    jm = {k: float(v) for k, v in jax.block_until_ready(jm).items()}
    return weights, jm, weights[1], _flax_sd(new.params["predictor"])
