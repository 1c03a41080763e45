"""The port's SwiGLU MLP (``use_silu``) against the JAX package: `SwiGLUFFN`,
a SwiGLU `Block` on the DN route, its remat residuals, one pretrain step of
SwiGLU models against JAX's `make_train_step` (unfused, and with the qkv
fusion, which leaves the SwiGLU MLP unfused as JAX's gate does), the
converter on SwiGLU parameters, and the loops building SwiGLU models from
``model.use_silu`` (JAX's loops drop it: ROADMAP queue C).

Sizes: width 64 (192 in the step), hidden 4x, ``wide_silu`` on (2/3 of the
hidden width rounded up to 8: 256 -> 176) and off; weights cross with
`hub.converter.state_dict_from_flax`, inputs from numpy with a seed. JAX's
flash routes run in interpret mode (`pltpu.force_tpu_interpret_mode()`) or
through their plain references, as `test_torch_fused_step.py` runs them.

Tolerance: fp32 throughout: outputs atol 2e-5, rtol 1e-4; the step's loss
and grad norm rtol 1e-5, gradients atol 1e-6 + 1e-4 max|leaf|, rtol 1e-4, the
EMA target atol 1e-6 (`test_torch_pretrain_step.py` gives the reasons).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils._python_dispatch import TorchDispatchMode

from vjepa2_tpu.models import modules as jm
from vjepa2_tpu.models.predictor import VisionTransformerPredictor as JaxPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.ops import flash_attention as jfa
from vjepa2_tpu.ops.masking import apply_mask as jax_apply_mask
from vjepa2_tpu.ops.rope import build_rope_cache as jax_rope_cache
from vjepa2_tpu.train import pretrain as jpre
from vjepa2_tpu.train.state import TrainState as JaxState
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.models import modules as tm
from vjepa2_tpu_torch.models.predictor import VisionTransformerPredictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache
from vjepa2_tpu_torch.train import pretrain as tpre
from vjepa2_tpu_torch.train.state import TrainState

ATOL, RTOL = 2e-5, 1e-4
B, N, DIM = 2, 32, 64


@pytest.fixture
def jax_fusions():
    """Sets JAX's LN fusions for one test (`set_ln_fusions`), restored after."""
    saved = (jm.FUSE_LN_QKV, jm.FUSE_LN_MLP)
    try:
        yield jm.set_ln_fusions
    finally:
        jm.FUSE_LN_QKV, jm.FUSE_LN_MLP = saved


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("hidden,wide,want", [(4096, True, 2736), (1536, True, 1024),
                                               (4096, False, 4096), (256, True, 176)])
def test_swiglu_hidden_width(hidden, wide, want):
    """ViT-L's 4096 -> 2736 and the predictor's 1536 -> 1024 with wide_silu."""
    assert tm.swiglu_hidden(hidden, wide) == want
    assert tm.SwiGLUFFN(8, hidden, wide_silu=wide, device="meta").fc1.out_features == want


@pytest.mark.parametrize("wide", [True, False])
def test_swiglu_ffn_and_grads_match_flax(wide):
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, DIM).astype(np.float32)
    cot = rng.randn(B, N, DIM).astype(np.float32)
    jffn = jm.SwiGLUFFN(hidden_dim=4 * DIM, wide_silu=wide, out_init_scale=0.5)
    params = jax.jit(jffn.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    out_j = jax.jit(jffn.apply)(params, jnp.asarray(x))
    g_p, g_x = jax.jit(jax.grad(lambda p, a: jnp.sum(jffn.apply(p, a) * cot), argnums=(0, 1)))(
        params, jnp.asarray(x))

    ffn = tm.SwiGLUFFN(DIM, 4 * DIM, wide_silu=wide)
    ffn.load_state_dict(state_dict_from_flax(params))  # strict: fc1, fc2 and fc3
    xt = torch.tensor(x, requires_grad=True)
    out = ffn(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, out_j)
    _close(xt.grad, g_x)
    want = state_dict_from_flax(g_p)
    for key, p in ffn.named_parameters():
        _close(p.grad, want[key], key)


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("fuse_mlp", [False, True])
def test_swiglu_block_matches_flax(wide, fuse_mlp, jax_fusions):
    """A SwiGLU block on the DN route (RoPE, the stack pad's kv_valid), JAX's
    B1/B2 in interpret mode; with the MLP fusion asked for on both sides the
    SwiGLU MLP stays unfused, as JAX chooses it first."""
    jax_fusions("mlp" if fuse_mlp else "")
    heads, kv_valid = 1, N - 3
    rng = np.random.RandomState(1)
    x = rng.randn(B, N, DIM).astype(np.float32)
    cot = rng.randn(B, N, DIM).astype(np.float32)
    cot[:, kv_valid:] = 0.0  # pad rows are the model's to slice off
    pos = np.arange(N)
    exp_t, perm = expand_rope_cache(build_rope_cache(torch.from_numpy(pos), DIM, 4, 4), DIM)
    exp_j, perm_j = jfa.expand_rope_cache(jax_rope_cache(jnp.asarray(pos), DIM, 4, 4), DIM)
    jblk = jm.Block(dim=DIM, num_heads=heads, use_rope=True, use_flash=True, use_silu=True,
                    wide_silu=wide, head_perm=tuple(int(i) for i in perm_j),
                    kv_valid=kv_valid, layer_id=2)
    twin = jm.Block(dim=DIM, num_heads=heads, use_silu=True, wide_silu=wide, layer_id=2)
    params = jax.jit(lambda a: twin.init(jax.random.PRNGKey(0), a))(jnp.asarray(x))

    def f(p, a):
        return jblk.apply(p, a, rope_expanded=exp_j)

    with pltpu.force_tpu_interpret_mode():
        out_j = jax.jit(f)(params, jnp.asarray(x))
        g_p, g_x = jax.jit(jax.grad(lambda p, a: jnp.sum(f(p, a) * cot), argnums=(0, 1)))(
            params, jnp.asarray(x))

    blk = tm.Block(DIM, heads, use_rope=True, use_flash=True, layer_id=2, use_silu=True,
                   wide_silu=wide, fuse_ln_mlp=fuse_mlp)
    assert isinstance(blk.mlp, tm.SwiGLUFFN) and not blk.fuse_ln_mlp
    blk.load_state_dict(state_dict_from_flax(params))
    xt = torch.tensor(x, requires_grad=True)
    out = blk(xt, rope_expanded=exp_t, qkv_perm=tm.qkv_row_perm(perm, heads, DIM),
              kv_valid=kv_valid)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out[:, :kv_valid], np.asarray(out_j)[:, :kv_valid])
    _close(xt.grad, g_x)
    want = state_dict_from_flax(g_p)
    for key, p in blk.named_parameters():
        _close(p.grad, want[key], key)


class _InputProducts(TorchDispatchMode):
    """Counts, while active, the GEMMs of fc1 and fc2 (``addmm`` on the
    transposed weight [C, hidden])."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.n = tuple(shape), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.addmm.default and tuple(args[2].shape) == self.shape:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [("full", 2), ("save_attn_qkv_h", 0)])
def test_swiglu_remat_keeps_both_input_products(policy, recomputed):
    """Under 'save_attn_qkv_h' both fc1's and fc2's outputs are kept (JAX
    `modules.py:286-289`), so the backward recomputes neither product; a full
    remat recomputes both. Either way the output and every gradient are
    bit-equal to no remat."""
    ffn = tm.SwiGLUFFN(DIM, 4 * DIM)
    ffn.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(2).randn(B, N, DIM).astype(np.float32))
    results = []
    for saves in (None, tm.resolve_remat_policy(policy)):
        ffn.zero_grad(set_to_none=True)
        xt = x.clone().requires_grad_()
        out = tm.remat_call(ffn, saves, xt)
        with _InputProducts(ffn.fc1.weight.t().shape) as counter:
            out.sum().backward()
        results.append((out.detach(), xt.grad, [p.grad for p in ffn.parameters()]))
    assert counter.n == recomputed
    (o0, x0, g0), (o1, x1, g1) = results
    assert torch.equal(o0, o1) and torch.equal(x0, x1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


S, T4 = 64, 4
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T4, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, uniform_power=True, use_rope=True, use_flash=True,
           use_silu=True)
PRED = dict(img_size=(S, S), patch_size=16, num_frames=T4, tubelet_size=2, embed_dim=192,
            predictor_embed_dim=64, depth=2, num_heads=2, uniform_power=True, use_rope=True,
            use_flash=True, use_mask_tokens=True, num_mask_tokens=2, zero_init_mask_tokens=False,
            use_silu=True)
MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]
HP = dict(ipe=100, epochs=10, warmup_epochs=1)


def _flat(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("fuse_qkv", [False, True], ids=["unfused", "qkv"])
def test_swiglu_train_step_matches_jax(fuse_qkv, jax_fusions):
    """One step of SwiGLU models: JAX's `make_train_step` (XLA attention
    unfused; with its qkv fusion its flash route, through the plain
    references at width 192) against the port's flash routes on the CPU."""
    jax_fusions("qkv" if fuse_qkv else "")
    coll = MaskCollator(MASK_CFGS, dataset_fpcs=[T4], crop_size=(S, S))
    coll.step()
    masks_enc, masks_pred = coll(T4, B)
    clips = np.random.RandomState(0).rand(B, T4, S, S, 3).astype(np.float32)
    jclips = jnp.asarray(clips)
    jme, jmp = tuple(map(jnp.asarray, masks_enc)), tuple(map(jnp.asarray, masks_pred))
    jenc = JaxViT(**dict(ENC, use_flash=fuse_qkv))
    jpred = JaxPredictor(**dict(PRED, use_flash=fuse_qkv))
    hp_j = jpre.PretrainHParams(**HP)
    enc_vars = jax.jit(lambda k, c, m: jenc.init(k, c, [m]))(jax.random.PRNGKey(0), jclips,
                                                             jme[0])
    z0 = jax.jit(lambda v, c, m: jenc.apply(v, c, [m]))(enc_vars, jclips, jme[0])
    pred_vars = jax.jit(lambda k, z, a, b: jpred.init(k, z, a, b, 0))(
        jax.random.PRNGKey(1), z0, jme[0], jmp[0])
    params = {"encoder": enc_vars["params"], "predictor": pred_vars["params"]}
    target = jax.tree_util.tree_map(jnp.copy, enc_vars["params"])

    def loss_fn(params, target):  # `make_train_step:207-230`, from the package's pieces
        h = jenc.apply({"params": target}, jclips).astype(jnp.float32)
        h = (h - h.mean(-1, keepdims=True)) / jnp.sqrt(h.var(-1, keepdims=True) + 1e-6)
        h_list = [jax_apply_mask(h, mp) for mp in jmp]
        z_list = [jpred.apply({"params": params["predictor"]},
                              jenc.apply({"params": params["encoder"]}, jclips, [me]),
                              me, mp, i)
                  for i, (me, mp) in enumerate(zip(jme, jmp))]
        return jpre.jepa_loss(z_list, h_list, hp_j.loss_exp)

    grads_j = jax.jit(jax.grad(loss_fn))(params, target)
    tx = jpre.make_optimizer(hp_j)
    state_j, metrics_j = jax.jit(jpre.make_train_step(jenc, jpred, tx, hp_j))(
        JaxState.create(params, target, tx), jclips, jme, jmp)

    fused = dict(fuse_ln_qkv=fuse_qkv, fuse_ln_mlp=fuse_qkv)  # mlp: no effect on SwiGLU
    enc, pred = VisionTransformer(**ENC, **fused), VisionTransformerPredictor(**PRED, **fused)
    assert all(isinstance(b.mlp, tm.SwiGLUFFN) for b in [*enc.blocks, *pred.predictor_blocks])
    enc.load_state_dict(state_dict_from_flax(enc_vars))
    pred.load_state_dict(state_dict_from_flax(pred_vars))
    hp = tpre.PretrainHParams(**HP)
    state = TrainState.create(enc, pred, tpre.make_optimizer(hp, enc, pred))
    grads = {}

    def keep_grads(opt_step, step):  # read the gradients the update is about to use
        for prefix, m in (("encoder", enc), ("predictor", pred)):
            grads.update({f"{prefix}.{k}": p.grad.clone() for k, p in m.named_parameters()})
        opt_step(step)

    state.optimizer.step = functools.partial(keep_grads, state.optimizer.step)
    metrics = tpre.make_train_step(hp)(state, torch.from_numpy(clips),
                                       [torch.from_numpy(m) for m in masks_enc],
                                       [torch.from_numpy(m) for m in masks_pred])
    np.testing.assert_allclose(metrics["loss"].item(), float(metrics_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(metrics_j["grad_norm"]),
                               rtol=1e-5)
    want = {f"encoder.{k}": v for k, v in _flat(state_dict_from_flax(grads_j["encoder"])).items()}
    want.update({f"predictor.{k}": v
                 for k, v in _flat(state_dict_from_flax(grads_j["predictor"])).items()})
    assert sorted(grads) == sorted(want)
    assert any(k.endswith("mlp.fc3.weight") for k in grads)
    for key, g in grads.items():
        tol = 1e-4 * np.abs(want[key]).max()
        np.testing.assert_allclose(g.numpy(), want[key], atol=1e-6 + tol, rtol=1e-4,
                                   err_msg=key)
    target_j = _flat(state_dict_from_flax(state_j.target_params))
    for key, t in state.target_encoder.state_dict().items():
        np.testing.assert_allclose(t.numpy(), target_j[key], atol=1e-6, err_msg=key)


def test_build_models_passes_use_silu_to_both():
    """`build_models(use_silu=True)` builds SwiGLU blocks in both models, as
    JAX's (`pretrain.py:67-68,92-93,111-112`), and the widths follow
    ``wide_silu``."""
    for wide, hidden in ((True, 176), (False, 256)):
        enc, pred = tpre.build_models("vit_tiny", crop_size=32, num_frames=4, pred_depth=1,
                                      pred_embed_dim=64, pred_num_heads=2, use_silu=True,
                                      wide_silu=wide, device="cpu", dtype=torch.float32)
        assert all(isinstance(b.mlp, tm.SwiGLUFFN) for b in [*enc.blocks,
                                                             *pred.predictor_blocks])
        assert pred.predictor_blocks[0].mlp.fc1.out_features == hidden
    enc, _ = tpre.build_models("vit_tiny", crop_size=32, num_frames=4, pred_depth=1,
                               pred_embed_dim=64, pred_num_heads=2, device="cpu",
                               dtype=torch.float32)
    assert isinstance(enc.blocks[0].mlp, tm.Mlp)


def _raw(folder, overrides) -> dict:
    import yaml

    import chip_smoke

    raw = yaml.safe_load(open("configs/train/smoke-tiny.yaml").read())
    return chip_smoke.overridden(raw, {"folder": str(folder), "model.use_silu": True,
                                       "model.wide_silu": False, **overrides})


def test_loops_pass_use_silu_where_jax_drops_it(tmp_path):
    """ROADMAP queue C, "JAX's loops drop ``model.use_silu``": a config asking
    for SwiGLU trains GELU MLPs in JAX's `Pretrainer` (`train/loop.py:133-151`
    passes neither option to `build_models`) and in its `DroidTrainer`
    (`droid_loop.py:72-98`); the port's `Pretrainer` and `DroidTrainer`
    build SwiGLU blocks in both models, hidden 4x with ``wide_silu`` off."""
    from vjepa2_tpu.core.config import PretrainConfig as JaxConfig
    from vjepa2_tpu.train import droid_loop as jdroid_loop
    from vjepa2_tpu.train import loop as jloop
    from vjepa2_tpu_torch.core.config import PretrainConfig
    from vjepa2_tpu_torch.train import droid_loop, loop

    def swiglu(blocks):
        return all(isinstance(b.mlp, tm.SwiGLUFFN)
                   and b.mlp.fc1.out_features == 4 * b.norm1.weight.shape[0] for b in blocks)

    raw = _raw(tmp_path / "pre", {})
    trainer = loop.Pretrainer(PretrainConfig.from_dict(raw), device="cpu")
    assert swiglu(trainer.encoder.blocks) and swiglu(trainer.predictor.predictor_blocks)
    jtrainer = jloop.Pretrainer(JaxConfig.from_dict(raw), synthetic_data=True)
    assert not jtrainer.encoder.use_silu and not jtrainer.predictor.use_silu

    raw = _raw(tmp_path / "droid", {"app": "vjepa_droid", "data.batch_size": 2,
                                     "data.crop_size": 32, "mesh.data": 1})
    trainer = droid_loop.DroidTrainer(PretrainConfig.from_dict(raw), device="cpu")
    assert swiglu(trainer.target_encoder.blocks) and swiglu(trainer.predictor.predictor_blocks)
    jtrainer = jdroid_loop.DroidTrainer(JaxConfig.from_dict(raw))
    assert not jtrainer.encoder.use_silu and not jtrainer.predictor.use_silu
