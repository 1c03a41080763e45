"""The port's serving export (`vjepa2_tpu_torch.hub.export`) against the JAX
package's (`vjepa2_tpu/hub/export.py`), on the CPU.

The encoder: a depth-2 ViT with 64-wide heads (RoPE, the DN flash route,
whose kernels run their plain versions here) on JAX's weights carried by
`state_dict_from_flax`, exported with a symbolic batch and loaded, against
JAX's `export_encoder` / `load_encoder` round trip at B = 1, 2 and 3, within
2e-5. Then the port's own round trip at a fixed batch (bit-equal to the
eager module; one op node a block, by route: `flash_fwd_dn` at heads of 64,
`flash_fwd_bhnd` at 80, `ln_qkv` + `flash_fwd_bhnd` + `ln_mlp` fused), a
loader that imports no model module (a fresh process), and
`torch.library.opcheck` of the four ops, fake kernel against real, and of
`flash_fwd_dn` at fp32 and bf16 on the DN route's strided views (the fake
keeps the operands' dtype: an fp32 model on the DN route traces).

The world model: the depth-2 encoder and AC predictor of
`tests/test_torch_planning.py` (numpy-drawn weights on both sides), with the
hub preprocessor, exported and loaded: encode equal to `WorldModel.encode`
and within JAX's AC tolerance (atol 3e-5, rtol 2e-4) of JAX's on uint8
frames at the crop size (no resize, so both preprocessors are exact); the
plan at seed s bit-equal to `infer_next_action` with a generator seeded s;
with JAX's own draws as the noise, within 1e-5 of JAX's CEM (the top-k
margins asserted as in the planning test); the preprocessor round trip
through meta.json, and the refusal of any other preprocessor.

Each side runs JAX's first, from copies of the inputs.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.hub import export as jexport
from vjepa2_tpu.hub.preprocessor import vjepa2_preprocessor as jax_preprocessor
from vjepa2_tpu.models.ac_predictor import VisionTransformerPredictorAC as JaxACPredictor
from vjepa2_tpu.models.vision_transformer import VisionTransformer as JaxViT
from vjepa2_tpu.planning import cem as jcem
from vjepa2_tpu.planning.world_model import WorldModel as JaxWorldModel
from vjepa2_tpu_torch.hub import export as texport
from vjepa2_tpu_torch.hub.converter import load_world_model_state, state_dict_from_flax
from vjepa2_tpu_torch.hub.preprocessor import vjepa2_preprocessor
from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.planning import cem as tcem
from vjepa2_tpu_torch.planning.world_model import WorldModel

ATOL, RTOL = 3e-5, 2e-4
EXPORT_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch ops: 6 pytest workers with
    torch's default 8 threads each oversubscribe an 8-core host (see
    `tests/test_torch_eval_cli.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the encoder ---------------------------------------------------------------

ENC = dict(img_size=(32, 32), patch_size=16, num_frames=4, tubelet_size=2, embed_dim=128,
           depth=2, num_heads=2, use_rope=True)


@pytest.fixture(scope="module")
def encoders():
    """(JAX's ViT, its params, the port's ViT on the same weights)."""
    jenc = JaxViT(**ENC)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)))["params"]
    enc = VisionTransformer(**ENC, use_flash=True)
    enc.load_state_dict(state_dict_from_flax(params))
    return jenc, params, enc


def _clips(seed, batch):
    return np.random.RandomState(seed).rand(batch, 4, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def port_artifact(encoders, tmp_path_factory):
    """The port's encoder exported with a symbolic batch: its directory."""
    return texport.export_encoder(encoders[2], str(tmp_path_factory.mktemp("enc")), batch="B")


def test_export_encoder_matches_jax_at_every_batch(encoders, port_artifact, tmp_path):
    jenc, params, enc = encoders
    jexport.export_encoder(jenc, params, str(tmp_path), batch="B")
    jfn, jmeta = jexport.load_encoder(str(tmp_path))
    fn, meta = texport.load_encoder(port_artifact, device="cpu")
    for key in ("num_frames", "img_size", "in_dtype", "batch", "embed_dim"):
        assert meta[key] == jmeta[key], key
    assert meta["torch_version"] == torch.__version__
    for b in (1, 2, 3):
        clips = _clips(b, b)
        want = np.asarray(jfn(clips.copy()))
        got = fn(clips)
        assert got.shape == (b, 8, 128) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=EXPORT_ATOL, rtol=0)
        with torch.inference_mode():
            assert torch.equal(got, enc(torch.from_numpy(clips)))


def _route_encoder(route):
    """A depth-2 ViT on one attention route: DN (heads of 64), BHND (heads of
    80) or fused (B7 + BHND + B8 at heads of 64)."""
    kw = dict(ENC, use_flash=True)
    if route == "bhnd":
        kw.update(embed_dim=160)
    if route == "fused":
        kw.update(fuse_ln_qkv=True, fuse_ln_mlp=True)
    enc = VisionTransformer(**kw)
    enc.reset_parameters(torch.Generator().manual_seed(1))
    return enc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_program_dtypes_and_image_encoder_round_trip(dtype, tmp_path):
    """`program_dtypes` reads the dtypes a program's nodes make: an fp32
    encoder's program (JAX's hub default, A11c) makes no bf16 tensor, a bf16
    one does; an image encoder (``num_frames=1``, [B, H, W, 3]) with SwiGLU
    blocks exports, records its dtype and loads bit-equal to eager."""
    enc = VisionTransformer(**dict(ENC, num_frames=1), use_flash=True, use_silu=True,
                            dtype=dtype)
    enc.reset_parameters(torch.Generator().manual_seed(2))
    texport.export_encoder(enc, str(tmp_path), batch=2)
    fn, meta = texport.load_encoder(str(tmp_path), device="cpu")
    dtypes = texport.program_dtypes(fn.module)
    assert meta["dtype"] == str(dtype).removeprefix("torch.")
    assert ("bfloat16" in dtypes) == (dtype == torch.bfloat16) and dtypes["float32"] > 0
    images = torch.from_numpy(np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32))
    got = fn(images)
    assert got.shape == (2, 4, 128) and got.dtype == dtype
    with torch.inference_mode():
        assert torch.equal(got, enc(images))


ROUTE_OPS = {"dn": {"flash_fwd_dn": 2}, "bhnd": {"flash_fwd_bhnd": 2},
             "fused": {"ln_qkv": 2, "flash_fwd_bhnd": 2, "ln_mlp": 2}}


@pytest.mark.parametrize("route", ["dn", "bhnd", "fused"])
def test_export_encoder_fixed_batch_round_trip(route, tmp_path):
    """A fixed batch of 2: the graph holds one attention op node a block (and
    on the fused route one ln_qkv and one ln_mlp), the loaded program equals
    the eager module bit for bit, and another batch is refused."""
    enc = _route_encoder(route)
    texport.export_encoder(enc, str(tmp_path), batch=2)
    fn, meta = texport.load_encoder(str(tmp_path), device="cpu")
    assert meta["batch"] == 2
    assert texport.program_op_counts(fn.module) == ROUTE_OPS[route]
    clips = torch.from_numpy(_clips(3, 2))
    with torch.inference_mode():
        assert torch.equal(fn(clips), enc(clips))
    with pytest.raises(Exception):
        fn(clips[:1])


def test_load_encoder_imports_no_model_module(encoders, port_artifact, tmp_path):
    """A fresh process loads and calls the program: it imports the ops and
    nothing of `vjepa2_tpu_torch.models`, and answers as the eager module."""
    enc = encoders[2]
    clips = torch.from_numpy(_clips(4, 3))
    torch.save(clips, tmp_path / "clips.pt")
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from vjepa2_tpu_torch.hub.export import load_encoder\n"
        f"fn, meta = load_encoder({port_artifact!r}, device='cpu')\n"
        f"torch.save(fn(torch.load({str(tmp_path / 'clips.pt')!r})), "
        f"{str(tmp_path / 'out.pt')!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('vjepa2_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vjepa2_tpu_torch.ops.flash_attention_dn" in modules
    assert not [m for m in modules if m.startswith("vjepa2_tpu_torch.models")], modules
    with torch.inference_mode():
        assert torch.equal(torch.load(tmp_path / "out.pt"), enc(clips))


def _op_cases():
    rs = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    B, H, D, N = 2, 2, 32, 24
    seg = torch.arange(N, dtype=torch.int32) // 8
    x, g, b = t(B, N, 64), t(64), t(64)
    return {
        "flash_fwd_dn": [(t(B, H, D, N), t(B, H, D, N), t(B, H, D, N), None, None, None, None, 20),
                         (t(B, H, D, N), t(B, H, D, N), t(B, H, D, N), 0.3, t(1, N, D),
                          t(1, N, D), seg, None)],
        "flash_fwd_bhnd": [(t(B, H, N, 80), t(B, H, N, 80), t(B, H, N, 80), None, None, None,
                            None, None, False, 20),
                           (t(B, H, N, 32), t(B, H, N, 32), t(B, H, N, 32), None, t(1, N, 32),
                            t(1, N, 32), seg.expand(B, N), seg.expand(B, N), False, None)],
        "ln_qkv": [(x, g, b, t(3 * H * 32, 64), t(3 * H * 32), None, None, 1e-6, H, 32),
                   (x, g, b, t(3 * H * 32, 64), t(3 * H * 32), t(1, N, 32), t(1, N, 32), 1e-6,
                    H, 32)],
        "ln_mlp": [(x, g, b, t(256, 64), t(256), 1e-6)],
    }


@pytest.mark.parametrize("op", ["flash_fwd_dn", "flash_fwd_bhnd", "ln_qkv", "ln_mlp"])
def test_ops_pass_opcheck(op):
    """Schema, autograd registration, the fake kernel against the real one
    (shapes, dtypes and strides) and dynamic-shape tracing, on the CPU."""
    overload = getattr(torch.ops.vjepa2, op).default
    for args in _op_cases()[op]:
        result = torch.library.opcheck(overload, args)
        assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_dn_opcheck_at_the_operands_dtype(dtype):
    """`flash_fwd_dn` at fp32 (the DN route's dtype on the card too, since
    B1/B2 take fp32 operands) and at bf16, on the CPU: opcheck on q, k, v as
    views of one [B, 3 * dim, N] projection output, as `Attention` makes
    them, with per-example tables, and with frame-causal ids and pad keys on
    int32-max; the fake kernel gives out in the operands' dtype and lse in
    fp32, so an fp32 model on the DN route traces."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rs = np.random.RandomState(3)
    B, H, D, N = 2, 2, 16, 24
    y = torch.from_numpy(rs.randn(B, 3 * H * D, N).astype(np.float32)).to(dtype)
    q, k, v = y.view(B, 3, H, D, N).unbind(1)
    cos, sin = (torch.from_numpy(rs.uniform(-1, 1, (B, N, D)).astype(np.float32))
                for _ in range(2))
    seg = torch.cat([torch.arange(N - 4, dtype=torch.int32) // 10,
                     torch.full((4,), torch.iinfo(torch.int32).max, dtype=torch.int32)])
    op = torch.ops.vjepa2.flash_fwd_dn.default
    for args in ((q, k, v, None, cos, sin, None, None), (q, k, v, None, None, None, seg, None)):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result
    with FakeTensorMode() as mode:
        out, lse = op(*(mode.from_tensor(t) for t in (q, k, v)), None, None, None, None, None)
    assert out.dtype == dtype and out.shape == (B, H, D, N) and lse.dtype == torch.float32


# -- the world model -----------------------------------------------------------

S, E, P, H = 32, 192, 128, 2  # 2 x 2 patches a frame; predictor heads of 64 (DN route)
TPF = (S // 16) ** 2
WM_CEM = dict(rollout=2, cem_steps=3, samples=16, topk=4)
# the plan's seed, picked by scanning seeds 0-15 with the frames below: at
# 0 (and 1) every CEM step's k-th and (k+1)-th distances lie further apart
# than twice what the step_fn tolerance lets a distance move (1.4-2.2 times
# that; asserted in the test), so that JAX's and the port's top-k sets agree;
# at 2-15 a step's gap is 0.03-0.9 times that
WM_SEED = 0


def _numpy_params(params, seed):
    """A flax tree with every leaf redrawn from numpy, as
    `tests/test_torch_planning.py` draws them: kernels ~ N(0, 1/fan_in),
    biases ~ N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            x = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * rs.randn(*shape)
        else:
            x = 0.1 * rs.randn(*shape)
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def world_models(tmp_path_factory):
    """(JAX's WorldModel, the port's, the port's loaded from its export),
    both with the hub preprocessor at the frames' size."""
    jenc = JaxViT(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2, embed_dim=E,
                  depth=2, num_heads=3, use_rope=True)
    jpred = JaxACPredictor(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2,
                           embed_dim=E, predictor_embed_dim=P, depth=2, num_heads=H)
    enc_params = _numpy_params(jax.jit(jenc.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, S, S, 3)))["params"], 0)
    zeros = jnp.zeros((1, 1, 7))
    pred_params = _numpy_params(jax.jit(jpred.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, TPF, E)), zeros, zeros)["params"], 1)
    jwm = JaxWorldModel(jenc, enc_params, jpred, pred_params, tokens_per_frame=TPF,
                        preprocessor=jax_preprocessor(crop_size=S),
                        cem_config=jcem.CEMConfig(**WM_CEM))
    enc = VisionTransformer(img_size=(S, S), patch_size=16, num_frames=2, tubelet_size=2,
                            embed_dim=E, depth=2, num_heads=3, use_rope=True, use_flash=True)
    pred = vit_ac_predictor(img_size=(S, S), patch_size=16, embed_dim=E, predictor_embed_dim=P,
                            depth=2, num_heads=H, use_flash=True)
    wm = load_world_model_state(
        WorldModel(enc, pred, TPF, preprocessor=vjepa2_preprocessor(crop_size=S),
                   cem_config=tcem.CEMConfig(**WM_CEM)), enc_params, pred_params)
    out = tmp_path_factory.mktemp("wm")
    texport.export_world_model(wm, str(out))
    return jwm, wm, texport.load_world_model(str(out), device="cpu")


def _frames(seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (S, S, 3), np.uint8) for _ in range(2)]


def test_world_model_meta_and_programs(world_models):
    _, wm, swm = world_models
    meta = swm.meta
    assert meta["frame_preprocessor"] == {"kind": "vjepa2", "crop_size": S}
    assert meta["preprocessor"] == texport.export_preprocessor_stats()
    assert meta["preprocessor"]["std"] == pytest.approx([0.229, 0.224, 0.225])
    assert (meta["img_size"], meta["tokens_per_frame"], meta["embed_dim"]) == ([S, S], TPF, E)
    assert meta["normalize_reps"] and swm.cem_config == wm.cem_config
    # the encode's 2 blocks; the plan's loop body holds one CEM step: 2
    # rollout frames of the 2-block predictor
    assert texport.program_op_counts(swm._encode) == {"flash_fwd_dn": 2}
    assert texport.program_op_counts(swm._plan) == {"flash_fwd_dn": 2 * 2}


def test_serving_encode_matches_eager_and_jax(world_models):
    jwm, wm, swm = world_models
    for frame in _frames(10):
        want = np.asarray(jwm.encode(frame.copy()))
        got = swm.encode(frame)
        assert got.shape == (TPF, E) and got.dtype == torch.float32
        assert torch.equal(got, wm.encode(frame))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_serving_plan_equals_infer_next_action(world_models, seed):
    _, wm, swm = world_models
    start, goal_frame = _frames(seed)
    rep, goal = wm.encode(start), wm.encode(goal_frame)
    pose = np.random.RandomState(seed).uniform(-0.3, 0.3, size=7).astype(np.float32)
    want = wm.infer_next_action(rep, pose, goal, generator=torch.Generator().manual_seed(seed))
    got = swm.plan(rep, pose, goal, seed=seed)
    assert got.shape == (2, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _jax_draws(seed: int, cfg) -> np.ndarray:
    """[cem_steps, rollout, samples, 4]: JAX's CEM draws from ``PRNGKey(seed)``
    in its order of key splits (`tests/test_torch_planning.py`)."""
    rng = jax.random.PRNGKey(seed)
    out = np.empty((cfg.cem_steps, cfg.rollout, cfg.samples, 4), np.float32)
    for step in range(cfg.cem_steps):
        for h in range(cfg.rollout):
            rng, k = jax.random.split(rng)
            out[step, h] = np.asarray(jax.random.normal(k, (cfg.samples, 4)))
    return out


def test_serving_plan_on_jax_draws_matches_jax(world_models):
    """The loaded plan on JAX's draws against JAX's CEM on the same reps."""
    jwm, wm, swm = world_models
    start, goal_frame = _frames(WM_SEED)
    rep, goal = swm.encode(start), swm.encode(goal_frame)
    pose = np.random.RandomState(WM_SEED).uniform(-0.3, 0.3, size=7).astype(np.float32)
    cfg = wm.cem_config
    draws = _jax_draws(WM_SEED, cfg)
    want = np.asarray(jwm.infer_next_action(jnp.asarray(rep.numpy()), pose.copy(),
                                            jnp.asarray(goal.numpy()),
                                            rng=jax.random.PRNGKey(WM_SEED)))

    # every step's top-k margin, from the port's step_fn on the final frame: a
    # distance is a mean of |out - goal| over the latent, so an out within
    # atol + rtol |out| moves it by at most b = atol + rtol mean|out|
    gaps = []

    def recording(reps, actions, poses):
        out = wm.step_fn(reps, actions, poses)
        if actions.shape[1] == cfg.rollout:
            ranked = torch.sort((out - goal[None]).abs().mean(dim=(1, 2))).values
            b = ATOL + RTOL * out.abs().mean().item()
            gaps.append(((ranked[cfg.topk] - ranked[cfg.topk - 1]).item(), b))
        return out

    tcem.make_cem(recording, cfg)(rep, pose, goal, sampler=lambda s, h: torch.from_numpy(
        draws[s, h]))
    assert len(gaps) == cfg.cem_steps
    for step, (gap, b) in enumerate(gaps):
        assert gap > 2 * b, f"step {step}: top-k margin {gap} within 2 x {b}"

    got = swm.plan_from_noise(rep, pose, goal, draws)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_export_world_model_refuses_another_preprocessor(world_models, tmp_path):
    _, wm, _ = world_models
    other = WorldModel(wm.encoder, wm.predictor, TPF, preprocessor=lambda clip: clip,
                       cem_config=wm.cem_config)
    with pytest.raises(ValueError, match="standard hub Preprocessor"):
        texport.export_world_model(other, str(tmp_path))
