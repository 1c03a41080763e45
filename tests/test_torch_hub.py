"""The port's hub factories (`vjepa2_tpu_torch.hub.backbones`) against the
JAX package's (`vjepa2_tpu/hub/backbones.py`), on the CPU.

Each factory returns (encoder, predictor) and, asked for the CPU, builds
there (`tests/test_torch_entry_points.py` holds that each raises without a
CUDA device otherwise): the predictor half of
``vjepa2_vit_*`` (12 x 384, 12 heads, 10 mask tokens, RoPE) and the AC pair
of ``vjepa2_ac_vit_giant`` (the 22-head ViT-g and the 24 x 1024 AC
predictor). The architectures are narrowed here, on both sides alike, so
that the CPU builds them quickly: each encoder to 2 blocks of 128 (2 heads
of 64), the predictor half to 2 blocks (its width and heads as shipped),
the AC predictor to 2 blocks of 128 (2 heads of 64). The arguments each
factory gives its predictor are recorded before the narrowing and compared
with JAX's; the modules then run on the same weights (carried by
`state_dict_from_flax`) and inputs from numpy with a seed, within the
predictor tolerance of `tests/test_torch_predictor.py` (atol 2e-5, rtol
1e-4) and JAX's AC tolerance (atol 3e-5, rtol 2e-4).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.hub import backbones as jb
from vjepa2_tpu.models import vision_transformer as jvt
from vjepa2_tpu_torch.hub import backbones as tb
from vjepa2_tpu_torch.hub.converter import state_dict_from_flax
from vjepa2_tpu_torch.models import vision_transformer as tvt

FACTORIES = ["vjepa2_vit_large", "vjepa2_vit_huge", "vjepa2_vit_giant", "vjepa2_vit_giant_384",
             "vjepa2_ac_vit_giant"]
ARCHS = ["vit_large", "vit_huge", "vit_giant_xformers"]
# what the narrowing overrides in each predictor
NARROW_PRED = {"depth": 2}
NARROW_AC = {"depth": 2, "predictor_embed_dim": 128, "num_heads": 2}
# the arguments compared apart: placement (the port's device, each side's
# dtype) and the port's route
PORT_ONLY = {"device", "dtype", "use_flash"}


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' encoders cut to 2 x 128 (2 heads of 64) and their
    predictors to `NARROW_PRED` / `NARROW_AC`. Returns {(side, kind): the
    keyword arguments the factory passed}."""
    seen = {}
    for arch in ARCHS:
        monkeypatch.setitem(tvt.MODEL_REGISTRY, arch, tvt._factory(128, 2, 2, 4))
        monkeypatch.setitem(jvt.MODEL_REGISTRY, arch, jvt._factory(128, 2, 2, 4))

    def recorder(side, kind, make, cut):
        def build(**kwargs):
            seen[(side, kind)] = dict(kwargs)
            return make(**{**kwargs, **cut})
        return build

    monkeypatch.setattr(tb, "vit_predictor", recorder("port", "pred", tb.vit_predictor,
                                                     NARROW_PRED))
    monkeypatch.setattr(tb, "vit_ac_predictor", recorder("port", "ac", tb.vit_ac_predictor,
                                                        NARROW_AC))
    monkeypatch.setattr(jb, "vit_predictor", recorder("jax", "pred", jb.vit_predictor,
                                                     NARROW_PRED))
    monkeypatch.setattr(jb, "vit_ac_predictor", recorder("jax", "ac", jb.vit_ac_predictor,
                                                        NARROW_AC))
    return seen


@pytest.mark.parametrize("factory", FACTORIES)
def test_factories_build_on_the_cpu_when_asked(narrow, factory):
    enc, pred = getattr(tb, factory)(device="cpu", generator=torch.Generator().manual_seed(0))
    params = list(enc.parameters()) + list(pred.parameters())
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in params)
    assert enc.dtype == pred.dtype == torch.float32 and enc.use_flash and pred.use_flash
    kind = "ac" if factory == "vjepa2_ac_vit_giant" else "pred"
    assert pred.embed_dim == enc.embed_dim
    assert len(pred.predictor_blocks) == 2
    assert (kind == "ac") == hasattr(pred, "action_encoder")


def _jax_pair(factory, **kwargs):
    (jenc, _), (jpred, _) = getattr(jb, factory)(**kwargs)
    return jenc, jpred


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("factory", ["vjepa2_vit_large", "vjepa2_vit_giant_384"])
def test_predictor_half_matches_jax(narrow, factory):
    """The factory's predictor: JAX's arguments, and on JAX's weights the
    same function (4 frames at the factory's size, 8 context and 6 target
    tokens a clip)."""
    img = 384 if factory.endswith("384") else 256
    jenc, jpred = _jax_pair(factory, num_frames=4)
    enc, pred = getattr(tb, factory)(num_frames=4, device="cpu")
    want_args = {k: v for k, v in narrow[("jax", "pred")].items() if k not in PORT_ONLY}
    got_args = {k: v for k, v in narrow[("port", "pred")].items() if k not in PORT_ONLY}
    assert got_args == want_args
    assert narrow[("port", "pred")]["use_flash"]
    n_tok = 2 * (img // 16) ** 2
    rs = np.random.RandomState(0)
    perm = [rs.permutation(n_tok) for _ in range(2)]
    mx = np.stack([np.sort(p[:8]) for p in perm]).astype(np.int32)
    my = np.stack([np.sort(p[8:14]) for p in perm]).astype(np.int32)
    z = rs.randn(2, 8, 128).astype(np.float32)
    params = jax.jit(lambda k: jpred.init(k, jnp.asarray(z), jnp.asarray(mx), jnp.asarray(my),
                                          1))(jax.random.PRNGKey(0))
    want = jax.jit(lambda p: jpred.apply(p, jnp.asarray(z), jnp.asarray(mx), jnp.asarray(my),
                                         1))(params)
    pred.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = pred(torch.from_numpy(z), torch.from_numpy(mx), torch.from_numpy(my), 1)
    assert got.shape == (2, 6, 128)
    _close(got, want, 2e-5, 1e-4)


def test_ac_pair_matches_jax(narrow):
    """`vjepa2_ac_vit_giant`: JAX's arguments for the AC predictor, and on
    JAX's weights the same encoder (one frame as a 2-frame tubelet, 256 px)
    and AC predictor (2 frames of its tokens)."""
    jenc, jpred = _jax_pair("vjepa2_ac_vit_giant")
    enc, pred = tb.vjepa2_ac_vit_giant(device="cpu")
    # JAX's AC predictor stores num_frames and tubelet_size and reads neither;
    # the port's takes its frame count at call time
    want_args = {k: v for k, v in narrow[("jax", "ac")].items()
                 if k not in PORT_ONLY | {"num_frames", "tubelet_size"}}
    got_args = {k: v for k, v in narrow[("port", "ac")].items() if k not in PORT_ONLY}
    assert got_args == want_args
    rs = np.random.RandomState(1)
    clip = np.repeat(rs.rand(1, 1, 256, 256, 3).astype(np.float32), 2, axis=1)
    enc_params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(clip))
    h_j = jax.jit(jenc.apply)(enc_params, jnp.asarray(clip))
    enc.load_state_dict(state_dict_from_flax(enc_params))
    with torch.no_grad():
        h = enc(torch.from_numpy(clip))
    assert h.shape == (1, 256, 128)
    _close(h, h_j, 2e-5, 1e-4)

    x = rs.randn(2, 2 * 256, 128).astype(np.float32)
    a, s = (rs.uniform(-0.1, 0.1, size=(2, 2, 7)).astype(np.float32) for _ in range(2))
    pred_params = jax.jit(jpred.init)(jax.random.PRNGKey(1), x, a, s)
    want = jax.jit(jpred.apply)(pred_params, x, a, s)
    pred.load_state_dict(state_dict_from_flax(pred_params))
    with torch.no_grad():
        got = pred(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(s))
    assert got.shape == (2, 512, 128)
    _close(got, want, 3e-5, 2e-4)


def _prefixed(module: torch.nn.Module, prefix: str, seed: int) -> dict:
    """``module``'s state dict with new values drawn from numpy, under
    ``prefix`` (the released files' ``module.`` / ``backbone.`` forms)."""
    rs = np.random.RandomState(seed)
    return {prefix + k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("factory", ["vjepa2_vit_large", "vjepa2_ac_vit_giant"])
def test_checkpoint_loads_by_key(narrow, tmp_path, factory):
    """A torch checkpoint with "encoder" and "predictor" entries under
    ``module.`` / ``backbone.`` prefixes loads into the pair, each weight
    equal to the one written; a file with "target_encoder" alone loads the
    encoder and draws the predictor."""
    make = getattr(tb, factory)
    enc, pred = make(device="cpu")
    written = {"encoder": _prefixed(enc, "module.backbone.", 0),
               "predictor": _prefixed(pred, "module.", 1), "epoch": 3}
    path = tmp_path / "ckpt.pt"
    torch.save(written, path)
    enc2, pred2 = make(device="cpu", checkpoint=str(path))
    for module, entry, prefix in ((enc2, "encoder", "module.backbone."),
                                  (pred2, "predictor", "module.")):
        sd = module.state_dict()
        assert sorted(sd) == sorted(k[len(prefix):] for k in written[entry])
        for k, v in sd.items():
            assert torch.equal(v, written[entry][prefix + k]), k
    if factory == "vjepa2_vit_large":
        torch.save({"target_encoder": written["encoder"]}, path)
        enc3, pred3 = make(device="cpu", checkpoint=str(path),
                           generator=torch.Generator().manual_seed(0))
        for k, v in enc3.state_dict().items():
            assert torch.equal(v, written["encoder"]["module.backbone." + k]), k
        drawn = copy.deepcopy(pred3)
        drawn.reset_parameters(torch.Generator().manual_seed(0))
        assert all(torch.equal(v, drawn.state_dict()[k]) for k, v in pred3.state_dict().items())
