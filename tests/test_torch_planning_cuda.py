"""Planning on the card: the CEM's update on device tensors against the same
CEM on the CPU, and B1 (`csrc/flash_fwd_dn.cu`) at the shapes a plan gives
it: 400 candidate rollouts of 1 and 2 frames of 2 + 256 tokens,
stack-padded to 264 and 520 with the pad keys on segment int32-max, as
`models/ac_predictor.py` runs them.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_planning_cuda.py -q

Tolerances: the CEM over the linear world model of
`tests/planning/test_cem.py` (fp32 on both sides, one sampler) within 1e-6;
over a depth-2 fp32 AC predictor (2 heads of 64, 16 tokens a frame, weights
drawn wider than the init's, as `tests/test_torch_planning.py` draws them,
so that the actions move its latents; on the card its attention on B1
at fp32, the DN route, with the frame-causal ids and pad keys) within 1e-5, once
every step's top-k margin exceeds twice the card's distances' distance from
the CPU's (else a tie could rank differently on the two sides): over 3 CEM
steps, since the candidates then converge until the 10th and 11th
distances tie to within fp32's rounding (a margin of 0 to 2e-7 from the
8th step on this model, measured on the CPU);
B1 against its plain version as `tests/test_torch_flash_dn_cuda.py` holds it
(out 1e-2 + 1e-2 |plain|, lse 3e-2), and the real queries' rows bit-equal
whatever the pad keys hold.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.models.ac_predictor import vit_ac_predictor
from vjepa2_tpu_torch.models.modules import frame_segments
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops.rope import build_rope_cache, expand_rope_cache
from vjepa2_tpu_torch.planning.cem import CEMConfig, make_cem
from vjepa2_tpu_torch.train.droid import feature_layernorm

pytestmark = pytest.mark.cuda

N, D = 4, 8


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _linear_step(kind):
    def step_fn(reps, actions, poses):
        last = reps[:, -N:]
        if kind == "constant":
            return last
        delta = torch.nn.functional.pad(actions[:, -1, :3], (0, D - 3))
        return last + delta[:, None, :]

    return step_fn


def _ac_step():
    """(a step_fn per device, tokens a frame, width): a depth-2 fp32 AC
    predictor with ``use_flash`` (2 heads of 64, a 4 x 4 grid of 64-wide
    tokens), the same weights on the card and on the CPU, drawn with numpy:
    matrices ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), LayerNorm scales 1 +
    N(0, 0.1^2); and `feature_layernorm` of its last frame, as
    `WorldModel.step_fn`."""
    cpu = vit_ac_predictor(img_size=(64, 64), patch_size=16, embed_dim=64,
                           predictor_embed_dim=128, depth=2, num_heads=2, use_flash=True)
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, prm in cpu.named_parameters():
            if prm.ndim == 2:
                x = rs.randn(*prm.shape) / np.sqrt(prm.shape[1])
            elif name.endswith("weight"):
                x = 1.0 + 0.1 * rs.randn(*prm.shape)
            else:
                x = 0.1 * rs.randn(*prm.shape)
            prm.copy_(torch.from_numpy(x.astype(np.float32)))
    models = {"cpu": cpu, "cuda": vit_ac_predictor(
        img_size=(64, 64), patch_size=16, embed_dim=64, predictor_embed_dim=128, depth=2,
        num_heads=2, use_flash=True, device="cuda")}
    models["cuda"].load_state_dict(cpu.state_dict())

    def step(reps, actions, poses):
        return feature_layernorm(models[reps.device.type](reps, actions, poses)[:, -16:])

    return step, 16, 64


@pytest.mark.parametrize("kind", ["linear", "constant", "fp32"])
def test_cem_on_the_card_matches_the_cpu(dev, kind):
    """One sampler's draws through the CEM on the card and on the CPU: the
    stable sort, ``std`` and the momenta on device tensors give the CPU's
    plan ("constant" ties every distance: the first k candidates win;
    "fp32" rolls out an fp32 AC predictor, on the card through B1 at fp32,
    the DN route at its heads of 64: each rollout call launches the forward
    once a layer, and the BHND kernels never)."""
    cfg = CEMConfig(samples=400, topk=10, cem_steps=3 if kind == "fp32" else 10)
    rs = np.random.RandomState(0)
    draws = rs.randn(cfg.cem_steps, cfg.rollout, cfg.samples, 4).astype(np.float32)
    step, n, d = _ac_step() if kind == "fp32" else (_linear_step(kind), N, D)
    rep = rs.randn(n, d).astype(np.float32) * (1.0 if kind == "fp32" else 0.1)
    goal = rep.copy()
    goal[:, :3] += 0.04
    pose = rs.uniform(-0.3, 0.3, size=7).astype(np.float32)
    dists = {"cuda": [], "cpu": []}  # each step's distances of the final frames to the goal

    def recording(reps, actions, poses):
        out = step(reps, actions, poses)
        if actions.shape[1] == cfg.rollout:
            goal_ = torch.from_numpy(goal).to(out.device)
            dists[out.device.type].append((out - goal_[None]).abs().mean(dim=(1, 2)).cpu())
        return out

    cem = make_cem(recording, cfg)
    before = (fdn.LAUNCHES_FP32, fa.LAUNCHES_FP32)
    with torch.inference_mode():
        plans = [cem(torch.from_numpy(rep).to(d_), pose, torch.from_numpy(goal).to(d_),
                     sampler=lambda step, h: torch.from_numpy(draws[step, h])).cpu().numpy()
                 for d_ in (dev, "cpu")]
    fp32_calls = cfg.cem_steps * cfg.rollout * 2 if kind == "fp32" else 0
    assert (fdn.LAUNCHES_FP32 - before[0], fa.LAUNCHES_FP32 - before[1]) == (fp32_calls, 0)
    if kind == "fp32":
        for i, (card, cpu) in enumerate(zip(dists["cuda"], dists["cpu"])):
            ranked = torch.sort(cpu).values
            gap = (ranked[cfg.topk] - ranked[cfg.topk - 1]).item()
            assert gap > 2 * (card - cpu).abs().max().item(), f"step {i}: top-k margin {gap}"
    np.testing.assert_allclose(plans[0], plans[1], atol=1e-5 if kind == "fp32" else 1e-6, rtol=0)


def test_cem_generator_on_the_card_repeats(dev):
    cem = make_cem(_linear_step("linear"), CEMConfig())
    rep, goal = torch.zeros(N, D, device=dev), torch.full((N, D), 0.02, device=dev)
    pose = np.zeros(7, np.float32)
    a, b = (cem(rep, pose, goal, generator=torch.Generator(dev).manual_seed(3)) for _ in "ab")
    assert torch.equal(a, b) and a.device.type == "cuda"


@pytest.mark.parametrize("frames, pad", [(1, 6), (2, 4)])
def test_b1_at_the_plan_shapes(dev, frames, pad):
    """B1 at [400, 16, 64, 264] and [400, 16, 64, 520] with frame-causal ids
    and the pad keys on int32-max, against its plain version; the real
    queries' rows do not change when the pad keys' k and v do."""
    B, H, Dh = 400, 16, 64
    n = frames * (2 + 256) + pad
    rng = np.random.RandomState(frames)
    q, k, v = (torch.from_numpy(rng.randn(B, H, Dh, n).astype(np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    (cos, sin), _ = expand_rope_cache(build_rope_cache(torch.arange(n, device=dev), Dh, 16, 16),
                                      Dh)
    kw = {"rope_expanded": (cos, sin), "segment_ids": frame_segments(frames, 258, dev, pad)}
    with torch.inference_mode():
        out_k, lse_k = fdn.flash_attention_bhdn(q, k, v, return_lse=True, **kw)
        out_p, lse_p = fdn.flash_attention_bhdn_plain(q, k, v, **kw)
        assert torch.isfinite(out_k.float()).all() and torch.isfinite(lse_k).all()
        d_out = (out_k.float() - out_p.float()).abs()
        assert (d_out <= 1e-2 + 1e-2 * out_p.float().abs()).all(), d_out.max().item()
        assert (lse_k - lse_p).abs().max().item() <= 3e-2
        k2, v2 = k.clone(), v.clone()
        k2[..., n - pad:] = 7.0
        v2[..., n - pad:] = -7.0
        out2 = fdn.flash_attention_bhdn(q, k2, v2, **kw)
        assert torch.equal(out2[..., :n - pad], out_k[..., :n - pad])
