"""The frozen evals on the card: the probe grid on CUDA tensors (its
self-attention on the fp32 flash kernels, head width 64) against the same
grid on the CPU (the plain route), and B1's launches in each eval step (the
frozen encoder, and the anticipation eval's predictor, on the flash route in
bf16; the probes' fp32 kernels count apart, `ops.flash_attention`).

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_evals_cuda.py -q

Tolerances: the grid fp32 on both sides (TF32 off), from one state: losses
within rtol 1e-5, Adam moments within rtol 1e-4 plus 1e-6 of the leaf's
largest entry and each parameter leaf within 1e-3 relative L2 of its update,
the key biases left out (as `tests/test_torch_probes.py` holds the port to
JAX), `eval_logits` within atol 2e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.evals import action_anticipation as ant
from vjepa2_tpu_torch.evals import probes
from vjepa2_tpu_torch.evals.video_classification import VideoClassificationEval
from vjepa2_tpu_torch.models.predictor import vit_predictor
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn

pytestmark = pytest.mark.cuda

CONFIGS = [probes.ProbeConfig(lr=5e-3, weight_decay=0.01, final_wd=0.1),
           probes.ProbeConfig(lr=1e-3, start_lr=2e-4, warmup_steps=2, weight_decay=0.1)]
S, T = 64, 4
ENC = dict(img_size=(S, S), patch_size=16, num_frames=T, tubelet_size=2, embed_dim=192,
           depth=2, num_heads=3, use_rope=True, uniform_power=True)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _state_to(state, device):
    params, opt, step = state
    move = lambda d: {k: v.to(device, copy=True) for k, v in d.items()}  # noqa: E731
    return move(params), {"mu": move(opt["mu"]), "nu": move(opt["nu"]),
                          "count": opt["count"].to(device, copy=True)}, step


def _key_bias(name: str, leaf: torch.Tensor, dim: int) -> torch.Tensor:
    """The key-bias entries of a [P, ...] leaf, whose gradient is 0 but for
    rounding (softmax ignores a shift of a row's scores): Adam steps them by
    ±lr on either side, so they are held by their moments only."""
    mask = torch.zeros_like(leaf, dtype=torch.bool)
    if name.endswith("attn.qkv.bias"):
        mask[..., dim:2 * dim] = True
    elif name.endswith("xattn.kv.bias"):
        mask[..., :dim] = True
    return mask


def test_probe_grid_on_the_card_matches_the_cpu(dev):
    grids = {d: probes.ProbeGrid(CONFIGS, embed_dim=128, num_classes=7, num_heads=2, depth=2,
                                 total_steps=4, device=d) for d in ("cpu", dev)}
    state = grids["cpu"].init()
    rs = np.random.RandomState(0)
    for step in range(2):
        feats = torch.from_numpy(rs.randn(4, 64, 128).astype(np.float32))
        labels = torch.from_numpy(rs.randint(0, 7, size=4))
        before = {k: v.clone() for k, v in state[0].items()}
        p_cpu, o_cpu, _, m_cpu = grids["cpu"].train_step(*_state_to(state, "cpu"), feats, labels)
        p_dev, o_dev, _, m_dev = grids[dev].train_step(*_state_to(state, dev), feats.to(dev),
                                                      labels.to(dev))
        np.testing.assert_allclose(m_dev["loss"].cpu().numpy(), m_cpu["loss"].numpy(), rtol=1e-5)
        for k in p_cpu:
            for mom in ("mu", "nu"):
                want = o_cpu[mom][k].numpy()
                np.testing.assert_allclose(o_dev[mom][k].cpu().numpy(), want, rtol=1e-4,
                                           atol=1e-6 * np.abs(want).max(), err_msg=k)
            keep = ~_key_bias(k, p_cpu[k], 128)
            update = (p_cpu[k] - before[k])[keep].norm()
            assert (p_dev[k].cpu() - p_cpu[k])[keep].norm() <= 1e-3 * update, k
        state = (p_cpu, o_cpu, step + 1)
    with torch.no_grad():
        want = grids["cpu"].eval_logits(state[0], feats)
        got = grids[dev].eval_logits(_state_to(state, dev)[0], feats.to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5, rtol=1e-4)


def _encoder(dev):
    enc = VisionTransformer(**ENC, use_flash=True, dtype=torch.bfloat16, device=dev)
    enc.reset_parameters(torch.Generator(dev).manual_seed(0))
    return enc.eval().requires_grad_(False)


def test_b1_launches_per_video_eval_step(dev):
    """A train step encodes its B x nc clips in one call (B1 once a layer);
    a val batch of 2 views encodes twice."""
    ev = VideoClassificationEval(encoder=_encoder(dev), num_classes=5, probe_configs=CONFIGS,
                                 num_heads=3, probe_depth=2)
    rs = np.random.RandomState(1)
    clips = rs.rand(3, 2, T, S, S, 3).astype(np.float32)
    labels = rs.randint(0, 5, size=3)
    before = fdn.LAUNCHES
    m = ev.train_batch(clips, labels)
    assert fdn.LAUNCHES - before == ENC["depth"] and np.isfinite(m["loss"]).all()
    before = fdn.LAUNCHES
    ev.eval_batch(np.concatenate([clips, clips], axis=1), labels, num_views=2)
    assert fdn.LAUNCHES - before == 2 * ENC["depth"]


def test_b1_launches_per_anticipation_step(dev):
    """A train step runs the encoder and the predictor once each (B1 once a
    layer of each), with per-example anticipation times; features in bf16."""
    pred = vit_predictor(img_size=(S, S), num_frames=T, tubelet_size=2, embed_dim=192,
                         predictor_embed_dim=64, depth=2, num_heads=2, use_mask_tokens=True,
                         num_mask_tokens=1, use_rope=True, use_flash=True, dtype=torch.bfloat16,
                         device=dev)
    pred.reset_parameters(torch.Generator(dev).manual_seed(1))
    ev = ant.AnticipationEval(_encoder(dev), pred.eval(), num_verbs=5, num_nouns=7,
                              num_actions=9, frames_per_second=2.0, probe_configs=CONFIGS,
                              num_heads=3, grid_size=4, h_patches=4, w_patches=4)
    rs = np.random.RandomState(2)
    clips = rs.rand(2, T, S, S, 3).astype(np.float32)
    times = np.asarray([1.0, 2.0], np.float32)
    feats = ev.features(clips, times)
    assert feats.dtype == torch.bfloat16 and feats.shape == (2, 32 + 16, 192)
    v = rs.randint(0, 5, size=2)
    before = fdn.LAUNCHES
    loss = ev.train_batch(clips, times, v, v % 7, v % 9)
    assert fdn.LAUNCHES - before == 2 + 2 and np.isfinite(loss)
    before = fdn.LAUNCHES
    out = ev.evaluate([(clips, times, v, v % 7, v % 9)], k=2)
    assert fdn.LAUNCHES - before == 2 + 2 and set(out["best_probe"]) == {"verb", "noun", "action"}
