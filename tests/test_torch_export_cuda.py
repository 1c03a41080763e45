"""The serving export (`vjepa2_tpu_torch.hub.export`) on the card: the
exported graphs' op nodes launch the hand-written kernels.

* a program traced on the CPU (bf16, the DN route's plain version there)
  and loaded onto the card launches B1 once a block, equal to the same
  encoder run eagerly on the card;
* ViT-L with ``fuse_ln="qkv,mlp"`` exports on the card and its program
  launches B7, B3 and B8 once a block each (and B1 never), equal to eager;
* ViT-L exported with a symbolic batch (traced at 2) answers batches of 1
  and 3 with no guard failing: 24 B1 a request, equal to eager.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py -q

Equality is `torch.equal`: a loaded program runs the eager module's ops on
the same inputs.
"""

import numpy as np
import pytest
import torch

from vjepa2_tpu_torch.hub import export
from vjepa2_tpu_torch.models.modules import parse_ln_fusions
from vjepa2_tpu_torch.models.vision_transformer import VisionTransformer, vit_large
from vjepa2_tpu_torch.ops import flash_attention as fa
from vjepa2_tpu_torch.ops import flash_attention_dn as fdn
from vjepa2_tpu_torch.ops import ln_mlp, ln_qkv

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _launches():
    return {"b1": fdn.LAUNCHES, "b3": fa.LAUNCHES, "b7": ln_qkv.LAUNCHES, "b8": ln_mlp.LAUNCHES}


def _counted(fn, *args):
    before = _launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _launches().items()}


def _clips(dev, batch, frames=16, size=256):
    rs = np.random.RandomState(batch)
    return torch.from_numpy(rs.rand(batch, frames, size, size, 3).astype(np.float32)).to(dev)


def test_program_traced_on_the_cpu_runs_b1_on_the_card(dev, tmp_path):
    enc = VisionTransformer(img_size=(64, 64), patch_size=16, num_frames=8, tubelet_size=2,
                            embed_dim=256, depth=2, num_heads=4, use_rope=True, use_flash=True,
                            dtype=torch.bfloat16)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    export.export_encoder(enc, str(tmp_path), batch="B")
    fn, meta = export.load_encoder(str(tmp_path))  # the card by default
    assert export.program_op_counts(fn.module) == {"flash_fwd_dn": 2}
    clips = _clips(dev, 2, frames=8, size=64)
    got, launched = _counted(fn, clips)
    assert launched == {"b1": 2, "b3": 0, "b7": 0, "b8": 0}
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    enc.to(dev)
    with torch.inference_mode():
        assert torch.equal(got, enc(clips))


def test_fused_vit_large_exports_and_runs_b7_b8(dev, tmp_path):
    fuse_qkv, fuse_mlp = parse_ln_fusions("qkv,mlp")
    enc = vit_large(img_size=(256, 256), num_frames=16, use_rope=True, use_flash=True,
                    dtype=torch.bfloat16, device=dev, fuse_ln_qkv=fuse_qkv, fuse_ln_mlp=fuse_mlp)
    enc.reset_parameters(torch.Generator(dev).manual_seed(0))
    export.export_encoder(enc, str(tmp_path), batch="B")
    fn, _ = export.load_encoder(str(tmp_path))
    assert export.program_op_counts(fn.module) == {"ln_qkv": 24, "flash_fwd_bhnd": 24,
                                                   "ln_mlp": 24}
    clips = _clips(dev, 1)
    got, launched = _counted(fn, clips)
    assert launched == {"b1": 0, "b3": 24, "b7": 24, "b8": 24}
    with torch.inference_mode():
        assert torch.equal(got, enc(clips))


def test_symbolic_batch_serves_batch_one_after_a_trace_at_two(dev, tmp_path):
    enc = vit_large(img_size=(256, 256), num_frames=16, use_rope=True, use_flash=True,
                    dtype=torch.bfloat16, device=dev)
    enc.reset_parameters(torch.Generator(dev).manual_seed(1))
    export.export_encoder(enc, str(tmp_path), batch="B")
    fn, meta = export.load_encoder(str(tmp_path))
    assert meta["batch"] == "B"
    for batch in (1, 3):
        clips = _clips(dev, batch)
        got, launched = _counted(fn, clips)
        assert launched == {"b1": 24, "b3": 0, "b7": 0, "b8": 0}
        assert got.shape == (batch, 2048, 1024)
        with torch.inference_mode():
            assert torch.equal(got, enc(clips))
