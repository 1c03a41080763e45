"""The port's mask sampling and token gathers against the JAX package:
`masks.multiblock3d.MaskCollator` (a numpy copy) yields identical arrays for
the same config, seed and steps, and `ops.masking.apply_masks` gathers the
same tokens, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vjepa2_tpu.masks.multiblock3d import MaskCollator as JaxCollator
from vjepa2_tpu.ops.masking import apply_masks as jax_apply_masks
from vjepa2_tpu_torch.masks.multiblock3d import MaskCollator
from vjepa2_tpu_torch.ops.masking import apply_masks

# the two mask configs of the pretrain headline (`bench.py:56-61`)
MASK_CFGS = [
    {"spatial_scale": (0.15, 0.15), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 8},
    {"spatial_scale": (0.7, 0.7), "temporal_scale": (1.0, 1.0),
     "aspect_ratio": (0.75, 1.5), "num_blocks": 2},
]


@pytest.mark.parametrize("fpcs,size,seed", [((16,), 256, 0), ((4, 8), 64, 3)])
def test_collator_matches_jax(fpcs, size, seed):
    ours = MaskCollator(MASK_CFGS, dataset_fpcs=fpcs, crop_size=(size, size), seed=seed)
    ref = JaxCollator(MASK_CFGS, dataset_fpcs=fpcs, crop_size=(size, size), seed=seed)
    for _ in range(3):
        ours.step()
        ref.step()
        for fpc in fpcs:
            for got, want in zip(ours(fpc, 4), ref(fpc, 4)):
                assert len(got) == len(want) == len(MASK_CFGS)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype == np.int32
                    np.testing.assert_array_equal(g, w)


def test_apply_masks_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 40, 5).astype(np.float32)
    masks = [np.stack([rng.permutation(40)[:k] for _ in range(3)]).astype(np.int32)
             for k in (7, 7, 12)]
    # stacked along batch (masks of one length), and as a list
    for ms, axis in ((masks[:2], 0), (masks, None)):
        want = jax_apply_masks(jnp.asarray(x), [jnp.asarray(m) for m in ms], concat_axis=axis)
        got = apply_masks(torch.from_numpy(x), [torch.from_numpy(m) for m in ms],
                          concat_axis=axis)
        if axis is None:
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert got.shape == (6, 7, 5)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
