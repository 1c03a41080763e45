"""`models.resize.resize`, the port's counterpart of `jax.image.resize`,
against JAX's on numpy-seeded tables: trilinear and bicubic, growing and
shrinking (JAX antialiases when it shrinks), integer and non-integer
ratios, at the sincos tables' shapes (the video table [T', H', W', D] and
the image table [H', W', D] of ViT-L at 224 px and of small grids), and a
ramp on which `torch.nn.functional.interpolate` gives other numbers (a =
-0.75 in its cubic kernel against Keys' -0.5, no antialias).

Tolerance: fp32; both sides sum a few taps a row in fp32 in another order:
atol 1e-5, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vjepa2_tpu_torch.models.resize import resize, weight_matrix

ATOL = RTOL = 1e-5


@pytest.mark.parametrize("shape,out,method", [
    ((8, 14, 14, 64), (8, 16, 16, 64), "trilinear"),     # ViT-L 16f@224 fed 256 px
    ((8, 16, 16, 32), (4, 16, 16, 32), "trilinear"),     # a shorter clip, shrunk in time
    ((8, 16, 16, 16), (5, 23, 10, 16), "trilinear"),     # non-integer ratios, both ways
    ((2, 4, 4, 8), (3, 6, 6, 8), "trilinear"),
    ((14, 14, 64), (16, 16, 64), "bicubic"),             # ViT-L/16 at 224 fed 256 px
    ((14, 14, 32), (9, 11, 32), "bicubic"),              # shrinking, non-integer
    ((14, 14, 32), (28, 21, 32), "bicubic"),             # growing 2x and 1.5x
    ((4, 4, 8), (7, 3, 8), "bicubic"),
    ((16, 16, 24), (16, 12, 24), "linear"),              # one axis left as it is
])
def test_resize_matches_jax(shape, out, method):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize(torch.from_numpy(x), out, method)
    assert got.dtype == torch.float32 and tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_ramp_is_jax_not_interpolate():
    """On a 4 x 4 ramp: JAX's bicubic row 0 at 6 x 6 and its antialiased
    2 x 2 linear shrink, which `F.interpolate` does not give."""
    ramp = np.arange(16, dtype=np.float32).reshape(4, 4)
    t = torch.from_numpy(ramp)
    up = resize(t, (6, 6), "bicubic")
    np.testing.assert_allclose(up.numpy(), np.asarray(jax.image.resize(ramp, (6, 6), "bicubic")),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(up[0, :3].numpy(), [-0.32894605, 0.14860788, 0.9035097],
                               atol=ATOL)
    down = resize(t, (2, 2), "linear")
    np.testing.assert_allclose(down.numpy(), [[3.5714288, 5.1428576], [9.857143, 11.428572]],
                               atol=ATOL)
    torch_up = F.interpolate(t[None, None], size=(6, 6), mode="bicubic", align_corners=False)
    torch_down = F.interpolate(t[None, None], size=(2, 2), mode="bilinear", align_corners=False)
    assert (torch_up[0, 0] - up).abs().max() > 0.05
    assert (torch_down[0, 0] - down).abs().max() > 0.5


@pytest.mark.parametrize("m,n", [(14, 16), (16, 14), (8, 5), (4, 7)])
def test_weight_columns_sum_to_one(m, n):
    """Each output takes a convex-weighted (linear) or normalised (cubic)
    sum of the taps there are: every column sums to 1."""
    for method in ("linear", "bicubic"):
        w = weight_matrix(m, n, method)
        assert w.shape == (m, n)
        np.testing.assert_allclose(w.sum(0).numpy(), np.ones(n), atol=1e-6)


def test_resize_refuses_what_it_does_not_know():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="method"):
        resize(x, (2, 2), "lanczos3")
    with pytest.raises(ValueError, match="dims"):
        resize(x, (2, 2, 1), "linear")
