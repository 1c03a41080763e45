"""Resizing a table on a grid as `jax.image.resize` resizes it (its
``scale_and_translate``, `jax/_src/image/scale.py`), for the sincos tables of
`vision_transformer.VisionTransformer` fed an input off their grid.

`torch.nn.functional.interpolate` is not that function. Its bicubic kernel
takes a = -0.75 where JAX's Keys kernel takes -0.5, and JAX antialiases when
it shrinks (the kernel widened by the scale) where torch samples. So the
resize is JAX's construction: each resized axis gets a weight matrix
[in, out] from the triangle (``"linear"``, ``"bilinear"``, ``"trilinear"``)
or the Keys cubic kernel (``"cubic"``, ``"bicubic"``, ``"tricubic"``)
evaluated at half-pixel centres, the kernel widened by in / out when
shrinking; each output's column is normalised over the input taps there
are (taps past the edge do not exist), and zeroed where the sample falls
outside the input. The matrices apply axis by axis in fp32; an axis whose
size stays is left alone, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (JAX `_fill_keys_cubic_kernel`)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


KERNELS = {"linear": _triangle, "bilinear": _triangle, "trilinear": _triangle,
           "triangle": _triangle, "cubic": _keys_cubic, "bicubic": _keys_cubic,
           "tricubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool = True,
                  device=None) -> torch.Tensor:
    """[in_size, out_size] fp32: output j = sum_i x[i] * w[i, j] along one axis
    (JAX `compute_weight_mat` at translation 0)."""
    kernel = KERNELS[method]
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else torch.ones_like(inv_scale)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    taps = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - taps[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``x`` resized to ``shape`` (every dim listed; the dims that keep their
    size are left alone) as ``jax.image.resize(x, shape, method, antialias)``
    does, in fp32; the result in fp32."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, x has {x.ndim}")
    if method not in KERNELS:
        raise ValueError(f"resize method {method!r}: expected one of {sorted(KERNELS)}")
    out = x.float()
    for d, n in enumerate(shape):
        m = out.shape[d]
        if n == m:
            continue
        w = weight_matrix(m, n, method, antialias, out.device)
        out = torch.tensordot(out.movedim(d, -1), w, dims=1).movedim(-1, d)
    return out
