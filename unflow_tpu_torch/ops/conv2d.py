"""SAME convolution with TF/XLA padding, in NCHW.

Port of the forward of ``unflow_tpu/ops/conv2d.py``. XLA's SAME padding of a
strided convolution puts the extra pixel on the high side; ``nn.Conv2d``'s
``padding=`` is symmetric and would shift the sampling grid of every
stride-2 layer by a pixel, so the asymmetric case pads explicitly. The JAX
package's phase-decomposed data gradient (``conv_impl=phase``) works around
an XLA lowering on the TPU and has no counterpart here.

Inside a :class:`~unflow_tpu_torch.parallel.spatial.SpatialContext` (W-sharding)
the W pads are those of the global width, taken as a halo of the neighbours'
columns (zeros at the global edges); H is padded as without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unflow_tpu_torch.parallel import spatial


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(pad_lo, pad_hi) of a SAME convolution along one dim (TF/XLA rule)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    lo = total // 2
    return lo, total - lo


def conv2d_same(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int = 1
) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` for NCHW/OIHW."""
    kh, kw = weight.shape[-2:]
    top, bottom = same_pads(x.shape[-2], kh, stride)
    left, right = same_pads(spatial.global_width(x.shape[-1]), kw, stride)
    if spatial.current() is not None:
        x = spatial.halo_exchange(x, left, right)
        left = right = 0
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride)


class Conv2dSame(nn.Conv2d):
    """``flax.linen.Conv(features, (k, k), strides=(s, s), padding="SAME")``,
    built as ``Conv2dSame(in_channels, features, k, s)``; its own
    ``padding`` stays 0.

    Runs in the input's dtype: float32 parameters are cast at each use, as
    flax casts them to ``dtype``.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride[0])
