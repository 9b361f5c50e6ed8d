"""Average downsampling and bilinear resizing of dense fields, in NCHW.

Port of ``unflow_tpu/ops/downsample.py``; the JAX functions take
``(B, H, W, C)``, these take ``(B, C, H, W)``. ``jax.image.resize(method=
"bilinear")`` samples at half-pixel centers and renormalizes its triangle
kernel at the borders, which for upsampling is ``F.interpolate(mode=
"bilinear", align_corners=False)``.

The average pooling is local to a W-slab when the slabs are aligned (as
W-sharding requires); the resize takes a halo (``resize_bilinear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unflow_tpu_torch.parallel import spatial


def downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool ``(B, C, H, W)`` by an integer factor (H, W divisible).

    Sums in float32 whatever the dtype: summing ``factor**2`` bfloat16
    values before the divide would compound rounding over successive
    pyramid levels.
    """
    if factor == 1:
        return x
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        raise ValueError(f"shape {(h, w)} not divisible by factor {factor}")
    acc = x.dtype if x.dtype == torch.float64 else torch.float32
    return F.avg_pool2d(x.to(acc), factor).to(x.dtype)


def downsample_flow(flow: torch.Tensor, factor: int, rescale: bool = False) -> torch.Tensor:
    """Average-downsample a flow field ``(B, 2, H, W)``; ``rescale`` divides
    the vectors by the factor (the coarse level's pixel units)."""
    out = downsample(flow, factor)
    if rescale and factor != 1:
        out = out / factor
    return out


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``(B, C, H, W)`` -> ``(B, C, height, width)``, computed in float32.

    Inside a ``SpatialContext`` ``x`` is a W-slab and ``width`` the slab's
    output width, an integer multiple ``k`` of its own: a sample at
    half-pixel centres reads at most one coarse column past the slab, so the
    slab takes one neighbour column on each side (the edge column repeated
    past the frame, the clamp of the unsharded sample), is resized to ``k``
    times that width and cropped to its own columns."""
    if spatial.current() is None:
        return F.interpolate(
            x.float(), size=(height, width), mode="bilinear", align_corners=False
        )
    w = x.shape[-1]
    k = width // w
    if k * w != width:
        raise ValueError(f"a W-slab resizes by an integer factor only: {w} -> {width}")
    ext = spatial.halo_exchange(x.float(), 1, 1, edge="replicate")
    out = F.interpolate(ext, size=(height, k * (w + 2)), mode="bilinear", align_corners=False)
    return out[..., k : k + width]


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling at half-pixel centers, in the dtype of ``x``."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, 2 * h, 2 * w).to(x.dtype)
