"""Loss primitives: charbonnier, census/ternary, smoothness, masks, in NCHW.

Port of ``unflow_tpu/losses/terms.py``. The JAX functions take
``(B, H, W, C)`` fields; these take ``(B, C, H, W)``, so "along W" is the
last axis and the channel axis is 1. Constants as in the reference: census
normalization 0.81, soft-hamming 0.1, charbonnier alpha 0.45 / beta 1.0 /
eps 0.001.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# a pixel on which less splat mass than this lands is disoccluded
DISOCC_THRESH = 0.8


def length_sq(x: torch.Tensor) -> torch.Tensor:
    return x.square().sum(dim=1, keepdim=True)


def charbonnier_loss(
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    truncate: float | None = None,
    alpha: float = 0.45,
    beta: float = 1.0,
    epsilon: float = 0.001,
) -> torch.Tensor:
    """Generalized charbonnier: sum of ``((x*beta)^2 + eps^2)^alpha`` over the
    **full** element count, whatever the mask."""
    error = torch.pow((x * beta).square() + epsilon**2, alpha)
    if mask is not None:
        error = error * mask
    if truncate is not None:
        error = error.clamp(max=truncate)
    # max(size, 1): a 1-pixel pyramid level gives empty stencil slices;
    # their loss is 0, not NaN.
    return error.sum() / max(error.numel(), 1)


def create_outgoing_mask(flow: torch.Tensor) -> torch.Tensor:
    """1.0 where the flow target stays inside the frame, else 0.0:
    ``(B, 2, H, W)`` -> ``(B, 1, H, W)``. Coordinates are float32 whatever
    the flow's dtype."""
    h, w = flow.shape[-2:]
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)
    gy = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    x = gx + flow[:, 0].float()
    y = gy + flow[:, 1].float()
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return inside[:, None].to(flow.dtype)


def create_border_mask(
    shape, distance: int, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """``(B, 1, H, W)`` for an NCHW ``shape``: 1.0 away from the border, 0.0
    within ``distance`` px of it. The distance is clamped so that the mask
    never comes out empty on a small pyramid level."""
    b, h, w = shape[0], shape[-2], shape[-1]
    distance = min(distance, (min(h, w) - 1) // 2)
    m = torch.zeros((h, w), dtype=dtype, device=device)
    m[distance : h - distance, distance : w - distance] = 1.0
    return m.expand(b, 1, h, w)


def _to_grayscale(im: torch.Tensor) -> torch.Tensor:
    """RGB -> luminance scaled to [0, 255]."""
    if im.shape[1] == 3:
        gray = 0.2989 * im[:, 0:1] + 0.5870 * im[:, 1:2] + 0.1140 * im[:, 2:3]
    else:
        gray = im.mean(dim=1, keepdim=True)
    return gray * 255.0


def _extract_patches(x: torch.Tensor, radius: int) -> torch.Tensor:
    """``(B, 1, H, W)`` -> ``(B, (2r+1)^2, H, W)`` neighborhood values, SAME
    zero padding, ordered (ky, kx) as ``lax.conv_general_dilated_patches``."""
    k = 2 * radius + 1
    b, _, h, w = x.shape
    return F.unfold(x, k, padding=radius).reshape(b, k * k, h, w)


def ternary_transform(im: torch.Tensor, max_distance: int) -> torch.Tensor:
    """Normalized census transform over a (2d+1)^2 patch: per-neighbor
    intensity difference ``d / sqrt(0.81 + d^2)``."""
    gray = _to_grayscale(im)
    diff = _extract_patches(gray, max_distance) - gray
    return diff / torch.sqrt(0.81 + diff.square())


def hamming_distance_soft(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Soft hamming: ``sum_k d_k^2 / (0.1 + d_k^2)`` over the channel axis."""
    sq = (t1 - t2).square()
    return (sq / (0.1 + sq)).sum(dim=1, keepdim=True)


def ternary_loss(
    im1: torch.Tensor, im2_warped: torch.Tensor, mask: torch.Tensor, max_distance: int = 1
) -> torch.Tensor:
    """Census data loss between frame 1 and the warped frame 2. The mask is
    shrunk by ``max_distance`` so every compared patch lies inside the frame."""
    t1 = ternary_transform(im1, max_distance)
    t2 = ternary_transform(im2_warped, max_distance)
    dist = hamming_distance_soft(t1, t2)
    border = create_border_mask(im1.shape, max_distance, im1.dtype, im1.device)
    return charbonnier_loss(dist, mask * border, truncate=None)


def photometric_loss(im_diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return charbonnier_loss(im_diff, mask, beta=255.0)


def _image_grads(im: torch.Tensor):
    gx = im[:, :, :, 1:] - im[:, :, :, :-1]
    gy = im[:, :, 1:, :] - im[:, :, :-1, :]
    return gx, gy


def gradient_loss(im1: torch.Tensor, im2_warped: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Image-gradient data term."""
    g1x, g1y = _image_grads(im1)
    g2x, g2y = _image_grads(im2_warped)
    lx = charbonnier_loss(g1x - g2x, mask[:, :, :, 1:], beta=255.0)
    ly = charbonnier_loss(g1y - g2y, mask[:, :, 1:, :], beta=255.0)
    return lx + ly


def smoothness_loss(flow: torch.Tensor) -> torch.Tensor:
    """First-order flow smoothness: the two directional charbonnier means are
    **summed**, as the reference's weights assume."""
    dx = flow[:, :, :, 1:] - flow[:, :, :, :-1]
    dy = flow[:, :, 1:, :] - flow[:, :, :-1, :]
    return charbonnier_loss(dx) + charbonnier_loss(dy)


def second_order_loss(flow: torch.Tensor) -> torch.Tensor:
    """Second-order smoothness: 3-point stencils along W, along H and along
    both diagonals; the sum of the four stencil means, halved."""
    h = flow[:, :, :, 2:] - 2.0 * flow[:, :, :, 1:-1] + flow[:, :, :, :-2]
    v = flow[:, :, 2:, :] - 2.0 * flow[:, :, 1:-1, :] + flow[:, :, :-2, :]
    d1 = flow[:, :, 2:, 2:] - 2.0 * flow[:, :, 1:-1, 1:-1] + flow[:, :, :-2, :-2]
    d2 = flow[:, :, 2:, :-2] - 2.0 * flow[:, :, 1:-1, 1:-1] + flow[:, :, :-2, 2:]
    return (
        charbonnier_loss(h) + charbonnier_loss(v) + charbonnier_loss(d1) + charbonnier_loss(d2)
    ) / 2.0
