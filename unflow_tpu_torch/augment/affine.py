"""Affine geometric augmentation (rotation, zoom, translation) on the device.

Port of ``unflow_tpu/augment/affine.py``: one *global* affine transform
shared by the frame pair plus a small *relative* transform of frame 2 only
(so the pair's apparent motion changes), with ground-truth flow remapped for
supervised training. Images keep the layout of ``augment/__init__.py``,
``(B, H, W, C)``. As there, the draws (:func:`sample_affine_params`) are
split from their application (:func:`apply_affine`), so that a test can feed
the JAX function's own draws to the port.

Each output pixel x samples the source at ``W_i(x) = A_i (x - c) + c + t_i``
(c the image center, i the frame). With ground-truth flow f mapping frame-1
points p to p + f(p):

    f'(x) = A2^{-1} (A1 (x - c) + t1 - t2 + f(W1(x))) + c - x

Samples outside the source are zero (images) and invalid (masks).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from unflow_tpu_torch.ops.warp import backward_warp


class AffineParams(NamedTuple):
    """Per-example 2x2 matrices and translations of frames 1 and 2."""

    a1: torch.Tensor  # (B, 2, 2)
    t1: torch.Tensor  # (B, 2)
    a2: torch.Tensor  # (B, 2, 2)
    t2: torch.Tensor  # (B, 2)


def _rot_scale(angle: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(B,)`` angle in radians, ``(B,)`` scale -> ``(B, 2, 2)`` scale x rotation."""
    c = torch.cos(angle) * scale
    s = torch.sin(angle) * scale
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _inv2x2(a: torch.Tensor) -> torch.Tensor:
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv = torch.stack(
        [
            torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
            torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1),
        ],
        -2,
    )
    return inv / det[..., None, None]


def sample_affine_params(
    generator: torch.Generator,
    batch: int,
    hw: tuple[int, int],
    translate: float = 0.0,
    rotate_deg: float = 0.0,
    zoom_min: float = 1.0,
    zoom_max: float = 1.0,
    rel_translate: float = 0.0,
    rel_rotate_deg: float = 0.0,
    rel_zoom: float = 0.0,
) -> AffineParams:
    """Per-example global and relative affine parameters, on the generator's
    device.

    ``translate`` / ``rel_translate`` are fractions of min(H, W); rotations
    in degrees; the zoom log-uniform in [zoom_min, zoom_max], the relative
    zoom log-uniform in [1 - rel_zoom, 1 + rel_zoom]. The matrices map
    output coordinates to source coordinates, so a zoom in by z has scale
    1/z."""
    ext = float(min(hw))
    deg = math.pi / 180.0
    dev = generator.device

    def uniform(shape, low: float, high: float) -> torch.Tensor:
        return low + (high - low) * torch.rand(shape, generator=generator, device=dev)

    ang = uniform((batch,), -rotate_deg * deg, rotate_deg * deg)
    zoom = torch.exp(uniform((batch,), math.log(zoom_min), math.log(zoom_max)))
    t_glob = uniform((batch, 2), -translate * ext, translate * ext)
    d_ang = uniform((batch,), -rel_rotate_deg * deg, rel_rotate_deg * deg)
    d_zoom = torch.exp(
        uniform((batch,), math.log(max(1.0 - rel_zoom, 1e-3)), math.log(1.0 + rel_zoom))
    )
    d_t = uniform((batch, 2), -rel_translate * ext, rel_translate * ext)

    a1 = _rot_scale(ang, 1.0 / zoom)
    a2 = _rot_scale(ang + d_ang, 1.0 / (zoom * d_zoom))
    return AffineParams(a1, t_glob, a2, t_glob + d_t)


def _source_coords(a: torch.Tensor, t: torch.Tensor, hw: tuple[int, int]):
    """Source-coordinate maps ``(xs, ys)``, each ``(B, H, W)``, of
    ``W(x) = A (x - c) + c + t``; (x, y) is (along W, along H), the flow's
    channel order."""
    h, w = hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    gy = torch.arange(h, dtype=torch.float32, device=a.device)[None, :, None] - cy
    gx = torch.arange(w, dtype=torch.float32, device=a.device)[None, None, :] - cx
    xs = a[:, 0, 0, None, None] * gx + a[:, 0, 1, None, None] * gy + cx + t[:, 0, None, None]
    ys = a[:, 1, 0, None, None] * gx + a[:, 1, 1, None, None] * gy + cy + t[:, 1, None, None]
    return xs, ys


def _inside(xs: torch.Tensor, ys: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """``(B, H, W, 1)`` float32: 1 where the source point lies in the frame."""
    h, w = hw
    return ((xs >= 0.0) & (xs <= w - 1.0) & (ys >= 0.0) & (ys <= h - 1.0)).float()[..., None]


def _bilinear_at(im: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample a ``(B, H, W, C)`` field at float coordinates; zero outside the
    frame (the backward warp's edge-clamped taps, masked)."""
    h, w = im.shape[1:3]
    gy = torch.arange(h, dtype=torch.float32, device=im.device)[None, :, None]
    gx = torch.arange(w, dtype=torch.float32, device=im.device)[None, None, :]
    flow = torch.stack([xs - gx, ys - gy], 1)
    out = backward_warp(im.permute(0, 3, 1, 2), flow).permute(0, 2, 3, 1)
    return out * _inside(xs, ys, (h, w)).to(im.dtype)


def apply_affine(
    params: AffineParams,
    ims: Sequence[torch.Tensor],
    flows: Sequence[torch.Tensor] | None = None,
    masks: Sequence[torch.Tensor] | None = None,
):
    """Resample ``[im1, im2]`` ``(B, H, W, C)`` with (A1, t1) / (A2, t2) and
    remap the frame-1 ground truth. Returns ``(ims, flows, masks)``.

    ``masks`` come back None only when neither masks nor flows were given:
    the remapped flow is zero where the pull-back W1(x) leaves the source
    frame, so flows without a mask get the inside-frame mask, and a given
    mask is strict (all four bilinear corners valid) and inside the frame."""
    im1, im2 = ims
    hw = im1.shape[1:3]
    xs1, ys1 = _source_coords(params.a1, params.t1, hw)
    xs2, ys2 = _source_coords(params.a2, params.t2, hw)
    out_ims = [_bilinear_at(im1, xs1, ys1), _bilinear_at(im2, xs2, ys2)]

    inside1 = _inside(xs1, ys1, hw)
    out_flows = out_masks = None
    if flows is not None:
        h, w = hw
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        gy = torch.arange(h, dtype=torch.float32, device=im1.device)[None, :, None]
        gx = torch.arange(w, dtype=torch.float32, device=im1.device)[None, None, :]
        a2_inv = _inv2x2(params.a2)
        out_flows = []
        for f in flows:
            fp = _bilinear_at(f, xs1, ys1)  # f(W1(x)), zero outside
            # q - c - t2 with q = W1(x) + f(W1(x))
            qx = xs1 + fp[..., 0] - cx - params.t2[:, 0, None, None]
            qy = ys1 + fp[..., 1] - cy - params.t2[:, 1, None, None]
            fx = a2_inv[:, 0, 0, None, None] * qx + a2_inv[:, 0, 1, None, None] * qy + cx - gx
            fy = a2_inv[:, 1, 0, None, None] * qx + a2_inv[:, 1, 1, None, None] * qy + cy - gy
            out_flows.append(torch.stack([fx, fy], -1))
    if masks is not None:
        out_masks = [(_bilinear_at(m, xs1, ys1) > 0.999).to(m.dtype) * inside1.to(m.dtype)
                     for m in masks]
    elif out_flows is not None:
        out_masks = [inside1.to(f.dtype) for f in out_flows]
    return out_ims, out_flows, out_masks


def random_affine(
    generator: torch.Generator,
    ims: Sequence[torch.Tensor],
    flows: Sequence[torch.Tensor] | None = None,
    masks: Sequence[torch.Tensor] | None = None,
    **ranges,
):
    """Draw the parameters (:func:`sample_affine_params`) and apply them."""
    b, h, w = ims[0].shape[:3]
    return apply_affine(sample_affine_params(generator, b, (h, w), **ranges), ims, flows, masks)
