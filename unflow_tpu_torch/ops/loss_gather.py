"""The fused unsupervised loss's arithmetic, in plain PyTorch, in the order
of its CUDA kernels (``csrc/loss.cu``).

The kernels compute ``losses/unsupervised.py::unsupervised_loss`` for the
terms ``occ``, ``fb``, ``ternary``, ``photo`` and ``smooth_2nd`` with
forward-backward occlusion masking, without its intermediate tensors:

  * per pixel and direction (``loss_pixel``): the bilinear backward warp of
    the other frame and of the opposite flow (each tap clamped to the frame),
    the occlusion test, the outgoing and border masks, the pointwise terms
    (``occ``, ``fb``, ``photo``), the grey level of the pixel's own frame and
    of the warped frame;
  * per pixel and direction over its neighbourhood (``loss_stencil``): the
    census distance at the level's patch radius (patch values past the frame
    are zero, as ``F.unfold`` pads them) and the second-order smoothness
    stencils anchored at the pixel;
  * the per-term sums over the full element counts, weighted into each
    scale's terms and the total (``loss_finish``);
  * the backward (``loss_grad``), per pixel: the census gradient gathered
    from every patch the pixel is in (as its centre and as a neighbour), the
    smoothness gradient from every stencil it is in, the pointwise terms',
    all taken through the warp's sampling position to the pixel's own flow,
    and the gradient to the warped opposite flow scattered to its four taps.

The masks are comparisons and take no gradient; the images take none. This
module states each of those steps with whole-tensor ops, shifted copies
standing for the neighbourhood loops, so that the kernels' index arithmetic
and hand-derived gradient are checked on the CPU (in float64, against
autograd of the composite terms: ``tests/test_torch_loss_gather.py``).
Nothing on the main path calls it.

Values come out as one vector: ``values[5 * level + term]`` for the terms
in :data:`TERMS` order (0 for an inactive term), the weighted total last.
"""

from __future__ import annotations

from typing import Sequence

import torch

from unflow_tpu_torch.ops.cuda.loss import TERMS, border_distance
from unflow_tpu_torch.ops.downsample import downsample

GRAY = (0.2989, 0.5870, 0.1140)
ALPHA = 0.45
EPS2 = 0.001**2


def charbonnier(x):
    return torch.pow(x * x + EPS2, ALPHA)


def charbonnier_grad(x):
    return 2.0 * ALPHA * x * torch.pow(x * x + EPS2, ALPHA - 1.0)


def census_tau(x):
    """The normalized census difference ``x / sqrt(0.81 + x^2)``."""
    return x / torch.sqrt(0.81 + x * x)


def census_tau_grad(x):
    return 0.81 / torch.pow(0.81 + x * x, 1.5)


def hamming(z):
    z2 = z * z
    return z2 / (0.1 + z2)


def hamming_grad(z):
    return 0.2 * z / (0.1 + z * z) ** 2


def _inside(h: int, w: int, d: int, device) -> torch.Tensor:
    """1 away from the border, 0 within ``d`` px of it: ``(h, w)``."""
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)
    return ((y >= d) & (y < h - d) & (x >= d) & (x < w - d))


def shifted(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y + dy, x + dx]``, zero past the frame."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def _gray(im: torch.Tensor) -> torch.Tensor:
    return (GRAY[0] * im[:, 0] + GRAY[1] * im[:, 1] + GRAY[2] * im[:, 2]) * 255.0


def _sample(field: torch.Tensor, flow_px: torch.Tensor):
    """The bilinear backward warp of ``field`` ``(B, C, h, w)`` by
    ``flow_px``, the derivatives of each warped value to the sampling
    position's x and y, and the four taps' flat indices and weights."""
    b, c, h, w = field.shape
    x = torch.arange(w, dtype=flow_px.dtype, device=flow_px.device) + flow_px[:, 0]
    y = torch.arange(h, dtype=flow_px.dtype, device=flow_px.device)[:, None] + flow_px[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    flat = field.reshape(b, c, h * w)
    taps = []
    for iy in (y0, y0 + 1):
        for ix in (x0, x0 + 1):
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long().reshape(b, 1, h * w)
            taps.append((idx, torch.gather(flat, 2, idx.expand(b, c, h * w)).reshape(b, c, h, w)))
    (i00, t00), (i01, t01), (i10, t10), (i11, t11) = taps
    top = t00 * (1.0 - wx) + t01 * wx
    bot = t10 * (1.0 - wx) + t11 * wx
    value = top * (1.0 - wy) + bot * wy
    d_x = (t01 - t00) * (1.0 - wy) + (t11 - t10) * wy
    d_y = bot - top
    weights = ((1.0 - wx) * (1.0 - wy), wx * (1.0 - wy), (1.0 - wx) * wy, wx * wy)
    return value, d_x, d_y, list(zip((i00, i01, i10, i11), weights))


def _outgoing(flow_px: torch.Tensor) -> torch.Tensor:
    """``create_outgoing_mask``: the target inside the frame, in float32
    coordinates whatever the flow's dtype."""
    h, w = flow_px.shape[-2:]
    x = torch.arange(w, dtype=torch.float32, device=flow_px.device) + flow_px[:, 0].float()
    y = torch.arange(h, dtype=torch.float32, device=flow_px.device)[:, None] + flow_px[:, 1].float()
    return (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)


def _offsets(radius: int):
    return [(ky, kx) for ky in range(-radius, radius + 1) for kx in range(-radius, radius + 1)]


def _pixel(own, other, flow, opposite, scale: float, border: int):
    """``loss_pixel`` for one direction: the warped fields, the difference
    to the warped opposite flow, the mask and the grey levels."""
    f = flow * scale
    warped, d_x, d_y, taps = _sample(torch.cat([other, opposite * scale], 1), f)
    other_w, opp_w = warped[:, :3], warped[:, 3:]
    diff = f + opp_w
    mag = f.square().sum(1) + opp_w.square().sum(1)
    occ = (diff.square().sum(1) > 0.01 * mag + 0.5).to(f.dtype)
    h, w = f.shape[-2:]
    mask = _outgoing(f) & _inside(h, w, border, f.device)
    mask = mask.to(f.dtype) * (1.0 - occ)
    return dict(f=f, other_w=other_w, diff=diff, occ=occ, mask=mask, d_x=d_x, d_y=d_y,
                taps=taps, g1=_gray(own), g2=_gray(other_w))


def _census(p: dict, radius: int):
    """The soft Hamming distance of each pixel's census patches; per offset
    the centre differences ``x1`` (own frame) and ``x2`` (warped frame)."""
    g1, g2 = p["g1"], p["g2"]
    dist = torch.zeros_like(g1)
    parts = []
    for ky, kx in _offsets(radius):
        x1 = shifted(g1, ky, kx) - g1
        x2 = shifted(g2, ky, kx) - g2
        z = census_tau(x1) - census_tau(x2)
        dist = dist + hamming(z)
        parts.append((ky, kx, x2, z))
    return dist, parts


def _stencils(f: torch.Tensor):
    """The four second-order stencils anchored at each pixel, each with the
    mask of its valid anchors and its offsets (+1, -2, +1)."""
    h, w = f.shape[-2:]
    out = []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        s = shifted(f, dy, dx) - 2.0 * f + shifted(f, -dy, -dx)
        valid = _inside(h, w, 0, f.device)
        y = torch.arange(h, device=f.device)[:, None]
        x = torch.arange(w, device=f.device)
        if dy:
            valid = valid & (y >= 1) & (y <= h - 2)
        if dx:
            valid = valid & (x >= 1) & (x <= w - 2)
        count = f.shape[0] * 2 * (h - 2 * abs(dy)) * (w - 2 * abs(dx))
        out.append((dy, dx, s, valid.to(f.dtype), max(count, 1)))
    return out


def _level_sums(own, other, flow, opposite, scale, radius, border):
    """One direction's sums of each term at one level, unnormalized but for
    the smoothness (the mean of each of its four stencils, halved)."""
    p = _pixel(own, other, flow, opposite, scale, border)
    h, w = flow.shape[-2:]
    dist, _ = _census(p, radius)
    census_border = _inside(h, w, border_distance(h, w, radius), flow.device).to(flow.dtype)
    smooth = sum((charbonnier(s) * valid).sum() / count for _, _, s, valid, count in _stencils(p["f"]))
    return {
        "occ": charbonnier(p["occ"]).sum(),
        "fb": (charbonnier(p["diff"]) * p["mask"][:, None]).sum(),
        "ternary": (charbonnier(dist) * p["mask"] * census_border).sum(),
        "photo": (charbonnier(255.0 * (own - p["other_w"])) * p["mask"][:, None]).sum(),
        "smooth_2nd": smooth / 2.0,
    }


def _counts(b: int, h: int, w: int) -> dict:
    n = b * h * w
    return {"occ": n, "fb": 2 * n, "ternary": n, "photo": 3 * n, "smooth_2nd": 1}


def pyramid(im: torch.Tensor, levels: int) -> list:
    """The loss's image pyramid: 1/4 resolution, then halved."""
    out = [downsample(im, 4)]
    for _ in range(levels - 1):
        out.append(downsample(out[-1], 2))
    return out


def fused_forward(
    im1: torch.Tensor, im2: torch.Tensor, flows_fw: Sequence[torch.Tensor],
    flows_bw: Sequence[torch.Tensor], term_weights: Sequence[float],
    layer_weights: Sequence[float], scales: Sequence[float], radii: Sequence[int],
    borders: Sequence[int],
) -> torch.Tensor:
    """The loss's values vector. ``term_weights`` in :data:`TERMS` order (0:
    inactive); per level the layer weight, the flow's scale to pixels, the
    census radius and the border mask's distance (0: none)."""
    levels = len(flows_fw)
    values = torch.zeros(5 * levels + 1, dtype=flows_fw[0].dtype, device=flows_fw[0].device)
    ims1, ims2 = pyramid(im1, levels), pyramid(im2, levels)
    total = values[-1]
    for i in range(levels):
        b, _, h, w = flows_fw[i].shape
        args = (scales[i], radii[i], borders[i])
        fw = _level_sums(ims1[i], ims2[i], flows_fw[i], flows_bw[i], *args)
        bw = _level_sums(ims2[i], ims1[i], flows_bw[i], flows_fw[i], *args)
        counts = _counts(b, h, w)
        scale_total = 0.0
        for t, key in enumerate(TERMS):
            if term_weights[t]:
                values[5 * i + t] = (fw[key] + bw[key]) / counts[key]
                scale_total = scale_total + term_weights[t] * values[5 * i + t]
        total = total + layer_weights[i] * scale_total
    values[-1] = total
    return values


def _level_grad(own, other, flow, opposite, scale, radius, border, coef):
    """One direction's gradient at one level: to the pixel's own flow (in
    pixels, gathered), and to the opposite flow (in pixels, scattered to the
    warp's taps). ``coef``: the loss's derivative to each term's value."""
    b, _, h, w = flow.shape
    counts = _counts(b, h, w)
    p = _pixel(own, other, flow, opposite, scale, border)
    mask = p["mask"][:, None]
    g_f = torch.zeros_like(p["f"])
    # fb: to the flow directly and to the warped opposite flow
    g_diff = coef[1] * mask * charbonnier_grad(p["diff"]) / counts["fb"]
    g_f = g_f + g_diff
    g_other = torch.zeros_like(own)
    # photo: to the warped frame
    g_other = g_other - coef[3] * mask * 255.0 * charbonnier_grad(255.0 * (own - p["other_w"])) / counts["photo"]
    # census: to the warped frame's grey level, gathered over the patches
    # the pixel is in: as the centre (every offset k), and as the neighbour
    # at offset -k of the patch anchored at pixel + k (where that anchor is
    # in the frame). The two see the same differences with the sign flipped,
    # and tau and the Hamming derivative are odd, tau's derivative even, so
    # one term per offset serves both
    dist, parts = _census(p, radius)
    census_border = _inside(h, w, border_distance(h, w, radius), flow.device).to(flow.dtype)
    anchor = coef[2] * charbonnier_grad(dist) * p["mask"] * census_border / counts["ternary"]
    g_g2 = torch.zeros_like(dist)
    for ky, kx, x2, z in parts:
        g_g2 = g_g2 + (anchor + shifted(anchor, ky, kx)) * hamming_grad(z) * census_tau_grad(x2)
    g_other = g_other + 255.0 * torch.stack([c * g_g2 for c in GRAY], 1)
    # through the sampling position to the pixel's own flow
    g_warped = torch.cat([g_other, g_diff], 1)
    g_f = g_f + torch.stack([(g_warped * p["d_x"]).sum(1), (g_warped * p["d_y"]).sum(1)], 1)
    # smoothness: from every stencil the pixel is in
    for dy, dx, s, valid, count in _stencils(p["f"]):
        g_s = coef[4] / 2.0 * charbonnier_grad(s) * valid[None] / count
        g_f = g_f + shifted(g_s, -dy, -dx) - 2.0 * g_s + shifted(g_s, dy, dx)
    # the warped opposite flow: scattered to its taps
    g_opp = torch.zeros(b, 2, h * w, dtype=flow.dtype, device=flow.device)
    for idx, weight in p["taps"]:
        g_opp.scatter_add_(2, idx.expand(b, 2, h * w), (g_diff * weight).reshape(b, 2, h * w))
    return g_f * scale, g_opp.reshape(b, 2, h, w) * scale


def fused_backward(
    im1: torch.Tensor, im2: torch.Tensor, flows_fw: Sequence[torch.Tensor],
    flows_bw: Sequence[torch.Tensor], term_weights: Sequence[float],
    layer_weights: Sequence[float], scales: Sequence[float], radii: Sequence[int],
    borders: Sequence[int], grad_values: torch.Tensor,
) -> tuple[list, list]:
    """The gradients to both flow pyramids (in the flows' own units) of a
    loss whose gradient to :func:`fused_forward`'s values is
    ``grad_values``; the values are recomputed from the inputs."""
    levels = len(flows_fw)
    ims1, ims2 = pyramid(im1, levels), pyramid(im2, levels)
    grads_fw, grads_bw = [], []
    for i in range(levels):
        coef = [grad_values[5 * i + t] + grad_values[-1] * layer_weights[i] * term_weights[t]
                if term_weights[t] else 0.0 for t in range(len(TERMS))]
        args = (scales[i], radii[i], borders[i], coef)
        own_fw, opp_bw = _level_grad(ims1[i], ims2[i], flows_fw[i], flows_bw[i], *args)
        own_bw, opp_fw = _level_grad(ims2[i], ims1[i], flows_bw[i], flows_fw[i], *args)
        grads_fw.append(own_fw + opp_fw)
        grads_bw.append(own_bw + opp_bw)
    return grads_fw, grads_bw
