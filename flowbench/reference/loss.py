"""UnFlow's unsupervised bidirectional loss, written plainly from the paper.

Meister, Hur & Roth, "UnFlow" (AAAI 2018), Sections 3.2-3.4: at each of the
five scales, a census (ternary) data term with a soft Hamming distance,
second-order smoothness, forward-backward consistency and a constant
penalty on pixels marked occluded; pixels whose forward-backward mismatch
exceeds ``0.01 * (|f_fw|^2 + |f_bw∘w|^2) + 0.5`` are occluded and leave the
data terms, as do pixels whose flow leaves the frame. Each term is a
generalized Charbonnier ``((x * beta)^2 + 0.001^2)^0.45`` averaged over all
elements. The images are ``(B, 3, H, W)`` in [0, 1], average-pooled to each
scale; the flows are the network's, in quarter-resolution pixels over
``FLOW_SCALE``. Everything is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flowbench.reference.flownet import FLOW_SCALE, backward_warp

LAYER_WEIGHTS = (12.7, 4.35, 3.9, 3.4, 1.1)
PATCH_DISTANCES = (3, 2, 2, 1, 1)
TERMS = ("occ", "sym", "fb", "grad", "ternary", "photo", "smooth_1st", "smooth_2nd")


def charbonnier(x, mask=None, beta: float = 1.0, count: int | None = None):
    err = ((x * beta) ** 2 + 0.001 ** 2) ** 0.45
    if mask is not None:
        err = err * mask
    return err.sum() / max(count if count is not None else err.numel(), 1)


def length_sq(x):
    return (x ** 2).sum(1, keepdim=True)


def outgoing_mask(flow):
    h, w = flow.shape[-2:]
    x = torch.arange(w, device=flow.device, dtype=torch.float32) + flow[:, 0]
    y = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None] + flow[:, 1]
    return ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))[:, None].float()


def border_mask(shape, distance: int, device):
    b, _, h, w = shape
    distance = min(distance, (min(h, w) - 1) // 2)
    m = torch.zeros((h, w), device=device)
    m[distance:h - distance, distance:w - distance] = 1.0
    return m.expand(b, 1, h, w)


def census(im, radius: int):
    gray = (0.2989 * im[:, 0:1] + 0.5870 * im[:, 1:2] + 0.1140 * im[:, 2:3]) * 255.0
    b, _, h, w = gray.shape
    k = 2 * radius + 1
    diff = F.unfold(gray, k, padding=radius).reshape(b, k * k, h, w) - gray
    return diff / torch.sqrt(0.81 + diff ** 2)


def ternary(im1, im2_warped, mask, radius: int):
    sq = (census(im1, radius) - census(im2_warped, radius)) ** 2
    dist = (sq / (0.1 + sq)).sum(1, keepdim=True)
    return charbonnier(dist, mask * border_mask(im1.shape, radius, im1.device))


def image_grad_loss(im1, im2_warped, mask):
    dx = lambda x: x[..., 1:] - x[..., :-1]  # noqa: E731
    dy = lambda x: x[..., 1:, :] - x[..., :-1, :]  # noqa: E731
    return (charbonnier(dx(im1) - dx(im2_warped), mask[..., 1:], beta=255.0)
            + charbonnier(dy(im1) - dy(im2_warped), mask[..., 1:, :], beta=255.0))


def first_order(flow):
    return charbonnier(flow[..., 1:] - flow[..., :-1]) + charbonnier(flow[..., 1:, :] - flow[..., :-1, :])


def second_order(flow):
    f = flow
    h = f[..., 2:] - 2 * f[..., 1:-1] + f[..., :-2]
    v = f[..., 2:, :] - 2 * f[..., 1:-1, :] + f[..., :-2, :]
    d1 = f[..., 2:, 2:] - 2 * f[..., 1:-1, 1:-1] + f[..., :-2, :-2]
    d2 = f[..., 2:, :-2] - 2 * f[..., 1:-1, 1:-1] + f[..., :-2, 2:]
    return (charbonnier(h) + charbonnier(v) + charbonnier(d1) + charbonnier(d2)) / 2.0


def scale_terms(im1, im2, flow_fw, flow_bw, weights, radius: int, mask_occlusion: str):
    """The terms of one scale whose weight is not zero."""
    warped_fw = backward_warp(torch.cat([im2, flow_bw], 1), flow_fw)
    warped_bw = backward_warp(torch.cat([im1, flow_fw], 1), flow_bw)
    im2_w, flow_bw_w = warped_fw[:, :3], warped_fw[:, 3:]
    im1_w, flow_fw_w = warped_bw[:, :3], warped_bw[:, 3:]
    diff_fw, diff_bw = flow_fw + flow_bw_w, flow_bw + flow_fw_w
    occ_fw = (length_sq(diff_fw) > 0.01 * (length_sq(flow_fw) + length_sq(flow_bw_w)) + 0.5).float()
    occ_bw = (length_sq(diff_bw) > 0.01 * (length_sq(flow_bw) + length_sq(flow_fw_w)) + 0.5).float()
    mask_fw, mask_bw = outgoing_mask(flow_fw), outgoing_mask(flow_bw)
    if mask_occlusion == "fb":
        mask_fw, mask_bw = mask_fw * (1 - occ_fw), mask_bw * (1 - occ_bw)
    elif mask_occlusion not in ("", "none"):
        raise NotImplementedError(f"mask_occlusion {mask_occlusion!r}")
    terms = {
        "occ": lambda: charbonnier(occ_fw) + charbonnier(occ_bw),
        "sym": lambda: charbonnier(occ_fw - occ_bw),
        "fb": lambda: charbonnier(diff_fw, mask_fw) + charbonnier(diff_bw, mask_bw),
        "grad": lambda: image_grad_loss(im1, im2_w, mask_fw) + image_grad_loss(im2, im1_w, mask_bw),
        "ternary": lambda: ternary(im1, im2_w, mask_fw, radius) + ternary(im2, im1_w, mask_bw, radius),
        "photo": lambda: (charbonnier(im1 - im2_w, mask_fw, beta=255.0)
                          + charbonnier(im2 - im1_w, mask_bw, beta=255.0)),
        "smooth_1st": lambda: first_order(flow_fw) + first_order(flow_bw),
        "smooth_2nd": lambda: second_order(flow_fw) + second_order(flow_bw),
    }
    return {k: fn() for k, fn in terms.items() if weights.get(k, 0.0)}


def unsupervised_loss(im1, im2, flows_fw, flows_bw, weights: dict, mask_occlusion: str = "fb"):
    """Weighted sum over the five scales (finest first) of the weighted terms."""
    unknown = set(weights) - set(TERMS)
    if unknown:
        raise NotImplementedError(f"loss terms {sorted(unknown)}")
    total = torch.zeros((), device=im1.device)
    for i, (ffw, fbw) in enumerate(zip(flows_fw, flows_bw)):
        factor = 4 if i == 0 else 2
        im1 = F.avg_pool2d(im1, factor)
        im2 = F.avg_pool2d(im2, factor)
        scale = FLOW_SCALE / 2 ** i
        terms = scale_terms(im1, im2, ffw * scale, fbw * scale, weights, PATCH_DISTANCES[i],
                            mask_occlusion)
        total = total + LAYER_WEIGHTS[i] * sum(weights[k] * v for k, v in terms.items())
    return total
