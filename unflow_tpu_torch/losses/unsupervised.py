"""Unsupervised bidirectional loss stack (census + smoothness + fb), in NCHW.

Port of ``unflow_tpu/losses/unsupervised.py``. Per-scale weights
[12.7, 4.35, 3.9, 3.4, 1.1] and census patch distances [3, 2, 2, 1, 1].
Occlusion comes from forward-backward consistency: occluded where
``|f_fw + f_bw∘w|^2 > 0.01 * (|f_fw|^2 + |f_bw∘w|^2) + 0.5``; a constant
penalty on the occlusion estimate keeps "mask everything" from being free.
The masks are comparisons, so no gradient passes through them.

Under W-sharding every image, flow and mask here is a W-slab, and every term
this rank's part of the global mean (``losses/terms.py``); the pyramid's
average pooling stays local.

On a GPU the loss of the paper's terms runs as fused CUDA kernels
(``ops/cuda/loss.py``: four launches forward, two backward, over every
scale), chosen by :func:`fused_spec` from what the call sees; everywhere
else, and for any other term or masking, the composite terms below run.

Flow units (see ``models/flownet.py``): every pyramid level predicts flow in
quarter-resolution pixels divided by ``FLOW_SCALE``, so the flow in pixels of
level i (resolution 1/(4*2^i)) is ``pred_i * FLOW_SCALE / 2^i``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from unflow_tpu_torch.losses.terms import (
    DISOCC_THRESH,
    charbonnier_loss,
    create_border_mask,
    create_outgoing_mask,
    gradient_loss,
    length_sq,
    photometric_loss,
    second_order_loss,
    smoothness_loss,
    ternary_loss,
)
from unflow_tpu_torch.models.flownet import FLOW_SCALE
from unflow_tpu_torch.ops.cuda import loss as fused
from unflow_tpu_torch.ops.downsample import downsample
from unflow_tpu_torch.ops.warp import backward_warp, forward_warp
from unflow_tpu_torch.parallel import spatial

LOSS_KEYS = ("occ", "sym", "fb", "grad", "ternary", "photo", "smooth_1st", "smooth_2nd")

LAYER_WEIGHTS = (12.7, 4.35, 3.9, 3.4, 1.1)
LAYER_PATCH_DISTANCES = (3, 2, 2, 1, 1)

# The paper's UnFlow objective: census data term + 2nd-order smoothness +
# fb consistency + occlusion prior.
DEFAULT_WEIGHTS = {
    "occ": 12.4,
    "sym": 0.0,
    "fb": 0.2,
    "grad": 0.0,
    "ternary": 1.0,
    "photo": 0.0,
    "smooth_1st": 0.0,
    "smooth_2nd": 3.0,
}


def compute_losses(
    im1: torch.Tensor,
    im2: torch.Tensor,
    flow_fw: torch.Tensor,
    flow_bw: torch.Tensor,
    border_mask: torch.Tensor | None = None,
    mask_occlusion: str = "fb",
    data_max_distance: int = 1,
    weights: dict[str, float] | None = None,
) -> dict[str, torch.Tensor]:
    """Loss terms at one pyramid scale; ``(B, 3, H, W)`` images and
    ``(B, 2, H, W)`` flows in this scale's pixels.

    ``mask_occlusion``: ``fb`` (forward-backward consistency), ``disocc``
    (pixels on which the other direction's forward splat lands less than
    ``DISOCC_THRESH``) or empty (no occlusion masking). ``weights``: when
    given, terms with weight 0 are not computed; None computes every term.
    """

    def active(key: str) -> bool:
        return weights is None or bool(weights.get(key, 0.0))

    # The image and the opposite flow are warped by the same field: one call.
    warped_fw = backward_warp(torch.cat([im2, flow_bw], 1), flow_fw)
    warped_bw = backward_warp(torch.cat([im1, flow_fw], 1), flow_bw)
    c = im1.shape[1]
    im2_warped, flow_bw_warped = warped_fw[:, :c], warped_fw[:, c:]
    im1_warped, flow_fw_warped = warped_bw[:, :c], warped_bw[:, c:]
    im_diff_fw = im1 - im2_warped
    im_diff_bw = im2 - im1_warped
    flow_diff_fw = flow_fw + flow_bw_warped
    flow_diff_bw = flow_bw + flow_fw_warped

    mag_sq_fw = length_sq(flow_fw) + length_sq(flow_bw_warped)
    mag_sq_bw = length_sq(flow_bw) + length_sq(flow_fw_warped)
    occ_fw = (length_sq(flow_diff_fw) > 0.01 * mag_sq_fw + 0.5).to(im1.dtype)
    occ_bw = (length_sq(flow_diff_bw) > 0.01 * mag_sq_bw + 0.5).to(im1.dtype)

    mask_fw = create_outgoing_mask(flow_fw)
    mask_bw = create_outgoing_mask(flow_bw)
    if border_mask is not None:
        mask_fw = border_mask * mask_fw
        mask_bw = border_mask * mask_bw

    if mask_occlusion == "fb":
        mask_fw = mask_fw * (1.0 - occ_fw)
        mask_bw = mask_bw * (1.0 - occ_bw)
    elif mask_occlusion == "disocc":
        # pixels of frame 1 that nothing maps to under the backward flow are
        # disoccluded: out of the forward data term
        disocc_fw = (forward_warp(flow_bw) < DISOCC_THRESH).to(im1.dtype)
        disocc_bw = (forward_warp(flow_fw) < DISOCC_THRESH).to(im1.dtype)
        mask_fw = mask_fw * (1.0 - disocc_fw)
        mask_bw = mask_bw * (1.0 - disocc_bw)
    elif mask_occlusion not in ("", "none", None):
        raise ValueError(f"unknown mask_occlusion mode {mask_occlusion!r}")

    losses = {}
    if active("occ"):
        losses["occ"] = charbonnier_loss(occ_fw) + charbonnier_loss(occ_bw)
    if active("sym"):
        losses["sym"] = charbonnier_loss(occ_fw - occ_bw)
    if active("fb"):
        losses["fb"] = charbonnier_loss(flow_diff_fw, mask_fw) + charbonnier_loss(
            flow_diff_bw, mask_bw
        )
    if active("grad"):
        losses["grad"] = gradient_loss(im1, im2_warped, mask_fw) + gradient_loss(
            im2, im1_warped, mask_bw
        )
    if active("ternary"):
        losses["ternary"] = ternary_loss(
            im1, im2_warped, mask_fw, data_max_distance
        ) + ternary_loss(im2, im1_warped, mask_bw, data_max_distance)
    if active("photo"):
        losses["photo"] = photometric_loss(im_diff_fw, mask_fw) + photometric_loss(
            im_diff_bw, mask_bw
        )
    if active("smooth_1st"):
        losses["smooth_1st"] = smoothness_loss(flow_fw) + smoothness_loss(flow_bw)
    if active("smooth_2nd"):
        losses["smooth_2nd"] = second_order_loss(flow_fw) + second_order_loss(flow_bw)
    return losses


def _border(h: int, w: int, border_ratio: float) -> int:
    """The border mask's distance at an unsharded level (0: no mask)."""
    dist = int(min(h, w) * border_ratio)
    return fused.border_distance(h, w, dist) if dist > 0 else 0


def fused_spec(im1, im2, flows_fw, flows_bw, weights: dict, mask_occlusion: str,
               border_ratio: float) -> fused.Spec | None:
    """What the fused kernels need for this call, or None where the composite
    terms run: on a CPU, inside a ``SpatialContext`` (the terms there take
    halos), with other masking than ``fb``, with an active term the kernels
    do not compute, with frames that take a gradient, or off float32."""
    tensors = [im1, im2, *flows_fw, *flows_bw]
    if (
        not im1.is_cuda
        or spatial.current() is not None
        or mask_occlusion != "fb"
        or any(weights.get(key, 0.0) for key in LOSS_KEYS if key not in fused.TERMS)
        or im1.requires_grad
        or im2.requires_grad
        or any(t.dtype != torch.float32 for t in tensors)
    ):
        return None
    shapes = [f.shape[-2:] for f in flows_fw]
    return fused.Spec(
        term_weights=tuple(float(weights.get(key, 0.0)) for key in fused.TERMS),
        layer_weights=LAYER_WEIGHTS[: len(shapes)],
        scales=tuple(FLOW_SCALE / 2**i for i in range(len(shapes))),
        radii=LAYER_PATCH_DISTANCES[: len(shapes)],
        borders=tuple(_border(h, w, border_ratio) for h, w in shapes),
    )


def unsupervised_loss(
    im1: torch.Tensor,
    im2: torch.Tensor,
    flows_fw: Sequence[torch.Tensor],
    flows_bw: Sequence[torch.Tensor],
    weights: dict[str, float] | None = None,
    mask_occlusion: str = "fb",
    border_ratio: float = 0.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted multi-scale bidirectional loss of one cascade stage.

    ``flows_fw``/``flows_bw``: 5-scale pyramids ``(B, 2, h, w)``, finest
    (1/4 res) first, in raw network units. ``im1``/``im2``: full-resolution
    ``(B, 3, H, W)`` images (geometrically but not photometrically
    augmented). Returns the total and the per-term, per-scale scalars
    (``"<term>/scale<i>"`` and ``"total"``) for logging.
    """
    weights = {**DEFAULT_WEIGHTS, **(weights or {})}
    spec = fused_spec(im1, im2, flows_fw, flows_bw, weights, mask_occlusion, border_ratio)
    if spec is not None:
        values = fused.FusedLoss.apply(spec, im1, im2, *flows_fw, *flows_bw)
        logs = {
            f"{key}/scale{i}": values[len(fused.TERMS) * i + t]
            for i in range(len(flows_fw))
            for t, key in enumerate(fused.TERMS)
            if spec.term_weights[t]
        }
        logs["total"] = values[-1]
        return values[-1], logs

    total = torch.zeros((), dtype=torch.float32, device=im1.device)
    logs: dict[str, torch.Tensor] = {}

    # The image pyramid is built successively: the mean of 2x2 means over
    # 4x4 blocks is the mean over 8x8.
    im1_s = im2_s = None
    for i, (ffw, fbw) in enumerate(zip(flows_fw, flows_bw)):
        step_f = 4 if i == 0 else 2
        im1_s = downsample(im1 if i == 0 else im1_s, step_f)
        im2_s = downsample(im2 if i == 0 else im2_s, step_f)
        flow_fw_px = ffw * (FLOW_SCALE / (2**i))
        flow_bw_px = fbw * (FLOW_SCALE / (2**i))

        border = None
        if border_ratio > 0:
            h_s, w_s = im1_s.shape[-2:]
            dist = int(min(h_s, spatial.global_width(w_s)) * border_ratio)
            if dist > 0:
                border = create_border_mask(im1_s.shape, dist, im1_s.dtype, im1_s.device)

        terms = compute_losses(
            im1_s, im2_s, flow_fw_px, flow_bw_px,
            border_mask=border,
            mask_occlusion=mask_occlusion,
            data_max_distance=LAYER_PATCH_DISTANCES[i],
            weights=weights,
        )
        scale_total = torch.zeros((), dtype=torch.float32, device=im1.device)
        for key, value in terms.items():
            scale_total = scale_total + weights[key] * value
            logs[f"{key}/scale{i}"] = value
        total = total + LAYER_WEIGHTS[i] * scale_total

    logs["total"] = total
    return total, logs
