"""Supervised multi-scale EPE loss for fine-tuning on ground truth, in NCHW.

Port of ``unflow_tpu/losses/supervised.py``: a charbonnier penalty between
the predicted flows and the ground truth average-downsampled to each pyramid
level, honoring a sparse validity mask (KITTI).
"""

from __future__ import annotations

from typing import Sequence

import torch

from unflow_tpu_torch.losses.terms import charbonnier_loss
from unflow_tpu_torch.losses.unsupervised import LAYER_WEIGHTS
from unflow_tpu_torch.models.flownet import FLOW_SCALE
from unflow_tpu_torch.ops.downsample import downsample


def supervised_loss(
    flows: Sequence[torch.Tensor],
    gt_flow: torch.Tensor,
    valid_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Multi-scale charbonnier EPE against (possibly sparse) ground truth.

    ``flows``: 5-scale predictions ``(B, 2, h, w)``, finest (1/4 res) first,
    in raw network units. ``gt_flow``: ``(B, 2, H, W)`` full-resolution
    ground truth in pixels. ``valid_mask``: ``(B, 1, H, W)``, 1 where the
    ground truth is valid; None means dense.

    Sparse ground truth is downsampled mask-aware, ``gt_s = avg(gt * m) /
    avg(m)``, and a level pixel is valid if any full-resolution pixel under
    it was.
    """
    if valid_mask is None:
        valid_mask = torch.ones_like(gt_flow[:, :1])
    total = torch.zeros((), dtype=torch.float32, device=gt_flow.device)
    logs: dict[str, torch.Tensor] = {}
    for i, pred in enumerate(flows):
        factor = 4 * (2**i)
        mask_s = downsample(valid_mask, factor)
        # in this level's pixels
        gt_s = downsample(gt_flow * valid_mask, factor) / mask_s.clamp(min=1e-8) / factor
        valid_s = (mask_s > 0).to(gt_flow.dtype)
        diff = pred * (FLOW_SCALE / (2**i)) - gt_s
        loss_i = charbonnier_loss(diff, valid_s, beta=1.0, alpha=0.5, epsilon=1e-3)
        logs[f"epe_charbonnier/scale{i}"] = loss_i
        total = total + LAYER_WEIGHTS[i] * loss_i
    logs["total"] = total
    return total, logs
