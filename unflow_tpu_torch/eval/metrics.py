"""Flow evaluation metrics: AEE and the KITTI outlier fraction (Fl).

Port of ``unflow_tpu/eval/metrics.py`` on torch tensors: flows are NHWC,
``(B, H, W, 2)``, and a mask is ``(B, H, W, 1)`` with 1.0 on valid pixels.
"""

from __future__ import annotations

import torch


def endpoint_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel endpoint error, (B, H, W, 1)."""
    return torch.sqrt(torch.sum(torch.square(pred - gt), dim=-1, keepdim=True))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def flow_error_avg(
    pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """AEE over valid pixels (mask: (B, H, W, 1), 1.0 = valid)."""
    return _masked_mean(endpoint_error(pred, gt), mask)


def outlier_fraction(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor | None = None,
    abs_thresh: float = 3.0,
    rel_thresh: float = 0.05,
) -> torch.Tensor:
    """KITTI Fl: fraction of valid pixels with EPE > 3 px and > 5% of |gt|."""
    err = endpoint_error(pred, gt)
    mag = torch.sqrt(torch.sum(torch.square(gt), dim=-1, keepdim=True))
    outlier = ((err > abs_thresh) & (err > rel_thresh * mag)).to(pred.dtype)
    return _masked_mean(outlier, mask)
