"""The chip's published peaks and the least time of a correlation kernel.

Peaks are NVIDIA's data sheets (dense rates, no sparsity), looked up by the
prefix of ``torch.cuda.get_device_name()``; they assume the card's full
power limit, which the result line states beside them.
"""

from __future__ import annotations

# name prefix -> (dense bf16 FLOP/s, HBM bytes/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),  # SXM5
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
}


def peaks(device_name: str) -> tuple[float, float] | None:
    """(bf16 FLOP/s, bytes/s) of a card, or None for one not listed."""
    best = max((p for p in PEAKS if device_name.startswith(p)), key=len, default=None)
    return PEAKS[best] if best else None


def corr_bound_s(shape, d: int, dtype_bytes: int, flops_per_s: float, bytes_per_s: float) -> float:
    """Least time of one correlation kernel, forward or either gradient, on
    maps ``(B, H, W, C)``: two maps and the ``(B, H, W, D*D)`` volume each read
    or written once, against ``2 * B * H * W * D*D * C`` operations."""
    b, h, w, c = shape
    t_bytes = (2 * b * h * w * c + b * h * w * d * d) * dtype_bytes / bytes_per_s
    t_ops = 2 * b * h * w * d * d * c / flops_per_s
    return max(t_bytes, t_ops)
