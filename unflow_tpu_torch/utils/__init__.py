"""Utilities of the port."""

from unflow_tpu_torch.utils.logging import MetricsLogger

__all__ = ["MetricsLogger"]
