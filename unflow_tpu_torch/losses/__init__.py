"""Losses of the port (port of ``unflow_tpu/losses``)."""

from unflow_tpu_torch.losses.supervised import supervised_loss
from unflow_tpu_torch.losses.unsupervised import (
    DEFAULT_WEIGHTS,
    LAYER_PATCH_DISTANCES,
    LAYER_WEIGHTS,
    LOSS_KEYS,
    compute_losses,
    unsupervised_loss,
)

__all__ = [
    "DEFAULT_WEIGHTS",
    "LAYER_PATCH_DISTANCES",
    "LAYER_WEIGHTS",
    "LOSS_KEYS",
    "compute_losses",
    "supervised_loss",
    "unsupervised_loss",
]
