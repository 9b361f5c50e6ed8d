"""Training of the port (port of ``unflow_tpu/train``)."""

from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train.schedule import piecewise_halving
from unflow_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    build_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "Trainer",
    "build_model",
    "build_optimizer",
    "make_train_step",
    "piecewise_halving",
]
