"""Training of the port (port of ``unflow_tpu/train``)."""

from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train.checkpoint import CheckpointManager, init_stages_from, restore_params
from unflow_tpu_torch.train.schedule import piecewise_halving
from unflow_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    build_optimizer,
    make_train_step,
)

__all__ = [
    "CheckpointManager",
    "TrainState",
    "Trainer",
    "build_model",
    "build_optimizer",
    "init_stages_from",
    "make_train_step",
    "piecewise_halving",
    "restore_params",
]
