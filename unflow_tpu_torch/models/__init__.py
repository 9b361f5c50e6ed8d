"""FlowNet models of the port and their construction from a config."""

from __future__ import annotations

import torch

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.models.flownet import (
    FLOW_SCALE,
    FlowNetC,
    FlowNetS,
    FlowNetStack,
    full_res_flow,
    init_params,
)
from unflow_tpu_torch.ops import impl_from_config

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: Config, device: torch.device | str | None) -> FlowNetStack:
    """The network of ``cfg`` (port of ``unflow_tpu/train/trainer.py::
    build_model``): the stack of ``flownet``, float32 parameters in
    channels_last memory on ``device`` (``None``: as constructed, on the
    default device, for tracing under fake tensors)."""
    t = cfg.train
    model = FlowNetStack(
        spec=t.flownet,
        compute_dtype=DTYPES[t.compute_dtype],
        corr_impl=impl_from_config(t.corr_impl),
        max_displacement=t.max_displacement,
        corr_stride=t.corr_stride,
        remat=t.remat,
    )
    if device is None:
        return model
    return model.to(device=device, memory_format=torch.channels_last)


__all__ = [
    "DTYPES",
    "FLOW_SCALE",
    "FlowNetC",
    "FlowNetS",
    "FlowNetStack",
    "build_model",
    "full_res_flow",
    "init_params",
]
