"""Random weights of a cascade, made on the device from a seed in a few large
calls: LeCun-normal kernels (truncated at two standard deviations, variance
``1 / fan_in``) and zero biases, as Flax initializes FlowNet."""

from __future__ import annotations

import math

import torch

from flowbench.reference.flownet import fan_in, param_shapes

# stddev of the unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def make_weights(spec: str, seed: int, device, max_displacement: int = 20,
                 stride: int = 2) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` of every parameter of ``spec``."""
    shapes = param_shapes(spec, max_displacement, stride)
    kernels = [k for k in shapes if k.endswith(".weight")]
    total = sum(math.prod(shapes[k]) for k in kernels)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    for _ in range(4):  # redraw the tails; what is left past 4 redraws is clipped
        flat = torch.where(flat.abs() > 2, torch.randn(total, generator=g, device=device), flat)
    flat = flat.clamp_(-2, 2)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        std = math.sqrt(1.0 / fan_in(name, shape)) / TRUNCATED_STD
        out[name] = flat[at:at + n].view(shape) * std
        at += n
    return out
