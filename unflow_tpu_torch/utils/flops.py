"""Conv/matmul FLOP accounting of a train step, for MFU.

Port of ``unflow_tpu/utils/flops.py``. The JAX package walks the jaxpr of
its traced step and sums ``2 * prod(out) * reduction`` over every
``conv_general_dilated`` and ``dot_general``; here a dispatch mode watches
the aten ops that one call of the port's step runs and counts each as the
JAX package counts the op that computes the same thing:

* ``convolution`` / ``convolution_backward``: 2 x output elements x the
  reduction length (input channels per group x kernel taps) of each conv
  XLA runs. A transposed conv is counted over its whole output, the data
  gradient of a strided conv over its whole input, and the filter gradient
  of a transposed conv over its whole output: XLA lowers these as convs over
  zero-dilated operands and the JAX count includes the zeros, so this count
  does too (cuDNN does not multiply them). The data gradient is counted over
  the SAME conv's input before ``ops/conv2d.py`` pads it, ``out x stride``
  (exact for FlowNet, whose maps are multiples of 64).
* ``im2col`` / ``col2im``: the census transform's patches. JAX extracts them
  with ``conv_general_dilated_patches`` (a conv with a one-hot kernel) and
  counts it; the port unfolds, and counts the unfold (and its gradient) as
  that conv.
* ``upsample_bilinear2d`` and its gradient: ``jax.image.resize`` contracts
  the image with one interpolation matrix per axis (two ``dot_general``),
  in the cheaper of the two orders.
* every other op of ``torch.utils.flop_counter``'s registry (``mm``,
  ``bmm``, ``addmm``, attention) by its formula there, which is JAX's.

The correlation is not counted: in JAX it is a Pallas kernel, here a
hand-written CUDA kernel (or, on the CPU, elementwise products), opaque to
both. Elementwise work is not counted either: MFU is the share of the
matrix units' peak.

    flops = train_step_flops(cfg)      # fake tensors: no memory, no device
    mfu = flops / step_seconds / peak_flops()
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

#: Dense bfloat16 tensor-core peak per GPU in FLOP/s, by the prefix of
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheets, without sparsity).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # SXM5
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
}


def peak_flops(device: torch.device | str | None = None) -> float | None:
    """The dense bf16 peak of a CUDA device (default: the current one), or
    None for the CPU and for a card not in :data:`PEAK_BF16_FLOPS`."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return peak_for_name(torch.cuda.get_device_name(device))


def peak_for_name(name: str) -> float | None:
    """The peak of the longest prefix of ``name`` in the table, or None."""
    best = max((p for p in PEAK_BF16_FLOPS if name.startswith(p)), key=len, default=None)
    return PEAK_BF16_FLOPS[best] if best else None


def _shape(x) -> tuple[int, ...]:
    return tuple(x.shape)


def _patches(x_shape, taps: int) -> int:
    """``conv_general_dilated_patches`` of ``(B, C, H, W)``: a one-hot kernel,
    ``taps`` outputs per input channel, each a reduction over ``taps`` pixels."""
    return 2 * math.prod(x_shape) * taps * taps


def _resize(b: int, c: int, hw_in, hw_out) -> int:
    """``jax.image.resize``: one contraction per axis, in the cheaper order."""
    (hi, wi), (ho, wo) = hw_in, hw_out
    return 2 * b * c * min(hi * wo * wi + ho * wo * hi, ho * wi * hi + ho * wo * wi)


def _count(func, args, kwargs, out) -> tuple[str, int] | None:
    """The site key and FLOPs of one aten call, or None if it is not counted."""
    packet = func._overloadpacket
    if packet is aten.convolution:
        x, w, transposed, groups = args[0], args[1], bool(args[6]), args[8]
        taps = math.prod(_shape(w)[2:])
        kind = "conv_transpose" if transposed else "conv"
        return (f"{kind} w={_shape(w)} out={_shape(out)}",
                2 * math.prod(_shape(out)) * (_shape(x)[1] // groups) * taps)
    if packet is aten.convolution_backward:
        grad_out, x, w = args[0], args[1], args[2]
        stride, transposed, groups, mask = args[4], bool(args[7]), args[9], args[10]
        taps = math.prod(_shape(w)[2:])
        flops = 0
        if mask[0]:  # data gradient: a conv over the forward's outputs
            x_shape = _shape(x)
            if not transposed:
                # the SAME conv's input before ``conv2d_same`` padded it
                x_shape = x_shape[:2] + tuple(o * s for o, s in zip(_shape(grad_out)[2:], stride))
            flops += 2 * math.prod(x_shape) * (_shape(grad_out)[1] // groups) * taps
        if mask[1]:  # filter gradient: a reduction over the batch and grad_out's map
            flops += 2 * math.prod(_shape(w)) * _shape(x)[0] * math.prod(_shape(grad_out)[2:])
        return f"conv_backward w={_shape(w)} x={_shape(x)} mask={tuple(mask[:2])}", flops
    if packet is aten.im2col:
        x, kernel = args[0], args[1]
        return f"patches x={_shape(x)} k={tuple(kernel)}", _patches(_shape(x), math.prod(kernel))
    if packet is aten.col2im:
        grad, size, kernel = args[0], args[1], args[2]
        taps = math.prod(kernel)
        x_shape = (_shape(grad)[0], _shape(grad)[1] // taps, *size)
        return f"patches_grad x={x_shape} k={tuple(kernel)}", _patches(x_shape, taps)
    if packet is aten.upsample_bilinear2d:
        b, c, hi, wi = _shape(args[0])
        ho, wo = _shape(out)[2:]
        return f"resize {(b, c, hi, wi)}->{(ho, wo)}", _resize(b, c, (hi, wi), (ho, wo))
    if packet is aten.upsample_bilinear2d_backward:
        b, c, ho, wo = _shape(args[0])
        hi, wi = _shape(out)[2:]
        return f"resize_grad {(b, c, hi, wi)}->{(ho, wo)}", _resize(b, c, (hi, wi), (ho, wo))
    if packet in flop_registry:
        shapes = [_shape(a) for a in args if isinstance(a, torch.Tensor)]
        return f"{packet.__name__} {shapes}", flop_registry[packet](*args, **kwargs, out_val=out)
    return None


class FlopCounter(TorchDispatchMode):
    """Counts the conv/matmul FLOPs of the aten ops run under it, by site
    (op and shapes), as the JAX package counts the ops it lowers to."""

    def __init__(self):
        super().__init__()
        self.sites: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        counted = _count(func, args, kwargs, out)
        if counted is not None and counted[1]:
            key, flops = counted
            self.sites[key] = self.sites.get(key, 0) + flops
        return out


def matmul_flops_by_site(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """Conv/matmul FLOPs (2 x MACs) of one call of ``fn(*args, **kwargs)``,
    keyed by op and shapes. ``fn`` runs: give it fake or small tensors."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.sites


def matmul_flops(fn: Callable, *args, **kwargs) -> int:
    """Total conv/matmul FLOPs (2 x MACs) of one call of ``fn(*args, **kwargs)``."""
    return sum(matmul_flops_by_site(fn, *args, **kwargs).values())


def train_step_flops(cfg, by_site: bool = False) -> int | dict[str, int]:
    """Conv/matmul FLOPs of one train step of ``cfg`` (its network, the
    global batch ``batch_size`` at ``height`` x ``width``, forward, backward
    and Adam), traced on fake tensors: nothing is allocated or computed, so
    it costs the same at any size. The count is linear in the batch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from unflow_tpu_torch.models import build_model
    from unflow_tpu_torch.train.trainer import (
        TrainState,
        build_optimizer,
        freeze_stages,
        make_train_step,
    )

    t = cfg.train
    with FakeTensorMode():
        model = build_model(cfg, None)
        freeze_stages(model, t.flownet)
        state = TrainState(model, build_optimizer(cfg, model))
        batch = {"im1": torch.empty(t.batch_size, t.height, t.width, 3),
                 "im2": torch.empty(t.batch_size, t.height, t.width, 3)}
        if t.supervised:
            batch["flow"] = torch.empty(t.batch_size, t.height, t.width, 2)
        sites = matmul_flops_by_site(make_train_step(cfg, shard=(0, 1)), state, batch)
    return sites if by_site else sum(sites.values())
