"""SAME convolution with TF/XLA padding, in NCHW.

Port of the forward of ``unflow_tpu/ops/conv2d.py``. XLA's SAME padding of a
strided convolution puts the extra pixel on the high side; ``nn.Conv2d``'s
``padding=`` is symmetric and would shift the sampling grid of every
stride-2 layer by a pixel, so the asymmetric case pads explicitly. The JAX
package's phase-decomposed data gradient (``conv_impl=phase``) works around
an XLA lowering on the TPU and has no counterpart here.

Inside a :class:`~unflow_tpu_torch.parallel.spatial.SpatialContext` (W-sharding)
the W pads are those of the global width, taken as a halo of the neighbours'
columns (zeros at the global edges); H is padded as without it.

A layer whose input is in a lower precision than its float32 parameters
(the bfloat16 towers) rounds where the JAX program, as XLA compiles it,
rounds (:class:`LowPrecisionConv`): the conv's output, then the sum with the
bias, each to the input's dtype; the weight gradient stays float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unflow_tpu_torch.parallel import spatial


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(pad_lo, pad_hi) of a SAME convolution along one dim (TF/XLA rule)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    lo = total // 2
    return lo, total - lo


class LowPrecisionConv(torch.autograd.Function):
    """A conv (or 4x4/2 transposed conv) of a low-precision input ``x`` and
    float32 ``weight`` and ``bias``, rounded as XLA compiles the JAX
    package's ``nn.Conv(dtype=bfloat16)`` (its optimized HLO, with and without
    ``--xla_allow_excess_precision``):

    * forward: the parameters cast to ``x.dtype``; the conv's output rounded
      to it, then its sum with the bias rounded again (``float_out``: the sum
      is left in float32, as XLA leaves the flow heads that the loss reads in
      float32);
    * backward: the data gradient in ``x.dtype`` and the bias gradient
      summed in float32 and rounded once to it, as the program says; the
      weight gradient summed in float32 and left there (XLA emits the
      filter-gradient conv in float32 and drops the program's round trip
      through bfloat16).

    The weight gradient runs as a float32 conv of the low-precision operands
    with TF32 allowed: bfloat16 values and their products are exact in TF32,
    so it sums exact products in float32, as a bfloat16 conv accumulates.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, transposed: bool, float_out: bool):
        w = weight.to(x.dtype)
        conv = F.conv_transpose2d if transposed else F.conv2d
        y = conv(x, w, None, stride, padding)
        b = bias.to(x.dtype)[:, None, None]
        y = y.float() + b.float() if float_out else y + b
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, transposed)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.conv
        gb = None
        if ctx.needs_input_grad[2]:
            gb = g.sum((0, 2, 3), dtype=torch.float32).to(x.dtype).float()
        g = g.to(x.dtype)

        def grad(gy, xx, ww, mask):
            return torch.ops.aten.convolution_backward(
                gy, xx, ww, None, _pair(stride), _pair(padding), (1, 1), transposed, (0, 0), 1,
                mask)

        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = grad(g, x, w, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            with _tf32():
                gw = grad(g.float(), x.float(), w.float(), [False, True, False])[1]
        return gx, gw, gb, None, None, None, None


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _tf32():
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                   allow_tf32=True)


def conv2d_same(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int = 1,
    float_out: bool = False,
) -> torch.Tensor:
    """``lax.conv_general_dilated(..., padding="SAME")`` plus ``bias`` for
    NCHW/OIHW, in the dtype of ``x`` (the parameters are cast to it; a
    lower one than theirs rounds as :class:`LowPrecisionConv` says)."""
    kh, kw = weight.shape[-2:]
    top, bottom = same_pads(x.shape[-2], kh, stride)
    left, right = same_pads(spatial.global_width(x.shape[-1]), kw, stride)
    if spatial.current() is not None:
        x = spatial.halo_exchange(x, left, right)
        left = right = 0
    padding = (top, left)
    if top != bottom or left != right:
        x, padding = F.pad(x, (left, right, top, bottom)), (0, 0)
    return conv_like_jax(x, weight, bias, stride, padding, float_out=float_out)


def conv_like_jax(x, weight, bias, stride, padding, transposed: bool = False,
                  float_out: bool = False) -> torch.Tensor:
    """``F.conv2d`` (``transposed``: ``F.conv_transpose2d``) of ``x`` with
    float32 ``weight`` and ``bias`` cast to ``x.dtype``: through
    :class:`LowPrecisionConv` when that dtype is a lower one."""
    if x.dtype == weight.dtype:
        conv = F.conv_transpose2d if transposed else F.conv2d
        return conv(x, weight, bias, stride, padding)
    return LowPrecisionConv.apply(x, weight, bias, stride, padding, transposed, float_out)


class Conv2dSame(nn.Conv2d):
    """``flax.linen.Conv(features, (k, k), strides=(s, s), padding="SAME")``,
    built as ``Conv2dSame(in_channels, features, k, s)``; its own
    ``padding`` stays 0.

    Runs in the input's dtype: float32 parameters are cast at each use, as
    flax casts them to ``dtype``. ``float_out`` leaves a low-precision
    layer's output in float32 (the flow heads).
    """

    float_out = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, self.stride[0], self.float_out)
