"""FlowNetS, FlowNetC, their decoder and the stacked cascades, in PyTorch.

Port of ``unflow_tpu/models/flownet.py`` (``FLOW_SCALE``, ``_Decoder``,
``FlowNetS``, ``FlowNetC``, ``full_res_flow`` and ``FlowNetStack``). The
structure and the parameter names follow the flax modules, so that
:func:`unflow_tpu_torch.convert.params_from_flax` maps a JAX param tree onto
``state_dict`` keys one to one (``stage1_S.conv1.weight`` is flax's
``stage1_S/conv1/kernel``). FlowNetC:

  * conv1-3 form a shared tower (7x7/2·64, 5x5/2·128, 5x5/2·256), run here
    once on both frames stacked along the batch (inference), or once on the
    interleaved forward/backward batch of the train step, whose second map
    is the first with its pairs swapped (``pair_flipped_im2``);
  * the 441-channel correlation (max_displacement 20, stride 2) of the two
    conv3 maps, leaky-ReLU, concatenated with a 1x1 ``conv_redir`` (32
    channels) of frame 1;
  * the trunk conv3_1 .. conv6_1 and a decoder of 4x4/2 transposed convs
    that predicts flow at five scales, finest (1/4 resolution) first.

FlowNetS runs the same ten convs (conv1 7x7/2·64 ... conv6_1·1024) on its
channel-concatenated input and the same decoder. A stack stage after the
first is a FlowNetS on ``[im1, im2, im2 warped by the previous flow, that
flow, the brightness error]`` (12 channels).

Tensors are NCHW in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)``
hands the correlation a contiguous NHWC view. ``compute_dtype`` runs the
towers and the decoder (bfloat16 by default in the configs); the flows come
out as float32.

Under W-sharding (``parallel/spatial.py``) each rank runs the same modules on
its W-slab: the convs and deconvs take halos, the correlation a halo of its
displacement range, the glue's warp the gathered frame, and the final
upsampling one coarse column each side.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unflow_tpu_torch.ops import correlation
from unflow_tpu_torch.ops.conv2d import Conv2dSame, conv_like_jax
from unflow_tpu_torch.ops.correlation import displacement_count
from unflow_tpu_torch.ops.downsample import resize_bilinear
from unflow_tpu_torch.ops.warp import backward_warp
from unflow_tpu_torch.parallel import spatial
from unflow_tpu_torch.utils.profiling import device_span

FLOW_SCALE = 5.0


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _pair_flip(x: torch.Tensor) -> torch.Tensor:
    """Swap each adjacent (forward, backward) pair along the batch axis:
    row 2i <-> row 2i+1."""
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:]).flip(1).reshape(x.shape).contiguous()


class Deconv4x4(nn.ConvTranspose2d):
    """``flax.linen.ConvTranspose(features, (4, 4), strides=(2, 2),
    padding="SAME")``: doubles H and W. Its weight is the flax kernel
    transposed to ``(C_in, F, 4, 4)`` and flipped in space (flax does not
    flip, ``conv_transpose2d`` does)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = 1
        if spatial.current() is not None:
            # output column 2g + k - 1 reads input g: one neighbour column on
            # each side, and a W padding of 3 keeps exactly the slab's 2w
            x, padding = spatial.halo_exchange(x, 1, 1), (1, 3)
        return conv_like_jax(x, self.weight, self.bias, 2, padding, transposed=True)


class FlowHead(Conv2dSame):
    """A 3x3 ``predict_flow`` conv to 2 channels. In low precision its sum
    with the bias stays float32 (the loss reads it; XLA drops the program's
    rounding there); the next scale's ``upflow`` takes it rounded."""

    float_out = True


class Decoder(nn.Module):
    """Shared FlowNet decoder: 4 deconv stages + 5 flow predictions.

    Returns float32 flows finest first: [flow2 (1/4 res), flow3, flow4,
    flow5, flow6 (1/64 res)].
    """

    def __init__(self):
        super().__init__()
        # channels of [skip, deconv, upflow] at each scale
        cat5 = 512 + 512 + 2  # conv5_1
        cat4 = 512 + 256 + 2  # conv4_1
        cat3 = 256 + 128 + 2  # conv3_1
        cat2 = 128 + 64 + 2  # conv2
        self.predict_flow6 = FlowHead(1024, 2, 3)
        self.deconv5 = Deconv4x4(1024, 512)
        self.upflow6to5 = Deconv4x4(2, 2)
        self.predict_flow5 = FlowHead(cat5, 2, 3)
        self.deconv4 = Deconv4x4(cat5, 256)
        self.upflow5to4 = Deconv4x4(2, 2)
        self.predict_flow4 = FlowHead(cat4, 2, 3)
        self.deconv3 = Deconv4x4(cat4, 128)
        self.upflow4to3 = Deconv4x4(2, 2)
        self.predict_flow3 = FlowHead(cat3, 2, 3)
        self.deconv2 = Deconv4x4(cat3, 64)
        self.upflow3to2 = Deconv4x4(2, 2)
        self.predict_flow2 = FlowHead(cat2, 2, 3)

    def forward(self, skip2, skip3, conv4_1, conv5_1, conv6_1) -> list[torch.Tensor]:
        dt = conv6_1.dtype
        flow6 = self.predict_flow6(conv6_1)
        cat5 = torch.cat([conv5_1, _leaky(self.deconv5(conv6_1)), self.upflow6to5(flow6.to(dt))], 1)
        flow5 = self.predict_flow5(cat5)
        cat4 = torch.cat([conv4_1, _leaky(self.deconv4(cat5)), self.upflow5to4(flow5.to(dt))], 1)
        flow4 = self.predict_flow4(cat4)
        cat3 = torch.cat([skip3, _leaky(self.deconv3(cat4)), self.upflow4to3(flow4.to(dt))], 1)
        flow3 = self.predict_flow3(cat3)
        cat2 = torch.cat([skip2, _leaky(self.deconv2(cat3)), self.upflow3to2(flow3.to(dt))], 1)
        flow2 = self.predict_flow2(cat2)
        return [f.float() for f in (flow2, flow3, flow4, flow5, flow6)]


class FlowNetC(nn.Module):
    """FlowNet-Correlation: shared towers + cost volume + trunk + decoder."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32, max_displacement: int = 20,
                 corr_stride: int = 2, corr_impl: str | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.max_displacement = max_displacement
        self.corr_stride = corr_stride
        self.corr_impl = corr_impl
        d = displacement_count(max_displacement, corr_stride)
        self.conv1 = Conv2dSame(3, 64, 7, 2)
        self.conv2 = Conv2dSame(64, 128, 5, 2)
        self.conv3 = Conv2dSame(128, 256, 5, 2)
        self.conv_redir = Conv2dSame(256, 32, 1)
        self.conv3_1 = Conv2dSame(d * d + 32, 256, 3)
        self.conv4 = Conv2dSame(256, 512, 3, 2)
        self.conv4_1 = Conv2dSame(512, 512, 3)
        self.conv5 = Conv2dSame(512, 512, 3, 2)
        self.conv5_1 = Conv2dSame(512, 512, 3)
        self.conv6 = Conv2dSame(512, 1024, 3, 2)
        self.conv6_1 = Conv2dSame(1024, 1024, 3)
        self.decoder = Decoder()

    def forward(
        self, im1: torch.Tensor, im2: torch.Tensor, pair_flipped_im2: bool = False
    ) -> list[torch.Tensor]:
        """``(B, 3, H, W)`` normalized frames -> five float32 flows.

        ``pair_flipped_im2``: the caller's promise that ``im2`` is ``im1``
        with each adjacent pair of rows swapped (the interleaved
        forward/backward batch of the train step). The tower then runs once,
        on ``im1``, and the second conv3 map is the first with its pairs
        swapped. Without it the tower runs once on both frames stacked.
        """
        n = im1.shape[0]
        x = im1 if pair_flipped_im2 else torch.cat([im1, im2])
        x = x.to(dtype=self.compute_dtype, memory_format=torch.channels_last)
        c2 = _leaky(self.conv2(_leaky(self.conv1(x))))
        c3 = _leaky(self.conv3(c2))
        c3a = c3[:n]
        f1 = c3a.permute(0, 2, 3, 1).contiguous()  # NHWC; no copy from channels_last
        if pair_flipped_im2:
            f2 = _pair_flip(f1)
        else:
            f2 = c3[n:].permute(0, 2, 3, 1).contiguous()
        corr = correlation(f1, f2, self.max_displacement, self.corr_stride, self.corr_impl)
        corr = _leaky(corr.permute(0, 3, 1, 2).to(self.compute_dtype))
        redir = _leaky(self.conv_redir(c3a))
        c3_1 = _leaky(self.conv3_1(torch.cat([corr, redir], 1)))
        c4_1 = _leaky(self.conv4_1(_leaky(self.conv4(c3_1))))
        c5_1 = _leaky(self.conv5_1(_leaky(self.conv5(c4_1))))
        c6_1 = _leaky(self.conv6_1(_leaky(self.conv6(c5_1))))
        return self.decoder(c2[:n], c3_1, c4_1, c5_1, c6_1)


def full_res_flow(flows: Sequence[torch.Tensor], height: int, width: int) -> torch.Tensor:
    """Finest prediction ``(B, 2, H/4, W/4)`` -> ``(B, 2, height, width)``
    flow in pixels (upsampled 4x, so vectors scale by 4 * FLOW_SCALE)."""
    return resize_bilinear(flows[0] * (4.0 * FLOW_SCALE), height, width)


class FlowNetS(nn.Module):
    """FlowNet-Simple on channel-concatenated inputs: ``in_channels`` is 6
    for a first stage (the two frames), 12 for a refinement stage."""

    def __init__(self, in_channels: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2dSame(in_channels, 64, 7, 2)
        self.conv2 = Conv2dSame(64, 128, 5, 2)
        self.conv3 = Conv2dSame(128, 256, 5, 2)
        self.conv3_1 = Conv2dSame(256, 256, 3)
        self.conv4 = Conv2dSame(256, 512, 3, 2)
        self.conv4_1 = Conv2dSame(512, 512, 3)
        self.conv5 = Conv2dSame(512, 512, 3, 2)
        self.conv5_1 = Conv2dSame(512, 512, 3)
        self.conv6 = Conv2dSame(512, 1024, 3, 2)
        self.conv6_1 = Conv2dSame(1024, 1024, 3)
        self.decoder = Decoder()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``(B, in_channels, H, W)`` -> five float32 flows."""
        x = x.to(dtype=self.compute_dtype, memory_format=torch.channels_last)
        c2 = _leaky(self.conv2(_leaky(self.conv1(x))))
        c3_1 = _leaky(self.conv3_1(_leaky(self.conv3(c2))))
        c4_1 = _leaky(self.conv4_1(_leaky(self.conv4(c3_1))))
        c5_1 = _leaky(self.conv5_1(_leaky(self.conv5(c4_1))))
        c6_1 = _leaky(self.conv6_1(_leaky(self.conv6(c5_1))))
        return self.decoder(c2, c3_1, c4_1, c5_1, c6_1)


class FlowNetStack(nn.Module):
    """The cascade of a spec string: ``S``, ``C``, ``cS``, ``CS``, ``csS``,
    ``CSS`` and the like. The first stage is a FlowNetC or a FlowNetS; every
    later one is a FlowNetS. Uppercase stages are trainable; lowercase ones
    are frozen: their flows are detached here, and the trainer gives their
    parameters no gradient. Each stage is the submodule ``stage{i}_{C|S}``.
    Returns one 5-scale flow list per stage, finest first, in network units.

    ``remat`` (the JAX package's ``nn.remat`` of each stage): with grad
    enabled, each stage runs under ``torch.utils.checkpoint``, which keeps only
    the stage's inputs and recomputes its activations in the backward pass,
    one more forward of each stage that gets a gradient for the memory of its
    activations. The parameters, the outputs and the gradients are those
    without it."""

    def __init__(self, spec: str = "C", compute_dtype: torch.dtype = torch.float32,
                 corr_impl: str | None = None, max_displacement: int = 20, corr_stride: int = 2,
                 remat: bool = False):
        super().__init__()
        if not spec or spec[0].upper() not in ("C", "S"):
            raise ValueError(f"bad stack spec {spec!r}")
        if any(ch.upper() != "S" for ch in spec[1:]):
            raise ValueError(
                f"only FlowNetS refinement stages are supported after the first net (spec {spec!r})"
            )
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.remat = remat
        for i, ch in enumerate(spec):
            if i == 0 and ch.upper() == "C":
                net = FlowNetC(compute_dtype, max_displacement, corr_stride, corr_impl)
            else:
                net = FlowNetS(6 if i == 0 else 12, compute_dtype)
            self.add_module(f"stage{i}_{ch.upper()}", net)

    def forward(
        self, im1: torch.Tensor, im2: torch.Tensor, pair_flipped_im2: bool = False
    ) -> list[list[torch.Tensor]]:
        """``pair_flipped_im2`` reaches only a first-stage FlowNetC.

        Inside a train step on a GPU each stage's network is timed on the
        device as ``unflow.dev.frozen`` (a lowercase stage) or
        ``unflow.dev.trainable_fwd``, and the glue before a later stage (the
        warp, the brightness error, the concatenation) as ``unflow.dev.glue``
        (``utils/profiling.py::device_span``)."""
        h, w = im1.shape[-2:]
        dt = self.compute_dtype
        stage_flows: list[list[torch.Tensor]] = []
        flow_prev = None
        for i, ch in enumerate(self.spec):
            net = getattr(self, f"stage{i}_{ch.upper()}")
            if self.remat and torch.is_grad_enabled():
                net = functools.partial(_checkpointed, net)
            if i == 0:
                if ch.upper() == "C":
                    x = (im1, im2, pair_flipped_im2)
                else:
                    x = (torch.cat([im1, im2], 1),)
            else:
                with device_span("unflow.dev.glue", im1):
                    # the glue runs in compute_dtype; flow_prev stays float32,
                    # because the warp's sample coordinates need it
                    warped = backward_warp(im2.to(dt), flow_prev)
                    # eps inside the root: the gradient of a plain norm is NaN
                    # at a zero difference, which bfloat16 makes common
                    err = torch.sqrt(torch.sum(torch.square(im1.to(dt) - warped), 1, keepdim=True)
                                     + 1e-6)
                    x = (torch.cat([im1.to(dt), im2.to(dt), warped, flow_prev.to(dt), err], 1),)
            with device_span("unflow.dev.frozen" if ch.islower() else "unflow.dev.trainable_fwd",
                             im1):
                flows = net(*x)
            del x  # the glue's 12 channels: autograd keeps them where the backward needs them
            if ch.islower():
                flows = [f.detach() for f in flows]
            stage_flows.append(flows)
            flow_prev = full_res_flow(flows, h, w)
        return stage_flows


def _checkpointed(net: nn.Module, *args) -> list[torch.Tensor]:
    """``net(*args)`` with its activations recomputed in the backward pass.
    Non-reentrant, as DistributedDataParallel's gradient hooks need. FlowNet
    draws no random numbers, so no RNG state is kept for the recompute. The
    recompute may run on autograd's device thread, which does not see the
    caller's W-sharding context: it re-enters the one of the forward."""
    ctx = spatial.current()
    return checkpoint(net, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), spatial.within(ctx)))


def _truncated_normal(shape: torch.Size, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) cut to [-2 std, 2 std]: the distribution of
    ``nn.init.trunc_normal_``, drawn by redrawing the values outside (much
    faster on channels_last weights)."""
    x = torch.randn(shape, generator=generator)
    out = (x.abs() > 2).nonzero(as_tuple=True)
    while out[0].numel():
        redraw = torch.randn(out[0].shape, generator=generator)
        x[out] = redraw
        keep = redraw.abs() > 2
        out = tuple(i[keep] for i in out)
    return x * std


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's init: lecun_normal (truncated normal, variance 1/fan_in) for
    every conv and transposed-conv kernel, zeros for biases. ``fan_in`` is
    ``kh * kw * C_in`` for both kinds, as for the flax kernels."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                w = module.weight
                c_in = w.shape[0] if isinstance(module, nn.ConvTranspose2d) else w.shape[1]
                # flax divides by the truncated unit normal's stddev on [-2, 2]
                std = math.sqrt(1.0 / (c_in * w.shape[2] * w.shape[3])) / 0.87962566103423978
                w.copy_(_truncated_normal(w.shape, std, generator))
                nn.init.zeros_(module.bias)
