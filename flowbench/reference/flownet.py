"""FlowNetC, FlowNetS and their cascades, written plainly from the papers.

FlowNet (Dosovitskiy et al., ICCV 2015) at its published widths, in the
arrangement UnFlow (Meister, Hur & Roth, AAAI 2018) trains: a FlowNetC or
FlowNetS first stage, FlowNetS refinement stages fed ``[im1, im2, im2 warped
by the previous flow, that flow, the brightness error]``, and one decoder
that predicts flow at five scales, finest (1/4 resolution) first. Every conv
pads as TensorFlow's ``SAME`` does (an odd pad's extra pixel on the high
side), every activation is a leaky ReLU of slope 0.1, and the flows are in
quarter-resolution pixels divided by ``FLOW_SCALE``.

Parameters are a flat ``{name: tensor}`` dict, named as the stages' modules
(``stage0_C.conv1.weight``); convs hold ``(C_out, C_in, k, k)`` weights and
the 4x4/2 transposed convs ``(C_in, C_out, 4, 4)``. The towers run in
``dtype`` with the float32 parameters cast at each use; the correlation sums
in float32; the flows come out as float32.

``quant`` stands in for a lower precision: a function applied to every conv
input and weight and to both correlation maps before use (the control of
``flowbench/reference/quant.py``). Nothing here is tuned for speed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FLOW_SCALE = 5.0
LEAK = 0.1

# (name, C_in, C_out, kernel, stride); C_in None: the stage's own input
_TRUNK = [
    ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
    ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
    ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1),
]
_DECODER_CONVS = [
    ("predict_flow6", 1024), ("predict_flow5", 512 + 512 + 2),
    ("predict_flow4", 512 + 256 + 2), ("predict_flow3", 256 + 128 + 2),
    ("predict_flow2", 128 + 64 + 2),
]
_DECODER_DECONVS = [
    ("deconv5", 1024, 512), ("upflow6to5", 2, 2),
    ("deconv4", 512 + 512 + 2, 256), ("upflow5to4", 2, 2),
    ("deconv3", 512 + 256 + 2, 128), ("upflow4to3", 2, 2),
    ("deconv2", 256 + 128 + 2, 64), ("upflow3to2", 2, 2),
]


def displacements(max_displacement: int, stride: int) -> int:
    return 2 * (max_displacement // stride) + 1


def stage_convs(kind: str, in_channels: int, d: int) -> list[tuple]:
    """The convs of one FlowNetC (``kind`` C) or FlowNetS stage before its
    decoder."""
    convs = [("conv1", in_channels, 64, 7, 2), ("conv2", 64, 128, 5, 2),
             ("conv3", 128, 256, 5, 2)]
    if kind == "C":
        convs += [("conv_redir", 256, 32, 1, 1), ("conv3_1", d * d + 32, 256, 3, 1)]
    else:
        convs += [("conv3_1", 256, 256, 3, 1)]
    return convs + _TRUNK


def param_shapes(spec: str, max_displacement: int = 20, stride: int = 2) -> dict[str, tuple]:
    """``{name: shape}`` of every parameter of the cascade ``spec``, in
    module order."""
    d = displacements(max_displacement, stride)
    shapes = {}
    for i, ch in enumerate(spec):
        kind = ch.upper()
        prefix = f"stage{i}_{kind}."
        in_ch = 3 if kind == "C" else (6 if i == 0 else 12)
        for name, cin, cout, k, _ in stage_convs(kind, in_ch, d):
            shapes[prefix + name + ".weight"] = (cout, cin, k, k)
            shapes[prefix + name + ".bias"] = (cout,)
        for name, cin in _DECODER_CONVS:
            shapes[prefix + f"decoder.{name}.weight"] = (2, cin, 3, 3)
            shapes[prefix + f"decoder.{name}.bias"] = (2,)
        for name, cin, cout in _DECODER_DECONVS:
            shapes[prefix + f"decoder.{name}.weight"] = (cin, cout, 4, 4)
            shapes[prefix + f"decoder.{name}.bias"] = (cout,)
    return shapes


def fan_in(name: str, shape: tuple) -> int:
    """Inputs summed into one output of a weight: ``C_in * k * k``."""
    transposed = any(f".{n}." in name for n, _, _ in _DECODER_DECONVS)
    return (shape[0] if transposed else shape[1]) * shape[2] * shape[3]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Net:
    """The cascade ``spec`` over a parameter dict."""

    def __init__(self, spec: str, params: dict[str, torch.Tensor], dtype=torch.bfloat16,
                 max_displacement: int = 20, stride: int = 2, quant=None):
        self.spec, self.p, self.dtype = spec, params, dtype
        self.max_displacement, self.stride = max_displacement, stride
        self.q = quant or (lambda x: x)

    def _w(self, name):
        return self.q(self.p[name + ".weight"].to(self.dtype)), self.p[name + ".bias"].to(self.dtype)

    def conv(self, x, name, stride):
        w, b = self._w(name)
        k = w.shape[-1]
        top, bottom = _same_pads(x.shape[-2], k, stride)
        left, right = _same_pads(x.shape[-1], k, stride)
        x = F.pad(self.q(x), (left, right, top, bottom))
        return F.conv2d(x, w, b, stride)

    def deconv(self, x, name):
        w, b = self._w(name)
        return F.conv_transpose2d(self.q(x), w, b, stride=2, padding=1)

    def correlation(self, f1, f2):
        """``out[:, dy*D + dx] = mean_c f1[:, c, y, x] * f2[:, c, y + dy, x + dx]``
        over displacements ``-P..P`` in steps of the stride, f2 zero outside
        the map; summed in float32."""
        p, s = self.max_displacement, self.stride
        d = displacements(p, s)
        h, w = f1.shape[-2:]
        a = self.q(f1).float()
        b = F.pad(self.q(f2).float(), (p, p, p, p))
        out = [(a * b[:, :, i * s:i * s + h, j * s:j * s + w]).sum(1)
               for i in range(d) for j in range(d)]
        return (torch.stack(out, 1) / f1.shape[1]).to(self.dtype)

    def trunk(self, prefix, x):
        c4 = leaky(self.conv(leaky(self.conv(x, prefix + "conv4", 2)), prefix + "conv4_1", 1))
        c5 = leaky(self.conv(leaky(self.conv(c4, prefix + "conv5", 2)), prefix + "conv5_1", 1))
        c6 = leaky(self.conv(leaky(self.conv(c5, prefix + "conv6", 2)), prefix + "conv6_1", 1))
        return c4, c5, c6

    def decoder(self, prefix, skip2, skip3, c4, c5, c6):
        prefix += "decoder."
        flows = []
        x, skips = c6, [c5, c4, skip3, skip2]
        levels = [("6", "5"), ("5", "4"), ("4", "3"), ("3", "2")]
        for (lvl, nxt), skip in zip(levels, skips):
            flow = self.conv(x, prefix + f"predict_flow{lvl}", 1)
            flows.append(flow)
            up = self.deconv(flow, prefix + f"upflow{lvl}to{nxt}")
            x = torch.cat([skip, leaky(self.deconv(x, prefix + f"deconv{nxt}")), up], 1)
        flows.append(self.conv(x, prefix + "predict_flow2", 1))
        return [f.float() for f in reversed(flows)]

    def flownet_c(self, prefix, im1, im2):
        def tower(x):
            c2 = leaky(self.conv(leaky(self.conv(x, prefix + "conv1", 2)), prefix + "conv2", 2))
            return c2, leaky(self.conv(c2, prefix + "conv3", 2))

        c2a, c3a = tower(im1.to(self.dtype))
        _, c3b = tower(im2.to(self.dtype))
        corr = leaky(self.correlation(c3a, c3b))
        redir = leaky(self.conv(c3a, prefix + "conv_redir", 1))
        c3_1 = leaky(self.conv(torch.cat([corr, redir], 1), prefix + "conv3_1", 1))
        return self.decoder(prefix, c2a, c3_1, *self.trunk(prefix, c3_1))

    def flownet_s(self, prefix, x):
        x = x.to(self.dtype)
        c2 = leaky(self.conv(leaky(self.conv(x, prefix + "conv1", 2)), prefix + "conv2", 2))
        c3 = leaky(self.conv(leaky(self.conv(c2, prefix + "conv3", 2)), prefix + "conv3_1", 1))
        return self.decoder(prefix, c2, c3, *self.trunk(prefix, c3))

    def __call__(self, im1, im2):
        """Normalized ``(B, 3, H, W)`` frames -> one 5-scale flow list per
        stage. A frozen (lowercase) stage's flows carry no gradient."""
        h, w = im1.shape[-2:]
        stages, prev = [], None
        for i, ch in enumerate(self.spec):
            prefix = f"stage{i}_{ch.upper()}."
            if i == 0:
                flows = (self.flownet_c(prefix, im1, im2) if ch.upper() == "C"
                         else self.flownet_s(prefix, torch.cat([im1, im2], 1)))
            else:
                warped = backward_warp(im2.float(), prev)
                err = torch.sqrt(((im1.float() - warped) ** 2).sum(1, keepdim=True) + 1e-6)
                flows = self.flownet_s(prefix, torch.cat([im1.float(), im2.float(), warped, prev, err], 1))
            if ch.islower():
                flows = [f.detach() for f in flows]
            stages.append(flows)
            prev = full_res_flow(flows, h, w)
        return stages


def leaky(x):
    return F.leaky_relu(x, LEAK)


def full_res_flow(flows, height: int, width: int) -> torch.Tensor:
    """The finest flow upsampled bilinearly (half-pixel centres) to
    ``(height, width)``, in pixels."""
    return F.interpolate(flows[0].float() * (4.0 * FLOW_SCALE), size=(height, width),
                         mode="bilinear", align_corners=False)


def backward_warp(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``out[p] = im[p + flow[p]]``, bilinear, the sample clamped to the
    frame; ``flow[:, 0]`` runs along W."""
    b, _, h, w = im.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=im.device, dtype=torch.float32),
                            torch.arange(w, device=im.device, dtype=torch.float32), indexing="ij")
    x = (gx + flow[:, 0].float()).clamp(0, w - 1) * (2.0 / max(w - 1, 1)) - 1.0
    y = (gy + flow[:, 1].float()).clamp(0, h - 1) * (2.0 / max(h - 1, 1)) - 1.0
    grid = torch.stack([x, y], -1)
    return F.grid_sample(im, grid.to(im.dtype), mode="bilinear", padding_mode="border",
                         align_corners=True)
