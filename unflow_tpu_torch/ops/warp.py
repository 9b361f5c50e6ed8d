"""Dense bilinear backward warp and forward splat, in NCHW.

Port of ``unflow_tpu/ops/warp.py::backward_warp`` (``backward_warp_jnp`` and
the packed route compute the same values and gradients): ``out[p] =
im[p + flow[p]]``, bilinear, with each of the four taps clamped to the frame
on its own (edge-extend), so a sample left of or above the frame collapses
to the border pixel and its gradient to the flow is zero there. The JAX
functions take ``(B, H, W, C)`` images and ``(B, H, W, 2)`` flows; these take
``(B, C, H, W)`` and ``(B, 2, H, W)``. ``flow[:, 0]`` is the horizontal
displacement (u, along W), ``flow[:, 1]`` the vertical one (v, along H).

The four taps are ``torch.gather`` on the flattened ``H*W`` axis, and autograd
gives the scatter-add of the gradient to the image. On CUDA that scatter-add
uses float atomics, so two runs of one step differ in the last bits. The
reference's 4C channel packing and its chunking of large gathers work around
the TPU's gather and have no counterpart here.

``forward_warp`` and ``forward_warp_image`` (ports of the JAX functions of
the same names) splat along the flow instead: each source pixel adds its
value, weighted by the bilinear weights, to the four pixels around its target.
Targets outside the frame receive nothing (the mass is dropped, never
clamped). The splat is ``index_add_`` on a flat ``(B, C, H*W)`` buffer, so on
CUDA it accumulates with float atomics and its last bits differ from run to
run.
"""

from __future__ import annotations

import torch


def backward_warp(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp of ``im`` ``(B, C, H, W)`` by ``flow`` ``(B, 2, H, W)``."""
    b, c, h, w = im.shape
    if flow.shape != (b, 2, h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not fit image {tuple(im.shape)}")
    # Coordinates in >= float32: bfloat16 cannot hold pixel positions past
    # 256, which would move the integer taps, not only the weights.
    ct = torch.promote_types(flow.dtype, torch.float32)
    gx = torch.arange(w, dtype=ct, device=flow.device)
    gy = torch.arange(h, dtype=ct, device=flow.device)[:, None]
    x = gx + flow[:, 0].to(ct)
    y = gy + flow[:, 1].to(ct)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(im.dtype)[:, None]
    wy = (y - y0).to(im.dtype)[:, None]
    flat = im.reshape(b, c, h * w)

    def tap(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
        idx = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        idx = idx.reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    top = tap(x0, y0) * (1.0 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1.0 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _splat(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear forward splat of ``values`` ``(B, C, H, W)`` along ``flow``
    ``(B, 2, H, W)``; out-of-frame mass is dropped."""
    b, c, h, w = values.shape
    ct = torch.promote_types(flow.dtype, torch.float32)
    x = torch.arange(w, dtype=ct, device=flow.device) + flow[:, 0].to(ct)
    y = torch.arange(h, dtype=ct, device=flow.device)[:, None] + flow[:, 1].to(ct)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(values.dtype)
    wy = (y - y0).to(values.dtype)
    # The batch is folded into the index, so one index_add serves every
    # example; an out-of-frame tap goes to one spare slot past the end,
    # which is dropped (a boolean mask would wait for the device).
    n = b * h * w
    base = (torch.arange(b, device=flow.device) * (h * w))[:, None, None]
    src = values.transpose(0, 1).reshape(c, n)
    out = values.new_zeros(c, n + 1)
    for iy, yw in ((y0, 1.0 - wy), (y0 + 1, wy)):
        for ix, xw in ((x0, 1.0 - wx), (x0 + 1, wx)):
            inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            idx = base + iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
            idx = torch.where(inb, idx, n).reshape(n)
            out = out.index_add(1, idx, src * (xw * yw).reshape(1, n))
    return out[:, :n].reshape(c, b, h, w).transpose(0, 1)


def forward_warp(flow: torch.Tensor) -> torch.Tensor:
    """Splat density map ``(B, 1, H, W)``: how much mass lands on each pixel
    when every pixel is pushed along ``flow`` ``(B, 2, H, W)``. Pixels where
    nothing lands are disoccluded."""
    return _splat(torch.ones_like(flow[:, :1]), flow)


def forward_warp_image(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Forward-warp ``im`` ``(B, C, H, W)`` by splatting (unnormalized
    accumulation)."""
    return _splat(im, flow)
