"""Dense bilinear backward warp, in NCHW.

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

``forward_warp`` (the splat behind ``mask_occlusion="disocc"``) is not ported
yet.
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


def forward_warp(flow: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(
        "forward_warp (and mask_occlusion='disocc') is not ported yet: ROADMAP item A9"
    )
