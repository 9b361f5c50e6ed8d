"""FlowNetC correlation (cost volume) op.

Port of ``unflow_tpu/ops/correlation.py``. For displacements ``(dy, dx)`` in
``{-P, ..., +P}`` with step ``s`` (``D = 2*(P//s) + 1`` values per axis):

    out[b, y, x, dy*D + dx] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c]

with reads of f2 outside the map taken as zero. Inputs and output keep the
JAX layout, NHWC: ``(B, H, W, C)`` in, ``(B, H, W, D*D)`` out, dy the slower
displacement axis. Sums are taken in float32 and cast to the input dtype,
the contract of the JAX package's Pallas kernels.

Two implementations: the plain versions here (:func:`correlation_torch`,
any device, differentiable by autograd, and its two gradients written out,
:func:`correlation_bwd_f1_torch` and :func:`correlation_bwd_f2_torch`), and
the CUDA kernels behind :mod:`unflow_tpu_torch.ops.cuda.correlation`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unflow_tpu_torch.ops import resolve_impl
from unflow_tpu_torch.parallel import spatial


def displacement_count(max_displacement: int, stride: int) -> int:
    return 2 * (max_displacement // stride) + 1


def correlation_torch(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2
) -> torch.Tensor:
    """Plain PyTorch version: one shifted multiply-reduce per displacement."""
    if max_displacement % stride:
        raise ValueError(
            f"max_displacement ({max_displacement}) must be divisible by stride ({stride})"
        )
    if f1.shape != f2.shape:
        raise ValueError(f"f1/f2 shape mismatch: {f1.shape} vs {f2.shape}")
    b, h, w, c = f1.shape
    d = displacement_count(max_displacement, stride)
    p, s = max_displacement, stride
    a = f1.float()
    f2p = F.pad(f2.float(), (0, 0, p, p, p, p))  # zero rows/cols around the map
    out = torch.empty((b, h, w, d * d), dtype=torch.float32, device=f1.device)
    for i in range(d):
        for j in range(d):
            shifted = f2p[:, i * s : i * s + h, j * s : j * s + w]
            out[..., i * d + j] = (a * shifted).sum(-1)
    return (out / c).to(f1.dtype)


def correlation_bwd_f1_torch(
    g: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2
) -> torch.Tensor:
    """Plain gradient of the cost volume to ``f1``, for the cotangent ``g``
    ``(B, H, W, D*D)``:

        df1[b, y, x, c] = (1/C) * sum_{dy,dx} g[b, y, x, dy*D + dx] * f2[b, y + dy, x + dx, c]

    summed in float32 and cast to the dtype of ``f2``.
    """
    b, h, w, c = f2.shape
    d = displacement_count(max_displacement, stride)
    p, s = max_displacement, stride
    gf = g.float()
    f2p = F.pad(f2.float(), (0, 0, p, p, p, p))
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=f2.device)
    for i in range(d):
        for j in range(d):
            out += gf[..., i * d + j, None] * f2p[:, i * s : i * s + h, j * s : j * s + w]
    return (out / c).to(f2.dtype)


def correlation_bwd_f2_torch(
    g: torch.Tensor, f1: torch.Tensor, max_displacement: int = 20, stride: int = 2
) -> torch.Tensor:
    """Plain gradient of the cost volume to ``f2``:

        df2[b, u, v, c] = (1/C) * sum_{dy,dx} g[b, u - dy, v - dx, dy*D + dx] * f1[b, u - dy, v - dx, c]

    with ``g`` and ``f1`` zero outside the map; summed in float32 over the
    zero-padded extent, cropped and cast to the dtype of ``f1``.
    """
    b, h, w, c = f1.shape
    d = displacement_count(max_displacement, stride)
    p, s = max_displacement, stride
    gf, a = g.float(), f1.float()
    acc = torch.zeros((b, h + 2 * p, w + 2 * p, c), dtype=torch.float32, device=f1.device)
    for i in range(d):
        for j in range(d):
            acc[:, i * s : i * s + h, j * s : j * s + w] += gf[..., i * d + j, None] * a
    return (acc[:, p : p + h, p : p + w] / c).to(f1.dtype)


def correlation(
    f1: torch.Tensor,
    f2: torch.Tensor,
    max_displacement: int = 20,
    stride: int = 2,
    impl: str | None = None,
) -> torch.Tensor:
    """Cost volume between two NHWC feature maps.

    ``impl``: ``auto`` (the kernels for CUDA tensors, the plain version for
    CPU tensors), ``torch`` (the plain version, differentiated by autograd)
    or ``cuda`` (the forward and gradient kernels behind one
    ``torch.autograd.Function``; raises for CPU tensors).

    Inside a ``SpatialContext`` the maps are W-slabs: ``f2`` takes a halo of
    ``max_displacement`` neighbour columns (:func:`correlation_slab`).
    """
    if spatial.current() is not None:
        p = max_displacement
        return correlation_slab(f1, spatial.halo_exchange(f2, p, p, dim=2), p, stride, impl)
    return _correlation(f1, f2, max_displacement, stride, impl)


def correlation_slab(
    f1: torch.Tensor,
    f2_ext: torch.Tensor,
    max_displacement: int = 20,
    stride: int = 2,
    impl: str | None = None,
) -> torch.Tensor:
    """The cost volume of one W-slab ``f1`` ``(B, H, w, C)``, given
    ``f2_ext`` ``(B, H, w + 2P, C)``: the slab of the second map with ``P =
    max_displacement`` columns of its neighbours on each side (zeros past the
    frame). ``f1`` is zero-extended to that width, the volume of the extended
    maps computed (by the kernels on CUDA) and cropped to the slab; the
    columns cropped away are the price, ``2P / w`` of the slab's work."""
    p = max_displacement
    if f2_ext.shape[2] != f1.shape[2] + 2 * p:
        raise ValueError(f"f2_ext {tuple(f2_ext.shape)} is not f1 {tuple(f1.shape)} + 2 x {p}")
    f1_ext = F.pad(f1, (0, 0, p, p))
    return _correlation(f1_ext, f2_ext.contiguous(), p, stride, impl)[:, :, p : p + f1.shape[2]]


def _correlation(f1, f2, max_displacement, stride, impl):
    if resolve_impl(impl, f1.device) == "cuda":
        from unflow_tpu_torch.ops.cuda.correlation import CorrelationFunction

        return CorrelationFunction.apply(f1, f2, max_displacement, stride)
    return correlation_torch(f1, f2, max_displacement, stride)
