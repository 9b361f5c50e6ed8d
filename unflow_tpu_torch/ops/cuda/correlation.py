"""Wrappers of the CUDA correlation kernels under ``csrc/`` and the
``torch.autograd.Function`` over them.

Nine kernels. ``correlation_fwd.cu`` and ``correlation_bwd.cu`` hold one
template per function, run on the FP32 cores and instantiated for float32 and
for bfloat16 (bf16 in, f32 sums, bf16 out), the two dtype contracts of the JAX
package's TPU kernels:

  * forward: ``ops/pallas/correlation.py::_corr_fwd_chunk`` (f32) and
    ``ops/pallas/correlation_mxu.py::corr_fwd_mxu`` (bf16);
  * gradient to f1: ``_corr_bwd_f1_chunk`` (f32), ``corr_bwd_f1_mxu`` (bf16);
  * gradient to f2: ``_corr_bwd_f2_chunk`` (f32), ``corr_bwd_f2_mxu`` (bf16).

Each of the three bf16 functions has a second kernel on the tensor cores
(``correlation_fwd_mma.cu``, and both gradients in ``correlation_bwd_mma.cu``:
the banded matrix product of :mod:`unflow_tpu_torch.ops.correlation_banded`).
They carry the names ``corr_fwd_bf16``, ``corr_bwd_f1_bf16`` and
``corr_bwd_f2_bf16``; the FP32-core instantiations are ``corr_fwd_bf16_simt``,
``corr_bwd_f1_bf16_simt`` and ``corr_bwd_f2_bf16_simt``.
:func:`tensor_core_ok` decides between the two from the dtype and the
geometry alone, as ``_mxu_ok`` does in the JAX package. It is a dispatch and
no fallback: a launch that fails raises, and nothing switches kernels on an
error.

:class:`CorrelationFunction` takes the place of the ``custom_vjp``
``correlation_pallas``. Each launch adds one to its kernel's counter in
the port's registry (``utils/profiling.py::count_launch``), which
:func:`launch_counts` reads, so a run can show that its path went through
the kernels. CUDA tensors go through a kernel or the call raises; only CPU
tensors take the plain versions of :mod:`unflow_tpu_torch.ops.correlation`.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from unflow_tpu_torch.ops import correlation_tiled
from unflow_tpu_torch.ops.correlation import (
    correlation_bwd_f1_torch,
    correlation_bwd_f2_torch,
    correlation_torch,
    displacement_count,
)
from unflow_tpu_torch.ops.correlation_banded import (
    ROWS_CHOICES,
    row_groups,
    tensor_core_geometry_ok,
    tile_count,
)
from unflow_tpu_torch.utils import profiling

_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# op -> source under csrc/ of its FP32-core kernel
SOURCES = {"fwd": "correlation_fwd", "bwd_f1": "correlation_bwd", "bwd_f2": "correlation_bwd"}
# op -> source of its bf16 tensor-core kernel
TENSOR_CORE_SOURCES = {
    "fwd": "correlation_fwd_mma", "bwd_f1": "correlation_bwd_mma", "bwd_f2": "correlation_bwd_mma",
}
# kernel name -> (source, C symbol)
KERNELS = {}
for _op, _source in SOURCES.items():
    KERNELS[f"corr_{_op}_f32"] = (_source, f"unflow_corr_{_op}_f32")
    KERNELS[f"corr_{_op}_bf16_simt"] = (_source, f"unflow_corr_{_op}_bf16_simt")
    KERNELS[f"corr_{_op}_bf16"] = (TENSOR_CORE_SOURCES[_op], f"unflow_corr_{_op}_bf16")
_TENSOR_CORE_KERNELS = frozenset(f"corr_{op}_bf16" for op in TENSOR_CORE_SOURCES)


def tensor_core_ok(dtype: torch.dtype, c: int, max_displacement: int, stride: int) -> bool:
    """Whether bf16 maps of ``c`` channels take the tensor-core kernels: bf16,
    stride 1 or 2, 21 displacements per axis (FlowNetC's grid) and a multiple
    of 16 channels up to 256. Everything else takes the FP32-core kernels."""
    return dtype == torch.bfloat16 and tensor_core_geometry_ok(c, max_displacement, stride)


def kernel_name(op: str, dtype: torch.dtype, c: int, max_displacement: int, stride: int) -> str:
    """Name of the kernel of ``op`` (``fwd``, ``bwd_f1``, ``bwd_f2``) for maps
    of ``dtype`` with ``c`` channels and this displacement grid."""
    name = f"corr_{op}_{_DTYPE_SUFFIX[dtype]}"
    if name in _TENSOR_CORE_KERNELS and not tensor_core_ok(dtype, c, max_displacement, stride):
        name += "_simt"
    return name


def _named_kernel(
    op: str, dtype: torch.dtype, c: int, max_displacement: int, stride: int, kernel: str | None
) -> str:
    """The kernel to launch: the dispatch's, or ``kernel`` where the caller
    names one. Only a kernel of the same ``op`` and ``dtype`` can be named (the
    dispatch's own or its ``_simt`` twin): another op's symbol would write an
    output of another shape."""
    base = f"corr_{op}_{_DTYPE_SUFFIX[dtype]}"
    allowed = {name for name in (base, base + "_simt") if name in KERNELS}
    if kernel is not None and kernel not in allowed:
        raise ValueError(f"{kernel!r} is no kernel of {op} in {dtype}: {sorted(allowed)}")
    return kernel or kernel_name(op, dtype, c, max_displacement, stride)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    counted = profiling.counts()
    return {name: counted.get(name, 0) for name in KERNELS}


def reset_launch_counts() -> None:
    profiling.reset_counts(KERNELS)


def _symbol(name: str):
    from unflow_tpu_torch.ops.cuda.build import load

    source, symbol = KERNELS[name]
    fn = getattr(load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_geometry(max_displacement: int, stride: int) -> None:
    if max_displacement % stride:
        raise ValueError(
            f"max_displacement ({max_displacement}) must be divisible by stride ({stride})"
        )


def _check_grid(name: str, op: str, a: torch.Tensor, b: torch.Tensor, max_displacement: int,
                stride: int) -> None:
    """Raise before any launch where the kernel ``name`` has no grid for these
    shapes or its int offsets would overflow."""
    batch, h, w, c = b.shape
    if name in _TENSOR_CORE_KERNELS:
        # the banded kernels' grid is (column tiles, row groups, batch); the
        # fewest rows per block give the most row groups
        groups = row_groups(h, stride, min(ROWS_CHOICES[op]))
        if max(groups, batch) > 65535 or tile_count(w) * groups * batch == 0:
            raise ValueError(f"{name}: no launch grid for maps {tuple(b.shape)}")
        return
    # the register-tiled FP32-core kernels: (column tiles, row groups, batch x
    # displacement blocks) for the forward, (column tiles, row groups, batch x
    # channel slices) for the gradients; a pixel's offset in one batch
    # element's map, and for the gradients in its cotangent, kept as an int
    if op == "fwd":
        grid = correlation_tiled.launch_grid(tuple(b.shape), max_displacement, stride)
        volume = 0
    else:
        grid = correlation_tiled.gradient_launch_grid(tuple(b.shape), max_displacement, stride)
        volume = h * w * a.shape[3]
    if max(grid[1:]) > correlation_tiled.MAX_GRID_YZ or max(h * w * c, volume) >= 2**31:
        raise ValueError(f"{name}: no launch grid for maps {tuple(b.shape)}")


def _launch(
    op: str, a: torch.Tensor, b: torch.Tensor, out_channels: int, max_displacement: int, stride: int,
    kernel: str | None = None,
) -> torch.Tensor:
    """Check two CUDA inputs, allocate the output ``(B, H, W, out_channels)``
    and launch the kernel of ``op`` on the current stream of their device:
    the one :func:`kernel_name` picks, or ``kernel`` where the caller names
    one. The map's shape ``(B, H, W, C)`` is ``b``'s."""
    if b.dtype not in _DTYPE_SUFFIX or a.dtype != b.dtype:
        raise TypeError(f"CUDA correlation takes float32 or bfloat16: {a.dtype}, {b.dtype}")
    batch, h, w, c = b.shape
    name = _named_kernel(op, b.dtype, c, max_displacement, stride, kernel)
    _check_grid(name, op, a, b, max_displacement, stride)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"{op}: inputs must lie on one CUDA device: {a.device} vs {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{op}: the CUDA correlation needs contiguous NHWC inputs")
    if name in _TENSOR_CORE_KERNELS and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    out = torch.empty((batch, h, w, out_channels), dtype=b.dtype, device=b.device)
    # autograd runs backward on a thread of its own: enter the device there too
    with torch.cuda.device(b.device):
        err = _symbol(name)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, h, w, c,
            max_displacement, stride, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    profiling.count_launch(name)
    return out


def correlation_fwd(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2,
    kernel: str | None = None,
) -> torch.Tensor:
    """Cost volume ``(B, H, W, D*D)`` of NHWC feature maps ``(B, H, W, C)``.

    CUDA tensors go through the kernel (or the call raises); CPU tensors go
    through the plain version :func:`correlation_torch`. The result carries
    no autograd graph: :class:`CorrelationFunction` adds the gradients.
    ``kernel`` names the kernel to launch past :func:`tensor_core_ok` (a check
    that times ``corr_fwd_bf16_simt`` beside ``corr_fwd_bf16``).
    """
    _check_geometry(max_displacement, stride)
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"f1/f2 must be equal (B, H, W, C) shapes: {f1.shape} vs {f2.shape}")
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_torch(f1, f2, max_displacement, stride)
    d = displacement_count(max_displacement, stride)
    return _launch("fwd", f1, f2, d * d, max_displacement, stride, kernel)


def _check_cotangent(g: torch.Tensor, f: torch.Tensor, max_displacement: int, stride: int) -> None:
    _check_geometry(max_displacement, stride)
    d = displacement_count(max_displacement, stride)
    if f.dim() != 4 or g.shape != (*f.shape[:3], d * d):
        raise ValueError(
            f"cotangent {tuple(g.shape)} does not fit maps {tuple(f.shape)} with D*D = {d * d}"
        )


def correlation_bwd_f1(
    g: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2,
    kernel: str | None = None,
) -> torch.Tensor:
    """Gradient to ``f1`` for the cotangent ``g`` ``(B, H, W, D*D)``, in the
    dtype of ``f2``. CUDA tensors go through the kernel or raise; CPU tensors
    take :func:`correlation_bwd_f1_torch`. ``kernel`` as in
    :func:`correlation_fwd`."""
    _check_cotangent(g, f2, max_displacement, stride)
    if g.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_bwd_f1_torch(g, f2, max_displacement, stride)
    return _launch("bwd_f1", g, f2, f2.shape[3], max_displacement, stride, kernel)


def correlation_bwd_f2(
    g: torch.Tensor, f1: torch.Tensor, max_displacement: int = 20, stride: int = 2,
    kernel: str | None = None,
) -> torch.Tensor:
    """Gradient to ``f2``, in the dtype of ``f1``; routes as
    :func:`correlation_bwd_f1`. ``kernel`` as in :func:`correlation_fwd`."""
    _check_cotangent(g, f1, max_displacement, stride)
    if g.device.type == "cpu" and f1.device.type == "cpu":
        return correlation_bwd_f2_torch(g, f1, max_displacement, stride)
    return _launch("bwd_f2", g, f1, f1.shape[3], max_displacement, stride, kernel)


class CorrelationFunction(torch.autograd.Function):
    """``correlation(f1, f2, max_displacement, stride)`` with its forward and
    both gradients in the wrappers above (port of the ``custom_vjp``
    ``ops/pallas/correlation.py::correlation_pallas``). Only the gradients
    that are asked for are launched. The cotangent arrives in the dtype of
    the output and is made contiguous (one copy when autograd hands over a
    permuted view or a slice)."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride):
        ctx.save_for_backward(f1, f2)
        ctx.geometry = (max_displacement, stride)
        return correlation_fwd(f1, f2, max_displacement, stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g = g.contiguous()
        df1 = correlation_bwd_f1(g, f2, *ctx.geometry) if ctx.needs_input_grad[0] else None
        df2 = correlation_bwd_f2(g, f1, *ctx.geometry) if ctx.needs_input_grad[1] else None
        return df1, df2, None, None
