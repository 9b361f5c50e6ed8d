"""Wrapper of the fused unsupervised-loss kernels (``csrc/loss.cu``) and the
``torch.autograd.Function`` over them.

:class:`FusedLoss` computes ``losses/unsupervised.py::unsupervised_loss``'s
values vector for the terms in :data:`TERMS` (``values[5 * level + term]``,
0 for an inactive term, the weighted total last) from the full-resolution
frames and both flow pyramids: four launches forward (``loss_pyramid``,
``loss_pixel``, ``loss_stencil``, ``loss_finish``) and two backward
(``loss_grad``, ``loss_grad_add``), whatever the number of scales. Its
gradients go to both flow pyramids only; the frames take none. Every sum
runs in a fixed order or in integers, so the values and the gradients repeat
to the bit from run to run.
``ops/loss_gather.py`` states the same arithmetic in plain PyTorch.

Each launch adds one to its kernel's counter in the port's registry
(``utils/profiling.py::count_launch``), which :func:`launch_counts` reads. Every
buffer is allocated with ``torch.empty`` or ``torch.zeros`` on the current
stream and no call waits for the device, so a CUDA graph captures the
forward and the backward as they are. The source is built at the first
call (``ops/cuda/build.py``), never at import.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from unflow_tpu_torch.utils import profiling

TERMS = ("occ", "fb", "ternary", "photo", "smooth_2nd")
SOURCE = "loss"
FORWARD_KERNELS = ("loss_pyramid", "loss_pixel", "loss_stencil", "loss_finish")
BACKWARD_KERNELS = ("loss_grad", "loss_grad_add")
KERNELS = FORWARD_KERNELS + BACKWARD_KERNELS
MAX_LEVELS = 5
MAX_RADIUS = 3
# the kernels' blocks (csrc/loss.cu): one thread a pixel and direction in
# loss_pixel, tiles of TILE_H x TILE_W pixels in loss_stencil and loss_grad
THREADS = 256
TILE_H, TILE_W = 8, 32
PIXEL_SLOTS, STENCIL_SLOTS = 3, 5  # per-block partial sums of each kernel
FIELDS = 4  # per pixel and direction: own grey, warped grey, mask, census distance


class Spec(NamedTuple):
    """What the values depend on besides the tensors: the terms' weights in
    :data:`TERMS` order (0: inactive), and per level its layer weight, its
    flow's scale to pixels, its census radius and its border mask's distance
    (0: none)."""

    term_weights: tuple
    layer_weights: tuple
    scales: tuple
    radii: tuple
    borders: tuple


def border_distance(h: int, w: int, distance: int) -> int:
    """The border mask's distance as ``create_border_mask`` clamps it."""
    return min(distance, (min(h, w) - 1) // 2)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    counted = profiling.counts()
    return {name: counted.get(name, 0) for name in KERNELS}


def reset_launch_counts() -> None:
    profiling.reset_counts(KERNELS)


def _symbol(name: str):
    from unflow_tpu_torch.ops.cuda.build import load

    fn = getattr(load(SOURCE), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _blocks(batch: int, shapes: list) -> tuple[int, int]:
    """Blocks of ``loss_pixel`` and of ``loss_stencil`` over every level."""
    pixel = sum(-(-2 * batch * h * w // THREADS) for h, w in shapes)
    stencil = sum(2 * batch * -(-h // TILE_H) * -(-w // TILE_W) for h, w in shapes)
    return pixel, stencil


def _flat(flow: torch.Tensor) -> torch.Tensor:
    """``flow`` if each example is contiguous (a batch stride of its own is
    fine: the even or odd rows of a stacked pyramid), else a copy."""
    _, c, h, w = flow.shape
    return flow if flow.stride()[1:] == (h * w, w, 1) else flow.contiguous()


class _Buffers(NamedTuple):
    shapes: list
    pyr: list  # per level, [2 frames][B][3][h][w]
    fields: list  # per level, [2 directions][FIELDS][B][h][w]
    partials: torch.Tensor


def _buffers(batch: int, shapes: list, device) -> _Buffers:
    sizes = [(2 * batch * 3 * h * w, 2 * FIELDS * batch * h * w) for h, w in shapes]
    pixel, stencil = _blocks(batch, shapes)
    room = PIXEL_SLOTS * pixel + STENCIL_SLOTS * stencil
    flat = torch.empty(sum(a + b for a, b in sizes) + room, dtype=torch.float32, device=device)
    pyr, fields, at = [], [], 0
    for a, b in sizes:
        pyr.append(flat[at:at + a])
        fields.append(flat[at + a:at + a + b])
        at += a + b
    return _Buffers(shapes, pyr, fields, flat[at:])


def _arrays(spec: Spec, im1, im2, fws, bws, buffers: _Buffers, values, grad_values, grads, taps):
    """The kernels' arguments as the flat arrays ``csrc/loss.cu::build``
    reads: pointers, integers and floats."""
    active = sum(1 << t for t, weight in enumerate(spec.term_weights) if weight)
    ptrs = [im1.data_ptr(), im2.data_ptr(), buffers.partials.data_ptr(),
            0 if values is None else values.data_ptr(),
            0 if grad_values is None else grad_values.data_ptr()]
    ints = [len(fws), fws[0].shape[0], active, *im1.stride(), *im2.stride()]
    floats = list(spec.term_weights)
    for i, (fw, bw) in enumerate(zip(fws, bws)):
        ptrs += [fw.data_ptr(), bw.data_ptr(), buffers.pyr[i].data_ptr(), buffers.fields[i].data_ptr()]
        ptrs += [0, 0, 0, 0] if grads is None else [
            grads[0][i].data_ptr(), grads[1][i].data_ptr(), taps[0][i].data_ptr(), taps[1][i].data_ptr()]
        ints += [*buffers.shapes[i], spec.radii[i], spec.borders[i], fw.stride(0), bw.stride(0)]
        floats += [spec.scales[i], spec.layer_weights[i]]
    return ((ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_longlong * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats), buffers.partials.numel())


def _call(name: str, arrays, device) -> None:
    # autograd runs backward on a thread of its own: enter the device there too
    with torch.cuda.device(device):
        err = _symbol(name)(*arrays, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: {'bad geometry' if err < 0 else f'cudaError {err}'}")


def check(spec: Spec, im1: torch.Tensor, im2: torch.Tensor, flows_fw, flows_bw) -> None:
    """Raise where the kernels cannot take these tensors."""
    levels = len(flows_fw)
    if not 1 <= levels <= MAX_LEVELS or len(flows_bw) != levels:
        raise ValueError(f"the fused loss takes 1 to {MAX_LEVELS} levels a direction")
    b, _, h, w = im1.shape
    if im1.shape != (b, 3, h, w) or im2.shape != im1.shape:
        raise ValueError(f"frames {tuple(im1.shape)} and {tuple(im2.shape)}: want two (B, 3, H, W)")
    for i, (fw, bw) in enumerate(zip(flows_fw, flows_bw)):
        want = (b, 2, h // (4 << i), w // (4 << i))
        if fw.shape != want or bw.shape != want or h % (4 << i) or w % (4 << i):
            raise ValueError(f"level {i}: flows {tuple(fw.shape)}, {tuple(bw.shape)} for frames "
                             f"{tuple(im1.shape)}")
        if not 1 <= spec.radii[i] <= MAX_RADIUS:
            raise ValueError(f"level {i}: census radius {spec.radii[i]} outside 1..{MAX_RADIUS}")
    tensors = [im1, im2, *flows_fw, *flows_bw]
    if any(t.dtype != torch.float32 or t.device != im1.device or not t.is_cuda for t in tensors):
        raise TypeError("the fused loss takes float32 CUDA tensors on one device")


class FusedLoss(torch.autograd.Function):
    """``FusedLoss.apply(spec, im1, im2, *flows_fw, *flows_bw)``: the values
    vector. The backward recomputes from the saved frames and flows, the
    frames' pyramid and the per-pixel fields the forward wrote."""

    @staticmethod
    def forward(ctx, spec: Spec, im1, im2, *flows):
        levels = len(flows) // 2
        fws = [_flat(f) for f in flows[:levels]]
        bws = [_flat(f) for f in flows[levels:]]
        check(spec, im1, im2, fws, bws)
        buffers = _buffers(im1.shape[0], [tuple(f.shape[-2:]) for f in fws], im1.device)
        values = torch.empty(len(TERMS) * levels + 1, dtype=torch.float32, device=im1.device)
        _call("unflow_loss_forward",
              _arrays(spec, im1, im2, fws, bws, buffers, values, None, None, None), im1.device)
        for name in FORWARD_KERNELS:
            profiling.count_launch(name)
        # saved, so that autograd raises where a caller writes into a frame or
        # a flow before the backward; the scratch fields stay on ctx
        ctx.save_for_backward(im1, im2, *fws, *bws)
        ctx.spec, ctx.buffers = spec, buffers
        return values

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_values):
        im1, im2, *flows = ctx.saved_tensors
        levels = len(flows) // 2
        fws, bws = flows[:levels], flows[levels:]
        # every level's forward then backward gradient, back to back (the
        # layout loss_grad_add reads), and as much room for the taps' sums
        sizes = [f.numel() for f in fws]
        flat = torch.empty(2 * sum(sizes), dtype=torch.float32, device=im1.device)
        flat_taps = torch.zeros(2 * sum(sizes), dtype=torch.int64, device=im1.device)
        grads, taps, at = ([], []), ([], []), 0
        for d in range(2):
            for f, n in zip(fws, sizes):
                grads[d].append(flat[at:at + n].view(f.shape))
                taps[d].append(flat_taps[at:at + n])
                at += n
        grad_values = grad_values.float().contiguous()
        _call("unflow_loss_backward",
              _arrays(ctx.spec, im1, im2, fws, bws, ctx.buffers, None, grad_values, grads, taps),
              im1.device)
        for name in BACKWARD_KERNELS:
            profiling.count_launch(name)
        need = ctx.needs_input_grad[3:]
        return (None, None, None, *(g if n else None for g, n in zip(grads[0] + grads[1], need)))
