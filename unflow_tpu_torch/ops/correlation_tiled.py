"""The register-tiled formulation of the FP32-core correlation forward, in
plain PyTorch.

``csrc/correlation_fwd.cu`` (``corr_fwd_f32`` and ``corr_fwd_bf16_simt``) cuts
the map's columns into *groups* of :data:`COLS` columns of one phase, ``x,
x + s, x + 2s, x + 3s``: such columns read the same f2 value at neighbouring
displacement columns, so one thread keeps a group's sums. The map's columns go
in runs of ``4*s``, each holding one group per phase; a block takes
:data:`GROUPS` consecutive groups, :data:`ROWS` output rows of one row phase
and :data:`DISP_ROWS` displacement rows, which meet only ``ROWS + DISP_ROWS -
1`` source rows of f2, and a block of ``J`` displacement columns
(:func:`displacement_block`). Window columns are stored by *slot*: a slot is a
window that several groups share (one for stride 1, one per phase for stride
2, one per group for any other stride), and column ``m`` of a slot is map
column ``first column of the slot's first group - P + s*(j0 + m)``.

This module holds that geometry, which the CUDA wrapper uses to check what it
launches, and :func:`correlation_tiled_torch`, which computes the cost volume
block by block with the same groups, slots, windows and zero fill: the model an
index mistake shows in without a card. Nothing on the main path calls it.
"""

from __future__ import annotations

import torch

from unflow_tpu_torch.ops.correlation import displacement_count

COLS = 4  # output columns per thread
GROUPS = 6  # column groups per block
ROWS = 8  # output rows per block, y0 + s*r
DISP_ROWS = 7  # displacement rows per block
MAX_GRID_YZ = 65535


def group_first_column(group: int, stride: int) -> int:
    """First column of column group ``group``; its columns follow at ``stride``."""
    return COLS * stride * (group // stride) + group % stride


def column_groups(w: int, stride: int) -> int:
    """Groups that cover a map of ``w`` columns."""
    return -(-w // (COLS * stride)) * stride


def displacement_block(d: int) -> int:
    """Displacement columns per block and thread: 11 where that covers the
    grid, else 21 (FlowNetC's)."""
    return 11 if d <= 11 else 21


def slot_count(stride: int) -> int:
    """Window slots per block: the kernel shares windows between groups for
    the strides it is instantiated for."""
    return {1: 1, 2: 2}.get(stride, GROUPS)


def slot_of_group(g: int, stride: int) -> tuple[int, int]:
    """``(slot, first window column)`` of the block's group ``g``."""
    if stride == 1:
        return 0, COLS * g
    if stride == 2:
        return g % 2, COLS * (g // 2)
    return g, 0


def launch_grid(
    shape: tuple[int, int, int, int], max_displacement: int, stride: int
) -> tuple[int, int, int]:
    """The kernel's grid for maps ``(B, H, W, C)``: column tiles, row groups,
    batch x displacement blocks."""
    b, h, w, _ = shape
    d = displacement_count(max_displacement, stride)
    tiles = -(-column_groups(w, stride) // GROUPS)
    row_groups = -(-h // (stride * ROWS)) * stride
    blocks = -(-d // DISP_ROWS) * -(-d // displacement_block(d))
    return tiles, row_groups, b * blocks


def correlation_tiled_torch(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2
) -> torch.Tensor:
    """The cost volume as ``csrc/correlation_fwd.cu`` computes it."""
    p, s = max_displacement, stride
    b, h, w, c = f1.shape
    d = displacement_count(p, s)
    jn = displacement_block(d)
    slots = slot_count(s)
    slot_cols = COLS * (GROUPS // slots) + jn - 1
    a32, b32 = f1.float(), f2.float()
    out = torch.zeros((b, h, w, d * d), dtype=torch.float32)
    tiles, row_groups, _ = launch_grid(tuple(f1.shape), p, s)
    for tile in range(tiles):
        group_x = [group_first_column(tile * GROUPS + g, s) for g in range(GROUPS)]
        for row_group in range(row_groups):
            y0 = (row_group // s) * (s * ROWS) + row_group % s
            for i0 in range(0, d, DISP_ROWS):
                for j0 in range(0, d, jn):
                    # the staged windows: [source row t][slot][column m]
                    windows = torch.zeros((ROWS + DISP_ROWS - 1, slots, slot_cols, b, c))
                    for t in range(ROWS + DISP_ROWS - 1):
                        y2 = y0 + s * (i0 + t) - p
                        if not 0 <= y2 < h:
                            continue
                        for slot in range(slots):
                            for m in range(slot_cols):
                                x2 = group_x[slot] - p + s * (j0 + m)
                                if 0 <= x2 < w:
                                    windows[t, slot, m] = b32[:, y2, x2]
                    for g in range(GROUPS):
                        slot, first = slot_of_group(g, s)
                        for r in range(ROWS):
                            y = y0 + s * r
                            if y >= h:
                                continue
                            for il in range(min(DISP_ROWS, d - i0)):
                                window = windows[r + il, slot, first : first + jn + COLS - 1]
                                for k in range(COLS):
                                    x = group_x[g] + s * k
                                    if x >= w:
                                        continue
                                    nj = min(jn, d - j0)
                                    # column k meets window column m at displacement j = m - k
                                    sums = (window[k : k + nj] * a32[:, y, x]).sum(-1)  # (nj, B)
                                    at = (i0 + il) * d + j0
                                    out[:, y, x, at : at + nj] = sums.T
    return (out / c).to(f1.dtype)
