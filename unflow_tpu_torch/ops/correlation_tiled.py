"""The register-tiled formulation of the FP32-core correlation forward and of
its two gradients, in plain PyTorch.

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

``csrc/correlation_bwd.cu`` (both gradients, f32 and the bf16 ``_simt`` twins)
takes the same groups and slots, :data:`GRAD_GROUPS` of them per block (one
warp per output row: 4 groups x 8 threads of :data:`GRAD_CHANNELS` channels),
:data:`GRAD_ROWS` output rows of one row phase and a slice of
:data:`GRAD_SLICE` channels. The displacements are the reduction: the block
walks the D displacement rows (``n = 0 .. D-1``; displacement row ``n`` for
df1, ``D-1-n`` for df2), and output row ``r`` meets source row ``t = r + n``,
map row ``y0 - P + s*t``, at every step. So the rows in use slide by one per
step through a ring of ``GRAD_ROWS + 1`` staged source rows: step ``n``
stages the row that step ``n + 1`` needs first. The cotangent comes as
a *band* per output row and group, ``band[m][k]``: the value that output
column ``k`` of the group multiplies with window column ``m`` (displacement
column ``j0 + m - k``), zero off the band. A grid wider than ``J``
(:func:`displacement_block`) is walked in blocks of ``J`` inside the block.

This module holds that geometry, which the CUDA wrapper uses to check what it
launches, and :func:`correlation_tiled_torch`,
:func:`correlation_bwd_f1_tiled_torch` and
:func:`correlation_bwd_f2_tiled_torch`, which compute block by block with the
same groups, slots, windows, ring, band and zero fill: the models an index
mistake shows in without a card. Nothing on the main path calls them.
"""

from __future__ import annotations

import torch

from unflow_tpu_torch.ops.correlation import displacement_count

COLS = 4  # output columns per thread
GROUPS = 6  # column groups per block
ROWS = 8  # output rows per block, y0 + s*r
DISP_ROWS = 7  # displacement rows per block
MAX_GRID_YZ = 65535
GRAD_GROUPS = 4  # column groups per gradient block: one warp per output row
GRAD_CHANNELS = 8  # channels per gradient thread
GRAD_SLICE = 8 * GRAD_CHANNELS  # channels per gradient block
GRAD_ROWS = 4  # output rows per gradient block, y0 + s*r


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


def slot_count(stride: int, groups: int = GROUPS) -> int:
    """Window slots of a block of ``groups`` groups: the kernels share windows
    between groups for the strides they are instantiated for."""
    return {1: 1, 2: 2}.get(stride, groups)


def slot_of_group(g: int, stride: int) -> tuple[int, int]:
    """``(slot, first window column)`` of the block's group ``g`` (any number
    of groups per block)."""
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


def first_row(row_group: int, stride: int, rows: int) -> int:
    """First output row of a row group; its rows follow at ``stride``."""
    return (row_group // stride) * (stride * rows) + row_group % stride


def gradient_launch_grid(
    shape: tuple[int, int, int, int], max_displacement: int, stride: int
) -> tuple[int, int, int]:
    """The gradient kernels' grid for maps ``(B, H, W, C)``: column tiles of
    :data:`GRAD_GROUPS` groups, row groups, batch x channel slices."""
    b, h, w, c = shape
    tiles = -(-column_groups(w, stride) // GRAD_GROUPS)
    row_groups = -(-h // (stride * GRAD_ROWS)) * stride
    return tiles, row_groups, b * -(-c // GRAD_SLICE)


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
            y0 = first_row(row_group, s, ROWS)
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


def _gradient_tiled(g: torch.Tensor, f: torch.Tensor, p: int, s: int, wrt: str) -> torch.Tensor:
    """A gradient as ``csrc/correlation_bwd.cu`` computes it; ``f`` is the
    other map (f2 for ``wrt="f1"``, f1 for ``wrt="f2"``)."""
    b, h, w, c = f.shape
    d = displacement_count(p, s)
    jn = displacement_block(d)
    rows, ring_rows = GRAD_ROWS, GRAD_ROWS + 1
    slots = slot_count(s, GRAD_GROUPS)
    slot_cols = COLS * (GRAD_GROUPS // slots) + jn - 1
    g32 = g.float().reshape(b, h, w, d, d)
    out = torch.zeros((b, h, w, c), dtype=torch.float32)
    tiles, row_groups, _ = gradient_launch_grid(tuple(f.shape), p, s)
    for tile in range(tiles):
        group_x = [group_first_column(tile * GRAD_GROUPS + gi, s) for gi in range(GRAD_GROUPS)]
        for row_group in range(row_groups):
            y0 = first_row(row_group, s, rows)
            for c0 in range(0, c, GRAD_SLICE):
                fs = f[..., c0 : c0 + GRAD_SLICE].float()
                acc = torch.zeros((rows, GRAD_GROUPS, COLS, b, fs.shape[-1]))
                for j0 in range(0, d, jn):
                    # ring[t % ring_rows]: source row t, map row y0 - p + s*t,
                    # as [slot][column m]; columns outside the map stay zero
                    ring = torch.zeros((ring_rows, slots, slot_cols, b, fs.shape[-1]))

                    def stage(t):
                        y2 = y0 - p + s * t
                        if not 0 <= y2 < h:
                            return  # no row of the block reads it
                        for slot in range(slots):
                            for m in range(slot_cols):
                                x2 = group_x[slot] - p + s * (j0 + m)
                                if 0 <= x2 < w:
                                    ring[t % ring_rows, slot, m] = fs[:, y2, x2]

                    for t in range(rows):
                        stage(t)
                    for n in range(d):
                        if n + 1 < d:
                            stage(n + rows)  # the slot that step n - 1 read
                        i = n if wrt == "f1" else d - 1 - n
                        for r in range(rows):
                            y = y0 + s * r
                            ysrc = y0 - p + s * (r + n)
                            if y >= h or not 0 <= ysrc < h:
                                continue  # nothing to add
                            window = ring[(r + n) % ring_rows]
                            for gi in range(GRAD_GROUPS):
                                band = torch.zeros((jn + COLS - 1, COLS, b))
                                for k in range(COLS):
                                    for jj in range(min(jn, d - j0)):
                                        m = k + jj  # column k meets window column m at j0 + jj
                                        if wrt == "f1":
                                            x = group_x[gi] + s * k
                                            if x < w:
                                                band[m, k] = g32[:, y, x, i, j0 + jj]
                                        else:
                                            x = group_x[gi] - p + s * (j0 + m)
                                            if 0 <= x < w:
                                                band[m, k] = g32[:, ysrc, x, i, d - 1 - j0 - jj]
                                slot, first = slot_of_group(gi, s)
                                win = window[slot, first : first + jn + COLS - 1]
                                acc[r, gi] += torch.einsum("mkb,mbc->kbc", band, win)
                for r in range(rows):
                    y = y0 + s * r
                    for gi in range(GRAD_GROUPS):
                        for k in range(COLS):
                            x = group_x[gi] + s * k
                            if y < h and x < w:
                                out[:, y, x, c0 : c0 + GRAD_SLICE] = acc[r, gi, k]
    return (out / c).to(f.dtype)


def correlation_bwd_f1_tiled_torch(
    g: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2
) -> torch.Tensor:
    """The gradient to f1 as ``csrc/correlation_bwd.cu`` computes it: the
    band of output row ``y`` at displacement row ``i`` holds
    ``g[y, x_k, i*D + j0 + m - k]``, the group's own pixels."""
    return _gradient_tiled(g, f2, max_displacement, stride, "f1")


def correlation_bwd_f2_tiled_torch(
    g: torch.Tensor, f1: torch.Tensor, max_displacement: int = 20, stride: int = 2
) -> torch.Tensor:
    """The gradient to f2 as ``csrc/correlation_bwd.cu`` computes it: the
    displacement rows walked downwards, the band at the window's pixels of the
    source row, ``g[src, window pixel m, i*D + (D-1) - (j0 + m - k)]``."""
    return _gradient_tiled(g, f1, max_displacement, stride, "f2")
