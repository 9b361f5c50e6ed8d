"""The banded-product formulation of the correlation, in plain PyTorch.

The tensor-core kernels (``csrc/correlation_fwd_mma.cu`` and the two of
``csrc/correlation_bwd_mma.cu``) do not compute the cost volume as shifted
multiply-reduces. They cut the map into tiles of :data:`TILE_X` output
columns and split each tile's columns by their phase ``p = x mod s`` (an
output column only ever meets window columns of its own phase). Per phase,
tile row ``k`` (output column ``x0 + s*k + p``) and window column ``m`` (map
column ``x0 - P + s*m + p``) meet at displacement ``j = m - k``, so

  * forward: the cost values of one displacement row ``i`` are the band
    ``G[k, k + j]`` of a small product ``G = A . B^T`` of the f1 tile rows
    ``A`` (16 x C) with the f2 row window ``B`` (:data:`BAND_COLS` x C);
  * gradient to f2: the tile accumulates ``A^ . F`` over the displacement
    rows, where ``F`` is the f1 row window and ``A^`` (16 x
    :data:`BAND_K`) holds the cotangent on the band,
    ``A^[k, m] = g[y, x0 - P + s*m + p, i*D + (D-1) - (m-k)]``, and zeros
    elsewhere;
  * gradient to f1: the same product with the f2 row window as ``F`` and the
    cotangent of the tile's own pixels on the band,
    ``A^[k, m] = g[y, x0 + s*k + p, i*D + (m-k)]``.

This module holds the index helpers of that geometry, which the CUDA wrappers
use to check what they launch, and three functions that compute the forward
and the gradients the kernels' way with ``torch.matmul`` on the small operands:
the same tiles, phases, windows, zero fill and band. They are the model an
index mistake shows in without a card; nothing on the main path calls them.
"""

from __future__ import annotations

import torch

from unflow_tpu_torch.ops.correlation import displacement_count

TILE_X = 64  # output columns per block
MMA_ROWS = 16  # rows of one matrix-instruction tile (m16n8k16)
# Output rows of one row phase per block, most first: rows y and y + s share all
# but one of their source rows, so more rows per block mean less traffic from
# L2, as long as every SM still gets a block (rows_per_block).
FWD_ROWS_CHOICES = (4, 2)
BWD_F1_ROWS_CHOICES = (2,)
BWD_F2_ROWS_CHOICES = (2,)
# op -> the rows-per-block choices of its tensor-core kernel
ROWS_CHOICES = {"fwd": FWD_ROWS_CHOICES, "bwd_f1": BWD_F1_ROWS_CHOICES, "bwd_f2": BWD_F2_ROWS_CHOICES}
BAND_D = 21  # displacements per axis the kernels are built for: FlowNetC's grid
MAX_C = 256  # channels the kernels keep in registers
BAND_COLS = 40  # window columns one 16-row tile multiplies in the forward (15 + D -> n8 tiles)
BAND_K = 48  # window columns of A^ (15 + D -> k16 steps)


def tensor_core_geometry_ok(c: int, max_displacement: int, stride: int) -> bool:
    """Whether the banded kernels take this geometry (any dtype)."""
    return (
        stride in (1, 2)
        and max_displacement % stride == 0
        and displacement_count(max_displacement, stride) == BAND_D
        and c % 16 == 0
        and 0 < c <= MAX_C
    )


def rows_per_phase(stride: int) -> int:
    """Tile rows (output columns of one phase) per tile."""
    return TILE_X // stride


def row_tiles(stride: int) -> int:
    """16-row matrix tiles per phase."""
    return rows_per_phase(stride) // MMA_ROWS


def window_cols(stride: int, pad: int) -> int:
    """Window columns staged per phase: the last 16-row tile reads ``pad``
    columns from its first row on."""
    return rows_per_phase(stride) - MMA_ROWS + pad


def tile_count(w: int) -> int:
    return -(-w // TILE_X)


def row_groups(h: int, stride: int, rows_per_block: int) -> int:
    """Blocks along y: each takes ``rows_per_block`` rows of one row phase."""
    return -(-h // (stride * rows_per_block)) * stride


def rows_per_block(choices: tuple[int, ...], h: int, w: int, batch: int, stride: int,
                   sm_count: int) -> int:
    """Rows per block the kernels' launchers pick on a card of ``sm_count``
    SMs: the first choice whose grid has a block for every SM, else the last."""
    for rows in choices[:-1]:
        if tile_count(w) * row_groups(h, stride, rows) * batch >= sm_count:
            return rows
    return choices[-1]


def group_rows(group: int, stride: int, rows_per_block: int) -> list[int]:
    """The output rows of row group ``group`` (some may lie past the map)."""
    base = (group // stride) * stride * rows_per_block + group % stride
    return [base + stride * r for r in range(rows_per_block)]


def output_column(x0: int, stride: int, phase: int, k: int) -> int:
    return x0 + stride * k + phase


def window_column(x0: int, max_displacement: int, stride: int, phase: int, m: int) -> int:
    return x0 - max_displacement + stride * m + phase


def _stage_window(f: torch.Tensor, row: int, x0: int, p: int, s: int, phase: int, cols: int,
                  needed: int) -> torch.Tensor:
    """Window of map row ``row`` for one phase, ``(B, cols, C)``: zeros outside
    the map and past the ``needed`` columns."""
    b, h, w, c = f.shape
    out = torch.zeros((b, cols, c), dtype=f.dtype)
    if not 0 <= row < h:
        return out
    for m in range(min(cols, needed)):
        x = window_column(x0, p, s, phase, m)
        if 0 <= x < w:
            out[:, m] = f[:, row, x]
    return out


def _tile_rows(f: torch.Tensor, row: int, x0: int, s: int, phase: int, rt: int) -> torch.Tensor:
    """The 16 tile rows of row tile ``rt``: ``(B, 16, C)``, zeros past the map."""
    b, h, w, c = f.shape
    out = torch.zeros((b, MMA_ROWS, c), dtype=f.dtype)
    for k in range(MMA_ROWS):
        x = output_column(x0, s, phase, rt * MMA_ROWS + k)
        if x < w:
            out[:, k] = f[:, row, x]
    return out


def correlation_banded_torch(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2,
    rows: int = FWD_ROWS_CHOICES[0],
) -> torch.Tensor:
    """The cost volume as ``csrc/correlation_fwd_mma.cu`` computes it with
    ``rows`` output rows per block."""
    p, s = max_displacement, stride
    if not tensor_core_geometry_ok(f1.shape[3], p, s):
        raise ValueError(f"geometry not taken by the banded kernels: C={f1.shape[3]} P={p} s={s}")
    b, h, w, c = f1.shape
    d = displacement_count(p, s)
    a32, b32 = f1.float(), f2.float()
    out = torch.zeros((b, h, w, d * d), dtype=torch.float32)
    cols = window_cols(s, BAND_COLS)
    needed = rows_per_phase(s) + d - 1
    k_idx = torch.arange(MMA_ROWS)[:, None] + torch.arange(d)[None, :]  # band: G[k, k + j]
    for x0 in range(0, tile_count(w) * TILE_X, TILE_X):
        for group in range(row_groups(h, s, rows)):
            ys = group_rows(group, s, rows)
            for t in range(d + rows - 1):  # the block's f2 source rows
                src = ys[0] - p + s * t
                for phase in range(s):
                    window = _stage_window(b32, src, x0, p, s, phase, cols, needed)
                    for r, y in enumerate(ys):
                        i = t - r
                        if y >= h or not 0 <= i < d:
                            continue
                        for rt in range(row_tiles(s)):
                            a = _tile_rows(a32, y, x0, s, phase, rt)
                            band = window[:, rt * MMA_ROWS : rt * MMA_ROWS + BAND_COLS]
                            g = torch.matmul(a, band.transpose(1, 2))  # (B, 16, 40)
                            picked = g[:, torch.arange(MMA_ROWS)[:, None], k_idx]  # (B, 16, D)
                            for k in range(MMA_ROWS):
                                x = output_column(x0, s, phase, rt * MMA_ROWS + k)
                                if x < w:
                                    out[:, y, x, i * d : (i + 1) * d] = picked[:, k]
    return (out / c).to(f1.dtype)


def band_matrix(g: torch.Tensor, row: int, i: int, x0: int, p: int, s: int, phase: int,
                rt: int, wrt: str = "f2") -> torch.Tensor:
    """``A^`` of one 16-row tile, ``(B, 16, BAND_K)``: the cotangent of row
    ``row`` and displacement row ``i`` on the band, zeros elsewhere (off the
    band, past the map, and the columns that pad K to :data:`BAND_K`). Tile
    row ``k`` and window column ``ml`` meet at ``j = ml - k``. For the
    gradient to f2 (``wrt="f2"``) ``row`` is the source row, the cotangent is
    read at the window column's pixel and the band runs backwards
    (``D-1 - j``); for the gradient to f1 ``row`` is the output row and the
    cotangent is read at the tile row's own pixel."""
    if wrt not in ("f1", "f2"):
        raise ValueError(f"wrt must be 'f1' or 'f2': {wrt!r}")
    b, h, w, dd = g.shape
    d = displacement_count(p, s)
    out = torch.zeros((b, MMA_ROWS, BAND_K), dtype=g.dtype)
    for ml in range(MMA_ROWS + d - 1):
        for k in range(max(0, ml - d + 1), min(MMA_ROWS, ml + 1)):
            if wrt == "f2":
                x = window_column(x0, p, s, phase, rt * MMA_ROWS + ml)
                j = (d - 1) - (ml - k)
            else:
                x = output_column(x0, s, phase, rt * MMA_ROWS + k)
                j = ml - k
            if 0 <= x < w:
                out[:, k, ml] = g[:, row, x, i * d + j]
    return out


def _banded_gradient(g: torch.Tensor, f: torch.Tensor, p: int, s: int, rows: int,
                     wrt: str) -> torch.Tensor:
    """Either gradient as ``csrc/correlation_bwd_mma.cu`` computes it: per
    block the source rows of the other map ``f`` inside the map, each staged
    once and multiplied with the band matrices of the block's output rows."""
    if not tensor_core_geometry_ok(f.shape[3], p, s):
        raise ValueError(f"geometry not taken by the banded kernels: C={f.shape[3]} P={p} s={s}")
    b, h, w, c = f.shape
    d = displacement_count(p, s)
    g32, f32 = g.float(), f.float()
    out = torch.zeros((b, h, w, c), dtype=torch.float32)
    cols = window_cols(s, BAND_K)
    needed = rows_per_phase(s) + d - 1
    for x0 in range(0, tile_count(w) * TILE_X, TILE_X):
        for group in range(row_groups(h, s, rows)):
            us = group_rows(group, s, rows)
            acc = torch.zeros((rows, b, s, row_tiles(s), MMA_ROWS, c), dtype=torch.float32)
            for t in range(d + rows - 1):
                # df1 walks the source rows upwards and output row r meets
                # row t at i = t - r; df2 walks them downwards from the last
                # output row's and meets them at i = t - (rows-1-r)
                y = us[0] - p + s * t if wrt == "f1" else us[-1] + p - s * t
                if not 0 <= y < h:
                    continue  # the whole block skips the row
                for phase in range(s):
                    window = _stage_window(f32, y, x0, p, s, phase, cols, needed)
                    for r, u in enumerate(us):
                        i = t - r if wrt == "f1" else t - (rows - 1 - r)
                        if u >= h or not 0 <= i < d:
                            continue
                        for rt in range(row_tiles(s)):
                            g_row = u if wrt == "f1" else y
                            a_hat = band_matrix(g32, g_row, i, x0, p, s, phase, rt, wrt)
                            win = window[:, rt * MMA_ROWS : rt * MMA_ROWS + BAND_K]
                            acc[r, :, phase, rt] += torch.matmul(a_hat, win)
            for r, u in enumerate(us):
                if u >= h:
                    continue
                for phase in range(s):
                    for rt in range(row_tiles(s)):
                        for k in range(MMA_ROWS):
                            v = output_column(x0, s, phase, rt * MMA_ROWS + k)
                            if v < w:
                                out[:, u, v] = acc[r, :, phase, rt, k]
    return (out / c).to(f.dtype)


def correlation_bwd_f1_banded_torch(
    g: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride: int = 2,
    rows: int = BWD_F1_ROWS_CHOICES[0],
) -> torch.Tensor:
    """The gradient to f1 as ``corr_bwd_f1_bf16`` (``csrc/correlation_bwd_mma.cu``)
    computes it with ``rows`` output rows per block."""
    return _banded_gradient(g, f2, max_displacement, stride, rows, "f1")


def correlation_bwd_f2_banded_torch(
    g: torch.Tensor, f1: torch.Tensor, max_displacement: int = 20, stride: int = 2,
    rows: int = BWD_F2_ROWS_CHOICES[0],
) -> torch.Tensor:
    """The gradient to f2 as ``corr_bwd_f2_bf16`` (``csrc/correlation_bwd_mma.cu``)
    computes it with ``rows`` output rows per block."""
    return _banded_gradient(g, f1, max_displacement, stride, rows, "f2")
