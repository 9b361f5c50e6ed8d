"""W-sharding: a (data, spatial) grid of processes, and the collectives that
let each process hold a contiguous W-slab of every activation and loss field.

Port of the JAX package's second mesh axis (``unflow_tpu/parallel/__init__.py``
``create_mesh(spatial=)``, ``batch_sharding(spatial_axis=2)``). There GSPMD
inserts the halo exchanges; here they are explicit. The grid follows the JAX
mesh's layout, ``create_device_mesh((n // S, S))``: rank ``r`` sits at data
index ``r // S`` and spatial index ``r % S``, so spatial neighbours are
consecutive ranks. The ``S`` ranks of a spatial group train on the same rows
of a global batch, each on its ``W / S`` columns; the parameters stay
replicated on every rank (DDP over the world group).

The ops of the network and the loss consult :func:`current`: outside a
:class:`SpatialContext` they run their unsharded code; inside one they take
the halo they need (:func:`halo_exchange`), gather the frame where no halo
bounds the reach (:func:`gather_w`, the warps), and count with the global
width. The context is entered by the train step only, around the network,
the loss and its backward pass.

Slabs are cut at FlowNet's deepest level (stride 64, six stride-2 levels):
its ``W / 64`` columns are split as evenly as the ``S`` ranks allow
(:func:`split_columns`: 18 into 5, 5, 4, 4), and at every other level each
slab is that many columns times the level's factor, so every slab of every
pyramid level starts at a column the global stride-2 grid samples. The train
width must be a multiple of 64 with at least one deep column a rank. Uneven
slabs exchange strips padded to the widest rank's.

Every collective is an ``all_reduce`` (an all-gather is an ``all_reduce`` of
a zeroed buffer, each rank's part in its own slot): gloo takes it on the CPU
and on CUDA tensors, as NCCL does, and gloo has no CUDA ``send``/``recv``.
"""

from __future__ import annotations

import contextvars
import dataclasses

import torch
import torch.distributed as dist

# FlowNet's six stride-2 levels: 2**6
WIDTH_QUANTUM = 64

_CURRENT: contextvars.ContextVar[SpatialContext | None] = contextvars.ContextVar(
    "unflow_spatial_context", default=None
)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place in the (data, spatial) grid and its spatial
    group."""

    spatial: int
    spatial_index: int
    data_index: int
    data_size: int
    group: object = None  # the spatial process group


_GRID: Grid | None = None


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def split_columns(width: int, spatial: int) -> tuple[int, ...]:
    """Each rank's columns at the deepest level (``width / 64`` of them),
    split as evenly as possible, the first ranks taking one more."""
    n = width // WIDTH_QUANTUM
    return tuple(n // spatial + (i < n % spatial) for i in range(spatial))


def check_grid(spatial: int, width: int | None = None, processes: int | None = None) -> None:
    """Raise ``ValueError`` unless ``spatial`` shards fit the processes of
    this run (it divides them; several need several processes) and, given
    ``width``, the train width (a multiple of 64 with ``width / 64 >=
    spatial``: a column of the deepest level for each rank)."""
    world = _world()[1] if processes is None else processes
    if spatial < 1:
        raise ValueError(f"spatial_shards must be >= 1, got {spatial}")
    if spatial > 1 and world == 1:
        raise ValueError(
            f"spatial_shards = {spatial}, but this is one process: start a multiple of "
            f"{spatial} processes with `torchrun --nproc-per-node {spatial} -m "
            "unflow_tpu_torch.cli.train --config ... --ex ... --set "
            f"spatial_shards={spatial}`"
        )
    if world % spatial:
        raise ValueError(f"spatial_shards = {spatial} does not divide the {world} processes")
    if width is None or spatial == 1:
        return
    q = WIDTH_QUANTUM
    if width % q:
        lo = width // q * q
        near = [v for v in (lo, lo + q) if v >= q * spatial]
        raise ValueError(
            f"width {width} is not a multiple of 64, which W-sharding needs (every slab "
            f"starts on the stride-2 grid of all six levels); nearest valid widths: {near}"
        )
    if width // q < spatial:
        raise ValueError(
            f"width {width} has {width // q} columns at FlowNet's deepest level (stride 64), "
            f"fewer than spatial_shards = {spatial}: every rank needs one; the narrowest "
            f"valid width is {q * spatial}"
        )


def init_grid(spatial: int) -> Grid | None:
    """Build the spatial process groups of ``spatial`` shards (None for 1).
    Every rank calls it, in the same order, as ``dist.new_group`` requires;
    a second call with the same ``spatial`` returns the grid it built."""
    global _GRID
    check_grid(spatial)
    if spatial == 1:
        _GRID = None
        return None
    rank, world = _world()
    if _GRID is not None and _GRID.spatial == spatial:
        return _GRID
    mine = None
    for d in range(world // spatial):
        group = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
        if d == rank // spatial:
            mine = group
    _GRID = Grid(spatial, rank % spatial, rank // spatial, world // spatial, mine)
    return _GRID


def reset_grid() -> None:
    """Forget the grid (before its process group is destroyed)."""
    global _GRID
    _GRID = None


def spatial_size() -> int:
    return 1 if _GRID is None else _GRID.spatial


def data_shard() -> tuple[int, int]:
    """(data index, data ranks): this process's share of each global batch,
    the ``Loader``'s ``shard``. Ranks of one spatial group share it."""
    if _GRID is None:
        return _world()
    return _GRID.data_index, _GRID.data_size


def spatial_shard() -> tuple[int, int]:
    """(spatial index, spatial shards): which W-slab this process holds."""
    if _GRID is None:
        return 0, 1
    return _GRID.spatial_index, _GRID.spatial


@dataclasses.dataclass(frozen=True)
class SpatialContext:
    """Inside ``with SpatialContext(...)``, each op of the network and the
    loss holds slab ``index`` of ``size`` W-slabs and exchanges with
    ``group``. ``cols`` holds each rank's share of the deepest level's
    columns (:func:`split_columns`); a slab ``w`` wide is then ``w /
    cols[index]`` times its share, and so is every other rank's."""

    group: object
    size: int
    index: int
    cols: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.cols) != self.size or min(self.cols) < 1:
            raise ValueError(f"{self.size} slabs need a positive share each, got {self.cols}")

    @classmethod
    def of(cls, grid: Grid, width: int) -> SpatialContext:
        """The context of ``grid``'s rank at the train ``width``: its slabs
        follow :func:`split_columns`."""
        return cls(grid.group, grid.spatial, grid.spatial_index,
                   split_columns(width, grid.spatial))

    def widths(self, w: int) -> list[int]:
        """Every rank's width where this rank's slab is ``w`` wide."""
        scale, rest = divmod(w, self.cols[self.index])
        if rest or not scale:
            raise ValueError(f"a slab {w} wide is no multiple of this rank's "
                             f"{self.cols[self.index]} deep columns")
        return [c * scale for c in self.cols]

    def offsets(self, w: int) -> list[int]:
        """Every rank's first global column where this rank's slab is ``w`` wide."""
        out, x = [], 0
        for n in self.widths(w):
            out.append(x)
            x += n
        return out

    def __enter__(self) -> SpatialContext:
        object.__setattr__(self, "_token", _CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)

    def offset(self, w: int) -> int:
        """The global column of this slab's first column, for a slab ``w`` wide."""
        return self.offsets(w)[self.index]

    def total(self, w: int) -> int:
        """The global width where this rank's slab is ``w`` wide."""
        return sum(self.widths(w))

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1


def current() -> SpatialContext | None:
    """The context the caller runs in, None outside one."""
    return _CURRENT.get()


def global_width(w: int) -> int:
    """The width of the frame whose slab is ``w`` wide (``w`` outside a context)."""
    ctx = current()
    return w if ctx is None else ctx.total(w)


def global_x(w: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The global column of each of a slab's ``w`` columns (``arange(w)``
    outside a context)."""
    ctx = current()
    x0 = 0 if ctx is None else ctx.offset(w)
    return torch.arange(x0, x0 + w, dtype=dtype, device=device)


def slab(x: torch.Tensor, ctx: SpatialContext, dim: int = -1) -> torch.Tensor:
    """This rank's columns of a full-width tensor."""
    full, parts = x.shape[dim], sum(ctx.cols)
    scale = full // parts
    if scale * parts != full:
        raise ValueError(f"width {full} does not split into {ctx.size} slabs")
    w = scale * ctx.cols[ctx.index]
    return x.narrow(dim, ctx.offset(w), w)


def _all_gather(x: torch.Tensor, ctx: SpatialContext, dim: int = -1,
                sizes: list[int] | None = None) -> list[torch.Tensor]:
    """Every rank's ``x``, in rank order. ``sizes``: each rank's extent of
    ``dim``, where they differ (each is sent padded to the largest).
    bfloat16 and float16 travel as float32 (exact; not every backend sums
    them)."""
    dim = dim % x.dim()
    most = x.shape[dim] if sizes is None else max(sizes)
    wire = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    shape = list(x.shape)
    shape[dim] = most
    buf = torch.zeros((ctx.size, *shape), dtype=wire, device=x.device)
    buf[ctx.index].narrow(dim, 0, x.shape[dim]).copy_(x)
    dist.all_reduce(buf, group=ctx.group)
    buf = buf.to(x.dtype)
    n = [x.shape[dim]] * ctx.size if sizes is None else sizes
    return [buf[j].narrow(dim, 0, n[j]) for j in range(ctx.size)]


def _zeros_like_layout(x: torch.Tensor, shape) -> torch.Tensor:
    """Zeros of ``shape`` in ``x``'s memory format (channels_last kept)."""
    out = x.new_zeros(shape)
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def _overlaps(src0: int, n: int, dst0: int, m: int):
    """(offset in the source, offset in the destination, length) of the
    overlap of global columns ``[src0, src0 + n)`` and ``[dst0, dst0 + m)``,
    or None."""
    a, b = max(src0, dst0), min(src0 + n, dst0 + m)
    return (a - src0, a - dst0, b - a) if a < b else None


class _HaloExchange(torch.autograd.Function):
    """``x`` with ``left`` columns before it and ``right`` after it along
    ``dim``: the neighbours' columns, zeros past the global edges. A halo may
    be wider than a slab: every rank sends the strips any other rank's halo
    can need (its first ``min(right, w)`` and last ``min(left, w)`` columns)
    and takes what falls in its halo. The backward sends each halo's
    gradient back the same way and adds it to the owner's slab."""

    @staticmethod
    def forward(fctx, x, left: int, right: int, dim: int, ctx: SpatialContext):
        dim = dim % x.dim()
        w = x.shape[dim]
        widths, offsets = ctx.widths(w), ctx.offsets(w)
        lws, rws = [min(left, v) for v in widths], [min(right, v) for v in widths]
        lw, rw = lws[ctx.index], rws[ctx.index]
        strips = _all_gather(torch.cat([x.narrow(dim, 0, rw), x.narrow(dim, w - lw, lw)], dim),
                             ctx, dim, [a + b for a, b in zip(lws, rws)])
        shape = list(x.shape)
        shape[dim] = left + w + right
        out = _zeros_like_layout(x, shape)
        out.narrow(dim, left, w).copy_(x)
        x0 = offsets[ctx.index]
        for j in range(ctx.size):
            if j == ctx.index:
                continue
            # rank j's two strips: global column, length, offset in its strip
            wj, xj = widths[j], offsets[j]
            for g0, n, s0 in ((xj, rws[j], 0), (xj + wj - lws[j], lws[j], rws[j])):
                for h0, m, o0 in ((x0 - left, left, 0), (x0 + w, right, left + w)):
                    hit = _overlaps(g0, n, h0, m)
                    if hit is not None:
                        src, dst, k = hit
                        out.narrow(dim, o0 + dst, k).copy_(strips[j].narrow(dim, s0 + src, k))
        fctx.args = (left, right, dim, w, ctx)
        return out

    @staticmethod
    def backward(fctx, g):
        left, right, dim, w, ctx = fctx.args
        halos = _all_gather(torch.cat([g.narrow(dim, 0, left), g.narrow(dim, left + w, right)],
                                      dim), ctx, dim)
        dx = g.narrow(dim, left, w).clone()
        widths, offsets = ctx.widths(w), ctx.offsets(w)
        x0 = offsets[ctx.index]
        for j in range(ctx.size):
            if j == ctx.index:
                continue
            # rank j's left halo covers [x_j - left, x_j), its right one
            # [x_j + w_j, x_j + w_j + right); what lies on this slab comes home
            xj = offsets[j]
            for h0, m, s0 in ((xj - left, left, 0), (xj + widths[j], right, left)):
                hit = _overlaps(h0, m, x0, w)
                if hit is not None:
                    src, dst, k = hit
                    dx.narrow(dim, dst, k).add_(halos[j].narrow(dim, s0 + src, k))
        return dx, None, None, None, None


class _GatherW(torch.autograd.Function):
    """Every rank's slab concatenated along ``dim``; the backward sums the
    full-width gradient over the group and keeps this rank's slab."""

    @staticmethod
    def forward(fctx, x, dim: int, ctx: SpatialContext):
        dim = dim % x.dim()
        fctx.args = (dim, x.shape[dim], ctx)
        return torch.cat(_all_gather(x, ctx, dim, ctx.widths(x.shape[dim])), dim)

    @staticmethod
    def backward(fctx, g):
        dim, w, ctx = fctx.args
        wire = torch.float32 if g.dtype in (torch.bfloat16, torch.float16) else g.dtype
        total = g.to(wire, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.narrow(dim, ctx.offset(w), w).to(g.dtype), None, None


class _SumOverSpatial(torch.autograd.Function):
    """All-reduce (sum) over the spatial group; its backward is the same
    all-reduce of the gradients, so each rank's backward carries the group's
    ``S`` loss gradients of 1."""

    @staticmethod
    def forward(fctx, v, ctx: SpatialContext):
        fctx.ctx = ctx
        out = v.clone()
        dist.all_reduce(out, group=ctx.group)
        return out

    @staticmethod
    def backward(fctx, g):
        g = g.clone()
        dist.all_reduce(g, group=fctx.ctx.group)
        return g, None


def _require() -> SpatialContext:
    ctx = current()
    if ctx is None:
        raise RuntimeError("a spatial collective outside a SpatialContext")
    return ctx


def halo_exchange(x: torch.Tensor, left: int, right: int, dim: int = -1,
                  edge: str = "zeros") -> torch.Tensor:
    """``x`` (this rank's slab) extended by ``left`` / ``right`` columns of
    its neighbours along ``dim``. Past the global edges the columns are zeros
    (``edge="zeros"``, SAME padding) or copies of the edge column
    (``edge="replicate"``, a clamped sample)."""
    ctx = _require()
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"edge must be 'zeros' or 'replicate', got {edge!r}")
    out = _HaloExchange.apply(x, left, right, dim, ctx) if left or right else x
    if edge == "replicate":
        dim = dim % x.dim()
        w = x.shape[dim]
        x0, total = ctx.offset(w), ctx.total(w)
        lo = max(left - x0, 0)  # columns before global column 0
        hi = max(x0 + w + right - total, 0)  # columns after the last one
        if lo or hi:
            n = out.shape[dim]
            inner = out.narrow(dim, lo, n - lo - hi)
            parts = [out.narrow(dim, lo, 1).expand_as(out.narrow(dim, 0, lo))] if lo else []
            parts.append(inner)
            if hi:
                parts.append(out.narrow(dim, n - hi - 1, 1).expand_as(out.narrow(dim, 0, hi)))
            out = torch.cat(parts, dim)
    return out


def gather_w(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The full-width tensor of which ``x`` is this rank's slab."""
    return _GatherW.apply(x, dim, _require())


def sum_over_spatial(v: torch.Tensor) -> torch.Tensor:
    """``v`` summed over the spatial group (differentiable)."""
    return _SumOverSpatial.apply(v, _require())


__all__ = [
    "Grid",
    "SpatialContext",
    "WIDTH_QUANTUM",
    "check_grid",
    "current",
    "data_shard",
    "gather_w",
    "global_width",
    "global_x",
    "halo_exchange",
    "init_grid",
    "reset_grid",
    "slab",
    "spatial_shard",
    "split_columns",
    "spatial_size",
    "sum_over_spatial",
]
