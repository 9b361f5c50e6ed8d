"""Reduce a ``torch.profiler`` trace of one steady stretch to what the
per-layer metrics and the breakdown read.

The stretch is the span of the benchmark's ``flowbench.window``
annotation. The device is busy where any kernel, copy or set runs (the union
of their intervals, so work overlapped on two streams counts once); the rest
of the stretch is idle, and each idle gap is named by what the host's main
thread was doing at its middle: the benchmark's innermost span and the
innermost operation under it.
"""

from __future__ import annotations

import bisect
import dataclasses

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "flowbench.window"

# kernel groups, first match wins: (group, words of the kernel's name)
GROUPS = (
    ("nccl", ("nccl",)),
    ("correlation", ("corr_",)),
    ("copy", ("Memcpy", "memcpy")),
    ("set", ("Memset", "memset")),
    ("conv_layout", ("nhwcAddPadding", "nchwToNhwc", "nhwcToNchw", "Nhwc", "Nchw")),
    ("conv", ("cudnn", "xmma", "cutlass", "implicit_gemm", "dgrad", "wgrad", "convolve",
              "sm90_", "gemm")),
    ("adam", ("Adam", "multi_tensor_apply")),
    ("census_patches", ("im2col", "col2im")),
    ("gather_scatter", ("gather", "scatter", "index", "Index")),
    ("random", ("distribution", "philox", "Philox", "normal", "uniform")),
    ("reduction", ("reduce_kernel", "Reduce", "reduce")),
    ("elementwise", ("elementwise", "Elementwise")),
)


def group(name: str) -> str:
    for label, words in GROUPS:
        if any(w in name for w in words):
            return label
    return "other"


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: dict  # name -> [launches, seconds]
    groups: dict  # group -> seconds
    idle: dict  # what the host did -> idle seconds

    def breakdown(self, top: int = 10) -> dict:
        def best(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": best(self.groups), "idle_gaps": best(self.idle)}


def union(intervals):
    """Merged, sorted ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def measure(merged) -> float:
    return sum(e - s for s, e in merged)


def _kind(e) -> str:
    """The event's activity type, in the names newer PyTorch reports."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    from torch.autograd import DeviceType

    annotation = e.is_user_annotation() or e.name().startswith("flowbench.")
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if annotation else "kernel"
    return "user_annotation" if annotation else "cpu_op"


def _events(prof):
    """(device events, annotations, cpu ops) as tuples of seconds and names."""
    device, spans, ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if kind in DEVICE_ACTIVITIES:
            device.append((start, end, e.name()))
        elif kind == "user_annotation":
            spans.append((start, end, e.name(), e.start_thread_id()))
        elif kind in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append((start, end, e.name(), e.start_thread_id()))
    return device, spans, ops


def _innermost(items, starts, t: float, limit: int = 256):
    """Name of the latest-starting item of ``items`` (sorted by start) that
    covers ``t``; None if none does within ``limit`` steps back."""
    i = bisect.bisect_right(starts, t) - 1
    steps = 0
    while i >= 0 and steps < limit:
        s, e, name = items[i][:3]
        if e >= t:
            return name
        i -= 1
        steps += 1
    return None


def reduce(prof) -> Trace | None:
    """The trace of the stretch, or None when it holds no device work."""
    device, spans, ops = _events(prof)
    windows = [s for s in spans if s[2] == WINDOW]
    if not windows or not device:
        return None
    w0, w1, _, thread = windows[0]
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    if not clipped:
        return None
    busy = union([(s, e) for s, e, _ in clipped])
    kernels, groups = {}, {}
    for s, e, n in clipped:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += e - s
    for n, (_, seconds) in kernels.items():
        g = group(n)
        groups[g] = groups.get(g, 0.0) + seconds
    main_spans = sorted((s for s in spans if s[3] == thread and s[2] != WINDOW),
                        key=lambda x: x[0])
    main_ops = sorted((o for o in ops if o[3] == thread), key=lambda x: x[0])
    span_starts = [s[0] for s in main_spans]
    op_starts = [o[0] for o in main_ops]
    idle = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        span = _innermost(main_spans, span_starts, mid) or "outside"
        op = _innermost(main_ops, op_starts, mid) or "python"
        label = f"{span.removeprefix('flowbench.')}:{op}"
        idle[label] = idle.get(label, 0.0) + (b - a)
    return Trace(busy_s=measure(busy), window_s=w1 - w0, kernels=kernels, groups=groups,
                 idle=idle)
