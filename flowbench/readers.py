"""What the metric readers read: one run's record, and the arithmetic the
readers share. A reader returns None where its run has nothing to read."""

from __future__ import annotations

import dataclasses
import statistics

from flowbench.peaks import corr_bound_s


@dataclasses.dataclass
class Run:
    kind: str  # "train" or "infer"
    chips: int
    setup_s: float
    window_s: float  # the timed window, host clock, ending in a synchronize
    units: int  # steps or requests completed in it
    pairs_per_unit: int  # image pairs of the global batch per step, or per request
    latencies_s: list  # per request (infer)
    peak_bytes: int  # max_memory_allocated over the window, fullest chip
    flops_per_unit: int  # flowbench/flops.py's count of a step or a request
    peak_flops: float | None  # per chip
    bytes_per_s: float | None
    corr_shape: tuple  # (B, H, W, C) of each correlation launch
    corr_d: int
    dtype_bytes: int
    # the traced run only: host spans over the window and the device trace
    # of the fixed stretch after it
    spans: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # flowbench.trace.Trace of the lead chip
    traced_units: int = 0


def mean_ms(run: Run, span: str):
    values = run.spans.get(span)
    return 1e3 * statistics.fmean(values) if values else None


def mfu(run: Run):
    """Share (%) of the chips' bf16 peak that the counted work reached over
    the window."""
    if not run.units or not run.peak_flops:
        return None
    return 100.0 * run.flops_per_unit * run.units / run.window_s / (run.peak_flops * run.chips)


def corr_roofline(run: Run):
    """Share (%) of the correlation kernels' device time that their least
    time (flowbench/peaks.py) would take."""
    if run.trace is None or not run.peak_flops:
        return None
    launches = seconds = 0.0
    for name, (count, s) in run.trace.kernels.items():
        if "corr_" in name and "_kernel" in name:
            launches += count
            seconds += s
    if not seconds:
        return None
    bound = corr_bound_s(run.corr_shape, run.corr_d, run.dtype_bytes, run.peak_flops,
                         run.bytes_per_s)
    return 100.0 * launches * bound / seconds


def idle_share(run: Run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def per_traced_unit_ms(run: Run, seconds):
    if run.trace is None or not run.traced_units or seconds is None:
        return None
    return 1e3 * seconds / run.traced_units
