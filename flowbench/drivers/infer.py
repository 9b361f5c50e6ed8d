"""Serving traffic: one client sends the consecutive pairs of a synthetic
drive to the port's ``Evaluator.predict``, as ``cli.infer`` does on a video,
one pair per call: a closed loop, each request sent when the previous flow is
back on the host. A request runs from host float frames in [0, 1] to the
host flow.

Set-up makes the drive and the weights from the seed, builds the
``Evaluator`` and sends ``warmup_requests``. The window sends requests until
the deadline; every ``keep_every``-th flow (from an offset drawn from the
seed) is kept, and the reference computes those again after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flowbench import check, frames, trace as tracing
from flowbench.flops import infer_flops
from flowbench.readers import Run
from flowbench.reference import quant
from flowbench.reference.infer import predict
from flowbench.weights import make_weights


def make_frames(s, seeds):
    """The drive's frames as host float32 ``(H, W, 3)`` arrays in [0, 1]."""
    t = s.traffic
    drive = frames.make_drives(seeds["frames"], 1, t["frames_per_drive"],
                               t["frame_hw"], t["motion"], s.device)[0]
    return [f.cpu().numpy().astype(np.float32) / 255.0 for f in drive]


def setup(s) -> dict:
    """The drive, the weights, the ``Evaluator`` and its warm-up requests."""
    from unflow_tpu_torch.eval.evaluate import Evaluator

    keys = s.train_keys()
    seeds = s.seeds()
    ims = make_frames(s, seeds)
    weights = make_weights(keys["flownet"], seeds["weights"], s.device, keys["max_displacement"],
                           keys["corr_stride"])
    ev = Evaluator(s.port_config(), params=weights, normalization=tuple(s.config["normalization"]),
                   device=s.device)
    pairs = len(ims) - 1
    for i in range(s.traffic["warmup_requests"]):
        ev.predict(ims[i % pairs], ims[i % pairs + 1])
    return {"ev": ev, "ims": ims, "weights": weights, "offset": seeds["sample"] % s.traffic["keep_every"]}


def window(s, st) -> dict:
    """The timed window of requests, then (traced runs) the profiled ones."""
    ev, ims, every = st["ev"], st["ims"], s.traffic["keep_every"]
    pairs = len(ims) - 1
    kept, latencies = [], []
    s.sync()
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    clock = time.perf_counter
    t_start = clock()
    setup_s = time.time() - s.t0
    deadline = t_start + s.seconds
    i = 0
    while clock() < deadline:
        a = clock()
        flow = ev.predict(ims[i % pairs], ims[i % pairs + 1])
        latencies.append(clock() - a)
        if i % every == st["offset"]:
            kept.append((i % pairs, flow))
        i += 1
    window_s = clock() - t_start
    peak = torch.cuda.max_memory_allocated(s.device) if s.device.type == "cuda" else 0
    traced = profile_requests(s, ev, ims, s.traffic["profile_requests"]) if s.trace else None
    st.pop("ev")
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"setup_s": setup_s, "window_s": window_s, "requests": i, "latencies": latencies,
            "kept": kept, "peak": peak, "traced": traced}


def run(s) -> tuple[Run, dict]:
    st = setup(s)
    w = window(s, st)
    keys, traced = s.train_keys(), w["traced"]
    h, wd = st["ims"][0].shape[:2]
    hp, wp = -(-h // 64) * 64, -(-wd // 64) * 64
    run = Run(kind="infer", chips=1, setup_s=w["setup_s"], window_s=w["window_s"],
              units=w["requests"], pairs_per_unit=1, latencies_s=w["latencies"],
              peak_bytes=w["peak"],
              flops_per_unit=infer_flops(keys["flownet"], 1, hp, wp, keys["max_displacement"],
                                         keys["corr_stride"]),
              peak_flops=None, bytes_per_s=None, corr_shape=(1, hp // 8, wp // 8, 256),
              corr_d=2 * (keys["max_displacement"] // keys["corr_stride"]) + 1,
              dtype_bytes=2 if keys["compute_dtype"] == "bfloat16" else 4,
              trace=traced,
              traced_units=s.traffic["profile_requests"] if s.trace else 0)
    kept = w["kept"]
    ref = reference_flows(s, st["weights"], st["ims"], [k for k, _ in kept])
    numbers = {"flow_gap": check.flow_gap([f for _, f in kept], ref)}
    busy = [] if traced is None else [(traced.busy_s, traced.window_s)]
    return run, {"numbers": numbers, "attempted": w["requests"], "busy": busy}


def reference_flows(s, weights, ims, pair_ids, precision="bf16") -> list:
    """The reference's flows of the pairs ``pair_ids``, in blocks."""
    block = s.traffic["reference_batch"]
    cfg = s.train_keys()
    out = []
    with check.plain_precision():
        for lo in range(0, len(pair_ids), block):
            ids = pair_ids[lo:lo + block]
            out.extend(predict(weights, np.stack([ims[k] for k in ids]),
                               np.stack([ims[k + 1] for k in ids]), cfg,
                               tuple(s.config["normalization"]), s.device,
                               quant=quant.QUANT[precision]))
    return out


def profile_requests(s, ev, ims, count):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if s.device.type == "cuda" else [])
    pairs = len(ims) - 1
    s.sync()
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            for i in range(count):
                with record_function("flowbench.predict"):
                    ev.predict(ims[i % pairs], ims[i % pairs + 1])
            s.sync()
    return tracing.reduce(prof)
