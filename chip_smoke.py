#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (unflow_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one GPU

Phases; any failure raises and the script exits non-zero without a result line:

  1. build   -- nvcc compiles every CUDA source of the port for sm_90a, one
                process per source, all started together.
  2. kernels -- each of the nine kernels (correlation forward, gradient to f1,
                gradient to f2; float32 and bfloat16, and in bfloat16 both the
                tensor-core kernel and its FP32-core twin ``*_simt``, called
                past the dispatch) against its plain PyTorch
                version on the card (tolerance 1e-5 * max|ref| in float32, 0.02 *
                max|ref| in bfloat16), at the training geometry (16, 40, 144,
                256), the eval geometry (4, 48, 160, 256), both with
                max_displacement 20 and stride 2, an odd case (W a multiple
                of no tile, stride 1), and the training geometry with stride 4,
                which the dispatch sends to the FP32-core kernels' run-time
                stride (in bfloat16 to the three ``*_simt`` twins; their reported
                numbers are from this case). Times are medians of 20 launches,
                each timed with CUDA events after warm-up. A tensor-core kernel
                that is slower than its twin at the training geometry fails the run.
                Each f32 gradient's time at the training geometry is also printed
                as a ratio to the f32 forward's there (same FMAs, same bound).
                Then the autograd Function over the three kernels against
                autograd through the plain version, with a non-contiguous
                cotangent.
  3. serving path -- ``unflow_tpu_torch.cli.infer`` with ``--random-init`` on two
                375x1242 frames (configs/kitti_unsup_c.ini: FlowNetC, bf16), then
                ``Evaluator.predict_batch`` at batch 4 in bf16 and in f32 (TF32
                off). Each run starts with the launch counts at 0 and must launch
                its kernel (in bf16 the tensor-core one, and no ``*_simt``); each
                flow must be finite and agree with the same weights run through
                the plain correlation (relative L2 < 2e-2 in bf16, < 1e-4 in f32).
  4. training path -- ``unflow_tpu_torch.cli.train`` with the same config and
                ``dataset=synthetic``: 12 steps at 320x1152, batch 8, bf16, which
                must launch the three bf16 kernels once per step (the tensor-core
                ones, no ``*_simt``), end with a finite loss and write
                ``metrics.jsonl``; then one f32 step at batch 2, which must launch
                the three f32 kernels; then two bf16 steps with ``corr_stride=4``,
                a displacement grid the tensor-core kernels do not take, which
                must launch the three ``*_simt`` twins instead. Then one train
                step through the kernels against the same step through the plain
                correlation (same parameters, batch and seed, cuDNN held to its
                deterministic algorithms), in bf16, in f32 and in bf16 with
                ``corr_stride=4``: loss, grad_norm and the relative L2 of the
                whole gradient must agree (2e-2 in bf16, 1e-4 in f32 with TF32
                off: the correlation's summation order differs), and the step
                must launch its three kernels once; the f32 step is also run
                twice through the plain correlation, as a control. Then ``Trainer.run`` on batches that are
                ready on the host, for the step's own time, its peak memory and a
                profile of one step; and one f32 step at batch 8 (TF32 off),
                profiled after a warm-up, for the f32 gradients' share of it.
  5. recipe  -- the stacked recipe through ``cli.train``, 2 steps each at 320x1152,
                batch 8, bf16, ``dataset=synthetic``, a checkpoint at step 2:
                configs/kitti_unsup_c.ini (FlowNetC, ``--ex kitti_c``), then
                configs/kitti_cs.ini (cS, finetune = kitti_c), then
                configs/kitti_css.ini (csS, finetune = kitti_c, kitti_cs). C must
                launch each of the three bf16 tensor-core kernels once per step;
                cS and csS only the forward (the frozen C needs no gradient). The
                csS checkpoint's stage0_C must equal kitti_c's bit for bit, its
                stage1_S kitti_cs's.
  6. resume  -- csS for 4 steps in one ``Trainer``, and again as two segments: a
                ``Trainer`` stops at step 2 and saves, a new one on the same
                experiment, fed the stream from ``start_batch=2``, runs to step 4.
                The losses of steps 3 and 4 and every parameter at the end must
                be identical (csS has no float atomics in its step, and cuDNN is
                held to its deterministic algorithms for this phase).
  7. serving the cascade -- ``cli.infer --ex kitti_css`` on a 375x1242 pair (the
                snapshot supplies the net) must write a finite flow and launch
                ``corr_fwd_bf16`` once; ``Evaluator(exp_dir=...)`` at batch 4 is
                held against the same weights through the plain correlation
                (relative L2 < 2e-2) and timed.
  8. the ``CSS`` twins -- every stage trainable, ``train_all`` (each stage's loss,
                gradients through the warps into C): one step through the
                kernels against the plain-correlation step, bf16 at batch 8
                (2e-2) and f32 at batch 2 (1e-4, TF32 off) from three init seeds.
                Each f32 gap is printed per stage and for its largest leaves,
                beside the gap between two runs of the plain step itself; then
                the plain step twice with cuDNN's default algorithms (printed).
  9. timed cascades -- ``Trainer.run`` for csS and for CSS (``train_all``) at
                320x1152, batch 8, bf16, on ready host batches: step time, peak
                memory and a profile of one step, as for C.

Prints the GPU's name and power limit first, then a line per check, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import statistics
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "kitti_unsup_c.ini"
CS_CONFIG = ROOT / "configs" / "kitti_cs.ini"
CSS_CONFIG = ROOT / "configs" / "kitti_css.ini"
FRAME_HW = (375, 1242)  # KITTI eval size; the evaluator pads it to 384x1280
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # FP32 cores; dense bf16
REPLACES = {
    "corr_fwd_f32": "unflow_tpu/ops/pallas/correlation.py:96",
    "corr_fwd_bf16": "unflow_tpu/ops/pallas/correlation_mxu.py:187",
    "corr_bwd_f1_f32": "unflow_tpu/ops/pallas/correlation.py:201",
    "corr_bwd_f2_f32": "unflow_tpu/ops/pallas/correlation.py:285",
    "corr_bwd_f1_bf16": "unflow_tpu/ops/pallas/correlation_mxu.py:281",
    "corr_bwd_f2_bf16": "unflow_tpu/ops/pallas/correlation_mxu.py:389",
    "corr_fwd_bf16_simt": "unflow_tpu/ops/pallas/correlation_mxu.py:187",
    "corr_bwd_f1_bf16_simt": "unflow_tpu/ops/pallas/correlation_mxu.py:281",
    "corr_bwd_f2_bf16_simt": "unflow_tpu/ops/pallas/correlation_mxu.py:389",
}
# the geometry each op's reported time is taken at: that of its main path
# (for a ``*_simt`` twin the stride-4 case, the one that reaches it)
REPORT_CASE = {"fwd": "eval", "bwd_f1": "train", "bwd_f2": "train"}
SIMT_CASE = "stride4"
TRAIN_STEPS = 12
RECIPE_STEPS = 2
TENSOR_CORE_KERNELS = ("corr_fwd_bf16", "corr_bwd_f1_bf16", "corr_bwd_f2_bf16")
# profile rows by the words in a kernel's name; the first group that matches
PROFILE_GROUPS = {
    "correlation kernels (this repo)": (
        "corr_fwd_kernel", "corr_bwd_f1_kernel", "corr_bwd_f2_kernel", "corr_fwd_mma_kernel",
        "corr_bwd_f1_mma_kernel", "corr_bwd_f2_mma_kernel",
    ),
    "copies": ("Memcpy", "Memset"),
    "cuDNN convolutions and their layout kernels": (
        "cudnn", "xmma", "cutlass", "implicit_gemm", "dgrad", "wgrad", "convolve", "nhwc", "nchw",
        "Nhwc", "Nchw",
    ),
    "optimizer": ("Adam", "multi_tensor_apply"),
    "gathers and scatter-adds (warp, crop)": ("gather", "scatter", "index", "Index"),
    "census patches (im2col, col2im)": ("im2col", "col2im"),
    "random numbers": ("distribution", "philox", "Philox", "normal", "uniform"),
    "reductions": ("reduce_kernel",),
    "elementwise": ("elementwise",),
}
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 0.02}
# (name, (B, H, W, C), max_displacement, stride)
KERNEL_CASES = [
    ("train", (16, 40, 144, 256), 20, 2),
    ("eval", (4, 48, 160, 256), 20, 2),
    ("odd", (2, 24, 75, 256), 10, 1),
    (SIMT_CASE, (16, 40, 144, 256), 20, 4),
]


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def bound_ms(shape, d: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for the forward or either gradient: two maps (B, H, W, C)
    and one volume (B, H, W, D*D) read or written once each (forward: f1, f2
    in, volume out; a gradient: cotangent and one map in, one map out),
    against 2*B*H*W*D*D*C operations at the peak rate of the inputs' type."""
    b, h, w, c = shape
    size = torch.finfo(dtype).bits // 8
    t_bytes = (2 * b * h * w * c + b * h * w * d * d) * size / HBM_BYTES_PER_S
    t_ops = 2 * b * h * w * d * d * c / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def banded_work(op: str, shape, p: int, s: int) -> str:
    """What a tensor-core kernel's grid does at ``shape``, counted from the
    geometry helpers its wrapper shares with the CPU model: blocks, output
    rows per block, bytes staged from L2 into shared memory (every block's
    row windows, map columns only) and matrix instructions executed."""
    from unflow_tpu_torch.ops import correlation_banded as banded

    b, h, w, c = shape
    d = 2 * (p // s) + 1
    choices = banded.ROWS_CHOICES[op]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = banded.rows_per_block(choices, h, w, b, s, sms)
    groups = banded.row_groups(h, s, rows)
    needed = banded.rows_per_phase(s) + d - 1
    staged = mmas = 0
    for tile in range(banded.tile_count(w)):
        x0 = tile * banded.TILE_X
        pixels = sum(
            0 <= banded.window_column(x0, p, s, phase, m) < w
            for phase in range(s) for m in range(needed)
        )
        live_tiles = sum(
            banded.output_column(x0, s, phase, rt * banded.MMA_ROWS) < w
            for phase in range(s) for rt in range(banded.row_tiles(s))
        )
        for group in range(groups):
            ys = [y for y in banded.group_rows(group, s, rows) if y < h]
            # source rows of the group inside the map, and (output row, source row) meetings
            if op == "bwd_f2":
                meets = [(u, u + p - s * i) for u in ys for i in range(d)]
            else:
                meets = [(y, y + s * i - p) for y in ys for i in range(d)]
            meets = [(a, src) for a, src in meets if 0 <= src < h]
            staged += len({src for _, src in meets}) * pixels * c * 2
            per_meeting = (c // 16) * 5 if op == "fwd" else 3 * (c // 8)
            mmas += len(meets) * live_tiles * per_meeting
    blocks = banded.tile_count(w) * groups * b
    return (f"{blocks} blocks of {rows} rows on {sms} SMs, staged from L2 "
            f"{staged * b / 1e6:.1f} MB, {mmas * b / 1e6:.2f} M mma.m16n8k16")


def check_kernels() -> dict[str, dict]:
    from unflow_tpu_torch.ops.correlation import (
        correlation_bwd_f1_torch,
        correlation_bwd_f2_torch,
        correlation_torch,
        displacement_count,
    )
    from unflow_tpu_torch.ops.cuda.correlation import (
        KERNELS,
        TENSOR_CORE_SOURCES,
        correlation_bwd_f1,
        correlation_bwd_f2,
        correlation_fwd,
        kernel_name,
        launch_counts,
    )

    # op -> (wrapper, plain version); each takes (a, b, P, s): the forward
    # (f1, f2), a gradient (cotangent, the other map)
    ops = {
        "fwd": (correlation_fwd, correlation_torch),
        "bwd_f1": (correlation_bwd_f1, correlation_bwd_f1_torch),
        "bwd_f2": (correlation_bwd_f2, correlation_bwd_f2_torch),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for case, shape, p, s in KERNEL_CASES:
        d = displacement_count(p, s)
        for dtype in (torch.float32, torch.bfloat16):
            f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn((*shape[:3], d * d), generator=gen, device="cuda").to(dtype)
            for op, (kernel, plain) in ops.items():
                a, b = (f1, f2) if op == "fwd" else (g, f1)
                name = kernel_name(op, dtype, shape[3], p, s)
                # only the stride-4 case goes to the FP32-core twins by itself
                if name.endswith("_simt") != (case == SIMT_CASE and dtype == torch.bfloat16
                                              and op in TENSOR_CORE_SOURCES):
                    raise AssertionError(f"{case}: the dispatch chose {name}")
                # a tensor-core kernel's twin is launched too, past the dispatch
                names = [name] + [n for n in (name + "_simt",) if n in KERNELS]
                with torch.inference_mode():
                    ref = plain(a, b, p, s)
                    plain_ms = median_ms(lambda: plain(a, b, p, s), runs=5, warmup=1)
                scale = ref.float().abs().max().item()
                bound, bound_by = bound_ms(shape, d, dtype)
                times = {}
                for which in names:
                    forced = {"kernel": which} if which != name else {}
                    before = launch_counts()[which]
                    with torch.inference_mode():
                        got = kernel(a, b, p, s, **forced)
                        torch.cuda.synchronize()
                        ms = times[which] = median_ms(lambda: kernel(a, b, p, s, **forced))
                    if which == "corr_fwd_f32":
                        fwd_f32_ms = ms
                    if launch_counts()[which] <= before:
                        raise AssertionError(f"{which} was not the kernel launched at {case}")
                    err = (got.float() - ref.float()).abs().max().item()
                    print(f"kernel {which} {case} {shape} P={p} s={s}: max_abs_err {err:.3e} "
                          f"(max|ref| {scale:.3e}, tol {TOLERANCE[dtype]}) ms {ms:.4f} "
                          f"plain_ms {plain_ms:.3f} bound_ms {bound:.4f} ({bound_by}) "
                          f"ms/bound {ms / bound:.2f}", flush=True)
                    if not err <= TOLERANCE[dtype] * scale:
                        raise AssertionError(f"{which} disagrees with its plain version at {case}")
                    if case == "train" and which in ("corr_bwd_f1_f32", "corr_bwd_f2_f32"):
                        # the same FMAs against the same bound as the f32 forward
                        print(f"ratio {which} / corr_fwd_f32 train: "
                              f"{ms / fwd_f32_ms:.2f} ({ms:.4f} / {fwd_f32_ms:.4f} ms)", flush=True)
                    if case == (SIMT_CASE if which.endswith("_simt") else REPORT_CASE[op]):
                        report[which] = {
                            "name": which, "route": "cuda",
                            "source": f"unflow_tpu_torch/csrc/{KERNELS[which][0]}.cu",
                            "replaces": REPLACES[which], "launches": 0, "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": bound_by, "library_ms": None, "shape": list(shape),
                            "max_displacement": p, "stride": s,
                        }
                if len(names) == 2:
                    ms, simt_ms = times[name], times[name + "_simt"]
                    print(f"tensor cores {name} {case}: ms {ms:.4f} simt_ms {simt_ms:.4f} "
                          f"bound_ms {bound:.4f} ms/bound_ms {ms / bound:.2f} "
                          f"simt_ms/ms {simt_ms / ms:.2f}; {banded_work(op, shape, p, s)}",
                          flush=True)
                    if case == "train" and not ms < simt_ms:
                        raise AssertionError(f"{name} is slower than {name}_simt at {shape}")
    return report


def check_function() -> None:
    """The autograd Function over the three kernels against autograd through
    the plain version: gradients of a random projection of the volume taken
    in NCHW, so the cotangent reaches the Function as a permuted view."""
    from unflow_tpu_torch.ops.correlation import correlation, displacement_count

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape, p, s = (2, 24, 75, 64), 20, 2
    d = displacement_count(p, s)
    for dtype in (torch.float32, torch.bfloat16):
        f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_()
        f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_()
        proj = torch.randn((shape[0], d * d, *shape[1:3]), generator=gen, device="cuda").to(dtype)

        def grads(impl):
            volume = correlation(f1, f2, p, s, impl=impl).permute(0, 3, 1, 2)
            return torch.autograd.grad((volume * proj).sum(), (f1, f2))

        for which, got, want in zip(("df1", "df2"), grads("cuda"), grads("torch")):
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            print(f"function {which} {dtype} {shape} P={p} s={s}: max_abs_err {err:.3e} "
                  f"(max|ref| {scale:.3e}, tol {TOLERANCE[dtype]})", flush=True)
            if not err <= TOLERANCE[dtype] * scale:
                raise AssertionError(f"CorrelationFunction {which} disagrees with autograd")


def synthetic_frames(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Smooth random textures in [0, 1]; frame 2 is frame 1 shifted."""
    gen = torch.Generator().manual_seed(seed)
    h, w = FRAME_HW
    coarse = torch.rand(n, 3, h // 8 + 2, w // 8 + 2, generator=gen)
    tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
    im1 = tex[:, :, :h, :w]
    im2 = tex[:, :, 3 : h + 3, 5 : w + 5]
    return (im1.permute(0, 2, 3, 1).numpy().copy(), im2.permute(0, 2, 3, 1).numpy().copy())


def simt_launches() -> int:
    """Launches of the FP32-core twins since the counts were reset: a main
    path whose geometry the tensor-core kernels take must make none."""
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts

    return sum(v for k, v in launch_counts().items() if k.endswith("_simt"))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms: its default ones may sum a
    convolution's weight gradient in another order from one call to the
    next."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def relative_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def run_cli(tmp: Path) -> int:
    from unflow_tpu_torch.cli.infer import main as infer_main
    from unflow_tpu_torch.data.io import read_flo, write_image
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    im1, im2 = synthetic_frames(1)
    write_image(tmp / "im1.png", im1[0])
    write_image(tmp / "im2.png", im2[0])
    reset_launch_counts()
    t = time.perf_counter()
    rc = infer_main(["--random-init", "--config", str(CONFIG), "--im1", str(tmp / "im1.png"),
                     "--im2", str(tmp / "im2.png"), "--out", str(tmp / "flow.flo"),
                     "--viz", str(tmp / "flow.png")])
    torch.cuda.synchronize()
    launches = launch_counts()["corr_fwd_bf16"]
    flow = read_flo(tmp / "flow.flo")
    print(f"main path cli.infer bf16: rc {rc} launches {launch_counts()} "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if rc != 0 or launches < 1 or simt_launches():
        raise AssertionError("cli.infer failed or did not launch the tensor-core bf16 kernel")
    if flow.shape != (*FRAME_HW, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"bad flow from cli.infer: {flow.shape}")
    return launches


def profile_call(fn, what: str, wall_s: float, top: int = 8) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and the
    device's busy share of the unprofiled wall time ``wall_s`` of one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels and copies, without the profiler's annotations (Optimizer.step#...),
    # whose time their kernels already count
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  profile: device busy {busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms wall per {what} "
          f"({busy_ms / (wall_s * 1e3):.3f}), {sum(e.count for e in rows)} kernels and copies")
    groups: dict[str, list[float]] = {}
    for e in rows:
        group = next((g for g, words in PROFILE_GROUPS.items() if any(w in e.key for w in words)),
                     "other PyTorch kernels")
        ms_count = groups.setdefault(group, [0.0, 0])
        ms_count[0] += e.self_device_time_total / 1e3
        ms_count[1] += e.count
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  profile group: {ms:9.3f} ms  x{count:<5d} {group}")
    for e in sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"  profile: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def run_eval(dtype: str, kernel: str, tolerance: float,
             exp_dir: Path | None = None) -> tuple[int, float]:
    """``Evaluator.predict_batch`` at batch 4: FlowNetC of configs/kitti_unsup_c.ini
    with random weights, or the network and weights of the experiment
    ``exp_dir`` (its snapshot and latest checkpoint)."""
    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.data import DEFAULT_NORMALIZATION, dataset_normalization
    from unflow_tpu_torch.eval.evaluate import Evaluator
    from unflow_tpu_torch.models import build_model, init_params
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts
    from unflow_tpu_torch.train import restore_params

    cfg = load_config(CONFIG if exp_dir is None else exp_dir / "config.ini")
    cfg.train.compute_dtype = dtype
    norm = dataset_normalization(cfg.train.dataset) or DEFAULT_NORMALIZATION
    if exp_dir is None:
        model = build_model(cfg, "cpu")
        init_params(model, torch.Generator().manual_seed(1))
        params = model.state_dict()
        ev = Evaluator(cfg, params=params, normalization=norm, device="cuda")
    else:
        params = restore_params(exp_dir)
        ev = Evaluator(cfg, exp_dir, normalization=norm, device="cuda")
    ims1, ims2 = synthetic_frames(4, seed=2)
    ev.predict_batch(ims1, ims2)  # warm-up: cuDNN picks its algorithms
    reset_launch_counts()
    flow = ev.predict_batch(ims1, ims2)
    launches = launch_counts()[kernel]
    runs = 5
    t = time.perf_counter()
    for _ in range(runs):
        ev.predict_batch(ims1, ims2)
    pairs_per_s = runs * len(ims1) / (time.perf_counter() - t)

    print(f"main path predict_batch {cfg.train.flownet} {dtype} batch 4: launches {launches} of "
          f"{kernel} "
          f"pairs/s {pairs_per_s:.3f} (host clock, {runs} batches, incl. host padding "
          f"and copies)", flush=True)
    profile_call(lambda: ev.predict_batch(ims1, ims2), "batch", len(ims1) / pairs_per_s)

    ref_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, corr_impl="torch"))
    ref = Evaluator(ref_cfg, params=params, normalization=norm, device="cuda")
    want = ref.predict_batch(ims1, ims2)
    err = relative_l2(flow, want)
    print(f"main path predict_batch {cfg.train.flownet} {dtype}: relative_l2_vs_plain {err:.3e} "
          f"(tol {tolerance})",
          flush=True)
    if launches < 1 or simt_launches():
        raise AssertionError(f"predict_batch {dtype} did not launch {kernel}")
    if flow.shape != (4, *FRAME_HW, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"bad flow from predict_batch {dtype}")
    if not err < tolerance:
        raise AssertionError(f"predict_batch {dtype} disagrees with the plain correlation")
    return launches, pairs_per_s


def train_config(tmp: Path, config: Path = CONFIG, **overrides):
    """``config`` with ``dataset=synthetic``, its log directory under ``tmp``
    and ``overrides`` applied; also written to ``tmp/<config's name>`` for the
    CLI."""
    from unflow_tpu_torch.config import load_config, save_config

    cfg = load_config(config)
    cfg.dirs.log = str(tmp / "log")
    cfg.train.dataset = "synthetic"
    for key, value in overrides.items():
        setattr(cfg.train, key, value)
    save_config(cfg, tmp / config.name)
    return cfg


def run_train_cli(tmp: Path, dtype: str, steps: int, batch: int,
                  corr_stride: int | None = None) -> dict[str, int]:
    """``cli.train`` in-process; returns the launch counts of the run, which
    must be ``steps`` for each of the three kernels that the dispatch picks
    for this dtype and displacement grid, and 0 for every other kernel.
    ``corr_stride`` sets the config key of that name (the config's is 2)."""
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.models import DTYPES
    from unflow_tpu_torch.ops.cuda.correlation import (
        kernel_name,
        launch_counts,
        reset_launch_counts,
    )

    cfg = train_config(tmp)
    stride = corr_stride or cfg.train.corr_stride
    name = f"smoke_{dtype}_s{stride}"
    reset_launch_counts()
    t = time.perf_counter()
    rc = train_main(["--config", str(tmp / CONFIG.name), "--ex", name,
                     "--set", f"compute_dtype={dtype}", "--set", f"batch_size={batch}",
                     "--set", f"corr_stride={stride}",
                     "--set", f"num_iters={steps}", "--set", f"display_interval={min(4, steps)}"])
    torch.cuda.synchronize()
    counts = launch_counts()
    # the correlation sees FlowNetC's conv3 maps: 256 channels
    expected = {kernel_name(op, DTYPES[dtype], 256, cfg.train.max_displacement, stride)
                for op in ("fwd", "bwd_f1", "bwd_f2")}
    mine = {k: v for k, v in counts.items() if v}
    metrics = cfg.experiment_dir(name) / "metrics.jsonl"
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    print(f"train path cli.train {dtype} 320x1152 batch {batch} corr_stride {stride}: rc {rc} "
          f"steps {steps} launches {mine} {time.perf_counter() - t:.2f} s", flush=True)
    if rc != 0 or set(mine) != expected or any(v != steps for v in mine.values()):
        raise AssertionError(f"cli.train {dtype} did not launch each kernel once per step: {counts}")
    last = records[-1]
    print(f"train path cli.train {dtype}: step {last['step']} loss {last['loss']:.5g} "
          f"grad_norm {last['grad_norm']:.5g} pairs/s {last['pairs_per_sec']:.3f} "
          f"step_ms {last['step_ms']:.3f} (the Trainer's last window; the host renders "
          f"the synthetic pairs meanwhile)", flush=True)
    if last["step"] != steps or not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"cli.train {dtype}: bad metrics.jsonl {records}")
    return mine


def host_batches(batch: int, count: int):
    """``count`` synthetic 320x1152 batches, rendered up front."""
    from unflow_tpu_torch.data.synthetic import batch_iterator

    stream = batch_iterator(batch, 320, 1152, seed=3, num_threads=4)
    batches = [next(stream) for _ in range(count)]
    stream.close()
    return batches


def run_train_twin(tmp: Path, dtype: str, batch: int, tolerance: float,
                   corr_stride: int = 2, config: Path = CONFIG, seed: int = 5,
                   control: bool = False, **overrides) -> None:
    """One train step through the kernels against the same step through the
    plain correlation: same parameters (from ``seed``), batch and step seed,
    cuDNN held to its deterministic algorithms (so that the two steps differ
    by the correlation alone). The step through the kernels must launch the
    three that the dispatch picks, once each. A stack's gap is also printed
    per stage and for its largest leaves; with ``control`` the plain step
    runs twice, and the gap between those two (what is left of the card's
    run-to-run spread: the float atomics of the gathers' and the resizes'
    gradients) is printed beside it."""
    from unflow_tpu_torch.models import DTYPES, build_model, init_params
    from unflow_tpu_torch.ops.cuda.correlation import (
        kernel_name,
        launch_counts,
        reset_launch_counts,
    )
    from unflow_tpu_torch.train import Trainer

    batches = host_batches(batch, 1)
    results, launched = {}, {}
    params = None
    for impl in ("cuda", "torch", "torch_again") if control else ("cuda", "torch"):
        cfg = train_config(tmp, config, compute_dtype=dtype, batch_size=batch,
                           corr_impl=impl.removesuffix("_again"), corr_stride=corr_stride,
                           **overrides)
        if params is None:
            model = build_model(cfg, "cpu")
            init_params(model, torch.Generator().manual_seed(seed))
            params = model.state_dict()
        trainer = Trainer(cfg, tmp / f"twin_{cfg.train.flownet}_{dtype}_s{corr_stride}_{impl}",
                          [], device="cuda", params=params)
        reset_launch_counts()
        with deterministic_cudnn():
            logs = {k: float(v) for k, v in trainer.train_step(batches[0]).items()}
            torch.cuda.synchronize()
        launched[impl] = {k: v for k, v in launch_counts().items() if v}
        grads = {n: p.grad.flatten() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        results[impl] = (logs["loss"], logs["grad_norm"], grads)
    # every twin's correlation sees FlowNetC's conv3 maps: 256 channels
    expected = {kernel_name(op, DTYPES[dtype], 256, cfg.train.max_displacement, corr_stride): 1
                for op in ("fwd", "bwd_f1", "bwd_f2")}

    def gaps(a, b):
        (loss_a, norm_a, g_a), (loss_b, norm_b, g_b) = results[a], results[b]
        flat_a, flat_b = torch.cat(list(g_a.values())), torch.cat(list(g_b.values()))
        rel = {
            "loss": abs(loss_a - loss_b) / abs(loss_b),
            "grad_norm": abs(norm_a - norm_b) / abs(norm_b),
            "gradient_l2": (torch.linalg.vector_norm(flat_a - flat_b)
                            / torch.linalg.vector_norm(flat_b)).item(),
        }
        # each stage's share of the whole gradient's gap, and the largest leaves'
        total = torch.linalg.vector_norm(flat_b).item()
        leaf = {n: torch.linalg.vector_norm(g_a[n] - g_b[n]).item() / total for n in g_b}
        stages = sorted({n.split(".")[0] for n in g_b})
        per_stage = {st: float(np.sqrt(sum(v * v for n, v in leaf.items() if n.startswith(st + "."))))
                     for st in stages}
        top = sorted(leaf.items(), key=lambda kv: -kv[1])[:3]
        return rel, per_stage, top

    what = (f"{cfg.train.flownet}{' train_all' if cfg.train.train_all else ''} {dtype}"
            f"{f' init seed {seed}' if seed != 5 else ''}")
    rel, per_stage, top = gaps("cuda", "torch")
    (loss_a, norm_a, _), (loss_b, norm_b, _) = results["cuda"], results["torch"]
    print(f"train step vs plain twin {what} batch {batch} corr_stride {corr_stride}: "
          f"loss {loss_a:.6g} vs {loss_b:.6g}, grad_norm {norm_a:.6g} vs {norm_b:.6g}, "
          "relative differences " + " ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (tol {tolerance}); launches {launched['cuda']}", flush=True)
    pairs = [("kernels vs plain", per_stage, top)]
    if control:
        c_rel, c_stage, c_top = gaps("torch_again", "torch")
        print(f"  control, plain vs plain (same step again): relative differences "
              + " ".join(f"{k} {v:.3e}" for k, v in c_rel.items()), flush=True)
        pairs.append(("plain vs plain", c_stage, c_top))
    if len(per_stage) > 1:
        for label, stage_gap, leaves in pairs:
            print(f"  {label}: gap per stage (share of the whole gradient's norm) "
                  + " ".join(f"{k} {v:.3e}" for k, v in stage_gap.items())
                  + "; largest leaves " + " ".join(f"{n} {v:.3e}" for n, v in leaves), flush=True)
    if not (np.isfinite(loss_a) and all(v < tolerance for v in rel.values())):
        raise AssertionError(f"train step {what} disagrees with its plain-correlation twin")
    want = {"cuda": expected, "torch": {}, **({"torch_again": {}} if control else {})}
    if launched != want:
        raise AssertionError(f"train step {what} did not launch {expected}: {launched}")


def run_cudnn_spread(tmp: Path, seed: int = 7) -> None:
    """The f32 ``CSS`` + ``train_all`` step at batch 2 through the plain
    correlation, twice, with cuDNN free to pick its algorithms: the card's
    run-to-run spread that the twins are held clear of. A measurement only."""
    from unflow_tpu_torch.models import build_model, init_params
    from unflow_tpu_torch.train import Trainer

    cfg = train_config(tmp, CSS_CONFIG, compute_dtype="float32", batch_size=2, corr_impl="torch",
                       flownet="CSS", train_all=True, finetune=())
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    batch = host_batches(2, 1)[0]
    grads = []
    for run in range(2):
        trainer = Trainer(cfg, tmp / f"spread_{run}", [], device="cuda", params=model.state_dict())
        trainer.train_step(batch)
        grads.append(torch.cat([p.grad.flatten() for p in trainer.model.parameters()]))
    rel = (torch.linalg.vector_norm(grads[0] - grads[1]) / torch.linalg.vector_norm(grads[1])).item()
    print(f"cuDNN's own spread, f32 CSS train_all init seed {seed} batch 2, plain step twice with "
          f"cuDNN's default algorithms: gradient relative L2 {rel:.3e}", flush=True)


def run_train_timed(tmp: Path, config: Path = CONFIG, warmup: int = 4, steps: int = 16,
                    **overrides) -> None:
    """``Trainer.run`` at 320x1152, batch 8, bf16 on batches that are ready on
    the host: the step's time from the Trainer's own window (the checkpoint
    saves left out), the peak memory and a profile of one step."""
    from unflow_tpu_torch.train import Trainer

    cfg = train_config(tmp, config, num_iters=warmup + steps, display_interval=warmup + steps,
                       **overrides)
    what = f"{cfg.train.flownet}{' train_all' if cfg.train.train_all else ''}"
    exp_dir = tmp / f"timed_{what.replace(' ', '_')}"
    trainer = Trainer(cfg, exp_dir, itertools.cycle(host_batches(8, 2)), device="cuda")
    trainer.run(max_iters=warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the window of the one record starts at run(); the warm-up logged nothing
    trainer.run()
    record = json.loads((exp_dir / "metrics.jsonl").read_text().splitlines()[-1])
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"train Trainer.run {what} bf16 320x1152 batch 8, host batches ready: pairs/s "
          f"{record['pairs_per_sec']:.3f} step_ms {record['step_ms']:.3f} over {steps} steps "
          f"(host clock, incl. host->device copies); loss {record['loss']:.5g}; peak memory "
          f"{peak / 2**20:.1f} MiB ({peak / total:.3f} of the card's {total / 2**30:.1f} GiB)",
          flush=True)
    profile_call(lambda: trainer.train_step(next(trainer.batches)), "train step",
                 record["step_ms"] / 1e3, top=14)
    # After earlier profiler sessions in one process the tracer was seen to
    # drop the large pageable copies, so the batch's copy is timed on its own.
    batch = next(trainer.batches)
    copy_ms = median_ms(lambda: trainer.put_batch(batch), runs=5, warmup=1)
    mib = sum(batch[k].nbytes for k in ("im1", "im2")) / 2**20
    print(f"  batch host->device copy ({mib:.1f} MiB, pageable): {copy_ms:.3f} ms by CUDA events "
          f"(part of each step; it may be missing from the profile above)", flush=True)
    shutil.rmtree(exp_dir)  # its checkpoints: a cascade's is over a GB


def run_train_profiled_f32(tmp: Path, warmup: int = 2) -> None:
    """One f32 train step at 320x1152, batch 8 (TF32 off), profiled after a
    warm-up: the share of the f32 gradients in the step they serve."""
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts
    from unflow_tpu_torch.train import Trainer

    cfg = train_config(tmp, compute_dtype="float32", num_iters=warmup, display_interval=warmup)
    trainer = Trainer(cfg, tmp / "profiled_f32", itertools.cycle(host_batches(8, 1)), device="cuda")
    trainer.run(max_iters=warmup)
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    trainer.train_step(next(trainer.batches))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    mine = {k: v for k, v in launch_counts().items() if v}
    print(f"train step f32 320x1152 batch 8: {wall_s * 1e3:.3f} ms (host clock, one step after "
          f"{warmup} warm-up steps) launches {mine}", flush=True)
    if mine != {"corr_fwd_f32": 1, "corr_bwd_f1_f32": 1, "corr_bwd_f2_f32": 1}:
        raise AssertionError(f"the f32 train step did not launch the three f32 kernels: {mine}")
    profile_call(lambda: trainer.train_step(next(trainer.batches)), "f32 train step", wall_s, top=14)


def run_recipe(tmp: Path) -> None:
    """C -> cS -> csS through ``cli.train``: each run's launches, then the
    frozen stages of the csS checkpoint against the experiments they came
    from."""
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts
    from unflow_tpu_torch.train import restore_params

    for ex, config, expected in (
        ("kitti_c", CONFIG, dict.fromkeys(TENSOR_CORE_KERNELS, RECIPE_STEPS)),
        ("kitti_cs", CS_CONFIG, {"corr_fwd_bf16": RECIPE_STEPS}),
        ("kitti_css", CSS_CONFIG, {"corr_fwd_bf16": RECIPE_STEPS}),
    ):
        cfg = train_config(tmp, config, num_iters=RECIPE_STEPS, save_interval=2,
                           display_interval=1)
        reset_launch_counts()
        t = time.perf_counter()
        rc = train_main(["--config", str(tmp / config.name), "--ex", ex])
        torch.cuda.synchronize()
        mine = {k: v for k, v in launch_counts().items() if v}
        records = [json.loads(line) for line in
                   (cfg.experiment_dir(ex) / "metrics.jsonl").read_text().splitlines()]
        losses = [round(r["loss"], 4) for r in records]
        print(f"recipe cli.train {ex} ({cfg.train.flownet}, finetune {list(cfg.train.finetune)}) "
              f"bf16 320x1152 batch 8: rc {rc} steps {RECIPE_STEPS} launches {mine} losses "
              f"{losses} {time.perf_counter() - t:.2f} s", flush=True)
        if rc != 0 or mine != expected:
            raise AssertionError(f"recipe {ex}: expected launches {expected}, got {mine}")
        if [r["step"] for r in records] != [1, 2] or not np.isfinite(losses).all():
            raise AssertionError(f"recipe {ex}: bad metrics.jsonl {records}")
    p_c, p_cs, p_css = (restore_params(cfg.experiment_dir(ex))
                        for ex in ("kitti_c", "kitti_cs", "kitti_css"))
    c_keys = [k for k in p_c if k.startswith("stage0_C.")]
    s_keys = [k for k in p_cs if k.startswith("stage1_S.")]
    c_equal = all(torch.equal(p_c[k], p_css[k]) for k in c_keys)
    s_equal = all(torch.equal(p_cs[k], p_css[k]) for k in s_keys)
    print(f"recipe: kitti_css stage0_C bit-equal to kitti_c's ({len(c_keys)} tensors): {c_equal}; "
          f"stage1_S bit-equal to kitti_cs's ({len(s_keys)} tensors): {s_equal}", flush=True)
    if not (c_keys and s_keys and c_equal and s_equal):
        raise AssertionError("the csS checkpoint's frozen stages differ from their sources")


def run_resume(tmp: Path, steps: int = 4, split: int = 2) -> None:
    """csS (finetuned from the recipe's experiments) for ``steps`` steps in one
    ``Trainer``, and as two segments split at ``split``: the losses after the
    split and the parameters at the end must be identical. The step of csS
    has no float atomics (the frozen stages' inputs and the frames need no
    gradient), and cuDNN is held to its deterministic algorithms here."""
    from unflow_tpu_torch.data.synthetic import batch_iterator
    from unflow_tpu_torch.train import Trainer

    cfg = train_config(tmp, CSS_CONFIG, num_iters=steps, save_interval=split, display_interval=1)
    streams = []

    def stream(start: int):
        streams.append(batch_iterator(8, 320, 1152, seed=cfg.train.seed, start_batch=start,
                                      num_threads=4))
        return streams[-1]

    try:
        with deterministic_cudnn():
            whole = Trainer(cfg, tmp / "resume_whole", stream(0), device="cuda")
            whole.run()
            first = Trainer(cfg, tmp / "resume_split", stream(0), device="cuda")
            first.run(max_iters=split)
            second = Trainer(cfg, tmp / "resume_split", stream(split), device="cuda")
            if second.step != split:
                raise AssertionError(f"resume: the second segment starts at step {second.step}")
            second.run()
    finally:
        for s in streams:
            s.close()

    def losses(name):
        lines = (tmp / name / "metrics.jsonl").read_text().splitlines()
        return {r["step"]: r["loss"] for r in map(json.loads, lines) if r["step"] > split}

    a, b = losses("resume_whole"), losses("resume_split")
    with torch.no_grad():
        diff = max((p - q).abs().max().item()
                   for p, q in zip(whole.model.parameters(), second.model.parameters()))
    print(f"resume csS bf16 320x1152 batch 8: losses of steps {sorted(a)} uninterrupted "
          f"{[a[k] for k in sorted(a)]} two segments {[b[k] for k in sorted(b)]}; largest "
          f"parameter difference {diff:.3e} (both must be identical)", flush=True)
    if not (sorted(a) == sorted(b) == list(range(split + 1, steps + 1)) and a == b and diff == 0):
        raise AssertionError("the resumed csS run is not bit-identical to the uninterrupted one")
    for name in ("resume_whole", "resume_split"):
        shutil.rmtree(tmp / name)


def run_serving_cascade(tmp: Path) -> None:
    """``cli.infer --ex kitti_css`` from the directory that holds ``log/``, so
    the experiment's snapshot supplies the network."""
    from unflow_tpu_torch.cli.infer import main as infer_main
    from unflow_tpu_torch.data.io import read_flo, write_image
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    im1, im2 = synthetic_frames(1, seed=4)
    write_image(tmp / "css_im1.png", im1[0])
    write_image(tmp / "css_im2.png", im2[0])
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_launch_counts()
        t = time.perf_counter()
        rc = infer_main(["--ex", "kitti_css", "--im1", "css_im1.png", "--im2", "css_im2.png",
                         "--out", "css.flo"])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    mine = {k: v for k, v in launch_counts().items() if v}
    flow = read_flo(tmp / "css.flo")
    print(f"main path cli.infer --ex kitti_css (csS, bf16): rc {rc} launches {mine} "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if rc != 0 or mine != {"corr_fwd_bf16": 1}:
        raise AssertionError(f"cli.infer --ex kitti_css: launches {mine}")
    if flow.shape != (*FRAME_HW, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"bad flow from cli.infer --ex kitti_css: {flow.shape}")
    run_eval("bfloat16", "corr_fwd_bf16", 2e-2, exp_dir=tmp / "log" / "ex" / "kitti_css")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, str(ROOT))
    from unflow_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    logs = build.build(sources)
    print(f"build {sources}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in build.ptxas_summary(log):
            print(f"  {name}: {line}")

    report = check_kernels()
    check_function()

    torch.backends.cudnn.allow_tf32 = False  # float32 means float32 in this check
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        report["corr_fwd_bf16"]["launches"] = run_cli(Path(tmp))
    run_eval("bfloat16", "corr_fwd_bf16", 2e-2)
    report["corr_fwd_f32"]["launches"], _ = run_eval("float32", "corr_fwd_f32", 1e-4)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the forward kernels keep the counts of the serving path; the
        # gradients' main path is the train step
        for dtype, steps, batch in (("bfloat16", TRAIN_STEPS, 8), ("float32", 1, 2)):
            for name, count in run_train_cli(tmp, dtype, steps, batch).items():
                if "bwd" in name:
                    report[name]["launches"] = count
                    report[name]["main_path"] = f"cli.train, {steps} step(s)"
        # corr_stride=4 is a grid the tensor-core kernels do not take: the same
        # entry point then goes through their FP32-core twins
        for name, count in run_train_cli(tmp, "bfloat16", 2, 8, corr_stride=4).items():
            if name.endswith("_simt"):
                report[name]["launches"] = count
                report[name]["main_path"] = "cli.train --set corr_stride=4, 2 step(s)"
        run_train_twin(tmp, "bfloat16", 8, 2e-2)
        run_train_twin(tmp, "float32", 2, 1e-4, control=True)
        run_train_twin(tmp, "bfloat16", 8, 2e-2, corr_stride=4)
        run_train_timed(tmp)
        run_train_profiled_f32(tmp)

        run_recipe(tmp)
        run_resume(tmp)
        run_serving_cascade(tmp)
        run_train_twin(tmp, "bfloat16", 8, 2e-2, config=CSS_CONFIG, flownet="CSS",
                       train_all=True, finetune=())
        for seed in (5, 6, 7):
            run_train_twin(tmp, "float32", 2, 1e-4, config=CSS_CONFIG, seed=seed, control=True,
                           flownet="CSS", train_all=True, finetune=())
        run_cudnn_spread(tmp)
        run_train_timed(tmp, CSS_CONFIG, finetune=())
        run_train_timed(tmp, CSS_CONFIG, flownet="CSS", train_all=True, finetune=())

    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [report[name] for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
