#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (unflow_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one GPU

A correctness smoke: each phase runs a path of the port on the card and
checks what it computes and which kernels it launches. It measures no path's
speed; ``flowbench/run.py --workload <cell>`` does (``BENCHMARK.json``). The
one timing kept is each correlation kernel's own, for PERF.md's kernel
table; the seconds on a check's line say only where the script spends its
time. Phases; any failure raises and the script exits non-zero without a
result line:

  1. build   -- nvcc compiles every CUDA source of the port for sm_90a, one
                process per source, all started together.
  2. kernels -- each of the nine kernels (correlation forward, gradient to f1,
                gradient to f2; float32 and bfloat16, and in bfloat16 both the
                tensor-core kernel and its FP32-core twin ``*_simt``, called
                past the dispatch) against its plain PyTorch
                version on the card (tolerance 1e-5 * max|ref| in float32, 0.02 *
                max|ref| in bfloat16), at the training geometry (16, 40, 144,
                256), the eval geometry (4, 48, 160, 256), the held-out run's
                (16, 16, 32, 256), the long run's (8, 16, 32, 256), the supervised
                and affine paths', the W-sharded slabs with their halos (16 and 8,
                40, 112, 256; uneven at 4 shards: 16, 40, 80 and 72, 256), the
                Sintel fine-tune's (16, 48, 96, 256) and eval's (4, 56, 128, 256),
                Middlebury's at batch 1 (56x56, 56x80 and 64x80), all with
                max_displacement 20 and stride 2, an
                odd case (W a multiple of no tile, stride 1), and the training
                geometry with stride 4,
                which the dispatch sends to the FP32-core kernels' run-time
                stride (in bfloat16 to the three ``*_simt`` twins; their reported
                numbers are from this case). Each launch must be the kernel the
                dispatch names. Times are medians of 20 launches,
                each timed with CUDA events after warm-up. A tensor-core kernel
                that is slower than its twin at the training geometry fails the run.
                Each f32 gradient's time at the training geometry is also printed
                as a ratio to the f32 forward's there (same FMAs, same bound).
                Then the autograd Function over the three kernels against
                autograd through the plain version, with a non-contiguous
                cotangent. Then the fused loss (``ops/cuda/loss.py``, the six
                kernels of ``csrc/loss.cu``) through ``unsupervised_loss``
                against the composite terms on the same card tensors, at the
                frames each training path hands it: 8x320x1152 (C, csS and
                CSS), the held-out run's 8x128x256, the Sintel fine-tune's
                8x384x768 and the affine pretraining's 8x512x768 with its
                config's terms (photo, no census): every log within 1e-5
                relative, both flow pyramids' gradients within 1e-4 relative
                L2, four forward launches and two backward, none on the
                composite path; its time forward and backward beside its
                bound and the composite's.
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
                must launch the three ``*_simt`` twins instead. Each run must
                launch the six loss kernels once a step. Then one train
                step through the kernels against the same step through the plain
                correlation and the composite loss (same parameters, batch and
                seed, cuDNN held to its deterministic algorithms), in bf16, in f32 and in bf16 with
                ``corr_stride=4``: loss, grad_norm and the relative L2 of the
                whole gradient must agree (2e-2 in bf16, 1e-4 in f32 with TF32
                off: the correlation's and the loss's summation orders differ),
                and the step must launch its three kernels and the six loss
                kernels once; the f32 step is also run
                twice through the plain correlation, as a control. Then one f32
                step at batch 8 (TF32 off) after two warm-up steps, which must
                launch each of the three f32 kernels once.
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
                (relative L2 < 2e-2).
  8. the ``CSS`` twins -- every stage trainable, ``train_all`` (each stage's loss,
                gradients through the warps into C): one step through the
                kernels against the plain-correlation step, bf16 at batch 8
                (2e-2) and f32 at batch 2 (1e-4, TF32 off) from three init seeds.
                Each f32 gap is printed per stage and for its largest leaves,
                beside the gap between two runs of the plain step itself.
  9. remat   -- per-stage rematerialization: ``cli.train --set remat=true`` for C,
                csS (from the recipe's experiments) and CSS with ``train_all``,
                2 steps each at 320x1152, batch 8, bf16 (a trainable C launches
                ``corr_fwd_bf16`` twice a step, once more for its recompute; a
                frozen c once). Then one step with remat against the same step
                without it, both through the kernels, cuDNN deterministic: bf16
                C at batch 8 (equal) and f32 CSS ``train_all`` at batch 2 (1e-6,
                TF32 off), each arm's launches asserted.
 10. real-data training -- a KITTI raw tree (2 drives of 9 frames at 375x1242,
                PNG, rendered from smooth textures) and a KITTI 2012 training
                tree (8 pairs of ``data/synthetic.py::make_pair`` at 375x1242,
                max_shift 32, ``flow_occ`` and a smaller ``flow_noc`` as 16-bit
                PNGs) are written; ``cli.pack`` packs the raw tree at 320x1152;
                ``cli.train`` (configs/kitti_unsup_c.ini, ``dataset=kitti_raw``,
                ``packed_dir``, ``eval_interval`` 6) runs 12 steps at batch 8,
                bf16: each of the three tensor-core kernels launches once per
                step (the forward once more per evaluation, on KITTI 2012's
                pairs), no ``*_simt``, the loss is finite and ``eval/aee`` is
                logged. The same run through the decoding Loader (no
                ``packed_dir``) follows, with the same checks.
 11. real-data evaluation -- ``cli.eval --ex kitti_real --dataset kitti_2012
                --batch 4`` prints AEE, Fl and the noc/occ breakdown and launches
                ``corr_fwd_bf16`` once per batch; ``Evaluator.run`` on the same
                weights through the kernel against the plain correlation (which
                launches no kernel): the 8 predicted flows within 2e-2 relative
                L2 in bf16, 1e-4 in f32 (TF32 off, through ``corr_fwd_f32``).
 12. held-out, short -- ``python -m unflow_tpu_torch.heldout`` at 128x256, batch
                8, a 64-pair corpus, 4 steps in 2 segments across
                ``--bootstrap-until 2``: the zero-flow AEE is 15.3428, the curve
                finite, and the three tensor-core kernels launch (the forward
                also for each held-out batch). Then the probes of
                ``unflow_tpu_torch/probes/``: the loss landscape at the JAX
                record's geometry beside ``benchmarks/loss_landscape.json``
                (the same ``monotone_to_gt`` verdicts), the supervised f32
                one-batch overfit for 200 steps (its AEE must fall), the
                autopsy of this run's checkpoint, and the input-dependence
                probe and the warm start for 24 steps a phase.
 13. supervised -- a FlyingChairs tree (16 pairs of the synthetic renderer at
                384x512, max_shift 32, PPM and ``.flo``) is written and packed
                with its ground truth; configs/chairs_supervised.ini as shipped
                (FlowNetS, 384x512, batch 8, bf16) through ``cli.train`` on the
                packed and the decoding Loader (6 steps, no correlation
                launched), then the packed run as FlowNetC (``--set
                flownet=C``, 2 steps, the three tensor-core kernels once a
                step, the forward twice more for each image summary, which
                the config as shipped writes every ``display_interval``);
                the loss on one repeated batch must fall. Then the
                supervised FlowNetC step against its plain-correlation twin:
                bf16 with dense and with sparse (KITTI-like) ground truth
                (2e-2), f32 with sparse ground truth (1e-4, TF32 off, with the
                plain-vs-plain control).
 14. disocc -- one bf16 FlowNetC step with ``mask_occlusion=disocc`` against
                its plain-correlation twin (2e-2); then the forward splat's
                run-to-run spread (float atomics): two density maps of one flow
                (ground truth at 320x1152 and an init net's finest flows), the
                share of their pixels and of the ``disocc`` mask's that differ.
 15. affine -- a SYNTHIA sequence (10 frames at 760x1280) is written;
                configs/synthia_pretrain_c_affine.ini as shipped (FlowNetC,
                512x768, batch 8, bf16, the affine augmentation) through
                ``cli.train`` for 6 steps (the three kernels once a step, and
                the summaries' forward launches); then
                the held-out run's ``affine_on`` arm cut as in phase 12, and
                ``python -m unflow_tpu_torch.cascade_heldout`` from it: cS and
                csS 4 steps each, every stage's held-out AEE finite, the csS
                checkpoint's frozen stages bit-equal to their sources, and
                one forward launch a step and a held-out batch in each
                stage. Beside it (both start their segments as processes of
                their own), ``python -m unflow_tpu_torch.longrun`` cut to 10
                steps in 3 segment processes (128x256, batch 4, bf16): every
                loss finite, the learning rate halved at steps 4 and 6, the
                segments stitched, the three tensor-core kernels once a step.
                Each segment process counts its own launches. Then
                configs/synthia_pretrain_c.ini as shipped on the same tree (2
                steps); an MPI-Sintel tree (2 scenes of 5 frames at 436x1024,
                clean and final passes, ``.flo`` ground truth, occlusion masks)
                and configs/sintel_finetune_css.ini through ``cli.train`` (csS
                at 384x768, batch 8, bf16, from ``kitti_c`` and ``kitti_cs``; 4
                steps, the forward once a step); ``cli.eval --dataset sintel``
                on it, clean and final, at batch 4; a Middlebury tree (the 8
                ``other-data`` scenes at their published sizes) and ``cli.eval
                --dataset middlebury --batch 1`` on ``kitti_c``. Each
                evaluation's flows against its plain-correlation twin
                (``Evaluator.run``: bf16 2e-2, f32 1e-4).
 16. summaries -- ``cli.train`` (configs/kitti_unsup_c.ini, synthetic) with
                ``tensorboard`` and an image summary every 2 of 4 steps; the
                event file is read back with ``read_events``: the scalars of
                steps 2 and 4, 7 images at each, and the summaries' forward
                launches.
 17. distributed -- ``cli.train`` under ``torchrun`` (this script re-run as
                ``--ddp-worker``, which joins the group and runs several
                ``cli.train`` jobs in it, the launch counts set to 0 before
                each) on the packed KITTI raw tree, configs/kitti_unsup_c.ini
                at 320x1152, global batch 8: one rank over NCCL (bf16, 4 steps;
                then one bf16 and one f32 step), each launching its three
                kernels once a step; two ranks (one per card over NCCL with two
                cards, else both on one card over gloo; printed) the same runs,
                held against the one-rank runs from the same config (one
                ``metrics.jsonl`` record a step; losses, one step's averaged
                gradient and the parameters' relative L2 within 2e-2 in bf16,
                1e-4 in f32 with TF32 off and cuDNN deterministic); the 2-rank
                checkpoint restored by the one-process ``Evaluator(exp_dir=)``
                against its plain twin; a 2-rank csS run resumed at step 2
                identical to the uninterrupted one; one 2-rank bf16 step with
                ``remat`` against the one-rank step without it (2e-2; the
                forward twice a step a rank).
 18. spatial -- W-sharding: ``cli.train --set spatial_shards=2`` under ``torchrun`` on the
                packed KITTI raw tree (configs/kitti_unsup_c.ini, 320x1152, global
                batch 8, a W-slab of 576 columns a rank). Two spatial ranks (one per
                card over NCCL with two cards, else both on one card over gloo):
                bf16 4 steps, one bf16 and one f32 step (TF32 off, cuDNN
                deterministic), held against phase 17's one-rank runs; one csS and
                one ``disocc`` bf16 step against the same steps in this process; the
                2x2 grid (4 ranks, one card over gloo with fewer than 4 cards), one
                f32 step against one rank, and the 1x4 grid (``spatial_shards=4``:
                uneven slabs of 320, 320, 256 and 256 columns), one f32 step
                against one rank; and one bf16 step with ``remat`` on 2 spatial
                ranks (the recompute re-issues the halo exchanges in the
                backward pass) against one rank without it. Limits 2e-2 in
                bf16, 1e-4 in f32 on the losses, the one-step gradient and the
                parameters; each rank's launches a step asserted.
 19. flops   -- ``utils/flops.py``'s count of the UnFlow-C bf16 step at 320x1152,
                batch 8, site by site (as the JAX package counts and keys it): the
                sites must sum to its 5,521,148,095,680.
 20. profile hooks -- ``utils.profiling.trace`` around two bf16 train steps: the
                trace reads back and names the three tensor-core kernels (run
                inside the step's replayed CUDA graph) and
                ``unflow.train.replay``.
 21. native decode -- ``UNFLOW_NATIVE=1``: the C++ sidecar builds into
                ``_build/``; the KITTI trees' frames and 16-bit flows and a
                ``Loader`` epoch equal the PIL / numpy path's bit for bit.

Prints the GPU's name and power limit first, then a line per check (and a
``phase ...: done at`` line after each group of phases), a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import statistics
import os
import re
import shutil
import socket
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
    # the fused loss, forward (loss_pyramid, loss_pixel, loss_stencil,
    # loss_finish) and backward (loss_grad, loss_grad_add): one entry point
    # each, timed as one; the JAX package leaves the loss to XLA
    "unflow_loss_forward": "unflow_tpu/losses/unsupervised.py:166",
    "unflow_loss_backward": "unflow_tpu/losses/unsupervised.py:166",
}
# the geometry each op's reported time is taken at: that of its main path
# (for a ``*_simt`` twin the stride-4 case, the one that reaches it)
REPORT_CASE = {"fwd": "eval", "bwd_f1": "train", "bwd_f2": "train"}
SIMT_CASE = "stride4"
TRAIN_STEPS = 12
RECIPE_STEPS = 2
TENSOR_CORE_KERNELS = ("corr_fwd_bf16", "corr_bwd_f1_bf16", "corr_bwd_f2_bf16")
CHAIRS_CONFIG = ROOT / "configs" / "chairs_supervised.ini"
AFFINE_CONFIG = ROOT / "configs" / "synthia_pretrain_c_affine.ini"
CHAIRS_PAIRS = 16
SUPERVISED_STEPS = 6
SYNTHIA_FRAMES = 10
SYNTHIA_C_CONFIG = ROOT / "configs" / "synthia_pretrain_c.ini"
SINTEL_CONFIG = ROOT / "configs" / "sintel_finetune_css.ini"
# MPI-Sintel's training frames (1041 pairs in 23 scenes), cut to 2 scenes of 5
SINTEL_HW = (436, 1024)
SINTEL_SCENES = ("alley_1", "market_2")
SINTEL_FRAMES = 5
SINTEL_STEPS = 4
SINTEL_EVAL_BATCH = 4
# Middlebury's other-data scenes with ground truth, at their published sizes
MIDDLEBURY_SCENES = {
    "Dimetrodon": (388, 584), "Grove2": (480, 640), "Grove3": (480, 640),
    "Hydrangea": (388, 584), "RubberWhale": (388, 584), "Urban2": (480, 640),
    "Urban3": (480, 640), "Venus": (388, 420),
}
# the real-data phases' trees, at KITTI's geometry
KITTI_RAW_DRIVES = ("2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync")
RAW_FRAMES = 9
KITTI_PAIRS = 8
REAL_EVAL_INTERVAL = 6
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 0.02}
# the JAX package's count of the UnFlow-C bf16 step at 320x1152, batch 8
# (tests/test_torch_flops.py holds the port's equal to it)
UNFLOW_C_FLOPS = 5_521_148_095_680
# (name, (B, H, W, C), max_displacement, stride)
KERNEL_CASES = [
    ("train", (16, 40, 144, 256), 20, 2),
    ("eval", (4, 48, 160, 256), 20, 2),
    ("odd", (2, 24, 75, 256), 10, 1),
    (SIMT_CASE, (16, 40, 144, 256), 20, 4),
    ("heldout", (16, 16, 32, 256), 20, 2),  # the held-out run: 128x256, batch 8
    # configs/chairs_supervised.ini as FlowNetC: 384x512, batch 8, one direction
    ("supervised", (8, 48, 64, 256), 20, 2),
    ("affine", (16, 64, 96, 256), 20, 2),  # configs/synthia_pretrain_c_affine.ini: 512x768
    # W-sharding, spatial_shards = 2 (run_spatial): a rank's conv3 slab of 72
    # columns with the correlation's halo of 20 on each side; 320x1152 at
    # batch 8 on one data rank, and 4 pairs a data rank on the 2x2 grid
    ("spatial2", (16, 40, 112, 256), 20, 2),
    ("spatial2x2", (8, 40, 112, 256), 20, 2),
    # spatial_shards = 4 at 1152 columns: 18 of the deepest level split 5, 5,
    # 4, 4, so conv3 slabs of 40 and 32 columns, each with the halo of 20
    ("spatial4_wide", (16, 40, 80, 256), 20, 2),
    ("spatial4_narrow", (16, 40, 72, 256), 20, 2),
    ("longrun", (8, 16, 32, 256), 20, 2),  # the long run: 128x256, batch 4
    # configs/sintel_finetune_css.ini: csS at 384x768, batch 8 (the frozen C)
    ("sintel_train", (16, 48, 96, 256), 20, 2),
    # cli.eval --dataset sintel --batch 4: 436x1024 padded to 448x1024
    ("sintel_eval", (4, 56, 128, 256), 20, 2),
    # cli.eval --dataset middlebury --batch 1: 388x420, 388x584 and 480x640
    # padded to 448x448, 448x640 and 512x640
    ("middlebury_448x448", (1, 56, 56, 256), 20, 2),
    ("middlebury_448x640", (1, 56, 80, 256), 20, 2),
    ("middlebury_512x640", (1, 64, 80, 256), 20, 2),
]


# (case, config, batch, height, width): the frames each training path hands
# the loss, with that path's terms
LOSS_CASES = [
    ("train", CONFIG, 8, 320, 1152),  # C, csS and CSS at KITTI's crop
    ("heldout", CONFIG, 8, 128, 256),
    ("sintel_train", SINTEL_CONFIG, 8, 384, 768),
    ("affine", AFFINE_CONFIG, 8, 512, 768),  # photo, no census
]
LOSS_VALUE_RTOL, LOSS_GRAD_RTOL = 1e-5, 1e-4
# fp32 operations per pixel, direction and census neighbour, counted from
# csrc/loss.cu: census() 15 (two differences, two tau at 4, one difference,
# the Hamming term at 3, the sum), census_grad() 25
CENSUS_OPS = {"forward": 15, "backward": 25}


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


@contextlib.contextmanager
def composite_loss():
    """``unsupervised_loss`` through its composite terms, as on a CPU: for the
    arm that a kernel is held against."""
    from unflow_tpu_torch.losses import unsupervised

    fused_spec = unsupervised.fused_spec
    unsupervised.fused_spec = lambda *args, **kwargs: None
    try:
        yield
    finally:
        unsupervised.fused_spec = fused_spec


def reset_all_launch_counts() -> None:
    """Every hand-written kernel's launch counter to 0."""
    from unflow_tpu_torch.utils import profiling

    profiling.reset_counts(list(profiling.launch_counts()))


def loss_bound_ms(batch: int, h: int, w: int, radii, which: str) -> tuple[float, str]:
    """Least time of the fused loss's forward or backward over five levels.
    Forward: the frames and both flow pyramids read once. Backward: the flows
    and the per-pixel fields read, the pyramid of both frames read, the
    gradients written. Against the census's operations at the FP32 cores'
    peak (``CENSUS_OPS``)."""
    levels = [batch * (h >> (2 + i)) * (w >> (2 + i)) for i in range(len(radii))]
    pixels = sum(levels)
    neighbours = 2 * sum(n * (2 * r + 1) ** 2 for n, r in zip(levels, radii))
    if which == "forward":
        floats = 2 * batch * 3 * h * w + 2 * 2 * pixels
    else:  # flows 4, gradients 4, fields 2 x 4, pyramid 2 x 3 floats a pixel
        floats = (4 + 4 + 8 + 6) * pixels
    t_bytes = floats * 4 / HBM_BYTES_PER_S
    t_ops = neighbours * CENSUS_OPS[which] / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_loss() -> dict[str, dict]:
    """The fused loss against the composite terms on the same card tensors at
    each of ``LOSS_CASES``; its launches, and its time beside its bound and
    the composite's. Returns the kernel table's two entries, from the
    ``train`` case."""
    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.losses import unsupervised_loss
    from unflow_tpu_torch.losses.unsupervised import LAYER_PATCH_DISTANCES
    from unflow_tpu_torch.ops.cuda import loss as fused

    gen = torch.Generator(device="cuda").manual_seed(2)
    report = {}
    for case, config, batch, h, w in LOSS_CASES:
        t = load_config(config).train
        im1 = torch.rand(batch, h, w, 3, generator=gen, device="cuda")
        # the second frame: the first moved by a few pixels, plus noise
        im2 = (torch.roll(im1, (2, 3), (1, 2)) * 0.9
               + 0.1 * torch.rand(batch, h, w, 3, generator=gen, device="cuda"))
        im1, im2 = im1.permute(0, 3, 1, 2), im2.permute(0, 3, 1, 2)  # as the step hands them
        # one stacked pyramid a level, forward flows in the even rows
        flows = [(0.3 * torch.randn(2 * batch, 2, h >> (2 + i), w >> (2 + i), generator=gen,
                                    device="cuda")).requires_grad_() for i in range(5)]

        def loss():
            return unsupervised_loss(
                im1, im2, [f[0::2] for f in flows], [f[1::2] for f in flows],
                weights=t.loss_weights(), mask_occlusion=t.mask_occlusion,
                border_ratio=t.border_ratio)

        def loss_and_grads():
            total, logs = loss()
            return logs, torch.autograd.grad(total, flows)

        fused.reset_launch_counts()
        total, logs = loss()
        forward_launches = fused.launch_counts()
        grads = torch.autograd.grad(total, flows)
        launches = fused.launch_counts()
        with composite_loss():
            want_logs, want_grads = loss_and_grads()
            if any(fused.launch_counts()[k] != n for k, n in launches.items()):
                raise AssertionError(f"loss {case}: the composite path launched a fused kernel")
            with torch.no_grad():
                plain_ms = {"forward": median_ms(loss, runs=5, warmup=1)}
            plain_ms["backward"] = median_ms(loss_and_grads, runs=5, warmup=1) - plain_ms["forward"]
        with torch.no_grad():
            ms = {"forward": median_ms(loss)}
        ms["backward"] = median_ms(loss_and_grads) - ms["forward"]

        if set(logs) != set(want_logs):
            raise AssertionError(f"loss {case}: logs {sorted(logs)} against {sorted(want_logs)}")
        value_err = max(abs(float(logs[k]) - float(v)) / max(abs(float(v)), 1e-30)
                        for k, v in want_logs.items())
        grad_err = {
            d: float(torch.linalg.vector_norm(torch.cat([g[i::2].flatten() for g in grads])
                                              - torch.cat([g[i::2].flatten() for g in want_grads]))
                     / torch.linalg.vector_norm(torch.cat([g[i::2].flatten() for g in want_grads])))
            for i, d in enumerate(("fw", "bw"))}
        bounds = {which: loss_bound_ms(batch, h, w, LAYER_PATCH_DISTANCES, which)
                  for which in ("forward", "backward")}
        print(f"loss {case} {batch}x{h}x{w} ({config.name}, terms "
              f"{sorted(k[:-len('/scale0')] for k in logs if k.endswith('/scale0'))}): "
              f"largest relative value gap {value_err:.3e} (tol {LOSS_VALUE_RTOL}), gradients' "
              f"relative L2 fw {grad_err['fw']:.3e} bw {grad_err['bw']:.3e} "
              f"(tol {LOSS_GRAD_RTOL}); ms forward {ms['forward']:.4f} backward "
              f"{ms['backward']:.4f} bound_ms {bounds['forward'][0]:.4f} ({bounds['forward'][1]}) "
              f"and {bounds['backward'][0]:.4f} ({bounds['backward'][1]}), composite "
              f"forward {plain_ms['forward']:.3f} backward {plain_ms['backward']:.3f} (eager); "
              f"launches {launches}", flush=True)
        if not all(abs(float(logs[k]) - float(v)) <= LOSS_VALUE_RTOL * abs(float(v)) + 1e-9
                   for k, v in want_logs.items()):
            raise AssertionError(f"loss {case}: the fused logs disagree with the composite's")
        if not max(grad_err.values()) < LOSS_GRAD_RTOL:
            raise AssertionError(f"loss {case}: the fused gradients disagree with the composite's")
        if (forward_launches != {**dict.fromkeys(fused.FORWARD_KERNELS, 1),
                                 **dict.fromkeys(fused.BACKWARD_KERNELS, 0)}
                or launches != dict.fromkeys(fused.KERNELS, 1)):
            raise AssertionError(f"loss {case}: launches {forward_launches} then {launches}")
        if case == "train":
            for which, kernels in (("forward", fused.FORWARD_KERNELS),
                                   ("backward", fused.BACKWARD_KERNELS)):
                name = f"unflow_loss_{which}"
                report[name] = {
                    "name": name, "route": "cuda", "source": "unflow_tpu_torch/csrc/loss.cu",
                    "replaces": REPLACES[name], "kernels": list(kernels), "launches": 0,
                    "max_rel_err": value_err if which == "forward" else max(grad_err.values()),
                    "ms": ms[which], "plain_ms": plain_ms[which],
                    "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
                    "library_ms": None, "shape": [batch, h, w],
                }
    return report


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


def run_eval(dtype: str, kernel: str, tolerance: float,
             exp_dir: Path | None = None) -> int:
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
    print(f"main path predict_batch {cfg.train.flownet} {dtype} batch 4: launches {launches} of "
          f"{kernel}", flush=True)

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
    return launches


def train_config(tmp: Path, config: Path = CONFIG, dataset: str = "synthetic", **overrides):
    """``config`` with ``dataset`` (synthetic unless given), its data and log
    directories under ``tmp`` and ``overrides`` applied; also written to
    ``tmp/<config's name>`` for the CLI. Image summaries are off unless
    ``image_summary_interval`` is given: a summary's two forward applies
    launch the forward kernel twice more."""
    from unflow_tpu_torch.config import load_config, save_config

    cfg = load_config(config)
    cfg.dirs.data = str(tmp / "data")
    cfg.dirs.log = str(tmp / "log")
    cfg.train.dataset = dataset
    for key, value in {"image_summary_interval": -1, **overrides}.items():
        setattr(cfg.train, key, value)
    save_config(cfg, tmp / config.name)
    return cfg


def run_train_cli(tmp: Path, dtype: str, steps: int, batch: int,
                  corr_stride: int | None = None) -> dict[str, int]:
    """``cli.train`` in-process; returns the launch counts of the run, which
    must be ``steps`` for each of the three kernels that the dispatch picks
    for this dtype and displacement grid, and 0 for every other kernel.
    ``corr_stride`` sets the config key of that name (the config's is 2).
    Each of the six loss kernels must launch ``steps`` times too; their
    counts are returned with the correlation's."""
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.models import DTYPES
    from unflow_tpu_torch.ops.cuda import loss as fused
    from unflow_tpu_torch.ops.cuda.correlation import (
        kernel_name,
        launch_counts,
        reset_launch_counts,
    )

    cfg = train_config(tmp)
    stride = corr_stride or cfg.train.corr_stride
    name = f"smoke_{dtype}_s{stride}"
    reset_launch_counts()
    fused.reset_launch_counts()
    t = time.perf_counter()
    rc = train_main(["--config", str(tmp / CONFIG.name), "--ex", name,
                     "--set", f"compute_dtype={dtype}", "--set", f"batch_size={batch}",
                     "--set", f"corr_stride={stride}",
                     "--set", f"num_iters={steps}", "--set", f"display_interval={min(4, steps)}"])
    torch.cuda.synchronize()
    counts = launch_counts()
    loss_launches = fused.launch_counts()
    # the correlation sees FlowNetC's conv3 maps: 256 channels
    expected = {kernel_name(op, DTYPES[dtype], 256, cfg.train.max_displacement, stride)
                for op in ("fwd", "bwd_f1", "bwd_f2")}
    mine = {k: v for k, v in counts.items() if v}
    metrics = cfg.experiment_dir(name) / "metrics.jsonl"
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    print(f"train path cli.train {dtype} 320x1152 batch {batch} corr_stride {stride}: rc {rc} "
          f"steps {steps} launches {mine}, loss {loss_launches} {time.perf_counter() - t:.2f} s",
          flush=True)
    if rc != 0 or set(mine) != expected or any(v != steps for v in mine.values()):
        raise AssertionError(f"cli.train {dtype} did not launch each kernel once per step: {counts}")
    if loss_launches != dict.fromkeys(fused.KERNELS, steps):
        raise AssertionError(f"cli.train {dtype} did not launch each loss kernel once per step: "
                             f"{loss_launches}")
    last = records[-1]
    print(f"train path cli.train {dtype}: step {last['step']} loss {last['loss']:.5g} "
          f"grad_norm {last['grad_norm']:.5g}", flush=True)
    if last["step"] != steps or not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"cli.train {dtype}: bad metrics.jsonl {records}")
    return {**mine, **loss_launches}


def host_batches(batch: int, count: int, supervised: str = ""):
    """``count`` synthetic 320x1152 batches, rendered up front; with
    ``supervised`` (``dense`` or ``sparse``) with their flow and a mask, all
    ones or KITTI-like (about a third valid, none in the top quarter)."""
    from unflow_tpu_torch.data.synthetic import batch_iterator

    stream = batch_iterator(batch, 320, 1152, seed=3, num_threads=4, supervised=bool(supervised))
    batches = [next(stream) for _ in range(count)]
    stream.close()
    if supervised == "sparse":
        rng = np.random.RandomState(12)
        for b in batches:
            b["mask"] = (rng.rand(*b["mask"].shape) < 0.35).astype(np.float32)
            b["mask"][:, :80] = 0.0
    return batches


def run_train_twin(tmp: Path, dtype: str, batch: int, tolerance: float,
                   corr_stride: int = 2, config: Path = CONFIG, seed: int = 5,
                   control: bool = False, supervised: str = "", remat: bool = False,
                   **overrides) -> dict[str, int]:
    """One train step through the kernels against the same step through the
    plain correlation and the composite loss: same parameters (from
    ``seed``), batch and step seed, cuDNN held to its deterministic
    algorithms (so that the two steps differ by the hand-written kernels
    alone). With ``remat`` the step with remat is held against the same step
    without it instead, both through the kernels. A ``tolerance`` of 0 asks
    for equality. The steps through the kernels must launch the three that
    the dispatch picks, once each (the forward twice under remat: its
    recompute), and the fused loss's six once for each stage's loss. A stack's gap is also printed per stage and
    for its largest leaves; with ``control`` the step held against runs
    twice, and the gap between those two (what is left of the card's
    run-to-run spread: the float atomics of the gathers' and the resizes'
    gradients) is printed beside it.
    ``supervised`` (``dense`` or ``sparse``) takes a supervised step on a
    batch with ground truth of that kind. Returns the launches of the step
    under test."""
    from unflow_tpu_torch.models import DTYPES, build_model, init_params
    from unflow_tpu_torch.ops.cuda import loss as fused
    from unflow_tpu_torch.ops.cuda.correlation import kernel_name
    from unflow_tpu_torch.train import Trainer
    from unflow_tpu_torch.utils.profiling import launch_counts

    batches = host_batches(batch, 1, supervised)
    if supervised:
        overrides["supervised"] = True
    # the arm under test, then the arm it is held against (twice with ``control``)
    arms = ({"remat": {"corr_impl": "cuda", "remat": True}, "cuda": {"corr_impl": "cuda"}}
            if remat else {"cuda": {"corr_impl": "cuda"}, "torch": {"corr_impl": "torch"}})
    test, ref = arms
    if control:
        arms[ref + "_again"] = arms[ref]
    results, launched, want = {}, {}, {}
    params = None
    for arm, arm_overrides in arms.items():
        cfg = train_config(tmp, config, compute_dtype=dtype, batch_size=batch,
                           corr_stride=corr_stride, **arm_overrides, **overrides)
        if params is None:
            model = build_model(cfg, "cpu")
            init_params(model, torch.Generator().manual_seed(seed))
            params = model.state_dict()
        trainer = Trainer(cfg, tmp / f"twin_{cfg.train.flownet}_{dtype}_s{corr_stride}_{arm}"
                          f"{supervised}{cfg.train.mask_occlusion}", [], device="cuda",
                          params=params)
        plain = arm_overrides["corr_impl"] == "torch"
        reset_all_launch_counts()
        with deterministic_cudnn(), composite_loss() if plain else contextlib.nullcontext():
            logs = {k: float(v) for k, v in trainer.train_step(batches[0]).items()}
            torch.cuda.synchronize()
        launched[arm] = {k: v for k, v in launch_counts().items() if v}
        # kept on the host between arms, so that the card holds one arm's
        # gradients at a time; the gaps are summed on the card
        grads = {n: p.grad.flatten().cpu() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        results[arm] = (logs["loss"], logs["grad_norm"], grads)
        # every twin's correlation sees FlowNetC's conv3 maps: 256 channels
        want[arm] = {} if plain else {
            kernel_name(op, DTYPES[dtype], 256, cfg.train.max_displacement, corr_stride):
                2 if op == "fwd" and arm_overrides.get("remat") else 1
            for op in ("fwd", "bwd_f1", "bwd_f2")}
        # the fused loss once for each stage that takes a loss: the last one,
        # or every one under train_all; none supervised or under disocc
        losses = (0 if plain or cfg.train.supervised or cfg.train.mask_occlusion != "fb"
                  else len(cfg.train.flownet) if cfg.train.train_all else 1)
        want[arm].update(dict.fromkeys(fused.KERNELS, losses) if losses else {})
        del trainer

    def gaps(a, b):
        (loss_a, norm_a, g_a), (loss_b, norm_b, g_b) = results[a], results[b]
        g_a, g_b = ({n: v.cuda() for n, v in g.items()} for g in (g_a, g_b))
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
            f"{f' init seed {seed}' if seed != 5 else ''}"
            f"{f' supervised ({supervised} ground truth)' if supervised else ''}"
            f"{' mask_occlusion=disocc' if cfg.train.mask_occlusion == 'disocc' else ''}")
    rel, per_stage, top = gaps(test, ref)
    (loss_a, norm_a, _), (loss_b, norm_b, _) = results[test], results[ref]
    label_a, label_b = ("remat", "no remat") if remat else ("kernels", "plain")
    print(("remat twin" if remat else "train step vs plain twin")
          + f" {what} batch {batch} corr_stride {corr_stride}: "
          f"loss {loss_a:.6g} vs {loss_b:.6g}, grad_norm {norm_a:.6g} vs {norm_b:.6g}, "
          "relative differences " + " ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (tol {tolerance}); launches {launched[test]} ({label_a}), {launched[ref]} "
          f"({label_b})", flush=True)
    pairs = [(f"{label_a} vs {label_b}", per_stage, top)]
    if control:
        c_rel, c_stage, c_top = gaps(ref + "_again", ref)
        print(f"  control, {label_b} vs {label_b} (same step again): relative differences "
              + " ".join(f"{k} {v:.3e}" for k, v in c_rel.items()), flush=True)
        pairs.append((f"{label_b} vs {label_b}", c_stage, c_top))
    if len(per_stage) > 1:
        for label, stage_gap, leaves in pairs:
            print(f"  {label}: gap per stage (share of the whole gradient's norm) "
                  + " ".join(f"{k} {v:.3e}" for k, v in stage_gap.items())
                  + "; largest leaves " + " ".join(f"{n} {v:.3e}" for n, v in leaves), flush=True)
    within = (lambda v: v == 0) if tolerance == 0 else (lambda v: v < tolerance)
    if not (np.isfinite(loss_a) and all(within(v) for v in rel.values())):
        raise AssertionError(f"train step {what} ({label_a}) disagrees with its {label_b} twin")
    if launched != want:
        raise AssertionError(f"train step {what} did not launch {want}: {launched}")
    return launched[test]


def run_f32_step(tmp: Path, warmup: int = 2) -> None:
    """One f32 train step at 320x1152, batch 8 (TF32 off), after ``warmup``
    steps: it must launch each of the three f32 kernels once."""
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts
    from unflow_tpu_torch.train import Trainer

    cfg = train_config(tmp, compute_dtype="float32", num_iters=warmup, display_interval=warmup)
    trainer = Trainer(cfg, tmp / "f32_batch8", itertools.cycle(host_batches(8, 1)), device="cuda")
    trainer.run(max_iters=warmup)
    torch.cuda.synchronize()
    reset_launch_counts()
    trainer.train_step(next(trainer.batches))
    torch.cuda.synchronize()
    mine = {k: v for k, v in launch_counts().items() if v}
    print(f"train step f32 320x1152 batch 8, after {warmup} warm-up steps: launches {mine}",
          flush=True)
    if mine != {"corr_fwd_f32": 1, "corr_bwd_f1_f32": 1, "corr_bwd_f2_f32": 1}:
        raise AssertionError(f"the f32 train step did not launch the three f32 kernels: {mine}")


# the stacks of the remat phase: config and overrides (csS is finetuned from
# the recipe's experiments)
REMAT_STACKS = {
    "C": (CONFIG, {}),
    "csS": (CSS_CONFIG, {}),
    "CSS train_all": (CSS_CONFIG, {"flownet": "CSS", "train_all": True, "finetune": ()}),
}


def remat_launches(stack: str, steps: int, remat: bool) -> dict[str, int]:
    """The bf16 launches of ``steps`` steps of ``stack``. A trainable C stage
    launches the forward once more a step under remat: its recompute in the
    backward pass. A frozen c stage needs no gradient, so nothing of it is
    recomputed: it launches the forward alone, with remat as without."""
    if stack.startswith("c"):
        return {"corr_fwd_bf16": steps}
    return {"corr_fwd_bf16": (2 if remat else 1) * steps, "corr_bwd_f1_bf16": steps,
            "corr_bwd_f2_bf16": steps}


def run_remat(tmp: Path) -> dict[str, dict[str, int]]:
    """Per-stage rematerialization at 320x1152, batch 8, bf16: ``cli.train
    --set remat=true`` for C, csS and CSS with ``train_all``
    (``RECIPE_STEPS`` steps each, their launches asserted). Returns their
    launch counts by path."""
    paths = {}
    for stack, (config, overrides) in REMAT_STACKS.items():
        ex = "remat_" + stack.replace(" ", "_")
        mine, records, wall, _ = run_cli_train(tmp, config, ex, RECIPE_STEPS,
                                               ["--set", "remat=true"], display_interval=1,
                                               **overrides)
        expected = remat_launches(stack, RECIPE_STEPS, True)
        what = f"{config.name}{' --set flownet=CSS train_all=true' if 'train_all' in overrides else ''}"
        print(f"remat cli.train {what} --set remat=true ({stack}) bf16 320x1152 batch 8: steps "
              f"{records[-1]['step']} launches {mine} (want {expected}) losses "
              f"{[round(r['loss'], 4) for r in records]} {wall:.2f} s", flush=True)
        if mine != expected:
            raise AssertionError(f"remat cli.train {stack}: launches {mine}, want {expected}")
        paths[f"cli.train {what} --set remat=true, {RECIPE_STEPS} steps"] = mine
        shutil.rmtree(tmp / "log" / "ex" / ex)
    return paths


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


def write_kitti_trees(data: Path) -> None:
    """Under ``data``: a KITTI raw tree, ``KITTI_RAW_DRIVES`` of ``RAW_FRAMES``
    frames at 375x1242 (a smooth texture moving 4 px right and 2 px down a
    frame), and a KITTI 2012 training tree of ``KITTI_PAIRS`` pairs from the
    synthetic renderer (max_shift 32), whose ``flow_occ`` is valid below the
    top quarter (KITTI has no ground truth in the sky) and whose ``flow_noc``
    keeps of those the pixels that stay inside the frame."""
    from unflow_tpu_torch.data.io import write_image, write_kitti_png_flow
    from unflow_tpu_torch.data.synthetic import make_pair

    h, w = FRAME_HW
    gen = torch.Generator().manual_seed(10)
    for drive in KITTI_RAW_DRIVES:
        frames = data / "kitti_raw" / drive / "image_02" / "data"
        frames.mkdir(parents=True)
        coarse = torch.rand(1, 3, (h + 2 * RAW_FRAMES) // 8 + 2, (w + 4 * RAW_FRAMES) // 8 + 2,
                            generator=gen)
        tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
        tex = tex[0].permute(1, 2, 0).numpy()
        for f in range(RAW_FRAMES):
            write_image(frames / f"{f:010d}.png", tex[2 * f : 2 * f + h, 4 * f : 4 * f + w])
    base = data / "kitti_2012" / "training"
    for sub in ("colored_0", "flow_occ", "flow_noc"):
        (base / sub).mkdir(parents=True)
    rng = np.random.RandomState(11)
    ys, xs = np.mgrid[0:h, 0:w]
    for i in range(KITTI_PAIRS):
        im1, im2, flow = make_pair(rng, h, w, max_shift=32.0)
        write_image(base / "colored_0" / f"{i:06d}_10.png", im1)
        write_image(base / "colored_0" / f"{i:06d}_11.png", im2)
        valid = np.ones((h, w, 1), np.float32)
        valid[: h // 4] = 0.0
        tx, ty = xs + flow[..., 0], ys + flow[..., 1]
        inside = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        write_kitti_png_flow(base / "flow_occ" / f"{i:06d}_10.png", flow, valid)
        write_kitti_png_flow(base / "flow_noc" / f"{i:06d}_10.png", flow,
                             valid * inside[..., None])


def run_real_train(tmp: Path) -> dict[str, int]:
    """``cli.pack`` of the KITTI raw tree at 320x1152, then ``cli.train`` on it
    (configs/kitti_unsup_c.ini, bf16, batch 8) through the packed Loader and
    through the decoding Loader, evaluating on KITTI 2012's pairs every
    ``REAL_EVAL_INTERVAL`` steps; returns the launch counts of the packed run."""
    from unflow_tpu_torch.cli.pack import main as pack_main
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    t = time.perf_counter()
    rc = pack_main(["--dataset", "kitti_raw", "--data-dir", str(tmp / "data"), "--out",
                    str(tmp / "packed"), "--height", "320", "--width", "1152"])
    print(f"real data cli.pack kitti_raw at 320x1152: rc {rc} {time.perf_counter() - t:.2f} s",
          flush=True)
    if rc != 0:
        raise AssertionError("cli.pack failed")
    counts = {}
    for ex, loader, extra in (("kitti_real", "packed", ["--set", f"packed_dir={tmp / 'packed'}"]),
                              ("kitti_real_decoded", "decoding", [])):
        cfg = train_config(tmp, dataset="kitti_raw", num_iters=TRAIN_STEPS, display_interval=4,
                           eval_interval=REAL_EVAL_INTERVAL)
        reset_launch_counts()
        t = time.perf_counter()
        rc = train_main(["--config", str(tmp / CONFIG.name), "--ex", ex, *extra])
        torch.cuda.synchronize()
        mine = {k: v for k, v in launch_counts().items() if v}
        records = [json.loads(line) for line in
                   (cfg.experiment_dir(ex) / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in records if "loss" in r]
        evals = [r["eval/aee"] for r in records if "eval/aee" in r]
        expected = {"corr_fwd_bf16": TRAIN_STEPS + len(evals), "corr_bwd_f1_bf16": TRAIN_STEPS,
                    "corr_bwd_f2_bf16": TRAIN_STEPS}
        last = steps[-1]
        print(f"real data cli.train kitti_raw ({loader} Loader) bf16 320x1152 batch 8: rc {rc} "
              f"steps {last['step']} launches {mine} (the forward once more per evaluation) "
              f"loss {last['loss']:.5g} eval/aee {[round(v, 4) for v in evals]} "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        if rc != 0 or mine != expected or last["step"] != TRAIN_STEPS:
            raise AssertionError(f"cli.train on kitti_raw ({loader}): launches {mine}")
        if len(evals) != TRAIN_STEPS // REAL_EVAL_INTERVAL or not np.isfinite(
                [r["loss"] for r in steps] + evals).all():
            raise AssertionError(f"cli.train on kitti_raw ({loader}): bad metrics.jsonl {records}")
        counts.setdefault("packed", mine)
    shutil.rmtree(cfg.experiment_dir("kitti_real_decoded"))
    return counts["packed"]


def run_real_eval(tmp: Path) -> dict[str, int]:
    """``cli.eval --ex kitti_real`` on the KITTI 2012 tree, then
    ``Evaluator.run`` on the same weights through the kernel against the plain
    correlation, in bf16 and in f32; returns the launch counts of each."""
    from unflow_tpu_torch.data import dataset_normalization, get_dataset

    _, line = run_cli_eval(tmp, "kitti_real", "kitti_2012", 4, KITTI_PAIRS)
    if not all(w in line for w in ("AEE=", "Fl=", "| noc: AEE=", "| occ-only: AEE=")):
        raise AssertionError(f"cli.eval printed no noc/occ breakdown: {line!r}")

    exp_dir = tmp / "log" / "ex" / "kitti_real"
    examples = get_dataset("kitti_2012", tmp / "data").eval_examples("occ")
    counts = hold_eval_twins("kitti_2012", exp_dir, examples, dataset_normalization("kitti_raw"),
                             4)
    for dtype, got in counts.items():
        if got["n_gt"] != KITTI_PAIRS or any(e["flow"].shape != (*FRAME_HW, 2)
                                             for e in got["entries"]):
            raise AssertionError(f"Evaluator.run {dtype}: {got['n_gt']} pairs with ground truth")
        if "aee_noc" not in got or "aee_occ" not in got:
            raise AssertionError(f"Evaluator.run {dtype}: no noc/occ breakdown")
    return {dtype: got["launches"] for dtype, got in counts.items()}


def hold_eval_twins(what: str, exp_dir: Path, examples, norm, batch: int) -> dict[str, dict]:
    """``Evaluator.run`` of the experiment ``exp_dir`` on ``examples`` at
    ``eval_batch=batch`` through the kernel against the plain correlation
    (which launches no kernel), in bf16 and in f32 (TF32 off, through
    ``corr_fwd_f32``): the predicted flows within 2e-2 relative L2 in bf16,
    1e-4 in f32, finite, of each pair's frame size, and one launch per forward
    of up to ``batch`` same-size pairs. Returns each dtype's result of the run
    through the kernel, with its launch counts under ``launches``."""
    from PIL import Image

    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.eval.evaluate import Evaluator
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    sizes: dict[tuple, int] = {}
    for ex in examples:
        with Image.open(ex.im1) as im:
            sizes[im.size] = sizes.get(im.size, 0) + 1
    forwards = sum(-(-n // batch) for n in sizes.values())
    n = len(examples)
    results = {}
    for dtype, kernel, tolerance in (("bfloat16", "corr_fwd_bf16", 2e-2),
                                     ("float32", "corr_fwd_f32", 1e-4)):
        cfg = load_config(exp_dir / "config.ini")
        cfg.train.compute_dtype = dtype
        ev = Evaluator(cfg, exp_dir, normalization=norm, device="cuda")
        ev.run(examples, eval_batch=batch)  # warm-up: cuDNN picks its algorithms
        reset_launch_counts()
        got = ev.run(examples, eval_batch=batch, collect=n)
        torch.cuda.synchronize()
        mine = {k: v for k, v in launch_counts().items() if v}
        ref_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, corr_impl="torch"))
        reset_launch_counts()
        want = Evaluator(ref_cfg, exp_dir, normalization=norm, device="cuda").run(
            examples, eval_batch=batch, collect=n)
        torch.cuda.synchronize()
        plain_launches = {k: v for k, v in launch_counts().items() if v}
        # the predicted flows themselves: the AEE of a barely trained net is
        # set by the ground truth and cannot tell the two paths apart
        flows, want_flows = (np.concatenate([e["flow"].ravel() for e in r["entries"]])
                             for r in (got, want))
        rel = relative_l2(flows, want_flows)
        aee_rel = abs(got["aee"] - want["aee"]) / want["aee"]
        breakdown = " ".join(f"{k} {got[k]:.5f}" for k in ("aee_noc", "aee_occ") if k in got)
        print(f"{what} Evaluator.run {dtype} batch {batch}: launches {mine} "
              f"(plain twin: {plain_launches}) flows relative_l2_vs_plain {rel:.3e} (tol "
              f"{tolerance}); AEE {got['aee']:.5f} vs plain {want['aee']:.5f} (relative "
              f"{aee_rel:.3e}); Fl {got['fl']:.5f} vs {want['fl']:.5f}; {breakdown}", flush=True)
        if mine != {kernel: forwards} or plain_launches or got["n"] != n:
            raise AssertionError(f"{what} Evaluator.run {dtype}: launches {mine}, plain twin's "
                                 f"{plain_launches}")
        if not all(e["flow"].shape == (*e["im1"].shape[:2], 2) and np.isfinite(e["flow"]).all()
                   for e in got["entries"]) or len(got["entries"]) != n:
            raise AssertionError(f"{what} Evaluator.run {dtype}: bad flows")
        if not rel < tolerance:
            raise AssertionError(f"{what} Evaluator.run {dtype} disagrees with the plain "
                                 f"correlation: flows relative L2 {rel}")
        results[dtype] = {**got, "launches": mine}
    return results


def run_heldout_short(tmp: Path, arm: str = "off", keep: bool = False) -> dict[str, int]:
    """The held-out acceptance run's arm ``arm`` (``off`` or ``on``, the
    affine augmentation), cut to 4 steps in 2 segments across the bootstrap
    boundary, at its geometry; returns its launch counts. ``keep``: leave its
    experiment (``tmp/heldout/affine_<arm>``) for the later phases."""
    from unflow_tpu_torch.heldout import HELDOUT_BATCHES
    from unflow_tpu_torch.heldout import main as heldout_main
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    steps = 4
    reset_launch_counts()
    t = time.perf_counter()
    rc = heldout_main(["--hw", "128", "256", "--batch", "8", "--corpus", "64", "--steps",
                       str(steps), "--segments", "2", "--bootstrap-until", "2", "--eval-every",
                       "2", "--arms", arm, "--exp-root", str(tmp / "heldout"),
                       "--out", str(tmp / "heldout.json")])
    torch.cuda.synchronize()
    mine = {k: v for k, v in launch_counts().items() if v}
    summary = json.loads((tmp / "heldout.json").read_text())
    curve = [c["aee"] for c in summary[f"affine_{arm}"]["curve"]]
    expected = {"corr_fwd_bf16": steps + len(curve) * HELDOUT_BATCHES,
                "corr_bwd_f1_bf16": steps, "corr_bwd_f2_bf16": steps}
    print(f"held-out short, arm {arm} (128x256, batch 8, 64-pair corpus, {steps} steps in 2 segments, "
          f"bootstrap to step 2): rc {rc} launches {mine} zero-flow AEE "
          f"{summary['zero_flow_aee']:.4f} curve {curve} {time.perf_counter() - t:.2f} s",
          flush=True)
    if rc != 0 or mine != expected or len(curve) != 2 or not np.isfinite(curve).all():
        raise AssertionError(f"held-out short: launches {mine}, curve {curve}")
    if f"{summary['zero_flow_aee']:.4f}" != "15.3428":
        raise AssertionError(f"held-out set: zero-flow AEE {summary['zero_flow_aee']}")
    if not keep:
        shutil.rmtree(tmp / "heldout")
    return mine


def _counted(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (its result, the kernels it launched)."""
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts().items() if v}


def run_longrun(tmp: Path) -> dict[str, int]:
    """``python -m unflow_tpu_torch.longrun`` at its geometry (128x256, batch
    4, bf16), cut to 10 steps in 3 segment processes, the learning rate
    halved at steps 4 and 6: its audit must pass (every loss and grad_norm
    finite, both halvings, the segments stitched with no gap or overlap),
    and each step must launch the three bf16 kernels once. Returns the
    launches that the segment processes counted."""
    from unflow_tpu_torch.longrun import main as longrun_main

    steps = 10
    t = time.perf_counter()
    out = tmp / "longrun.json"
    rc = longrun_main(["--steps", str(steps), "--segments", "3", "--display-interval", "1",
                       "--exp", str(tmp / "longrun"), "--out", str(out)])
    summary = json.loads(out.read_text()) if out.exists() else {}
    launches = summary.get("kernel_launches")
    print(f"longrun (128x256, batch 4, bf16, {steps} steps in 3 segment processes): rc {rc} "
          f"lr {summary.get('lr_crossings')} loss {summary.get('loss_first')} -> "
          f"{summary.get('loss_last')} grad_norm max {summary.get('grad_norm_max')} "
          f"launches {launches} {time.perf_counter() - t:.1f} s", flush=True)
    want = {"initial": 1e-4, "step_5": 5e-5, "step_7": 2.5e-5}
    kernels = ("corr_fwd_bf16", "corr_bwd_f1_bf16", "corr_bwd_f2_bf16")
    if rc != 0 or not summary.get("ok") or summary["lr_crossings"] != want \
            or summary["logged_points"] != steps or launches != dict.fromkeys(kernels, steps):
        raise AssertionError(f"longrun: rc {rc}, {summary}")
    shutil.rmtree(tmp / "longrun")
    return launches


def run_cascade(tmp: Path) -> dict[str, int]:
    """``python -m unflow_tpu_torch.cascade_heldout`` from the held-out short
    run's ``affine_on`` experiment: cS and csS 4 steps each (one segment
    process each), the held-out AEE of every stage finite, the csS
    checkpoint's frozen stages bit-equal to their sources, and in each
    stage (C frozen) one forward launch a step and a held-out batch, no
    gradient. Returns the launches that the segment processes counted."""
    from unflow_tpu_torch.cascade_heldout import main as cascade_main
    from unflow_tpu_torch.heldout import HELDOUT_BATCHES
    from unflow_tpu_torch.train.checkpoint import restore_params

    t = time.perf_counter()
    stage1, out = tmp / "heldout" / "affine_on", tmp / "cascade.json"
    rc = cascade_main(["--steps", "4", "--segments", "1", "--eval-every", "2", "--corpus", "64",
                       "--stage1", str(stage1), "--synth-cache",
                       str(tmp / "heldout" / "synth_cache"), "--exp-root", str(tmp / "cascade"),
                       "--out", str(out)])
    summary = json.loads(out.read_text())
    finals = {k: v["final_aee"] for k, v in summary["stages"].items()}
    css = restore_params(tmp / "cascade" / "csS")
    sources = {"stage0_C.": restore_params(stage1),
               "stage1_S.": restore_params(tmp / "cascade" / "cS")}
    equal = all(torch.equal(v, src[k]) for k, v in css.items() for prefix, src in sources.items()
                if k.startswith(prefix))
    stages = [summary["stages"][spec] for spec in ("cS", "csS")]
    launches = {"corr_fwd_bf16": sum(st["kernel_launches"].get("corr_fwd_bf16", 0)
                                     for st in stages)}
    expected = [{"corr_fwd_bf16": 4 + len(st["curve"]) * HELDOUT_BATCHES} for st in stages]
    print(f"cascade held-out (128x256, batch 8, bf16, stage 1 {summary['stage1_arm']} cut to 4 "
          f"steps, cS and csS 4 steps each): rc {rc} final AEE {finals} frozen stages equal "
          f"{equal} launches {[st['kernel_launches'] for st in stages]} "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if rc != 0 or not equal or not np.isfinite(list(finals.values())).all() \
            or [st["kernel_launches"] for st in stages] != expected:
        raise AssertionError(f"cascade held-out: rc {rc}, {finals}, frozen equal {equal}, "
                             f"launches {[st['kernel_launches'] for st in stages]}")
    shutil.rmtree(tmp / "cascade")
    return launches


def run_probes(tmp: Path) -> dict[str, dict[str, int]]:
    """The diagnostic probes of ``unflow_tpu_torch/probes/``: the loss
    landscape at the JAX record's geometry (128x256, batch 8, seed 777000)
    beside ``benchmarks/loss_landscape.json`` (a TPU's: its census rounds
    the grayscale to bf16, so its values sit 3-10% above; the
    ``monotone_to_gt`` verdicts must agree); the supervised f32 one-batch
    overfit for 200 steps (the AEE must fall); the autopsy of the held-out
    short run's checkpoint; the input-dependence probe and the warm start
    for 24 steps a phase. Returns the launch counts of the probes that
    train."""
    from unflow_tpu_torch.probes import autopsy, convergence, input_dependence, landscape
    from unflow_tpu_torch.probes import warmstart

    paths = {}
    t = time.perf_counter()
    out = landscape.probe((128, 256), 8, device="cuda")
    record = json.loads((ROOT / "benchmarks" / "loss_landscape.json").read_text())
    for mode, row in out["modes"].items():
        tpu = record["modes"][mode]
        print(f"landscape {mode}: loss at alpha {list(row['loss_at_alpha'].values())} (TPU record "
              f"{list(tpu['loss_at_alpha'].values())}), monotone_to_gt {row['monotone_to_gt']} "
              f"(record {tpu['monotone_to_gt']})", flush=True)
        if row["monotone_to_gt"] != tpu["monotone_to_gt"]:
            raise AssertionError(f"landscape {mode}: verdict differs from the record")
    print(f"  landscape {time.perf_counter() - t:.2f} s", flush=True)

    t = time.perf_counter()
    conv, launches = _counted(lambda: convergence.overfit(False, 200, 1e-4, device="cuda"))
    print(f"convergence (supervised, f32, 128x256, batch 4, 200 steps at lr 1e-4): AEE zero-flow "
          f"{conv['zero_flow_aee']:.3f} init {conv['init_aee']:.3f} -> "
          f"{[round(r['aee'], 3) for r in conv['curve']]} launches {launches} "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if not conv["final_aee"] < conv["init_aee"]:
        raise AssertionError(f"convergence: AEE did not fall: {conv}")
    paths["probes.convergence supervised f32, 200 steps"] = launches

    t = time.perf_counter()
    (dead, launches) = _counted(lambda: autopsy.autopsy(tmp / "heldout" / "affine_off",
                                                        device="cuda"))
    print(f"autopsy of the held-out short run (step {dead['step']}): spread of the predicted "
          f"means {dead['spread_of_pred_means']:.3f} px ({dead['verdict']}), AEE "
          f"{[round(p['aee'], 2) for p in dead['pairs']]} launches {launches} "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if len(dead["pairs"]) != 8 or not np.isfinite([p["aee"] for p in dead["pairs"]]).all():
        raise AssertionError(f"autopsy: {dead}")
    paths["probes.autopsy, 8 pairs"] = launches

    t = time.perf_counter()
    dep, launches = _counted(lambda: input_dependence.probe(24, 12, device="cuda"))
    print(f"input dependence (f32, 128x256, batch 8, 2 batches, lr 1e-3, 24 steps): "
          f"{[{k: round(v, 3) for k, v in r.items()} for r in dep['reports']]} "
          f"launches {launches} {time.perf_counter() - t:.1f} s", flush=True)
    if not np.isfinite(dep["losses"]).all():
        raise AssertionError(f"input dependence: {dep['losses']}")
    paths["probes.input_dependence f32, 24 steps"] = launches

    t = time.perf_counter()
    args = warmstart.parse_args(["--sup-steps", "24", "--unsup-steps", "24", "--eval-every",
                                 "12", "--exp-root", str(tmp / "warmstart")])
    warm, launches = _counted(lambda: warmstart.probe(args, torch.device("cuda")))
    curves = {k: [c["aee"] for c in warm[k]["curve"]]
              for k in ("supervised", "unsupervised_continuation")}
    print(f"warm start (bf16, 128x256, batch 4, 24 steps a phase): held-out AEE {curves}, "
          f"zero-flow {warm['zero_flow_aee']} launches {launches} "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if any(len(c) != 2 or not np.isfinite(c).all() for c in curves.values()):
        raise AssertionError(f"warm start: {curves}")
    paths["probes.warmstart bf16, 24 + 24 steps"] = launches
    shutil.rmtree(tmp / "warmstart")
    return paths


def write_chairs_tree(data: Path) -> None:
    """Under ``data``: a FlyingChairs tree of ``CHAIRS_PAIRS`` pairs at 384x512
    (``*_img1.ppm``, ``*_img2.ppm``, ``*_flow.flo``) from the synthetic
    renderer, max_shift 32."""
    from unflow_tpu_torch.data.io import write_flo, write_image
    from unflow_tpu_torch.data.synthetic import make_pair

    root = data / "chairs" / "data"
    root.mkdir(parents=True)
    rng = np.random.RandomState(13)
    for i in range(1, CHAIRS_PAIRS + 1):
        im1, im2, flow = make_pair(rng, 384, 512, max_shift=32.0)
        write_image(root / f"{i:05d}_img1.ppm", im1)
        write_image(root / f"{i:05d}_img2.ppm", im2)
        write_flo(root / f"{i:05d}_flow.flo", flow)


def write_synthia_tree(data: Path) -> None:
    """Under ``data``: one SYNTHIA sequence of ``SYNTHIA_FRAMES`` frames at
    760x1280 (a smooth texture moving 4 px right and 2 px down a frame)."""
    from unflow_tpu_torch.data.io import write_image

    h, w = 760, 1280
    frames = data / "synthia" / "SEQ_01" / "RGB" / "Stereo_Left" / "Omni_F"
    frames.mkdir(parents=True)
    gen = torch.Generator().manual_seed(14)
    coarse = torch.rand(1, 3, (h + 2 * SYNTHIA_FRAMES) // 8 + 2,
                        (w + 4 * SYNTHIA_FRAMES) // 8 + 2, generator=gen)
    tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
    tex = tex[0].permute(1, 2, 0).numpy()
    for f in range(SYNTHIA_FRAMES):
        write_image(frames / f"{f:06d}.png", tex[2 * f : 2 * f + h, 4 * f : 4 * f + w])


def run_cli_train(tmp: Path, config: Path, ex: str, steps: int, extra=(), **overrides):
    """``cli.train --config <config> --ex <ex>`` in-process with ``overrides``
    on ``tmp``'s data: (launch counts, step records, wall seconds, the
    launches a FlowNetC run must make: the three tensor-core kernels once a
    step, the forward twice more for each image summary)."""
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    cfg = train_config(tmp, config, num_iters=steps, **overrides)
    t = cfg.train
    interval = t.display_interval if t.image_summary_interval == 0 else t.image_summary_interval
    summaries = steps // interval if interval > 0 else 0
    reset_launch_counts()
    t = time.perf_counter()
    rc = train_main(["--config", str(tmp / config.name), "--ex", ex, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    mine = {k: v for k, v in launch_counts().items() if v}
    records = [json.loads(line) for line in
               (cfg.experiment_dir(ex) / "metrics.jsonl").read_text().splitlines()]
    steps_logged = [r for r in records if "loss" in r]
    if rc != 0 or steps_logged[-1]["step"] != steps or not np.isfinite(
            [r["loss"] for r in steps_logged]).all():
        raise AssertionError(f"cli.train {config.name} --ex {ex}: rc {rc}, records {records}")
    expected = {k: steps for k in TENSOR_CORE_KERNELS}
    expected["corr_fwd_bf16"] += 2 * summaries
    return mine, steps_logged, wall, expected


def run_supervised(tmp: Path) -> dict[str, dict[str, int]]:
    """configs/chairs_supervised.ini as shipped (FlowNetS, 384x512, batch 8,
    bf16) through ``cli.train`` on a FlyingChairs tree, through the packed
    and the decoding Loader; the same packed run as FlowNetC; the loss on one
    repeated batch. Returns the launch counts of the runs by path."""
    from unflow_tpu_torch.cli.pack import main as pack_main
    from unflow_tpu_torch.data.packed import PackedExamples
    from unflow_tpu_torch.train import Trainer

    write_chairs_tree(tmp / "data")
    t = time.perf_counter()
    rc = pack_main(["--dataset", "chairs", "--data-dir", str(tmp / "data"), "--out",
                    str(tmp / "packed_chairs"), "--height", "384", "--width", "512",
                    "--supervised"])
    print(f"supervised cli.pack chairs --supervised at 384x512: rc {rc} "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if rc != 0:
        raise AssertionError("cli.pack chairs failed")
    packed = ["--set", f"packed_dir={tmp / 'packed_chairs'}"]
    paths = {}
    runs = (("chairs_s", "packed", packed, "S"), ("chairs_s_decoded", "decoding", [], "S"),
            ("chairs_c", "packed", packed + ["--set", "flownet=C"], "C"))
    for ex, loader, extra, flownet in runs:
        steps = SUPERVISED_STEPS if flownet == "S" else 2
        # as shipped: an image summary every display_interval
        mine, records, wall, expected = run_cli_train(
            tmp, CHAIRS_CONFIG, ex, steps, extra, dataset="chairs",
            display_interval=min(3, steps), image_summary_interval=0)
        last = records[-1]
        if flownet == "S":
            expected = {}
        what = " --set flownet=C" if flownet == "C" else ""
        print(f"supervised cli.train configs/chairs_supervised.ini{what} "
              f"({loader} Loader) bf16 384x512 batch 8: steps {last['step']} launches {mine} "
              f"loss {[round(r['loss'], 4) for r in records]} epe scale0 "
              f"{last['epe_charbonnier/scale0']:.5g} {wall:.2f} s", flush=True)
        if mine != expected or "epe_charbonnier/scale4" not in last:
            raise AssertionError(f"supervised cli.train {ex}: launches {mine}")
        if loader == "packed":
            path = f"cli.train chairs_supervised.ini flownet={flownet}, packed, {steps} steps"
            paths[path] = mine
    # one repeated batch of the packed tree: the loss must fall
    cfg = train_config(tmp, CHAIRS_CONFIG, dataset="chairs", num_iters=12)
    batch = PackedExamples(tmp / "packed_chairs").gather(np.arange(8), supervised=True)
    trainer = Trainer(cfg, tmp / "chairs_repeat", itertools.repeat(batch), device="cuda")
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(12)]
    print(f"supervised FlowNetS bf16 384x512 batch 8, one batch 12 times: loss "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"supervised loss does not fall on a repeated batch: {losses}")
    for ex in ("chairs_s", "chairs_s_decoded", "chairs_c"):
        shutil.rmtree(cfg.experiment_dir(ex))
    return paths


def run_disocc_spread(tmp: Path) -> None:
    """The ``disocc`` mask's run-to-run spread on the card: the forward
    splat's density (float atomics) computed twice on the same flows, the
    share of mask pixels that differ, on ground-truth flow at 320x1152 and on
    the finest flows of an init FlowNetC step (bf16, batch 8). A measurement
    only."""
    from unflow_tpu_torch.augment import normalize
    from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
    from unflow_tpu_torch.losses.terms import DISOCC_THRESH
    from unflow_tpu_torch.models import FLOW_SCALE, build_model, init_params
    from unflow_tpu_torch.ops.warp import forward_warp

    batch = host_batches(8, 1, "dense")[0]
    gt = torch.from_numpy(batch["flow"]).cuda().permute(0, 3, 1, 2).contiguous()
    cfg = train_config(tmp, corr_impl="cuda")
    model = build_model(cfg, "cuda")
    init_params(model, torch.Generator().manual_seed(5))
    n1, n2 = (normalize(torch.from_numpy(batch[k]).cuda(), *DEFAULT_NORMALIZATION)
              .permute(0, 3, 1, 2) for k in ("im1", "im2"))
    with torch.inference_mode():
        net = model(n1, n2)[-1][0] * FLOW_SCALE
    for what, flow in (("ground-truth flow 320x1152", gt), ("init FlowNetC flow2 80x288", net)):
        a, b = forward_warp(flow), forward_warp(flow)
        torch.cuda.synchronize()
        diff = (a != b).float().mean().item()
        mask_diff = ((a < DISOCC_THRESH) != (b < DISOCC_THRESH)).float().mean().item()
        disoccluded = (a < DISOCC_THRESH).float().mean().item()
        print(f"disocc spread, {what} batch 8: density max |a-b| {(a - b).abs().max().item():.3e}, "
              f"share of density pixels that differ {diff:.3e}, share of disocc mask pixels that "
              f"differ {mask_diff:.3e} (disoccluded share {disoccluded:.4f})",
              flush=True)


def run_affine(tmp: Path) -> dict[str, dict[str, int]]:
    """configs/synthia_pretrain_c_affine.ini as shipped (FlowNetC, 512x768,
    batch 8, bf16, the affine augmentation) through ``cli.train`` on a SYNTHIA
    tree; returns its launch counts by path."""
    write_synthia_tree(tmp / "data")
    steps = 6
    # as shipped: an image summary every display_interval
    mine, records, wall, expected = run_cli_train(tmp, AFFINE_CONFIG, "synthia_affine", steps,
                                                  dataset="synthia", display_interval=3,
                                                  image_summary_interval=0)
    last = records[-1]
    print(f"affine cli.train configs/synthia_pretrain_c_affine.ini (decoding Loader) bf16 512x768 "
          f"batch 8: steps {last['step']} launches {mine} loss "
          f"{[round(r['loss'], 4) for r in records]} {wall:.2f} s", flush=True)
    if mine != expected:
        raise AssertionError(f"affine cli.train: launches {mine}, not {expected}")
    shutil.rmtree(tmp / "log" / "ex" / "synthia_affine")
    return {f"cli.train synthia_pretrain_c_affine.ini, {steps} steps": mine}


def write_sintel_tree(data: Path) -> None:
    """Under ``data``: MPI-Sintel's ``training`` layout, ``SINTEL_SCENES`` of
    ``SINTEL_FRAMES`` frames each at the release's 436x1024 in both passes
    (``clean``: a smooth texture moving a few pixels a frame; ``final``: the
    same frames with noise), the ``.flo`` ground truth of each pair and its
    occlusion mask (white where a pixel leaves the frame)."""
    from unflow_tpu_torch.data.io import write_flo, write_image

    h, w = SINTEL_HW
    root = data / "sintel" / "training"
    gen = torch.Generator().manual_seed(15)
    rng = np.random.RandomState(16)
    for s, scene in enumerate(SINTEL_SCENES):
        dx, dy = 3 + 2 * s, 1 + s  # pixels a frame
        for sub in ("clean", "final", "flow", "occlusions"):
            (root / sub / scene).mkdir(parents=True)
        coarse = torch.rand(1, 3, (h + dy * SINTEL_FRAMES) // 8 + 2,
                            (w + dx * SINTEL_FRAMES) // 8 + 2, generator=gen)
        tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
        tex = tex[0].permute(1, 2, 0).numpy()
        # frame f shows the texture at (y + dy f, x + dx f): its content moves
        # by (-dx, -dy) to the next frame
        flow = np.broadcast_to(np.array([-dx, -dy], np.float32), (h, w, 2))
        ys, xs = np.mgrid[0:h, 0:w]
        occluded = ((xs - dx < 0) | (ys - dy < 0)).astype(np.float32)
        for f in range(SINTEL_FRAMES):
            clean = tex[dy * f : dy * f + h, dx * f : dx * f + w]
            final = np.clip(clean + rng.normal(0.0, 0.03, clean.shape), 0.0, 1.0)
            name = f"frame_{f + 1:04d}"
            write_image(root / "clean" / scene / f"{name}.png", clean)
            write_image(root / "final" / scene / f"{name}.png", final)
            if f + 1 < SINTEL_FRAMES:
                write_flo(root / "flow" / scene / f"{name}.flo", flow)
                write_image(root / "occlusions" / scene / f"{name}.png",
                            np.repeat(occluded[..., None], 3, -1))


def write_middlebury_tree(data: Path) -> None:
    """Under ``data``: Middlebury's ``other-data`` / ``other-gt-flow``, one
    pair of the synthetic renderer (max_shift 8) per scene of
    ``MIDDLEBURY_SCENES``, at that scene's published size."""
    from unflow_tpu_torch.data.io import write_flo, write_image
    from unflow_tpu_torch.data.synthetic import make_pair

    root = data / "middlebury"
    rng = np.random.RandomState(17)
    for scene, (h, w) in MIDDLEBURY_SCENES.items():
        (root / "other-data" / scene).mkdir(parents=True)
        (root / "other-gt-flow" / scene).mkdir(parents=True)
        im1, im2, flow = make_pair(rng, h, w, max_shift=8.0)
        write_image(root / "other-data" / scene / "frame10.png", im1)
        write_image(root / "other-data" / scene / "frame11.png", im2)
        write_flo(root / "other-gt-flow" / scene / "flow10.flo", flow)


def run_cli_eval(tmp: Path, ex: str, dataset: str, batch: int, pairs: int,
                 variant: str | None = None) -> tuple[dict[str, int], str]:
    """``cli.eval --ex <ex> --dataset <dataset>`` from ``tmp`` (which holds
    ``log/``): its printed line must be finite over ``pairs`` pairs and it
    must launch ``corr_fwd_bf16`` once per forward of up to ``batch``
    same-size pairs (each dataset here has one frame size, or runs at batch
    1). Returns its launch counts and its line."""
    import io

    from unflow_tpu_torch.cli.eval import main as eval_main
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts

    argv = ["--ex", ex, "--dataset", dataset, "--batch", str(batch)]
    argv += ["--variant", variant] if variant else []
    cwd = os.getcwd()
    os.chdir(tmp)  # the experiment lives under ./log
    try:
        reset_launch_counts()
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = eval_main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    mine = {k: v for k, v in launch_counts().items() if v}
    line = out.getvalue().strip().splitlines()[-1]
    print(f"cli.eval {' '.join(argv)}: rc {rc} launches {mine} {time.perf_counter() - t:.2f} s: "
          f"{line}", flush=True)
    numbers = [float(x) for x in re.findall(r"=([-\d.naninf]+)", line)]
    forwards = -(-pairs // batch)
    if rc != 0 or mine != {"corr_fwd_bf16": forwards} or not np.isfinite(numbers).all():
        raise AssertionError(f"cli.eval {dataset}: launches {mine}, line {line!r}")
    if f"(n={pairs})" not in line:
        raise AssertionError(f"cli.eval {dataset} did not evaluate {pairs} pairs: {line!r}")
    return mine, line


def run_sintel_middlebury(tmp: Path) -> dict[str, dict[str, int]]:
    """The shipped paths of Sintel, SYNTHIA and Middlebury: configs/
    synthia_pretrain_c.ini as shipped on the affine phase's SYNTHIA tree
    (2 steps); a Sintel tree and configs/sintel_finetune_css.ini (csS at
    384x768, batch 8, bf16, finetuned from the recipe's ``kitti_c`` and
    ``kitti_cs``) through ``cli.train``; ``cli.eval --dataset sintel`` on
    that experiment, clean and final; a Middlebury tree and ``cli.eval
    --dataset middlebury --batch 1`` on ``kitti_c`` (its scenes differ in
    size: one pair a forward). Each evaluation's flows are then held against
    the plain-correlation twin in bf16 and f32. Returns the launch counts by
    path."""
    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.data import dataset_normalization, get_dataset

    paths = {}
    steps = 2
    mine, records, wall, expected = run_cli_train(tmp, SYNTHIA_C_CONFIG, "synthia_c", steps,
                                                  dataset="synthia", display_interval=1)
    print(f"cli.train configs/synthia_pretrain_c.ini (decoding Loader) bf16 512x768 batch 8: "
          f"steps {records[-1]['step']} launches {mine} loss "
          f"{[round(r['loss'], 4) for r in records]} photo/scale0 "
          f"{records[-1]['photo/scale0']:.5g} {wall:.2f} s", flush=True)
    if mine != expected:
        raise AssertionError(f"cli.train synthia_pretrain_c.ini: launches {mine}, not {expected}")
    paths[f"cli.train synthia_pretrain_c.ini, {steps} steps"] = mine
    shutil.rmtree(tmp / "log" / "ex" / "synthia_c")

    write_sintel_tree(tmp / "data")
    write_middlebury_tree(tmp / "data")
    steps = SINTEL_STEPS
    mine, records, wall, _ = run_cli_train(tmp, SINTEL_CONFIG, "sintel_css", steps,
                                           dataset="sintel", display_interval=2)
    print(f"cli.train configs/sintel_finetune_css.ini (csS from kitti_c, kitti_cs; decoding "
          f"Loader) bf16 384x768 batch 8: steps {records[-1]['step']} launches {mine} loss "
          f"{[round(r['loss'], 4) for r in records]} {wall:.2f} s", flush=True)
    if mine != remat_launches("csS", steps, False):
        raise AssertionError(f"cli.train sintel_finetune_css.ini: launches {mine}")
    paths[f"cli.train sintel_finetune_css.ini, {steps} steps"] = mine

    pairs = len(SINTEL_SCENES) * (SINTEL_FRAMES - 1)
    evals = [("sintel_css", "sintel", variant, SINTEL_EVAL_BATCH, pairs)
             for variant in ("clean", "final")]
    evals.append(("kitti_c", "middlebury", None, 1, len(MIDDLEBURY_SCENES)))
    for ex, dataset, variant, batch, n in evals:
        what = f"cli.eval {dataset}{'/' + variant if variant else ''} --ex {ex} --batch {batch}"
        paths[what] = run_cli_eval(tmp, ex, dataset, batch, n, variant)[0]
        exp_dir = tmp / "log" / "ex" / ex
        ds = get_dataset(dataset, tmp / "data", **({"render_pass": variant} if variant else {}))
        # as cli.eval normalizes: the training dataset's constants, else the eval set's
        norm = (dataset_normalization(load_config(exp_dir / "config.ini").train.dataset)
                or ds.normalization)
        examples = ds.eval_examples()
        for dtype, got in hold_eval_twins(f"{dataset}{'/' + variant if variant else ''}",
                                          exp_dir, examples, norm, batch).items():
            paths[f"Evaluator.run {dtype} {dataset}{'/' + variant if variant else ''} --ex {ex}, "
                  f"{n} pairs, batch {batch}"] = got["launches"]
    shutil.rmtree(tmp / "log" / "ex" / "sintel_css")
    return paths


def run_summaries(tmp: Path) -> dict[str, dict[str, int]]:
    """``cli.train`` (configs/kitti_unsup_c.ini, synthetic, 320x1152, batch 8,
    bf16) with ``tensorboard`` and an image summary every 2 steps, read back
    with ``read_events``."""
    from unflow_tpu_torch.utils.tensorboard import read_events

    steps = 4
    mine, records, wall, expected = run_cli_train(tmp, CONFIG, "summaries", steps,
                                                  display_interval=2, tensorboard=True,
                                                  image_summary_interval=2)
    ex_dir = tmp / "log" / "ex" / "summaries"
    (path,) = list((ex_dir / "tb").glob("events.out.tfevents.*"))
    events = read_events(path)
    scalar_steps = sorted({e["step"] for e in events if e["scalars"]})
    images = {(e["step"], tag) for e in events for tag in e["images"]}
    strips = sorted(p.name for p in (ex_dir / "summaries").iterdir())
    print(f"summaries cli.train tensorboard=true image_summary_interval=2, {steps} steps: "
          f"launches {mine}, {len(events)} events, scalars at steps {scalar_steps}, "
          f"{len(images)} images, strips {strips}, {wall:.2f} s", flush=True)
    if (scalar_steps != [2, 4] or len(images) != 14 or strips != ["step_00000002", "step_00000004"]
            or mine != expected):
        raise AssertionError(f"summaries: events {scalar_steps}, images {sorted(images)}")
    shutil.rmtree(ex_dir)
    return {f"cli.train tensorboard + image summaries, {steps} steps": mine}


DDP_STEPS = 4


def ddp_worker(spec_path: str) -> int:
    """One process of a ``torchrun`` job that ``run_distributed`` starts:
    joins the group over the spec's backend, then runs each job of the spec
    through ``unflow_tpu_torch.cli.train.main`` (the launch counts set to 0
    just before, read just after) and writes what it saw to
    ``<out>.<rank>``."""
    sys.path.insert(0, str(ROOT))
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts, reset_launch_counts
    from unflow_tpu_torch.parallel import init_distributed, process_shard
    from unflow_tpu_torch.train import Trainer

    spec = json.loads(Path(spec_path).read_text())
    init_distributed(spec["device"], backend=spec["backend"])
    rank = process_shard()[0]
    torch.backends.cudnn.allow_tf32 = False  # float32 means float32 in this check
    torch.backends.cuda.matmul.allow_tf32 = False
    run = Trainer.run
    results = []
    for job in spec["jobs"]:
        torch.backends.cudnn.deterministic = job["deterministic"]
        # a job cut at ``stop_after`` steps stands for a run that was killed there
        Trainer.run = (lambda self, max_iters=None, _n=job.get("stop_after"): run(self, _n)
                       ) if job.get("stop_after") else run
        reset_launch_counts()
        t = time.perf_counter()
        rc = train_main(job["argv"])
        torch.cuda.synchronize()
        results.append({"name": job["name"], "rc": rc, "seconds": time.perf_counter() - t,
                        "launches": {k: v for k, v in launch_counts().items() if v}})
    Path(f"{spec['out']}.{rank}").write_text(json.dumps(results))
    torch.distributed.destroy_process_group()
    return 0


def run_torchrun(tmp: Path, nproc: int, jobs: list[dict], device: str,
                 backend: str | None, tag: str = "") -> list[list[dict]]:
    """``torchrun --nproc-per-node nproc chip_smoke.py --ddp-worker``: each
    rank's results of ``jobs``."""
    out = tmp / f"torchrun_{tag}{nproc}"
    spec = tmp / f"torchrun_{tag}{nproc}.json"
    spec.write_text(json.dumps({"device": device, "backend": backend, "jobs": jobs,
                                "out": str(out)}))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "localhost", "--master-port", str(port),
           str(ROOT / "chip_smoke.py"), "--ddp-worker", str(spec)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, capture_output=True, text=True, timeout=900)
    print(f"torchrun --nproc-per-node {nproc} ({backend or 'nccl'}, --device {device}) {tag}: "
          f"rc {proc.returncode} {time.perf_counter() - t:.2f} s", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(Path(f"{out}.{rank}").read_text()) for rank in range(nproc)]


def _records(tmp: Path, ex: str) -> list[dict]:
    return [json.loads(line) for line in
            (tmp / "log" / "ex" / ex / "metrics.jsonl").read_text().splitlines()]


def _checkpoint(tmp: Path, ex: str, step: int) -> dict:
    return torch.load(tmp / "log" / "ex" / ex / "checkpoints" / f"{step}.pt",
                      map_location="cpu", weights_only=True)


def _param_gap(mine: dict, ref: dict) -> float:
    """Relative L2 of ``mine - ref`` over all tensors of ``ref``."""
    num = sum(torch.sum((mine[k].double() - v.double()) ** 2).item() for k, v in ref.items())
    return (num / sum(torch.sum(v.double() ** 2).item() for v in ref.values())) ** 0.5


def hold_run(tmp: Path, label: str, mine: str, ref: str, steps: int, tol: float,
             start: dict | None = None) -> None:
    """The run of experiment ``mine`` against the run of ``ref`` from the same
    config: one ``metrics.jsonl`` record a step; the losses, the parameters'
    relative L2 (and, given the init ``start``, their updates') and for one
    step Adam's first moment (0.1 x the gradient) within ``tol``."""
    a, b = _records(tmp, ref), _records(tmp, mine)
    if not [r["step"] for r in a] == [r["step"] for r in b] == list(range(1, steps + 1)):
        raise AssertionError(f"{label}: metrics.jsonl has not one record per step: {b}")
    gaps = [abs(x["loss"] - y["loss"]) / abs(x["loss"]) for x, y in zip(a, b)]
    ck1, ck2 = (_checkpoint(tmp, ex, steps) for ex in (ref, mine))
    params = _param_gap(ck2["model"], ck1["model"])
    line = (f"{label}: losses of steps 1-{steps} {[round(r['loss'], 5) for r in b]} vs "
            f"{[round(r['loss'], 5) for r in a]} (relative gaps {[f'{g:.2e}' for g in gaps]}); "
            f"parameters' relative L2 gap {params:.3e}")
    if start is not None:
        updates = _param_gap(*({k: ck["model"][k] - v for k, v in start.items()}
                               for ck in (ck2, ck1)))
        line += f", their updates' {updates:.3e}"
    grad = 0.0
    if steps == 1:  # Adam's first moment after one step: 0.1 x the averaged gradient
        moments = [[s["exp_avg"] for s in ck["optimizer"]["state"].values()]
                   for ck in (ck2, ck1)]
        grad = _param_gap(dict(enumerate(moments[0])), dict(enumerate(moments[1])))
        line += (f"; gradient relative L2 gap {grad:.3e}, grad_norm {b[0]['grad_norm']:.6g}"
                 f" vs {a[0]['grad_norm']:.6g}")
    print(f"{line} (tolerance {tol} on each)", flush=True)
    if max(gaps) > tol or grad > tol or params > tol:
        raise AssertionError(f"{label}: {mine} does not follow {ref}")


def run_distributed(tmp: Path) -> dict[str, dict[str, int]]:
    """The data-parallel path: ``cli.train`` under ``torchrun`` on the packed
    KITTI raw tree (configs/kitti_unsup_c.ini, 320x1152, global batch 8).
    One rank over NCCL: bf16 for ``DDP_STEPS`` steps, then one step each in
    bf16 and in f32 (TF32 off, cuDNN deterministic). Two ranks, one per card
    over NCCL with two cards or more, else both on one card over gloo: the
    same three runs, held against the one-rank runs from the same snapshot
    (the same config, so the same init and batches); then csS (cuDNN
    deterministic) four steps uninterrupted and as two segments cut at step
    2, which must agree bit for bit. Returns the launch counts of each run,
    summed over its ranks (the one-rank runs' experiments stay, as
    ``run_spatial``'s references)."""
    from unflow_tpu_torch.models import DTYPES
    from unflow_tpu_torch.ops.cuda.correlation import kernel_name

    cards = torch.cuda.device_count()
    nccl2 = cards >= 2
    print(f"distributed: 2 ranks {'on 2 cards over NCCL' if nccl2 else 'on one card over gloo'} "
          f"({cards} card(s) visible)", flush=True)
    base = train_config(tmp, dataset="kitti_raw", packed_dir=str(tmp / "packed"),
                        display_interval=1, eval_interval=0)
    ini = tmp / "ddp_c.ini"
    shutil.copy(tmp / CONFIG.name, ini)
    train_config(tmp, CSS_CONFIG, dataset="kitti_raw", packed_dir=str(tmp / "packed"),
                 display_interval=1, eval_interval=0, save_interval=2)
    css_ini = tmp / "ddp_css.ini"
    shutil.copy(tmp / CSS_CONFIG.name, css_ini)
    runs = {"bf16": ("bfloat16", DDP_STEPS, False), "bf16_step": ("bfloat16", 1, False),
            "f32_step": ("float32", 1, True)}

    def job(name, ranks, dtype="bfloat16", steps=4, deterministic=True, config=css_ini,
            sets=(), **extra):
        argv = ["--config", str(config), "--ex", f"ddp_{name}_{ranks}", "--set",
                f"compute_dtype={dtype}", "--set", f"num_iters={steps}", "--device",
                "cuda" if ranks == 1 or nccl2 else "cuda:0"]
        argv += [x for kv in sets for x in ("--set", kv)]
        if config == ini:  # one checkpoint, at the end
            argv += ["--set", f"save_interval={steps}"]
        return {"name": name, "argv": argv, "deterministic": deterministic, **extra}

    one = run_torchrun(tmp, 1, [job(n, 1, *r, config=ini) for n, r in runs.items()], "cuda", None)
    two = run_torchrun(tmp, 2, [job(n, 2, *r, config=ini) for n, r in runs.items()] + [
        job("css", 2), job("css_split", 2, stop_after=2), job("css_split", 2),
        # one bf16 step with per-stage rematerialization, against one rank without
        job("bf16_step_remat", 2, "bfloat16", 1, False, config=ini, sets=["remat=true"]),
    ], "cuda" if nccl2 else "cuda:0", None if nccl2 else "gloo")

    paths = {}
    for ranks, results in ((1, one), (2, two)):
        for i, res in enumerate(results[0]):
            per_rank = [r[i]["launches"] for r in results]
            total = {k: sum(c.get(k, 0) for c in per_rank) for k in per_rank[0]}
            print(f"distributed {ranks} rank(s) {res['name']}: rc {[r[i]['rc'] for r in results]} "
                  f"launches per rank {per_rank} {res['seconds']:.2f} s", flush=True)
            if any(r[i]["rc"] != 0 for r in results):
                raise AssertionError(f"{res['name']} failed")
            if res["name"] in runs:
                dtype, steps, _ = runs[res["name"]]
                expected = {kernel_name(op, DTYPES[dtype], 256, base.train.max_displacement, 2):
                            steps for op in ("fwd", "bwd_f1", "bwd_f2")}
                if any(c != expected for c in per_rank):
                    raise AssertionError(f"{res['name']}: launches {per_rank}, want {expected}")
                paths[f"torchrun {ranks} rank(s), cli.train kitti_raw packed {dtype}, "
                      f"{steps} step(s)"] = total
            elif res["name"] == "bf16_step_remat":
                expected = remat_launches("C", 1, True)
                if any(c != expected for c in per_rank):
                    raise AssertionError(f"{res['name']}: launches {per_rank}, want {expected}")
                paths[f"torchrun {ranks} ranks, cli.train kitti_raw packed bfloat16 "
                      f"--set remat=true, 1 step"] = total

    start = config_init(ini)
    for name, tol in (("bf16", 2e-2), ("bf16_step", 2e-2), ("f32_step", 1e-4)):
        hold_run(tmp, f"distributed {name}: 2 ranks against 1, global batch 8",
                 f"ddp_{name}_2", f"ddp_{name}_1", runs[name][1], tol, start)
    hold_run(tmp, "distributed bf16_step_remat: 2 ranks with remat against 1 rank without, "
             "global batch 8", "ddp_bf16_step_remat_2", "ddp_bf16_step_1", 1, 2e-2, start)
    # the 2-rank run's checkpoint serves the 1-process Evaluator
    launches = run_eval("bfloat16", "corr_fwd_bf16", 2e-2, exp_dir=tmp / "log" / "ex" / "ddp_bf16_2")
    paths["Evaluator(exp_dir=2-rank checkpoint) bf16, batch 4"] = {"corr_fwd_bf16": launches}
    whole, split = _records(tmp, "ddp_css_2"), _records(tmp, "ddp_css_split_2")
    p1, p2 = (_checkpoint(tmp, ex, 4)["model"] for ex in ("ddp_css_2", "ddp_css_split_2"))
    diff = max((p1[k].float() - p2[k].float()).abs().max().item() for k in p1)
    losses = ({r["step"]: r["loss"] for r in whole}, {r["step"]: r["loss"] for r in split})
    print(f"distributed resume csS bf16, 2 ranks: losses {losses[0]} uninterrupted, {losses[1]} "
          f"in two segments cut at step 2; largest parameter difference {diff:.3e} (both must be "
          f"identical)", flush=True)
    if losses[0] != losses[1] or sorted(losses[0]) != [1, 2, 3, 4] or diff != 0:
        raise AssertionError("the resumed 2-rank csS run is not identical to the uninterrupted one")
    # the one-rank runs are run_spatial's references too
    for ex in [f"ddp_{n}_2" for n in runs] + ["ddp_css_2", "ddp_css_split_2",
                                              "ddp_bf16_step_remat_2"]:
        shutil.rmtree(tmp / "log" / "ex" / ex)
    return paths


def run_spatial(tmp: Path) -> dict[str, dict[str, int]]:
    """W-sharding (``spatial_shards=2``) through ``cli.train`` under
    ``torchrun`` on the packed KITTI raw tree, configs/kitti_unsup_c.ini at
    320x1152, global batch 8; each rank holds a W-slab of 576 columns. Two
    spatial ranks (one per card over NCCL with two cards or more, else both
    on one card over gloo): bf16 for ``DDP_STEPS`` steps, then one bf16 and
    one f32 step (TF32 off, cuDNN deterministic), held against
    ``run_distributed``'s one-rank runs of the same config; one csS
    step (the glue's warps, the frozen stages) and one ``disocc`` step (the
    splat) in bf16, held against the same steps in this process. Then the
    2x2 grid (4 ranks: 2 data x 2 spatial; on one card over gloo with fewer
    than 4 cards), one f32 step against the one-rank one, and the 1x4 grid
    (``spatial_shards=4``: the 18 columns of the deepest level split 5, 5, 4,
    4, so uneven slabs of 320, 320, 256 and 256 columns), one f32 step
    against the one-rank one. Limits: bf16 2e-2, f32 1e-4, on the losses,
    the one-step gradient and the parameters; each rank's launches a step
    asserted. Returns the launch counts of each run, summed over its ranks."""
    from unflow_tpu_torch.cli.train import main as train_main
    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.models import DTYPES
    from unflow_tpu_torch.ops.cuda.correlation import kernel_name

    cards = torch.cuda.device_count()
    ini, css_ini = tmp / "ddp_c.ini", tmp / "ddp_css.ini"  # run_distributed's configs
    p = load_config(ini).train.max_displacement
    # in this process: the one-rank references of csS and disocc
    singles = {"css": (css_ini, {}), "disocc": (ini, {"mask_occlusion": "disocc"})}
    for name, (config, extra) in singles.items():
        argv = ["--config", str(config), "--ex", f"sp_{name}_1", "--set", "compute_dtype=bfloat16",
                "--set", "num_iters=1", "--set", "save_interval=1"]
        rc = train_main(argv + [x for k, v in extra.items() for x in ("--set", f"{k}={v}")])
        if rc != 0:
            raise AssertionError(f"one-rank {name} failed")

    # the one-rank reference of each run: its experiment by name
    one_ex = {"bf16": "ddp_bf16_1", "bf16_step": "ddp_bf16_step_1",
              "f32_step": "ddp_f32_step_1", "css": "sp_css_1", "disocc": "sp_disocc_1"}
    # name -> (dtype, steps, deterministic, config, extra keys, ranks, reference);
    # spatial_shards is 2 unless the extra keys say otherwise
    runs = {"bf16": ("bfloat16", DDP_STEPS, False, ini, {}, 2, "bf16"),
            "bf16_step": ("bfloat16", 1, False, ini, {}, 2, "bf16_step"),
            "f32_step": ("float32", 1, True, ini, {}, 2, "f32_step"),
            "css": ("bfloat16", 1, False, css_ini, {}, 2, "css"),
            "disocc": ("bfloat16", 1, False, ini, {"mask_occlusion": "disocc"}, 2, "disocc"),
            "f32_grid": ("float32", 1, True, ini, {}, 4, "f32_step"),
            "f32_uneven": ("float32", 1, True, ini, {"spatial_shards": 4}, 4, "f32_step"),
            # per-stage rematerialization: the recompute re-issues the halo
            # exchanges inside the backward pass
            "bf16_step_remat": ("bfloat16", 1, False, ini, {"remat": "true"}, 2, "bf16_step")}

    def job(name):
        dtype, steps, deterministic, config, extra, ranks, _ = runs[name]
        argv = ["--config", str(config), "--ex", f"sp_{name}_{ranks}", "--set",
                f"compute_dtype={dtype}", "--set", f"num_iters={steps}", "--set",
                f"save_interval={steps}", "--set", "spatial_shards=2",
                "--device", "cuda" if cards >= ranks else "cuda:0"]
        argv += [x for k, v in extra.items() for x in ("--set", f"{k}={v}")]
        return {"name": name, "argv": argv, "deterministic": deterministic}

    results = {}
    for ranks in (2, 4):
        nccl = cards >= ranks
        print(f"spatial: {ranks} ranks ({ranks // 2} data x 2 spatial"
              f"{'; and 1 data x 4 spatial' if ranks == 4 else ''}) "
              f"{f'on {ranks} cards over NCCL' if nccl else 'on one card over gloo'} "
              f"({cards} card(s) visible)", flush=True)
        out = run_torchrun(tmp, ranks, [job(n) for n, r in runs.items() if r[5] == ranks],
                           "cuda" if nccl else "cuda:0", None if nccl else "gloo", tag="spatial")
        for i, res in enumerate(out[0]):
            results[res["name"]] = [r[i] for r in out]

    paths = {}
    start = config_init(ini)
    for name, per_rank in results.items():
        dtype, steps, _, config, extra, ranks, ref = runs[name]
        counts = [r["launches"] for r in per_rank]
        kernels = ["fwd"] if name == "css" else ["fwd", "bwd_f1", "bwd_f2"]
        # under remat the forward runs again in the backward pass
        expected = {kernel_name(op, DTYPES[dtype], 256, p, 2):
                    steps * (2 if op == "fwd" and "remat" in extra else 1) for op in kernels}
        total = {k: sum(c.get(k, 0) for c in counts) for k in expected}
        shards = extra.get("spatial_shards", 2)
        print(f"spatial {name} ({ranks} ranks, {ranks // shards} data x {shards} spatial): rc "
              f"{[r['rc'] for r in per_rank]} launches per "
              f"rank {counts} (summed {total}) {per_rank[0]['seconds']:.2f} s", flush=True)
        if any(r["rc"] != 0 for r in per_rank) or any(c != expected for c in counts):
            raise AssertionError(f"spatial {name}: launches {counts}, want {expected} a rank")
        paths[f"torchrun {ranks} ranks spatial_shards={shards}, cli.train kitti_raw packed "
              f"{dtype}{' ' + config.stem if config != ini else ''}"
              f"{''.join(f' {k}={v}' for k, v in extra.items() if k != 'spatial_shards')}, "
              f"{steps} step(s)"] = total
        hold_run(tmp, f"spatial {name}: {ranks // shards} data x {shards} spatial against 1 rank",
                 f"sp_{name}_{ranks}", one_ex[ref], steps, 2e-2 if dtype == "bfloat16" else 1e-4,
                 None if name == "css" else start)
    for ex in [f"sp_{name}_{run[5]}" for name, run in runs.items()] + list(one_ex.values()):
        shutil.rmtree(tmp / "log" / "ex" / ex)
    return paths


def config_init(ini: Path) -> dict:
    """The parameters a fresh run of ``ini`` starts from (its seed's init)."""
    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.models import build_model, init_params

    cfg = load_config(ini)
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.state_dict()


def run_flops() -> None:
    """The conv/matmul FLOPs of the UnFlow-C bf16 step at 320x1152, batch 8
    (``utils/flops.py``'s per-site breakdown, counted and keyed as the JAX
    package counts them): its sites must sum to the JAX package's count."""
    from unflow_tpu_torch.utils.flops import breakdown

    sites = breakdown()
    flops = sum(sites.values())
    if flops != UNFLOW_C_FLOPS:
        raise AssertionError(f"flops: {flops:,} FLOPs a step, the JAX package counts "
                             f"{UNFLOW_C_FLOPS:,}")
    top = [(k, f"{v / flops:.3f}") for k, v in sorted(sites.items(), key=lambda kv: -kv[1])[:3]]
    print(f"flops: UnFlow-C bf16 320x1152 batch 8 train step {flops:,} FLOPs in {len(sites)} "
          f"sites, the largest {top}", flush=True)


def run_profile_hooks(tmp: Path) -> None:
    """``utils.profiling.trace`` around two bf16 train steps writes a trace
    that reads back and names the three tensor-core correlation kernels and
    the replay's span."""
    from unflow_tpu_torch.train import Trainer
    from unflow_tpu_torch.utils import profiling

    cfg = train_config(tmp)
    trainer = Trainer(cfg, tmp / "profile_hooks", itertools.cycle(host_batches(8, 2)),
                      device="cuda")
    for _ in range(3):  # warm-up
        trainer.train_step(next(trainer.batches))
    with profiling.trace(tmp / "profile_hooks" / "trace") as prof:
        for _ in range(2):
            trainer.train_step(next(trainer.batches))
    path = tmp / "profile_hooks" / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    names = ("corr_fwd_mma_kernel", "corr_bwd_f1_mma_kernel", "corr_bwd_f2_mma_kernel")
    mine = sorted(k for k in kernels if any(n in k for n in names))
    print(f"profile hooks: trace.json {path.stat().st_size / 2**20:.1f} MiB, {len(events)} events, "
          f"{len(kernels)} kernel names, correlation kernels {[k[:60] for k in mine]}; "
          f"{len(prof.key_averages())} ops and kernels by name", flush=True)
    if "unflow.train.replay" not in {e.get("name") for e in events}:
        raise AssertionError("the trace names no unflow.train.replay span")
    if not all(any(n in k for k in mine) for n in names):
        raise AssertionError(f"the trace names no tensor-core correlation kernel: {mine}")
    shutil.rmtree(tmp / "profile_hooks")


def run_native(tmp: Path) -> None:
    """``UNFLOW_NATIVE=1``: the C++ decode sidecar builds into ``_build/``;
    its frames and KITTI 16-bit flows of the KITTI trees equal the PIL /
    numpy path's bit for bit, and a Loader epoch with it equals one without."""
    from unflow_tpu_torch.data import get_dataset, native
    from unflow_tpu_torch.data.base import Loader
    from unflow_tpu_torch.data.io import read_image, read_kitti_png_flow

    t = time.perf_counter()
    lib = native.build()
    print(f"native decode: built {lib.relative_to(ROOT)} in {time.perf_counter() - t:.2f} s",
          flush=True)
    data = tmp / "data"
    frames = sorted((data / "kitti_raw").rglob("*.png")) + sorted(
        (data / "kitti_2012").rglob("colored_0/*.png"))
    flows = sorted((data / "kitti_2012").rglob("flow_*/*.png"))
    examples = get_dataset("kitti_2012", data).train_examples()

    def read_all():
        out = [read_image(p) for p in frames] + [x for p in flows for x in read_kitti_png_flow(p)]
        loader = Loader(examples, batch_size=4, load_hw=(320, 1152), supervised=True, seed=0,
                        loop=False, num_threads=4, image_dtype="float32")
        return out, list(loader)

    decoded = {}
    for mode in ("0", "1"):
        os.environ["UNFLOW_NATIVE"] = mode
        decoded[mode] = read_all()
    os.environ.pop("UNFLOW_NATIVE")
    (plain, plain_batches), (mine, batches) = decoded["0"], decoded["1"]
    same = (all(np.array_equal(a, b) for a, b in zip(mine, plain))
            and len(batches) == len(plain_batches)
            and all(np.array_equal(a[k], b[k]) for a, b in zip(batches, plain_batches) for k in a))
    print(f"native decode: {len(frames)} frames and {len(flows)} KITTI flows at 375x1242, a Loader "
          f"epoch of {len(batches)} batches: {'bit-identical' if same else 'DIFFERENT'} to PIL / "
          f"numpy", flush=True)
    if not same or not frames or not flows:
        raise AssertionError("the native sidecar does not decode what PIL / numpy decodes")


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

    def lap(what: str) -> None:
        print(f"phase {what}: done at {time.perf_counter() - t0:.1f} s", flush=True)

    sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    logs = build.build(sources)
    print(f"build {sources}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in build.ptxas_summary(log):
            print(f"  {name}: {line}")

    report = check_kernels()
    check_function()
    report.update(check_loss())
    lap("build and kernels")

    torch.backends.cudnn.allow_tf32 = False  # float32 means float32 in this check
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        report["corr_fwd_bf16"]["launches"] = run_cli(Path(tmp))
    run_eval("bfloat16", "corr_fwd_bf16", 2e-2)
    report["corr_fwd_f32"]["launches"] = run_eval("float32", "corr_fwd_f32", 1e-4)
    lap("serving")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the forward kernels keep the counts of the serving path; the
        # gradients' main path is the train step
        for dtype, steps, batch in (("bfloat16", TRAIN_STEPS, 8), ("float32", 1, 2)):
            for name, count in run_train_cli(tmp, dtype, steps, batch).items():
                if "bwd" in name:
                    report[name]["launches"] = count
                    report[name]["main_path"] = f"cli.train, {steps} step(s)"
                elif dtype == "bfloat16" and name.startswith("loss_"):
                    # the loss's entry points: each of their kernels once a step
                    entry = report["unflow_loss_backward" if name.startswith("loss_grad")
                                   else "unflow_loss_forward"]
                    entry["launches"] = count
                    entry["main_path"] = f"cli.train, {steps} step(s)"
        # corr_stride=4 is a grid the tensor-core kernels do not take: the same
        # entry point then goes through their FP32-core twins
        for name, count in run_train_cli(tmp, "bfloat16", 2, 8, corr_stride=4).items():
            if name.endswith("_simt"):
                report[name]["launches"] = count
                report[name]["main_path"] = "cli.train --set corr_stride=4, 2 step(s)"
        run_train_twin(tmp, "bfloat16", 8, 2e-2)
        run_train_twin(tmp, "float32", 2, 1e-4, control=True)
        run_train_twin(tmp, "bfloat16", 8, 2e-2, corr_stride=4)
        run_f32_step(tmp)
        lap("training")

        run_recipe(tmp)
        run_resume(tmp)
        run_serving_cascade(tmp)
        run_train_twin(tmp, "bfloat16", 8, 2e-2, config=CSS_CONFIG, flownet="CSS",
                       train_all=True, finetune=())
        for seed in (5, 6, 7):
            run_train_twin(tmp, "float32", 2, 1e-4, config=CSS_CONFIG, seed=seed, control=True,
                           flownet="CSS", train_all=True, finetune=())
        lap("the cascades")
        paths = run_remat(tmp)
        # remat recomputes the same ops on the same inputs: bf16 C equal, f32
        # CSS within the gathers' atomics (the control reads about 1e-7)
        run_train_twin(tmp, "bfloat16", 8, 0, remat=True)
        run_train_twin(tmp, "float32", 2, 1e-6, config=CSS_CONFIG, remat=True, flownet="CSS",
                       train_all=True, finetune=())
        lap("remat")

        write_kitti_trees(tmp / "data")
        paths["cli.train kitti_raw, packed, 12 steps, eval every 6"] = run_real_train(tmp)
        for dtype, counts in run_real_eval(tmp).items():
            paths[f"Evaluator.run {dtype} kitti_2012, 8 pairs, batch 4"] = counts
        paths["heldout, 4 steps, 2 evals of 8 batches"] = run_heldout_short(tmp, keep=True)
        paths.update(run_probes(tmp))
        shutil.rmtree(tmp / "heldout")
        lap("real data, held-out, probes")

        paths.update(run_supervised(tmp))
        run_train_twin(tmp, "bfloat16", 8, 2e-2, supervised="dense")
        run_train_twin(tmp, "bfloat16", 8, 2e-2, supervised="sparse")
        run_train_twin(tmp, "float32", 2, 1e-4, supervised="sparse", control=True)
        run_train_twin(tmp, "bfloat16", 8, 2e-2, mask_occlusion="disocc")
        run_disocc_spread(tmp)
        lap("supervised, disocc")
        paths.update(run_affine(tmp))
        paths["heldout --arms on, 4 steps, 2 evals of 8 batches"] = run_heldout_short(
            tmp, "on", keep=True)
        # both run their segments in processes of their own, mostly start-up:
        # the long run's go beside the cascade's
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            longrun = pool.submit(run_longrun, tmp)
            paths["cascade_heldout, cS and csS 4 steps each, 2 evals of 8 batches each "
                  "(segment processes)"] = run_cascade(tmp)
            paths["longrun, 10 steps in 3 segment processes"] = longrun.result()
        shutil.rmtree(tmp / "heldout")
        lap("affine, affine_on, cascade held-out, long run")
        paths.update(run_sintel_middlebury(tmp))
        lap("synthia_c, sintel, middlebury")
        paths.update(run_summaries(tmp))
        paths.update(run_distributed(tmp))
        lap("summaries, distributed")
        paths.update(run_spatial(tmp))
        lap("spatial")
        run_flops()
        run_profile_hooks(tmp)
        run_native(tmp)
    # the paths of the later phases, beside each kernel's main path
    for path, counts in paths.items():
        for name, count in counts.items():
            report[name].setdefault("other_paths", {})[path] = count
    report["corr_fwd_bf16"].setdefault("main_path", "cli.infer, one pair")
    report["corr_fwd_f32"].setdefault("main_path", "Evaluator.predict_batch f32, batch 4")

    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [report[name] for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ddp-worker":
        sys.exit(ddp_worker(sys.argv[2]))
    sys.exit(main())
