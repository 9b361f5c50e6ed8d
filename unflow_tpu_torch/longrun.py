"""Long-run stability: a 50,000-step unsupervised run across two learning
rate halvings, in segments that resume.

Port of ``scripts/longrun_stability.py``. FlowNetC trains unsupervised on
the synthetic stream (128x256, batch 4, bf16) in ``--segments`` segments,
each a new process that resumes the experiment from the last checkpoint on
the step-indexed stream (every boundary is a kill and a resume). Then it
audits ``metrics.jsonl``:

* every logged loss and ``grad_norm`` is finite;
* the learning rate has halved at ``decay_after`` and again at
  ``decay_after + decay_interval`` (``2/5`` and ``3/5`` of the steps);
* the logged steps follow each other ``display_interval`` apart across
  every resume: no gap and no overlap.

  python -m unflow_tpu_torch.longrun [--steps 50000] [--segments 4] \\
      [--out log/longrun.json]

It runs on the GPU unless ``--device cpu``; ``--hw``, ``--batch``,
``--display-interval`` and ``--dtype`` shrink it (the script's geometry is
the default). The summary (with the kernel launches of every segment's
process, summed) also goes to ``<exp>/stability_summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W, BATCH = 128, 256, 4
DISPLAY = 250


def make_config(steps: int, hw=(H, W), batch: int = BATCH, display: int = DISPLAY,
                dtype: str = "bfloat16"):
    """The run's config: the script's, at ``hw`` and ``batch``."""
    from unflow_tpu_torch.config import Config

    cfg = Config()
    t = cfg.train
    t.flownet = "C"
    t.height, t.width = hw
    t.batch_size = batch
    t.num_iters = steps
    t.learning_rate = 1e-4
    t.decay_after = steps * 2 // 5  # 20k of 50k
    t.decay_interval = steps // 5  # the next halving at 30k
    t.display_interval = display
    t.save_interval = 10_000
    t.eval_interval = 10_000
    t.image_summary_interval = -1
    t.compute_dtype = dtype
    return cfg


def segment_bounds(steps: int, segments: int) -> list[int]:
    return [steps * i // segments for i in range(segments + 1)]


def _config_of(args):
    return make_config(args.steps, tuple(args.hw), args.batch, args.display_interval, args.dtype)


def run_segment(args, start: int, until: int) -> int:
    """Child mode: resume at ``start``, train to ``until`` (checkpointed at
    the end), exit."""
    from unflow_tpu_torch.data.synthetic import batch_iterator
    from unflow_tpu_torch.train import Trainer

    cfg = _config_of(args)
    h, w = args.hw
    # the continuation is the uninterrupted stream: the same seed, fast
    # forwarded to the resume step, as cli.train does on a rerun
    stream = batch_iterator(args.batch, h, w, seed=0, start_batch=start)
    trainer = Trainer(cfg, Path(args.exp), stream, device=args.device)
    if trainer.step != start:
        raise RuntimeError(f"segment resume landed at step {trainer.step}, wanted {start}")
    trainer.run(max_iters=until)
    if trainer.step != until:
        raise RuntimeError(f"segment [{start}, {until}) ended at step {trainer.step}")
    record_launches(Path(args.exp))
    print(f"segment [{start}, {until}) done", flush=True)
    return 0


def record_launches(exp: Path) -> None:
    """Append the kernel launches of this segment's process to
    ``<exp>/launches.jsonl`` (none where the correlation ran its plain
    version, on the CPU)."""
    from unflow_tpu_torch.ops.cuda.correlation import launch_counts

    with open(exp / "launches.jsonl", "a") as f:
        f.write(json.dumps({k: v for k, v in launch_counts().items() if v}) + "\n")


def summed_launches(exp: Path) -> dict[str, int]:
    """The kernel launches of every segment of ``exp``, summed."""
    total: dict[str, int] = {}
    for line in (exp / "launches.jsonl").read_text().splitlines():
        for name, count in json.loads(line).items():
            total[name] = total.get(name, 0) + count
    return total


def audit(rows: list[dict], cfg, bounds: list[int]) -> dict:
    """The checks of the script on the records of ``metrics.jsonl``; raises
    ``RuntimeError`` naming the first that fails. Returns the summary's
    numbers."""
    t = cfg.train
    logged = [r["step"] for r in rows if "loss" in r]
    by_step = {r["step"]: r for r in rows if "loss" in r}
    steps = sorted(by_step)
    if not steps:
        raise RuntimeError("no loss rows logged")
    if len(logged) != len(steps):
        twice = sorted({s for s in logged if logged.count(s) > 1})
        raise RuntimeError(f"steps logged twice: {twice[:5]}")
    bad = [s for s in steps if not np.isfinite(by_step[s]["loss"])
           or not np.isfinite(by_step[s].get("grad_norm", 0.0))]
    if bad:
        raise RuntimeError(f"non-finite loss or grad_norm at steps {bad[:5]}")

    def lr_at(step):
        return by_step[min(by_step, key=lambda s: abs(s - step))]["lr"]

    lr0 = by_step[steps[0]]["lr"]
    first = t.decay_after + t.display_interval
    second = t.decay_after + t.decay_interval + t.display_interval
    for step, want in ((first, lr0 / 2), (second, lr0 / 4)):
        if abs(lr_at(step) - want) >= lr0 * 1e-6:
            raise RuntimeError(f"lr {lr_at(step)} at step {step}, wanted {want}")
    gaps = sorted(set(np.diff(steps).tolist()))
    if gaps != [t.display_interval] or steps[0] != t.display_interval \
            or steps[-1] != bounds[-1]:
        raise RuntimeError(f"logged steps {steps[0]}..{steps[-1]} with gaps {gaps[:5]}, "
                           f"wanted {t.display_interval}..{bounds[-1]} every "
                           f"{t.display_interval}")
    losses = [by_step[s]["loss"] for s in steps]
    grad_norms = [by_step[s].get("grad_norm", 0.0) for s in steps]
    # the steady step time leaves out each segment's first window (process
    # start-up and the first steps' warm-up)
    firsts = {b + t.display_interval for b in bounds[:-1]}
    step_ms = [by_step[s]["step_ms"] for s in steps if "step_ms" in by_step[s]
               and s not in firsts]
    return {
        "pairs_per_sec_steady": (round(1e3 * t.batch_size / float(np.median(step_ms)), 1)
                                 if step_ms else None),
        "step_ms_p50": round(float(np.percentile(step_ms, 50)), 2) if step_ms else None,
        "step_ms_p95": round(float(np.percentile(step_ms, 95)), 2) if step_ms else None,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "loss_min": min(losses),
        "loss_max": max(losses),
        "grad_norm_min": min(grad_norms),
        "grad_norm_max": max(grad_norms),
        "logged_points": len(steps),
        "all_finite": True,
        "lr_crossings": {"initial": lr0, f"step_{first}": lr_at(first),
                         f"step_{second}": lr_at(second)},
    }


def child_env() -> dict:
    """The environment of a segment's process: this one's, with the
    directory that holds the package first on ``PYTHONPATH``."""
    root = str(Path(__file__).resolve().parent.parent)
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": root + (os.pathsep + path if path else "")}


def _forwarded(args) -> list[str]:
    return ["--steps", str(args.steps), "--exp", str(args.exp), "--device", str(args.device),
            "--hw", str(args.hw[0]), str(args.hw[1]), "--batch", str(args.batch),
            "--display-interval", str(args.display_interval), "--dtype", args.dtype]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--segments", type=int, default=4,
                    help="segments, each a new process resuming from the checkpoint")
    ap.add_argument("--exp", default="log/ex/longrun_stability")
    ap.add_argument("--hw", type=int, nargs=2, default=(H, W))
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--display-interval", type=int, default=DISPLAY)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/longrun.json", help="JSON summary path")
    ap.add_argument("--run-segment", nargs=2, type=int, metavar=("START", "UNTIL"),
                    help=argparse.SUPPRESS)  # the child's mode
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.run_segment:
        return run_segment(args, *args.run_segment)
    from unflow_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no GPU: fail before the first segment
    exp = Path(args.exp)
    # a fresh run: a leftover experiment would resume and mix two runs' rows
    if exp.exists():
        shutil.rmtree(exp)
    exp.mkdir(parents=True)
    bounds = segment_bounds(args.steps, args.segments)
    t0 = time.perf_counter()
    for start, until in zip(bounds, bounds[1:]):
        cmd = [sys.executable, "-m", "unflow_tpu_torch.longrun", "--run-segment", str(start),
               str(until), *_forwarded(args)]
        rc = subprocess.run(cmd, env=child_env()).returncode
        if rc != 0:
            print(f"segment [{start}, {until}) failed rc={rc}", file=sys.stderr)
            return rc
        print(f"[{time.perf_counter() - t0:.0f} s] completed segment [{start}, {until})",
              flush=True)
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    h, w = args.hw
    summary = {
        "steps": args.steps,
        "geometry": (f"{h}x{w} batch {args.batch} "
                     f"{'bf16' if args.dtype == 'bfloat16' else 'f32'}, FlowNetC unsupervised"),
        "resume_boundaries": bounds[1:-1],
        "wall_s": round(wall, 1),
        "pairs_per_sec_incl_restarts": round(args.steps * args.batch / wall, 1),
        **audit(rows, _config_of(args), bounds),
        "kernel_launches": summed_launches(exp),
        "ok": True,
    }
    (exp / "stability_summary.json").write_text(json.dumps(summary))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
