"""Do the stacked cascade's stages improve flow on pairs never trained on?

Port of ``scripts/cascade_heldout.py``, on the held-out recipe of
:mod:`unflow_tpu_torch.heldout` (the same 4096-pair corpus, the same 64
held-out pairs, 128x256, batch 8, bf16, a flat learning rate of 1e-4):

* stage 1 (C) is not trained again: a finished held-out experiment
  (``--stage1``) is restored and its held-out AEE measured;
* stage 2 (cS): ``flownet=cS``, stage 0 frozen and restored from stage 1,
  the second stage trained on the unmodified UnFlow objective (no
  bootstrap: the stage starts from a working flow);
* stage 3 (csS): ``flownet=csS``, stages 0 and 1 frozen and restored from
  stages 1 and 2, the third trained the same way.

The criterion is an improvement stage over stage, csS < cS < C, in held-out
AEE. Each stage runs in ``--segments`` segments, each a new process that
resumes from the checkpoint on the step-indexed stream.

The JAX script restores the ``affine_off`` arm. On the H100 that arm stays at
zero flow (ROADMAP C2), so the default ``--stage1`` is the held-out run's
``affine_on`` arm, which leaves it, and the summary names the arm it
restored (``stage1_arm``).

  python -m unflow_tpu_torch.heldout --arms on            # stage 1
  python -m unflow_tpu_torch.cascade_heldout [--steps 4000] [--segments 2] \\
      [--stage1 log/ex/heldout/affine_on] [--out log/cascade_heldout.json]

It runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from unflow_tpu_torch import heldout
from unflow_tpu_torch.longrun import child_env, record_launches, summed_launches

STAGE_SPECS = {"cS": 1, "csS": 2}  # spec -> index of its trainable stage


def stage_cfg(args, spec: str):
    """The held-out recipe's config (no bootstrap, no affine ranges) at the
    run's learning rate, decay and clip, with the cascade ``spec``, as the
    script's ``_stage_cfg`` builds it."""
    ns = argparse.Namespace(hw=args.hw, batch=args.batch, steps=args.steps,
                            eval_every=args.eval_every, segments=args.segments,
                            dtype=args.dtype, set=[])
    cfg = heldout.build_cfg(ns, affine=False, bootstrap=False)
    t = cfg.train
    t.learning_rate = args.lr
    t.decay_after = args.decay_after or args.steps  # default: flat
    t.decay_interval = max((args.steps - t.decay_after) // 2, 1)
    t.grad_clip_norm = args.grad_clip
    t.flownet = spec
    return cfg


def finetune_dirs(args, spec: str, exp_root: Path) -> list[Path]:
    """The experiments whose checkpoints initialize ``spec``'s frozen
    stages, in stage order."""
    dirs = [Path(args.stage1)]
    if spec == "csS":
        dirs.append(exp_root / "cS")
    return dirs


def _held(args):
    from unflow_tpu_torch.data.synthetic import batch_iterator

    h, w = args.hw
    stream = batch_iterator(args.batch, h, w, seed=heldout.HELDOUT_SEED, supervised=True,
                            mode="affine", max_shift=args.max_shift)
    return [next(stream) for _ in range(heldout.HELDOUT_BATCHES)]


def run_segment(args, exp_root: Path) -> int:
    """Child mode: train ``spec`` from ``start`` to ``until``, exit."""
    from unflow_tpu_torch.data.synthetic import corpus_iterator
    from unflow_tpu_torch.train import Trainer

    spec, start, until = args.run_segment
    start, until = int(start), int(until)
    h, w = args.hw
    cfg = stage_cfg(args, spec)
    stream = corpus_iterator(args.batch, h, w, n_pairs=args.corpus, seed=0, mode="affine",
                             start_batch=start, max_shift=args.max_shift,
                             cache_dir=args.synth_cache, dtype="uint8")
    trainer = Trainer(cfg, exp_root / spec, stream, device=args.device,
                      eval_fn=heldout.make_eval_fn(_held(args), args.device),
                      finetune_dirs=finetune_dirs(args, spec, exp_root))
    if trainer.step != start:
        raise RuntimeError(f"segment resume landed at step {trainer.step}, wanted {start}")
    trainer.run(max_iters=until)
    if trainer.step != until:
        raise RuntimeError(f"segment {spec} [{start}, {until}) ended at step {trainer.step}")
    record_launches(exp_root / spec)
    print(f"segment {spec} [{start}, {until}) done", flush=True)
    return 0


def eval_stage1(args, device) -> tuple[float, float]:
    """The held-out AEE of the restored stage-1 (C) experiment through the
    stages' evaluation, and the zero-flow AEE."""
    from unflow_tpu_torch.models import build_model
    from unflow_tpu_torch.train.checkpoint import restore_params

    cfg = stage_cfg(args, "C")
    model = build_model(cfg, device)
    model.load_state_dict(restore_params(Path(args.stage1)))
    held = _held(args)
    return (heldout.make_eval_fn(held, device)(model.eval())["heldout_aee"],
            heldout.zero_flow_aee(held))


def run_stage(spec: str, args, exp_root: Path) -> dict:
    exp = exp_root / spec
    if exp.exists():
        shutil.rmtree(exp)
    exp.mkdir(parents=True)
    bounds = [args.steps * i // args.segments for i in range(args.segments + 1)]
    t0 = time.perf_counter()
    for start, until in zip(bounds, bounds[1:]):
        cmd = [sys.executable, "-m", "unflow_tpu_torch.cascade_heldout", "--run-segment", spec,
               str(start), str(until), *_forwarded(args)]
        rc = subprocess.run(cmd, env=child_env()).returncode
        if rc != 0:
            raise RuntimeError(f"{spec} segment [{start}, {until}) rc={rc}")
        print(f"[{time.perf_counter() - t0:.0f} s] {spec} segment [{start}, {until}) done",
              flush=True)
    wall = time.perf_counter() - t0
    curve, train_loss = [], []
    for line in (exp / "metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        if "eval/heldout_aee" in row:
            curve.append({"step": row["step"], "aee": round(row["eval/heldout_aee"], 4)})
        if "loss" in row and row["step"] % args.eval_every == 0:
            train_loss.append({"step": row["step"], "loss": round(row["loss"], 2)})
    return {
        "spec": spec,
        "curve": curve,
        "train_loss": train_loss,
        "final_aee": curve[-1]["aee"] if curve else None,
        "best_aee": min((c["aee"] for c in curve), default=None),
        "wall_s": round(wall, 1),
        "kernel_launches": summed_launches(exp),
    }


def _forwarded(args) -> list[str]:
    return ["--steps", str(args.steps), "--eval-every", str(args.eval_every),
            "--hw", str(args.hw[0]), str(args.hw[1]), "--batch", str(args.batch),
            "--lr", str(args.lr), "--decay-after", str(args.decay_after),
            "--grad-clip", str(args.grad_clip), "--segments", str(args.segments),
            "--corpus", str(args.corpus), "--max-shift", str(args.max_shift),
            "--dtype", args.dtype, "--stage1", str(args.stage1),
            "--synth-cache", str(args.synth_cache), "--exp-root", str(args.exp_root),
            "--device", str(args.device)]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--decay-after", type=int, default=0)
    ap.add_argument("--grad-clip", type=float, default=0.0)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--corpus", type=int, default=4096)
    ap.add_argument("--max-shift", type=float, default=heldout.MAX_SHIFT)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--stage1", default="log/ex/heldout/affine_on",
                    help="a finished FlowNetC experiment of the held-out recipe (stage 1)")
    ap.add_argument("--synth-cache", default="log/ex/heldout/synth_cache",
                    help="corpus cache (the held-out run's by default)")
    ap.add_argument("--exp-root", default="log/ex/cascade")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/cascade_heldout.json", help="JSON summary path")
    ap.add_argument("--run-segment", nargs=3, metavar=("SPEC", "START", "UNTIL"),
                    help=argparse.SUPPRESS)  # the child's mode
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    exp_root = Path(args.exp_root)
    if args.run_segment:
        return run_segment(args, exp_root)
    from unflow_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    arm = Path(args.stage1).name
    print("=== stage 1 (C, restored) ===", flush=True)
    c_aee, zero = eval_stage1(args, device)
    print(f"stage1 heldout_aee={c_aee:.4f} zero_flow={zero:.4f}", flush=True)
    stages = {"C": {"spec": "C", "final_aee": round(c_aee, 4),
                    "restored_from": str(args.stage1)}}
    for spec in STAGE_SPECS:
        print(f"=== stage {spec} ===", flush=True)
        stages[spec] = run_stage(spec, args, exp_root)
        print(json.dumps({k: v for k, v in stages[spec].items()
                          if k not in ("curve", "train_loss")}), flush=True)
    h, w = args.hw
    summary = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "geometry": (f"{h}x{w} batch {args.batch} "
                     f"{'bf16' if args.dtype == 'bfloat16' else 'f32'}, "
                     f"lr {args.lr:g} flat, max_shift {args.max_shift:g}"),
        "train_stream": (f"fixed corpus of {args.corpus} pairs seed 0, mode=affine, "
                         "per-epoch reshuffle (the held-out run's corpus)"),
        "heldout": (f"{heldout.HELDOUT_BATCHES * args.batch} fixed pairs, "
                    f"seed {heldout.HELDOUT_SEED} (never trained on)"),
        "stage1_arm": arm,
        "stage1_note": ("the JAX script restores the affine_off arm; " + (
            "this run restores it" if arm == "affine_off" else
            f"this run restores {arm}: the affine_off arm stays at zero flow on the H100 "
            "(ROADMAP C2)")),
        "steps_per_stage": args.steps,
        "objective": ("the unmodified UnFlow objective (census, second-order smoothness, "
                      "fb, occlusion); no bootstrap phase"),
        "zero_flow_aee": round(zero, 4),
        "stages": stages,
        "criterion": "held-out AEE improves stage over stage: csS < cS < C",
        "stacking_improves": bool(stages["csS"]["final_aee"] is not None
                                  and stages["cS"]["final_aee"] is not None
                                  and stages["csS"]["final_aee"] < stages["cS"]["final_aee"]
                                  < stages["C"]["final_aee"]),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
