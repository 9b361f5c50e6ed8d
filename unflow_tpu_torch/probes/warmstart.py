"""Supervised warm start, then unsupervised training: is the true flow a
stable minimum of the unsupervised objective?

Port of ``scripts/warmstart_probe.py``. Phase A trains FlowNetC supervised
on the synthetic stream (or a fixed ``--corpus``); phase B continues
unsupervised from phase A's parameters. Both evaluate the AEE on the
held-out pairs (seed 777000) every ``--eval-every`` steps. If phase B holds
or improves phase A's AEE, the true flow is a stable minimum and training
from scratch only fails to reach it; if it falls back to the zero-flow AEE,
the objective prefers zero flow. ``basin_stable``: phase B's final AEE under
0.7 times the zero-flow AEE.

  python -m unflow_tpu_torch.probes.warmstart [--sup-steps 2000] \\
      [--unsup-steps 2000] [--skip-b] [--device cpu] [--out log/warmstart.json]

The JAX package's record, ``benchmarks/warmstart_probe.json``, holds phase A
alone (``--skip-b``) of 4000 steps.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from unflow_tpu_torch import heldout
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data.synthetic import batch_iterator, corpus_iterator
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.train import Trainer


def phase_cfg(args, supervised: bool, steps: int, eval_every: int, lr: float) -> Config:
    """A phase's config, as the script's ``run_phase`` builds it."""
    h, w = args.hw
    cfg = Config()
    t = cfg.train
    t.flownet = "C"
    t.height, t.width = h, w
    t.batch_size = args.batch
    t.num_iters = steps
    t.learning_rate = lr
    t.decay_after = steps
    t.display_interval = eval_every
    t.save_interval = steps
    t.eval_interval = eval_every
    t.image_summary_interval = -1
    t.compute_dtype = args.dtype
    t.supervised = supervised
    t.grad_clip_norm = args.grad_clip
    t.aug_photometric = not args.no_photometric
    t.aug_hflip = not args.no_hflip
    t.aug_noise_stddev = args.noise
    return cfg


def heldout_batches(args) -> list[dict]:
    h, w = args.hw
    stream = batch_iterator(args.batch, h, w, seed=heldout.HELDOUT_SEED, supervised=True,
                            mode="affine", max_shift=args.max_shift)
    return [next(stream) for _ in range(heldout.HELDOUT_BATCHES)]


def run_phase(name: str, supervised: bool, steps: int, eval_every: int, args,
              exp_root: Path, lr: float, device, finetune_from: Path | None = None,
              params: dict | None = None) -> tuple[dict, Path]:
    """Train one phase; its held-out curve, losses, final and zero-flow AEE."""
    h, w = args.hw
    cfg = phase_cfg(args, supervised, steps, eval_every, lr)
    exp = exp_root / name
    if exp.exists():
        shutil.rmtree(exp)
    exp.mkdir(parents=True)
    held = heldout_batches(args)
    if args.corpus:
        stream = corpus_iterator(args.batch, h, w, n_pairs=args.corpus, seed=0,
                                 supervised=supervised, mode="affine", max_shift=args.max_shift,
                                 cache_dir=str(exp_root / "synth_cache"), dtype="uint8")
    else:
        stream = batch_iterator(args.batch, h, w, seed=0, supervised=supervised, mode="affine",
                                max_shift=args.max_shift)
    trainer = Trainer(cfg, exp, stream, device=device, params=params,
                      eval_fn=heldout.make_eval_fn(held, device),
                      finetune_dirs=[finetune_from] if finetune_from else ())
    trainer.run()
    rows = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    curve = [{"step": r["step"], "aee": round(r["eval/heldout_aee"], 4)}
             for r in rows if "eval/heldout_aee" in r]
    return {"curve": curve, "loss_curve": [round(r["loss"], 2) for r in rows if "loss" in r],
            "final_aee": curve[-1]["aee"] if curve else None,
            "zero_flow_aee": round(heldout.zero_flow_aee(held), 4)}, exp


def probe(args, device, params: dict | None = None) -> dict:
    """Both phases (phase A alone with ``--skip-b``) and the summary."""
    root = Path(args.exp_root)
    sup, sup_dir = run_phase("sup", True, args.sup_steps, args.sup_eval_every or args.eval_every,
                             args, root, args.sup_lr, device, params=params)
    print(json.dumps(sup), flush=True)
    if args.skip_b:
        return {"supervised_only": sup}
    unsup, _ = run_phase("unsup_cont", False, args.unsup_steps, args.eval_every, args, root,
                         args.unsup_lr, device, finetune_from=sup_dir)
    print(json.dumps(unsup), flush=True)
    h, w = args.hw
    return {
        "geometry": (f"{h}x{w} batch {args.batch} "
                     f"{'bf16' if args.dtype == 'bfloat16' else 'f32'} FlowNetC, sup lr "
                     f"{args.sup_lr:g} / unsup lr {args.unsup_lr:g} flat, data mode=affine, "
                     f"max_shift {args.max_shift:g}"),
        "supervised": sup,
        "unsupervised_continuation": unsup,
        "zero_flow_aee": sup["zero_flow_aee"],
        "basin_stable": bool(unsup["final_aee"] is not None and sup["final_aee"] is not None
                             and unsup["final_aee"] < 0.7 * sup["zero_flow_aee"]),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sup-steps", type=int, default=2000)
    ap.add_argument("--unsup-steps", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--sup-lr", type=float, default=1e-4, help="phase A's learning rate")
    ap.add_argument("--unsup-lr", type=float, default=1e-4, help="phase B's learning rate")
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    help="global-norm clip of both phases (0: off)")
    ap.add_argument("--sup-eval-every", type=int, default=0,
                    help="phase A's evaluation interval (0: --eval-every)")
    ap.add_argument("--skip-b", action="store_true", help="phase A only")
    ap.add_argument("--corpus", type=int, default=0,
                    help="a fixed train corpus of N pairs cycled in epochs (0: the stream)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--max-shift", type=float, default=32.0,
                    help="synthetic max displacement in px")
    ap.add_argument("--noise", type=float, default=0.04,
                    help="photometric per-frame noise stddev")
    ap.add_argument("--no-photometric", action="store_true",
                    help="no photometric augmentation")
    ap.add_argument("--no-hflip", action="store_true", help="no random horizontal flip")
    ap.add_argument("--exp-root", default="log/ex/warmstart")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/warmstart.json", help="JSON summary path")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = probe(args, resolve_device(args.device))
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
