"""Held-out acceptance run: does unsupervised UnFlow-C training generalize?

Port of ``scripts/heldout_generalization.py``, both of its arms: ``off``
trains without the affine augmentation, ``on`` with the ranges of
``AFFINE_ON`` (``--arms both`` runs the two in turn). FlowNetC trains
unsupervised on a fixed corpus of ``--corpus`` synthetic pairs
(``data/synthetic.py::corpus_iterator``: textures under a similarity motion
of up to ``MAX_SHIFT`` px, cycled in epochs), and every ``--eval-every``
steps its AEE is measured on 64 held-out pairs it never trains on (seed
``HELDOUT_SEED``). Steps [0, ``--bootstrap-until``) train with the plain
photometric data term (``photo_weight=1``, ``ternary_weight=0``,
``occ_weight=0``, no occlusion masking), which breaks the collapse to one
input-independent flow; later steps use the unmodified UnFlow objective.
The run goes in ``--segments`` segments, each a new ``Trainer`` that resumes
the experiment from its checkpoint on the step-indexed stream; no segment
straddles the bootstrap boundary. The run passes when the final held-out AEE
is below ``CRITERION`` times the zero-flow AEE (a collapsed run matches zero
flow). The recipe (flat learning rate 1e-4, no clipping, photometric and
flip augmentation with noise 0.04) is fixed; ``--set KEY=VALUE`` overrides a
train key of every segment for a diagnostic.

  python -m unflow_tpu_torch.heldout --steps 8000 --segments 2 --corpus 4096 \\
      --bootstrap-until 2000 --eval-every 250 --arms both --out log/heldout.json

It runs on the GPU unless ``--device cpu``, and writes a JSON summary to
``--out``: for each arm the held-out AEE curve, the final and best AEE, the
zero-flow AEE and the wall time; the verdict is the ``affine_off`` arm's
when it ran, else the ``affine_on`` arm's.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from unflow_tpu_torch.config import _FIELD_TYPES, Config, _coerce
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.synthetic import batch_iterator, corpus_iterator
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.evaluate import predict_flow
from unflow_tpu_torch.eval.metrics import flow_error_avg
from unflow_tpu_torch.train import Trainer

HELDOUT_SEED = 777_000  # far from any training stream seed
HELDOUT_BATCHES = 8  # fixed held-out batches, never trained on
DATA_MODE = "affine"  # similarity motion of the train and held-out pairs
MAX_SHIFT = 32.0  # synthetic max displacement in px
LEARNING_RATE = 1e-4  # flat for the whole run
CRITERION = 0.5  # pass iff final AEE < CRITERION * zero-flow AEE
# the affine_on arm's ranges, as the script sets them: conservative, to add
# pose diversity without distorting the data
AFFINE_ON = {
    "aug_translate": 0.05, "aug_rotate": 3.0, "aug_zoom_min": 0.95, "aug_zoom_max": 1.05,
    "aug_rel_translate": 0.01, "aug_rel_rotate": 0.5, "aug_rel_zoom": 0.01,
}
ARMS = {"off": ("affine_off",), "on": ("affine_on",), "both": ("affine_off", "affine_on")}


def heldout_set(batch: int, h: int, w: int) -> list[dict]:
    """The ``HELDOUT_BATCHES`` held-out batches of ``batch`` pairs, with their
    flow: numpy, frames float32 in [0, 1]."""
    stream = batch_iterator(batch, h, w, seed=HELDOUT_SEED, supervised=True, mode=DATA_MODE,
                            max_shift=MAX_SHIFT)
    return [next(stream) for _ in range(HELDOUT_BATCHES)]


def zero_flow_aee(held: list[dict]) -> float:
    """The AEE of predicting no motion: the mean of each batch's AEE."""
    aees = []
    for b in held:
        gt = torch.from_numpy(b["flow"])
        aees.append(float(flow_error_avg(torch.zeros_like(gt), gt)))
    return float(np.mean(aees))


def make_eval_fn(held: list[dict], device: torch.device | str):
    """``eval_fn(model) -> {"heldout_aee": ...}``: the mean over the held-out
    batches of each one's AEE, the frames normalized as the synthetic train
    stream's are."""
    tensors = [tuple(torch.from_numpy(b[k]).to(device) for k in ("im1", "im2", "flow"))
               for b in held]

    def eval_fn(model) -> dict:
        with torch.inference_mode():
            aees = [float(flow_error_avg(predict_flow(model, im1, im2, DEFAULT_NORMALIZATION), gt))
                    for im1, im2, gt in tensors]
        return {"heldout_aee": float(np.mean(aees))}

    return eval_fn


def build_cfg(args, affine: bool = False, bootstrap: bool = False) -> Config:
    """FlowNetC at ``--hw`` with the recipe's flat learning rate; with
    ``affine`` the ranges of ``AFFINE_ON``; with ``bootstrap`` the
    photometric objective of the first phase; then the ``--set``
    overrides."""
    cfg = Config()
    t = cfg.train
    if bootstrap:
        t.ternary_weight = 0.0
        t.photo_weight = 1.0
        t.occ_weight = 0.0
        t.mask_occlusion = ""
    t.flownet = "C"
    t.height, t.width = args.hw
    t.batch_size = args.batch
    t.num_iters = args.steps
    t.learning_rate = LEARNING_RATE
    t.decay_after = args.steps  # flat: no halving within the run
    t.display_interval = min(args.eval_every, 250)
    t.save_interval = max(args.steps // max(args.segments, 1), 1)
    t.eval_interval = args.eval_every
    t.image_summary_interval = -1
    t.compute_dtype = args.dtype
    t.grad_clip_norm = 0.0
    t.aug_photometric = True
    t.aug_hflip = True
    t.aug_noise_stddev = 0.04
    if affine:
        for key, value in AFFINE_ON.items():
            setattr(t, key, value)
    for kv in args.set:
        key, _, value = kv.partition("=")
        if key not in _FIELD_TYPES:
            raise SystemExit(f"unknown config key {key!r}")
        setattr(t, key, _coerce(value, _FIELD_TYPES[key]))
    return cfg


def segment_bounds(steps: int, segments: int, bootstrap_until: int) -> list[int]:
    """Segment boundaries: ``segments`` equal parts, split again at the
    bootstrap boundary so that no segment straddles it."""
    bounds = [steps * i // segments for i in range(segments + 1)]
    if bootstrap_until and 0 < bootstrap_until < steps:
        bounds = sorted(set(bounds) | {bootstrap_until})
    return bounds


def run_arm(args, name: str, device: torch.device) -> dict:
    """Train the arm ``name`` (``affine_off`` or ``affine_on``) segment by
    segment; its curve, final and best AEE."""
    h, w = args.hw
    exp = Path(args.exp_root) / name
    if exp.exists():
        shutil.rmtree(exp)
    held = heldout_set(args.batch, h, w)
    zero_aee = zero_flow_aee(held)
    eval_fn = make_eval_fn(held, device)

    t0 = time.perf_counter()
    bounds = segment_bounds(args.steps, args.segments, args.bootstrap_until)
    for start, until in zip(bounds, bounds[1:]):
        bootstrap = bool(args.bootstrap_until) and until <= args.bootstrap_until
        cfg = build_cfg(args, affine=name == "affine_on", bootstrap=bootstrap)
        # a fixed corpus cycled in epochs, generated once and cached; uint8
        # frames, which the train step converts on the device
        stream = corpus_iterator(args.batch, h, w, n_pairs=args.corpus, seed=0, mode=DATA_MODE,
                                 start_batch=start, max_shift=MAX_SHIFT,
                                 cache_dir=str(Path(args.exp_root) / "synth_cache"),
                                 dtype="uint8")
        trainer = Trainer(cfg, exp, stream, device=device, eval_fn=eval_fn)
        if trainer.step != start:
            raise RuntimeError(f"segment resume landed at step {trainer.step}, wanted {start}")
        trainer.run(max_iters=until)
        if trainer.step != until:
            raise RuntimeError(f"segment [{start}, {until}) ended at step {trainer.step}")
        print(f"[{time.perf_counter() - t0:.1f} s] {name} segment [{start}, {until}) done"
              f"{' (bootstrap)' if bootstrap else ''}", flush=True)
    wall = time.perf_counter() - t0

    curve, train_loss = [], []
    for line in (exp / "metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        if "eval/heldout_aee" in row:
            curve.append({"step": row["step"], "aee": row["eval/heldout_aee"]})
        if "loss" in row and row["step"] % args.eval_every == 0:
            train_loss.append({"step": row["step"], "loss": row["loss"]})
    return {
        "curve": curve,
        "train_loss": train_loss,
        "final_aee": curve[-1]["aee"] if curve else None,
        "best_aee": min((c["aee"] for c in curve), default=None),
        "zero_flow_aee": zero_aee,
        "wall_s": wall,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segments", type=int, default=2,
                    help="segments, each a new Trainer resuming from the checkpoint")
    ap.add_argument("--arms", choices=tuple(ARMS), default="off",
                    help="off: no affine augmentation; on: AFFINE_ON's ranges; both: the two")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--corpus", type=int, default=4096,
                    help="train on a fixed corpus of N pairs cycled in epochs")
    ap.add_argument("--bootstrap-until", type=int, default=2000,
                    help="steps before this train with the photometric bootstrap objective; "
                         "0 = the UnFlow objective throughout")
    ap.add_argument("--exp-root", default="log/ex/heldout")
    ap.add_argument("--out", default="log/heldout.json", help="JSON summary path")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a [train] config key of every segment, e.g. corr_impl=torch "
                         "or seed=1 (a diagnostic: the acceptance run sets none)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.corpus < 1:
        raise SystemExit("--corpus must be at least 1 pair")
    device = resolve_device(args.device)

    results = {}
    for name in ARMS[args.arms]:
        print(f"=== {name} ===", flush=True)
        results[name] = run_arm(args, name, device)
        print(json.dumps(results[name]), flush=True)
    result = results.get("affine_off") or results["affine_on"]
    summary = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "geometry": (f"{args.hw[0]}x{args.hw[1]} batch {args.batch} "
                     f"{'bf16' if args.dtype == 'bfloat16' else 'f32'}, "
                     f"FlowNetC unsupervised, lr {LEARNING_RATE:g} flat, max_shift {MAX_SHIFT:g}"),
        "train_stream": (f"fixed corpus of {args.corpus} pairs seed 0, mode={DATA_MODE}, "
                         "per-epoch reshuffle"),
        "heldout": f"{HELDOUT_BATCHES * args.batch} fixed pairs, seed {HELDOUT_SEED}",
        "steps": args.steps,
        "segments": args.segments,
        "overrides": args.set,
        "bootstrap": (f"steps [0, {args.bootstrap_until}): photometric data term, no occlusion "
                      f"masking or penalty; steps >= {args.bootstrap_until}: the UnFlow objective"
                      if args.bootstrap_until else "none (the UnFlow objective throughout)"),
        "zero_flow_aee": result["zero_flow_aee"],
        "criterion": f"final_aee < {CRITERION} * zero_flow_aee",
        **results,
        "generalizes": bool(result["final_aee"] is not None
                            and result["final_aee"] < CRITERION * result["zero_flow_aee"]),
    }
    if len(results) == 2 and None not in (results["affine_off"]["final_aee"],
                                          results["affine_on"]["final_aee"]):
        summary["affine_aee_delta"] = (results["affine_on"]["final_aee"]
                                       - results["affine_off"]["final_aee"])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("device", "zero_flow_aee", "generalizes")}))
    for name, r in results.items():
        print(f"{name}: final AEE {r['final_aee']} best {r['best_aee']} zero-flow "
              f"{r['zero_flow_aee']} wall {r['wall_s']:.1f} s -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
