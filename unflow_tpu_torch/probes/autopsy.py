"""Per-example statistics of a checkpoint's predictions.

Port of ``scripts/checkpoint_autopsy.py``. Restores an experiment's latest
checkpoint and, for each pair of one synthetic batch (seed 777000, the
held-out seed), gives the mean and standard deviation of the predicted and
the true flow and the pair's AEE. A net parked in the zero-flow basin
predicts the same near-constant flow for every pair, which one AEE number
cannot tell from a slightly wrong per-pair motion: the spread of the
predicted means across the pairs can (under 0.25 px: a collapse to one
input-independent flow).

  python -m unflow_tpu_torch.probes.autopsy --exp log/ex/heldout/affine_off \\
      [--hw 128 256] [--batch 8] [--max-shift 8] [--device cpu] \\
      [--out log/autopsy.json]

It runs in bfloat16 on the GPU and in float32 with ``--device cpu``, as the
script does on the TPU and with ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.evaluate import predict_flow
from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train.checkpoint import CheckpointManager

COLLAPSE_SPREAD_PX = 0.25


def autopsy(exp: str | Path, hw=(128, 256), batch: int = 8, seed: int = 777_000,
            max_shift: float = 8.0, flownet: str = "C",
            device: torch.device | str = "cuda") -> dict:
    """The restored step, each pair's statistics and the spread of the
    predicted means (NHWC flows, pixels)."""
    device = torch.device(device)
    h, w = hw
    cfg = Config()
    t = cfg.train
    t.flownet = flownet
    t.height, t.width = h, w
    t.compute_dtype = "float32" if device.type == "cpu" else "bfloat16"
    model = build_model(cfg, device)
    checkpoint = CheckpointManager(exp).load()
    model.load_state_dict(checkpoint["model"])
    b = next(batch_iterator(batch, h, w, seed=seed, supervised=True, mode="affine",
                            max_shift=max_shift))
    with torch.inference_mode():
        flow = predict_flow(model.eval(), torch.from_numpy(b["im1"]).to(device),
                            torch.from_numpy(b["im2"]).to(device), DEFAULT_NORMALIZATION)
    flow, gt = flow.float().cpu().numpy(), b["flow"]
    pairs = []
    for f, g in zip(flow, gt):
        pairs.append({"pred_mean": f.mean((0, 1)).tolist(), "pred_std": f.std((0, 1)).tolist(),
                      "gt_mean": g.mean((0, 1)).tolist(), "gt_std": g.std((0, 1)).tolist(),
                      "aee": float(np.linalg.norm(f - g, axis=-1).mean())})
    spread = float(np.std([p["pred_mean"] for p in pairs], axis=0).mean())
    return {"exp": str(exp), "step": int(checkpoint["step"]), "pairs": pairs,
            "spread_of_pred_means": spread,
            "verdict": ("input-independent collapse" if spread < COLLAPSE_SPREAD_PX
                        else "input-dependent")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--exp", required=True, help="experiment directory with checkpoints/")
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=777_000)
    ap.add_argument("--max-shift", type=float, default=8.0)
    ap.add_argument("--flownet", default="C")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/autopsy.json", help="JSON summary path")
    args = ap.parse_args(argv)
    out = autopsy(args.exp, tuple(args.hw), args.batch, args.seed, args.max_shift, args.flownet,
                  resolve_device(args.device))
    print(f"restored step {out['step']} from {args.exp}")
    for i, p in enumerate(out["pairs"]):
        pm, ps, gm, gs = p["pred_mean"], p["pred_std"], p["gt_mean"], p["gt_std"]
        print(f"ex{i}: pred mean=({pm[0]:+.2f},{pm[1]:+.2f}) std=({ps[0]:.2f},{ps[1]:.2f})"
              f"  gt mean=({gm[0]:+.2f},{gm[1]:+.2f}) std=({gs[0]:.2f},{gs[1]:.2f})"
              f"  aee={p['aee']:.2f}")
    print(f"cross-example spread of predicted means: {out['spread_of_pred_means']:.3f} px "
          f"({out['verdict']})")
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
