"""The unsupervised loss along the line from zero flow to the ground truth.

Port of ``scripts/loss_landscape_probe.py``: the full objective (census,
second-order smoothness, forward-backward and the occlusion prior) at flow
pyramids ``alpha x GT`` for ``alpha`` in ``ALPHAS``, on one batch of
synthetic pairs per motion mode. A loss that falls monotonically toward
``alpha = 1`` means the data carries a learnable signal; a plateau or a bump
between 0 and 1 is a basin the optimizer can park in. No network runs.

  python -m unflow_tpu_torch.probes.landscape [--hw 128 256] [--batch 8] \\
      [--device cpu] [--out log/loss_landscape.json]

The JAX package's record, ``benchmarks/loss_landscape.json``, was taken on a
TPU, whose default precision computes the census patches
(``conv_general_dilated_patches``) in one bfloat16 pass: its losses are
those of the grayscale rounded to bfloat16 (3-10% above this module's, which
takes the patches exactly, as XLA does on the CPU).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.losses import unsupervised_loss
from unflow_tpu_torch.models.flownet import FLOW_SCALE
from unflow_tpu_torch.ops.downsample import downsample

ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0, 1.25)
MODES = ("translate", "affine")


def gt_pyramid(gt_full: torch.Tensor, num_levels: int = 5) -> list[torch.Tensor]:
    """Full-resolution ground truth ``(B, 2, H, W)`` in pixels -> the five
    network-unit flows, finest (1/4) first: level ``i`` is the flow
    average-pooled by ``f = 4 * 2**i``, in that level's pixels, times
    ``2**i / FLOW_SCALE`` (the loss's scaling inverted)."""
    pyramid = []
    for i in range(num_levels):
        f = 4 * 2**i
        pyramid.append((downsample(gt_full, f) / f * (2**i / FLOW_SCALE)).float())
    return pyramid


def loss_at(alpha: float, im1: torch.Tensor, im2: torch.Tensor,
            pyr_fw: list[torch.Tensor], pyr_bw: list[torch.Tensor]) -> float:
    """The objective at the pyramids scaled by ``alpha`` (NCHW frames)."""
    with torch.no_grad():
        total, _ = unsupervised_loss(im1, im2, [alpha * p for p in pyr_fw],
                                     [alpha * p for p in pyr_bw])
    return float(total)


def probe(hw=(128, 256), batch: int = 8, max_shift: float = 8.0, seed: int = 777_000,
          device: torch.device | str = "cuda", alphas=ALPHAS) -> dict:
    """The script's summary: for each motion mode the loss at each alpha,
    the drop from zero to the ground truth and whether the loss falls
    monotonically to ``alpha = 1``."""
    h, w = hw
    out = {"geometry": f"{h}x{w} batch {batch}", "alphas": list(alphas), "modes": {}}
    for mode in MODES:
        b = next(batch_iterator(batch, h, w, seed=seed, supervised=True, max_shift=max_shift,
                                mode=mode))
        im1, im2, gt = (torch.from_numpy(b[k]).permute(0, 3, 1, 2).to(device)
                        for k in ("im1", "im2", "flow"))
        pyr_fw = gt_pyramid(gt)
        # for these smooth similarity motions the backward flow is about
        # minus the forward one (exactly, for a translation)
        pyr_bw = [-p for p in pyr_fw]
        curve = [round(loss_at(a, im1, im2, pyr_fw, pyr_bw), 3) for a in alphas]
        one = list(alphas).index(1.0)
        out["modes"][mode] = {
            "loss_at_alpha": dict(zip(map(str, alphas), curve)),
            "zero_minus_gt": round(curve[0] - curve[one], 3),
            "monotone_to_gt": bool(all(curve[i] >= curve[i + 1] for i in range(one))),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-shift", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=777_000)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/loss_landscape.json", help="JSON summary path")
    args = ap.parse_args(argv)
    out = probe(tuple(args.hw), args.batch, args.max_shift, args.seed,
                resolve_device(args.device))
    for mode, row in out["modes"].items():
        print(mode, row, flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
