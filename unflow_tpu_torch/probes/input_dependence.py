"""Can the network fit two fixed batches, which needs it to read its input?

Port of ``scripts/input_dependence_probe.py``. The narrowest test of the
zero-flow collapse: the model and the supervised loss alone (no trainer
augmentation, float32, no clipping, Adam at ``--lr``) on ``--batches`` fixed
synthetic batches (seed 4242) cycled step by step. One batch can be fitted
through the biases alone; several distinct input -> flow pairs cannot. Every
``--report-every`` steps it gives the train AEE against zero flow, the
spread of the per-pair mean predicted flow, and the AEE on two held-out
batches (seed 777000). ``--photometric`` turns the trainer's photometric
augmentation back on (its draws from a torch generator, where the script's
come from a JAX key).

  python -m unflow_tpu_torch.probes.input_dependence [--steps 2000] [--lr 1e-3] \\
      [--dtype float32|bfloat16] [--photometric] [--device cpu] \\
      [--out log/input_dependence.json]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from unflow_tpu_torch.augment import normalize, random_photometric
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.evaluate import predict_flow
from unflow_tpu_torch.losses import supervised_loss
from unflow_tpu_torch.models import build_model, init_params


def _stats(model, batches) -> tuple[float, float, float]:
    """(AEE, zero-flow AEE, the spread of the per-pair mean flow), averaged
    over ``batches`` of NHWC tensors."""
    aees, zeros, spreads = [], [], []
    with torch.no_grad():
        for im1, im2, gt in batches:
            flow = predict_flow(model, im1, im2, DEFAULT_NORMALIZATION).float()
            spreads.append(float(flow.mean((1, 2)).std(0, unbiased=False).mean()))
            aees.append(float(torch.linalg.vector_norm(flow - gt, dim=-1).mean()))
            zeros.append(float(torch.linalg.vector_norm(gt, dim=-1).mean()))
    return float(np.mean(aees)), float(np.mean(zeros)), float(np.mean(spreads))


def probe(steps: int = 2000, report_every: int = 200, hw=(128, 256), batch: int = 8,
          batches: int = 2, lr: float = 1e-3, dtype: str = "float32", flownet: str = "C",
          photometric: bool = False, data_mode: str = "affine", max_shift: float = 8.0,
          device: torch.device | str = "cuda", params: dict | None = None,
          corr_impl: str = "auto") -> dict:
    """The probe's reports and its verdict; ``params``: a ``state_dict`` to
    start from (else the init of seed 0)."""
    h, w = hw
    cfg = Config()
    t = cfg.train
    t.flownet = flownet
    t.height, t.width = h, w
    t.compute_dtype = dtype
    t.corr_impl = corr_impl
    model = build_model(cfg, "cpu")
    if params is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params)
    model = model.to(device=device, memory_format=torch.channels_last)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)

    def tensors(seed, n):
        it = batch_iterator(batch, h, w, seed=seed, supervised=True, mode=data_mode,
                            max_shift=max_shift)
        return [tuple(torch.from_numpy(b[k]).to(device) for k in ("im1", "im2", "flow"))
                for b in (next(it) for _ in range(n))]

    train, held = tensors(4242, batches), tensors(777_000, 2)
    mean, std = DEFAULT_NORMALIZATION
    generator = torch.Generator(device=device).manual_seed(1)

    def report(step: int) -> dict:
        aee, zero, spread = _stats(model, train[:8])
        held_aee, held_zero, _ = _stats(model, held)
        return {"step": step, "train_aee": aee, "train_zero_aee": zero, "spread_px": spread,
                "heldout_aee": held_aee, "heldout_zero_aee": held_zero}

    out = {"reports": [], "losses": []}
    t0 = time.perf_counter()
    for i in range(steps):
        im1, im2, gt = train[i % len(train)]
        if photometric:
            im1, im2 = random_photometric(generator, [im1, im2])
        stages = model(normalize(im1, mean, std).permute(0, 3, 1, 2),
                       normalize(im2, mean, std).permute(0, 3, 1, 2))
        loss, _ = supervised_loss(stages[-1], gt.permute(0, 3, 1, 2))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        out["losses"].append(loss.item())
        if (i + 1) % report_every == 0:
            out["reports"].append({**report(i + 1), "loss": out["losses"][-1],
                                   "wall_s": time.perf_counter() - t0})
    final = report(steps)
    out["final"] = final
    out["verdict"] = ("input-dependent" if final["train_aee"] < 0.5 * final["train_zero_aee"]
                      else "collapsed or inconclusive")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--report-every", type=int, default=200)
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2, help="distinct fixed batches cycled")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--flownet", default="C")
    ap.add_argument("--photometric", action="store_true",
                    help="the trainer's photometric augmentation on")
    ap.add_argument("--data-mode", choices=("affine", "translate"), default="affine")
    ap.add_argument("--max-shift", type=float, default=8.0,
                    help="synthetic max displacement in px")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/input_dependence.json", help="JSON summary path")
    args = ap.parse_args(argv)
    out = probe(args.steps, args.report_every, tuple(args.hw), args.batch, args.batches,
                args.lr, args.dtype, args.flownet, args.photometric, args.data_mode,
                args.max_shift, resolve_device(args.device))
    for r in out["reports"] + [out["final"]]:
        print(f"step {r['step']}: train aee={r['train_aee']:.3f} (zero {r['train_zero_aee']:.3f}) "
              f"spread={r['spread_px']:.3f} px | HELD-OUT aee={r['heldout_aee']:.3f} "
              f"(zero {r['heldout_zero_aee']:.3f})", flush=True)
    print(out["verdict"])
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
