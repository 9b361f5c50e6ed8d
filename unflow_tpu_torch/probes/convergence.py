"""Overfit one batch: can the pipeline drive AEE toward zero at all?

Port of ``scripts/validate_convergence.py``. FlowNetC in float32 trains on
one fixed synthetic batch with known flow (128x256, batch 4, seed 0), Adam
at ``--lr``, on the supervised loss or, with ``--unsup``, the unsupervised
one (a forward and a backward apply); the AEE of the full-resolution flow is
read every ``--report-every`` steps. It passes when the final AEE is under
half the smaller of the zero-flow AEE and the init's.

The JAX package's figures, on a TPU (its docstring; accuracy, not speed):
supervised, AEE 8.75 -> about 1.0 in 600 steps at lr 1e-3; unsupervised,
8.75 -> 0.71 in 1200 steps at lr 1e-4. One batch can be memorized through
the biases alone, so this does not show that training generalizes
(:mod:`unflow_tpu_torch.heldout` does).

  python -m unflow_tpu_torch.probes.convergence [--unsup] [--steps 600] \\
      [--lr 1e-4] [--device cpu] [--out log/convergence.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from unflow_tpu_torch.augment import normalize
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.losses import supervised_loss, unsupervised_loss
from unflow_tpu_torch.models import FlowNetC, full_res_flow, init_params


def _aee(flow: torch.Tensor, gt: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(flow - gt, dim=1).mean())


def overfit(unsup: bool = False, steps: int = 600, lr: float = 1e-4, hw=(128, 256),
            batch: int = 4, device: torch.device | str = "cuda",
            params: dict | None = None, report_every: int = 100,
            corr_impl: str | None = None) -> dict:
    """Train on the one batch; the zero-flow and init AEE, the loss and AEE
    every ``report_every`` steps, the final AEE and the verdict. ``params``:
    a ``state_dict`` to start from (else the init of seed 0)."""
    h, w = hw
    b = next(batch_iterator(batch, h, w, seed=0, supervised=True))
    im1, im2, gt = (torch.from_numpy(b[k]).permute(0, 3, 1, 2).to(device)
                    for k in ("im1", "im2", "flow"))
    mean, std = DEFAULT_NORMALIZATION
    n1, n2 = (normalize(x.permute(0, 2, 3, 1), mean, std).permute(0, 3, 1, 2)
              .contiguous(memory_format=torch.channels_last) for x in (im1, im2))
    model = FlowNetC(torch.float32, corr_impl=corr_impl)
    if params is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params)
    model = model.to(device=device, memory_format=torch.channels_last)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)

    def aee() -> float:
        with torch.no_grad():
            return _aee(full_res_flow(model(n1, n2), h, w), gt)

    out = {"objective": "unsupervised" if unsup else "supervised", "lr": lr,
           "zero_flow_aee": _aee(torch.zeros_like(gt), gt), "init_aee": aee(), "curve": []}
    for i in range(1, steps + 1):
        flows_fw = model(n1, n2)
        if unsup:
            loss, _ = unsupervised_loss(im1, im2, flows_fw, model(n2, n1))
        else:
            loss, _ = supervised_loss(flows_fw, gt)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if i % report_every == 0:
            out["curve"].append({"step": i, "loss": loss.item(), "aee": aee()})
    out["final_aee"] = aee()
    out["ok"] = out["final_aee"] < 0.5 * min(out["zero_flow_aee"], out["init_aee"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--unsup", action="store_true", help="the unsupervised objective")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--out", default="log/convergence.json", help="JSON summary path")
    args = ap.parse_args(argv)
    out = overfit(args.unsup, args.steps, args.lr, device=resolve_device(args.device))
    print(f"zero-prediction baseline AEE: {out['zero_flow_aee']:.3f}; "
          f"init AEE: {out['init_aee']:.3f}")
    for row in out["curve"]:
        print(f"step {row['step']}: loss {row['loss']:.3f} aee {row['aee']:.3f}")
    print(f"final AEE {out['final_aee']:.3f} -> "
          f"{'OK' if out['ok'] else 'FAILED (no convergence)'}")
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
