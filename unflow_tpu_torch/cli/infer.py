"""Single-pair inference: two frames in, optical flow out.

Port of ``unflow_tpu/cli/infer.py``: pads the pair to the /64 pyramid
size, runs the network and writes the flow as ``.flo``, KITTI 16-bit PNG
and/or a color visualization. It runs on the GPU unless ``--device cpu``.

  python -m unflow_tpu_torch.cli.infer --ex kitti_css --im1 f1.png --im2 f2.png \\
      --out flow.flo --viz flow.png

``--ex`` restores the experiment's latest checkpoint, and its snapshot
supplies the network (unless ``--config`` is given); ``--random-init`` runs
a network initialized from ``--seed`` instead.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from unflow_tpu_torch.config import Config, load_config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION, dataset_normalization
from unflow_tpu_torch.data.io import read_image, write_flo, write_image, write_kitti_png_flow
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.evaluate import Evaluator
from unflow_tpu_torch.eval.flow_viz import flow_to_color
from unflow_tpu_torch.models import build_model, init_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ex", default=None, help="experiment name under <log>/ex/")
    ap.add_argument("--config", default=None, help="config.ini (defaults to the experiment snapshot)")
    ap.add_argument("--im1", required=True)
    ap.add_argument("--im2", required=True)
    ap.add_argument("--out", default=None, help=".flo or .png (KITTI 16-bit) output path")
    ap.add_argument("--viz", default=None, help="flow color-wheel PNG output path")
    ap.add_argument(
        "--random-init", action="store_true",
        help="skip checkpoint restore (structural smoke run)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0, help="seed of --random-init")
    args = ap.parse_args(argv)
    if not (args.out or args.viz):
        ap.error("nothing to do: pass --out and/or --viz")
    if not args.random_init and args.ex is None:
        ap.error("--ex is required unless --random-init")

    # --config applies with or without --ex (a --random-init run still
    # needs it for the net spec and dataset normalization).
    cfg = load_config(args.config) if args.config else Config()
    exp_dir = None
    if args.ex is not None:
        exp_dir = cfg.experiment_dir(args.ex)
        snapshot = exp_dir / "config.ini"
        if args.config is None and snapshot.exists():
            cfg = load_config(snapshot)  # the snapshot knows the net spec
    # the checkpoint was trained with its dataset's normalization
    norm = dataset_normalization(cfg.train.dataset) or DEFAULT_NORMALIZATION

    device = resolve_device(args.device)  # before the model: no GPU fails fast
    params = None
    if args.random_init:
        model = build_model(cfg, "cpu")
        init_params(model, torch.Generator().manual_seed(args.seed))
        params = model.state_dict()
    ev = Evaluator(cfg, exp_dir, params=params, normalization=norm, device=device)

    im1 = read_image(args.im1)
    im2 = read_image(args.im2)
    if im1.shape != im2.shape:
        raise SystemExit(f"frame shapes differ: {im1.shape} vs {im2.shape}")
    flow = ev.predict(im1, im2)

    if args.out:
        out = Path(args.out)
        if out.suffix == ".flo":
            write_flo(out, flow)
        elif out.suffix == ".png":
            write_kitti_png_flow(out, flow)
        else:
            raise SystemExit(f"unknown output extension {out.suffix!r} (use .flo or .png)")
        print(f"wrote {out}")
    if args.viz:
        write_image(Path(args.viz), flow_to_color(flow))
        print(f"wrote {args.viz}")
    u, v = flow[..., 0], flow[..., 1]
    mag = ((u**2 + v**2) ** 0.5).mean()
    print(
        f"flow {flow.shape[1]}x{flow.shape[0]}: |f| mean {float(mag):.3f} "
        f"u [{float(u.min()):.2f}, {float(u.max()):.2f}] "
        f"v [{float(v.min()):.2f}, {float(v.max()):.2f}]"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
