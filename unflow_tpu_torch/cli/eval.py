"""Evaluation entry point: AEE and Fl of an experiment on a dataset.

Port of ``unflow_tpu/cli/eval.py``: restores the experiment's latest
checkpoint (its snapshot supplies the network unless ``--config`` is given),
evaluates a dataset's eval split with :meth:`Evaluator.run`, prints AEE, Fl
and the occluded / non-occluded breakdown, and with ``--output`` dumps the
flows. It runs on the GPU unless ``--device cpu``.

  python -m unflow_tpu_torch.cli.eval --ex kitti_c --dataset kitti_2012
  python -m unflow_tpu_torch.cli.eval --ex kitti_c --dataset sintel \\
      --variant clean --output out/ --format viz
"""

from __future__ import annotations

import argparse

from unflow_tpu_torch.config import Config, load_config
from unflow_tpu_torch.data import dataset_normalization, get_dataset
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.evaluate import Evaluator


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ex", required=True, help="experiment name")
    ap.add_argument("--config", default=None)
    ap.add_argument("--dataset", required=True,
                    help="kitti_2012 | kitti_2015 | sintel | chairs | middlebury")
    ap.add_argument("--variant", default=None,
                    help="dataset variant (kitti: occ|noc, sintel: clean|final)")
    ap.add_argument("--num", type=int, default=None, help="max examples")
    ap.add_argument("--batch", type=int, default=8, help="same-shape pairs per forward pass")
    ap.add_argument("--output", default=None, help="dump directory")
    ap.add_argument("--format", default="flo", choices=("flo", "kitti_png", "viz"))
    ap.add_argument("--gui", action="store_true", help="matplotlib pager (not ported)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.gui:
        raise NotImplementedError("the matplotlib pager (--gui) is not ported yet: ROADMAP item A13")

    cfg = load_config(args.config) if args.config else Config()
    ex_dir = cfg.experiment_dir(args.ex)
    snapshot = ex_dir / "config.ini"
    if args.config is None and snapshot.exists():
        cfg = load_config(snapshot)
    device = resolve_device(args.device)  # before the model: no GPU fails fast

    if args.dataset == "sintel":
        dataset = get_dataset("sintel", cfg.dirs.data, render_pass=args.variant or "clean")
        examples = dataset.eval_examples()
    else:
        dataset = get_dataset(args.dataset, cfg.dirs.data)
        examples = dataset.eval_examples(args.variant)

    # the constants the checkpoint was trained with (the snapshot names the
    # training dataset); the eval dataset's for synthetic or unknown ones
    norm = dataset_normalization(cfg.train.dataset) or dataset.normalization
    evaluator = Evaluator(cfg, ex_dir, normalization=norm, device=device)
    metrics = evaluator.run(
        examples, max_examples=args.num, output_dir=args.output, output_format=args.format,
        eval_batch=args.batch,
    )
    line = (
        f"{args.dataset}{'/' + args.variant if args.variant else ''}: "
        f"AEE={metrics['aee']:.4f} Fl={metrics['fl'] * 100:.2f}% (n={metrics['n']})"
    )
    if "aee_noc" in metrics:  # occ/noc breakdown (flow_noc / occlusion masks)
        line += f" | noc: AEE={metrics['aee_noc']:.4f} Fl={metrics['fl_noc'] * 100:.2f}%"
    if "aee_occ" in metrics:
        line += f" | occ-only: AEE={metrics['aee_occ']:.4f}"
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
