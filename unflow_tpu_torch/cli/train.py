"""Training entry point.

Port of ``unflow_tpu/cli/train.py``: parses ``--ex`` (experiment name) and
overrides, creates ``<log>/ex/<name>/``, snapshots the resolved config into
it and runs the Trainer. It runs on the GPU unless ``--device cpu``.

  python -m unflow_tpu_torch.cli.train --config configs/kitti_unsup_c.ini --ex kitti_c \\
      --set dataset=synthetic --set num_iters=20 --set display_interval=5

Rerunning an experiment resumes it from its latest checkpoint, under its
snapshot (``--config`` and ``--set`` are then ignored), on the batches an
uninterrupted run would have seen. Only ``dataset=synthetic`` trains so far
(the dataset loaders are ROADMAP item A10).
"""

from __future__ import annotations

import argparse

from unflow_tpu_torch.config import (
    _FIELD_TYPES,
    Config,
    _coerce,
    load_config,
    prepare_experiment_dir,
)
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.synthetic import batch_iterator as synthetic_batches
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.train import CheckpointManager, Trainer


def build_batches_and_norm(cfg: Config, start_batch: int = 0):
    """The host batch stream of ``cfg`` and its normalization. The stream is
    step-indexed: ``start_batch`` is the step a resumed run starts at."""
    t = cfg.train
    if t.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {t.dataset!r}: only dataset=synthetic trains so far; the dataset "
            "loaders are ROADMAP item A10"
        )
    batches = synthetic_batches(
        t.batch_size, t.height, t.width, seed=t.seed, start_batch=start_batch,
        num_threads=t.num_threads,
    )
    return batches, DEFAULT_NORMALIZATION


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="config.ini path")
    ap.add_argument("--ex", required=True, help="experiment name")
    ap.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override a [train] config key",
    )
    ap.add_argument("--debug", action="store_true", help="tiny smoke run")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config) if args.config else Config()
    for kv in args.set:
        key, _, value = kv.partition("=")
        if key not in _FIELD_TYPES:
            raise SystemExit(f"unknown config key {key!r}")
        setattr(cfg.train, key, _coerce(value, _FIELD_TYPES[key]))
    device = resolve_device(args.device)  # before anything is written: no GPU fails fast
    ex_dir = cfg.experiment_dir(args.ex)
    snapshot = ex_dir / "config.ini"
    existed = snapshot.exists()
    if existed:
        # the snapshot governs a resumed experiment, as in the reference
        if args.config is not None or args.set:
            print(f"resuming {args.ex}: snapshot {snapshot} governs; "
                  "ignoring --config/--set overrides")
        cfg = load_config(snapshot)
    # the stream starts at the checkpointed step, so a resumed run sees the
    # batches an uninterrupted one would
    resume_step = CheckpointManager(ex_dir).latest_step() or 0
    # before the snapshot: a refused dataset writes nothing
    batches, norm = build_batches_and_norm(cfg, start_batch=resume_step)
    if not existed:
        prepare_experiment_dir(cfg, args.ex)
    if args.debug:
        # Run-mode clamp only, applied after the snapshot so a --debug run
        # does not bake tiny iteration counts into it.
        cfg.train.num_iters = min(cfg.train.num_iters, 10)
        cfg.train.display_interval = 1
        cfg.train.save_interval = 10

    trainer = Trainer(cfg, ex_dir, batches, normalization=norm, device=device)
    print(f"experiment {args.ex}: step {trainer.step} -> {cfg.train.num_iters}")
    logs = trainer.run()
    if "loss" in logs:
        print(f"done at step {trainer.step}: loss={logs['loss']:.5g}")
    else:
        print(f"already complete at step {trainer.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
