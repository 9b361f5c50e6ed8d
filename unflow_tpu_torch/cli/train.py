"""Training entry point.

Port of ``unflow_tpu/cli/train.py``: parses ``--ex`` (experiment name) and
overrides, creates ``<log>/ex/<name>/``, snapshots the resolved config into
it, builds the input of its ``dataset`` (the synthetic stream, or a dataset
under ``[dirs] data`` through the threaded ``Loader``, from the packed
directory ``packed_dir`` when one is set) and runs the Trainer, evaluating
every ``eval_interval`` steps. It runs on the GPU unless ``--device cpu``.

  python -m unflow_tpu_torch.cli.train --config configs/kitti_unsup_c.ini --ex kitti_c \\
      --set packed_dir=data/packed/kitti_320x1152 --set eval_interval=1000

Rerunning an experiment resumes it from its latest checkpoint, under its
snapshot (``--config`` and ``--set`` are then ignored), on the batches an
uninterrupted run would have seen.

On several GPUs, one process each (``batch_size`` stays the global batch;
``--device cpu`` runs the processes on the CPU over gloo):

  torchrun --nproc-per-node 2 -m unflow_tpu_torch.cli.train --config ... --ex ...

With ``--set spatial_shards=S`` the processes form ``N / S`` data ranks of
``S`` spatial ranks each, which split the width of every frame (a multiple of
``64 * S``) into W-slabs:

  torchrun --nproc-per-node 4 -m unflow_tpu_torch.cli.train --config ... --ex ... \\
      --set spatial_shards=2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from unflow_tpu_torch.config import (
    _FIELD_TYPES,
    Config,
    _coerce,
    load_config,
    prepare_experiment_dir,
)
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION, get_dataset
from unflow_tpu_torch.data.base import Loader, load_example
from unflow_tpu_torch.data.packed import PackedExamples
from unflow_tpu_torch.data.synthetic import batch_iterator as synthetic_batches
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.evaluate import predict_flow
from unflow_tpu_torch.eval.metrics import flow_error_avg
from unflow_tpu_torch.parallel import (
    barrier,
    data_shard,
    init_distributed,
    init_grid,
    is_lead_process,
    local_device,
    per_process_batch_size,
    process_shard,
    reset_grid,
    spatial_shard,
)
from unflow_tpu_torch.train import CheckpointManager, Trainer

# A dataset without ground truth of its own is evaluated on another one during
# training, as the reference UnFlow recipe evaluates its KITTI raw training on
# the KITTI 2012 training pairs.
EVAL_DATASET = {"kitti_raw": "kitti_2012"}


def build_batches_and_norm(cfg: Config, start_batch: int = 0):
    """This process's host batch stream of ``cfg`` and its normalization. The
    stream is step-indexed: ``start_batch`` is the step a resumed run starts
    at. A dataset directory that does not exist raises here.

    ``batch_size`` is the global batch: under several processes each data
    rank loads its contiguous rows of every global batch (the union is the
    one-process stream), and the synthetic stream of data rank ``r`` is drawn
    from ``seed + r``, as in the JAX package. The ranks of a spatial group
    (``spatial_shards``) load the same rows."""
    t = cfg.train
    shard = data_shard()
    local_bs = per_process_batch_size(t.batch_size)
    if t.dataset == "synthetic":
        batches = synthetic_batches(
            local_bs, t.height, t.width, seed=t.seed + shard[0], supervised=t.supervised,
            start_batch=start_batch, num_threads=t.num_threads,
        )
        return batches, DEFAULT_NORMALIZATION
    ds_kwargs = {}
    if t.dataset == "kitti_raw" and t.max_frame_gap > 1:
        ds_kwargs["max_frame_gap"] = t.max_frame_gap
    dataset = get_dataset(t.dataset, cfg.dirs.data, **ds_kwargs)
    # a packed directory (cli.pack): a batch is a copy out of a memmap, not
    # a decode of every PNG
    examples = PackedExamples(t.packed_dir) if t.packed_dir else dataset.train_examples()
    loader = Loader(
        examples,
        batch_size=local_bs,
        load_hw=(t.height, t.width),
        supervised=t.supervised,
        seed=t.seed,
        num_threads=t.num_threads,
        mode=t.input_mode,
        shard=shard,
        start_batch=start_batch,
        # uint8 frames to the device; the train step converts f32/255 (exact)
        image_dtype="uint8" if t.input_mode == "crop_pad" else "float32",
    )
    return iter(loader), dataset.normalization


def build_eval_fn(cfg: Config, normalization, device: torch.device | str):
    """``eval_fn(model) -> {"aee": ...}`` for the Trainer, or None when
    ``eval_interval`` is 0 or there is nothing to evaluate on. Synthetic data
    is evaluated on one batch of 4 pairs of its own (seed + 999) against
    their known flow; a dataset on the first 4 examples of its eval split
    (of ``EVAL_DATASET``'s for one without ground truth), cropped or padded
    to the train geometry."""
    t = cfg.train
    if not t.eval_interval:
        return None
    if t.dataset == "synthetic":
        batch = next(synthetic_batches(4, t.height, t.width, seed=t.seed + 999, supervised=True))
    else:
        try:
            dataset = get_dataset(EVAL_DATASET.get(t.dataset, t.dataset), cfg.dirs.data)
            examples = dataset.eval_examples()[:4]
        except (ValueError, FileNotFoundError):
            return None
        items = [load_example(ex, (t.height, t.width), supervised=True) for ex in examples]
        batch = {k: np.stack([it[k] for it in items]) for k in ("im1", "im2", "flow", "mask")}
    im1, im2, gt, mask = (torch.from_numpy(batch[k]).to(device)
                          for k in ("im1", "im2", "flow", "mask"))

    def eval_fn(model) -> dict:
        with torch.inference_mode():
            flow = predict_flow(model, im1, im2, normalization)
            return {"aee": float(flow_error_avg(flow, gt, mask))}

    return eval_fn


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
    # under torchrun: join the group (unless the caller has); each process
    # then takes its own GPU
    joined = not torch.distributed.is_initialized() and init_distributed(device)
    multi = process_shard()[1] > 1
    device = local_device(device)
    lead = is_lead_process()
    ex_dir = cfg.experiment_dir(args.ex)
    snapshot = ex_dir / "config.ini"
    existed = snapshot.exists()
    barrier()  # every process decides fresh or resume before the lead writes
    if existed:
        # the snapshot governs a resumed experiment, as in the reference
        if lead and (args.config is not None or args.set):
            print(f"resuming {args.ex}: snapshot {snapshot} governs; "
                  "ignoring --config/--set overrides")
        cfg = load_config(snapshot)
    # the stream starts at the checkpointed step, so a resumed run sees the
    # batches an uninterrupted one would
    resume_step = CheckpointManager(ex_dir).latest_step() or 0
    init_grid(cfg.train.spatial_shards)  # the data shard the input stream loads
    # before the snapshot: a missing dataset writes nothing
    batches, norm = build_batches_and_norm(cfg, start_batch=resume_step)
    if not existed:
        if lead:
            prepare_experiment_dir(cfg, args.ex)
        if multi:  # every process trains the snapshot the lead wrote
            barrier()
            cfg = load_config(snapshot)
    if args.debug:
        # Run-mode clamp only, applied after the snapshot so a --debug run
        # does not bake tiny iteration counts into it.
        cfg.train.num_iters = min(cfg.train.num_iters, 10)
        cfg.train.display_interval = 1
        cfg.train.save_interval = 10

    trainer = Trainer(cfg, ex_dir, batches, normalization=norm, device=device,
                      eval_fn=build_eval_fn(cfg, norm, device))
    if lead:
        s = spatial_shard()[1]
        print(f"experiment {args.ex}: step {trainer.step} -> {cfg.train.num_iters}"
              + (f" on {process_shard()[1]} processes" if multi else "")
              + (f" ({data_shard()[1]} data x {s} spatial)" if s > 1 else ""))
    logs = trainer.run()
    if lead and "loss" in logs:
        print(f"done at step {trainer.step}: loss={logs['loss']:.5g}")
    elif lead:
        print(f"already complete at step {trainer.step}")
    if joined:
        reset_grid()
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
