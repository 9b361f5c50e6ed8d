"""One-time dataset packing for the memmap input path.

Port of ``unflow_tpu/cli/pack.py``: decodes a dataset's training examples
once into the packed format of :mod:`unflow_tpu_torch.data.packed`, so that
training serves batches out of a memmap instead of decoding PNGs every
epoch. It needs no GPU.

  python -m unflow_tpu_torch.cli.pack --dataset kitti_raw --data-dir data \
      --out data/packed/kitti_320x1152 --height 320 --width 1152
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out", required=True, help="output packed directory")
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--supervised", action="store_true")
    ap.add_argument(
        "--max-frame-gap", type=int, default=1,
        help="kitti_raw temporal pairing gap (multiplies example count)",
    )
    args = ap.parse_args(argv)

    from unflow_tpu_torch.data import get_dataset
    from unflow_tpu_torch.data.packed import pack_examples

    kwargs = {}
    if args.dataset == "kitti_raw" and args.max_frame_gap > 1:
        kwargs["max_frame_gap"] = args.max_frame_gap
    dataset = get_dataset(args.dataset, args.data_dir, **kwargs)
    examples = dataset.train_examples()
    t0 = time.perf_counter()
    out = pack_examples(
        examples,
        args.out,
        (args.height, args.width),
        supervised=args.supervised,
        progress_every=200,
    )
    dt = time.perf_counter() - t0
    print(
        f"packed {len(examples)} examples -> {out} "
        f"({dt:.1f}s, {len(examples) / dt:.1f} ex/s). "
        f"Train with --set packed_dir={out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
