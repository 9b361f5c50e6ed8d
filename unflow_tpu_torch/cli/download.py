"""Dataset bootstrap CLI: download and extract a dataset into ``dirs.data``.

Port of ``unflow_tpu/cli/download.py``. Training machines are often
air-gapped, so no entry point downloads by surprise; run this once instead:

  python -m unflow_tpu_torch.cli.download kitti_2015 --data-dir data
  python -m unflow_tpu_torch.cli.download all --data-dir data

Mirrors and other drive lists: ``unflow_tpu_torch.data.bootstrap.override_manifest``.
"""

from __future__ import annotations

import argparse
import sys

from unflow_tpu_torch.data.bootstrap import MANIFESTS, ensure_dataset


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "dataset",
        choices=sorted(MANIFESTS) + ["all"],
        help="dataset to fetch ('all' = every dataset with a direct URL)",
    )
    ap.add_argument("--data-dir", default="data")
    args = ap.parse_args(argv)

    names = (
        [n for n, m in sorted(MANIFESTS.items()) if m.archives]
        if args.dataset == "all"
        else [args.dataset]
    )
    rc = 0
    for name in names:
        try:
            root = ensure_dataset(name, args.data_dir, download=True)
            print(f"{name}: ready at {root}")
        except Exception as e:  # noqa: BLE001 - report and go on with the next
            print(f"{name}: FAILED — {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
