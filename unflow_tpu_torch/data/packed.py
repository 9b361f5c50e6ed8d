"""Packed dataset format: decode once into a memmappable directory.

A copy of ``unflow_tpu/data/packed.py``; the two packages read and write one
format. Decoding a KITTI PNG pair costs the host more than a train step
leaves it, every epoch; packing pays the decode once, and a batch is then a
fancy-indexed copy out of a memmap.

Layout (one directory):
  ``header.json``  — {"version": 1, "n": N, "h": H, "w": W, "supervised": bool}
  ``frames.u8``    — uint8, shape (N, 2, H, W, 3), C-order (``.npy`` format)
  ``flow.f32``     — float32, (N, H, W, 2)   [supervised only]
  ``mask.u8``      — uint8,   (N, H, W, 1)   [supervised only]

Frames are stored center crop/padded to the training geometry (the random
crop, flip and photometric augmentation run on the device in the train step,
so the host-side geometry is fixed). uint8 frames are bit-exact with the
float path: the train step converts f32/255 on the device.

Usage:
  python -m unflow_tpu_torch.cli.pack --dataset kitti_raw --data-dir data \
      --out data/packed/kitti_320x1152 --height 320 --width 1152
  # or in code:
  pack_examples(examples, out_dir, load_hw=(320, 1152))
  loader = Loader(PackedExamples(out_dir), ...)     # drop-in source
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

from unflow_tpu_torch.data.base import Example, load_example

_HEADER = "header.json"
_FRAMES = "frames.u8"
_FLOW = "flow.f32"
_MASK = "mask.u8"


def pack_examples(
    examples: Sequence[Example],
    out_dir: str | Path,
    load_hw: tuple[int, int],
    supervised: bool = False,
    progress_every: int = 0,
) -> Path:
    """Decode ``examples`` once into a packed directory at ``out_dir``.

    Images are decoded to uint8 and center crop/padded to ``load_hw``;
    ground truth (when ``supervised``) keeps float32 flow + uint8 mask.
    Idempotent: re-packing overwrites.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(examples)
    if n == 0:
        raise ValueError("empty example list")
    h, w = load_hw
    frames = np.lib.format.open_memmap(
        out / _FRAMES, mode="w+", dtype=np.uint8, shape=(n, 2, h, w, 3)
    )
    flow = mask = None
    if supervised:
        flow = np.lib.format.open_memmap(
            out / _FLOW, mode="w+", dtype=np.float32, shape=(n, h, w, 2)
        )
        mask = np.lib.format.open_memmap(
            out / _MASK, mode="w+", dtype=np.uint8, shape=(n, h, w, 1)
        )
    for i, ex in enumerate(examples):
        item = load_example(
            ex, load_hw, supervised, mode="crop_pad", image_dtype="uint8"
        )
        frames[i, 0] = item["im1"]
        frames[i, 1] = item["im2"]
        if supervised:
            flow[i] = item["flow"]
            mask[i] = (item["mask"] > 0).astype(np.uint8)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"packed {i + 1}/{n}")
    frames.flush()
    if supervised:
        flow.flush()
        mask.flush()
    header = {
        "version": 1,
        "n": n,
        "h": h,
        "w": w,
        "supervised": supervised,
    }
    (out / _HEADER).write_text(json.dumps(header))
    return out


class PackedExamples:
    """Random-access view over a packed directory.

    Quacks like ``Sequence[Example]`` for the Loader (``len``, indexing)
    but each element resolves to in-memory arrays instead of paths; the
    Loader detects this and skips the decode pool entirely.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        hdr = json.loads((self.path / _HEADER).read_text())
        if hdr.get("version") != 1:
            raise ValueError(f"unsupported packed version: {hdr.get('version')}")
        self.n = hdr["n"]
        self.hw = (hdr["h"], hdr["w"])
        self.supervised = hdr["supervised"]
        self._frames = np.load(self.path / _FRAMES, mmap_mode="r")
        self._flow = self._mask = None
        if self.supervised:
            self._flow = np.load(self.path / _FLOW, mmap_mode="r")
            self._mask = np.load(self.path / _MASK, mmap_mode="r")

    def __len__(self) -> int:
        return self.n

    def gather(self, idx: np.ndarray, supervised: bool) -> dict:
        """Assemble a batch dict for example indices ``idx``.

        One fancy-indexed copy out of the memmap per tensor — the whole
        "decode" is a memcpy the OS page cache serves at memory bandwidth.
        """
        fr = self._frames[idx]  # (B, 2, h, w, 3) uint8 copy
        batch = {"im1": fr[:, 0], "im2": fr[:, 1]}
        if supervised:
            if not self.supervised:
                raise ValueError("packed dataset has no ground truth")
            batch["flow"] = np.asarray(self._flow[idx])
            batch["mask"] = self._mask[idx].astype(np.float32)
        return batch
