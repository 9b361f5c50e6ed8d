"""Flow-format and image IO (PIL + numpy).

Copy of ``unflow_tpu/data/io.py`` without its optional native decoder.
Formats:
  * ``.flo`` (Middlebury/Sintel/FlyingChairs): TAG float 202021.25
    ("PIEH"), int32 width/height, float32 (u, v) interleaved.
  * KITTI 16-bit PNG flow: channels (u, v, valid) with
    ``flow = (uint16 - 2^15) / 64``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
from PIL import Image

from unflow_tpu_torch.data.png16 import read_png16, write_png16

FLO_TAG = 202021.25


def read_image(path: str | Path) -> np.ndarray:
    """Decode an image to float32 RGB in [0, 1], (H, W, 3)."""
    with Image.open(str(path)) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0


def read_image_u8(path: str | Path) -> np.ndarray:
    """Decode an image to uint8 RGB (H, W, 3), without the float conversion:
    the train step converts ``u8 / 255`` (exact in float32) on the device,
    at a quarter of the bytes copied there."""
    with Image.open(str(path)) as img:
        return np.asarray(img.convert("RGB"))


def write_image(path: str | Path, im: np.ndarray) -> None:
    arr = np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(str(path))


def read_flo(path: str | Path) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        tag = struct.unpack("<f", f.read(4))[0]
        if abs(tag - FLO_TAG) > 1e-3:
            raise ValueError(f"{path}: bad .flo tag {tag}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str | Path, flow: np.ndarray) -> None:
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"flow must have 2 channels, got {c}")
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_TAG))
        f.write(struct.pack("<ii", w, h))
        f.write(flow.astype("<f4").tobytes())


def read_kitti_png_flow(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit PNG -> ((H, W, 2) flow, (H, W, 1) valid mask).

    Pillow truncates 16-bit RGB PNGs to 8 bits, so this uses the numpy
    codec of :mod:`unflow_tpu_torch.data.png16`.
    """
    arr = read_png16(path)
    if arr.ndim != 3 or arr.shape[-1] < 3:
        raise ValueError(f"{path}: expected 3-channel 16-bit PNG, got {arr.shape}")
    flow = (arr[..., :2].astype(np.float32) - 2.0**15) / 64.0
    valid = (arr[..., 2:3] > 0).astype(np.float32)
    flow = flow * valid  # invalid px carry no flow
    return flow, valid


def write_kitti_png_flow(
    path: str | Path, flow: np.ndarray, valid: np.ndarray | None = None
) -> None:
    h, w, _ = flow.shape
    if valid is None:
        valid = np.ones((h, w, 1), np.float32)
    out = np.zeros((h, w, 3), np.uint16)
    # Round to nearest (the devkit's uint16() rounds): a bare cast would
    # floor, biasing every stored value by up to -1/64 px.
    quant = np.clip(np.round(flow * 64.0 + 2.0**15), 0, 2**16 - 1)
    out[..., :2] = quant.astype(np.uint16)
    out[..., 2] = (valid[..., 0] > 0).astype(np.uint16)
    write_png16(path, out)


def pad_to_multiple(im: np.ndarray, multiple: int = 64) -> tuple[np.ndarray, tuple]:
    """Zero-pad H and W up to a multiple (FlowNet needs /64); returns
    (padded, (orig_h, orig_w)) for cropping back."""
    h, w = im.shape[:2]
    ph = -h % multiple
    pw = -w % multiple
    if ph == 0 and pw == 0:
        return im, (h, w)
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (im.ndim - 2)
    return np.pad(im, pad), (h, w)
