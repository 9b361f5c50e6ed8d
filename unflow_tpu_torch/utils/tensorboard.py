"""Dependency-free TensorBoard event writer (tfevents scalars and images).

A copy of ``unflow_tpu/utils/tensorboard.py`` (the port imports nothing of
the JAX package). The tfevents container is written directly: TFRecord
framing (length and masked CRC32C) around hand-encoded ``tensorflow.Event``
protobufs, of the three shapes TensorBoard needs (file_version, a scalar
Value, an image Value).

Wire format:
- TFRecord: ``uint64 len | uint32 masked_crc(len) | data |
  uint32 masked_crc(data)``, CRC32C (Castagnoli), masked as
  ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.
- Event proto: 1=wall_time(double), 2=step(int64), 3=file_version(str),
  5=summary(Summary). Summary: 1=repeated Value. Value: 1=tag(str),
  2=simple_value(float), 4=image(Image). Image: 1=height, 2=width,
  3=colorspace (3=RGB), 4=encoded_image_string (PNG bytes).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

import numpy as np


def _crc32c_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _crc32c_np(data: bytes, crc: int = 0, lanes: int = 1024) -> int:
    """CRC32C with numpy, for payloads of megabytes, where the per-byte loop
    of :func:`_crc32c_py` takes seconds.

    The CRC register is linear over GF(2): the data is cut into ``lanes``
    runs of ``L`` bytes, each run's register (from 0) is computed in
    lock-step across the runs, and the runs are chained with the 32x32 matrix
    that ``L`` zero bytes apply to a register (its columns come from 32 more
    lanes, started at the unit registers, over zero bytes)."""
    n = len(data)
    lanes = min(lanes, n // 64)
    if lanes < 16:
        return _crc32c_py(data, crc)
    run = n // lanes
    table = np.array(_TABLE, np.uint32)
    cols = np.zeros((run, lanes + 32), np.uint8)
    cols[:, :lanes] = np.frombuffer(data, np.uint8, count=lanes * run).reshape(lanes, run).T
    regs = np.zeros(lanes + 32, np.uint32)
    regs[lanes:] = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for col in cols:
        regs = (regs >> np.uint32(8)) ^ table[(regs ^ col) & np.uint32(0xFF)]
    shift = [int(c) for c in regs[lanes:]]
    reg = crc ^ 0xFFFFFFFF
    for lane_reg in regs[:lanes].tolist():
        out = lane_reg
        for j in range(32):
            if reg >> j & 1:
                out ^= shift[j]
        reg = out
    for b in data[lanes * run:]:
        reg = (reg >> 8) ^ _TABLE[(reg ^ b) & 0xFF]
    return reg ^ 0xFFFFFFFF


try:
    # C implementation when available: the pure-Python per-byte loop
    # runs at a few MB/s, which stalls the train loop for seconds per
    # image-summary write (multi-MB PNG payloads).
    import google_crc32c as _gcrc

    def crc32c(data: bytes, crc: int = 0) -> int:
        return _gcrc.extend(crc, data)

except ImportError:
    crc32c = _crc32c_np


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _event(step: int | None = None, summary: bytes | None = None,
           file_version: str | None = None) -> bytes:
    parts = [_double_field(1, time.time())]
    if step is not None:
        parts.append(_varint_field(2, int(step)))
    if file_version is not None:
        parts.append(_bytes_field(3, file_version.encode()))
    if summary is not None:
        parts.append(_bytes_field(5, summary))
    return b"".join(parts)


def _encode_png(im: np.ndarray, compress_level: int = 6) -> bytes:
    """(H, W, 3) float [0,1] or uint8 -> PNG bytes (via PIL; level 6 is
    PIL's default, 1 takes half its time for a few per cent more bytes)."""
    import io

    from PIL import Image

    if im.dtype != np.uint8:
        im = (np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="PNG", compress_level=compress_level)
    return buf.getvalue()


class EventWriter:
    """Append-only tfevents file under ``logdir`` (TensorBoard-readable).

    Usage: ``w = EventWriter(dir); w.scalar("loss", 1.2, step=10);
    w.image("flow", rgb, step=10); w.close()``.
    """

    def __init__(self, logdir: str | Path):
        self._dir = Path(logdir)
        self._dir.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._file = open(self._dir / name, "ab")
        self._record(_event(file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        value_msg = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
        self._record(_event(step=step, summary=_bytes_field(1, value_msg)))

    def scalars(self, metrics: dict, step: int) -> None:
        for tag, value in metrics.items():
            try:
                self.scalar(tag, float(value), step)
            except (TypeError, ValueError):
                continue  # non-numeric metric; JSONL keeps it

    def image(self, tag: str, im: np.ndarray, step: int) -> None:
        """(H, W, 3) float [0,1] or uint8."""
        self.image_png(tag, _encode_png(np.asarray(im)), im.shape[0], im.shape[1], step)

    def image_png(self, tag: str, png: bytes, height: int, width: int, step: int) -> None:
        """An RGB image already encoded as PNG."""
        image_msg = (
            _varint_field(1, height)
            + _varint_field(2, width)
            + _varint_field(3, 3)
            + _bytes_field(4, png)
        )
        value_msg = _bytes_field(1, tag.encode()) + _bytes_field(4, image_msg)
        self._record(_event(step=step, summary=_bytes_field(1, value_msg)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def read_events(path: str | Path) -> list[dict]:
    """Minimal tfevents reader (CRC-checked) for tests and inspection.

    Returns one dict per event: {'step', 'wall_time', 'file_version'?,
    'scalars': {tag: value}, 'images': {tag: png_bytes}}.
    """
    events = []
    raw = Path(path).read_bytes()
    off = 0
    while off < len(raw):
        (length,) = struct.unpack_from("<Q", raw, off)
        header = raw[off : off + 8]
        (len_crc,) = struct.unpack_from("<I", raw, off + 8)
        if _masked_crc(header) != len_crc:
            raise ValueError(f"length CRC mismatch at offset {off}")
        data = raw[off + 12 : off + 12 + length]
        (data_crc,) = struct.unpack_from("<I", raw, off + 12 + length)
        if _masked_crc(data) != data_crc:
            raise ValueError(f"data CRC mismatch at offset {off}")
        events.append(_parse_event(data))
        off += 12 + length + 4
    return events


def _parse(buf: bytes):
    """Yield (field, wire, value) over one protobuf message."""
    off = 0
    while off < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[off]
            off += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            value = 0
            shift = 0
            while True:
                b = buf[off]
                off += 1
                value |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            value = struct.unpack_from("<d", buf, off)[0]
            off += 8
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[off]
                off += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            value = buf[off : off + ln]
            off += ln
        elif wire == 5:
            value = struct.unpack_from("<f", buf, off)[0]
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_event(data: bytes) -> dict:
    ev: dict = {"scalars": {}, "images": {}}
    for field, _, value in _parse(data):
        if field == 1:
            ev["wall_time"] = value
        elif field == 2:
            ev["step"] = value
        elif field == 3:
            ev["file_version"] = value.decode()
        elif field == 5:
            for vfield, _, vmsg in _parse(value):
                if vfield != 1:
                    continue
                tag, scalar, image = None, None, None
                for f2, _, v2 in _parse(vmsg):
                    if f2 == 1:
                        tag = v2.decode()
                    elif f2 == 2:
                        scalar = v2
                    elif f2 == 4:
                        for f3, _, v3 in _parse(v2):
                            if f3 == 4:
                                image = v3
                if tag is not None and scalar is not None:
                    ev["scalars"][tag] = scalar
                if tag is not None and image is not None:
                    ev["images"][tag] = image
    return ev


__all__ = ["EventWriter", "read_events", "crc32c"]
