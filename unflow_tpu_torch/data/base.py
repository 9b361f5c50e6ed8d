"""Dataset base classes and the host-side prefetching loader.

A copy of ``unflow_tpu/data/base.py`` (``Example``, ``PairDataset``,
``fit_to_shape``, ``resize_to_shape``, ``load_example``, ``Loader``; numpy and
threads only). The loader decodes and stacks uniformly sized frame pairs on a
small thread pool, ahead of the train loop, in an order fixed by the seed;
the random crop, flip and photometric augmentation and the normalization run
on the device inside the train step (``unflow_tpu_torch.augment``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from unflow_tpu_torch.data.io import (
    read_flo,
    read_image,
    read_image_u8,
    read_kitti_png_flow,
)


@dataclass(frozen=True)
class Example:
    """One frame pair, optionally with ground truth.

    ``noc`` optionally points at a non-occluded-region source so eval can
    report occ/noc AEE breakdowns in one pass (reference: eval_gui's
    occluded/non-occluded metrics, SURVEY.md §2.2 P18):
    - ``noc_format="kitti_png"``: a KITTI ``flow_noc`` 16-bit PNG whose
      validity channel marks valid AND non-occluded pixels;
    - ``noc_format="occ_png"``: a Sintel ``occlusions/`` 8-bit mask where
      white (>0.5) = occluded.
    """

    im1: str
    im2: str
    flow: str | None = None  # .flo or KITTI 16-bit png
    flow_format: str = "flo"  # "flo" | "kitti_png"
    noc: str | None = None
    noc_format: str = "kitti_png"  # "kitti_png" | "occ_png"
    meta: dict = field(default_factory=dict)


class PairDataset:
    """Base: enumerates examples; subclasses know directory layouts."""

    name = "base"
    # Per-dataset mean (0..255 RGB) / stddev for input normalization
    # (reference: Input.get_normalization / per-dataset constants [MED]).
    normalization: tuple[tuple[float, float, float], float] = (
        (104.92, 110.18, 114.47), 60.0,
    )

    def __init__(self, data_dir: str | Path):
        self.data_dir = Path(data_dir)

    def train_examples(self) -> list[Example]:
        raise NotImplementedError

    def eval_examples(self, variant: str | None = None) -> list[Example]:
        raise NotImplementedError

    def _require(self, path: Path, hint: str) -> Path:
        if not path.exists():
            raise FileNotFoundError(
                f"{self.name}: expected {path}; place the dataset there (a "
                f"download command is not ported yet: ROADMAP item A13). {hint}"
            )
        return path


def fit_to_shape(im: np.ndarray, target_hw: tuple[int, int]) -> np.ndarray:
    """Center crop-or-pad to a fixed (H, W) (reference:
    Input._resize_crop_or_pad semantics, without resampling)."""
    th, tw = target_hw
    h, w = im.shape[:2]
    # crop
    if h > th:
        off = (h - th) // 2
        im = im[off : off + th]
    if w > tw:
        off = (w - tw) // 2
        im = im[:, off : off + tw]
    h, w = im.shape[:2]
    if h < th or w < tw:
        pad = [((th - h) // 2, th - h - (th - h) // 2),
               ((tw - w) // 2, tw - w - (tw - w) // 2)] + [(0, 0)] * (im.ndim - 2)
        im = np.pad(im, pad)
    return im


def resize_to_shape(
    im: np.ndarray, target_hw: tuple[int, int], is_flow: bool = False
) -> np.ndarray:
    """Bilinear resize to (H, W); flow fields get their vectors rescaled
    by the size ratio (reference: Input._resize_crop_or_pad resize mode
    + flow resizing in the supervised inputs [MED])."""
    th, tw = target_hw
    h, w = im.shape[:2]
    if (h, w) == (th, tw):
        return im
    # separable bilinear via np.interp on each axis (no PIL dependency
    # for multi-channel float arrays)
    yi = np.linspace(0.0, h - 1.0, th)
    xi = np.linspace(0.0, w - 1.0, tw)
    y0 = np.floor(yi).astype(np.int64)
    x0 = np.floor(xi).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (yi - y0).astype(im.dtype)[:, None, None]
    wx = (xi - x0).astype(im.dtype)[None, :, None]
    rows0 = im[y0]
    rows1 = im[y1]
    top = rows0[:, x0] * (1 - wx) + rows0[:, x1] * wx
    bot = rows1[:, x0] * (1 - wx) + rows1[:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if is_flow:
        out = out * np.asarray([tw / w, th / h], out.dtype)
    return out


def load_example(
    ex: Example,
    target_hw: tuple[int, int] | None,
    supervised: bool,
    mode: str = "crop_pad",
    image_dtype: str = "float32",
):
    """Decode one example. image_dtype='uint8' keeps frames as raw uint8
    (the train step converts to f32/255 on the device — bit-identical
    and ~4x less host work/transfer); requires mode='crop_pad' since the
    host-side bilinear resize needs float frames."""
    if image_dtype == "uint8":
        if mode == "resize":
            raise ValueError("image_dtype='uint8' requires mode='crop_pad'")
        im1 = read_image_u8(ex.im1)
        im2 = read_image_u8(ex.im2)
    else:
        im1 = read_image(ex.im1)
        im2 = read_image(ex.im2)
    out = {}
    if supervised:
        if ex.flow is None:
            raise ValueError(f"example has no ground truth: {ex.im1}")
        if ex.flow_format == "kitti_png":
            flow, valid = read_kitti_png_flow(ex.flow)
        else:
            flow = read_flo(ex.flow)
            valid = np.ones(flow.shape[:2] + (1,), np.float32)
        out["flow"], out["mask"] = flow, valid
        if ex.noc is not None:
            if ex.noc_format == "kitti_png":
                _, noc_valid = read_kitti_png_flow(ex.noc)
                out["noc_mask"] = valid * noc_valid
            elif ex.noc_format == "occ_png":
                occ = read_image(ex.noc)
                out["noc_mask"] = valid * (occ[..., :1] < 0.5).astype(np.float32)
            else:
                raise ValueError(f"unknown noc format {ex.noc_format!r}")
    if target_hw is not None:
        if mode == "resize":
            im1 = resize_to_shape(im1, target_hw)
            im2 = resize_to_shape(im2, target_hw)
            if supervised:
                out["flow"] = resize_to_shape(out["flow"], target_hw, is_flow=True)
                # nearest-style validity: strict after bilinear
                out["mask"] = (
                    resize_to_shape(out["mask"], target_hw) > 0.999
                ).astype(np.float32)
                if "noc_mask" in out:
                    out["noc_mask"] = (
                        resize_to_shape(out["noc_mask"], target_hw) > 0.999
                    ).astype(np.float32)
        elif mode == "crop_pad":
            im1 = fit_to_shape(im1, target_hw)
            im2 = fit_to_shape(im2, target_hw)
            if supervised:
                out["flow"] = fit_to_shape(out["flow"], target_hw)
                out["mask"] = fit_to_shape(out["mask"], target_hw)
                if "noc_mask" in out:
                    out["noc_mask"] = fit_to_shape(out["noc_mask"], target_hw)
        else:
            raise ValueError(f"unknown load mode {mode!r}")
    out["im1"], out["im2"] = im1, im2
    return out


class Loader:
    """Threaded prefetching batch loader (replaces TF1 queue runners).

    Yields dict batches {'im1','im2'[,'flow','mask']} float32, stacked to
    ``(batch, H, W, C)`` at ``load_hw``. Deterministic given ``seed``:
    examples are shuffled per epoch with a per-epoch PRNG; worker threads
    decode *pre-assigned* indices so thread scheduling cannot reorder the
    stream (resume-safe, SURVEY.md §5 failure-detection row).
    """

    def __init__(
        self,
        examples: Sequence[Example],
        batch_size: int,
        load_hw: tuple[int, int],
        supervised: bool = False,
        shuffle: bool = True,
        seed: int = 0,
        num_threads: int = 4,
        prefetch: int = 2,
        loop: bool = True,
        mode: str = "crop_pad",
        image_dtype: str = "float32",
        shard: tuple[int, int] = (0, 1),
        start_batch: int = 0,
    ):
        if not len(examples):
            raise ValueError("empty example list")
        # Packed source (data/packed.py): batches come from a memmap
        # gather instead of the decode pool — keep the object as-is.
        self._packed = examples if hasattr(examples, "gather") else None
        if self._packed is not None:
            if tuple(self._packed.hw) != tuple(load_hw):
                raise ValueError(
                    f"packed dataset geometry {self._packed.hw} != "
                    f"requested load_hw {tuple(load_hw)}; re-pack"
                )
        self.examples = examples if self._packed is not None else list(examples)
        self.batch_size = batch_size
        self.load_hw = load_hw
        self.supervised = supervised
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        if prefetch < 1:
            # queue.Queue(maxsize=0) means UNBOUNDED — "no prefetch"
            # would silently become "materialize every batch ahead".
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.prefetch = prefetch
        self.loop = loop
        self.mode = mode
        self.image_dtype = image_dtype
        # Sharding across processes (several devices are ROADMAP item A13,
        # so the default (0, 1) is the only one used yet): every process runs
        # the SAME per-epoch shuffle (same seed), forms global batches of
        # batch_size * shard_count, and decodes only its contiguous slice
        # — so the union across hosts is exactly the single-host stream
        # and resume stays deterministic.
        index, count = shard
        if not (0 <= index < count):
            raise ValueError(f"bad shard {shard}")
        self.shard = (index, count)
        # Fail fast: with fewer examples than one global batch the
        # epoch loop would yield nothing (an infinite busy-spin when
        # loop=True, a silent empty stream otherwise).
        if len(examples) < batch_size * count:
            raise ValueError(
                f"{len(examples)} examples < one global batch "
                f"({batch_size} x {count} processes)"
            )
        # Deterministic resume: skip the first N GLOBAL batches (= train
        # steps) in O(1) — the per-epoch shuffles are pure functions of
        # (seed, epoch), so a resumed run sees exactly the stream an
        # uninterrupted run would (SURVEY §5 failure-detection row).
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.start_batch = start_batch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.examples))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _batch_indices(self) -> Iterator[np.ndarray]:
        """Deterministic stream of per-batch example indices (this
        process's slice of each global batch when sharded)."""
        index, count = self.shard
        global_bs = self.batch_size * count
        n_full = len(self.examples) // global_bs  # constant across epochs
        epoch, b0 = divmod(self.start_batch, n_full)
        while True:
            order = self._epoch_order(epoch)
            for b in range(b0, n_full):
                g = order[b * global_bs : (b + 1) * global_bs]
                yield g[index * self.batch_size : (index + 1) * self.batch_size]
            b0 = 0
            if not self.loop:
                return
            epoch += 1

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def safe_put(item) -> bool:
            """put() that observes the stop event, so an abandoned
            iterator can never leave the producer blocked forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer_packed():
            """Memmap-gather path: no decode pool, one prefetch thread
            overlapping the batch memcpy with the device step."""
            batches = self._batch_indices()
            try:
                while not stop.is_set():
                    sel = next(batches, None)
                    if sel is None:
                        safe_put(None)
                        return
                    batch = self._packed.gather(sel, self.supervised)
                    if self.image_dtype == "float32":
                        for k in ("im1", "im2"):
                            batch[k] = batch[k].astype(np.float32) / 255.0
                    if not safe_put(batch):
                        return
            except Exception as e:
                safe_put(e)

        def producer():
            from concurrent.futures import ThreadPoolExecutor
            import collections

            batches = self._batch_indices()
            try:
                with ThreadPoolExecutor(
                    max_workers=max(1, self.num_threads)
                ) as pool:
                    # Futures are submitted AND consumed in batch order:
                    # thread scheduling parallelizes the decodes but can
                    # never reorder the stream (resume determinism).
                    pending: collections.deque = collections.deque()
                    window = self.prefetch + 1
                    while not stop.is_set():
                        while len(pending) < window:
                            sel = next(batches, None)
                            if sel is None:
                                break
                            pending.append(
                                [
                                    pool.submit(
                                        load_example,
                                        self.examples[i],
                                        self.load_hw,
                                        self.supervised,
                                        self.mode,
                                        self.image_dtype,
                                    )
                                    for i in sel
                                ]
                            )
                        if not pending:
                            safe_put(None)
                            return
                        items = [f.result() for f in pending.popleft()]
                        # Keys common to EVERY item: optional fields
                        # (noc_mask exists only where the file does) must
                        # not crash the stack when a batch mixes
                        # examples, nor depend on which example lands at
                        # index 0.
                        keys = set(items[0])
                        for it in items[1:]:
                            keys &= set(it)
                        batch = {
                            k: np.stack([it[k] for it in items]) for k in keys
                        }
                        if not safe_put(batch):
                            return
            except Exception as e:  # propagate decode errors to the consumer
                safe_put(e)

        thread = threading.Thread(
            target=producer_packed if self._packed is not None else producer,
            daemon=True,
        )
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
