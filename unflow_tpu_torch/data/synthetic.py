"""Synthetic moving-texture pairs (training smoke runs, tests, benches).

A copy of ``unflow_tpu/data/synthetic.py`` (numpy only): ``make_pair``, the
infinite batch stream ``batch_iterator``, and the fixed corpus ``make_corpus``
(cached as ``.npy``) with its epoch iterator ``corpus_iterator``, which the
held-out acceptance run (``unflow_tpu_torch.heldout``) trains on.

* **Texture**: multi-octave smooth noise (bilinearly interpolated random
  grids at dyadic scales, amplitudes decaying with frequency), so the image
  gradient is nonzero at every pixel: coarse octaves widen the photometric
  basin of attraction, fine octaves feed the census transform.
* **Motion**: per example a similarity transform (translation + rotation +
  zoom) about the image center, a smooth non-constant flow with subpixel
  values (``mode="affine"``, the default); ``mode="translate"`` is a global
  integer shift, whose warp is exact.

Frame 2 is rendered by inverse-mapping into a margin-extended texture canvas
(``im2(q) = canvas(T^-1(q))``), so both frames sample the same scene and the
ground-truth forward flow is ``T(p) - p`` exactly.
"""

from __future__ import annotations

import numpy as np

# Octaves for the smooth texture: (grid cell size in px, amplitude).
# Rough 1/f decay; the scale-1 octave is per-pixel detail for census.
_OCTAVES = ((64, 1.0), (32, 0.8), (16, 0.6), (8, 0.45), (4, 0.3),
            (2, 0.2), (1, 0.12))


def _bilinear(img: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Sample img (H, W, C) at float coords (broadcastable y, x), clamped."""
    h, w = img.shape[:2]
    y = np.clip(y, 0.0, h - 1.0)
    x = np.clip(x, 0.0, w - 1.0)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (y - y0).astype(np.float32)[..., None]
    fx = (x - x0).astype(np.float32)[..., None]
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _lerp_index(n: int, scale: int):
    """Cached 1D linear-interp indices/weights for regular upsampling."""
    key = (n, scale)
    cached = _LERP_CACHE.get(key)
    if cached is None:
        pos = np.arange(n, dtype=np.float32) / scale
        i0 = np.floor(pos).astype(np.int64)
        f = (pos - i0).astype(np.float32)
        cached = _LERP_CACHE[key] = (i0, f)
    return cached


_LERP_CACHE: dict = {}


def _upsample(grid: np.ndarray, h: int, w: int, scale: int) -> np.ndarray:
    """Separable bilinear upsample of a regular grid by integer scale."""
    iy, fy = _lerp_index(h, scale)
    ix, fx = _lerp_index(w, scale)
    rows = grid[iy] * (1 - fy)[:, None, None] + grid[iy + 1] * fy[:, None, None]
    return rows[:, ix] * (1 - fx)[None, :, None] + rows[:, ix + 1] * fx[None, :, None]


def _texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Smooth multi-octave random RGB texture in [0, 1].

    Content at every frequency: each octave is a random grid bilinearly
    upsampled by its cell size, so image gradients are nonzero almost
    everywhere (unlike kron blocks, which are flat inside each cell).
    """
    im = np.zeros((h, w, 3), np.float32)
    total = 0.0
    for scale, amp in _OCTAVES:
        if scale == 1:
            layer = rng.rand(h, w, 3).astype(np.float32)
        else:
            gh = (h - 1) // scale + 2
            gw = (w - 1) // scale + 2
            grid = rng.rand(gh, gw, 3).astype(np.float32)
            layer = _upsample(grid, h, w, scale)
        im += amp * layer
        total += amp
    return im / total


def make_pair(
    rng: np.random.RandomState,
    h: int,
    w: int,
    max_shift: float = 8.0,
    mode: str = "affine",
):
    """Returns (im1, im2, flow) with exact ground-truth forward flow.

    mode="affine" (default): similarity motion (translation + rotation
    + zoom about the image center); parameters are scaled so the max
    displacement anywhere in-frame stays within ~max_shift px.
    mode="translate": global integer (u, v) shift, |u|,|v| <= max_shift
    (bit-exact warp — im2 is a shifted crop of the same canvas).
    """
    margin = int(np.ceil(max_shift)) + 2
    canvas = _texture(rng, h + 2 * margin, w + 2 * margin)
    m = float(margin)

    if mode == "translate":
        u = int(rng.randint(-int(max_shift), int(max_shift) + 1))
        v = int(rng.randint(-int(max_shift), int(max_shift) + 1))
        mi = int(margin)
        im1 = canvas[mi : mi + h, mi : mi + w]
        # Forward flow (u, v): pixel p in frame1 moves to p + (u, v) in
        # frame2, i.e. im2[y, x] = im1[y - v, x - u].
        im2 = canvas[mi - v : mi - v + h, mi - u : mi - u + w]
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0], flow[..., 1] = u, v
        return im1, np.ascontiguousarray(im2), flow

    if mode != "affine":
        raise ValueError(f"unknown synthetic motion mode {mode!r}")

    # Similarity transform T about the image center c (frame1 -> frame2
    # coords): T(p) = c + t + s * R(theta) @ (p - c).
    # Budget: |t| contributes up to 0.6*max_shift per axis; rotation and
    # zoom each contribute up to ~0.2*max_shift at the farthest corner,
    # so total displacement stays within ~max_shift and T^-1 stays on
    # the margin-extended canvas.
    radius = 0.5 * float(np.hypot(h - 1, w - 1))
    t = (rng.rand(2).astype(np.float32) * 2.0 - 1.0) * (0.6 * max_shift)
    theta = (rng.rand() * 2.0 - 1.0) * (0.2 * max_shift / radius)
    zoom = 1.0 + (rng.rand() * 2.0 - 1.0) * (0.2 * max_shift / radius)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0

    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    dx, dy = xs - cx, ys - cy
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    # Forward map: where does frame1 pixel p land in frame2?
    fwd_x = cx + t[0] + zoom * (cos_t * dx - sin_t * dy)
    fwd_y = cy + t[1] + zoom * (sin_t * dx + cos_t * dy)
    flow = np.stack([fwd_x - xs * np.ones_like(ys),
                     fwd_y - ys * np.ones_like(xs)], axis=-1).astype(np.float32)

    # Frame 1 is the center crop of the canvas (exact grid samples).
    mi = int(margin)
    im1 = canvas[mi : mi + h, mi : mi + w]
    # Frame 2: im2(q) = canvas(T^-1(q) + margin). Inverse of a
    # similarity: p = c + R(-theta) @ (q - c - t) / zoom.
    inv_dx = (xs - cx - t[0]) * np.ones_like(ys)
    inv_dy = (ys - cy - t[1]) * np.ones_like(xs)
    inv_x = cx + (cos_t * inv_dx + sin_t * inv_dy) / zoom
    inv_y = cy + (-sin_t * inv_dx + cos_t * inv_dy) / zoom
    im2 = _bilinear(canvas, inv_y + m, inv_x + m).astype(np.float32)
    return np.ascontiguousarray(im1), im2, flow


def _make_batch(index, batch_size, height, width, seed, supervised, max_shift,
                mode):
    """Batch ``index`` of the stream — a pure function of (seed, index)."""
    rng = np.random.RandomState((seed * 1_000_003 + index) % (2**32))
    im1s, im2s, flows = [], [], []
    for _ in range(batch_size):
        im1, im2, flow = make_pair(rng, height, width, max_shift, mode=mode)
        im1s.append(im1)
        im2s.append(im2)
        flows.append(flow)
    batch = {
        "im1": np.stack(im1s),
        "im2": np.stack(im2s),
    }
    if supervised:
        batch["flow"] = np.stack(flows)
        batch["mask"] = np.ones((batch_size, height, width, 1), np.float32)
    return batch


def make_corpus(
    n_pairs: int,
    height: int,
    width: int,
    seed: int = 0,
    max_shift: float = 8.0,
    mode: str = "affine",
    cache_dir: str | None = None,
    dtype: str = "float32",
):
    """Generate (or load from cache) a FIXED corpus of ``n_pairs`` pairs.

    Pair ``i`` is a pure function of (seed, i) (same keying scheme as the
    stream's batches, but per-pair), so the corpus is reproducible across
    processes. With ``cache_dir`` the arrays are persisted as ``.npy``
    (a ``DONE`` marker is written last) and memory-mapped on reload, so a
    resumed segment pays the file opens, not the regeneration.

    dtype="uint8" stores frames quantized to 8 bits (flow stays f32);
    the train step converts back with f32/255 on the device. This matches
    real corpora (KITTI PNGs are 8-bit) and quarters the host->device
    copy.

    Returns dict of arrays: im1/im2 (n, h, w, 3), flow (n, h, w, 2) f32.
    """
    if dtype not in ("float32", "uint8"):
        raise ValueError(f"unsupported corpus dtype {dtype!r}")
    names = ("im1", "im2", "flow")
    if cache_dir is not None:
        import os

        tag = (f"synth_{mode}_{height}x{width}_n{n_pairs}_s{seed}"
               f"_ms{max_shift:g}_{dtype}")
        d = os.path.join(cache_dir, tag)
        done = os.path.join(d, "DONE")
        if os.path.exists(done):
            return {k: np.load(os.path.join(d, f"{k}.npy"), mmap_mode="r")
                    for k in names}
        os.makedirs(d, exist_ok=True)

    im_dt = np.uint8 if dtype == "uint8" else np.float32
    im1 = np.empty((n_pairs, height, width, 3), im_dt)
    im2 = np.empty((n_pairs, height, width, 3), im_dt)
    flow = np.empty((n_pairs, height, width, 2), np.float32)
    for i in range(n_pairs):
        rng = np.random.RandomState((seed * 1_000_003 + i) % (2**32))
        a, b, f = make_pair(rng, height, width, max_shift, mode=mode)
        if dtype == "uint8":
            a = np.round(a * 255.0).astype(np.uint8)
            b = np.round(b * 255.0).astype(np.uint8)
        im1[i], im2[i], flow[i] = a, b, f
    corpus = {"im1": im1, "im2": im2, "flow": flow}
    if cache_dir is not None:
        for k in names:
            np.save(os.path.join(d, f"{k}.npy"), corpus[k])
        with open(done, "w") as f:
            f.write("ok\n")
    return corpus


def corpus_iterator(
    batch_size: int,
    height: int,
    width: int,
    n_pairs: int,
    seed: int = 0,
    supervised: bool = False,
    max_shift: float = 8.0,
    start_batch: int = 0,
    mode: str = "affine",
    cache_dir: str | None = None,
    dtype: str = "float32",
):
    """Epoch iterator over a fixed ``n_pairs`` corpus (vs the infinite
    fresh-pair stream of :func:`batch_iterator`).

    This is the analog of the reference's training regime — a finite
    KITTI-raw corpus cycled for many epochs — and it decouples training
    throughput from the host renderer: pairs are generated once (then
    disk-cached), so steady-state feeding is a memmap gather.

    Deterministic + step-indexed: batch ``i`` draws indices from a
    per-epoch permutation keyed on (seed, epoch), so resume at
    ``start_batch`` reproduces the uninterrupted stream exactly.
    Requires ``n_pairs % batch_size == 0`` to keep epoch boundaries
    aligned with batches.
    """
    if n_pairs % batch_size:
        raise ValueError(f"n_pairs={n_pairs} not divisible by "
                         f"batch_size={batch_size}")
    corpus = make_corpus(n_pairs, height, width, seed, max_shift, mode,
                         cache_dir=cache_dir, dtype=dtype)
    per_epoch = n_pairs // batch_size
    mask = np.ones((batch_size, height, width, 1), np.float32)
    index = start_batch
    perm_epoch, perm = -1, None
    while True:
        epoch, offset = divmod(index, per_epoch)
        if epoch != perm_epoch:
            perm = np.random.RandomState(
                (seed * 7_919 + epoch) % (2**32)).permutation(n_pairs)
            perm_epoch = epoch
        idx = perm[offset * batch_size:(offset + 1) * batch_size]
        batch = {"im1": np.ascontiguousarray(corpus["im1"][idx]),
                 "im2": np.ascontiguousarray(corpus["im2"][idx])}
        if supervised:
            batch["flow"] = np.ascontiguousarray(corpus["flow"][idx])
            batch["mask"] = mask
        yield batch
        index += 1


def batch_iterator(
    batch_size: int,
    height: int,
    width: int,
    seed: int = 0,
    supervised: bool = False,
    max_shift: float = 8.0,
    start_batch: int = 0,
    mode: str = "affine",
    num_threads: int = 0,
):
    """Infinite iterator of host batches for the Trainer.

    Batch i derives from (seed, i) alone, so a run that starts at
    ``start_batch`` sees exactly the stream an uninterrupted run would.

    num_threads > 0: generate up to 2*num_threads batches ahead on a
    thread pool (numpy releases the GIL), yielding strictly in index
    order — the stream is bit-identical to the synchronous one. Use for
    training runs, where host generation would otherwise serialize with
    the device step.
    """
    args = (batch_size, height, width, seed, supervised, max_shift, mode)
    if num_threads <= 0:
        index = start_batch
        while True:
            yield _make_batch(index, *args)
            index += 1
        return

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(num_threads)
    depth = 2 * num_threads
    next_submit = start_batch
    pending: dict[int, object] = {}
    index = start_batch
    try:
        while True:
            while next_submit < index + depth:
                pending[next_submit] = pool.submit(_make_batch, next_submit, *args)
                next_submit += 1
            yield pending.pop(index).result()
            index += 1
    finally:
        # No `with`: generator finalization can run during interpreter
        # shutdown, where Executor.__exit__'s thread join explodes.
        pool.shutdown(wait=False, cancel_futures=True)
