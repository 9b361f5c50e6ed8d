"""The port's native decode sidecar (``unflow_tpu_torch/data/native``) against
the JAX package's sidecar and the port's PIL / numpy path, bit for bit:
every case of ``tests/test_native_loader.py``; then ``UNFLOW_NATIVE=1``
through ``data/io.py`` and a ``Loader`` epoch, and a build that fails."""

import numpy as np
import pytest
import torch
from PIL import Image

from unflow_tpu.data import native as native_jax
from unflow_tpu_torch.data import native
from unflow_tpu_torch.data.base import Example, Loader
from unflow_tpu_torch.data.io import (
    read_image,
    read_kitti_png_flow,
    write_image,
    write_kitti_png_flow,
)
from unflow_tpu_torch.data.png16 import read_png16, write_png16

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _built():
    native.load()  # g++ and zlib's headers are here: a failed build raises with its output


def _pil_read(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0


def _jax(fn, *args, **kwargs):
    """The JAX package's sidecar on the same input, where it builds."""
    if not native_jax.available():
        return None
    return getattr(native_jax, fn)(*args, **kwargs)


def test_decode_rgb_matches_pil(tmp_path, rng):
    write_image(tmp_path / "a.png", rng.rand(23, 37, 3).astype(np.float32))
    got = native.decode_rgb(tmp_path / "a.png")
    np.testing.assert_array_equal(got, _pil_read(tmp_path / "a.png"))
    theirs = _jax("decode_rgb", str(tmp_path / "a.png"))
    if theirs is not None:
        np.testing.assert_array_equal(got, theirs)


def test_decode_rgb_grayscale(tmp_path, rng):
    arr = (rng.rand(11, 13) * 255).astype(np.uint8)
    Image.fromarray(arr, mode="L").save(tmp_path / "g.png")
    got = native.decode_rgb(tmp_path / "g.png")
    assert got.shape == (11, 13, 3)
    np.testing.assert_array_equal(got[..., 0], arr.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got[..., 0], got[..., 1])
    np.testing.assert_array_equal(got, _pil_read(tmp_path / "g.png"))


def test_decode_kitti_flow_matches_python(tmp_path, rng, monkeypatch):
    flow = (rng.randn(17, 19, 2) * 20).astype(np.float32)
    valid = (rng.rand(17, 19, 1) > 0.3).astype(np.float32)
    write_kitti_png_flow(tmp_path / "f.png", flow, valid)
    got_flow, got_valid = native.decode_kitti_flow(tmp_path / "f.png")
    monkeypatch.delenv("UNFLOW_NATIVE", raising=False)
    want_flow, want_valid = read_kitti_png_flow(tmp_path / "f.png")
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got_flow, want_flow)
    np.testing.assert_allclose(got_flow, flow * valid, atol=1.0 / 64 + 1e-6)
    theirs = _jax("decode_kitti_flow", str(tmp_path / "f.png"))
    if theirs is not None:
        np.testing.assert_array_equal(got_flow, theirs[0])
        np.testing.assert_array_equal(got_valid, theirs[1])


def test_png_shape(tmp_path, rng):
    arr = rng.randint(0, 2**16, (9, 15, 3)).astype(np.uint16)
    write_png16(tmp_path / "x.png", arr)
    assert native.png_shape(tmp_path / "x.png") == (9, 15, 3, 16)
    assert read_png16(tmp_path / "x.png").shape == (9, 15, 3)
    if native_jax.available():
        assert native_jax.png_shape(tmp_path / "x.png") == (9, 15, 3, 16)


def test_batch_decode(tmp_path, rng):
    paths = []
    for i in range(6):
        write_image(tmp_path / f"{i}.png", rng.rand(16, 24, 3).astype(np.float32))
        paths.append(str(tmp_path / f"{i}.png"))
    batch = native.decode_rgb_batch(paths, 16, 24, num_threads=3)
    assert batch.shape == (6, 16, 24, 3)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(batch[i], _pil_read(p))
    theirs = _jax("decode_rgb_batch", paths, 16, 24, num_threads=3)
    if theirs is not None:
        np.testing.assert_array_equal(batch, theirs)


def test_corrupt_file_raises(tmp_path):
    (tmp_path / "bad.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        native.decode_rgb(tmp_path / "bad.png")
    with pytest.raises(ValueError):
        native.png_shape(tmp_path / "missing.png")


def test_unflow_native_reads_through_the_sidecar(tmp_path, rng, monkeypatch):
    """``UNFLOW_NATIVE=1``: ``read_image`` and ``read_kitti_png_flow`` go
    through the sidecar and return what the PIL / numpy path returns."""
    write_image(tmp_path / "a.png", rng.rand(10, 14, 3).astype(np.float32))
    write_kitti_png_flow(tmp_path / "f.png", (rng.randn(10, 14, 2) * 5).astype(np.float32),
                         (rng.rand(10, 14, 1) > 0.5).astype(np.float32))
    monkeypatch.delenv("UNFLOW_NATIVE", raising=False)
    plain = read_image(tmp_path / "a.png"), read_kitti_png_flow(tmp_path / "f.png")
    calls = []
    for name in ("decode_rgb", "decode_kitti_flow"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    monkeypatch.setenv("UNFLOW_NATIVE", "1")
    im, (flow, valid) = read_image(tmp_path / "a.png"), read_kitti_png_flow(tmp_path / "f.png")
    assert calls == ["decode_rgb", "decode_kitti_flow"]
    np.testing.assert_array_equal(im, plain[0])
    np.testing.assert_array_equal(flow, plain[1][0])
    np.testing.assert_array_equal(valid, plain[1][1])


def test_loader_epoch_is_the_same_with_the_sidecar(tmp_path, rng, monkeypatch):
    examples = []
    for i in range(6):
        write_image(tmp_path / f"{i}.png", rng.rand(12, 20, 3).astype(np.float32))
        write_kitti_png_flow(tmp_path / f"{i}_f.png", (rng.randn(12, 20, 2) * 3).astype(np.float32))
        examples.append(Example(im1=str(tmp_path / f"{i}.png"),
                                im2=str(tmp_path / f"{(i + 1) % 6}.png"),
                                flow=str(tmp_path / f"{i}_f.png"), flow_format="kitti_png"))

    def epoch():
        loader = Loader(examples, batch_size=2, load_hw=(12, 20), supervised=True, seed=3,
                        loop=False, num_threads=2)
        return list(loader)

    monkeypatch.delenv("UNFLOW_NATIVE", raising=False)
    plain = epoch()
    monkeypatch.setenv("UNFLOW_NATIVE", "1")
    mine = epoch()
    assert len(mine) == len(plain) == 3
    for a, b in zip(mine, plain):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_failed_build_raises_with_the_compiler_output(tmp_path, rng, monkeypatch):
    broken = tmp_path / "loader.cc"
    broken.write_text("int unflow_png_shape( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    write_image(tmp_path / "a.png", rng.rand(4, 4, 3).astype(np.float32))
    monkeypatch.setenv("UNFLOW_NATIVE", "1")
    with pytest.raises(native.NativeCompileError, match="error"):
        read_image(tmp_path / "a.png")
    assert not native.available()
    with pytest.raises(native.NativeCompileError, match="no-such-compiler"):
        native.build(compiler="no-such-compiler")
