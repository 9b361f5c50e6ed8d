"""Port's data layer (unflow_tpu_torch/data) against the JAX package's: the
dataset loaders' example lists, ``load_example``, the threaded ``Loader``,
the packed format (one format in both packages), the fixed synthetic corpus
and the held-out set of the acceptance run, on fixture trees in ``tmp_path``."""

import dataclasses
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import unflow_tpu.data as data_jax
from unflow_tpu.data.base import load_example as load_example_jax
from unflow_tpu.data.io import pad_to_multiple as pad_to_multiple_jax
from unflow_tpu.data.io import read_image_u8 as read_image_u8_jax
from unflow_tpu.data.packed import PackedExamples as PackedExamplesJax
from unflow_tpu.data.packed import pack_examples as pack_examples_jax
from unflow_tpu.data.synthetic import corpus_iterator as corpus_iterator_jax
from unflow_tpu.data.synthetic import make_corpus as make_corpus_jax
from unflow_tpu_torch import data
from unflow_tpu_torch.data import Loader, get_dataset, load_example
from unflow_tpu_torch.data.io import (
    pad_to_multiple,
    read_image_u8,
    write_flo,
    write_image,
    write_kitti_png_flow,
)
from unflow_tpu_torch.data.kitti import _KITTI_RAW_DRIVES
from unflow_tpu_torch.data.packed import PackedExamples, pack_examples
from unflow_tpu_torch.data.synthetic import corpus_iterator, make_corpus
from unflow_tpu_torch.heldout import heldout_set, zero_flow_aee

torch.set_num_threads(1)

DRIVE = "2011_09_26_drive_0001"


def _im(rng, h=16, w=32):
    return rng.rand(h, w, 3).astype(np.float32)


def write_kitti_raw(root: Path, rng, n_frames=4, drive=DRIVE, hw=(16, 32)):
    d = root / "kitti_raw" / drive / "image_02" / "data"
    d.mkdir(parents=True)
    for i in range(n_frames):
        write_image(d / f"{i:010d}.png", _im(rng, *hw))


def write_kitti_flow(root: Path, rng, name="kitti_2012", n=2, hw=(16, 32), with_noc=True):
    """A KITTI 2012 (``colored_0``) or 2015 (``image_2``) training tree whose
    ``flow_noc`` is ``flow_occ`` with its lower half invalid."""
    image_dir = "colored_0" if name == "kitti_2012" else "image_2"
    base = root / name / "training"
    subs = (image_dir, "flow_occ") + (("flow_noc",) if with_noc else ())
    for sub in subs:
        (base / sub).mkdir(parents=True)
    h, w = hw
    for i in range(n):
        for suffix in ("10", "11"):
            write_image(base / image_dir / f"{i:06d}_{suffix}.png", _im(rng, h, w))
        flow = (rng.randn(h, w, 2) * 5).astype(np.float32)
        valid = (rng.rand(h, w, 1) > 0.1).astype(np.float32)
        write_kitti_png_flow(base / "flow_occ" / f"{i:06d}_10.png", flow, valid)
        if with_noc:
            noc = valid.copy()
            noc[h // 2:] = 0.0
            write_kitti_png_flow(base / "flow_noc" / f"{i:06d}_10.png", flow, noc)


def write_sintel(root: Path, rng, render_pass="clean", scenes=("alley_1", "bamboo_2"), n=3):
    base = root / "sintel" / "training"
    for scene in scenes:
        for sub in (f"{render_pass}/{scene}", f"flow/{scene}", f"occlusions/{scene}"):
            (base / sub).mkdir(parents=True, exist_ok=True)
        for i in range(1, n + 1):
            write_image(base / render_pass / scene / f"frame_{i:04d}.png", _im(rng))
        for i in range(1, n):
            write_flo(base / "flow" / scene / f"frame_{i:04d}.flo",
                      rng.randn(16, 32, 2).astype(np.float32))
        occ = np.zeros((16, 32, 3), np.float32)
        occ[:, 16:] = 1.0  # white: occluded
        write_image(base / "occlusions" / scene / "frame_0001.png", occ)


def write_chairs(root: Path, rng, n=3, split="1\n2\n1\n"):
    d = root / "chairs" / "data"
    d.mkdir(parents=True)
    for i in range(1, n + 1):
        for k in (1, 2):
            write_image(d / f"{i:05d}_img{k}.ppm", _im(rng, 8, 8))
        write_flo(d / f"{i:05d}_flow.flo", rng.randn(8, 8, 2).astype(np.float32))
    if split:
        (root / "chairs" / "FlyingChairs_train_val.txt").write_text(split)


def write_middlebury(root: Path, rng):
    for scene, gt in (("Grove2", True), ("Urban3", True), ("Army", False)):
        d = root / "middlebury" / "other-data" / scene
        d.mkdir(parents=True)
        for f in ("frame10.png", "frame11.png"):
            write_image(d / f, _im(rng, 8, 8))
        if gt:
            g = root / "middlebury" / "other-gt-flow" / scene
            g.mkdir(parents=True)
            write_flo(g / "flow10.flo", rng.randn(8, 8, 2).astype(np.float32))


def write_synthia(root: Path, rng):
    for seq in ("SEQ1", "SEQ2"):
        for cam in ("Omni_F", "Omni_B"):
            d = root / "synthia" / seq / "RGB" / "Stereo_Left" / cam
            d.mkdir(parents=True)
            for i in range(3):
                write_image(d / f"{i:06d}.png", _im(rng, 8, 8))


def write_mapping(root: Path, bench="kitti_2015", frame=10):
    mapping = root / bench / "devkit" / "mapping"
    mapping.mkdir(parents=True)
    (mapping / "train_mapping.txt").write_text(f"2011_09_26 {DRIVE} {frame:010d}\n\n")


def _asdicts(examples):
    return [dataclasses.asdict(e) for e in examples]


def _both(name, root, method, *args, **kwargs):
    """The examples of ``method`` from the port's and the JAX package's
    dataset ``name``, as dicts."""
    port = getattr(get_dataset(name, root, **kwargs), method)(*args)
    ref = getattr(data_jax.get_dataset(name, root, **kwargs), method)(*args)
    return _asdicts(port), _asdicts(ref)


def _tree_kitti_raw(root, rng):
    write_kitti_raw(root, rng, n_frames=30, hw=(8, 16))
    write_kitti_raw(root, rng, n_frames=5, drive="2011_09_28_drive_0002", hw=(8, 16))
    write_mapping(root)


def _tree_kitti_raw_file(root, rng):
    write_kitti_raw(root, rng, n_frames=8)
    (root / "exclude.txt").write_text(f"# comment\n{DRIVE} 2\n0000000006\n")


CASES = {
    # name: (fixture writer, dataset, method, method args, constructor kwargs)
    "kitti_raw_auto_exclusion": (_tree_kitti_raw, "kitti_raw", "train_examples", (),
                                 {"exclude_window": 5}),
    "kitti_raw_gap3": (_tree_kitti_raw, "kitti_raw", "train_examples", (),
                       {"exclude": "off", "max_frame_gap": 3}),
    "kitti_raw_exclude_file": (_tree_kitti_raw_file, "kitti_raw", "train_examples", (),
                               {"exclude_file": "exclude.txt", "exclude_window": 1}),
    "kitti_2012_train": (lambda r, g: write_kitti_flow(r, g, n=3), "kitti_2012", "train_examples",
                         (), {}),
    "kitti_2012_occ": (lambda r, g: write_kitti_flow(r, g, n=3), "kitti_2012", "eval_examples",
                       ("occ",), {}),
    "kitti_2012_noc": (lambda r, g: write_kitti_flow(r, g, n=3), "kitti_2012", "eval_examples",
                       ("noc",), {}),
    "kitti_2015_occ": (lambda r, g: write_kitti_flow(r, g, "kitti_2015"), "kitti_2015",
                       "eval_examples", (None,), {}),
    "kitti_2015_no_noc": (lambda r, g: write_kitti_flow(r, g, "kitti_2015", with_noc=False),
                          "kitti_2015", "eval_examples", ("occ",), {}),
    "sintel_clean_train": (write_sintel, "sintel", "train_examples", (), {}),
    "sintel_clean_eval": (write_sintel, "sintel", "eval_examples", (), {}),
    "sintel_final_eval": (lambda r, g: write_sintel(r, g, "final"), "sintel_final",
                          "eval_examples", (), {}),
    "chairs_train": (write_chairs, "chairs", "train_examples", (), {}),
    "chairs_eval": (write_chairs, "chairs", "eval_examples", (), {}),
    "chairs_no_split": (lambda r, g: write_chairs(r, g, split=""), "chairs", "eval_examples",
                        (), {}),
    "middlebury": (write_middlebury, "middlebury", "eval_examples", (), {}),
    "synthia": (write_synthia, "synthia", "train_examples", (), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_examples_match_jax(tmp_path, rng, monkeypatch, case):
    writer, name, method, args, kwargs = CASES[case]
    writer(tmp_path, rng)
    monkeypatch.chdir(tmp_path)  # exclude_file is relative
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref = _both(name, tmp_path, method, *args, **kwargs)
    assert port and port == ref
    if case == "kitti_raw_auto_exclusion":
        kept = {int(Path(e["im1"]).stem) for e in port if DRIVE in e["im1"]}
        assert kept == {0, 1, 2, 3} | set(range(16, 29)), sorted(kept)
    if case == "kitti_2012_occ":
        assert all(e["noc"] and e["noc"].endswith(Path(e["flow"]).name) for e in port)
    if case.startswith("sintel"):
        assert port[0]["meta"]["id"] == "alley_1/frame_0001"


@pytest.mark.parametrize("name,method", [
    ("kitti_raw", "eval_examples"), ("synthia", "eval_examples"), ("middlebury", "train_examples"),
])
def test_loader_refusals_match_jax(tmp_path, name, method):
    with pytest.raises(ValueError):
        getattr(data_jax.get_dataset(name, tmp_path), method)()
    with pytest.raises(ValueError):
        getattr(get_dataset(name, tmp_path), method)()


def test_kitti_raw_warnings(tmp_path, rng):
    write_kitti_raw(tmp_path, rng)
    with pytest.warns(UserWarning) as record:
        examples = get_dataset("kitti_raw", tmp_path).train_examples()
    messages = " ".join(str(w.message) for w in record)
    assert len(examples) == 3
    assert "contaminates" in messages and "partial corpus" in messages
    # the hint names no download command the port lacks
    assert "A13" in messages and "cli.download" not in messages
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        get_dataset("kitti_raw", tmp_path, exclude="off", warn_partial_corpus=False).train_examples()


def test_kitti_raw_drive_list_is_the_jax_one(tmp_path, rng):
    from unflow_tpu.data.bootstrap import _KITTI_RAW_DRIVES as drives_jax

    assert _KITTI_RAW_DRIVES == drives_jax
    for drive in _KITTI_RAW_DRIVES:
        (tmp_path / "kitti_raw" / f"{drive}_sync" / "image_02" / "data").mkdir(parents=True)
    first = tmp_path / "kitti_raw" / f"{_KITTI_RAW_DRIVES[0]}_sync" / "image_02" / "data"
    for i in range(3):
        write_image(first / f"{i:010d}.png", _im(rng, 8, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the full corpus: no warning
        assert len(get_dataset("kitti_raw", tmp_path, exclude="off").train_examples()) == 2


def test_registry_normalization_and_missing_data(tmp_path):
    assert sorted(data.DATASETS) == sorted(data_jax.DATASETS)
    for name in [*data.DATASETS, "synthetic", "nope"]:
        assert data.dataset_normalization(name) == data_jax.dataset_normalization(name), name
    assert data.KITTI_NORMALIZATION == data.dataset_normalization("kitti_raw")
    assert data.DEFAULT_NORMALIZATION == data.dataset_normalization("sintel")
    with pytest.raises(ValueError, match="batch_iterator"):
        get_dataset("synthetic", tmp_path)
    with pytest.raises(KeyError):
        get_dataset("bogus", tmp_path)
    with pytest.raises(FileNotFoundError, match="A13"):
        get_dataset("kitti_raw", tmp_path).train_examples()


def test_read_image_u8_and_pad_to_multiple_match_jax(tmp_path, rng):
    write_image(tmp_path / "a.png", _im(rng, 11, 13))
    got = read_image_u8(tmp_path / "a.png")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, read_image_u8_jax(tmp_path / "a.png"))
    for shape in ((375, 1242, 3), (64, 128, 2), (5, 7)):
        im = rng.rand(*shape).astype(np.float32)
        padded, orig = pad_to_multiple(im)
        want, want_orig = pad_to_multiple_jax(im)
        assert orig == want_orig == shape[:2]
        np.testing.assert_array_equal(padded, want)


def _assert_same_items(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("mode,dtype,hw", [
    ("crop_pad", "float32", None), ("crop_pad", "float32", (12, 40)),
    ("crop_pad", "uint8", (20, 24)), ("resize", "float32", (24, 48)),
])
@pytest.mark.parametrize("source", ["kitti_2012", "sintel"])
def test_load_example_matches_jax(tmp_path, rng, source, mode, dtype, hw):
    if source == "kitti_2012":
        write_kitti_flow(tmp_path, rng)
        examples = get_dataset("kitti_2012", tmp_path).eval_examples("occ")
    else:
        write_sintel(tmp_path, rng)
        examples = get_dataset("sintel", tmp_path).eval_examples()
    ex = examples[0]
    ex_jax = data_jax.Example(**dataclasses.asdict(ex))
    for supervised in (False, True):
        got = load_example(ex, hw, supervised, mode=mode, image_dtype=dtype)
        want = load_example_jax(ex_jax, hw, supervised, mode=mode, image_dtype=dtype)
        _assert_same_items(got, want)
    assert "noc_mask" in got


def test_load_example_uint8_refuses_resize(tmp_path, rng):
    write_kitti_raw(tmp_path, rng, n_frames=2)
    (ex,) = get_dataset("kitti_raw", tmp_path, exclude="off",
                        warn_partial_corpus=False).train_examples()
    with pytest.raises(ValueError, match="crop_pad"):
        load_example(ex, (16, 32), False, mode="resize", image_dtype="uint8")


def _stream(loader, count=None):
    it = iter(loader)
    try:
        return [b for _, b in zip(range(count), it)] if count else list(it)
    finally:
        it.close()


def _kitti_examples(tmp_path, rng, n=6):
    write_kitti_flow(tmp_path, rng, n=n)
    return get_dataset("kitti_2012", tmp_path).train_examples()


LOADER_CASES = {
    # name: Loader keyword arguments and the number of batches taken
    "unthreaded": (dict(num_threads=1, seed=3), 5),
    "threaded": (dict(num_threads=2, seed=3), 5),
    "start_batch_mid_epoch": (dict(num_threads=1, seed=3, start_batch=1), 3),
    "start_batch_next_epoch": (dict(num_threads=2, seed=3, start_batch=4), 3),
    "no_loop": (dict(num_threads=2, loop=False, shuffle=False), None),
    "uint8": (dict(num_threads=1, image_dtype="uint8", seed=1), 3),
    "resize": (dict(num_threads=1, mode="resize", load_hw=(24, 48), seed=2), 3),
    "unsupervised": (dict(num_threads=2, supervised=False, seed=4), 3),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_match_jax(tmp_path, rng, case):
    kwargs, count = LOADER_CASES[case]
    examples = _kitti_examples(tmp_path, rng)
    kw = {"batch_size": 2, "load_hw": (16, 32), "supervised": True, **kwargs}
    port = _stream(Loader(examples, **kw), count)
    ref = _stream(data_jax.Loader([data_jax.Example(**dataclasses.asdict(e)) for e in examples],
                                  **kw), count)
    assert len(port) == len(ref) == (count or 3)
    for a, b in zip(port, ref):
        _assert_same_items(a, b)


def test_loader_threads_do_not_reorder_and_resume_is_exact(tmp_path, rng):
    examples = _kitti_examples(tmp_path, rng)
    kw = dict(batch_size=2, load_hw=(16, 32), seed=5)
    serial = _stream(Loader(examples, num_threads=1, **kw), 7)  # over two epochs
    threaded = _stream(Loader(examples, num_threads=2, **kw), 7)
    for a, b in zip(serial, threaded):
        _assert_same_items(a, b)
    for k in (1, 3, 5):
        for j, batch in enumerate(_stream(Loader(examples, num_threads=2, start_batch=k, **kw), 2)):
            _assert_same_items(batch, serial[k + j])
    with pytest.raises(ValueError):
        Loader(examples, start_batch=-1, **kw)
    with pytest.raises(ValueError, match="prefetch"):
        Loader(examples, prefetch=0, **kw)
    with pytest.raises(ValueError, match="global batch"):
        Loader(examples[:1], **kw)


def test_loader_uint8_matches_float32(tmp_path, rng):
    examples = _kitti_examples(tmp_path, rng, n=4)
    kw = dict(batch_size=2, load_hw=(16, 32), loop=False, shuffle=False, num_threads=1)
    for b_f, b_u in zip(_stream(Loader(examples, **kw)),
                        _stream(Loader(examples, image_dtype="uint8", **kw))):
        assert b_u["im1"].dtype == np.uint8
        for key in ("im1", "im2"):
            np.testing.assert_array_equal(b_u[key].astype(np.float32) / 255.0, b_f[key])


def test_loader_abandoned_iterator_does_not_hang(tmp_path, rng):
    """The producer observes the stop event even when blocked on a full queue."""
    examples = _kitti_examples(tmp_path, rng, n=4)
    loader = Loader(examples, batch_size=1, load_hw=(16, 32), supervised=True, prefetch=1,
                    num_threads=2)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()  # abandoned with the queue full
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_loader_propagates_decode_errors(tmp_path, rng):
    examples = _kitti_examples(tmp_path, rng, n=2)
    Path(examples[1].im2).write_bytes(b"not a png")
    loader = Loader(examples, batch_size=2, load_hw=(16, 32), num_threads=2, loop=False)
    with pytest.raises(OSError):  # PIL's UnidentifiedImageError, from the producer thread
        _stream(loader)


@pytest.mark.parametrize("supervised", [False, True])
def test_packed_matches_decode_loader(tmp_path, rng, supervised):
    examples = _kitti_examples(tmp_path, rng, n=5)
    out = pack_examples(examples, tmp_path / "packed", (16, 32), supervised=supervised)
    packed = PackedExamples(out)
    assert len(packed) == 5 and packed.hw == (16, 32)
    kw = dict(batch_size=2, load_hw=(16, 32), supervised=supervised, seed=3, num_threads=1)
    for dtype in ("uint8", "float32"):
        dec = _stream(Loader(examples, image_dtype=dtype, **kw), 4)
        pak = _stream(Loader(packed, image_dtype=dtype, **kw), 4)
        for a, b in zip(dec, pak):
            for key in a:
                assert a[key].dtype == b[key].dtype
                if key == "flow":  # packed keeps the flow of valid pixels
                    np.testing.assert_array_equal(a[key] * a["mask"], b[key] * b["mask"])
                else:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packed_format_is_shared(tmp_path, rng, writer):
    """A directory packed by one package loads in the other, with the same
    arrays."""
    examples = _kitti_examples(tmp_path, rng, n=3)
    examples_jax = [data_jax.Example(**dataclasses.asdict(e)) for e in examples]
    if writer == "jax":
        out = pack_examples_jax(examples_jax, tmp_path / "packed", (16, 32), supervised=True)
        reader, other = PackedExamples(out), PackedExamplesJax(out)
    else:
        out = pack_examples(examples, tmp_path / "packed", (16, 32), supervised=True)
        reader, other = PackedExamplesJax(out), PackedExamples(out)
    assert sorted(p.name for p in out.iterdir()) == ["flow.f32", "frames.u8", "header.json",
                                                     "mask.u8"]
    idx = np.array([2, 0])
    _assert_same_items(reader.gather(idx, True), other.gather(idx, True))


def test_packed_refusals(tmp_path, rng):
    examples = _kitti_examples(tmp_path, rng, n=2)
    out = pack_examples(examples, tmp_path / "packed", (16, 32))
    with pytest.raises(ValueError, match="re-pack"):
        Loader(PackedExamples(out), batch_size=1, load_hw=(32, 64))
    loader = Loader(PackedExamples(out), batch_size=1, load_hw=(16, 32), supervised=True,
                    loop=False)
    with pytest.raises(ValueError, match="no ground truth"):
        _stream(loader)
    with pytest.raises(ValueError, match="empty"):
        pack_examples([], tmp_path / "none", (16, 32))


def test_cli_pack_writes_what_the_jax_cli_writes(tmp_path, rng, capsys):
    from unflow_tpu.cli.pack import main as pack_main_jax
    from unflow_tpu_torch.cli.pack import main as pack_main

    write_kitti_raw(tmp_path, rng, n_frames=5)
    common = ["--dataset", "kitti_raw", "--data-dir", str(tmp_path), "--height", "12",
              "--width", "40", "--max-frame-gap", "2"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert pack_main([*common, "--out", str(tmp_path / "port")]) == 0
        assert pack_main_jax([*common, "--out", str(tmp_path / "jax")]) == 0
    assert "packed 7 examples" in capsys.readouterr().out
    a, b = PackedExamples(tmp_path / "port"), PackedExamples(tmp_path / "jax")
    assert len(a) == len(b) == 7
    _assert_same_items(a.gather(np.arange(7), False), b.gather(np.arange(7), False))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_make_corpus_matches_jax_and_caches(tmp_path, dtype):
    kw = dict(n_pairs=4, height=16, width=24, seed=7, max_shift=4.0, dtype=dtype)
    port = make_corpus(cache_dir=str(tmp_path / "port"), **kw)
    ref = make_corpus_jax(**kw)
    again = make_corpus(cache_dir=str(tmp_path / "port"), **kw)  # memmapped from the cache
    (cached,) = (tmp_path / "port").iterdir()
    assert cached.name == f"synth_affine_16x24_n4_s7_ms4_{dtype}"
    assert sorted(p.name for p in cached.iterdir()) == ["DONE", "flow.npy", "im1.npy", "im2.npy"]
    assert isinstance(again["im1"], np.memmap)
    for key in ("im1", "im2", "flow"):
        np.testing.assert_array_equal(port[key], ref[key])
        np.testing.assert_array_equal(np.asarray(again[key]), ref[key])
    assert port["im1"].dtype == np.dtype(dtype) and port["flow"].dtype == np.float32
    with pytest.raises(ValueError):
        make_corpus(4, 16, 24, dtype="float16")


def test_corpus_iterator_matches_jax_with_resume(tmp_path):
    kw = dict(batch_size=2, height=16, width=16, n_pairs=6, seed=5, supervised=True,
              cache_dir=str(tmp_path), dtype="uint8")
    port = corpus_iterator(**kw)
    ref = corpus_iterator_jax(**kw)
    stream = [next(port) for _ in range(8)]  # over two epochs
    for batch in stream:
        _assert_same_items(batch, next(ref))
    for k in (1, 3, 7):
        _assert_same_items(next(corpus_iterator(start_batch=k, **kw)), stream[k])
    with pytest.raises(ValueError, match="divisible"):
        next(corpus_iterator(4, 16, 16, n_pairs=6))


def test_heldout_set_zero_flow_aee():
    """The acceptance run's held-out set: 8 batches of 8 at 128x256, seed
    777000, ``max_shift`` 32; its zero-flow AEE is the JAX record's."""
    held = heldout_set(8, 128, 256)
    assert len(held) == 8 and held[0]["flow"].shape == (8, 128, 256, 2)
    assert round(zero_flow_aee(held), 4) == 15.3428
