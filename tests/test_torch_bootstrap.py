"""The port's dataset bootstrap (``unflow_tpu_torch/data/bootstrap.py``) and
``cli.download``, offline through ``file://`` URLs: every case of
``tests/test_bootstrap.py`` against the port's copy, its manifests against
the JAX package's name by name, and the trees both extract from one archive."""

from __future__ import annotations

import dataclasses
import hashlib
import io
import tarfile
import zipfile
from pathlib import Path

import pytest

from unflow_tpu.data import bootstrap as bootstrap_jax
from unflow_tpu_torch.data import DATASETS
from unflow_tpu_torch.data.bootstrap import (
    MANIFESTS,
    ArchiveSpec,
    DatasetManifest,
    ensure_dataset,
    override_manifest,
)


@pytest.fixture()
def quiet():
    return lambda msg: None


def _make_zip(path: Path, members: dict[str, bytes]) -> None:
    with zipfile.ZipFile(path, "w") as z:
        for name, data in members.items():
            z.writestr(name, data)


def _make_tar(path: Path, members: dict[str, bytes]) -> None:
    with tarfile.open(path, "w:gz") as t:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))


def _manifest_for(archive: Path, **spec_kw) -> DatasetManifest:
    return DatasetManifest(
        name="testset",
        layout_root="testset/training",
        archives=(ArchiveSpec(url=archive.as_uri(), extract_into="testset", **spec_kw),),
    )


def test_download_extract_layout(tmp_path, quiet, monkeypatch):
    src = tmp_path / "src.zip"
    _make_zip(src, {"training/image_2/000000_10.png": b"fakepng",
                    "testing/image_2/000000_10.png": b"x"})
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src))
    data_dir = tmp_path / "data"
    root = ensure_dataset("testset", data_dir, progress=quiet)
    assert root == data_dir / "testset" / "training"
    assert (root / "image_2" / "000000_10.png").read_bytes() == b"fakepng"
    assert (data_dir / "_downloads" / "src.zip").exists()  # the archive is kept


def test_idempotent_no_redownload(tmp_path, quiet, monkeypatch):
    src = tmp_path / "src.zip"
    _make_zip(src, {"training/a.txt": b"1"})
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src))
    data_dir = tmp_path / "data"
    ensure_dataset("testset", data_dir, progress=quiet)
    src.unlink()  # a second call that fetched would fail
    assert ensure_dataset("testset", data_dir, progress=quiet).exists()


def test_strip_prefix(tmp_path, quiet, monkeypatch):
    src = tmp_path / "src.zip"
    _make_zip(src, {"Release_v1/data/00001_img1.ppm": b"img"})
    m = DatasetManifest(
        name="testset", layout_root="testset/data",
        archives=(ArchiveSpec(url=src.as_uri(), extract_into="testset",
                              strip_prefix="Release_v1"),),
    )
    monkeypatch.setitem(MANIFESTS, "testset", m)
    root = ensure_dataset("testset", tmp_path / "data", progress=quiet)
    assert (root / "00001_img1.ppm").read_bytes() == b"img"


def test_tarball(tmp_path, quiet, monkeypatch):
    src = tmp_path / "src.tar.gz"
    _make_tar(src, {"training/flow/0000.flo": b"flowdata"})
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src))
    root = ensure_dataset("testset", tmp_path / "data", progress=quiet)
    assert (root / "flow" / "0000.flo").read_bytes() == b"flowdata"


@pytest.mark.parametrize("kind", ["zip", "tar"])
def test_zip_slip_rejected(tmp_path, quiet, monkeypatch, kind):
    src = tmp_path / f"evil.{kind}"
    (_make_zip if kind == "zip" else _make_tar)(src, {"../../escape.txt": b"pwn"})
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src))
    with pytest.raises(ValueError, match="unsafe archive member"):
        ensure_dataset("testset", tmp_path / "data", progress=quiet)
    assert not (tmp_path / "escape.txt").exists()


def test_checksum_mismatch(tmp_path, quiet, monkeypatch):
    src = tmp_path / "src.zip"
    _make_zip(src, {"training/a.txt": b"1"})
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src, sha256="0" * 64))
    with pytest.raises(ValueError, match="checksum mismatch"):
        ensure_dataset("testset", tmp_path / "data", progress=quiet)
    # the bad download is gone, so a retry fetches it again
    assert not (tmp_path / "data" / "_downloads" / "src.zip").exists()


def test_checksum_match(tmp_path, quiet, monkeypatch):
    src = tmp_path / "src.zip"
    _make_zip(src, {"training/a.txt": b"1"})
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src, sha256=digest))
    root = ensure_dataset("testset", tmp_path / "data", progress=quiet)
    assert (root / "a.txt").exists()


def test_missing_no_download(tmp_path, quiet):
    with pytest.raises(FileNotFoundError, match="download=False"):
        ensure_dataset("kitti_2015", tmp_path, download=False, progress=quiet)


def test_registration_gated_dataset(tmp_path, quiet):
    with pytest.raises(FileNotFoundError, match="no direct URL"):
        ensure_dataset("synthia", tmp_path, progress=quiet)


def test_unknown_dataset(tmp_path, quiet):
    with pytest.raises(KeyError, match="no bootstrap manifest"):
        ensure_dataset("nope", tmp_path, progress=quiet)


def test_plain_file_archive(tmp_path, quiet, monkeypatch):
    # a URL that is no archive (the FlyingChairs train/val split) is copied
    src = tmp_path / "split.txt"
    src.write_bytes(b"1\n2\n1\n")
    zsrc = tmp_path / "src.zip"
    _make_zip(zsrc, {"data/a.ppm": b"x"})
    m = DatasetManifest(
        name="testset", layout_root="testset/data",
        archives=(ArchiveSpec(url=zsrc.as_uri(), extract_into="testset"),
                  ArchiveSpec(url=src.as_uri(), extract_into="testset")),
    )
    monkeypatch.setitem(MANIFESTS, "testset", m)
    ensure_dataset("testset", tmp_path / "data", progress=quiet)
    assert (tmp_path / "data" / "testset" / "split.txt").read_bytes() == b"1\n2\n1\n"


def test_every_real_manifest_is_wellformed():
    for name in DATASETS:
        assert name in MANIFESTS, f"dataset {name} has no bootstrap manifest"
        m = MANIFESTS[name]
        assert m.layout_root
        for spec in m.archives:
            assert spec.filename  # the URL parses to a usable filename


def test_manifests_are_the_jax_ones():
    assert sorted(MANIFESTS) == sorted(bootstrap_jax.MANIFESTS)
    for name, m in MANIFESTS.items():
        assert dataclasses.asdict(m) == dataclasses.asdict(bootstrap_jax.MANIFESTS[name]), name
    assert MANIFESTS["sintel_final"] is MANIFESTS["sintel"]


def test_override_manifest(tmp_path, quiet):
    src = tmp_path / "mirror.zip"
    _make_zip(src, {"training/a.txt": b"mirrored"})
    orig = MANIFESTS["kitti_2012"]
    try:
        override_manifest("kitti_2012", DatasetManifest(
            name="kitti_2012", layout_root="kitti_2012/training",
            archives=(ArchiveSpec(url=src.as_uri(), extract_into="kitti_2012"),),
        ))
        root = ensure_dataset("kitti_2012", tmp_path / "data", progress=quiet)
        assert (root / "a.txt").read_bytes() == b"mirrored"
    finally:
        override_manifest("kitti_2012", orig)


@pytest.mark.parametrize("kind", ["zip", "tar", "strip_prefix"])
def test_extracts_what_the_jax_bootstrap_extracts(tmp_path, quiet, monkeypatch, kind):
    members = {"training/image_2/000000_10.png": b"a", "training/flow/0.flo": b"bb",
               "testing/x.txt": b"ccc"}
    src = tmp_path / ("src.tar.gz" if kind == "tar" else "src.zip")
    spec_kw = {}
    if kind == "strip_prefix":
        members = {f"Release/{k}": v for k, v in members.items()}
        spec_kw["strip_prefix"] = "Release"
    (_make_tar if kind == "tar" else _make_zip)(src, members)
    trees = []
    for module, name in ((bootstrap_jax, "jax"), (None, "port")):
        if module is None:
            monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src, **spec_kw))
            root = ensure_dataset("testset", tmp_path / name, progress=quiet)
        else:
            monkeypatch.setitem(module.MANIFESTS, "testset", module.DatasetManifest(
                name="testset", layout_root="testset/training",
                archives=(module.ArchiveSpec(url=src.as_uri(), extract_into="testset",
                                             **spec_kw),)))
            root = module.ensure_dataset("testset", tmp_path / name, progress=quiet)
        base = root.parent.parent
        trees.append({str(p.relative_to(base)): p.read_bytes()
                      for p in sorted(base.rglob("*")) if p.is_file()})
    assert trees[0] == trees[1] and len(trees[0]) == 4  # three members and the archive


def test_download_cli(tmp_path, monkeypatch, capsys):
    from unflow_tpu_torch.cli.download import main

    src = tmp_path / "src.zip"
    _make_zip(src, {"training/a.txt": b"1"})
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src))
    assert main(["testset", "--data-dir", str(tmp_path / "data")]) == 0
    assert "testset: ready at" in capsys.readouterr().out
    # a failure is reported and the exit code says so
    monkeypatch.setitem(MANIFESTS, "testset", _manifest_for(src, sha256="0" * 64))
    assert main(["testset", "--data-dir", str(tmp_path / "other")]) == 1
    assert "testset: FAILED" in capsys.readouterr().err
