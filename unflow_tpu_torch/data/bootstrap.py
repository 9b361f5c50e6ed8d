"""Dataset bootstrap: download, extract, verify layout.

Copy of ``unflow_tpu/data/bootstrap.py`` (the same manifests, URLs,
layouts and checksums). Every dataset has a :class:`DatasetManifest`
(archive URLs, optional SHA-256 checksums, the extracted layout the loaders
of :mod:`unflow_tpu_torch.data` expect); ``ensure_dataset(name, data_dir)``
is a no-op when the layout is already there, and otherwise streams each
archive into ``<data_dir>/_downloads/`` (finished files are kept and
checksummed, partial ones fetched again) and extracts it with zip-slip
protection. Any scheme ``urllib`` takes works, ``file://`` included: a
local mirror replaces a manifest through :func:`override_manifest`.

The public dataset URLs are recollections of the upstream hosting
locations ([MED] confidence — verify before a large download); SYNTHIA
requires registration and has no direct URL, so its manifest carries
only the layout check and a pointer.
"""

from __future__ import annotations

import hashlib
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile
from dataclasses import dataclass
from pathlib import Path, PurePosixPath
from typing import Callable, Sequence

__all__ = [
    "ArchiveSpec",
    "DatasetManifest",
    "MANIFESTS",
    "ensure_dataset",
    "override_manifest",
]


@dataclass(frozen=True)
class ArchiveSpec:
    """One downloadable archive and where its contents land."""

    url: str
    #: directory under data_dir the archive extracts into
    extract_into: str = "."
    #: leading path component(s) to strip from every member, e.g.
    #: "FlyingChairs_release" so its data/ lands at <extract_into>/data
    strip_prefix: str | None = None
    sha256: str | None = None

    @property
    def filename(self) -> str:
        return PurePosixPath(urllib.parse.urlparse(self.url).path).name


@dataclass(frozen=True)
class DatasetManifest:
    name: str
    #: path relative to data_dir whose existence marks the dataset ready
    layout_root: str
    archives: Sequence[ArchiveSpec] = ()
    note: str = ""


_KITTI_S3 = "https://s3.eu-central-1.amazonaws.com/avg-kitti"

# The full KITTI raw training corpus by category, as listed on the KITTI
# raw-data page (cvlibs.net/datasets/kitti/raw_data.php). The paper
# recipe (reference core/data.py download lists [MED]: src/e2eflow/kitti/
# data.py) trains on city + residential + road; campus/person/calibration
# categories are not part of the flow recipe. Drive numbers are [MED]
# recollections of the public category tables — verify against the KITTI
# page before a full download. Eval-scene overlap with KITTI 2012/2015 is
# handled downstream at index time (data/kitti.py train_mapping
# exclusion), so the manifest ships every drive.
_KITTI_RAW_DRIVES_BY_CATEGORY: dict[str, tuple[str, ...]] = {
    "city": (
        "2011_09_26_drive_0001",
        "2011_09_26_drive_0002",
        "2011_09_26_drive_0005",
        "2011_09_26_drive_0009",
        "2011_09_26_drive_0011",
        "2011_09_26_drive_0013",
        "2011_09_26_drive_0014",
        "2011_09_26_drive_0017",
        "2011_09_26_drive_0018",
        "2011_09_26_drive_0048",
        "2011_09_26_drive_0051",
        "2011_09_26_drive_0056",
        "2011_09_26_drive_0057",
        "2011_09_26_drive_0059",
        "2011_09_26_drive_0060",
        "2011_09_26_drive_0084",
        "2011_09_26_drive_0091",
        "2011_09_26_drive_0093",
        "2011_09_26_drive_0095",
        "2011_09_26_drive_0096",
        "2011_09_26_drive_0104",
        "2011_09_26_drive_0106",
        "2011_09_26_drive_0113",
        "2011_09_26_drive_0117",
        "2011_09_28_drive_0001",
        "2011_09_28_drive_0002",
        "2011_09_29_drive_0026",
        "2011_09_29_drive_0071",
    ),
    "residential": (
        "2011_09_26_drive_0019",
        "2011_09_26_drive_0020",
        "2011_09_26_drive_0022",
        "2011_09_26_drive_0023",
        "2011_09_26_drive_0035",
        "2011_09_26_drive_0036",
        "2011_09_26_drive_0039",
        "2011_09_26_drive_0046",
        "2011_09_26_drive_0061",
        "2011_09_26_drive_0064",
        "2011_09_26_drive_0079",
        "2011_09_26_drive_0086",
        "2011_09_26_drive_0087",
        "2011_09_30_drive_0018",
        "2011_09_30_drive_0020",
        "2011_09_30_drive_0027",
        "2011_09_30_drive_0028",
        "2011_09_30_drive_0033",
        "2011_09_30_drive_0034",
        "2011_10_03_drive_0027",
        "2011_10_03_drive_0034",
    ),
    "road": (
        "2011_09_26_drive_0015",
        "2011_09_26_drive_0027",
        "2011_09_26_drive_0028",
        "2011_09_26_drive_0029",
        "2011_09_26_drive_0032",
        "2011_09_26_drive_0052",
        "2011_09_26_drive_0070",
        "2011_09_26_drive_0101",
        "2011_09_29_drive_0004",
        "2011_09_30_drive_0016",
        "2011_10_03_drive_0042",
        "2011_10_03_drive_0047",
    ),
}

_KITTI_RAW_DRIVES = tuple(
    d for drives in _KITTI_RAW_DRIVES_BY_CATEGORY.values() for d in drives
)


def _kitti_raw_archives() -> tuple[ArchiveSpec, ...]:
    specs = [
        ArchiveSpec(
            url=f"{_KITTI_S3}/raw_data/{d}/{d}_sync.zip",
            extract_into="kitti_raw",
        )
        for d in _KITTI_RAW_DRIVES
    ]
    # calibration files per recording date
    dates = sorted({d[:10] for d in _KITTI_RAW_DRIVES})
    specs.extend(
        ArchiveSpec(
            url=f"{_KITTI_S3}/raw_data/{date}_calib.zip",
            extract_into="kitti_raw",
        )
        for date in dates
    )
    return tuple(specs)


MANIFESTS: dict[str, DatasetManifest] = {
    "kitti_2012": DatasetManifest(
        name="kitti_2012",
        layout_root="kitti_2012/training",
        archives=(
            ArchiveSpec(
                url=f"{_KITTI_S3}/data_stereo_flow.zip",
                extract_into="kitti_2012",
            ),
        ),
    ),
    "kitti_2015": DatasetManifest(
        name="kitti_2015",
        layout_root="kitti_2015/training",
        archives=(
            ArchiveSpec(
                url=f"{_KITTI_S3}/data_scene_flow.zip",
                extract_into="kitti_2015",
            ),
        ),
    ),
    "kitti_raw": DatasetManifest(
        name="kitti_raw",
        layout_root="kitti_raw",
        archives=_kitti_raw_archives(),
        note=(
            "Manifest enumerates the full paper corpus: "
            f"{len(_KITTI_RAW_DRIVES_BY_CATEGORY['city'])} city + "
            f"{len(_KITTI_RAW_DRIVES_BY_CATEGORY['residential'])} residential + "
            f"{len(_KITTI_RAW_DRIVES_BY_CATEGORY['road'])} road drives "
            "(~170 GB). Also download kitti_2015 so the default-on "
            "eval-scene exclusion (train_mapping.txt) can activate."
        ),
    ),
    "sintel": DatasetManifest(
        name="sintel",
        layout_root="sintel/training",
        archives=(
            ArchiveSpec(
                url="http://files.is.tue.mpg.de/sintel/MPI-Sintel-complete.zip",
                extract_into="sintel",
            ),
        ),
    ),
    "chairs": DatasetManifest(
        name="chairs",
        layout_root="chairs/data",
        archives=(
            ArchiveSpec(
                url=(
                    "https://lmb.informatik.uni-freiburg.de/data/"
                    "FlyingChairs/FlyingChairs.zip"
                ),
                extract_into="chairs",
                strip_prefix="FlyingChairs_release",
            ),
            ArchiveSpec(
                url=(
                    "https://lmb.informatik.uni-freiburg.de/data/"
                    "FlyingChairs/FlyingChairs_train_val.txt"
                ),
                extract_into="chairs",
            ),
        ),
    ),
    "middlebury": DatasetManifest(
        name="middlebury",
        layout_root="middlebury",
        archives=(
            ArchiveSpec(
                url=(
                    "https://vision.middlebury.edu/flow/data/comp/zip/"
                    "other-color-twoframes.zip"
                ),
                extract_into="middlebury",
            ),
            ArchiveSpec(
                url=(
                    "https://vision.middlebury.edu/flow/data/comp/zip/"
                    "other-gt-flow.zip"
                ),
                extract_into="middlebury",
            ),
        ),
    ),
    "synthia": DatasetManifest(
        name="synthia",
        layout_root="synthia",
        archives=(),
        note=(
            "SYNTHIA requires registration (synthia-dataset.net); download "
            "the video sequences manually and place them under "
            "<data_dir>/synthia/."
        ),
    ),
}

# The final render pass ships in the same MPI-Sintel archive; the
# dataset-registry alias shares its manifest.
MANIFESTS["sintel_final"] = MANIFESTS["sintel"]


def override_manifest(name: str, manifest: DatasetManifest) -> None:
    """Replace a dataset's manifest (local mirrors, full drive lists)."""
    MANIFESTS[name] = manifest


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _download(url: str, dest: Path, progress: Callable[[str], None]) -> None:
    part = dest.with_suffix(dest.suffix + ".part")
    progress(f"downloading {url}")
    # Socket timeout (not a total-transfer cap): a mirror that accepts
    # the connection then stalls raises instead of hanging the download
    # loop forever; the CLI's per-archive error handling reports it.
    with urllib.request.urlopen(url, timeout=60) as r, part.open("wb") as f:
        shutil.copyfileobj(r, f, length=1 << 20)
    part.replace(dest)


def _safe_members(names: Sequence[str], strip_prefix: str | None):
    """Map archive member names to extraction-relative paths, rejecting
    absolute paths and parent traversal (zip-slip)."""
    out = []
    prefix = PurePosixPath(strip_prefix) if strip_prefix else None
    for raw in names:
        p = PurePosixPath(raw)
        if p.is_absolute() or ".." in p.parts:
            raise ValueError(f"unsafe archive member path: {raw!r}")
        if prefix is not None:
            parts = p.parts
            np_ = prefix.parts
            if parts[: len(np_)] == np_:
                p = PurePosixPath(*parts[len(np_):]) if len(parts) > len(np_) else None
        out.append((raw, p))
    return out


def _extract(archive: Path, into: Path, strip_prefix: str | None,
             progress: Callable[[str], None]) -> None:
    into.mkdir(parents=True, exist_ok=True)
    progress(f"extracting {archive.name} -> {into}")
    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            for raw, rel in _safe_members(z.namelist(), strip_prefix):
                if rel is None or raw.endswith("/"):
                    continue
                dest = into / Path(*rel.parts)
                dest.parent.mkdir(parents=True, exist_ok=True)
                with z.open(raw) as src, dest.open("wb") as f:
                    shutil.copyfileobj(src, f)
    elif tarfile.is_tarfile(archive):
        with tarfile.open(archive) as t:
            members = t.getmembers()
            mapped = dict(_safe_members([m.name for m in members], strip_prefix))
            for m in members:
                rel = mapped[m.name]
                if rel is None or not m.isfile():
                    continue
                dest = into / Path(*rel.parts)
                dest.parent.mkdir(parents=True, exist_ok=True)
                src = t.extractfile(m)
                assert src is not None
                with dest.open("wb") as f:
                    shutil.copyfileobj(src, f)
    else:
        # plain file (e.g. the FlyingChairs train/val split txt)
        shutil.copy2(archive, into / archive.name)


def ensure_dataset(
    name: str,
    data_dir: str | Path,
    download: bool = True,
    progress: Callable[[str], None] = print,
) -> Path:
    """Make sure ``name``'s on-disk layout exists under ``data_dir``.

    Returns the dataset's layout root. No-op when already present.
    Raises FileNotFoundError when absent and ``download=False`` or the
    manifest has no archives (registration-gated datasets).
    """
    if name not in MANIFESTS:
        raise KeyError(f"no bootstrap manifest for {name!r}; have {sorted(MANIFESTS)}")
    m = MANIFESTS[name]
    data_dir = Path(data_dir)
    root = data_dir / m.layout_root
    if root.exists():
        return root
    if not download or not m.archives:
        raise FileNotFoundError(
            f"{name}: {root} is missing and "
            + ("download=False. " if m.archives else "it has no direct URL. ")
            + (m.note or f"Run ensure_dataset({name!r}, ..., download=True) "
                         "or place the data manually.")
        )
    dl_dir = data_dir / "_downloads"
    dl_dir.mkdir(parents=True, exist_ok=True)
    for spec in m.archives:
        archive = dl_dir / spec.filename
        if not archive.exists():
            _download(spec.url, archive, progress)
        if spec.sha256 is not None:
            digest = _sha256(archive)
            if digest != spec.sha256:
                archive.unlink()
                raise ValueError(
                    f"{name}: checksum mismatch for {spec.filename} "
                    f"(got {digest}, want {spec.sha256}); stale download "
                    f"removed — retry."
                )
        _extract(archive, data_dir / spec.extract_into, spec.strip_prefix,
                 progress)
    if not root.exists():
        raise FileNotFoundError(
            f"{name}: archives extracted but expected layout {root} did not "
            f"appear — the upstream archive structure may have changed. "
            f"{m.note}"
        )
    if m.note:
        progress(f"{name}: {m.note}")
    return root
