"""KITTI datasets: raw drives (unsupervised) and 2012/2015 (eval/GT).

A copy of ``unflow_tpu/data/kitti.py``; the paper recipe's list of KITTI raw
drives, which the partial-corpus warning counts, is the bootstrap
manifest's (``data/bootstrap.py``).

Reference: simonmeister/UnFlow ``src/e2eflow/kitti/data.py::KITTIData``
and ``src/e2eflow/kitti/input.py::KITTIInput`` (``input_raw``,
``input_train_2012``, ``input_train_2015``) — SURVEY.md §2.2 P10.
16-bit PNG GT decode ``(u16 - 2^15)/64`` with validity channel.

Expected layout under ``<data_dir>``:
  kitti_raw/<drive>/image_02/data/*.png         (any nesting of drives)
  kitti_2012/training/colored_0/??????_1{0,1}.png + flow_occ/??????_10.png
  kitti_2015/training/image_2/??????_1{0,1}.png + flow_occ/??????_10.png
"""

from __future__ import annotations

from pathlib import Path

from unflow_tpu_torch.data import bootstrap
from unflow_tpu_torch.data.base import Example, PairDataset

# Reference KITTI normalization constants ([MED] recollection).
KITTI_MEAN = (96.81, 98.83, 94.48)
KITTI_STDDEV = 60.0

# The paper recipe's KITTI raw drives (the bootstrap manifest's); a corpus
# on disk with fewer than three quarters of them warns.
_KITTI_RAW_DRIVES = bootstrap._KITTI_RAW_DRIVES


class KITTIRaw(PairDataset):
    """Consecutive-frame pairs from KITTI raw drives (no GT).

    Eval-scene exclusion (reference ``src/e2eflow/kitti/input.py::
    input_raw`` excludes raw frames overlapping the 2012/2015 eval
    scenes [MED]) is ON by default:

      * Explicit: pass ``exclude_file`` — lines are either a bare path
        substring, or ``<drive> <frame_index>`` pairs excluding
        ``exclude_window`` frames around that index in that drive.
      * Automatic: when the sibling ``kitti_2015`` dataset is present,
        its devkit's ``train_mapping.txt`` (eval frame -> raw drive +
        frame index) is parsed and those scenes are excluded with the
        same window — the exclusion is derived from the eval set itself,
        not a shipped approximation.
      * Neither available: a loud warning that raw training may
        contaminate the 2012/2015 eval scenes (set
        ``exclude="off"`` to silence deliberately).
    """

    name = "kitti_raw"
    normalization = (KITTI_MEAN, KITTI_STDDEV)

    def __init__(
        self,
        data_dir,
        exclude_file: str | None = None,
        exclude: str = "auto",  # auto | off
        exclude_window: int = 20,
        max_frame_gap: int = 1,
        warn_partial_corpus: bool = True,
    ):
        super().__init__(data_dir)
        self.exclude_mode = exclude
        self.exclude_window = exclude_window
        self.warn_partial_corpus = warn_partial_corpus
        # Temporal augmentation (reference input_raw skip_frames [MED]):
        # gap g in 1..max_frame_gap yields pairs (frame_i, frame_{i+g}),
        # multiplying effective motion magnitudes in the training set.
        self.max_frame_gap = max(1, int(max_frame_gap))
        self.exclude_substrings: list[str] = []
        self.exclude_scenes: list[tuple[str, int]] = []  # (drive, frame)
        if exclude_file:
            for line in open(exclude_file):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) == 2 and parts[1].isdigit():
                    self.exclude_scenes.append((parts[0], int(parts[1])))
                else:
                    self.exclude_substrings.append(line)

    def _warn_if_partial_corpus(self, root: Path) -> None:
        """Warn loudly when the on-disk corpus is a fraction of the paper
        recipe's city+residential+road drive list (bootstrap manifest).

        The paper recipe trains on the full corpus; silently training on
        a couple of drives produces much worse flow and wastes a run.
        """
        if not self.warn_partial_corpus:
            return
        on_disk = {
            p.name.replace("_sync", "")
            for p in root.glob("**/*_drive_*")
            if p.is_dir() and (p / "image_02").exists()
        }
        expected = set(_KITTI_RAW_DRIVES)
        missing = expected - on_disk
        if on_disk and len(missing) > len(expected) // 4:
            import warnings

            warnings.warn(
                f"KITTIRaw: only {len(expected) - len(missing)} of "
                f"{len(expected)} paper-recipe drives present under {root} "
                f"(missing e.g. {sorted(missing)[:3]}). Training on a "
                "partial corpus degrades accuracy; run "
                "`python -m unflow_tpu_torch.cli.download kitti_raw` "
                "for the full city/residential/road set.",
                stacklevel=3,
            )

    def _auto_exclusions(self) -> list[tuple[str, int]]:
        """Parse the 2012 AND 2015 devkit train mappings when present.

        Lines look like ``2011_09_26 2011_09_26_drive_0009_sync
        0000000384`` (empty for frames without a raw correspondence).
        Both benchmarks' eval scenes come from raw drives — excluding
        only one would leave the other's scenes in the training set.
        """
        scenes = []
        for bench in ("kitti_2012", "kitti_2015"):
            for mapping in sorted(
                (self.data_dir / bench).glob("**/train_mapping.txt")
            ):
                for line in open(mapping):
                    parts = line.split()
                    if len(parts) == 3:
                        scenes.append((parts[1], int(parts[2])))
        return scenes

    def train_examples(self) -> list[Example]:
        root = self._require(
            self.data_dir / "kitti_raw", "KITTI raw city/residential/road drives."
        )
        self._warn_if_partial_corpus(root)
        scenes = list(self.exclude_scenes)
        if self.exclude_mode == "auto":
            scenes += self._auto_exclusions()
        if (
            self.exclude_mode != "off"
            and not scenes
            and not self.exclude_substrings
        ):
            import warnings

            warnings.warn(
                "KITTIRaw: no eval-scene exclusion active (no exclude_file; "
                "no kitti_2012/kitti_2015 devkit train_mapping.txt found). "
                "Training on unfiltered raw drives contaminates the KITTI "
                "2012/2015 eval scenes. Pass exclude_file=..., place the "
                "benchmark devkits under the data dir, or set exclude='off' "
                "to silence.",
                stacklevel=2,
            )
        by_drive: dict[str, list[int]] = {}
        for drive, frame in scenes:
            by_drive.setdefault(drive, []).append(frame)

        def excluded(path: Path) -> bool:
            s = str(path)
            if any(x in s for x in self.exclude_substrings):
                return True
            for drive, frames in by_drive.items():
                if drive in s:
                    try:
                        idx = int(path.stem)
                    except ValueError:
                        return True  # unparseable frame in a mapped drive
                    if any(abs(idx - f) <= self.exclude_window for f in frames):
                        return True
            return False

        examples = []
        for image_dir in sorted(root.glob("**/image_02/data")):
            frames = sorted(image_dir.glob("*.png"))
            for gap in range(1, self.max_frame_gap + 1):
                for a, b in zip(frames, frames[gap:]):
                    if excluded(a) or excluded(b):
                        continue
                    examples.append(Example(im1=str(a), im2=str(b)))
        if not examples:
            raise FileNotFoundError(f"no frame pairs under {root}")
        return examples

    def eval_examples(self, variant=None):
        raise ValueError("KITTI raw has no ground truth; use kitti_2012/2015")


class KITTI2012(PairDataset):
    name = "kitti_2012"
    normalization = (KITTI_MEAN, KITTI_STDDEV)
    image_dir = "colored_0"

    def _root(self) -> Path:
        return self._require(
            self.data_dir / self.name / "training",
            f"{self.name} training set with flow_occ GT.",
        )

    def _examples(
        self, flow_subdir: str, noc_subdir: str | None = None
    ) -> list[Example]:
        root = self._root()
        examples = []
        for gt in sorted((root / flow_subdir).glob("*_10.png")):
            frame_id = gt.name[: -len("_10.png")]
            im1 = root / self.image_dir / f"{frame_id}_10.png"
            im2 = root / self.image_dir / f"{frame_id}_11.png"
            noc = root / noc_subdir / gt.name if noc_subdir else None
            if im1.exists() and im2.exists():
                examples.append(
                    Example(
                        im1=str(im1), im2=str(im2), flow=str(gt),
                        flow_format="kitti_png",
                        noc=str(noc) if noc is not None and noc.exists() else None,
                        meta={"id": frame_id},
                    )
                )
        if not examples:
            raise FileNotFoundError(f"no examples under {root}/{flow_subdir}")
        return examples

    def train_examples(self) -> list[Example]:
        return self._examples("flow_occ")

    def eval_examples(self, variant: str | None = "occ") -> list[Example]:
        # occ = all pixels (occluded included), noc = non-occluded only.
        # The occ variant also attaches flow_noc (when present) so the
        # evaluator can report the noc/occ AEE breakdown in one pass.
        variant = variant or "occ"
        noc_subdir = "flow_noc" if variant == "occ" else None
        return self._examples(f"flow_{variant}", noc_subdir=noc_subdir)


class KITTI2015(KITTI2012):
    name = "kitti_2015"
    image_dir = "image_2"
