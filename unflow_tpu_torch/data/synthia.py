"""SYNTHIA synthetic driving video (unsupervised pretraining).

A copy of ``unflow_tpu/data/synthia.py``.

Reference: simonmeister/UnFlow ``src/e2eflow/synthia/data.py`` — the
paper's CSS recipe pretrains on SYNTHIA before KITTI raw
(SURVEY.md §2.2 P12).

Expected layout: ``<data_dir>/synthia/<sequence>/RGB/**/*.png`` with
frames sorted per directory; consecutive frames form pairs.
"""

from __future__ import annotations

from unflow_tpu_torch.data.base import Example, PairDataset


class Synthia(PairDataset):
    name = "synthia"

    def train_examples(self) -> list[Example]:
        root = self._require(self.data_dir / "synthia", "SYNTHIA video sequences.")
        examples = []
        for rgb_dir in sorted(root.glob("**/RGB")):
            for sub in sorted({p.parent for p in rgb_dir.glob("**/*.png")}):
                frames = sorted(sub.glob("*.png"))
                examples.extend(
                    Example(im1=str(a), im2=str(b))
                    for a, b in zip(frames, frames[1:])
                )
        if not examples:
            raise FileNotFoundError(f"no frame pairs under {root}")
        return examples

    def eval_examples(self, variant=None):
        raise ValueError("SYNTHIA is used for unsupervised pretraining only")
