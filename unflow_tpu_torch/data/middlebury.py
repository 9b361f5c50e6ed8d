"""Middlebury optical-flow evaluation set.

A copy of ``unflow_tpu/data/middlebury.py``.

Reference: simonmeister/UnFlow ``src/e2eflow/middlebury/{data,input}.py``
(SURVEY.md §2.2 P14).

Expected layout: ``<data_dir>/middlebury/other-data/<scene>/frame10.png,
frame11.png`` and ``other-gt-flow/<scene>/flow10.flo``.
"""

from __future__ import annotations

from unflow_tpu_torch.data.base import Example, PairDataset


class Middlebury(PairDataset):
    name = "middlebury"

    def train_examples(self):
        raise ValueError("Middlebury is evaluation-only")

    def eval_examples(self, variant: str | None = None) -> list[Example]:
        root = self._require(
            self.data_dir / "middlebury", "Middlebury other-data + other-gt-flow."
        )
        examples = []
        for scene in sorted((root / "other-data").iterdir()):
            im1 = scene / "frame10.png"
            im2 = scene / "frame11.png"
            flow = root / "other-gt-flow" / scene.name / "flow10.flo"
            if im1.exists() and im2.exists():
                examples.append(
                    Example(
                        im1=str(im1), im2=str(im2),
                        flow=str(flow) if flow.exists() else None,
                        # one pair per scene -> the scene name is a
                        # unique benchmark-dump stem
                        meta={"scene": scene.name, "id": scene.name},
                    )
                )
        if not examples:
            raise FileNotFoundError(f"no scenes under {root}/other-data")
        return examples
