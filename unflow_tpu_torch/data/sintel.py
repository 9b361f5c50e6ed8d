"""MPI-Sintel dataset (clean/final passes, .flo ground truth).

A copy of ``unflow_tpu/data/sintel.py``.

Reference: simonmeister/UnFlow ``src/e2eflow/sintel/{data,input}.py``
(SURVEY.md §2.2 P11).

Expected layout: ``<data_dir>/sintel/training/{clean,final}/<scene>/
frame_%04d.png`` and ``training/flow/<scene>/frame_%04d.flo``.
"""

from __future__ import annotations

from unflow_tpu_torch.data.base import Example, PairDataset


class Sintel(PairDataset):
    name = "sintel"

    def __init__(self, data_dir, render_pass: str = "clean"):
        super().__init__(data_dir)
        if render_pass not in ("clean", "final"):
            raise ValueError(f"render pass must be clean|final, got {render_pass}")
        self.render_pass = render_pass

    def _examples(self, with_gt: bool) -> list[Example]:
        root = self._require(
            self.data_dir / "sintel" / "training",
            "MPI-Sintel training set (clean/final + flow).",
        )
        pass_dir = root / self.render_pass
        examples = []
        for scene in sorted(p for p in pass_dir.iterdir() if p.is_dir()):
            frames = sorted(scene.glob("frame_*.png"))
            for a, b in zip(frames, frames[1:]):
                flow = root / "flow" / scene.name / (a.stem + ".flo")
                if with_gt and not flow.exists():
                    continue
                # Official occlusion masks (white = occluded) enable the
                # evaluator's noc/occ AEE breakdown when present.
                occ = root / "occlusions" / scene.name / (a.stem + ".png")
                examples.append(
                    Example(
                        im1=str(a), im2=str(b),
                        flow=str(flow) if flow.exists() else None,
                        flow_format="flo",
                        noc=str(occ) if flow.exists() and occ.exists() else None,
                        noc_format="occ_png",
                        # "id" is the benchmark-dump stem: scene subdir +
                        # frame stem, unique per pair (scene alone would
                        # make every pair in a scene overwrite one file).
                        meta={"scene": scene.name,
                              "id": f"{scene.name}/{a.stem}"},
                    )
                )
        if not examples:
            raise FileNotFoundError(f"no examples under {pass_dir}")
        return examples

    def train_examples(self) -> list[Example]:
        return self._examples(with_gt=False)

    def eval_examples(self, variant: str | None = None) -> list[Example]:
        return self._examples(with_gt=True)


class SintelFinal(Sintel):
    """Registry alias: train/eval on the final render pass
    (the train CLI selects datasets by name only)."""

    name = "sintel_final"

    def __init__(self, data_dir, render_pass: str = "final"):
        super().__init__(data_dir, render_pass=render_pass)
