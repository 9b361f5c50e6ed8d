"""FlyingChairs dataset (supervised pairs with dense .flo GT).

A copy of ``unflow_tpu/data/chairs.py``.

Reference: simonmeister/UnFlow ``src/e2eflow/chairs/{data,input}.py``
(SURVEY.md §2.2 P13).

Expected layout: ``<data_dir>/chairs/data/NNNNN_img1.ppm``,
``NNNNN_img2.ppm``, ``NNNNN_flow.flo`` (the official release layout).
An optional ``chairs/FlyingChairs_train_val.txt`` (1 = train, 2 = val
per line) splits train/eval as in the common protocol.
"""

from __future__ import annotations

from unflow_tpu_torch.data.base import Example, PairDataset


class FlyingChairs(PairDataset):
    name = "chairs"

    def _all_examples(self) -> list[Example]:
        root = self._require(self.data_dir / "chairs" / "data", "FlyingChairs data/.")
        examples = []
        for im1 in sorted(root.glob("*_img1.ppm")):
            stem = im1.name[: -len("_img1.ppm")]
            im2 = root / f"{stem}_img2.ppm"
            flow = root / f"{stem}_flow.flo"
            if im2.exists() and flow.exists():
                examples.append(
                    Example(im1=str(im1), im2=str(im2), flow=str(flow),
                            meta={"id": stem})
                )
        if not examples:
            raise FileNotFoundError(f"no examples under {root}")
        return examples

    def _split(self, want: int) -> list[Example]:
        examples = self._all_examples()
        split_file = self.data_dir / "chairs" / "FlyingChairs_train_val.txt"
        if not split_file.exists():
            return examples
        flags = [int(x) for x in split_file.read_text().split()]
        return [ex for ex, fl in zip(examples, flags) if fl == want]

    def train_examples(self) -> list[Example]:
        return self._split(1)

    def eval_examples(self, variant: str | None = None) -> list[Example]:
        return self._split(2)
