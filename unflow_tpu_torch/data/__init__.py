"""Datasets, the threaded loader and the per-dataset input normalization.

A copy of ``unflow_tpu/data/__init__.py``: the dataset registry, its loaders
(numpy and threads only) and ``get_dataset``. A dataset's normalization,
the mean of its 0..255 RGB channels and one stddev, is a class attribute.
The synthetic pairs come from ``data/synthetic.py``; packed input from
``data/packed.py``.
"""

from unflow_tpu_torch.data.base import Example, Loader, PairDataset, fit_to_shape, load_example
from unflow_tpu_torch.data.chairs import FlyingChairs
from unflow_tpu_torch.data.kitti import KITTI2012, KITTI2015, KITTIRaw
from unflow_tpu_torch.data.middlebury import Middlebury
from unflow_tpu_torch.data.sintel import Sintel, SintelFinal
from unflow_tpu_torch.data.synthia import Synthia

DEFAULT_NORMALIZATION = PairDataset.normalization
KITTI_NORMALIZATION = KITTIRaw.normalization

DATASETS = {
    "kitti_raw": KITTIRaw,
    "kitti_2012": KITTI2012,
    "kitti_2015": KITTI2015,
    "sintel": Sintel,
    "sintel_final": SintelFinal,
    "synthia": Synthia,
    "chairs": FlyingChairs,
    "middlebury": Middlebury,
}


def dataset_normalization(name: str):
    """(mean, stddev) of a dataset without touching the filesystem; None for
    synthetic or unknown names."""
    return getattr(DATASETS.get(name), "normalization", None)


def get_dataset(name: str, data_dir: str, **kwargs) -> PairDataset:
    if name == "synthetic":
        raise ValueError(
            "synthetic batches come from unflow_tpu_torch.data.synthetic.batch_iterator"
        )
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](data_dir, **kwargs)


__all__ = [
    "DATASETS",
    "DEFAULT_NORMALIZATION",
    "KITTI_NORMALIZATION",
    "Example",
    "FlyingChairs",
    "KITTI2012",
    "KITTI2015",
    "KITTIRaw",
    "Loader",
    "Middlebury",
    "PairDataset",
    "Sintel",
    "SintelFinal",
    "Synthia",
    "dataset_normalization",
    "fit_to_shape",
    "get_dataset",
    "load_example",
]
