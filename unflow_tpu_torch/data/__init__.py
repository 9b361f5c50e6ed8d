"""Per-dataset input normalization.

A copy of the constants of ``unflow_tpu/data`` (``base.py::PairDataset``,
``kitti.py::KITTI_MEAN``/``KITTI_STDDEV`` and the ``DATASETS`` registry):
mean of the 0..255 RGB channels and one stddev. Of the data sources only the
synthetic stream (``data/synthetic.py``) is here; the dataset loaders are not
ported yet.
"""

from __future__ import annotations

DEFAULT_NORMALIZATION = ((104.92, 110.18, 114.47), 60.0)
KITTI_NORMALIZATION = ((96.81, 98.83, 94.48), 60.0)

NORMALIZATION = {
    "kitti_raw": KITTI_NORMALIZATION,
    "kitti_2012": KITTI_NORMALIZATION,
    "kitti_2015": KITTI_NORMALIZATION,
    "sintel": DEFAULT_NORMALIZATION,
    "sintel_final": DEFAULT_NORMALIZATION,
    "synthia": DEFAULT_NORMALIZATION,
    "chairs": DEFAULT_NORMALIZATION,
    "middlebury": DEFAULT_NORMALIZATION,
}


def dataset_normalization(name: str):
    """(mean, stddev) of a dataset; None for synthetic or unknown names."""
    return NORMALIZATION.get(name)
