"""Configuration: dataclasses read from the repo's INI files.

A copy of ``unflow_tpu/config.py`` (``Config``, ``TrainConfig``,
``load_config``), so that the port reads the same ``configs/*.ini``: a
``[train]`` section, overridden key by key by ``[train_<dataset>]``.

A copy too of ``save_config`` and ``prepare_experiment_dir``, which snapshot
the resolved config into ``<log>/ex/<name>/config.ini``.

Keys the port reads: the model (``flownet``, ``compute_dtype``,
``corr_impl`` -- ``auto|torch|cuda``; the JAX names ``jnp``/``pallas`` map
to ``torch``/``cuda`` --, ``max_displacement``, ``corr_stride``), the input
(``dataset`` -- ``synthetic`` or a name of ``data.DATASETS`` under
``[dirs] data`` --, ``packed_dir``, ``input_mode``, ``max_frame_gap``,
``num_threads``), the train step (``batch_size``, ``height``, ``width``,
``num_iters``, ``learning_rate``, ``decay_after``, ``decay_interval``,
``weight_decay``, ``grad_clip_norm``, ``display_interval``,
``save_interval``, ``eval_interval``, ``seed``, ``train_all``,
``finetune``, ``supervised``, ``image_summary_interval``,
``tensorboard``), the loss (the ``*_weight`` keys, ``mask_occlusion``,
``border_ratio``) and the augmentation (``aug_swap_prob``,
``aug_photometric``, ``aug_hflip``, ``aug_noise_stddev`` and the affine
ranges ``aug_translate``, ``aug_rotate``, ``aug_zoom_min``,
``aug_zoom_max``, ``aug_rel_*``). ``conv_impl``, ``deconv_impl`` and
``remat`` select XLA lowerings on the TPU; they are accepted and ignored.
Several devices (``num_devices`` > 1, ``spatial_shards`` > 1) are not
ported yet and make the trainer raise.
"""

from __future__ import annotations

import configparser
import dataclasses
from pathlib import Path


@dataclasses.dataclass
class TrainConfig:
    dataset: str = "synthetic"
    flownet: str = "C"
    batch_size: int = 4
    height: int = 320
    width: int = 1152
    num_iters: int = 500_000
    learning_rate: float = 1.0e-4
    decay_after: int = 100_000
    decay_interval: int = 100_000
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    save_interval: int = 5_000
    display_interval: int = 100
    image_summary_interval: int = 0
    tensorboard: bool = False
    eval_interval: int = 0
    # loss-term weights
    occ_weight: float = 12.4
    sym_weight: float = 0.0
    fb_weight: float = 0.2
    grad_weight: float = 0.0
    ternary_weight: float = 1.0
    photo_weight: float = 0.0
    smooth_1st_weight: float = 0.0
    smooth_2nd_weight: float = 3.0
    mask_occlusion: str = "fb"  # fb | disocc | (empty)
    border_ratio: float = 0.0
    # augmentation
    aug_translate: float = 0.0
    aug_rotate: float = 0.0
    aug_zoom_min: float = 1.0
    aug_zoom_max: float = 1.0
    aug_rel_translate: float = 0.0
    aug_rel_rotate: float = 0.0
    aug_rel_zoom: float = 0.0
    aug_swap_prob: float = 0.0
    aug_photometric: bool = True
    aug_hflip: bool = True
    aug_noise_stddev: float = 0.04
    train_all: bool = False
    supervised: bool = False
    finetune: tuple[str, ...] = ()
    # correlation geometry (the reference's FlowNetC uses 20 / 2)
    max_displacement: int = 20
    corr_stride: int = 2
    input_mode: str = "crop_pad"
    num_threads: int = 4
    packed_dir: str = ""
    max_frame_gap: int = 1
    compute_dtype: str = "bfloat16"  # towers and decoder; flows stay float32
    corr_impl: str = "auto"
    deconv_impl: str = "native"  # accepted, ignored
    conv_impl: str = "native"  # accepted, ignored
    remat: bool = False  # accepted, ignored
    num_devices: int = 0
    spatial_shards: int = 1
    seed: int = 0

    def loss_weights(self) -> dict[str, float]:
        return {
            "occ": self.occ_weight,
            "sym": self.sym_weight,
            "fb": self.fb_weight,
            "grad": self.grad_weight,
            "ternary": self.ternary_weight,
            "photo": self.photo_weight,
            "smooth_1st": self.smooth_1st_weight,
            "smooth_2nd": self.smooth_2nd_weight,
        }


@dataclasses.dataclass
class DirsConfig:
    data: str = "data"
    log: str = "log"


@dataclasses.dataclass
class Config:
    dirs: DirsConfig = dataclasses.field(default_factory=DirsConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def experiment_dir(self, name: str) -> Path:
        return Path(self.dirs.log) / "ex" / name


_TYPES = {"str": str, "int": int, "float": float, "bool": bool}
_FIELD_TYPES = {
    f.name: tuple if f.name == "finetune" else _TYPES[f.type]
    for f in dataclasses.fields(TrainConfig)
}


def _coerce(value: str, field_type):
    if field_type is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if field_type is tuple:
        return tuple(v.strip() for v in value.split(",") if v.strip())
    return field_type(value)


def load_config(path: str | Path, dataset_overrides: bool = True) -> Config:
    """Parse an INI config; ``[train_<dataset>]`` overrides ``[train]``."""
    parser = configparser.ConfigParser()
    if not parser.read(str(path)):
        raise FileNotFoundError(path)

    cfg = Config()
    if parser.has_section("dirs"):
        for key, val in parser.items("dirs"):
            if hasattr(cfg.dirs, key):
                setattr(cfg.dirs, key, val)

    def apply(section):
        for key, val in parser.items(section):
            if key not in _FIELD_TYPES:
                raise KeyError(f"unknown config key [{section}] {key}")
            setattr(cfg.train, key, _coerce(val, _FIELD_TYPES[key]))

    if parser.has_section("train"):
        apply("train")
    if dataset_overrides:
        override = f"train_{cfg.train.dataset}"
        if parser.has_section(override):
            apply(override)
    return cfg


def save_config(cfg: Config, path: str | Path) -> None:
    parser = configparser.ConfigParser()
    parser["dirs"] = dataclasses.asdict(cfg.dirs)
    parser["train"] = {
        key: ",".join(val) if isinstance(val, tuple) else str(val)
        for key, val in dataclasses.asdict(cfg.train).items()
    }
    # Atomic write (tmp + rename): a reader never sees a truncated snapshot.
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        parser.write(f)
    tmp.replace(path)


def prepare_experiment_dir(cfg: Config, name: str) -> Path:
    """Create (or reuse) the experiment dir and snapshot the config into it.

    The snapshot is written from the *resolved* ``cfg`` (after ``--set``
    overrides), never copied from the raw file; an existing snapshot is left
    as it is.
    """
    ex_dir = cfg.experiment_dir(name)
    snapshot = ex_dir / "config.ini"
    ex_dir.mkdir(parents=True, exist_ok=True)
    if not snapshot.exists():
        save_config(cfg, snapshot)
    return ex_dir
