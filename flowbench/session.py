"""One run's share of the work: its cell, its configuration and traffic, its
device, the seeds drawn from ``--seed`` and its scratch directory."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass
class Session:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: Path
    t0: float  # process start, host clock (time.time)
    overrides: dict = dataclasses.field(default_factory=dict)  # tests: smaller sizes

    def seeds(self) -> dict[str, int]:
        """Independent 31-bit seeds of the run's parts, from ``--seed``."""
        words = np.random.SeedSequence(self.seed).generate_state(4)
        return {k: int(w) & 0x7FFFFFFF for k, w in zip(("frames", "weights", "config", "sample"), words)}

    def train_keys(self) -> dict:
        return {**self.config["train"], **self.overrides}

    def port_config(self):
        """The port's ``Config`` holding the configuration file's train keys."""
        from unflow_tpu_torch.config import Config

        cfg = Config()
        for key, value in self.train_keys().items():
            if not hasattr(cfg.train, key):
                raise KeyError(f"the port has no train key {key!r}")
            setattr(cfg.train, key, tuple(value) if key == "finetune" else value)
        return cfg

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
