"""Checkpoints, resume and the stage initialization of a stacked finetune.

Port of ``unflow_tpu/train/checkpoint.py`` without orbax. An experiment keeps
its checkpoints in ``<exp_dir>/checkpoints/<step>.pt``, each one
``torch.save`` of ``{"step", "model", "optimizer"}`` (the model's and the
optimizer's ``state_dict``). A save writes a temporary file in the same
directory and renames it into place, so a crash leaves either the old set of
checkpoints or the new one, never a partial ``<step>.pt``.
:func:`init_stages_from` copies the stages of a stacked net (``stage0_C``,
``stage1_S`` ...) from earlier experiments' checkpoints: the ``finetune``
list of the C -> cS -> csS recipe.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Iterable

import torch


class CheckpointManager:
    """The checkpoints of one experiment; keeps the newest ``max_to_keep``."""

    def __init__(self, exp_dir: str | Path, max_to_keep: int = 3):
        self.directory = Path(exp_dir) / "checkpoints"
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        """Steps of the finished checkpoints, oldest first (temporary files of
        a save in flight are not among them)."""
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{step}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save({"step": step, "model": model.state_dict(),
                            "optimizer": optimizer.state_dict()}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.directory / f"{step}.pt")
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
        for old in self.steps()[: -self.max_to_keep]:
            (self.directory / f"{old}.pt").unlink(missing_ok=True)

    def load(self) -> dict:
        """The latest checkpoint, as saved, on the host."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.directory / f"{step}.pt", map_location="cpu", weights_only=True)

    def restore(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int:
        """Load the latest checkpoint into ``model`` and ``optimizer`` (built
        as when it was saved: the same parameters, in the same order, requiring
        a gradient) and return its step. ``load_state_dict`` copies the
        weights and Adam's moments to the parameters' device. How the
        optimizer holds its learning rate and step counts stays its own,
        whichever device saved the checkpoint: a capturable Adam (on a GPU,
        ``build_optimizer``) keeps its device tensor of the learning rate and
        its step counts on the device, any other its counts on the host."""
        ckpt = self.load()
        model.load_state_dict(ckpt["model"])
        own = [{k: g[k] for k in ("lr", "capturable") if k in g} for g in optimizer.param_groups]
        optimizer.load_state_dict(ckpt["optimizer"])
        for group, kept in zip(optimizer.param_groups, own):
            group.update(kept)
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                if "step" in state:
                    device = p.device if group.get("capturable") else "cpu"
                    state["step"] = state["step"].to(device)
        return ckpt["step"]


def restore_params(exp_dir: str | Path) -> dict:
    """The model's ``state_dict`` from an experiment's latest checkpoint, on
    the host."""
    return CheckpointManager(exp_dir).load()["model"]


def init_stages_from(state: dict[str, torch.Tensor],
                     finetune_exp_dirs: Iterable[str | Path]) -> dict[str, torch.Tensor]:
    """``state`` with its stages taken from earlier experiments' checkpoints.

    A later experiment in the list wins per stage (the recipe passes
    ``[C_exp, cS_exp]``, so cS's stage 0 and 1 take precedence); stages that a
    checkpoint lacks keep their values from ``state``. A source without a
    checkpoint raises ``FileNotFoundError``, a shape that differs from
    ``state``'s ``ValueError``.
    """
    state = dict(state)
    for exp_dir in finetune_exp_dirs:
        try:
            source = restore_params(exp_dir)
        except FileNotFoundError as e:
            raise FileNotFoundError(f"finetune experiment has no checkpoint: {exp_dir}") from e
        for key, value in source.items():
            if key in state:
                if value.shape != state[key].shape:
                    raise ValueError(f"finetune checkpoint {exp_dir}: {key} has shape "
                                     f"{tuple(value.shape)}, the model {tuple(state[key].shape)}")
                state[key] = value.to(state[key].dtype)
    return state
