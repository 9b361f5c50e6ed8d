"""Training loop of the unsupervised UnFlow recipe and its cascades.

Port of ``unflow_tpu/train/trainer.py`` (``build_model``, ``build_optimizer``,
``TrainState``, ``make_train_step``, ``Trainer``): augmentation on the device,
one apply of the stack (C, cS, csS, CSS ...) on the interleaved
forward/backward 2x batch, the 5-scale unsupervised loss of the last stage
(of every stage with ``train_all``), backward and Adam with a
piecewise-halved learning rate. PyTorch runs eagerly, so the step is a plain
function that updates the model and the optimizer of its :class:`TrainState`
in place; there is no jit and no mesh. The :class:`Trainer` initializes the
stages of a fresh experiment from the ``finetune`` experiments, resumes an
experiment from its latest checkpoint, saves every ``save_interval``
steps (``train/checkpoint.py``) and, given an ``eval_fn``, evaluates every
``eval_interval`` steps. Not ported yet, each raising or saying so when
asked for: ``supervised`` (ROADMAP A8), the affine augmentation, image
summaries, tensorboard and several devices (A13).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from unflow_tpu_torch.augment import (
    normalize,
    random_crop_flip,
    random_order_swap,
    random_photometric,
)
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.losses import unsupervised_loss
from unflow_tpu_torch.models import FlowNetStack, build_model, init_params
from unflow_tpu_torch.train.checkpoint import CheckpointManager, init_stages_from
from unflow_tpu_torch.train.schedule import piecewise_halving
from unflow_tpu_torch.utils import MetricsLogger

_AFFINE_DEFAULTS = {
    "aug_translate": 0.0, "aug_rotate": 0.0, "aug_zoom_min": 1.0, "aug_zoom_max": 1.0,
    "aug_rel_translate": 0.0, "aug_rel_rotate": 0.0, "aug_rel_zoom": 0.0,
}


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place: the parameters (float32, in the
    model), Adam's moments (in the optimizer) and the host-side step count."""

    model: FlowNetStack
    optimizer: torch.optim.Optimizer
    step: int = 0


def build_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam as ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the root)
    over the parameters that require a gradient; frozen ones get no state.
    ``weight_decay`` is the coupled L2 term, added to the gradient before
    Adam (``optax.add_decayed_weights``). The learning rate of each update is
    set by the train step from the schedule."""
    t = cfg.train
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError(f"flownet spec {t.flownet!r} leaves no parameter to train")
    return torch.optim.Adam(
        params, lr=t.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=t.weight_decay
    )


def _check_ported(cfg: Config) -> None:
    """Raise for config keys that ask for a part the port lacks."""
    t = cfg.train
    if t.supervised:
        raise NotImplementedError("supervised training is not ported yet: ROADMAP item A8")
    if any(getattr(t, key) != default for key, default in _AFFINE_DEFAULTS.items()):
        raise NotImplementedError("the affine augmentation is not ported yet: ROADMAP item A13")
    if t.tensorboard or t.image_summary_interval > 0:
        raise NotImplementedError(
            "image summaries and tensorboard are not ported yet: ROADMAP item A13"
        )
    if t.num_devices > 1 or t.spatial_shards > 1:
        raise NotImplementedError("training on several devices is not ported yet: ROADMAP item A13")


def _step_seed(seed: int, step: int) -> int:
    """One generator seed per (config seed, step), so a step's randomness
    depends on those two alone."""
    return (seed * 1_000_003 + step) % (2**63)


def make_train_step(
    cfg: Config, normalization=DEFAULT_NORMALIZATION
) -> Callable[[TrainState, dict], dict]:
    """Returns ``train_step(state, batch) -> logs``.

    ``batch``: ``im1``, ``im2`` as ``(B, H, W, 3)`` tensors on the model's
    device, float in [0, 1] or uint8, any size >= (height, width). The step
    crops, flips and jitters on the device, updates ``state`` in place and
    returns 0-d tensors: the loss terms, ``loss``, ``grad_norm`` (global norm
    of the raw gradients, before clipping) and ``lr``. Nothing in it reads a
    value back to the host.
    """
    _check_ported(cfg)
    t = cfg.train
    weights = t.loss_weights()
    mean, stddev = normalization
    crop_hw = (t.height, t.width)
    schedule = piecewise_halving(t.learning_rate, t.decay_after, t.decay_interval)

    def as_float(im: torch.Tensor) -> torch.Tensor:
        # uint8 batches: the f32/255 conversion is exact, at a quarter of the
        # bytes copied to the device
        return im.float() / 255.0 if im.dtype == torch.uint8 else im

    def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.stack([a, b], 1).reshape(2 * a.shape[0], *a.shape[1:])

    def train_step(state: TrainState, batch: dict) -> dict:
        model, optimizer = state.model, state.optimizer
        device = batch["im1"].device
        generator = torch.Generator(device=device).manual_seed(_step_seed(t.seed, state.step))

        im1, im2 = as_float(batch["im1"]), as_float(batch["im2"])
        if t.aug_swap_prob:
            im1, im2 = random_order_swap(generator, im1, im2, t.aug_swap_prob)
        (im1, im2), _ = random_crop_flip(generator, [im1, im2], crop_hw, t.aug_hflip)
        # Photometric augmentation feeds the network only; the loss sees the
        # un-jittered pair.
        if t.aug_photometric:
            p1, p2 = random_photometric(generator, [im1, im2], t.aug_noise_stddev)
        else:
            p1, p2 = im1, im2
        # NHWC -> NCHW views: channels_last memory, what the convs want
        n1 = normalize(p1, mean, stddev).permute(0, 3, 1, 2)
        n2 = normalize(p2, mean, stddev).permute(0, 3, 1, 2)
        im1, im2 = im1.permute(0, 3, 1, 2), im2.permute(0, 3, 1, 2)

        # One apply at 2x batch gives forward AND backward flow: rows 2i and
        # 2i+1 are the (fw, bw) pair of example i, and the second argument is
        # the first with each pair swapped, so the tower runs once.
        stages = model(interleave(n1, n2), interleave(n2, n1), pair_flipped_im2=True)
        stage_ids = range(len(stages)) if t.train_all else [len(stages) - 1]
        loss = torch.zeros((), dtype=torch.float32, device=device)
        logs: dict[str, torch.Tensor] = {}
        for si in stage_ids:
            stage_total, stage_logs = unsupervised_loss(
                im1, im2, [f[0::2] for f in stages[si]], [f[1::2] for f in stages[si]],
                weights=weights, mask_occlusion=t.mask_occlusion, border_ratio=t.border_ratio,
            )
            loss = loss + stage_total
            if len(stage_ids) > 1:
                logs.update({f"stage{si}/{k}": v for k, v in stage_logs.items()})
            else:
                logs.update(stage_logs)

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for group in optimizer.param_groups for p in group["params"]
                 if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        if t.grad_clip_norm > 0:
            # optax.clip_by_global_norm: g * max_norm / max(norm, max_norm)
            scale = t.grad_clip_norm / grad_norm.clamp(min=t.grad_clip_norm)
            for g in grads:
                g.mul_(scale)
        lr = schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        state.step += 1

        logs = {k: v.detach() for k, v in logs.items()}
        logs["loss"] = loss.detach()
        logs["grad_norm"] = grad_norm
        logs["lr"] = torch.tensor(lr, dtype=torch.float64)
        return logs

    return train_step


class Trainer:
    """End-to-end trainer over an experiment directory.

    Args:
      cfg: full config.
      exp_dir: experiment directory (``metrics.jsonl``, ``checkpoints/``). If
        it holds a checkpoint, the model, Adam's moments and the step are
        restored from the latest one.
      batch_iterator: infinite iterator of host batches ``{'im1', 'im2'}``,
        numpy ``(batch, H >= height, W >= width, 3)``, float32 in [0, 1] or
        uint8.
      normalization: (per-channel mean in [0, 255], scalar stddev).
      device: ``cuda`` unless given; with no GPU and no ``device="cpu"`` it
        raises.
      params: a ``state_dict`` to start from (for example from
        :func:`unflow_tpu_torch.convert.params_from_flax`); else the
        parameters are drawn from ``cfg.train.seed``.
      finetune_dirs: experiment directories whose checkpoints initialize the
        stages of a fresh start (:func:`init_stages_from`); by default those
        of ``cfg.train.finetune``, named under ``<log>/ex/``.
      eval_fn: ``eval_fn(model) -> {name: value}``, called every
        ``eval_interval`` steps (for example ``cli.train.build_eval_fn``);
        its values are logged as ``eval/<name>``.
    """

    def __init__(
        self,
        cfg: Config,
        exp_dir: str | Path,
        batch_iterator: Iterable[dict],
        normalization=DEFAULT_NORMALIZATION,
        device: torch.device | str | None = None,
        params: dict[str, torch.Tensor] | None = None,
        finetune_dirs: Iterable[str | Path] = (),
        eval_fn: Callable[[FlowNetStack], dict] | None = None,
    ):
        t = cfg.train
        self.cfg = cfg
        self.exp_dir = Path(exp_dir)
        self.batches = iter(batch_iterator)
        self.device = resolve_device(device)  # before the model: no GPU fails fast
        self._step_fn = make_train_step(cfg, normalization)

        model = build_model(cfg, "cpu")
        if params is None:
            init_params(model, torch.Generator().manual_seed(t.seed))
        else:
            model.load_state_dict(params)
        self.ckpt = CheckpointManager(self.exp_dir)
        latest = self.ckpt.latest_step()
        # the finetune stages initialize a fresh start only: a resume restores
        # every parameter from its own checkpoint below
        finetune_dirs = list(finetune_dirs) or [cfg.experiment_dir(name) for name in t.finetune]
        if latest is None and finetune_dirs:
            model.load_state_dict(init_stages_from(model.state_dict(), finetune_dirs))
        # before the optimizer is built, which restores Adam's state by
        # parameter order
        for i, ch in enumerate(t.flownet):
            if ch.islower():  # a frozen stage: no gradient, no optimizer state
                for name, p in model.named_parameters():
                    if name.startswith(f"stage{i}_"):
                        p.requires_grad_(False)
        model = model.to(device=self.device, memory_format=torch.channels_last).train()
        self.state = TrainState(model, build_optimizer(cfg, model))
        if latest is not None:
            self.state.step = self.ckpt.restore(model, self.state.optimizer)
        self.logger = MetricsLogger(self.exp_dir)
        self.eval_fn = eval_fn
        if t.image_summary_interval == 0:
            print("image summaries are not ported yet (ROADMAP item A13): none are written")

    @property
    def model(self) -> FlowNetStack:
        return self.state.model

    @property
    def step(self) -> int:
        return self.state.step

    def put_batch(self, batch: dict) -> dict:
        """Copy the frames of one host batch to the device."""
        return {
            key: torch.from_numpy(np.ascontiguousarray(batch[key])).to(self.device, non_blocking=True)
            for key in ("im1", "im2")
        }

    def train_step(self, batch: dict) -> dict:
        """Copy one host batch to the device and take one step on it; returns
        the step's logs as 0-d tensors, without waiting for the device."""
        return self._step_fn(self.state, self.put_batch(batch))

    def _sync(self) -> None:
        """Wait for the queued steps before a pause of the throughput
        window, so that they stay in the window and only the pause leaves
        it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save(self) -> None:
        """Checkpoint the model, the optimizer and the step."""
        self.ckpt.save(self.state.step, self.state.model, self.state.optimizer)

    def run(self, max_iters: int | None = None) -> dict:
        """Train until ``cfg.train.num_iters`` (or ``max_iters``),
        checkpointing every ``save_interval`` steps and at the end. Returns
        the last step's logs as floats. Rerunning on the same experiment
        resumes from its latest checkpoint.

        The step count lives on the host and no value is read back from the
        device between display intervals, so steps queue up on the device.
        At each display interval the logs are read (which waits for the
        device) and written to ``metrics.jsonl`` with ``pairs_per_sec`` and
        ``step_ms`` of the window since the last one; the time of the
        evaluations and the saves in the window is left out.
        """
        t = self.cfg.train
        target = min(max_iters or t.num_iters, t.num_iters)
        logs: dict = {}
        pairs_accum, t_last, pause_s = 0, time.perf_counter(), 0.0
        while self.state.step < target:
            batch = next(self.batches)
            logs = self.train_step(batch)
            batch_size = batch["im1"].shape[0]
            pairs_accum += batch_size
            if self.state.step % t.display_interval == 0:
                record = {k: float(v) for k, v in logs.items()}  # waits for the device
                now = time.perf_counter()
                work_s = max(now - t_last - pause_s, 1e-9)
                record["pairs_per_sec"] = pairs_accum / work_s
                record["step_ms"] = 1e3 * work_s / max(pairs_accum / max(batch_size, 1), 1)
                self.logger.log(self.state.step, record)
                # the window restarts after the write, which leaves that pause out
                pairs_accum, t_last, pause_s = 0, time.perf_counter(), 0.0
            if self.eval_fn is not None and t.eval_interval and self.state.step % t.eval_interval == 0:
                self._sync()
                t0 = time.perf_counter()
                metrics = self.eval_fn(self.state.model)
                self.logger.log(self.state.step, {f"eval/{k}": v for k, v in metrics.items()})
                pause_s += time.perf_counter() - t0
            if self.state.step % t.save_interval == 0 or self.state.step >= target:
                self._sync()
                t0 = time.perf_counter()
                self.save()
                pause_s += time.perf_counter() - t0
        if self.ckpt.latest_step() != self.state.step:
            self.save()
        return {k: float(v) for k, v in logs.items()}
