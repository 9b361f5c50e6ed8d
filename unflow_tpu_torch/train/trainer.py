"""Training loop of the UnFlow recipe, its cascades and supervised training.

Port of ``unflow_tpu/train/trainer.py`` (``build_model``, ``build_optimizer``,
``TrainState``, ``make_train_step``, ``Trainer``): augmentation on the device
(order swap, affine, crop/flip, photometric); for unsupervised training one
apply of the stack (C, cS, csS, CSS ...) on the interleaved forward/backward
2x batch and the 5-scale unsupervised loss of the last stage (of every stage
with ``train_all``); for ``supervised`` training one forward apply and the
multi-scale EPE against the ground truth; backward and Adam with a
piecewise-halved learning rate. PyTorch runs eagerly, so the step is a plain
function that updates the model and the optimizer of its :class:`TrainState`
in place; there is no jit and no mesh. The :class:`Trainer` initializes the
stages of a fresh experiment from the ``finetune`` experiments, resumes an
experiment from its latest checkpoint, saves every ``save_interval``
steps (``train/checkpoint.py``), given an ``eval_fn`` evaluates every
``eval_interval`` steps, writes image summaries and, with ``tensorboard``,
mirrors its logs into a tfevents file. Several devices are not ported yet
(ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from unflow_tpu_torch.augment import (
    apply_affine,
    apply_crop_flip,
    apply_order_swap,
    apply_photometric,
    normalize,
    sample_affine_params,
    sample_crop_flip_params,
    sample_order_swap_params,
    sample_photometric_params,
)
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.losses import supervised_loss, unsupervised_loss
from unflow_tpu_torch.models import FlowNetStack, build_model, init_params
from unflow_tpu_torch.train.checkpoint import CheckpointManager, init_stages_from
from unflow_tpu_torch.train.schedule import piecewise_halving
from unflow_tpu_torch.train.summaries import ImageSummaryWriter
from unflow_tpu_torch.utils import MetricsLogger


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
    if t.num_devices > 1 or t.spatial_shards > 1:
        raise NotImplementedError("training on several devices is not ported yet: ROADMAP item A13")


def affine_ranges(cfg: Config) -> dict | None:
    """The keyword ranges of :func:`sample_affine_params` of ``cfg``, or None
    when every one leaves the frames as they are."""
    t = cfg.train
    ranges = {
        "translate": t.aug_translate,
        "rotate_deg": t.aug_rotate,
        "zoom_min": t.aug_zoom_min,
        "zoom_max": t.aug_zoom_max,
        "rel_translate": t.aug_rel_translate,
        "rel_rotate_deg": t.aug_rel_rotate,
        "rel_zoom": t.aug_rel_zoom,
    }
    off = {**{k: 0.0 for k in ranges}, "zoom_min": 1.0, "zoom_max": 1.0}
    return None if ranges == off else ranges


def _step_seed(seed: int, step: int) -> int:
    """One generator seed per (config seed, step), so a step's randomness
    depends on those two alone."""
    return (seed * 1_000_003 + step) % (2**63)


def make_train_step(
    cfg: Config,
    normalization=DEFAULT_NORMALIZATION,
    draws: Callable[[int], dict] | None = None,
) -> Callable[[TrainState, dict], dict]:
    """Returns ``train_step(state, batch) -> logs``.

    ``batch``: ``im1``, ``im2`` as ``(B, H, W, 3)`` tensors on the model's
    device, float in [0, 1] or uint8, any size >= (height, width), and for
    ``supervised`` training ``flow`` ``(B, H, W, 2)`` and optionally
    ``mask`` ``(B, H, W, 1)``. The step augments on the device, updates
    ``state`` in place and returns 0-d tensors: the loss terms, ``loss``,
    ``grad_norm`` (global norm of the raw gradients, before clipping) and
    ``lr``. Nothing in it reads a value back to the host.

    ``draws`` is a seam for tests: ``draws(step)`` returns augmentation
    parameters by name (``swap``, ``affine``, ``crop_flip``,
    ``photometric``, in the layout of the ``sample_*_params`` functions),
    which the step then uses in place of its own draws.
    """
    _check_ported(cfg)
    t = cfg.train
    if t.aug_swap_prob and t.supervised:
        # swapping the frames inverts the motion, and ground truth has one
        # direction
        raise ValueError("aug_swap_prob requires unsupervised training")
    weights = t.loss_weights()
    mean, stddev = normalization
    crop_hw = (t.height, t.width)
    ranges = affine_ranges(cfg)
    schedule = piecewise_halving(t.learning_rate, t.decay_after, t.decay_interval)

    def as_float(im: torch.Tensor) -> torch.Tensor:
        # uint8 batches: the f32/255 conversion is exact, at a quarter of the
        # bytes copied to the device
        return im.float() / 255.0 if im.dtype == torch.uint8 else im

    def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.stack([a, b], 1).reshape(2 * a.shape[0], *a.shape[1:])

    def nchw(x: torch.Tensor) -> torch.Tensor:
        # an NHWC -> NCHW view: channels_last memory, what the convs want
        return x.permute(0, 3, 1, 2)

    def train_step(state: TrainState, batch: dict) -> dict:
        model, optimizer = state.model, state.optimizer
        device = batch["im1"].device
        generator = torch.Generator(device=device).manual_seed(_step_seed(t.seed, state.step))
        given = draws(state.step) if draws is not None else {}

        im1, im2 = as_float(batch["im1"]), as_float(batch["im2"])
        b, h, w = im1.shape[:3]
        if t.aug_swap_prob:
            swap = given.get("swap")
            if swap is None:
                swap = sample_order_swap_params(generator, b, t.aug_swap_prob)
            im1, im2 = apply_order_swap(im1, im2, swap)
        gt = [batch["flow"]] if t.supervised else None
        masks = [batch["mask"]] if t.supervised and "mask" in batch else None
        if ranges is not None:
            # at the loaded size, so that the crop sees the transformed
            # frames; may synthesize a mask where the pull-back leaves the
            # frame
            params = given.get("affine")
            if params is None:
                params = sample_affine_params(generator, b, (h, w), **ranges)
            (im1, im2), gt, masks = apply_affine(params, [im1, im2], gt, masks)
        # the mask rides the image list: one crop/flip draw for all
        params = given.get("crop_flip")
        if params is None:
            params = sample_crop_flip_params(generator, (h, w), crop_hw, t.aug_hflip)
        cropped, gt = apply_crop_flip([im1, im2] + (masks or []), params, crop_hw, gt)
        im1, im2 = cropped[:2]
        mask = cropped[2] if masks else None
        # Photometric augmentation feeds the network only; the loss sees the
        # un-jittered pair.
        if t.aug_photometric:
            params = given.get("photometric")
            if params is None:
                params = sample_photometric_params(generator, im1.shape, 2, t.aug_noise_stddev)
            p1, p2 = apply_photometric([im1, im2], params)
        else:
            p1, p2 = im1, im2
        n1 = nchw(normalize(p1, mean, stddev))
        n2 = nchw(normalize(p2, mean, stddev))

        logs: dict[str, torch.Tensor] = {}
        if t.supervised:
            stages = model(n1, n2)
            loss, logs = supervised_loss(
                stages[-1], nchw(gt[0]), None if mask is None else nchw(mask)
            )
        else:
            im1, im2 = nchw(im1), nchw(im2)
            # One apply at 2x batch gives forward AND backward flow: rows 2i
            # and 2i+1 are the (fw, bw) pair of example i, and the second
            # argument is the first with each pair swapped, so the tower runs
            # once.
            stages = model(interleave(n1, n2), interleave(n2, n1), pair_flipped_im2=True)
            stage_ids = range(len(stages)) if t.train_all else [len(stages) - 1]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for si in stage_ids:
                stage_total, stage_logs = unsupervised_loss(
                    im1, im2, [f[0::2] for f in stages[si]], [f[1::2] for f in stages[si]],
                    weights=weights, mask_occlusion=t.mask_occlusion,
                    border_ratio=t.border_ratio,
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

    Image summaries of the current batch are written every
    ``image_summary_interval`` steps (0: every ``display_interval``; -1:
    never) under ``<exp_dir>/summaries/``; with ``tensorboard`` the logs,
    evaluations and images also go to a tfevents file under
    ``<exp_dir>/tb/``.
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
        self._tb = None
        if t.tensorboard:
            from unflow_tpu_torch.utils.tensorboard import EventWriter

            self._tb = EventWriter(self.exp_dir / "tb")
        self._summary_interval = (
            t.display_interval if t.image_summary_interval == 0 else t.image_summary_interval
        )
        self._summaries = (
            ImageSummaryWriter(self.exp_dir, normalization, event_writer=self._tb)
            if self._summary_interval > 0 else None
        )

    @property
    def model(self) -> FlowNetStack:
        return self.state.model

    @property
    def step(self) -> int:
        return self.state.step

    def put_batch(self, batch: dict) -> dict:
        """Copy the frames of one host batch (and the ground truth of a
        supervised one) to the device."""
        keys = ("im1", "im2", "flow", "mask") if self.cfg.train.supervised else ("im1", "im2")
        return {
            key: torch.from_numpy(np.ascontiguousarray(batch[key])).to(self.device, non_blocking=True)
            for key in keys if key in batch
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
        evaluations, the image summaries and the saves in the window is left
        out.
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
                if self._tb is not None:
                    self._tb.scalars(record, self.state.step)
                    self._tb.flush()
                # the window restarts after the write, which leaves that pause out
                pairs_accum, t_last, pause_s = 0, time.perf_counter(), 0.0
            if self._summaries is not None and self.state.step % self._summary_interval == 0:
                self._sync()
                t0 = time.perf_counter()
                self._summaries.write(self.state.step, self.state.model, batch)
                pause_s += time.perf_counter() - t0
            if self.eval_fn is not None and t.eval_interval and self.state.step % t.eval_interval == 0:
                self._sync()
                t0 = time.perf_counter()
                metrics = self.eval_fn(self.state.model)
                eval_record = {f"eval/{k}": v for k, v in metrics.items()}
                self.logger.log(self.state.step, eval_record)
                if self._tb is not None:
                    self._tb.scalars(eval_record, self.state.step)
                    self._tb.flush()
                pause_s += time.perf_counter() - t0
            if self.state.step % t.save_interval == 0 or self.state.step >= target:
                self._sync()
                t0 = time.perf_counter()
                self.save()
                pause_s += time.perf_counter() - t0
        if self.ckpt.latest_step() != self.state.step:
            self.save()
        return {k: float(v) for k, v in logs.items()}
