"""Training loop of the UnFlow recipe, its cascades and supervised training.

Port of ``unflow_tpu/train/trainer.py`` (``build_model``, ``build_optimizer``,
``TrainState``, ``make_train_step``, ``Trainer``): augmentation on the device
(order swap, affine, crop/flip, photometric); for unsupervised training one
apply of the stack (C, cS, csS, CSS ...) on the interleaved forward/backward
2x batch and the 5-scale unsupervised loss of the last stage (of every stage
with ``train_all``); for ``supervised`` training one forward apply and the
multi-scale EPE against the ground truth; backward and Adam with a
piecewise-halved learning rate. The step is a plain function that updates
the model and the optimizer of its :class:`TrainState` in place; there is no
jit and no mesh. On one GPU everything after the augmentation is captured
once as a CUDA graph and replayed (``train/graph.py``), elsewhere dispatched
eagerly. The :class:`Trainer` initializes the
stages of a fresh experiment from the ``finetune`` experiments, resumes an
experiment from its latest checkpoint, saves every ``save_interval``
steps (``train/checkpoint.py``), given an ``eval_fn`` evaluates every
``eval_interval`` steps, writes image summaries and, with ``tensorboard``,
mirrors its logs into a tfevents file.

Under ``torchrun`` (one process per GPU, ``parallel/``) each process trains
on its rows of the global batch, draws the augmentation of the whole global
batch and keeps its own rows (so that the processes draw what one process
would), and ``DistributedDataParallel`` averages the gradients; the losses
are means over equal-size local batches, so the average is the gradient of
the global batch. The lead process alone writes metrics (averaged over the
processes), tensorboard and checkpoints; image summaries are off.

With ``spatial_shards = S`` (W-sharding, ``parallel/spatial.py``) the
processes form a grid of ``N / S`` data ranks times ``S`` spatial ranks. The
ranks of a spatial group load the same rows, augment the full frames alike
(the draws depend on the step alone) and cut them to their W-slabs; the
network, the loss and the backward pass run inside a ``SpatialContext``. The
step's loss terms are this rank's parts of the global means, summed over the
group in one all-reduce whose backward carries a factor ``S``, so that DDP's
average over all ``N`` ranks is the data-parallel mean of the global loss.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
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
from unflow_tpu_torch.parallel import (
    SpatialContext,
    barrier,
    check_grid,
    check_num_devices,
    data_shard,
    init_grid,
    is_lead_process,
    process_shard,
    wrap_model,
)
from unflow_tpu_torch.parallel.spatial import slab, sum_over_spatial
from unflow_tpu_torch.train.checkpoint import CheckpointManager, init_stages_from
from unflow_tpu_torch.train.graph import StepGraph
from unflow_tpu_torch.train.schedule import piecewise_halving
from unflow_tpu_torch.train.summaries import ImageSummaryWriter
from unflow_tpu_torch.utils import MetricsLogger
from unflow_tpu_torch.utils.profiling import count, device_step, read_device_steps, span


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place: the parameters (float32, in the
    model), Adam's moments (in the optimizer) and the host-side step count.
    ``model`` is what the step calls: the network, or under several
    processes its ``DistributedDataParallel`` wrapper."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def build_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam as ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the root)
    over the parameters that require a gradient; frozen ones get no state.
    ``weight_decay`` is the coupled L2 term, added to the gradient before
    Adam (``optax.add_decayed_weights``). The learning rate of each update is
    set by the train step from the schedule.

    On a GPU Adam is capturable: its step counts live on the device and its
    learning rate is a 0-d device tensor that the train step writes, so that
    a CUDA graph of the update (``train/graph.py``) replays with each step's
    rate."""
    t = cfg.train
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError(f"flownet spec {t.flownet!r} leaves no parameter to train")
    hyper = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": t.weight_decay}
    device = params[0].device
    if device.type == "cuda":
        lr = torch.tensor(t.learning_rate, dtype=torch.float32, device=device)
        return torch.optim.Adam(params, lr=lr, capturable=True, **hyper)
    return torch.optim.Adam(params, lr=t.learning_rate, **hyper)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every parameter group: into its device tensor where
    Adam holds one (a graph of the update reads it there), else as a
    float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def replays_as_graph(device: torch.device, processes: int, spatial_shards: int) -> bool:
    """Whether the train step's update is captured once as a CUDA graph and
    replayed (``train/graph.py``), else dispatched eagerly each step."""
    return (
        device.type == "cuda"
        # DDP's gradient all-reduce runs from hooks inside the backward pass
        and processes == 1
        # W-sharding's halo exchanges and sums are gloo collectives on the host
        and spatial_shards == 1
    )


def _check_parallel(cfg: Config) -> None:
    """Raise ``ValueError`` for a ``num_devices`` other than the processes of
    this run, or for ``spatial_shards`` that do not fit them or the width."""
    t = cfg.train
    check_num_devices(t.num_devices)
    check_grid(t.spatial_shards, t.width)


def freeze_stages(model: FlowNetStack, spec: str) -> None:
    """A lowercase stage of ``spec`` is frozen: no gradient, no optimizer
    state, no part in the gradient average."""
    for i, ch in enumerate(spec):
        if ch.islower():
            for name, p in model.named_parameters():
                if name.startswith(f"stage{i}_"):
                    p.requires_grad_(False)


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


def _rows(params, lo: int, hi: int):
    """Rows ``lo:hi`` of every per-example tensor of a parameter set."""
    if isinstance(params, torch.Tensor):
        return params[lo:hi]
    if isinstance(params, dict):
        return {k: _rows(v, lo, hi) for k, v in params.items()}
    if hasattr(params, "_fields"):  # a NamedTuple
        return type(params)(*(_rows(v, lo, hi) for v in params))
    return [_rows(v, lo, hi) for v in params]


def make_train_step(
    cfg: Config,
    normalization=DEFAULT_NORMALIZATION,
    draws: Callable[[int], dict] | None = None,
    shard: tuple[int, int] | None = None,
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

    ``shard`` is ``(rank, processes)`` of the data ranks (by default this
    process's, ``parallel.data_shard()``): ``batch`` is then this process's
    rows of a global batch of ``B x processes`` pairs, the per-example draws
    (and those ``draws`` returns) are of the global batch, and the step keeps
    rows ``rank x B`` to ``(rank + 1) x B`` of them.

    With ``spatial_shards > 1`` (several processes), the augmented frames are
    cut to this rank's W-slab and the rest of the step runs in its
    ``SpatialContext``.

    The augmentation runs eagerly. The rest of the step (the network, the
    loss, the backward pass, the clip and Adam) runs as a CUDA graph where
    :func:`replays_as_graph` admits it (one process on a GPU): the first step
    eagerly, the second captured and replayed, every later one replayed
    (``train/graph.py``; one graph per optimizer). Elsewhere, and for a step
    whose frames differ in shape or dtype from the captured ones, it is
    dispatched eagerly. ``train_step.eager(state, batch)`` takes a step
    eagerly on any device. Each step counts ``train.steps``, each replayed one
    ``train.graph_replays`` (``utils/profiling.py::count``). On a GPU the
    network's stages and the glue between them are timed on the device
    (``device_span``) in every step but the graph's warm-up, replayed or not,
    and read into the counters ``device_us.*`` once the device has passed
    them.
    """
    _check_parallel(cfg)
    t = cfg.train
    grid = init_grid(t.spatial_shards)
    rank, processes = shard if shard is not None else data_shard()
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

    def augment(state: TrainState, batch: dict, device) -> list:
        """The step's draws applied to the batch: the normalized network
        inputs, the un-jittered frames the loss sees, and the ground truth
        and mask of supervised training, as ``(B, C, H, W)`` views."""
        generator = torch.Generator(device=device).manual_seed(_step_seed(t.seed, state.step))
        given = draws(state.step) if draws is not None else {}

        im1, im2 = as_float(batch["im1"]), as_float(batch["im2"])
        b, h, w = im1.shape[:3]
        lo, hi = rank * b, (rank + 1) * b  # this process's rows of the global draws
        if t.aug_swap_prob:
            swap = given.get("swap")
            if swap is None:
                swap = sample_order_swap_params(generator, b * processes, t.aug_swap_prob)
            im1, im2 = apply_order_swap(im1, im2, _rows(swap, lo, hi))
        gt = [batch["flow"]] if t.supervised else None
        masks = [batch["mask"]] if t.supervised and "mask" in batch else None
        if ranges is not None:
            # at the loaded size, so that the crop sees the transformed
            # frames; may synthesize a mask where the pull-back leaves the
            # frame
            params = given.get("affine")
            if params is None:
                params = sample_affine_params(generator, b * processes, (h, w), **ranges)
            (im1, im2), gt, masks = apply_affine(_rows(params, lo, hi), [im1, im2], gt, masks)
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
                params = sample_photometric_params(
                    generator, (b * processes, *im1.shape[1:]), 2, t.aug_noise_stddev)
            p1, p2 = apply_photometric([im1, im2], _rows(params, lo, hi))
        else:
            p1, p2 = im1, im2
        n1 = nchw(normalize(p1, mean, stddev))
        n2 = nchw(normalize(p2, mean, stddev))
        gt = nchw(gt[0]) if t.supervised else None
        mask = None if mask is None else nchw(mask)
        return [n1, n2, nchw(im1), nchw(im2), gt, mask]

    graphs = weakref.WeakKeyDictionary()  # optimizer -> its StepGraph

    def take_step(state: TrainState, batch: dict, graph: bool) -> dict:
        device = batch["im1"].device
        count("train.steps")
        with span("unflow.train.augment"):
            frames = augment(state, batch, device)
            if grid is not None:
                # every rank of the group augmented the same full frames:
                # each keeps its W-slab of them
                ctx = SpatialContext.of(grid, t.width)
                frames = [None if x is None else slab(x, ctx) for x in frames]
        lr = schedule(state.step)
        set_lr(state.optimizer, lr)
        if grid is not None:
            with ctx, device_step():
                logs = finish(state, *frames, device)
        elif graph and replays_as_graph(device, process_shard()[1], t.spatial_shards):
            runner = graphs.get(state.optimizer)
            if runner is None:
                runner = graphs[state.optimizer] = StepGraph(finish, device)
            logs, replayed = runner(state, frames, device)
            if replayed:
                count("train.graph_replays")
        else:
            with device_step():
                logs = finish(state, *frames, device)
        state.step += 1
        logs["lr"] = torch.tensor(lr, dtype=torch.float64)
        read_device_steps()  # the earlier steps', while the device works on this one
        return logs

    def finish(state, n1, n2, im1, im2, gt, mask, device) -> dict:
        """The network, the loss, its backward and Adam (at the learning rate
        last set) on the augmented ``(B, C, H, W)`` frames (a W-slab of them
        inside a context); the logs as 0-d device tensors, ``loss`` and
        ``grad_norm`` among them."""
        model, optimizer = state.model, state.optimizer
        logs: dict[str, torch.Tensor] = {}
        with span("unflow.train.forward"):
            if t.supervised:
                stages = model(n1, n2)
            else:
                # One apply at 2x batch gives forward AND backward flow: rows
                # 2i and 2i+1 are the (fw, bw) pair of example i, and the
                # second argument is the first with each pair swapped, so the
                # tower runs once.
                stages = model(interleave(n1, n2), interleave(n2, n1), pair_flipped_im2=True)
        with span("unflow.train.loss"):
            if t.supervised:
                loss, logs = supervised_loss(stages[-1], gt, mask)
            else:
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
            if grid is not None:
                # this rank's parts of the global means: one all-reduce sums
                # them, the total with them
                keys = list(logs)
                summed = sum_over_spatial(torch.stack([logs[k].float() for k in keys] + [loss]))
                logs = dict(zip(keys, summed[:-1].unbind(0)))
                loss = summed[-1]

        with span("unflow.train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("unflow.train.adam"):
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
            optimizer.step()

        logs = {k: v.detach() for k, v in logs.items()}
        logs["loss"] = loss.detach()
        logs["grad_norm"] = grad_norm
        return logs

    def train_step(state: TrainState, batch: dict) -> dict:
        return take_step(state, batch, graph=True)

    train_step.eager = lambda state, batch: take_step(state, batch, graph=False)
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

    Under several processes (``torchrun``; ``device`` is then this
    process's GPU) every process restores the checkpoint, the model is
    wrapped in ``DistributedDataParallel`` after the freeze and the restore,
    and the lead alone writes ``metrics.jsonl``, tensorboard and
    checkpoints and evaluates (on the unwrapped model) while the others
    wait; the logs are averaged over the processes at each display step,
    and image summaries are off, as in the JAX package.
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
        freeze_stages(model, t.flownet)
        model = model.to(device=self.device, memory_format=torch.channels_last).train()
        self.state = TrainState(model, build_optimizer(cfg, model))
        if latest is not None:  # every process restores
            self.state.step = self.ckpt.restore(model, self.state.optimizer)
        self._model = model
        self.state.model = wrap_model(model, self.device)
        self._processes = process_shard()[1]
        self._data_ranks = data_shard()[1]  # the ranks of a spatial group share rows
        self._lead = is_lead_process()
        self.logger = MetricsLogger(self.exp_dir) if self._lead else None
        self.eval_fn = eval_fn
        self._tb = None
        if t.tensorboard and self._lead:
            from unflow_tpu_torch.utils.tensorboard import EventWriter

            self._tb = EventWriter(self.exp_dir / "tb")
        self._summary_interval = (
            t.display_interval if t.image_summary_interval == 0 else t.image_summary_interval
        )
        # several processes: no image summaries (the lead's forward alone
        # would see one slice of the batch), as in the JAX package
        self._summaries = (
            ImageSummaryWriter(self.exp_dir, normalization, event_writer=self._tb)
            if self._summary_interval > 0 and self._processes == 1 else None
        )

    @property
    def model(self) -> FlowNetStack:
        """The network (unwrapped under several processes)."""
        return self._model

    @property
    def step(self) -> int:
        return self.state.step

    def put_batch(self, batch: dict) -> dict:
        """Copy the frames of one host batch (and the ground truth of a
        supervised one) to the device."""
        keys = ("im1", "im2", "flow", "mask") if self.cfg.train.supervised else ("im1", "im2")
        with span("unflow.train.put_batch"):
            return {
                key: torch.from_numpy(np.ascontiguousarray(batch[key])).to(self.device,
                                                                           non_blocking=True)
                for key in keys if key in batch
            }

    def train_step(self, batch: dict) -> dict:
        """Copy one host batch to the device and take one step on it; returns
        the step's logs as 0-d tensors, without waiting for the device. Under
        a ``torch.profiler`` profile the step is the span
        ``unflow.train.step`` (unit: the step count), with the phases
        ``put_batch``, ``augment``, ``forward``, ``loss``, ``backward`` and
        ``adam`` as its children; a replayed step has ``replay`` in place of
        the last four."""
        with span("unflow.train.step", self.state.step):
            return self._step_fn(self.state, self.put_batch(batch))

    def _sync(self) -> None:
        """Wait for the queued steps before a pause of the throughput
        window, so that they stay in the window and only the pause leaves
        it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save(self) -> None:
        """Checkpoint the model, the optimizer and the step (the lead
        process writes; every process returns once it is written)."""
        if self._lead:
            self.ckpt.save(self.state.step, self.model, self.state.optimizer)
        barrier()

    def _global_logs(self, logs: dict) -> dict:
        """The logs as floats; under several processes the loss terms are
        averaged over them (each is a mean over equal-size local batches, so
        this is the global batch's), in one all-reduce. ``grad_norm`` (of the
        averaged gradients) and ``lr`` are the same on every process."""
        if self._processes == 1:
            return {k: float(v) for k, v in logs.items()}
        keys = [k for k in logs if k not in ("grad_norm", "lr")]
        values = torch.stack([logs[k].float() for k in keys])
        torch.distributed.all_reduce(values)
        record = {k: float(v) for k, v in zip(keys, values / self._processes)}
        record.update({k: float(logs[k]) for k in ("grad_norm", "lr")})
        return record

    def run(self, max_iters: int | None = None) -> dict:
        """Train until ``cfg.train.num_iters`` (or ``max_iters``),
        checkpointing every ``save_interval`` steps and at the end. Returns
        the last step's logs as floats (averaged over the processes).
        Rerunning on the same experiment resumes from its latest checkpoint.

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
        record: dict = {}
        pairs_accum, t_last, pause_s = 0, time.perf_counter(), 0.0
        while self.state.step < target:
            batch = next(self.batches)
            logs = self.train_step(batch)
            batch_size = batch["im1"].shape[0] * self._data_ranks  # the global batch
            pairs_accum += batch_size
            if self.state.step % t.display_interval == 0:
                record = self._global_logs(logs)  # waits for the device
                now = time.perf_counter()
                work_s = max(now - t_last - pause_s, 1e-9)
                record["pairs_per_sec"] = pairs_accum / work_s
                record["step_ms"] = 1e3 * work_s / max(pairs_accum / max(batch_size, 1), 1)
                if self._lead:
                    self.logger.log(self.state.step, record)
                if self._tb is not None:
                    self._tb.scalars(record, self.state.step)
                    self._tb.flush()
                # the window restarts after the write, which leaves that pause out
                pairs_accum, t_last, pause_s = 0, time.perf_counter(), 0.0
            if self._summaries is not None and self.state.step % self._summary_interval == 0:
                self._sync()
                t0 = time.perf_counter()
                self._summaries.write(self.state.step, self.model, batch)
                pause_s += time.perf_counter() - t0
            if self.eval_fn is not None and t.eval_interval and self.state.step % t.eval_interval == 0:
                self._sync()
                t0 = time.perf_counter()
                if self._lead:  # on the unwrapped model: its forward is no collective
                    metrics = self.eval_fn(self.model)
                    eval_record = {f"eval/{k}": v for k, v in metrics.items()}
                    self.logger.log(self.state.step, eval_record)
                    if self._tb is not None:
                        self._tb.scalars(eval_record, self.state.step)
                        self._tb.flush()
                barrier()
                pause_s += time.perf_counter() - t0
            if self.state.step % t.save_interval == 0 or self.state.step >= target:
                self._sync()
                t0 = time.perf_counter()
                self.save()
                pause_s += time.perf_counter() - t0
        if self.ckpt.latest_step() != self.state.step:
            self.save()
        if logs and self.state.step % t.display_interval:  # not read at a display step
            record = self._global_logs(logs)
        return {k: record[k] for k in logs}
