"""Inference over frame pairs, and evaluation over a dataset.

Port of ``unflow_tpu/eval/evaluate.py::Evaluator``: ``predict`` and
``predict_batch`` send raw [0, 1] frames to the device, pad them there with
zeros to a multiple of 64, normalize them with the dataset's constants, run
the network, upsample its finest flow to the padded size and crop it back
before the copy to the host; on a GPU the network and the upsampling at
each input shape are replayed as a CUDA graph (:class:`ForwardGraphs`).
``run`` evaluates a list of examples in same-shape batches, averages AEE
and Fl (``eval/metrics.py``) over the examples with ground truth, with the
occluded / non-occluded breakdown where the examples carry one, and can
dump the flows as ``.flo``, KITTI 16-bit PNGs or color images.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from unflow_tpu_torch.augment import normalize
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.base import Example, load_example
from unflow_tpu_torch.data.io import write_flo, write_image, write_kitti_png_flow
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.eval.flow_viz import flow_error_image, flow_to_color
from unflow_tpu_torch.eval.metrics import flow_error_avg, outlier_fraction
from unflow_tpu_torch.models import DTYPES, FlowNetStack, build_model, full_res_flow
from unflow_tpu_torch.train.checkpoint import restore_params
from unflow_tpu_torch.utils.profiling import count, launch_counts, span


def predict_flow(
    model: FlowNetStack, im1: torch.Tensor, im2: torch.Tensor, normalization
) -> torch.Tensor:
    """NHWC frames in [0, 1] (H, W multiples of 64) -> NHWC full-resolution
    flow of the stack's last stage."""
    mean, std = normalization
    stages = model(
        normalize(im1, mean, std).permute(0, 3, 1, 2),
        normalize(im2, mean, std).permute(0, 3, 1, 2),
    )
    h, w = im1.shape[1:3]
    return full_res_flow(stages[-1], h, w).permute(0, 2, 3, 1)


def _padded_flow(model: FlowNetStack, inputs: torch.Tensor) -> torch.Tensor:
    """The network's two (B, 3, hp, wp) inputs stacked -> the (B, hp, wp, 2)
    flow upsampled at the padded size."""
    stages = model(inputs[0], inputs[1])
    hp, wp = inputs.shape[-2:]
    return full_res_flow(stages[-1], hp, wp).permute(0, 2, 3, 1)


# forward graphs kept at once; past it the least recently used one goes
GRAPH_CAP = 4


class ForwardGraphs:
    """``forward(inputs) -> output`` on a GPU, one CUDA graph per input shape.

    A key is what the code sees in its input: shape, dtype and device. The
    first call of a key runs eagerly on a side stream: it loads the kernels
    and makes cuDNN's plans and the allocator's blocks, none of which may
    first appear inside a capture. The second call of the key is captured
    and at once replayed, and so is every later one. Past :data:`GRAPH_CAP`
    keys the least recently used one is dropped with its graph, so a run
    over many shapes holds at most that many graphs; a key seen once stays
    eager.

    A replay copies the input into the graph's fixed buffer (which keeps
    the strides of the first input it captured) and returns the graph's own
    output, which the next replay of that key overwrites. The graph reads
    the parameters of ``forward``'s module where they were at the capture.
    The hand-written kernels' launch counters (the registry's
    ``launch_counts()``) count on the host at launch, which a replay skips:
    the launches counted while the graph was captured are taken back, and
    each replay adds them, so that the counters read a forward's launches on
    either path. Each replay adds
    one to the counter ``infer.graph_replays``.

    The graphs go when this object goes, so ``forward`` must hold nothing
    that holds it: in a reference cycle the graphs would wait for the
    cyclic collector, which may free them while another graph is being
    captured, and that breaks the capture.
    """

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor], device: torch.device):
        self._forward = forward
        self._stream = torch.cuda.Stream(device)
        # key -> (graph, input buffer, output, launches), or None once warmed up
        self._graphs: OrderedDict[tuple, tuple | None] = OrderedDict()

    def __len__(self) -> int:
        """The graphs held."""
        return sum(g is not None for g in self._graphs.values())

    def __call__(self, inputs: torch.Tensor) -> torch.Tensor:
        key = (tuple(inputs.shape), inputs.dtype, inputs.device)
        if key not in self._graphs:
            self._graphs[key] = None
            if len(self._graphs) > GRAPH_CAP:
                self._graphs.popitem(last=False)
            return self._warm_up(inputs)
        self._graphs.move_to_end(key)
        if self._graphs[key] is None:
            self._graphs[key] = self._capture(inputs)
        graph, buffer, out, launches = self._graphs[key]
        buffer.copy_(inputs)
        graph.replay()
        for name, n in launches.items():
            count(name, n)
        count("infer.graph_replays")
        return out

    def _warm_up(self, inputs: torch.Tensor) -> torch.Tensor:
        current = torch.cuda.current_stream(inputs.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = self._forward(inputs)
        current.wait_stream(self._stream)
        return out

    def _capture(self, inputs: torch.Tensor) -> tuple:
        buffer = torch.empty_like(inputs)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            out = self._forward(buffer)
        launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                    if n != before.get(k, 0)}
        for name, n in launches.items():  # a capture launches nothing: its replay counts
            count(name, -n)
        return graph, buffer, out, launches


class Evaluator:
    """The network of ``cfg`` with ``params``, a ``state_dict`` (for example
    from :func:`unflow_tpu_torch.convert.params_from_flax`), or else with the
    parameters of ``exp_dir``'s latest checkpoint. The parameters are cast
    once to the config's ``compute_dtype``."""

    def __init__(
        self,
        cfg: Config,
        exp_dir: str | Path | None = None,
        normalization=DEFAULT_NORMALIZATION,
        params: dict[str, torch.Tensor] | None = None,
        device: torch.device | str | None = None,
    ):
        if params is None:
            if exp_dir is None:
                raise ValueError("pass params= (a state_dict) or exp_dir= (an experiment)")
            params = restore_params(exp_dir)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.normalization = normalization
        mean, self.stddev = normalization
        # on the device once, so that a request copies no constant in
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.model = build_model(cfg, self.device)
        self.model.load_state_dict(params)
        self.model.to(DTYPES[cfg.train.compute_dtype]).eval()
        # over the model, not the Evaluator: ForwardGraphs says why
        self._forward = functools.partial(_padded_flow, self.model)
        if self.device.type == "cuda":
            self._forward = ForwardGraphs(self._forward, self.device)
            # present from the start, so that a GPU run with no replay reads 0
            count("infer.graph_replays", 0)

    def predict(self, im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        """Single unbatched pair (H, W, 3) -> (H, W, 2) flow; pads to /64."""
        return self.predict_batch(im1[None], im2[None])[0]

    def predict_batch(self, ims1: np.ndarray, ims2: np.ndarray) -> np.ndarray:
        """Same-shape pairs (B, H, W, 3) -> (B, H, W, 2); pads to /64.

        The frames are copied into one device buffer as they are (a
        contiguous float32 frame without a host copy; any other dtype is
        cast to float32 on the host first); frames of two shapes raise
        ``ValueError``. The device pads them with zeros to a multiple of 64
        where H or W is not one, normalizes them, runs the network,
        upsamples the flow at the padded size and crops it to (H, W); only
        the crop is copied back.

        On a GPU the network and the upsampling are replayed as a CUDA graph
        (:class:`ForwardGraphs`), keyed by the network input's shape (B, the
        padded H and W), dtype and device: the first request of a key runs
        eagerly, the second is captured and replayed, every later one
        replayed; at most :data:`GRAPH_CAP` graphs are kept, the least
        recently used dropped past it. A replay runs the same kernels on
        the same input as the eager forward, so its flow is the same. On
        the CPU every request runs eagerly.

        Under a ``torch.profiler`` profile the call is the span
        ``unflow.infer.request`` (unit: the request's number) with the
        children ``unflow.infer.h2d`` (both frames' copies in),
        ``unflow.infer.pad`` (the dispatch of the padding and the
        normalization), ``unflow.infer.forward`` (the network's dispatch,
        the upsampling and the crop; on a replay the copy into the graph's
        input buffer and its launch) and ``unflow.infer.d2h``
        (``flow.cpu()``: the wait for the device's queued work and the copy
        back). The counters ``infer.requests``, ``infer.padded_requests``
        (requests whose frames were padded), ``infer.h2d_bytes``,
        ``infer.d2h_bytes`` and, on a GPU, ``infer.graph_replays`` (requests
        whose forward was replayed) are always on."""
        if ims1.shape != ims2.shape:
            raise ValueError(f"frames of shapes {ims1.shape} and {ims2.shape}; a pair shares one")
        b, h, w, _ = ims1.shape
        hp = -(-h // 64) * 64
        wp = -(-w // 64) * 64
        with span("unflow.infer.request", count("infer.requests")), torch.inference_mode():
            with span("unflow.infer.h2d"):
                # both frames in one buffer, so that each step below runs once
                frames = torch.empty((2, b, h, w, 3), device=self.device)
                for dst, ims in zip(frames, (ims1, ims2)):
                    dst.copy_(torch.from_numpy(np.ascontiguousarray(ims, dtype=np.float32)))
            count("infer.h2d_bytes", frames.numel() * frames.element_size())
            with span("unflow.infer.pad"):
                inputs = self._network_input(frames, hp, wp)
            count("infer.padded_requests", int((hp, wp) != (h, w)))
            with span("unflow.infer.forward"):
                flow = self._forward(inputs)[:, :h, :w]
            with span("unflow.infer.d2h"):
                flow = flow.cpu()
            count("infer.d2h_bytes", flow.numel() * flow.element_size())
            return flow.numpy()

    def _network_input(self, frames: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        """(2, B, H, W, 3) float32 frames in [0, 1] on the device -> the
        network's two (B, 3, hp, wp) inputs: padded with zeros at the bottom
        and the right, then normalized, padding included, by the float32
        operations of ``augment.normalize`` in its order, so that the
        result is the same to the bit."""
        h, w = frames.shape[2:4]
        if (h, w) != (hp, wp):
            frames = F.pad(frames, (0, 0, 0, wp - w, 0, hp - h))
        return ((frames * 255.0 - self.mean) / self.stddev).permute(0, 1, 4, 2, 3)

    def run(
        self,
        examples: Sequence[Example],
        max_examples: int | None = None,
        output_dir: str | Path | None = None,
        output_format: str = "flo",  # flo | kitti_png | viz
        collect: int = 0,
        eval_batch: int = 1,
    ) -> dict:
        """Returns {'aee': ..., 'fl': ..., 'n': ..., 'n_gt': ...}: AEE and Fl
        averaged over the examples that have ground truth (``n_gt`` of the
        ``n`` evaluated).

        ``collect``: also return the first K predictions under ``'entries'``
        ({'im1', 'flow'[, 'gt', 'mask']}), in example order.

        ``eval_batch``: run up to this many same-shape pairs per forward;
        the metrics of each example are unchanged (the batch axis is
        independent).

        When examples carry a non-occluded-region source (KITTI ``flow_noc``
        validity, Sintel occlusion masks: ``Example.noc``), also returns
        ``aee_noc`` / ``fl_noc`` (valid and non-occluded) and ``aee_occ``
        (valid and occluded); each is a per-image mean over the images where
        that region is non-empty.
        """
        out_dir = Path(output_dir) if output_dir else None
        if out_dir:
            out_dir.mkdir(parents=True, exist_ok=True)
        aee_sum = fl_sum = 0.0
        noc_sums = {"aee_noc": 0.0, "fl_noc": 0.0, "aee_occ": 0.0}
        noc_counts = {"aee_noc": 0, "fl_noc": 0, "aee_occ": 0}
        n = n_gt = 0
        entries = []

        def consume(i, ex, item, flow):
            nonlocal aee_sum, fl_sum, n, n_gt
            if collect and i < collect:
                entry = {"im1": item["im1"], "flow": flow}
                if "flow" in item:
                    entry["gt"], entry["mask"] = item["flow"], item["mask"]
                entries.append((i, entry))
            if ex.flow is not None:
                n_gt += 1
                gt = torch.from_numpy(item["flow"][None])
                mask = torch.from_numpy(item["mask"][None])
                pred = torch.from_numpy(flow[None])
                aee_sum += float(flow_error_avg(pred, gt, mask))
                fl_sum += float(outlier_fraction(pred, gt, mask))
                if "noc_mask" in item:
                    noc = torch.from_numpy(item["noc_mask"][None])
                    occ = mask * (1.0 - noc)
                    for key, m, fn in (
                        ("aee_noc", noc, flow_error_avg),
                        ("fl_noc", noc, outlier_fraction),
                        ("aee_occ", occ, flow_error_avg),
                    ):
                        if float(torch.sum(m)) > 0:
                            noc_sums[key] += float(fn(pred, gt, m))
                            noc_counts[key] += 1
            n += 1
            if out_dir:
                # "id" is pair-unique; it may hold a subdirectory (Sintel's
                # <scene>/frame_xxxx benchmark layout)
                stem = ex.meta.get("id") or f"{i:06d}"
                (out_dir / stem).parent.mkdir(parents=True, exist_ok=True)
                if output_format == "flo":
                    write_flo(out_dir / f"{stem}.flo", flow)
                elif output_format == "kitti_png":
                    write_kitti_png_flow(out_dir / f"{stem}_10.png", flow)
                elif output_format == "viz":
                    write_image(out_dir / f"{stem}_flow.png", flow_to_color(flow))
                    if ex.flow is not None:
                        write_image(
                            out_dir / f"{stem}_err.png",
                            flow_error_image(flow, item["flow"], item["mask"]),
                        )
                else:
                    raise ValueError(f"unknown output format {output_format!r}")

        pending: dict[tuple, list] = {}

        def flush(shape_key):
            group = pending.pop(shape_key)
            flows = self.predict_batch(
                np.stack([it["im1"] for _, _, it in group]),
                np.stack([it["im2"] for _, _, it in group]),
            )
            for (i, ex, item), flow in zip(group, flows):
                consume(i, ex, item, flow)

        for i, ex in enumerate(examples):
            if max_examples is not None and i >= max_examples:
                break
            item = load_example(ex, target_hw=None, supervised=ex.flow is not None)
            key = item["im1"].shape
            pending.setdefault(key, []).append((i, ex, item))
            if len(pending[key]) >= eval_batch:
                flush(key)
        for key in list(pending):
            flush(key)
        if n == 0:
            raise ValueError("no examples evaluated")
        # averaged over the examples that have ground truth: dividing by all
        # of n would dilute AEE and Fl on datasets with partial ground truth
        result = {
            "aee": aee_sum / n_gt if n_gt else float("nan"),
            "fl": fl_sum / n_gt if n_gt else float("nan"),
            "n": n,
            "n_gt": n_gt,
        }
        for key, count in noc_counts.items():
            if count:
                result[key] = noc_sums[key] / count
        if collect:
            # same-shape batching can flush out of example order
            result["entries"] = [e for _, e in sorted(entries, key=lambda t: t[0])]
        return result
