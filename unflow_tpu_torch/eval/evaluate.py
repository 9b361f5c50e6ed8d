"""Inference over frame pairs, and evaluation over a dataset.

Port of ``unflow_tpu/eval/evaluate.py::Evaluator``: ``predict`` and
``predict_batch`` pad raw [0, 1] frames with zeros to a multiple of 64,
normalize them with the dataset's constants, run the network and upsample
its finest flow to full resolution; ``run`` evaluates a list of examples in
same-shape batches, averages AEE and Fl (``eval/metrics.py``) over the
examples with ground truth, with the occluded / non-occluded breakdown where
the examples carry one, and can dump the flows as ``.flo``, KITTI 16-bit
PNGs or color images.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

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
from unflow_tpu_torch.utils.profiling import count, span


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
        self.model = build_model(cfg, self.device)
        self.model.load_state_dict(params)
        self.model.to(DTYPES[cfg.train.compute_dtype]).eval()

    def predict(self, im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        """Single unbatched pair (H, W, 3) -> (H, W, 2) flow; pads to /64."""
        return self.predict_batch(im1[None], im2[None])[0]

    def predict_batch(self, ims1: np.ndarray, ims2: np.ndarray) -> np.ndarray:
        """Same-shape pairs (B, H, W, 3) -> (B, H, W, 2); pads to /64.

        Under a ``torch.profiler`` profile the call is the span
        ``unflow.infer.request`` (unit: the request's number) with the
        children ``unflow.infer.pad`` (the padding and the float32 cast on
        the host), ``unflow.infer.h2d`` (both frames' copies in),
        ``unflow.infer.forward`` (the network's dispatch) and
        ``unflow.infer.d2h`` (``flow.cpu()``: the wait for the device's
        queued work and the copy back). The counters ``infer.requests``,
        ``infer.h2d_bytes`` and ``infer.d2h_bytes`` are always on."""
        b, h, w, _ = ims1.shape
        hp = -(-h // 64) * 64
        wp = -(-w // 64) * 64
        pad = ((0, 0), (0, hp - h), (0, wp - w), (0, 0))
        with span("unflow.infer.request", count("infer.requests")), torch.inference_mode():
            with span("unflow.infer.pad"):
                a1 = np.pad(ims1, pad).astype(np.float32)
                a2 = np.pad(ims2, pad).astype(np.float32)
            with span("unflow.infer.h2d"):
                p1 = torch.from_numpy(a1).to(self.device)
                p2 = torch.from_numpy(a2).to(self.device)
            count("infer.h2d_bytes", a1.nbytes + a2.nbytes)
            with span("unflow.infer.forward"):
                flow = predict_flow(self.model, p1, p2, self.normalization)
            with span("unflow.infer.d2h"):
                flow = flow.cpu()
            count("infer.d2h_bytes", flow.numel() * flow.element_size())
            return flow.numpy()[:, :h, :w]

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
