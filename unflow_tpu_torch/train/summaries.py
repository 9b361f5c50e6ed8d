"""Image summaries of training: flow colours, warped frame, occlusion mask.

Port of ``unflow_tpu/train/summaries.py``. At the summary interval one
forward pass without gradients (forward and backward flow, the warp, the
forward-backward occlusion mask) runs on the current batch, and the host
writes PNG strips under ``<exp_dir>/summaries/step_<step>/`` and, given an
event writer, the same PNGs to tensorboard: each strip is encoded once, at
PNG's fastest compression level (the JAX package encodes each twice at
PIL's default level; the pixels are the same).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from unflow_tpu_torch.augment import normalize
from unflow_tpu_torch.eval.flow_viz import flow_to_color
from unflow_tpu_torch.losses.terms import length_sq
from unflow_tpu_torch.models import FlowNetStack, full_res_flow
from unflow_tpu_torch.ops.warp import backward_warp
from unflow_tpu_torch.utils.tensorboard import _encode_png


def _grid(ims: np.ndarray) -> np.ndarray:
    """``(B, H, W, C)`` -> ``(B*H, W, C)``, a vertical strip."""
    b, h, w, c = ims.shape
    return ims.reshape(b * h, w, c)


class ImageSummaryWriter:
    """Writes PNG strips (im1, im2, flow_fw / flow_bw colours, warped im2,
    brightness error, occlusion mask) of the first ``max_examples`` pairs of
    the current batch."""

    def __init__(self, exp_dir, normalization, max_examples: int = 2, event_writer=None):
        self._dir = Path(exp_dir) / "summaries"
        self._max = max_examples
        self._tb = event_writer  # an optional utils.tensorboard.EventWriter
        self._norm = normalization

    def _forward(self, model: FlowNetStack, im1: torch.Tensor, im2: torch.Tensor):
        mean, stddev = self._norm
        n1 = normalize(im1, mean, stddev).permute(0, 3, 1, 2)
        n2 = normalize(im2, mean, stddev).permute(0, 3, 1, 2)
        h, w = im1.shape[1:3]
        flow_fw = full_res_flow(model(n1, n2)[-1], h, w)
        flow_bw = full_res_flow(model(n2, n1)[-1], h, w)
        im1, im2 = im1.permute(0, 3, 1, 2), im2.permute(0, 3, 1, 2)
        warped = backward_warp(torch.cat([im2, flow_bw], 1), flow_fw)
        im2_warped, flow_bw_warped = warped[:, :3], warped[:, 3:]
        occ_thresh = 0.01 * (length_sq(flow_fw) + length_sq(flow_bw_warped)) + 0.5
        occ = (length_sq(flow_fw + flow_bw_warped) > occ_thresh).float()
        err = (im1 - im2_warped).abs()
        return [x.permute(0, 2, 3, 1).float().cpu().numpy()
                for x in (flow_fw, flow_bw, im2_warped, err, occ)]

    def write(self, step: int, model: FlowNetStack, batch: dict) -> Path:
        """Summarize the host ``batch`` (``im1``, ``im2``: ``(B, H, W, 3)``,
        float in [0, 1] or uint8) under ``model``'s current parameters."""
        n = min(self._max, batch["im1"].shape[0])
        # the batch may be any size >= the crop; the pyramid needs extents
        # divisible by 64, so the top-left such region is summarized
        h = (batch["im1"].shape[1] // 64) * 64
        w = (batch["im1"].shape[2] // 64) * 64
        device = next(model.parameters()).device
        ims = []
        for key in ("im1", "im2"):
            im = torch.from_numpy(np.ascontiguousarray(batch[key][:n, :h, :w])).to(device)
            ims.append(im.float() / 255.0 if im.dtype == torch.uint8 else im)
        with torch.inference_mode():
            flow_fw, flow_bw, warped, err, occ = self._forward(model, *ims)
        im1, im2 = (im.cpu().numpy() for im in ims)
        out = self._dir / f"step_{step:08d}"
        out.mkdir(parents=True, exist_ok=True)
        grids = {
            "im1": _grid(im1),
            "im2": _grid(im2),
            "flow_fw": _grid(np.stack([flow_to_color(f) for f in flow_fw])),
            "flow_bw": _grid(np.stack([flow_to_color(f) for f in flow_bw])),
            "im2_warped": _grid(np.clip(warped, 0.0, 1.0)),
            "error": _grid(np.clip(err, 0.0, 1.0)),
            "occ_mask": _grid(np.repeat(occ, 3, axis=-1)),
        }
        for name, grid in grids.items():
            # one fast encode serves the file and the event
            png = _encode_png(grid, compress_level=1)
            (out / f"{name}.png").write_bytes(png)
            if self._tb is not None:
                self._tb.image_png(name, png, grid.shape[0], grid.shape[1], step)
        if self._tb is not None:
            self._tb.flush()
        return out
