"""Inference over frame pairs.

Port of ``unflow_tpu/eval/evaluate.py::Evaluator`` (``__init__``,
``_forward``, ``predict``, ``predict_batch``): pads raw [0, 1] frames with
zeros to a multiple of 64, normalizes them with the dataset's constants,
runs the network and upsamples its finest flow to full resolution. The
dataset loop with metrics (``run``) waits for a later slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from unflow_tpu_torch.augment import normalize
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.device import resolve_device
from unflow_tpu_torch.models import DTYPES, build_model, full_res_flow
from unflow_tpu_torch.train.checkpoint import restore_params


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

    def _forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        """NHWC frames in [0, 1] -> NHWC full-resolution flow."""
        mean, std = self.normalization
        stages = self.model(
            normalize(im1, mean, std).permute(0, 3, 1, 2),
            normalize(im2, mean, std).permute(0, 3, 1, 2),
        )
        h, w = im1.shape[1:3]
        return full_res_flow(stages[-1], h, w).permute(0, 2, 3, 1)

    def predict(self, im1: np.ndarray, im2: np.ndarray) -> np.ndarray:
        """Single unbatched pair (H, W, 3) -> (H, W, 2) flow; pads to /64."""
        return self.predict_batch(im1[None], im2[None])[0]

    def predict_batch(self, ims1: np.ndarray, ims2: np.ndarray) -> np.ndarray:
        """Same-shape pairs (B, H, W, 3) -> (B, H, W, 2); pads to /64."""
        b, h, w, _ = ims1.shape
        hp = -(-h // 64) * 64
        wp = -(-w // 64) * 64
        pad = ((0, 0), (0, hp - h), (0, wp - w), (0, 0))
        with torch.inference_mode():
            p1 = torch.from_numpy(np.pad(ims1, pad).astype(np.float32)).to(self.device)
            p2 = torch.from_numpy(np.pad(ims2, pad).astype(np.float32)).to(self.device)
            flow = self._forward(p1, p2)
            return flow.cpu().numpy()[:, :h, :w]
