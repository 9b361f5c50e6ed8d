"""Flow of frame pairs, written plainly: pad to the pyramid's multiple of 64,
normalize, run the cascade in the configuration's precision, upsample its
last stage's finest flow to the padded size and crop it back."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from flowbench.reference.flownet import Net, full_res_flow
from flowbench.reference.train import DTYPES, normalize


def predict(params: dict, ims1: np.ndarray, ims2: np.ndarray, cfg: dict, normalization, device,
            quant=None) -> np.ndarray:
    """``(B, H, W, 3)`` float frames in [0, 1] -> ``(B, H, W, 2)`` flow."""
    b, h, w, _ = ims1.shape
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    mean, std = normalization
    net = Net(cfg["flownet"], params, dtype=DTYPES[cfg["compute_dtype"]],
              max_displacement=cfg["max_displacement"], stride=cfg["corr_stride"], quant=quant)

    def prepare(ims):
        x = torch.from_numpy(np.ascontiguousarray(ims, dtype=np.float32)).to(device)
        x = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h))
        return normalize(x, mean, std)

    with torch.no_grad():
        flow = full_res_flow(net(prepare(ims1), prepare(ims2))[-1], hp, wp)
        return flow[:, :, :h, :w].permute(0, 2, 3, 1).cpu().numpy()
