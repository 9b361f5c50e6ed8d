"""Synthetic drives: textured frames moved by a smooth motion, made on the
device from a seed.

Each drive is one scene, a multi-octave smooth random RGB texture on a
canvas wider than the frame, seen through a camera that moves by a fixed
similarity (zoom about the centre, rotation, translation) per frame, so that
consecutive frames differ by a smooth flow of a few pixels with sub-pixel
values, as in a car's forward drive. Frame ``t`` samples the canvas
bilinearly at the inverse of ``t`` steps of that motion. Every seed gives
the same sizes; only the pixels and the motion differ.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# (cell size in px, amplitude): coarse octaves give the photometric terms a
# wide basin, fine ones feed the census transform
OCTAVES = ((64, 1.0), (32, 0.8), (16, 0.6), (8, 0.45), (4, 0.3), (2, 0.2), (1, 0.12))


def make_drives(seed: int, drives: int, frames: int, hw, motion: dict, device) -> torch.Tensor:
    """``(drives, frames, H, W, 3)`` uint8 frames on ``device``."""
    h, w = hw
    g = torch.Generator(device=device).manual_seed(int(seed))
    reach = frames * (motion["max_translate_px"] + max(h, w) * (
        motion["max_zoom"] + math.radians(motion["max_rotate_deg"])))
    margin = int(math.ceil(reach)) + 2
    ch, cw = h + 2 * margin, w + 2 * margin
    canvas = torch.zeros((drives, 3, ch, cw), device=device)
    for cell, amp in OCTAVES:
        grid = torch.rand((drives, 3, ch // cell + 2, cw // cell + 2), generator=g, device=device)
        canvas += amp * (grid if cell == 1 else F.interpolate(
            grid, size=(ch, cw), mode="bilinear", align_corners=False))[..., :ch, :cw]
    canvas /= sum(a for _, a in OCTAVES)

    def uniform(limit):
        return (2 * torch.rand((drives,), generator=g, device=device) - 1) * limit

    zoom = 1.0 + uniform(motion["max_zoom"]).abs()  # forward: the scene grows
    angle = uniform(math.radians(motion["max_rotate_deg"]))
    shift = torch.stack([uniform(motion["max_translate_px"]),
                         uniform(motion["max_translate_px"])], -1)
    t = torch.arange(frames, device=device, dtype=torch.float32)
    # frame t sees canvas point c + R(-t a) (q - c) / z^t - t s
    scale = zoom[:, None] ** (-t)  # (drives, frames)
    rot = -angle[:, None] * t
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) - (h - 1) / 2,
                            torch.arange(w, device=device, dtype=torch.float32) - (w - 1) / 2,
                            indexing="ij")
    cos, sin = (torch.cos(rot) * scale)[..., None, None], (torch.sin(rot) * scale)[..., None, None]
    sx = cos * xs - sin * ys - t[:, None, None] * shift[:, 0, None, None, None] + (cw - 1) / 2
    sy = sin * xs + cos * ys - t[:, None, None] * shift[:, 1, None, None, None] + (ch - 1) / 2
    grid = torch.stack([sx * (2.0 / (cw - 1)) - 1.0, sy * (2.0 / (ch - 1)) - 1.0], -1)
    out = torch.empty((drives, frames, h, w, 3), dtype=torch.uint8, device=device)
    for d in range(drives):
        sample = F.grid_sample(canvas[d:d + 1].expand(frames, -1, -1, -1), grid[d],
                               mode="bilinear", padding_mode="border", align_corners=True)
        out[d] = (sample * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out
