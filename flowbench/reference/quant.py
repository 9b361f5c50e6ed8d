"""The control: the reference computed one precision below the configuration.

The configurations state bfloat16 towers, so the control rounds every conv
input, conv weight and correlation map to 8-bit floats (e4m3, the H100's
fp8 tensor-core type) with one scale per tensor, as an fp8 path would: the
tensor's largest magnitude maps to e4m3's largest finite value, 448. The
gradient passes the rounding unchanged (straight through), as it does
through the casts of a mixed-precision program.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to scaled e4m3 and back to its dtype; the gradient
    passes as it is."""
    with torch.no_grad():
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = E4M3_MAX / amax
        q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


QUANT = {"bf16": None, "fp8": fp8}
