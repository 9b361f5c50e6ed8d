"""The numbers that decide ``correct``: the program's output against the
plain reference's, each beside the limit of ``limits/<cell>.json``.

Training (the checked steps): ``loss_gap``, the largest relative gap of a
step's loss; ``grad_gap``, of the first gradient's norm, leaf by leaf;
``change_gap``, of the norm of the parameters' change after the checked
steps, leaf by leaf, leaving out leaves whose reference gradient is under a
thousandth of the median leaf's (they move by round-off alone). A leaf's gap
is ``| |program| - |reference| |`` over the larger of the reference's norm
of that leaf and of the median leaf; the number is the worst leaf's.

Serving (the sampled requests): ``flow_gap``, the largest relative L2 gap of
a request's flow, ``|program - reference| / |reference|``.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import numpy as np
import torch

SMALL_LEAF = 1e-3


@contextlib.contextmanager
def plain_precision():
    """float32 as float32: no TF32 in the reference's matmuls and convs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def worst_leaf(program: dict, reference: dict, leaves) -> float:
    leaves = list(leaves)
    median = statistics.median(reference[k] for k in leaves)
    return max(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in leaves)


def train_numbers(program: dict, reference: dict) -> dict:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    grads = reference["grad_norms"]
    median = statistics.median(grads.values())
    moving = [k for k in grads if grads[k] >= SMALL_LEAF * median]
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_leaf(program["grad_norms"], grads, grads),
        "change_gap": worst_leaf(program["change_norms"], reference["change_norms"], moving),
    }


def flow_gap(program: list, reference: list) -> float:
    """Largest relative L2 gap over pairs of ``(H, W, 2)`` flows; infinite
    when there is no pair to compare."""
    if not program or len(program) != len(reference):
        return math.inf
    worst = 0.0
    for p, r in zip(program, reference):
        diff = float(np.linalg.norm((np.asarray(p, np.float64) - r).ravel()))
        worst = max(worst, diff / max(float(np.linalg.norm(np.asarray(r, np.float64).ravel())), 1e-30))
    return worst


def unmatched() -> dict:
    """A fed row that is none of the benchmark's pairs: nothing to compare."""
    return {"fed_rows_unknown": math.inf}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit. A number that is not
    finite, or has no limit, fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value if math.isfinite(value) else str(value), "limit": limit}
    return ok and bool(numbers), checks
