"""Learning-rate schedule: piecewise halving (port of
``unflow_tpu/train/schedule.py``): constant until ``decay_after`` steps, then
halved every ``decay_interval`` steps."""

from __future__ import annotations


def piecewise_halving(learning_rate: float, decay_after: int, decay_interval: int):
    """``schedule(step) = learning_rate * 0.5 ** halvings(step)`` for a host-side
    integer step."""

    def schedule(step: int) -> float:
        halvings = max(0, (int(step) - decay_after) // decay_interval + 1)
        return learning_rate * 0.5**halvings

    return schedule
