"""The train step's update replayed as one CUDA graph.

Eager PyTorch dispatches the update of a FlowNet step (the network at 2x
batch, the loss, the backward pass, the gradient clip and Adam) as thousands
of small kernels, and the card waits on the host's dispatch. A
:class:`StepGraph` captures that update once and replays it: one launch a
step. It serves one optimizer (one set of parameters); ``make_train_step``
keeps one per optimizer and sends it the steps that ``replays_as_graph``
admits.

What the graph reads and writes stays where it was at capture: the fixed
input buffers (each step's augmented frames are copied into them), the
parameters, their gradients and Adam's moments and step counts (updated in
place), and Adam's learning rate, a device tensor that the step writes
before each replay (``build_optimizer`` makes Adam capturable on a GPU). So a
new learning rate needs no new capture, and an optimizer whose state is
replaced (``load_state_dict``) needs a new ``StepGraph``.
"""

from __future__ import annotations

from typing import Callable

import torch

from unflow_tpu_torch.ops.cuda.correlation import launch_counts
from unflow_tpu_torch.utils.profiling import (
    count,
    device_step,
    queue_device_step,
    read_device_steps,
    span,
)


def _signature(frames) -> tuple:
    """What a capture is valid for: each frame's shape and dtype (None for an
    absent ground truth or mask)."""
    return tuple(None if x is None else (tuple(x.shape), x.dtype) for x in frames)


class StepGraph:
    """``finish(state, *frames, device) -> logs`` taken eagerly once, then
    captured and replayed.

    The first step runs eagerly on the capture stream: it creates Adam's
    state, cuDNN's plans and the allocator's blocks, none of which may first
    appear inside a capture. The next step whose frames have the same shapes
    and dtypes is captured and at once replayed, and so is every later one;
    a step with other frames runs eagerly on the current stream (before the
    capture, it warms up again instead). Each step updates the state once.

    A replayed step (the span ``unflow.train.replay``: the copies into the
    input buffers, the launch and the copy out) returns a copy of the graph's
    logs (one device copy), so that the logs of an earlier step keep their
    values. The correlation kernels' launch counters (``launch_counts()``)
    count on the host at launch, which a replay skips: the launches counted
    while the graph was captured are taken back, and each replay adds them,
    so that the counters read a step's launches on either path.

    The device spans of a step (``utils/profiling.py::device_span``) are
    queued by each eager step but the warm-up; the capture keeps the ones it
    recorded, which every replay records again, and queues them after each
    replay. A span that a gradient hook starts (``device_span_after_grad``)
    is recorded on autograd's device thread on the capture stream, so the
    capture keeps it like the others. Before the next replay overwrites
    them, the previous replay's times are read if the device has passed them
    (``read_device_steps``), else dropped.
    """

    def __init__(self, finish: Callable[..., dict], device: torch.device):
        self._finish = finish
        self._stream = torch.cuda.Stream(device)
        self._signature = None  # of the frames the last warm-up ran on
        self._graph = None
        self._inputs: list = []
        self._keys: list[str] = []
        self._out = None  # the logs stacked, written by every replay
        self._launches: dict[str, int] = {}
        self._spans: list = []  # the device spans the capture recorded

    def __call__(self, state, frames: list, device: torch.device) -> tuple[dict, bool]:
        """The step's logs, and whether it was replayed."""
        signature = _signature(frames)
        if self._graph is None and signature != self._signature:
            self._signature = signature
            return self._warm_up(state, frames, device), False
        if signature != self._signature:
            with device_step():
                return self._finish(state, *frames, device), False
        if self._graph is None:
            self._capture(state, frames, device)
        return self._replay(frames), True

    def _warm_up(self, state, frames, device) -> dict:
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        # no device spans: this step's times hold the first calls' loading of
        # kernels and cuDNN's plans, which no later step pays
        with torch.cuda.stream(self._stream):
            logs = self._finish(state, *frames, device)
        current.wait_stream(self._stream)
        return logs

    def _capture(self, state, frames, device) -> None:
        self._inputs = [None if x is None else x.clone() for x in frames]
        # the warm-up's gradients go before the capture's empty_cache(), which
        # then returns their blocks to the device; the graph makes its own
        state.optimizer.zero_grad(set_to_none=True)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream), device_step(queue=False) as spans:
            logs = self._finish(state, *self._inputs, device)
            self._keys = list(logs)
            self._out = torch.stack([logs[k].float() for k in self._keys])
        self._graph = graph
        self._spans = spans
        self._launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        for name, n in self._launches.items():  # a capture launches nothing: its replay counts
            count(name, -n)

    def _replay(self, frames) -> dict:
        with span("unflow.train.replay"):
            for buffer, x in zip(self._inputs, frames):
                if buffer is not None:
                    buffer.copy_(x)
            read_device_steps(drop=self._spans)
            self._graph.replay()
            queue_device_step(self._spans)
            for name, n in self._launches.items():
                count(name, n)
            return dict(zip(self._keys, self._out.clone().unbind(0)))
