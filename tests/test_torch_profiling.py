"""The port's profiling hooks (``unflow_tpu_torch/utils/profiling.py``):
``trace`` writes a Chrome trace that reads back and names the convolution it
profiled; the JAX package's ``StepTimer`` rate follows a known sleep (the
port has no ``StepTimer``: its spans are in ``test_torch_spans.py``)."""

import json
import time

import pytest
import torch

from unflow_tpu.utils.profiling import StepTimer as StepTimerJax
from unflow_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)


def test_trace_writes_a_readable_trace_naming_the_conv(tmp_path):
    x = torch.randn(1, 3, 16, 16)
    conv = torch.nn.Conv2d(3, 4, 3)
    with trace(tmp_path / "prof") as prof:
        conv(x).sum().backward()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]
    assert any("convolution_backward" in n for n in names)
    assert "aten::convolution" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("cls", [StepTimerJax], ids=["jax"])
def test_step_timer_rate_follows_a_known_sleep(cls):
    timer = cls()
    timer.start(sync_scalar=torch.zeros(()))
    for _ in range(4):
        time.sleep(0.05)
        timer.tick(8)
    rate = timer.rate(sync_scalar=torch.ones(()))
    # 32 items in 0.2 s of sleep, and what a loaded host adds to it
    assert 50 < rate <= 160, rate
    timer.start()  # no scalar
    timer.tick(3)
    assert timer.rate() > 0
    timer.reset()
