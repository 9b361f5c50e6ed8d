"""``Evaluator.predict_batch`` replays the network's forward as a CUDA graph on
a GPU (``eval/evaluate.py::ForwardGraphs``): the first request of an input
shape runs eagerly, the second is captured and replayed, every later one
replayed. The tests marked ``cuda`` hold the replayed flows, bit for bit,
to the eager path's; the correlation's launch counters per request to the
eager path's; the counter ``infer.graph_replays`` to the replays alone; and
the cache to its cap; an Evaluator let go frees its graphs at once, so
that no collection during a later capture frees them there. The others run
anywhere: on the CPU no request replays, each request records its spans as
before, and an Evaluator let go is freed without the cyclic collector.

The tests marked ``cuda`` skip without an NVIDIA GPU. The file imports no
JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_infer_graph.py
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import profile

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.eval.evaluate import GRAPH_CAP, Evaluator
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.ops.cuda.correlation import launch_counts
from unflow_tpu_torch.utils.profiling import counts, reset, summary

torch.set_num_threads(1)

KITTI = (375, 1242)  # padded to 384x1280
PHASES = ("request", "h2d", "pad", "forward", "d2h")


def _evaluator(device, dtype="float32", max_displacement=4):
    cfg = Config()
    cfg.train.flownet, cfg.train.compute_dtype = "C", dtype
    cfg.train.max_displacement = max_displacement
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    return Evaluator(cfg, params=model.state_dict(), device=device)


def _frames(seed, hw, batch=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(batch, *hw, 3).astype(np.float32) for _ in range(2))


def _replays():
    return counts().get("infer.graph_replays", 0)


def _request(ev, frames):
    """The flow of one request, the correlation launches it counted and the
    replays it counted."""
    launches, replays = launch_counts(), _replays()
    flow = ev.predict_batch(*frames)
    grew = {k: n - launches[k] for k, n in launch_counts().items() if n != launches[k]}
    return flow, grew, _replays() - replays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(64, 128), (60, 100)], ids=["aligned", "padded"])
def test_on_the_cpu_no_request_replays_and_each_records_its_spans(dtype, hw):
    ev = _evaluator("cpu", dtype)
    frames = _frames(1, hw)
    before = _replays()
    reset()
    try:
        with profile():
            flows = [ev.predict_batch(*frames) for _ in range(3)]
        spans = summary()["spans"]
    finally:
        reset()
    assert _replays() == before
    for phase in PHASES:
        assert spans[f"unflow.infer.{phase}"]["count"] == 3
    assert flows[0].shape == (1, *hw, 2)
    for flow in flows[1:]:
        np.testing.assert_array_equal(flow, flows[0])


def _freed_without_the_collector(make):
    """Whether the object ``make()`` returns is freed as soon as it is let go."""
    gc.disable()
    try:
        ref = weakref.ref(make())
        return ref() is None
    finally:
        gc.enable()


def test_on_the_cpu_an_evaluator_let_go_is_freed_without_the_collector():
    def served():
        ev = _evaluator("cpu")
        ev.predict_batch(*_frames(1, (64, 128)))
        return ev

    assert _freed_without_the_collector(served)


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, so that two eager forwards of one
    input agree to the bit; skips without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = was


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_replayed_flows_equal_the_eager_ones_bit_for_bit(deterministic, dtype):
    ev = _evaluator(deterministic, dtype, max_displacement=20)
    a, b = _frames(1, KITTI), _frames(2, KITTI)
    eager_a, eager_launches, replays = _request(ev, a)  # warms up the key
    assert replays == 0 and len(ev._forward) == 0
    assert sum(eager_launches.values()) == 1
    first_b, launches, replays = _request(ev, b)  # captured and replayed
    assert (launches, replays, len(ev._forward)) == (eager_launches, 1, 1)
    kept_b = first_b.copy()
    again_a, launches_a, replays_a = _request(ev, a)
    again_b, launches_b, replays_b = _request(ev, b)
    assert (launches_a, launches_b, replays_a, replays_b) == (eager_launches,) * 2 + (1, 1)
    fresh_b, fresh_launches, fresh_replays = _request(_evaluator(deterministic, dtype, 20), b)
    assert (fresh_launches, fresh_replays) == (eager_launches, 0)
    assert first_b.shape == (1, *KITTI, 2) and first_b.dtype == np.float32
    np.testing.assert_array_equal(again_a, eager_a)
    np.testing.assert_array_equal(first_b, fresh_b)
    np.testing.assert_array_equal(again_b, fresh_b)
    # a flow handed back earlier is the caller's: later replays leave it alone
    np.testing.assert_array_equal(first_b, kept_b)
    assert not np.array_equal(eager_a, fresh_b)


@pytest.mark.cuda
def test_a_request_of_another_shape_runs_eagerly_between_replays(deterministic):
    ev = _evaluator(deterministic, "bfloat16", max_displacement=20)
    a = _frames(3, KITTI)
    eager, _, _ = _request(ev, a)
    replayed, _, replays = _request(ev, a)
    assert replays == 1
    # batch 2 is another key: a warm-up, which replays nothing
    other, launches, replays = _request(ev, _frames(4, KITTI, batch=2))
    assert other.shape == (2, *KITTI, 2)
    assert replays == 0 and sum(launches.values()) == 1 and len(ev._forward) == 1
    again, _, replays = _request(ev, a)
    assert replays == 1
    np.testing.assert_array_equal(replayed, eager)
    np.testing.assert_array_equal(again, eager)


@pytest.mark.cuda
def test_the_cache_never_holds_more_graphs_than_its_cap(deterministic):
    ev = _evaluator(deterministic, "bfloat16", max_displacement=20)
    shapes = [(64 * (k + 1), 256) for k in range(GRAPH_CAP + 2)]
    eager = {}
    for hw in shapes:
        frames = _frames(5, hw)
        eager[hw], _, warm = _request(ev, frames)
        flow, _, replays = _request(ev, frames)
        assert (warm, replays) == (0, 1)
        assert len(ev._forward) <= GRAPH_CAP
        np.testing.assert_array_equal(flow, eager[hw])
    assert len(ev._forward) == GRAPH_CAP
    # the first shape was dropped: it warms up again, then replays
    first = _frames(5, shapes[0])
    flow, _, warm = _request(ev, first)
    assert warm == 0 and len(ev._forward) == GRAPH_CAP - 1
    np.testing.assert_array_equal(flow, eager[shapes[0]])
    # the newest shape is still held
    flow, _, replays = _request(ev, _frames(5, shapes[-1]))
    assert replays == 1
    np.testing.assert_array_equal(flow, eager[shapes[-1]])


@pytest.mark.cuda
def test_an_evaluator_let_go_frees_its_graphs_before_a_later_capture(deterministic):
    def served():
        ev = _evaluator(deterministic, "bfloat16", max_displacement=20)
        for _ in range(2):
            ev.predict_batch(*_frames(6, (128, 256)))
        assert len(ev._forward) == 1
        return ev._forward

    gc.collect()  # what earlier tests left to the collector goes now
    assert _freed_without_the_collector(served)
    # a collection inside a capture, as an allocation may start one, frees no
    # graph there: freeing one during a capture breaks the capture
    x = torch.zeros(8, device=deterministic)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gc.collect()
        y = x * 2
    x.fill_(1.0)
    graph.replay()
    assert y.tolist() == [2.0] * 8
