"""The port's spans and counters (``unflow_tpu_torch/utils/profiling.py``):
off, a span records nothing; under ``torch.profiler`` it is an annotation on
the profiler's timeline and a record on the same clock; self time is total
less the children's; the train step, the Loader and ``Evaluator.predict``
emit their phases; the buffer keeps its cap; the correlation's launch
counts are a view of the counter registry, whose launch counters are
tagged."""

import itertools
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data.base import Example, Loader
from unflow_tpu_torch.data.io import write_image
from unflow_tpu_torch.data.packed import PackedExamples, pack_examples
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.eval.evaluate import Evaluator
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.ops.cuda.correlation import KERNELS, launch_counts, reset_launch_counts
from unflow_tpu_torch.train import Trainer
from unflow_tpu_torch.utils import profiling
from unflow_tpu_torch.utils.profiling import count, records, reset, span, summary, trace

torch.set_num_threads(1)

H, W, BATCH = 64, 128, 2
TRAIN_PHASES = ("put_batch", "augment", "forward", "loss", "backward", "adam")
INFER_PHASES = ("h2d", "pad", "forward", "d2h")


@pytest.fixture(autouse=True)
def _fresh_spans():
    reset()
    yield
    reset()


def _config(tmp_path, **overrides):
    cfg = Config()
    cfg.dirs.log = str(tmp_path / "log")
    keys = dict(flownet="C", batch_size=BATCH, height=H, width=W, compute_dtype="float32",
                max_displacement=4, corr_stride=2, aug_photometric=False,
                image_summary_interval=-1, **overrides)
    for key, value in keys.items():
        setattr(cfg.train, key, value)
    return cfg


def _annotations(prof):
    """``{name: [(start_ns, end_ns)]}`` of the profile's user annotations."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.activity_type() == "user_annotation":
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_off_a_span_is_one_shared_no_op_and_records_nothing():
    assert span("unflow.a") is span("unflow.b", unit=3)
    with span("unflow.a"):
        torch.ones(4).mul(2)
    assert summary()["spans"] == {} and records() == []


def test_a_span_lies_within_a_millisecond_of_its_annotation():
    with profile() as prof:
        with span("unflow.warm"):
            pass
        with span("unflow.outer", unit=5):
            torch.ones(64).mul(2).sum()
    (rec,) = [r for r in records() if r[0] == "unflow.outer"]
    ((start, end),) = _annotations(prof)["unflow.outer"]
    assert abs(rec[2] - start) < 1e6 and abs(rec[3] - end) < 1e6, (rec, start, end)
    assert rec[1] == threading.get_ident() and rec[4] is None and rec[5] == 5


def test_the_ops_run_inside_a_span_fall_inside_its_annotation():
    with profile() as prof:
        with span("unflow.outer"):
            torch.ones(64).mul(2).sum()
        torch.ones(8).add(1)
    ((start, end),) = _annotations(prof)["unflow.outer"]
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.activity_type() == "cpu_op":
            ops.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ("aten::mul", "aten::sum"):
        assert all(start <= s and e <= end for s, e in ops[name]), name
    assert all(s >= end for s, _ in ops["aten::add"])


def test_nested_spans_give_the_parent_self_time_total_less_children():
    with profile():
        with span("unflow.outer", unit=7):
            time.sleep(0.002)
            for _ in range(2):
                with span("unflow.inner"):
                    time.sleep(0.003)
    spans = summary()["spans"]
    outer, inner = spans["unflow.outer"], spans["unflow.inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert inner["self_ns"] == inner["total_ns"]
    assert outer["self_ns"] >= 2e6 and inner["total_ns"] >= 6e6
    inners = [r for r in records() if r[0] == "unflow.inner"]
    assert [(r[4], r[5]) for r in inners] == [("unflow.outer", 7)] * 2


@pytest.mark.parametrize("supervised", [False, True], ids=["unsupervised", "supervised"])
def test_a_train_step_is_one_step_span_over_its_six_phases(tmp_path, supervised):
    cfg = _config(tmp_path, supervised=supervised, corr_impl="torch")
    batch = next(batch_iterator(BATCH, H, W, seed=0, max_shift=3.0, supervised=supervised))
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")
    trainer.train_step(batch)
    reset()
    with profile():
        trainer.train_step(batch)
    recs = records()
    steps = [r for r in recs if r[0] == "unflow.train.step"]
    assert len(steps) == 1 and steps[0][5] == 1
    children = [r for r in recs if r[4] == "unflow.train.step"]
    assert [r[0] for r in children] == [f"unflow.train.{p}" for p in TRAIN_PHASES]
    assert {r[5] for r in children} == {1}
    spans = summary()["spans"]
    covered = sum(spans[f"unflow.train.{p}"]["total_ns"] for p in TRAIN_PHASES)
    assert covered >= 0.9 * spans["unflow.train.step"]["total_ns"]


@pytest.mark.parametrize("hw", [(64, 128), (60, 100)], ids=["aligned", "padded"])
def test_predict_is_one_request_over_its_four_phases_and_counts_its_bytes(tmp_path, hw):
    cfg = _config(tmp_path)
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    ev = Evaluator(cfg, params=model.state_dict(), device="cpu")
    rng = np.random.RandomState(0)
    im1, im2 = rng.rand(2, *hw, 3).astype(np.float32)
    before = profiling.counts()
    with profile():
        flow = ev.predict(im1, im2)
    assert flow.shape == (*hw, 2)
    recs = records()
    (request,) = [r for r in recs if r[0] == "unflow.infer.request"]
    children = [r for r in recs if r[4] == "unflow.infer.request"]
    assert [r[0] for r in children] == [f"unflow.infer.{p}" for p in INFER_PHASES]
    assert {r[5] for r in children} == {request[5]} and request[5] == profiling.counts()[
        "infer.requests"]
    grew = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
            if k.startswith("infer.")}
    # the unpadded frames go in and the cropped flow comes back
    pixels = hw[0] * hw[1]
    assert grew == {"infer.requests": 1, "infer.padded_requests": int(hw != (64, 128)),
                    "infer.h2d_bytes": 2 * pixels * 3 * 4, "infer.d2h_bytes": pixels * 2 * 4}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "decode"])
def test_the_loader_counts_its_gets_and_spans_its_wait_and_gather(tmp_path, packed):
    rng = np.random.RandomState(1)
    examples = []
    for i in range(5):
        for j in (0, 1):
            write_image(tmp_path / f"{i}_{j}.png", rng.rand(16, 32, 3))
        examples.append(Example(im1=str(tmp_path / f"{i}_0.png"),
                                im2=str(tmp_path / f"{i}_1.png")))
    source = PackedExamples(pack_examples(examples, tmp_path / "packed", (16, 32))) \
        if packed else examples
    loader = Loader(source, batch_size=2, load_hw=(16, 32), num_threads=1, image_dtype="uint8")
    before = profiling.counts()
    batches = iter(loader)
    with profile():
        for _ in range(3):
            next(batches)
    batches.close()
    after = profiling.counts()
    gets = after["loader.gets"] - before.get("loader.gets", 0)
    starved = after.get("loader.starved", 0) - before.get("loader.starved", 0)
    assert gets == 3 and 0 <= starved <= gets
    recs = records()
    waits = [r for r in recs if r[0] == "unflow.loader.wait"]
    gathers = [r for r in recs if r[0] == "unflow.loader.gather"]
    assert len(waits) == 3 and {r[1] for r in waits} == {threading.get_ident()}
    assert gathers and threading.get_ident() not in {r[1] for r in gathers}
    assert all(r[4] is None for r in waits + gathers)


def test_trace_around_a_step_writes_a_trace_naming_the_loss_span(tmp_path):
    cfg = _config(tmp_path, corr_impl="torch")
    batch = next(batch_iterator(BATCH, H, W, seed=0, max_shift=3.0))
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")
    with trace(tmp_path / "prof"):
        trainer.train_step(batch)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"unflow.train.step", "unflow.train.loss", "unflow.train.backward"} <= names
    assert summary()["spans"]["unflow.train.loss"]["count"] == 1


def test_the_buffer_stays_at_its_cap_and_the_totals_go_on(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 10)
    with profile():
        for _ in range(25):
            with span("unflow.tick"):
                pass
    assert len(records()) == 10
    assert summary()["spans"]["unflow.tick"]["count"] == 25


def test_launch_counts_are_a_view_of_the_counter_registry():
    reset_launch_counts()
    assert launch_counts() == {name: 0 for name in KERNELS}
    assert count("corr_fwd_f32") == 1 and count("corr_fwd_f32", 2) == 3
    count("unflow.test.other")
    assert launch_counts()["corr_fwd_f32"] == 3 and set(launch_counts()) == set(KERNELS)
    assert summary()["counters"]["corr_fwd_f32"] == 3
    reset_launch_counts()
    assert launch_counts()["corr_fwd_f32"] == 0
    assert profiling.counts()["unflow.test.other"] >= 1


def test_launch_counters_are_the_registry_counters_tagged_as_launches():
    """What ``StepGraph`` and ``ForwardGraphs`` add back on a replay: every
    counter :func:`profiling.count_launch` made, and no other."""
    profiling.reset_counts(["unflow.test.kernel"])
    count("unflow.test.not_a_kernel")
    assert "unflow.test.kernel" not in profiling.launch_counts()
    profiling.count_launch("unflow.test.kernel")
    profiling.count_launch("unflow.test.kernel")
    launches = profiling.launch_counts()
    assert launches["unflow.test.kernel"] == 2 and "unflow.test.not_a_kernel" not in launches
    assert count("unflow.test.kernel", -2) == 0  # a capture's launches taken back
    profiling.reset_counts(["unflow.test.kernel"])
    assert profiling.launch_counts()["unflow.test.kernel"] == 0  # still a launch counter


def test_counters_and_span_totals_lose_no_update_across_threads():
    threads, n = 16, 500
    before = profiling.counts().get("unflow.test.stress", 0)

    def work():
        for _ in range(n):
            count("unflow.test.stress")
            with span("unflow.test.stress"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile():
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counts()["unflow.test.stress"] - before == threads * n
    assert summary()["spans"]["unflow.test.stress"]["count"] == threads * n
