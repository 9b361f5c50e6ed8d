"""The readers of the program's own spans and counters (``flowbench/program.py``,
``metrics/host_*``, ``loader_*``, ``infer_copy_mib``): their arithmetic on a
made-up ``summary()``, None where a span or counter is missing, and idle gaps
named by the program's spans inside the benchmark's."""

import pytest

from flowbench import manifest as mf, program, trace
from flowbench.readers import Run
from flowbench.tests.test_bench_trace import Event, fake

MS = 1_000_000  # ns


def spans(**self_ms):
    """``summary()["spans"]`` entries of ``name=(count, self ms)``."""
    return {name.replace("__", "."): {"count": c, "total_ns": int(ms * MS) + 7,
                                      "self_ns": int(ms * MS)}
            for name, (c, ms) in self_ms.items()}


TRAIN = {
    "spans": spans(unflow__train__step=(8, 40.0), unflow__train__put_batch=(8, 24.0),
                   unflow__train__augment=(8, 16.0), unflow__train__forward=(8, 80.0),
                   unflow__train__loss=(8, 320.0), unflow__train__backward=(8, 240.0),
                   unflow__train__adam=(8, 56.0), unflow__loader__wait=(9, 4.5),
                   unflow__loader__gather=(10, 30.0)),
    "counters": {"loader.gets": 200, "loader.starved": 5, "corr_fwd_bf16": 3},
}
INFER = {
    "spans": spans(unflow__infer__request=(32, 16.0), unflow__infer__pad=(32, 64.0),
                   unflow__infer__h2d=(32, 32.0), unflow__infer__forward=(32, 96.0),
                   unflow__infer__d2h=(32, 128.0)),
    "counters": {"infer.requests": 4, "infer.h2d_bytes": 6 * 2**20, "infer.d2h_bytes": 2**20},
}
EXPECTED = {
    "host_put_batch_ms.train": 3.0, "host_augment_ms.train": 2.0, "host_forward_ms.train": 10.0,
    "host_loss_ms.train": 40.0, "host_backward_ms.train": 30.0, "host_adam_ms.train": 7.0,
    "loader_wait_ms.train": 0.5, "loader_gather_ms.train": 3.0,
    "loader_starved_share.train": 2.5,
    "host_pad_ms.infer": 2.0, "host_h2d_ms.infer": 1.0, "host_forward_ms.infer": 3.0,
    "host_d2h_wait_ms.infer": 4.0, "infer_copy_mib": 1.75,
}


def run(kind, traced=True):
    return Run(kind=kind, chips=1, setup_s=1.0, window_s=1.0, units=1, pairs_per_unit=1,
               latencies_s=[], peak_bytes=0, flops_per_unit=0, peak_flops=None,
               bytes_per_s=None, corr_shape=(1, 1, 1, 1), corr_d=1, dtype_bytes=2,
               trace=object() if traced else None)


def kind_of(name):
    return "infer" if name.endswith(".infer") or name == "infer_copy_mib" else "train"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_its_span_or_counters(monkeypatch, name):
    kind = kind_of(name)
    monkeypatch.setattr(program, "program_summary", lambda: TRAIN if kind == "train" else INFER)
    read = mf.reader(name)
    assert read(run(kind)) == pytest.approx(EXPECTED[name])
    # the other kind of run, and a run without a traced stretch, read nothing
    assert read(run("infer" if kind == "train" else "train")) is None
    assert read(run(kind, traced=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_reads_none_where_the_program_recorded_nothing(monkeypatch, name):
    kind = kind_of(name)
    monkeypatch.setattr(program, "program_summary", lambda: {"spans": {}, "counters": {}})
    assert mf.reader(name)(run(kind)) is None
    monkeypatch.setattr(program, "program_summary", lambda: None)  # a program without them
    assert mf.reader(name)(run(kind)) is None


def test_every_new_metric_is_an_entry_of_its_cell():
    layer = {m["name"]: m for m in mf.load()["per_layer"]}
    for name in EXPECTED:
        cell = "c-infer-kitti" if kind_of(name) == "infer" else "c-train-kitti"
        assert layer[name]["workloads"] == [cell]
        assert layer[name]["source"] == ("program_counter" if name in (
            "loader_starved_share.train", "infer_copy_mib") else "program_span")


def test_an_idle_gap_is_named_by_the_programs_span_inside_the_benchmarks():
    events = [
        Event("user_annotation", trace.WINDOW, 0, 100),
        Event("user_annotation", "flowbench.train_step", 0, 100),
        Event("user_annotation", "unflow.train.step", 2, 96),
        Event("user_annotation", "unflow.train.loss", 10, 40),
        Event("cpu_op", "aten::mul", 20, 5),
        Event("user_annotation", "unflow.train.backward", 50, 40),
        Event("user_annotation", "unflow.loader.gather", 0, 100, thread=2),  # another thread
        Event("kernel", "elementwise_kernel", 0, 10),
        Event("kernel", "elementwise_kernel", 30, 10),
        Event("kernel", "elementwise_kernel", 60, 40),
    ]
    t = trace.reduce(fake(events))
    # gaps [10, 30] (middle 20: the mul in the loss) and [40, 60] (middle 50:
    # the backward's first instant, no op)
    assert t.idle == pytest.approx({"unflow.train.loss:aten::mul": 20e-6,
                                    "unflow.train.backward:python": 20e-6})
