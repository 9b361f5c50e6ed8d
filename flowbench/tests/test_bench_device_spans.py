"""The readers of the program's device spans (``frozen_stages_ms.train``,
``cascade_glue_ms.train``, ``trainable_fwd_ms.train``): device ms a step from
the counters ``device_us.<span>`` and ``device_steps``, on a made-up
``summary()``; None where the program read no such span, as the parent of
the spans reads; and their entries in ``BENCHMARK.json``."""

import pytest

from flowbench import manifest as mf, program
from flowbench.tests.test_bench_program import TRAIN, run

READERS = {
    "frozen_stages_ms.train": ("device_us.unflow.dev.frozen", ["css-train-kitti"]),
    "cascade_glue_ms.train": ("device_us.unflow.dev.glue", ["css-train-kitti"]),
    "trainable_fwd_ms.train": ("device_us.unflow.dev.trainable_fwd",
                               ["c-train-kitti", "css-train-kitti"]),
}


def with_counters(counters):
    return {"spans": TRAIN["spans"], "counters": {**TRAIN["counters"], **counters}}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("us, steps, ms", [(2_500_000, 125, 20.0), (1_234, 1, 1.234),
                                            (7, 8, 0.000875)])
def test_each_reader_is_device_ms_a_step(monkeypatch, name, us, steps, ms):
    counter, _ = READERS[name]
    monkeypatch.setattr(program, "program_summary",
                        lambda: with_counters({counter: us, "device_steps": steps}))
    read = mf.reader(name)
    assert read(run("train")) == pytest.approx(ms)
    # an inference run, and a run without a traced stretch, read nothing
    assert read(run("infer")) is None
    assert read(run("train", traced=False)) is None


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("summary", [
    None,  # a program without spans or counters
    {"spans": {}, "counters": {}},
    with_counters({}),  # a program without device spans: the parent's
    with_counters({"device_steps": 40}),  # C reads no frozen stage and no glue
    with_counters({"device_us.unflow.dev.frozen": 0, "device_us.unflow.dev.glue": 0,
                   "device_us.unflow.dev.trainable_fwd": 0, "device_steps": 0}),
])
def test_a_reader_reads_none_where_no_step_was_read(monkeypatch, name, summary):
    monkeypatch.setattr(program, "program_summary", lambda: summary)
    assert mf.reader(name)(run("train")) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_is_an_entry_of_the_cells_that_have_its_span(name):
    m = mf.load()
    entry = {x["name"]: x for x in m["per_layer"]}[name]
    assert entry["workloads"] == READERS[name][1]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"]) == (
        "ms", "lower", "program_counter", "model step", "train_pairs_per_s")
    for cell in entry["workloads"]:
        assert entry in mf.metrics(m, cell)[1]


def test_the_css_cell_reports_the_training_metrics():
    m = mf.load()
    cell = mf.cell(m, "css-train-kitti")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "unflow-css", "kitti-packed-train", 1)
    entry = {c["name"]: c for c in m["configs"]}["unflow-css"]
    assert entry["reduced"] == ["finetune", "dataset_pairs"]
    assert mf.config(m, "unflow-css")["train"]["flownet"] == "csS"
    e2e, layer = mf.metrics(m, "css-train-kitti")
    assert {x["name"] for x in e2e} == {"train_pairs_per_s", "train_peak_gib", "setup_s"}
    names = {x["name"] for x in layer}
    assert set(READERS) <= names
    # the host phases a replayed step does not run are left to the C cell
    assert not names & {"host_forward_ms.train", "host_loss_ms.train", "host_backward_ms.train",
                        "host_adam_ms.train"}
    # the cell's metrics are those of C's cell, less those four, and its own
    c_names = {x["name"] for x in mf.metrics(m, "c-train-kitti")[1]}
    assert names == (c_names - {"host_forward_ms.train", "host_loss_ms.train",
                                "host_backward_ms.train", "host_adam_ms.train"}
                     ) | {"frozen_stages_ms.train", "cascade_glue_ms.train"}
