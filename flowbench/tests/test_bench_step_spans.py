"""The readers of the train step's device spans after the forward
(``loss_ms.train``, ``backward_ms.train``, ``adam_ms.train``,
``cascade_bwd_ms.train``): device ms a step from the counters
``device_us.<span>`` and ``device_steps``, on a made-up ``summary()``; None
where the program read no such span, as the parent of the spans reads; their
entries in ``BENCHMARK.json``; and the cell ``cssjoint-train-kitti``."""

import pytest

from flowbench import manifest as mf, program
from flowbench.tests.test_bench_program import TRAIN, run

TRAIN_CELLS = ["c-train-kitti", "css-train-kitti", "cssjoint-train-kitti"]
READERS = {
    "loss_ms.train": ("device_us.unflow.dev.loss", TRAIN_CELLS),
    "backward_ms.train": ("device_us.unflow.dev.backward", TRAIN_CELLS),
    "adam_ms.train": ("device_us.unflow.dev.adam", TRAIN_CELLS),
    "cascade_bwd_ms.train": ("device_us.unflow.dev.cascade_bwd", ["cssjoint-train-kitti"]),
}


def with_counters(counters):
    return {"spans": TRAIN["spans"], "counters": {**TRAIN["counters"], **counters}}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("us, steps, ms", [(6_250_000, 125, 50.0), (1_234, 1, 1.234),
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
    # the parent of these spans: the forward's spans alone
    with_counters({"device_us.unflow.dev.trainable_fwd": 7_000, "device_steps": 40}),
    with_counters({"device_us.unflow.dev.loss": 0, "device_us.unflow.dev.backward": 0,
                   "device_us.unflow.dev.adam": 0, "device_us.unflow.dev.cascade_bwd": 0,
                   "device_steps": 0}),
])
def test_a_reader_reads_none_where_no_step_was_read(monkeypatch, name, summary):
    monkeypatch.setattr(program, "program_summary", lambda: summary)
    assert mf.reader(name)(run("train")) is None


def test_c_and_css_read_no_cascade_backward(monkeypatch):
    # a stack whose earlier stages are frozen, or that has none, has no span
    # from the last stage's input on
    monkeypatch.setattr(program, "program_summary", lambda: with_counters({
        "device_us.unflow.dev.backward": 80_000, "device_steps": 2}))
    assert mf.reader("backward_ms.train")(run("train")) == pytest.approx(40.0)
    assert mf.reader("cascade_bwd_ms.train")(run("train")) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_is_an_entry_of_the_cells_that_have_its_span(name):
    m = mf.load()
    entry = {x["name"]: x for x in m["per_layer"]}[name]
    assert entry["workloads"] == READERS[name][1]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"]) == (
        "ms", "lower", "program_counter", "model step", "train_pairs_per_s")
    for cell in entry["workloads"]:
        assert entry in mf.metrics(m, cell)[1]


def test_the_joint_css_cell_reports_the_training_metrics():
    m = mf.load()
    cell = mf.cell(m, "cssjoint-train-kitti")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "unflow-css-joint", "kitti-packed-train", 1)
    entry = {c["name"]: c for c in m["configs"]}["unflow-css-joint"]
    assert entry["reduced"] == ["finetune", "dataset_pairs"]
    keys = mf.config(m, "unflow-css-joint")["train"]
    assert (keys["flownet"], keys["learning_rate"], keys["train_all"], keys["remat"]) == (
        "CSS", 1e-05, False, False)
    # every other train key is csS's
    css = mf.config(m, "unflow-css")["train"]
    assert {k: v for k, v in keys.items() if k != "flownet"} == {
        k: v for k, v in css.items() if k != "flownet"}
    e2e, layer = mf.metrics(m, "cssjoint-train-kitti")
    assert {x["name"] for x in e2e} == {"train_pairs_per_s", "train_peak_gib", "setup_s"}
    names = {x["name"] for x in layer}
    # csS's metrics, less its frozen stages, and the backward from the last
    # stage's input on
    css_names = {x["name"] for x in mf.metrics(m, "css-train-kitti")[1]}
    assert names == (css_names - {"frozen_stages_ms.train"}) | {"cascade_bwd_ms.train"}
    assert set(READERS) <= names
    assert mf.limits("cssjoint-train-kitti").keys() == {"loss_gap", "grad_gap", "change_gap"}
