"""The reader of ``train_graph_share.train``: the share of train steps replayed
as a CUDA graph, from the program's counters ``train.steps`` and
``train.graph_replays``, on a made-up ``summary()``."""

import pytest

from flowbench import manifest as mf, program
from flowbench.tests.test_bench_program import TRAIN, run

NAME = "train_graph_share.train"


def with_counters(**counters):
    return {"spans": TRAIN["spans"],
            "counters": {k.replace("__", "."): v for k, v in counters.items()}}


@pytest.mark.parametrize("counters, share", [
    ({"train__steps": 160, "train__graph_replays": 159}, 99.375),
    ({"train__steps": 8, "train__graph_replays": 8}, 100.0),
    # a program that counts its steps and never replays one
    ({"train__steps": 160}, 0.0),
    ({"train__steps": 160, "train__graph_replays": 0}, 0.0),
])
def test_the_share_is_the_replayed_steps_over_all_steps(monkeypatch, counters, share):
    monkeypatch.setattr(program, "program_summary", lambda: with_counters(**counters))
    read = mf.reader(NAME)
    assert read(run("train")) == pytest.approx(share)
    # an inference run, and a run without a traced stretch, read nothing
    assert read(run("infer")) is None
    assert read(run("train", traced=False)) is None


@pytest.mark.parametrize("summary", [
    None,  # a program without spans or counters
    {"spans": {}, "counters": {}},
    {"spans": TRAIN["spans"], "counters": dict(TRAIN["counters"])},  # the parent's counters
    {"spans": {}, "counters": {"train.steps": 0, "train.graph_replays": 0}},
])
def test_the_share_reads_none_where_no_step_was_counted(monkeypatch, summary):
    monkeypatch.setattr(program, "program_summary", lambda: summary)
    assert mf.reader(NAME)(run("train")) is None


def test_the_share_is_an_entry_of_the_train_cell():
    entry = {m["name"]: m for m in mf.load()["per_layer"]}[NAME]
    assert entry["workloads"] == ["c-train-kitti"]
    assert entry["source"] == "program_counter"
    assert entry["layer"] == "model step"
    assert entry["moves"] == "train_pairs_per_s"
