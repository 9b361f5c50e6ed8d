"""The reader of ``infer_graph_share.infer``: the share of requests whose
forward was replayed as a CUDA graph, from the program's counters
``infer.requests`` and ``infer.graph_replays``, on a made-up ``summary()``."""

import pytest

from flowbench import manifest as mf, program
from flowbench.tests.test_bench_program import INFER, run

NAME = "infer_graph_share.infer"


def with_counters(**counters):
    return {"spans": INFER["spans"],
            "counters": {k.replace("__", "."): v for k, v in counters.items()}}


@pytest.mark.parametrize("counters, share", [
    ({"infer__requests": 1600, "infer__graph_replays": 1599}, 99.9375),
    ({"infer__requests": 8, "infer__graph_replays": 8}, 100.0),
    # a program that counts replays and made none (the CPU's eager path)
    ({"infer__requests": 40, "infer__graph_replays": 0}, 0.0),
])
def test_the_share_is_the_replayed_requests_over_all_requests(monkeypatch, counters, share):
    monkeypatch.setattr(program, "program_summary", lambda: with_counters(**counters))
    read = mf.reader(NAME)
    assert read(run("infer")) == pytest.approx(share)
    # a training run, and a run without a traced stretch, read nothing
    assert read(run("train")) is None
    assert read(run("infer", traced=False)) is None


@pytest.mark.parametrize("summary", [
    None,  # a program without spans or counters
    {"spans": {}, "counters": {}},
    {"spans": INFER["spans"], "counters": dict(INFER["counters"])},  # a program without replays
    {"spans": {}, "counters": {"infer.requests": 0, "infer.graph_replays": 0}},
])
def test_the_share_reads_none_where_replays_or_requests_were_not_counted(monkeypatch, summary):
    monkeypatch.setattr(program, "program_summary", lambda: summary)
    assert mf.reader(NAME)(run("infer")) is None


def test_the_share_is_an_entry_of_the_serving_cell():
    entry = {m["name"]: m for m in mf.load()["per_layer"]}[NAME]
    assert entry["workloads"] == ["c-infer-kitti"]
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["source"] == "program_counter"
    assert entry["layer"] == "model step"
    assert entry["moves"] == "infer_ms_p50"
