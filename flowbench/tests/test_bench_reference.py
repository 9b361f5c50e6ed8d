"""The frozen reference against the port at a tiny size on the CPU, and the
faults a cell can have: each drives the rest of a run with the timed path
broken underneath, and ``correct`` comes out false."""

import pytest
import torch

from flowbench.tests.tiny import execute, session


@pytest.mark.parametrize("cell", ["c-train-kitti", "css-train-kitti"])
def test_training_follows_the_reference_in_float32(cell, tmp_path):
    line = execute(session(cell, tmp_path, compute_dtype="float32"))
    assert line["correct"], line["checks"]
    for name, c in line["checks"].items():
        assert c["value"] < 1e-2, (name, c)


def test_serving_follows_the_reference_in_float32(tmp_path):
    line = execute(session("c-infer-kitti", tmp_path, compute_dtype="float32"))
    assert line["correct"] and line["checks"]["flow_gap"]["value"] < 1e-4, line["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line = execute(session("c-train-kitti", tmp_path, compute_dtype="float32"))
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(tmp_path, monkeypatch):
    from unflow_tpu_torch.train import Trainer

    whole = Trainer.train_step

    def half(self, batch):
        return whole(self, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "train_step", half)
    line = execute(session("c-train-kitti", tmp_path, compute_dtype="float32"))
    assert not line["correct"], line["checks"]


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path, monkeypatch):
    from unflow_tpu_torch.eval.evaluate import Evaluator

    right = Evaluator.predict_batch

    def off_by_one(self, ims1, ims2):
        flow = right(self, ims1, ims2)
        flow[..., 0] += 1.0
        return flow

    monkeypatch.setattr(Evaluator, "predict_batch", off_by_one)
    line = execute(session("c-infer-kitti", tmp_path, compute_dtype="float32"))
    assert not line["correct"], line["checks"]

