"""Port's held-out acceptance run (``python -m unflow_tpu_torch.heldout``)
against ``scripts/heldout_generalization.py``: the held-out set, its
zero-flow AEE and the held-out AEE of the same parameters (float32, and the
bf16 model at the recipe's correlation), each arm's config; and short runs on
the CPU, in two segments across the bootstrap boundary, of each arm."""

import argparse
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu_torch import heldout
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.models import build_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, BATCH = 64, 128, 2


@pytest.fixture(scope="module")
def script():
    """``scripts/heldout_generalization.py``, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        "heldout_generalization", ROOT / "scripts" / "heldout_generalization.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_heldout_set_and_eval_match_the_script(script):
    """The same 8 held-out batches, the same zero-flow AEE, and the held-out
    AEE of one set of parameters within 1e-4 (float32, plain correlation)."""
    assert (heldout.HELDOUT_SEED, heldout.HELDOUT_BATCHES) == (script.HELDOUT_SEED,
                                                              script.HELDOUT_BATCHES)
    cfgs = ConfigJax(), Config()
    for c in cfgs:
        c.train.compute_dtype, c.train.corr_impl, c.train.max_displacement = "float32", "jnp", 4
    model_jax = build_model_jax(cfgs[0])
    sample = jnp.zeros((1, H, W, 3), jnp.float32)
    params = jax.jit(model_jax.init)(jax.random.PRNGKey(0), sample, sample)["params"]
    eval_jax, zero_jax = script.make_eval_fn(model_jax, H, W, BATCH, "affine", max_shift=32.0)

    held = heldout.heldout_set(BATCH, H, W)
    assert heldout.zero_flow_aee(held) == pytest.approx(zero_jax, rel=1e-6)
    model = build_model(cfgs[1], "cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    got = heldout.make_eval_fn(held, "cpu")(model)["heldout_aee"]
    assert got == pytest.approx(eval_jax(params)["heldout_aee"], rel=1e-4)


@pytest.mark.parametrize("hw,batch", [((H, W), BATCH), ((128, 256), 8)], ids=["64x128", "recipe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heldout_eval_at_init_matches_jax(script, hw, batch, dtype):
    """The held-out AEE of JAX's init (``PRNGKey(0)``) with the recipe's
    correlation (D = 21), in float32 and in bfloat16 as the run trains the
    model, at 64x128 and at the recipe's 128x256, batch 8: the two packages
    within 1e-4 (``-s`` prints both)."""
    h, w = hw
    cfgs = ConfigJax(), Config()
    for c in cfgs:
        c.train.compute_dtype, c.train.max_displacement = dtype, 20
    cfgs[0].train.corr_impl, cfgs[1].train.corr_impl = "jnp", "torch"
    model_jax = build_model_jax(cfgs[0])
    sample = jnp.zeros((1, h, w, 3), jnp.float32)
    params = jax.jit(model_jax.init)(jax.random.PRNGKey(0), sample, sample)["params"]
    eval_jax, zero_jax = script.make_eval_fn(model_jax, h, w, batch, "affine", max_shift=32.0)
    model = build_model(cfgs[1], "cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    got = heldout.make_eval_fn(heldout.heldout_set(batch, h, w), "cpu")(model)["heldout_aee"]
    want = eval_jax(params)["heldout_aee"]
    print(f"{h}x{w} batch {batch} {dtype}: held-out AEE JAX {want!r} port {got!r} "
          f"(relative {abs(got - want) / want:.3e}); zero flow {zero_jax!r}")
    assert got == pytest.approx(want, rel=1e-4)
    assert want != pytest.approx(zero_jax, rel=1e-3)  # the init predicts some flow


@pytest.mark.parametrize("affine", [False, True], ids=["affine_off", "affine_on"])
@pytest.mark.parametrize("bootstrap", [False, True])
def test_build_cfg_matches_the_script(script, affine, bootstrap):
    """Every train key of each arm's config, as the script builds it with the
    recipe's arguments."""
    argv = ["--hw", "64", "96", "--batch", "4", "--steps", "10", "--segments", "2"]
    mine = heldout.build_cfg(heldout.parse_args(argv), affine=affine, bootstrap=bootstrap).train
    args = argparse.Namespace(hw=(64, 96), batch=4, steps=10, lr=1e-4, decay_after=0,
                              segments=2, eval_every=250, dtype="bfloat16", grad_clip=0.0,
                              no_photometric=False, no_hflip=False, noise=0.04)
    theirs = script.build_cfg(args, affine=affine, bootstrap=bootstrap).train
    for key in vars(theirs):
        if key != "decay_interval":  # flat: decay_after is the last step
            assert getattr(mine, key) == getattr(theirs, key), key
    assert (mine.aug_rotate != 0.0) == affine


def test_build_cfg_takes_the_recipe_then_the_overrides():
    def args(*sets):
        argv = ["--hw", "64", "96", "--batch", "4", "--steps", "10", "--segments", "2"]
        for kv in sets:
            argv += ["--set", kv]
        return heldout.parse_args(argv)

    t = heldout.build_cfg(args(), bootstrap=True).train
    assert (t.flownet, t.height, t.width, t.batch_size, t.num_iters) == ("C", 64, 96, 4, 10)
    assert (t.photo_weight, t.ternary_weight, t.occ_weight, t.mask_occlusion) == (1.0, 0.0, 0.0, "")
    assert (t.decay_after, t.save_interval, t.eval_interval) == (10, 5, 250)
    assert (t.learning_rate, t.grad_clip_norm, t.aug_noise_stddev) == (1e-4, 0.0, 0.04)
    assert (t.aug_photometric, t.aug_hflip, t.compute_dtype) == (True, True, "bfloat16")
    t = heldout.build_cfg(args("corr_impl=torch", "seed=3")).train
    assert (t.ternary_weight, t.mask_occlusion, t.corr_impl, t.seed) == (1.0, "fb", "torch", 3)
    with pytest.raises(SystemExit, match="unknown config key"):
        heldout.build_cfg(args("nope=1"))


def test_segment_bounds_split_at_the_bootstrap():
    assert heldout.segment_bounds(8000, 2, 2000) == [0, 2000, 4000, 8000]
    assert heldout.segment_bounds(4, 2, 2) == [0, 2, 4]
    assert heldout.segment_bounds(6, 1, 0) == [0, 6]


def test_short_run_in_two_segments_writes_its_summary(tmp_path, script, capsys):
    """4 steps at 64x128, batch 2, on a corpus of 8 pairs: steps 1-2 with the
    bootstrap objective, 3-4 with UnFlow's, each segment a new Trainer."""
    out = tmp_path / "heldout.json"
    argv = ["--device", "cpu", "--hw", str(H), str(W), "--batch", str(BATCH), "--corpus", "8",
            "--steps", "4", "--segments", "2", "--bootstrap-until", "2", "--eval-every", "2",
            "--dtype", "float32", "--exp-root", str(tmp_path / "ex"), "--out", str(out)]
    try:
        assert heldout.main(argv) == 0
    finally:
        shutil.rmtree(tmp_path / "ex" / "affine_off" / "checkpoints", ignore_errors=True)
    printed = capsys.readouterr().out
    assert "segment [0, 2) done (bootstrap)" in printed and "segment [2, 4) done" in printed
    summary = json.loads(out.read_text())
    result = summary["affine_off"]
    assert summary["device"] == "cpu" and summary["steps"] == 4
    assert [c["step"] for c in result["curve"]] == [2, 4]
    assert all(np.isfinite(c["aee"]) for c in result["curve"])
    assert result["final_aee"] == result["curve"][-1]["aee"]
    assert result["best_aee"] == min(c["aee"] for c in result["curve"])
    assert [r["step"] for r in result["train_loss"]] == [2, 4]
    _, zero_jax = script.make_eval_fn(None, H, W, BATCH, "affine", max_shift=32.0)
    assert summary["zero_flow_aee"] == result["zero_flow_aee"] == pytest.approx(zero_jax, rel=1e-6)
    assert summary["generalizes"] == (result["final_aee"] < 0.5 * result["zero_flow_aee"])
    assert result["wall_s"] > 0
    # the bootstrap segment trained the photometric term only; the next, census
    lines = (tmp_path / "ex" / "affine_off" / "metrics.jsonl").read_text().splitlines()
    losses = {r["step"]: r for r in map(json.loads, lines) if "loss" in r}
    assert "photo/scale0" in losses[2] and "ternary/scale0" not in losses[2]
    assert "ternary/scale0" in losses[4] and "photo/scale0" not in losses[4]


def test_short_run_of_both_arms(tmp_path):
    """``--arms both`` at 64x128, batch 2, 2 steps each, one segment: both
    arms' curves in the summary, the verdict the ``affine_off`` arm's, the
    ``affine_on`` arm trained with its affine ranges."""
    out = tmp_path / "heldout.json"
    argv = ["--device", "cpu", "--hw", str(H), str(W), "--batch", str(BATCH), "--corpus", "4",
            "--steps", "2", "--segments", "1", "--bootstrap-until", "0", "--eval-every", "2",
            "--dtype", "float32", "--arms", "both", "--exp-root", str(tmp_path / "ex"),
            "--out", str(out), "--set", "max_displacement=4"]
    try:
        assert heldout.main(argv) == 0
    finally:
        for arm in ("affine_off", "affine_on"):
            shutil.rmtree(tmp_path / "ex" / arm / "checkpoints", ignore_errors=True)
    summary = json.loads(out.read_text())
    for arm in ("affine_off", "affine_on"):
        assert [c["step"] for c in summary[arm]["curve"]] == [2]
        assert np.isfinite(summary[arm]["final_aee"])
    assert summary["generalizes"] == (summary["affine_off"]["final_aee"]
                                      < 0.5 * summary["zero_flow_aee"])
    assert summary["affine_aee_delta"] == pytest.approx(
        summary["affine_on"]["final_aee"] - summary["affine_off"]["final_aee"])
    on = [json.loads(line) for line in
          (tmp_path / "ex" / "affine_on" / "metrics.jsonl").read_text().splitlines()]
    off = [json.loads(line) for line in
           (tmp_path / "ex" / "affine_off" / "metrics.jsonl").read_text().splitlines()]
    loss = [next(r["loss"] for r in rows if "loss" in r) for rows in (off, on)]
    assert loss[0] != loss[1]  # the affine draws moved the first step


def test_refusals():
    with pytest.raises(SystemExit, match="--corpus"):
        heldout.main(["--corpus", "0", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            heldout.main(["--steps", "1"])
