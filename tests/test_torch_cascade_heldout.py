"""The port's cascade held-out run (``python -m
unflow_tpu_torch.cascade_heldout``) against ``scripts/cascade_heldout.py``:
each stage's config (every train key the script's ``_stage_cfg`` sets, at
its defaults and with a decay, a clip and float32), the experiments that
initialize each stage's frozen stages; and a short run on the CPU (64x128,
batch 2, float32, 2 steps a stage in 2 segment processes) from a stage-1
checkpoint: the summary, and the csS checkpoint's frozen stages equal to
their sources."""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from unflow_tpu_torch import cascade_heldout
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.train import CheckpointManager, build_optimizer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def script():
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    spec = importlib.util.spec_from_file_location("cascade_heldout",
                                                  ROOT / "scripts" / "cascade_heldout.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_args(args) -> argparse.Namespace:
    """The script's namespace for the same run (its argument names)."""
    return argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "device"})


@pytest.mark.parametrize("argv", [[], ["--decay-after", "1000", "--grad-clip", "5.0",
                                       "--dtype", "float32", "--steps", "3000"]],
                         ids=["defaults", "decay_clip_f32"])
@pytest.mark.parametrize("spec", list(cascade_heldout.STAGE_SPECS))
def test_stage_config_is_the_scripts(script, spec, argv):
    args = cascade_heldout.parse_args(argv)
    want = script._stage_cfg(_jax_args(args), spec).train
    mine = cascade_heldout.stage_cfg(args, spec).train
    for key in vars(mine):
        if hasattr(want, key) and key != "corr_impl":
            assert getattr(mine, key) == getattr(want, key), key
    root = Path(args.exp_root)
    assert cascade_heldout.finetune_dirs(args, spec, root) == script._finetune_dirs(
        _jax_args(args), spec, root)


def test_short_cascade_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # stage 1: a FlowNetC experiment of the recipe, saved at its last step
    args = cascade_heldout.parse_args(["--hw", "64", "128", "--batch", "2"])
    cfg = cascade_heldout.stage_cfg(args, "C")
    cfg.train.compute_dtype = "float32"
    net = build_model(cfg, "cpu")
    init_params(net, torch.Generator().manual_seed(3))
    stage1 = tmp_path / "log" / "ex" / "heldout" / "affine_on"
    CheckpointManager(stage1).save(8, net, build_optimizer(cfg, net))
    out = tmp_path / "cascade.json"
    assert cascade_heldout.main([
        "--steps", "2", "--segments", "2", "--eval-every", "1", "--hw", "64", "128",
        "--batch", "2", "--corpus", "4", "--dtype", "float32", "--device", "cpu",
        "--stage1", str(stage1), "--synth-cache", str(tmp_path / "cache"),
        "--exp-root", str(tmp_path / "cascade"), "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["stage1_arm"] == "affine_on" and "C2" in summary["stage1_note"]
    assert set(summary["stages"]) == {"C", "cS", "csS"}
    for spec in ("cS", "csS"):
        stage = summary["stages"][spec]
        assert [c["step"] for c in stage["curve"]] == [1, 2]
        assert stage["final_aee"] == stage["curve"][-1]["aee"]
        assert stage["kernel_launches"] == {}  # the plain correlation on the CPU
    assert summary["stacking_improves"] == (
        summary["stages"]["csS"]["final_aee"] < summary["stages"]["cS"]["final_aee"]
        < summary["stages"]["C"]["final_aee"])
    # csS's frozen stages are stage 1's C and cS's S, untouched
    css = CheckpointManager(tmp_path / "cascade" / "csS").load()["model"]
    cs = CheckpointManager(tmp_path / "cascade" / "cS").load()["model"]
    c = net.state_dict()
    for key, value in css.items():
        if key.startswith("stage0_C."):
            assert torch.equal(value, c[key]), key
        elif key.startswith("stage1_S."):
            assert torch.equal(value, cs[key]), key
