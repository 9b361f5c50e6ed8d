"""Port's checkpoints (unflow_tpu_torch/train/checkpoint.py), resume, the
finetune recipe C -> cS -> csS through ``cli.train``, and a JAX (orbax)
experiment carried into a port checkpoint, on the CPU."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.eval.evaluate import Evaluator as EvaluatorJax
from unflow_tpu.train.checkpoint import CheckpointManager as CheckpointManagerJax
from unflow_tpu.train.checkpoint import restore_params as restore_params_jax
from unflow_tpu.train.trainer import TrainState as TrainStateJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.train.trainer import build_optimizer as build_optimizer_jax
from unflow_tpu_torch.cli import train as cli_train
from unflow_tpu_torch.config import Config, load_config, prepare_experiment_dir
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.eval.evaluate import Evaluator
from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train import (
    CheckpointManager,
    Trainer,
    build_optimizer,
    init_stages_from,
    restore_params,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A FlowNet checkpoint is 0.5-1.4 GB: none outlives its test."""
    yield
    for path in list(tmp_path.rglob("checkpoints")):
        shutil.rmtree(path)


class _Stages(nn.Module):
    """A tiny stand-in for a stack: one linear layer per named stage."""

    def __init__(self, names, width=3):
        super().__init__()
        for name in names:
            self.add_module(name, nn.Linear(width, 2))


def _save(exp_dir, model, step=1):
    CheckpointManager(exp_dir).save(step, model, torch.optim.Adam(model.parameters()))


def test_save_restores_model_optimizer_and_step(tmp_path):
    torch.manual_seed(0)
    model = _Stages(["stage0_C", "stage1_S"])
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.randn(4, 3)
    (model.stage0_C(x) * model.stage1_S(x)).sum().backward()
    optimizer.step()
    CheckpointManager(tmp_path).save(7, model, optimizer)

    again = _Stages(["stage0_C", "stage1_S"])
    opt_again = torch.optim.Adam(again.parameters(), lr=1e-3)
    assert CheckpointManager(tmp_path).restore(again, opt_again) == 7
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        want, got = optimizer.state[p], opt_again.state[q]
        assert torch.equal(want["exp_avg"], got["exp_avg"])
        assert torch.equal(want["exp_avg_sq"], got["exp_avg_sq"])
        assert got["step"].device.type == "cpu" and float(got["step"]) == 1.0
    assert restore_params(tmp_path).keys() == model.state_dict().keys()


def test_save_is_atomic_and_keeps_the_newest(tmp_path, monkeypatch):
    model = _Stages(["stage0_S"])
    manager = CheckpointManager(tmp_path, max_to_keep=3)
    for step in range(1, 6):
        manager.save(step, model, torch.optim.Adam(model.parameters()))
    assert manager.steps() == [3, 4, 5]

    # a save in flight (a crash mid-write): its bytes never show as a checkpoint
    (manager.directory / ".6.abc.tmp").write_bytes(b"partial")

    def crash(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError, match="disk full"):
        manager.save(7, model, torch.optim.Adam(model.parameters()))
    monkeypatch.undo()
    assert manager.steps() == [3, 4, 5] and manager.latest_step() == 5
    assert sorted(p.name for p in manager.directory.iterdir()) == [
        ".6.abc.tmp", "3.pt", "4.pt", "5.pt"
    ]
    assert CheckpointManager(tmp_path / "none").latest_step() is None
    with pytest.raises(FileNotFoundError):
        restore_params(tmp_path / "none")


def test_init_stages_from_takes_the_last_source_per_stage(tmp_path):
    torch.manual_seed(1)
    c_only = _Stages(["stage0_C"])
    c_and_s = _Stages(["stage0_C", "stage1_S"])
    _save(tmp_path / "c", c_only)
    _save(tmp_path / "cs", c_and_s)
    fresh = _Stages(["stage0_C", "stage1_S", "stage2_S"]).state_dict()

    state = init_stages_from(fresh, [tmp_path / "c"])
    assert torch.equal(state["stage0_C.weight"], c_only.stage0_C.weight)
    assert torch.equal(state["stage1_S.weight"], fresh["stage1_S.weight"])  # missing: fresh

    state = init_stages_from(fresh, [tmp_path / "c", tmp_path / "cs"])
    assert torch.equal(state["stage0_C.weight"], c_and_s.stage0_C.weight)  # the last wins
    assert torch.equal(state["stage1_S.bias"], c_and_s.stage1_S.bias)
    assert torch.equal(state["stage2_S.weight"], fresh["stage2_S.weight"])

    with pytest.raises(FileNotFoundError, match="nowhere"):
        init_stages_from(fresh, [tmp_path / "c", tmp_path / "nowhere"])
    _save(tmp_path / "wide", _Stages(["stage0_C"], width=5))
    with pytest.raises(ValueError, match="stage0_C.weight"):
        init_stages_from(fresh, [tmp_path / "wide"])


def _ini(tmp_path, name, flownet, finetune=""):
    """The recipe's shapes in ``tests/test_recipe.py``: 64x64, batch 2,
    max_displacement 4, float32, 2 steps, a checkpoint every 2."""
    path = tmp_path / f"{name}.ini"
    lines = [
        "[dirs]", f"log = {tmp_path / 'log'}", "[train]", "dataset = synthetic",
        f"flownet = {flownet}", "batch_size = 2", "height = 64", "width = 64",
        "max_displacement = 4", "num_iters = 2", "display_interval = 1", "save_interval = 2",
        "image_summary_interval = -1", "compute_dtype = float32", "corr_impl = jnp",
        "num_threads = 0",
    ]
    if finetune:
        lines.append(f"finetune = {finetune}")
    path.write_text("\n".join(lines) + "\n")
    return path


def _train(path, ex, *extra):
    return cli_train.main(["--config", str(path), "--ex", ex, "--device", "cpu", *extra])


def test_two_segment_run_is_bit_identical(tmp_path, capsys):
    ini = _ini(tmp_path, "c", "C")
    assert _train(ini, "whole", "--set", "num_iters=4") == 0

    # segment 1: a Trainer on the snapshot stops at step 2 and saves
    cfg = load_config(ini)
    cfg.train.num_iters = 4
    prepare_experiment_dir(cfg, "split")
    ex_dir = cfg.experiment_dir("split")
    batches, _ = cli_train.build_batches_and_norm(cfg)
    first = Trainer(cfg, ex_dir, batches, device="cpu")
    first.run(max_iters=2)
    assert first.step == 2 and CheckpointManager(ex_dir).steps() == [2]
    # segment 2: cli.train restarts the experiment from its checkpoint
    capsys.readouterr()
    assert _train(ini, "split") == 0
    out = capsys.readouterr().out
    assert "experiment split: step 2 -> 4" in out and "done at step 4" in out

    whole = CheckpointManager(cfg.experiment_dir("whole")).load()
    split = CheckpointManager(ex_dir).load()
    assert whole["step"] == split["step"] == 4
    for key, value in whole["model"].items():
        assert torch.equal(value, split["model"][key]), key
    for index, slot in whole["optimizer"]["state"].items():
        for name, value in slot.items():
            assert torch.equal(value, split["optimizer"]["state"][index][name]), (index, name)

    def losses(ex):
        lines = (cfg.experiment_dir(ex) / "metrics.jsonl").read_text().splitlines()
        return {r["step"]: r["loss"] for r in map(json.loads, lines)}

    assert losses("split") == losses("whole") and sorted(losses("whole")) == [1, 2, 3, 4]


def test_recipe_c_cs_css_through_cli_train(tmp_path):
    """``tests/test_recipe.py`` on the port: the frozen stages of each later
    experiment equal the stages of the experiments they came from."""
    assert _train(_ini(tmp_path, "c", "C"), "rc_c") == 0
    assert _train(_ini(tmp_path, "cs", "cS", "rc_c"), "rc_cs") == 0
    assert _train(_ini(tmp_path, "css", "csS", "rc_c,rc_cs"), "rc_css") == 0

    log = tmp_path / "log" / "ex"
    p_c, p_cs, p_css = (restore_params(log / ex) for ex in ("rc_c", "rc_cs", "rc_css"))
    assert {k.split(".")[0] for k in p_css} == {"stage0_C", "stage1_S", "stage2_S"}
    c_keys = [k for k in p_c if k.startswith("stage0_C.")]
    s_keys = [k for k in p_cs if k.startswith("stage1_S.")]
    assert c_keys and s_keys
    for key in c_keys:  # stage 0 frozen in cS and csS: the C experiment's
        assert torch.equal(p_c[key], p_cs[key]) and torch.equal(p_c[key], p_css[key]), key
    for key in s_keys:  # stage 1 frozen in csS: the cS experiment's
        assert torch.equal(p_cs[key], p_css[key]), key
    assert not torch.equal(p_css["stage2_S.conv1.weight"], p_cs["stage1_S.conv1.weight"])
    for ex in ("rc_c", "rc_cs", "rc_css"):
        records = (log / ex / "metrics.jsonl").read_text().splitlines()
        assert all(np.isfinite(json.loads(r)["loss"]) for r in records)

    snap = load_config(log / "rc_css" / "config.ini")
    assert snap.train.flownet == "csS" and snap.train.finetune == ("rc_c", "rc_cs")


def test_orbax_experiment_serves_the_same_flow_through_the_port(tmp_path):
    """A JAX experiment (orbax) restored with the JAX package's
    ``restore_params``, converted and saved as a port checkpoint: the port's
    ``Evaluator(exp_dir=...)`` gives the JAX Evaluator's flow within 1e-4."""
    cfg_jax = ConfigJax()
    cfg = Config()
    for c in (cfg_jax, cfg):
        c.train.flownet, c.train.compute_dtype = "csS", "float32"
        c.train.max_displacement, c.train.corr_impl = 4, "jnp"
    model_jax = build_model_jax(cfg_jax)
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.jit(model_jax.init)(jax.random.PRNGKey(3), sample, sample)["params"]
    tx = build_optimizer_jax(cfg_jax, params)
    manager = CheckpointManagerJax(tmp_path / "jax_ex")
    manager.save(5, TrainStateJax(jnp.asarray(5, jnp.int32), params, tx.init(params)), wait=True)
    manager.close()

    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_flax(restore_params_jax(tmp_path / "jax_ex")))
    CheckpointManager(tmp_path / "port_ex").save(5, model, build_optimizer(cfg, model))

    rng = np.random.RandomState(4)
    im1, im2 = rng.rand(2, 50, 70, 3).astype(np.float32)
    want = EvaluatorJax(cfg_jax, tmp_path / "jax_ex").predict(im1, im2)
    got = Evaluator(cfg, exp_dir=tmp_path / "port_ex", device="cpu").predict(im1, im2)
    assert got.shape == want.shape == (50, 70, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_evaluator_needs_params_or_an_experiment():
    with pytest.raises(ValueError, match="exp_dir"):
        Evaluator(Config(), device="cpu")
