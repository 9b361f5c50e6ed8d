"""Port's inference CLI and Evaluator (unflow_tpu_torch.cli.infer,
unflow_tpu_torch.eval.evaluate) against the JAX package's."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.eval.evaluate import Evaluator as EvaluatorJax
from unflow_tpu.train import build_model as build_model_jax
from unflow_tpu_torch.cli.infer import main as infer_main
from unflow_tpu_torch.config import Config, prepare_experiment_dir
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data.io import read_flo, read_image, read_kitti_png_flow, write_image
from unflow_tpu_torch.eval.evaluate import Evaluator
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.train import CheckpointManager, build_optimizer

torch.set_num_threads(1)


@pytest.fixture
def frames(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for name in ("a.png", "b.png"):
        write_image(tmp_path / name, rng.rand(50, 70, 3).astype(np.float32))
        paths.append(str(tmp_path / name))
    return paths


def _run(frames, *extra):
    return infer_main(
        ["--random-init", "--device", "cpu", "--im1", frames[0], "--im2", frames[1], *extra]
    )


def test_infer_random_init_writes_flo_and_viz(tmp_path, frames):
    out, viz = tmp_path / "flow.flo", tmp_path / "flow_viz.png"
    assert _run(frames, "--out", str(out), "--viz", str(viz)) == 0
    flow = read_flo(out)
    assert flow.shape == (50, 70, 2)  # /64 padding cropped back off
    assert np.isfinite(flow).all()
    assert read_image(viz).shape == (50, 70, 3)


def test_infer_kitti_png_output(tmp_path, frames):
    cfg = tmp_path / "f32.ini"
    cfg.write_text("[train]\ncompute_dtype = float32\ndataset = kitti_raw\n")
    out = tmp_path / "flow_10.png"
    assert _run(frames, "--config", str(cfg), "--out", str(out), "--seed", "3") == 0
    flow, valid = read_kitti_png_flow(out)
    assert flow.shape == (50, 70, 2)
    assert valid.all()  # dense prediction: every pixel valid


def test_infer_ex_restores_the_experiment(frames, tmp_path, monkeypatch):
    """``--ex`` alone: the snapshot under ``log/ex/<name>`` supplies the
    network (a csS cascade) and the checkpoint its parameters."""
    cfg = Config()
    cfg.train.flownet, cfg.train.compute_dtype = "csS", "float32"
    cfg.train.max_displacement = 4
    cfg.dirs.log = str(tmp_path / "log")
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(7))
    ex_dir = prepare_experiment_dir(cfg, "css")
    CheckpointManager(ex_dir).save(3, model, build_optimizer(cfg, model))
    monkeypatch.chdir(tmp_path)  # the default config's log directory is ./log
    out = tmp_path / "flow.flo"
    assert infer_main(["--ex", "css", "--device", "cpu", "--im1", frames[0], "--im2", frames[1],
                       "--out", str(out)]) == 0
    want = Evaluator(cfg, params=model.state_dict(), device="cpu").predict(
        read_image(frames[0]), read_image(frames[1]))
    np.testing.assert_array_equal(read_flo(out), want)
    shutil.rmtree(ex_dir / "checkpoints")  # 0.8 GB
    with pytest.raises(SystemExit):  # neither --ex nor --random-init
        infer_main(["--device", "cpu", "--im1", frames[0], "--im2", frames[1], "--out", str(out)])


def test_infer_without_gpu_raises_unless_cpu_requested(frames, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer_main(["--random-init", "--im1", frames[0], "--im2", frames[1],
                    "--out", str(tmp_path / "f.flo")])


def test_evaluator_matches_jax_evaluator():
    cfg_jax = ConfigJax()
    cfg_jax.train.compute_dtype = "float32"
    cfg_jax.train.corr_impl = "jnp"
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.jit(build_model_jax(cfg_jax).init)(jax.random.PRNGKey(1), sample, sample)["params"]
    rng = np.random.RandomState(1)
    im1, im2 = rng.rand(2, 50, 70, 3).astype(np.float32)
    want = EvaluatorJax(cfg_jax, ".", params=params).predict(im1, im2)

    cfg = Config()
    cfg.train.compute_dtype = "float32"
    ev = Evaluator(cfg, params=params_from_flax(jax.device_get(params)), device="cpu")
    got = ev.predict(im1, im2)
    assert got.shape == want.shape == (50, 70, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
