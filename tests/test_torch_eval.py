"""Port's ``Evaluator.run`` and ``cli.eval`` against the JAX package's, on a
KITTI 2012 fixture tree, from the same flax FlowNetC parameters (float32, the
plain correlation), on the CPU."""

import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.cli.eval import main as eval_main_jax
from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.config import save_config as save_config_jax
from unflow_tpu.data import get_dataset as get_dataset_jax
from unflow_tpu.data.base import Example as ExampleJax
from unflow_tpu.eval.evaluate import Evaluator as EvaluatorJax
from unflow_tpu.train.checkpoint import CheckpointManager as CheckpointManagerJax
from unflow_tpu.train.trainer import TrainState as TrainStateJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.train.trainer import build_optimizer as build_optimizer_jax
from unflow_tpu_torch.cli.eval import main as eval_main
from unflow_tpu_torch.config import Config, save_config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data import (
    DEFAULT_NORMALIZATION,
    KITTI_NORMALIZATION,
    Example,
    get_dataset,
)
from unflow_tpu_torch.data.io import (
    read_flo,
    read_image,
    read_kitti_png_flow,
    write_flo,
    write_image,
    write_kitti_png_flow,
)
from unflow_tpu_torch.eval.evaluate import Evaluator
from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train import CheckpointManager, build_optimizer

torch.set_num_threads(1)

# (frame id, height, width): two shapes, so that run() batches by shape
FRAMES = [("000000", 50, 70), ("000001", 50, 70), ("000002", 40, 90), ("000003", 50, 70)]
RTOL = 1e-4  # AEE: float32 through two implementations
PIXELS_FL = 2  # Fl: an error at the 3 px / 5% threshold may flip


def _configs(data_dir=".", log_dir="log"):
    cfgs = ConfigJax(), Config()
    for c in cfgs:
        c.dirs.data, c.dirs.log = str(data_dir), str(log_dir)
        t = c.train
        t.flownet, t.compute_dtype, t.corr_impl, t.max_displacement = "C", "float32", "jnp", 4
        t.dataset = "kitti_raw"
    return cfgs


@pytest.fixture(scope="module")
def flax_params():
    model = build_model_jax(_configs()[0])
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jax.jit(model.init)(jax.random.PRNGKey(2), sample, sample)["params"]


def write_kitti_2012(root, seed=0):
    """Frames, ``flow_occ`` (about 10% invalid) and ``flow_noc`` (its lower
    half invalid as well) of ``FRAMES``, under ``root/kitti_2012/training``."""
    rng = np.random.RandomState(seed)
    base = root / "kitti_2012" / "training"
    for sub in ("colored_0", "flow_occ", "flow_noc"):
        (base / sub).mkdir(parents=True)
    for frame, h, w in FRAMES:
        for suffix in ("10", "11"):
            write_image(base / "colored_0" / f"{frame}_{suffix}.png",
                        rng.rand(h, w, 3).astype(np.float32))
        flow = (rng.randn(h, w, 2) * 4).astype(np.float32)
        valid = (rng.rand(h, w, 1) > 0.1).astype(np.float32)
        noc = valid.copy()
        noc[h // 2:] = 0.0
        write_kitti_png_flow(base / "flow_occ" / f"{frame}_10.png", flow, valid)
        write_kitti_png_flow(base / "flow_noc" / f"{frame}_10.png", flow, noc)


def _fewest_valid(examples, key="mask"):
    """The fewest valid pixels of one image: the share of one pixel of Fl."""
    from unflow_tpu_torch.data import load_example

    return min(load_example(ex, None, True)[key].sum() for ex in examples)


def _assert_metrics_close(got, want, examples):
    assert got["n"] == want["n"] and got["n_gt"] == want["n_gt"]
    assert sorted(got) == sorted(want)
    for key in ("aee", "aee_noc", "aee_occ"):
        assert got[key] == pytest.approx(want[key], rel=RTOL), key
    for key, mask in (("fl", "mask"), ("fl_noc", "noc_mask")):
        assert abs(got[key] - want[key]) <= PIXELS_FL / _fewest_valid(examples, mask), key


@pytest.fixture(scope="module")
def kitti(tmp_path_factory, flax_params):
    """The fixture tree, its occ examples, and the JAX Evaluator's metrics."""
    root = tmp_path_factory.mktemp("kitti")
    write_kitti_2012(root)
    examples = get_dataset("kitti_2012", root).eval_examples("occ")
    cfg_jax, _ = _configs(root)
    ev = EvaluatorJax(cfg_jax, None, normalization=get_dataset_jax("kitti_2012", root).normalization,
                      params=flax_params)
    want = ev.run(get_dataset_jax("kitti_2012", root).eval_examples("occ"), eval_batch=2)
    return root, examples, want


def _evaluator(flax_params, root, normalization=KITTI_NORMALIZATION):
    _, cfg = _configs(root)
    return Evaluator(cfg, params=params_from_flax(flax_params), normalization=normalization,
                     device="cpu")


def test_run_matches_jax_on_kitti_2012(kitti, flax_params):
    root, examples, want = kitti
    got = _evaluator(flax_params, root).run(examples, eval_batch=2)
    assert got["n"] == got["n_gt"] == len(FRAMES)
    _assert_metrics_close(got, want, examples)
    # the all-pixel AEE lies between the two regions' AEEs
    assert min(got["aee_noc"], got["aee_occ"]) <= got["aee"] <= max(got["aee_noc"], got["aee_occ"])


def test_run_batching_does_not_change_the_metrics(kitti, flax_params):
    root, examples, _ = kitti
    ev = _evaluator(flax_params, root)
    one = ev.run(examples, eval_batch=1, collect=3)
    three = ev.run(examples, eval_batch=3, collect=3)
    for key in ("aee", "fl", "aee_noc", "fl_noc", "aee_occ", "n", "n_gt"):
        assert three[key] == pytest.approx(one[key], rel=1e-5, abs=1e-7), key
    # collected in example order, though same-shape batching flushes out of order
    assert [e["flow"].shape for e in three["entries"]] == [(h, w, 2) for _, h, w in FRAMES[:3]]
    for a, b in zip(one["entries"], three["entries"]):
        np.testing.assert_allclose(a["flow"], b["flow"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a["gt"], b["gt"])
    assert ev.run(examples, max_examples=2)["n"] == 2


def test_run_mixed_ground_truth_and_subdirectory_stems(tmp_path, flax_params):
    """Examples without ground truth count in ``n`` and not in the metrics;
    an ``id`` with a subdirectory dumps into it."""
    rng = np.random.RandomState(3)
    examples = []
    for i, (scene, gt) in enumerate((("alley_1", True), ("alley_1", False), ("cave_2", True))):
        paths = []
        for k in (1, 2):
            paths.append(tmp_path / f"{i}_{k}.png")
            write_image(paths[-1], rng.rand(30, 40, 3).astype(np.float32))
        flow = None
        if gt:
            flow = tmp_path / f"{i}.flo"
            write_flo(flow, rng.randn(30, 40, 2).astype(np.float32))
        examples.append(dict(im1=str(paths[0]), im2=str(paths[1]),
                             flow=None if flow is None else str(flow),
                             meta={"id": f"{scene}/frame_{i:04d}"}))
    cfg_jax, _ = _configs()
    want = EvaluatorJax(cfg_jax, None, params=flax_params).run(
        [ExampleJax(**e) for e in examples], output_dir=tmp_path / "jax", eval_batch=2)
    got = _evaluator(flax_params, tmp_path, DEFAULT_NORMALIZATION).run(
        [Example(**e) for e in examples], output_dir=tmp_path / "port", eval_batch=2)
    assert got["n"] == want["n"] == 3 and got["n_gt"] == want["n_gt"] == 2
    assert got["aee"] == pytest.approx(want["aee"], rel=RTOL)
    assert abs(got["fl"] - want["fl"]) <= PIXELS_FL / (30 * 40)
    names = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*.flo"))
    assert names == ["alley_1/frame_0000.flo", "alley_1/frame_0001.flo", "cave_2/frame_0002.flo"]
    nan = _evaluator(flax_params, tmp_path).run([Example(**examples[1])])
    assert nan["n"] == 1 and nan["n_gt"] == 0 and np.isnan(nan["aee"])
    with pytest.raises(ValueError, match="no examples"):
        _evaluator(flax_params, tmp_path).run([])


@pytest.mark.parametrize("fmt", ["flo", "kitti_png", "viz"])
def test_dumps_match_jax(kitti, flax_params, tmp_path, fmt):
    root, examples, _ = kitti
    cfg_jax, _ = _configs(root)
    norm = get_dataset("kitti_2012", root).normalization
    EvaluatorJax(cfg_jax, None, normalization=norm, params=flax_params).run(
        get_dataset_jax("kitti_2012", root).eval_examples("occ"), output_dir=tmp_path / "jax",
        output_format=fmt, eval_batch=2)
    with pytest.raises(ValueError, match="output format"):
        _evaluator(flax_params, root).run(examples, output_dir=tmp_path / "bad", output_format="x")
    _evaluator(flax_params, root).run(examples, output_dir=tmp_path / "port", output_format=fmt,
                                      eval_batch=2)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == len(FRAMES) * (2 if fmt == "viz" else 1)
    for name in files:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if fmt == "flo":
            want = read_flo(b)
            np.testing.assert_allclose(read_flo(a), want, atol=1e-4 * np.abs(want).max())
        elif fmt == "kitti_png":
            (got, got_valid), (want, want_valid) = read_kitti_png_flow(a), read_kitti_png_flow(b)
            assert got_valid.all() and want_valid.all()
            # the format stores 1/64 px: a value at a rounding edge may take the next step
            np.testing.assert_allclose(got, want, atol=1 / 64 + 1e-4)
        else:  # 8-bit color images: one level apart at most
            np.testing.assert_allclose(read_image(a), read_image(b), atol=1 / 255 + 1e-4)


def _experiments(root, flax_params):
    """The same parameters as a JAX (orbax) experiment and as a port one, each
    with a snapshot that names the data directory."""
    cfg_jax, cfg = _configs(root, root / "log")
    log = root / "log" / "ex"
    (log / "jax_ex").mkdir(parents=True, exist_ok=True)
    (log / "port_ex").mkdir(parents=True, exist_ok=True)
    save_config_jax(cfg_jax, log / "jax_ex" / "config.ini")
    save_config(cfg, log / "port_ex" / "config.ini")
    tx = build_optimizer_jax(cfg_jax, flax_params)
    manager = CheckpointManagerJax(log / "jax_ex")
    manager.save(1, TrainStateJax(jnp.asarray(1, jnp.int32), flax_params, tx.init(flax_params)),
                 wait=True)
    manager.close()
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_flax(flax_params))
    CheckpointManager(log / "port_ex").save(1, model, build_optimizer(cfg, model))
    return log


def _numbers(line):
    return [float(x) for x in re.findall(r"=(-?[\d.]+)", line)]


def test_cli_eval_prints_the_jax_line(kitti, flax_params, capsys, monkeypatch):
    root, examples, _ = kitti
    log = _experiments(root, flax_params)
    monkeypatch.chdir(root)  # the experiments live under ./log
    try:
        assert eval_main_jax(["--ex", "jax_ex", "--dataset", "kitti_2012", "--batch", "2"]) == 0
        want = capsys.readouterr().out.strip().splitlines()[-1]
        assert eval_main(["--ex", "port_ex", "--dataset", "kitti_2012", "--batch", "2",
                          "--device", "cpu"]) == 0
        got = capsys.readouterr().out.strip().splitlines()[-1]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="--device cpu"):
                eval_main(["--ex", "port_ex", "--dataset", "kitti_2012"])
    finally:
        shutil.rmtree(log)
    # the same words; the numbers AEE, Fl %, n, noc AEE, noc Fl %, occ-only AEE
    assert re.sub(r"=[\d.]+", "=", got) == re.sub(r"=[\d.]+", "=", want)
    assert got.startswith("kitti_2012: AEE=") and "| noc: AEE=" in got and "| occ-only: AEE=" in got
    g, w = _numbers(got), _numbers(want)
    fl_share = 100 * PIXELS_FL / _fewest_valid(examples, "noc_mask")
    for i, (a, b) in enumerate(zip(g, w)):
        # printed to 4 places (AEE) or 2 (Fl in %)
        tol = {1: fl_share + 0.01, 4: fl_share + 0.01}.get(i, RTOL * abs(b) + 1e-4)
        assert abs(a - b) <= tol, (i, got, want)


def test_cli_eval_gui_names_its_roadmap_item(monkeypatch):
    """``--gui`` without matplotlib (as on the GPU machine) fails at once with
    an ImportError that names it, before any evaluation; it does not run
    headless."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="--gui pager needs matplotlib"):
        eval_main(["--ex", "none", "--dataset", "kitti_2012", "--gui", "--device", "cpu"])


def test_cli_eval_gui_pages_what_the_jax_one_pages(kitti, flax_params, monkeypatch):
    """``cli.eval --gui`` of the port and of the JAX package on one
    experiment: the pagers open on the same four panels (the flows within the
    colour coding's rounding of each other)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    root, _, _ = kitti
    log = _experiments(root, flax_params)
    monkeypatch.chdir(root)
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    try:
        assert eval_main_jax(["--ex", "jax_ex", "--dataset", "kitti_2012", "--gui",
                              "--num", "3"]) == 0
        assert eval_main(["--ex", "port_ex", "--dataset", "kitti_2012", "--gui", "--num", "3",
                          "--device", "cpu"]) == 0
    finally:
        shutil.rmtree(log)
    panels = [[ax.get_images()[0].get_array() for ax in fig.axes] for fig in shown]
    assert [ax.get_title() for ax in shown[1].axes] == [ax.get_title() for ax in shown[0].axes]
    assert shown[1].axes[0].get_title() == "frame 1 [1/3]"
    for got, want in zip(*reversed(panels)):
        # frame 1 exactly; flow colours and the error image within a few levels
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   atol=4 if np.asarray(want).dtype == np.uint8 else 2e-2)
    plt.close("all")
