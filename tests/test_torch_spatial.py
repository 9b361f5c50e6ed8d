"""W-sharding of the port (``unflow_tpu_torch/parallel/spatial.py``,
``spatial_shards > 1``) on the CPU, over gloo processes.

Two ``torchrun`` jobs run ``tests/_torch_spatial_worker.py``, one on 2
ranks and one on 4, each a list of jobs that share the launch:

* the three collectives (``halo_exchange``, ``gather_w``,
  ``sum_over_spatial``), forward and backward, against slicing one full
  tensor, on 2 and 4 ranks, halos wider than a slab included (float64: the values exact, the
  gradients within 1e-12);
* FlowNetS at (2, 64x256, 6) on 4 spatial ranks against the port's unsharded
  forward (1e-5) and the JAX package's ``model.apply`` on
  ``create_mesh(8, spatial=4)`` (2e-5, the tolerance of
  ``tests/test_sharding.py``'s case);
* FlowNetC (max_displacement 20: a correlation halo of 20 columns around a
  conv3 slab of 8) on 2 ranks, its flows and parameter gradient against the
  unsharded ones (1e-5);
* the unsupervised loss with every term weighted (``fb`` and ``disocc``
  masks, a border mask) and the supervised loss on 2 spatial ranks (slabs
  of 16 down to 1 column over the pyramid) against the unsharded losses:
  each term and the flows' gradients (1e-5);
* ``cli.train`` one step of UnFlow-C (f32, fb masks, a KITTI raw tree) on 2
  spatial ranks, augmentation off and on, and on the 2x2 grid, against the
  one-process step from the same snapshot (loss 1e-5 relative, the
  gradient's relative L2 1e-5 through Adam's first moment) and against JAX's
  ``make_train_step`` from the same flax init on the same global batch (the
  port's augmentation taken from JAX's draws): the logged terms 1e-4
  relative, ``grad_norm`` 1e-3 and the gradient's relative L2 1e-4;
* one ``disocc`` step and one ``csS`` step on 2 spatial ranks against one
  process (1e-4; see ``STEP_TOLERANCE``).

And the refusals: a width that is not a multiple of ``64 * S``, ``S`` not
dividing the processes, and ``S > 1`` in one process.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_spatial_worker import loss_terms
from tests.test_torch_trajectory import jax_draws
from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.data import get_dataset as get_dataset_jax
from unflow_tpu.data.base import Loader as LoaderJax
from unflow_tpu.models import FlowNetS as FlowNetSJax
from unflow_tpu.parallel import batch_sharding, create_mesh, replicated
from unflow_tpu.train.trainer import TrainState as TrainStateJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.train.trainer import build_optimizer as build_optimizer_jax
from unflow_tpu.train.trainer import make_train_step as make_train_step_jax
from unflow_tpu_torch.cli import train as cli_train
from unflow_tpu_torch.config import Config, save_config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data.io import write_image
from unflow_tpu_torch.models import FlowNetC, FlowNetS, init_params
from unflow_tpu_torch.parallel import check_grid
from unflow_tpu_torch.train import CheckpointManager, build_model, build_optimizer
from unflow_tpu_torch.train import trainer as trainer_module

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, BATCH = 64, 128, 2
DRIVE = "2011_09_26_drive_0001_sync"
SHARED = dict(
    dataset="kitti_raw", flownet="C", batch_size=BATCH, height=H, width=W,
    compute_dtype="float32", max_displacement=4, corr_stride=2, learning_rate=1e-4,
    image_summary_interval=-1, display_interval=1, num_iters=1, num_threads=1,
    save_interval=1,
)
AUG = {
    "off": dict(aug_photometric=False, aug_hflip=False, aug_swap_prob=0.0),
    "on": dict(aug_photometric=True, aug_hflip=True, aug_swap_prob=0.5),
}
# the train runs: name -> (spatial shards, processes, augmentation, overrides, from flax)
RUNS = {
    "off": (2, 2, "off", {}, True),
    "on": (2, 2, "on", {}, True),
    "grid": (2, 4, "off", {}, True),
    "disocc": (2, 2, "off", {"mask_occlusion": "disocc"}, False),
    "css": (2, 2, "off", {"flownet": "csS"}, False),
}
# One process against the grid: 1e-5, the port's float32 tolerance on the
# CPU. The csS cascade (random frozen stages feeding warped frames forward)
# and the disocc mask (a thresholded splat) are held to 1e-4, the port's
# float32 tolerance on the card: the slabs' other summation order moves
# csS's flows by 2.5e-7 of their largest value in stage 0 and 3e-6 in stage
# 2, enough to flip a thresholded pixel; measured here, gradient 8.8e-5
# (csS) and 1.3e-5 (disocc) against 3.0e-6 (off), 7.0e-6 (on) and 3.0e-6
# (the 2x2 grid).
STEP_TOLERANCE = {"off": 1e-5, "on": 1e-5, "grid": 1e-5, "disocc": 1e-4, "css": 1e-4}
S_SHAPE = (2, 64, 256, 6)  # tests/test_sharding.py's FlowNetS input, NHWC


def _config(cls, root: Path, aug: str, **overrides):
    cfg = cls()
    cfg.dirs.data, cfg.dirs.log = str(root / "data"), str(root / "log")
    for key, value in {**SHARED, **AUG[aug], **overrides}.items():
        setattr(cfg.train, key, value)
    return cfg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(root: Path, nproc: int, jobs: list[dict]) -> tuple[subprocess.Popen, Path]:
    spec = root / f"spec{nproc}.json"
    spec.write_text(json.dumps({"cwd": str(root), "jobs": jobs}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "localhost", "--master-port", str(_free_port()),
           str(ROOT / "tests" / "_torch_spatial_worker.py"), str(spec)]
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), spec


def _collect(proc: subprocess.Popen, spec: Path, nproc: int) -> list[list]:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return [torch.load(f"{spec}.{rank}.pt", weights_only=False) for rank in range(nproc)]


def _experiment(root: Path, name: str, aug: str, spatial: int, overrides: dict,
                start: Path | None) -> Path:
    """``<log>/ex/<name>``: the run's snapshot and, for a run from the flax
    init, a link to the step-0 checkpoint ``start``, which ``cli.train``
    resumes."""
    cfg = _config(Config, root, aug, spatial_shards=spatial, **overrides)
    ex_dir = cfg.experiment_dir(name)
    ex_dir.mkdir(parents=True)
    save_config(cfg, ex_dir / "config.ini")
    if start is not None:
        (ex_dir / "checkpoints").mkdir()
        os.link(start, ex_dir / "checkpoints" / "0.pt")
    return ex_dir


def _read_run(ex_dir: Path, spec: str) -> tuple[dict, dict]:
    """The one record of ``metrics.jsonl`` and Adam's first moment after the
    step (0.1 x the gradient) by trainable parameter; the run is deleted (a
    checkpoint is half a GB)."""
    (record,) = [json.loads(line) for line in (ex_dir / "metrics.jsonl").read_text().splitlines()]
    ckpt = torch.load(ex_dir / "checkpoints" / "1.pt", weights_only=True)
    net = build_model(_config(Config, Path("."), "off", flownet=spec), None)
    trainer_module.freeze_stages(net, spec)
    names = [k for k, p in net.named_parameters() if p.requires_grad]
    moments = dict(zip(names, (s["exp_avg"] for s in ckpt["optimizer"]["state"].values())))
    shutil.rmtree(ex_dir)
    return record, moments


def _spec(name: str) -> str:
    return RUNS[name][3].get("flownet", "C")


def _rel_l2(mine: dict, ref: dict) -> float:
    num = sum(torch.sum((mine[k].double() - v.double()) ** 2).item() for k, v in ref.items())
    return (num / sum(torch.sum(v.double() ** 2).item() for v in ref.values())) ** 0.5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A KITTI raw drive of 10 smooth 64x128 frames moving 1 px a frame, and
    the JAX package's FlowNetC init at this size (``PRNGKey(0)``), saved as
    the port's step-0 checkpoint."""
    root = tmp_path_factory.mktemp("spatial")
    frames = root / "data" / "kitti_raw" / DRIVE / "image_02" / "data"
    frames.mkdir(parents=True)
    coarse = torch.rand(1, 3, H // 8 + 3, W // 8 + 4, generator=torch.Generator().manual_seed(0))
    tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")[0]
    tex = tex.permute(1, 2, 0).numpy()
    for f in range(10):
        write_image(frames / f"{f:010d}.png", tex[f : f + H, 2 * f : 2 * f + W])
    cfg_jax = _config(ConfigJax, root, "off", corr_impl="jnp")
    model = build_model_jax(cfg_jax)
    sample = jnp.zeros((1, H, W, 3), jnp.float32)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), sample, sample)["params"])
    cfg = _config(Config, root, "off")
    net = build_model(cfg, "cpu")
    net.load_state_dict(params_from_flax(params))
    start = root / "start.pt"
    CheckpointManager(root / "start").save(0, net, build_optimizer(cfg, net))
    shutil.move(root / "start" / "checkpoints" / "0.pt", start)
    return root, params, start


@pytest.fixture(scope="module")
def runs(tree):
    """Both launches (2 ranks and 4), started together; meanwhile this
    process runs the one-process references. Returns (the 2-rank results,
    the 4-rank results, the references, the inputs)."""
    root, _, start = tree
    gen = torch.Generator().manual_seed(3)
    # FlowNetS on 4 spatial ranks: tests/test_sharding.py's case, from the
    # flax init
    x = torch.randn(S_SHAPE, generator=gen)
    s_params = jax.device_get(FlowNetSJax().init(jax.random.PRNGKey(0), jnp.asarray(x.numpy())))
    x = x.permute(0, 3, 1, 2)
    s_net = FlowNetS(S_SHAPE[-1])
    s_net.load_state_dict(params_from_flax(s_params["params"]))
    torch.save(s_net.state_dict(), root / "s_params.pt")
    torch.save({"x": x}, root / "s_inputs.pt")
    # FlowNetC, D = 21, on 2 ranks: interleaved pairs and cotangents
    c_net = FlowNetC(max_displacement=20)
    init_params(c_net, torch.Generator().manual_seed(1))
    n1, n2 = (torch.randn(BATCH, 3, H, W, generator=gen) for _ in range(2))
    im1 = torch.stack([n1, n2], 1).reshape(2 * BATCH, 3, H, W)
    im2 = torch.stack([n2, n1], 1).reshape(2 * BATCH, 3, H, W)
    cots = [torch.randn(2 * BATCH, 2, H // 4 >> i, W // 4 >> i, generator=gen) for i in range(5)]
    torch.save(c_net.state_dict(), root / "c_params.pt")
    torch.save({"im1": im1, "im2": im2, "cotangents": cots}, root / "c_inputs.pt")

    # the losses on 2 spatial ranks: frames, 5-scale flows (network units)
    # and sparse ground truth at 64x128
    loss_in = {
        "im1": torch.rand(BATCH, 3, H, W, generator=gen),
        "im2": torch.rand(BATCH, 3, H, W, generator=gen),
        "flows_fw": [0.3 * torch.randn(BATCH, 2, H // 4 >> i, W // 4 >> i, generator=gen)
                     for i in range(5)],
        "flows_bw": [0.3 * torch.randn(BATCH, 2, H // 4 >> i, W // 4 >> i, generator=gen)
                     for i in range(5)],
        "gt": 3 * torch.randn(BATCH, 2, H, W, generator=gen),
        "mask": (torch.rand(BATCH, 1, H, W, generator=gen) < 0.4).float(),
    }
    torch.save(loss_in, root / "loss_inputs.pt")

    draws = root / "draws.pt"
    cfg_jax = _config(ConfigJax, root, "on")
    torch.save([jax_draws(cfg_jax, 0, (H, W))], draws)

    def train_job(name):
        spatial, nproc, aug, overrides, from_flax = RUNS[name]
        _experiment(root, f"sharded_{name}", aug, spatial, overrides,
                    start if from_flax else None)
        return {"kind": "train", "argv": ["--ex", f"sharded_{name}", "--device", "cpu"],
                "draws": str(draws) if aug == "on" else None}

    two = _launch(root, 2, [
        {"kind": "collectives", "spatial": 2},
        {"kind": "flownet", "net": "C", "max_displacement": 20, "spatial": 2,
         "params": str(root / "c_params.pt"), "inputs": str(root / "c_inputs.pt")},
        {"kind": "losses", "spatial": 2, "inputs": str(root / "loss_inputs.pt")},
    ] + [train_job(name) for name, run in RUNS.items() if run[1] == 2])
    four = _launch(root, 4, [
        {"kind": "collectives", "spatial": 4},
        {"kind": "flownet", "net": "S", "spatial": 4,
         "params": str(root / "s_params.pt"), "inputs": str(root / "s_inputs.pt")},
        train_job("grid"),
    ])

    refs = {"losses": loss_terms(loss_in)}
    with torch.inference_mode():
        refs["S"] = [f.clone() for f in s_net.to(memory_format=torch.channels_last)(x)]
    c_net = c_net.to(memory_format=torch.channels_last)
    flows = c_net(im1, im2, pair_flipped_im2=True)
    sum((f * g).sum() for f, g in zip(flows, cots)).backward()
    refs["C"] = [f.detach() for f in flows], {k: p.grad for k, p in c_net.named_parameters()}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, (_, _, aug, overrides, from_flax) in RUNS.items():
            if name == "grid":  # the same global batch as "off"
                continue
            _experiment(root, f"one_{name}", aug, 1, overrides, start if from_flax else None)
            step = trainer_module.make_train_step
            if aug == "on":
                given = torch.load(draws, weights_only=False)
                trainer_module.make_train_step = (
                    lambda *a, **k: step(*a, draws=lambda i: given[i], **k))
            try:
                assert cli_train.main(["--ex", f"one_{name}", "--device", "cpu"]) == 0
            finally:
                trainer_module.make_train_step = step
            refs[name] = _read_run(root / "log" / "ex" / f"one_{name}", _spec(name))
    finally:
        os.chdir(cwd)
    two, four = _collect(*two, 2), _collect(*four, 4)
    sharded = {name: _read_run(root / "log" / "ex" / f"sharded_{name}", _spec(name))
               for name in RUNS}
    return two, four, refs, sharded, (x, s_params)


def _halves(results: list[list], job: int, key: str, i: int) -> torch.Tensor:
    return torch.cat([rank[job][key][i] for rank in results], -1)


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives_match_slicing_one_tensor(runs, ranks):
    results = runs[0] if ranks == 2 else runs[1]
    for rank, res in enumerate(results):
        errors = res[0]
        assert len(errors) == 7 * 3 + 5, errors
        for key, err in errors.items():
            # the values move exactly; a sum (a gradient that several halo
            # columns send to one column, the all-reduce) may add in another
            # order than the reference
            exact = "grad" not in key and "sum" not in key
            assert err <= (0.0 if exact else 1e-12), (rank, key, err)


def test_flownet_s_on_4_spatial_ranks_matches_unsharded_and_the_jax_mesh(runs):
    """The port's FlowNetS on four W-slabs (64 columns each; conv6's slab is
    one column wide) against its unsharded forward (1e-5 of the largest
    value) and against the JAX package's FlowNetS from the same flax
    parameters on a (2 data, 4 spatial) mesh (``tests/test_sharding.py``'s
    2e-5)."""
    four, refs, (x, params) = runs[1], runs[2], runs[4]
    mesh = create_mesh(8, spatial=4)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    flows = jax.jit(FlowNetSJax().apply)(jax.device_put(params, replicated(mesh)),
                                         jax.device_put(xj, batch_sharding(mesh, spatial_axis=2)))
    for i, (ref, want) in enumerate(zip(refs["S"], flows)):
        mine = _halves(four, 1, "flows", i)
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), atol=1e-5 * float(ref.abs().max()))
        np.testing.assert_allclose(mine.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=2e-5)


def test_flownet_c_on_2_spatial_ranks_matches_unsharded(runs):
    """Flows and the parameter gradient (summed over the ranks) of FlowNetC
    with a 20-column correlation halo around 8-column conv3 slabs."""
    two, refs = runs[0], runs[2]
    flows, grads = refs["C"]
    for i, ref in enumerate(flows):
        np.testing.assert_allclose(_halves(two, 1, "flows", i).numpy(), ref.numpy(),
                                   atol=1e-5 * float(ref.abs().max()))
    mine = {k: two[0][1]["grads"][k] + two[1][1]["grads"][k] for k in grads}
    assert _rel_l2(mine, grads) < 1e-5
    for k, g in grads.items():
        assert torch.linalg.vector_norm(mine[k] - g) <= 1e-5 * torch.linalg.vector_norm(g), k


@pytest.mark.parametrize("which", ["fb", "disocc", "supervised"])
def test_losses_on_2_spatial_ranks_match_unsharded(runs, which):
    """Every term (the ranks' parts summed) within 1e-5 relative of the
    unsharded term, and the gradient to each flow (the ranks' slabs side by
    side) within 1e-5 of its largest value."""
    two, refs = runs[0], runs[2]
    want_logs, want_grads = refs["losses"][which]
    parts = [rank[2][which] for rank in two]
    assert set(parts[0][0]) == set(want_logs)
    for key, want in want_logs.items():
        got = sum(logs[key] for logs, _ in parts)
        assert got == pytest.approx(want, rel=1e-5, abs=1e-9), key
    for i, want in enumerate(want_grads):
        got = torch.cat([grads[i] for _, grads in parts], -1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_step_matches_one_process(runs, name):
    """One ``cli.train`` step on the grid against one process: every logged
    term relative, and the gradient (Adam's first moment) in relative L2,
    within ``STEP_TOLERANCE``."""
    mine = runs[3][name]
    one = runs[2]["off" if name == "grid" else name]
    tol = STEP_TOLERANCE[name]
    for key, value in one[0].items():
        if key not in ("time", "pairs_per_sec", "step_ms", "step"):
            assert mine[0][key] == pytest.approx(value, rel=tol, abs=1e-7), key
    assert set(mine[0]) == set(one[0])
    assert _rel_l2(mine[1], one[1]) < tol


@pytest.mark.parametrize("aug", ["off", "on"])
def test_sharded_step_matches_the_jax_step(runs, tree, aug):
    """The 2-rank step against JAX's ``make_train_step`` on the same global
    batch from the same flax init (JAX's own draws, which the port took):
    terms 1e-4 relative, ``grad_norm`` 1e-3, the gradient 1e-4 relative L2."""
    root, params, _ = tree
    mine = runs[3][aug]
    cfg = _config(ConfigJax, root, aug, corr_impl="jnp")
    t = cfg.train
    with warnings.catch_warnings():  # the partial corpus, no eval-scene exclusion
        warnings.simplefilter("ignore")
        dataset = get_dataset_jax("kitti_raw", cfg.dirs.data)
        examples = dataset.train_examples()
    batch = next(iter(LoaderJax(examples, batch_size=BATCH, load_hw=(H, W), seed=t.seed,
                                num_threads=1, mode=t.input_mode, image_dtype="uint8")))
    model = build_model_jax(cfg)
    tx = build_optimizer_jax(cfg, params)
    state = TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax.jit(make_train_step_jax(model, tx, cfg, dataset.normalization))
    state, logs = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(t.seed))
    (adam,) = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                    is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    moments = params_from_flax(jax.device_get(adam.mu))
    for key, value in logs.items():
        tol = 1e-3 if key == "grad_norm" else 1e-4
        assert mine[0][key] == pytest.approx(float(value), rel=tol, abs=1e-7), key
    assert _rel_l2(mine[1], moments) < 1e-4


@pytest.mark.parametrize(
    "spatial,processes,width,match",
    [pytest.param(2, 2, 192, r"nearest valid widths: \[128, 256\]", id="width-192-S2"),
     pytest.param(4, 4, 1152, r"nearest valid widths: \[1024, 1280\]", id="width-1152-S4"),
     pytest.param(3, 4, 1152, "does not divide the 4 processes", id="S3-of-4-processes"),
     pytest.param(2, 1, 128, "torchrun --nproc-per-node 2", id="S2-one-process")],
)
def test_refusals(spatial, processes, width, match):
    with pytest.raises(ValueError, match=match):
        check_grid(spatial, width, processes)


@pytest.mark.parametrize("spatial", [2, 3])
def test_kitti_width_allows_two_and_three_shards(spatial):
    check_grid(spatial, 1152, 2 * spatial)


def test_one_process_cli_train_refuses_spatial_shards_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli_train.main(["--ex", "refused", "--device", "cpu", "--set", "spatial_shards=2",
                        "--set", "height=64", "--set", "width=128"])
    assert not list(tmp_path.rglob("config.ini"))


def test_sharded_ops_raise_without_a_process_group():
    """No fallback: inside a context with no process group the halo of a
    conv, the correlation's and the warp's gather raise; outside any context
    the collectives raise."""
    from unflow_tpu_torch.ops.conv2d import conv2d_same
    from unflow_tpu_torch.ops.correlation import correlation
    from unflow_tpu_torch.ops.warp import backward_warp
    from unflow_tpu_torch.parallel import SpatialContext, spatial

    x = torch.zeros(1, 4, 8, 8)
    maps = torch.zeros(1, 4, 8, 16)
    calls = [lambda: conv2d_same(x, torch.zeros(4, 4, 3, 3), None),
             lambda: correlation(maps, maps, 4, 2),
             lambda: backward_warp(x, torch.zeros(1, 2, 8, 8))]
    with SpatialContext(None, 2, 0):
        for call in calls:
            with pytest.raises((RuntimeError, ValueError)):
                call()
    for call in (lambda: spatial.halo_exchange(x, 1, 1), lambda: spatial.gather_w(x),
                 lambda: spatial.sum_over_spatial(torch.zeros(2))):
        with pytest.raises(RuntimeError, match="outside a SpatialContext"):
            call()
