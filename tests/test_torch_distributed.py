"""Data-parallel training of the port (``unflow_tpu_torch/parallel``, DDP).

The single-process defaults and the checks of ``parallel``; each process's
rows of the global augmentation draws; and two gloo processes on the CPU
through the real entry point (``python -m torch.distributed.run
--nproc-per-node 2 -m unflow_tpu_torch.cli.train --device cpu``), FlowNetC at
64x128, global batch 4, two steps on a KITTI raw tree, from one snapshot of
the JAX package's init, held against (i) the same run in one process and
(ii) the JAX package's ``make_train_step`` jitted over a 2-device mesh on the
same global batches; with augmentation off, and on (the JAX step's own draws
fed to the port through ``make_train_step``'s ``draws`` seam, global rows).
The run with augmentation on goes through ``tests/_torch_ddp_worker.py``,
which also records every collective, the counterpart of
``tests/test_sharding.py``'s collective count of the JAX step.
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

from tests.test_torch_trajectory import jax_draws
from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.data import get_dataset as get_dataset_jax
from unflow_tpu.data.base import Loader as LoaderJax
from unflow_tpu.parallel import batch_sharding, create_mesh, put_global_batch, replicated
from unflow_tpu.train.trainer import TrainState as TrainStateJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.train.trainer import build_optimizer as build_optimizer_jax
from unflow_tpu.train.trainer import make_train_step as make_train_step_jax
from unflow_tpu_torch import parallel
from unflow_tpu_torch.cli import train as cli_train
from unflow_tpu_torch.config import Config, save_config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data import get_dataset
from unflow_tpu_torch.data.base import Loader
from unflow_tpu_torch.data.io import write_image
from unflow_tpu_torch.parallel import distributed
from unflow_tpu_torch.train import CheckpointManager, Trainer, build_model, build_optimizer
from unflow_tpu_torch.train import trainer as trainer_module

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, BATCH, STEPS = 64, 128, 4, 2
DRIVE = "2011_09_26_drive_0001_sync"
SHARED = dict(
    dataset="kitti_raw", flownet="C", batch_size=BATCH, height=H, width=W,
    compute_dtype="float32", max_displacement=4, corr_stride=2, learning_rate=1e-4,
    image_summary_interval=-1, display_interval=1, num_iters=STEPS, num_threads=1,
    save_interval=1,
)
AUG = {
    "off": dict(aug_photometric=False, aug_hflip=False, aug_swap_prob=0.0),
    "on": dict(aug_photometric=True, aug_hflip=True, aug_swap_prob=0.5),
}


def _config(cls, root: Path, aug: str):
    cfg = cls()
    cfg.dirs.data, cfg.dirs.log = str(root / "data"), str(root / "log")
    for key, value in {**SHARED, **AUG[aug]}.items():
        setattr(cfg.train, key, value)
    return cfg


def test_single_process_defaults():
    assert parallel.init_distributed("cpu") is False  # no torchrun environment: a no-op
    assert parallel.is_lead_process()
    assert parallel.process_shard() == (0, 1)
    assert parallel.per_process_batch_size(8) == parallel.local_batch_size(8) == 8
    assert parallel.local_device("cpu") == torch.device("cpu")
    assert parallel.local_device("cuda") == torch.device("cuda", 0)
    assert parallel.local_device("cuda:1") == torch.device("cuda", 1)
    parallel.barrier()  # nothing to wait for
    model = torch.nn.Linear(2, 2)
    assert parallel.wrap_model(model, torch.device("cpu")) is model


def test_per_process_batch_size_validation(monkeypatch):
    monkeypatch.setattr(distributed, "process_shard", lambda: (1, 3))
    assert parallel.per_process_batch_size(9) == 3
    with pytest.raises(ValueError, match="global batch 8 not divisible by 3 processes"):
        parallel.per_process_batch_size(8)
    assert not parallel.is_lead_process()


def test_num_devices_mismatches_raise(monkeypatch, tmp_path):
    for n in (0, 1):
        parallel.check_num_devices(n)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4 -m unflow_tpu_torch.cli.train"):
        parallel.check_num_devices(4)
    cfg = _config(Config, tmp_path, "off")
    cfg.train.num_devices = 4
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        Trainer(cfg, tmp_path / "ex", iter(()), device="cpu")
    monkeypatch.setattr(parallel, "process_shard", lambda: (0, 2))
    parallel.check_num_devices(2)
    parallel.check_num_devices(0)
    with pytest.raises(ValueError, match="num_devices = 3, but torchrun started 2 processes"):
        parallel.check_num_devices(3)


def test_each_process_draws_its_rows_of_the_global_draws(tmp_path):
    """With augmentation on (order swap, flips, photometric with noise) and
    a learning rate of 0, the two halves of a global batch stepped as
    processes 0 and 1 of 2 (``shard``) give losses whose mean is the loss of
    the whole batch in one process: each half drew its rows of the global
    batch's draws. Drawn for the half alone, they would not."""
    from unflow_tpu_torch.data.synthetic import batch_iterator

    cfg = _config(Config, tmp_path, "on")
    cfg.train.learning_rate = 0.0
    cfg.train.corr_impl = "torch"
    batch = next(batch_iterator(BATCH, H + 8, W + 16, seed=2, max_shift=3.0))
    model = build_model(cfg, "cpu")
    trainer_module.init_params(model, torch.Generator().manual_seed(0))

    def loss(rows, shard):
        state = trainer_module.TrainState(model, build_optimizer(cfg, model))
        part = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        return float(trainer_module.make_train_step(cfg, shard=shard)(state, part)["loss"])

    whole = loss(slice(0, 4), (0, 1))
    halves = [loss(slice(0, 2), (0, 2)), loss(slice(2, 4), (1, 2))]
    assert (halves[0] + halves[1]) / 2 == pytest.approx(whole, rel=1e-5)
    alone = [loss(slice(0, 2), (0, 1)), loss(slice(2, 4), (0, 1))]
    assert (alone[0] + alone[1]) / 2 != pytest.approx(whole, rel=1e-3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A KITTI raw drive of 10 smooth 64x128 frames moving 1 px a frame, and
    the JAX package's FlowNetC init at this size (``PRNGKey(0)``)."""
    root = tmp_path_factory.mktemp("ddp")
    frames = root / "data" / "kitti_raw" / DRIVE / "image_02" / "data"
    frames.mkdir(parents=True)
    coarse = torch.rand(1, 3, H // 8 + 3, W // 8 + 4, generator=torch.Generator().manual_seed(0))
    tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")[0]
    tex = tex.permute(1, 2, 0).numpy()
    for f in range(10):
        write_image(frames / f"{f:010d}.png", tex[f : f + H, 2 * f : 2 * f + W])
    cfg_jax = _config(ConfigJax, root, "off")
    cfg_jax.train.corr_impl = "jnp"
    model = build_model_jax(cfg_jax)
    sample = jnp.zeros((1, H, W, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), sample, sample)["params"]
    return root, jax.device_get(params)


def _experiment(root: Path, name: str, aug: str, params) -> Path:
    """``<log>/ex/<name>`` holding the snapshot of the run and a checkpoint
    at step 0 of ``params`` (flax), from which ``cli.train`` resumes."""
    cfg = _config(Config, root, aug)
    ex_dir = cfg.experiment_dir(name)
    ex_dir.mkdir(parents=True)
    save_config(cfg, ex_dir / "config.ini")
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_flax(params))
    CheckpointManager(ex_dir).save(0, model, build_optimizer(cfg, model))
    return ex_dir


def _read_run(ex_dir: Path) -> tuple[list[dict], dict, dict]:
    """The records of ``metrics.jsonl`` and the checkpoints after the first
    and the last step; the checkpoints are deleted (one is half a GB)."""
    records = [json.loads(line) for line in (ex_dir / "metrics.jsonl").read_text().splitlines()]
    assert sorted(p.name for p in (ex_dir / "checkpoints").iterdir()) == ["0.pt", "1.pt", "2.pt"]
    first = torch.load(ex_dir / "checkpoints" / "1.pt", weights_only=True)
    final = torch.load(ex_dir / "checkpoints" / f"{STEPS}.pt", weights_only=True)
    shutil.rmtree(ex_dir / "checkpoints")
    return records, first, final


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(root: Path, args: list[str]) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "localhost", "--master-port", str(_free_port()), *args]
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


def _jax_mesh_run(root: Path, aug: str, params) -> tuple[list[dict], dict]:
    """The JAX package's step jitted over a 2-device mesh (batch sharded,
    parameters replicated), on the JAX package's own Loader's global
    batches; returns each step's logs and the final parameters."""
    cfg = _config(ConfigJax, root, aug)
    cfg.train.corr_impl = "jnp"
    t = cfg.train
    with warnings.catch_warnings():  # the partial corpus, no eval-scene exclusion
        warnings.simplefilter("ignore")
        dataset = get_dataset_jax("kitti_raw", cfg.dirs.data)
        examples = dataset.train_examples()
        port_examples = get_dataset("kitti_raw", cfg.dirs.data).train_examples()
    loader = iter(LoaderJax(examples, batch_size=BATCH, load_hw=(H, W), seed=t.seed,
                            num_threads=1, mode=t.input_mode, image_dtype="uint8"))
    batches = [next(loader) for _ in range(STEPS)]
    # the port's Loader yields the same global batches
    port_loader = iter(Loader(port_examples, batch_size=BATCH, load_hw=(H, W), seed=t.seed,
                              num_threads=1, mode=t.input_mode, image_dtype="uint8"))
    for b in batches:
        mine = next(port_loader)
        assert all(np.array_equal(mine[k], b[k]) for k in ("im1", "im2"))

    mesh = create_mesh(2)
    model = build_model_jax(cfg)
    tx = build_optimizer_jax(cfg, params)
    state = jax.device_put(TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params)),
                           replicated(mesh))
    step = jax.jit(make_train_step_jax(model, tx, cfg, dataset.normalization,
                                       gather_granularity=2))
    key = jax.random.PRNGKey(t.seed)
    logs = []
    for b in batches:
        state, out = step(state, put_global_batch(b, batch_sharding(mesh)), key)
        logs.append({k: float(v) for k, v in out.items()})
    return logs, params_from_flax(jax.device_get(state.params))


@pytest.mark.parametrize("aug", ["off", "on"])
def test_two_gloo_processes_match_one_process_and_the_jax_mesh(tree, tmp_path, monkeypatch, aug):
    """Tolerances (float32, CPU): against one process at the same global
    batch, every logged term and ``grad_norm`` within 1e-5 relative; Adam's
    moments after the first step (the averaged gradient) within 1e-5
    relative L2 in every tensor; the final parameters within 1e-5 but where
    Adam divides a gradient within rounding of zero by its own size (eps
    1e-8): such an element may move by lr either way, 2 x lr x steps at
    most, and at most 1 element in 10^4 of a tensor does. Against the JAX mesh, as ``test_torch_train.py`` holds
    one step: each term within 1e-4 relative and ``grad_norm`` 1e-3 at every
    step; the parameters within 2 x lr x steps, and each tensor's update
    within 5% relative L2 of the JAX step's (its elements near the
    rounding-sensitive points above move the second step's update most:
    measured up to 4.7e-2 in conv5's bias, 7.3e-3 in every other tensor)."""
    root, params = tree
    lr = SHARED["learning_rate"]
    draws_path = tmp_path / "draws.pt"
    if aug == "on":
        cfg_jax = _config(ConfigJax, root, aug)
        torch.save([jax_draws(cfg_jax, step, (H, W)) for step in range(STEPS)], draws_path)
        draws = torch.load(draws_path, weights_only=False)
        make_train_step = trainer_module.make_train_step
        monkeypatch.setattr(trainer_module, "make_train_step", lambda *a, **k: make_train_step(
            *a, draws=lambda step: draws[step], **k))

    # both runs resume their experiment from step 0, run from the directory
    # that holds log/
    monkeypatch.chdir(root)
    ex_dir = _experiment(root, f"one_{aug}", aug, params)
    assert cli_train.main(["--ex", f"one_{aug}", "--device", "cpu"]) == 0
    one, one_first, one_final = _read_run(ex_dir)

    name = f"two_{aug}"
    ex_dir = _experiment(root, name, aug, params)
    train_args = ["--ex", name, "--device", "cpu"]
    if aug == "off":  # the entry point itself
        out = _torchrun(root, ["-m", "unflow_tpu_torch.cli.train", *train_args])
    else:
        report = tmp_path / "report.json"
        out = _torchrun(root, [str(ROOT / "tests" / "_torch_ddp_worker.py"), str(draws_path),
                               str(report), "--", *train_args])
    assert "on 2 processes" in out.stdout
    two, two_first, two_final = _read_run(ex_dir)

    # one writer: one record per step
    assert [r["step"] for r in two] == [r["step"] for r in one] == list(range(1, STEPS + 1))
    for mine, ref in zip(two, one):
        assert set(mine) == set(ref)
        for key, value in ref.items():
            if key not in ("time", "pairs_per_sec", "step_ms", "step"):
                assert mine[key] == pytest.approx(value, rel=1e-5, abs=1e-7), key
    start = params_from_flax(params)
    adam = [two_first["optimizer"]["state"], one_first["optimizer"]["state"]]
    for i, (name_, p) in enumerate(two_first["model"].items()):
        for key in ("exp_avg", "exp_avg_sq"):
            mine, ref = adam[0][i][key], adam[1][i][key]
            assert torch.linalg.vector_norm(mine - ref) < 1e-5 * torch.linalg.vector_norm(ref), name_
        diff = (p - one_first["model"][name_]).abs()
        assert diff.max() <= 2 * lr * (1 + 1e-3), name_
        assert (diff > 1e-5).sum() <= diff.numel() // 10_000, name_
        p = two_final["model"][name_]
        update, want = p - start[name_], one_final["model"][name_] - start[name_]
        assert (p - one_final["model"][name_]).abs().max() <= 2 * STEPS * lr * (1 + 1e-3), name_
        assert torch.linalg.vector_norm(update - want) < 1e-2 * torch.linalg.vector_norm(want), name_

    jax_logs, jax_params = _jax_mesh_run(root, aug, params)
    for mine, ref in zip(two, jax_logs):
        for key, value in ref.items():
            tol = 1e-3 if key == "grad_norm" else 1e-4
            assert mine[key] == pytest.approx(value, rel=tol, abs=1e-7), key
    for name_, p in two_final["model"].items():
        diff = (p - jax_params[name_]).abs()
        assert (p - start[name_]).abs().max() <= STEPS * lr * (1 + 1e-3), name_
        assert diff.max() <= 2 * STEPS * lr * (1 + 1e-3), name_
        update, want = p - start[name_], jax_params[name_] - start[name_]
        assert torch.linalg.vector_norm(update - want) < 0.05 * torch.linalg.vector_norm(want), name_

    if aug == "on":
        reports = [json.loads(Path(f"{report}.{rank}").read_text()) for rank in (0, 1)]
        # Adam's state and the parameters are identical in both processes
        assert reports[0]["digest"] == reports[1]["digest"]
        for rep in reports:
            assert rep["rc"] == 0
            _check_collectives(rep["events"])


def _check_collectives(events: list) -> None:
    """Before the first step, ``cli.train``'s one barrier (the
    fresh-or-resume decision). Then per step: DDP's gradient buckets (each
    index once, the last one flagged last), the one all-reduce of the logs
    (every step is a display step here) and the barrier after the save (a
    checkpoint every step here); nothing else."""
    assert events[0] == ["barrier"]
    steps, rest = [], events[1:]
    while rest:
        n = next(i for i, e in enumerate(rest) if e[0] != "bucket")
        buckets, rest = rest[:n], rest[n:]
        assert rest[:2] == [["all_reduce"], ["barrier"]], rest[:3]
        rest = rest[2:]
        assert sorted(e[1] for e in buckets) == list(range(len(buckets))) and buckets, buckets
        assert [e[2] for e in buckets] == [False] * (len(buckets) - 1) + [True], buckets
        steps.append(buckets)
    assert len(steps) == STEPS
