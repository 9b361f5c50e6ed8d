"""Port's train step against the JAX package's ``make_train_step``, from
converted parameters and one batch, on the CPU in float32, for FlowNetC, the
cascades, the ``disocc`` mask and supervised training; and the Trainer and
``cli.train`` around it."""

import itertools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.train.schedule import piecewise_halving as piecewise_halving_jax
from unflow_tpu.train.trainer import TrainState as TrainStateJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.train.trainer import build_optimizer as build_optimizer_jax
from unflow_tpu.train.trainer import make_train_step as make_train_step_jax
from unflow_tpu_torch.cli import train as cli_train
from unflow_tpu_torch.config import Config, load_config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train import Trainer, piecewise_halving

torch.set_num_threads(1)

H, W, BATCH = 64, 128, 2
# a small correlation (D = 5) keeps the CPU step short
SHARED = dict(
    flownet="C", batch_size=BATCH, height=H, width=W, compute_dtype="float32",
    max_displacement=4, corr_stride=2, aug_photometric=False, aug_hflip=False,
    learning_rate=1e-4, image_summary_interval=-1, display_interval=1, num_iters=3,
)


def _config(cls, tmp_path, **overrides):
    cfg = cls()
    cfg.dirs.log = str(tmp_path / "log")
    for key, value in {**SHARED, **overrides}.items():
        setattr(cfg.train, key, value)
    return cfg


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A FlowNet checkpoint is 0.5-1.4 GB: none outlives its test."""
    yield
    for path in list(tmp_path.rglob("checkpoints")):
        shutil.rmtree(path)


@pytest.fixture(scope="module")
def batch():
    return next(batch_iterator(BATCH, H, W, seed=0, max_shift=3.0))


@pytest.fixture(scope="module")
def sup_batch():
    """A supervised batch: the pairs' flow and a KITTI-like sparse mask."""
    b = next(batch_iterator(BATCH, H, W, seed=3, max_shift=3.0, supervised=True))
    b["mask"] = (np.random.RandomState(4).rand(BATCH, H, W, 1) < 0.4).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def flax_params():
    """``flax_params(spec)`` -> (flax stack, its params), one init per spec.

    The cascades start from key 1: from key 0 a pre-activation of
    stage1_S.conv5 lies 1.5e-7 of its layer's largest from zero, where
    float32 rounding decides the leaky ReLU's slope, so that one layer's
    gradient (and the layers' below it) differs by up to 0.8% between two
    correct implementations. ``key`` picks another init."""
    made = {}

    def get(spec, key=None):
        key = (0 if spec == "C" else 1) if key is None else key
        if (spec, key) not in made:
            model = build_model_jax(_config(ConfigJax, Path("."), corr_impl="jnp", flownet=spec))
            sample = jnp.zeros((1, H, W, 3), jnp.float32)
            made[spec, key] = model, jax.jit(model.init)(jax.random.PRNGKey(key), sample, sample)[
                "params"]
        return made[spec, key]

    return get


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_pair_flipped_flownet_matches_flax(flax_params, batch):
    model_jax, params = flax_params("C")
    rng = np.random.RandomState(1)
    n1 = rng.randn(2, H, W, 3).astype(np.float32)
    n2 = rng.randn(2, H, W, 3).astype(np.float32)
    inter = np.stack([n1, n2], 1).reshape(4, H, W, 3)
    flipped = np.stack([n2, n1], 1).reshape(4, H, W, 3)
    want = jax.jit(lambda p, a, b: model_jax.apply({"params": p}, a, b, pair_flipped_im2=True))(
        params, inter, flipped
    )[0]
    model = build_model(_config(Config, Path("."), corr_impl="torch"), "cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    a = torch.from_numpy(inter).permute(0, 3, 1, 2)
    b = torch.from_numpy(flipped).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = model(a, b, pair_flipped_im2=True)[0]
        plain = model(a, b)[0]  # the tower on both arguments: the same flows
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.permute(0, 2, 3, 1).numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max()
        )
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-6)


def test_piecewise_halving_matches_jax():
    mine = piecewise_halving(1e-4, decay_after=100, decay_interval=50)
    theirs = piecewise_halving_jax(1e-4, decay_after=100, decay_interval=50)
    for step in (0, 99, 100, 149, 150, 1000):
        assert mine(step) == pytest.approx(float(theirs(step)), rel=1e-6)
    assert [mine(s) for s in (0, 99, 100, 149, 150)] == [1e-4, 1e-4, 5e-5, 5e-5, 2.5e-5]


def _adam_states(opt_state):
    found = [
        s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")
    ]
    assert len(found) == 1
    return found[0]


STEP_CASES = {
    "plain": ("C", {}),
    "clip_decay": ("C", {"grad_clip_norm": 1.0, "weight_decay": 1e-3}),
    "cS": ("cS", {}),  # frozen FlowNetC under a trainable FlowNetS
    "CSS_train_all": ("CSS", {"train_all": True}),  # every stage's loss, gradients through the warps
    # the held-out run's bootstrap objective: photometric, no occlusion masking
    "bootstrap": ("C", {"photo_weight": 1.0, "ternary_weight": 0.0, "occ_weight": 0.0,
                        "mask_occlusion": ""}),
    "disocc": ("C", {"mask_occlusion": "disocc"}),
    # one forward apply, the EPE against dense ground truth (S) and against a
    # sparse mask, with its gradient through the correlation (C)
    "supervised_S": ("S", {"supervised": True}),
    "supervised_C_sparse": ("C", {"supervised": True}),
}
# The supervised C step starts from init key 2: on its batch (one forward
# apply of 2 pairs) a pre-activation lies within float32 rounding of the leaky
# ReLU's kink at keys 0 (deconv5's output) and 1 (conv3_1's), where the two
# packages may take either slope and the gradients of the layers below part
# beyond this test's 1e-3.
INIT_KEYS = {"supervised_C_sparse": 2}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_train_step_matches_jax(tmp_path, flax_params, batch, sup_batch, case):
    """Tolerances (float32, CPU): loss and each logged term 1e-4 relative,
    grad_norm 1e-3, Adam's first and second moments per leaf 1e-3 relative L2
    (the first moment after one step is 0.1 x the gradient that Adam saw, so
    this holds every leaf of the gradient too). The updated parameters are
    only bounded: after one step Adam moves an element by lr * g / (|g| + eps),
    so an element whose gradient is near eps may take a step of either size.
    A frozen stage's parameters get no optimizer state and do not move."""
    spec, overrides = STEP_CASES[case]
    overrides = {"flownet": spec, **overrides}
    if overrides.get("supervised"):
        batch = sup_batch if spec == "C" else {k: v for k, v in sup_batch.items() if k != "mask"}
    model_jax, params = flax_params(spec, INIT_KEYS.get(case))
    cfg_jax = _config(ConfigJax, tmp_path, corr_impl="jnp", **overrides)
    tx = build_optimizer_jax(cfg_jax, params)
    state = TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params))
    step_jax = jax.jit(make_train_step_jax(model_jax, tx, cfg_jax))
    new_state, want_logs = step_jax(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0)
    )
    want_logs = {k: float(v) for k, v in want_logs.items()}

    cfg = _config(Config, tmp_path, corr_impl="torch", **overrides)
    host_params = jax.device_get(params)
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu",
                      params=params_from_flax(host_params))
    logs = {k: float(v) for k, v in trainer.train_step(batch).items()}
    assert trainer.step == 1

    assert set(logs) == set(want_logs)
    for key, want in want_logs.items():
        tol = 1e-3 if key == "grad_norm" else 1e-4
        assert logs[key] == pytest.approx(want, rel=tol, abs=1e-7), key
    if case == "clip_decay":
        assert want_logs["grad_norm"] > 10 * cfg.train.grad_clip_norm  # the clip is active
    if case.startswith("supervised"):
        assert "epe_charbonnier/scale0" in logs and "ternary/scale0" not in logs

    adam = _adam_states(new_state.opt_state)
    trainable = [f"stage{i}_{ch}" for i, ch in enumerate(spec) if ch.isupper()]
    want_mu = params_from_flax({k: jax.device_get(adam.mu[k]) for k in trainable})
    want_nu = params_from_flax({k: jax.device_get(adam.nu[k]) for k in trainable})
    want_params = params_from_flax(jax.device_get(new_state.params))
    old_params = params_from_flax(host_params)
    lr = cfg.train.learning_rate
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert not name.startswith(tuple(trainable)), name
            assert p not in trainer.state.optimizer.state, name
            assert torch.equal(p.detach(), old_params[name]), name
            assert torch.equal(p.detach(), want_params[name]), name
            continue
        slot = trainer.state.optimizer.state[p]
        assert _rel_l2(slot["exp_avg"].numpy(), want_mu[name].numpy()) < 1e-3, name
        assert _rel_l2(slot["exp_avg_sq"].numpy(), want_nu[name].numpy()) < 1e-3, name
        moved = (p.detach() - old_params[name]).abs()
        assert moved.max() <= lr * (1 + 1e-3), name
        diff = (p.detach() - want_params[name]).abs()
        assert diff.max() <= 2 * lr * (1 + 1e-3), name
        assert (diff < 0.01 * lr).float().mean() > 0.98, name


def test_bf16_css_step_has_finite_gradients(tmp_path, batch):
    cfg = _config(Config, tmp_path, corr_impl="torch", flownet="CSS", train_all=True,
                  compute_dtype="bfloat16")
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")
    logs = trainer.train_step(batch)
    assert np.isfinite(float(logs["loss"])) and np.isfinite(float(logs["grad_norm"]))
    assert {"stage0/total", "stage2/total"} <= set(logs)
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert torch.isfinite(p).all(), name


def test_train_step_takes_uint8_batches(tmp_path, batch):
    u8 = {k: np.round(v * 255.0).astype(np.uint8) for k, v in batch.items()}
    as_float = {k: v.astype(np.float32) / 255.0 for k, v in u8.items()}
    losses = []
    for name, b in (("u8", u8), ("f32", as_float)):
        cfg = _config(Config, tmp_path, corr_impl="torch")
        trainer = Trainer(cfg, tmp_path / name, itertools.repeat(b), device="cpu")
        losses.append(float(trainer.train_step(b)["loss"]))
    assert losses[0] == losses[1]


def test_step_randomness_depends_on_seed_and_step_alone(tmp_path, batch):
    big = next(batch_iterator(BATCH, H + 8, W + 16, seed=1, max_shift=3.0))

    def first_losses(seed, name):
        cfg = _config(Config, tmp_path, corr_impl="torch", aug_photometric=True, aug_hflip=True,
                      aug_swap_prob=0.5, seed=seed, learning_rate=0.0)
        trainer = Trainer(cfg, tmp_path / name, itertools.repeat(big), device="cpu")
        return [float(trainer.train_step(big)["loss"]) for _ in range(2)]

    a, again, other = first_losses(0, "a"), first_losses(0, "b"), first_losses(1, "c")
    assert a == again
    assert a[0] != a[1]  # lr 0: only the step's draws differ
    assert a[0] != other[0]


def test_trainer_run_lowers_the_loss_on_a_repeated_batch(tmp_path, batch):
    cfg = _config(Config, tmp_path, corr_impl="torch", learning_rate=3e-4)
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")
    logs = trainer.run()
    assert trainer.step == 3
    records = [json.loads(line) for line in open(tmp_path / "ex" / "metrics.jsonl")]
    losses = [r["loss"] for r in records]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    assert logs["loss"] == losses[2]
    for key in ("pairs_per_sec", "step_ms", "grad_norm", "lr", "total", "ternary/scale0"):
        assert key in records[0]
    assert records[0]["lr"] == 3e-4
    assert trainer.run() == {}  # already complete


def test_frozen_spec_leaves_nothing_to_train(tmp_path, batch):
    cfg = _config(Config, tmp_path, corr_impl="torch", flownet="c")
    with pytest.raises(ValueError, match="no parameter to train"):
        Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")


@pytest.mark.parametrize(
    "key,value,item",
    # the ids are those of the time both keys named A13; both are ported now
    # (one process per GPU): in one process, num_devices = 4 and
    # spatial_shards = 2 each name the torchrun command that starts them
    [pytest.param("num_devices", 4, "torchrun --nproc-per-node 4", id="num_devices-4-A13"),
     pytest.param("spatial_shards", 2, "torchrun --nproc-per-node 2", id="spatial_shards-2-A13")],
)
def test_unported_parts_raise_with_their_roadmap_item(tmp_path, batch, key, value, item):
    cfg = _config(Config, tmp_path, **{key: value})
    with pytest.raises(ValueError, match=item):
        Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")


def test_swap_with_supervised_training_is_refused(tmp_path, sup_batch):
    cfg = _config(Config, tmp_path, supervised=True, aug_swap_prob=0.5)
    with pytest.raises(ValueError, match="aug_swap_prob requires unsupervised"):
        Trainer(cfg, tmp_path / "ex", itertools.repeat(sup_batch), device="cpu")


@pytest.mark.parametrize("affine", [False, True], ids=["crop_flip", "affine"])
def test_supervised_step_carries_the_ground_truth_through_augmentation(tmp_path, affine):
    """A supervised batch larger than the crop, with flips (and the affine
    ranges of configs/synthia_pretrain_c_affine.ini): the step draws one crop
    for frames, flow and mask, and the loss and the gradients stay finite.
    Without the affine transform the loss falls on the repeated batch (the
    affine draws move it more than three steps do)."""
    big = next(batch_iterator(BATCH, H + 8, W + 16, seed=5, max_shift=3.0, supervised=True))
    extra = dict(aug_translate=0.05, aug_rotate=5.0, aug_zoom_min=0.95, aug_zoom_max=1.05,
                 aug_rel_translate=0.01, aug_rel_rotate=1.0, aug_rel_zoom=0.02) if affine else {}
    cfg = _config(Config, tmp_path, corr_impl="torch", flownet="S", supervised=True,
                  aug_hflip=True, aug_photometric=True, learning_rate=3e-4, **extra)
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(big), device="cpu")
    losses = [float(trainer.train_step(big)["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert affine or losses[2] < losses[0], losses
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_trainer_without_gpu_raises_unless_cpu_is_asked_for(tmp_path, batch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_config(Config, tmp_path), tmp_path / "ex", itertools.repeat(batch))


def _write_ini(tmp_path):
    path = tmp_path / "tiny.ini"
    lines = [f"{k} = {v}" for k, v in SHARED.items() if k not in ("num_iters", "display_interval")]
    path.write_text(f"[dirs]\ndata = {tmp_path / 'data'}\nlog = {tmp_path / 'log'}\n\n"
                    "[train]\ndataset = synthetic\n"
                    + "\n".join(lines) + "\ncorr_impl = jnp\nnum_threads = 0\n")
    return path


def test_cli_train_on_cpu_writes_snapshot_and_metrics(tmp_path, capsys):
    ini = _write_ini(tmp_path)
    args = ["--config", str(ini), "--ex", "run", "--set", "num_iters=2",
            "--set", "display_interval=1", "--device", "cpu"]
    assert cli_train.main(args) == 0
    out = capsys.readouterr().out
    assert "experiment run: step 0 -> 2" in out and "done at step 2: loss=" in out
    ex_dir = tmp_path / "log" / "ex" / "run"
    snapshot = load_config(ex_dir / "config.ini")
    assert snapshot.train.num_iters == 2 and snapshot.train.max_displacement == 4
    records = [json.loads(line) for line in open(ex_dir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2] and np.isfinite(records[-1]["loss"])
    assert sorted(p.name for p in (ex_dir / "checkpoints").iterdir()) == ["2.pt"]
    # the experiment exists: a rerun resumes it under its snapshot, which
    # the --set of the rerun does not change
    assert cli_train.main(args[:4] + ["--set", "num_iters=5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "snapshot" in out and "ignoring --config/--set" in out
    assert "experiment run: step 2 -> 2" in out and "already complete at step 2" in out
    assert load_config(ex_dir / "config.ini").train.num_iters == 2


def test_cli_train_refusals(tmp_path):
    ini = _write_ini(tmp_path)
    # a dataset directory that does not exist fails before the snapshot is written
    with pytest.raises(FileNotFoundError, match="kitti_raw"):
        cli_train.main(["--config", str(ini), "--ex", "k", "--set", "dataset=kitti_raw",
                        "--device", "cpu"])
    assert not (tmp_path / "log" / "ex" / "k").exists()
    with pytest.raises(FileNotFoundError):
        cli_train.main(["--config", str(ini), "--ex", "k", "--set", "dataset=kitti_raw",
                        "--set", f"packed_dir={tmp_path / 'nowhere'}", "--device", "cpu"])
    assert not (tmp_path / "log" / "ex" / "k").exists()
    with pytest.raises(SystemExit, match="unknown config key"):
        cli_train.main(["--config", str(ini), "--ex", "k", "--set", "nope=1", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli_train.main(["--config", str(ini), "--ex", "k"])
        assert not (tmp_path / "log" / "ex" / "k").exists()


# --- in-training evaluation and training on a dataset --------------------------


def _write_kitti(root, rng, raw_frames=(4, 4), pairs_2012=4, hw=(70, 140)):
    """KITTI raw drives of ``raw_frames`` frames and a KITTI 2012 training tree
    of ``pairs_2012`` pairs (flow_occ only), all at ``hw`` (cropped to 64x128)."""
    from unflow_tpu_torch.data.io import write_image, write_kitti_png_flow

    h, w = hw
    for i, n in enumerate(raw_frames):
        d = root / "kitti_raw" / f"2011_09_26_drive_{i + 1:04d}_sync" / "image_02" / "data"
        d.mkdir(parents=True)
        for f in range(n):
            write_image(d / f"{f:010d}.png", rng.rand(h, w, 3).astype(np.float32))
    base = root / "kitti_2012" / "training"
    for sub in ("colored_0", "flow_occ"):
        (base / sub).mkdir(parents=True)
    for i in range(pairs_2012):
        for suffix in ("10", "11"):
            write_image(base / "colored_0" / f"{i:06d}_{suffix}.png",
                        rng.rand(h, w, 3).astype(np.float32))
        write_kitti_png_flow(base / "flow_occ" / f"{i:06d}_10.png",
                             (rng.randn(h, w, 2) * 3).astype(np.float32),
                             (rng.rand(h, w, 1) > 0.2).astype(np.float32))


def test_trainer_logs_eval_outside_the_throughput_window(tmp_path, batch, monkeypatch):
    """``eval_fn`` runs every ``eval_interval`` steps on the model, its values
    are logged as ``eval/<name>``, and its time leaves the window: on a clock
    that moves only while the eval runs, the steps take no time."""
    import unflow_tpu_torch.train.trainer as trainer_module

    clock = [0.0]
    monkeypatch.setattr(trainer_module.time, "perf_counter", lambda: clock[0])
    seen = []

    def eval_fn(model):
        seen.append(model)
        clock[0] += 100.0
        return {"aee": 1.5 * len(seen)}

    cfg = _config(Config, tmp_path, corr_impl="torch", eval_interval=2, num_iters=4)
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu",
                      eval_fn=eval_fn)
    trainer.run()
    records = [json.loads(line) for line in open(tmp_path / "ex" / "metrics.jsonl")]
    evals = [(r["step"], r["eval/aee"]) for r in records if "eval/aee" in r]
    assert evals == [(2, 1.5), (4, 3.0)] and all(m is trainer.model for m in seen)
    assert all(r["step_ms"] < 1e-3 for r in records if "step_ms" in r)


@pytest.mark.parametrize("dataset", ["synthetic", "kitti_2012", "kitti_raw"])
def test_build_eval_fn_matches_jax(tmp_path, rng, flax_params, dataset):
    """The in-training AEE of the port and of the JAX package, from the same
    parameters. A dataset without ground truth (KITTI raw) is evaluated on
    KITTI 2012's training pairs, as the UnFlow recipe does; the JAX package
    evaluates nothing there."""
    from unflow_tpu.cli.train import build_eval_fn as build_eval_fn_jax
    from unflow_tpu_torch.data import dataset_normalization

    _write_kitti(tmp_path, rng, raw_frames=(3,), pairs_2012=5)
    norm = dataset_normalization(dataset) or dataset_normalization("sintel")
    cfgs = [_config(cls, tmp_path, corr_impl="jnp", eval_interval=1, dataset=dataset)
            for cls in (ConfigJax, Config)]
    for c in cfgs:
        c.dirs.data = str(tmp_path)
    model_jax, params = flax_params("C")
    model = build_model(cfgs[1], "cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    got = cli_train.build_eval_fn(cfgs[1], norm, "cpu")(model)
    assert list(got) == ["aee"] and np.isfinite(got["aee"])
    if dataset == "kitti_raw":
        assert build_eval_fn_jax(cfgs[0], norm) is None
        cfgs[0].train.dataset = "kitti_2012"
    want = build_eval_fn_jax(cfgs[0], norm)(params)
    assert got["aee"] == pytest.approx(want["aee"], rel=1e-4)


def test_build_eval_fn_without_anything_to_evaluate(tmp_path):
    cfg = _config(Config, tmp_path, corr_impl="torch", dataset="kitti_2012")
    cfg.dirs.data = str(tmp_path)
    assert cli_train.build_eval_fn(cfg, None, "cpu") is None  # eval_interval 0
    cfg.train.eval_interval = 5
    assert cli_train.build_eval_fn(cfg, None, "cpu") is None  # no dataset on disk
    cfg.train.dataset = "synthia"
    assert cli_train.build_eval_fn(cfg, None, "cpu") is None  # no eval split


def _dataset_ini(tmp_path, **extra):
    lines = [f"{k} = {v}" for k, v in SHARED.items() if k not in ("num_iters", "display_interval")]
    lines += [f"{k} = {v}" for k, v in extra.items()]
    path = tmp_path / "kitti.ini"
    path.write_text(f"[dirs]\ndata = {tmp_path}\nlog = {tmp_path / 'log'}\n\n[train]\n"
                    "dataset = kitti_raw\ncorr_impl = jnp\nnum_threads = 2\n" + "\n".join(lines)
                    + "\n")
    return path


def test_cli_train_on_kitti_raw_decoded_and_packed(tmp_path, rng):
    """Two steps on a KITTI raw tree through the decoding Loader and through
    the packed directory of ``cli.pack``: the same batches, the same losses,
    and the held-out AEE on KITTI 2012 logged at each step."""
    from unflow_tpu_torch.cli.pack import main as pack_main

    _write_kitti(tmp_path, rng)
    ini = _dataset_ini(tmp_path, eval_interval=1)
    assert pack_main(["--dataset", "kitti_raw", "--data-dir", str(tmp_path), "--out",
                      str(tmp_path / "packed"), "--height", str(H), "--width", str(W)]) == 0
    losses = {}
    for ex, extra in (("decoded", []), ("packed", ["--set", f"packed_dir={tmp_path / 'packed'}"])):
        assert cli_train.main(["--config", str(ini), "--ex", ex, "--set", "num_iters=2",
                               "--set", "display_interval=1", "--device", "cpu", *extra]) == 0
        lines = (tmp_path / "log" / "ex" / ex / "metrics.jsonl").read_text().splitlines()
        records = [json.loads(line) for line in lines]
        losses[ex] = [r["loss"] for r in records if "loss" in r]
        evals = [r for r in records if "eval/aee" in r]
        assert [r["step"] for r in evals] == [1, 2] and all(np.isfinite(r["eval/aee"]) for r in evals)
        assert len(losses[ex]) == 2 and all(np.isfinite(losses[ex]))
    assert losses["decoded"] == losses["packed"]
    snapshot = load_config(tmp_path / "log" / "ex" / "packed" / "config.ini")
    assert snapshot.train.packed_dir == str(tmp_path / "packed")


def test_smoke_config_trains_with_its_eval_interval(tmp_path, monkeypatch):
    """``configs/smoke.ini`` (FlowNetS, ``eval_interval = 10``) through
    ``cli.train``, its ``dirs`` under ``tmp_path``: the eval at step 10 is
    logged."""
    shutil.copy(Path(__file__).resolve().parent.parent / "configs" / "smoke.ini", tmp_path)
    monkeypatch.chdir(tmp_path)  # dirs: data = data, log = log
    assert cli_train.main(["--config", "smoke.ini", "--ex", "smoke", "--set", "num_iters=10",
                           "--set", "num_threads=2", "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open("log/ex/smoke/metrics.jsonl")]
    assert [r["step"] for r in records if "loss" in r] == [5, 10]
    (aee,) = [r["eval/aee"] for r in records if "eval/aee" in r]
    assert np.isfinite(aee) and all(np.isfinite(r["loss"]) for r in records if "loss" in r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_several_steps_follow_jax(tmp_path, flax_params, dtype):
    """Six steps of the held-out run's bootstrap objective from one init on
    the same uint8 batches, augmentation off, each step's loss against the
    JAX package's. float32 follows within 2e-5 for five steps (it reads
    3e-6). At the sixth it parts by 2.8e-3 (limit 5e-3): at 64x128 the
    scale-3 level is 2x4 pixels, all on the frame's edge, where the sign of
    a near-zero flow decides the outgoing mask, so one rounding flips a
    pixel of it. bfloat16 stays within 1e-2 (it reads 6.1e-3): Adam moves an
    element by up to lr whatever the size of its gradient, so the towers'
    rounding in the near-zero gradients grows from step to step."""
    rtols = [2e-5] * 5 + [5e-3] if dtype == "float32" else [1e-2] * 6
    from unflow_tpu_torch.data.synthetic import corpus_iterator

    overrides = dict(photo_weight=1.0, ternary_weight=0.0, occ_weight=0.0, mask_occlusion="",
                     compute_dtype=dtype, num_iters=6)
    model_jax, params = flax_params("C")
    cfg_jax = _config(ConfigJax, tmp_path, corr_impl="jnp", **overrides)
    tx = build_optimizer_jax(cfg_jax, params)
    state = TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params))
    step_jax = jax.jit(make_train_step_jax(model_jax, tx, cfg_jax))
    stream = corpus_iterator(BATCH, H, W, n_pairs=12, seed=0, max_shift=16.0, dtype="uint8")
    batches = [next(stream) for _ in range(6)]
    trainer = Trainer(_config(Config, tmp_path, corr_impl="torch", **overrides), tmp_path / "ex",
                      iter(batches), device="cpu", params=params_from_flax(jax.device_get(params)))
    for i, b in enumerate(batches):
        state, want = step_jax(state, {k: jnp.asarray(v) for k, v in b.items()},
                               jax.random.PRNGKey(i))
        got = trainer.train_step(b)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=rtols[i]), i


def _write_chairs(root, rng, n=4, hw=(70, 140)):
    """A FlyingChairs tree of ``n`` pairs at ``hw`` with their ``.flo`` flow."""
    from unflow_tpu_torch.data.io import write_flo, write_image

    d = root / "chairs" / "data"
    d.mkdir(parents=True)
    for i in range(1, n + 1):
        for k in (1, 2):
            write_image(d / f"{i:05d}_img{k}.ppm", rng.rand(*hw, 3).astype(np.float32))
        write_flo(d / f"{i:05d}_flow.flo", (rng.randn(*hw, 2) * 3).astype(np.float32))


def test_cli_train_supervised_on_chairs_decoded_and_packed(tmp_path, rng):
    """``supervised = true`` on a FlyingChairs tree, FlowNetS as
    configs/chairs_supervised.ini: through the decoding Loader and through a
    packed directory with its ground truth, the same batches and losses."""
    from unflow_tpu_torch.cli.pack import main as pack_main

    _write_chairs(tmp_path, rng)
    ini = _dataset_ini(tmp_path)
    assert pack_main(["--dataset", "chairs", "--data-dir", str(tmp_path), "--out",
                      str(tmp_path / "packed"), "--height", str(H), "--width", str(W),
                      "--supervised"]) == 0
    losses = {}
    for ex, extra in (("decoded", []), ("packed", ["--set", f"packed_dir={tmp_path / 'packed'}"])):
        assert cli_train.main(["--config", str(ini), "--ex", ex, "--set", "dataset=chairs",
                               "--set", "flownet=S", "--set", "supervised=true",
                               "--set", "num_iters=2", "--set", "display_interval=1",
                               "--device", "cpu", *extra]) == 0
        lines = (tmp_path / "log" / "ex" / ex / "metrics.jsonl").read_text().splitlines()
        records = [json.loads(line) for line in lines]
        losses[ex] = [r["loss"] for r in records]
        assert all("epe_charbonnier/scale0" in r for r in records)
        assert len(losses[ex]) == 2 and all(np.isfinite(losses[ex]))
    assert losses["decoded"] == losses["packed"]


def test_cli_train_supervised_on_synthetic_batches(tmp_path):
    ini = _write_ini(tmp_path)
    assert cli_train.main(["--config", str(ini), "--ex", "sup", "--set", "supervised=true",
                           "--set", "num_iters=2", "--set", "display_interval=1",
                           "--device", "cpu"]) == 0
    records = [json.loads(line) for line in open(tmp_path / "log" / "ex" / "sup" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and "epe_charbonnier/scale4" in r for r in records)
