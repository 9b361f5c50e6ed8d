"""The port's training trajectory side by side with the JAX package's.

Both start from one flax init (``PRNGKey(0)``, carried over by
``params_from_flax``), train on the same ``corpus_iterator`` batches with the
held-out recipe's bootstrap objective (``heldout.build_cfg(bootstrap=True)``)
and log every step's loss, each loss term and ``grad_norm``, and the
held-out AEE every ``eval_every`` steps. With augmentation on, the two
random streams cannot agree, so the port's step takes the JAX step's own
draws through ``make_train_step``'s ``draws`` seam, re-derived from the JAX
key as ``unflow_tpu/train/trainer.py`` splits it.

Two correct implementations part by rounding within ten free-running
steps, so the port's step is also taken from the JAX state before it
("forced") and held against the JAX step, and a free run is held against the
port's own spread (a twin run on another thread count).

The twelve-step cases and the bfloat16 rounding check run in tier-1; the
250-step runs and the excess-precision experiment are minute-scale and
marked ``slow`` (``--runslow``; ``-s`` prints the trajectories).
"""

import importlib.util
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.augment import sample_affine_params as sample_affine_params_jax
from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.data.synthetic import corpus_iterator as corpus_iterator_jax
from unflow_tpu.train.trainer import TrainState as TrainStateJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.train.trainer import build_optimizer as build_optimizer_jax
from unflow_tpu.train.trainer import make_train_step as make_train_step_jax
from unflow_tpu_torch import heldout
from unflow_tpu_torch.augment import AffineParams
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data.synthetic import corpus_iterator
from unflow_tpu_torch.train import Trainer
from unflow_tpu_torch.train.trainer import affine_ranges, make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def jax_draws(cfg, step: int, loaded_hw: tuple[int, int]) -> dict:
    """The augmentation parameters the JAX train step draws at ``step``
    (``unflow_tpu/train/trainer.py``: ``fold_in(PRNGKey(seed), step)`` split
    into the crop/flip, photometric, affine and swap keys), in the layout of
    the port's ``sample_*_params``."""
    t = cfg.train
    b, (h, w), (ch, cw) = t.batch_size, loaded_hw, (t.height, t.width)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(t.seed), step)
    k_geo, k_photo, k_affine, k_swap = jax.random.split(step_rng, 4)
    out = {}
    if t.aug_swap_prob:
        out["swap"] = _t(jax.random.bernoulli(k_swap, t.aug_swap_prob, (b, 1, 1, 1)))
    ranges = affine_ranges(cfg)
    if ranges is not None:
        out["affine"] = AffineParams(*(_t(x) for x in sample_affine_params_jax(
            k_affine, b, (h, w), **ranges)))
    # unflow_tpu/augment/__init__.py::random_crop_flip
    k_off, k_flip = jax.random.split(k_geo)
    out["crop_flip"] = {
        "oy": _t(jax.random.randint(k_off, (), 0, h - ch + 1)).long(),
        "ox": _t(jax.random.randint(jax.random.fold_in(k_off, 1), (), 0, w - cw + 1)).long(),
        "flip": _t(bool(t.aug_hflip) & (jax.random.uniform(k_flip, ()) < 0.5)),
    }
    if t.aug_photometric:
        # unflow_tpu/augment/__init__.py::random_photometric
        k_contrast, k_gamma, k_bright, k_colour, k_noise = jax.random.split(k_photo, 5)
        noise = t.aug_noise_stddev
        out["photometric"] = {
            "contrast": _t(jax.random.uniform(k_contrast, (b, 1, 1, 1), minval=-0.3, maxval=0.3)),
            "gamma": _t(jax.random.uniform(k_gamma, (b, 1, 1, 1), minval=0.7, maxval=1.5)),
            "bright": _t(0.02 * jax.random.normal(k_bright, (b, 1, 1, 1))),
            "colour": _t(jax.random.uniform(k_colour, (b, 1, 1, 3), minval=0.9, maxval=1.1)),
            "noise": [_t(noise * jax.random.normal(jax.random.fold_in(k_noise, i), (b, ch, cw, 3)))
                      for i in range(2 if noise > 0 else 0)],
        }
    return out


def _script():
    spec = importlib.util.spec_from_file_location(
        "heldout_generalization", ROOT / "scripts" / "heldout_generalization.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside ``opt_state``."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def load_jax_state(trainer: Trainer, state) -> None:
    """Put the JAX train state (parameters, Adam's moments and count, the
    step) into the port's ``trainer``."""
    host = jax.device_get(state)
    trainer.model.load_state_dict(params_from_flax(host.params))
    adam = _adam_state(host.opt_state)
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    optimizer = trainer.state.optimizer
    optimizer.state.clear()
    if int(adam.count):
        for name, p in trainer.model.named_parameters():
            optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                  "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    trainer.state.step = int(host.step)


def _update_agreement(trainer: Trainer, before, after, lr: float) -> tuple[float, float]:
    """The share of parameter elements whose update by the port's step lies
    within 1% of ``lr`` of the JAX step's (Adam moves an element by up to lr,
    and by a size set by eps where its gradient is near eps): over all the
    parameters, and the least over the leaves with one element of each
    forgiven (a fault confined to a small leaf, a bias or a flow head, shows
    in the second; one element whose gradient lies within rounding of zero
    may move by up to lr either way, which in a leaf of 32 is 3%)."""
    want = params_from_flax(jax.device_get(after.params))
    old = params_from_flax(jax.device_get(before.params))
    close = total = 0
    least = 1.0
    for name, p in trainer.model.named_parameters():
        got_update = p.detach() - old[name]
        want_update = want[name] - old[name]
        leaf = int(((got_update - want_update).abs() < 0.01 * lr).sum())
        close += leaf
        total += p.numel()
        least = min(least, min(leaf + 1, p.numel()) / p.numel())
    return close / total, least


# optax.adam's defaults, which the JAX package's optimizer uses
ADAM_BETAS = (0.9, 0.999)


def _moment_gap(trainer: Trainer, before, after) -> float:
    """The largest gap, over the parameter leaves, of Adam's moments after
    the port's step (``exp_avg``, ``exp_avg_sq``) from the JAX step's
    (``mu``, ``nu``): the L2 norm of the difference over that of JAX's
    moment plus that of this step's part of it (``m - beta * m_before``),
    so that a moment which this step's gradient nearly cancels is held at
    the gradient's scale. Adam's step count must equal JAX's."""
    prev = _adam_state(jax.device_get(before.opt_state))
    adam = _adam_state(jax.device_get(after.opt_state))
    moments = [(params_from_flax(adam.mu), params_from_flax(prev.mu), "exp_avg", ADAM_BETAS[0]),
               (params_from_flax(adam.nu), params_from_flax(prev.nu), "exp_avg_sq", ADAM_BETAS[1])]
    gap = 0.0
    for name, p in trainer.model.named_parameters():
        slot = trainer.state.optimizer.state[p]
        assert int(slot["step"]) == int(adam.count), name
        for want, want_prev, key, beta in moments:
            w = want[name]
            scale = w.norm() + (w - beta * want_prev[name]).norm()
            gap = max(gap, float((slot[key] - w).norm() / scale.clamp_min(1e-30)))
    return gap


def recipe_configs(tmp_path, steps: int, *, hw=(64, 128), batch=2, dtype="float32",
                   augment=True, affine=False, max_displacement=4, eval_every=1):
    """The port's config of the held-out recipe's bootstrap objective
    (``heldout.build_cfg``) at this size, and the JAX package's copy of it;
    ``augment=False`` turns the photometric augmentation and the flips off."""
    h, w = hw
    argv = ["--hw", str(h), str(w), "--batch", str(batch), "--steps", str(steps),
            "--dtype", dtype, "--eval-every", str(eval_every),
            "--set", f"max_displacement={max_displacement}", "--set", "corr_impl=torch"]
    if not augment:
        argv += ["--set", "aug_photometric=false", "--set", "aug_hflip=false"]
    cfg = heldout.build_cfg(heldout.parse_args(argv), affine=affine, bootstrap=True)
    cfg.dirs.log = str(tmp_path / "log")
    cfg_jax = ConfigJax()
    for key in vars(cfg.train):
        setattr(cfg_jax.train, key, getattr(cfg.train, key))
    cfg_jax.train.corr_impl = "jnp"
    return cfg, cfg_jax


def jax_init(cfg_jax, hw):
    """The flax model of ``cfg_jax`` and its parameters from ``PRNGKey(0)``."""
    model_jax = build_model_jax(cfg_jax)
    sample = jnp.zeros((1, *hw, 3), jnp.float32)
    return model_jax, jax.jit(model_jax.init)(jax.random.PRNGKey(0), sample, sample)["params"]


def run_side_by_side(tmp_path, steps: int, *, hw=(64, 128), batch=2, dtype="float32",
                     augment=True, affine=False, max_displacement=4, n_pairs=16,
                     eval_every=0, eval_batch=2, free=True, forced=False, noise=False,
                     perturb=None):
    """Train the JAX package ``steps`` steps and follow it with the port on
    the same batches, from one init. Returns one row per step: ``{"step",
    "jax": logs}`` and, for each port run asked for, its logs:

    * ``free``: the port's own trajectory;
    * ``forced``: the port's step taken from the JAX state before the step
      (parameters, Adam's moments and count), so that it is held against the
      JAX step along the JAX trajectory, with ``update_agreement`` and
      ``leaf_agreement`` (the share of parameter updates within 1% of lr of
      the JAX step's, over all and in the worst leaf) and ``moment_gap``
      (Adam's moments against JAX's, the worst leaf);
    * ``noise``: a second free port trajectory whose steps run on 4 threads
      (the others on 1): its gap to ``free`` is the spread that summation
      order alone opens, the noise floor of the comparison.

    ``perturb``: every run starts from the init multiplied by ``1 + 1e-6 *
    z``, ``z`` a standard normal draw per element from
    ``numpy.random.default_rng(perturb)``.

    ``heldout_aee`` joins the logs of the JAX, free and noise runs every
    ``eval_every`` steps (0: never). The JAX step trains on the JAX
    package's own ``corpus_iterator``, the port's on the port's, and each
    batch of the two streams is checked equal (the per-epoch reshuffle
    included)."""
    h, w = hw
    cfg, cfg_jax = recipe_configs(tmp_path, steps, hw=hw, batch=batch, dtype=dtype,
                                  augment=augment, affine=affine,
                                  max_displacement=max_displacement,
                                  eval_every=max(eval_every, 1))
    model_jax, params = jax_init(cfg_jax, hw)
    if perturb is not None:
        rng = np.random.default_rng(perturb)
        params = jax.tree_util.tree_map(
            lambda a: a * (1 + 1e-6 * jnp.asarray(rng.standard_normal(a.shape), a.dtype)), params)
    tx = build_optimizer_jax(cfg_jax, params)
    state = TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params))
    step_jax = jax.jit(make_train_step_jax(model_jax, tx, cfg_jax))
    key = jax.random.PRNGKey(cfg.train.seed)  # what the JAX Trainer passes every step

    runs = [name for name, on in (("free", free), ("forced", forced), ("noise", noise)) if on]
    init = params_from_flax(jax.device_get(params))
    trainers = {name: Trainer(cfg, tmp_path / name, itertools.repeat(None), device="cpu",
                              params=init) for name in runs}
    if augment:
        for trainer in trainers.values():
            trainer._step_fn = make_train_step(cfg, draws=lambda step: jax_draws(cfg, step, hw))
    evals = None
    if eval_every:
        eval_jax, _ = _script().make_eval_fn(model_jax, h, w, eval_batch, heldout.DATA_MODE,
                                             max_shift=heldout.MAX_SHIFT)
        eval_port = heldout.make_eval_fn(heldout.heldout_set(eval_batch, h, w), "cpu")
        evals = eval_jax, eval_port

    corpus = dict(n_pairs=n_pairs, seed=0, mode=heldout.DATA_MODE, max_shift=heldout.MAX_SHIFT,
                  dtype="uint8")
    stream = corpus_iterator(batch, h, w, **corpus)
    stream_jax = corpus_iterator_jax(batch, h, w, **corpus)
    threads = torch.get_num_threads()
    rows = []
    for _ in range(steps):
        b, b_jax = next(stream), next(stream_jax)
        assert all(np.array_equal(b[k], b_jax[k]) for k in ("im1", "im2"))
        before = state
        state, want = step_jax(state, {k: jnp.asarray(v) for k, v in b_jax.items()}, key)
        row = {"step": int(state.step), "jax": {k: float(v) for k, v in want.items()}}
        for name, trainer in trainers.items():
            if name == "forced":
                load_jax_state(trainer, before)
            torch.set_num_threads(4 if name == "noise" else threads)
            row[name] = {k: float(v) for k, v in trainer.train_step(b).items()}
            torch.set_num_threads(threads)
            if name == "forced":
                row[name]["update_agreement"], row[name]["leaf_agreement"] = _update_agreement(
                    trainer, before, state, cfg.train.learning_rate)
                row[name]["moment_gap"] = _moment_gap(trainer, before, state)
        if evals and row["step"] % eval_every == 0:
            row["jax"]["heldout_aee"] = evals[0](state.params)["heldout_aee"]
            for name in ("free", "noise"):
                if name in trainers:
                    row[name]["heldout_aee"] = evals[1](trainers[name].model)["heldout_aee"]
        rows.append(row)
    return rows


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _print_rows(rows, run="free", keys=("loss", "grad_norm", "heldout_aee")):
    """Each step's ``keys``: JAX's value, the port's and their relative gap,
    or the port's alone where JAX has none (the forced steps' readings)."""
    for r in rows:
        cells = [f"{k} {r['jax'][k]:.7g}/{r[run][k]:.7g} ({_rel(r[run][k], r['jax'][k]):.2e})"
                 if k in r["jax"] else f"{k} {r[run][k]:.7g}"
                 for k in keys if k in r[run]]
        print(f"step {r['step']:4d} {run} " + "  ".join(cells), flush=True)


FORCED_KEYS = ("loss", "grad_norm", "lr", "update_agreement", "leaf_agreement", "moment_gap")


def _forced_gaps(row) -> tuple[float, float]:
    """(the largest relative gap of the loss and the logged terms, that of
    ``grad_norm``) of a forced step against the JAX step. A term is compared
    where it is above 1e-6 of the loss; below, the absolute gap is."""
    jax_logs, port = row["jax"], row["forced"]
    floor = 1e-6 * abs(jax_logs["loss"])
    terms = [abs(port[k] - v) / max(abs(v), floor) for k, v in jax_logs.items()
             if k not in ("lr", "grad_norm", "heldout_aee")]
    return max(terms), _rel(port["grad_norm"], jax_logs["grad_norm"])


@pytest.mark.parametrize("affine", [False, True], ids=["photometric_flip", "affine_on"])
def test_steps_with_augmentation_follow_jax(tmp_path, affine):
    """Twelve steps in float32 at 64x128, batch 2, D = 5, augmentation on
    (photometric with noise and flips; ``affine_on`` adds the held-out arm's
    affine ranges), the port's step fed the JAX step's draws. Free-running,
    two trajectories part by rounding alone within a few steps (Adam moves
    an element by up to lr whatever the size of its gradient). So each of
    the port's steps is taken from the JAX state before it (parameters,
    Adam's moments and count) and held against the JAX step: the loss and
    each logged term within 2e-5, ``grad_norm`` within 1e-4, the learning
    rate within 1e-6 and Adam's step count equal at every step; each leaf's
    moments (``exp_avg``, ``exp_avg_sq`` against ``mu``, ``nu``) within 5e-3
    (``_moment_gap``; they read up to 2.3e-3, in the deep encoder's layers,
    whose gradients sum the few pixels of 4x8 and 2x4 maps; most steps
    under 1e-4); and at least 99.9% of the parameter updates within 1% of
    lr of the JAX step's, and 99% in every leaf with one element forgiven
    (Adam's bias correction, eps and the learning rate, leaf by leaf; they
    read at least 99.98% and 99.6%). Exempt, as in
    ``test_torch_train.py::test_several_steps_follow_jax``: one step at
    which a pixel of a coarse level's outgoing mask flips may read up to
    5e-3 in its terms and ``grad_norm``."""
    rows = run_side_by_side(tmp_path, 12, affine=affine, free=False, forced=True)
    _print_rows(rows, "forced", FORCED_KEYS)
    parted = []
    for r in rows:
        port = r["forced"]
        assert set(port) - set(FORCED_KEYS) == set(r["jax"]) - set(FORCED_KEYS), r["step"]
        assert port["lr"] == pytest.approx(r["jax"]["lr"], rel=1e-6), r["step"]
        assert port["moment_gap"] < 5e-3, r["step"]
        assert port["update_agreement"] > 0.999 and port["leaf_agreement"] > 0.99, r["step"]
        terms, grad_norm = _forced_gaps(r)
        if terms > 2e-5 or grad_norm > 1e-4:
            parted.append((r["step"], terms, grad_norm))
    assert len(parted) <= 1 and all(t < 5e-3 and g < 5e-3 for _, t, g in parted), parted


def test_bf16_step_rounds_as_far_from_f32_as_jax(tmp_path):
    """Where each package rounds the bfloat16 step (candidate: a cast back to
    float32 in the loss or the glue that JAX does not make, or the reverse):
    one step of the bootstrap objective from JAX's init at 64x128, batch 2,
    D = 21, no augmentation, in float32 and in bfloat16 in both packages.
    Against the JAX float32 step's gradient (Adam's first moment / 0.1), the
    port's float32 gradient lies within 1e-3 (relative L2), and its bfloat16
    gradient as far as JAX's bfloat16 one, within a factor 1.5 either way
    (they read 3.2e-2 and 3.4e-2)."""
    b = next(corpus_iterator(2, 64, 128, n_pairs=8, seed=0, mode=heldout.DATA_MODE,
                             max_shift=heldout.MAX_SHIFT, dtype="uint8"))
    grads = {}
    for dtype in ("float32", "bfloat16"):
        cfg, cfg_jax = recipe_configs(tmp_path, 1, dtype=dtype, augment=False,
                                      max_displacement=20)
        model_jax, params = jax_init(cfg_jax, (64, 128))
        tx = build_optimizer_jax(cfg_jax, params)
        state = TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params))
        state, _ = jax.jit(make_train_step_jax(model_jax, tx, cfg_jax))(
            state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        mu = params_from_flax(jax.device_get(_adam_state(state.opt_state).mu))
        grads["jax", dtype] = {k: v / 0.1 for k, v in mu.items()}
        trainer = Trainer(cfg, tmp_path / dtype, itertools.repeat(None), device="cpu",
                          params=params_from_flax(jax.device_get(params)))
        trainer.train_step(b)
        grads["port", dtype] = {n: p.grad for n, p in trainer.model.named_parameters()}
    ref = grads["jax", "float32"]

    def gap(g):
        num = sum(float((g[k] - ref[k]).square().sum()) for k in ref)
        return (num / sum(float(ref[k].square().sum()) for k in ref)) ** 0.5

    port_f32, port_bf16, jax_bf16 = (gap(grads[k]) for k in (
        ("port", "float32"), ("port", "bfloat16"), ("jax", "bfloat16")))
    print(f"gradient relative L2 from JAX float32: port float32 {port_f32:.3e}, port bfloat16 "
          f"{port_bf16:.3e}, JAX bfloat16 {jax_bf16:.3e}")
    assert port_f32 < 1e-3
    assert jax_bf16 / 1.5 < port_bf16 < 1.5 * jax_bf16


def _rounding_frames() -> tuple[np.ndarray, np.ndarray]:
    """Two batches of frames (NHWC, 2x64x128x3) for the bf16 forward."""
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal((2, 64, 128, 3)).astype(np.float32) for _ in range(2))


def _with_biases(params):
    """The flax params with every bias drawn (normal, 0.1) from a numpy seed:
    at init they are zeros, and a sum with a zero bias rounds nothing."""
    rng = np.random.default_rng(12)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(v), jax.device_get(params))


def xla_rounding_results() -> dict:
    """What XLA computes for the bf16 rounding tests, as this process's
    ``XLA_FLAGS`` compile it: one bf16 step of the held-out recipe's
    bootstrap objective from JAX's init (64x128, batch 2, D = 21, no
    augmentation), its gradient (Adam's first moment / 0.1) by the port's
    parameter name under ``step/``; and the float32 flows of the bf16
    network from JAX's init, its biases drawn (:func:`_with_biases`), on
    :func:`_rounding_frames`, finest first, under ``flows/``."""
    import tempfile

    out = {}
    b = next(corpus_iterator(2, 64, 128, n_pairs=8, seed=0, mode=heldout.DATA_MODE,
                             max_shift=heldout.MAX_SHIFT, dtype="uint8"))
    _, cfg_jax = recipe_configs(Path(tempfile.mkdtemp()), 1, dtype="bfloat16", augment=False,
                                max_displacement=20)
    model_jax, params = jax_init(cfg_jax, (64, 128))
    tx = build_optimizer_jax(cfg_jax, params)
    state = TrainStateJax(jnp.zeros((), jnp.int32), params, tx.init(params))
    state, _ = jax.jit(make_train_step_jax(model_jax, tx, cfg_jax))(
        state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    mu = params_from_flax(jax.device_get(_adam_state(state.opt_state).mu))
    out.update({f"step/{k}": (v / 0.1).numpy() for k, v in mu.items()})
    flows = jax.jit(model_jax.apply)({"params": _with_biases(params)},
                                     *map(jnp.asarray, _rounding_frames()))
    out.update({f"flows/{i}": np.asarray(f, np.float32).transpose(0, 3, 1, 2)
                for i, f in enumerate(flows[0])})
    return out


def port_rounding_results(tmp_path) -> dict:
    """The port's counterpart of :func:`xla_rounding_results` (the same
    step, the same forward)."""
    out = {}
    b = next(corpus_iterator(2, 64, 128, n_pairs=8, seed=0, mode=heldout.DATA_MODE,
                             max_shift=heldout.MAX_SHIFT, dtype="uint8"))
    cfg, cfg_jax = recipe_configs(tmp_path, 1, dtype="bfloat16", augment=False,
                                  max_displacement=20)
    _, params = jax_init(cfg_jax, (64, 128))
    trainer = Trainer(cfg, tmp_path / "rounding", itertools.repeat(None), device="cpu",
                      params=params_from_flax(jax.device_get(params)))
    trainer.train_step(b)
    out.update({f"step/{n}": p.grad.numpy() for n, p in trainer.model.named_parameters()})
    frames = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in _rounding_frames()]
    with torch.no_grad():
        trainer.model.load_state_dict(params_from_flax(_with_biases(params)))
        flows = trainer.model(*frames)
    out.update({f"flows/{i}": f.numpy() for i, f in enumerate(flows[0])})
    return out


def _gap(a: dict, b: dict, prefix: str) -> float:
    """Relative L2 of ``a`` from ``b`` over the keys ``prefix`` names: the
    key itself, or those under it (a prefix ending in ``/``)."""
    keys = [k for k in b if k.startswith(prefix)] if prefix.endswith("/") else [prefix]
    num = sum(float(((a[k].astype(np.float64) - b[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((b[k].astype(np.float64) ** 2).sum()) for k in keys)) ** 0.5


def _bf16_share(results: dict, prefix: str, suffix: str = "") -> float:
    """The share of the elements under ``prefix`` (of keys ending in
    ``suffix``) that lie within two float32 ulps of a bfloat16 value: 1
    where they were rounded to bfloat16 (Adam's ``0.1 * g`` and back moves a
    gradient by an ulp or two)."""
    hits = total = 0
    for k, v in results.items():
        if k.startswith(prefix) and k.endswith(suffix):
            t = torch.from_numpy(np.ascontiguousarray(v, np.float32)).ravel()
            hits += int(((t - t.to(torch.bfloat16).float()).abs() <= 2 * t.abs() * 2**-23).sum())
            total += t.numel()
    return hits / total


@pytest.fixture(scope="module")
def xla_rounding(tmp_path_factory):
    """:func:`xla_rounding_results` as XLA compiles them by default (in this
    process) and held to the program's bf16 rounding
    (``--xla_allow_excess_precision=false``, in a child process)."""
    import os
    import subprocess
    import sys

    tmp = tmp_path_factory.mktemp("xla_rounding")
    code = ("import sys; import jax; jax.config.update('jax_platforms', 'cpu'); "
            f"sys.path.insert(0, {str(ROOT)!r}); import numpy as np; "
            "from tests.test_torch_trajectory import xla_rounding_results; "
            f"np.savez({str(tmp / 'held.npz')!r}, **xla_rounding_results())")
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "JAX_PLATFORMS": "cpu"}
    child = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    default = xla_rounding_results()
    port = port_rounding_results(tmp)
    _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-3000:]
    held = dict(np.load(tmp / "held.npz"))
    return default, held, port


def test_bf16_step_gradient_rounds_as_xla_compiles_it(xla_rounding):
    """Where XLA, as it compiles the JAX program by default, keeps a bf16
    value in float32 (its optimized HLO against the same program under
    ``--xla_allow_excess_precision=false``): the filter gradient of every
    conv and transposed conv (and the flow heads' sums,
    ``test_bf16_flows_round_as_xla_compiles_them``); the forward epilogue
    (conv, bias, leaky ReLU), the data gradients and the bias gradients
    round to bf16 in both (the held compilation rounds a bias gradient twice:
    its float32 sum, then again).

    One bf16 step of the held-out recipe from JAX's init (64x128, batch 2,
    D = 21): the whole gradient's relative L2 from JAX's step compiled by
    default and held, printed, with the two JAX steps' own gap. A bf16 net's
    step amplifies each conv's summation order through the next roundings
    (the port and JAX part by about 2e-2 whichever rules they follow; the two
    JAX compilations share XLA's convs and part by 4e-3), so the relative L2
    cannot tell the rules apart. The rounding shows in the gradient's values:
    the share of weight-gradient elements that are bfloat16 values is 1 in
    the held step and about a third in the default one (zeros and values of
    few bits); the port's lies within 0.02 of the default step's. Every
    bias-gradient element is a bfloat16 value in all three."""
    default, held, port = xla_rounding
    gaps = {"port to JAX default": _gap(port, default, "step/"),
            "port to JAX held": _gap(port, held, "step/"),
            "JAX held to JAX default": _gap(held, default, "step/")}
    print("gradient relative L2:", {k: f"{v:.3e}" for k, v in gaps.items()})
    shares = {}
    for suffix in ("weight", "bias"):
        shares[suffix] = {name: _bf16_share(r, "step/", suffix) for name, r in
                          (("JAX default", default), ("JAX held", held), ("port", port))}
        print(f"share of {suffix}-gradient elements that are bf16 values:", shares[suffix])
    weight, bias = shares["weight"], shares["bias"]
    assert weight["JAX held"] > 0.999 and weight["JAX default"] < 0.9
    assert abs(weight["port"] - weight["JAX default"]) < 0.02
    assert min(bias.values()) > 0.999
    assert max(gaps.values()) < 5e-2


def test_bf16_flows_round_as_xla_compiles_them(xla_rounding):
    """The flow heads' sum with the bias reaches the loss in float32 when XLA
    compiles the JAX program by default, rounded to bf16 when it is held to
    the program. The bf16 network's flows from JAX's init, with biases drawn
    away from zero, on the same frames:
    every element a bfloat16 value in the held compilation, few in the
    default one, and the port's share within 0.02 of the default one's; the
    relative L2 of each scale printed (the forward's own summation order
    parts the port from both by about 2e-3)."""
    default, held, port = xla_rounding
    for i in range(5):
        print(f"flow {i}: relative L2 port to JAX default {_gap(port, default, f'flows/{i}'):.3e}, "
              f"to JAX held {_gap(port, held, f'flows/{i}'):.3e}")
    shares = {name: _bf16_share(r, "flows/") for name, r in
              (("JAX default", default), ("JAX held", held), ("port", port))}
    print("share of flow elements that are bf16 values:", shares)
    assert shares["JAX held"] == 1.0
    assert shares["JAX default"] < 0.5
    assert abs(shares["port"] - shares["JAX default"]) < 0.02


def _window_means(rows, run, key="loss", window=50):
    values = np.array([r[run][key] for r in rows])
    return values.reshape(-1, window).mean(1)


def _aee_gaps(rows, run, ref):
    return np.array([abs(r[run]["heldout_aee"] - r[ref]["heldout_aee"]) / r[ref]["heldout_aee"]
                     for r in rows if "heldout_aee" in r[ref]])


# (run_side_by_side's arguments; the forced steps' median gap of the loss
# terms; their largest gap; the least share of parameter updates that agree;
# in float32 also the least share in a leaf and the largest gap of a leaf's
# Adam moments, as in the twelve-step test: over 250 steps the moments read
# up to 6.0e-3, where a leaf's gradient nearly cancels, against 1e-1 or more
# for a moment computed with another beta)
SLOW_CASES = {
    "off_f32": (dict(augment=False, dtype="float32"), 2e-5, 5e-3, 0.999, 0.99, 1e-2),
    "on_f32": (dict(augment=True, dtype="float32"), 2e-5, 5e-3, 0.999, 0.99, 1e-2),
    # bfloat16: the two packages round the towers at other points (the
    # whole gradient of one step lies 3.2% from float32's in the port and
    # 3.4% in JAX), so a forced step parts at that level; the leaves and
    # the moments are printed, not held
    "off_bf16": (dict(augment=False, dtype="bfloat16"), 5e-2, 2e-1, 0.5, None, None),
    "on_bf16": (dict(augment=True, dtype="bfloat16"), 5e-2, 2e-1, 0.5, None, None),
}


@pytest.mark.slow
@pytest.mark.parametrize("case", list(SLOW_CASES))
def test_250_steps_follow_jax(tmp_path, case):
    """250 steps at 64x128, batch 2, the recipe's correlation (D = 21) on a
    64-pair corpus (32 batches an epoch: the per-epoch reshuffle crosses 7
    epoch boundaries), the held-out AEE every 25 steps on 8 batches of 2.

    Held: every forced step (the port's step from the JAX state) within the
    case's gaps, and at least the case's share of the parameter updates
    within 1% of lr of the JAX step's; in float32 also each leaf's share and
    Adam's moments, as in the twelve-step test. In float32 the free-running
    port stays within its own spread: the largest gap to JAX of the loss
    averaged over 50-step windows, and of the held-out AEE, at most three
    times the largest gap between the port and its 4-thread twin, plus 1e-3.

    Printed, not held: the bfloat16 free runs. With the towers rounded as
    XLA compiles the JAX program by default (filter gradients and flow
    heads' sums in float32), the port's held-out AEE stays within 0.33% of
    JAX's at every point of the off arm and its loss within 0.13% in every
    window (one run); rounded as the program says, JAX's AEE fell to
    15.27-15.34 from step 50 while the port's stayed at 15.40-15.49.
    ROADMAP C2 records both."""
    kwargs, median_tol, max_tol, agreement, leaf_agreement, moment_tol = SLOW_CASES[case]
    rows = run_side_by_side(tmp_path, 250, max_displacement=20, n_pairs=64, eval_every=25,
                            forced=True, noise=True, **kwargs)
    _print_rows(rows, "free")
    _print_rows(rows, "forced", FORCED_KEYS)
    gaps = np.array([_forced_gaps(r) for r in rows])
    least = min(r["forced"]["update_agreement"] for r in rows)
    least_leaf = min(r["forced"]["leaf_agreement"] for r in rows)
    moment_gap = max(r["forced"]["moment_gap"] for r in rows)
    jax_w, free_w, noise_w = (_window_means(rows, run) for run in ("jax", "free", "noise"))
    loss_gap = np.abs(free_w - jax_w) / jax_w
    loss_spread = np.abs(noise_w - free_w) / free_w
    aee_gap, aee_spread = _aee_gaps(rows, "free", "jax"), _aee_gaps(rows, "noise", "free")
    print(f"forced steps: terms gap median {np.median(gaps[:, 0]):.3e} max {gaps[:, 0].max():.3e}; "
          f"grad_norm median {np.median(gaps[:, 1]):.3e} max {gaps[:, 1].max():.3e}; "
          f"update agreement least {least:.5f}, in a leaf {least_leaf:.5f}; "
          f"Adam's moments largest gap {moment_gap:.3e}")
    print("windows of 50 steps: loss jax", np.round(jax_w, 4), "port", np.round(free_w, 4),
          "gap", np.round((free_w - jax_w) / jax_w, 5), "port's spread", np.round(loss_spread, 5))
    print("held-out AEE gap to jax", np.round(aee_gap, 5), "port's spread", np.round(aee_spread, 5))
    assert np.median(gaps[:, 0]) < median_tol and gaps.max() < max_tol
    assert least > agreement
    if kwargs["dtype"] == "float32":
        assert least_leaf > leaf_agreement and moment_gap < moment_tol
        assert loss_gap.max() <= 3 * loss_spread.max() + 1e-3
        assert aee_gap.max() <= 3 * aee_spread.max() + 1e-3


def _port_bf16_curve(tmp_path, steps: int, flow_heads_f32: bool = False) -> list[float]:
    """The port alone on the off-arm geometry of the 250-step runs (bf16, no
    augmentation), its held-out AEE every 25 steps. ``flow_heads_f32`` runs
    the decoder's flow heads (``predict_flow*``, ``upflow*``) in float32 on
    bfloat16-rounded inputs and weights, their outputs unrounded: a
    diagnostic of where XLA's excess precision acts."""
    import types

    import torch.nn.functional as F

    from unflow_tpu_torch.ops.conv2d import conv2d_same

    def r(t):
        return t.to(torch.bfloat16).float()

    def head(self, x):
        return conv2d_same(r(x), r(self.weight), r(self.bias), self.stride[0])

    def uphead(self, x):
        return F.conv_transpose2d(r(x), r(self.weight), r(self.bias), stride=2, padding=1)

    h, w = 64, 128
    cfg, cfg_jax = recipe_configs(tmp_path, steps, dtype="bfloat16", augment=False,
                                  max_displacement=20)
    _, params = jax_init(cfg_jax, (h, w))
    trainer = Trainer(cfg, tmp_path / f"port_{flow_heads_f32}", itertools.repeat(None),
                      device="cpu", params=params_from_flax(jax.device_get(params)))
    if flow_heads_f32:
        for name, module in trainer.model.named_modules():
            if "predict_flow" in name:
                module.forward = types.MethodType(head, module)
            elif "upflow" in name:
                module.forward = types.MethodType(uphead, module)
    evaluate = heldout.make_eval_fn(heldout.heldout_set(2, h, w), "cpu")
    stream = corpus_iterator(2, h, w, n_pairs=64, seed=0, mode=heldout.DATA_MODE,
                             max_shift=heldout.MAX_SHIFT, dtype="uint8")
    curve = []
    for _ in range(steps):
        trainer.train_step(next(stream))
        if trainer.step % 25 == 0:
            curve.append(evaluate(trainer.model)["heldout_aee"])
    return curve


def jax_bf16_curve(tmp_path, steps: int, perturb: int | None = None) -> list[float]:
    """The JAX package alone on the same run: its held-out AEE every 25 steps
    (``perturb``: from the init perturbed as ``run_side_by_side`` says)."""
    rows = run_side_by_side(tmp_path, steps, augment=False, dtype="bfloat16", max_displacement=20,
                            n_pairs=64, eval_every=25, free=False, perturb=perturb)
    return [r["jax"]["heldout_aee"] for r in rows if "heldout_aee" in r["jax"]]


@pytest.mark.slow
def test_jax_bf16_dip_turns_on_a_perturbation(tmp_path):
    """The early dip of ``test_bf16_parting_follows_xla_excess_precision``
    is a property of the trajectory: JAX's default compilation from its init
    perturbed by 1e-6 (relative; draws 1 and 2) reads 15.3043 and 15.4236 at
    step 100, one dipping as the unperturbed run does (15.3055) and one not.
    Held: the two perturbed runs' last two points at least 0.05 apart."""
    curves = [jax_bf16_curve(tmp_path / f"draw{k}", 100, perturb=k) for k in (1, 2)]
    for k, curve in zip((1, 2), curves):
        print(f"held-out AEE at steps 25-100, jax default, init perturbed (draw {k}): "
              f"{[round(v, 4) for v in curve]}")
    assert abs(np.mean(curves[0][-2:]) - np.mean(curves[1][-2:])) > 0.05


@pytest.mark.slow
def test_bf16_parting_follows_xla_excess_precision(tmp_path):
    """Where the bfloat16 runs part (``test_250_steps_follow_jax[off_bf16]``):
    100 steps of the off arm, the held-out AEE every 25 steps, of the JAX
    package as XLA compiles it by default, of the JAX package with XLA held
    to the program's rounding (``--xla_allow_excess_precision=false``, in a
    child process), of the port, and of the port with its flow heads in
    float32 on bf16-rounded operands (a diagnostic). By default XLA keeps the
    filter gradients and the flow heads' sums in float32, and the port
    rounds as it does (``test_bf16_step_gradient_rounds_as_xla_compiles_it``):
    the default JAX curve falls below the held one, and the port's follows
    the default one (they read 15.3306 and 15.3355 over the last two points,
    the held one 15.4256). Held: the default JAX curve's last two points at
    least 0.05 under the held one's, and the port's within 0.05 of the
    default one's. The dip is a property of this trajectory, not of the
    rounding alone: JAX's default compilation from its init perturbed by 1e-6
    (relative, one numpy draw per leaf) dipped in one of two draws."""
    import json
    import os
    import subprocess
    import sys

    steps = 100
    default = jax_bf16_curve(tmp_path / "default", steps)
    code = ("import json, sys; import jax; jax.config.update('jax_platforms', 'cpu'); "
            f"sys.path.insert(0, {str(ROOT)!r}); "
            "from pathlib import Path; from tests.test_torch_trajectory import jax_bf16_curve; "
            f"print(json.dumps(jax_bf16_curve(Path({str(tmp_path / 'held')!r}), {steps})))")
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    held = json.loads(out.strip().splitlines()[-1])
    port = _port_bf16_curve(tmp_path, steps)
    heads = _port_bf16_curve(tmp_path, steps, flow_heads_f32=True)
    for name, curve in (("jax, XLA default", default), ("jax, XLA held to bf16", held),
                        ("port", port), ("port, flow heads in f32", heads)):
        print(f"held-out AEE at steps 25-{steps}, {name}: {[round(v, 4) for v in curve]}")
    assert np.mean(default[-2:]) < np.mean(held[-2:]) - 0.05
    assert abs(np.mean(port[-2:]) - np.mean(default[-2:])) < 0.05
