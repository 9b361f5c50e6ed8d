"""The port's diagnostic probes (``unflow_tpu_torch/probes/``) against the
JAX package's scripts they port, on the CPU at 64x128, batch 2, float32, from
one flax init: the loss landscape (``scripts/loss_landscape_probe.py``, every
loss 1e-5 relative), the one-batch overfit (``validate_convergence.py``: the
loss and AEE of each of 3 steps, 1e-4), the checkpoint autopsy
(``checkpoint_autopsy.py``: each pair's statistics, 1e-4 px), the
input-dependence probe (``input_dependence_probe.py``: 3 steps, 1e-4) and the
warm-start probe (``warmstart_probe.py``: each phase's config equal, the
zero-flow AEE 1e-6, two short phases run end to end).

And a finding about the JAX package's record ``benchmarks/loss_landscape.json``,
taken on a TPU: it is the landscape of the census of the grayscale rounded to
bfloat16 (the TPU's default precision computes
``conv_general_dilated_patches`` in one bfloat16 pass), which XLA:CPU, even
under ``jax.default_matmul_precision("bfloat16")``, does not do."""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unflow_tpu.augment import normalize as normalize_jax
from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.data.synthetic import batch_iterator as batch_iterator_jax
from unflow_tpu.losses import supervised_loss as supervised_loss_jax
from unflow_tpu.losses import unsupervised_loss as unsupervised_loss_jax
from unflow_tpu.models import FlowNetC as FlowNetCJax
from unflow_tpu.models import full_res_flow as full_res_flow_jax
from unflow_tpu.train import build_model as build_model_jax
from unflow_tpu.train.trainer import DEFAULT_NORMALIZATION as NORMALIZATION_JAX
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.probes import autopsy, convergence, input_dependence, landscape, warmstart
from unflow_tpu_torch.train import CheckpointManager, build_optimizer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W, BATCH = 64, 128, 2


def _script(name: str):
    """``scripts/<name>.py`` imported as a module (``scripts/`` on the path
    for the imports between them)."""
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("mode", landscape.MODES)
def test_landscape_matches_the_jax_probe(mode):
    """The loss at each ``alpha x GT`` of the script's pyramids, JAX's
    ``unsupervised_loss`` against the port's, and the summary's verdicts."""
    script = _script("loss_landscape_probe")
    b = next(batch_iterator_jax(BATCH, H, W, seed=777_000, supervised=True, max_shift=8.0,
                                mode=mode))
    pyr = script.gt_pyramid(jnp.asarray(b["flow"]))
    mine = landscape.gt_pyramid(_nchw(b["flow"]))
    for a, m in zip(pyr, mine):
        np.testing.assert_allclose(m.permute(0, 2, 3, 1).numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    im1, im2 = jnp.asarray(b["im1"]), jnp.asarray(b["im2"])
    for alpha in landscape.ALPHAS:
        want = float(unsupervised_loss_jax(im1, im2, [alpha * p for p in pyr],
                                           [-alpha * p for p in pyr])[0])
        got = landscape.loss_at(alpha, _nchw(b["im1"]), _nchw(b["im2"]), mine,
                                [-p for p in mine])
        assert got == pytest.approx(want, rel=1e-5), alpha
    out = landscape.probe((H, W), BATCH, device="cpu")
    assert set(out["modes"]) == set(landscape.MODES)
    row = out["modes"][mode]
    assert list(row["loss_at_alpha"]) == [str(a) for a in landscape.ALPHAS]
    curve = list(row["loss_at_alpha"].values())
    assert row["monotone_to_gt"] == all(curve[i] >= curve[i + 1] for i in range(4))


def test_tpu_landscape_record_is_the_census_of_bf16_grayscale(monkeypatch):
    """``benchmarks/loss_landscape.json`` (TPU) against JAX on this CPU at the
    record's geometry (128x256, batch 8, seed 777000): as compiled here, the
    loss sits 8.5 under the record at zero flow and 9.4 under it at the true
    flow; with the census patches' operand (the grayscale) rounded to
    bfloat16, every value of the record comes back within 0.003 (its
    rounding to 3 decimals, and f32 summation order)."""
    import unflow_tpu.losses.terms as terms_jax

    script = _script("loss_landscape_probe")
    record = json.loads((ROOT / "benchmarks" / "loss_landscape.json").read_text())

    def curves():
        loss = jax.jit(lambda a, im1, im2, fw, bw: unsupervised_loss_jax(
            im1, im2, [a * p for p in fw], [a * p for p in bw])[0])
        out = {}
        for mode in landscape.MODES:
            b = next(batch_iterator_jax(8, 128, 256, seed=777_000, supervised=True,
                                        max_shift=8.0, mode=mode))
            fw = script.gt_pyramid(jnp.asarray(b["flow"]))
            out[mode] = [float(loss(a, jnp.asarray(b["im1"]), jnp.asarray(b["im2"]), fw,
                                    [-p for p in fw])) for a in record["alphas"]]
        return out

    exact = curves()
    patches = terms_jax._extract_patches
    monkeypatch.setattr(terms_jax, "_extract_patches", lambda x, r: patches(
        x.astype(jnp.bfloat16).astype(jnp.float32), r))
    rounded = curves()
    for mode, row in record["modes"].items():
        tpu = list(row["loss_at_alpha"].values())
        print(mode, "TPU record", tpu, "CPU", np.round(exact[mode], 3).tolist(),
              "CPU, census of bf16 grayscale", np.round(rounded[mode], 3).tolist())
        np.testing.assert_allclose(rounded[mode], tpu, atol=3e-3)
        assert min(np.subtract(tpu, exact[mode])) > 5.0


def jax_overfit(unsup: bool, steps: int, lr: float, params):
    """``scripts/validate_convergence.py``'s loop at 64x128, batch 2, from
    ``params``: (zero-flow AEE, init AEE, [(loss, AEE) of each step])."""
    b = next(batch_iterator_jax(BATCH, H, W, seed=0, supervised=True))
    im1, im2, gt = (jnp.asarray(b[k]) for k in ("im1", "im2", "flow"))
    mean, std = NORMALIZATION_JAX
    n1, n2 = normalize_jax(im1, mean, std), normalize_jax(im2, mean, std)
    model = FlowNetCJax(compute_dtype=jnp.float32)
    tx = optax.adam(lr)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            flows_fw = model.apply({"params": p}, n1, n2)
            if unsup:
                return unsupervised_loss_jax(im1, im2, flows_fw,
                                             model.apply({"params": p}, n2, n1))[0]
            return supervised_loss_jax(flows_fw, gt)[0]

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    @jax.jit
    def aee(params):
        f = full_res_flow_jax(model.apply({"params": params}, n1, n2), H, W)
        return jnp.mean(jnp.linalg.norm(f - gt, axis=-1))

    zero, rows, start = float(jnp.mean(jnp.linalg.norm(gt, axis=-1))), [], float(aee(params))
    for _ in range(steps):
        params, opt, loss = step(params, opt)
        rows.append((float(loss), float(aee(params))))
    return zero, start, rows


@pytest.fixture(scope="module")
def flax_c():
    """FlowNetC's flax parameters from ``PRNGKey(0)`` at 64x128."""
    sample = jnp.zeros((1, H, W, 3), jnp.float32)
    return jax.device_get(jax.jit(FlowNetCJax().init)(jax.random.PRNGKey(0), sample,
                                                      sample)["params"])


@pytest.mark.parametrize("unsup", [False, True], ids=["supervised", "unsupervised"])
def test_convergence_follows_the_jax_overfit(flax_c, unsup):
    """Three steps of the one-batch overfit at lr 1e-3 (supervised) and 1e-4
    (unsupervised): the zero-flow and init AEE, each step's loss and AEE."""
    lr = 1e-4 if unsup else 1e-3
    zero, start, rows = jax_overfit(unsup, 3, lr, flax_c)
    out = convergence.overfit(unsup, 3, lr, (H, W), BATCH, "cpu", params_from_flax(flax_c),
                              report_every=1, corr_impl="torch")
    assert out["zero_flow_aee"] == pytest.approx(zero, rel=1e-6)
    assert out["init_aee"] == pytest.approx(start, rel=1e-5)
    for row, (loss, aee) in zip(out["curve"], rows):
        assert row["loss"] == pytest.approx(loss, rel=1e-4), row
        assert row["aee"] == pytest.approx(aee, rel=1e-4), row
    assert out["final_aee"] == out["curve"][-1]["aee"]
    assert out["ok"] == (out["final_aee"] < 0.5 * min(zero, out["init_aee"]))


def _flax_stack(spec="C"):
    """The JAX package's float32 stack of ``spec`` and its flax init."""
    cfg = ConfigJax()
    cfg.train.flownet = spec
    cfg.train.compute_dtype = "float32"
    model = build_model_jax(cfg)
    sample = jnp.zeros((1, H, W, 3), jnp.float32)
    return model, jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), sample,
                                                     sample)["params"])


def test_autopsy_matches_the_jax_autopsy(tmp_path):
    """A checkpoint of the flax init: each pair's predicted mean and spread,
    the AEE and the spread across pairs, as the script computes them from the
    same parameters (float32, as with ``--cpu``)."""
    model_jax, params = _flax_stack()
    cfg = Config()
    net = build_model(cfg, "cpu")
    net.load_state_dict(params_from_flax(params))
    CheckpointManager(tmp_path / "ex").save(7, net, build_optimizer(cfg, net))
    out = autopsy.autopsy(tmp_path / "ex", (H, W), BATCH, max_shift=8.0, device="cpu")
    assert out["step"] == 7 and len(out["pairs"]) == BATCH

    b = next(batch_iterator_jax(BATCH, H, W, seed=777_000, supervised=True, mode="affine",
                                max_shift=8.0))
    mean, std = NORMALIZATION_JAX
    stages = model_jax.apply({"params": params}, normalize_jax(jnp.asarray(b["im1"]), mean, std),
                             normalize_jax(jnp.asarray(b["im2"]), mean, std))
    flow = np.asarray(full_res_flow_jax(stages[-1], H, W))
    for pair, f, g in zip(out["pairs"], flow, b["flow"]):
        np.testing.assert_allclose(pair["pred_mean"], f.mean((0, 1)), atol=1e-4)
        np.testing.assert_allclose(pair["pred_std"], f.std((0, 1)), atol=1e-4)
        np.testing.assert_allclose(pair["gt_mean"], g.mean((0, 1)), atol=1e-6)
        assert pair["aee"] == pytest.approx(float(np.linalg.norm(f - g, axis=-1).mean()),
                                            rel=1e-5)
    spread = float(np.std(flow.mean((1, 2)), axis=0).mean())
    assert out["spread_of_pred_means"] == pytest.approx(spread, abs=1e-4)
    assert out["verdict"] == ("input-independent collapse" if spread < 0.25
                              else "input-dependent")


def test_input_dependence_follows_the_jax_probe():
    """Three supervised steps on two alternating fixed batches (seed 4242) at
    lr 1e-3 from one flax init: each step's loss, then the train and held-out
    AEE and the spread of the per-pair mean flow, against the script's loop."""
    model_jax, params = _flax_stack()
    mean, std = NORMALIZATION_JAX

    def batches(seed, n):
        it = batch_iterator_jax(BATCH, H, W, seed=seed, supervised=True, mode="affine",
                                max_shift=8.0)
        return [tuple(jnp.asarray(b[k]) for k in ("im1", "im2", "flow"))
                for b in (next(it) for _ in range(n))]

    train, held = batches(4242, 2), batches(777_000, 2)
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, im1, im2, gt):
        def loss_fn(p):
            stages = model_jax.apply({"params": p}, normalize_jax(im1, mean, std),
                                     normalize_jax(im2, mean, std))
            return supervised_loss_jax(stages[-1], gt)[0]

        loss, g = jax.value_and_grad(loss_fn)(params)
        up, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, up), opt, loss

    def stats(params, bs):
        aees, spreads = [], []
        for im1, im2, gt in bs:
            stages = model_jax.apply({"params": params}, normalize_jax(im1, mean, std),
                                     normalize_jax(im2, mean, std))
            flow = np.asarray(full_res_flow_jax(stages[-1], H, W))
            spreads.append(flow.mean(axis=(1, 2)).std(axis=0).mean())
            aees.append(np.mean(np.linalg.norm(flow - np.asarray(gt), axis=-1)))
        return float(np.mean(aees)), float(np.mean(spreads))

    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, *train[i % 2])
        losses.append(float(loss))
    out = input_dependence.probe(3, 3, (H, W), BATCH, 2, 1e-3, device="cpu",
                                 params=params_from_flax(_flax_stack()[1]), corr_impl="torch")
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
    final = out["final"]
    aee, spread = stats(params, train)
    assert final["train_aee"] == pytest.approx(aee, rel=1e-4)
    assert final["spread_px"] == pytest.approx(spread, rel=1e-3, abs=1e-4)
    assert final["heldout_aee"] == pytest.approx(stats(params, held)[0], rel=1e-4)
    assert out["reports"][0]["step"] == 3


def _warmstart_args(tmp_path, **overrides):
    argv = ["--sup-steps", "2", "--unsup-steps", "2", "--eval-every", "1", "--hw", str(H),
            str(W), "--batch", str(BATCH), "--dtype", "float32", "--no-photometric",
            "--no-hflip", "--exp-root", str(tmp_path / "ws"), "--device", "cpu"]
    args = warmstart.parse_args(argv)
    vars(args).update(overrides)
    return args


def test_warmstart_phases_are_the_scripts(tmp_path, monkeypatch):
    """Each phase's config, field by field, as the script's ``run_phase``
    builds it (its ``Trainer`` stubbed to record the config), the held-out
    zero-flow AEE as its ``make_eval_fn`` gives it; and both phases run end to
    end on the CPU, phase B starting from phase A's parameters."""
    import unflow_tpu.train as train_jax

    script = _script("warmstart_probe")
    seen = []

    class Recorder:
        def __init__(self, cfg, exp, it, **kwargs):
            seen.append((cfg, kwargs.get("finetune_dirs")))
            (Path(exp) / "metrics.jsonl").write_text("")
            self.ckpt = argparse.Namespace(close=lambda: None)

        def run(self):
            pass

    monkeypatch.setattr(train_jax, "Trainer", Recorder)
    args = _warmstart_args(tmp_path)
    jax_args = argparse.Namespace(**{**vars(args), "corpus": 0})
    for supervised, lr in ((True, 1e-4), (False, 2e-4)):
        result, _ = script.run_phase("p", supervised, 3, 1, jax_args, tmp_path / "jax", lr)
        want = seen[-1][0].train
        mine = warmstart.phase_cfg(args, supervised, 3, 1, lr).train
        for key in vars(mine):
            if hasattr(want, key):
                assert getattr(mine, key) == getattr(want, key), key
        held = warmstart.heldout_batches(args)
        from unflow_tpu_torch import heldout

        assert heldout.zero_flow_aee(held) == pytest.approx(result["zero_flow_aee"], abs=1e-4)

    out = warmstart.probe(args, "cpu")
    assert [c["step"] for c in out["supervised"]["curve"]] == [1, 2]
    assert [c["step"] for c in out["unsupervised_continuation"]["curve"]] == [1, 2]
    assert out["zero_flow_aee"] == out["supervised"]["zero_flow_aee"]
    sup = torch.load(tmp_path / "ws" / "sup" / "checkpoints" / "2.pt", weights_only=True)
    cont = CheckpointManager(tmp_path / "ws" / "unsup_cont")
    assert cont.steps() == [2]
    # phase B started from phase A: its parameters moved from A's by 2 steps
    # of lr 1e-4, not from a fresh init
    b = cont.load()["model"]
    gap = max(float((b[k] - sup["model"][k]).abs().max()) for k in b)
    assert gap <= 2.5e-4
