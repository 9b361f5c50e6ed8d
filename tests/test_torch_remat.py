"""Per-stage rematerialization (``remat``) of the port
(``unflow_tpu_torch/models/flownet.py::FlowNetStack``), on the CPU at
64x128, batch 2, ``max_displacement`` 4, float32 unless named:

* the port's train step with ``remat`` against the same step without it,
  for S, C, cS and CSS with ``train_all``, and C in bfloat16 too (the
  recompute goes through the same bf16 rounding sites as the forward): the
  same ``state_dict`` keys, and the logged terms, the loss and every
  gradient bit for bit (the recompute runs the same ops on the same inputs,
  and the backward is the same graph);
* the port's stack with ``remat`` against the JAX package's
  ``FlowNetStack(remat=True)`` from the same flax init (``params_from_flax``)
  for S and CS, on ``tests/test_models.py``'s loss (the sum of the squared
  flows of every stage and scale), with each package's remat gradients
  equal to its own plain ones;
* one W-sharded ``cli.train`` step with ``remat`` on a 1x2 gloo grid against
  one process without it.
"""

import itertools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_spatial import (
    STEP_TOLERANCE,
    _collect,
    _experiment,
    _launch,
    _read_run,
    _rel_l2,
)
from unflow_tpu.models import FlowNetStack as FlowNetStackJax
from unflow_tpu_torch.cli import train as cli_train
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data.io import write_image
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.models import FlowNetStack, build_model, init_params
from unflow_tpu_torch.train import Trainer

torch.set_num_threads(1)

H, W, BATCH = 64, 128, 2
SHARED = dict(
    batch_size=BATCH, height=H, width=W, compute_dtype="float32", max_displacement=4,
    corr_stride=2, corr_impl="torch", aug_photometric=False, aug_hflip=False,
    image_summary_interval=-1, display_interval=1, num_iters=1,
)
STACKS = {"S": ("S", {}), "C": ("C", {}), "cS": ("cS", {}),
          "CSS_train_all": ("CSS", {"train_all": True})}


def _step(tmp_path, spec, remat, params=None, **overrides):
    """One train step of ``spec`` from ``params`` (None: the seed-1 init):
    (logs, gradients by parameter, the initial parameters, the model's
    ``state_dict`` keys)."""
    cfg = Config()
    cfg.dirs.log = str(tmp_path / "log")
    for key, value in {**SHARED, "flownet": spec, "remat": remat, **overrides}.items():
        setattr(cfg.train, key, value)
    if params is None:
        net = build_model(cfg, "cpu")
        init_params(net, torch.Generator().manual_seed(1))
        params = {k: v.clone() for k, v in net.state_dict().items()}
    batch = next(batch_iterator(BATCH, H, W, seed=0, max_shift=3.0))
    trainer = Trainer(cfg, tmp_path / f"ex_{remat}", itertools.repeat(batch), device="cpu",
                      params=params)
    assert trainer.model.remat is remat
    logs = {k: float(v) for k, v in trainer.train_step(batch).items()}
    grads = {k: p.grad for k, p in trainer.model.named_parameters() if p.grad is not None}
    return logs, grads, params, list(trainer.model.state_dict())


STEP_CASES = [pytest.param(case, "float32", id=case) for case in STACKS] + [
    pytest.param("C", "bfloat16", id="C-bf16")]


@pytest.mark.parametrize("case, dtype", STEP_CASES)
def test_remat_step_equals_plain_step(tmp_path, case, dtype):
    spec, overrides = STACKS[case]
    overrides = {**overrides, "compute_dtype": dtype}
    logs, grads, params, keys = _step(tmp_path, spec, False, **overrides)
    logs_r, grads_r, _, keys_r = _step(tmp_path, spec, True, params, **overrides)
    assert keys_r == keys
    assert logs_r == logs
    assert list(grads_r) == list(grads)
    for name, g in grads.items():
        assert torch.equal(grads_r[name], g), name
    # a frozen stage takes no gradient, with remat as without
    frozen = tuple(f"stage{i}_" for i, ch in enumerate(spec) if ch.islower())
    assert grads and not any(name.startswith(frozen) for name in grads)


def test_remat_leaves_no_grad_forwards_alone():
    """Under ``torch.no_grad`` (eval, serving) a remat stack runs no
    checkpoint: the same flows, and nothing kept for a backward."""
    plain = FlowNetStack("CS", max_displacement=4, corr_impl="torch")
    init_params(plain, torch.Generator().manual_seed(2))
    remat = FlowNetStack("CS", max_displacement=4, corr_impl="torch", remat=True)
    remat.load_state_dict(plain.state_dict())
    gen = torch.Generator().manual_seed(3)
    im1, im2 = (torch.rand(BATCH, 3, H, W, generator=gen) for _ in range(2))
    with torch.no_grad():
        want, got = plain(im1, im2), remat(im1, im2)
    for stage_w, stage_g in zip(want, got):
        for w, g in zip(stage_w, stage_g):
            assert torch.equal(g, w)
            assert g.grad_fn is None


def _flow_loss_jax(model, im1, im2):
    def fn(params):
        stages = model.apply({"params": params}, im1, im2, pair_flipped_im2=False)
        return sum(jnp.sum(jnp.square(f)) for st in stages for f in st)
    return fn


# The port against JAX, both with remat. The loss holds to
# tests/test_models.py's rtol 1e-6. The gradients hold, leaf by leaf, to the
# gap between the two packages' plain steps, which remat leaves as it is (each
# package's remat gradients are its plain ones bit for bit, asserted here):
# FlowNetS's float32 summation orders part by 3.5e-6
# relative L2 at most (stage0_S.conv6); in CS the cascade's warp passes the
# stage-1 gradient to the flow of stage 0 through bilinear taps whose weights
# jump where a sample crosses a pixel, and flows that agree to 4e-6 of their
# largest value put a few samples on the other side: 2.3e-3
# (stage0_C.decoder.predict_flow6), with remat and without.
JAX_CASES = {"S": 1e-5, "CS": 5e-3}


@pytest.mark.parametrize("spec", list(JAX_CASES))
def test_remat_stack_matches_jax_remat(spec):
    rng = np.random.RandomState(3)
    im1 = rng.rand(BATCH, H, W, 3).astype(np.float32)
    im2 = rng.rand(BATCH, H, W, 3).astype(np.float32)
    kw = dict(spec=spec, compute_dtype=jnp.float32, corr_impl="jnp", max_displacement=4)
    model = FlowNetStackJax(remat=True, **kw)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), im1, im2)["params"]
    loss_jax, grads_jax = jax.jit(jax.value_and_grad(_flow_loss_jax(model, im1, im2)))(params)
    _, grads_plain = jax.jit(jax.value_and_grad(
        _flow_loss_jax(FlowNetStackJax(**kw), im1, im2)))(params)
    for a, b in zip(jax.tree_util.tree_leaves(grads_plain), jax.tree_util.tree_leaves(grads_jax)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    want = params_from_flax(jax.device_get(grads_jax))

    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in (im1, im2))
    grads = {}
    for remat in (True, False):
        net = FlowNetStack(spec, max_displacement=4, corr_impl="torch", remat=remat)
        net = net.to(memory_format=torch.channels_last)
        net.load_state_dict(params_from_flax(jax.device_get(params)))
        loss = sum(torch.sum(torch.square(f)) for st in net(a, b) for f in st)
        loss.backward()
        grads[remat] = {k: p.grad for k, p in net.named_parameters()}
        if remat:
            assert loss.item() == pytest.approx(float(loss_jax), rel=1e-6)
    assert set(grads[True]) == set(want)
    for name, w in want.items():
        assert torch.equal(grads[True][name], grads[False][name]), name
        gap = float(torch.linalg.vector_norm(grads[True][name] - w) / torch.linalg.vector_norm(w))
        assert gap <= JAX_CASES[spec], (name, gap)


def test_w_sharded_remat_step_matches_one_process(tmp_path):
    """``cli.train`` one step of UnFlow-C with ``remat`` on 2 spatial gloo
    ranks: the recompute in the backward pass re-issues the forward's halo
    exchanges, in one order on every rank. Held against one process without
    remat from the same seed at ``tests/test_torch_spatial.py``'s tolerance
    for this step (loss 1e-5 relative, the gradient's relative L2 through
    Adam's first moment 1e-5)."""
    drive = "2011_09_26_drive_0001_sync"
    frames = tmp_path / "data" / "kitti_raw" / drive / "image_02" / "data"
    frames.mkdir(parents=True)
    coarse = torch.rand(1, 3, H // 8 + 3, W // 8 + 4, generator=torch.Generator().manual_seed(0))
    tex = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")[0]
    tex = tex.permute(1, 2, 0).numpy()
    for f in range(4):
        write_image(frames / f"{f:010d}.png", tex[f : f + H, 2 * f : 2 * f + W])

    _experiment(tmp_path, "sharded_remat", "off", 2, {"remat": True}, None)
    proc = _launch(tmp_path, 2, [{"kind": "train", "argv": ["--ex", "sharded_remat",
                                                            "--device", "cpu"]}])
    _experiment(tmp_path, "one_plain", "off", 1, {}, None)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli_train.main(["--ex", "one_plain", "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    assert _collect(*proc, 2) == [[0], [0]]
    ref, ref_m = _read_run(tmp_path / "log" / "ex" / "one_plain", "C")
    got, got_m = _read_run(tmp_path / "log" / "ex" / "sharded_remat", "C")
    tol = STEP_TOLERANCE["off"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=tol)
    assert _rel_l2(got_m, ref_m) < tol
    shutil.rmtree(tmp_path / "log")
