"""The port's FLOP count (``unflow_tpu_torch/utils/flops.py``) against the JAX
package's ``matmul_flops`` of its traced train step: equal, FLOP for FLOP,
for C, S, cS, CSS with ``train_all`` and supervised S at 64x128, batch 2, and
for UnFlow-C as shipped (320x1152, batch 8, bf16); with ``remat`` (C, CSS
with ``train_all``) equal site for site, the recomputed forwards included;
linear in the batch; single ops counted as JAX counts them; and the peak
table."""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.config import load_config as load_config_jax
from unflow_tpu.train import TrainState as TrainStateJax
from unflow_tpu.train import build_model as build_model_jax
from unflow_tpu.train import build_optimizer as build_optimizer_jax
from unflow_tpu.train import make_train_step as make_train_step_jax
from unflow_tpu.utils import flops as flops_jax
from unflow_tpu_torch.config import Config, load_config
from unflow_tpu_torch.ops.conv2d import conv2d_same
from unflow_tpu_torch.utils.flops import (
    breakdown,
    matmul_flops,
    matmul_flops_by_site,
    peak_flops,
    peak_for_name,
    train_step_flops,
)

torch.set_num_threads(1)


def _sds(tree):
    return jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def jax_step_jaxpr(cfg):
    """The jaxpr of the JAX package's train step of ``cfg``, traced on
    shapes alone."""
    fn, args = _jax_step(cfg)
    return jax.make_jaxpr(fn)(*args).jaxpr


def _jax_step(cfg):
    """The JAX package's train step of ``cfg`` and its arguments as shapes."""
    t = cfg.train
    model = build_model_jax(cfg)
    sample = jnp.zeros((1, t.height, t.width, 3), jnp.float32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, sample)["params"]
    tx = build_optimizer_jax(cfg, params)
    state = TrainStateJax(jax.ShapeDtypeStruct((), jnp.int32), _sds(params),
                          _sds(jax.eval_shape(tx.init, params)))
    batch = {k: jax.ShapeDtypeStruct((t.batch_size, t.height, t.width, 3), jnp.float32)
             for k in ("im1", "im2")}
    if t.supervised:
        batch["flow"] = jax.ShapeDtypeStruct((t.batch_size, t.height, t.width, 2), jnp.float32)
    rng = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return make_train_step_jax(model, tx, cfg), (state, batch, rng)


def inside_pallas(jaxpr) -> int:
    """What ``unflow_tpu/utils/flops.py`` counts inside ``pallas_call``
    bodies: it walks into a kernel's jaxpr as into any other, once, not once
    per program of the grid."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            total += flops_jax._jaxpr_flops(eqn.params["jaxpr"])
        else:
            for sub in flops_jax._iter_subjaxprs(eqn.params):
                total += inside_pallas(sub)
    return total


def _configs(spec, **overrides):
    cfgs = Config(), ConfigJax()
    for cfg in cfgs:
        t = cfg.train
        t.flownet, t.height, t.width, t.batch_size = spec, 64, 128, 2
        t.compute_dtype = "float32"
        for key, value in overrides.items():
            setattr(t, key, value)
    # the plain correlation in JAX: no conv or dot, as the port's kernels
    cfgs[1].train.corr_impl = "jnp"
    return cfgs


STEPS = {
    "C": ("C", {}),
    "S": ("S", {}),
    "cS": ("cS", {}),  # frozen C: no backward through it in either package
    "CSS_train_all": ("CSS", {"train_all": True}),
    "supervised_S": ("S", {"supervised": True}),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_train_step_flops_equal_jax(case):
    spec, overrides = STEPS[case]
    cfg, cfg_jax = _configs(spec, **overrides)
    mine = train_step_flops(cfg, by_site=True)
    want = flops_jax._jaxpr_flops(jax_step_jaxpr(cfg_jax))
    assert sum(mine.values()) == want, sorted(mine.items(), key=lambda kv: -kv[1])[:12]


REMAT_STEPS = {"C_remat": ("C", {}), "CSS_train_all_remat": ("CSS", {"train_all": True})}


@pytest.mark.parametrize("case", list(REMAT_STEPS))
def test_remat_step_flops_equal_jax_site_for_site(case):
    """With ``remat`` each stage's forward runs again in the backward pass:
    fwd + refwd + the gradients, as JAX counts through ``jax.checkpoint``.
    Every conv site equal, key for key, the resizes as in
    ``test_breakdown_sites_equal_the_jax_scripts`` (two contractions a site in
    JAX, one site in the port), and the total."""
    spec, overrides = REMAT_STEPS[case]
    cfg, cfg_jax = _configs(spec, remat=True, **overrides)
    mine = train_step_flops(cfg, by_site=True)
    fn, args = _jax_step(cfg_jax)
    want = flops_jax.matmul_flops_by_site(fn, *args)
    convs = [{k: v for k, v in sites.items() if k.startswith("conv ")} for sites in (mine, want)]
    assert convs[0] == convs[1]
    rest = [sum(v for k, v in sites.items() if not k.startswith("conv ")) for sites in (mine, want)]
    assert rest[0] == rest[1]
    assert sum(mine.values()) == sum(want.values())


def test_shipped_unflow_c_step_flops_equal_jax():
    """configs/kitti_unsup_c.ini (320x1152, batch 8, bf16), with the JAX
    step's correlation as on the TPU (``pallas``, the MXU kernels in bf16):
    the JAX count is the port's plus what it counts inside the three Pallas
    kernels' bodies, one grid program of each."""
    cfg = load_config("configs/kitti_unsup_c.ini")
    cfg_jax = load_config_jax("configs/kitti_unsup_c.ini")
    cfg_jax.train.corr_impl = "pallas"
    jaxpr = jax_step_jaxpr(cfg_jax)
    mine = train_step_flops(cfg)
    kernels = inside_pallas(jaxpr)
    assert flops_jax._jaxpr_flops(jaxpr) == mine + kernels
    assert mine == 5_521_148_095_680
    assert kernels == 3_831_496_704  # 0.07% of the step


@pytest.mark.parametrize("spec", ["C", "cS"])
def test_breakdown_sites_equal_the_jax_scripts(spec):
    """``scripts/flops_breakdown.py``'s per-site count (its config: bf16, the
    native conv lowering; the plain correlation) against the port's
    ``breakdown`` at 64x128, batch 2: every conv site equal, key for key (the
    forward convs, the data gradients and the filter gradients of every
    layer, and the census patches), and the resizes' two contractions a site
    in JAX equal to the port's one resize site."""
    cfg_jax = ConfigJax()
    t = cfg_jax.train
    t.flownet, t.height, t.width, t.batch_size = spec, 64, 128, 2
    t.compute_dtype, t.conv_impl, t.corr_impl = "bfloat16", "native", "jnp"
    model = build_model_jax(cfg_jax)
    sample = jnp.zeros((1, 64, 128, 3), jnp.float32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample, sample)["params"]
    tx = build_optimizer_jax(cfg_jax, params)
    state = TrainStateJax(jax.ShapeDtypeStruct((), jnp.int32), _sds(params),
                          _sds(jax.eval_shape(tx.init, params)))
    batch = {k: jax.ShapeDtypeStruct((2, 64, 128, 3), jnp.float32) for k in ("im1", "im2")}
    want = flops_jax.matmul_flops_by_site(make_train_step_jax(model, tx, cfg_jax), state, batch,
                                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    mine = breakdown(spec, 64, 128, 2)
    convs = [{k: v for k, v in sites.items() if k.startswith("conv ")} for sites in (mine, want)]
    assert convs[0] == convs[1]
    rest = [sum(v for k, v in sites.items() if not k.startswith("conv ")) for sites in (mine, want)]
    assert rest[0] == rest[1]
    assert sum(mine.values()) == sum(want.values())


def test_train_step_flops_scale_with_batch():
    cfg, _ = _configs("S")
    f2 = train_step_flops(cfg)
    cfg.train.batch_size = 4
    assert train_step_flops(cfg) == 2 * f2 > 0


def test_conv_and_matmul_counts():
    x = torch.zeros(2, 16, 8, 8)
    w = torch.zeros(32, 16, 3, 3, requires_grad=True)
    # 2 MACs x output elements x fan-in, as tests/test_flops.py holds JAX's
    assert matmul_flops(conv2d_same, x, w, None) == 2 * (2 * 8 * 8 * 32) * (3 * 3 * 16)
    assert matmul_flops(lambda a: conv2d_same(a, w, None, 2), x) == 2 * (2 * 4 * 4 * 32) * 144
    a, b = torch.zeros(3, 5), torch.zeros(5, 7)
    assert matmul_flops(torch.mm, a, b) == 2 * 3 * 7 * 5
    assert matmul_flops(lambda v: torch.tanh(v) + v * 2, torch.zeros(128)) == 0
    # the filter gradient adds one conv-sized contraction (the data gradient
    # of an input that needs none is not computed)
    w1 = torch.zeros(8, 16, 1, 1, requires_grad=True)
    x1 = torch.zeros(1, 16, 4, 4)
    fwd = matmul_flops(lambda: F.conv2d(x1, w1))
    assert matmul_flops(lambda: (F.conv2d(x1, w1) ** 2).sum().backward()) == 2 * fwd
    sites = matmul_flops_by_site(lambda: (F.conv2d(x1, w1) ** 2).sum().backward())
    assert sorted(sites.values()) == [fwd, fwd]


def test_peak_flops_table():
    assert peak_for_name("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_for_name("NVIDIA H100 PCIe") == 756e12
    assert peak_for_name("NVIDIA H100 NVL") == 835e12
    assert peak_for_name("NVIDIA A100-SXM4-80GB") is None
    assert peak_for_name("Mystery Accelerator") is None
    assert peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert peak_flops() is None
