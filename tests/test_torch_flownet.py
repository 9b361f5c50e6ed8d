"""Port's FlowNetC, FlowNetS and stacked cascades against the JAX package's,
from converted JAX params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.models import FlowNetStack as FlowNetStackJax
from unflow_tpu.models import full_res_flow as full_res_flow_jax
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.models import build_model, full_res_flow, init_params
from unflow_tpu_torch.models.flownet import FlowNetStack

torch.set_num_threads(1)

HW = (64, 64)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX init and one f32 + one bf16 apply at 64x64, batch 2."""
    rng = np.random.RandomState(0)
    im1 = rng.randn(2, *HW, 3).astype(np.float32)
    im2 = rng.randn(2, *HW, 3).astype(np.float32)
    f32 = FlowNetStackJax(spec="C", compute_dtype=jnp.float32, corr_impl="jnp")
    bf16 = FlowNetStackJax(spec="C", compute_dtype=jnp.bfloat16, corr_impl="jnp")
    params = jax.jit(f32.init)(jax.random.PRNGKey(0), im1, im2)["params"]
    flows = {
        dtype: [np.asarray(f) for f in jax.jit(m.apply)({"params": params}, im1, im2)[0]]
        for dtype, m in (("float32", f32), ("bfloat16", bf16))
    }
    full = np.asarray(full_res_flow_jax([jnp.asarray(flows["float32"][0])], *HW))
    return {
        "im1": im1, "im2": im2, "flows": flows, "full": full,
        "params": jax.device_get(params),
    }


def _torch_flows(jax_run, dtype):
    cfg = Config()
    cfg.train.compute_dtype = dtype
    cfg.train.corr_impl = "jnp"  # a JAX config name: the plain version
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax_run["params"]))
    nchw = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in (jax_run["im1"], jax_run["im2"])]
    with torch.inference_mode():
        return model(*nchw)[0]


def test_flownet_c_f32_matches_jax(jax_run):
    flows = _torch_flows(jax_run, "float32")
    assert len(flows) == 5
    for got, want in zip(flows, jax_run["flows"]["float32"]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
        )
    full = full_res_flow(flows, *HW).permute(0, 2, 3, 1).numpy()
    want = jax_run["full"]
    np.testing.assert_allclose(full, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_flownet_c_bf16_matches_jax(jax_run):
    flows = _torch_flows(jax_run, "bfloat16")
    for got, want in zip(flows, jax_run["flows"]["bfloat16"]):
        got = got.permute(0, 2, 3, 1).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_converted_params_cover_the_model(jax_run):
    state = params_from_flax(jax_run["params"])
    model = build_model(Config(), "cpu")
    assert set(state) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert value.shape == state[key].shape, key


def test_random_init_follows_flax_lecun_normal(jax_run):
    model = build_model(Config(), "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    state = model.state_dict()
    for key in ("conv1", "conv6_1", "conv_redir", "decoder/deconv5", "decoder/predict_flow2"):
        path = key.split("/")
        want = jax_run["params"]["stage0_C"]
        for name in path:
            want = want[name]
        weight = state[".".join(["stage0_C", *path, "weight"])]
        assert abs(weight.std().item() / np.std(want["kernel"]) - 1) < 0.1, key
        assert not state[".".join(["stage0_C", *path, "bias"])].any()
    again = build_model(Config(), "cpu")
    init_params(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in state.items())


SPECS = ("S", "cS", "CS", "csS", "CSS")


@pytest.fixture(scope="module")
def stack_params():
    """flax params of the ``S`` stack and of the ``CSS`` stack (whose
    stage0_C and stage1_S also serve ``cS``, ``CS`` and ``csS``), at 64x64
    with max_displacement 4."""
    sample = np.zeros((1, *HW, 3), np.float32)
    params = {}
    for spec in ("S", "CSS"):
        model = FlowNetStackJax(spec=spec, max_displacement=4, corr_impl="jnp")
        params[spec] = jax.device_get(
            jax.jit(model.init)(jax.random.PRNGKey(2), sample, sample)["params"]
        )
    return params


def _spec_params(stack_params, spec):
    tree = stack_params["S" if spec == "S" else "CSS"]
    return {k: v for k, v in tree.items() if int(k[5]) < len(spec)}


def _stack_run(stack_params, spec, dtype):
    """The flax stack and the port's on one pair: lists of stage flows, NHWC
    numpy."""
    rng = np.random.RandomState(3)
    im1, im2 = (rng.randn(2, *HW, 3).astype(np.float32) for _ in range(2))
    params = _spec_params(stack_params, spec)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    model_jax = FlowNetStackJax(spec=spec, compute_dtype=jdt, max_displacement=4, corr_impl="jnp")
    want = jax.jit(model_jax.apply)({"params": params}, im1, im2)
    cfg = Config()
    cfg.train.flownet, cfg.train.compute_dtype = spec, dtype
    cfg.train.max_displacement, cfg.train.corr_impl = 4, "torch"
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_flax(params))
    nchw = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in (im1, im2)]
    with torch.inference_mode():
        got = model(*nchw)
    got = [[f.permute(0, 2, 3, 1).numpy() for f in stage] for stage in got]
    return got, [[np.asarray(f) for f in stage] for stage in want]


@pytest.mark.parametrize("spec", SPECS)
def test_stack_f32_matches_jax(stack_params, spec):
    got, want = _stack_run(stack_params, spec, "float32")
    assert len(got) == len(want) == len(spec)
    for stage_got, stage_want in zip(got, want):
        assert len(stage_got) == 5
        for g, w in zip(stage_got, stage_want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_stack_css_bf16_matches_jax(stack_params):
    """bf16 towers and glue: the JAX warp gathers from packed channels, the
    port's four taps weigh in bf16, so only the relative L2 is held."""
    got, want = _stack_run(stack_params, "CSS", "bfloat16")
    for stage_got, stage_want in zip(got, want):
        for g, w in zip(stage_got, stage_want):
            assert np.isfinite(g).all()
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2


@pytest.mark.parametrize("spec", SPECS)
def test_converted_params_cover_each_spec(stack_params, spec):
    state = params_from_flax(_spec_params(stack_params, spec))
    model = FlowNetStack(spec=spec, max_displacement=4)
    assert set(state) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert value.shape == state[key].shape, key


@pytest.mark.parametrize("spec", ["", "x", "SC", "cC", "CSC"])
def test_bad_specs_raise(spec):
    with pytest.raises(ValueError):
        FlowNetStack(spec=spec)


@pytest.mark.parametrize("spec", ["c", "cS", "csS", "Cs"])
def test_lowercase_stages_detach(spec):
    model = FlowNetStack(spec=spec, max_displacement=4)
    im = torch.randn(1, 3, 64, 64)
    stages = model(im, im)
    for ch, flows in zip(spec, stages):
        assert all(f.requires_grad == ch.isupper() for f in flows), spec
