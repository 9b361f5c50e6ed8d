"""The port's correlation gradients against the JAX package's: ``jax.grad`` of
the plain jnp version, the Pallas kernels B2/B3 (f32) and B5/B6 (bf16 MXU)
in interpret mode, and the autograd Function on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.correlation import correlation_jnp
from unflow_tpu.ops.pallas.correlation import _corr_bwd_f1_impl, _corr_bwd_f2_impl, _mxu_ok
from unflow_tpu_torch.ops.correlation import (
    correlation_bwd_f1_torch,
    correlation_bwd_f2_torch,
    correlation_torch,
    displacement_count,
)
from unflow_tpu_torch.ops.cuda.correlation import (
    CorrelationFunction,
    correlation_bwd_f1,
    correlation_bwd_f2,
    launch_counts,
)

torch.set_num_threads(1)

# the shapes of tests/test_ops_correlation.py: stride 2, stride 1, and a width
# that divides no tile; H < D in the last two
SHAPES = [((2, 8, 12, 6), 4, 2), ((2, 8, 12, 6), 3, 1), ((1, 8, 72, 4), 4, 2), ((1, 4, 9, 3), 4, 1)]


def _inputs(shape, max_disp, stride, seed=0):
    rng = np.random.RandomState(seed)
    d = displacement_count(max_disp, stride)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape[:3], d * d).astype(np.float32)
    return f1, f2, g


@pytest.mark.parametrize("shape,max_disp,stride", SHAPES)
def test_plain_gradients_match_jax_grad(shape, max_disp, stride):
    f1, f2, g = _inputs(shape, max_disp, stride)
    want1, want2 = jax.grad(
        lambda a, b: jnp.sum(correlation_jnp(a, b, max_disp, stride) * g), argnums=(0, 1)
    )(jnp.asarray(f1), jnp.asarray(f2))
    got1 = correlation_bwd_f1_torch(torch.from_numpy(g), torch.from_numpy(f2), max_disp, stride)
    got2 = correlation_bwd_f2_torch(torch.from_numpy(g), torch.from_numpy(f1), max_disp, stride)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "shape,max_disp,stride", [((1, 8, 8, 4), 4, 2), ((1, 8, 72, 4), 4, 2), ((1, 8, 16, 8), 3, 1)]
)
def test_plain_gradients_match_pallas_f32_kernels(shape, max_disp, stride):
    # B2, B3: ops/pallas/correlation.py::_corr_bwd_f1_chunk / _corr_bwd_f2_chunk
    # through their wrappers, interpret mode on CPU.
    f1, f2, g = _inputs(shape, max_disp, stride, seed=1)
    assert not _mxu_ok(jnp.float32, shape[1], shape[2], max_disp, stride, shape[3])
    want1 = np.asarray(_corr_bwd_f1_impl(jnp.asarray(g), jnp.asarray(f2), max_disp, stride))
    want2 = np.asarray(_corr_bwd_f2_impl(jnp.asarray(g), jnp.asarray(f1), max_disp, stride))
    got1 = correlation_bwd_f1_torch(torch.from_numpy(g), torch.from_numpy(f2), max_disp, stride)
    got2 = correlation_bwd_f2_torch(torch.from_numpy(g), torch.from_numpy(f1), max_disp, stride)
    np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,max_disp,stride", [((1, 8, 16, 128), 4, 2), ((1, 8, 16, 128), 4, 1)])
def test_plain_gradients_match_pallas_bf16_mxu_kernels(shape, max_disp, stride):
    # B5, B6: ops/pallas/correlation_mxu.py::corr_bwd_f1_mxu / corr_bwd_f2_mxu.
    # Their gate needs 128-multiple channel chunks, so C=128 (at C=8 a bf16
    # input takes the f32-path kernels).
    assert _mxu_ok(jnp.bfloat16, shape[1], shape[2], max_disp, stride, shape[3])
    f1, f2, g = _inputs(shape, max_disp, stride, seed=2)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    want1 = np.asarray(_corr_bwd_f1_impl(bf(g), bf(f2), max_disp, stride).astype(jnp.float32))
    want2 = np.asarray(_corr_bwd_f2_impl(bf(g), bf(f1), max_disp, stride).astype(jnp.float32))
    tb = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    got1 = correlation_bwd_f1_torch(tb(g), tb(f2), max_disp, stride)
    got2 = correlation_bwd_f2_torch(tb(g), tb(f1), max_disp, stride)
    assert got1.dtype == got2.dtype == torch.bfloat16
    for got, want in ((got1, want1), (got2, want2)):
        assert np.abs(got.float().numpy() - want).max() / np.abs(want).max() < 0.02


def test_plain_gradients_sum_bf16_in_f32():
    f1, f2, g = _inputs((1, 4, 6, 16), 2, 1, seed=3)
    g16, f16 = torch.from_numpy(g).bfloat16(), torch.from_numpy(f2).bfloat16()
    for fn in (correlation_bwd_f1_torch, correlation_bwd_f2_torch):
        assert torch.equal(fn(g16, f16, 2, 1), fn(g16.float(), f16.float(), 2, 1).bfloat16())


def _projected_grads(fn, f1, f2, proj, inputs):
    """Gradients of sum(volume_nchw * proj): the cotangent reaches ``fn`` as a
    permuted, non-contiguous view."""
    volume = fn(f1, f2).permute(0, 3, 1, 2)
    return torch.autograd.grad((volume * proj).sum(), inputs)


@pytest.mark.parametrize("shape,max_disp,stride", SHAPES[:3])
def test_function_on_cpu_matches_autograd(shape, max_disp, stride):
    a, b, g = _inputs(shape, max_disp, stride, seed=4)
    f1 = torch.from_numpy(a).requires_grad_()
    f2 = torch.from_numpy(b).requires_grad_()
    proj = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous()
    before = launch_counts()
    got = _projected_grads(
        lambda x, y: CorrelationFunction.apply(x, y, max_disp, stride), f1, f2, proj, (f1, f2)
    )
    want = _projected_grads(
        lambda x, y: correlation_torch(x, y, max_disp, stride), f1, f2, proj, (f1, f2)
    )
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    assert launch_counts() == before  # CPU tensors: no kernel ran


@pytest.mark.parametrize("which", [0, 1])
def test_function_computes_only_the_gradient_asked_for(which, monkeypatch):
    from unflow_tpu_torch.ops.cuda import correlation as wrappers

    a, b, g = _inputs((1, 6, 10, 4), 2, 1, seed=5)
    maps = [torch.from_numpy(a), torch.from_numpy(b)]
    maps[which].requires_grad_()
    called = []
    for name in ("correlation_bwd_f1", "correlation_bwd_f2"):
        fn = getattr(wrappers, name)
        monkeypatch.setattr(
            wrappers, name, lambda *args, _fn=fn, _n=name: (called.append(_n), _fn(*args))[1]
        )
    proj = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous()
    (got,) = _projected_grads(
        lambda x, y: CorrelationFunction.apply(x, y, 2, 1), *maps, proj, (maps[which],)
    )
    (want,) = _projected_grads(
        lambda x, y: correlation_torch(x, y, 2, 1), *maps, proj, (maps[which],)
    )
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert called == [("correlation_bwd_f1", "correlation_bwd_f2")[which]]


def test_gradient_wrappers_check_the_cotangent():
    f = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="divisible"):
        correlation_bwd_f1(torch.zeros(1, 4, 4, 9), f, 3, 2)
    with pytest.raises(ValueError, match="does not fit"):
        correlation_bwd_f2(torch.zeros(1, 4, 4, 8), f, 2, 2)


def test_df2_hands_tensors_off_the_cpu_to_the_launch(monkeypatch):
    # as the forward's test: meta tensors stand in for CUDA tensors
    from unflow_tpu_torch.ops.cuda import correlation as wrappers

    seen = []
    monkeypatch.setattr(
        wrappers, "_launch", lambda op, a, b, channels, p, s, kernel=None: seen.append(
            (op, channels, wrappers.kernel_name(op, b.dtype, b.shape[3], p, s), kernel)
        )
    )
    for c in (128, 8):
        f = torch.empty((1, 4, 8, c), dtype=torch.bfloat16, device="meta")
        g = torch.empty((1, 4, 8, 441), dtype=torch.bfloat16, device="meta")
        correlation_bwd_f2(g, f, 20, 2)
        correlation_bwd_f1(g, f, 20, 2)
    correlation_bwd_f2(g.float(), f.float(), 20, 2)
    assert seen == [
        ("bwd_f2", 128, "corr_bwd_f2_bf16", None),
        ("bwd_f1", 128, "corr_bwd_f1_bf16", None),
        ("bwd_f2", 8, "corr_bwd_f2_bf16_simt", None),
        ("bwd_f1", 8, "corr_bwd_f1_bf16_simt", None),
        ("bwd_f2", 8, "corr_bwd_f2_f32", None),
    ]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_goes_through_the_dispatch(dtype, monkeypatch):
    """CorrelationFunction on tensors off the CPU reaches _launch once for the
    forward and once per gradient, with no kernel forced."""
    from unflow_tpu_torch.ops.cuda import correlation as wrappers

    seen = []

    def fake_launch(op, a, b, channels, p, s, kernel=None):
        seen.append((wrappers.kernel_name(op, b.dtype, b.shape[3], p, s), kernel))
        return torch.empty((*b.shape[:3], channels), dtype=b.dtype, device=b.device)

    monkeypatch.setattr(wrappers, "_launch", fake_launch)
    f1 = torch.empty((1, 4, 8, 32), dtype=dtype, device="meta", requires_grad=True)
    f2 = torch.empty((1, 4, 8, 32), dtype=dtype, device="meta", requires_grad=True)
    CorrelationFunction.apply(f1, f2, 20, 2).sum().backward()
    suffix = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    assert seen == [(f"corr_{op}_{suffix}", None) for op in ("fwd", "bwd_f1", "bwd_f2")]


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"), (torch.bfloat16, "bf16_simt")])
@pytest.mark.parametrize("op", ["bwd_f1", "bwd_f2"])
@pytest.mark.parametrize(
    "shape,max_disp,stride",
    [((32768, 1, 1, 72), 2, 1),  # batch x 64-channel slices past the grid's 65535
     ((1, 4096, 1190, 1), 20, 2),  # the cotangent's offsets past an int
     ((1, 2**16, 2**15, 1), 2, 1)],  # the map's offsets past an int
)
def test_gradient_wrappers_refuse_what_the_fp32_core_kernels_do_not_take(
    shape, max_disp, stride, op, dtype, suffix
):
    # meta tensors stand in for CUDA tensors: the check comes before any launch
    d = displacement_count(max_disp, stride)
    f = torch.empty(shape, dtype=dtype, device="meta")
    g = torch.empty((*shape[:3], d * d), dtype=dtype, device="meta")
    fn = correlation_bwd_f1 if op == "bwd_f1" else correlation_bwd_f2
    with pytest.raises(ValueError, match=f"corr_{op}_{suffix}: no launch grid"):
        fn(g, f, max_disp, stride)
