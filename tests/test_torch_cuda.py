"""The port's nine CUDA kernels and the autograd Function over them against
their plain versions, on the card.

Marked ``cuda``; each skips without an NVIDIA GPU. The file imports no JAX,
so it also runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from unflow_tpu_torch.ops.correlation import (
    correlation,
    correlation_bwd_f1_torch,
    correlation_bwd_f2_torch,
    correlation_torch,
    displacement_count,
)
from unflow_tpu_torch.ops.cuda.correlation import (
    correlation_bwd_f1,
    correlation_bwd_f2,
    correlation_fwd,
    kernel_name,
    launch_counts,
)

# narrow and wide maps; a width that divides no tile with stride 1 and H < D;
# a displacement grid (D = 45) wider than the forward's 21-column blocks;
# stride 4 (D = 11), which every FP32-core kernel serves with its run-time
# stride. In bf16 the tensor-core kernels take D = 21 with C a multiple of 16:
# C = 16 below a tile, C = 64 across three column tiles with P = 20, C = 128
# with stride 1 and a width that divides no tile. The others (C = 8, C = 24,
# D = 5, 11 or 45) take the FP32-core kernels (*_simt); so do C = 5 (staged
# by plain loads) and H = 3 with W = 9 (below one block of the FP32-core
# kernels)
GEOMETRIES = [
    ((2, 8, 40, 16), 4, 2), ((1, 9, 75, 24), 5, 1), ((1, 6, 20, 8), 44, 2),
    ((1, 8, 70, 32), 20, 4), ((2, 9, 150, 256), 20, 4),
    ((2, 8, 40, 16), 20, 2), ((1, 7, 150, 64), 20, 2), ((2, 5, 75, 128), 10, 1),
    ((2, 6, 20, 5), 4, 2), ((1, 3, 9, 8), 4, 1),
]
DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 0.02)]


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _assert_close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape,max_disp,stride", GEOMETRIES)
def test_cuda_kernel_matches_plain(cuda_device, shape, max_disp, stride, dtype, tol):
    a, b = _pair(shape, seed=4)
    f1 = torch.from_numpy(a).to(cuda_device, dtype)
    f2 = torch.from_numpy(b).to(cuda_device, dtype)
    name = kernel_name("fwd", dtype, shape[3], max_disp, stride)
    before = launch_counts()
    with torch.inference_mode():
        got = correlation_fwd(f1, f2, max_disp, stride)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before[name] + 1
    assert sum(launch_counts().values()) == sum(before.values()) + 1
    _assert_close(got, correlation_torch(f1, f2, max_disp, stride), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape,max_disp,stride", GEOMETRIES)
@pytest.mark.parametrize(
    "op,kernel,plain",
    [("bwd_f1", correlation_bwd_f1, correlation_bwd_f1_torch),
     ("bwd_f2", correlation_bwd_f2, correlation_bwd_f2_torch)],
)
def test_cuda_gradient_kernel_matches_plain(
    cuda_device, op, kernel, plain, shape, max_disp, stride, dtype, tol
):
    d = displacement_count(max_disp, stride)
    rng = np.random.RandomState(5)
    f = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda_device, dtype)
    g = torch.from_numpy(rng.randn(*shape[:3], d * d).astype(np.float32)).to(cuda_device, dtype)
    name = kernel_name(op, dtype, shape[3], max_disp, stride)
    before = launch_counts()[name]
    got = kernel(g, f, max_disp, stride)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    assert got.dtype == dtype and got.shape == f.shape
    _assert_close(got, plain(g, f, max_disp, stride), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
def test_cuda_function_matches_autograd(cuda_device, dtype, tol, needs):
    """Gradients through the Function (kernels) against autograd through the
    plain version, with a non-contiguous cotangent; only the gradients that
    are asked for are launched."""
    shape, max_disp, stride = (2, 9, 40, 16), 4, 2
    d = displacement_count(max_disp, stride)
    a, b = _pair(shape, seed=6)
    maps = [torch.from_numpy(x).to(cuda_device, dtype).requires_grad_(n) for x, n in zip((a, b), needs)]
    wanted = [m for m in maps if m.requires_grad]
    proj = torch.from_numpy(
        np.random.RandomState(7).randn(shape[0], d * d, *shape[1:3]).astype(np.float32)
    ).to(cuda_device, dtype)

    def grads(impl):
        volume = correlation(*maps, max_disp, stride, impl=impl).permute(0, 3, 1, 2)
        return torch.autograd.grad((volume * proj).sum(), wanted)

    before = launch_counts()
    got = grads("cuda")
    torch.cuda.synchronize()
    after = launch_counts()
    for op, need in zip(("bwd_f1", "bwd_f2"), needs):
        name = kernel_name(op, dtype, shape[3], max_disp, stride)
        assert after[name] - before[name] == int(need)
    for x, y in zip(got, grads("torch")):
        _assert_close(x, y, tol)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    f = torch.randn(1, 4, 8, 8, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation_fwd(f.half(), f.half(), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_fwd(f.transpose(1, 2), f.transpose(1, 2), 2, 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        correlation_bwd_f1(torch.zeros(1, 4, 8, 25), f, 2, 1)
    # the FP32-core gradients: batch x 64-channel slices past the grid's 65535
    many = torch.zeros(32768, 1, 1, 72, device=cuda_device)
    g = torch.zeros(32768, 1, 1, 25, device=cuda_device)
    for op, fn in (("bwd_f1", correlation_bwd_f1), ("bwd_f2", correlation_bwd_f2)):
        for dtype, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16_simt")):
            before = launch_counts()
            with pytest.raises(ValueError, match=f"corr_{op}_{suffix}: no launch grid"):
                fn(g.to(dtype), many.to(dtype), 2, 1)
            assert launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,suffix", [(torch.float32, 1e-5, "f32"), (torch.bfloat16, 0.02, "bf16_simt")])
@pytest.mark.parametrize("op,kernel,plain", [("bwd_f1", correlation_bwd_f1, correlation_bwd_f1_torch),
                                             ("bwd_f2", correlation_bwd_f2, correlation_bwd_f2_torch)])
def test_cuda_gradients_take_unaligned_maps(cuda_device, op, kernel, plain, dtype, tol, suffix):
    """A map one element past a 16-byte boundary (contiguous, so the wrappers
    take it): the FP32-core gradients stage it and write the output by plain
    loads and stores."""
    shape, max_disp, stride = (2, 9, 40, 32), 20, 2
    d = displacement_count(max_disp, stride)
    rng = np.random.RandomState(12)
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(cuda_device, dtype)
    f = buf[1:].view(shape)
    assert f.is_contiguous() and f.data_ptr() % 16
    g = torch.from_numpy(rng.randn(*shape[:3], d * d).astype(np.float32)).to(cuda_device, dtype)
    name = f"corr_{op}_{suffix}"
    before = launch_counts()[name]
    got = kernel(g, f, max_disp, stride, kernel=name)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    _assert_close(got, plain(g, f, max_disp, stride), tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,max_disp,stride,suffix",
    [((2, 8, 40, 16), 20, 2, ""), ((1, 7, 150, 64), 20, 2, ""), ((2, 5, 75, 128), 10, 1, ""),
     ((1, 6, 20, 8), 20, 2, "_simt"), ((1, 9, 75, 24), 10, 1, "_simt"),
     ((1, 6, 20, 16), 44, 2, "_simt"), ((2, 8, 40, 16), 4, 2, "_simt"),
     ((2, 9, 150, 256), 20, 4, "_simt")],
)
def test_cuda_bf16_dispatch_by_launch_count(cuda_device, shape, max_disp, stride, suffix):
    """bf16 maps the tensor-core kernels take launch them and no twin; the
    others launch the FP32-core twins and no tensor-core kernel."""
    d = displacement_count(max_disp, stride)
    rng = np.random.RandomState(8)
    f = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(rng.randn(*shape[:3], d * d).astype(np.float32)).to(cuda_device, torch.bfloat16)
    before = launch_counts()
    fwd = correlation_fwd(f, f, max_disp, stride)
    df1 = correlation_bwd_f1(g, f, max_disp, stride)
    df2 = correlation_bwd_f2(g, f, max_disp, stride)
    torch.cuda.synchronize()
    grew = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    assert grew == {f"corr_{op}_bf16{suffix}": 1 for op in ("fwd", "bwd_f1", "bwd_f2")}
    _assert_close(fwd, correlation_torch(f, f, max_disp, stride), 0.02)
    _assert_close(df1, correlation_bwd_f1_torch(g, f, max_disp, stride), 0.02)
    _assert_close(df2, correlation_bwd_f2_torch(g, f, max_disp, stride), 0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", [((2, 8, 40, 16), 20, 2), ((2, 5, 75, 128), 10, 1)])
def test_cuda_twins_agree_past_the_dispatch(cuda_device, shape, max_disp, stride):
    """A forced ``*_simt`` launch computes what the tensor-core kernel does, to
    bf16 rounding; forcing a tensor-core kernel on what it does not take raises."""
    d = displacement_count(max_disp, stride)
    rng = np.random.RandomState(9)
    f = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(rng.randn(*shape[:3], d * d).astype(np.float32)).to(cuda_device, torch.bfloat16)
    _assert_close(correlation_fwd(f, f, max_disp, stride, kernel="corr_fwd_bf16_simt"),
                  correlation_fwd(f, f, max_disp, stride), 0.02)
    _assert_close(correlation_bwd_f1(g, f, max_disp, stride, kernel="corr_bwd_f1_bf16_simt"),
                  correlation_bwd_f1(g, f, max_disp, stride), 0.02)
    _assert_close(correlation_bwd_f2(g, f, max_disp, stride, kernel="corr_bwd_f2_bf16_simt"),
                  correlation_bwd_f2(g, f, max_disp, stride), 0.02)
    narrow = f[..., :8].contiguous()
    with pytest.raises(RuntimeError, match="launch failed"):
        correlation_fwd(narrow, narrow, max_disp, stride, kernel="corr_fwd_bf16")
    with pytest.raises(RuntimeError, match="launch failed"):  # D = 9
        correlation_fwd(f, f, 4 * stride, stride, kernel="corr_fwd_bf16")
    with pytest.raises(ValueError, match="is no kernel of fwd"):
        correlation_fwd(f, f, max_disp, stride, kernel="corr_bwd_f2_bf16")
    g8 = g[..., : 81].contiguous()  # D = 9
    with pytest.raises(RuntimeError, match="launch failed"):
        correlation_bwd_f1(g8, f, 4 * stride, stride, kernel="corr_bwd_f1_bf16")
    with pytest.raises(ValueError, match="is no kernel of bwd_f1"):
        correlation_bwd_f1(g, f, max_disp, stride, kernel="corr_bwd_f2_bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 64, 128, 256])
@pytest.mark.parametrize("shape3,max_disp,stride", [((2, 7, 150), 20, 2), ((1, 23, 75), 10, 1),
                                                     ((1, 5, 64), 20, 2), ((3, 2, 129), 10, 1)])
def test_cuda_tensor_core_df1_matches_plain(cuda_device, shape3, max_disp, stride, c):
    """``corr_bwd_f1_bf16`` over the channel counts it takes, at widths that
    are no multiple of its 64-column tile, one tile exactly, and one column
    past two tiles; an odd H, and an H above D."""
    d = displacement_count(max_disp, stride)
    rng = np.random.RandomState(10)
    f = torch.from_numpy(rng.randn(*shape3, c).astype(np.float32)).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(rng.randn(*shape3, d * d).astype(np.float32)).to(cuda_device, torch.bfloat16)
    before = launch_counts()["corr_bwd_f1_bf16"]
    got = correlation_bwd_f1(g, f, max_disp, stride)
    torch.cuda.synchronize()
    assert launch_counts()["corr_bwd_f1_bf16"] == before + 1
    _assert_close(got, correlation_bwd_f1_torch(g, f, max_disp, stride), 0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize(
    "shape,max_disp,stride",
    [((2, 9, 150, 256), 20, 4), ((1, 8, 70, 32), 12, 4), ((1, 7, 45, 40), 3, 1),
     ((1, 6, 33, 16), 6, 3), ((1, 5, 50, 12), 10, 5), ((1, 20, 40, 6), 24, 2),
     ((1, 4, 20, 3), 9, 9)],
)
def test_cuda_forward_displacement_grids(cuda_device, shape, max_disp, stride, dtype, tol):
    """The FP32-core forward at stride 4, at D below 21 (D = 11, 7, 5, 3), at
    strides that divide no column group (3, 5, 9), at D = 25 (two blocks of
    displacement columns) and at channel counts that are no multiple of 8
    (staged without 16-byte copies)."""
    a, b = _pair(shape, seed=11)
    f1 = torch.from_numpy(a).to(cuda_device, dtype)
    f2 = torch.from_numpy(b).to(cuda_device, dtype)
    kernel = "corr_fwd_bf16_simt" if dtype == torch.bfloat16 else None
    got = correlation_fwd(f1, f2, max_disp, stride, kernel=kernel)
    torch.cuda.synchronize()
    d = displacement_count(max_disp, stride)
    assert got.shape == (*shape[:3], d * d)
    _assert_close(got, correlation_torch(f1, f2, max_disp, stride), tol)


@pytest.mark.cuda
def test_cuda_forward_splat_matches_the_host(cuda_device):
    """The forward splat (``ops/warp.py::forward_warp``) accumulates with
    float atomics on the card, so its last bits move from run to run. The
    density of a ground-truth-like flow (up to 12 px, some of it leaving the
    frame) against the host's within 1e-5, and the ``disocc`` mask
    (density < 0.8) differing on at most 1e-3 of its pixels, the ones whose
    density lies within rounding of the threshold; its gradient to the flow
    within 1e-4."""
    from unflow_tpu_torch.losses.terms import DISOCC_THRESH
    from unflow_tpu_torch.ops.warp import forward_warp

    rng = np.random.RandomState(3)
    flow = torch.from_numpy((rng.randn(4, 2, 48, 160) * 6.0).astype(np.float32))
    proj = torch.from_numpy(rng.randn(4, 1, 48, 160).astype(np.float32))
    host = flow.clone().requires_grad_()
    card = flow.to(cuda_device).requires_grad_()
    want, got = forward_warp(host), forward_warp(card)
    (want * proj).sum().backward()
    (got * proj.to(cuda_device)).sum().backward()
    got_cpu = got.detach().cpu()
    assert (got_cpu - want.detach()).abs().max().item() < 1e-5
    flips = ((got_cpu < DISOCC_THRESH) != (want.detach() < DISOCC_THRESH)).float().mean().item()
    assert flips <= 1e-3
    assert (card.grad.cpu() - host.grad).abs().max().item() < 1e-4
