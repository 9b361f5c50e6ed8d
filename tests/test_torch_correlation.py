"""Port's correlation against the JAX package's: the plain jnp version, and
the Pallas kernels B1 (f32) and B4 (bf16 MXU) run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.correlation import correlation_jnp
from unflow_tpu.ops.pallas.correlation import _mxu_ok, correlation_pallas
from unflow_tpu_torch.ops import correlation, impl_from_config, resolve_impl
from unflow_tpu_torch.ops.correlation import correlation_torch
from unflow_tpu_torch.ops.cuda import build
from unflow_tpu_torch.ops.cuda.correlation import (
    KERNELS,
    correlation_fwd,
    kernel_name,
    launch_counts,
    tensor_core_ok,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "shape,max_disp,stride",
    [((2, 8, 12, 6), 4, 2), ((2, 8, 12, 6), 3, 1), ((1, 8, 72, 4), 4, 2)],
)
def test_correlation_torch_matches_jnp(shape, max_disp, stride):
    a, b = _pair(shape)
    want = np.asarray(correlation_jnp(jnp.asarray(a), jnp.asarray(b), max_disp, stride))
    got = correlation_torch(torch.from_numpy(a), torch.from_numpy(b), max_disp, stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape,max_disp,stride",
    [((2, 8, 16, 8), 4, 2), ((1, 8, 72, 4), 4, 2), ((1, 8, 16, 8), 3, 1)],
)
def test_correlation_torch_matches_pallas_f32_kernel(shape, max_disp, stride):
    # B1: ops/pallas/correlation.py::_corr_fwd_chunk, interpret mode on CPU.
    a, b = _pair(shape, seed=1)
    want = np.asarray(correlation_pallas(jnp.asarray(a), jnp.asarray(b), max_disp, stride))
    got = correlation_torch(torch.from_numpy(a), torch.from_numpy(b), max_disp, stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_correlation_torch_matches_pallas_bf16_mxu_kernel():
    # B4: ops/pallas/correlation_mxu.py::corr_fwd_mxu. Its gate needs
    # 128-multiple channel chunks, so C=128 (a C=8 bf16 input takes B1).
    shape, max_disp, stride = (1, 8, 16, 128), 4, 2
    assert _mxu_ok(jnp.bfloat16, shape[1], shape[2], max_disp, stride, shape[3])
    a, b = _pair(shape, seed=2)
    want = np.asarray(
        correlation_pallas(
            jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
            max_disp, stride,
        ).astype(jnp.float32)
    )
    got = correlation_torch(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), max_disp, stride
    )
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err / np.abs(want).max() < 0.02


def test_correlation_torch_sums_bf16_in_f32():
    a, b = _pair((1, 4, 6, 300), seed=3)
    a16, b16 = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = correlation_torch(a16, b16, 2, 1)
    want = correlation_torch(a16.float(), b16.float(), 2, 1).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("fn", [correlation_torch, correlation, correlation_fwd])
def test_asymmetric_grid_rejected(fn):
    a, b = _pair((1, 4, 4, 2))
    with pytest.raises(ValueError, match="divisible"):
        fn(torch.from_numpy(a), torch.from_numpy(b), 3, 2)


def test_impl_resolution():
    assert resolve_impl(None, CPU) == "torch"
    assert resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_impl("cuda", CPU)
    with pytest.raises(ValueError):
        resolve_impl("pallas", CPU)
    assert [impl_from_config(n) for n in ("auto", "jnp", "pallas", "torch", "cuda")] == [
        "auto", "torch", "cuda", "torch", "cuda"
    ]


def test_cuda_impl_on_cpu_tensors_raises():
    a, b = _pair((1, 4, 4, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        correlation(torch.from_numpy(a), torch.from_numpy(b), 2, 1, impl="cuda")


def test_wrapper_takes_plain_version_for_cpu_tensors():
    a, b = _pair((1, 5, 9, 3))
    before = launch_counts()
    got = correlation_fwd(torch.from_numpy(a), torch.from_numpy(b), 2, 1)
    want = correlation_torch(torch.from_numpy(a), torch.from_numpy(b), 2, 1)
    assert torch.equal(got, want)
    assert launch_counts() == before  # no kernel ran


def test_nvcc_build_targets_hopper():
    cmd = build.build_command("correlation_fwd", build.BUILD_DIR / "x.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1].endswith("csrc/correlation_fwd.cu")
    lib = build.library_path("correlation_fwd")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("correlation_fwd-")


@pytest.mark.parametrize(
    "dtype,c,max_disp,stride,ok",
    [
        (torch.bfloat16, 256, 20, 2, True),   # FlowNetC's conv3 maps
        (torch.bfloat16, 256, 10, 1, True),
        (torch.bfloat16, 64, 20, 2, True),
        (torch.bfloat16, 128, 10, 1, True),
        (torch.bfloat16, 16, 20, 2, True),
        (torch.bfloat16, 8, 20, 2, False),    # C no multiple of 16
        (torch.bfloat16, 24, 10, 1, False),
        (torch.bfloat16, 64, 8, 2, False),    # D = 9: not FlowNetC's 21
        (torch.bfloat16, 256, 20, 4, False),  # stride 4, D = 11
        (torch.bfloat16, 256, 20, 1, False),  # D = 41
        (torch.bfloat16, 512, 20, 2, False),  # more channels than the A fragments hold
        (torch.bfloat16, 8, 44, 2, False),
        (torch.bfloat16, 256, 44, 2, False),  # D = 45
        (torch.bfloat16, 256, 21, 3, False),  # stride 3
        (torch.float32, 256, 20, 2, False),
        (torch.float16, 256, 20, 2, False),
    ],
)
def test_tensor_core_ok(dtype, c, max_disp, stride, ok):
    assert tensor_core_ok(dtype, c, max_disp, stride) is ok


@pytest.mark.parametrize(
    "op,dtype,c,max_disp,stride,want",
    [
        ("fwd", torch.bfloat16, 256, 20, 2, "corr_fwd_bf16"),
        ("fwd", torch.bfloat16, 64, 10, 1, "corr_fwd_bf16"),
        ("fwd", torch.bfloat16, 8, 20, 2, "corr_fwd_bf16_simt"),
        ("fwd", torch.bfloat16, 24, 10, 1, "corr_fwd_bf16_simt"),
        ("fwd", torch.bfloat16, 256, 44, 2, "corr_fwd_bf16_simt"),
        ("fwd", torch.bfloat16, 256, 20, 4, "corr_fwd_bf16_simt"),
        ("fwd", torch.bfloat16, 64, 4, 2, "corr_fwd_bf16_simt"),
        ("fwd", torch.float32, 256, 20, 2, "corr_fwd_f32"),
        ("bwd_f2", torch.bfloat16, 128, 20, 2, "corr_bwd_f2_bf16"),
        ("bwd_f2", torch.bfloat16, 24, 20, 2, "corr_bwd_f2_bf16_simt"),
        ("bwd_f2", torch.bfloat16, 256, 20, 4, "corr_bwd_f2_bf16_simt"),
        ("bwd_f2", torch.float32, 24, 4, 2, "corr_bwd_f2_f32"),
        ("bwd_f1", torch.bfloat16, 256, 20, 2, "corr_bwd_f1_bf16"),
        ("bwd_f1", torch.bfloat16, 8, 4, 2, "corr_bwd_f1_bf16_simt"),
        ("bwd_f1", torch.float32, 8, 4, 2, "corr_bwd_f1_f32"),
    ],
)
def test_kernel_chosen_for_dtype_and_geometry(op, dtype, c, max_disp, stride, want):
    assert kernel_name(op, dtype, c, max_disp, stride) == want
    assert want in KERNELS


def test_eight_kernels_with_a_count_each():
    # nine since the gradient to f1 has its tensor-core kernel too
    names = {
        "corr_fwd_f32", "corr_fwd_bf16", "corr_fwd_bf16_simt",
        "corr_bwd_f1_f32", "corr_bwd_f1_bf16", "corr_bwd_f1_bf16_simt",
        "corr_bwd_f2_f32", "corr_bwd_f2_bf16", "corr_bwd_f2_bf16_simt",
    }
    assert len(names) == 9 and set(KERNELS) == names == set(launch_counts())
    for op, source, mma in (("fwd", "correlation_fwd", "correlation_fwd_mma"),
                            ("bwd_f1", "correlation_bwd", "correlation_bwd_mma"),
                            ("bwd_f2", "correlation_bwd", "correlation_bwd_mma")):
        assert KERNELS[f"corr_{op}_bf16"] == (mma, f"unflow_corr_{op}_bf16")
        assert KERNELS[f"corr_{op}_bf16_simt"] == (source, f"unflow_corr_{op}_bf16_simt")
    # each symbol is exported by its source, and by no other
    for name, (source, symbol) in KERNELS.items():
        assert f"int {symbol}(" in (build.CSRC_DIR / f"{source}.cu").read_text(), name
        others = [p for p in build.CSRC_DIR.glob("*.cu") if p.stem != source]
        assert not any(f"int {symbol}(" in p.read_text() for p in others), name


def test_forward_hands_tensors_off_the_cpu_to_the_launch(monkeypatch):
    # meta tensors stand in for CUDA tensors: anything not on the CPU goes to
    # _launch (which launches or raises), never to the plain version
    from unflow_tpu_torch.ops.cuda import correlation as wrappers

    seen = []
    monkeypatch.setattr(
        wrappers, "_launch", lambda op, a, b, channels, p, s, kernel=None: seen.append(
            (op, channels, kernel_name(op, b.dtype, b.shape[3], p, s), kernel)
        )
    )
    wide = torch.empty((1, 4, 8, 64), dtype=torch.bfloat16, device="meta")
    narrow = torch.empty((1, 4, 8, 24), dtype=torch.bfloat16, device="meta")
    correlation_fwd(wide, wide, 20, 2)
    correlation_fwd(narrow, narrow, 20, 2)
    correlation_fwd(wide, wide, 4, 2)
    correlation_fwd(wide, wide, 20, 2, kernel="corr_fwd_bf16_simt")
    assert seen == [
        ("fwd", 441, "corr_fwd_bf16", None),
        ("fwd", 441, "corr_fwd_bf16_simt", None),
        ("fwd", 25, "corr_fwd_bf16_simt", None),
        ("fwd", 441, "corr_fwd_bf16", "corr_fwd_bf16_simt"),
    ]


@pytest.mark.parametrize(
    "dtype,kernel",
    [
        (torch.bfloat16, "corr_bwd_f2_bf16"),   # another op's kernel: another output shape
        (torch.bfloat16, "corr_fwd_f32"),       # another dtype's
        (torch.float32, "corr_fwd_bf16_simt"),
        (torch.float32, "corr_fwd_f32_simt"),   # f32 has no twin
        (torch.bfloat16, "no_such_kernel"),
    ],
)
def test_only_a_kernel_of_the_same_op_and_dtype_can_be_named(dtype, kernel):
    # meta tensors: the name is refused before anything is launched
    f = torch.empty((1, 4, 8, 64), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="is no kernel of fwd"):
        correlation_fwd(f, f, 20, 2, kernel=kernel)


def test_a_named_kernel_of_the_op_gets_as_far_as_the_device_check():
    from unflow_tpu_torch.ops.cuda.correlation import correlation_bwd_f2

    f = torch.empty((1, 4, 8, 64), dtype=torch.bfloat16, device="meta")
    g = torch.empty((1, 4, 8, 441), dtype=torch.bfloat16, device="meta")
    for kernel in ("corr_fwd_bf16", "corr_fwd_bf16_simt"):
        with pytest.raises(ValueError, match="one CUDA device"):
            correlation_fwd(f, f, 20, 2, kernel=kernel)
    with pytest.raises(ValueError, match="is no kernel of bwd_f2"):
        correlation_bwd_f2(g, f, 20, 2, kernel="corr_bwd_f1_bf16")
    with pytest.raises(ValueError, match="one CUDA device"):
        correlation_bwd_f2(g, f, 20, 2, kernel="corr_bwd_f2_bf16_simt")


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("constexpr int kTile = 32;\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "k.cuh").write_text("constexpr int kTile = 64;\n")
    second = build.library_path("k")
    assert second != first  # an edited header is rebuilt, not loaded stale
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


def test_sources_include_only_headers_that_are_hashed():
    import re

    for source in build.CSRC_DIR.glob("*.cu*"):
        for header in re.findall(r'#include "([^"]+)"', source.read_text()):
            assert header.endswith(".cuh") and (build.CSRC_DIR / header).exists(), (source, header)


def test_ptxas_summary_names_each_instantiation():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__a1b2_22_correlation_fwd_mma_cu_0c19corr_fwd_mma_kernelILi2ELi4EEEvPK13__nv_bfloat16S3_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN57_GLOBAL__N__a1b2_22_correlation_fwd_mma_cu_0c19corr_fwd_mma_kernelILi2ELi4EEEvPK13__nv_bfloat16S3_PS1_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__c3d4_18_correlation_fwd_cu_0c15corr_fwd_kernelI13__nv_bfloat16Li0EEEvPKT_S4_PS2_iiiiiiiib' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__c3d4_18_correlation_fwd_cu_0c15corr_fwd_kernelI13__nv_bfloat16Li0EEEvPKT_S4_PS2_iiiiiiiib
    2272 bytes stack frame, 2368 bytes spill stores, 2376 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 2272 bytes cumulative stack size
"""
    assert build.ptxas_summary(log) == [
        "corr_fwd_mma_kernel<2, 4>: 128 registers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "corr_fwd_kernel<bf16, 0>: 72 registers; "
        "2272 bytes stack frame, 2368 bytes spill stores, 2376 bytes spill loads",
    ]


def test_forward_model_mirrors_the_tile_of_the_source():
    # the CPU model of the register-tiled forward uses the tile the source builds
    from unflow_tpu_torch.ops import correlation_tiled as tiled

    source = (build.CSRC_DIR / "correlation_fwd.cu").read_text()
    assert f"constexpr int kGroups = {tiled.GROUPS};" in source
    assert f"constexpr int kRy = {tiled.ROWS};" in source
    assert f"constexpr int kDi = {tiled.DISP_ROWS};" in source
    assert f"constexpr int kCols = {tiled.COLS};" in source


def test_sources_build_one_way_only():
    # no macro switches a part of a kernel: what the port loads is what a
    # source holds (a header's include guard aside)
    for path in sorted(build.CSRC_DIR.glob("*.cu")):
        switches = [line for line in path.read_text().splitlines()
                    if line.lstrip().startswith(("#if", "#define"))]
        assert not switches, (path.name, switches)
    assert "-D" not in " ".join(build.build_command("correlation_fwd", build.library_path("correlation_fwd")))


def test_chip_smoke_fails_without_a_card_and_prints_no_result(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", build.PACKAGE_DIR.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run")
    assert chip_smoke.main() == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err
