"""The register-tiled models of the FP32-core correlation forward and of its
two gradients (``unflow_tpu_torch/ops/correlation_tiled.py``: the column
groups, window slots, blocks of displacement rows and columns, the gradients'
ring of source rows and cotangent band, and the zero fill that
``csrc/correlation_fwd.cu`` and ``csrc/correlation_bwd.cu`` use) against the
port's plain versions, the JAX package's plain version (and its ``jax.grad``)
and the Pallas kernels B1, B2 and B3 in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.correlation import correlation_jnp
from unflow_tpu.ops.pallas.correlation import correlation_pallas
from unflow_tpu_torch.ops import correlation_tiled as tiled
from unflow_tpu_torch.ops.correlation import (
    correlation_bwd_f1_torch,
    correlation_bwd_f2_torch,
    correlation_torch,
    displacement_count,
)

torch.set_num_threads(1)

# stride 1 and 2 (shared windows) with D = 21, W below, at and past one tile of
# 24 columns and an H past one block of 8 rows; D = 11 and below (blocks of 11
# displacement columns); D = 25 (two blocks of displacement columns, four of
# rows); strides that share no window (3, 4, 5)
CASES = [
    ((2, 5, 12, 3), 20, 2),
    ((1, 19, 27, 2), 10, 1),
    ((1, 4, 24, 4), 20, 2),
    ((1, 6, 50, 2), 20, 4),
    ((1, 9, 30, 3), 4, 2),
    ((1, 3, 26, 2), 12, 1),
    ((1, 7, 31, 2), 6, 3),
    ((1, 11, 23, 2), 10, 5),
]
IDS = [f"{'x'.join(map(str, shape))}-P{p}-s{s}" for shape, p, s in CASES]
# the gradients also at a C that is no multiple of 4 and past one slice of 64
# channels, and at a run-time stride with J = 21 (the widest windows)
GRAD_CASES = CASES + [((1, 5, 9, 70), 4, 1), ((1, 20, 9, 3), 30, 3)]
GRAD_IDS = [f"{'x'.join(map(str, shape))}-P{p}-s{s}" for shape, p, s in GRAD_CASES]
GRADIENTS = {
    "f1": (tiled.correlation_bwd_f1_tiled_torch, correlation_bwd_f1_torch),
    "f2": (tiled.correlation_bwd_f2_tiled_torch, correlation_bwd_f2_torch),
}


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _cotangent_case(shape, max_disp, stride, seed):
    """Maps and a cotangent (B, H, W, D*D) as numpy f32."""
    rng = np.random.RandomState(seed)
    d = displacement_count(max_disp, stride)
    a, b = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    return a, b, rng.randn(*shape[:3], d * d).astype(np.float32)


def _assert_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_tiled_forward_matches_plain_version(shape, max_disp, stride):
    # only the order of summation differs
    a, b = _pair(shape)
    f1, f2 = torch.from_numpy(a), torch.from_numpy(b)
    got = tiled.correlation_tiled_torch(f1, f2, max_disp, stride)
    _assert_close(got.numpy(), correlation_torch(f1, f2, max_disp, stride).numpy(), 1e-5)


@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_tiled_forward_matches_jnp(shape, max_disp, stride):
    a, b = _pair(shape, seed=1)
    want = correlation_jnp(jnp.asarray(a), jnp.asarray(b), max_disp, stride)
    got = tiled.correlation_tiled_torch(torch.from_numpy(a), torch.from_numpy(b), max_disp, stride)
    _assert_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("shape,max_disp,stride", [((1, 8, 16, 8), 20, 2), ((1, 8, 16, 8), 4, 1)])
def test_tiled_forward_matches_pallas_f32_kernel(shape, max_disp, stride):
    # B1 _corr_fwd_chunk in interpret mode on the CPU; f32 on both sides
    a, b = _pair(shape, seed=2)
    want = correlation_pallas(jnp.asarray(a), jnp.asarray(b), max_disp, stride)
    got = tiled.correlation_tiled_torch(torch.from_numpy(a), torch.from_numpy(b), max_disp, stride)
    _assert_close(got.numpy(), want, 1e-5)


def test_tiled_forward_keeps_bf16_contract():
    # bf16 in, f32 sums, one rounding to bf16
    a, b = _pair((1, 4, 10, 4), seed=3)
    f1, f2 = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = tiled.correlation_tiled_torch(f1, f2, 4, 2)
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), correlation_torch(f1, f2, 4, 2).float().numpy(), 0.02)


@pytest.mark.parametrize("stride", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("w", [1, 23, 24, 75, 144])
def test_column_groups_cover_every_column_once(w, stride):
    groups = tiled.column_groups(w, stride)
    cols = [
        tiled.group_first_column(g, stride) + stride * k
        for g in range(groups) for k in range(tiled.COLS)
    ]
    assert len(cols) == len(set(cols))
    assert set(range(w)) <= set(cols)
    # a group's columns are one phase, so they share their window
    for g in range(groups):
        first = tiled.group_first_column(g, stride)
        assert first % stride == g % stride
    # nothing past the last run of 4*s columns
    assert max(cols) < -(-w // (tiled.COLS * stride)) * tiled.COLS * stride


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_groups_of_a_slot_read_one_window(stride):
    # group g's column k at displacement j is column first + k + j of its slot
    p = 20 if stride != 1 else 10
    for tile in (0, 3):
        xs = [tiled.group_first_column(tile * tiled.GROUPS + g, stride) for g in range(tiled.GROUPS)]
        for g in range(tiled.GROUPS):
            slot, first = tiled.slot_of_group(g, stride)
            assert slot < tiled.slot_count(stride)
            for k in (0, tiled.COLS - 1):
                for j in (0, 7, 20):
                    want = xs[g] + stride * k + stride * j - p
                    assert xs[slot] - p + stride * (first + k + j) == want


def test_displacement_blocks_and_launch_grid():
    assert [tiled.displacement_block(d) for d in (3, 11, 13, 21, 45)] == [11, 11, 21, 21, 21]
    # FlowNetC's eval and train maps, and the train maps at stride 4 (D = 11)
    assert tiled.launch_grid((4, 48, 160, 256), 20, 2) == (7, 6, 12)
    assert tiled.launch_grid((16, 40, 144, 256), 20, 2) == (6, 6, 48)
    assert tiled.launch_grid((16, 40, 144, 256), 20, 4) == (6, 8, 32)
    assert tiled.launch_grid((1, 6, 20, 8), 44, 2) == (1, 2, 21)  # D = 45: 7 x 3 blocks


@pytest.mark.parametrize("wrt", ["f1", "f2"])
@pytest.mark.parametrize("shape,max_disp,stride", GRAD_CASES, ids=GRAD_IDS)
def test_tiled_gradient_matches_plain_version(shape, max_disp, stride, wrt):
    # only the order of summation differs
    _, f, g = _cotangent_case(shape, max_disp, stride, seed=4)
    model, plain = GRADIENTS[wrt]
    gt, ft = torch.from_numpy(g), torch.from_numpy(f)
    _assert_close(model(gt, ft, max_disp, stride).numpy(), plain(gt, ft, max_disp, stride).numpy(), 1e-5)


@pytest.mark.parametrize("shape,max_disp,stride", GRAD_CASES, ids=GRAD_IDS)
def test_tiled_gradients_match_jax_grad(shape, max_disp, stride):
    a, b, g = _cotangent_case(shape, max_disp, stride, seed=5)
    want1, want2 = jax.grad(
        lambda x, y: jnp.sum(correlation_jnp(x, y, max_disp, stride) * g), argnums=(0, 1)
    )(jnp.asarray(a), jnp.asarray(b))
    gt = torch.from_numpy(g)
    got1 = tiled.correlation_bwd_f1_tiled_torch(gt, torch.from_numpy(b), max_disp, stride)
    got2 = tiled.correlation_bwd_f2_tiled_torch(gt, torch.from_numpy(a), max_disp, stride)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "shape,max_disp,stride", [((1, 8, 8, 4), 4, 2), ((1, 8, 72, 4), 4, 2), ((1, 8, 16, 8), 3, 1)]
)
def test_tiled_gradients_match_pallas_f32_kernels(shape, max_disp, stride):
    # B2 _corr_bwd_f1_chunk and B3 _corr_bwd_f2_chunk through the VJP of
    # correlation_pallas, interpret mode on the CPU; f32 on both sides
    a, b, g = _cotangent_case(shape, max_disp, stride, seed=6)
    _, vjp = jax.vjp(
        lambda x, y: correlation_pallas(x, y, max_disp, stride), jnp.asarray(a), jnp.asarray(b)
    )
    want1, want2 = vjp(jnp.asarray(g))
    gt = torch.from_numpy(g)
    got1 = tiled.correlation_bwd_f1_tiled_torch(gt, torch.from_numpy(b), max_disp, stride)
    got2 = tiled.correlation_bwd_f2_tiled_torch(gt, torch.from_numpy(a), max_disp, stride)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("wrt", ["f1", "f2"])
def test_tiled_gradient_keeps_bf16_contract(wrt):
    # bf16 in, f32 sums, one rounding to bf16
    _, f, g = _cotangent_case((1, 6, 20, 12), 4, 2, seed=7)
    model, plain = GRADIENTS[wrt]
    gt, ft = torch.from_numpy(g).bfloat16(), torch.from_numpy(f).bfloat16()
    got = model(gt, ft, 4, 2)
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), plain(gt, ft, 4, 2).float().numpy(), 0.02)


@pytest.mark.parametrize("stride", [1, 2, 3, 4])
@pytest.mark.parametrize("h,w,max_disp", [(40, 144, 20), (7, 23, 4), (3, 9, 12), (20, 75, 36)])
def test_gradient_blocks_cover_every_pixel_once(h, w, max_disp, stride):
    p = max_disp - max_disp % stride
    rows = tiled.GRAD_ROWS
    tiles, row_groups, slices = tiled.gradient_launch_grid((2, h, w, 130), p, stride)
    assert slices == 2 * 3  # 130 channels: three slices of 64
    seen = []
    for tile in range(tiles):
        xs = [tiled.group_first_column(tile * tiled.GRAD_GROUPS + g, stride) + stride * k
              for g in range(tiled.GRAD_GROUPS) for k in range(tiled.COLS)]
        for row_group in range(row_groups):
            y0 = tiled.first_row(row_group, stride, rows)
            seen += [(y0 + stride * r, x) for r in range(rows) for x in xs]
    inside = [yx for yx in seen if yx[0] < h and yx[1] < w]
    assert len(inside) == len(set(inside)) == h * w


@pytest.mark.parametrize("wrt", ["f1", "f2"])
@pytest.mark.parametrize("max_disp,stride", [(20, 2), (10, 1), (20, 4), (30, 3)])
def test_gradient_rows_meet_the_ring_source_rows(max_disp, stride, wrt):
    """Output row r meets source row t = r + n at step n, the map row of its
    displacement row (n for df1, D-1-n for df2); the ring row staged at step n
    is none that step reads, and held the row that step n - 1 read last."""
    d = displacement_count(max_disp, stride)
    rows = tiled.GRAD_ROWS
    ring = rows + 1
    for y0 in (0, 1, 17):
        for n in range(d):
            i = n if wrt == "f1" else d - 1 - n
            for r in range(rows):
                y = y0 + stride * r
                src = y0 - max_disp + stride * (r + n)
                assert src == (y + stride * i - max_disp if wrt == "f1" else y + max_disp - stride * i)
            read = {(r + n) % ring for r in range(rows)}
            assert len(read) == rows
            staged = n + rows  # first read at step n + 1, by the last row
            assert staged % ring not in read
            if n:
                assert staged % ring == (0 + n - 1) % ring


def test_gradient_launch_grid():
    # FlowNetC's train and eval maps, the train maps at stride 4 (D = 11), a
    # run-time stride with D = 21, and D = 45 (walked in three blocks of 21)
    assert tiled.gradient_launch_grid((16, 40, 144, 256), 20, 2) == (9, 10, 64)
    assert tiled.gradient_launch_grid((4, 48, 160, 256), 20, 2) == (10, 12, 16)
    assert tiled.gradient_launch_grid((16, 40, 144, 256), 20, 4) == (9, 12, 64)
    assert tiled.gradient_launch_grid((1, 20, 40, 6), 30, 3) == (3, 6, 1)
    assert tiled.gradient_launch_grid((1, 6, 20, 8), 44, 2) == (2, 2, 1)
