"""The banded-product model of the tensor-core correlation kernels
(``unflow_tpu_torch/ops/correlation_banded.py``: the tiles, phases, windows,
zero fill and band that ``csrc/correlation_fwd_mma.cu`` and
``csrc/correlation_bwd_mma.cu`` use) against the port's plain versions, the
JAX package's plain version and its gradients, and the Pallas MXU kernels B4,
B5 and B6 in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.correlation import correlation_jnp
from unflow_tpu.ops.pallas.correlation import (
    _corr_bwd_f1_impl,
    _corr_bwd_f2_impl,
    _mxu_ok,
    correlation_pallas,
)
from unflow_tpu_torch.ops import correlation_banded as banded
from unflow_tpu_torch.ops.correlation import (
    correlation_bwd_f1_torch,
    correlation_bwd_f2_torch,
    correlation_torch,
    displacement_count,
)
from unflow_tpu_torch.ops.correlation_banded import (
    band_matrix,
    correlation_banded_torch,
    correlation_bwd_f1_banded_torch,
    correlation_bwd_f2_banded_torch,
)

torch.set_num_threads(1)

# The kernels' grid: D = 21, as P = 20 with s = 2 (FlowNetC's) or P = 10 with
# s = 1; H < D throughout. W smaller than a tile with two batch elements; a
# width that divides no tile (75); W smaller than the band; two tiles with an
# odd H; a second tile of two columns.
CASES = [
    ((2, 8, 12, 16), 20, 2),
    ((1, 3, 75, 16), 10, 1),
    ((1, 4, 9, 16), 10, 1),
    ((1, 5, 70, 16), 20, 2),
    ((1, 6, 66, 32), 10, 1),
]
IDS = [f"{'x'.join(map(str, shape))}-P{p}-s{s}" for shape, p, s in CASES]


def _inputs(shape, max_disp, stride, seed=0):
    rng = np.random.RandomState(seed)
    d = displacement_count(max_disp, stride)
    f1 = rng.randn(*shape).astype(np.float32)
    f2 = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape[:3], d * d).astype(np.float32)
    return f1, f2, g


def _assert_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("rows", banded.FWD_ROWS_CHOICES)
@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_banded_forward_matches_plain_version(shape, max_disp, stride, rows):
    # only the order of summation differs
    f1, f2, _ = _inputs(shape, max_disp, stride)
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    got = correlation_banded_torch(a, b, max_disp, stride, rows)
    _assert_close(got.numpy(), correlation_torch(a, b, max_disp, stride).numpy(), 1e-5)


@pytest.mark.parametrize("rows", banded.BWD_F2_ROWS_CHOICES)
@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_banded_df2_matches_plain_version(shape, max_disp, stride, rows):
    f1, _, g = _inputs(shape, max_disp, stride)
    a, c = torch.from_numpy(f1), torch.from_numpy(g)
    got = correlation_bwd_f2_banded_torch(c, a, max_disp, stride, rows)
    _assert_close(got.numpy(), correlation_bwd_f2_torch(c, a, max_disp, stride).numpy(), 1e-5)


@pytest.mark.parametrize("rows", banded.BWD_F1_ROWS_CHOICES)
@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_banded_df1_matches_plain_version(shape, max_disp, stride, rows):
    _, f2, g = _inputs(shape, max_disp, stride)
    b, c = torch.from_numpy(f2), torch.from_numpy(g)
    got = correlation_bwd_f1_banded_torch(c, b, max_disp, stride, rows)
    _assert_close(got.numpy(), correlation_bwd_f1_torch(c, b, max_disp, stride).numpy(), 1e-5)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("wrt", ["f1", "f2"])
def test_banded_gradients_do_not_depend_on_rows_per_block(wrt, rows):
    # rows per block only regroup which source rows a block stages
    shape, max_disp, stride = CASES[3]
    f1, _, g = _inputs(shape, max_disp, stride, seed=3)
    a, c = torch.from_numpy(f1), torch.from_numpy(g)
    fn, plain = {
        "f1": (correlation_bwd_f1_banded_torch, correlation_bwd_f1_torch),
        "f2": (correlation_bwd_f2_banded_torch, correlation_bwd_f2_torch),
    }[wrt]
    _assert_close(fn(c, a, max_disp, stride, rows).numpy(), plain(c, a, max_disp, stride).numpy(), 1e-5)


@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_banded_forward_matches_jnp(shape, max_disp, stride):
    f1, f2, _ = _inputs(shape, max_disp, stride)
    want = correlation_jnp(jnp.asarray(f1), jnp.asarray(f2), max_disp, stride)
    got = correlation_banded_torch(torch.from_numpy(f1), torch.from_numpy(f2), max_disp, stride)
    _assert_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_banded_df2_matches_jax_grad(shape, max_disp, stride):
    f1, f2, g = _inputs(shape, max_disp, stride)
    want = jax.grad(
        lambda a, b: jnp.sum(correlation_jnp(a, b, max_disp, stride) * g), argnums=1
    )(jnp.asarray(f1), jnp.asarray(f2))
    got = correlation_bwd_f2_banded_torch(
        torch.from_numpy(g), torch.from_numpy(f1), max_disp, stride
    )
    _assert_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("shape,max_disp,stride", CASES, ids=IDS)
def test_banded_df1_matches_jax_grad(shape, max_disp, stride):
    f1, f2, g = _inputs(shape, max_disp, stride)
    want = jax.grad(
        lambda a, b: jnp.sum(correlation_jnp(a, b, max_disp, stride) * g), argnums=0
    )(jnp.asarray(f1), jnp.asarray(f2))
    got = correlation_bwd_f1_banded_torch(
        torch.from_numpy(g), torch.from_numpy(f2), max_disp, stride
    )
    _assert_close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("shape,max_disp,stride", [((1, 8, 16, 128), 20, 2), ((1, 4, 16, 128), 10, 1)])
def test_banded_df1_matches_pallas_bf16_mxu_kernel(shape, max_disp, stride):
    # B5 corr_bwd_f1_mxu in interpret mode on the CPU, at the geometry its gate
    # takes (see the test below); bf16 in, f32 sums, bf16 out on both sides
    assert _mxu_ok(jnp.bfloat16, shape[1], shape[2], max_disp, stride, shape[3])
    _, f2, g = _inputs(shape, max_disp, stride, seed=2)
    want = _corr_bwd_f1_impl(
        jnp.asarray(g).astype(jnp.bfloat16), jnp.asarray(f2).astype(jnp.bfloat16), max_disp, stride
    ).astype(jnp.float32)
    got = correlation_bwd_f1_banded_torch(
        torch.from_numpy(g).bfloat16(), torch.from_numpy(f2).bfloat16(), max_disp, stride
    )
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), want, 0.02)


@pytest.mark.parametrize("shape,max_disp,stride", [((1, 8, 16, 128), 20, 2), ((1, 4, 16, 128), 10, 1)])
def test_banded_model_matches_pallas_bf16_mxu_kernels(shape, max_disp, stride):
    # B4 corr_fwd_mxu and B6 corr_bwd_f2_mxu, interpret mode on the CPU. Their
    # gate needs 128-multiple channel chunks, so C = 128, and row tiles that
    # divide H + 2P; bf16 in, f32 sums, bf16 out on both sides, hence one bf16
    # step of difference at most.
    assert _mxu_ok(jnp.bfloat16, shape[1], shape[2], max_disp, stride, shape[3])
    f1, f2, g = _inputs(shape, max_disp, stride, seed=2)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    tb = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    want_fwd = correlation_pallas(bf(f1), bf(f2), max_disp, stride).astype(jnp.float32)
    want_df2 = _corr_bwd_f2_impl(bf(g), bf(f1), max_disp, stride).astype(jnp.float32)
    got_fwd = correlation_banded_torch(tb(f1), tb(f2), max_disp, stride)
    got_df2 = correlation_bwd_f2_banded_torch(tb(g), tb(f1), max_disp, stride)
    assert got_fwd.dtype == got_df2.dtype == torch.bfloat16
    _assert_close(got_fwd.float().numpy(), want_fwd, 0.02)
    _assert_close(got_df2.float().numpy(), want_df2, 0.02)


@pytest.mark.parametrize(
    "stride,rows_per_block", [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4)]
)
@pytest.mark.parametrize("h", [1, 5, 8, 24])
def test_row_groups_cover_every_row_once(h, stride, rows_per_block):
    rows = [
        y
        for group in range(banded.row_groups(h, stride, rows_per_block))
        for y in banded.group_rows(group, stride, rows_per_block)
    ]
    assert len(rows) == len(set(rows))
    assert set(range(h)) <= set(rows)
    # the rows of a group are one row phase, so they share their source rows
    for group in range(banded.row_groups(h, stride, rows_per_block)):
        ys = banded.group_rows(group, stride, rows_per_block)
        assert {y % stride for y in ys} == {ys[0] % stride}


@pytest.mark.parametrize("stride", [1, 2])
def test_tile_rows_and_window_columns_meet_at_the_displacement(stride):
    p, x0 = 20 if stride == 2 else 10, 64
    d = displacement_count(p, stride)
    for phase in range(stride):
        xs = [banded.output_column(x0, stride, phase, k) for k in range(banded.rows_per_phase(stride))]
        assert all(x % stride == phase for x in xs)
        for k in (0, 7, banded.rows_per_phase(stride) - 1):
            for j in (0, d // 2, d - 1):
                got = banded.window_column(x0, p, stride, phase, k + j)
                assert got == xs[k] + stride * j - p
    # the tile's phases hold each output column once
    cols = sorted(
        banded.output_column(x0, stride, phase, k)
        for phase in range(stride) for k in range(banded.rows_per_phase(stride))
    )
    assert cols == list(range(x0, x0 + banded.TILE_X))
    # the staged window holds what the last row tile's products read
    assert banded.window_cols(stride, banded.BAND_COLS) >= banded.rows_per_phase(stride) + d - 1
    assert d == banded.BAND_D
    assert banded.BAND_COLS >= banded.MMA_ROWS - 1 + banded.BAND_D
    assert banded.BAND_K >= banded.MMA_ROWS - 1 + banded.BAND_D


def test_band_matrix_is_zero_off_the_band_and_outside_the_map():
    shape, p, s = (1, 3, 20, 16), 20, 2
    d = displacement_count(p, s)
    g = torch.ones(*shape[:3], d * d)
    a_hat = band_matrix(g, row=1, i=2, x0=0, p=p, s=s, phase=1, rt=0)[0]
    assert a_hat.shape == (banded.MMA_ROWS, banded.BAND_K)
    for k in range(banded.MMA_ROWS):
        for m in range(banded.BAND_K):
            x = banded.window_column(0, p, s, 1, m)
            on_band = 0 <= m - k < d and 0 <= x < shape[2]
            assert a_hat[k, m] == float(on_band)


def test_df1_band_matrix_holds_the_tile_rows_own_cotangent():
    # zero off the band and where the tile row's pixel lies past the map; on the
    # band, row k holds its pixel's D values of displacement row i in order
    shape, p, s = (1, 3, 20, 16), 20, 2
    d = displacement_count(p, s)
    g = torch.arange(float(np.prod(shape[:3]) * d * d)).reshape(*shape[:3], d * d) + 1.0
    i, phase = 2, 1
    a_hat = band_matrix(g, row=1, i=i, x0=0, p=p, s=s, phase=phase, rt=0, wrt="f1")[0]
    assert a_hat.shape == (banded.MMA_ROWS, banded.BAND_K)
    for k in range(banded.MMA_ROWS):
        x = banded.output_column(0, s, phase, k)
        for m in range(banded.BAND_K):
            if 0 <= m - k < d and x < shape[2]:
                assert a_hat[k, m] == g[0, 1, x, i * d + (m - k)]
            else:
                assert a_hat[k, m] == 0.0
    with pytest.raises(ValueError, match="wrt"):
        band_matrix(g, 1, i, 0, p, s, phase, 0, wrt="f3")


@pytest.mark.parametrize(
    "c,max_disp,stride,ok",
    [(256, 20, 2, True), (16, 10, 1, True), (64, 20, 2, True), (64, 8, 2, False),
     (8, 20, 2, False), (24, 10, 1, False), (512, 20, 2, False), (256, 44, 2, False),
     (256, 20, 4, False), (256, 20, 1, False), (256, 30, 3, False), (256, 3, 2, False)],
)
def test_banded_geometry_gate(c, max_disp, stride, ok):
    assert banded.tensor_core_geometry_ok(c, max_disp, stride) is ok
    if not ok and max_disp % stride == 0:
        z = torch.zeros(1, 2, 4, c)
        with pytest.raises(ValueError, match="banded"):
            correlation_banded_torch(z, z, max_disp, stride)
        d = displacement_count(max_disp, stride)
        with pytest.raises(ValueError, match="banded"):
            correlation_bwd_f1_banded_torch(torch.zeros(1, 2, 4, d * d), z, max_disp, stride)


def test_rows_per_block_follows_the_grid():
    # FlowNetC's train (16, 40x144) and eval (4, 48x160) maps fill a 132-SM card
    # with the larger choice; a small map takes the smaller one
    fwd, df2 = banded.FWD_ROWS_CHOICES, banded.BWD_F2_ROWS_CHOICES
    df1 = banded.ROWS_CHOICES["bwd_f1"]
    assert banded.rows_per_block(df1, 40, 144, 16, 2, 132) == 2
    assert banded.rows_per_block(df1, 24, 75, 2, 1, 132) == 2
    assert set(banded.ROWS_CHOICES) == {"fwd", "bwd_f1", "bwd_f2"}
    assert banded.rows_per_block(fwd, 40, 144, 16, 2, 132) == 4
    assert banded.rows_per_block(fwd, 48, 160, 4, 2, 132) == 4
    assert banded.rows_per_block(fwd, 24, 75, 2, 1, 132) == 2
    assert banded.rows_per_block(fwd, 48, 160, 1, 2, 132) == 2  # one pair, as cli.infer
    assert banded.rows_per_block(df2, 40, 144, 16, 2, 132) == 2
    assert banded.rows_per_block(df2, 24, 75, 2, 1, 132) == 2
    assert banded.tile_count(144) == 3 and banded.row_groups(40, 2, 4) == 10
