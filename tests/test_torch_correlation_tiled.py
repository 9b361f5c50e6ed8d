"""The register-tiled model of the FP32-core correlation forward
(``unflow_tpu_torch/ops/correlation_tiled.py``: the column groups, window
slots, blocks of displacement rows and columns and the zero fill that
``csrc/correlation_fwd.cu`` uses) against the port's plain version, the JAX
package's plain version and the Pallas kernel B1 in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.correlation import correlation_jnp
from unflow_tpu.ops.pallas.correlation import correlation_pallas
from unflow_tpu_torch.ops import correlation_tiled as tiled
from unflow_tpu_torch.ops.correlation import correlation_torch, displacement_count

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


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


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
