"""Port's flow metrics (unflow_tpu_torch/eval/metrics.py) against the JAX
package's, on random flows with and without masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.eval import metrics as metrics_jax
from unflow_tpu_torch.eval import metrics

torch.set_num_threads(1)

SHAPE = (2, 9, 13)


def _case(kind: str, seed: int):
    rng = np.random.RandomState(seed)
    gt = (rng.randn(*SHAPE, 2) * 6).astype(np.float32)
    pred = gt + (rng.randn(*SHAPE, 2) * 4).astype(np.float32)
    mask = {
        "none": None,
        "ones": np.ones((*SHAPE, 1), np.float32),
        "sparse": (rng.rand(*SHAPE, 1) > 0.6).astype(np.float32),
        "empty": np.zeros((*SHAPE, 1), np.float32),
    }[kind]
    return pred, gt, mask


@pytest.mark.parametrize("kind", ["none", "ones", "sparse", "empty"])
@pytest.mark.parametrize("name", ["flow_error_avg", "outlier_fraction"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_matches_jax(name, kind, seed):
    pred, gt, mask = _case(kind, seed)
    want = float(getattr(metrics_jax, name)(
        jnp.asarray(pred), jnp.asarray(gt), None if mask is None else jnp.asarray(mask)))
    got = float(getattr(metrics, name)(
        torch.from_numpy(pred), torch.from_numpy(gt), None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    if kind == "empty":
        assert got == 0.0  # the sum over the mask is divided by max(sum(mask), 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_endpoint_error_matches_jax(seed):
    pred, gt, _ = _case("none", seed)
    want = np.asarray(metrics_jax.endpoint_error(jnp.asarray(pred), jnp.asarray(gt)))
    got = metrics.endpoint_error(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    assert got.shape == (*SHAPE, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_outlier_needs_both_thresholds():
    """Fl counts a pixel whose error is > 3 px and > 5% of |gt|."""
    gt = torch.tensor([[[[100.0, 0.0], [1.0, 0.0], [100.0, 0.0]]]])
    pred = gt + torch.tensor([[[[4.0, 0.0], [4.0, 0.0], [6.0, 0.0]]]])
    # 4 px on |gt| 100 is 4%: not an outlier; 4 px on |gt| 1 is; 6 px on 100 is
    assert float(metrics.outlier_fraction(pred, gt)) == pytest.approx(2 / 3)
