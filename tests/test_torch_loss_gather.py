"""The fused loss kernels' arithmetic (``ops/loss_gather.py``: the warp, the
masks, the census per pixel over its neighbourhood, the smoothness stencils,
and the hand-derived gradient gathered per pixel and scattered to the warp's
taps) against autograd of the composite terms (``losses/unsupervised.py``),
in float64, so that any gap is a mistake and not rounding.

The flows are large enough that many samples leave the frame and many pixels
fail the forward-backward test; the tests assert both, so the masks are
exercised on both sides of every threshold."""

import numpy as np
import pytest
import torch

from unflow_tpu_torch.losses import LAYER_PATCH_DISTANCES, LAYER_WEIGHTS, compute_losses
from unflow_tpu_torch.losses import terms as loss_terms
from unflow_tpu_torch.losses.unsupervised import unsupervised_loss
from unflow_tpu_torch.models.flownet import FLOW_SCALE
from unflow_tpu_torch.ops import loss_gather
from unflow_tpu_torch.ops.downsample import downsample

torch.set_num_threads(1)

RTOL = 1e-10
WEIGHTS = {"occ": 12.4, "fb": 0.2, "ternary": 1.0, "photo": 0.7, "smooth_2nd": 3.0}
TERM_WEIGHTS = [WEIGHTS[k] for k in loss_gather.TERMS]


def _images(b, h, w, seed):
    rng = np.random.RandomState(seed)
    base = rng.rand(b, 3, h, w)
    # the second frame: the first shifted by a few pixels, plus noise
    im2 = np.roll(base, (2, 3), axis=(2, 3)) * 0.9 + 0.1 * rng.rand(b, 3, h, w)
    return torch.from_numpy(base), torch.from_numpy(im2)


def _flows(b, h, w, seed, amplitude):
    """Raw network flows of one level: a translation per example plus
    noise; the backward flow is minus the translation on the left half
    (consistent) and independent on the right (occluded by the
    forward-backward test)."""
    rng = np.random.RandomState(seed)
    shift = rng.randn(b, 2, 1, 1) * amplitude
    fw = shift + rng.randn(b, 2, h, w) * amplitude * 0.05
    bw = -shift + rng.randn(b, 2, h, w) * amplitude * 0.05
    bw[..., w // 2:] = rng.randn(b, 2, h, w - w // 2) * amplitude
    return (torch.from_numpy(fw).requires_grad_(), torch.from_numpy(bw).requires_grad_())


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def _coef(seed, levels):
    """A gradient to the values vector: every term's and the total's."""
    return torch.from_numpy(np.random.RandomState(seed).rand(5 * levels + 1) + 0.5)


@pytest.mark.parametrize("hw", [(5, 18), (12, 20)])
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("border_ratio", [0.0, 0.2])
def test_one_level_matches_the_composite_terms(radius, hw, border_ratio):
    h, w = hw
    b, scale = 2, FLOW_SCALE / 4
    im1, im2 = _images(b, 4 * h, 4 * w, 10 * radius + h)
    fw, bw = _flows(b, h, w, radius + w, amplitude=3.0 / scale)
    dist = int(min(h, w) * border_ratio)
    border = loss_gather.border_distance(h, w, dist) if dist > 0 else 0

    # the composite: compute_losses at this level, its terms weighted
    im1_s, im2_s = downsample(im1, 4), downsample(im2, 4)
    mask = loss_terms.create_border_mask(im1_s.shape, dist, im1_s.dtype) if dist > 0 else None
    terms = compute_losses(im1_s, im2_s, fw * scale, bw * scale, border_mask=mask,
                           mask_occlusion="fb", data_max_distance=radius, weights=WEIGHTS)
    want = torch.stack([terms[k] for k in loss_gather.TERMS])
    coef = _coef(radius, 1)
    total = LAYER_WEIGHTS[0] * sum(WEIGHTS[k] * terms[k] for k in loss_gather.TERMS)
    objective = (coef[:5] * want).sum() + coef[5] * total
    want_fw, want_bw = torch.autograd.grad(objective, (fw, bw))

    spec = (TERM_WEIGHTS, [LAYER_WEIGHTS[0]], [scale], [radius], [border])
    with torch.no_grad():
        values = loss_gather.fused_forward(im1, im2, [fw], [bw], *spec)
        got_fw, got_bw = loss_gather.fused_backward(im1, im2, [fw], [bw], *spec, coef)
    np.testing.assert_allclose(values[:5].numpy(), want.detach().numpy(), rtol=RTOL)
    np.testing.assert_allclose(float(values[5]), float(total.detach()), rtol=RTOL)
    assert _rel(got_fw[0], want_fw) < RTOL and _rel(got_bw[0], want_bw) < RTOL

    # the masks are exercised both ways
    x = torch.arange(w, dtype=torch.float64) + fw[:, 0].detach() * scale
    leaves = (x < 0) | (x > w - 1)
    assert 0 < float(leaves.double().mean()) < 1
    occluded = loss_gather._pixel(im1_s, im2_s, fw.detach(), bw.detach(), scale, border)["occ"]
    assert 0.05 < float(occluded.mean()) < 0.95


def test_five_levels_match_unsupervised_loss():
    b, h, w = 1, 320, 1152  # the training crop: the coarsest level is 5x18
    im1, im2 = _images(b, h, w, 3)
    flows = [_flows(b, h // (4 * 2**i), w // (4 * 2**i), 20 + i, amplitude=0.8) for i in range(5)]
    fws, bws = [f for f, _ in flows], [g for _, g in flows]
    weights = {**WEIGHTS, "sym": 0.0, "grad": 0.0, "smooth_1st": 0.0}
    total, logs = unsupervised_loss(im1, im2, fws, bws, weights=weights, border_ratio=0.1)
    want_fw = torch.autograd.grad(total, fws + bws)

    scales = [FLOW_SCALE / 2**i for i in range(5)]
    borders = []
    for i in range(5):
        hs, ws = h // (4 * 2**i), w // (4 * 2**i)
        dist = int(min(hs, ws) * 0.1)
        borders.append(loss_gather.border_distance(hs, ws, dist) if dist > 0 else 0)
    spec = (TERM_WEIGHTS, LAYER_WEIGHTS, scales, LAYER_PATCH_DISTANCES, borders)
    grad_values = torch.zeros(26, dtype=torch.float64)
    grad_values[-1] = 1.0
    with torch.no_grad():
        values = loss_gather.fused_forward(im1, im2, fws, bws, *spec)
        got_fw, got_bw = loss_gather.fused_backward(im1, im2, fws, bws, *spec, grad_values)
    for i in range(5):
        for t, key in enumerate(loss_gather.TERMS):
            np.testing.assert_allclose(float(values[5 * i + t]), float(logs[f"{key}/scale{i}"].detach()),
                                       rtol=RTOL)
    np.testing.assert_allclose(float(values[-1]), float(total.detach()), rtol=RTOL)
    for got, want in zip(got_fw + got_bw, want_fw):
        assert _rel(got, want) < RTOL
