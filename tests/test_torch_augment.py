"""Port's augmentations against the JAX package's. The two random streams
cannot agree, so each test re-derives the parameters with the JAX function's
own ``jax.random`` calls (or takes ``sample_affine_params``' draws) and feeds
them to the port's ``apply_*``; the samplers are checked for shapes and
ranges."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu import augment as augment_jax
from unflow_tpu_torch import augment

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("noise_stddev", [0.04, 0.0])
def test_apply_photometric_matches_jax(noise_stddev):
    im1, im2 = _pair((3, 6, 8, 3))
    key = jax.random.PRNGKey(7)
    want = augment_jax.random_photometric(key, [jnp.asarray(im1), jnp.asarray(im2)], noise_stddev)
    # the draws of unflow_tpu/augment/__init__.py::random_photometric
    k_contrast, k_gamma, k_bright, k_colour, k_noise = jax.random.split(key, 5)
    params = {
        "contrast": _t(jax.random.uniform(k_contrast, (3, 1, 1, 1), minval=-0.3, maxval=0.3)),
        "gamma": _t(jax.random.uniform(k_gamma, (3, 1, 1, 1), minval=0.7, maxval=1.5)),
        "bright": _t(0.02 * jax.random.normal(k_bright, (3, 1, 1, 1))),
        "colour": _t(jax.random.uniform(k_colour, (3, 1, 1, 3), minval=0.9, maxval=1.1)),
        "noise": [
            _t(noise_stddev * jax.random.normal(jax.random.fold_in(k_noise, i), im1.shape))
            for i in range(2 if noise_stddev > 0 else 0)
        ],
    }
    got = augment.apply_photometric([_t(im1), _t(im2)], params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
        assert g.min() >= 0.0 and g.max() <= 1.0


def test_sample_photometric_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    p = augment.sample_photometric_params(gen, (64, 4, 5, 3), num_images=2, noise_stddev=0.04)
    assert p["contrast"].shape == p["gamma"].shape == p["bright"].shape == (64, 1, 1, 1)
    assert p["colour"].shape == (64, 1, 1, 3)
    assert -0.3 <= p["contrast"].min() and p["contrast"].max() <= 0.3
    assert 0.7 <= p["gamma"].min() and p["gamma"].max() <= 1.5
    assert 0.9 <= p["colour"].min() and p["colour"].max() <= 1.1
    assert p["contrast"].std() > 0.1 and p["bright"].abs().max() < 0.02 * 6
    assert [n.shape for n in p["noise"]] == [(64, 4, 5, 3)] * 2
    assert not torch.equal(p["noise"][0], p["noise"][1])  # independent per frame
    assert abs(p["noise"][0].std().item() - 0.04) < 0.004
    assert augment.sample_photometric_params(gen, (2, 4, 5, 3), noise_stddev=0.0)["noise"] == []


def _jax_crop_flip_params(key, hw, crop_hw, horizontal_flip):
    """The draws of unflow_tpu/augment/__init__.py::random_crop_flip."""
    (h, w), (ch, cw) = hw, crop_hw
    k_off, k_flip = jax.random.split(key)
    oy = jax.random.randint(k_off, (), 0, h - ch + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (), 0, w - cw + 1)
    flip = bool(horizontal_flip) & (jax.random.uniform(k_flip, ()) < 0.5)
    return {"oy": _t(oy).long(), "ox": _t(ox).long(), "flip": _t(flip)}


@pytest.mark.parametrize("seed", range(4))  # both flip decisions occur
def test_apply_crop_flip_matches_jax(seed):
    im1, im2 = _pair((2, 10, 14, 3), seed)
    flow = np.random.RandomState(seed).randn(2, 10, 14, 2).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_ims, want_flows = augment_jax.random_crop_flip(
        key, [jnp.asarray(im1), jnp.asarray(im2)], (6, 9), flows=[jnp.asarray(flow)]
    )
    params = _jax_crop_flip_params(key, (10, 14), (6, 9), True)
    got_ims, got_flows = augment.apply_crop_flip([_t(im1), _t(im2)], params, (6, 9), [_t(flow)])
    for g, w in zip(got_ims + got_flows, list(want_ims) + list(want_flows)):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert augment.apply_crop_flip([_t(im1)], params, (6, 9))[1] is None


def test_crop_flip_seeds_cover_both_flip_decisions():
    flips = {
        bool(_jax_crop_flip_params(jax.random.PRNGKey(s), (10, 14), (6, 9), True)["flip"])
        for s in range(4)
    }
    assert flips == {False, True}


def test_sample_crop_flip_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(1)
    draws = [augment.sample_crop_flip_params(gen, (10, 14), (6, 9)) for _ in range(200)]
    oy = torch.stack([d["oy"] for d in draws])
    ox = torch.stack([d["ox"] for d in draws])
    flips = torch.stack([d["flip"] for d in draws])
    assert draws[0]["oy"].shape == draws[0]["ox"].shape == draws[0]["flip"].shape == ()
    assert set(oy.tolist()) == set(range(5)) and set(ox.tolist()) == set(range(6))
    assert 0.3 < flips.float().mean() < 0.7
    no_flip = [augment.sample_crop_flip_params(gen, (10, 14), (10, 14), False) for _ in range(20)]
    assert not any(bool(d["flip"]) or int(d["oy"]) or int(d["ox"]) for d in no_flip)
    with pytest.raises(ValueError, match="larger than image"):
        augment.sample_crop_flip_params(gen, (10, 14), (11, 14))


def test_apply_order_swap_matches_jax():
    im1, im2 = _pair((6, 4, 5, 3))
    key = jax.random.PRNGKey(3)
    want = augment_jax.random_order_swap(key, jnp.asarray(im1), jnp.asarray(im2), 0.5)
    swap = _t(jax.random.bernoulli(key, 0.5, (6, 1, 1, 1)))
    assert 0 < swap.sum() < 6
    got = augment.apply_order_swap(_t(im1), _t(im2), swap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_sample_order_swap_params():
    gen = torch.Generator().manual_seed(2)
    swap = augment.sample_order_swap_params(gen, 400, 0.25)
    assert swap.shape == (400, 1, 1, 1) and swap.dtype == torch.bool
    assert 0.15 < swap.float().mean() < 0.35
    assert not augment.sample_order_swap_params(gen, 50, 0.0).any()


def test_random_functions_depend_on_the_generator_seed_alone():
    im1, im2 = (_t(x) for x in _pair((2, 10, 14, 3)))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        a, b = augment.random_order_swap(gen, im1, im2, 0.5)
        (a, b), _ = augment.random_crop_flip(gen, [a, b], (6, 9))
        return augment.random_photometric(gen, [a, b])

    first, again, other = run(5), run(5), run(6)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first[0], other[0])
    assert first[0].shape == (2, 6, 9, 3)


def test_normalize_matches_jax():
    im = _pair((2, 4, 5, 3))[0]
    mean, std = (104.92, 110.18, 114.47), 60.0
    want = augment_jax.normalize(jnp.asarray(im), mean, std)
    np.testing.assert_allclose(augment.normalize(_t(im), mean, std).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


AFFINE_RANGES = dict(translate=0.05, rotate_deg=5.0, zoom_min=0.9, zoom_max=1.1,
                     rel_translate=0.02, rel_rotate_deg=1.0, rel_zoom=0.03)


def _affine_case(seed):
    """Frames (2, 12, 20, 3), a flow (2, 12, 20, 2) of a few pixels and a
    sparse mask, and JAX's affine draws for them, as torch tensors too."""
    rng = np.random.RandomState(seed)
    im1, im2 = _pair((2, 12, 20, 3), seed)
    flow = (rng.randn(2, 12, 20, 2) * 2.0).astype(np.float32)
    mask = (rng.rand(2, 12, 20, 1) < 0.7).astype(np.float32)
    params_jax = augment_jax.sample_affine_params(jax.random.PRNGKey(seed), 2, (12, 20),
                                                  **AFFINE_RANGES)
    params = augment.AffineParams(*(_t(x) for x in params_jax))
    return (im1, im2, flow, mask), params_jax, params


@pytest.mark.parametrize("given_mask", [True, False], ids=["mask", "synthesized_mask"])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_affine_matches_jax(seed, given_mask):
    """The resampled frames and the remapped flow at 1e-4 (bilinear taps at
    float coordinates); the masks, a threshold of them, identical but for at
    most one pixel whose sampled mask lies within 1e-5 of the threshold."""
    (im1, im2, flow, mask), params_jax, params = _affine_case(seed)
    want_ims, want_flows, want_masks = augment_jax.apply_affine(
        params_jax, [jnp.asarray(im1), jnp.asarray(im2)], [jnp.asarray(flow)],
        [jnp.asarray(mask)] if given_mask else None)
    got_ims, got_flows, got_masks = augment.apply_affine(
        params, [_t(im1), _t(im2)], [_t(flow)], [_t(mask)] if given_mask else None)
    for g, w in zip(got_ims + got_flows, list(want_ims) + list(want_flows)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    (g,), (w,) = got_masks, want_masks
    assert g.shape == w.shape == (2, 12, 20, 1)
    assert int((g.numpy() != np.asarray(w)).sum()) <= 1
    assert 0 < float(g.sum()) < g.numel()  # some samples leave the frame or the mask
    # frames only: no ground truth in, none out
    ims, flows, masks = augment.apply_affine(params, [_t(im1), _t(im2)])
    assert flows is None and masks is None and torch.equal(ims[0], got_ims[0])


def test_apply_affine_of_the_identity_keeps_everything():
    im1, im2 = _pair((2, 8, 10, 3))
    flow = np.random.RandomState(3).randn(2, 8, 10, 2).astype(np.float32)
    eye = torch.eye(2).expand(2, 2, 2)
    zero = torch.zeros(2, 2)
    ims, flows, masks = augment.apply_affine(augment.AffineParams(eye, zero, eye, zero),
                                             [_t(im1), _t(im2)], [_t(flow)])
    np.testing.assert_allclose(ims[0].numpy(), im1, atol=1e-6)
    np.testing.assert_allclose(flows[0].numpy(), flow, atol=1e-5)
    assert torch.equal(masks[0], torch.ones(2, 8, 10, 1))


def test_sample_affine_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(4)
    p = augment.sample_affine_params(gen, 500, (12, 20), **AFFINE_RANGES)
    assert p.a1.shape == p.a2.shape == (500, 2, 2) and p.t1.shape == p.t2.shape == (500, 2)
    scale1 = torch.linalg.det(p.a1).sqrt()  # 1 / zoom
    assert 1 / 1.1 - 1e-6 <= scale1.min() and scale1.max() <= 1 / 0.9 + 1e-6
    angle1 = torch.atan2(p.a1[:, 1, 0], p.a1[:, 0, 0])
    assert angle1.abs().max() <= np.deg2rad(5.0) + 1e-6 and angle1.std() > np.deg2rad(1.0)
    assert p.t1.abs().max() <= 0.05 * 12 + 1e-6
    d_t = p.t2 - p.t1
    assert d_t.abs().max() <= 0.02 * 12 + 1e-6 and d_t.abs().max() > 0
    d_angle = torch.atan2(p.a2[:, 1, 0], p.a2[:, 0, 0]) - angle1
    assert d_angle.abs().max() <= np.deg2rad(1.0) + 1e-5
    d_zoom = scale1 / torch.linalg.det(p.a2).sqrt()
    assert (1 - 0.03 - 1e-5) <= d_zoom.min() and d_zoom.max() <= 1 + 0.03 + 1e-5
    off = augment.sample_affine_params(gen, 3, (12, 20))
    assert torch.allclose(off.a1, torch.eye(2).expand(3, 2, 2)) and not off.t2.any()


def test_random_affine_applies_its_own_draws():
    """``random_affine`` is ``sample_affine_params`` at the frames' batch and
    size, then ``apply_affine``: equal to the two steps run on a generator
    of the same seed, bit for bit, and another seed moves it."""
    (im1, im2, flow, mask), _, _ = _affine_case(0)
    args = ([_t(im1), _t(im2)], [_t(flow)], [_t(mask)])
    got = augment.random_affine(torch.Generator().manual_seed(7), *args, **AFFINE_RANGES)
    params = augment.sample_affine_params(torch.Generator().manual_seed(7), 2, (12, 20),
                                          **AFFINE_RANGES)
    want = augment.apply_affine(params, *args)
    for g, w in zip(itertools.chain(*got), itertools.chain(*want)):
        assert torch.equal(g, w)
    other = augment.random_affine(torch.Generator().manual_seed(8), *args, **AFFINE_RANGES)
    assert not torch.equal(other[0][0], got[0][0])
