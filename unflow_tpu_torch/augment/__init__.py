"""Data augmentation on the device, and input normalization.

Port of ``unflow_tpu/augment/__init__.py`` (``random_photometric``,
``random_crop_flip``, ``random_order_swap``, ``normalize``). Images keep the
JAX layout here, ``(B, H, W, C)`` in [0, 1]: the functions are elementwise or
index rows and columns, and a contiguous NHWC batch permuted to NCHW is
already the ``channels_last`` tensor the network wants.

JAX's and PyTorch's random streams cannot agree, so each augmentation is
split in two: ``sample_*_params(generator, ...)`` draws its parameters as
tensors on the generator's device (nothing is read back to the host, so a
train step never waits for them), and ``apply_*(..., params)`` is a pure
function of them. ``random_*`` is the two in a row. The affine augmentation
is in ``augment/affine.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def normalize(im: torch.Tensor, mean: Sequence[float], stddev: float) -> torch.Tensor:
    """``(..., 3)`` RGB in [0, 1] -> ``(im * 255 - mean) / stddev``."""
    return (im * 255.0 - torch.tensor(mean, dtype=im.dtype, device=im.device)) / stddev


def _uniform(generator: torch.Generator, shape, low: float, high: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def sample_photometric_params(
    generator: torch.Generator,
    shape: Sequence[int],
    num_images: int = 2,
    noise_stddev: float = 0.04,
    min_contrast: float = -0.3,
    max_contrast: float = 0.3,
    brightness_stddev: float = 0.02,
    min_colour: float = 0.9,
    max_colour: float = 1.1,
    min_gamma: float = 0.7,
    max_gamma: float = 1.5,
) -> dict:
    """One parameter set per example of a ``(B, H, W, C)`` batch, shared by
    the frames of a pair: ``contrast``, ``gamma``, ``bright`` ``(B, 1, 1, 1)``
    and ``colour`` ``(B, 1, 1, C)``; ``noise``: one ``(B, H, W, C)`` gaussian
    field of stddev ``noise_stddev`` per frame (empty when it is 0)."""
    b, c = shape[0], shape[-1]
    dev = generator.device
    return {
        "contrast": _uniform(generator, (b, 1, 1, 1), min_contrast, max_contrast),
        "gamma": _uniform(generator, (b, 1, 1, 1), min_gamma, max_gamma),
        "bright": brightness_stddev * torch.randn((b, 1, 1, 1), generator=generator, device=dev),
        "colour": _uniform(generator, (b, 1, 1, c), min_colour, max_colour),
        "noise": [
            noise_stddev * torch.randn(tuple(shape), generator=generator, device=dev)
            for _ in range(num_images if noise_stddev > 0 else 0)
        ],
    }


def apply_photometric(ims: Sequence[torch.Tensor], params: dict) -> list[torch.Tensor]:
    """``(im * (1 + contrast) + bright) * colour``, clipped to [0, 1], raised
    to ``1 / gamma``, plus the frame's noise, clipped again."""
    gamma_inv = 1.0 / params["gamma"]
    out = []
    for i, im in enumerate(ims):
        im = (im * (1.0 + params["contrast"]) + params["bright"]) * params["colour"]
        im = im.clamp(0.0, 1.0) ** gamma_inv
        if params["noise"]:
            im = im + params["noise"][i]
        out.append(im.clamp(0.0, 1.0))
    return out


def random_photometric(
    generator: torch.Generator, ims: Sequence[torch.Tensor], noise_stddev: float = 0.04
) -> list[torch.Tensor]:
    """One random photometric transform per example, applied to every image
    of ``ims``, with independent noise per frame."""
    params = sample_photometric_params(generator, ims[0].shape, len(ims), noise_stddev)
    return apply_photometric(ims, params)


def sample_crop_flip_params(
    generator: torch.Generator,
    image_hw: tuple[int, int],
    crop_hw: tuple[int, int],
    horizontal_flip: bool = True,
) -> dict:
    """One crop offset and one flip decision **per batch**: ``oy``, ``ox``
    (0-d int64 tensors) and ``flip`` (0-d bool tensor)."""
    (h, w), (ch, cw) = image_hw, crop_hw
    if ch > h or cw > w:
        raise ValueError(f"crop {crop_hw} larger than image {(h, w)}")
    dev = generator.device
    return {
        "oy": torch.randint(0, h - ch + 1, (), generator=generator, device=dev),
        "ox": torch.randint(0, w - cw + 1, (), generator=generator, device=dev),
        "flip": (torch.rand((), generator=generator, device=dev) < 0.5) & horizontal_flip,
    }


def apply_crop_flip(
    ims: Sequence[torch.Tensor],
    params: dict,
    crop_hw: tuple[int, int],
    flows: Sequence[torch.Tensor] | None = None,
):
    """Crop every ``(B, H, W, C)`` field at ``(oy, ox)`` to ``crop_hw`` and
    mirror it along W where ``flip``; a flip negates the u component of the
    ground-truth ``flows``. Returns ``(cropped_ims, cropped_flows_or_None)``.

    The offsets stay on the device: rows and columns are picked by index
    (a mirrored crop is the same columns counted down), so nothing waits for
    the host to read them."""
    ch, cw = crop_hw
    dev = ims[0].device
    rows = params["oy"] + torch.arange(ch, device=dev)
    ar = torch.arange(cw, device=dev)
    cols = torch.where(params["flip"], params["ox"] + (cw - 1) - ar, params["ox"] + ar)

    def crop(x: torch.Tensor) -> torch.Tensor:
        return x.index_select(1, rows).index_select(2, cols)

    out_ims = [crop(im) for im in ims]
    out_flows = None
    if flows is not None:
        sign_u = torch.where(params["flip"], -1.0, 1.0)
        out_flows = []
        for f in flows:
            fc = crop(f)
            out_flows.append(fc * torch.stack([sign_u, torch.ones_like(sign_u)]).to(fc.dtype))
    return out_ims, out_flows


def random_crop_flip(
    generator: torch.Generator,
    ims: Sequence[torch.Tensor],
    crop_hw: tuple[int, int],
    horizontal_flip: bool = True,
    flows: Sequence[torch.Tensor] | None = None,
):
    """Shared random crop (+ optional horizontal flip) of the whole batch."""
    params = sample_crop_flip_params(generator, ims[0].shape[1:3], crop_hw, horizontal_flip)
    return apply_crop_flip(ims, params, crop_hw, flows)


def sample_order_swap_params(generator: torch.Generator, batch: int, prob: float) -> torch.Tensor:
    """``(B, 1, 1, 1)`` bool: True where an example trains on (im2, im1)."""
    return torch.rand((batch, 1, 1, 1), generator=generator, device=generator.device) < prob


def apply_order_swap(
    im1: torch.Tensor, im2: torch.Tensor, swap: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.where(swap, im2, im1), torch.where(swap, im1, im2)


def random_order_swap(
    generator: torch.Generator, im1: torch.Tensor, im2: torch.Tensor, prob: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example temporal order swap with probability ``prob``
    (unsupervised training only: ground-truth flow has one direction)."""
    return apply_order_swap(im1, im2, sample_order_swap_params(generator, im1.shape[0], prob))


from unflow_tpu_torch.augment.affine import (  # noqa: E402
    AffineParams,
    apply_affine,
    random_affine,
    sample_affine_params,
)
