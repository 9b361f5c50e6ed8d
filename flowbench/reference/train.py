"""UnFlow's training step, written plainly: augmentation, the cascade, the
unsupervised loss of its last stage, the gradient and Adam.

The augmentation draws follow the port's documented stream, so that both
sides see the same pixels: one generator per step on the frames' device,
seeded ``(seed * 1_000_003 + step) mod 2**63``, drawing in this order one
crop offset (``oy``, ``ox``) and one horizontal flip for the whole batch,
then per example a contrast in [-0.3, 0.3], a gamma in [0.7, 1.5], a
brightness of stddev 0.02, a colour per channel in [0.9, 1.1] and, per frame,
gaussian noise of stddev ``aug_noise_stddev`` over every pixel. The
photometric change feeds the network only; the loss sees the cropped pair.
Adam is ``b1 = 0.9, b2 = 0.999, eps = 1e-8`` with bias correction.
"""

from __future__ import annotations

import torch

from flowbench.reference.flownet import Net
from flowbench.reference.loss import unsupervised_loss

BETAS = (0.9, 0.999)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EPS = 1e-8


def augment_draws(device, seed: int, step: int, batch: int, hw, crop_hw, cfg: dict) -> dict:
    """The draws of one step for a global batch of ``batch`` pairs."""
    if cfg.get("aug_swap_prob", 0.0):
        raise NotImplementedError("aug_swap_prob")
    if any(cfg.get(k, 0.0) for k in ("aug_translate", "aug_rotate", "aug_rel_translate",
                                     "aug_rel_rotate", "aug_rel_zoom")) or \
            cfg.get("aug_zoom_min", 1.0) != 1.0 or cfg.get("aug_zoom_max", 1.0) != 1.0:
        raise NotImplementedError("affine augmentation")
    g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % 2 ** 63)
    (h, w), (ch, cw) = hw, crop_hw
    d = {
        "oy": torch.randint(0, h - ch + 1, (), generator=g, device=device),
        "ox": torch.randint(0, w - cw + 1, (), generator=g, device=device),
        "flip": (torch.rand((), generator=g, device=device) < 0.5) & cfg.get("aug_hflip", True),
    }
    if cfg.get("aug_photometric", True):
        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

        d["contrast"] = uniform((batch, 1, 1, 1), -0.3, 0.3)
        d["gamma"] = uniform((batch, 1, 1, 1), 0.7, 1.5)
        d["bright"] = 0.02 * torch.randn((batch, 1, 1, 1), generator=g, device=device)
        d["colour"] = uniform((batch, 1, 1, 3), 0.9, 1.1)
        sd = cfg.get("aug_noise_stddev", 0.04)
        d["noise"] = [sd * torch.randn((batch, ch, cw, 3), generator=g, device=device)
                      for _ in range(2 if sd > 0 else 0)]
    return d


def augment(im1, im2, d: dict, rows: slice, crop_hw):
    """uint8 ``(B, H, W, 3)`` frames -> the cropped pair and the pair the
    network sees, ``(B, 3, h, w)`` float32 in [0, 1]."""
    ch, cw = crop_hw
    dev = im1.device
    ys = d["oy"] + torch.arange(ch, device=dev)
    ar = torch.arange(cw, device=dev)
    xs = torch.where(d["flip"], d["ox"] + cw - 1 - ar, d["ox"] + ar)
    crop = [im.float().div(255.0)[:, ys][:, :, xs] for im in (im1, im2)]
    seen = crop
    if "contrast" in d:
        seen = []
        for i, im in enumerate(crop):
            im = ((im * (1.0 + d["contrast"][rows]) + d["bright"][rows]) * d["colour"][rows])
            im = im.clamp(0.0, 1.0) ** (1.0 / d["gamma"][rows])
            if d["noise"]:
                im = im + d["noise"][i][rows]
            seen.append(im.clamp(0.0, 1.0))
    nchw = lambda x: x.permute(0, 3, 1, 2)  # noqa: E731
    return [nchw(x) for x in crop], [nchw(x) for x in seen]


def normalize(im, mean, std):
    return (im * 255.0 - torch.tensor(mean, device=im.device)[:, None, None]) / std


def train_steps(params: dict, batches: list, cfg: dict, normalization, device, quant=None,
                half_batch: bool = False):
    """Run ``len(batches)`` steps of the configuration ``cfg`` (the train
    keys of a ``flowbench/configs`` file) from ``params`` on the uint8
    ``(im1, im2)`` batches. ``half_batch`` keeps the first half of each
    batch's rows (a fault).

    Returns the step losses, the per-leaf norms of the first gradient and the
    per-leaf norms of the change of every trainable parameter."""
    if cfg.get("train_all") or cfg.get("supervised"):
        raise NotImplementedError("train_all or supervised training")
    spec = cfg["flownet"]
    mean, std = normalization
    crop_hw = (cfg["height"], cfg["width"])
    trainable = [k for k in params if spec[int(k.split("_")[0][len("stage"):])].isupper()]
    theta = {k: v.detach().float().clone().to(device) for k, v in params.items()}
    start = {k: theta[k].clone() for k in trainable}
    m = {k: torch.zeros_like(theta[k]) for k in trainable}
    v = {k: torch.zeros_like(theta[k]) for k in trainable}
    weights = {k[:-len("_weight")]: cfg[k] for k in cfg if k.endswith("_weight")}
    losses, first_grad = [], None
    for step, (im1, im2) in enumerate(batches):
        im1, im2 = im1.to(device), im2.to(device)
        b = im1.shape[0]
        d = augment_draws(device, cfg["seed"], step, b, im1.shape[1:3], crop_hw, cfg)
        for k in trainable:
            theta[k].requires_grad_(True)
        net = Net(spec, theta, dtype=DTYPES[cfg["compute_dtype"]],
                  max_displacement=cfg["max_displacement"], stride=cfg["corr_stride"], quant=quant)
        rows = slice(0, b // 2 if half_batch else b)
        (c1, c2), (s1, s2) = augment(im1[rows], im2[rows], d, rows, crop_hw)
        n1, n2 = normalize(s1, mean, std), normalize(s2, mean, std)
        stages = net(torch.cat([n1, n2]), torch.cat([n2, n1]))
        n = n1.shape[0]
        last = stages[-1]
        loss = unsupervised_loss(c1, c2, [f[:n] for f in last], [f[n:] for f in last],
                                 weights, cfg.get("mask_occlusion", "fb"))
        grads = dict(zip(trainable, (g.float() for g in
                                     torch.autograd.grad(loss, [theta[k] for k in trainable]))))
        losses.append(float(loss.detach()))
        del stages, loss
        with torch.no_grad():
            if first_grad is None:
                first_grad = {k: float(grads[k].norm()) for k in trainable}
            t = step + 1
            lr = learning_rate(cfg, step)
            for k in trainable:
                theta[k].requires_grad_(False)
                m[k].mul_(BETAS[0]).add_(grads[k], alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(grads[k], grads[k], value=1 - BETAS[1])
                denom = (v[k] / (1 - BETAS[1] ** t)).sqrt() + EPS
                theta[k] -= lr * (m[k] / (1 - BETAS[0] ** t)) / denom
    change = {k: float((theta[k] - start[k]).norm()) for k in trainable}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


def learning_rate(cfg: dict, step: int) -> float:
    """Halved every ``decay_interval`` steps from ``decay_after`` on."""
    halvings = max(0, (step - cfg["decay_after"]) // cfg["decay_interval"] + 1)
    return cfg["learning_rate"] * 0.5 ** halvings
