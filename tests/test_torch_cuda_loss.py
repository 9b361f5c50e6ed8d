"""The fused loss kernels (``ops/cuda/loss.py``, ``csrc/loss.cu``) against the
composite terms (``losses/unsupervised.py``) on the card, in float32, and the
path ``unsupervised_loss`` takes.

The tests marked ``cuda`` skip without an NVIDIA GPU. The composite runs on
the card too: frames that take a gradient send ``unsupervised_loss`` down the
composite path and change no value. The others run anywhere: the path is
chosen from what the call sees. The file imports no JAX, so on the card it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_loss.py
"""

import socket

import pytest
import torch
import torch.distributed as dist

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.losses import DEFAULT_WEIGHTS, unsupervised_loss
from unflow_tpu_torch.losses.unsupervised import fused_spec
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.ops.cuda import loss as fused
from unflow_tpu_torch.parallel.spatial import SpatialContext
from unflow_tpu_torch.train import build_optimizer, make_train_step
from unflow_tpu_torch.train.trainer import TrainState, freeze_stages

torch.set_num_threads(1)

# the values: the same terms summed in another order; the gradients: the
# same sums in another order (the composite's warp scatters with float atomics)
VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
PAPER = dict(DEFAULT_WEIGHTS)  # occ, fb, ternary, smooth_2nd
WITH_PHOTO = {**DEFAULT_WEIGHTS, "photo": 1.0}
# C's training crop and batch, and an odd size whose coarse levels are odd
GEOMETRIES = {"c_crop": (8, 320, 1152), "odd": (3, 192, 448)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(batch, h, w, device, seed, amplitude=0.3):
    """Frames as the train step hands them over (NCHW views of NHWC
    memory) and one stacked pyramid per level whose even rows are the
    forward flows and odd rows the backward ones, as the network's."""
    g = torch.Generator(device=device).manual_seed(seed)
    im1 = torch.rand(batch, h, w, 3, device=device, generator=g)
    # the second frame: the first moved by a few pixels, plus noise
    im2 = torch.roll(im1, (2, 3), (1, 2)) * 0.9 + 0.1 * torch.rand(batch, h, w, 3, device=device, generator=g)
    flows = [(torch.randn(2 * batch, 2, h // (4 << i), w // (4 << i), device=device, generator=g)
              * amplitude).requires_grad_() for i in range(5)]
    return im1.permute(0, 3, 1, 2), im2.permute(0, 3, 1, 2), flows


def _loss(im1, im2, flows, composite=False, **kwargs):
    if composite:  # frames that take a gradient take the composite terms
        im1, im2 = im1.clone().requires_grad_(), im2.clone().requires_grad_()
    return unsupervised_loss(im1, im2, [f[0::2] for f in flows], [f[1::2] for f in flows], **kwargs)


def _launched(fn):
    """``fn()``'s result and the fused kernels' launches it counted."""
    before = fused.launch_counts()
    out = fn()
    return out, {k: n - before[k] for k, n in fused.launch_counts().items()}


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("weights,border_ratio,amplitude", [
    (PAPER, 0.0, 0.3), (WITH_PHOTO, 0.1, 0.3), (PAPER, 0.0, 3.0)],
    ids=["paper", "photo_border", "large_flows"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_fused_matches_the_composite(cuda_device, geometry, weights, border_ratio, amplitude):
    im1, im2, flows = _inputs(*GEOMETRIES[geometry], cuda_device, seed=len(geometry),
                              amplitude=amplitude)
    kwargs = dict(weights=weights, border_ratio=border_ratio)
    (total, logs), launched = _launched(lambda: _loss(im1, im2, flows, **kwargs))
    assert launched == dict.fromkeys(fused.FORWARD_KERNELS, 1) | dict.fromkeys(fused.BACKWARD_KERNELS, 0)
    grads, launched = _launched(lambda: torch.autograd.grad(total, flows))
    assert launched == dict.fromkeys(fused.FORWARD_KERNELS, 0) | dict.fromkeys(fused.BACKWARD_KERNELS, 1)

    (want_total, want_logs), launched = _launched(
        lambda: _loss(im1, im2, flows, composite=True, **kwargs))
    assert not any(launched.values())
    want_grads = torch.autograd.grad(want_total, flows)

    assert list(logs) == list(want_logs)
    for key, want in want_logs.items():
        assert float(logs[key]) == pytest.approx(float(want), rel=VALUE_RTOL, abs=1e-9), key
    assert total.dtype == torch.float32 and total.shape == ()
    for level, (got, want) in enumerate(zip(grads, want_grads)):
        assert _rel_l2(got, want) < GRAD_RTOL, level


@pytest.mark.cuda
def test_a_replayed_loss_matches_the_eager_one(cuda_device):
    im1, im2, flows = _inputs(8, 320, 1152, cuda_device, seed=5)

    def loss_and_grads():
        total, logs = _loss(im1, im2, flows)
        return [total, logs["ternary/scale0"], *torch.autograd.grad(total, flows)]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = loss_and_grads()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = loss_and_grads()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    # every sum runs in a fixed order or in integers: equal to the bit
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("written", ["frame", "flow"])
def test_a_tensor_written_before_the_backward_raises(cuda_device, written):
    """The frames and flows are saved for the backward, so autograd sees a
    write into one of them between the forward and the backward."""
    im1, im2, flows = _inputs(2, 64, 128, cuda_device, seed=11)
    total, _ = _loss(im1, im2, flows)
    with torch.no_grad():
        (im1 if written == "frame" else flows[0]).mul_(2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        torch.autograd.grad(total, flows)


def _config(**overrides):
    cfg = Config()
    keys = dict(flownet="C", batch_size=2, height=64, width=128, image_summary_interval=-1,
                compute_dtype="float32")
    keys.update(overrides)
    for key, value in keys.items():
        setattr(cfg.train, key, value)
    return cfg


def _state(cfg, device):
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    freeze_stages(model, cfg.train.flownet)
    model = model.to(device=device, memory_format=torch.channels_last).train()
    return TrainState(model, build_optimizer(cfg, model))


@pytest.mark.cuda
def test_train_steps_count_the_loss_launches_on_both_paths(cuda_device):
    cfg = _config()
    step = make_train_step(cfg)
    graphed, eager = _state(cfg, cuda_device), _state(cfg, cuda_device)
    batches = [{k: torch.from_numpy(v).to(cuda_device)
                for k, v in next(batch_iterator(2, 64, 128, seed=k)).items()} for k in range(4)]
    # a warm-up step, a capture replayed, and two replays
    _, replayed = _launched(lambda: [step(graphed, b) for b in batches])
    _, taken = _launched(lambda: [step.eager(eager, b) for b in batches])
    assert replayed == taken == dict.fromkeys(fused.KERNELS, 4)
    assert float(step(graphed, batches[0])["loss"]) == pytest.approx(
        float(step.eager(eager, batches[0])["loss"]), rel=1e-3)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
@pytest.mark.parametrize("fallback", ["w_sharded", "disocc", "grad", "smooth_1st", "images_grad"])
def test_each_fallback_takes_the_composite(cuda_device, fallback):
    im1, im2, flows = _inputs(2, 64, 128, cuda_device, seed=7)
    kwargs = {"disocc": dict(mask_occlusion="disocc"),
              "grad": dict(weights={**PAPER, "grad": 0.5}),
              "smooth_1st": dict(weights={**PAPER, "smooth_1st": 0.5})}.get(fallback, {})
    (want, _), _ = _launched(lambda: _loss(im1, im2, flows, composite=True, **kwargs))
    if fallback == "images_grad":
        (got, _), launched = _launched(lambda: _loss(im1, im2, flows, composite=True))
    elif fallback == "w_sharded":
        # one slab of the whole frame: the composite's sharded terms, which
        # exchange over a process group of one
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            with SpatialContext(dist.group.WORLD, 1, 0, (128 // 64,)):
                (got, _), launched = _launched(lambda: _loss(im1, im2, flows))
        finally:
            dist.destroy_process_group()
    else:
        (got, _), launched = _launched(lambda: _loss(im1, im2, flows, **kwargs))
    assert not any(launched.values())
    assert float(got) == pytest.approx(float(want), rel=VALUE_RTOL)
    assert got.grad_fn is not None and "FusedLoss" not in type(got.grad_fn).__name__


@pytest.mark.parametrize("weights", [PAPER, WITH_PHOTO], ids=["paper", "photo"])
def test_the_cpu_takes_the_composite(weights):
    """On the CPU ``fused_spec`` declines whatever the terms, and the loss
    launches no fused kernel (the card's choices are the tests above)."""
    im1, im2, flows = _inputs(2, 64, 128, torch.device("cpu"), seed=9)
    fws, bws = [f[0::2] for f in flows], [f[1::2] for f in flows]
    assert fused_spec(im1, im2, fws, bws, weights, "fb", 0.0) is None
    (total, logs), launched = _launched(lambda: _loss(im1, im2, flows, weights=weights))
    assert not any(launched.values()) and total.grad_fn is not None
    assert ("photo/scale0" in logs) == bool(weights["photo"])
