"""``Evaluator.predict_batch`` pads, normalizes and crops on the device: its
network input and its flow are held, bit for bit, to the host path it
replaced (``np.pad`` and a float32 cast on the host, ``predict_flow``, the
crop of the host's copy), for aligned and unaligned shapes, batches of one
and two, and frames that are contiguous float32, a negative-stride view or
float64; the counter ``infer.padded_requests`` grows exactly when a pad
engages; frames of two shapes are refused.

The test marked ``cuda`` skips without an NVIDIA GPU. The file imports no
JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_infer_device_pad.py
"""

import numpy as np
import pytest
import torch

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.eval.evaluate import Evaluator, predict_flow
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.utils.profiling import counts

torch.set_num_threads(1)


def _evaluator(device, dtype="float32", max_displacement=4):
    cfg = Config()
    cfg.train.flownet, cfg.train.compute_dtype = "C", dtype
    cfg.train.max_displacement = max_displacement
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    return Evaluator(cfg, params=model.state_dict(), device=device)


def _host_path(ev, ims1, ims2):
    """The host path that ``predict_batch`` replaced: the padded network
    input it fed, and its flow."""
    b, h, w, _ = ims1.shape
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    pad = ((0, 0), (0, hp - h), (0, wp - w), (0, 0))
    p1 = torch.from_numpy(np.pad(ims1, pad).astype(np.float32)).to(ev.device)
    p2 = torch.from_numpy(np.pad(ims2, pad).astype(np.float32)).to(ev.device)
    inputs = []
    hook = ev.model.register_forward_pre_hook(lambda m, args: inputs.append(args))
    try:
        with torch.inference_mode():
            flow = predict_flow(ev.model, p1, p2, ev.normalization).cpu()
    finally:
        hook.remove()
    return inputs[0], flow.numpy()[:, :h, :w]


def _device_path(ev, ims1, ims2):
    """``predict_batch``'s network input and flow."""
    inputs = []
    hook = ev.model.register_forward_pre_hook(lambda m, args: inputs.append(args))
    try:
        flow = ev.predict_batch(ims1, ims2)
    finally:
        hook.remove()
    return inputs[0], flow


@pytest.fixture(scope="module")
def cpu_evaluator():
    return _evaluator("cpu")


FRAMES = {
    "float32": lambda a: a.astype(np.float32),
    "negative_stride": lambda a: a.astype(np.float32)[:, ::-1, ::-1],
    "float64": lambda a: a,
}


@pytest.mark.parametrize("frames", sorted(FRAMES))
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("hw", [(64, 128), (60, 128), (64, 100), (60, 100)],
                         ids=["aligned", "h_only", "w_only", "both"])
def test_device_padding_matches_the_host_path_bit_for_bit(cpu_evaluator, hw, batch, frames):
    rng = np.random.RandomState(hw[0] + hw[1] + batch)
    ims1, ims2 = (FRAMES[frames](rng.rand(batch, *hw, 3)) for _ in range(2))
    assert (ims1.dtype == np.float64) == (frames == "float64")
    assert (ims1.strides[1] < 0) == (frames == "negative_stride")
    want_inputs, want = _host_path(cpu_evaluator, ims1, ims2)
    before = counts().get("infer.padded_requests", 0)
    got_inputs, got = _device_path(cpu_evaluator, ims1, ims2)
    assert counts()["infer.padded_requests"] - before == int(hw != (64, 128))
    for g, w in zip(got_inputs, want_inputs):
        assert g.shape == w.shape == (batch, 3, 64, 128)
        assert g.stride() == w.stride()
        assert torch.equal(g, w)
    assert got.shape == (batch, *hw, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_frames_of_two_shapes_are_refused(cpu_evaluator):
    ims = np.zeros((2, 60, 100, 3), np.float32)
    with pytest.raises(ValueError, match="shapes"):
        cpu_evaluator.predict_batch(ims, ims[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_device_padding_at_kittis_size_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ev = _evaluator(torch.device("cuda"), dtype, max_displacement=20)
        rng = np.random.RandomState(1)
        ims1, ims2 = (rng.rand(1, 375, 1242, 3).astype(np.float32) for _ in range(2))
        want_inputs, want = _host_path(ev, ims1, ims2)
        got_inputs, got = _device_path(ev, ims1, ims2)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for g, w in zip(got_inputs, want_inputs):
        assert g.shape == (1, 3, 384, 1280) and g.stride() == w.stride()
        assert torch.equal(g, w)
    assert got.shape == want.shape == (1, 375, 1242, 2)
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{dtype}: relative L2 of the flows {gap:.3e}, equal {np.array_equal(got, want)}")
    assert gap <= 1e-6
