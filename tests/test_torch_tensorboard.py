"""The port's tfevents writer and image summaries against the JAX package's:
the same event bytes for the same scalars and image (wall time fixed), both
readers agreeing on either file, and the summary images of one set of
parameters; then the Trainer writing both."""

import io
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unflow_tpu.config import Config as ConfigJax
from unflow_tpu.train.summaries import ImageSummaryWriter as ImageSummaryWriterJax
from unflow_tpu.train.trainer import build_model as build_model_jax
from unflow_tpu.utils import tensorboard as tensorboard_jax
from unflow_tpu_torch.config import Config
from unflow_tpu_torch.convert import params_from_flax
from unflow_tpu_torch.data import DEFAULT_NORMALIZATION
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.models import build_model
from unflow_tpu_torch.train import Trainer
from unflow_tpu_torch.train.summaries import ImageSummaryWriter
from unflow_tpu_torch.utils import tensorboard

torch.set_num_threads(1)

H, W = 64, 128


def _write(module, logdir, image, monkeypatch):
    monkeypatch.setattr(module.time, "time", lambda: 1_700_000_000.25)
    writer = module.EventWriter(logdir)
    writer.scalar("loss", 1.25, step=3)
    writer.scalars({"a/b": 2.5, "eval/aee": np.float32(7.5), "skip": "not-a-number"}, step=4)
    writer.image("viz", image, step=5)
    writer.close()
    (path,) = list(logdir.glob("events.out.tfevents.*"))
    return path


def test_crc32c_matches_jax(rng):
    """Every route (the library's when present, the numpy lanes for large
    payloads, the per-byte loop) against the JAX package's, also continuing
    from a CRC, for sizes around the lanes' cut-offs."""
    payloads = [b"123456789", b"", b"\x00" * 32, bytes(range(256)) * 3]
    payloads += [rng.randint(0, 256, n).astype(np.uint8).tobytes()
                 for n in (1023, 1024, 64 * 1024 + 5, 300_001)]
    for data in payloads:
        want = tensorboard_jax.crc32c(data)
        assert tensorboard.crc32c(data) == want
        assert tensorboard._crc32c_py(data) == want
        assert tensorboard._crc32c_np(data) == want
        assert tensorboard._crc32c_np(data, 0xDEADBEEF) == tensorboard_jax.crc32c(data, 0xDEADBEEF)
    assert tensorboard.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_event_bytes_match_jax(tmp_path, rng, monkeypatch, dtype):
    image = rng.rand(6, 8, 3).astype(np.float32)
    if dtype == "uint8":
        image = (image * 255).astype(np.uint8)
    mine = _write(tensorboard, tmp_path / "port", image, monkeypatch)
    theirs = _write(tensorboard_jax, tmp_path / "jax", image, monkeypatch)
    assert mine.name == theirs.name
    assert mine.read_bytes() == theirs.read_bytes()
    for path in (mine, theirs):
        events = tensorboard.read_events(path)
        assert events == tensorboard_jax.read_events(path)
        assert events[0]["file_version"] == "brain.Event:2" and len(events) == 5
        assert events[1]["step"] == 3 and events[1]["scalars"] == {"loss": 1.25}
        assert events[2]["scalars"] == {"a/b": 2.5} and events[3]["scalars"] == {"eval/aee": 7.5}
        decoded = np.asarray(Image.open(io.BytesIO(events[4]["images"]["viz"])))
        want = image if dtype == "uint8" else (np.clip(image, 0, 1) * 255 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(decoded, want)


def test_read_events_checks_the_crc(tmp_path, rng, monkeypatch):
    path = _write(tensorboard, tmp_path, rng.rand(4, 4, 3).astype(np.float32), monkeypatch)
    raw = bytearray(path.read_bytes())
    raw[30] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC mismatch"):
        tensorboard.read_events(path)


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def test_image_summaries_match_jax(tmp_path):
    """The seven PNG strips of the same parameters and batch: frames equal,
    the rest within 2 of 255 (a flow colour or an error rounds either way)
    and the occlusion mask at no more than 1% of its pixels (a comparison
    of two float32 sums)."""
    cfg_jax, cfg = ConfigJax(), Config()
    for c in (cfg_jax, cfg):
        c.train.flownet, c.train.compute_dtype, c.train.max_displacement = "C", "float32", 4
    cfg_jax.train.corr_impl, cfg.train.corr_impl = "jnp", "torch"
    model_jax = build_model_jax(cfg_jax)
    sample = jnp.zeros((1, H, W, 3), jnp.float32)
    params = jax.jit(model_jax.init)(jax.random.PRNGKey(0), sample, sample)["params"]
    model = build_model(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    # larger than the crop: the top-left 64x128 region is summarized
    batch = next(batch_iterator(3, H + 8, W + 20, seed=2, max_shift=6.0))
    ImageSummaryWriterJax(tmp_path / "jax", model_jax, DEFAULT_NORMALIZATION).write(
        7, params, batch)
    out = ImageSummaryWriter(tmp_path / "port", DEFAULT_NORMALIZATION).write(7, model, batch)
    assert out == tmp_path / "port" / "summaries" / "step_00000007"
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "summaries" / "step_00000007")
                           .iterdir()) and len(names) == 7
    for name in names:
        got, want = _png(out / name), _png(tmp_path / "jax" / "summaries" / "step_00000007" / name)
        assert got.shape == want.shape == (2 * H, W, 3), name
        if name in ("im1.png", "im2.png"):
            np.testing.assert_array_equal(got, want)
        elif name == "occ_mask.png":
            assert (got != want).any(-1).mean() <= 0.01
        else:
            assert np.abs(got - want).max() <= 2, name


def test_trainer_writes_summaries_and_tensorboard(tmp_path):
    """``image_summary_interval = 0`` follows ``display_interval``; with
    ``tensorboard`` every logged scalar and each image strip lands in the
    event file, and the summary time stays out of the throughput window."""
    cfg = Config()
    cfg.dirs.log = str(tmp_path / "log")
    t = cfg.train
    t.flownet, t.batch_size, t.height, t.width = "S", 2, H, W
    t.compute_dtype, t.num_iters, t.display_interval = "float32", 2, 1
    t.image_summary_interval, t.tensorboard = 0, True
    batch = next(batch_iterator(2, H, W, seed=0, max_shift=3.0))
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")
    trainer.run()
    assert sorted(p.name for p in (tmp_path / "ex" / "summaries").iterdir()) == [
        "step_00000001", "step_00000002"]
    (path,) = list((tmp_path / "ex" / "tb").glob("events.out.tfevents.*"))
    events = tensorboard.read_events(path)
    records = [json.loads(line) for line in open(tmp_path / "ex" / "metrics.jsonl")]
    by_step = {}
    for e in events:
        if e["scalars"]:  # one event per scalar
            by_step.setdefault(e["step"], {}).update(e["scalars"])
    assert sorted(by_step) == [r["step"] for r in records] == [1, 2]
    for r in records:
        assert set(by_step[r["step"]]) == set(r) - {"step", "time"}
        assert by_step[r["step"]]["loss"] == pytest.approx(r["loss"], rel=1e-6)
    images = {tag for e in events for tag in e["images"]}
    assert images == {"im1", "im2", "flow_fw", "flow_bw", "im2_warped", "error", "occ_mask"}
