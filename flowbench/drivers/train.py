"""Training traffic: the port's trainer fed by its Loader over a packed set
of synthetic drives, as a user trains after ``cli.pack``.

Set-up makes the drives from the seed, writes their frames as image files,
packs the consecutive pairs with the port's ``pack_examples`` at the
training crop and builds one ``Trainer`` on weights made from the seed. Its
first ``checked_steps`` steps (distinct pairs, through the window's own
call and feed) are the ones the reference follows after the window; then
``warmup_steps`` more, and the window: ``next(batches)`` and
``trainer.train_step(batch)`` until the clock passes the deadline, ending
in a synchronize.
"""

from __future__ import annotations

import hashlib
import shutil
import time

import numpy as np
import torch

from flowbench import check, frames, trace as tracing
from flowbench.flops import train_step_flops
from flowbench.readers import Run
from flowbench.reference import quant
from flowbench.reference.train import train_steps
from flowbench.weights import make_weights

BETA1 = 0.9


def port_config(s, seeds, packed_dir):
    """The port's ``Config`` of the run: the configuration file's keys, the
    seed's and the packed set."""
    cfg = s.port_config()
    cfg.train.seed = seeds["config"]
    cfg.train.packed_dir = str(packed_dir)
    cfg.dirs.log = str(s.workdir / "log")
    cfg.dirs.data = str(s.workdir / "data")
    return cfg


def center_crop(im: np.ndarray, hw) -> np.ndarray:
    """The centre ``hw`` of a frame at least that large (a packed frame)."""
    (h, w), (th, tw) = im.shape[:2], hw
    y, x = (h - th) // 2, (w - tw) // 2
    return im[y:y + th, x:x + tw]


def row_key(im1: np.ndarray, im2: np.ndarray) -> str:
    return hashlib.blake2b(im1.tobytes() + im2.tobytes(), digest_size=16).hexdigest()


def write_ppm(path, im: np.ndarray) -> None:
    h, w, _ = im.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(im).tobytes())


def make_pairs(s, seeds, t):
    """Host uint8 frames ``(drives, frames, H, W, 3)`` and the list of their
    consecutive pairs as ``(drive, frame)``."""
    drives = frames.make_drives(seeds["frames"], t["drives"], t["frames_per_drive"],
                                t["frame_hw"], t["motion"],
                                s.device).cpu().numpy()
    pairs = [(d, f) for d in range(t["drives"]) for f in range(t["frames_per_drive"] - 1)]
    return drives, pairs


def pack(s, drives, pairs, hw):
    """Write the frames as files, pack the pairs with the port and delete the
    files; the packed directory."""
    from unflow_tpu_torch.data.base import Example
    from unflow_tpu_torch.data.packed import pack_examples

    raw = s.workdir / "frames"
    raw.mkdir(parents=True, exist_ok=True)
    for d in range(drives.shape[0]):
        for f in range(drives.shape[1]):
            write_ppm(raw / f"{d:02d}_{f:04d}.ppm", drives[d, f])
    examples = [Example(im1=str(raw / f"{d:02d}_{f:04d}.ppm"),
                        im2=str(raw / f"{d:02d}_{f + 1:04d}.ppm")) for d, f in pairs]
    out = pack_examples(examples, s.workdir / "packed", load_hw=hw)
    shutil.rmtree(raw)
    return out


def setup(s) -> dict:
    """Everything before the window: the packed drives, the trainer on the
    seed's weights, and its checked and warm-up steps with the numbers the
    reference is held to."""
    from unflow_tpu_torch.data.base import Loader
    from unflow_tpu_torch.data.packed import PackedExamples
    from unflow_tpu_torch.train import Trainer

    t = s.traffic
    keys = s.train_keys()
    seeds = s.seeds()
    hw = (keys["height"], keys["width"])
    drives, pairs = make_pairs(s, seeds, t)  # held for the reference
    pack(s, drives, pairs, hw)
    cfg = port_config(s, seeds, s.workdir / "packed")
    loader = Loader(PackedExamples(s.workdir / "packed"), batch_size=keys["batch_size"], load_hw=hw,
                    seed=cfg.train.seed, num_threads=t["loader_threads"], prefetch=t["prefetch"],
                    image_dtype="uint8")
    batches = iter(loader)
    weights = make_weights(keys["flownet"], seeds["weights"], s.device, keys["max_displacement"],
                           keys["corr_stride"])
    trainer = Trainer(cfg, s.workdir / "log" / "ex" / "bench", batches,
                      normalization=tuple(s.config["normalization"]), device=s.device,
                      params={k: v.clone() for k, v in weights.items()})
    named = dict(trainer.model.named_parameters())
    trainable = [k for k, p in named.items() if p.requires_grad]
    start = {k: named[k].detach().clone() for k in trainable}

    # the checked steps: the reference follows them after the window
    fed, losses, grad_norms = [], [], None
    for step in range(t["checked_steps"]):
        batch = next(batches)
        fed.append([row_key(a, b) for a, b in zip(batch["im1"], batch["im2"])])
        logs = trainer.train_step(batch)
        losses.append(logs["loss"].detach().clone().float())
        if step == 0:
            state = trainer.state.optimizer.state
            grad_norms = {k: float(state[named[k]]["exp_avg"].norm()) / (1 - BETA1)
                          if "exp_avg" in state.get(named[k], {}) else 0.0 for k in trainable}
    change_norms = {k: float((named[k].detach() - start[k]).norm()) for k in trainable}
    del start
    for _ in range(t["warmup_steps"]):
        trainer.train_step(next(batches))
    return {"trainer": trainer, "batches": batches, "weights": weights, "drives": drives,
            "pairs": pairs, "fed": fed, "hw": hw,
            "program": {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                        "change_norms": change_norms}}


def window(s, st) -> dict:
    """The timed window, then (traced runs) the profiled stretch."""
    trainer, batches = st["trainer"], st["batches"]
    spans = {"input": [], "train_step": []}
    s.sync()
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    clock = time.perf_counter
    t_start = clock()
    setup_s = time.time() - s.t0
    deadline = t_start + s.seconds
    steps = 0
    while clock() < deadline:
        if s.trace:
            a = clock()
            batch = next(batches)
            b = clock()
            trainer.train_step(batch)
            spans["input"].append(b - a)
            spans["train_step"].append(clock() - b)
        else:
            trainer.train_step(next(batches))
        steps += 1
    s.sync()
    window_s = clock() - t_start
    peak = torch.cuda.max_memory_allocated(s.device) if s.device.type == "cuda" else 0
    traced = profile_steps(s, trainer, batches, s.traffic["profile_steps"]) if s.trace else None
    return {"setup_s": setup_s, "window_s": window_s, "steps": steps, "spans": spans,
            "peak": peak, "traced": traced}


def teardown(s, st) -> None:
    """Stop the Loader and free the program's state."""
    st["batches"].close()
    st.pop("trainer", None)
    st.pop("batches", None)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def run(s) -> tuple[Run, dict]:
    st = setup(s)
    w = window(s, st)
    traced = w["traced"]
    teardown(s, st)
    keys, hw, batch = s.train_keys(), st["hw"], s.train_keys()["batch_size"]
    run = Run(kind="train", chips=1, setup_s=w["setup_s"], window_s=w["window_s"],
              units=w["steps"], pairs_per_unit=batch, latencies_s=[], peak_bytes=w["peak"],
              flops_per_unit=train_step_flops(keys["flownet"], batch, *hw,
                                              keys["max_displacement"], keys["corr_stride"]),
              peak_flops=None, bytes_per_s=None,
              corr_shape=(2 * batch, hw[0] // 8, hw[1] // 8, 256),
              corr_d=2 * (keys["max_displacement"] // keys["corr_stride"]) + 1,
              dtype_bytes=2 if keys["compute_dtype"] == "bfloat16" else 4,
              spans=w["spans"], trace=traced,
              traced_units=s.traffic["profile_steps"] if s.trace else 0)
    # the reference: each checked step's batch, from the frames the benchmark
    # made, found by the rows the program was fed
    numbers = reference_numbers(s, st)
    busy = [] if traced is None else [(traced.busy_s, traced.window_s)]
    return run, {"numbers": numbers, "attempted": w["steps"], "busy": busy}


def reference_batches(drives, pairs, fed_rows, hw):
    """The uint8 batches of the checked steps, or None when a fed row is none
    of the packed pairs."""
    index = {}
    for i, (d, f) in enumerate(pairs):
        index[row_key(center_crop(drives[d, f], hw), center_crop(drives[d, f + 1], hw))] = i
    out = []
    for keys in fed_rows:
        if any(k not in index for k in keys):
            return None
        sel = [pairs[index[k]] for k in keys]
        im1 = np.stack([center_crop(drives[d, f], hw) for d, f in sel])
        im2 = np.stack([center_crop(drives[d, f + 1], hw) for d, f in sel])
        out.append((torch.from_numpy(im1), torch.from_numpy(im2)))
    return out


def reference_result(s, weights, batches, precision="bf16", fault=None) -> dict:
    """The reference's checked steps (``precision`` fp8: the control;
    ``fault``: ``half_batch`` planted in it)."""
    cfg = {**s.train_keys(), "seed": s.seeds()["config"]}
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    with check.plain_precision():
        return train_steps(weights, batches, cfg, tuple(s.config["normalization"]), s.device,
                           quant=quant.QUANT[precision], half_batch=fault == "half_batch")


def reference_numbers(s, st) -> dict:
    """The compared numbers of the program's checked steps (``st`` from
    :func:`setup`)."""
    batches = reference_batches(st["drives"], st["pairs"], st["fed"], st["hw"])
    if batches is None:
        return check.unmatched()
    return check.train_numbers(st["program"], reference_result(s, st["weights"], batches))


def profile_steps(s, trainer, batches, count):
    """The device trace of ``count`` steps after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    s.sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if s.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            for _ in range(count):
                with record_function("flowbench.input"):
                    batch = next(batches)
                with record_function("flowbench.train_step"):
                    trainer.train_step(batch)
            s.sync()
    return tracing.reduce(prof)

