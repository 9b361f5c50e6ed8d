"""The train step's update as one CUDA graph (``train/graph.py``) against the
same step dispatched eagerly.

The tests marked ``cuda`` skip without an NVIDIA GPU; each holds the graph
path (``make_train_step``'s ``train_step``) against the eager one
(``train_step.eager``) on the same batches. The others run anywhere: which
runs take the graph path, the step counters on the CPU, and a checkpoint
restored across the two kinds of Adam. The file imports no JAX, so on the
card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graph.py
"""

import itertools

import numpy as np
import pytest
import torch

from unflow_tpu_torch.config import Config
from unflow_tpu_torch.data.synthetic import batch_iterator
from unflow_tpu_torch.models import build_model, init_params
from unflow_tpu_torch.ops.cuda.correlation import launch_counts
from unflow_tpu_torch.train import CheckpointManager, Trainer, build_optimizer, make_train_step
from unflow_tpu_torch.train.trainer import TrainState, freeze_stages, replays_as_graph
from unflow_tpu_torch.utils.profiling import counts

torch.set_num_threads(1)

H, W, BATCH = 64, 128, 2
# bf16 noise, as in test_torch_cuda.py: the largest error within 2% of the
# largest magnitude
TOL = 0.02
# the losses and the gradient norm: the same kernels on the same inputs,
# apart from the order of atomic sums
LOSS_RTOL = 1e-3
CASES = {
    "c": dict(flownet="C", grad_clip_norm=1.0),
    "css": dict(flownet="csS"),
    "supervised": dict(flownet="C", supervised=True),
    "remat": dict(flownet="C", remat=True),
}


def _config(tmp_path=None, **overrides):
    cfg = Config()
    if tmp_path is not None:
        cfg.dirs.log = str(tmp_path / "log")
    keys = dict(flownet="C", batch_size=BATCH, height=H, width=W, image_summary_interval=-1,
                display_interval=1000, save_interval=1000)
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


def _batch(k, device, supervised=False, batch=BATCH):
    host = next(batch_iterator(batch, H, W, seed=k, supervised=supervised))
    return {key: torch.from_numpy(v).to(device) for key, v in host.items()}


def _counted(name):
    return counts().get(name, 0)


def _assert_close(got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


def _assert_states_close(a: TrainState, b: TrainState):
    assert a.step == b.step
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        _assert_close(pa.detach(), pb.detach())
        if pa.requires_grad:
            for key in ("exp_avg", "exp_avg_sq"):
                _assert_close(a.optimizer.state[pa][key], b.optimizer.state[pb][key])


def _assert_logs_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=LOSS_RTOL, abs=1e-7), key


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("device,processes,spatial_shards,graph", [
    ("cpu", 1, 1, False),
    ("cuda", 2, 1, False),
    ("cuda", 4, 2, False),
    ("cuda", 1, 2, False),
    ("cuda", 1, 1, True),
], ids=["cpu", "ddp", "w_sharded", "spatial_shards", "one_gpu"])
def test_only_one_process_on_a_gpu_replays_a_graph(device, processes, spatial_shards, graph):
    assert replays_as_graph(torch.device(device), processes, spatial_shards) is graph


def test_a_cpu_trainer_counts_its_steps_and_replays_none(tmp_path):
    cfg = _config(tmp_path, compute_dtype="float32", max_displacement=4, corr_impl="torch",
                  aug_photometric=False)
    batch = next(batch_iterator(BATCH, H, W, seed=0))
    trainer = Trainer(cfg, tmp_path / "ex", itertools.repeat(batch), device="cpu")
    steps, replays = _counted("train.steps"), _counted("train.graph_replays")
    for _ in range(3):
        logs = trainer.train_step(batch)
    assert _counted("train.steps") == steps + 3
    assert _counted("train.graph_replays") == replays
    assert np.isfinite(float(logs["loss"])) and float(logs["lr"]) == cfg.train.learning_rate
    group = trainer.state.optimizer.param_groups[0]
    assert not group["capturable"] and isinstance(group["lr"], float)


def test_a_checkpoint_of_a_capturable_adam_restores_into_a_cpu_adam(tmp_path):
    cfg = _config(flownet="S", compute_dtype="float32")
    state = _state(cfg, "cpu")
    manager = CheckpointManager(tmp_path)
    manager.save(3, state.model, state.optimizer)
    # what a GPU run saves: a capturable Adam, its rate a tensor, its step
    # counts float32 tensors (on the host after the load)
    path = tmp_path / "checkpoints" / "3.pt"
    ckpt = torch.load(path, weights_only=True)
    ids = ckpt["optimizer"]["param_groups"][0]["params"]
    for group in ckpt["optimizer"]["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(5e-5))
    ckpt["optimizer"]["state"] = {
        i: {"step": torch.tensor(3.0), "exp_avg": torch.full_like(p, 0.5),
            "exp_avg_sq": torch.full_like(p, 0.25)}
        for i, p in zip(ids, (p for p in state.model.parameters() if p.requires_grad))}
    torch.save(ckpt, path)

    fresh = _state(cfg, "cpu")
    assert manager.restore(fresh.model, fresh.optimizer) == 3
    group = fresh.optimizer.param_groups[0]
    assert group["capturable"] is False and group["lr"] == cfg.train.learning_rate
    for p in group["params"]:
        moments = fresh.optimizer.state[p]
        assert moments["step"].device.type == "cpu" and float(moments["step"]) == 3.0
        assert float(moments["exp_avg"].flatten()[0]) == 0.5
    step = make_train_step(_config(flownet="S", compute_dtype="float32", aug_photometric=False))
    logs = step(fresh, _batch(0, "cpu"))
    assert fresh.step == 1 and np.isfinite(float(logs["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_steps_follow_eager_steps(cuda_device, case):
    cfg = _config(**CASES[case])
    supervised = cfg.train.supervised
    step = make_train_step(cfg)
    graphed, eager = _state(cfg, cuda_device), _state(cfg, cuda_device)
    replays = _counted("train.graph_replays")
    for k in range(5):
        batch = _batch(k, cuda_device, supervised)
        _assert_logs_close(step(graphed, batch), step.eager(eager, batch))
    # the first step warms up eagerly; the second is captured and replayed
    assert _counted("train.graph_replays") == replays + 4
    _assert_states_close(graphed, eager)


@pytest.mark.cuda
def test_a_decay_boundary_halves_the_replayed_update_without_a_new_capture(
        cuda_device, monkeypatch):
    captures = []

    class Counted(torch.cuda.CUDAGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            captures.append(self)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Counted)
    torch.backends.cudnn.deterministic = True
    try:
        # no augmentation and frames of the crop's size: a step's frames do
        # not depend on its number, so a step can be taken again at another
        cfg = _config(decay_after=2, decay_interval=100, aug_photometric=False, aug_hflip=False)
        step = make_train_step(cfg)
        state = _state(cfg, cuda_device)
        batch = _batch(0, cuda_device)
        for _ in range(2):
            step(state, batch)
        params = [p for p in state.model.parameters() if p.requires_grad]
        saved = [p.detach().clone() for p in params]
        moments = {id(p): {k: v.clone() for k, v in state.optimizer.state[p].items()}
                   for p in params}

        def update(at: int):
            for p, p0 in zip(params, saved):
                p.data.copy_(p0)
                for k, v in moments[id(p)].items():
                    state.optimizer.state[p][k].copy_(v)
            state.step = at
            logs = step(state, batch)
            return float(logs["lr"]), [p.detach() - p0 for p, p0 in zip(params, saved)]

        lr_half, halved = update(2)
        lr_full, full = update(1)
    finally:
        torch.backends.cudnn.deterministic = False
    assert lr_half == cfg.train.learning_rate / 2 and lr_full == cfg.train.learning_rate
    assert len(captures) == 1
    eps = torch.finfo(torch.float32).eps
    for d_half, d_full, p0 in zip(halved, full, saved):
        # p + u is rounded to p's ulp; sums of atomics may differ a little
        bound = eps * (p0.abs() + d_full.abs()) + 1e-6 * d_full.abs().max()
        assert ((d_half - d_full / 2).abs() <= bound).all()
        assert d_full.abs().max() > 0


@pytest.mark.cuda
def test_a_steps_logs_keep_their_values_after_later_steps(cuda_device):
    cfg = _config()
    step = make_train_step(cfg)
    state = _state(cfg, cuda_device)
    history = [step(state, _batch(k, cuda_device)) for k in range(5)]
    values = [{k: float(v) for k, v in logs.items()} for logs in history]
    for logs in history[:3]:
        assert logs["loss"].device.type == "cuda"
    later = [step(state, _batch(k, cuda_device)) for k in range(5, 7)]
    for logs, kept in zip(history, values):
        assert {k: float(v) for k, v in logs.items()} == kept
    assert float(later[-1]["loss"]) != values[2]["loss"]


@pytest.mark.cuda
def test_a_checkpoint_saved_after_replays_restores_and_replays_on(cuda_device, tmp_path):
    cfg = _config(tmp_path)
    batches = [{k: v.cpu().numpy() for k, v in _batch(k, "cpu").items()} for k in range(6)]
    first = Trainer(cfg, tmp_path / "ex", iter(()), device=cuda_device)
    for batch in batches[:4]:
        first.train_step(batch)
    first.save()
    replays = _counted("train.graph_replays")
    for batch in batches[4:]:
        first.train_step(batch)
    assert _counted("train.graph_replays") == replays + 2

    second = Trainer(cfg, tmp_path / "ex", iter(()), device=cuda_device)
    assert second.step == 4
    group = second.state.optimizer.param_groups[0]
    assert group["capturable"] and group["lr"].device.type == "cuda"
    for p in group["params"]:
        assert second.state.optimizer.state[p]["step"].device.type == "cuda"
    replays = _counted("train.graph_replays")
    for batch in batches[4:]:
        second.train_step(batch)
    # the restored run warms up once, then replays
    assert _counted("train.graph_replays") == replays + 1
    _assert_states_close(second.state, first.state)


@pytest.mark.cuda
def test_a_batch_of_another_shape_takes_an_eager_step(cuda_device):
    cfg = _config()
    step = make_train_step(cfg)
    graphed, eager = _state(cfg, cuda_device), _state(cfg, cuda_device)
    sizes = [BATCH, 1, BATCH, BATCH, 1, BATCH]  # another shape before and after the capture
    replayed = []
    for k, size in enumerate(sizes):
        batch = _batch(k, cuda_device, batch=size)
        before = _counted("train.graph_replays")
        _assert_logs_close(step(graphed, batch), step.eager(eager, batch))
        replayed.append(_counted("train.graph_replays") - before)
    # a warm-up, a warm-up on the other shape, a warm-up on this one again,
    # the capture, an eager step, a replay
    assert replayed == [0, 0, 0, 1, 0, 1]
    _assert_states_close(graphed, eager)


@pytest.mark.cuda
def test_a_replay_counts_its_launches_and_names_its_kernels_to_the_profiler(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    cfg = _config()
    step = make_train_step(cfg)
    state = _state(cfg, cuda_device)
    before = launch_counts()
    for k in range(2):  # the warm-up, the capture and its replay
        step(state, _batch(k, cuda_device))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, _batch(2, cuda_device))
        torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    # a bf16 FlowNetC step: the tensor-core forward and both gradients, once
    # each, in each of the three steps
    assert launched == {"corr_fwd_bf16": 3, "corr_bwd_f1_bf16": 3, "corr_bwd_f2_bf16": 3}
    kernels = " ".join(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    for name in ("corr_fwd_mma_kernel", "corr_bwd_f1_mma_kernel", "corr_bwd_f2_mma_kernel"):
        assert name in kernels
