"""One process of a ``torchrun`` job for tests/test_torch_spatial.py.

Usage: python -m torch.distributed.run --nproc-per-node N tests/_torch_spatial_worker.py <spec.json>

Joins the gloo group on the CPU, then runs each job of the spec in order
(every rank runs the same jobs, so their collectives pair up) and writes
what each job returned, a list in job order, to ``<spec>.<rank>.pt``:

* ``collectives``: ``halo_exchange`` (zeros and replicate past the frame),
  ``gather_w`` and ``sum_over_spatial`` on ``spatial`` shards, forward and
  backward, against slicing one full tensor; the largest difference of each
  case.
* ``flownet``: a FlowNetS or FlowNetC (``state_dict`` from a file) on this
  rank's W-slab of the spec's inputs inside a ``SpatialContext``: the slabs
  of its five flows and, given cotangents (full-width, sliced here), this
  rank's part of the parameter gradient of ``sum(flow * cotangent)``.
* ``losses``: the unsupervised loss (every term weighted, a border mask,
  ``fb`` and ``disocc`` occlusion) and the supervised loss on this rank's
  W-slab of the spec's frames, flows and ground truth: this rank's part of
  each logged term and the slabs of the flows' gradients.
* ``train``: ``unflow_tpu_torch.cli.train.main(argv)``, the augmentation
  taken from a ``draws`` file (one parameter set per step) when one is named.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HALO_CASES = [  # (left, right, edge): within a slab, past a slab, one-sided, replicate
    (1, 1, "zeros"), (3, 2, "zeros"), (0, 1, "zeros"), (2, 0, "zeros"), (11, 9, "zeros"),
    (1, 1, "replicate"), (5, 3, "replicate"),
]


def _padded(full: torch.Tensor, left: int, right: int, edge: str) -> torch.Tensor:
    """The full tensor extended past its edges, zeros or edge copies."""
    if edge == "zeros":
        return torch.nn.functional.pad(full, (left, right))
    parts = [full[..., :1].expand(*full.shape[:-1], left), full,
             full[..., -1:].expand(*full.shape[:-1], right)]
    return torch.cat(parts, -1)


def collectives(spatial_shards: int) -> dict:
    from unflow_tpu_torch.parallel import SpatialContext, init_grid
    from unflow_tpu_torch.parallel import spatial

    grid = init_grid(spatial_shards)
    s, i = grid.spatial, grid.spatial_index
    gen = torch.Generator().manual_seed(0)
    w = 4
    full = torch.randn(2, 3, 5, w * s, generator=gen, dtype=torch.float64)
    mine = full[..., i * w : (i + 1) * w]
    errors = {}
    with SpatialContext.of(grid):
        for left, right, edge in HALO_CASES:
            # one cotangent per rank's extended slab; the reference gradient
            # of sum_r <ext_r(full), g_r> is the scatter-add of every g_r
            gs = [torch.randn(2, 3, 5, left + w + right, generator=gen, dtype=torch.float64)
                  for _ in range(s)]
            x = mine.clone().requires_grad_()
            out = spatial.halo_exchange(x, left, right, edge=edge)
            (out * gs[i]).sum().backward()
            ref_full = full.clone().requires_grad_()
            padded = _padded(ref_full, left, right, edge)
            ref = [padded[..., j * w : j * w + left + w + right] for j in range(s)]
            sum((r * g).sum() for r, g in zip(ref, gs)).backward()
            key = f"halo {left},{right} {edge}"
            errors[key] = float((out - ref[i]).abs().max())
            errors[key + " grad"] = float(
                (x.grad - ref_full.grad[..., i * w : (i + 1) * w]).abs().max())
            # along another dim (the correlation's NHWC maps exchange dim 2)
            y = spatial.halo_exchange(mine.transpose(-1, 1).contiguous(), left, right, dim=1,
                                      edge=edge)
            errors[key + " dim 1"] = float((y.transpose(-1, 1) - ref[i]).abs().max())

        gs = [torch.randn(full.shape, generator=gen, dtype=torch.float64) for _ in range(s)]
        x = mine.clone().requires_grad_()
        out = spatial.gather_w(x)
        (out * gs[i]).sum().backward()
        errors["gather_w"] = float((out - full).abs().max())
        errors["gather_w grad"] = float(
            (x.grad - sum(gs)[..., i * w : (i + 1) * w]).abs().max())
        bf = mine.to(torch.bfloat16)
        errors["gather_w bf16"] = float((spatial.gather_w(bf).double()
                                         - full.to(torch.bfloat16).double()).abs().max())

        vs = [torch.randn(6, generator=gen, dtype=torch.float64) for _ in range(s)]
        gs = [torch.randn(6, generator=gen, dtype=torch.float64) for _ in range(s)]
        v = vs[i].clone().requires_grad_()
        out = spatial.sum_over_spatial(v)
        (out * gs[i]).sum().backward()
        errors["sum_over_spatial"] = float((out - sum(vs)).abs().max())
        errors["sum_over_spatial grad"] = float((v.grad - sum(gs)).abs().max())
    return errors


def flownet(job: dict) -> dict:
    from unflow_tpu_torch.models import FlowNetC, FlowNetS
    from unflow_tpu_torch.parallel import SpatialContext, init_grid

    grid = init_grid(job["spatial"])
    data = torch.load(job["inputs"], weights_only=True)
    if job["net"] == "S":
        model = FlowNetS(data["x"].shape[1])
    else:
        model = FlowNetC(max_displacement=job["max_displacement"], corr_stride=2)
    model.load_state_dict(torch.load(job["params"], weights_only=True))
    model = model.to(memory_format=torch.channels_last)
    s, i = grid.spatial, grid.spatial_index

    def cut(x):
        w = x.shape[-1] // s
        return x[..., i * w : (i + 1) * w]

    with SpatialContext.of(grid):
        if job["net"] == "S":
            flows = model(cut(data["x"]))
        else:
            flows = model(cut(data["im1"]), cut(data["im2"]), pair_flipped_im2=True)
        out = {"flows": [f.detach() for f in flows]}
        if "cotangents" in data:
            sum((f * cut(g)).sum() for f, g in zip(flows, data["cotangents"])).backward()
            out["grads"] = {k: p.grad for k, p in model.named_parameters()}
    return out


def loss_terms(data: dict) -> dict:
    """The unsupervised loss with every term weighted (``fb`` and ``disocc``)
    and the supervised loss of ``data``: for each, the logged terms and the
    gradients to the flows. Inside a ``SpatialContext`` (on W-slabs) these
    are this rank's parts and slabs; outside one, the unsharded reference."""
    from unflow_tpu_torch.losses import supervised_loss, unsupervised_loss
    from unflow_tpu_torch.losses.unsupervised import LOSS_KEYS

    out = {}
    for occ in ("fb", "disocc", "supervised"):
        fw = [f.clone().requires_grad_() for f in data["flows_fw"]]
        bw = [f.clone().requires_grad_() for f in data["flows_bw"]]
        if occ == "supervised":
            bw = []
            total, logs = supervised_loss(fw, data["gt"], data["mask"])
        else:
            total, logs = unsupervised_loss(data["im1"], data["im2"], fw, bw,
                                            weights={k: 1.0 for k in LOSS_KEYS},
                                            mask_occlusion=occ, border_ratio=0.1)
        total.backward()
        out[occ] = ({k: float(v) for k, v in logs.items()}, [f.grad for f in fw + bw])
    return out


def losses(job: dict) -> dict:
    from unflow_tpu_torch.parallel import SpatialContext, init_grid, spatial

    grid = init_grid(job["spatial"])
    data = torch.load(job["inputs"], weights_only=True)
    with SpatialContext.of(grid) as ctx:
        return loss_terms({k: [spatial.slab(x, ctx) for x in v] if isinstance(v, list)
                           else spatial.slab(v, ctx) for k, v in data.items()})


def train(job: dict) -> int:
    from unflow_tpu_torch.cli import train as cli_train
    from unflow_tpu_torch.train import trainer as trainer_module

    make_train_step = trainer_module.make_train_step
    if job.get("draws"):
        draws = torch.load(job["draws"], weights_only=False)
        trainer_module.make_train_step = (
            lambda *a, **k: make_train_step(*a, draws=lambda step: draws[step], **k))
    try:
        return cli_train.main(job["argv"])
    finally:
        trainer_module.make_train_step = make_train_step


def main() -> int:
    torch.set_num_threads(1)
    spec_path = sys.argv[1]
    spec = json.loads(open(spec_path).read())
    os.chdir(spec["cwd"])

    from unflow_tpu_torch.parallel import init_distributed

    init_distributed("cpu")
    results = []
    for job in spec["jobs"]:
        if job["kind"] == "collectives":
            results.append(collectives(job["spatial"]))
        elif job["kind"] == "flownet":
            results.append(flownet(job))
        elif job["kind"] == "losses":
            results.append(losses(job))
        else:
            results.append(train(job))
    torch.save(results, f"{spec_path}.{os.environ['RANK']}.pt")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
