"""One process of a ``torchrun`` job for tests/test_torch_distributed.py.

Usage: python -m torch.distributed.run --nproc-per-node N tests/_torch_ddp_worker.py \\
           <draws.pt> <report.json> -- <unflow_tpu_torch.cli.train arguments>

Runs ``unflow_tpu_torch.cli.train.main`` as ``-m unflow_tpu_torch.cli.train``
would, with two additions for the test:

* the train step takes its augmentation from ``draws.pt`` (a list, one
  parameter set per step, of the global batch) through ``make_train_step``'s
  ``draws`` seam;
* every collective is recorded in order: each DDP gradient bucket (through
  a communication hook around DDP's own all-reduce) and each
  ``torch.distributed`` call of the port. At the end each process writes
  the record, a digest of its parameters and of Adam's state, to
  ``<report.json>.<rank>``.
"""

import hashlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    torch.set_num_threads(1)
    draws_path, report_path = sys.argv[1], sys.argv[2]
    argv = sys.argv[sys.argv.index("--") + 1:]

    import torch.distributed as dist

    from unflow_tpu_torch.cli import train as cli_train
    from unflow_tpu_torch.train import trainer as trainer_module

    draws = torch.load(draws_path, weights_only=False)
    make_train_step = trainer_module.make_train_step
    trainer_module.make_train_step = (
        lambda *a, **k: make_train_step(*a, draws=lambda step: draws[step], **k))

    events = []
    all_reduce = dist.all_reduce

    def bucket_hook(state, bucket):
        # DDP's default: the bucket divided by the processes, all-reduced
        events.append(["bucket", bucket.index(), bucket.is_last()])
        tensor = bucket.buffer().div_(dist.get_world_size())
        return all_reduce(tensor, async_op=True).get_future().then(lambda f: f.value()[0])

    wrap_model = trainer_module.wrap_model

    def wrap_and_hook(model, device):
        wrapped = wrap_model(model, device)
        wrapped.register_comm_hook(None, bucket_hook)
        return wrapped

    trainer_module.wrap_model = wrap_and_hook
    for name in ("all_reduce", "barrier", "broadcast", "all_gather", "reduce", "gather",
                 "scatter", "all_to_all", "reduce_scatter"):
        original = getattr(dist, name)

        def recorded(*a, _name=name, _original=original, **k):
            events.append([_name])
            return _original(*a, **k)

        setattr(dist, name, recorded)

    trainers = []
    init = trainer_module.Trainer.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        trainers.append(self)

    trainer_module.Trainer.__init__ = keep
    rc = cli_train.main(argv)

    trainer = trainers[0]
    digest = hashlib.sha256()
    for p in trainer.model.parameters():
        digest.update(p.detach().numpy().tobytes())
        for key in ("exp_avg", "exp_avg_sq"):
            if p in trainer.state.optimizer.state:
                digest.update(trainer.state.optimizer.state[p][key].numpy().tobytes())
    rank = int(os.environ["RANK"])
    with open(f"{report_path}.{rank}", "w") as f:
        json.dump({"rc": rc, "events": events, "digest": digest.hexdigest()}, f)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
