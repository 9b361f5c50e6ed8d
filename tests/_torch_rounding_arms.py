"""Card diagnostics of ROADMAP C2: the held-out run, or the timed bf16 C step,
under one rounding arm of the bf16 towers.

    python tests/_torch_rounding_arms.py ARM [heldout arguments]   # the held-out run
    python tests/_torch_rounding_arms.py --time ARM [WINDOWS]      # step and eval times

ARM is one of:

* ``tree``: the port as it is (the towers rounded where XLA rounds the JAX
  program by default: ``ops/conv2d.py::LowPrecisionConv``);
* ``epilogue_once``: ``tree`` with each conv's epilogue (the conv, the bias
  and the leaky ReLU) computed in float32 (the conv through TF32, exact for
  bf16 operands) and rounded once, as a fused conv on the TPU may do;
* ``tpu_census``: ``tree`` with the census patches taken from the grayscale
  rounded to bf16 and their cotangent rounded likewise, as the TPU's default
  precision computes ``conv_general_dilated_patches``;
* ``parent:DIR``: the port of another checkout (for example the parent
  commit unpacked with ``git archive``) at ``DIR``.

The held-out run is ``unflow_tpu_torch.heldout.main`` with the arguments
given (for example ``--steps 2000 --segments 1 --bootstrap-until 2000`` for
the bootstrap segment alone). ``--time`` reads WINDOWS (default 5) windows
of each of: the bf16 C step of ``chip_smoke.py``'s ``run_train_timed``
(320x1152, batch 8, ready host batches; the Trainer's own window of 16
steps, after a window of warm-up) and bf16 ``Evaluator.predict_batch`` of
its ``run_eval`` (batch 4, 375x1242; 5 batches by the host clock, after two
of warm-up), and prints them as one JSON line. Needs a GPU; none of the arms
is a feature of the port.
"""

import itertools
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _epilogue_once(torch, F):
    from unflow_tpu_torch.models import flownet
    from unflow_tpu_torch.ops import conv2d

    def forward(ctx, x, weight, bias, stride, padding, transposed, float_out):
        w = weight.to(x.dtype)
        conv = F.conv_transpose2d if transposed else F.conv2d
        with conv2d._tf32():
            y = conv(x.float(), w.float(), None, stride, padding)
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, transposed)
        return y + bias.to(x.dtype).float()[:, None, None]

    conv2d.LowPrecisionConv.forward = staticmethod(forward)
    flownet._leaky = lambda x: F.leaky_relu(x.float(), 0.1).to(torch.bfloat16)
    deconv = flownet.Deconv4x4.forward
    # the flow upsamplers feed a concatenation, not a leaky ReLU: rounded there
    flownet.Deconv4x4.forward = lambda self, x: (
        deconv(self, x).to(torch.bfloat16) if self.out_channels == 2 else deconv(self, x))


def _tpu_census(torch):
    from unflow_tpu_torch.losses import terms

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.to(torch.bfloat16).float()

        @staticmethod
        def backward(ctx, g):
            return g

    class RoundGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g.to(torch.bfloat16).float()

    patches = terms._extract_patches
    terms._extract_patches = lambda x, r: RoundGrad.apply(patches(Round.apply(x), r))


def _timed(torch, arm: str, windows: int) -> dict:
    import chip_smoke
    from unflow_tpu_torch.config import load_config
    from unflow_tpu_torch.data import DEFAULT_NORMALIZATION, dataset_normalization
    from unflow_tpu_torch.eval.evaluate import Evaluator
    from unflow_tpu_torch.models import build_model, init_params
    from unflow_tpu_torch.train import Trainer

    steps = 16
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = chip_smoke.train_config(tmp, num_iters=steps * (windows + 1),
                                      display_interval=steps)
        trainer = Trainer(cfg, tmp / "timed", itertools.cycle(chip_smoke.host_batches(8, 2)),
                          device="cuda")
        trainer.run()
        records = [json.loads(line) for line in
                   (tmp / "timed" / "metrics.jsonl").read_text().splitlines()]
        step_ms = [r["step_ms"] for r in records if "step_ms" in r][1:]
        del trainer

    cfg = load_config(chip_smoke.CONFIG)
    cfg.train.compute_dtype = "bfloat16"
    model = build_model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(1))
    ev = Evaluator(cfg, params=model.state_dict(), device="cuda",
                   normalization=dataset_normalization(cfg.train.dataset) or DEFAULT_NORMALIZATION)
    ims1, ims2 = chip_smoke.synthetic_frames(4, seed=2)
    for _ in range(2):
        ev.predict_batch(ims1, ims2)
    pairs_per_s = []
    for _ in range(windows):
        t = time.perf_counter()
        for _ in range(5):
            ev.predict_batch(ims1, ims2)
        pairs_per_s.append(5 * len(ims1) / (time.perf_counter() - t))
    return {"arm": arm, "step_ms": step_ms, "eval_pairs_per_s": pairs_per_s}


def main(argv) -> int:
    timed = argv[:1] == ["--time"]
    arm, rest = (argv[1], argv[2:]) if timed else (argv[0], argv[1:])
    root = Path(arm.split(":", 1)[1]) if arm.startswith("parent:") else ROOT
    sys.path[:0] = [str(root), str(ROOT)]
    import torch
    import torch.nn.functional as F

    import unflow_tpu_torch

    print(f"arm {arm}: {unflow_tpu_torch.__file__}", flush=True)
    if arm == "epilogue_once":
        _epilogue_once(torch, F)
    elif arm == "tpu_census":
        _tpu_census(torch)
    elif arm != "tree" and not arm.startswith("parent:"):
        raise SystemExit(f"unknown arm {arm!r}")
    if not timed:
        from unflow_tpu_torch import heldout

        return heldout.main(rest)
    from unflow_tpu_torch.ops.cuda import build

    build.build(sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")))
    torch.backends.cudnn.allow_tf32 = False  # as chip_smoke.py runs the step
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(_timed(torch, arm, int(rest[0]) if rest else 5)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
