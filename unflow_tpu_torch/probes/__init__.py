"""Diagnostic runs of the zero-flow basin, ported from the JAX package's
``scripts/``: the loss landscape along zero -> ground truth
(:mod:`~unflow_tpu_torch.probes.landscape`), the one-batch overfit
(:mod:`~unflow_tpu_torch.probes.convergence`), the per-example autopsy of a
checkpoint (:mod:`~unflow_tpu_torch.probes.autopsy`), the two-batch
input-dependence probe (:mod:`~unflow_tpu_torch.probes.input_dependence`) and
the supervised warm start followed by unsupervised training
(:mod:`~unflow_tpu_torch.probes.warmstart`). Each runs with ``python -m
unflow_tpu_torch.probes.<name>``, on the GPU unless ``--device cpu``, and
writes its JSON summary to ``--out``.
"""
