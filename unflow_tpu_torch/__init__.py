"""PyTorch / CUDA port of unflow_tpu for NVIDIA Hopper (H100).

The JAX package ``unflow_tpu`` is the reference this package is held
against; nothing here imports it. It runs FlowNetS, FlowNetC and their
cascades: inference (``python -m unflow_tpu_torch.cli.infer``), unsupervised
training on synthetic pairs or a dataset (``cli.train``, with ``cli.pack``
for packed input), evaluation on a dataset (``cli.eval``) and the held-out
acceptance run (``python -m unflow_tpu_torch.heldout``), with the
correlation forward and both of its gradients in hand-written CUDA kernels
(``csrc/``).
"""
