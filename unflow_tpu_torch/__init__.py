"""PyTorch / CUDA port of unflow_tpu for NVIDIA Hopper (H100).

The JAX package ``unflow_tpu`` is the reference this package is held
against; nothing here imports it. So far it runs FlowNetC inference
(``python -m unflow_tpu_torch.cli.infer``) and the unsupervised UnFlow-C
train step (``python -m unflow_tpu_torch.cli.train``), with the correlation
forward and both of its gradients in hand-written CUDA kernels
(``csrc/correlation_fwd.cu``, ``csrc/correlation_bwd.cu``).
"""
