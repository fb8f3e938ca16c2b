"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
beside its plain PyTorch version, dispatched by the tensor's device."""

from byteps_tpu_torch.ops.backend import launches, reset_launches  # noqa: F401
