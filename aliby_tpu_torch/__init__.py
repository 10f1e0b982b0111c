"""aliby-tpu in PyTorch: the port of ``aliby_tpu`` to CUDA on NVIDIA Hopper.

The layout mirrors ``aliby_tpu`` module for module. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package on a ported path becomes a
CUDA C++ kernel under ``kernels/csrc`` (built with nvcc at first use), with
a plain PyTorch version beside it that runs only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; see
:func:`aliby_tpu_torch.device.resolve_device`.
"""

from aliby_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
