"""Hand-written CUDA kernels (``csrc/``) and their nvcc build (``_build``)."""
