"""Image and label operations with their kernels."""
