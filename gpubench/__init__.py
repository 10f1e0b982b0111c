"""The benchmark of the PyTorch and CUDA port (``aliby_tpu_torch``) on
NVIDIA H100 cards: fields of JUMP-sized Cell Painting plates a second
through the production mesh runner. ``python gpubench/run.py --help``."""
