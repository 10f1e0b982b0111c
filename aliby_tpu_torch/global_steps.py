"""Public surface of the global steps (counterpart of
``aliby_tpu/global_steps.py``; see ``engine/global_steps.py``)."""

from aliby_tpu_torch.engine.global_steps import dispatch_global_step

__all__ = ["dispatch_global_step"]
