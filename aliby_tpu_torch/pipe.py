"""Public surface of the standard pipeline flavour (counterpart of
``aliby_tpu/pipe.py``)."""

from aliby_tpu_torch.engine.pipe import init_step, run_pipeline_and_post

__all__ = ["init_step", "run_pipeline_and_post"]
