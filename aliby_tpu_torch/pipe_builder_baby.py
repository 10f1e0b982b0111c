"""Public surface of the BABY builder (counterpart of
``aliby_tpu/pipe_builder_baby.py``)."""

from aliby_tpu_torch.engine.builders_baby import build_pipeline_steps

__all__ = ["build_pipeline_steps"]
