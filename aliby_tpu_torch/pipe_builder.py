"""Public surface of the standard builder (counterpart of
``aliby_tpu/pipe_builder.py``)."""

from aliby_tpu_torch.engine.builders import build_pipeline_steps

__all__ = ["build_pipeline_steps"]
