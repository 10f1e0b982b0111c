"""Public surface of the pipeline runtime (counterpart of
``aliby_tpu/pipe_core.py``; parity with ``aliby.pipe_core``)."""

from aliby_tpu_torch.engine.core import (
    _attach_trackastra,
    _run_pipeline_and_post_impl,
    configure_logging,
    get_profiles_from_state,
    get_step_output,
    pipeline_step,
    profile_columns,
    run_pipeline_return_state,
    validate_pipeline,
)

__all__ = [
    "configure_logging",
    "get_profiles_from_state",
    "get_step_output",
    "pipeline_step",
    "profile_columns",
    "run_pipeline_return_state",
    "validate_pipeline",
    "_attach_trackastra",
    "_run_pipeline_and_post_impl",
]
