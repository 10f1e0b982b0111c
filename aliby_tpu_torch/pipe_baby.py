"""Public surface of the BABY pipeline flavour (counterpart of
``aliby_tpu/pipe_baby.py``)."""

from aliby_tpu_torch.engine.pipe_baby import (
    _save_baby_tracking_lineage,
    init_step,
    run_pipeline_and_post,
    tracking_columns,
)

__all__ = ["init_step", "run_pipeline_and_post", "tracking_columns",
           "_save_baby_tracking_lineage"]
