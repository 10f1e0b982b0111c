"""Post-hoc queries over a run's outputs (counterpart of
``aliby_tpu/postprocess``): host numpy; pandas and pyarrow are imported
where a parquet is read."""

from aliby_tpu_torch.postprocess.cells import Cells
from aliby_tpu_torch.postprocess.signal import Signal

__all__ = ["Cells", "Signal"]
