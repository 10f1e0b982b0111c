from aliby_tpu_torch.utils.abc import ParametersABC, ProcessABC, StepABC
from aliby_tpu_torch.utils.timer import timer

__all__ = ["ParametersABC", "ProcessABC", "StepABC", "timer"]
