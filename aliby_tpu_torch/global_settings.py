"""Public surface of the settings (counterpart of
``aliby_tpu/global_settings.py``; see ``utils/settings.py``)."""

from aliby_tpu_torch.utils.settings import (
    earlystop,
    fluorescence_functions,
    imaging_specifications,
    outline_functions,
    possible_imaging_channels,
)

__all__ = [
    "earlystop",
    "fluorescence_functions",
    "imaging_specifications",
    "outline_functions",
    "possible_imaging_channels",
]
