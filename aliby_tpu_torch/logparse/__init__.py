"""Microscope log parsers (counterpart of ``aliby_tpu/logparse``)."""

from aliby_tpu_torch.logparse.metadata import MetaData, parse_microscopy_logs
from aliby_tpu_torch.logparse.swainlab import parse_swainlab_logs

__all__ = ["MetaData", "parse_microscopy_logs", "parse_swainlab_logs"]
