from aliby_tpu_torch.io.dataset import DatasetDir, DatasetZarr, dispatch_dataset
from aliby_tpu_torch.io.image import (
    ImageDir,
    ImageList,
    ImageMultiTiff,
    ImageZarr,
    adjust_dimensions,
    dispatch_image,
)

__all__ = [
    "DatasetDir",
    "DatasetZarr",
    "dispatch_dataset",
    "ImageDir",
    "ImageList",
    "ImageMultiTiff",
    "ImageZarr",
    "adjust_dimensions",
    "dispatch_image",
]
