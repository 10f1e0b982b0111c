from aliby_tpu_torch.tile.tiler import CropTiler, Tiler, TilerParameters, dispatch_tiler

__all__ = ["CropTiler", "Tiler", "TilerParameters", "dispatch_tiler"]
