from aliby_tpu_torch.track.dispatch import dispatch_tracker

__all__ = ["dispatch_tracker"]
