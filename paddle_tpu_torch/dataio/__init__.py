"""Data pipeline: the DataLoader's device double buffer and the shared
background prefetch iterator (counterpart of paddle_tpu/dataio/)."""
from .dataloader import DataLoader  # noqa: F401
from .prefetch import background_iter  # noqa: F401

__all__ = ["DataLoader", "background_iter"]
