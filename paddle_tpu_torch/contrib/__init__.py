"""Contrib subsystems (counterpart of paddle_tpu/contrib; parity:
python/paddle/fluid/contrib/).  The port carries ``mixed_precision``;
the rest of the JAX package's contrib is ROADMAP Queue 1 item 6.6."""
from . import mixed_precision  # noqa: F401
