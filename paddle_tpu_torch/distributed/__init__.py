"""paddle_tpu_torch.distributed — the multi-process launcher and its port
reservation and group teardown (:mod:`.launch`), the parameter server
(:mod:`.ps`, :mod:`.ps_sharded`, :mod:`.geo`), the host-driven
collectives over ``torch.distributed`` (:mod:`.collectives`) and the
all-reduce bandwidth harness (:mod:`.allreduce_bench`).

Counterpart of paddle_tpu/distributed/ (parity:
python/paddle/distributed/).  Submodules load at first use, so
``python -m paddle_tpu_torch.distributed.launch`` runs the launcher
module once."""
import importlib

__all__ = ["PortReservation", "reserve_ports", "terminate_procs"]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(".launch", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
