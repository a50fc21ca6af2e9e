"""paddle_tpu_torch.distributed — so far the port reservation and the
group teardown that the cluster tier's worker pool spawns and reaps its
processes with (:mod:`.launch`).  The launcher, the parameter server
and the collectives come with their own slice."""
from .launch import PortReservation, reserve_ports, terminate_procs

__all__ = ["PortReservation", "reserve_ports", "terminate_procs"]
