"""Process plumbing of the cluster tier: port reservation and group
teardown.

Counterpart of the part of paddle_tpu/distributed/launch.py that
`cluster.pool` uses (`PortReservation`, `reserve_ports`,
`terminate_procs`, copied).  The multi-process launcher itself comes
with the port's distributed slice.
"""
from __future__ import annotations

import collections
import signal
import socket
import subprocess
import time

__all__ = ["reserve_ports", "PortReservation", "terminate_procs"]


# ports handed out recently by THIS process: a reservation window so two
# back-to-back reserve/release cycles (e.g. the cluster pool starting two
# worker fleets) can never re-issue a just-released port while its first
# recipient is still binding it
_RECENT_PORTS: collections.deque = collections.deque(maxlen=128)


class PortReservation:
    """Bind-and-hold N distinct free ports.

    Binding port 0, reading the number and CLOSING the socket is a
    TOCTOU race: with many concurrent spawns the kernel
    can hand the same "free" port to two children.  A reservation holds
    every socket BOUND until :meth:`release` (call it immediately before
    spawning the processes that will bind the ports), so concurrently
    reserved ports are distinct by construction; SO_REUSEADDR lets the
    child bind the instant the reservation drops.  Recipients should
    still retry EADDRINUSE briefly (cf. cluster.rpc.RpcServer) — the
    post-release window is small but not zero against *foreign*
    processes."""

    def __init__(self, n, host=""):
        self._socks = []
        rejected = []
        try:
            while len(self._socks) < n:
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((host, 0))
                port = s.getsockname()[1]
                if port in _RECENT_PORTS:
                    # keep the reject bound (so retries can't land on
                    # it) until the reservation is complete
                    rejected.append(s)
                    continue
                self._socks.append(s)
        finally:
            for s in rejected:
                s.close()
        self.ports = [s.getsockname()[1] for s in self._socks]
        _RECENT_PORTS.extend(self.ports)

    def release(self):
        """Drop the holds — the recipients may bind now."""
        for s in self._socks:
            s.close()
        self._socks = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def reserve_ports(n, host=""):
    """Reserve ``n`` distinct free ports, held bound until released."""
    return PortReservation(n, host=host)


def terminate_procs(procs, timeout=10.0, sig=signal.SIGTERM):
    """Graceful group teardown: signal every child, wait them out under
    ONE shared deadline, then SIGKILL stragglers.

    The per-process ``wait(timeout=10)`` loop this replaces paid the
    deadline N times over (a 4-rank hang stalled teardown 40 s) and a
    launcher killed mid-loop orphaned the remaining children."""
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass
    deadline = time.monotonic() + timeout
    for p in procs:
        if p.poll() is not None:
            continue
        try:
            p.wait(timeout=max(0.05, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
