"""Multi-process launcher, port reservation and group teardown.

Counterpart of paddle_tpu/distributed/launch.py (parity:
python/paddle/distributed/launch.py — start_procs :147, launch :308).
``PortReservation``, ``reserve_ports`` and ``terminate_procs`` are
copies; the cluster tier (``cluster.pool``) spawns and reaps its worker
processes with them.

``start_procs`` spawns one training process per local rank with the JAX
launcher's env contract (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
PADDLE_TRAINER_ENDPOINTS / PADDLE_CURRENT_ENDPOINT / PADDLE_COORDINATOR,
the address ``fleet.init`` hands ``init_process_group``) and
``torch.distributed``'s (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE /
LOCAL_RANK).  Each rank learns its device and backend from
PADDLE_TRAINER_DEVICE (``cpu`` or ``cuda:<i>``, read back with
:func:`trainer_device`) and PADDLE_DIST_BACKEND.  ``--use_cpu_devices``
asks for CPU ranks over gloo (no card visible to them).  Otherwise the
ranks run on CUDA: ``--backend`` defaults to NCCL when every local rank
has a card of its own, and to gloo when ranks share one (NCCL refuses two
ranks on one device; gloo stages CUDA tensors through the host).

Usage::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \
        [--use_cpu_devices N] [--backend gloo] train.py --your-args
"""
from __future__ import annotations

import argparse
import collections
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "start_procs", "reserve_ports", "PortReservation",
           "terminate_procs", "trainer_device"]


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


def trainer_device():
    """This rank's ``torch.device`` as the launcher set it
    (PADDLE_TRAINER_DEVICE); a process the launcher did not start runs
    on the card."""
    import torch

    return torch.device(os.environ.get("PADDLE_TRAINER_DEVICE", "cuda"))


class _SignalStop(Exception):
    """A forwarded SIGTERM/SIGINT arrived while babysitting children."""

    def __init__(self, signum):
        super().__init__(signum)
        self.signum = signum


def _parse_args(argv):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch multi-process launcher")
    p.add_argument("--cluster_node_ips", default="127.0.0.1",
                   help="comma-separated node IPs (parity arg)")
    p.add_argument("--node_ip", default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=None)
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks on this node (default 1)")
    p.add_argument("--use_cpu_devices", type=int, default=0,
                   help="if >0, CPU ranks over gloo with no card visible "
                        "(the JAX launcher's CPU-device count; tests)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend of CUDA ranks "
                        "(default: nccl when each local rank has a card "
                        "of its own, gloo when they share one)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _placement(args, nproc):
    """(backend, [device string per local rank])."""
    if args.use_cpu_devices:
        if args.backend == "nccl":
            raise ValueError("--use_cpu_devices runs CPU ranks: NCCL "
                             "needs CUDA ranks")
        return "gloo", ["cpu"] * nproc
    import torch

    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            "the launcher's ranks run on CUDA by default and no card is "
            "visible; pass --use_cpu_devices for CPU ranks over gloo")
    backend = args.backend or ("nccl" if cards >= nproc else "gloo")
    if backend == "nccl" and cards < nproc:
        raise ValueError(f"NCCL needs a card per rank: {nproc} ranks, "
                         f"{cards} cards (use --backend gloo)")
    return backend, [f"cuda:{r % cards}" for r in range(nproc)]


def start_procs(args):
    """Spawn and babysit the per-rank processes (parity: launch.py:147).

    SIGTERM/SIGINT to the launcher is forwarded to every child (then the
    shared-deadline SIGKILL sweep) — a killed launcher must not orphan
    workers, which would wedge multi-process runs."""
    node_ips = args.cluster_node_ips.split(",")
    nnodes = len(node_ips)
    node_id = node_ips.index(args.node_ip)
    nproc = args.nproc_per_node or 1
    backend, devices = _placement(args, nproc)
    # multi-node: every node must derive the SAME endpoint list, so the
    # port must be deterministic (reference default 6170); random free
    # ports are only safe single-node, where they are RESERVED
    # (bind-and-hold) until just before the children spawn
    reservation = None
    if args.started_port is not None:
        ports = [args.started_port + r for r in range(nproc)]
    elif nnodes == 1:
        reservation = reserve_ports(nproc)
        ports = reservation.ports
    else:
        ports = [6170 + r for r in range(nproc)]
    endpoints = []
    for ip in node_ips:
        for r in range(nproc):
            endpoints.append(f"{ip}:{ports[r]}")
    coordinator = endpoints[0]
    world = nnodes * nproc

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    procs = []
    fail_rank, code = None, 0
    stop_sig = None
    prev_handlers = {}

    def _on_signal(signum, frame):
        raise _SignalStop(signum)

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[s] = signal.signal(s, _on_signal)
            except ValueError:
                pass    # not the main thread: rely on caller's handling
        # rank 0 binds the coordinator's port (init_process_group's TCP
        # store) — release the holds only now, with spawn imminent
        if reservation is not None:
            reservation.release()
        # spawn INSIDE the try: a mid-spawn failure must still tear down
        # the ranks already started (they would otherwise hang in
        # init_process_group waiting for the missing rank)
        for local_rank in range(nproc):
            rank = node_id * nproc + local_rank
            env = dict(os.environ)
            host, port = coordinator.rsplit(":", 1)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "PADDLE_COORDINATOR": coordinator,
                "PADDLE_DIST_BACKEND": backend,
                "PADDLE_TRAINER_DEVICE": devices[local_rank],
                "MASTER_ADDR": host,
                "MASTER_PORT": port,
                "RANK": str(rank),
                "WORLD_SIZE": str(world),
                "LOCAL_RANK": str(local_rank),
            })
            if devices[local_rank] == "cpu":
                env["CUDA_VISIBLE_DEVICES"] = ""
            cmd = [sys.executable, "-u", args.training_script] \
                + args.training_script_args
            if args.log_dir:
                out = open(os.path.join(args.log_dir,
                                        f"worker.{rank}.log"), "w")
            else:
                out = None
            try:
                p = subprocess.Popen(cmd, env=env, stdout=out,
                                     stderr=subprocess.STDOUT if out
                                     else None)
            except BaseException:
                if out:
                    out.close()
                raise
            procs.append((p, out, rank))

        # poll ALL ranks: a crash anywhere must tear the job down at once
        # (sequential wait() would park on rank 0 while rank k is dead)
        live = {rank: p for p, _, rank in procs}
        while live and fail_rank is None:
            for rank, p in list(live.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del live[rank]
                if rc != 0:
                    fail_rank, code = rank, rc
                    break
            if live and fail_rank is None:
                time.sleep(0.2)
    except _SignalStop as s:
        stop_sig = s.signum
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if reservation is not None:
            reservation.release()
        terminate_procs([p for p, _, _ in procs], timeout=10.0)
        for _, out, _ in procs:
            if out:
                out.close()
    if stop_sig is not None:
        # children are reaped; exit with the conventional fatal-signal
        # code so wrappers see the launcher as killed, not as clean
        raise SystemExit(128 + stop_sig)
    if fail_rank is not None:
        raise RuntimeError(
            f"rank {fail_rank} exited with code {code}; see logs"
            + (f" in {args.log_dir}" if args.log_dir else ""))


def launch(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    start_procs(args)


if __name__ == "__main__":
    launch()
