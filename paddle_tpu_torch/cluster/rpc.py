"""Cluster control plane: length-prefixed message transport over TCP.

Counterpart of paddle_tpu/cluster/rpc.py, copied (the wire format, the
error envelope and the failure classification are the JAX module's).

The reference ecosystem's parameter-server tier (distributed/ps.py)
speaks a C++ brpc-style socket protocol; the cluster tier needs the same
shape of thing — a tiny request/response protocol between the router and
its workers — but in pure Python, because the payloads here are
arbitrary request envelopes (feeds, KV handoffs, trace contexts), not
fixed-width embedding rows.  Framing is an 8-byte big-endian length
prefix followed by a pickled dict; numpy arrays ride in the pickle
(KV pages are a few hundred KB — far below any framing concern).

Connection model, mirroring PSClient: one persistent connection per
(client, worker) pair, one outstanding request at a time per connection
(the RpcClient lock), a thread per connection on the server side.  A
connect retries with `resilience.retry_call` — a worker process takes
seconds to import torch and warm its engine up.

Failure classification: anything that looks like "the peer is gone"
(refused, reset, EOF mid-frame, timeout) raises
:class:`WorkerUnavailable`, a ``resilience.TransientError`` — the
router's re-route policy keys on exactly that type.  The
``cluster_rpc`` fault site (resilience/faults.py) fires here, so a
FaultPlan can simulate a worker death at any chosen request without
killing a process.

Trust model: pickle over localhost between processes THIS process
spawned (same trust domain as multiprocessing itself); the port is
bound on 127.0.0.1.
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
import time

from ..resilience.faults import InjectedFault, maybe_fail
from ..resilience.retry import TransientError, retry_call

__all__ = ["WorkerUnavailable", "RpcError", "send_msg", "recv_msg",
           "RpcServer", "RpcClient"]

_HEADER = struct.Struct("!Q")
_MAX_FRAME = 1 << 31   # sanity bound: a corrupt length must not OOM us


class WorkerUnavailable(TransientError):
    """The worker at the other end of this connection is gone (or was
    made to look gone by an armed FaultPlan) — retry elsewhere."""


class RpcError(RuntimeError):
    """Protocol-level failure that is NOT a worker loss (corrupt frame,
    oversized message) — do not re-route, surface it."""


def send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock):
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if n > _MAX_FRAME:
        raise RpcError(f"frame length {n} exceeds bound {_MAX_FRAME}")
    return pickle.loads(_recv_exact(sock, n))


class RpcServer:
    """Threaded accept loop: one daemon thread per connection, each
    looping ``handler(msg) -> resp`` until the peer disconnects.

    ``bind`` retries EADDRINUSE for ``bind_retry_s`` — the port arrives
    from a `distributed.launch.PortReservation` that was released just
    before this process spawned, and the reservation contract is that
    the recipient rides out the tiny release-to-bind window."""

    def __init__(self, host, port, handler, name="cluster-rpc"):
        self._handler = handler
        self._name = name
        self._sock = None
        self._host, self._port = host, port
        self._closed = False
        self._threads = []
        self._accept_thread = None

    def bind(self, bind_retry_s=5.0):
        deadline = time.monotonic() + bind_retry_s
        while True:
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((self._host, self._port))
                break
            except OSError:
                s.close()
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        s.listen(64)
        self._sock = s
        self._port = s.getsockname()[1]
        return self._port

    @property
    def port(self):
        return self._port

    def start(self):
        if self._sock is None:
            self.bind()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self._name}-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self):
        if self._sock is None:
            self.bind()
        self._accept_loop()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return    # closed underneath us
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 name=f"{self._name}-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._closed:
                try:
                    msg = recv_msg(conn)
                except (EOFError, OSError):
                    return
                try:
                    resp = self._handler(msg)
                except Exception as e:  # noqa: BLE001 — isolate per req
                    # a handler bug must fail THIS request, not sever
                    # the connection (which would read as worker death
                    # and trigger a pointless re-route)
                    resp = {"ok": False, "error": str(e),
                            "error_type": type(e).__name__}
                try:
                    send_msg(conn, resp)
                except OSError:
                    return
        finally:
            conn.close()

    def close(self):
        self._closed = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class RpcClient:
    """One persistent connection to one worker; thread-safe with one
    outstanding request at a time (callers that want pipelining open
    more clients — the server is thread-per-connection)."""

    def __init__(self, host, port, connect_timeout_s=20.0,
                 io_timeout_s=None):
        self.endpoint = f"{host}:{port}"
        self._host, self._port = host, port
        self._io_timeout_s = io_timeout_s
        # a lazy reconnect (below) must not inherit the patient
        # first-connect budget: by then the worker has long since
        # started, so either it answers quickly or it is gone
        self._reconnect_timeout_s = min(5.0, connect_timeout_s)
        self._lock = threading.Lock()
        self._sock = None
        self._closed = False
        # patient connect: the worker may still be starting up
        self._sock = self._connect(connect_timeout_s, max_attempts=40)

    def _connect(self, budget_s, max_attempts):
        def _dial():
            s = socket.create_connection(
                (self._host, self._port), timeout=5.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self._io_timeout_s)
            return s

        try:
            return retry_call(
                _dial, max_attempts=max_attempts, base_delay=0.1,
                max_delay=1.0, multiplier=1.4, jitter=0.2,
                deadline=budget_s, retry_on=(OSError,),
                op_name="cluster_rpc_connect")
        except Exception as e:
            raise WorkerUnavailable(
                f"cannot connect to worker at {self.endpoint}: {e}") \
                from e

    def call(self, op, _io_timeout_s=None, **payload):
        """One request/response round trip.  Raises WorkerUnavailable on
        any sign the peer is gone (including an injected `cluster_rpc`
        fault).  ``_io_timeout_s`` overrides the connection's I/O
        timeout for THIS call only — the page-streaming ``prefill_pull``
        long-poll legitimately idles longer than a normal round trip
        (underscored so it can never collide with a payload key).

        A failed call poisons only ITSELF: the socket is dropped, but
        the next call redials with a short bounded retry, so a
        transient fault (or a worker restart on the same port) does not
        brick the client forever."""
        msg = {"op": op}
        msg.update(payload)
        with self._lock:
            if self._sock is None:
                if self._closed:
                    raise WorkerUnavailable(
                        f"connection to {self.endpoint} is closed")
                # lazy reconnect after a prior failure — bounded, so a
                # truly-dead worker fails fast into the re-route path
                self._sock = self._connect(
                    self._reconnect_timeout_s, max_attempts=5)
            try:
                maybe_fail("cluster_rpc", endpoint=self.endpoint, op=op)
                if _io_timeout_s is not None:
                    self._sock.settimeout(_io_timeout_s)
                try:
                    send_msg(self._sock, msg)
                    return recv_msg(self._sock)
                finally:
                    if _io_timeout_s is not None and \
                            self._sock is not None:
                        self._sock.settimeout(self._io_timeout_s)
            except (InjectedFault, OSError, EOFError) as e:
                # the connection state is unknown after a failure —
                # poison it so a later call cannot read a stale frame
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise WorkerUnavailable(
                    f"worker at {self.endpoint} lost during '{op}': "
                    f"{e}") from e

    def close(self):
        with self._lock:
            self._closed = True   # closed stays closed: no reconnect
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
