"""RoleMakers: cluster topology discovery (parity: python/paddle/fluid/
incubate/fleet/base/role_maker.py — PaddleCloudRoleMaker :441 env-var
based, UserDefinedRoleMaker :876, GeneralRoleMaker :542).

Counterpart of paddle_tpu/incubate/fleet/base/role_maker.py, copied;
``coordinator_endpoint`` is the address the fleets hand
``torch.distributed.init_process_group``, and the rendezvous
directories default under the temporary directory (TMPDIR)."""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

__all__ = ["Role", "RoleMakerBase", "GeneralRoleMaker",
           "MPISymetricRoleMaker", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role = Role.WORKER
        self._current_id = 0

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(1, len(self._worker_endpoints))

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def coordinator_endpoint(self):
        """The process group's address (``init_process_group``'s
        ``tcp://`` store): env override, else the first worker
        endpoint."""
        env = os.environ.get("PADDLE_COORDINATOR")
        if env:
            return env
        return self._worker_endpoints[0] if self._worker_endpoints else None


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the launcher's env contract (parity: role_maker.py:441):
    PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
    optionally PADDLE_PSERVERS / TRAINING_ROLE for PS mode."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        pseps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                               os.environ.get("PADDLE_PSERVERS", ""))
        self._server_endpoints = [e for e in pseps.split(",") if e]
        if self._role == Role.SERVER:
            self._current_id = int(os.environ.get("PADDLE_PSERVER_ID", "0"))


class UserDefinedRoleMaker(RoleMakerBase):
    """Explicit topology (parity: role_maker.py:876)."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None):
        super().__init__()
        self._current_id = int(current_id)
        self._role = role
        self._server_endpoints = list(server_endpoints or [])
        if worker_endpoints is not None:
            self._worker_endpoints = list(worker_endpoints)
        else:
            self._worker_endpoints = [f"127.0.0.1:{6170 + i}"
                                      for i in range(worker_num)]


class _FileRendezvous:
    """Filesystem-rendezvous communicator (the analog of the
    reference's Gloo-over-HDFS groups, role_maker.py:580-608): N ranks
    coordinate through files under a shared path — local/NFS directly,
    or any mount the fs layer exposes.  Provides barrier / all_gather /
    all_reduce; each collective round uses fresh filenames so rounds
    can't cross-talk.

    Use a FRESH `path` per job (the reference's per-job HDFS path
    contract): leftover files from a previous run under the same path
    would satisfy the first rounds with dead data.  Within a run, each
    rank lag-deletes its own round N-2 file when starting round N
    (entering round N proves every rank finished reading round N-2),
    so disk usage stays bounded."""

    def __init__(self, rank, size, path, prefix=""):
        self.rank = int(rank)
        self.size = int(size)
        self.path = path
        self.prefix = prefix
        self._round = 0
        # (round, value) of a timed-out all_gather awaiting retry
        self._pending = None
        os.makedirs(path, exist_ok=True)

    def _fname(self, tag, rank, rnd=None):
        return os.path.join(
            self.path,
            f"{self.prefix}r{self._round if rnd is None else rnd}"
            f"_{tag}_{rank}")

    def all_gather(self, value, timeout=60.0):
        """Gather one JSON-serializable value per rank; returns the list
        ordered by rank.

        A TimeoutError leaves this rank's file IN PLACE (a peer may have
        already consumed it and completed the round — deleting it would
        desynchronize round contents across ranks); the
        caller may retry, but must resend the identical value, which is
        enforced here.
        """
        if self._pending is not None:
            rnd, prev = self._pending
            if value != prev:
                raise ValueError(
                    f"rendezvous retry for round {rnd} must resend the "
                    f"identical value: a peer may have already read the "
                    f"published {prev!r}, so changing it to {value!r} "
                    f"would leave ranks disagreeing on round contents")
            # our file for this round is already published — just re-read
        else:
            self._round += 1
            # bounded cleanup: everyone has read our round N-2 file by now
            old = self._fname("v", self.rank, rnd=self._round - 2)
            if self._round >= 3 and os.path.exists(old):
                os.remove(old)
            mine = self._fname("v", self.rank)
            with open(mine + ".part", "w") as f:
                json.dump(value, f)
            os.replace(mine + ".part", mine)
        deadline = time.time() + timeout
        out = []
        try:
            for r in range(self.size):
                fn = self._fname("v", r)
                while not os.path.exists(fn):
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"rendezvous: rank {r} missing after "
                            f"{timeout}s ({fn})")
                    time.sleep(0.02)
                # the writer's os.replace makes the read atomic
                with open(fn) as f:
                    out.append(json.load(f))
        except TimeoutError:
            # keep our file published and remember the round so a retry
            # re-enters THIS round with the same value
            self._pending = (self._round, value)
            raise
        self._pending = None
        return out

    def barrier(self, timeout=60.0):
        self.all_gather(None, timeout=timeout)

    def all_reduce(self, arr, timeout=60.0):
        """Element-wise sum of one ndarray/list per rank."""
        import numpy as np

        vals = self.all_gather(np.asarray(arr).tolist(), timeout=timeout)
        return np.sum([np.asarray(v) for v in vals], axis=0)


class GeneralRoleMaker(RoleMakerBase):
    """Env-contract role maker with rendezvous communicators (parity:
    role_maker.py:542 GeneralRoleMaker — same env variables; the Gloo
    groups become file-rendezvous groups under ``path``).  Three
    communicators are built, matching the reference: one among workers,
    one among servers, one among everyone.

    IMPORTANT (same contract as the reference's per-job HDFS path): the
    rendezvous directory must be FRESH per job run — pass a unique
    ``path`` or set SYS_JOB_ID per run; a restart reusing the directory
    of a crashed run can consume its leftover files.  Call ``cleanup()``
    (after training, any rank) to best-effort remove the job's
    rendezvous state so clean restarts are safe."""

    def __init__(self, path=None, **kwargs):
        super().__init__()
        self._path = path or os.path.join(tempfile.gettempdir(),
                                          "paddle_tpu_rendezvous")
        self._prefix = os.environ.get("SYS_JOB_ID", "")
        self._role_is_generated = False
        self._node_type_comm = None
        self._all_comm = None

    @staticmethod
    def _env(name):
        """Required launcher-contract variable, with a setup hint instead
        of a bare KeyError."""
        try:
            return os.environ[name]
        except KeyError:
            raise ValueError(
                f"GeneralRoleMaker: environment variable {name} is not "
                f"set.  The launcher contract (distributed/launch.py, "
                f"mirroring the reference's fleet launch) must export "
                f"PADDLE_PSERVERS_IP_PORT_LIST, PADDLE_TRAINER_ENDPOINTS,"
                f" TRAINING_ROLE, and PADDLE_TRAINER_ID / "
                f"PADDLE_PSERVER_ID on every process.") from None

    def generate_role(self):
        if self._role_is_generated:
            return
        eplist = [e for e in self._env(
            "PADDLE_PSERVERS_IP_PORT_LIST").split(",") if e]
        worker_endpoints = [e for e in self._env(
            "PADDLE_TRAINER_ENDPOINTS").split(",") if e]
        training_role = self._env("TRAINING_ROLE")
        if training_role not in ("TRAINER", "PSERVER"):
            raise ValueError("TRAINING_ROLE must be PSERVER or TRAINER")
        self._worker_endpoints = worker_endpoints
        self._server_endpoints = eplist
        # job-scoped subdir: different topologies/jobs under the same
        # base path cannot read each other's files
        topo = ",".join(worker_endpoints) + "|" + ",".join(eplist) \
            + "|" + self._prefix
        self._path = os.path.join(
            self._path, hashlib.md5(topo.encode()).hexdigest()[:12])
        if training_role == "TRAINER":
            self._role = Role.WORKER
            self._current_id = int(self._env("PADDLE_TRAINER_ID"))
            self._node_type_comm = _FileRendezvous(
                self._current_id, len(worker_endpoints),
                os.path.join(self._path, "trainer"), self._prefix)
            all_rank = self._current_id
        else:
            self._role = Role.SERVER
            self._current_id = int(self._env("PADDLE_PSERVER_ID"))
            self._node_type_comm = _FileRendezvous(
                self._current_id, len(eplist),
                os.path.join(self._path, "pserver"), self._prefix)
            all_rank = len(worker_endpoints) + self._current_id
        self._all_comm = _FileRendezvous(
            all_rank, len(worker_endpoints) + len(eplist),
            os.path.join(self._path, "all"), self._prefix)
        self._role_is_generated = True

    # -- collective surface (fleet_util consumes these) -------------------
    def _ensure(self):
        if not self._role_is_generated:
            self.generate_role()

    def barrier_worker(self):
        self._ensure()
        if self.is_worker():
            self._node_type_comm.barrier()

    def barrier_all(self):
        self._ensure()
        self._all_comm.barrier()

    def all_reduce_worker(self, arr):
        """Sum an array across workers (no-op pass-through on servers)."""
        self._ensure()
        if not self.is_worker():
            return arr
        return self._node_type_comm.all_reduce(arr)

    def all_gather_worker(self, value):
        """Gather across WORKERS; on a server this is a pass-through
        singleton (mirrors all_reduce_worker — the server group must
        not masquerade as the worker group)."""
        self._ensure()
        if not self.is_worker():
            return [value]
        return self._node_type_comm.all_gather(value)

    def cleanup(self):
        """Best-effort removal of this job's rendezvous directory (call
        after training; makes a restart under the same path safe)."""
        import shutil

        shutil.rmtree(self._path, ignore_errors=True)

    def is_worker(self):
        self._ensure()
        return self._role == Role.WORKER

    def is_server(self):
        self._ensure()
        return self._role == Role.SERVER


class MPISymetricRoleMaker(RoleMakerBase):
    """Symmetric worker/server assignment under an MPI launch (parity:
    role_maker.py:225 MPISymetricRoleMaker — same split: with 2
    processes per node, EVEN ranks become servers and ODD ranks
    workers, worker/server index = rank // 2, endpoints gathered from
    the ranks and interleaved servers=eps[::2] / workers=eps[1::2]).

    Deliberate deviation, documented: mpi4py is not in this
    environment, so rank/size come from the env every MPI launcher
    exports (OMPI_COMM_WORLD_* for Open MPI, PMI_*/PMIX_* for
    MPICH/SLURM) and the intra-group collectives ride the same
    file-rendezvous communicators GeneralRoleMaker uses (MPI jobs have
    a shared filesystem by construction).  Concurrent same-size jobs
    sharing ``path`` are separated by the launcher's job id
    (SLURM_JOB_ID etc.); launchers exporting none should pass a unique
    ``path`` or set SYS_JOB_ID.  The (typo'd) reference class name is
    kept for API parity.
    """

    # (rank, size) variable PAIRS per launcher family — resolved as a
    # pair so a stale variable from a different launcher can never mix
    # rank and size from two worlds
    _ENV_FAMILIES = (
        ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),   # Open MPI
        ("PMI_RANK", "PMI_SIZE"),                           # MPICH
        ("PMIX_RANK", "SLURM_NTASKS"),    # srun --mpi=pmix (no PMIX_SIZE)
        ("SLURM_PROCID", "SLURM_NTASKS"),                   # plain srun
    )
    # a per-job token keeps two concurrent same-size jobs on a shared
    # filesystem out of each other's rendezvous directory
    _JOB_VARS = ("SYS_JOB_ID", "SLURM_JOB_ID", "PBS_JOBID",
                 "OMPI_MCA_ess_base_jobid", "LSB_JOBID")

    def __init__(self, path=None):
        super().__init__()
        self._path = path or os.path.join(tempfile.gettempdir(),
                                          "paddle_tpu_mpi_rendezvous")
        self._proc_per_node = 2
        self._role_is_generated = False
        self._node_type_comm = None
        self._all_comm = None

    @classmethod
    def _discover(cls):
        for rank_var, size_var in cls._ENV_FAMILIES:
            r, s = os.environ.get(rank_var), os.environ.get(size_var)
            if r is not None and s is not None:
                return int(r), int(s)
        raise ValueError(
            "MPISymetricRoleMaker: no MPI rank/size variable pair found "
            "(looked for OMPI_COMM_WORLD_*, PMI_*, PMIX_RANK+"
            "SLURM_NTASKS, SLURM_PROCID+SLURM_NTASKS) — launch under "
            "mpirun/srun, or use GeneralRoleMaker with the PADDLE_* "
            "env contract")

    @classmethod
    def _job_token(cls):
        for v in cls._JOB_VARS:
            t = os.environ.get(v)
            if t:
                return t
        return ""

    def generate_role(self):
        import socket

        if self._role_is_generated:
            return
        rank, size = self._discover()
        if size % self._proc_per_node:
            raise ValueError(
                f"MPISymetricRoleMaker needs an even world size "
                f"(2 procs/node), got {size}")
        job = self._job_token()
        topo = f"{size}|{job}"
        base = os.path.join(self._path,
                            hashlib.md5(topo.encode()).hexdigest()[:12])
        # even rank -> server (node_type 0), odd -> worker (node_type 1)
        self._role = Role.WORKER if rank % 2 else Role.SERVER
        self._current_id = rank // 2
        n_pairs = size // 2
        group = "worker" if rank % 2 else "server"
        self._node_type_comm = _FileRendezvous(
            self._current_id, n_pairs, os.path.join(base, group), job)
        self._all_comm = _FileRendezvous(
            rank, size, os.path.join(base, "all"), job)
        # REAL endpoints, not placeholders: gather each rank's
        # ip:port over the all-ranks rendezvous (the reference's
        # MPIRoleMaker does the same through MPI allgather), so the
        # fleet PS/collective init surfaces get resolvable addresses
        try:
            ip = socket.gethostbyname(socket.gethostname())
        except OSError:
            ip = socket.gethostname()
        eps = self._all_comm.all_gather(f"{ip}:{6000 + rank}")
        self._server_endpoints = eps[::2]
        self._worker_endpoints = eps[1::2]
        self._role_is_generated = True

    # -- collective surface (mirrors GeneralRoleMaker) --------------------
    def _ensure(self):
        if not self._role_is_generated:
            self.generate_role()

    def barrier_worker(self):
        self._ensure()
        if self.is_worker():
            self._node_type_comm.barrier()

    def barrier_all(self):
        self._ensure()
        self._all_comm.barrier()

    def all_gather(self, value):
        """Gather across ALL ranks (workers + servers), rank-ordered."""
        self._ensure()
        return self._all_comm.all_gather(value)

    def all_reduce_worker(self, arr):
        self._ensure()
        if not self.is_worker():
            return arr
        return self._node_type_comm.all_reduce(arr)
