"""HDFSClient (parity: incubate/fleet/utils/hdfs.py:45): the Fleet-side
convenience wrapper over the pluggable fs layer — checkpoint upload,
warehouse listing, existence checks for PS-mode training jobs.

Counterpart of paddle_tpu/incubate/fleet/utils/hdfs.py, copied over the
port's ``fs``."""
from __future__ import annotations

from .... import fs as _fs


class HDFSClient:
    """API-parity subset of the reference HDFSClient; `hadoop_home` +
    `configs` assemble the launcher command the same way (the reference
    builds `${hadoop_home}/bin/hadoop fs -D k=v ...`)."""

    def __init__(self, hadoop_home=None, configs=None):
        cmd = "hadoop fs" if hadoop_home is None \
            else f"{hadoop_home}/bin/hadoop fs"
        for k, v in (configs or {}).items():
            cmd += f" -D{k}={v}"
        self._fs = _fs.HadoopFS(command=cmd)

    def is_exist(self, path):
        return self._fs.exists(path)

    def is_file(self, path):
        return self._fs.is_file(path)

    def ls(self, path):
        return self._fs.ls(path)

    def mkdirs(self, path):
        self._fs.mkdir(path)

    def delete(self, path):
        self._fs.remove(path)

    def upload(self, local_path, hdfs_path):
        self._fs.upload(local_path, hdfs_path)

    def download(self, hdfs_path, local_path):
        self._fs.download(hdfs_path, local_path)
