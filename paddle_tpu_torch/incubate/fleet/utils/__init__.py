from .hdfs import HDFSClient  # noqa: F401
from .fleet_util import FleetUtil  # noqa: F401
