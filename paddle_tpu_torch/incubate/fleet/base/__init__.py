from .fleet_base import DistributedOptimizer, Fleet  # noqa: F401
from .role_maker import (  # noqa: F401
    GeneralRoleMaker,
    PaddleCloudRoleMaker,
    Role,
    RoleMakerBase,
    UserDefinedRoleMaker,
)
