"""Mapping/SLAM namespace mirroring the reference's
``ouster.sdk.mapping`` (ref: python/src/ouster/sdk/mapping/__init__.py):
KISS-ICP odometry with a host backend (KissICP) and a device backend
(DeviceICP, its Gauss-Newton loop on the device), the engines, deskew,
time correction and the offline pose optimizer (numpy and scipy)."""

from .engine import (  # noqa: F401
    LocalizationConfig,
    LocalizationEngine,
    SlamConfig,
    SlamEngine,
    determine_voxel_size,
)
from .deskew import (  # noqa: F401
    ConstantVelocityDeskewMethod,
    DeskewMethod,
    DeskewMethodFactory,
    InertialIntegrationImuDeskewMethod,
    NoneDeskewMethod,
    make_deskew_method,
)
from .time_correction import ActiveTimeCorrection  # noqa: F401
from .kiss_icp import KissConfig, KissICP  # noqa: F401
from .device_icp import DeviceICP, register_points_device  # noqa: F401
from .pose_optimizer import (  # noqa: F401
    AbsolutePointConstraint,
    AbsolutePoseConstraint,
    LossFunction,
    Node,
    PointToPointConstraint,
    PoseOptimizer,
    PoseToPoseConstraint,
    SamplingMode,
    SolverConfig,
    save_trajectory,
)

#: Reference binding names (ref: mapping.pyi Constraint base /
#: PoseOptimizerNode).
from typing import Union as _Union  # noqa: E402

Constraint = _Union[AbsolutePoseConstraint, PoseToPoseConstraint,
                    PointToPointConstraint, AbsolutePointConstraint]
PoseOptimizerNode = Node
