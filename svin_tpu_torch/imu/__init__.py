from .preintegration import (
    ImuParameters,
    Preintegral,
    error_and_jacobians,
    gravity_vector,
    init_pose_from_imu,
    preintegrate,
    propagate,
    sqrt_information,
)

__all__ = [
    "ImuParameters",
    "Preintegral",
    "error_and_jacobians",
    "gravity_vector",
    "init_pose_from_imu",
    "preintegrate",
    "propagate",
    "sqrt_information",
]
