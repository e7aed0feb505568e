from .preintegration import (
    ImuParameters,
    Preintegral,
    error_and_jacobians,
    gravity_vector,
    preintegrate,
    propagate,
    sqrt_information,
)

__all__ = [
    "ImuParameters",
    "Preintegral",
    "error_and_jacobians",
    "gravity_vector",
    "preintegrate",
    "propagate",
    "sqrt_information",
]
