from . import npq, quaternion
from .transformation import (
    Transformation,
    compose,
    from_matrix,
    from_rq,
    identity,
    inverse,
    ominus,
    oplus,
    transform_point,
)

__all__ = [
    "Transformation",
    "compose",
    "from_matrix",
    "from_rq",
    "identity",
    "inverse",
    "npq",
    "ominus",
    "oplus",
    "quaternion",
    "transform_point",
]
