from . import quaternion
from .transformation import (
    Transformation,
    compose,
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
    "from_rq",
    "identity",
    "inverse",
    "ominus",
    "oplus",
    "quaternion",
    "transform_point",
]
