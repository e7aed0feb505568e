from . import distortion
from .ncamera import NCameraSystem
from .pinhole import (
    PinholeCamera,
    back_project,
    make_camera,
    project,
    project_jacobian,
)

__all__ = [
    "NCameraSystem",
    "PinholeCamera",
    "back_project",
    "distortion",
    "make_camera",
    "project",
    "project_jacobian",
]
