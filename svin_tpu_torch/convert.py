"""Carry state between the JAX package and the port as numpy trees.

``from_numpy_tree`` turns NamedTuples whose leaves are arrays (numpy, or
anything ``numpy.asarray`` takes) into the port's NamedTuple of the same
class name with tensor leaves; ``to_numpy_tree`` goes the other way. Float
arrays become ``dtype``, bool stays bool, integer index arrays keep their
width, and packed uint32 descriptor words become their bit-identical int32
view. Non-array leaves (ints, strings, Python floats, None) pass through.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import estimator, imu, kinematics
from .cameras import PinholeCamera
from .estimator import factors as _factors
from .estimator import gauss_newton as _gn

PORT_TYPES = {
    cls.__name__: cls
    for cls in (
        estimator.WindowState, estimator.Factors, estimator.ReprojectionFactors,
        estimator.ImuFactors, estimator.DepthFactors, estimator.SonarFactors,
        estimator.PriorFactors, estimator.ExtrinsicsPrior, estimator.MarginalPrior,
        estimator.LandmarkPrior, estimator.RigParams, estimator.OptimizeResult,
        estimator.WindowConfig, imu.Preintegral, imu.ImuParameters,
        kinematics.Transformation, PinholeCamera, _gn.NormalEqs,
        _factors.ReprojEval, _factors.ImuEval, _factors.ScalarEval,
        _factors.PriorEval, _factors.LmPriorEval, _factors.ExtPriorEval,
    )
}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def array_to_tensor(a, device=None, dtype=torch.float64) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)
    return torch.as_tensor(np.array(a), device=device)


def from_numpy_tree(tree, device=None, dtype=torch.float64):
    """numpy-leaf NamedTuples (e.g. the JAX package's WindowState, Factors,
    RigParams, Preintegral, OptimizeResult) → the port's NamedTuples."""
    if _is_namedtuple(tree):
        cls = PORT_TYPES.get(type(tree).__name__)
        if cls is None:
            return type(tree)(*(from_numpy_tree(x, device, dtype) for x in tree))
        # by field name: fields only the JAX package has (an XLA knob like
        # WindowConfig.unroll) are dropped
        return cls(**{f: from_numpy_tree(getattr(tree, f), device, dtype)
                      for f in cls._fields if hasattr(tree, f)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(x, device, dtype) for x in tree)
    if hasattr(tree, "__array__"):
        return array_to_tensor(tree, device, dtype)
    return tree


def to_numpy_tree(tree):
    """Tensor-leaf NamedTuples → the same NamedTuples with numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy_tree(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(x) for x in tree)
    return tree


def tree_to(tree, device=None, dtype=None):
    """Move every tensor leaf to ``device``; cast floating leaves to
    ``dtype`` (integer and bool leaves keep theirs)."""
    if isinstance(tree, torch.Tensor):
        if dtype is not None and tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree.to(device=device)
    if _is_namedtuple(tree):
        return type(tree)(*(tree_to(x, device, dtype) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(x, device, dtype) for x in tree)
    return tree
