"""Carry state between the JAX package and the port as numpy trees.

``from_numpy_tree`` turns NamedTuples whose leaves are arrays (numpy, or
anything ``numpy.asarray`` takes) into the port's NamedTuple of the same
class name with tensor leaves; ``to_numpy_tree`` goes the other way (host
copies). Float arrays become ``dtype``, bool stays bool, integer index
arrays keep their width, and packed uint32 descriptor words become their
bit-identical int32 view. Non-array leaves (ints, strings, Python floats,
None) pass through.

For the engine: ``config_from_numpy`` (a JAX-package ``VioConfig``, whose
fields are numpy and Python values → the port's), ``renderer_from_scene``
(a synthetic scene as numpy arrays → the port's renderer) and
``engine_from_state`` (an engine's host state as numpy → a port
``VioEngine``). For loop closure: ``vocabulary_from_numpy`` and
``product_vocabulary_from_numpy`` (codebooks as uint32 words, idf weights),
and ``posegraph_from_numpy`` (the pose-graph tables ``PoseGraphNodes`` /
``PoseGraphEdges`` / ``PoseGraph6Nodes`` / ``PoseGraph6Edges``). Callers hand over host values only: extract
them with the JAX package's own tools first.
"""
from __future__ import annotations

import dataclasses
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
    """Host array → an independent tensor on ``device``: floats as
    ``dtype``, packed uint32 words as their int32 view, other dtypes kept.
    The dtype is converted on the host. For a CUDA device the array is
    staged in pinned memory from PyTorch's caching host allocator and copied
    with ``non_blocking=True`` on the current stream, so the host does not
    wait for the device (a copy from pageable memory would); the allocator
    keeps the staging block until the copy's stream event has passed, and a
    consumer on another stream waits on an event and calls
    ``record_stream``, as for any tensor made on this stream."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(torch.empty(0, dtype=dtype).numpy().dtype, copy=False)
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return torch.from_numpy(np.array(a)).to(dev)
    host = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype, pin_memory=True)
    host.numpy()[...] = a
    return host.to(dev, non_blocking=True)


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


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if _is_namedtuple(tree):
        return type(tree)(*(_map_tensors(x, fn) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(x, fn) for x in tree)
    return tree


def to_numpy_tree(tree):
    """Tensor-leaf NamedTuples → the same NamedTuples with numpy leaves
    (independent host copies). One fetch: every device leaf is queued as a
    non-blocking copy into pinned host memory, then the host waits once."""
    streams = {}

    def fetch(t):
        t = t.detach()
        if t.device.type == "cpu":
            return np.array(t.numpy())  # .numpy() shares the tensor's memory
        streams.setdefault(t.device, torch.cuda.current_stream(t.device))
        return t.to("cpu", non_blocking=True)

    host = _map_tensors(tree, fetch)
    if not streams:
        return host
    for s in streams.values():
        s.synchronize()
    return _map_tensors(host, lambda t: t.numpy())


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


def numpy_tree_as_port(tree):
    """A numpy-leaf NamedTuple tree (the JAX package's classes) → the port's
    classes of the same names with numpy leaves (copies; uint32 words as
    their int32 view)."""
    if _is_namedtuple(tree):
        cls = PORT_TYPES.get(type(tree).__name__, type(tree))
        return cls(**{f: numpy_tree_as_port(getattr(tree, f))
                      for f in cls._fields if hasattr(tree, f)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree_as_port(x) for x in tree)
    if hasattr(tree, "__array__"):
        a = np.array(tree)
        return a.view(np.int32) if a.dtype == np.uint32 else a
    return tree


def posegraph_from_numpy(tree, device=None, dtype=torch.float64):
    """The JAX package's pose-graph tables (numpy leaves; ``is_loop`` may be
    None) → the port's, on ``device`` with float leaves in ``dtype``."""
    from .loopclosure import posegraph

    cls = getattr(posegraph, type(tree).__name__)
    return cls(**{f: None if getattr(tree, f, None) is None
                  else array_to_tensor(getattr(tree, f), device, dtype) for f in cls._fields})


def vocabulary_from_numpy(vocab, weights=None, device=None):
    """A flat codebook (V, 8) of uint32 words and optional idf weights (V,)
    → (int32 words, float32 weights or None) on ``device``."""
    from .loopclosure.retrieval import as_words

    w = None if weights is None else torch.as_tensor(np.asarray(weights, np.float32), device=device)
    return as_words(np.asarray(vocab), device), w


def product_vocabulary_from_numpy(pv, device=None):
    """The JAX package's ``ProductVocabulary`` (or any object with
    ``vocab1``, ``vocab2`` and ``idf`` as numpy values) → the port's."""
    from .loopclosure.retrieval import ProductVocabulary, as_words

    idf = getattr(pv, "idf", None)
    return ProductVocabulary(
        vocab1=as_words(np.asarray(pv.vocab1), device), vocab2=as_words(np.asarray(pv.vocab2), device),
        idf=None if idf is None else torch.as_tensor(np.asarray(idf, np.float32), device=device))


def config_from_numpy(cfg):
    """A JAX-package ``VioConfig`` (numpy and Python fields) → the port's."""
    from .pipeline import config as pc

    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(pc.VioConfig)}
    d["cameras"] = [pc.CameraConfig(**{f.name: getattr(c, f.name)
                                       for f in dataclasses.fields(pc.CameraConfig)})
                    for c in cfg.cameras]
    d["imu"] = imu.ImuParameters(**{k: getattr(cfg.imu, k) for k in imu.ImuParameters._fields})
    for name, cls in (("loop_closure", pc.LoopClosureConfig), ("health", pc.HealthConfig),
                      ("global_map", pc.GlobalMapConfig)):
        sub = getattr(cfg, name)
        d[name] = cls(**{f.name: getattr(sub, f.name) for f in dataclasses.fields(cls)})
    d["T_BS"] = np.array(cfg.T_BS, float)
    d["T_SSo"] = np.array(cfg.T_SSo, float)
    return pc.VioConfig(**d)


def renderer_from_scene(rig, traj, scene: dict):
    """A synthetic scene ``{"points_W", "brightness", "icov_a", "icov_b",
    "icov_c", "blob_sigma"}`` (numpy) → the port's ``SyntheticRenderer`` on
    ``rig`` (an ``NCameraSystem`` of the port) along ``traj``."""
    from .pipeline.dataset import SyntheticRenderer

    return SyntheticRenderer.from_scene(
        rig, traj, scene["points_W"], scene["brightness"], scene["icov_a"], scene["icov_b"],
        scene["icov_c"], scene["blob_sigma"])


# the engine attributes that carry its state from one frame to the next
ENGINE_STATE_FIELDS = (
    "window", "factors", "_lm_desc", "_lm_cov", "frames", "imu_t", "imu_gyro", "imu_acc",
    "depth_buffer", "sonar_buffer", "first_depth", "n_states", "last_kf_slot",
    "_track_miss_streak", "_cost_last", "_lm_iterations_last", "rotation_only_detections",
    "frame_count", "kf_count", "_kf_index_by_state_id", "sequence", "next_state_id",
    "next_lm_id", "trajectory", "_rng", "scale_refiner", "_last_ransac_T_WS", "_scale_last_t",
    "_opt_iter_ema", "_opt_calls",
)


def engine_from_state(engine, state: dict):
    """Load an engine's host state into the port ``engine`` (in place;
    returned). ``state`` maps each name of ``ENGINE_STATE_FIELDS`` to numpy
    and Python values: the window and factor tables as numpy-leaf
    NamedTuples, ``frames`` as {slot: dict of the frame record's fields,
    ``image0`` a uint8 array or None}, ``_rng`` as ``RandomState.get_state()``,
    ``scale_refiner`` as a dict of its fields (``result`` a dict or None),
    ``_last_ransac_T_WS`` as (r, q) or None."""
    import copy

    from .frontend.scale_refinement import ScaleEstimate, ScaleRefiner
    from .kinematics import Transformation
    from .pipeline.vio import _FrameData

    st = copy.deepcopy(state)
    engine.window = numpy_tree_as_port(st.pop("window"))
    engine.factors = numpy_tree_as_port(st.pop("factors"))
    engine._lm_desc = numpy_tree_as_port(st.pop("_lm_desc"))
    engine._lm_cov = np.array(st.pop("_lm_cov"), float)
    frames = {}
    for slot, fd in st.pop("frames").items():
        fd = dict(fd)
        img0 = fd.pop("image0")
        frames[int(slot)] = _FrameData(
            image0=None if img0 is None else torch.as_tensor(np.array(img0), device=engine.device),
            **{k: [numpy_tree_as_port(a) for a in v] if isinstance(v, (list, tuple)) else v
               for k, v in fd.items()})
    engine.frames = frames
    rng = np.random.RandomState()
    rng.set_state(st.pop("_rng"))
    engine._rng = rng
    sr = st.pop("scale_refiner")
    result = sr.pop("result")
    engine.scale_refiner = ScaleRefiner(
        **sr, result=None if result is None else ScaleEstimate(**result))
    T = st.pop("_last_ransac_T_WS")
    engine._last_ransac_T_WS = None if T is None else Transformation(
        r=np.array(T[0]), q=np.array(T[1]))
    engine.trajectory = [(t, np.array(r), np.array(q)) for t, r, q in st.pop("trajectory")]
    for k, v in st.items():
        setattr(engine, k, v)
    return engine
