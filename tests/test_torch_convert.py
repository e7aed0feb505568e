"""The port's host-to-device upload (``convert.array_to_tensor``, behind
``from_numpy_tree`` and the engine's transfers) against the conversion it
made before it staged through pinned memory, on the CPU: the same dtype, shape and values
for every array dtype the engine hands over, the uint32 descriptor words
as their int32 view, and a copy independent of the host array. Exact (the
float conversions round the same way in numpy and torch). The pinned,
non-blocking path for a card runs in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from svin_tpu_torch.convert import array_to_tensor, from_numpy_tree
from svin_tpu_torch.kinematics import Transformation


def _before(a, device=None, dtype=torch.float64):
    """The conversion ``array_to_tensor`` made before it staged through
    pinned memory."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)
    return torch.as_tensor(np.array(a), device=device)


_RNG = np.random.default_rng(0)
ARRAYS = {
    "float64": _RNG.standard_normal((5, 3)),
    "float32": _RNG.standard_normal(7).astype(np.float32),
    "float16": _RNG.standard_normal(4).astype(np.float16),
    "float64_0d": np.float64(0.1),
    "python_float": 1.0 / 3.0,
    "int64": np.arange(-3, 9).reshape(3, 4),
    "int32": np.arange(6, dtype=np.int32),
    "int16": np.arange(-4, 4, dtype=np.int16),
    "int8": np.arange(-4, 4, dtype=np.int8),
    "uint8": np.arange(250, 256, dtype=np.uint8),
    "uint32_words": _RNG.integers(0, 2**32, size=(4, 8), dtype=np.uint64).astype(np.uint32),
    "bool": _RNG.random(9) < 0.5,
    "python_ints": [1, 2, 3],
    "strided": np.arange(20.0).reshape(4, 5)[:, ::2],
    "fortran": np.asfortranarray(_RNG.standard_normal((3, 4))),
}


@pytest.mark.parametrize("name", list(ARRAYS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_upload_matches_the_conversion_it_replaced(name, dtype):
    a = ARRAYS[name]
    want = _before(a, "cpu", dtype)
    for got in (array_to_tensor(a, "cpu", dtype), array_to_tensor(a, None, dtype)):
        assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
        assert torch.equal(got, want)
    if name == "uint32_words":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), a)


def test_upload_copies_and_trees_go_through_it():
    a = np.arange(4.0)
    t = array_to_tensor(a, "cpu", torch.float64)
    a[0] = 99.0
    assert float(t[0]) == 0.0  # independent of the host array
    ro = np.arange(3.0)
    ro.setflags(write=False)
    assert torch.equal(array_to_tensor(ro, "cpu", torch.float32), torch.arange(3.0))
    T = from_numpy_tree(Transformation(r=np.array([1.0, 2.0, 3.0]), q=np.array([0.0, 0, 0, 1])),
                        dtype=torch.float32)
    assert T.r.dtype == torch.float32 and torch.equal(T.q, torch.tensor([0.0, 0, 0, 1]))
