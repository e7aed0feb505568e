"""The port's kernels against the JAX package's Pallas kernels.

B1 (dense SPD solve) and B2 (Hamming distance matrix): on the CPU the port
runs each kernel's plain version, held here to the JAX Pallas kernel in
interpret mode (as ``tests/test_ops.py`` runs it) and to the JAX package's
own CPU path. The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` holds them to these plain versions there.

Tolerances: B2 and the matcher are integer-exact. The plain solve (f64
Cholesky) agrees with the JAX f64 Cholesky path to 1e-10 relative, and with
the f32 Pallas Gauss–Jordan to its f32 rounding (2e-4, the bound
``tests/test_ops.py`` holds it to against numpy). The 3x3 closed forms agree
to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu.ops import hamming as jham
from svin_tpu.ops import linalg3 as jl3
from svin_tpu.ops import solve as jsolve
from svin_tpu_torch.ops import hamming as tham
from svin_tpu_torch.ops import linalg3 as tl3
from svin_tpu_torch.ops import solve as tsolve

torch.set_num_threads(1)


def _desc(rng, n, words=8):
    return rng.integers(0, 2**32, size=(n, words), dtype=np.uint64).astype(np.uint32)


def _t32(u32):
    return torch.as_tensor(u32.view(np.int32))


@pytest.mark.parametrize("na,nb", [(1, 1), (64, 32), (128, 128)])
def test_hamming_plain_matches_pallas_interpret(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a, b = _desc(rng, na), _desc(rng, nb)
    want = np.asarray(jham.hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = tham.hamming_matrix(_t32(a), _t32(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("na,nb", [(129, 257), (400, 512), (400, 1), (3, 5)])
def test_hamming_plain_matches_reference_ragged(na, nb):
    rng = np.random.default_rng(na + 7 * nb)
    a, b = _desc(rng, na), _desc(rng, nb)
    a[0] = b[0]  # distance 0
    a[-1] = ~b[-1]  # distance 256
    want = np.asarray(jham.hamming_matrix_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tham.hamming_matrix(_t32(a), _t32(b)).numpy(), want)


def test_hamming_plain_batched_over_cameras():
    rng = np.random.default_rng(11)
    a = np.stack([_desc(rng, 40), _desc(rng, 40)])
    b = _desc(rng, 70)
    got = tham.hamming_matrix(torch.as_tensor(a.view(np.int32)), _t32(b))
    for c in range(2):
        want = np.asarray(jham.hamming_matrix_ref(jnp.asarray(a[c]), jnp.asarray(b)))
        np.testing.assert_array_equal(got[c].numpy(), want)


def _spd(rng, D):
    A = rng.standard_normal((D, D))
    return A @ A.T + D * np.eye(D), rng.standard_normal(D)


@pytest.mark.parametrize("D", [5, 120, 132])
def test_solve_plain_matches_jax(D):
    rng = np.random.default_rng(D)
    H, b = _spd(rng, D)
    got = tsolve.solve_spd(torch.as_tensor(H), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsolve.solve_spd(jnp.asarray(H), jnp.asarray(b))),
                               rtol=1e-10, atol=1e-12)
    pallas = np.asarray(jsolve.solve_spd_pallas(jnp.asarray(H), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


def test_solve_plain_batched_and_not_positive_definite():
    rng = np.random.default_rng(3)
    Hs, bs = zip(*(_spd(rng, 9) for _ in range(3)))
    H, b = torch.as_tensor(np.stack(Hs)), torch.as_tensor(np.stack(bs))
    x = tsolve.solve_spd_plain(H, b)
    for k in range(3):
        np.testing.assert_allclose(x[k].numpy(), np.linalg.solve(Hs[k], bs[k]), rtol=1e-10)
    # an indefinite system gives NaN (as the JAX cho_factor path), so LM rejects the step
    bad = tsolve.solve_spd_plain(-H[0], b[0])
    assert bool(torch.isnan(bad).all())


def test_kernel_wrappers_refuse_cpu_tensors():
    H, b = torch.eye(4, dtype=torch.float32), torch.ones(4, dtype=torch.float32)
    with pytest.raises(ValueError):
        tsolve.spd_solve_gj(H, b)
    a = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tham.hamming_matrix_cuda(a, a)
    assert tsolve.smem_bytes(120) > 48 * 1024  # needs the dynamic shared-memory opt-in
    assert tsolve.smem_bytes(239) <= tsolve.MAX_SMEM_BYTES < tsolve.smem_bytes(240)


def test_linalg3_matches_jax():
    rng = np.random.default_rng(8)
    A = rng.standard_normal((32, 3, 3))
    A = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(3)
    A[0] = 2.0 * np.eye(3)  # p == 0 branch
    v = np.array([1.0, 2.0, 3.0])
    A[1] = np.outer(v, v)  # rank 1
    np.testing.assert_allclose(tl3.eigvalsh3x3(torch.as_tensor(A)).numpy(),
                               np.asarray(jl3.eigvalsh3x3(jnp.asarray(A))), rtol=1e-12, atol=1e-12)
    B = A[2:]
    np.testing.assert_allclose(tl3.inv3x3(torch.as_tensor(B)).numpy(),
                               np.asarray(jl3.inv3x3(jnp.asarray(B))), rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("ratio,mutual", [(0.0, True), (0.0, False), (0.8, True), (0.8, False)])
def test_match_matches_jax(ratio, mutual):
    rng = np.random.default_rng(int(ratio * 10) + mutual)
    d = rng.integers(0, 90, size=(2, 30, 45)).astype(np.int32)
    d[:, 3, 7] = d[:, 3, 9] = 0  # ties resolve to the lowest index
    mask = rng.uniform(size=d.shape) < 0.7
    got = tham.match(torch.as_tensor(d), torch.as_tensor(mask), max_distance=60,
                     ratio=ratio, mutual=mutual)
    for c in range(2):
        want = jham.match(jnp.asarray(d[c]), jnp.asarray(mask[c]), max_distance=60,
                          ratio=ratio, mutual=mutual)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(w))


def test_match_descriptors_matches_jax():
    rng = np.random.default_rng(9)
    b = _desc(rng, 50)
    a = np.concatenate([b[:20] ^ np.uint32(1 << 3), _desc(rng, 25)])
    va, vb = rng.uniform(size=45) < 0.9, rng.uniform(size=50) < 0.9
    got = tham.match_descriptors(_t32(a), _t32(b), torch.as_tensor(va), torch.as_tensor(vb))
    want = jham.match_descriptors(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
