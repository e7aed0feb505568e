"""The port's kernels against the JAX package's Pallas kernels.

B1 (dense SPD solve), B2 (Hamming distance matrix) and the fused matcher
(distances + selection): on the CPU the port runs each kernel's plain
version, held here to the JAX Pallas kernel in interpret mode (as
``tests/test_ops.py`` runs it) and to the JAX package's own CPU path. The CUDA kernels themselves run only on a card:
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
from svin_tpu_torch import problems
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


@pytest.mark.parametrize("D", [5, 120, 132, 330, 384, 1024])
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


def test_solve_on_the_cpu_takes_no_kernel_route():
    """CPU tensors go to the plain Cholesky whatever their size and dtype:
    no route's count moves (the kernels and the library route are CUDA's)."""
    routes = (tsolve.spd_solve_chol, tsolve.spd_solve_cluster, tsolve.solve_spd_library)
    before = [f.launches for f in routes]
    rng = np.random.default_rng(4)
    for D, dtype in ((330, torch.float32), (40, torch.float64), (1100, torch.float32)):
        H, b = (torch.as_tensor(x, dtype=dtype) for x in _spd(rng, D))
        assert torch.equal(tsolve.solve_spd(H, b), tsolve.solve_spd_plain(H, b))
    assert [f.launches for f in routes] == before


def _planted_codebook(rng, K, V, W, batch=None):
    """Descriptors and a codebook with repeated codewords and descriptors
    sitting on them (ties in the minimum) and near copies of them."""
    shape = (() if batch is None else (batch,))
    vocab = _desc(rng, V * (batch or 1), W).reshape(shape + (V, W))
    desc = _desc(rng, K * (batch or 1), W).reshape(shape + (K, W))
    n = V // 4
    vocab[..., V - n:, :] = vocab[..., :n, :]  # equal codewords
    desc[..., :n, :] = vocab[..., :n, :]  # exact hits on them
    desc[..., n:2 * n, 0] = vocab[..., :n, 0] ^ 1  # one bit off them
    return desc, vocab


@pytest.mark.parametrize("case", ["shared", "batched_desc", "per_batch"])
def test_nearest_codeword_plain_matches_jax(case):
    """The nearest codeword (the word assignment's kernel, plain version)
    against ``jnp.argmin`` of the JAX reference distance matrix, ties to the
    first index, with a shared codebook (2-D, and a batch of descriptors)
    and a codebook per batch entry (the product vocabulary's halves)."""
    rng = np.random.default_rng(len(case))
    if case == "shared":
        desc, vocab = _planted_codebook(rng, 300, 64, 8)
        descs, vocabs = [desc], [vocab]
    elif case == "batched_desc":
        desc, vocab = _planted_codebook(rng, 90, 40, 8)
        other = desc.copy()
        other[20:] = _desc(rng, 70)  # the same planted rows, other free ones
        desc = np.stack([desc, other])
        descs, vocabs = list(desc), [vocab, vocab]
    else:
        desc, vocab = _planted_codebook(rng, 150, 256, 4, batch=2)
        descs, vocabs = list(desc), list(vocab)
    got = tham.nearest_codeword(torch.as_tensor(desc.view(np.int32)),
                                torch.as_tensor(vocab.view(np.int32)))
    assert got.dtype == torch.int64
    got = got.reshape(len(descs), -1).numpy()
    for k, (d, v) in enumerate(zip(descs, vocabs)):
        want = np.asarray(jnp.argmin(jham.hamming_matrix_ref(jnp.asarray(d), jnp.asarray(v)), axis=1))
        np.testing.assert_array_equal(got[k], want)
        n = v.shape[0] // 4
        assert (got[k][:n] == np.arange(n)).all()  # the first of two equal codewords


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: CPU tensors, wrong dtypes and
    non-contiguous input are refused before any build or launch."""
    H, b = torch.eye(4, dtype=torch.float32), torch.ones(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tsolve.spd_solve_chol(H, b)
    with pytest.raises(TypeError):
        tsolve.spd_solve_chol(H.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        tsolve.spd_solve_chol(torch.eye(8)[::2, ::2], torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        tsolve.spd_solve_cluster(H, b)
    with pytest.raises(TypeError):
        tsolve.spd_solve_cluster(H.double(), b.double())
    a = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tham.nearest_codeword_cuda(a, a)
    with pytest.raises(TypeError):
        tham.nearest_codeword_cuda(a.float(), a.float())
    with pytest.raises(ValueError, match="contiguous"):
        tham.nearest_codeword_cuda(torch.zeros((3, 16), dtype=torch.int32)[:, ::2], a)
    with pytest.raises(ValueError, match="CUDA"):
        tham.hamming_matrix_cuda(a, a)
    with pytest.raises(TypeError):
        tham.hamming_matrix_cuda(a.float(), a.float())
    with pytest.raises(ValueError, match="contiguous"):
        tham.hamming_matrix_cuda(torch.zeros((3, 16), dtype=torch.int32)[:, ::2], a)
    va = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tham.match_descriptors_cuda(a, a, va, va)
    with pytest.raises(TypeError):
        tham.match_descriptors_cuda(a, a, va.int(), va)
    with pytest.raises(ValueError, match="contiguous"):
        tham.match_descriptors_cuda(a, a, va, va, mask=torch.ones((3, 6), dtype=torch.bool)[:, ::2])


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


@pytest.mark.parametrize("ratio", [0.0, 0.8])
@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_fused_matcher_plain_matches_jax(ratio, mutual, masked):
    """The fused matcher's plain version (``match_descriptors_plain``, the
    oracle the CUDA kernel is held to bit for bit) against the JAX
    package's ``match_descriptors``, per camera of a batch of two against a
    shared b, integer-exact."""
    rng = np.random.default_rng(int(ratio * 10) + 2 * mutual + 4 * masked)
    a, b, va, vb, mask = problems.matcher_case(rng)
    got = tham.match_descriptors_plain(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(va), torch.as_tensor(vb),
        torch.as_tensor(mask) if masked else None, max_distance=60, ratio=ratio, mutual=mutual)
    assert bool(got.valid.any())
    for c in range(a.shape[0]):
        want = jham.match_descriptors(
            jnp.asarray(a[c].view(np.uint32)), jnp.asarray(b.view(np.uint32)),
            jnp.asarray(va[c]), jnp.asarray(vb),
            jnp.asarray(mask[c]) if masked else None, max_distance=60, ratio=ratio, mutual=mutual)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(w))
    if masked:
        assert got.dist[:, 7].tolist() == [tham.BIG] * a.shape[0]  # fully masked row
        assert got.idx_b[:, 7].tolist() == [-1] * a.shape[0]
    if not mutual and ratio == 0.0:
        assert got.idx_b[:, 0].tolist() == [5] * a.shape[0]  # row tie: lowest column


def test_match_descriptors_dispatches_cpu_to_plain():
    args = tuple(torch.as_tensor(x) for x in problems.matcher_case(np.random.default_rng(11)))
    n0 = tham.match_descriptors_cuda.launches
    got = tham.match_descriptors(*args, ratio=0.8)
    want = tham.match_descriptors_plain(*args, ratio=0.8)
    assert tham.match_descriptors_cuda.launches == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
