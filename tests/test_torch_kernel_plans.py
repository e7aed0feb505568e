"""The launch plans of the port's two cluster kernels, checked on the CPU.

``csrc/spd_solve_cluster.cu`` and ``csrc/hamming_match.cu`` take their
launch plans from Python (``ops/solve.py::cluster_plan``,
``ops/hamming.py::match_plan``), so the layout each kernel relies on is
checked here without a card: every tile of the solve's padded triangle and
every column and row of the matcher has exactly one home, each CTA's share
fits the H100's shared memory, and the wrappers refuse what the kernels do
not take before any build or launch. The fused matcher's distances come
from the tensor cores' AND-popcount, d = popc(a) + popc(b) - 2 popc(a & b);
that identity, in torch on int32 words with the sign bit set, is held to the
JAX package's ``hamming_matrix_ref`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svin_tpu.ops import hamming as jham
from svin_tpu_torch.ops import hamming as tham
from svin_tpu_torch.ops import solve as tsolve

CLUSTER_DS = range(321, tsolve.KERNEL_MAX_D + 1)  # past one block's shared memory


def _tiles(plan):
    """(CTA, tile index) of every tile (r, j <= r) of the padded triangle."""
    return [(plan.owner[r], plan.base[r] + j) for r in range(plan.nt) for j in range(r + 1)]


def test_cluster_plan_fits_every_cta():
    for D in CLUSTER_DS:
        plan = tsolve.cluster_plan(D)
        assert plan.smem_bytes + tsolve.STATIC_SMEM_RESERVE <= tsolve.SMEM_PER_CTA, D
        rows = [sum(1 for r in range(plan.nt) if plan.owner[r] == c) for c in range(plan.cluster)]
        tiles = [sum(r + 1 for r in range(plan.nt) if plan.owner[r] == c) for c in range(plan.cluster)]
        assert max(rows) == plan.nslots and max(tiles) == plan.ntiles, D
        assert plan.ring % 2 == 0 and tsolve.MIN_RING <= plan.ring <= tsolve.MAX_RING, D
        assert plan.smem_bytes == (plan.ntiles + plan.ring) * tsolve.TILE_BYTES + tsolve.FIXED_SMEM + \
            plan.nslots * tsolve.TILE * 4, D


def test_cluster_plan_covers_the_triangle_once():
    for D in CLUSTER_DS:
        plan = tsolve.cluster_plan(D)
        assert plan.nt == -(-D // 32)
        homes = _tiles(plan)
        assert len(set(homes)) == len(homes) == plan.nt * (plan.nt + 1) // 2, D
        assert all(0 <= c < plan.cluster and 0 <= t < plan.ntiles for c, t in homes), D
        for c in range(plan.cluster):  # a CTA's row slots are 0, 1, ... in row order
            mine = [r for r in range(plan.nt) if plan.owner[r] == c]
            assert [plan.slot[r] for r in mine] == list(range(len(mine))), (D, c)


def test_cluster_plan_takes_16_ctas_only_where_8_cannot_hold_the_triangle():
    budget = tsolve.SMEM_PER_CTA - tsolve.STATIC_SMEM_RESERVE
    sizes = set()
    for D in CLUSTER_DS:
        plan = tsolve.cluster_plan(D)
        sizes.add(plan.cluster)
        if plan.cluster == 16:
            # the least any split over 8 CTAs could need: an even share of the
            # tiles and of the row slots, and the smallest ring
            nt = plan.nt
            least = (-(-nt * (nt + 1) // 2 // 8) + tsolve.MIN_RING) * tsolve.TILE_BYTES + \
                tsolve.FIXED_SMEM + -(-nt // 8) * tsolve.TILE * 4
            assert least > budget, D
        else:
            assert plan.cluster == 8, D
    assert sizes == {8, 16}
    assert tsolve.cluster_plan(1024).ntiles == 33  # the pairs (r, 31 - r)
    assert [tsolve.cluster_plan(1024).owner[r] for r in (0, 31)] == [0, 0]


@pytest.mark.parametrize("D", [0, 1025, 2048])
def test_cluster_plan_refuses_sizes_past_the_kernel(D):
    with pytest.raises(ValueError, match="cluster_plan"):
        tsolve.cluster_plan(D)


def test_cluster_plan_ints_match_the_kernel_layout():
    plan = tsolve.cluster_plan(330)
    ints = plan.as_ints()
    nt, mx = plan.nt, tsolve.MAX_NT
    assert len(ints) == 4 + 3 * mx
    assert ints[:4] == [plan.cluster, plan.ntiles, plan.ring, plan.smem_bytes]
    assert ints[4:4 + nt] == list(plan.owner) and ints[4 + mx:4 + mx + nt] == list(plan.slot)
    assert ints[4 + 2 * mx:4 + 2 * mx + nt] == list(plan.base)


def test_match_plan_covers_every_column_once():
    W, cluster = 8, tham.MATCH_CLUSTER
    for Nb in range(1, tham.MATCH_MAX_NB + 1):
        plan = tham.match_plan(400, Nb, W)
        c = plan.cols_per_cta
        assert 1 <= c <= tham.MATCH_MAX_COLS_PER_CTA and cluster * c >= Nb, Nb
        # CTA q owns [q c, (q + 1) c): disjoint blocks whose union is [0, Nb)
        lo = [min(Nb, q * c) for q in range(cluster)]
        hi = [min(Nb, (q + 1) * c) for q in range(cluster)]
        assert lo[0] == 0 and hi[-1] == Nb and all(hi[q] == lo[q + 1] for q in range(cluster - 1))
    for Nb in (1, 7, 12, 400, 500, 512, 700, 4097, tham.MATCH_MAX_NB):  # column by column
        c = tham.match_plan(400, Nb, W).cols_per_cta
        owner = np.arange(Nb) // c
        local = np.arange(Nb) - owner * c
        assert owner.max() < tham.MATCH_CLUSTER and local.max() < tham.MATCH_MAX_COLS_PER_CTA
        assert len(set(zip(owner.tolist(), local.tolist()))) == Nb


@pytest.mark.parametrize("Na", [1, 8, 9, 37, 400, 512, 1100])
def test_match_plan_splits_the_rows_once(Na):
    plan = tham.match_plan(Na, 500, 8)
    r = plan.rows_per_cta
    spans = [(min(Na, q * r), min(Na, (q + 1) * r)) for q in range(tham.MATCH_CLUSTER)]
    assert spans[0][0] == 0 and spans[-1][1] == Na
    assert all(spans[q][1] == spans[q + 1][0] for q in range(tham.MATCH_CLUSTER - 1))


@pytest.mark.parametrize("na,nb,words", [(40, 50, 8), (129, 7, 8), (33, 65, 5), (1, 1, 1)])
def test_and_popcount_identity_matches_jax(na, nb, words):
    rng = np.random.default_rng(na + nb + words)
    a = rng.integers(0, 2**32, size=(na, words), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=(nb, words), dtype=np.uint64).astype(np.uint32)
    a[:, 0] |= 0x80000000  # the sign bit of the int32 words the port holds
    b[0] = 0xFFFFFFFF
    ta, tb = torch.as_tensor(a.view(np.int32)), torch.as_tensor(b.view(np.int32))
    pa, pb = tham.popcount(ta).sum(-1), tham.popcount(tb).sum(-1)
    both = tham.popcount(ta[:, None, :] & tb[None, :, :]).sum(-1)
    d = pa[:, None] + pb[None, :] - 2 * both
    want = np.asarray(jham.hamming_matrix_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(d.numpy(), want)
    np.testing.assert_array_equal(tham.hamming_matrix_plain(ta, tb).numpy(), want)


def test_matcher_refusals_need_no_card():
    """Nb past the column-minimum tables' cap and W past 8 words are refused
    by the plan, before any device check, build or launch."""
    a = torch.zeros((3, 8), dtype=torch.int32)
    va = torch.ones(3, dtype=torch.bool)
    nb = tham.MATCH_MAX_NB + 1
    b = torch.zeros((nb, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"Nb={nb}"):
        tham.match_descriptors_cuda(a, b, va, torch.ones(nb, dtype=torch.bool))
    wide = torch.zeros((3, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="W=9"):
        tham.match_descriptors_cuda(wide, wide, va, va)
    with pytest.raises(ValueError, match="Na="):
        tham.match_plan(tham.MATCH_MAX_NA + 1, 10, 8)
    with pytest.raises(ValueError, match="Nb=0"):
        tham.match_plan(10, 0, 8)
    assert tham.match_plan(400, tham.MATCH_MAX_NB, 8).cols_per_cta == tham.MATCH_MAX_COLS_PER_CTA
