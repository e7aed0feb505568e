"""Banded 4-DoF pose-graph solver: the loop closer's branch past 512 nodes.

Counterpart of the JAX package's ``parallel/pg_band.py``. A SLAM pose graph
is a temporal chain: sequential edges join node i to i+1..i+wmax, and only
loop edges jump. ``band_posegraph`` (host numpy) splits the edges as the JAX
package does: banded edges (valid, not loop, 1 ≤ j−i ≤ wmax) sorted by i and
padded to a multiple of ``block``, the rest a COO set padded to a power of
two ≥ 16, and pads the nodes to a multiple of ``coarse_group`` so the coarse
groups are contiguous.

The solver keeps the JAX package's semantics (damping, Huber on the loop
edges, fixed-node masking, the two-level preconditioner over contiguous
groups), not its TPU forms. There, per-block one-hot matmuls into a dynamic
slice of the node vector (``_banded_scatter2``, the matvec's ``lax.scan``)
and tri-packed channel sums (``_band_channels``, ``_sym4``) keep gathers and
scatters off the TPU. On the GPU those forms reduce to the matrix-free PCG
of ``pcg.py`` over the same edges (both ends of all edges gathered at once,
summed back with one ``index_add_``, each edge's Jacobian the closed form of
``loopclosure.posegraph``), so ``optimize_4dof_banded`` is
``optimize_4dof_pcg`` on the banded and COO edges together, and the split
and its padding are read by nothing past it. The TPU's block windows (the
JAX ``BandMeta.S`` and ``BandedPoseGraph.lo``) are not kept. The loop
closer calls ``optimize_4dof_pcg`` on its edge tables directly.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..loopclosure.posegraph import PoseGraphEdges, PoseGraphNodes
from ..pipeline.vio import _float32_matmuls
from .dist_ba import _cost, _host
from .pcg import _free, _pg4_eval, _pg4_gn_step_pcg, optimize_4dof_pcg


class BandMeta(NamedTuple):
    B: int  # edges per block (the banded edges are padded to whole blocks)
    N: int  # nodes, padded to a multiple of coarse_group
    n_blocks: int
    Ec: int  # COO edge slots
    coarse_group: int


class BandedPoseGraph(NamedTuple):
    nodes: PoseGraphNodes
    be_i: torch.Tensor  # (Eb,) sorted ascending
    be_j: torch.Tensor  # (Eb,) i + d, d in [1, wmax]
    be_t: torch.Tensor  # (Eb,3)
    be_yaw: torch.Tensor  # (Eb,)
    be_w: torch.Tensor  # (Eb,)
    be_valid: torch.Tensor  # (Eb,)
    co: PoseGraphEdges  # loop and irregular edges (COO, Huber on is_loop)


def band_posegraph(nodes: PoseGraphNodes, edges: PoseGraphEdges, block: int = 1024,
                   wmax: int = 4, coarse_group: int = 64) -> Tuple[BandedPoseGraph, BandMeta]:
    """Split a temporally ordered pose graph into banded sequential edges and
    COO leftovers, padding nodes and edges (host numpy; the tensors land on
    the nodes' device)."""
    dev = nodes.p.device
    N0 = int(nodes.p.shape[0])
    N = -(-N0 // coarse_group) * coarse_group
    if N != N0:
        nodes = PoseGraphNodes(*(torch.cat([a, a.new_zeros((N - N0,) + a.shape[1:])])
                                 for a in nodes))
    ei, ej, ok, il = (_host(a) for a in (edges.i, edges.j, edges.valid, edges.is_loop))
    t_ij, yaw_ij, weight = (_host(a) for a in (edges.t_ij, edges.yaw_ij, edges.weight))
    d = ej - ei
    banded = ok & ~il & (d >= 1) & (d <= wmax)
    rows = np.nonzero(banded)[0]
    rows = rows[np.argsort(ei[rows], kind="stable")]
    n = len(rows)
    Eb = -(-max(n, 1) // block) * block

    def padded(a, rows, size, fill=0):
        out = np.full((size,) + a.shape[1:], fill, a.dtype)
        out[: len(rows)] = a[rows]
        return torch.from_numpy(out).to(dev)

    # padded edges run 0 -> 1 with weight 0, invalid
    be = [padded(ei.astype(np.int64), rows, Eb), padded(ej.astype(np.int64), rows, Eb, 1),
          padded(t_ij, rows, Eb), padded(yaw_ij, rows, Eb), padded(weight, rows, Eb, 0),
          padded(np.ones_like(ok), rows, Eb, False)]
    co_rows = np.nonzero(ok & ~banded)[0]
    # a power of two ≥ 16, so an occasional extra loop edge keeps the shape
    Ec = max(16, 1 << (max(len(co_rows), 1) - 1).bit_length())
    co = PoseGraphEdges(
        i=padded(ei.astype(np.int64), co_rows, Ec), j=padded(ej.astype(np.int64), co_rows, Ec, 1),
        t_ij=padded(t_ij, co_rows, Ec), yaw_ij=padded(yaw_ij, co_rows, Ec),
        weight=padded(weight, co_rows, Ec), is_loop=padded(il, co_rows, Ec, False),
        valid=padded(np.ones_like(ok), co_rows, Ec, False))
    prob = BandedPoseGraph(nodes, *be, co=co)
    return prob, BandMeta(B=block, N=N, n_blocks=Eb // block, Ec=Ec, coarse_group=coarse_group)


def _edges(prob: BandedPoseGraph) -> PoseGraphEdges:
    """The banded and the COO edges as one edge set."""
    cat = lambda a, b: torch.cat([a, b])  # noqa: E731
    return PoseGraphEdges(i=cat(prob.be_i, prob.co.i.long()), j=cat(prob.be_j, prob.co.j.long()),
                          t_ij=cat(prob.be_t, prob.co.t_ij), yaw_ij=cat(prob.be_yaw, prob.co.yaw_ij),
                          weight=cat(prob.be_w, prob.co.weight),
                          is_loop=cat(torch.zeros_like(prob.be_valid), prob.co.is_loop),
                          valid=cat(prob.be_valid, prob.co.valid))


def _gn_step_banded(prob: BandedPoseGraph, meta: BandMeta, fix_before, cg_iters: int):
    """One GN step over the banded and the COO edges together: the update
    (N, 4) and the cost before it."""
    return _pg4_gn_step_pcg(prob.nodes, _edges(prob), fix_before, meta.N, cg_iters,
                            meta.coarse_group)


@_float32_matmuls()
def optimize_4dof_banded(prob: BandedPoseGraph, meta: BandMeta, fix_before, iters: int = 10,
                         cg_iters: int = 64) -> Tuple[PoseGraphNodes, torch.Tensor]:
    """Banded-layout 4-DoF pose-graph GN + PCG: (nodes, the cost at them);
    padded nodes stay untouched. ``optimize_4dof_pcg`` over the banded and
    COO edges with the coarse groups of ``meta``."""
    edges = _edges(prob)
    nd = optimize_4dof_pcg(prob.nodes, edges, fix_before, iters, cg_iters, meta.coarse_group)
    r, _, _ = _pg4_eval(nd, edges, _free(nd.valid, fix_before))
    return nd, _cost(r)
