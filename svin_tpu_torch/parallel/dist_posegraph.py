"""Sharded 4-DoF pose-graph optimization: edges cut over the process mesh.

Counterpart of the JAX package's ``parallel/dist_posegraph.py``. The edge
set is cut into one block per rank of a ``runtime.ProcessMesh``; each rank
evaluates its edges' residuals and Jacobians (the analytic 4-DoF Jacobian
and Huber weight of ``loopclosure.posegraph``, where the JAX package takes
``jacfwd``) and builds a partial dense (N, N, 4, 4) system; one sum over
the mesh per GN step (``ProcessMesh.psum``: the blocks, then b) merges them
and every rank solves the same replicated (4N)² system with
``torch.linalg.solve_ex`` (the JAX package's ``jnp.linalg.solve``). Nodes
are replicated: a pose graph's state is small next to its edges.

The dense solve bounds this variant to N ≲ 2,000 nodes; past that,
``pcg.make_sharded_posegraph_pcg`` shards the same way with nothing
quadratic in N.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..loopclosure.posegraph import (
    PoseGraphEdges,
    PoseGraphNodes,
    _edge_jacobian_4dof,
    _huber_sqrt_weight,
)
from ..pipeline.vio import _float32_matmuls
from .dist_ba import _check_divides, _cost
from .runtime import ProcessMesh, shard


def _edge_eval(nd: PoseGraphNodes, edges: PoseGraphEdges):
    """Whitened residuals (E, 4) and Jacobians (E, 4, 8) over [p_i, yaw_i,
    p_j, yaw_j]: weight times Huber on loop edges, zero where invalid."""
    r, J = _edge_jacobian_4dof(nd, edges.i.long(), edges.j.long(), edges.t_ij, edges.yaw_ij)
    wt = torch.where(edges.valid, edges.weight * _huber_sqrt_weight(r, edges.is_loop),
                     torch.zeros_like(edges.weight))
    return wt[:, None] * r, wt[:, None, None] * J


def _partial_normal_eqs(nd: PoseGraphNodes, edges: PoseGraphEdges):
    """This block of edges' dense normal equations: Hb (N, N, 4, 4), b (N, 4)
    and the cost."""
    N = nd.p.shape[0]
    r, J = _edge_eval(nd, edges)
    Ji, Jj = J[..., :4], J[..., 4:]
    ei, ej = edges.i.long(), edges.j.long()
    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    Hij = JiT @ Jj
    Hb = torch.zeros(N * N, 4, 4, dtype=r.dtype, device=r.device).index_add_(
        0, torch.cat([ei * N + ei, ej * N + ej, ei * N + ej, ej * N + ei]),
        torch.cat([JiT @ Ji, JjT @ Jj, Hij, Hij.transpose(-1, -2)])).view(N, N, 4, 4)
    b = torch.zeros(N, 4, dtype=r.dtype, device=r.device).index_add_(
        0, torch.cat([ei, ej]), (torch.cat([JiT, JjT]) @ torch.cat([r, r])[..., None])[..., 0])
    return Hb, b, _cost(r)


def make_sharded_posegraph(mesh: ProcessMesh, N: int, E: int, iters: int = 10):
    """The sharded dense 4-DoF pose-graph step on ``mesh``: ``(step,
    shard)``. ``shard(edges)`` cuts this rank's block of an edge table
    padded to a multiple of the mesh (``pad_edges_for_mesh``);
    ``step(nodes, local_edges, fix_before)`` runs ``iters`` GN steps (nodes
    below ``fix_before`` and invalid nodes fixed) and gives (the nodes, the
    cost of the final nodes summed over the mesh)."""
    _check_divides("make_sharded_posegraph", mesh.size, E=E)

    @_float32_matmuls()
    def step(nodes: PoseGraphNodes, edges: PoseGraphEdges,
             fix_before) -> Tuple[PoseGraphNodes, torch.Tensor]:
        nd = nodes
        dtype = nd.p.dtype
        free4 = (nd.valid & (torch.arange(N, device=nd.p.device) >= fix_before)
                 ).repeat_interleave(4).to(dtype)
        for _ in range(iters):
            Hb, b, _ = _partial_normal_eqs(nd, edges)
            Hb, b = mesh.psum(Hb), mesh.psum(b)
            H = Hb.permute(0, 2, 1, 3).reshape(4 * N, 4 * N)
            dH = torch.diagonal(H)
            H = H * free4[:, None] * free4[None, :]
            H = H + torch.diag(1e-6 * torch.clamp(dH, min=1.0) + (1.0 - free4))
            dx = -torch.linalg.solve_ex(H, b.reshape(4 * N) * free4)[0].view(N, 4)
            nd = nd._replace(p=nd.p + dx[:, :3], yaw=nd.yaw + dx[:, 3])
        return nd, mesh.psum(_cost(_edge_eval(nd, edges)[0]))

    return step, lambda edges: shard(mesh, edges)


def pad_edges_for_mesh(edges: PoseGraphEdges, n_dev: int) -> PoseGraphEdges:
    """The edge table padded with invalid edges (0 → 0, weight 1) to a
    multiple of ``n_dev`` rows."""
    pad = (-edges.i.shape[0]) % n_dev
    if pad == 0:
        return edges

    def padf(x, fill=0):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype,
                                        device=x.device)])

    return PoseGraphEdges(
        i=padf(edges.i), j=padf(edges.j), t_ij=padf(edges.t_ij), yaw_ij=padf(edges.yaw_ij),
        weight=padf(edges.weight, 1), is_loop=padf(edges.is_loop, False),
        valid=padf(edges.valid, False))
