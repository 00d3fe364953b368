"""Keyframe pose graph: drift correction for long sequences (port of
graph/pose_graph.py).

The reference is a pure EKF whose only answer to divergence is a full map
reset (resetEKFMap, MapManagement.cpp:263-275), so long-run drift is
unbounded.  This layer snapshots the camera pose every few frames as a
keyframe, links consecutive keyframes by relative-pose edges measured by
the filter, adds loop-closure edges when a place is recognised
(graph/loop_closure.py), and redistributes the accumulated drift by
Gauss-Newton over the graph.

Capacities are fixed, with active masks: adding a node or an edge is a
masked write on the device, never a reshape and never a read back.  All
edges' residuals and Jacobians are one ``torch.func.vmap`` of
``torch.func.jacfwd``; the normal system is assembled by index-adds into
a dense (6K, 6K) matrix and solved by ``torch.linalg.solve_ex`` (the LU
solve without its error check, which would read back to the host; a
singular system gives non-finite steps, which the fallback drops).

Parametrisation: nodes are (r in R^3, q in R^4) world poses; the residual
of edge (i -> j) with measurement (dr, dq) is the 6-vector
[R(q_i)^T (r_j - r_i) - dr ; 2 vec(dq^-1 (q_i^-1 q_j))], the standard
right-multiplicative local error.  Updates are local perturbations
(delta_r in the world frame, delta_theta a small rotation on the right).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from openekfmonoslam_tpu_torch.core import quaternion as quat


class PoseGraph(NamedTuple):
    node_r: torch.Tensor       # (K, 3) world positions
    node_q: torch.Tensor       # (K, 4) world orientations (w, x, y, z)
    node_active: torch.Tensor  # (K,) bool
    n_nodes: torch.Tensor      # () int32
    edge_ij: torch.Tensor      # (E, 2) int32 node indices (i -> j)
    edge_dr: torch.Tensor      # (E, 3) measured relative translation (in i)
    edge_dq: torch.Tensor      # (E, 4) measured relative rotation
    edge_info: torch.Tensor    # (E, 6, 6) information matrix
    edge_active: torch.Tensor  # (E,) bool
    n_edges: torch.Tensor      # () int32

    @property
    def capacity(self) -> tuple[int, int]:
        return self.node_r.shape[0], self.edge_ij.shape[0]


def make_pose_graph(max_nodes: int = 256, max_edges: int = 512,
                    dtype=torch.float32, device=None) -> PoseGraph:
    """An empty graph; float32 by default, as in the JAX package (also when
    the filter runs in float64)."""
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    return PoseGraph(
        node_r=torch.zeros((max_nodes, 3), dtype=dtype, device=device),
        node_q=ident.repeat(max_nodes, 1),
        node_active=torch.zeros((max_nodes,), dtype=torch.bool,
                                device=device),
        n_nodes=torch.zeros((), dtype=torch.int32, device=device),
        edge_ij=torch.zeros((max_edges, 2), dtype=torch.int32, device=device),
        edge_dr=torch.zeros((max_edges, 3), dtype=dtype, device=device),
        edge_dq=ident.repeat(max_edges, 1),
        edge_info=torch.zeros((max_edges, 6, 6), dtype=dtype, device=device),
        edge_active=torch.zeros((max_edges,), dtype=torch.bool,
                                device=device),
        n_edges=torch.zeros((), dtype=torch.int32, device=device),
    )


def relative_pose(r_i, q_i, r_j, q_j):
    """Relative pose of j in i's frame: (dr, dq)."""
    Ri_t = quat.to_rotation_matrix(quat.conjugate(q_i))
    dr = (Ri_t @ (r_j - r_i)[..., None])[..., 0]
    dq = quat.multiply(quat.conjugate(q_i), q_j)
    return dr, dq


def _row(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (a 0-dim tensor) of ``t``, without a host read."""
    return torch.index_select(t, 0, idx.reshape(1).to(torch.long))[0]


def _put(t: torch.Tensor, idx: torch.Tensor, value: torch.Tensor,
         enable: torch.Tensor) -> torch.Tensor:
    """``t`` with row ``idx`` set to ``value`` where ``enable``: a masked
    write on the device."""
    iota = torch.arange(t.shape[0], device=t.device)
    sel = (iota == idx) & enable
    return torch.where(sel.reshape((-1,) + (1,) * (t.dim() - 1)),
                       value.to(t.dtype), t)


def add_keyframe(graph: PoseGraph, r: torch.Tensor, q: torch.Tensor,
                 info: torch.Tensor | None = None) -> PoseGraph:
    """Append a keyframe and link it to the previous one by an odometry
    edge whose measurement is the current filter-relative pose.

    ``info`` is the (6, 6) information of the relative measurement
    (identity when omitted).  A masked no-op when the graph is full."""
    kmax, _ = graph.capacity
    dtype, dev = graph.node_r.dtype, graph.node_r.device
    r = torch.as_tensor(r, device=dev).to(dtype)
    q = torch.as_tensor(q, device=dev).to(dtype)
    k = graph.n_nodes
    can_add = k < kmax
    idx = torch.clamp(k, 0, kmax - 1)
    g = graph._replace(
        node_r=_put(graph.node_r, idx, r, can_add),
        node_q=_put(graph.node_q, idx, q, can_add),
        node_active=_put(graph.node_active, idx, can_add, can_add),
        n_nodes=k + can_add.to(torch.int32),
    )
    # odometry edge from the previous keyframe
    pidx = torch.clamp(k - 1, 0, kmax - 1)
    dr, dq = relative_pose(_row(g.node_r, pidx), _row(g.node_q, pidx), r, q)
    inf = (torch.eye(6, dtype=dtype, device=dev) if info is None
           else torch.as_tensor(info, device=dev).to(dtype))
    return _append_edge(g, pidx, idx, dr, dq, inf, enable=can_add & (k > 0))


def add_loop_edge(graph: PoseGraph, i, j, dr, dq,
                  info: torch.Tensor | None = None) -> PoseGraph:
    """Add a loop-closure edge i -> j with a measured relative pose.

    Closure information may be orders of magnitude stiffer than the
    odometry edges (PnP information under unit pixel noise reaches about
    1e7 against the velocity walk's 1e3-1e4); ``optimize``'s scale-aware
    damping handles that span.  Do not rescale closures below the odometry
    stiffness, or the graph stops moving (a trace cap at 1e3 x identity
    cut a 92% endpoint correction to 10% in the JAX package's runs)."""
    dtype, dev = graph.node_r.dtype, graph.node_r.device
    inf = (torch.eye(6, dtype=dtype, device=dev) if info is None
           else torch.as_tensor(info, device=dev).to(dtype))
    i = torch.full((), int(i), dtype=torch.int32, device=dev)
    j = torch.full((), int(j), dtype=torch.int32, device=dev)
    return _append_edge(graph, i, j,
                        torch.as_tensor(dr, device=dev).to(dtype),
                        torch.as_tensor(dq, device=dev).to(dtype), inf,
                        enable=torch.ones((), dtype=torch.bool, device=dev))


def _append_edge(graph: PoseGraph, i, j, dr, dq, info, enable) -> PoseGraph:
    _, emax = graph.capacity
    e = graph.n_edges
    ok = enable & (e < emax)
    eidx = torch.clamp(e, 0, emax - 1)
    ij = torch.stack([i.to(torch.int32), j.to(torch.int32)])
    return graph._replace(
        edge_ij=_put(graph.edge_ij, eidx, ij, ok),
        edge_dr=_put(graph.edge_dr, eidx, dr, ok),
        edge_dq=_put(graph.edge_dq, eidx, dq, ok),
        edge_info=_put(graph.edge_info, eidx, info, ok),
        edge_active=_put(graph.edge_active, eidx, ok, ok),
        n_edges=e + ok.to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Gauss-Newton optimization
# ---------------------------------------------------------------------------


def _edge_residual(r_i, q_i, r_j, q_j, dr, dq):
    """6-vector residual of one edge (translation in i's frame; rotation as
    twice the vector part of the error quaternion)."""
    pr, pq = relative_pose(r_i, q_i, r_j, q_j)
    err_q = quat.multiply(quat.conjugate(dq), pq)
    # keep the scalar part positive so the small-angle map is continuous
    err_q = err_q * torch.sign(err_q[..., 0:1] + 1e-30)
    return torch.cat([pr - dr, 2.0 * err_q[..., 1:4]], dim=-1)


def _apply_delta(node_r, node_q, delta):
    """Apply per-node local perturbations [dr_world, dtheta_right]."""
    dq = torch.cat([torch.ones_like(delta[:, 0:1]), 0.5 * delta[:, 3:6]],
                   dim=1)
    q_new = quat.multiply(node_q, dq)
    q_new = q_new / torch.linalg.vector_norm(q_new, dim=1, keepdim=True)
    return node_r + delta[:, 0:3], q_new


def _residual_of(delta12, r_i, q_i, r_j, q_j, dr, dq):
    ri2, qi2 = _apply_delta(r_i[None], q_i[None], delta12[None, 0:6])
    rj2, qj2 = _apply_delta(r_j[None], q_j[None], delta12[None, 6:12])
    return _edge_residual(ri2[0], qi2[0], rj2[0], qj2[0], dr, dq)


_edge_jacobians = vmap(jacfwd(_residual_of))


def _add_blocks(H: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                blocks: torch.Tensor) -> torch.Tensor:
    """H (K, K, 6, 6) plus each block at (row, col), summed in edge order
    (a sequential sum on the CPU, atomics on the card)."""
    kmax = H.shape[0]
    flat = H.reshape(kmax * kmax, 36)
    flat = flat.index_add(0, row * kmax + col, blocks.reshape(-1, 36))
    return flat.reshape(kmax, kmax, 6, 6)


def _gn_step(graph: PoseGraph, node_r, node_q, damping: float):
    kmax, emax = graph.capacity
    dtype, dev = node_r.dtype, node_r.device
    n6 = 6 * kmax
    ij = graph.edge_ij.to(torch.long)
    w_edge = graph.edge_active.to(dtype)
    r_i, q_i = node_r[ij[:, 0]], node_q[ij[:, 0]]
    r_j, q_j = node_r[ij[:, 1]], node_q[ij[:, 1]]

    zero12 = torch.zeros((emax, 12), dtype=dtype, device=dev)
    res = vmap(_residual_of)(zero12, r_i, q_i, r_j, q_j, graph.edge_dr,
                             graph.edge_dq)
    J = _edge_jacobians(zero12, r_i, q_i, r_j, q_j, graph.edge_dr,
                        graph.edge_dq)
    res = res * w_edge[:, None]
    J = J * w_edge[:, None, None]                       # (E, 6, 12)

    Ji, Jj = J[:, :, 0:6], J[:, :, 6:12]
    info = graph.edge_info
    JiT_W = torch.einsum("eri,erc->eic", Ji, info)      # (E, 6, 6)
    JjT_W = torch.einsum("eri,erc->eic", Jj, info)
    bi = torch.einsum("eic,ec->ei", JiT_W, res)
    bj = torch.einsum("eic,ec->ei", JjT_W, res)

    H = torch.zeros((kmax, kmax, 6, 6), dtype=dtype, device=dev)
    H = _add_blocks(H, ij[:, 0], ij[:, 0], JiT_W @ Ji)
    H = _add_blocks(H, ij[:, 0], ij[:, 1], JiT_W @ Jj)
    H = _add_blocks(H, ij[:, 1], ij[:, 0], JjT_W @ Ji)
    H = _add_blocks(H, ij[:, 1], ij[:, 1], JjT_W @ Jj)
    b = torch.zeros((kmax, 6), dtype=dtype, device=dev)
    b = b.index_add(0, ij[:, 0], bi).index_add(0, ij[:, 1], bj)

    Hd = H.permute(0, 2, 1, 3).reshape(n6, n6)
    bd = b.reshape(n6)

    # gauge: node 0 fixed; inactive nodes regularised so Hd stays SPD
    node_free = graph.node_active & (torch.arange(kmax, device=dev) != 0)
    free = torch.repeat_interleave(node_free, 6).to(dtype)
    Hd = Hd * free[:, None] * free[None, :]
    # SCALE-AWARE damping: PnP information matrices carry entries of
    # 1e6-1e8, so an absolute 1e-6 ridge is about 1e-13 relative, and a
    # nearly unconstrained direction (a sparse closure set) drives the
    # float32 solve to NaN (seen on a 3-closure graph in the JAX package's
    # runs).  The ridge is relative to the mean active diagonal, LM style,
    # which also keeps the step invariant to a global information scale.
    diag = torch.diagonal(Hd)
    scale = torch.sum(diag * free) / torch.clamp(torch.sum(free), min=1.0)
    lam = damping * torch.clamp(scale, min=1.0)
    Hd = Hd + torch.diag(torch.where(free > 0, lam, torch.ones_like(free)))
    delta = -torch.linalg.solve_ex(Hd, bd * free)[0].reshape(kmax, 6)
    delta = delta * free.reshape(kmax, 6)
    # a diverged solve must not poison the trajectory: no update for
    # non-finite steps
    delta = torch.where(torch.isfinite(delta), delta,
                        torch.zeros_like(delta))

    # TRUST-REGION step clamp: with stiff loop-closure edges (PnP
    # information about 1e7) against soft odometry and real rotations, a
    # full Gauss-Newton step overshoots the linearisation and the
    # iteration diverges (300x the raw error on a 3-closure out-and-back
    # graph in the JAX package's runs).  Each node's step is clamped to
    # 0.3 rad and a quarter of the graph's span, a damped descent that
    # converges in the extra iterations.
    span = torch.amax(torch.linalg.vector_norm(node_r - node_r[0:1], dim=-1)
                      * graph.node_active)
    t_cap = torch.clamp(0.25 * span, min=1e-3)
    tn = torch.linalg.vector_norm(delta[:, 0:3], dim=-1)
    rn = torch.linalg.vector_norm(delta[:, 3:6], dim=-1)
    s = torch.minimum(torch.clamp(t_cap / torch.clamp(tn, min=1e-12),
                                  max=1.0),
                      0.3 / torch.clamp(rn, min=1e-12))
    return _apply_delta(node_r, node_q, delta * s[:, None])


def optimize(graph: PoseGraph, iterations: int = 40,
             damping: float = 1e-6) -> PoseGraph:
    """Batched Gauss-Newton over all active nodes and edges, node 0
    gauged; ``iterations`` steps on the device with no read back."""
    node_r, node_q = graph.node_r, graph.node_q
    for _ in range(iterations):
        node_r, node_q = _gn_step(graph, node_r, node_q, damping)
    return graph._replace(node_r=node_r, node_q=node_q)


def total_error(graph: PoseGraph) -> torch.Tensor:
    """Sum of information-weighted squared edge residuals (diagnostic)."""
    ij = graph.edge_ij.to(torch.long)
    res = _edge_residual(graph.node_r[ij[:, 0]], graph.node_q[ij[:, 0]],
                         graph.node_r[ij[:, 1]], graph.node_q[ij[:, 1]],
                         graph.edge_dr, graph.edge_dq)
    errs = torch.einsum("ea,eab,eb->e", res, graph.edge_info, res)
    return torch.sum(errs * graph.edge_active)
