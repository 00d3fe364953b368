"""The frame step with the covariance P split over torch.distributed ranks
(port of parallel/sharding.py).

The scaling dimension of EKF-SLAM is the map: P is (13 + 6 F)^2 and every
hot step is a P-sized product.  The JAX package annotates P as sharded
and lets GSPMD partition every op.  PyTorch has no such partitioner, so
here the step is written out in SPMD form:

  * The mesh is (p, q).  Rank (i, j) holds a tile of the padded P: rows
    [i N/p, (i+1) N/p) by columns [j N/q, (j+1) N/q).  Row strips
    (``make_sharded_step``, the JAX package's 1-D layout) are the case
    q = 1 with no q axis; ``make_sharded_step_2d`` tiles over (p, q).  The
    same tile functions run both.
  * x, the slot metadata and the front end are replicated: every rank
    computes them from the same inputs, as GSPMD does, and the hand-
    written kernels whose operands are replicated keep running (measure,
    the S-inverse, STAR, BRIEF and the add path's init (A)).
  * Ranks exchange data only through summing ``all_reduce``s over one mesh
    axis (parallel/comm.py), most of them masked: each rank writes the
    entries it owns into zeros, so the sum places them exactly.

The P-touching pieces of ``SlamRuntime`` and their form on a tile
(``ShardedRuntime`` overrides each; every phase keeps its ``step.<phase>``
profiler range):

  1. predict: mesh row 0 applies F to the camera rows, mesh column 0 F^T
     to the camera columns, the corner adds Q; no communication.
  2. H P and S: P is symmetric, so (H P)^T on the tile's rows is
     P[rows, cols] H^T[cols], from the camera and per-slot columns
     (``blocks``) or a dense H (``dense``); it is summed over q and placed
     over p, which gives every rank the (2F, N) H P; S = H P H^T is then
     replicated.
  3. update: K^T = S^-1 (H P) and dx are replicated; each tile subtracts
     the symmetrised increment 0.5 (K^T[:, r]^T HP[:, c] + HP[:, r]^T
     K^T[:, c]) in place of symmetrising P (which needs a transposed
     tile); the quaternion rows and columns live in mesh row and column 0.
  4. map management: removal zeroes the tile's rows and columns; the
     conversion's linearity index reads P's diagonal (gathered, N values),
     and the converted slot's 6 rows and 6 columns, which may straddle a
     tile edge, are gathered, transformed and placed in each tile.
  5. addition: the pose strip P[:7, :] is gathered (7 x N); the chain (A)
     runs on the replicated camera block; each tile places the new rows
     and columns that fall in it (``init_kernel.augment_rows``).
  6. records: P[:13, :13] is gathered from tile (0, 0).

No collective of the step carries N x N elements: the largest is H P's
(N, 2F), twice a frame.  ``gather_state`` is the one full-P transfer, for
tests and checkpoints.

The JAX package turns every Pallas kernel off when sharded
(``_sharded_runtime``); here only the kernels that need the whole P are
off: predict and the fused update (the tile forms replace them) and the
add path's (B) (the tile placement replaces it).  The dense H P layout is
taken, as in JAX, when the map has 13 + 6F >= 1024 dims.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.engine.step import (SlamRuntime,
                                                   resolve_device)
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter import mapman
from openekfmonoslam_tpu_torch.filter import measure as meas_mod
from openekfmonoslam_tpu_torch.filter import predict as pred_mod
from openekfmonoslam_tpu_torch.filter import shardable
from openekfmonoslam_tpu_torch.filter import update as upd_mod
from openekfmonoslam_tpu_torch.filter.state import (CAM_DIM, FEAT_DIM,
                                                    SlamState, select_state)
from openekfmonoslam_tpu_torch.ops import init_kernel, predict_kernel
from openekfmonoslam_tpu_torch.parallel.comm import Comm

# the JAX package's crossover (parallel/sharding.py:80-81): maps of
# 13 + 6F dims or more take the dense H P layout when sharded
DENSE_FROM_DIMS = 1024


# ---------------------------------------------------------------- layout

@dataclasses.dataclass(frozen=True)
class Tiling:
    """This rank's tile of the padded (n, n) P on a (p, q) mesh, and the
    counted collectives over the mesh's axes (``q_axis`` None: row strips,
    q = 1)."""

    n: int
    p: int
    q: int
    i: int
    j: int
    comm: Comm
    p_axis: str
    q_axis: str | None = None

    @property
    def nr(self) -> int:
        return self.n // self.p

    @property
    def nc(self) -> int:
        return self.n // self.q

    @property
    def rows(self) -> slice:
        return slice(self.i * self.nr, (self.i + 1) * self.nr)

    @property
    def cols(self) -> slice:
        return slice(self.j * self.nc, (self.j + 1) * self.nc)

    def sum_q(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """``t`` summed over this rank's mesh row (itself when q = 1)."""
        if self.q_axis is None:
            return t
        return self.comm.all_reduce(t, self.q_axis, site)

    def sum_p(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """``t`` summed over this rank's mesh column."""
        return self.comm.all_reduce(t, self.p_axis, site)

    def full_rows(self, part: torch.Tensor, site: str) -> torch.Tensor:
        """(N, ...) on every rank of the mesh column from each rank's rows
        (nr, ...) of it: placed in zeros and summed over p."""
        out = part.new_zeros((self.n,) + tuple(part.shape[1:]))
        out[self.rows] = part
        return self.sum_p(out, site)

    def full_cols(self, part: torch.Tensor, site: str) -> torch.Tensor:
        """(k, N) on every rank of the mesh row from each rank's columns
        (k, nc) of it: placed in zeros and summed over q."""
        if self.q_axis is None:
            return part
        out = part.new_zeros((part.shape[0], self.n))
        out[:, self.cols] = part
        return self.sum_q(out, site)


def _tiling(mesh: DeviceMesh, n: int, p_axis: str,
            q_axis: str | None = None) -> Tiling:
    """The tiling of an (n, n) P over ``mesh``'s ``p_axis`` (rows) and
    ``q_axis`` (columns, if any); raises ValueError unless n divides by
    both and each tile holds all 13 camera rows and columns."""
    names = list(mesh.mesh_dim_names or ())
    for axis in (p_axis, q_axis):
        if axis is not None and axis not in names:
            raise ValueError(f"mesh {names} has no axis {axis!r}")
    p = mesh.shape[names.index(p_axis)]
    q = mesh.shape[names.index(q_axis)] if q_axis is not None else 1
    if n % p or n % q or n // p < CAM_DIM or n // q < CAM_DIM:
        raise ValueError(
            f"P of {n} dims does not tile over ({p}, {q}): N must divide by "
            f"both and N/p, N/q hold the {CAM_DIM} camera dims (pad_state_to "
            "sets N)")
    groups = {p_axis: mesh.get_group(p_axis)}
    if q_axis is not None:
        groups[q_axis] = mesh.get_group(q_axis)
    return Tiling(n=n, p=p, q=q, i=mesh.get_local_rank(p_axis),
                  j=mesh.get_local_rank(q_axis) if q_axis is not None else 0,
                  comm=Comm(groups), p_axis=p_axis, q_axis=q_axis)


def _local_index(start: torch.Tensor, k: int, lo: int, size: int
                 ) -> torch.Tensor:
    """(k,) positions of global dims start .. start+k-1 in a tile's range
    [lo, lo + size); a dim outside goes to its own spare slot past the end
    (size + its offset), which the caller drops."""
    ar = torch.arange(k, device=start.device)
    loc = start - lo + ar
    return torch.where((loc >= 0) & (loc < size), loc, size + ar)


# ------------------------------------------------------ tile functions

def tile_of(tl: Tiling, P: torch.Tensor) -> torch.Tensor:
    """This rank's tile of a whole P."""
    return P[tl.rows, tl.cols].clone()


def gather_p(tl: Tiling, P: torch.Tensor) -> torch.Tensor:
    """The whole P on every rank (the one full-P transfer)."""
    return tl.full_rows(tl.full_cols(P, "gather_state"), "gather_state")


def tile_predict(tl: Tiling, P: torch.Tensor, x: torch.Tensor, dt: float,
                 lin: float, ang: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P' tile): F on the camera rows (mesh row 0), F^T on the camera
    columns (mesh column 0), Q on the corner; no communication."""
    cam_new, F, Qc = predict_kernel.motion_terms(x, dt, lin, ang)
    if tl.i == 0:
        P = shardable.place_rows(P, F @ P[:CAM_DIM, :], 0)
    if tl.j == 0:
        P = shardable.place_cols(P, P[:, :CAM_DIM] @ F.T, 0)
        if tl.i == 0:
            P = shardable.place_block(P, P[:CAM_DIM, :CAM_DIM] + Qc, 0, 0)
    return torch.cat([cam_new, x[CAM_DIM:]]), P


def tile_hp_products(tl: Tiling, P: torch.Tensor, Hc: torch.Tensor,
                     Hf: torch.Tensor, layout: str = "blocks"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H P (2F, N), H P H^T (2F, 2F)), both replicated, from the tile."""
    F = Hc.shape[0]
    if layout == "dense":
        H = meas_mod.dense_H(Hc, Hf, tl.n)
        part = P @ H[:, tl.cols].T                           # (nr, 2F)
    elif layout == "blocks":
        end = CAM_DIM + F * FEAT_DIM
        # the tile's columns in place among all N (zeros elsewhere)
        Pw = P if tl.q == 1 else torch.nn.functional.pad(
            P, (tl.cols.start, tl.n - tl.cols.stop))
        part = (Pw[:, :CAM_DIM]
                @ Hc[:, :, :CAM_DIM].reshape(2 * F, CAM_DIM).T
                + torch.einsum("rfd,fid->rfi",
                               Pw[:, CAM_DIM:end].reshape(tl.nr, F, FEAT_DIM),
                               Hf).reshape(tl.nr, 2 * F))
    else:
        raise ValueError(f"unknown hp_layout {layout!r}")
    HP = tl.full_rows(tl.sum_q(part, "hp"), "hp").T.contiguous()
    if layout == "dense":
        return HP, HP @ H.T
    return HP, meas_mod.blocks_hpht(HP, Hc, Hf)


def tile_update(tl: Tiling, state: SlamState, pred: meas_mod.Prediction,
                z: torch.Tensor, use: torch.Tensor, pixel_error: float,
                deadband: bool = False) -> SlamState:
    """The joint update (the chain of filter/update.py) on the tile."""
    x, KT, HP = upd_mod.kalman_gain(state.x, pred.HP, pred.Sfull, pred.uv,
                                    z, use, pixel_error, deadband=deadband)
    r, c = tl.rows, tl.cols
    inc = KT[:, r].T @ HP[:, c]
    P = state.P - 0.5 * (inc + HP[:, r].T @ KT[:, c])
    applied = torch.any(use)
    q = x[3:7]
    Jq = quat.normalize_jacobian(q)
    Pn = P
    if tl.i == 0:
        Pn = shardable.place_rows(Pn, Jq @ Pn[3:7, :], 3)
    if tl.j == 0:
        Pn = shardable.place_cols(Pn, Pn[:, 3:7] @ Jq.T, 3)
    xn = torch.cat([x[:3], q / torch.linalg.vector_norm(q), x[7:]])
    return state._replace(x=torch.where(applied, xn, x),
                          P=torch.where(applied, Pn, P))


def tile_zero(tl: Tiling, P: torch.Tensor, dim_mask: torch.Tensor
              ) -> torch.Tensor:
    """``state.zero_inactive`` on the tile."""
    m = dim_mask.to(P.dtype)
    return P * m[tl.rows][:, None] * m[tl.cols][None, :]


def tile_diagonal(tl: Tiling, P: torch.Tensor) -> torch.Tensor:
    """P's diagonal (N,) on every rank."""
    dev = P.device
    g = torch.arange(tl.rows.start, tl.rows.stop, device=dev)
    inside = (g >= tl.cols.start) & (g < tl.cols.stop)
    local = torch.clamp(g - tl.cols.start, 0, tl.nc - 1)
    d = P[torch.arange(tl.nr, device=dev), local]
    d = torch.where(inside, d, torch.zeros_like(d))
    return tl.full_rows(tl.sum_q(d, "diagonal"), "diagonal")


def tile_convert_slot(tl: Tiling, state: SlamState, slot: torch.Tensor
                      ) -> SlamState:
    """``mapman._convert_slot`` on the tile: the slot's rows and columns
    gathered, transformed as there, and placed where they fall in it."""
    J, off, x_new, is_xyz = mapman.slot_conversion(state, slot)
    nr, nc, k = tl.nr, tl.nc, FEAT_DIM
    li = _local_index(off, k, tl.rows.start, nr)
    lj = _local_index(off, k, tl.cols.start, nc)
    # the tile with k spare rows and columns, where dims outside it go
    P = torch.nn.functional.pad(state.P, (0, k, 0, k))
    rows6 = tl.sum_p(tl.full_cols(torch.index_select(P, 0, li)[:, :nc],
                                  "convert"), "convert")     # (6, N)
    cols6 = tl.full_rows(tl.sum_q(torch.index_select(P, 1, lj)[:nr],
                                  "convert"), "convert")     # (N, 6)
    new_rows, new_cols, new_block = mapman.converted_strips(rows6, cols6,
                                                            J, off)
    pad = torch.nn.functional.pad
    P = P.index_copy(0, li, pad(new_rows[:, tl.cols], (0, k)))
    P = P.index_copy(1, lj, pad(new_cols[tl.rows], (0, 0, 0, k)))
    strip = torch.index_select(P, 0, li).index_copy(1, lj, new_block)
    P = P.index_copy(0, li, strip)[:nr, :nc]
    return state._replace(x=x_new, P=P, is_xyz=is_xyz)


def tile_add_covariance(tl: Tiling, camera, P: torch.Tensor,
                        cam7: torch.Tensor, cand_uv: torch.Tensor,
                        slots: torch.Tensor, ok: torch.Tensor, rho0: float,
                        r_add: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """``init_kernel.add_covariance`` on the tile: (feats, P_new tile)."""
    part = P[:7, :] if tl.i == 0 else P.new_zeros((7, tl.nc))
    p7 = tl.sum_p(tl.full_cols(part, "add"), "add")          # (7, N)
    feats, J1, J2 = init_kernel.init_chain(camera, cam7, cand_uv, rho0)
    A_ext, idx_map, wrote = init_kernel.augment_rows(p7, J1, J2, slots, ok,
                                                     r_add)
    Gr = torch.index_select(A_ext, 0, idx_map[tl.rows])[:, tl.cols]
    Gc = torch.index_select(A_ext, 0, idx_map[tl.cols])[:, tl.rows]
    Pn = torch.where(wrote[tl.rows][:, None], Gr, P)
    return feats, torch.where(wrote[tl.cols][None, :], Gc.T, Pn)


def tile_camera_block(tl: Tiling, P: torch.Tensor) -> torch.Tensor:
    """P[:13, :13] on every rank, from tile (0, 0)."""
    part = (P[:CAM_DIM, :CAM_DIM] if tl.i == 0 and tl.j == 0
            else P.new_zeros((CAM_DIM, CAM_DIM)))
    return tl.sum_p(tl.sum_q(part, "record"), "record")


# -------------------------------------------------------------- runtime

class ShardedRuntime(SlamRuntime):
    """``SlamRuntime`` whose states hold this rank's tile of P; every piece
    that touches P takes its tile form (the module docstring's list)."""

    # the step runs eagerly: its prefix holds torch.distributed
    # collectives, which a CUDA graph of the step's own stream does not
    step_graphs = False

    def __init__(self, config, tiling: Tiling, device=None):
        super().__init__(config, device)
        if config.padded_state_dim != tiling.n:
            raise ValueError(f"tiling of N = {tiling.n} for a config of "
                             f"N = {config.padded_state_dim}")
        self.tiling = tiling

    def make_initial_state(self) -> SlamState:
        state = super().make_initial_state()
        return state._replace(P=tile_of(self.tiling, state.P))

    def predict_filter(self, state: SlamState) -> SlamState:
        return pred_mod.predict(state, self.config, kernel=functools.partial(
            tile_predict, self.tiling))

    def predict_measurements(self, state: SlamState) -> meas_mod.Prediction:
        return meas_mod.predict_measurements(
            state, self.camera, quirks=self.quirks, hp_layout=self.hp_layout,
            products=functools.partial(tile_hp_products, self.tiling))

    def update_filter(self, state: SlamState, pred, z, use) -> SlamState:
        return tile_update(self.tiling, state, pred, z, use,
                           self.config.camera.pixel_error_x,
                           deadband=self.quirks)

    def remove_features(self, state: SlamState, remove) -> SlamState:
        return mapman.remove_features(
            state, remove, zero_dims=functools.partial(tile_zero, self.tiling))

    def convert_feature(self, state: SlamState, enable) -> SlamState:
        rho_var = tile_diagonal(self.tiling, state.P)[
            mapman.rho_dims(state.n_features, state.x.device)]
        do, slot = mapman.conversion_candidate(
            state, self.config.ekf.inverse_depth_linearity_index_threshold,
            order_key=state.birth if self.quirks else None, rho_var=rho_var)
        return select_state(do & enable,
                            tile_convert_slot(self.tiling, state, slot), state)

    def add_features(self, state: SlamState, uv, desc, valid) -> SlamState:
        return feat_mod.add_features(
            state, self.camera, self.config, uv, desc, valid,
            covariance=functools.partial(tile_add_covariance, self.tiling))

    def camera_covariance(self, state: SlamState) -> torch.Tensor:
        return tile_camera_block(self.tiling, state.P)

    def step_injected(self, *args, **kwargs):
        raise NotImplementedError(
            "the sharded runtime runs the live step (init_step, step)")


def _sharded_runtime(runtime: SlamRuntime, mesh: DeviceMesh, p_axis: str,
                     q_axis: str | None = None) -> ShardedRuntime:
    """``runtime`` on this rank's tile of P over ``mesh``, with the dense
    H P layout from 13 + 6F >= 1024 dims (an explicit
    ``config.hp_layout="dense"`` always stands)."""
    cfg = runtime.config
    if cfg.state_dim >= DENSE_FROM_DIMS:
        cfg = dataclasses.replace(cfg, hp_layout="dense")
    return ShardedRuntime(cfg, _tiling(mesh, cfg.padded_state_dim, p_axis,
                                       q_axis), device=runtime.device)


# ------------------------------------------------------ meshes and states

def make_mesh(device=None, axis: str = "p") -> DeviceMesh:
    """A 1-D mesh over every rank of the process group (which must be
    started: parallel/multihost.initialize); ``device`` as for
    ``SlamRuntime`` (the card unless the caller passes "cpu")."""
    return init_device_mesh(resolve_device(device).type,
                            (dist.get_world_size(),), mesh_dim_names=(axis,))


def make_mesh_2d(device=None, shape: tuple = (2, 4),
                 axes: tuple = ("p", "q")) -> DeviceMesh:
    """A (p, q) mesh over the p q ranks of the process group."""
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def placements(mesh: DeviceMesh, shards: dict) -> tuple:
    """The DTensor placements over ``mesh``'s axes: ``Shard(dim)`` on the
    axes of ``shards`` (axis -> tensor dim), ``Replicate()`` on the rest."""
    return tuple(Shard(shards[a]) if a in shards else Replicate()
                 for a in mesh.mesh_dim_names)


def state_shardings(mesh: DeviceMesh, axis: str = "p") -> SlamState:
    """A SlamState of placements: P's rows over ``axis``, the rest
    replicated.  The step's states hold the local tensors these describe,
    not DTensors."""
    rep = placements(mesh, {})
    return SlamState(*(placements(mesh, {axis: 0}) if name == "P" else rep
                       for name in SlamState._fields))


def state_shardings_2d(mesh: DeviceMesh, axes: tuple = ("p", "q")
                       ) -> SlamState:
    """P tiled (rows over ``axes[0]``, columns over ``axes[1]``), the rest
    replicated."""
    rep = placements(mesh, {})
    tiled = placements(mesh, {axes[0]: 0, axes[1]: 1})
    return SlamState(*(tiled if name == "P" else rep
                       for name in SlamState._fields))


def shard_state(state: SlamState, mesh: DeviceMesh, axis: str = "p"
                ) -> SlamState:
    """This rank's share of a whole state: its rows of P."""
    tl = _tiling(mesh, state.P.shape[0], axis)
    return state._replace(P=tile_of(tl, state.P))


def shard_state_2d(state: SlamState, mesh: DeviceMesh,
                   axes: tuple = ("p", "q")) -> SlamState:
    """This rank's share of a whole state: its tile of P."""
    tl = _tiling(mesh, state.P.shape[0], *axes)
    return state._replace(P=tile_of(tl, state.P))


def gather_state(state: SlamState, mesh: DeviceMesh, axes=("p",)
                 ) -> SlamState:
    """The whole state on every rank from each rank's share (``axes``:
    ("p",) for row strips, ("p", "q") for tiles)."""
    tl = _tiling(mesh, state.x.shape[0], *axes)
    return state._replace(P=gather_p(tl, state.P))


def make_sharded_init(runtime: SlamRuntime, mesh: DeviceMesh,
                      axis: str = "p"):
    """(local state, gray) -> local state: ``init_step`` with P's rows
    over ``axis``."""
    return _sharded_runtime(runtime, mesh, axis).init_step


def make_sharded_step(runtime: SlamRuntime, mesh: DeviceMesh,
                      axis: str = "p"):
    """(local state, gray) -> (local state, record): the frame step with
    P's rows over ``axis``; records are the same on every rank."""
    return _sharded_runtime(runtime, mesh, axis).step


def make_sharded_init_2d(runtime: SlamRuntime, mesh: DeviceMesh,
                         axes: tuple = ("p", "q")):
    """``make_sharded_init`` with P tiled over (``axes[0]``, ``axes[1]``)."""
    return _sharded_runtime(runtime, mesh, *axes).init_step


def make_sharded_step_2d(runtime: SlamRuntime, mesh: DeviceMesh,
                         axes: tuple = ("p", "q")):
    """``make_sharded_step`` with P tiled over (``axes[0]``, ``axes[1]``)."""
    return _sharded_runtime(runtime, mesh, *axes).step
