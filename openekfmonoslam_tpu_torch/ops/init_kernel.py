"""The add path's new-landmark chain and covariance augmentation as two
CUDA launches (``csrc/init.cu``).

Replaces the TPU kernel ``_init_kernel`` / ``init_chain_pallas``
(openekfmonoslam_tpu/ops/init_kernel.py:48,138) and the covariance work
that follows it in the JAX package as XLA einsums and scatters
(openekfmonoslam_tpu/filter/features.py:177-224):

  (A) ``init_chain``: per candidate pixel, the inverse-depth feature
      (undistort -> back-project -> rotate -> bearing angles) with its
      hand-derived Jacobians J1 = d(feat)/d(r, q) and J2 = d(feat)/d(u, v,
      rho), in the padded (C, 6), (C, 6, 7), (C, 6, 3) shapes, and, for the
      add path, the compact operands of (B) from P's camera block: J1's
      rows 3:5 at columns 3:7, B = J1 P77 and the candidate's own block
      B J1^T + J2 diag(r_add) J2^T.  The bearing atan2 runs inside the
      kernel (the TPU caller took it outside: Mosaic has no atan2).
  (B) ``init_augment``: P_new, out of place, in one pass over P, with each
      valid candidate's rows and columns placed at its slot's dims
      (csrc/init.cu gives the element rule and the sum order).

Bound on the H100: bytes, 2 N^2 4 B for (B); (A) is launch bound.

``add_covariance`` is the add path's wrapper: a CPU tensor runs
``add_covariance_plain`` (the JAX package's einsums and index-map
placement, with ``init_plain``), a CUDA float32 tensor launches (A) and
(B), or raises.  ``init_chain`` is the chain alone, the counterpart of the
TPU kernel: ``init_plain`` (the vmapped forward-mode Jacobian of
filter/features.py init_feature) on the CPU, (A) on the card.

B streams stacked on a leading axis take one launch of each (the stream is a
grid index; each stream's bits are its single launch's), which the
batched step (parallel/batch_runner.py) reaches under ``torch.func.vmap``
through the wrapper's custom op (ops/batched.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.ops import batched, cuda_lib

# filter/state.py: the camera's 13 dims come first, then 6 a slot
CAM_DIM, FEAT_DIM = 13, 6
# csrc/init.cu: floats of a candidate's compact operands, and the largest
# N whose dim map fits (B)'s shared memory
OPS = 88
MAX_N = 12288

LAUNCHES = cuda_lib.LaunchCounter("init")
AUGMENT_LAUNCHES = cuda_lib.LaunchCounter("init_augment")


def init_plain(camera: Camera, cam7: torch.Tensor, cand_uv: torch.Tensor,
               rho0: float):
    """(feats (C, 6), J1 (C, 6, 7), J2 (C, 6, 3)) by forward-mode
    differentiation of init_feature, vmapped over the candidates."""
    from torch.func import jacfwd, vmap

    from openekfmonoslam_tpu_torch.filter.features import init_feature

    C = cand_uv.shape[0]
    uv_rho = torch.cat([cand_uv, torch.full((C, 1), rho0, dtype=cand_uv.dtype,
                                            device=cand_uv.device)], dim=1)

    def f(c7, m):
        return init_feature(camera, c7, m)

    feats = vmap(f, in_dims=(None, 0))(cam7, uv_rho)
    J1 = vmap(jacfwd(f, argnums=0), in_dims=(None, 0))(cam7, uv_rho)
    J2 = vmap(jacfwd(f, argnums=1), in_dims=(None, 0))(cam7, uv_rho)
    return feats, J1, J2


def _chain_cuda(camera: Camera | cuda_lib.CamParams, cam7: torch.Tensor,
                cand_uv: torch.Tensor, rho0: float,
                P: torch.Tensor | None = None,
                r_add: tuple = (0.0, 0.0, 0.0)):
    """(feats, J1, J2, ops) from one launch of (A); ops (C, OPS) only with
    P given (else None).  B streams stacked (a leading B axis on every
    input and output) take the same one launch."""
    cam7 = cam7.contiguous()
    cand_uv = cand_uv.contiguous()
    tensors = {"cam7": cam7, "cand_uv": cand_uv}
    if P is not None:
        P = P.contiguous()
        tensors["P"] = P
    cuda_lib.check_cuda_inputs("init", tensors)
    lead = tuple(cam7.shape[:-1])
    C = cand_uv.shape[-2]
    N = P.shape[-1] if P is not None else 0
    if (cam7.shape != lead + (7,) or cand_uv.shape != lead + (C, 2) or C < 1
            or len(lead) > 1
            or (P is not None and (P.shape != lead + (N, N) or N < 7))):
        raise ValueError("init: bad shapes")
    f32 = dict(dtype=torch.float32, device=cand_uv.device)
    feats = torch.empty(lead + (C, 6), **f32)
    J1 = torch.empty(lead + (C, 6, 7), **f32)
    J2 = torch.empty(lead + (C, 6, 3), **f32)
    ops = torch.empty(lead + (C, OPS), **f32) if P is not None else None
    cam = (camera if isinstance(camera, cuda_lib.CamParams)
           else cuda_lib.CamParams.from_camera(camera))
    cuda_lib.library().call(
        "ekf_init_batched", cam7.data_ptr(), cand_uv.data_ptr(),
        P.data_ptr() if P is not None else None, feats.data_ptr(),
        J1.data_ptr(), J2.data_ptr(),
        ops.data_ptr() if ops is not None else None, C, N,
        lead[0] if lead else 1, float(rho0), *(float(r) for r in r_add),
        ctypes.byref(cam), cuda_lib.stream_of(cand_uv))
    LAUNCHES.hit()
    return feats, J1, J2, ops


def init_cuda(camera: Camera, cam7: torch.Tensor, cand_uv: torch.Tensor,
              rho0: float):
    """The chain's three arrays from one launch of (A)."""
    return _chain_cuda(camera, cam7, cand_uv, rho0)[:3]


def init_chain(camera: Camera, cam7: torch.Tensor, cand_uv: torch.Tensor,
               rho0: float):
    """The init chain: plain version on the CPU, the kernel on CUDA."""
    if cand_uv.device.type == "cpu":
        return init_plain(camera, cam7, cand_uv, rho0)
    return init_cuda(camera, cam7, cand_uv, rho0)


def new_dims(slots: torch.Tensor, ok: torch.Tensor, N: int) -> torch.Tensor:
    """(C, 6) state dims of each candidate's slot; N (the dropped extra
    column) for an invalid candidate."""
    dim_idx = (CAM_DIM + FEAT_DIM * slots.to(torch.long)[:, None]
               + torch.arange(FEAT_DIM, device=slots.device)[None, :])
    return torch.where(ok[:, None], dim_idx, torch.full_like(dim_idx, N))


def add_covariance_plain(camera: Camera, P: torch.Tensor, cam7: torch.Tensor,
                         cand_uv: torch.Tensor, slots: torch.Tensor,
                         ok: torch.Tensor, rho0: float, r_add: tuple):
    """(feats (C, 6), P_new (N, N)): the new features and P grown by their
    rows and columns at the dims of their slots."""
    feats, J1, J2 = init_chain(camera, cam7, cand_uv, rho0)
    return feats, augment_plain(P, J1, J2, slots, ok, r_add)


def augment_plain(P: torch.Tensor, J1: torch.Tensor, J2: torch.Tensor,
                  slots: torch.Tensor, ok: torch.Tensor, r_add: tuple
                  ) -> torch.Tensor:
    """P grown by the candidates' rows and columns from the chain's J1 and
    J2 (the JAX package's einsums, then its index-map placement): the
    plain version of (B) with the products of (A)."""
    # each new feature's J1 only reads the camera pose strip P[:7, :],
    # which no addition modifies
    A_ext, idx_map, wrote = augment_rows(P[:7, :], J1, J2, slots, ok, r_add)
    G = torch.index_select(A_ext, 0, idx_map)                # (N, N)
    Pn = torch.where(wrote[:, None], G, P)
    return torch.where(wrote[None, :], G.T, Pn)


def augment_rows(p7: torch.Tensor, J1: torch.Tensor, J2: torch.Tensor,
                 slots: torch.Tensor, ok: torch.Tensor, r_add: tuple):
    """(A_ext (6C + 1, N), idx_map (N,), wrote (N,)) from the pose strip
    ``p7`` = P[:7, :]: the candidates' new rows of P (a zero row last),
    the row of A_ext that writes each state dim (the zero row for none),
    and whether one does.  Row n of P_new is row idx_map[n] of A_ext
    where wrote[n] (its column likewise), else P's."""
    dtype, dev = p7.dtype, p7.device
    C = J1.shape[0]
    N = p7.shape[1]
    # two new features c, d cross-correlate by J1_c P77 J1_d^T
    P77 = p7[:, :7]
    rows = torch.einsum("cij,jn->cin", J1, p7)               # (C, 6, N)
    B = torch.einsum("cij,jk->cik", J1, P77)                 # (C, 6, 7)
    cross = torch.einsum("cik,djk->cidj", B, J1)             # (C, 6, C, 6)
    J2r = torch.stack([J2[..., k] * r_add[k] for k in range(3)], dim=-1)
    noise = torch.einsum("cik,cjk->cij", J2r, J2)            # (C, 6, 6)

    # each state dim looks up which candidate row writes it: the highest
    # valid candidate whose slot holds the dim (K = none).  Every placement
    # below is a gather and a select, which torch.func.vmap batches.
    K = C * FEAT_DIM
    n = torch.arange(N, device=dev)
    col_slot = torch.div(n - CAM_DIM, FEAT_DIM, rounding_mode="floor")
    col_j = n - CAM_DIM - FEAT_DIM * col_slot
    cand = torch.arange(C, device=dev)
    writes = ok[None, :] & (slots.to(torch.long)[None, :] == col_slot[:, None])
    writer = torch.amax(torch.where(writes, cand[None, :],
                                    torch.full_like(cand, -1)[None, :]),
                        dim=1)                               # (N,)
    wrote = writer >= 0
    idx_map = torch.where(wrote, FEAT_DIM * writer + col_j,
                          torch.full_like(writer, K))

    # a candidate's rows: the cross blocks at the other candidates' dims,
    # then its own diagonal block at its dims
    cross = torch.index_select(cross.reshape(C, FEAT_DIM, K), 2,
                               torch.clamp(idx_map, max=K - 1))
    rows = torch.where(wrote[None, None, :], cross, rows)
    diag = torch.einsum("cik,cjk->cij", B, J1) + noise       # (C, 6, 6)
    own = n[None, :] - (CAM_DIM + FEAT_DIM * slots.to(torch.long)[:, None])
    mine = ok[:, None] & (own >= 0) & (own < FEAT_DIM)       # (C, N)
    diag = torch.gather(diag, 2, torch.clamp(own, 0, FEAT_DIM - 1)[
        :, None, :].expand(C, FEAT_DIM, N))
    rows = torch.where(mine[:, None, :], diag, rows)

    A_ext = torch.cat([rows.reshape(K, N),
                       torch.zeros((1, N), dtype=dtype, device=dev)], dim=0)
    return A_ext, idx_map, wrote


def augment_cuda(P: torch.Tensor, ops: torch.Tensor, slots: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
    """P_new from one launch of (B): P (N, N) float32, ops (C, OPS) from
    (A), slots (C,) int32, ok (C,) bool; or B streams stacked (a leading B
    axis on each) in the same one launch."""
    P, ops, slots, ok = (t.contiguous() for t in (P, ops, slots, ok))
    cuda_lib.check_cuda_inputs("init_augment", {
        "P": P, "ops": ops, "slots": slots, "ok": ok})
    lead = tuple(P.shape[:-2])
    N, C = P.shape[-1], slots.shape[-1]
    if (P.shape != lead + (N, N) or ops.shape != lead + (C, OPS)
            or ok.shape != lead + (C,) or slots.shape != lead + (C,)
            or len(lead) > 1 or slots.dtype != torch.int32
            or ok.dtype != torch.bool or C < 1 or not CAM_DIM <= N <= MAX_N):
        raise ValueError("init_augment: bad shapes or types")
    P_new = torch.empty_like(P)
    cuda_lib.library().call(
        "ekf_init_augment_batched", P.data_ptr(), ops.data_ptr(),
        slots.data_ptr(), ok.data_ptr(), P_new.data_ptr(), N, C,
        lead[0] if lead else 1, cuda_lib.stream_of(P))
    AUGMENT_LAUNCHES.hit()
    return P_new


def add_covariance_cuda(camera: Camera, P: torch.Tensor, cam7: torch.Tensor,
                        cand_uv: torch.Tensor, slots: torch.Tensor,
                        ok: torch.Tensor, rho0: float, r_add: tuple):
    """(feats, P_new) from the two launches (A) and (B)."""
    feats, _, _, ops = _chain_cuda(camera, cam7, cand_uv, rho0, P, r_add)
    return feats, augment_cuda(P, ops, slots, ok)


@functools.cache
def _batched_ops():
    """The custom ops of (A) with its compact operands and of (B)."""
    def chain_op(cam: list[float], cam7: torch.Tensor, cand_uv: torch.Tensor,
                 P: torch.Tensor, rho0: float, r_add: list[float]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        feats, _, _, ops = _chain_cuda(cuda_lib.CamParams(*cam), cam7,
                                       cand_uv, rho0, P, tuple(r_add))
        return feats, ops

    def chain_rule(info, in_dims, cam, cam7, cand_uv, P, rho0, r_add):
        cam7, cand_uv, P = batched.stacked(info.batch_size, in_dims[1:4],
                                           cam7, cand_uv, P)
        feats, _, _, ops = _chain_cuda(cuda_lib.CamParams(*cam), cam7,
                                       cand_uv, rho0, P, tuple(r_add))
        return (feats, ops), (0, 0)

    def augment_op(P: torch.Tensor, ops: torch.Tensor, slots: torch.Tensor,
                   ok: torch.Tensor) -> torch.Tensor:
        return augment_cuda(P, ops, slots, ok)

    def augment_rule(info, in_dims, P, ops, slots, ok):
        return augment_cuda(*batched.stacked(info.batch_size, in_dims, P, ops,
                                             slots, ok)), 0

    return (batched.custom_op("init_chain", chain_op, chain_rule),
            batched.custom_op("init_augment", augment_op, augment_rule))


def add_covariance(camera: Camera, P: torch.Tensor, cam7: torch.Tensor,
                   cand_uv: torch.Tensor, slots: torch.Tensor,
                   ok: torch.Tensor, rho0: float, r_add: tuple):
    """(feats, P_new): the plain version on the CPU, the kernels on CUDA
    (one launch of each for all streams under ``torch.func.vmap``)."""
    if P.device.type == "cpu":
        return add_covariance_plain(camera, P, cam7, cand_uv, slots, ok,
                                    rho0, r_add)
    if batched.any_batched(P, cam7, cand_uv, slots, ok):
        chain, augment = _batched_ops()
        feats, ops = chain(cuda_lib.CamParams.values(camera), cam7, cand_uv,
                           P, float(rho0), [float(r) for r in r_add])
        return feats, augment(P, ops, slots, ok)
    return add_covariance_cuda(camera, P, cam7, cand_uv, slots, ok, rho0,
                               r_add)
