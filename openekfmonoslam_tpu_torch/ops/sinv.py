"""SPD inverses for the joint update (port of ops/sinv.py).

``sinv_cuda`` launches the hand-written Newton-Schulz kernel
(``csrc/sinv.cu``), which replaces the TPU kernel ``_sinv_kernel`` /
``sinv_pallas`` (openekfmonoslam_tpu/ops/sinv.py:169,177).  ``ns_inverse``
is its plain PyTorch version; ``newton_schulz_inverse`` is the wrapper: a
CPU tensor runs ``ns_inverse``, a CUDA tensor launches the kernel or
raises.

``spd_inverse`` routes as the JAX package does (ops/sinv.py:215-225): a
CUDA float32 S with M <= 512 takes the kernel, anything else Cholesky
against I (``cholesky_inverse``, a library call, as the JAX package leaves
it to XLA outside any Pallas kernel).  On the card the Cholesky path does
not read back to the host: ``cholesky_ex`` skips the error check that
``torch.linalg.cholesky`` syncs for.

Bound of the kernel on the H100: bytes (S in, S^-1 out); see
csrc/sinv.cu for the count and the design.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.ops import cuda_lib

N_ITERS = 12
F32_POLISH = 2
MAX_RESCUE = 128
# The JAX package's routing (ops/sinv.py:212): its one-block TPU kernel
# held S in 16 MB of VMEM up to M = 512.  Not a limit of the CUDA kernel,
# which takes any M.
MAX_KERNEL_M = 512
# csrc/sinv.cu's output tile edge: the kernel needs one float of scratch
# per (TILE, TILE) tile for its per-block residual maxima
TILE = 32

LAUNCHES = cuda_lib.LaunchCounter("sinv")


def cholesky_inverse(S: torch.Tensor) -> torch.Tensor:
    """S^-1 for SPD S by Cholesky factorization and a solve against I,
    with no host synchronisation on the card."""
    L, _ = torch.linalg.cholesky_ex(S)
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    return torch.cholesky_solve(eye, L)


def ns_inverse(S: torch.Tensor, lam_floor: float = 1.0,
               n_iters: int = N_ITERS, f32_polish: int = F32_POLISH
               ) -> torch.Tensor:
    """Newton-Schulz SPD inverse X <- X (2I - S X) from X0 = c I,
    c = 1.8 / (lam_floor + ||S||_inf), with the residual-gated rescue of
    the TPU kernel: when the first polish step's residual max|SX - I|
    exceeds 0.05, restart from X0 and iterate until it is <= 5e-4.  The
    last f32_polish - 1 steps refine, X <- X + X (I - S X), with the
    residual computed in float64 (the kernel's Dot2 sum: twice float32's
    precision)."""
    return ns_inverse_steps(S, lam_floor, n_iters, f32_polish)[0]


def ns_inverse_steps(S: torch.Tensor, lam_floor: float = 1.0,
                     n_iters: int = N_ITERS, f32_polish: int = F32_POLISH
                     ) -> tuple[torch.Tensor, int]:
    """``ns_inverse`` and the number of rescue steps it took (0: the
    probe passed)."""
    m = S.shape[0]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    c = 1.8 / (lam_floor + torch.max(torch.sum(torch.abs(S), dim=1)))
    X = c * eye
    for _ in range(n_iters - f32_polish):
        X = X @ (2.0 * eye - S @ X)
    T = 2.0 * eye - S @ X
    bad = bool(torch.max(torch.abs(T - eye)) > 0.05)
    X = X @ T
    k = 0
    if bad:
        X = c * eye
        res = 1.0
        while res > 5e-4 and k < MAX_RESCUE:
            T = 2.0 * eye - S @ X
            res = float(torch.max(torch.abs(T - eye)))
            X = X @ T
            k += 1
    wide = torch.float64
    for _ in range(f32_polish - 1):
        R = (eye.to(wide) - S.to(wide) @ X.to(wide)).to(S.dtype)
        X = X + X @ R
    return X, k


def sinv_cuda(S: torch.Tensor, lam_floor: float = 1.0,
              n_iters: int = N_ITERS, f32_polish: int = F32_POLISH
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S^-1, rescue steps) from one cooperative launch of the CUDA
    kernel; S (M, M) float32 SPD with lambda_min(S) >= lam_floor.  The
    rescue-step count (a (1,) int32 tensor, 0 when the probe passed) is
    returned for checking."""
    S = S.contiguous()
    cuda_lib.check_cuda_inputs("sinv", {"S": S})
    M = S.shape[0]
    if S.shape != (M, M) or M < 1:
        raise ValueError(f"sinv: S must be square, got {tuple(S.shape)}")
    if f32_polish < 1 or n_iters < f32_polish:
        raise ValueError("sinv: needs 1 <= f32_polish <= n_iters")
    tiles = -(-M // TILE)
    dev = S.device
    out = torch.empty_like(S)
    scratch = torch.empty((2 * M * M + tiles * tiles,), dtype=torch.float32,
                          device=dev)
    info = torch.empty((1,), dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    cuda_lib.library().call(
        "ekf_sinv", S.data_ptr(), out.data_ptr(), base, base + 4 * M * M,
        base + 8 * M * M, info.data_ptr(), M, float(lam_floor), n_iters,
        f32_polish, cuda_lib.stream_of(S))
    LAUNCHES.hit()
    return out, info


def newton_schulz_inverse(S: torch.Tensor, lam_floor: float = 1.0
                          ) -> torch.Tensor:
    """The Newton-Schulz S^-1: plain version on the CPU, the kernel on
    CUDA."""
    if S.device.type == "cpu":
        return ns_inverse(S, lam_floor)
    return sinv_cuda(S, lam_floor)[0]


def spd_inverse(S: torch.Tensor, lam_floor: float = 1.0) -> torch.Tensor:
    """S^-1 for SPD S with lambda_min >= lam_floor: the Newton-Schulz
    kernel for a CUDA float32 S up to MAX_KERNEL_M, Cholesky otherwise
    (large maps, the CPU, float64)."""
    if (S.device.type == "cuda" and S.dtype == torch.float32
            and S.shape[0] <= MAX_KERNEL_M):
        return newton_schulz_inverse(S, lam_floor)
    return cholesky_inverse(S)
