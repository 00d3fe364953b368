"""The yardstick of the kernels' roofline shares: the card's published
peaks and, for each kernel set, the bytes and operations one launch needs,
counted from the shapes it was launched with.

Bytes count each input the computation needs read once and each output
written once, whatever a kernel reads again; operations are what these
inputs need (the used rows, not the padded ones).  A launch over B streams
needs the sum of its streams' counts.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the 700 W limit: HBM3 bytes/s and float32
# operations/s outside the tensor cores (the filter computes in true fp32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes or operations, whichever
    bounds."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S)


def update_bytes(n_state: int, n_slots: int, used_rows: int) -> int:
    """The fused joint update (csrc/update.cu, its three launches together)
    on ``used_rows`` = 2 x the slots it uses: P (N, N) in and out, x in and
    out, the used rows of H P and of S, the slots' predictions and matches
    (float32 pixels) and the use mask (bytes)."""
    N, F, M = n_state, n_slots, used_rows
    return 4 * (2 * N * N + 2 * N + M * N + M * M + 4 * F) + F


def update_flops(n_state: int, used_rows: int) -> float:
    """Its operations in factored form, two a multiply-add: the Cholesky
    factor of the used S (M^3 / 6), V = L^-1 (H P)_used (M^2 N / 2), the
    downdate V^T V on one triangle (M N^2 / 2, P' is symmetric), y and
    dx = V^T y (M^2 / 2 + M N)."""
    N, M = n_state, used_rows
    return 2.0 * (M ** 3 / 6 + M * M * N / 2 + M * N * N / 2
                  + M * M / 2 + M * N)


def sinv_bytes(m: int) -> int:
    """The S-inverse set (csrc/sinv.cu): S (m, m) float32 in, S^-1 out."""
    return 8 * m * m


def sinv_flops(used_rows: int) -> float:
    """An SPD inverse over the rows that are not identity rows."""
    return float(used_rows) ** 3
