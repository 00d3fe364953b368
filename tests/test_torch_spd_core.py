"""The steps of the compacted, factored SPD core (csrc/spd_core.cuh) that
the CUDA update and S-inverse kernels follow, written out in PyTorch here
and held against the JAX package:

- ``identity_rows``: the rows k whose row and column of S are exactly e_k
  (``sinv_factor``'s test);
- ``compact``: the used rows' indices by a prefix sum (``spd::compact``);
- ``blocked_cholesky``: S_u = L L^T by panels of ``NB`` columns, the panel
  below each diagonal block formed as A_21 T^T with T = L_bb^-1
  (``spd::factor``); returns L and the T of every diagonal block;
- ``forward_solve``: L^-1 B by block rows through the T blocks
  (``update_solve``, ``sinv_solve``);
- ``update_factored``: the fused update's three launches, in factored form;
- ``inverse_factored``: the S-inverse's launches, W = L^-1, X = W^T W and
  one refinement step whose residual is taken in float64 (the kernel's
  Dot2 sum: twice float32's precision).

The tests:

- The factored update (compaction, blocked Cholesky, V = L^-1 HP_u,
  y = L^-1 res_u, x' = x + V^T y, P' = 1/2 (P + P^T) - V^T V, then the
  quaternion renormalization) against the JAX chain
  ``filter/update.update`` in float64 at 1e-10, at F = 1, 8, 96 and 130
  with 0, 30, 60 and 100% of the slots used.
- The blocked Cholesky and the blocked forward solve against JAX's
  ``cholesky`` and ``solve_triangular`` in float64.
- The compacted S-inverse against ``ops/sinv.spd_inverse`` (Cholesky) on
  the update's masked S and on dense ``spd_cond`` matrices, in float64,
  and in float32 against float64 within the kernel's bounds.
- The identity-row test rejects a row that is e_k while its column is
  not, and ``dense_factor`` rebuilds the masked S's factor from the
  kernel's packed layout.

Inputs are made from a numpy seed.
"""

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.filter import update as jupd
from openekfmonoslam_tpu.filter.measure import Prediction as JPrediction
from openekfmonoslam_tpu.filter.state import SlamState as JState
from openekfmonoslam_tpu_torch.filter.update import finalize_xp
from openekfmonoslam_tpu_torch.ops import sinv, spd_core
from test_torch_cuda_kernels import masked_s, spd_cond

PIXEL_ERROR = 1.5


def identity_rows(S: torch.Tensor) -> torch.Tensor:
    """(M,) bool: row k and column k of S are exactly e_k."""
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    off = S != eye
    return ~(off.any(dim=1) | off.any(dim=0))


def compact(used: torch.Tensor) -> torch.Tensor:
    """The indices of the used rows, in order, placed by an exclusive
    prefix sum of the flags as the kernel places them."""
    flags = used.to(torch.int64)
    slot = torch.cumsum(flags, 0) - flags
    idx = torch.empty(int(flags.sum()), dtype=torch.int64, device=used.device)
    rows = torch.arange(used.shape[0], device=used.device)
    idx[slot[used]] = rows[used]
    return idx


def blocked_cholesky(A: torch.Tensor, nb: int = spd_core.NB
                     ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(L, [T_b]) with A = L L^T, by right-looking panels of nb columns:
    factor the diagonal block, T = its inverse, the panel below as
    A_21 T^T, the trailing update A_22 -= L_21 L_21^T."""
    A = torch.tril(A.clone())
    n = A.shape[0]
    inverses = []
    for p in range(0, n, nb):
        q = min(p + nb, n)
        L11 = torch.linalg.cholesky(A[p:q, p:q])
        eye = torch.eye(q - p, dtype=A.dtype, device=A.device)
        T = torch.linalg.solve_triangular(L11, eye, upper=False)
        inverses.append(T)
        A[p:q, p:q] = L11
        L21 = A[q:, p:q] @ T.T
        A[q:, p:q] = L21
        A[q:, q:] -= torch.tril(L21 @ L21.T)
    return A, inverses


def forward_solve(L: torch.Tensor, inverses: list, B: torch.Tensor,
                  nb: int = spd_core.NB) -> torch.Tensor:
    """L^-1 B by block rows: Y_b = T_b B_b, then B_below -= L_below,b Y_b."""
    Y = B.clone()
    for b, T in enumerate(inverses):
        p, q = b * nb, min((b + 1) * nb, L.shape[0])
        Y[p:q] = T @ Y[p:q]
        Y[q:] -= L[q:, p:q] @ Y[p:q]
    return Y


def update_factored(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                    Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                    use: torch.Tensor, pixel_error: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P') by the fused update's factored steps; with no slot used,
    x and P unchanged."""
    idx = compact(use[:, None].expand(-1, 2).reshape(-1))
    if idx.numel() == 0:
        return x, P
    S_u = Sfull[idx][:, idx] + pixel_error * torch.eye(
        idx.numel(), dtype=P.dtype, device=P.device)
    L, inverses = blocked_cholesky(S_u)
    res_u = (z - uv).reshape(-1)[idx]
    Y = forward_solve(L, inverses, torch.cat([HP[idx], res_u[:, None]], 1))
    V, y = Y[:, :-1], Y[:, -1]
    xk = x + V.T @ y
    Pk = 0.5 * (P + P.T) - V.T @ V
    # the symmetrize step of finalize_xp leaves this exactly symmetric P'
    return finalize_xp(Pk, xk, torch.ones((), dtype=torch.bool))


def inverse_factored(S: torch.Tensor) -> torch.Tensor:
    """S^-1 by the S-inverse kernels' steps: compact the non-identity rows,
    factor, W = L^-1, X = W^T W, one refinement step with a float64
    residual, scatter back with identity rows and columns."""
    idx = compact(~identity_rows(S))
    out = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    if idx.numel() == 0:
        return out
    S_u = S[idx][:, idx]
    L, inverses = blocked_cholesky(S_u)
    eye = torch.eye(idx.numel(), dtype=S.dtype, device=S.device)
    W = forward_solve(L, inverses, eye)
    X = W.T @ W
    wide = torch.float64
    R = (eye.to(wide) - S_u.to(wide) @ X.to(wide)).to(S.dtype)
    out[idx[:, None], idx[None, :]] = X + X @ R
    return out


def _problem(F, use_frac, seed):
    rng = np.random.default_rng(seed)
    N = 13 + 6 * F
    A = rng.standard_normal((N, 40))
    P = A @ A.T / 40 + 0.5 * np.eye(N)
    P = 0.5 * (P + P.T)
    x = rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    H = rng.standard_normal((2 * F, N)) * 0.05
    HP = H @ P
    uv = rng.uniform(0, 600, (F, 2))
    z = uv + rng.standard_normal((F, 2))
    use = rng.uniform(size=F) < use_frac
    return P, x, HP, HP @ H.T, uv, z, use


def _jax_update(P, x, HP, Sfull, uv, z, use):
    F = uv.shape[0]
    f64 = jnp.float64
    state = JState(x=jnp.asarray(x, f64), P=jnp.asarray(P, f64),
                   active=jnp.ones(F, bool), is_xyz=jnp.zeros(F, bool),
                   times_predicted=jnp.zeros(F, jnp.int32),
                   times_matched=jnp.zeros(F, jnp.int32),
                   descriptors=jnp.zeros((F, 8), jnp.uint32),
                   patch_pose=jnp.zeros((F, 7), jnp.float32),
                   birth=jnp.zeros(F, jnp.int32),
                   rng=jax.random.PRNGKey(0), frame=jnp.int32(0))
    pred = JPrediction(uv=jnp.asarray(uv, f64), visible=jnp.asarray(use),
                       Hc=jnp.zeros((F, 2, 13), f64),
                       Hf=jnp.zeros((F, 2, 6), f64),
                       S=jnp.zeros((F, 2, 2), f64), HP=jnp.asarray(HP, f64),
                       Sfull=jnp.asarray(Sfull, f64))
    ref = jupd.update(state, pred, jnp.asarray(z, f64), jnp.asarray(use),
                      PIXEL_ERROR)
    return np.asarray(ref.x), np.asarray(ref.P)


@pytest.mark.parametrize("use_frac", [0.0, 0.3, 0.6, 1.0])
@pytest.mark.parametrize("F", [1, 8, 96, 130])
def test_update_factored_matches_jax_chain(F, use_frac):
    P, x, HP, Sfull, uv, z, use = _problem(F, use_frac, seed=F)
    want_x, want_P = _jax_update(P, x, HP, Sfull, uv, z, use)
    t = [torch.tensor(a) for a in (P, x, HP, Sfull, uv, z)]
    got_x, got_P = update_factored(*t, torch.tensor(use),
                                            PIXEL_ERROR)
    if not use.any():
        # no applied match: an exact pass-through, as in JAX
        assert torch.equal(got_x, t[1]) and torch.equal(got_P, t[0])
        np.testing.assert_array_equal(want_P, P)
        return
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_P.numpy(), want_P, rtol=0, atol=1e-10)


def test_compact_is_the_prefix_sum_of_the_flags():
    rng = np.random.default_rng(2)
    for m in (1, 7, 192, 700):
        used = rng.random(m) < 0.4
        idx = compact(torch.tensor(used))
        np.testing.assert_array_equal(idx.numpy(), np.flatnonzero(used))
    assert compact(torch.zeros(5, dtype=torch.bool)).numel() == 0


def _spd64(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n + 5))
    return A @ A.T / n + np.eye(n)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_blocked_cholesky_and_forward_solve_match_jax(n):
    S = _spd64(n, n)
    L, inverses = blocked_cholesky(torch.tensor(S))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(S)))
    np.testing.assert_allclose(L.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert len(inverses) == -(-n // spd_core.NB)
    B = np.random.default_rng(n + 1).standard_normal((n, 17))
    Y = forward_solve(L, inverses, torch.tensor(B))
    want_Y = np.asarray(jsl.solve_triangular(jnp.asarray(want),
                                             jnp.asarray(B), lower=True))
    np.testing.assert_allclose(Y.numpy(), want_Y, rtol=0,
                               atol=1e-10 * np.abs(want_Y).max())


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("M", [192, 336])
def test_inverse_factored_masked_s(M):
    S = torch.tensor(masked_s(M)).double()
    ident = identity_rows(S)
    assert 0 < int(ident.sum()) < M
    got = inverse_factored(S)
    assert _rel(got, sinv.spd_inverse(S)) <= 1e-12
    eye = torch.eye(M, dtype=S.dtype)
    assert torch.equal(got[ident], eye[ident])
    assert torch.equal(got[:, ident], eye[:, ident])
    # float32, against float64, within the masked-S bound of the kernel
    got32 = inverse_factored(S.float())
    assert got32.dtype == torch.float32
    assert _rel(got32, torch.linalg.inv(S)) <= 1e-4


@pytest.mark.parametrize("cond", [1e2, 1e4])
@pytest.mark.parametrize("M", [1, 7, 96, 200])
def test_inverse_factored_dense(M, cond):
    S32 = torch.tensor(spd_cond(M, cond))
    S = S32.double()
    assert not bool(identity_rows(S).any()) or M == 1
    assert _rel(inverse_factored(S), sinv.spd_inverse(S)) \
        <= 1e-13 * cond
    assert _rel(inverse_factored(S32), torch.linalg.inv(S)) \
        <= 3e-5 * max(cond / 1e2, 1.0)


def test_identity_rows_need_the_row_and_the_column():
    S = torch.tensor(spd_cond(8, 1e2)).double()
    S[3, :] = 0.0
    S[:, 3] = 0.0
    S[3, 3] = 1.0
    S[5, :] = 0.0
    S[5, 5] = 1.0               # row 5 is e_5, column 5 is not
    S[:, 6] = 0.0
    S[6, 6] = 1.0               # column 6 is e_6, row 6 is not
    got = identity_rows(S)
    assert got.tolist() == [k == 3 for k in range(8)]


@pytest.mark.parametrize("F,use_frac", [(8, 0.5), (40, 1.0), (30, 0.0)])
def test_dense_factor_rebuilds_the_masked_factor(F, use_frac):
    """The kernel's layout (packed L of the used rows, their indices, the
    counts) rebuilt by ``dense_factor``: L L^T is the masked S."""
    _, _, _, Sfull, _, _, use = _problem(F, use_frac, seed=7)
    use = torch.tensor(use)
    u2 = use[:, None].expand(-1, 2).reshape(-1)
    Sf = torch.tensor(Sfull)
    S = Sf * (u2[:, None] & u2[None, :]).double() + torch.diag(
        torch.where(u2, torch.tensor(PIXEL_ERROR, dtype=torch.float64),
                    torch.tensor(1.0, dtype=torch.float64)))
    idx = compact(u2)
    n = idx.numel()
    packed = torch.zeros(spd_core.tri(2 * F), dtype=torch.float64)
    if n:
        L, _ = blocked_cholesky(
            Sf[idx][:, idx] + PIXEL_ERROR * torch.eye(n, dtype=torch.float64))
        rows, cols = torch.tril_indices(n, n)
        packed[:spd_core.tri(n)] = L[rows, cols]
    ints = torch.zeros(2 * F, dtype=torch.int32)
    ints[:n] = idx.to(torch.int32)
    factor = spd_core.Factor(packed, ints,
                             torch.tensor([n, 0], dtype=torch.int32))
    Ld = spd_core.dense_factor(factor, 2 * F)
    assert torch.equal(Ld, torch.tril(Ld))
    assert _rel(Ld @ Ld.T, S) <= 1e-13
