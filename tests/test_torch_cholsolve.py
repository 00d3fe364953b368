"""The port's blocked Cholesky solve (ops/cholsolve.py) against the JAX
package.

``chol_solve_plain`` is held against the JAX kernel in interpret mode
(``chol_solve_pallas(..., interpret=True)``) at tests/test_cholsolve.py's
shapes in float32: within 1e-5 relative of each other, and within that
test's 1e-4 of the float64 solve.  Ragged sizes, which the JAX wrapper pads
and the port does not, are held against float64.  ``solve_spd`` off the
card is the library Cholesky solve, held against the JAX ``solve_spd`` off
the TPU in float64 to 1e-12.  The CUDA kernel itself is checked on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.ops import cholsolve as jchol
from openekfmonoslam_tpu_torch.ops import cholsolve
from test_torch_cuda_kernels import spd_plus


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def problem(m, n, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    S = spd_plus(rng, m, scale)
    return S, rng.normal(size=(m, n)).astype(np.float32)


@pytest.mark.parametrize("m,n", [(64, 128), (192, 640), (128, 256)])
def test_plain_matches_the_jax_kernel_in_interpret_mode(m, n):
    S, B = problem(m, n)
    X = cholsolve.chol_solve_plain(torch.tensor(S), torch.tensor(B))
    assert X.dtype == torch.float32 and X.shape == (m, n)
    Xj = np.asarray(jchol.chol_solve_pallas(jnp.asarray(S), jnp.asarray(B),
                                            interpret=True))
    X64 = np.linalg.solve(S.astype(np.float64), B.astype(np.float64))
    assert rel(X.numpy(), Xj) <= 1e-5
    assert rel(X.numpy(), X64) <= 1e-4
    assert rel(Xj, X64) <= 1e-4


@pytest.mark.parametrize("m,n", [(48, 200), (1, 1), (65, 3)])
def test_plain_ragged_sizes(m, n):
    """No padding: the last block is ragged (one row at m = 65)."""
    S, B = problem(m, n, seed=1, scale=5.0)
    X64 = np.linalg.solve(S.astype(np.float64), B.astype(np.float64))
    X = cholsolve.chol_solve_plain(torch.tensor(S), torch.tensor(B))
    assert rel(X.numpy(), X64) <= 1e-4
    Xd = cholsolve.chol_solve_plain(torch.tensor(S, dtype=torch.float64),
                                    torch.tensor(B, dtype=torch.float64))
    assert rel(Xd.numpy(), X64) <= 1e-12


def test_plain_pivot_clamp():
    """A non-positive pivot is clamped to 1e-30 as in the TPU kernel, which
    keeps the factor finite."""
    L = cholsolve._factor_block(torch.tensor([[0.0, 0.0], [0.0, 4.0]]))
    assert bool(torch.isfinite(L).all())
    assert float(L[1, 1]) == 2.0


@pytest.mark.parametrize("m,n", [(96, 50), (200, 7)])
def test_solve_spd_matches_jax_in_float64(m, n):
    S, B = problem(m, n, seed=2)
    S, B = S.astype(np.float64), B.astype(np.float64)
    want = np.asarray(jchol.solve_spd(jnp.asarray(S), jnp.asarray(B)))
    got = cholsolve.solve_spd(torch.tensor(S), torch.tensor(B)).numpy()
    assert rel(got, want) <= 1e-12


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    S, B = problem(70, 9, seed=3)
    St, Bt = torch.tensor(S), torch.tensor(B)
    cholsolve.LAUNCHES.reset()
    torch.testing.assert_close(cholsolve.solve_spd(St, Bt, force_kernel=True),
                               cholsolve.chol_solve_plain(St, Bt), rtol=0,
                               atol=0)
    # a CPU float32 S without force_kernel: the library solve, as JAX off
    # the TPU
    torch.testing.assert_close(
        cholsolve.solve_spd(St, Bt),
        torch.cholesky_solve(Bt, torch.linalg.cholesky(St)), rtol=0, atol=0)
    assert cholsolve.LAUNCHES.count == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cholsolve.chol_solve_cuda(St, Bt)
    assert cholsolve.LAUNCHES.count == 0


def test_block_size_is_the_jax_kernels():
    assert cholsolve.BS == jchol.BS
