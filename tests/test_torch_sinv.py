"""The port's SPD inverses (ops/sinv.py) and the update's routing
(filter/update.py) against the JAX package.

The port of the JAX Newton-Schulz math, ``ns_inverse``, is held against
the float64 inverse on the matrices of tests/test_sinv.py (cond 1e2-1e4,
and the update's masked S with identity rows) in float32, to the 1e-4
relative bound of the TPU kernel's tests; ``spd_inverse`` on the CPU is
Cholesky (the S-inverse kernels' plain version), held against the JAX
``spd_inverse`` in float64.  The routing constants are the JAX package's.
The CUDA kernels themselves are checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.ops import sinv as jsinv
from openekfmonoslam_tpu.ops import update_kernel as jupdk
from openekfmonoslam_tpu_torch.ops import sinv, update_kernel
from test_torch_cuda_kernels import masked_s, spd_cond as spd


def rel_err(x, s):
    want = np.linalg.inv(s.astype(np.float64))
    return np.abs(np.asarray(x, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("m", [192, 336])
@pytest.mark.parametrize("cond", [1e2, 1e3, 1e4])
def test_ns_inverse_float32_against_float64(m, cond):
    s = spd(m, cond)
    x, steps = sinv.ns_inverse_steps(torch.tensor(s), lam_floor=1.0)
    assert x.dtype == torch.float32
    assert rel_err(x.numpy(), s) <= 1e-4
    if cond == 1e4:
        assert steps > 0            # the rescue branch ran
    if cond == 1e2:
        assert steps == 0


def test_ns_inverse_masked_identity_rows():
    s = masked_s(336)
    x, steps = sinv.ns_inverse_steps(torch.tensor(s), lam_floor=1.0)
    assert rel_err(x.numpy(), s) <= 1e-4
    assert steps > 0


@pytest.mark.parametrize("case", ["spd", "masked"])
def test_spd_inverse_cpu_matches_jax_in_float64(case):
    s = (spd(96, 1e3) if case == "spd" else masked_s(120)).astype(np.float64)
    want = np.asarray(jsinv.spd_inverse(jnp.asarray(s), lam_floor=1.0))
    got = sinv.spd_inverse(torch.tensor(s), lam_floor=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_routing_constants_are_the_jax_packages():
    assert sinv.MAX_KERNEL_M == jsinv._MAX_PALLAS_M
    assert (update_kernel._LANE, update_kernel._MAX_N,
            update_kernel._MAX_M) == (jupdk._LANE, jupdk._MAX_N,
                                      jupdk._MAX_M)
    assert (sinv.N_ITERS, sinv.F32_POLISH) == (jsinv.N_ITERS,
                                               jsinv.F32_POLISH)


@pytest.mark.parametrize("N,M,route", [(640, 192, "fused"),
                                       (1024, 336, "chain+sinv"),
                                       (1664, 550, "chain+cholesky")])
def test_update_routes(N, M, route):
    fused = update_kernel.update_kernel_fits(N, M)
    kernel_inverse = M <= sinv.MAX_KERNEL_M
    assert route == ("fused" if fused else
                     "chain+sinv" if kernel_inverse else "chain+cholesky")
    # the JAX package's rule on the same shapes (update_kernel.py:213-215)
    assert fused == (N % jupdk._LANE == 0 and N <= jupdk._MAX_N
                     and M <= jupdk._MAX_M)
    assert kernel_inverse == (M <= jsinv._MAX_PALLAS_M)


def test_cpu_tensors_take_the_chain_and_cholesky():
    P, HP = torch.eye(640), torch.zeros((192, 640))
    assert not update_kernel.update_kernel_applicable(P, HP)
    s = torch.tensor(spd(32, 1e2))
    sinv.LAUNCHES.reset()
    torch.testing.assert_close(sinv.spd_inverse(s), sinv.cholesky_inverse(s),
                               rtol=0, atol=0)
    assert sinv.LAUNCHES.count == 0


def test_wrapper_runs_the_plain_version_on_a_cpu_tensor():
    s = torch.tensor(spd(48, 1e3))
    sinv.LAUNCHES.reset()
    # the S-inverse kernels' plain version is the Cholesky inverse
    torch.testing.assert_close(sinv.newton_schulz_inverse(s, 1.0),
                               sinv.cholesky_inverse(s), rtol=0, atol=0)
    assert sinv.LAUNCHES.count == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        sinv.sinv_cuda(s)
    assert sinv.LAUNCHES.count == 0
