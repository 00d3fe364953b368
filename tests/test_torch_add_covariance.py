"""The add path's covariance augmentation (ops/init_kernel.py) against the
JAX package.

``add_covariance_plain`` (the port's copy of the JAX einsums and
index-map placement) runs inside the port's ``_add_features_impl`` and
``add_features_at``; both are held against the JAX functions in float64
at small F (N = 128 and 256), with invalid candidates, one candidate, and
targets that collide with active slots: P and x within 1e-12.

The element rule of the CUDA kernel (csrc/init.cu's header: the dim map
in which the higher candidate wins a dim two name, the new rows from
J1 P[:7, :], their transposes, and M(d, c) where both dims are new) is
written out in numpy from the chain's J1 and J2 and held against the
plain version in float64, duplicate slots included.  The kernels
themselves run on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.config import SlamConfig as JConfig
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu.filter import features as jfeat
from openekfmonoslam_tpu_torch.config import SlamConfig as TConfig
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter import features as tfeat
from openekfmonoslam_tpu_torch.filter.state import (state_from_numpy,
                                                    state_to_numpy)
from openekfmonoslam_tpu_torch.ops import init_kernel

CFG = TConfig(dtype="float64")
CAM = Camera.from_calibration(CFG.camera)
R_ADD = (CFG.camera.pixel_error_x ** 2, CFG.camera.pixel_error_y ** 2,
         CFG.ekf.inverse_depth_rho_sd ** 2)


def make_states(F, n_active, seed):
    """A JAX state with a random pose, n_active random active slots and a
    random SPD P on the active dims (zero elsewhere, as the filter keeps
    it), and the port's copy on the CPU."""
    rng = np.random.default_rng(seed)
    jrt = JRuntime(JConfig(max_features=F, dtype="float64"))
    js = jrt.make_initial_state()
    fields = {name: np.asarray(getattr(js, name)) for name in js._fields}
    N = fields["P"].shape[0]
    active = np.zeros(F, bool)
    active[rng.choice(F, n_active, replace=False)] = True
    dims = np.zeros(N, bool)
    dims[:13] = True
    for s in np.flatnonzero(active):
        dims[13 + 6 * s:19 + 6 * s] = True
    A = rng.normal(size=(N, N + 5))
    P = (A @ A.T / N + 0.3 * np.eye(N)) * np.outer(dims, dims)
    x = np.where(dims, rng.normal(0, 0.5, N), 0.0)
    q = rng.normal(size=4)
    x[3:7] = q / np.linalg.norm(q)
    fields.update(P=0.5 * (P + P.T), x=x, active=active)
    js = js._replace(**{k: jnp.asarray(fields[k])
                        for k in ("P", "x", "active")})
    return jrt, js, state_from_numpy(fields, "cpu"), rng


def candidates(rng, F, C, n_valid, active, free_only=True):
    """C candidate pixels; n_valid of them valid, at shuffled slots (free
    ones, or any when not free_only), the rest invalid at slot F."""
    uv = rng.uniform([30, 30], [610, 450], size=(C, 2))
    pool = np.flatnonzero(~active) if free_only else np.arange(F)
    slots = np.full(C, F, np.int32)
    ok = np.zeros(C, bool)
    where = rng.choice(C, n_valid, replace=False)
    slots[where] = rng.choice(pool, n_valid, replace=False)
    ok[where] = True
    return uv, slots, ok


def assert_states_close(js, ts):
    got = state_to_numpy(ts)
    for name in ("P", "x", "active", "is_xyz", "times_predicted",
                 "times_matched", "birth"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("F,n_active,C,n_valid", [
    (12, 4, 12, 5),       # N = 128: valid and invalid candidates
    (12, 7, 1, 1),        # one candidate
    (30, 10, 30, 12),     # N = 256
    (30, 0, 6, 0),        # no valid candidate: P and x unchanged
])
def test_add_features_impl_matches_jax(F, n_active, C, n_valid):
    jrt, js, ts, rng = make_states(F, n_active, seed=F + C)
    uv, slots, ok = candidates(rng, F, C, n_valid, np.asarray(js.active))
    desc = np.zeros((C, 8), np.uint32)
    jout = jfeat._add_features_impl(js, jrt.camera, jrt.config,
                                    jnp.asarray(uv), jnp.asarray(desc),
                                    jnp.asarray(slots), jnp.asarray(ok))
    tout = tfeat._add_features_impl(ts, CAM, CFG, torch.tensor(uv),
                                    torch.tensor(desc.view(np.int32)),
                                    torch.tensor(slots), torch.tensor(ok))
    assert_states_close(jout, tout)
    if n_valid == 0:
        assert torch.equal(tout.P, ts.P) and torch.equal(tout.x, ts.x)


def test_add_features_at_collision_matches_jax():
    """Targets that name active slots: both packages free them first."""
    F, C = 20, 8
    jrt, js, ts, rng = make_states(F, 12, seed=5)
    uv, slots, ok = candidates(rng, F, C, 6, np.asarray(js.active),
                               free_only=False)
    assert np.asarray(js.active)[slots[ok]].any()
    desc = np.zeros((C, 8), np.uint32)
    jout = jfeat.add_features_at(js, jrt.camera, jrt.config,
                                 jnp.asarray(uv), jnp.asarray(desc),
                                 jnp.asarray(slots), jnp.asarray(ok))
    tout = tfeat.add_features_at(ts, CAM, CFG, torch.tensor(uv),
                                 torch.tensor(desc.view(np.int32)),
                                 torch.tensor(slots), torch.tensor(ok))
    assert_states_close(jout, tout)


def kernel_rule(P, cam7, uv, slots, ok):
    """P_new by csrc/init.cu's element rule, in numpy float64, from the
    chain's J1 and J2 (init_plain)."""
    N, C = P.shape[0], len(slots)
    _, J1, J2 = (a.numpy() for a in init_kernel.init_plain(
        CAM, torch.tensor(cam7), torch.tensor(uv), CFG.ekf.init_inv_depth_rho))
    G = J1[:, 3:5, 3:7]
    Bm = J1 @ P[:7, :7]
    D = Bm @ J1.transpose(0, 2, 1) + np.einsum(
        "cik,k,cjk->cij", J2, np.array(R_ADD), J2)
    dim_map = np.full(N, -1)
    for c in range(C):                  # in order: the higher c wins
        if ok[c]:
            dim_map[13 + 6 * slots[c]:19 + 6 * slots[c]] = 6 * c + np.arange(6)

    def row(m, col):                    # (J1_c P[:7, :])[i, col]
        c, i = divmod(m, 6)
        if i < 3:
            return P[i, col]
        return 0.0 if i == 5 else G[c, i - 3] @ P[3:7, col]

    def cross(md, mr):                  # M(d, c)[j, i]
        (d, j), (c, i) = divmod(md, 6), divmod(mr, 6)
        if c == d:
            return D[d, j, i]
        if i < 3:
            return Bm[d, j, i]
        return 0.0 if i == 5 else G[c, i - 3] @ Bm[d, j, 3:7]

    out = P.copy()
    new = np.flatnonzero(dim_map >= 0)
    for r in new:
        for n in range(N):
            if dim_map[n] < 0:
                out[r, n] = row(dim_map[r], n)
                out[n, r] = row(dim_map[r], n)
            else:
                out[r, n] = cross(dim_map[n], dim_map[r])
    return out


@pytest.mark.parametrize("duplicate", [False, True])
def test_kernel_element_rule_matches_plain(duplicate):
    """The kernel's element rule gives the plain version's P_new; with two
    valid candidates on one slot, the higher candidate wins in both."""
    F, C = 12, 7
    _, js, ts, rng = make_states(F, 3, seed=11)
    uv, slots, ok = candidates(rng, F, C, 5, np.asarray(js.active))
    if duplicate:
        valid = np.flatnonzero(ok)
        slots[valid[3]] = slots[valid[1]]
    P = ts.P.numpy()
    cam7 = ts.x[:7].numpy()
    feats, P_new = init_kernel.add_covariance_plain(
        CAM, ts.P, ts.x[:7], torch.tensor(uv), torch.tensor(slots),
        torch.tensor(ok), CFG.ekf.init_inv_depth_rho, R_ADD)
    np.testing.assert_allclose(P_new.numpy(), kernel_rule(P, cam7, uv,
                                                          slots, ok),
                               rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    F, C = 12, 5
    _, js, ts, rng = make_states(F, 3, seed=2)
    uv, slots, ok = candidates(rng, F, C, 4, np.asarray(js.active))
    args = (CAM, ts.P.float(), ts.x[:7].float(),
            torch.tensor(uv, dtype=torch.float32), torch.tensor(slots),
            torch.tensor(ok), CFG.ekf.init_inv_depth_rho, R_ADD)
    init_kernel.LAUNCHES.reset()
    init_kernel.AUGMENT_LAUNCHES.reset()
    for got, want in zip(init_kernel.add_covariance(*args),
                         init_kernel.add_covariance_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        init_kernel.add_covariance_cuda(*args)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        init_kernel.augment_cuda(args[1], torch.zeros((C, init_kernel.OPS)),
                                 args[4], args[5])
    assert init_kernel.LAUNCHES.count == 0
    assert init_kernel.AUGMENT_LAUNCHES.count == 0
