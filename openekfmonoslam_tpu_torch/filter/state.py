"""Slot-based filter state (port of filter/state.py).

The layout is the JAX package's, so states can be compared element by
element and carried between the packages (``state_from_numpy`` /
``state_to_numpy``):

  state vector x (N,)   N = 13 + 6*max_features, padded
    x[0:3]   r    camera position (world)
    x[3:7]   q    orientation quaternion (w,x,y,z), camera-to-world
    x[7:10]  v    linear velocity
    x[10:13] w    angular velocity
    x[13+6i : 19+6i]  feature slot i:
       inverse-depth: (x, y, z, theta, phi, rho)
       converted XYZ: (x, y, z, 0, 0, 0)

  covariance P (N, N): rows/columns of inactive dims are exactly zero.

Every function returns new tensors: no state tensor is written in place,
so a caller may keep any earlier ``SlamState`` (the step keeps the
prediction made from the pre-update P).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openekfmonoslam_tpu_torch.config import SlamConfig

CAM_DIM = 13
FEAT_DIM = 6

# the JAX PRNGKey(seed) layout: two uint32 words, high then low
_KEY_WORDS = 2


class SlamState(NamedTuple):
    """The filter state; every field is a tensor on the state's device."""

    x: torch.Tensor               # (N,) state vector
    P: torch.Tensor               # (N, N) covariance
    active: torch.Tensor          # (F,) bool: slot holds a live landmark
    is_xyz: torch.Tensor          # (F,) bool: converted to XYZ
    times_predicted: torch.Tensor  # (F,) int32
    times_matched: torch.Tensor    # (F,) int32
    descriptors: torch.Tensor     # (F, W) int32: uint32 words, bit-cast
    patch_pose: torch.Tensor      # (F, 7) float32 template capture pose
    birth: torch.Tensor           # (F,) int32 insertion stamp
    rng: torch.Tensor             # () int64: config.seed (nothing on the
    #                               ported path draws random numbers)
    frame: torch.Tensor           # () int32 step counter

    @property
    def n_features(self) -> int:
        return self.active.shape[0]

    @property
    def r(self) -> torch.Tensor:
        return self.x[0:3]

    @property
    def q(self) -> torch.Tensor:
        return self.x[3:7]

    @property
    def v(self) -> torch.Tensor:
        return self.x[7:10]

    @property
    def w(self) -> torch.Tensor:
        return self.x[10:13]

    @property
    def features(self) -> torch.Tensor:
        """(F, 6) feature slot parameters (excludes padding dims)."""
        f = self.active.shape[0]
        return self.x[CAM_DIM:CAM_DIM + f * FEAT_DIM].reshape(-1, FEAT_DIM)


def slot_offsets(n_features: int, device=None) -> torch.Tensor:
    """(F,) covariance row offset of each slot."""
    return CAM_DIM + FEAT_DIM * torch.arange(n_features, device=device)


def dim_active_mask(state: SlamState) -> torch.Tensor:
    """(N,) bool: camera dims always; slot dims when the slot is active,
    minus the retired 3 dims of converted-XYZ slots; padding never."""
    f = state.n_features
    n = state.x.shape[0]
    dev = state.x.device
    first3 = torch.arange(FEAT_DIM, device=dev) < 3
    per_slot = torch.where(state.is_xyz[:, None], first3[None, :],
                           torch.ones((1, FEAT_DIM), dtype=torch.bool,
                                      device=dev))
    per_slot = per_slot & state.active[:, None]
    return torch.cat([
        torch.ones((CAM_DIM,), dtype=torch.bool, device=dev),
        per_slot.reshape(f * FEAT_DIM),
        torch.zeros((n - CAM_DIM - f * FEAT_DIM,), dtype=torch.bool,
                    device=dev)])


def make_initial_state(config: SlamConfig, dtype: torch.dtype,
                       device) -> SlamState:
    """Bootstrap state and covariance (CommonFunctions.cpp:39-80)."""
    n = config.padded_state_dim
    f = config.max_features
    eps = 2.22e-16

    x = torch.zeros((n,), dtype=dtype, device=device)
    x[3:4] = 1.0                             # q = (1,0,0,0)
    x[10:13] = eps

    diag = torch.zeros((n,), dtype=dtype, device=device)
    diag[0:7] = eps
    diag[7:10] = config.ekf.init_linear_accel_sd ** 2
    diag[10:13] = config.ekf.init_angular_accel_sd ** 2

    if not config.descriptor.is_binary:
        raise NotImplementedError(
            f"{config.descriptor.kind} descriptors are not ported yet")
    i32 = dict(dtype=torch.int32, device=device)
    return SlamState(
        x=x,
        P=torch.diag(diag),
        active=torch.zeros((f,), dtype=torch.bool, device=device),
        is_xyz=torch.zeros((f,), dtype=torch.bool, device=device),
        times_predicted=torch.zeros((f,), **i32),
        times_matched=torch.zeros((f,), **i32),
        descriptors=torch.zeros((f, config.descriptor.width), **i32),
        patch_pose=torch.zeros((f, 7), dtype=torch.float32, device=device),
        birth=torch.zeros((f,), **i32),
        rng=torch.full((), config.seed, dtype=torch.int64, device=device),
        frame=torch.zeros((), **i32),
    )


def select_state(flag: torch.Tensor, if_true: SlamState,
                 if_false: SlamState) -> SlamState:
    """Field-wise ``where(flag, if_true, if_false)`` for a 0-dim bool
    ``flag`` on the device.  The port's form of the JAX package's
    ``lax.cond`` around rare state surgery: both sides are computed and
    one is selected, so no branch needs a device-to-host sync."""
    return SlamState(*(torch.where(flag, a, b)
                       for a, b in zip(if_true, if_false)))


def zero_inactive(P: torch.Tensor, dim_mask: torch.Tensor) -> torch.Tensor:
    """Re-assert the P-invariant: inactive rows/cols exactly zero."""
    m = dim_mask.to(P.dtype)
    return P * m[:, None] * m[None, :]


def state_from_numpy(fields: dict, device) -> SlamState:
    """A SlamState from the JAX SlamState's fields as numpy arrays
    (``{name: np.asarray(getattr(jax_state, name))}``).

    Float fields keep their dtype; ``descriptors`` (uint32) are bit-cast to
    int32; ``rng``, a JAX PRNGKey of the seed, becomes the seed."""
    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    key = np.asarray(fields["rng"]).astype(np.uint64).reshape(-1)
    if key.shape != (_KEY_WORDS,):
        raise ValueError(f"rng must be a PRNGKey of 2 words, got {key.shape}")
    seed = int((key[0] << np.uint64(32)) | key[1])
    desc = np.asarray(fields["descriptors"])
    if desc.dtype == np.uint32:
        desc = desc.view(np.int32)
    return SlamState(
        x=t(fields["x"]),
        P=t(fields["P"]),
        active=t(fields["active"], torch.bool),
        is_xyz=t(fields["is_xyz"], torch.bool),
        times_predicted=t(fields["times_predicted"], torch.int32),
        times_matched=t(fields["times_matched"], torch.int32),
        descriptors=t(desc, torch.int32),
        patch_pose=t(fields["patch_pose"], torch.float32),
        birth=t(fields["birth"], torch.int32),
        rng=torch.tensor(seed, dtype=torch.int64, device=device),
        frame=t(fields["frame"], torch.int32),
    )


def state_to_numpy(state: SlamState) -> dict:
    """The JAX SlamState's fields as numpy arrays, in the JAX dtypes:
    ``descriptors`` as uint32 and ``rng`` as the PRNGKey of the seed."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in SlamState._fields}
    out["descriptors"] = out["descriptors"].astype(np.int32).view(np.uint32)
    seed = int(out["rng"])
    out["rng"] = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                          np.uint32)
    return out
