"""Checkpoint / resume for the full filter state (port of
engine/checkpoint.py).

The reference serializes per-frame state write-only (State::write,
State.cpp:339-360) and never implemented restore (``State::read`` is
``assert(false)``, State.cpp:364-367).  A checkpoint is the complete filter
carry (x, P, slot metadata, rng, frame counter), so a resumed run
continues bit for bit.

Files are the JAX package's layout, written and read through
``filter/state.state_to_numpy`` / ``state_from_numpy``: descriptors as
uint32, rng as the PRNGKey words.  Either package loads the other's file,
and the pose-graph files (``save_pose_graph`` / ``load_pose_graph``: the
``PoseGraph`` fields by name, float32 poses, int32 counts and indices)
too.
"""

from __future__ import annotations

import numpy as np
import torch

from openekfmonoslam_tpu_torch.filter.state import (SlamState,
                                                    state_from_numpy,
                                                    state_to_numpy)
from openekfmonoslam_tpu_torch.graph.pose_graph import PoseGraph

_FIELDS = SlamState._fields


def save_checkpoint(path: str, state: SlamState) -> None:
    np.savez_compressed(path, **state_to_numpy(state))


def load_checkpoint(path: str, like: SlamState | None = None) -> SlamState:
    """Load a checkpoint onto ``like``'s device (the CPU without one).
    ``like`` (e.g. a fresh make_initial_state) pins shapes and dtypes: a
    field missing from the file is filled from ``like``, every field's
    shape must be ``like``'s, and its dtype becomes ``like``'s."""
    want = state_to_numpy(like) if like is not None else None
    with np.load(path) as data:
        arrays = {}
        for f in _FIELDS:
            if f in data:
                arrays[f] = data[f]
            elif want is not None:
                arrays[f] = want[f]
            else:
                raise KeyError(
                    f"checkpoint misses field {f!r} and no ``like`` state "
                    "was provided to fill it")
    if want is not None:
        for f in _FIELDS:
            got = arrays[f]
            if tuple(want[f].shape) != tuple(got.shape):
                raise ValueError(
                    f"checkpoint field {f} has shape {got.shape}, "
                    f"expected {want[f].shape}")
            arrays[f] = got.astype(want[f].dtype)
    device = like.x.device if like is not None else torch.device("cpu")
    return state_from_numpy(arrays, device)


def save_pose_graph(path: str, graph: PoseGraph) -> None:
    """Checkpoint the keyframe pose graph beside the filter state."""
    np.savez_compressed(path, **{f: getattr(graph, f).cpu().numpy()
                                 for f in PoseGraph._fields})


def load_pose_graph(path: str, device=None) -> PoseGraph:
    """A pose graph from ``save_pose_graph`` (of either package), on
    ``device`` (the CPU without one)."""
    with np.load(path) as data:
        return PoseGraph(**{f: torch.as_tensor(data[f], device=device)
                            for f in PoseGraph._fields})


def reset_map(state: SlamState, init_like: SlamState) -> SlamState:
    """Relocalization hook: drop the whole map, keep the camera pose and
    velocities, reinitialize the covariance (resetEKFMap,
    MapManagement.cpp:263-275)."""
    x = torch.cat([state.x[:13], init_like.x[13:]])
    return init_like._replace(x=x, P=init_like.P, frame=state.frame,
                              rng=state.rng)
