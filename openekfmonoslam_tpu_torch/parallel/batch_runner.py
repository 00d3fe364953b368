"""B camera streams through one frame step (port of parallel/batch_runner.py).

Production serving runs one filter per camera stream.  Here B streams
share each step: every field of the state gains a leading (B,) axis, and
the step's phases (``SlamRuntime.phase_*``) run under ``torch.func.vmap``,
so each PyTorch op is dispatched once for the B streams.  On the GPU every
hand-written kernel of the path (predict, measure, the fused update, the
S-inverse, STAR, BRIEF and the add path's init (A) and (B)) is reached
through its ``torch.library`` custom op, whose vmap rule makes ONE launch
(set) with a stream index in its grid (ops/batched.py): the launches a
batched frame
makes do not grow with B, and each stream's bits are those of its own
single-stream launch.  The streams never exchange data.

Rare paths are gated at batch level, as the JAX package's
``lax.cond(jnp.any(...))`` does: the conversion runs masked per stream on
the device (as the single-stream step runs it), and the batch reads back
(any stream needs features?, each stream's need) once a frame, its one
host sync.  Detection and addition then run for all streams when any
needs features, with the largest count's picks and each stream stopped at
its own count (``detect.select_zone_balanced``'s ``limit``); a stream that
did not trigger has its candidates masked off, so its state passes through
bit for bit and its record's ``new_uv`` is zeros.

Scope: every configuration the single-stream step runs, as the JAX
package's batched step vmaps them all: every detector (FAST, STAR, ORB,
SIFT, SURF, HARRIS, SHI_TOMASI) and descriptor (BRIEF, ORB, SURF-64,
PATCH), the descriptor and the NCC matchers, the parity modes and the
large map.  On the card the update takes the fused kernel where it
applies, and otherwise (the large map, N = 1024; every update of the
parity mode) the chain whose S^-1 is the S-inverse kernels' batched
launch (ops/sinv.py), one launch set for B streams.  The front ends'
PyTorch chains (ORB's pyramid, the DoG / DoH scale spaces, Harris, the
SURF-64 descriptors, NCC's correlation) run under vmap as they are.

Meshes (torch.distributed, parallel/multihost.py): with ``mesh`` the
streams are split over its axis ``axis`` ("d"); each rank's states hold
its ``multihost.local_batch_slice`` of them (``make_batch_states(...,
mesh=mesh)``), it is given every stream's frames and runs its own slice,
and the ranks exchange nothing.  The two-axis layout
(``make_batched_step_2d``, ``batch_state_shardings_2d``) splits the
streams over ``d_axis`` and each stream's P into row strips over
``p_axis`` (parallel/sharding.py); a rank steps its streams through the
sharded step one after another.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from openekfmonoslam_tpu_torch.engine.scan_runner import stack_records
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime, StepRecord
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter.state import SlamState
from openekfmonoslam_tpu_torch.parallel import multihost, sharding
from openekfmonoslam_tpu_torch.spans import span


def make_batch_states(runtime: SlamRuntime, batch: int, seeds=None,
                      mesh=None, axis: str = "d",
                      p_axis: str | None = None) -> SlamState:
    """A SlamState whose every field gains a leading (B,) axis, each with
    its single-stream dtype (the descriptor slots int32 words for binary
    descriptors, float32 for SURF-64 and PATCH); ``seeds`` (B ints) sets
    each stream's ``rng`` (filter/state.py's int64 seed).  With ``mesh``:
    this rank's slice of the B streams over ``axis``, and with ``p_axis``
    each stream's P is this rank's rows of it over that axis."""
    base = runtime.make_initial_state()
    if p_axis is not None:
        base = sharding.shard_state(base, mesh, p_axis)
    if seeds is not None:
        seeds = list(seeds)
        if len(seeds) != batch:
            raise ValueError(f"seeds: {batch} expected, got {len(seeds)}")
    if mesh is not None:
        local = multihost.local_batch_slice(batch, mesh, axis)
        batch = local.stop - local.start
        seeds = seeds[local] if seeds is not None else None
    states = SlamState(*(t.expand((batch,) + tuple(t.shape)).contiguous()
                         for t in base))
    if seeds is not None:
        states = states._replace(rng=torch.as_tensor(
            seeds, dtype=torch.int64, device=runtime.device))
    return states


def _local(batch, mesh, axis: str):
    """This rank's slice over ``mesh``'s ``axis`` of a stream batch (all of
    it without a mesh)."""
    if mesh is None:
        return batch
    return batch[multihost.local_batch_slice(len(batch), mesh, axis)]


def batched_init_recorded(runtime: SlamRuntime, states: SlamState, grays):
    """``init_step_recorded`` over the stream axis: (states, uv, ok, slot),
    the last three (B, C, ...) (each stream's bootstrap features, the
    entry of its injection log)."""
    return vmap(runtime.init_step_recorded)(states, runtime._tensor(grays))


def make_batched_init(runtime: SlamRuntime, mesh=None, axis: str = "d"):
    """``init_step`` over the stream axis: (states, grays (B, H, W)) ->
    states; with ``mesh``, this rank's states and slice of the B frames."""
    def batched_init(states: SlamState, grays) -> SlamState:
        return batched_init_recorded(runtime, states,
                                     _local(grays, mesh, axis))[0]

    return batched_init


def batched_step(runtime: SlamRuntime, states: SlamState, grays
                 ) -> tuple[SlamState, StepRecord]:
    """The frame step over a leading (B,) stream axis, rare paths gated at
    batch level; ``grays`` (B, H, W).  Returns (states, records), each
    record field with a leading (B,) axis.  Each phase is a ``step.<phase>``
    span, as in ``SlamRuntime.step``, with the same spans inside it."""
    rt = runtime
    cfg = rt.config
    C, F = cfg.max_features, cfg.max_features
    with span("batch.upload"):
        grays = rt._tensor(grays)
    B = grays.shape[0]
    with span("step.predict"):
        states, pred = vmap(rt.phase_predict)(states)
    with span("step.match"):
        m, aux, in_ellipse = vmap(rt.phase_match)(states, pred, grays)
    with span("step.ransac"):
        res = vmap(rt.phase_ransac)(states, pred, m)
    with span("step.update_li"):
        states = vmap(rt.phase_update_li)(states, pred, m, res.inliers)
    with span("step.rescue"):
        pred2, rescued = vmap(rt.phase_rescue)(states, m, res.outliers)
    with span("step.update_hi"):
        states = vmap(rt.phase_update_hi)(states, pred2, m, rescued)
    with span("step.mapman"):
        states, do_mm, needed = vmap(rt.mapman_maintain)(
            states, pred, m, res.inliers | rescued)
        with span("mapman.convert"):
            states = vmap(rt.convert_feature)(states, do_mm)

        # the batch's one host read: which streams need features, and how
        # many each
        flags = do_mm & (needed > 0)
        with span("read.add"):
            wants, counts = torch.stack([flags.to(torch.int32),
                                         needed]).tolist()
        dev = rt.device
        if not any(wants):
            new_uv = torch.zeros((B, C, 2), dtype=rt.dtype, device=dev)
            new_ok = torch.zeros((B, C), dtype=torch.bool, device=dev)
            new_slot = torch.full((B, C), F, dtype=torch.int32, device=dev)
        else:
            n_iter = max(min(n, C) for w, n in zip(wants, counts) if w)
            limit = torch.clamp(needed, 0, C)
            cand_uv, cand_desc, cand_valid = vmap(
                lambda st, pr, ax, ie, lim: rt.detect_candidates(
                    st, pr, ax, ie, n_iter, lim))(states, pred, aux,
                                                  in_ellipse, limit)
            with span("mapman.add"):
                cand_uv = cand_uv.to(rt.dtype)
                cand_valid = cand_valid & flags[:, None]
                new_slot, new_ok = vmap(feat_mod.assign_slots)(
                    states.active, cand_valid)
                states = vmap(lambda st, uv, de, sl, ok:
                              feat_mod._add_features_impl(
                                  st, rt.camera, cfg, uv, de, sl, ok))(
                    states, cand_uv, cand_desc, new_slot, new_ok)
                new_uv = torch.where(flags[:, None, None], cand_uv,
                                     torch.zeros_like(cand_uv))
    records = vmap(rt.make_record)(states, pred, m, res, rescued, new_uv,
                                   new_ok, new_slot)
    return states, records


def make_batched_step(runtime: SlamRuntime, mesh=None, axis: str = "d"):
    """(states, grays (B, H, W)) -> (states, records): ``batched_step``
    bound to ``runtime``; with ``mesh``, on this rank's states and slice
    of the B frames."""
    def step(states: SlamState, grays) -> tuple[SlamState, StepRecord]:
        return batched_step(runtime, states, _local(grays, mesh, axis))

    return step


def scan_batched_sequences(runtime: SlamRuntime, states: SlamState, frames,
                           mesh=None, axis: str = "d"
                           ) -> tuple[SlamState, StepRecord]:
    """B sequences stepped together: ``frames`` (B, T, H, W) uploaded once
    (with ``mesh``, this rank's slice of them, for its states); returns
    the final states and the records stacked with leading (T, B) axes."""
    frames = runtime._tensor(_local(frames, mesh, axis))
    records = []
    for t in range(frames.shape[1]):
        states, rec = batched_step(runtime, states, frames[:, t])
        records.append(rec)
    return states, stack_records(records)


def batch_state_shardings_2d(mesh, d_axis: str = "d",
                             p_axis: str = "p") -> SlamState:
    """The placements of the two-axis layout: every field's stream axis
    over ``d_axis``, and P (B, N, N) also row-split over ``p_axis``; the
    rest is replicated within a stream's ``p_axis`` group."""
    by_stream = sharding.placements(mesh, {d_axis: 0})
    return SlamState(*(sharding.placements(mesh, {d_axis: 0, p_axis: 1})
                       if name == "P" else by_stream
                       for name in SlamState._fields))


def _streams(states: SlamState) -> list[SlamState]:
    """The streams of a batched state, one state each."""
    return [SlamState(*(f[b] for f in states))
            for b in range(states.x.shape[0])]


def _stacked(states: list[SlamState]) -> SlamState:
    return SlamState(*(torch.stack(f) for f in zip(*states)))


def make_batched_init_2d(runtime: SlamRuntime, mesh, d_axis: str = "d",
                         p_axis: str = "p"):
    """(states, grays (B, H, W)) -> states in the two-axis layout: this
    rank's streams (``make_batch_states(..., mesh=mesh, axis=d_axis,
    p_axis=p_axis)``) through the sharded ``init_step``.  The callable's
    ``runtime`` is the ``ShardedRuntime`` it runs."""
    srt = sharding._sharded_runtime(runtime, mesh, p_axis)

    def init(states: SlamState, grays) -> SlamState:
        grays = srt._tensor(_local(grays, mesh, d_axis))
        return _stacked([srt.init_step(st, g)
                         for st, g in zip(_streams(states), grays)])

    init.runtime = srt
    return init


def make_batched_step_2d(runtime: SlamRuntime, mesh, d_axis: str = "d",
                         p_axis: str = "p"):
    """(states, grays (B, H, W)) -> (states, records) in the two-axis
    layout: this rank's streams, each with P row-split over ``p_axis``,
    through the sharded step one after another (records with a leading
    axis of this rank's streams).  The callable's ``runtime`` is the
    ``ShardedRuntime`` it runs."""
    srt = sharding._sharded_runtime(runtime, mesh, p_axis)

    def step(states: SlamState, grays) -> tuple[SlamState, StepRecord]:
        grays = srt._tensor(_local(grays, mesh, d_axis))
        outs = [srt.step(st, g) for st, g in zip(_streams(states), grays)]
        return (_stacked([o[0] for o in outs]),
                stack_records([o[1] for o in outs]))

    step.runtime = srt
    return step
