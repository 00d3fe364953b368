"""The port's sharded step (parallel/sharding.py) on gloo ranks against the
JAX package's single-device run, in float64.

The scenario is tests/test_sharded_equivalence.py's churn run (160x120,
F = 24, ``pad_state_to`` 128, so N = 256, 13 frames from numpy seed 3):
adds, culls, conversions and chi-square rescues all fire.  Each case runs
the port's ``make_sharded_init`` / ``make_sharded_step`` (or their 2-D
forms) on 4 spawned CPU ranks over gloo, P in row strips or (p, q)
tiles: p = 2, p = 4, (p, q) = (2, 2), the dense H P layout at p = 2, and
the parity mode at p = 2 over 6 frames (the p = 2 cases on the "p" axis
of a ("d", "p") = (2, 2) mesh, its two "d" groups at once).  The bounds are the JAX test's own:
each frame's ``x_cam`` within 1e-9 and every count equal, the final x
within 1e-9, the gathered P within rtol 1e-7 and atol 1e-9, ``active``
and ``is_xyz`` equal.  The ranks' replicated state and records must agree
bit for bit every frame, and no step collective may carry N x N elements
or more, nor a step's collectives 4 N^2 x 8 bytes.

The rank function lives here; JAX is imported only inside fixtures, so the
spawned ranks (which import this module) never load it.
"""

import contextlib
import dataclasses
import hashlib
import multiprocessing
import queue
import socket
import time
import types

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
from openekfmonoslam_tpu_torch.filter.state import state_from_numpy
from openekfmonoslam_tpu_torch.io.sources import SlidingWindowSource
from openekfmonoslam_tpu_torch.parallel import multihost, sharding

N_FRAMES = 13
PARITY_FRAMES = 6
JOIN_S = 240.0
WORLD = 4
# case: (mesh axes P is split over, their sizes, config overrides,
# frames).  The p = 2 cases run on the two "d" groups of a ("d", "p") =
# (2, 2) mesh at once, group 0 the first two, group 1 the third; p = 4
# and (2, 2) on all four ranks.
CASES = {
    "p2": (("p",), (2,), {}, N_FRAMES),
    "parity_p2": (("p",), (2,), {"reference_quirks": True,
                                 "ransac_parity_visit": True},
                  PARITY_FRAMES),
    "dense_p2": (("p",), (2,), {"hp_layout": "dense"}, N_FRAMES),
    "p4": (("p",), (4,), {}, N_FRAMES),
    "p2q2": (("p", "q"), (2, 2), {}, N_FRAMES),
}
D_GROUPS = (("p2", "parity_p2"), ("dense_p2",))


def churn_config(mod, **overrides):
    """tests/test_sharded_equivalence.py's churn_cfg, from either package's
    config module."""
    cam = mod.CameraCalibration(
        pixels_x=160, pixels_y=120, fx=120.0, fy=120.0, cx=80.0, cy=60.0,
        k1=-0.01, k2=0.001, dx=0.01, dy=0.01, angular_vision_x=45.0,
        angular_vision_y=35.0)
    ekf = mod.EKFParams(min_matches_per_image=14,
                        detect_new_features_image_areas_divide_times=1,
                        good_feature_matching_percent=0.6,
                        inverse_depth_linearity_index_threshold=3.0,
                        always_remove_unseen_map_features=True)
    return mod.SlamConfig(
        camera=cam, ekf=ekf, max_features=24, max_keypoints=128,
        dtype="float64", pad_state_to=128,
        detector=dataclasses.replace(mod.SlamConfig().detector,
                                     threshold=12.0), **overrides)


def churn_frames() -> np.ndarray:
    rng = np.random.default_rng(3)
    img = np.zeros((240, 400), np.float32)
    for _ in range(140):
        y, x = rng.integers(6, 234), rng.integers(6, 394)
        s = rng.integers(2, 5)
        img[y - s:y + s, x - s:x + s] = rng.integers(60, 255)
    return np.stack(list(SlidingWindowSource(
        img.astype(np.uint8), (120, 160), step_xy=(2, 1),
        n_frames=N_FRAMES)))


def digest(state, record) -> str:
    """sha256 of a state's replicated fields and of its record."""
    h = hashlib.sha256()
    for name, t in list(state._asdict().items()) + list(
            record._asdict().items()):
        if name != "P":
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def run_case(mesh, axes, overrides, frames) -> dict:
    """One case on this rank, P split over ``mesh``'s ``axes``: the
    sharded init and steps, each step's collectives, the replicated
    state's digest a frame, and the whole state gathered at the end."""
    rt = SlamRuntime(churn_config(tcfg, **overrides), device="cpu")
    if len(axes) == 1:
        state = sharding.shard_state(rt.make_initial_state(), mesh, *axes)
        init = sharding.make_sharded_init(rt, mesh, *axes)
        step = sharding.make_sharded_step(rt, mesh, *axes)
    else:
        state = sharding.shard_state_2d(rt.make_initial_state(), mesh, axes)
        init = sharding.make_sharded_init_2d(rt, mesh, axes)
        step = sharding.make_sharded_step_2d(rt, mesh, axes)
    comm = step.__self__.tiling.comm
    state = init(state, frames[0])
    records, per_step, digests = [], [], []
    for f in frames[1:]:
        comm.reset()
        state, rec = step(state, f)
        per_step.append(comm.summary())
        digests.append(digest(state, rec))
        records.append({k: v.numpy() for k, v in rec._asdict().items()})
    full = sharding.gather_state(state, mesh, axes)
    return dict(records=records, per_step=per_step, digests=digests,
                state={k: v.numpy() for k, v in full._asdict().items()},
                local_shape=tuple(state.P.shape),
                hp_layout=step.__self__.hp_layout)


def rank_main(rank, world, port, frames, out):
    """A spawned rank of WORLD gloo ranks: its cases (D_GROUPS' of its
    "d" group, then p = 4 and (2, 2)); {case: result} (or a traceback)
    to ``out``."""
    torch.set_num_threads(1)
    try:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
        meshes = {(2,): init_device_mesh("cpu", (2, 2),
                                         mesh_dim_names=("d", "p")),
                  (4,): sharding.make_mesh("cpu"),
                  (2, 2): sharding.make_mesh_2d("cpu", (2, 2))}
        names = D_GROUPS[meshes[(2,)].get_local_rank("d")] + ("p4", "p2q2")
        results = {}
        for name in names:
            axes, shape, overrides, T = CASES[name]
            results[name] = run_case(meshes[shape], axes, overrides,
                                     frames[:T])
        torch.distributed.destroy_process_group()
        out.put((rank, results))
    except BaseException:
        import traceback
        out.put((rank, traceback.format_exc()))
        raise


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def spawned(target, world: int, *args):
    """Start ``target(rank, world, port, *args, out)`` on ``world``
    spawned ranks and yield a function that waits for {rank: result}, so
    the caller can work meanwhile.  Every rank is joined within JOIN_S or
    killed, and the test fails."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S

    def collect() -> dict:
        got = {}
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"ranks gave no result within {JOIN_S} s")
            try:
                rank, res = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                continue
            if isinstance(res, str):
                pytest.fail(f"rank {rank} failed:\n{res}")
            got[rank] = res
        return got

    try:
        yield collect
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def jax_reference(frames) -> dict:
    """The JAX package's jitted single-device run: {"blocks", "parity"} ->
    (final state fields, records), numpy."""
    import jax.numpy as jnp

    from openekfmonoslam_tpu import config as jcfg
    from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime

    def run(cfg, T):
        rt = JRuntime(cfg)
        init_fn, step_fn = rt.jitted()
        state = init_fn(rt.make_initial_state(), jnp.asarray(frames[0]))
        recs = []
        for f in frames[1:T]:
            state, rec = step_fn(state, jnp.asarray(f))
            recs.append({k: np.asarray(v) for k, v in rec._asdict().items()})
        return ({k: np.asarray(v) for k, v in state._asdict().items()},
                recs)

    return {"blocks": run(churn_config(jcfg), N_FRAMES),
            "parity": run(churn_config(jcfg, reference_quirks=True,
                                       ransac_parity_visit=True),
                          PARITY_FRAMES)}


@pytest.fixture(scope="module")
def frames():
    return churn_frames()


@pytest.fixture(scope="module")
def both(frames):
    """({case: {rank: result}} of the ranks that ran each case, the JAX
    reference), the reference computed while the ranks run."""
    with spawned(rank_main, WORLD, frames) as collect:
        reference = jax_reference(frames)
        got = collect()
    runs = {name: {r: res[name] for r, res in got.items() if name in res}
            for name in CASES}
    return runs, reference


@pytest.fixture(scope="module")
def runs(both):
    return both[0]


@pytest.fixture(scope="module")
def reference(both):
    return both[1]


def test_the_scenario_churns(reference):
    """Adds, culls, conversions and rescues fire in the reference run, as
    in tests/test_sharded_equivalence.py."""
    state, recs = reference["blocks"]
    active = np.asarray([int(r["n_active"]) for r in recs])
    assert active.max() > active.min(), active
    assert state["is_xyz"].any(), "no conversion happened"
    assert any(int(r["hi_inliers"]) > 0 for r in recs), "no rescue happened"
    assert any(r["new_ok"].any() for r in recs), "no feature added"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(case, runs, reference):
    ref_state, ref_recs = reference["parity" if "parity" in case
                                    else "blocks"]
    by_rank = runs[case]
    res = by_rank[min(by_rank)]
    assert len(res["records"]) == len(ref_recs)
    for i, (a, b) in enumerate(zip(ref_recs, res["records"])):
        np.testing.assert_allclose(b["x_cam"], a["x_cam"], rtol=0,
                                   atol=1e-9, err_msg=f"frame {i}")
        for k in ("total_matches", "li_inliers", "hi_inliers", "n_active"):
            assert int(a[k]) == int(b[k]), (i, k)
    st = res["state"]
    np.testing.assert_allclose(st["x"], ref_state["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(st["P"], ref_state["P"], rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_array_equal(st["active"], ref_state["active"])
    np.testing.assert_array_equal(st["is_xyz"], ref_state["is_xyz"])


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_bit_for_bit(case, runs):
    """Every rank's replicated state and records, every frame, and the
    gathered state equal rank 0's; each rank held its own tile."""
    by_rank = runs[case]
    shape = CASES[case][1]
    first = by_rank[min(by_rank)]
    n = churn_config(tcfg).padded_state_dim
    want = (n // shape[0], n // shape[1] if len(shape) > 1 else n)
    assert len(by_rank) == int(np.prod(shape)), sorted(by_rank)
    for r, res in by_rank.items():
        assert res["digests"] == first["digests"], r
        assert res["local_shape"] == want, (r, res["local_shape"])
        for k, v in res["state"].items():
            np.testing.assert_array_equal(v, first["state"][k],
                                          err_msg=f"rank {r}, {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_step_collectives(case, runs):
    """No step collective carries N x N elements, a step's bytes stay
    under 4 full P, and every collective is a summing all_reduce over a
    mesh axis (H P's twice a step)."""
    n = churn_config(tcfg).padded_state_dim
    axes = CASES[case][0]
    by_rank = runs[case]
    for step in by_rank[min(by_rank)]["per_step"]:
        assert 0 < step["largest_elements"] < n * n, step
        assert step["total_bytes"] < 4 * n * n * 8, step
        assert all(k.split("/")[0] == "all_reduce" for k in step["calls"])
        assert step["calls"]["all_reduce/p/hp"] == 2, step
        if len(axes) > 1:
            assert step["calls"]["all_reduce/q/hp"] == 2, step


def test_dense_layout_from_1024_dims():
    """The sharded runtime takes the dense H P layout from 13 + 6F >= 1024
    dims (the JAX package's crossover); the large map's 1021 keeps
    blocks."""
    mesh = types.SimpleNamespace(mesh_dim_names=("p",), shape=(1,),
                                 get_group=lambda a: None,
                                 get_local_rank=lambda a: 0)
    for F, layout in ((168, "blocks"), (169, "dense")):
        cfg = tcfg.SlamConfig(max_features=F)
        srt = sharding._sharded_runtime(SlamRuntime(cfg, device="cpu"),
                                        mesh, "p")
        assert srt.hp_layout == layout, (F, cfg.state_dim)


def test_state_shardings_describe_the_layout():
    mesh1 = types.SimpleNamespace(mesh_dim_names=("p",))
    sh = sharding.state_shardings(mesh1)
    assert sh.P == (sharding.Shard(0),)
    assert sh.x == (sharding.Replicate(),)
    mesh2 = types.SimpleNamespace(mesh_dim_names=("p", "q"))
    sh2 = sharding.state_shardings_2d(mesh2)
    assert sh2.P == (sharding.Shard(0), sharding.Shard(1))
    assert sh2.active == (sharding.Replicate(), sharding.Replicate())


@pytest.mark.parametrize("shape", [(3,), (32,), (2, 3)])
def test_a_tiling_that_does_not_fit_raises(shape):
    """N = 256 does not divide by 3, and 256 / 32 = 8 rows cannot hold the
    13 camera dims."""
    names = ("p", "q")[:len(shape)]
    mesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    state = SlamRuntime(churn_config(tcfg), device="cpu").make_initial_state()
    with pytest.raises(ValueError, match="does not tile"):
        if len(shape) == 1:
            sharding.shard_state(state, mesh)
        else:
            sharding.shard_state_2d(state, mesh)


def test_nccl_that_cannot_start_raises():
    """NCCL asked for on a machine without CUDA raises; it never falls back
    to gloo, and no process group is left started."""
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.initialize("127.0.0.1:1", 2, 0, backend="nccl",
                             device="cpu")
    with pytest.raises(RuntimeError):      # no device given: the card
        multihost.initialize("127.0.0.1:1", 2, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_shard_state_takes_a_jax_state(reference):
    """``shard_state_2d`` splits a whole state made from the JAX package's
    arrays (``state_from_numpy``); the tiles put together give it back."""
    state = state_from_numpy(reference["blocks"][0], "cpu")
    n = state.P.shape[0]
    tiles = []
    for i in range(2):
        for j in range(2):
            mesh = types.SimpleNamespace(
                mesh_dim_names=("p", "q"), shape=(2, 2),
                get_group=lambda a: None,
                get_local_rank=lambda a, i=i, j=j: i if a == "p" else j)
            local = sharding.shard_state_2d(state, mesh)
            assert local.P.shape == (n // 2, n // 2)
            torch.testing.assert_close(local.x, state.x, rtol=0, atol=0)
            tiles.append(local.P)
    whole = torch.cat([torch.cat(tiles[0:2], 1), torch.cat(tiles[2:4], 1)])
    assert torch.equal(whole, state.P)
