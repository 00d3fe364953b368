"""The port's process-group bring-up and host-aware mesh
(parallel/multihost.py) and the batch runner's mesh layouts
(parallel/batch_runner.py), on spawned gloo ranks on the CPU.

  * ``make_host_mesh`` on 4 ranks with LOCAL_WORLD_SIZE=2 is the (2, 2)
    ("d", "p") mesh; in one process it is (1, 1), as
    tests/test_batch_runner.py:122-130 checks for the JAX package.
  * The batched init, step and scan over that mesh's "d" axis: 4 streams
    over its 2 "d" groups (the 2 ranks of a group run theirs alike), each
    rank's streams equal to the single-process batched run's within 1e-9
    in float64 (tests/test_batch_runner.py:72-90).
  * ``make_batched_step_2d``: 2 streams over "d", each stream's P in row
    strips over "p", every stream within 1e-9 of its own single-stream run,
    and a sum of ``n_active`` across the "d" groups
    (tests/multiproc_worker.py:96-111).
"""

import multiprocessing
import os
import queue
import socket
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
from openekfmonoslam_tpu_torch.filter.state import SlamState
from openekfmonoslam_tpu_torch.parallel import batch_runner as br
from openekfmonoslam_tpu_torch.parallel import multihost, sharding
from openekfmonoslam_tpu_torch.vision import brief

JOIN_S = 240.0
STREAMS = 4
T = 4


def config() -> SlamConfig:
    return SlamConfig(max_features=12, max_keypoints=64, max_hypotheses=12,
                      dtype="float64")


def make_frames(b: int, t: int, h: int = 120, w: int = 128) -> np.ndarray:
    """B independent smoothed translation sequences (numpy seed 0)."""
    rng = np.random.default_rng(0)
    out = np.zeros((b, t, h, w), np.uint8)
    for i in range(b):
        big = np.kron(rng.integers(0, 255, (40, 44)), np.ones((4, 4)))
        big = brief.smooth(torch.as_tensor(big), 1.0).numpy()
        for j in range(t):
            out[i, j] = np.clip(big[20:20 + h, 20 + j:20 + j + w], 0, 255)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target, world: int, *args) -> dict:
    """Run ``target(rank, world, port, *args, out)`` on ``world`` spawned
    ranks; {rank: result}.  Every rank is joined within JOIN_S or killed,
    and the test fails."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + JOIN_S
    try:
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
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return got


def rank_main(rank, world, port, frames, out):
    """A spawned rank: ``host_ranks``' result (or its traceback) to
    ``out``."""
    torch.set_num_threads(1)
    try:
        out.put((rank, host_ranks(rank, world, port, frames)))
    except BaseException:
        import traceback
        out.put((rank, traceback.format_exc()))
        raise


def host_ranks(rank, world, port, frames):
    """4 ranks as 2 hosts of 2: the host mesh; then 4 streams over its "d"
    axis (batched init, step and scan, each "d" group's 2 ranks alike);
    then 2 streams over "d", each stream's P in row strips over "p"."""
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = multihost.make_host_mesh(device="cpu")
    rt = SlamRuntime(config(), device="cpu")
    res = dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
               coordinate=tuple(mesh.get_coordinate()),
               slice4=multihost.local_batch_slice(STREAMS, mesh),
               slice2=multihost.local_batch_slice(2, mesh))

    states = br.make_batch_states(rt, STREAMS, seeds=range(STREAMS),
                                  mesh=mesh)
    states = br.make_batched_init(rt, mesh)(states, frames[:, 0])
    stepped, rec = br.make_batched_step(rt, mesh)(states, frames[:, 1])
    scanned, recs = br.scan_batched_sequences(rt, states, frames[:, 1:],
                                              mesh)
    res.update(rng=stepped.rng.numpy(), x_step=stepped.x.numpy(),
               P_step=stepped.P.numpy(), matches=rec.total_matches.numpy(),
               x_scan=scanned.x.numpy(), n_active_scan=recs.n_active.numpy())

    states = br.make_batch_states(rt, 2, seeds=range(2), mesh=mesh,
                                  p_axis="p")
    states = br.make_batched_init_2d(rt, mesh)(states, frames[:2, 0])
    step = br.make_batched_step_2d(rt, mesh)
    for t in range(1, T):
        states, rec = step(states, frames[:2, t])
    whole = sharding.gather_state(SlamState(*(f[0] for f in states)), mesh)
    total = rec.n_active.sum()
    dist.all_reduce(total, group=mesh.get_group("d"))
    res.update(local_p=tuple(states.P.shape), x=whole.x.numpy(),
               P=whole.P.numpy(), n_active=rec.n_active.numpy(),
               total_n_active=int(total))
    dist.destroy_process_group()
    return res


@pytest.fixture(scope="module")
def frames():
    return make_frames(STREAMS, T)


@pytest.fixture(scope="module")
def ranks(frames):
    return spawn(rank_main, 4, frames)


@pytest.fixture
def one_thread():
    """The references below in one thread: the suite's other workers
    keep every core busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_process_is_one_host():
    """Without an address one process starts a world of its own: the
    host mesh is (1, 1)."""
    try:
        assert multihost.initialize(device="cpu") is False
        assert dist.is_initialized() and dist.get_world_size() == 1
        mesh = multihost.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("d", "p")
        assert multihost.local_batch_slice(8) == slice(0, 8)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_local_batch_slice():
    assert multihost.local_batch_slice(8) == slice(0, 8)   # no group
    mesh = types.SimpleNamespace(mesh_dim_names=("d", "p"), shape=(2, 2),
                                 get_local_rank=lambda a: 1)
    assert multihost.local_batch_slice(8, mesh) == slice(4, 8)
    with pytest.raises(ValueError):
        multihost.local_batch_slice(7, mesh)


def test_host_mesh(ranks):
    """4 ranks with LOCAL_WORLD_SIZE=2: (2, 2) ("d", "p"), ranks host by
    host."""
    for r, res in ranks.items():
        assert (res["shape"], res["names"]) == ((2, 2), ("d", "p"))
        d, p = res["coordinate"]
        assert (d, p) == divmod(r, 2)
        assert res["slice4"] == slice(2 * d, 2 * d + 2)
        assert res["slice2"] == slice(d, d + 1)


def test_d_mesh_batched_init_step_scan(ranks, frames, one_thread):
    """4 streams over the "d" axis: each rank's 2 streams equal the
    single-process batched run's."""
    rt = SlamRuntime(config(), device="cpu")
    states = br.make_batch_states(rt, STREAMS, seeds=range(STREAMS))
    states = br.make_batched_init(rt)(states, frames[:, 0])
    stepped, rec = br.make_batched_step(rt)(states, frames[:, 1])
    scanned, recs = br.scan_batched_sequences(rt, states, frames[:, 1:])
    for r, res in ranks.items():
        sl = res["slice4"]
        np.testing.assert_array_equal(res["rng"], range(sl.start, sl.stop))
        np.testing.assert_allclose(res["x_step"], stepped.x[sl].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(res["P_step"], stepped.P[sl].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(res["matches"],
                                      rec.total_matches[sl].numpy())
        np.testing.assert_allclose(res["x_scan"], scanned.x[sl].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(res["n_active_scan"],
                                      recs.n_active[:, sl].numpy())
    assert (recs.total_matches[-1] > 0).all()


def test_streams_by_row_strips(ranks, frames, one_thread):
    """make_batched_step_2d: each stream within 1e-9 of its single-stream
    run, and the cross-group sum of n_active."""
    rt = SlamRuntime(config(), device="cpu")
    singles = []
    for b in range(2):
        st = rt.init_step(rt.make_initial_state(), frames[b, 0])
        for t in range(1, T):
            st, rec = rt.step(st, frames[b, t])
        singles.append((st, int(rec.n_active)))
    n = rt.config.padded_state_dim
    for r, res in ranks.items():
        d, _ = res["coordinate"]
        assert res["local_p"] == (1, n // 2, n)
        st, _ = singles[d]
        np.testing.assert_allclose(res["x"], st.x.numpy(), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(res["P"], st.P.numpy(), rtol=0,
                                   atol=1e-9)
        assert int(res["n_active"][0]) == singles[d][1]
        assert res["total_n_active"] == sum(s[1] for s in singles) > 0


def test_batch_state_shardings_2d():
    mesh = types.SimpleNamespace(mesh_dim_names=("d", "p"))
    sh = br.batch_state_shardings_2d(mesh)
    assert sh.P == (sharding.Shard(0), sharding.Shard(1))
    assert sh.x == (sharding.Shard(0), sharding.Replicate())
