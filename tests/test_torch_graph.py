"""The keyframe pose graph and loop closure of the port (``graph/``, the
engine's ``keyframe_every`` and the pose-graph checkpoints) against the
JAX package.

- ``tests/test_pose_graph.py``'s nine cases and
  ``tests/test_loop_closure.py::test_pnp_recovers_pose`` through the port.
- ``optimize`` and ``pnp_gauss_newton`` against the JAX functions on the
  same inputs: within 1e-9 in float64 and 1e-4 in float32.  The edge and
  PnP Jacobians are ``torch.func.jacfwd`` under ``vmap``, through the
  same implicit derivative of the re-distortion as ``jax.jacfwd``.
- Pose-graph checkpoints saved by each package and loaded by the other.

The engines over the loop-closure scenario are
tests/test_torch_loop_closure.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.core.camera import Camera as JCamera
from openekfmonoslam_tpu.engine import checkpoint as jckpt
from openekfmonoslam_tpu.graph import loop_closure as jlc
from openekfmonoslam_tpu.graph import pose_graph as jpg
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.core import camera as tcam
from openekfmonoslam_tpu_torch.core import quaternion as tquat
from openekfmonoslam_tpu_torch.engine import checkpoint as tckpt
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine as TEngine
from openekfmonoslam_tpu_torch.graph import loop_closure as tlc
from openekfmonoslam_tpu_torch.graph import (add_keyframe, add_loop_edge,
                                             make_pose_graph, optimize,
                                             relative_pose)
from openekfmonoslam_tpu_torch.graph.pose_graph import total_error

TOL = {"float64": 1e-9, "float32": 1e-4}
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}


def qz(angle, dtype=torch.float32):
    """Quaternion for a rotation about +z."""
    return torch.tensor([np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)],
                        dtype=dtype)


def f64(*v):
    return torch.tensor(v, dtype=torch.float64)


# ---------------------------------------------------------------------------
# tests/test_pose_graph.py through the port
# ---------------------------------------------------------------------------


class TestRelativePose:
    def test_identity(self):
        r = torch.tensor([1.0, 2.0, 3.0])
        q = qz(0.3)
        dr, dq = relative_pose(r, q, r, q)
        assert np.allclose(dr, 0, atol=1e-6)
        assert np.allclose(np.abs(dq[0]), 1, atol=1e-6)

    def test_translation_in_local_frame(self):
        q = qz(np.pi / 2)
        dr, _ = relative_pose(torch.zeros(3), q, torch.tensor([1.0, 0, 0]),
                              q)
        # world +x in a frame rotated +90 deg about z is -y
        assert np.allclose(dr, [0.0, -1.0, 0.0], atol=1e-6)


class TestBookkeeping:
    def test_keyframes_and_odometry_edges(self):
        g = make_pose_graph(max_nodes=8, max_edges=8)
        g = add_keyframe(g, torch.zeros(3), qz(0.0))
        g = add_keyframe(g, torch.tensor([1.0, 0, 0]), qz(0.1))
        g = add_keyframe(g, torch.tensor([2.0, 0, 0]), qz(0.2))
        assert int(g.n_nodes) == 3
        assert int(g.n_edges) == 2          # the first keyframe has none
        assert g.edge_ij[:2].tolist() == [[0, 1], [1, 2]]
        assert np.allclose(g.edge_dr[0], [1.0, 0, 0], atol=1e-6)
        assert g.n_nodes.dtype == g.edge_ij.dtype == torch.int32

    def test_capacity_is_masked_noop(self):
        g = make_pose_graph(max_nodes=2, max_edges=1)
        for i in range(4):
            g = add_keyframe(g, torch.tensor([float(i), 0, 0]), qz(0.0))
        assert int(g.n_nodes) == 2
        assert int(g.n_edges) == 1
        assert torch.isfinite(g.node_r).all()


def square_loop_graph(dtype=torch.float64):
    """tests/test_pose_graph.py's drifted square: odometry edges measure
    perfect 1 m legs with 90 deg turns, the node poses carry drift, and a
    loop edge ties node 4 back to node 0.  Returns (graph, true poses)."""
    true, r, ang = [], np.zeros(3), 0.0
    for _ in range(5):
        true.append((r.copy(), ang))
        r = r + np.array([np.cos(ang), np.sin(ang), 0.0])
        ang += np.pi / 2
    est, r, ang = [], np.zeros(3), 0.0
    for _ in range(5):
        est.append((r.copy(), ang))
        r = r + 1.06 * np.array([np.cos(ang), np.sin(ang), 0.0])
        ang += np.pi / 2 + 0.03
    g = make_pose_graph(max_nodes=8, max_edges=16, dtype=dtype)
    for r_e, a_e in est:
        g = add_keyframe(g, torch.tensor(r_e), qz(a_e, dtype))
    edge_dr, edge_dq = g.edge_dr.clone(), g.edge_dq.clone()
    for e in range(4):
        (r_a, a_a), (r_b, a_b) = true[e], true[e + 1]
        dr, dq = relative_pose(torch.tensor(r_a, dtype=dtype),
                               qz(a_a, dtype),
                               torch.tensor(r_b, dtype=dtype),
                               qz(a_b, dtype))
        edge_dr[e], edge_dq[e] = dr, dq
    g = g._replace(edge_dr=edge_dr, edge_dq=edge_dq)
    dr, dq = relative_pose(torch.tensor(true[4][0], dtype=dtype),
                           qz(true[4][1], dtype),
                           torch.tensor(true[0][0], dtype=dtype),
                           qz(true[0][1], dtype))
    g = add_loop_edge(g, 4, 0, dr, dq,
                      info=10.0 * torch.eye(6, dtype=dtype))
    return g, true


class TestOptimize:
    def test_perfect_graph_unchanged(self):
        g = make_pose_graph(max_nodes=8, max_edges=8)
        poses = [(torch.tensor([float(i), 0, 0]), qz(0.1 * i))
                 for i in range(4)]
        for r, q in poses:
            g = add_keyframe(g, r, q)
        assert float(total_error(g)) < 1e-10
        g2 = optimize(g, iterations=3)
        for i, (r, _) in enumerate(poses):
            assert np.allclose(g2.node_r[i], r, atol=1e-4)

    def test_loop_closure_redistributes_drift(self):
        g, true = square_loop_graph()
        end_before = float(torch.linalg.vector_norm(
            g.node_r[4] - torch.tensor(true[4][0])))
        e_before = float(total_error(g))
        g2 = optimize(g, iterations=15)
        e_after = float(total_error(g2))
        end_after = float(torch.linalg.vector_norm(
            g2.node_r[4] - torch.tensor(true[4][0])))
        assert e_after < e_before * 1e-2
        assert end_after < end_before * 0.2
        assert np.allclose(g2.node_r[0], 0.0, atol=1e-9)   # gauge held

    def test_jit_and_masked_capacity(self):
        """Inactive node and edge slots stay untouched (the JAX case also
        jits; the port runs eagerly)."""
        g = make_pose_graph(max_nodes=16, max_edges=16)
        g = add_keyframe(g, torch.zeros(3), qz(0.0))
        g = add_keyframe(g, torch.tensor([1.0, 0, 0]), qz(0.0))
        g2 = optimize(g, iterations=2)
        assert torch.isfinite(g2.node_r).all()
        assert torch.isfinite(g2.node_q).all()
        assert np.allclose(g2.node_q[5], [1, 0, 0, 0], atol=1e-9)


def small_scene_frames(rng, n=7):
    big = np.kron(rng.integers(0, 255, (40, 44)),
                  np.ones((4, 4))).astype(np.uint8)
    return [big[20:140, 20 + i:148 + i] for i in range(n)]


class TestEngineIntegration:
    def test_engine_collects_keyframes(self, rng):
        cfg = tcfg.SlamConfig(max_features=12, max_keypoints=64,
                              max_hypotheses=12)
        eng = TEngine(cfg, keyframe_every=2, keyframe_capacity=16,
                      device="cpu")
        frames = small_scene_frames(rng)
        eng.init(frames[0])
        for f in frames[1:]:
            eng.step(f)
        assert int(eng.pose_graph.n_nodes) == 3      # frames 2, 4, 6
        assert int(eng.pose_graph.n_edges) == 2
        assert eng.keyframe_frames == [2, 4, 6]
        kf = eng.optimize_pose_graph(iterations=2)
        assert kf.shape == (3, 3) and np.isfinite(kf).all()

    def test_pose_graph_checkpoint_roundtrip(self, tmp_path):
        g = make_pose_graph(max_nodes=8, max_edges=8)
        g = add_keyframe(g, torch.zeros(3), qz(0.0))
        g = add_keyframe(g, torch.tensor([1.0, 0, 0]), qz(0.2))
        p = str(tmp_path / "graph.npz")
        tckpt.save_pose_graph(p, g)
        g2 = tckpt.load_pose_graph(p)
        for f in g._fields:
            assert torch.equal(getattr(g, f), getattr(g2, f)), f


def test_pnp_recovers_pose(rng):
    """Gauss-Newton PnP recovers a known pose from exact projections."""
    cam = tcam.Camera.from_calibration(tcfg.CameraCalibration())
    r_true = f64(0.12, -0.05, 0.08)
    q_true = tquat.normalize(f64(0.99, 0.05, -0.08, 0.03))
    xyz = torch.tensor(rng.uniform([-0.8, -0.6, 1.2], [0.8, 0.6, 3.0],
                                   size=(24, 3)))
    p = (xyz - r_true) @ tquat.to_rotation_matrix(q_true)
    uv = tcam.distort(cam, tcam.project(cam, p))
    r0 = r_true + f64(0.05, -0.04, 0.06)
    r, q, rms, n, Hinfo = tlc.pnp_gauss_newton(
        cam, xyz, uv, torch.ones(24, dtype=torch.bool), r0,
        f64(1.0, 0.0, 0.0, 0.0))
    np.testing.assert_allclose(r.numpy(), r_true.numpy(), atol=1e-8)
    assert float(rms) < 1e-6
    assert int(n) == 24
    assert np.linalg.eigvalsh(Hinfo.numpy()).min() > 0


# ---------------------------------------------------------------------------
# optimize and pnp_gauss_newton against the JAX functions
# ---------------------------------------------------------------------------


def random_graph(seed, dtype):
    """A 12-keyframe random walk with drifted node poses, noisy odometry
    measurements and two stiff loop edges (PnP-like information), in
    capacity 16 x 48."""
    rng = np.random.default_rng(seed)
    g = make_pose_graph(max_nodes=16, max_edges=48, dtype=dtype)
    r = np.zeros(3)
    q = np.asarray([1.0, 0, 0, 0])
    for _ in range(12):
        g = add_keyframe(g, torch.tensor(r), torch.tensor(q),
                         torch.diag(torch.tensor(
                             [1e3] * 3 + [1e4] * 3, dtype=dtype)))
        r = r + rng.normal(0, 0.2, 3)
        q = tquat.normalize(tquat.multiply(
            torch.tensor(q), tquat.from_axis_angle(
                torch.tensor(rng.normal(0, 0.1, 3))))).numpy()
    # the measurements disagree with the drifted poses
    noise = torch.tensor(rng.normal(0, 0.02, (48, 3)), dtype=dtype)
    g = g._replace(edge_dr=g.edge_dr + noise * g.edge_active[:, None])
    for i, j in ((0, 10), (2, 11)):
        dr, dq = relative_pose(g.node_r[i], g.node_q[i], g.node_r[j],
                               g.node_q[j])
        A = rng.normal(size=(6, 6))
        info = torch.tensor(A @ A.T * 1e5 + np.eye(6) * 1e6, dtype=dtype)
        g = add_loop_edge(g, i, j, dr + 0.1, dq, info)
    return g


def to_jax_graph(g):
    return jpg.PoseGraph(**{f: jnp.asarray(getattr(g, f).numpy())
                            for f in g._fields})


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["square", "random"])
def test_optimize_against_jax(case, dtype):
    tdt, _ = DTYPES[dtype]
    g = (square_loop_graph(tdt)[0] if case == "square"
         else random_graph(0, tdt))
    want = jpg.optimize(to_jax_graph(g), iterations=12)
    got = optimize(g, iterations=12)
    assert got.node_r.dtype == tdt
    for f in ("node_r", "node_q"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=TOL[dtype], err_msg=f)
    e0, e1 = float(total_error(g)), float(total_error(got))
    assert e1 < e0
    assert abs(e1 - float(jpg.total_error(want))) <= TOL[dtype] * e0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("outliers", [0, 6])
def test_pnp_against_jax(dtype, outliers):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5 + outliers)
    calib = tcfg.CameraCalibration()
    tcam_ = tcam.Camera.from_calibration(calib)
    jcam_ = JCamera.from_calibration(jcfg.CameraCalibration(), jdt)
    r_true = f64(0.12, -0.05, 0.08)
    q_true = tquat.normalize(f64(0.99, 0.05, -0.08, 0.03))
    xyz = torch.tensor(rng.uniform([-0.8, -0.6, 1.2], [0.8, 0.6, 3.0],
                                   size=(30, 3)))
    p = (xyz - r_true) @ tquat.to_rotation_matrix(q_true)
    uv = tcam.distort(tcam_, tcam.project(tcam_, p))
    uv = uv + torch.tensor(rng.normal(0, 0.3, uv.shape))
    uv[:outliers] += torch.tensor(rng.uniform(20, 40, (outliers, 2)))
    valid = torch.tensor(rng.uniform(size=30) > 0.1)
    r0 = r_true + f64(0.05, -0.04, 0.06)
    q0 = f64(1.0, 0.0, 0.0, 0.0)
    args = [xyz, uv, valid, r0, q0]
    got = tlc.pnp_gauss_newton(tcam_, *[a.to(tdt) if a.is_floating_point()
                                        else a for a in args])
    want = jax.jit(jlc.pnp_gauss_newton)(
        jcam_, *[jnp.asarray(a.numpy(), jdt) if a.is_floating_point()
                 else jnp.asarray(a.numpy()) for a in args])
    names = ("r", "q", "rms", "n_used", "H")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=TOL[dtype] * scale, err_msg=name)
    assert int(got[3]) == int(want[3])


def test_match_2d3d_breaks_ties_as_top_k():
    """Integer Hamming distances tie: the lower keypoint index wins, as in
    ``lax.top_k``."""
    rng = np.random.default_rng(3)
    kf = rng.integers(0, 2 ** 31, (12, 8), dtype=np.int64).astype(np.int32)
    kp = np.concatenate([kf[:6], kf[:6], rng.integers(
        0, 2 ** 31, (20, 8), dtype=np.int64).astype(np.int32)])
    kp_valid = np.ones(32, bool)
    kp_valid[2] = False
    kf_valid = np.ones(12, bool)
    from openekfmonoslam_tpu.vision import brief as jbrief
    from openekfmonoslam_tpu_torch.vision import brief as tbrief
    got = tlc.match_2d3d(torch.tensor(kf), torch.tensor(kf_valid),
                         torch.tensor(kp), torch.tensor(kp_valid),
                         tbrief.hamming_distance, max_distance=300)
    want = jlc.match_2d3d(jnp.asarray(kf.view(np.uint32)),
                          jnp.asarray(kf_valid),
                          jnp.asarray(kp.view(np.uint32)),
                          jnp.asarray(kp_valid), jbrief.hamming_distance,
                          max_distance=300)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0][2] and int(got[1][2]) == 8      # the tie at d = 0


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def test_pose_graph_checkpoint_from_jax_loads_in_the_port(tmp_path):
    g = jpg.make_pose_graph(max_nodes=8, max_edges=8)
    g = jpg.add_keyframe(g, jnp.zeros(3), jnp.asarray([1.0, 0, 0, 0]))
    g = jpg.add_keyframe(g, jnp.asarray([1.0, 0.5, 0]),
                         jnp.asarray([0.99, 0.0, 0.0, 0.141]))
    g = jpg.add_loop_edge(g, 1, 0, jnp.ones(3), jnp.asarray([1.0, 0, 0, 0]))
    path = str(tmp_path / "jax.graph.npz")
    jckpt.save_pose_graph(path, g)
    got = tckpt.load_pose_graph(path)
    for f in g._fields:
        want = np.asarray(getattr(g, f))
        assert getattr(got, f).numpy().dtype == want.dtype, f
        np.testing.assert_array_equal(getattr(got, f).numpy(), want, f)
    # the port continues the loaded graph
    assert int(add_keyframe(got, torch.ones(3), qz(0.1)).n_nodes) == 3


def test_pose_graph_checkpoint_from_the_port_loads_in_jax(tmp_path):
    g = random_graph(2, torch.float32)
    path = str(tmp_path / "port.graph.npz")
    tckpt.save_pose_graph(path, g)
    got = jckpt.load_pose_graph(path)
    for f in g._fields:
        want = getattr(g, f).numpy()
        assert np.asarray(getattr(got, f)).dtype == want.dtype, f
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), want, f)
    np.testing.assert_allclose(
        np.asarray(jpg.optimize(got, iterations=5).node_r),
        optimize(g, iterations=5).node_r.numpy(), rtol=0, atol=1e-4)
