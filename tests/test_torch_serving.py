"""The port's serving daemon (``serving/server.py``) through the C client
library, loaded by ctypes as a host application links it.

- tests/test_serving.py's three C-client cases against the port's server
  with ``device="cpu"``: session lifecycle and tracking, two independent
  sessions, errors reported without killing the connection.
- The poses a session serves equal an in-process port ``SlamEngine``'s on
  the same frames bit for bit, and the JAX server's within 1e-9 in
  float64.
- ``SlamServer`` runs on the first CUDA device unless ``device="cpu"`` is
  given, and ``main`` takes ``--device``, ``--matcher ncc`` (PATCH) and
  ``--keyframe-every`` as the JAX daemon does.

The client library is ``native/ekf_client.c`` compiled here with ``gcc``
(the library is not in git).
"""

import ctypes
import subprocess
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.serving.server import SlamServer as JServer
from openekfmonoslam_tpu.vision import brief as jbrief
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine
from openekfmonoslam_tpu_torch.serving import server as tserver

REPO = Path(__file__).resolve().parent.parent


def make_frames(rng, n, h=480, w=640):
    big = np.kron(rng.integers(0, 255, ((h + 40) // 4, (w + 60) // 4)),
                  np.ones((4, 4))).astype(np.float32)
    big = np.asarray(jbrief.smooth(jnp.asarray(big), 1.0))
    return [np.clip(big[10:10 + h, 10 + i:10 + i + w], 0, 255
                    ).astype(np.uint8) for i in range(n)]


class EkfPose(ctypes.Structure):
    _fields_ = [("r", ctypes.c_double * 3), ("q", ctypes.c_double * 4),
                ("v", ctypes.c_double * 3), ("matches", ctypes.c_uint32),
                ("li_inliers", ctypes.c_uint32),
                ("hi_inliers", ctypes.c_uint32),
                ("map_size", ctypes.c_uint32)]


@pytest.fixture(scope="module")
def clib(tmp_path_factory):
    so = tmp_path_factory.mktemp("clib") / "libekfclient.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-std=gnu11",
                    str(REPO / "native" / "ekf_client.c"), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.ekf_connect.restype = ctypes.c_void_p
    lib.ekf_connect.argtypes = [ctypes.c_char_p]
    lib.ekf_create.restype = ctypes.c_int64
    lib.ekf_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ekf_init.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_char_p, ctypes.c_uint32,
                             ctypes.c_uint32]
    lib.ekf_step.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_char_p, ctypes.c_uint32,
                             ctypes.c_uint32, ctypes.POINTER(EkfPose)]
    lib.ekf_state.restype = ctypes.c_int64
    lib.ekf_state.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.c_size_t]
    lib.ekf_release.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ekf_last_error.restype = ctypes.c_char_p
    lib.ekf_last_error.argtypes = [ctypes.c_void_p]
    lib.ekf_disconnect.argtypes = [ctypes.c_void_p]
    return lib


def small_config(mod, dtype="float32"):
    return mod.SlamConfig(max_features=12, max_keypoints=64,
                          max_hypotheses=12, dtype=dtype)


def start(server, sock):
    ready = threading.Event()
    t = threading.Thread(target=server.serve, args=(sock, ready),
                         daemon=True)
    t.start()
    assert ready.wait(10)
    return t


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's daemon on the CPU; sessions take an in-memory config."""
    sock = str(tmp_path_factory.mktemp("srv") / "ekf.sock")
    srv = tserver.SlamServer(small_config(tcfg), device="cpu")
    thread = start(srv, sock)
    yield sock, srv
    srv.shutdown()
    thread.join(10)
    assert not thread.is_alive()


def served_poses(clib, sock, frames):
    """init + step over ``frames`` through the C client: the (T-1, 10)
    poses (r, q, v) and the final state vector."""
    c = clib.ekf_connect(sock.encode())
    assert c
    sid = clib.ekf_create(c, b"")
    assert sid > 0, clib.ekf_last_error(c)
    h, w = frames[0].shape
    assert clib.ekf_init(c, sid, frames[0].tobytes(), h, w) == 0
    pose, out = EkfPose(), []
    for f in frames[1:]:
        assert clib.ekf_step(c, sid, f.tobytes(), h, w,
                             ctypes.byref(pose)) == 0, clib.ekf_last_error(c)
        out.append(list(pose.r) + list(pose.q) + list(pose.v)
                   + [pose.matches, pose.map_size])
    buf = (ctypes.c_double * 4096)()
    n = clib.ekf_state(c, sid, buf, 4096)
    assert clib.ekf_release(c, sid) == 0
    clib.ekf_disconnect(c)
    return np.asarray(out), np.asarray(buf[:n])


class TestCClientEndToEnd:
    def test_session_lifecycle_and_tracking(self, clib, server, rng):
        sock, _ = server
        c = clib.ekf_connect(sock.encode())
        assert c
        sid = clib.ekf_create(c, b"")
        assert sid > 0
        frames = make_frames(rng, 5)
        h, w = frames[0].shape
        assert clib.ekf_init(c, sid, frames[0].tobytes(), h, w) == 0
        pose = EkfPose()
        for f in frames[1:]:
            rc = clib.ekf_step(c, sid, f.tobytes(), h, w,
                               ctypes.byref(pose))
            assert rc == 0, clib.ekf_last_error(c)
            assert np.isfinite(list(pose.r)).all()
        assert pose.map_size > 0
        assert pose.matches > 0
        assert abs(sum(x * x for x in pose.q) - 1.0) < 1e-6
        buf = (ctypes.c_double * 4096)()
        n = clib.ekf_state(c, sid, buf, 4096)
        assert n > 13
        assert np.isfinite(buf[:13]).all()
        assert clib.ekf_release(c, sid) == 0
        clib.ekf_disconnect(c)

    def test_two_sessions_independent(self, clib, server, rng):
        sock, _ = server
        c = clib.ekf_connect(sock.encode())
        s1 = clib.ekf_create(c, b"")
        s2 = clib.ekf_create(c, b"")
        assert s1 != s2
        frames = make_frames(rng, 3)
        h, w = frames[0].shape
        assert clib.ekf_init(c, s1, frames[0].tobytes(), h, w) == 0
        assert clib.ekf_init(c, s2, frames[2].tobytes(), h, w) == 0
        pose1, pose2 = EkfPose(), EkfPose()
        clib.ekf_step(c, s1, frames[1].tobytes(), h, w, ctypes.byref(pose1))
        clib.ekf_step(c, s2, frames[1].tobytes(), h, w, ctypes.byref(pose2))
        # session 2 initialised on a shifted frame: different motion
        assert list(pose1.r) != list(pose2.r)
        clib.ekf_release(c, s1)
        clib.ekf_release(c, s2)
        clib.ekf_disconnect(c)

    def test_errors_are_reported_not_fatal(self, clib, server, rng):
        sock, _ = server
        c = clib.ekf_connect(sock.encode())
        pose = EkfPose()
        # a step on a session that does not exist: a remote error
        rc = clib.ekf_step(c, 9999, b"\0" * 16, 4, 4, ctypes.byref(pose))
        assert rc == -3
        assert b"9999" in clib.ekf_last_error(c)
        # a frame of the wrong size: a remote error
        sid = clib.ekf_create(c, b"")
        rc = clib.ekf_init(c, sid, b"\0" * 16, 4, 4)
        assert rc == -3
        assert b"frame payload" in clib.ekf_last_error(c)
        # the connection is still usable
        frames = make_frames(rng, 1)
        h, w = frames[0].shape
        assert clib.ekf_init(c, sid, frames[0].tobytes(), h, w) == 0
        clib.ekf_release(c, sid)
        clib.ekf_disconnect(c)


def test_served_poses_equal_the_in_process_engine(clib, server):
    frames = make_frames(np.random.default_rng(7), 5)
    served, state = served_poses(clib, server[0], frames)
    eng = SlamEngine(small_config(tcfg), device="cpu")
    eng.init(frames[0])
    want = [r["position"] + r["orientation"] + r["linear_velocity"]
            + [r["total_matches"], r["n_active"]]
            for r in (eng.step(f) for f in frames[1:])]
    assert served.tobytes() == np.asarray(want).tobytes()
    assert state.tobytes() == eng.state_vector.astype(np.float64).tobytes()


def test_served_poses_against_the_jax_server(clib, tmp_path):
    """The two daemons in float64 over the same frames: poses within
    1e-9, counts identical."""
    frames = make_frames(np.random.default_rng(11), 5)
    out = {}
    for name, srv in (
            ("port", tserver.SlamServer(small_config(tcfg, "float64"),
                                        device="cpu")),
            ("jax", JServer(small_config(jcfg, "float64")))):
        sock = str(tmp_path / f"{name}.sock")
        thread = start(srv, sock)
        out[name] = served_poses(clib, sock, frames)
        srv.shutdown()
        if name == "port":
            thread.join(10)
            assert not thread.is_alive()
    np.testing.assert_allclose(out["port"][0][:, :10], out["jax"][0][:, :10],
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(out["port"][0][:, 10:],
                                  out["jax"][0][:, 10:])
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=0,
                               atol=1e-9)


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.SlamServer(small_config(tcfg))
    assert tserver.SlamServer(small_config(tcfg),
                              device="cpu").device == torch.device("cpu")


def test_main_options(monkeypatch, tmp_path):
    """``main``'s options reach every session's engine: ``--matcher ncc``
    with PATCH descriptors, ``--keyframe-every``, ``--device``."""
    seen = {}

    def fake_serve(self, path, ready_event=None, max_conns=32):
        seen.update(path=path, device=self.device, kwargs=self.engine_kwargs)

    monkeypatch.setattr(tserver.SlamServer, "serve", fake_serve)
    tserver.main(["--socket", str(tmp_path / "s.sock"), "--config", "c.yml",
                  "--matcher", "ncc", "--keyframe-every", "6",
                  "--relocalize-after", "3", "--device", "cpu"])
    kw = seen["kwargs"]
    assert seen["device"] == torch.device("cpu")
    assert kw["matcher"] == "ncc" and kw["descriptor"].kind == "PATCH"
    assert kw["keyframe_every"] == 6 and kw["relocalize_after"] == 3
    # such a session builds: the NCC matcher and the pose graph on the CPU
    eng = SlamEngine(small_config(tcfg), device="cpu",
                     **{k: v for k, v in kw.items()
                        if k in ("keyframe_every", "relocalize_after")})
    assert eng.pose_graph is not None
