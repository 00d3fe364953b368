"""SLAM serving daemon: engine sessions behind a Unix or TCP socket (port of
serving/server.py).

Host applications create a session (one ``SlamEngine`` each, the
reference's one-EKF-per-Handler model, android Handler.cpp), push
grayscale frames and read the camera pose back per frame, as the JNI
shim's EKFInit / EKFStep did (EKFNative.cpp:126-204).  Every session runs
on the server's device: the first CUDA device unless ``--device cpu``.
Connections are served by threads; a request that fails answers with an
error frame and the connection and the daemon keep serving.

Run:  python -m openekfmonoslam_tpu_torch.serving.server \\
          --socket /tmp/ekf.sock --config experiments/s3/config.yml
"""

from __future__ import annotations

import argparse
import os
import socket
import struct
import threading

import numpy as np

from openekfmonoslam_tpu_torch.engine.step import resolve_device
from openekfmonoslam_tpu_torch.serving import protocol as pr

_ACCEPT_POLL_S = 0.2


class SlamServer:
    def __init__(self, config_path, allow_config_dir: str = "",
                 device=None, **engine_kwargs):
        """``config_path`` is the sessions' config file (or a
        ``SlamConfig``); ``device`` (the first CUDA device by default) and
        ``engine_kwargs`` go to every session's ``SlamEngine``."""
        self.config_path = config_path
        # clients may only select configs inside this directory; empty =
        # client-supplied paths rejected (always use --config)
        self.allow_config_dir = (os.path.realpath(allow_config_dir)
                                 if allow_config_dir else "")
        self.device = resolve_device(device)
        self.engine_kwargs = engine_kwargs
        self.sessions: dict[int, object] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def _resolve_config(self, cfg_path: str):
        """Whitelist client-supplied config paths (the OP_CREATE payload is
        untrusted: without this an unauthenticated client could make the
        server parse any file on disk)."""
        if not cfg_path:
            return self.config_path
        if not self.allow_config_dir:
            raise PermissionError(
                "client config paths disabled (run with --allow-config-dir)")
        real = os.path.realpath(cfg_path)
        if not real.startswith(self.allow_config_dir + os.sep):
            raise PermissionError(
                f"config path outside allowed dir: {cfg_path}")
        return real

    # -- session ops -----------------------------------------------------
    def create(self, payload: bytes) -> bytes:
        from openekfmonoslam_tpu_torch.engine.engine import SlamEngine
        # payload: u16 h | u16 w | config path bytes (protocol.py).  The
        # h/w hint, when nonzero, must agree with the config's calibration.
        h = w = 0
        if len(payload) >= 4:
            h, w = struct.unpack("<HH", payload[:4])
        cfg_path = payload[4:].decode() if len(payload) > 4 else ""
        engine = SlamEngine(self._resolve_config(cfg_path),
                            device=self.device, **self.engine_kwargs)
        cam = engine.config.camera
        if (h or w) and (h != cam.pixels_y or w != cam.pixels_x):
            engine.close()
            raise ValueError(
                f"frame hint {h}x{w} != calibration "
                f"{cam.pixels_y}x{cam.pixels_x}")
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self.sessions[sid] = engine
        return struct.pack("<I", sid)

    def _engine(self, session: int):
        eng = self.sessions.get(session)
        if eng is None:
            raise KeyError(f"no session {session}")
        return eng

    def _frame(self, eng, payload: bytes) -> np.ndarray:
        h = eng.config.camera.pixels_y
        w = eng.config.camera.pixels_x
        if len(payload) != h * w:
            raise ValueError(f"frame payload {len(payload)} != {h}x{w}")
        return np.frombuffer(payload, np.uint8).reshape(h, w)

    def init(self, session: int, payload: bytes) -> bytes:
        eng = self._engine(session)
        eng.init(self._frame(eng, payload))
        return b""

    def step(self, session: int, payload: bytes) -> bytes:
        eng = self._engine(session)
        rec = eng.step(self._frame(eng, payload))
        x = (rec["position"] + rec["orientation"]
             + rec["linear_velocity"])
        return pr.STEP_RSP.pack(*x, rec["total_matches"],
                                rec["li_inliers"], rec["hi_inliers"],
                                rec["n_active"])

    def state(self, session: int) -> bytes:
        eng = self._engine(session)
        return np.asarray(eng.state_vector, np.float64).tobytes()

    def release(self, session: int) -> bytes:
        eng = self.sessions.pop(session, None)
        if eng is not None:
            eng.close()
        return b""

    # -- socket loop -------------------------------------------------------
    def handle(self, conn) -> None:
        try:
            while True:
                try:
                    opcode, session, payload = pr.read_request(conn)
                except ConnectionError:
                    return
                try:
                    if opcode == pr.OP_CREATE:
                        out = self.create(payload)
                    elif opcode == pr.OP_INIT:
                        out = self.init(session, payload)
                    elif opcode == pr.OP_STEP:
                        out = self.step(session, payload)
                    elif opcode == pr.OP_STATE:
                        out = self.state(session)
                    elif opcode == pr.OP_RELEASE:
                        out = self.release(session)
                    else:
                        raise ValueError(f"bad opcode {opcode}")
                    conn.sendall(pr.pack_response(pr.ST_OK, out))
                except Exception as e:  # error -> status frame, keep serving
                    conn.sendall(pr.pack_response(
                        pr.ST_ERROR, str(e).encode()[:512]))
        finally:
            conn.close()

    def serve(self, path: str, ready_event=None, max_conns: int = 32
              ) -> None:
        """Serve on a Unix socket path (or host:port when it contains :)."""
        if ":" in path:
            host, port = path.rsplit(":", 1)
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, int(port)))
        else:
            if os.path.exists(path):
                os.unlink(path)
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(path)
        srv.listen(max_conns)
        # accept() wakes every _ACCEPT_POLL_S to see a shutdown: closing a
        # listening socket does not wake a blocked accept() everywhere
        srv.settimeout(_ACCEPT_POLL_S)
        self._srv = srv
        if ready_event is not None:
            ready_event.set()
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # socket closed -> shut down
                conn.setblocking(True)
                threading.Thread(target=self.handle, args=(conn,),
                                 daemon=True).start()
        finally:
            srv.close()

    def shutdown(self) -> None:
        """Stop serve (within _ACCEPT_POLL_S) and release every session."""
        self._stop.set()
        for sid in list(self.sessions):
            self.release(sid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--socket", default="/tmp/ekf.sock",
                    help="unix socket path or host:port")
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-features", type=int, default=None)
    ap.add_argument("--matcher", choices=("descriptor", "ncc"), default=None)
    ap.add_argument("--keyframe-every", type=int, default=0,
                    help="enable the pose-graph layer in every session")
    ap.add_argument("--relocalize-after", type=int, default=0,
                    help="auto map-reset after N consecutive lost frames")
    ap.add_argument("--allow-config-dir", default="",
                    help="directory clients may select configs from "
                         "(default: client config paths rejected)")
    ap.add_argument("--device", default=None,
                    help="torch device of every session (default: the "
                         "first CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    kwargs = {}
    if args.max_features:
        kwargs["max_features"] = args.max_features
    if args.matcher:
        kwargs["matcher"] = args.matcher
        if args.matcher == "ncc":
            from openekfmonoslam_tpu_torch.config import DescriptorConfig
            kwargs["descriptor"] = DescriptorConfig(kind="PATCH")
    if args.keyframe_every:
        kwargs["keyframe_every"] = args.keyframe_every
    if args.relocalize_after:
        kwargs["relocalize_after"] = args.relocalize_after
    server = SlamServer(args.config, allow_config_dir=args.allow_config_dir,
                        device=args.device, **kwargs)
    print(f"serving on {args.socket}")
    server.serve(args.socket)


if __name__ == "__main__":
    main()
