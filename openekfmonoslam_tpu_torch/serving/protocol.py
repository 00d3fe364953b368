"""Wire protocol for the SLAM serving daemon (the port's own copy of
serving/protocol.py; the bytes on the wire are the same).

The reference embeds the engine in host applications through a JNI shim
exposing four calls -- loadEKFNativeReference / EKFInit / EKFStep /
releaseEKFNativeReference (EKFNative.cpp:62-73) -- with EKFStep pushing a
camera frame in and camera x/y/z back out (EKFNative.cpp:155-204).  The
engine lives in the process that owns the GPU, so host apps reach it over
a socket: the same four operations as length-prefixed binary messages,
served by serving/server.py and spoken by the C client library
(native/ekf_client.c), so C/C++/Java hosts link the way they linked the
JNI shim.

Frame layout (little-endian):
  request:  u32 magic | u8 opcode | u32 session | u32 payload_len | payload
  response: u32 magic | u8 status | u32 payload_len | payload

opcodes: CREATE=1 (payload: u16 h, u16 w, config bytes) -> u32 session id
         INIT=2, STEP=3 (payload: h*w u8 grayscale frame)
         STATE=4 (payload empty) -> full state vector f64
         RELEASE=5 (payload empty)
STEP response payload: 7 f64 pose (r, q) + 3 f64 velocity + u32 matches,
u32 li_inliers, u32 hi_inliers, u32 n_active.
"""

from __future__ import annotations

import struct

MAGIC = 0x454B4631          # "EKF1"
OP_CREATE = 1
OP_INIT = 2
OP_STEP = 3
OP_STATE = 4
OP_RELEASE = 5

ST_OK = 0
ST_ERROR = 1

_REQ_HDR = struct.Struct("<IBII")
_RSP_HDR = struct.Struct("<IBI")
STEP_RSP = struct.Struct("<10d4I")


def pack_request(opcode: int, session: int, payload: bytes = b"") -> bytes:
    return _REQ_HDR.pack(MAGIC, opcode, session, len(payload)) + payload


def pack_response(status: int, payload: bytes = b"") -> bytes:
    return _RSP_HDR.pack(MAGIC, status, len(payload)) + payload


def read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_request(sock) -> tuple[int, int, bytes]:
    hdr = read_exact(sock, _REQ_HDR.size)
    magic, opcode, session, plen = _REQ_HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    payload = read_exact(sock, plen) if plen else b""
    return opcode, session, payload


def read_response(sock) -> tuple[int, bytes]:
    hdr = read_exact(sock, _RSP_HDR.size)
    magic, status, plen = _RSP_HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    payload = read_exact(sock, plen) if plen else b""
    return status, payload
