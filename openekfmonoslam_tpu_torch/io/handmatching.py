"""Hand-labeled match replay: the reference's HandMatching harness.

Reference: HandMatching.cpp:37-99 -- loads an OpenCV FileStorage YML file
whose root holds one node per frame, each a sequence of {x, y} entries
where the sequence index is the feature index and x > 0 && y > 0 marks a
live match.  The reference replays these instead of running live
detection/matching, isolating the filter math from the vision front-end.

The port replays them through SlamRuntime.step_injected (the filter
pipeline with externally supplied per-slot measurements): this module
parses the reference file format into (z, matched) slot arrays (port of
openekfmonoslam_tpu/io/handmatching.py).
"""

from __future__ import annotations

import re

import numpy as np

_ENTRY_RE = re.compile(
    r"\{\s*x\s*:\s*(-?\d+(?:\.\d+)?)\s*,\s*y\s*:\s*(-?\d+(?:\.\d+)?)\s*\}")


def load_hand_matches(path: str, max_features: int
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Parse a reference hand-match YML into per-frame slot measurements.

    Returns a list over frames of ``(z, matched)`` with ``z`` (F, 2)
    float64 pixel positions (x, y) and ``matched`` (F,) bool, where F =
    ``max_features``.  Entries beyond F are dropped (the slot model caps
    the map); x <= 0 or y <= 0 entries are unmatched, exactly like
    loadHandMatches (HandMatching.cpp:64-67).

    Supported syntax: OpenCV FileStorage sequences of inline maps,
    one frame node per root key::

        %YAML:1.0
        frame0:
           - { x: 120, y: 45 }
           - { x: -1, y: -1 }
        frame1: [ { x: 121, y: 44 }, { x: -1, y: -1 } ]
    """
    frames: list[tuple[np.ndarray, np.ndarray]] = []
    cur: list[tuple[float, float]] | None = None

    def flush():
        nonlocal cur
        if cur is None:
            return
        z = np.zeros((max_features, 2), np.float64)
        matched = np.zeros((max_features,), bool)
        for i, (x, y) in enumerate(cur[:max_features]):
            if x > 0 and y > 0:
                z[i] = (x, y)
                matched[i] = True
        frames.append((z, matched))
        cur = None

    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(("%", "#", "---")):
                continue
            m = re.match(r"^([A-Za-z_]\w*)\s*:(.*)$", line)
            if m and not line.startswith("-"):
                flush()
                cur = []
                rest = m.group(2)
                for e in _ENTRY_RE.finditer(rest):
                    cur.append((float(e.group(1)), float(e.group(2))))
                continue
            if cur is not None:
                for e in _ENTRY_RE.finditer(line):
                    cur.append((float(e.group(1)), float(e.group(2))))
    flush()
    return frames


def replay(runtime, state, frames):
    """Replay hand matches through the injected-measurement step.

    ``frames`` as returned by :func:`load_hand_matches`.  Returns
    (final_state, records list) -- handmatchForStep semantics
    (HandMatching.cpp:90-99) driving step_injected.  The measurements are
    copied to the runtime's device once, before the first frame.
    """
    import torch

    if not frames:
        return state, []
    z_all = torch.as_tensor(np.stack([z for z, _ in frames]),
                            dtype=runtime.dtype, device=runtime.device)
    m_all = torch.as_tensor(np.stack([m for _, m in frames]),
                            device=runtime.device)
    records = []
    for t in range(len(frames)):
        state, rec = runtime.step_injected(state, z_all[t], m_all[t])
        records.append(rec)
    return state, records
