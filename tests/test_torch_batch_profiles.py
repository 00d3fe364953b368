"""The port's stream-batched step (``parallel/batch_runner.py``) on every
configuration beyond FAST and STAR with BRIEF, on the CPU.

B = 2 streams of 120x128 frames (tests/test_torch_profiles_engine.py's
scene and, for the second stream, the same frames mirrored) go through the
port's batched init and 3 batched steps in float64 on ORB/ORB, SIFT/SURF,
SURF/SURF, HARRIS/BRIEF and SHI_TOMASI/ORB (that file's settings), the
NCC matcher (tests/test_torch_ncc.py's engine configuration and frames)
and the parity mode (FAST/BRIEF with ``reference_quirks``,
``ransac_parity_visit`` and 1000 hypotheses):

- against the JAX package's ``make_batched_init`` / ``make_batched_step``:
  masks and match counts identical, x within 1e-9; NCC held as
  tests/test_torch_ncc.py holds its engine (masks identical, the camera
  within 1e-5: its correlations sum in another order than XLA's);
- against the port's own single-stream ``step`` per stream: masks and
  records identical, x and P within 1e-12 (a vmapped product may sum in
  another order).

A parity case where a conversion fires holds the batched conversion to the
single-stream step's insertion-order scan: the streams' birth stamps are
reversed, so the first eligible slot in slot order is not the first in
insertion order.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu.parallel import batch_runner as jbr
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.parallel import batch_runner as br

import test_torch_ncc as ncc_test
from test_torch_batch_runner import (MASKS, assert_same_state,
                                     assert_same_stream, port_batched,
                                     port_single)
from test_torch_profiles_engine import profile_config, scene_frames

B = 2
CONFIGS = ["ORB/ORB", "SIFT/SURF", "SURF/SURF", "HARRIS/BRIEF",
           "SHI_TOMASI/ORB", "NCC", "parity"]
# x against the JAX package: 1e-9, NCC as tests/test_torch_ncc.py's engine
TOL_X = {"NCC": 1e-5}
PARITY = dict(reference_quirks=True, ransac_parity_visit=True,
              max_hypotheses=1000)


def config(mod, name, **ekf):
    if name == "NCC":
        cfg = ncc_test.engine_config(mod, "float64")
    elif name == "parity":
        cfg = dataclasses.replace(profile_config(mod, "FAST", "BRIEF"),
                                  **PARITY)
    else:
        cfg = profile_config(mod, *name.split("/"))
    if ekf:
        cfg = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf,
                                                               **ekf))
    return cfg


@functools.lru_cache(maxsize=None)
def frames(name):
    """(B, T, H, W) uint8: each configuration's scene, and mirrored."""
    if name == "NCC":
        seq = np.stack(ncc_test.engine_frames(np.random.default_rng(42)))
        seq = np.clip(np.round(seq), 0, 255).astype(np.uint8)
    else:
        seq = np.stack(scene_frames())
    return np.stack([seq, np.ascontiguousarray(seq[:, :, ::-1])])


@functools.lru_cache(maxsize=None)
def port_run(name):
    return port_batched(TRuntime(config(tcfg, name), device="cpu"),
                        frames(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_matches_jax(name):
    fr = frames(name)
    jrt = JRuntime(config(jcfg, name))
    js = jbr.make_batched_init(jrt)(jbr.make_batch_states(jrt, B),
                                    jnp.asarray(fr[:, 0]))
    jstep = jbr.make_batched_step(jrt)
    ts, trecs = port_run(name)
    tol = TOL_X.get(name, 1e-9)
    for t in range(1, fr.shape[1]):
        js, jrec = jstep(js, jnp.asarray(fr[:, t]))
        trec = trecs[t - 1]
        for k in MASKS:
            np.testing.assert_array_equal(getattr(trec, k).numpy(),
                                          np.asarray(getattr(jrec, k)),
                                          err_msg=f"frame {t} {k}")
        np.testing.assert_allclose(trec.x_cam.numpy(),
                                   np.asarray(jrec.x_cam), rtol=0, atol=tol)
    # NCC: the camera only, as tests/test_torch_ncc.py holds it (a
    # template near-tie moves a landmark's subpixel fit by 5e-3 px)
    n = 13 if name == "NCC" else ts.x.shape[1]
    np.testing.assert_allclose(ts.x[:, :n].numpy(), np.asarray(js.x)[:, :n],
                               rtol=0, atol=tol)
    assert ts.descriptors.dtype == (torch.int32 if str(
        js.descriptors.dtype) == "uint32" else torch.float32)
    assert (np.asarray(jrec.total_matches) >= 5).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_matches_single_stream(name):
    rt = TRuntime(config(tcfg, name), device="cpu")
    st, recs = port_run(name)
    fr = frames(name)
    for b in range(B):
        s, srecs = port_single(rt, fr[b])
        for rec_b, rec in zip(recs, srecs):
            assert_same_stream(rec_b, b, rec)
        assert_same_state(st, b, s)


@pytest.mark.parametrize("name", ["SIFT/SURF", "NCC"])
def test_batch_states_keep_the_descriptor_dtype(name):
    rt = TRuntime(config(tcfg, name), device="cpu")
    st = br.make_batch_states(rt, 3)
    assert st.descriptors.dtype == torch.float32
    assert st.descriptors.shape == (3,) + tuple(
        rt.make_initial_state().descriptors.shape)


def test_parity_conversion_takes_the_insertion_order():
    """Every inverse-depth slot eligible (threshold 1e9) and the birth
    stamps reversed: each stream converts its latest-slot landmark, as
    its single-stream step does, and not slot 0."""
    rt = TRuntime(config(tcfg, "parity",
                         inverse_depth_linearity_index_threshold=1e9),
                  device="cpu")
    fr = frames("parity")
    st = br.make_batched_init(rt)(br.make_batch_states(rt, B), fr[:, 0])
    st = st._replace(birth=torch.where(st.active, 1000 - st.birth,
                                       st.birth))
    got, rec = br.batched_step(rt, st, fr[:, 1])
    for b in range(B):
        one = type(st)(*(f[b] for f in st))
        want, srec = rt.step(one, fr[b, 1])
        assert_same_stream(rec, b, srec)
        assert_same_state(got, b, want)
        converted = got.is_xyz[b] & ~st.is_xyz[b]
        assert int(converted.sum()) == 1
        # slot 0 was, and stays, an eligible inverse-depth landmark: the
        # scan in slot order would have taken it
        assert bool(st.active[b, 0]) and not bool(st.is_xyz[b, 0])
        assert bool(got.active[b, 0]) and not bool(converted[0])
