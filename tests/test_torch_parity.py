"""The port's parity mode (``reference_quirks`` and ``ransac_parity_visit``)
against the JAX package and the bug-compatible oracle, in float64.

- ``step_injected`` on tests/test_torch_slice.py's numpy-made log (F = 12,
  25 frames, adds into occupied slots, culls), for each combination of the
  two flags other than (off, off): every StepRecord field agrees with the
  JAX ``step_injected`` on every frame, ``x_cam`` and ``P_cam`` to 1e-9,
  every mask and count exactly.
- The port's quirks + parity replay tracks the bug-compatible oracle
  (``OracleQuirks()``), the port's copy and the JAX one, within
  tests/test_oracle_parity.py's bound: ATE < 1e-5 path + 1e-7.
- The port's ``eval/oracle.replay_log`` equals the JAX one bit for bit for
  every entry of ``quirk_variants()``: the same numpy code on the same log.
- ``SlamEngine`` in parity mode against the JAX ``SlamEngine`` on
  tests/test_torch_live.py's 160x120 frames, ``init`` + 6 steps: records
  to 1e-9, counters identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.config import EKFParams as JEKF
from openekfmonoslam_tpu.config import SlamConfig as JConfig
from openekfmonoslam_tpu.engine import engine as jeng
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu.eval import oracle as joracle
from openekfmonoslam_tpu.filter import features as jfeat
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.config import EKFParams as TEKF
from openekfmonoslam_tpu_torch.config import SlamConfig as TConfig
from openekfmonoslam_tpu_torch.engine import engine as teng
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.eval import oracle as toracle
from openekfmonoslam_tpu_torch.eval import replay as treplay
from openekfmonoslam_tpu_torch.eval.trajectory import ate_rmse
from openekfmonoslam_tpu_torch.filter import features as tfeat
from test_torch_engine import assert_records_agree
from test_torch_live import make_config, make_frames
from test_torch_slice import EKF, F, T_FRAMES, arrays, make_log

# (reference_quirks, ransac_parity_visit)
MODES = {"quirks+visit": (True, True), "quirks": (True, False),
         "visit": (False, True)}
ENGINE_STEPS = 6


def configs(quirks: bool, visit: bool):
    """The slice test's configuration in both packages, with the parity
    flags and the reference's 1000 hypotheses (1PointRansac.cpp:116)."""
    kw = dict(max_features=F, dtype="float64", reference_quirks=quirks,
              ransac_parity_visit=visit, max_hypotheses=1000)
    return (JConfig(ekf=dataclasses.replace(JEKF(), **EKF), **kw),
            TConfig(ekf=dataclasses.replace(TEKF(), **EKF), **kw))


def run_both(quirks: bool, visit: bool, log: dict):
    """Both packages' step_injected over the log from the same add_features_at
    bootstrap; returns (JAX records, port records)."""
    jc, tc = configs(quirks, visit)
    jrt, trt = JRuntime(jc), TRuntime(tc, device="cpu")
    uv0, valid0, slots0 = arrays(log["init"])
    js = jfeat.add_features_at(jrt.make_initial_state(), jrt.camera, jc,
                               jnp.asarray(uv0), jnp.zeros((F, 8), jnp.uint32),
                               jnp.asarray(slots0), jnp.asarray(valid0))
    ts = tfeat.add_features_at(trt.make_initial_state(), trt.camera, tc,
                               torch.tensor(uv0),
                               torch.zeros((F, 8), dtype=torch.int32),
                               torch.tensor(slots0), torch.tensor(valid0))
    jstep = jax.jit(jrt.step_injected)
    jrecs, trecs = [], []
    for fr in log["frames"]:
        uv, valid, slots = arrays(fr["new"])
        js, jr = jstep(js, jnp.asarray(fr["z"]), jnp.asarray(fr["matched"]),
                       new_uv=jnp.asarray(uv), new_desc=None,
                       new_valid=jnp.asarray(valid),
                       new_slot=jnp.asarray(slots))
        ts, tr = trt.step_injected(ts, fr["z"], fr["matched"], new_uv=uv,
                                   new_valid=valid, new_slot=slots)
        jrecs.append(jr)
        trecs.append(tr)
    return jrecs, trecs


@pytest.fixture(scope="module")
def log():
    return make_log()


@pytest.fixture(scope="module")
def runs(log):
    return {name: run_both(*flags, log) for name, flags in MODES.items()}


@pytest.fixture(scope="module")
def oracles(log):
    """replay_log of both packages for every quirk variant."""
    jc, tc = configs(True, True)
    return {name: (joracle.replay_log(jc, log, q),
                   toracle.replay_log(tc, log, toracle.quirk_variants()[name]))
            for name, q in joracle.quirk_variants().items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_step_injected_matches_jax_every_frame(runs, mode):
    jrecs, trecs = runs[mode]
    assert len(trecs) == T_FRAMES
    for t, (jr, tr) in enumerate(zip(jrecs, trecs)):
        for name in jr._fields:
            a = np.asarray(getattr(jr, name))
            b = getattr(tr, name).numpy()
            assert a.shape == b.shape, (t, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9,
                                           err_msg=f"{mode} frame {t} {name}")
            else:
                np.testing.assert_array_equal(
                    b, a, err_msg=f"{mode} frame {t} {name}")


def test_parity_modes_change_the_run(runs, log):
    """Each mode departs from the correct-math run somewhere, so the
    comparisons above hold each flag, not the default path."""
    _, tc = configs(False, False)
    base = treplay.replay_through_engine(TRuntime(tc, device="cpu"), log)
    for mode, (_, trecs) in runs.items():
        traj = np.stack([r.x_cam.numpy() for r in trecs])
        assert np.abs(traj - base).max() > 1e-12, mode


def _path_and_ate(traj, ref):
    n = min(len(traj), len(ref))
    path = float(np.sum(np.linalg.norm(np.diff(ref[:n, 0:3], axis=0),
                                       axis=1)))
    return path, ate_rmse(traj[:n, 0:3], ref[:n, 0:3], align=False)


def test_quirks_replay_tracks_the_reference_oracle(log, oracles):
    """The port's parity replay against the bug-compatible oracle, its own
    copy and the JAX one (tests/test_oracle_parity.py:155's bound)."""
    _, tc = configs(True, True)
    traj = treplay.replay_through_engine(TRuntime(tc, device="cpu"), log)
    jorc, torc = oracles["reference"]
    for orc in (torc, jorc):
        path, ate = _path_and_ate(traj, np.stack(orc.trajectory))
        assert path > 1e-3
        assert ate < 1e-5 * max(path, 1e-3) + 1e-7, (ate, path)


@pytest.mark.parametrize("variant", list(joracle.quirk_variants()))
def test_port_oracle_equals_jax_oracle_bit_for_bit(oracles, variant):
    jorc, torc = oracles[variant]
    assert torc.q == toracle.OracleQuirks(**dataclasses.asdict(jorc.q))
    assert len(torc.trajectory) == len(jorc.trajectory) == T_FRAMES
    np.testing.assert_array_equal(np.stack(torc.trajectory),
                                  np.stack(jorc.trajectory))
    np.testing.assert_array_equal(torc.x, jorc.x)
    np.testing.assert_array_equal(torc.P, jorc.P)
    assert torc.slot_collisions == jorc.slot_collisions
    assert [f.slot for f in torc.feats] == [f.slot for f in jorc.feats]


@pytest.fixture(scope="module")
def engines():
    frames = make_frames()

    def run(engine):
        engine.init(frames[0])
        for f in frames[1:ENGINE_STEPS + 1]:
            engine.step(f)
        return engine.records

    flags = dict(reference_quirks=True, ransac_parity_visit=True)
    jc = dataclasses.replace(make_config(jcfg), **flags)
    tc = dataclasses.replace(make_config(tcfg), **flags)
    return run(jeng.SlamEngine(jc)), run(teng.SlamEngine(tc, device="cpu"))


def test_parity_engine_matches_jax(engines):
    jrecs, trecs = engines
    assert len(trecs) == ENGINE_STEPS
    assert_records_agree(trecs, jrecs)
    assert all(r["total_matches"] >= 8 for r in trecs)
