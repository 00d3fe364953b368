"""The comparison that decides ``correct``.

The filter is a recursion, and the plain reference costs far more a frame
than the program, so it follows the program step by step: for each frame
of a sample drawn from the seed it starts from the program's own state
before that frame, takes the frame with the program's front-end output
(matches, and the candidate pixels of additions), and holds the program's
state after the frame, its predictions and its decisions against its own.
The two stages this skips are checked by themselves: the bootstrap from
the initial state (``check_bootstrap``) and, on every sampled frame and
the bootstrap, the front end (``check_front``): the program's matches,
the candidates it detected for new features and the descriptors it
stored (refreshed for the frame's inliers, written for additions)
against the plain front end's.

A discrete decision (visibility, RANSAC's inliers, the rescue, a
conversion) whose deciding number lies within rounding of its threshold
may fall either way in float32: such a frame is counted as a knife edge
and its state is not compared.  A decision that differs by more is wrong.

Numbers compared, each against its limit (limits/<configuration>.json):
  state_gap   largest |x - x_ref| / max(|x_ref|, 1) over the live dims
              after a frame (relative where a value passes 1: anchors and
              positions grow as the camera travels)
  P_gap       largest |P - P_ref| over the live block, over max |P_ref|
  wrong       decisions that differ beyond rounding (count)
  z_gap       mean |z - z_ref| (px) over the slots matched to the same
              keypoint by both (the subpixel fit on float32 scores; its
              largest swings where a peak is flat, so the mean is held)
  match_off   slots matched by one side only, or to another keypoint
              (further than Z_PX) (count)
  cand_off    rows of the new-feature candidates (pixels, in pick order)
              that differ from the plain detection's, which follows the
              program's picks where a pick's score ties the plain one's
              to rounding (``vision.zone_balanced``) (count)
  desc_bits   bits of the stored descriptors of the live slots that
              differ from the plain front end's (count)
  followed_share  share of the sampled frames whose state was compared
              (at least)
The largest gap of the visible predictions' pixels is printed beside
them: the control (TF32 products) moves only their covariances.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slambench.reference import ekf
from slambench.reference.ekf import Matmul, Params, State
from slambench.reference.vision import FrontEnd, bits_apart, words

# a deciding number within this share of its threshold may round either way
# in float32 (its own relative rounding is about 1e-7)
EDGE_REL = 1e-4
EDGE_PX = 1e-3          # the same for a pixel distance of RANSAC's test
Z_PX = 0.5              # a matched pixel further away is another keypoint


@dataclasses.dataclass
class Program:
    """What the program produced on one frame, read back after the window:
    its state before and after, and its record's fields (numpy)."""

    before: dict
    after: dict
    record: dict
    gray: np.ndarray | None = None


def to_state(fields: dict) -> State:
    """A reference State, float64 on the CPU, from a program state's
    fields (numpy arrays)."""
    return State(
        torch.as_tensor(fields["x"], dtype=torch.float64),
        torch.as_tensor(fields["P"], dtype=torch.float64),
        torch.as_tensor(fields["active"], dtype=torch.bool),
        torch.as_tensor(fields["is_xyz"], dtype=torch.bool),
        torch.as_tensor(fields["times_predicted"], dtype=torch.int64),
        torch.as_tensor(fields["times_matched"], dtype=torch.int64),
        int(fields["frame"]))


def _gaps(ref: State, got: State) -> tuple[float, float]:
    m = ref.dim_mask()
    dx = float(((ref.x - got.x).abs() / ref.x.abs().clamp(min=1.0))[m].max())
    Pr = ref.P[m][:, m]
    dP = float((Pr - got.P[m][:, m]).abs().max() / Pr.abs().max())
    return dx, dP


@dataclasses.dataclass
class FrameResult:
    wrong: list
    knife: list
    followed: bool
    state_gap: float = 0.0
    P_gap: float = 0.0
    pred_gap: float = 0.0


def forward(p: Params, st0: State, rec: dict, mm: Matmul,
            pick=None) -> tuple:
    """The reference's own frame from ``st0`` with the program's front-end
    output in ``rec`` (z, matched, and the additions' pixels, flags and
    slots): (state after, its decisions and the numbers that decided
    them).  With ``pick`` (n -> ((C, 2) pixels, picks made)) the additions
    are its own, and ``new_uv``, ``new_ok``, ``new_slot`` are among the
    decisions."""
    z = torch.as_tensor(rec["z"], dtype=st0.x.dtype)
    matched = torch.as_tensor(rec["matched"], dtype=torch.bool)
    st = st0.clone()
    st.frame += 1
    st = ekf.predict(p, st, mm)
    pr = ekf.measure(p, st, mm)
    matched = matched & pr["vis"]
    rs = ekf.ransac(p, st, pr, z, matched)
    li = rs["inliers"]
    st = ekf.update(p, st, pr, z, li, mm)
    pr2 = ekf.measure(p, st, mm)
    d = z - pr2["uv"]
    md = (d[:, None, :] @ torch.linalg.solve(pr2["Sii"], d[..., None])
          )[:, 0, 0]
    out = matched & ~li
    rescued = out & pr2["vis"] & (md < p.chi2_rescue)
    union = li | rescued
    st = ekf.update(p, st, pr2, z, rescued, mm)
    st.times_predicted = st.times_predicted + pr["vis"].to(torch.int64)
    st.times_matched = st.times_matched + union.to(torch.int64)
    do_mm = p.mm_frequency > 0 and st.frame % max(p.mm_frequency, 1) == 0
    needed = p.min_matches - int(union.sum())
    pre = st.active.clone()
    if do_mm:
        tp = st.times_predicted
        ratio = st.times_matched.double() / torch.clamp(tp, min=1)
        st = ekf.remove(st, st.active & (tp > 0) & (ratio < p.good_percent))
        live = int(st.dim_mask().sum())
        n_feat = int(st.active.sum())
        pressure = needed > 0 and (
            p.always_remove_unseen
            or (p.max_map_features > 0
                and n_feat + needed > p.max_map_features)
            or (p.max_map_size > 0 and live + 6 * needed > p.max_map_size))
        if pressure:
            st = ekf.remove(st, st.active & ~pr["vis"])
    removed = pre & ~st.active
    lin = ekf.linearity(st)
    below = torch.nonzero(lin < p.li_threshold).flatten()
    conv = below[:1] if do_mm else below[:0]
    if len(conv):
        st = ekf.convert(st, int(conv[0]), mm)
    adds = do_mm and needed > 0
    own = {}
    if pick is None:
        new_ok = np.asarray(rec["new_ok"], bool)
        uv_new = np.asarray(rec["new_uv"])[new_ok]
    else:
        uv_all, n = pick(min(needed, p.n_slots)) if adds else (
            np.zeros((p.n_slots, 2), np.float32), 0)
        free_all = torch.nonzero(~st.active).flatten()
        k = min(n, len(free_all))
        slot = np.full(p.n_slots, p.n_slots, np.int32)
        slot[:k] = free_all[:k].numpy()
        own = dict(new_uv=uv_all, new_ok=np.arange(p.n_slots) < k,
                   new_slot=slot)
        uv_new = uv_all[:k]
    free = torch.nonzero(~st.active).flatten()[:len(uv_new)]
    if adds:
        st = ekf.add(p, st, torch.as_tensor(uv_new, dtype=st.x.dtype),
                     free, mm)
    return st, dict(pr=pr, rs=rs, li=li, md=md, outliers=out,
                    rescued=rescued, union=union, removed=removed,
                    lin=lin, conv=conv, adds=adds, free=free,
                    matched=matched, **own)


def check_step(p: Params, prog: Program, mm: Matmul | None = None
               ) -> FrameResult:
    """One frame of the reference from the program's state before it,
    against the program's decisions and state after it."""
    rec = prog.record
    st0 = to_state(prog.before)
    got = to_state(prog.after)
    wrong, knife = [], []
    res = FrameResult(wrong, knife, False)
    st, d = forward(p, st0, rec, mm or Matmul())
    pr = d["pr"]

    vis_p = torch.as_tensor(rec["visible"], dtype=torch.bool)
    if not torch.equal(pr["vis"], vis_p):
        pre = ekf.predict(p, dataclasses.replace(st0.clone(),
                                                 frame=st0.frame + 1),
                          Matmul())
        feats = pre.feats()
        for i in torch.nonzero(pr["vis"] != vis_p).flatten().tolist():
            uv = ekf.h(p, pre.x[:7], feats[i], pre.is_xyz[i])
            margin = float(ekf.visibility_margin(p, pre.x[:7], feats[i],
                                                 pre.is_xyz[i], uv))
            (knife if margin < EDGE_REL else wrong).append(
                f"visible[{i}] {bool(vis_p[i])}, margin {margin:.3e}")
        return res
    if not torch.equal(d["matched"], torch.as_tensor(rec["matched"],
                                                     dtype=torch.bool)):
        wrong.append("a slot matched that is not visible")
        return res
    uv_p = torch.as_tensor(rec["pred_uv"], dtype=torch.float64)
    if bool(pr["vis"].any()):
        res.pred_gap = float((uv_p - pr["uv"])[pr["vis"]].abs().max())

    union_p = torch.as_tensor(rec["inliers"], dtype=torch.bool)
    if int(d["li"].sum()) != int(rec["li_inliers"]) or not torch.equal(
            d["union"], union_p):
        rs = d["rs"]
        near = (torch.abs(rs["dist"] - p.ransac_threshold) < EDGE_PX) & (
            rs["support"][:, None] >= rs["support"].max() - 2) & \
            d["matched"][None, :]
        near_chi = d["outliers"] & (torch.abs(d["md"] - p.chi2_rescue)
                                    < EDGE_REL * p.chi2_rescue)
        what = (f"inliers {int(rec['li_inliers'])} + "
                f"{int(union_p.sum()) - int(rec['li_inliers'])}, reference "
                f"{int(d['li'].sum())} + {int(d['rescued'].sum())}")
        (knife if bool(near.any() or near_chi.any()) else wrong).append(what)
        return res

    new_ok = np.asarray(rec["new_ok"], bool)
    new_slot = np.asarray(rec["new_slot"])[new_ok]
    added = torch.zeros(p.n_slots, dtype=torch.bool)
    added[torch.as_tensor(new_slot, dtype=torch.long)] = True
    pre_active = st0.active
    removed_p = pre_active & (~got.active | added)
    if not torch.equal(d["removed"], removed_p):
        wrong.append(
            f"removed {torch.nonzero(removed_p).flatten().tolist()}, "
            f"reference {torch.nonzero(d['removed']).flatten().tolist()}")
        return res
    conv_p = torch.nonzero(got.is_xyz & ~st0.is_xyz & ~added).flatten()
    if not torch.equal(d["conv"], conv_p):
        lin = d["lin"]
        near = any(abs(float(lin[s]) - p.li_threshold)
                   < EDGE_REL * p.li_threshold
                   for s in torch.cat([d["conv"], conv_p]).tolist())
        (knife if near else wrong).append(
            f"converted {conv_p.tolist()}, reference {d['conv'].tolist()}")
        return res
    if d["adds"]:
        if not np.array_equal(d["free"].numpy(), new_slot):
            wrong.append(f"added into slots {new_slot.tolist()}, free "
                         f"{d['free'].tolist()}")
            return res
    elif len(new_slot):
        wrong.append(f"{len(new_slot)} features added on a frame that "
                     "needs none")
        return res

    for name in ("active", "is_xyz", "times_predicted", "times_matched"):
        if not torch.equal(getattr(st, name), getattr(got, name)):
            wrong.append(f"{name} differs")
    if got.frame != st.frame:
        wrong.append(f"frame {got.frame}, reference {st.frame}")
    if wrong:
        return res
    res.followed = True
    res.state_gap, res.P_gap = _gaps(st, got)
    return res


def control(p: Params, cfg: dict, prog: Program) -> Program:
    """The reference in the program's place, in the nearest precision
    below the configuration's float32: the filter in float32 with every
    covariance product's operands rounded to TF32 (the tensor cores' mode
    that ``torch.backends.cuda.matmul.allow_tf32`` turns on), and the
    front end with its integral image summed in bfloat16.  Its matches,
    its candidates and the descriptors it stores are its own."""
    front = FrontEnd(cfg, reduced=True)
    rec0 = prog.record
    fr = front.frame(prog.gray)
    pred = _predictions(rec0)
    z, ok, _, best, _ = front.match(fr, *pred, torch.as_tensor(
        words(prog.before["descriptors"])))
    rec = dict(rec0, z=z.numpy(), matched=ok.numpy())
    st0 = to_state(prog.before)
    st0.x, st0.P = st0.x.float(), st0.P.float()
    picks = {}

    def pick(n):
        picks["uv"], picks["yx"], _, _ = front.candidates(fr, n, *pred)
        return picks["uv"], len(picks["yx"])

    st, d = forward(p, st0, rec, Matmul(reduced=True), pick)
    rec.update(visible=d["pr"]["vis"].numpy(),
               pred_uv=d["pr"]["uv"].double().numpy(),
               inliers=d["union"].numpy(), li_inliers=int(d["li"].sum()),
               new_uv=d["new_uv"], new_ok=d["new_ok"],
               new_slot=d["new_slot"])
    desc = words(prog.before["descriptors"])
    union = d["union"].numpy()
    desc[union] = best.numpy()[union]
    slots = d["new_slot"][d["new_ok"]]
    if len(slots):
        desc[slots] = front.describe_at(fr, picks["yx"][:len(slots)]).numpy()
    after = dict(prog.after)
    after.update(x=st.x.double().numpy(), P=st.P.double().numpy(),
                 active=st.active.numpy(), is_xyz=st.is_xyz.numpy(),
                 times_predicted=st.times_predicted.numpy(),
                 times_matched=st.times_matched.numpy(), frame=st.frame,
                 descriptors=desc)
    return Program(prog.before, after, rec, prog.gray)


def check_bootstrap(p: Params, after: dict, uv, ok, slots,
                    mm: Matmul | None = None) -> tuple[float, float, list]:
    """The bootstrap: the initial state grown by the program's detections
    (``uv`` (C, 2), ``ok``, ``slots``), against the program's state after
    it.  Returns (state gap, P gap, wrong decisions)."""
    mm = mm or Matmul()
    st = ekf.initial_state(p)
    ok = np.asarray(ok, bool)
    slots = np.asarray(slots)[ok]
    wrong = []
    if not np.array_equal(slots, np.arange(len(slots))):
        wrong.append(f"bootstrap slots {slots.tolist()}")
        return math.inf, math.inf, wrong
    st = ekf.add(p, st, torch.as_tensor(np.asarray(uv)[ok],
                                        dtype=torch.float64), slots, mm)
    got = to_state(after)
    if not torch.equal(st.active, got.active):
        wrong.append("bootstrap active slots differ")
        return math.inf, math.inf, wrong
    dx, dP = _gaps(st, got)
    return dx, dP, wrong


def _predictions(rec: dict) -> tuple:
    """The program's frame-start predictions, as its front end took them:
    (uv, S) float32 and the visible flags."""
    return (torch.as_tensor(rec["pred_uv"], dtype=torch.float32),
            torch.as_tensor(rec["pred_S"], dtype=torch.float32),
            torch.as_tensor(rec["visible"], dtype=torch.bool))


def picks_asked(p: Params, prog: Program) -> int:
    """The picks the program's own decisions ask of the frame's new-feature
    detection: min(needed, C) on a map-management frame that needs
    features, else none."""
    frame = int(prog.before["frame"]) + 1
    do_mm = p.mm_frequency > 0 and frame % max(p.mm_frequency, 1) == 0
    needed = p.min_matches - int(np.asarray(prog.record["inliers"],
                                            bool).sum())
    return min(needed, p.n_slots) if do_mm and needed > 0 else 0


@dataclasses.dataclass
class FrontResult:
    dz_sum: float = 0.0     # sum of |z - z_ref| over the slots matched alike
    alike: int = 0          # their count
    match_off: int = 0
    cand_off: int = 0
    cand_edges: int = 0     # candidates off by a knife edge (not counted)
    desc_bits: int = 0


def _yx(uv) -> np.ndarray:
    """The (row, column) of whole-pixel candidates (x, y)."""
    return np.rint(np.asarray(uv, np.float64)[:, ::-1]).astype(np.int64)


def check_front(front: FrontEnd, p: Params, prog: Program) -> FrontResult:
    """The program's front end on one frame against the plain one, from
    the program's predictions and map descriptors: its matches, its
    new-feature candidates (under the picks its decisions ask for), and
    the descriptors stored after the frame: an inlier's refreshed to its
    match's where both sides matched it alike, an added slot's described
    at its candidate, any other live slot's unchanged."""
    rec = prog.record
    fr = front.frame(prog.gray)
    pred = _predictions(rec)
    before = words(prog.before["descriptors"])
    z, ok, _, best, pixel = front.match(fr, *pred, torch.as_tensor(before))
    okp = torch.as_tensor(rec["matched"], dtype=torch.bool)
    zp = torch.as_tensor(rec["z"], dtype=torch.float32)
    dz = torch.abs(z - zp).amax(-1)
    same = ok & okp & (dz <= Z_PX)
    out = FrontResult(float(dz[same].sum()), int(same.sum()),
                      int(((ok | okp) & ~same).sum()))

    got = np.asarray(rec["new_uv"], np.float32)
    n = picks_asked(p, prog)
    if n:
        _, _, out.cand_off, out.cand_edges = front.candidates(
            fr, n, *pred, follow=got, rel=EDGE_REL)
    else:
        out.cand_off = int(got.any(1).sum())

    # the program's keypoint is the plain one where its refined pixel lies
    # within half a pixel of it (a refinement moves by half a pixel at most)
    union = np.asarray(rec["inliers"], bool)
    alike = (same & ((zp - pixel).abs().amax(-1) < 0.5)).numpy()
    expect = before.copy()
    expect[union & alike] = best.numpy()[union & alike]
    compared = np.asarray(prog.after["active"], bool) & ~(union & ~alike)
    new_ok = np.asarray(rec["new_ok"], bool)
    slots = np.asarray(rec["new_slot"])[new_ok]
    if len(slots):
        expect[slots] = front.describe_at(
            fr, _yx(np.asarray(rec["new_uv"])[new_ok])).numpy()
        compared[slots] = True
    out.desc_bits = int(bits_apart(
        expect[compared], np.asarray(prog.after["descriptors"])[compared]
    ).sum())
    return out


def check_bootstrap_front(front: FrontEnd, p: Params, gray, after: dict,
                          uv, ok, slots) -> FrontResult:
    """The bootstrap's detection (MinMatchesPerImage picks over the whole
    border) and the descriptors it stored, against the plain front end."""
    fr = front.frame(gray)
    out = FrontResult()
    _, _, out.cand_off, out.cand_edges = front.candidates(
        fr, p.min_matches, follow=np.asarray(uv, np.float32), rel=EDGE_REL)
    ok = np.asarray(ok, bool)
    slots = np.asarray(slots)[ok]
    if len(slots):
        ref = front.describe_at(fr, _yx(np.asarray(uv)[ok])).numpy()
        out.desc_bits = int(bits_apart(
            ref, np.asarray(after["descriptors"])[slots]).sum())
    return out
