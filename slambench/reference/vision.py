"""Plain reference of the STAR + BRIEF-256 front end, of the gated 2-NN
matching and of the new-feature detection of one frame, in plain PyTorch
and NumPy on the CPU.

A frozen copy of the arithmetic the program's front end is specified by:
the mean-centred float32 integral image, the CenSurE box responses at the
scale ladder up to the configured max size, the structure-tensor line
test, the response threshold and the (2r+1)^2 non-maximum suppression;
the top-K keypoints inside the union of the gate ellipses; the 9-tap
Gaussian blur and the BRIEF-256 shared-point pattern (the same seeded
draws); Hamming 2-NN with the ratio test; the parabola subpixel fit on the
pre-suppression map; the zone-balanced picks of new features outside the
gate ellipses.  Nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

SCALE_LADDER = (1, 2, 3, 4, 6, 8, 11, 16, 22, 32, 45, 64, 90, 128)
LINE_WINDOW = 2
BIG = 1 << 20


def f32(v: float) -> float:
    return float(np.float32(v))


def shift(img, dy, dx):
    h, w = img.shape
    out = img
    if dy:
        out = torch.index_select(out, 0, torch.clamp(torch.arange(h) + dy,
                                                     0, h - 1))
    if dx:
        out = torch.index_select(out, 1, torch.clamp(torch.arange(w) + dx,
                                                     0, w - 1))
    return out


def box_sum(img, r):
    acc = torch.zeros_like(img)
    for d in range(-r, r + 1):
        acc = acc + shift(img, d, 0)
    out = torch.zeros_like(img)
    for d in range(-r, r + 1):
        out = out + shift(acc, 0, d)
    return out


def star_maps(gray: torch.Tensor, max_size: int, response_threshold: float,
              line_threshold: float, nms_radius: int, reduced: bool = False):
    """(score_raw, score_nms) of an (H, W) uint8 frame.  The integral image
    is the exact sum rounded to float32 (``reduced``: summed in bfloat16,
    the control's precision)."""
    sizes = tuple(s for s in SCALE_LADDER if s <= max_size) or (1,)
    pad = 2 * max(sizes) + 1
    h, w = gray.shape
    p = nnf.pad(gray.to(torch.float32)[None, None], (pad,) * 4,
                mode="replicate")[0, 0]
    p = p - (torch.sum(p, dtype=torch.float64) / p.numel()).to(torch.float32)
    acc = torch.bfloat16 if reduced else torch.float64
    ii = nnf.pad(torch.cumsum(torch.cumsum(p.to(acc), 0), 1).float(),
                 (1, 0, 1, 0))

    def box(n):
        t, b = pad - n, pad + n + 1
        return (ii[b:b + h, b:b + w] - ii[t:t + h, b:b + w]
                - ii[b:b + h, t:t + w] + ii[t:t + h, t:t + w])

    def uses(b):
        return (b in sizes) + (b % 2 == 0 and b // 2 in sizes)

    resp = []
    for n in sizes:
        s_in, s_out = box(n), box(2 * n)
        r_in, r_out = 1.0 / (2 * n + 1) ** 2, 1.0 / (4 * n + 1) ** 2
        if uses(n) == 1:
            r = s_in.double() * f32(r_in) - (s_out * r_out).double()
        elif uses(2 * n) == 1:
            r = (s_in * r_in).double() - s_out.double() * f32(r_out)
        else:
            r = s_in * r_in - s_out * r_out
        resp.append(r.float())
    best = torch.amax(torch.abs(torch.stack(resp)), 0)
    rx = 0.5 * (shift(best, 0, 1) - shift(best, 0, -1))
    ry = 0.5 * (shift(best, 1, 0) - shift(best, -1, 0))
    sxx = box_sum(rx * rx, LINE_WINDOW)
    syy = box_sum(ry * ry, LINE_WINDOW)
    sxy = box_sum(rx * ry, LINE_WINDOW)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    keep = (det > 0) & (tr * tr < line_threshold * det)
    best = torch.where(keep, best, torch.zeros_like(best))
    raw = torch.where(best >= response_threshold, best, torch.zeros_like(best))
    k = 2 * nms_radius + 1
    pooled = nnf.max_pool2d(raw[None, None], k, stride=1,
                            padding=nms_radius)[0, 0]
    nms = torch.where((raw >= pooled) & (raw > 0), raw, torch.zeros_like(raw))
    return raw, nms


def inv2(S):
    a, b, c, d = S[..., 0, 0], S[..., 0, 1], S[..., 1, 0], S[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20),
                      det)
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None, None]


def ellipse_mask(h, w, centers, S, vis, gate, block=4):
    """(H, W) bool: 4x4 blocks whose centre passes a visible prediction's
    gate inflated by the block's worst centre-to-pixel slack."""
    Si = inv2(S)
    hb, wb = (h + block - 1) // block, (w + block - 1) // block
    ctr = (block - 1) * 0.5
    xs = torch.arange(wb, dtype=S.dtype) * block + ctr
    ys = torch.arange(hb, dtype=S.dtype) * block + ctr
    dx = xs[None, None, :] - centers[:, 0][:, None, None]
    dy = ys[None, :, None] - centers[:, 1][:, None, None]
    md = (Si[:, 0, 0][:, None, None] * dx * dx
          + 2.0 * Si[:, 0, 1][:, None, None] * dx * dy
          + Si[:, 1, 1][:, None, None] * dy * dy)
    tr2 = 0.5 * (S[:, 0, 0] + S[:, 1, 1])
    disc = torch.sqrt(torch.clamp(
        tr2 * tr2 - (S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]),
        min=0.0))
    lam = torch.clamp(tr2 - disc, min=1e-12)
    thresh = (torch.sqrt(torch.full((), gate, dtype=S.dtype))
              + math.sqrt(2.0) * (block - 1) * 0.5 / torch.sqrt(lam))
    ok = torch.sqrt(torch.clamp(md, min=0.0)) <= thresh[:, None, None]
    inside = torch.any(ok & vis[:, None, None], 0)
    full = inside[:, None, :, None].expand(hb, block, wb, block)
    return full.reshape(hb * block, wb * block)[:h, :w]


def top_keypoints(score, mask, k):
    """The top k scores of the masked map, ties to the lower flat index:
    ((k, 2) row/col, (k,) score)."""
    h, w = score.shape
    flat = torch.where(mask, score, torch.zeros_like(score)).reshape(-1)
    n = flat.shape[0]
    sh = max(n - 1, 1).bit_length()
    key = ((flat.view(torch.int32).to(torch.int64) << sh)
           | (n - 1 - torch.arange(n, dtype=torch.int64)))
    idx = (n - 1) - (torch.topk(key, k, sorted=True).values & ((1 << sh) - 1))
    return torch.stack([idx // w, idx % w], -1), flat[idx]


def brief_pattern(n_bits=256, patch_size=33, seed=7, n_points=64):
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    sigma = patch_size / 5.0
    pts = set()
    while len(pts) < n_points:
        q = np.clip(np.round(rng.normal(0.0, sigma, size=2)), -half, half)
        pts.add((int(q[0]), int(q[1])))
    points = np.asarray(sorted(pts), dtype=np.int64)
    pairs = set()
    while len(pairs) < n_bits:
        i, j = rng.integers(0, n_points, size=2)
        if i != j and (i, j) not in pairs and (j, i) not in pairs:
            pairs.add((int(i), int(j)))
    return points, np.asarray(sorted(pairs), dtype=np.int64)


def smooth(gray, sigma):
    """Separable 9-tap Gaussian, vertical then horizontal, each tap one
    float32 rounding of a float64 multiply-add."""
    x = np.arange(-4, 5, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    kern = [float(v) for v in (g / g.sum()).astype(np.float32)]
    img = gray.to(torch.float32)
    h, w = img.shape

    def taps(pad, view):
        out = kern[1] * view(pad, 1)
        out = (kern[0] * view(pad, 0).double() + out.double()).float()
        for i in range(2, 9):
            out = (out.double() + kern[i] * view(pad, i).double()).float()
        return out

    pv = nnf.pad(img[None, None], (0, 0, 4, 4), mode="replicate")[0, 0]
    out = taps(pv, lambda p, i: p[i:i + h, :])
    ph = nnf.pad(out[None, None], (4, 4, 0, 0), mode="replicate")[0, 0]
    return taps(ph, lambda p, i: p[:, i:i + w])


def describe(smoothed, yx, points, pairs):
    """(K, 8) BRIEF-256 words (as int64 0..2^32-1) at keypoints ``yx``,
    sampled where the dense planes sample them (clamped to the
    interior)."""
    h, w = smoothed.shape
    half = int(np.abs(points).max())
    ih, iw = h - 2 * half, w - 2 * half
    y = torch.clamp(yx[:, 0] - half, 0, ih - 1) + half
    x = torch.clamp(yx[:, 1] - half, 0, iw - 1) + half
    vals = torch.stack([smoothed[y + int(dy), x + int(dx)]
                        for dy, dx in points], -1)            # (K, P)
    bits = (vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]).to(torch.int64)
    weights = (1 << torch.arange(32, dtype=torch.int64))
    return (bits.reshape(-1, pairs.shape[0] // 32, 32) * weights).sum(-1)


def hamming(a, b):
    """(F, W) x (K, W) words (0..2^32-1) -> (F, K) bit differences."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :])
    count = torch.zeros(x.shape[:2], dtype=torch.int64)
    for j in range(32):
        count += ((x >> j) & 1).sum(-1)
    return count


def subpixel(raw, xy, ok):
    h, w = raw.shape
    ix = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 1, w - 2)
    iy = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 1, h - 2)
    c0 = raw[iy, ix]

    def para(m, q):
        den = m - 2.0 * c0 + q
        big = torch.abs(den) > 1e-9
        off = torch.where(big, 0.5 * (m - q) / torch.where(
            big, den, torch.ones_like(den)), torch.zeros_like(den))
        return torch.clamp(off, -0.5, 0.5)

    d = torch.stack([para(raw[iy, ix - 1], raw[iy, ix + 1]),
                     para(raw[iy - 1, ix], raw[iy + 1, ix])], -1)
    return xy + d.to(xy.dtype) * ok[:, None].to(xy.dtype)


def zone_balanced(kp_xy, score, avail, pred_uv, pred_vis, n_iter: int,
                  radius: float, zones: int, w: int, h: int, max_new: int,
                  follow=None, tie=None):
    """The new-feature picks, one at a time (DetectNewImageFeatures.cpp):
    the least-populated zone of a ``zones`` x ``zones`` grid that still has
    an available keypoint (visible predictions and earlier picks count,
    ties to the lower zone id), its strongest keypoint (ties to the first
    in keypoint order), each pick taking the keypoints within ``radius``
    out.  Returns (the picked pixels (n, 2) float32, n at most
    min(n_iter, max_new); rows off; knife edges).

    With ``follow``, the program's (C, 2) picks, each pick is held against
    the program's: where they differ, the program's is a knife edge when
    it lies in the same zone, outside the earlier picks' radius, and
    ``tie(its pixel, the plain pixel)`` (their scores equal to rounding);
    then the picks go on from the program's, else the row is off and they
    go on from the plain one."""
    zone_w, zone_h = w // zones, h // zones

    def zone(xy):
        zx = np.clip(np.trunc(xy[:, 0]).astype(np.int64) // zone_w, 0,
                     zones - 1)
        zy = np.clip(np.trunc(xy[:, 1]).astype(np.int64) // zone_h, 0,
                     zones - 1)
        return zy * zones + zx

    kp_xy = np.asarray(kp_xy, np.float32)
    score = np.asarray(score, np.float32)
    avail = np.asarray(avail, bool).copy()
    kp_zone = zone(kp_xy)
    pop = np.bincount(zone(np.asarray(pred_uv, np.float32))[
        np.asarray(pred_vis, bool)], minlength=zones * zones)
    r2 = np.float32(radius) * np.float32(radius)
    picks, off, edges = [], 0, 0
    for i in range(min(n_iter, max_new)):
        has = np.bincount(kp_zone[avail], minlength=zones * zones) > 0
        if not has.any():
            break
        z = int(np.argmin(np.where(has, pop, np.iinfo(np.int64).max)))
        k = int(np.argmax(np.where(avail & (kp_zone == z), score,
                                   -np.inf)))
        xy = kp_xy[k]
        if follow is not None and (follow[i] != xy).any():
            q = np.asarray(follow[i], np.float32)
            clear = all(((q - c) ** 2).sum(dtype=np.float32) > r2
                        for c in picks)
            if q.any() and zone(q[None])[0] == z and clear and tie(q, xy):
                edges += 1
                xy = q
            else:
                off += 1
        d = kp_xy - xy
        avail &= ~((d * d).sum(1, dtype=np.float32) <= r2)
        pop[z] += 1
        picks.append(xy)
    if follow is not None:
        off += int(np.asarray(follow)[len(picks):].any(1).sum())
    return np.asarray(picks, np.float32).reshape(-1, 2), off, edges


def words(d) -> np.ndarray:
    """Descriptor words as int64 0..2^32-1 (the program stores the uint32
    bits as int32)."""
    return np.asarray(d).astype(np.int64) & 0xFFFFFFFF


def bits_apart(a, b) -> np.ndarray:
    """Differing bits of each row of two (n, W) word arrays."""
    x = np.bitwise_xor(words(a), words(b)).astype(np.uint64)
    return np.unpackbits(x.view(np.uint8), axis=-1).reshape(
        len(x), -1).sum(1)


class FrontEnd:
    """The configuration's front end (configs/*.json), on the CPU."""

    def __init__(self, cfg: dict, reduced: bool = False):
        det, desc, ekf = cfg["detector"], cfg["descriptor"], cfg["ekf"]
        self.reduced = reduced
        self.det, self.desc = det, desc
        self.k = int(cfg["max_keypoints"])
        self.max_new = int(cfg["max_features"])
        self.gate = cfg["gate_scale"] ** 2 * cfg["chi2_95_2"]
        self.ratio = ekf["matching_comp_coef_second_best_vs_first"]
        self.subpixel = bool(cfg["subpixel_matches"])
        self.radius = cfg["gate_scale"] * math.sqrt(
            ekf["detect_new_features_image_mask_ellipse_size"]
            * cfg["chi2_95_2"])
        self.zones = 2 ** int(
            ekf["detect_new_features_image_areas_divide_times"])
        self.points, self.pairs = brief_pattern(
            desc["n_bits"], desc["patch_size"], desc["pattern_seed"])
        self.border = max(desc["patch_size"] // 2 + 1,
                          desc["orientation_radius"], desc["float_radius"],
                          desc["patch_radius"], 4)

    def frame(self, gray: np.ndarray) -> dict:
        """The maps of one frame: the score before and after suppression,
        the smoothed image, the border mask."""
        g = torch.from_numpy(np.ascontiguousarray(gray))
        h, w = g.shape
        raw, nms = star_maps(g, self.det["star_max_size"],
                             self.det["star_response_threshold"],
                             self.det["star_line_threshold"],
                             self.det["nonmax_radius"], self.reduced)
        ys = torch.arange(h)[:, None]
        xs = torch.arange(w)[None, :]
        m = self.border
        border = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
        return dict(raw=raw, nms=nms, border=border,
                    smoothed=smooth(g, self.desc["blur_sigma"]))

    def describe_at(self, fr: dict, yx) -> torch.Tensor:
        return describe(fr["smoothed"], torch.as_tensor(yx, dtype=torch.int64),
                        self.points, self.pairs)

    def match(self, fr: dict, pred_uv, pred_S, vis, map_desc):
        """(z (F, 2), matched (F,), Mahalanobis distances, the matched
        keypoint's descriptor (F, 8) and pixel (F, 2)) of one frame's maps
        ``fr``, from the
        program's predictions (float32 on the CPU) and the map's
        descriptors ((F, 8) words as int64)."""
        h, w = fr["nms"].shape
        mask = ellipse_mask(h, w, pred_uv, pred_S, vis, self.gate) \
            & fr["border"]
        yx, score = top_keypoints(fr["nms"], mask, self.k)
        valid = score > 0
        kp_desc = self.describe_at(fr, yx)
        kp_xy = torch.stack([yx[:, 1], yx[:, 0]], -1).to(pred_uv.dtype)
        dx = kp_xy[None, :, 0] - pred_uv[:, None, 0]
        dy = kp_xy[None, :, 1] - pred_uv[:, None, 1]
        Si = inv2(pred_S)
        md = (Si[:, 0, 0][:, None] * dx * dx
              + 2.0 * Si[:, 0, 1][:, None] * dx * dy
              + Si[:, 1, 1][:, None] * dy * dy)
        gated = (md <= self.gate) & valid[None, :] & vis[:, None]
        dist = torch.where(gated, hamming(map_desc, kp_desc),
                           torch.full(gated.shape, BIG, dtype=torch.int64))
        d1, best = torch.min(dist, 1)
        d2 = torch.where(torch.arange(dist.shape[1])[None, :]
                         == best[:, None], BIG, dist).amin(1)
        n = gated.sum(1)
        ok = vis & (n > 0) & ((n == 1) | ((n >= 2) & (
            d1.to(pred_uv.dtype) <= d2.to(pred_uv.dtype) * self.ratio)))
        z = torch.where(ok[:, None], kp_xy[best], torch.zeros_like(
            kp_xy[best]))
        pixel = z.clone()
        if self.subpixel:
            z = subpixel(fr["raw"].to(pred_uv.dtype), z, ok)
        return z, ok, md, kp_desc[best], pixel

    def candidates(self, fr: dict, n_iter: int, pred_uv=None, pred_S=None,
                   vis=None, follow=None, rel: float = 0.0):
        """New-feature candidates away from the visible predictions' gate
        ellipses (anywhere in the border without predictions): (uv (C, 2)
        float32 in pick order, zero past the picks; their (n, 2) row and
        column; rows off and knife edges against ``follow``, the
        program's picks, where scores before suppression within ``rel``
        of each other tie)."""
        h, w = fr["nms"].shape
        mask = fr["border"]
        if pred_uv is None:
            pred_uv = torch.zeros((1, 2), dtype=torch.float32)
            vis = torch.zeros((1,), dtype=torch.bool)
        else:
            mask = mask & ~ellipse_mask(h, w, pred_uv, pred_S, vis,
                                        self.gate)
        yx, score = top_keypoints(fr["nms"], mask, self.k)
        xy = torch.stack([yx[:, 1], yx[:, 0]], -1).to(torch.float32)
        raw = fr["raw"]

        def tie(q, r):
            a = float(raw[int(round(q[1])), int(round(q[0]))])
            b = float(raw[int(round(r[1])), int(round(r[0]))])
            return abs(a - b) <= rel * max(abs(a), abs(b))

        picks, off, edges = zone_balanced(
            xy.numpy(), score.numpy(), (score > 0).numpy(),
            pred_uv.to(torch.float32).numpy(), vis.numpy(), n_iter,
            self.radius, self.zones, w, h, self.max_new,
            None if follow is None else np.asarray(follow, np.float32), tie)
        uv = np.zeros((self.max_new, 2), np.float32)
        uv[:len(picks)] = picks
        return uv, np.rint(picks[:, ::-1]).astype(np.int64), off, edges
