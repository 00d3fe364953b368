"""NCC patch-correlation active-search matching, detection-free (port of
vision/ncc.py).

Each landmark stores a zero-mean unit-norm appearance patch in its
descriptor slot (kind "PATCH").  A frame slices a fixed search window
around every predicted pixel, correlates all F windows against their
patches with one grouped convolution, normalises by the windows' local
statistics (box-sum convolutions of the mean-centred window and its
square), gates the
candidate centres by the Mahalanobis test d^T S^-1 d <= gate, and keeps
the best NCC above ``min_corr`` with a least-squares subpixel fit.

Everything is statically shaped (F windows of (2 search_radius + 1)^2
candidate centres, masked where invalid) and reads nothing back to the
host.  The image, the templates and the correlation are float32 whatever
the state's dtype; the candidate grid takes ``pred_uv``'s dtype.  The
convolutions are PyTorch's (cuDNN on the card), as they are XLA's
convolutions outside any Pallas kernel in the JAX package; they run in
true float32, never TF32.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as nnf

from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.vision.matching import Matches, _inv_2x2

# the gated-out correlation (below any NCC) and the unmatched distance
_NO_CORR = -2.0
_NO_MATCH_DISTANCE = 1 << 20


@contextlib.contextmanager
def _true_fp32():
    """cuDNN convolutions in float32, not TF32, inside the block (a no-op
    once ``SlamRuntime`` has turned TF32 off for the process)."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    if saved:
        cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if saved:
            cudnn.allow_tf32 = True


def _normalise(v: torch.Tensor) -> torch.Tensor:
    """Rows of (K, P) made zero-mean and unit-norm."""
    v = v - torch.mean(v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)
    return v / n


def _windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             side: int) -> torch.Tensor:
    """(K, side, side) windows of ``img`` at the (K,) origins, gathered on
    the device."""
    d = torch.arange(side, device=img.device)
    ys = (y0.to(torch.long)[:, None] + d[None, :])[:, :, None]
    xs = (x0.to(torch.long)[:, None] + d[None, :])[:, None, :]
    return img[ys, xs]


def extract_patches(smoothed: torch.Tensor, yx: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """(K, (2r+1)^2) zero-mean unit-norm patch vectors at integer pixels
    (edge-clamped)."""
    h, w = smoothed.shape
    d = torch.arange(-radius, radius + 1, device=smoothed.device)
    yx = yx.to(torch.long)
    ys = torch.clamp(yx[:, 0:1] + d[None, :], 0, h - 1)
    xs = torch.clamp(yx[:, 1:2] + d[None, :], 0, w - 1)
    patch = smoothed[ys[:, :, None], xs[:, None, :]]
    return _normalise(patch.reshape(patch.shape[0], -1).to(torch.float32))


def extract_patches_bilinear(smoothed: torch.Tensor, yx: torch.Tensor,
                             radius: int) -> torch.Tensor:
    """(K, (2r+1)^2) zero-mean unit-norm patches at SUBPIXEL centres.

    The sample grid is the centre plus integer offsets, so one (P+1)^2
    window per keypoint, blended by two scalar weights, gives the bilinear
    patch.  Templates refreshed at a matched subpixel position are centred
    exactly there (rounding would plant up to 0.5 px of bias that later
    correlation peaks inherit)."""
    h, w = smoothed.shape
    img = smoothed.to(torch.float32)
    P = 2 * radius + 1
    yf = yx[:, 0].to(torch.float32)
    xf = yx[:, 1].to(torch.float32)
    y0 = torch.clamp(torch.floor(yf).to(torch.int32) - radius, 0, h - P - 1)
    x0 = torch.clamp(torch.floor(xf).to(torch.int32) - radius, 0, w - P - 1)
    # weights relative to the clipped window origin: exact bilinear
    # wherever the window was not clipped
    ay = torch.clamp(yf - radius - y0.to(torch.float32), 0.0, 1.0)[:, None,
                                                                   None]
    ax = torch.clamp(xf - radius - x0.to(torch.float32), 0.0, 1.0)[:, None,
                                                                   None]
    win = _windows(img, y0, x0, P + 1)                      # (K, P+1, P+1)
    patch = (win[:, :-1, :-1] * (1 - ay) * (1 - ax)
             + win[:, :-1, 1:] * (1 - ay) * ax
             + win[:, 1:, :-1] * ay * (1 - ax)
             + win[:, 1:, 1:] * ay * ax)
    return _normalise(patch.reshape(patch.shape[0], -1))


@functools.lru_cache(maxsize=8)
def _warp_constants(fx: float, fy: float, cx: float, cy: float,
                    device: torch.device) -> tuple:
    """(identity quaternion, K, K^-1), float32 on ``device``, uploaded once
    per camera and device (a host-to-device copy from a Python list would
    wait on the stream every frame); callers never write to them."""
    return tuple(
        torch.tensor(v, dtype=torch.float32, device=device) for v in (
            [1.0, 0.0, 0.0, 0.0],
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
            [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy],
             [0.0, 0.0, 1.0]]))


def warp_templates(patches: torch.Tensor, patch_pose: torch.Tensor,
                   feats: torch.Tensor, is_xyz: torch.Tensor,
                   cam7: torch.Tensor, pred_uv: torch.Tensor,
                   visible: torch.Tensor, fx: float, fy: float,
                   cx: float, cy: float, patch_radius: int) -> torch.Tensor:
    """Each stored template as the current camera should see it: the
    homography of the landmark's patch plane (through its 3D point,
    fronto-parallel to the capture view),

        H_0<-1 = K (R_rel + t_rel n1^T / d1) K^-1,

    with R_rel = R0^T R1, t_rel = R0^T (r1 - r0), n1 the plane normal in
    the current camera and d1 its distance; the stored patch is bilinearly
    resampled (edge-clamped) on the warped grid and re-normalised.  Slots
    with no stored pose (q == 0), the plane behind the camera, or not
    visible keep the stored template.

    ``patches`` (F, ps*ps); ``patch_pose`` (F, 7) capture (r, q);
    ``feats`` (F, 6); ``pred_uv`` (F, 2).  Returns (F, ps*ps) float32."""
    f = patches.shape[0]
    pr = patch_radius
    ps = 2 * pr + 1
    f32 = torch.float32
    dev = patches.device
    feats = feats.to(f32)
    cam7 = cam7.to(f32)
    pred_uv = pred_uv.to(f32)

    # landmark world point (inverse-depth slots through anchor + m / rho)
    m = quat.directional_vector(feats[:, 3], feats[:, 4])
    rho = feats[:, 5]
    rho_s = torch.where(torch.abs(rho) < 1e-12,
                        torch.full_like(rho, 1e-12), rho)
    p_w = torch.where(is_xyz[:, None], feats[:, 0:3],
                      feats[:, 0:3] + m / rho_s[:, None])

    r0, q0 = patch_pose[:, 0:3], patch_pose[:, 3:7]
    has_pose = torch.sum(q0 * q0, dim=-1) > 0.25
    ident, K, Kinv = _warp_constants(float(fx), float(fy), float(cx),
                                     float(cy), torch.device(dev))
    q0_safe = torch.where(has_pose[:, None], q0, ident[None])
    q0_safe = q0_safe / torch.linalg.vector_norm(q0_safe, dim=-1,
                                                 keepdim=True)
    R0 = quat.to_rotation_matrix(q0_safe)                   # (F, 3, 3)
    r1, q1 = cam7[0:3], cam7[3:7]
    R1 = quat.to_rotation_matrix(q1 / torch.linalg.vector_norm(q1))

    to_p = p_w - r0                                         # capture ray
    d0 = torch.linalg.vector_norm(to_p, dim=-1)
    n_w = to_p / torch.clamp(d0, min=1e-9)[:, None]         # plane normal
    d1 = torch.sum(n_w * (p_w - r1[None, :]), dim=-1)       # (F,)

    R0T = R0.transpose(1, 2)
    R_rel = torch.einsum("fij,jk->fik", R0T, R1)
    t_rel = (torch.einsum("fij,j->fi", R0T, r1)
             - torch.einsum("fij,fj->fi", R0T, r0))         # R0^T (r1 - r0)
    n1 = torch.einsum("ji,fj->fi", R1, n_w)                 # R1^T n_w

    d1_ok = d1 > 1e-3
    d1_safe = torch.where(d1_ok, d1, torch.ones_like(d1))
    M = R_rel + t_rel[:, :, None] * n1[:, None, :] / d1_safe[:, None, None]

    H = torch.einsum("ij,fjk,kl->fil", K, M, Kinv)          # (F, 3, 3)

    # the current template's pixel grid, warped into capture coordinates
    d = torch.arange(-pr, pr + 1, dtype=f32, device=dev)
    gx = (pred_uv[:, 0][:, None, None] + d[None, None, :]).expand(f, ps, ps)
    gy = (pred_uv[:, 1][:, None, None] + d[None, :, None]).expand(f, ps, ps)
    u = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (F, ps, ps, 3)
    u0h = torch.einsum("fij,fabj->fabi", H, u)
    wz = torch.where(torch.abs(u0h[..., 2]) > 1e-6, u0h[..., 2],
                     torch.ones_like(u0h[..., 2]))
    u0 = u0h[..., 0:2] / wz[..., None]
    # template coordinates are relative to the warped centre (the capture
    # projection of the landmark): a differential warp
    c = torch.stack([pred_uv[:, 0], pred_uv[:, 1],
                     torch.ones((f,), dtype=f32, device=dev)], dim=-1)
    c0h = torch.einsum("fij,fj->fi", H, c)
    cz = torch.where(torch.abs(c0h[..., 2]) > 1e-6, c0h[..., 2],
                     torch.ones_like(c0h[..., 2]))
    c0 = c0h[..., 0:2] / cz[..., None]
    sx = u0[..., 0] - c0[:, None, None, 0] + pr             # (F, ps, ps)
    sy = u0[..., 1] - c0[:, None, None, 1] + pr

    # bilinear resampling of the stored template: the JAX package writes
    # it as two one-hot interpolation matrices contracted on the MXU; the
    # same two weights a pixel and axis are a gather of four taps here
    x0i = torch.clamp(torch.floor(sx), 0, ps - 2).to(torch.long)
    y0i = torch.clamp(torch.floor(sy), 0, ps - 2).to(torch.long)
    ax = torch.clamp(sx - x0i, 0.0, 1.0)
    ay = torch.clamp(sy - y0i, 0.0, 1.0)
    T = patches.to(f32).reshape(f, ps * ps)

    def tap(yi, xi):
        return torch.gather(T, 1, (yi * ps + xi).reshape(f, -1)
                            ).reshape(f, ps, ps)

    warped = ((1.0 - ay) * ((1.0 - ax) * tap(y0i, x0i)
                            + ax * tap(y0i, x0i + 1))
              + ay * ((1.0 - ax) * tap(y0i + 1, x0i)
                      + ax * tap(y0i + 1, x0i + 1)))
    v = _normalise(warped.reshape(f, ps * ps))
    ok = has_pose & d1_ok & visible
    return torch.where(ok[:, None], v, patches.to(f32))


def _box_sums(x: torch.Tensor, ps: int) -> torch.Tensor:
    """(F, ss, ss) sums of every ps x ps box of the (F, rs, rs) windows."""
    f = x.shape[0]
    ones = torch.ones((f, 1, ps, ps), dtype=x.dtype, device=x.device)
    return nnf.conv2d(x[None], ones, groups=f)[0]


def gated_ncc(smoothed: torch.Tensor, pred_uv: torch.Tensor,
              pred_S: torch.Tensor, visible: torch.Tensor,
              patches: torch.Tensor, gate: float, patch_radius: int,
              search_radius: int,
              corr_patches: torch.Tensor | None = None) -> tuple:
    """The NCC map of every landmark over its search window, -2 where the
    candidate centre fails the Mahalanobis gate or the slot is not
    visible: (ncc (F, ss, ss) float32, cand_x, cand_y (F, ss, ss) in
    ``pred_uv``'s dtype), ss = 2 search_radius + 1.

    With ``corr_patches`` (warp_templates), the stored and the warped
    template of each landmark are both correlated (2F groups), and each
    landmark's map is that of the template with the higher gated peak."""
    h, w = smoothed.shape
    f = pred_uv.shape[0]
    dev = pred_uv.device
    pr, sr = patch_radius, search_radius
    ps = 2 * pr + 1          # patch side
    ss = 2 * sr + 1          # candidate-centre grid side
    rs = ss + ps - 1         # window side covering every candidate

    img = smoothed.to(torch.float32)
    cx = torch.round(pred_uv[:, 0]).to(torch.int32)
    cy = torch.round(pred_uv[:, 1]).to(torch.int32)
    y0 = torch.clamp(cy - sr - pr, 0, h - rs)
    x0 = torch.clamp(cx - sr - pr, 0, w - rs)
    windows = _windows(img, y0, x0, rs)                     # (F, rs, rs)

    n_tpl = 1 if corr_patches is None else 2
    if corr_patches is None:
        kernel = patches.to(torch.float32).reshape(f, 1, ps, ps)
        conv_in = windows[None]
    else:
        kernel = torch.cat([patches, corr_patches], dim=0).to(
            torch.float32).reshape(2 * f, 1, ps, ps)
        conv_in = torch.cat([windows, windows], dim=0)[None]
    # local variance over each ps x ps support from box sums of the window
    # and its square, taken about the window's mean: the variance is the
    # same, and float32 no longer loses it to cancellation (about 37x on a
    # 0-255 texture, which left the JAX package's own float32 maps within
    # 4e-6 of float64 and PyTorch's CPU convolution's within 1.4e-5)
    centred = windows - torch.mean(windows, dim=(1, 2), keepdim=True)
    with _true_fp32():
        corr = nnf.conv2d(conv_in, kernel, groups=n_tpl * f)[0]
        wsum = _box_sums(centred, ps)
        w2sum = _box_sums(centred * centred, ps)
    n = float(ps * ps)
    var = torch.clamp(w2sum - wsum * wsum / n, min=0.0)
    denom = torch.sqrt(var + 1e-8)                          # (F, ss, ss)

    # candidate centre (x, y) of each grid cell, Mahalanobis-gated
    grid = torch.arange(ss, dtype=torch.int32, device=dev)
    cand_y = (y0[:, None, None] + pr + grid[None, :, None]).to(
        pred_uv.dtype).expand(f, ss, ss)
    cand_x = (x0[:, None, None] + pr + grid[None, None, :]).to(
        pred_uv.dtype).expand(f, ss, ss)
    dx = cand_x - pred_uv[:, 0][:, None, None]
    dy = cand_y - pred_uv[:, 1][:, None, None]
    Sinv = _inv_2x2(pred_S)
    md = (Sinv[:, 0, 0][:, None, None] * dx * dx
          + 2.0 * Sinv[:, 0, 1][:, None, None] * dx * dy
          + Sinv[:, 1, 1][:, None, None] * dy * dy)
    ok = (md <= gate) & visible[:, None, None]

    no_corr = torch.full((), _NO_CORR, dtype=torch.float32, device=dev)
    if n_tpl == 1:
        return torch.where(ok, corr / denom, no_corr), cand_x, cand_y
    # gate both maps before picking the template (a spurious peak outside
    # the gate must not pick the worse one); the winner's whole gated map
    # then feeds the argmax and the subpixel fit
    ncc2_g = torch.where(ok[None], corr.reshape(2, f, ss, ss)
                         / denom[None], no_corr)
    peak = torch.amax(ncc2_g.reshape(2, f, ss * ss), dim=-1)      # (2, F)
    win = torch.argmax(peak, dim=0)                                # (F,)
    return (torch.where((win == 1)[:, None, None], ncc2_g[1], ncc2_g[0]),
            cand_x, cand_y)


def ncc_match(smoothed: torch.Tensor, pred_uv: torch.Tensor,
              pred_S: torch.Tensor, visible: torch.Tensor,
              patches: torch.Tensor, gate: float,
              patch_radius: int, search_radius: int,
              min_corr: float = 0.8,
              refresh_below: float = 0.93,
              corr_patches: torch.Tensor | None = None) -> Matches:
    """Correlate every landmark's patch over its gated search window
    (``gated_ncc``) and take the best candidate with a subpixel fit.

    ``patches`` (F, (2pr+1)^2) normalised patch vectors; ``pred_uv`` (F, 2)
    predicted pixels (x, y).  Returns ``Matches``: ``desc`` holds the patch
    re-extracted at the match where the lazy refresh fires (``refreshed``)
    and the stored one elsewhere; ``distance`` is round(1000 (1 - NCC)),
    int32.

    ``corr_patches`` (warp_templates) are correlated beside the stored
    ``patches``; only ``patches`` can survive into ``desc`` (storing a
    warped template back would compound the warp over frames)."""
    h, w = smoothed.shape
    f = pred_uv.shape[0]
    pr = patch_radius
    ss = 2 * search_radius + 1
    img = smoothed.to(torch.float32)
    ncc_g, cand_x, cand_y = gated_ncc(img, pred_uv, pred_S, visible,
                                      patches, gate, patch_radius,
                                      search_radius, corr_patches)

    flat = ncc_g.reshape(f, ss * ss)
    best = torch.argmax(flat, dim=-1)
    best_ncc = torch.gather(flat, 1, best[:, None])[:, 0]
    by = best // ss
    bx = best % ss
    zx = torch.gather(cand_x.reshape(f, -1), 1, best[:, None])[:, 0]
    zy = torch.gather(cand_y.reshape(f, -1), 1, best[:, None])[:, 0]

    # subpixel peak: the least-squares 2-D quadratic over the 3x3
    # neighbourhood (closed form on the unit grid), which follows a tilted
    # correlation ridge; the 1-D parabola pair where the 3x3 support
    # crosses the gate (cells at the -2 sentinel) or is not concave
    def neighbor(ddy, ddx):
        iy = torch.clamp(by + ddy, 0, ss - 1)
        ix = torch.clamp(bx + ddx, 0, ss - 1)
        return torch.gather(flat, 1, (iy * ss + ix)[:, None])[:, 0]

    c0 = best_ncc

    def para_offset(mv, pv):
        den = mv - 2.0 * c0 + pv
        off = torch.where(torch.abs(den) > 1e-9, 0.5 * (mv - pv) / den,
                          torch.zeros_like(den))
        return torch.clamp(off, -0.5, 0.5)

    all_valid = torch.ones_like(c0, dtype=torch.bool)
    S0 = Sx = Sy = Sxx = Syy = Sxy = 0.0
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            v = neighbor(ddy, ddx)
            all_valid = all_valid & (v > -1.5)
            S0 = S0 + v
            Sx = Sx + v * ddx
            Sy = Sy + v * ddy
            Sxx = Sxx + v * (ddx * ddx)
            Syy = Syy + v * (ddy * ddy)
            Sxy = Sxy + v * (ddx * ddy)
    # coefficients of a + b x + c y + dxx x^2 + e x y + fyy y^2
    b = Sx / 6.0
    cc = Sy / 6.0
    e = Sxy / 4.0
    dxx = (3.0 * Sxx - 2.0 * S0) / 6.0
    fyy = (3.0 * Syy - 2.0 * S0) / 6.0
    det = 4.0 * dxx * fyy - e * e
    concave = (dxx < 0) & (det > 1e-9)
    det_safe = torch.where(concave, det, torch.ones_like(det))
    dx2 = torch.clamp(-(2.0 * fyy * b - e * cc) / det_safe, -0.5, 0.5)
    dy2 = torch.clamp(-(2.0 * dxx * cc - e * b) / det_safe, -0.5, 0.5)

    xm, xp = neighbor(0, -1), neighbor(0, 1)
    ym, yp = neighbor(-1, 0), neighbor(1, 0)
    zero = torch.zeros_like(c0)
    dx1 = torch.where((xm > -1.5) & (xp > -1.5), para_offset(xm, xp), zero)
    dy1 = torch.where((ym > -1.5) & (yp > -1.5), para_offset(ym, yp), zero)
    use2d = all_valid & concave
    zx = zx + torch.where(use2d, dx2, dx1).to(zx.dtype)
    zy = zy + torch.where(use2d, dy2, dy1).to(zy.dtype)

    matched = visible & (best_ncc >= min_corr)
    zxy = torch.stack([zx, zy], dim=-1)
    z = torch.where(matched[:, None], zxy, torch.zeros_like(zxy))

    # lazy template refresh (the MapManagement.cpp:104-112 descriptor
    # refresh): keep the stored patch while it still correlates strongly,
    # since re-storing every frame integrates subpixel template drift; and
    # never within a patch radius of the border, where the bilinear
    # window's origin clip would store a shifted template
    new_patches = extract_patches_bilinear(img, torch.stack([zy, zx], -1),
                                           pr)
    in_interior = ((zy >= pr + 1) & (zy < h - pr - 1)
                   & (zx >= pr + 1) & (zx < w - pr - 1))
    refresh = matched & (best_ncc < refresh_below) & in_interior
    desc = torch.where(refresh[:, None], new_patches,
                       patches.to(torch.float32))

    dist = torch.round((1.0 - best_ncc) * 1000.0).to(torch.int32)
    return Matches(z=z, matched=matched, desc=desc,
                   distance=torch.where(
                       matched, dist,
                       torch.full_like(dist, _NO_MATCH_DISTANCE)),
                   refreshed=refresh)
