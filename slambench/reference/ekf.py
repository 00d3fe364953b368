"""Plain reference of one frame of the inverse-depth EKF, and of the
bootstrap, written from the filter's equations in plain PyTorch.

It works in the slot layout a run's state is read in (camera state
x[0:13], slot i at x[13 + 6 i: 19 + 6 i], P padded to N with zero rows for
dead dims), so that it can start from any state the program reached and
take one step.  Every Jacobian (motion, measurement, addition, conversion,
quaternion normalisation) is taken by plain autograd through the value
function; the updates invert S explicitly on the used rows
only.  Nothing of the program is imported.

Precision: every function computes in the dtype and on the device of the
tensors it is given; ``Matmul`` rounds the operands of every covariance
product to TF32 when asked to, which is the control of ``check.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

CAM, FD = 13, 6
NEWTON_STEPS = 11      # 10 Newton iterations plus one more, as the filter


@dataclasses.dataclass(frozen=True)
class Params:
    """The configuration's numbers the filter uses (configs/*.json)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    dx: float
    dy: float
    width: int
    height: int
    pe_x: float
    pe_y: float
    tan_x: float
    tan_y: float
    rho0: float
    init_lin_sd: float
    init_ang_sd: float
    lin_sd: float
    ang_sd: float
    rho_sd: float
    max_map_size: int
    max_map_features: int
    always_remove_unseen: bool
    mm_frequency: int
    min_matches: int
    good_percent: float
    ransac_threshold: float
    chi2_rescue: float
    li_threshold: float
    n_slots: int
    n_state: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        cam, ekf = cfg["camera"], cfg["ekf"]
        n_slots = int(cfg["max_features"])
        logical = CAM + FD * n_slots
        pad = max(int(cfg["pad_state_to"]), 1)
        return cls(
            fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
            k1=cam["k1"], k2=cam["k2"], dx=cam["dx"], dy=cam["dy"],
            width=cam["pixels_x"], height=cam["pixels_y"],
            pe_x=cam["pixel_error_x"], pe_y=cam["pixel_error_y"],
            tan_x=math.tan(math.radians(cam["angular_vision_x"])),
            tan_y=math.tan(math.radians(cam["angular_vision_y"])),
            rho0=ekf["init_inv_depth_rho"],
            init_lin_sd=ekf["init_linear_accel_sd"],
            init_ang_sd=ekf["init_angular_accel_sd"],
            lin_sd=ekf["linear_accel_sd"], ang_sd=ekf["angular_accel_sd"],
            rho_sd=ekf["inverse_depth_rho_sd"],
            max_map_size=ekf["max_map_size"],
            max_map_features=ekf["max_map_features_count"],
            always_remove_unseen=ekf["always_remove_unseen_map_features"],
            mm_frequency=ekf["map_management_frequency"],
            min_matches=ekf["min_matches_per_image"],
            good_percent=ekf["good_feature_matching_percent"],
            ransac_threshold=ekf["ransac_threshold_predict_distance"],
            chi2_rescue=ekf["ransac_chi2_threshold"],
            li_threshold=ekf["inverse_depth_linearity_index_threshold"],
            n_slots=n_slots, n_state=((logical + pad - 1) // pad) * pad)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) with its mantissa rounded to TF32's 10 bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Matmul:
    """The covariance products: exact in the operands' dtype, or with both
    operands rounded to TF32 first (``reduced``), as a tensor core does."""

    def __init__(self, reduced: bool = False):
        self.reduced = reduced

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.reduced:
            return tf32(a.float()) @ tf32(b.float())
        return a @ b


# ------------------------------------------------------------ geometry
# Every function takes its arguments with any leading (batch) dims.

def jacobian(fn, x: torch.Tensor) -> torch.Tensor:
    """d fn(x) / dx for fn: (n,) -> (m,), by one backward pass an output
    (plain autograd)."""
    x = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        y = fn(x)
        rows = [torch.autograd.grad(y[i], x, retain_graph=True)[0]
                for i in range(y.shape[0])]
    return torch.stack(rows).detach()


def rot(q: torch.Tensor) -> torch.Tensor:
    """R(q), camera to world, for q = (w, x, y, z) not necessarily unit."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                     2 * (z * x + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (z * x - w * y), 2 * (y * z + w * x),
                     w * w - x * x - y * y + z * z], -1)], -2)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def rotvec_quat(v: torch.Tensor) -> torch.Tensor:
    """Unit quaternion of the rotation vector v (3,); a series below
    1e-6."""
    n2 = v @ v
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    s = torch.where(small, 0.5 - n2 / 48.0, torch.sin(0.5 * n) / n)
    c = torch.where(small, 1.0 - n2 / 8.0, torch.cos(0.5 * n))
    return torch.cat([c[None], s * v])


def ray(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(phi) * torch.sin(theta), -torch.sin(phi),
                        torch.cos(phi) * torch.cos(theta)], -1)


def p_camera(cam7: torch.Tensor, f: torch.Tensor, xyz: torch.Tensor
             ) -> torch.Tensor:
    """A slot's point in the camera frame (before any clamp of z)."""
    r, q = cam7[..., 0:3], cam7[..., 3:7]
    a_inv = f[..., 5:6] * (f[..., 0:3] - r) + ray(f[..., 3], f[..., 4])
    a = torch.where(xyz[..., None], f[..., 0:3] - r, a_inv)
    return (rot(q).transpose(-1, -2) @ a[..., None])[..., 0]


def distort(p: Params, uv: torch.Tensor) -> torch.Tensor:
    """Undistorted to distorted pixel: the radial polynomial inverted by
    Newton's method on the metric radius."""
    du, dv = uv[..., 0] - p.cx, uv[..., 1] - p.cy
    r2 = torch.clamp((p.dx * du) ** 2 + (p.dy * dv) ** 2, min=1e-12)
    ru = torch.sqrt(r2)
    rd = ru / (1.0 + p.k1 * r2 + p.k2 * r2 * r2)
    for _ in range(NEWTON_STEPS):
        rd2 = rd * rd
        g = rd + p.k1 * rd2 * rd + p.k2 * rd2 * rd2 * rd - ru
        rd = rd - g / (1.0 + 3.0 * p.k1 * rd2 + 5.0 * p.k2 * rd2 * rd2)
    rd2 = rd * rd
    d = 1.0 + p.k1 * rd2 + p.k2 * rd2 * rd2
    return torch.stack([p.cx + du / d, p.cy + dv / d], -1)


def undistort(p: Params, uv: torch.Tensor) -> torch.Tensor:
    """Distorted to undistorted pixel by the one-shot polynomial."""
    du, dv = uv[..., 0] - p.cx, uv[..., 1] - p.cy
    r2 = (p.dx * du) ** 2 + (p.dy * dv) ** 2
    d = 1.0 + p.k1 * r2 + p.k2 * r2 * r2
    return torch.stack([p.cx + du * d, p.cy + dv * d], -1)


def h(p: Params, cam7: torch.Tensor, f: torch.Tensor, xyz: torch.Tensor
      ) -> torch.Tensor:
    """The predicted distorted pixel of a slot."""
    pc = p_camera(cam7, f, xyz)
    z = pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.ones_like(z), z)
    return distort(p, torch.stack([p.cx + p.fx * pc[..., 0] / z,
                                   p.cy + p.fy * pc[..., 1] / z], -1))


def visible(p: Params, cam7: torch.Tensor, f: torch.Tensor,
            xyz: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    pc = p_camera(cam7, f, xyz)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    return ((z > 0) & (torch.abs(x) < z * p.tan_x)
            & (torch.abs(y) < z * p.tan_y)
            & (uv[..., 0] > 0) & (uv[..., 0] < p.width) & (uv[..., 1] > 0)
            & (uv[..., 1] < p.height))


def visibility_margin(p: Params, cam7, f, xyz, uv) -> torch.Tensor:
    """The smallest relative distance of a slot's visibility tests from
    their edges: a decision within a small margin may round either way."""
    pc = p_camera(cam7, f, xyz)
    z = torch.abs(pc[2]) + 1e-30
    return torch.stack([
        torch.abs(pc[2]) / (torch.abs(pc[0]) + torch.abs(pc[1]) + z),
        torch.abs(torch.abs(pc[0]) - pc[2] * p.tan_x) / z,
        torch.abs(torch.abs(pc[1]) - pc[2] * p.tan_y) / z,
        torch.abs(uv[0]) / p.width, torch.abs(uv[0] - p.width) / p.width,
        torch.abs(uv[1]) / p.height,
        torch.abs(uv[1] - p.height) / p.height]).min()


# ------------------------------------------------------------ the state

@dataclasses.dataclass
class State:
    """The fields of a filter state the reference reads and writes."""

    x: torch.Tensor                 # (N,)
    P: torch.Tensor                 # (N, N)
    active: torch.Tensor            # (F,) bool
    is_xyz: torch.Tensor            # (F,) bool
    times_predicted: torch.Tensor   # (F,) int64
    times_matched: torch.Tensor     # (F,) int64
    frame: int

    def clone(self) -> "State":
        return State(self.x.clone(), self.P.clone(), self.active.clone(),
                     self.is_xyz.clone(), self.times_predicted.clone(),
                     self.times_matched.clone(), self.frame)

    def feats(self) -> torch.Tensor:
        F = self.active.shape[0]
        return self.x[CAM:CAM + FD * F].reshape(F, FD)

    def dim_mask(self) -> torch.Tensor:
        """(N,) bool: the dims that carry a live value."""
        F = self.active.shape[0]
        per = torch.ones((F, FD), dtype=torch.bool, device=self.x.device)
        per[:, 3:] = ~self.is_xyz[:, None]
        per &= self.active[:, None]
        out = torch.zeros_like(self.x, dtype=torch.bool)
        out[:CAM] = True
        out[CAM:CAM + FD * F] = per.reshape(-1)
        return out


def initial_state(p: Params, dtype=torch.float64, device="cpu") -> State:
    x = torch.zeros(p.n_state, dtype=dtype, device=device)
    x[3] = 1.0
    x[10:13] = 2.22e-16
    d = torch.zeros(p.n_state, dtype=dtype, device=device)
    d[0:7] = 2.22e-16
    d[7:10] = p.init_lin_sd ** 2
    d[10:13] = p.init_ang_sd ** 2
    F = p.n_slots
    z = torch.zeros(F, dtype=torch.int64, device=device)
    return State(x, torch.diag(d), torch.zeros(F, dtype=torch.bool,
                                               device=device),
                 torch.zeros(F, dtype=torch.bool, device=device), z,
                 z.clone(), 0)


# ------------------------------------------------------------ the phases

def predict(p: Params, st: State, mm: Matmul) -> State:
    """Constant velocity over one frame, P <- F P F^T + G Q G^T on the
    camera rows and columns."""
    def motion(c):
        q2 = rotvec_quat(c[10:13])
        return torch.cat([c[0:3] + c[7:10], qmul(c[3:7], q2), c[7:13]])

    def motion_noise(c, n):
        return motion(torch.cat([c[:7], c[7:10] + n[0:3],
                                 c[10:13] + n[3:6]]))

    c = st.x[:CAM]
    Fm = jacobian(motion, c)
    G = jacobian(lambda n: motion_noise(c, n),
                 torch.zeros(6, dtype=c.dtype, device=c.device))
    Q = torch.diag(torch.tensor([p.lin_sd ** 2] * 3 + [p.ang_sd ** 2] * 3,
                                dtype=c.dtype, device=c.device))
    out = st.clone()
    out.x = torch.cat([motion(c), st.x[CAM:]])
    P = st.P.clone()
    P[:CAM, :] = mm(Fm, st.P[:CAM, :])
    P[:, :CAM] = mm(P[:, :CAM], Fm.T)
    P[:CAM, :CAM] = P[:CAM, :CAM] + G @ Q @ G.T
    out.P = P
    return out


def measure(p: Params, st: State, mm: Matmul) -> dict:
    """Predicted pixels, visibility and each slot's S = H P H^T + I, with
    the stacked H (2F, N) of the visible slots."""
    cam7 = st.x[:7]
    feats = st.feats()
    F = feats.shape[0]
    c = cam7.expand(F, 7).clone().requires_grad_(True)
    f = feats.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        uv = h(p, c, f, st.is_xyz)
        d0 = torch.autograd.grad(uv[:, 0].sum(), (c, f), retain_graph=True)
        d1 = torch.autograd.grad(uv[:, 1].sum(), (c, f))
    uv = uv.detach()
    Hc = torch.stack([d0[0], d1[0]], 1)                       # (F, 2, 7)
    Hf = torch.stack([d0[1], d1[1]], 1)                       # (F, 2, 6)
    vis = st.active & visible(p, cam7, feats, st.is_xyz, uv)
    Hf = Hf * (~st.is_xyz[:, None, None]
               | (torch.arange(FD, device=uv.device) < 3)[None, None, :])
    N = st.x.shape[0]
    H = torch.zeros((F, 2, N), dtype=st.x.dtype, device=st.x.device)
    H[:, :, :7] = Hc
    for i in range(F):
        H[i, :, CAM + FD * i:CAM + FD * (i + 1)] = Hf[i]
    H = H * vis[:, None, None]
    H = H.reshape(2 * F, N)
    HP = mm(H, st.P)
    S = mm(HP, H.T)
    eye = torch.eye(2, dtype=S.dtype, device=S.device)
    Sii = S.reshape(F, 2, F, 2).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    return dict(uv=torch.where(vis[:, None], uv, torch.zeros_like(uv)),
                vis=vis, H=H, HP=HP, S=S, Sii=Sii + eye)


def ransac(p: Params, st: State, pr: dict, z, matched) -> dict:
    """Every matched slot a hypothesis: a state-only one-point update, then
    every slot re-predicted; the support is the matched slots within the
    threshold.  Returns the winner's inliers, and each hypothesis' pixel
    distances for the margin of its decisions."""
    F = matched.shape[0]
    S1 = pr["Sii"] + (p.pe_x - 1.0) * torch.eye(2, dtype=z.dtype,
                                                device=z.device)
    dz = z - pr["uv"]
    sol = torch.linalg.solve(S1, dz[..., None])[..., 0]     # (F, 2)
    HP = pr["HP"].reshape(F, 2, -1)
    dx = torch.einsum("fin,fi->fn", HP, sol) * matched[:, None]
    xs = st.x[None, :] + dx                                  # (F, N)
    feats = xs[:, CAM:CAM + FD * F].reshape(F, F, FD)

    cams = xs[:, None, :7]                                    # (F, 1, 7)
    uv = h(p, cams, feats, st.is_xyz[None])                  # (F, F, 2)
    vis = visible(p, cams, feats, st.is_xyz[None], uv)
    dist = torch.linalg.vector_norm(z[None] - uv, dim=-1)    # (F, F)
    good = matched[None] & st.active[None] & vis & (dist < p.ransac_threshold)
    support = torch.where(matched, good.sum(1), torch.full_like(
        good.sum(1), -1))
    best = int(torch.argmax(support))
    best_s = max(int(support[best]), 0)
    inl = good[best] & matched & (best_s > 0)
    return dict(inliers=inl, support=support, dist=dist, good=good,
                best=best)


def update(p: Params, st: State, pr: dict, z, use, mm: Matmul) -> State:
    """The joint update over the ``use`` slots, then P symmetrised and q
    renormalised with its Jacobian pushed through P."""
    if not bool(use.any()):
        return st
    rows = use[:, None].expand(-1, 2).reshape(-1)
    HP = pr["HP"][rows]                                      # (M, N)
    S = pr["S"][rows][:, rows] + p.pe_x * torch.eye(
        int(rows.sum()), dtype=HP.dtype, device=HP.device)
    res = (z - pr["uv"])[use].reshape(-1)
    KT = mm(torch.linalg.inv(S), HP)                          # (M, N)
    out = st.clone()
    x = st.x + KT.T @ res
    P = st.P - mm(KT.T, HP)
    P = 0.5 * (P + P.T)
    q = x[3:7]
    Jq = jacobian(lambda v: v / torch.linalg.vector_norm(v), q)
    P[3:7, :] = mm(Jq, P[3:7, :])
    P[:, 3:7] = mm(P[:, 3:7], Jq.T)
    x = x.clone()
    x[3:7] = q / torch.linalg.vector_norm(q)
    out.x, out.P = x, P
    return out


def remove(st: State, gone: torch.Tensor) -> State:
    out = st.clone()
    out.active = st.active & ~gone
    out.is_xyz = st.is_xyz & out.active
    m = out.dim_mask()
    out.x = torch.where(m, out.x, torch.zeros_like(out.x))
    mf = m.to(out.P.dtype)
    out.P = out.P * mf[:, None] * mf[None, :]
    return out


def linearity(st: State) -> torch.Tensor:
    """The linearity index of each inverse-depth slot (inf elsewhere)."""
    F = st.active.shape[0]
    f = st.feats()
    rho = f[:, 5]
    dims = CAM + FD * torch.arange(F, device=rho.device) + 5
    sigma_d = torch.sqrt(torch.abs(st.P[dims, dims])) / (rho * rho)
    xyz = f[:, 0:3] + ray(f[:, 3], f[:, 4]) / rho[:, None]
    to_cam = xyz - st.x[None, 0:3]
    to_anchor = xyz - f[:, 0:3]
    d_cam = torch.linalg.vector_norm(to_cam, dim=-1)
    cos_a = (to_cam * to_anchor).sum(-1) / (
        d_cam * torch.linalg.vector_norm(to_anchor, dim=-1))
    li = 4.0 * sigma_d * cos_a / d_cam
    return torch.where(st.active & ~st.is_xyz, li,
                       torch.full_like(li, math.inf))


def convert(st: State, slot: int, mm: Matmul) -> State:
    """Slot ``slot`` from inverse depth to XYZ, its 6 rows and columns of P
    mapped through the Jacobian of the conversion."""
    o = CAM + FD * slot
    f6 = st.x[o:o + FD]

    def to_xyz(f):
        return f[0:3] + ray(f[3], f[4]) / f[5]

    J = jacobian(to_xyz, f6)                                  # (3, 6)
    out = st.clone()
    P = st.P
    rows = mm(J, P[o:o + FD, :])                              # (3, N)
    block = J @ P[o:o + FD, o:o + FD] @ J.T
    Pn = P.clone()
    Pn[o:o + FD, :] = 0.0
    Pn[:, o:o + FD] = 0.0
    Pn[o:o + 3, :] = rows
    Pn[:, o:o + 3] = rows.T
    Pn[o:o + 3, o:o + 3] = block
    out.P = Pn
    out.x = st.x.clone()
    out.x[o:o + 3] = to_xyz(f6)
    out.x[o + 3:o + FD] = 0.0
    out.is_xyz = st.is_xyz.clone()
    out.is_xyz[slot] = True
    return out


def new_feature(p: Params, cam7: torch.Tensor, uvr: torch.Tensor
                ) -> torch.Tensor:
    """(r, theta, phi, rho) of the ray through a distorted pixel."""
    u = undistort(p, uvr[0:2])
    c = torch.stack([(u[0] - p.cx) / p.fx, (u[1] - p.cy) / p.fy,
                     torch.ones_like(u[0])])
    g = rot(cam7[3:7]) @ c
    theta = torch.atan2(g[0], g[2])
    phi = torch.atan2(-g[1], torch.sqrt(g[0] ** 2 + g[2] ** 2))
    return torch.cat([cam7[0:3], theta[None], phi[None], uvr[2:3]])


def add(p: Params, st: State, uv: torch.Tensor, slots, mm: Matmul
        ) -> State:
    """Add one feature a pixel of ``uv`` (K, 2) into slot ``slots[k]``, in
    order, each growing P by J1 P[0:7] and J1 P J1^T + J2 R J2^T."""
    out = st.clone()
    R = torch.diag(torch.tensor([p.pe_x ** 2, p.pe_y ** 2, p.rho_sd ** 2],
                                dtype=st.x.dtype, device=st.x.device))
    for k in range(uv.shape[0]):
        s = int(slots[k])
        cam7 = out.x[:7]
        uvr = torch.cat([uv[k], torch.full((1,), p.rho0, dtype=uv.dtype,
                                           device=uv.device)])
        f = new_feature(p, cam7, uvr)
        J = jacobian(lambda v: new_feature(p, v[:7], v[7:]),
                     torch.cat([cam7, uvr]))
        J1, J2 = J[:, :7], J[:, 7:]                           # (6, 7), (6, 3)
        o = CAM + FD * s
        P = out.P.clone()
        rows = mm(J1, P[0:7, :])
        P[o:o + FD, :] = rows
        P[:, o:o + FD] = rows.T
        P[o:o + FD, o:o + FD] = (J1 @ P[0:7, 0:7] @ J1.T + J2 @ R @ J2.T)
        out.P = P
        out.x = out.x.clone()
        out.x[o:o + FD] = f
        out.active = out.active.clone()
        out.active[s] = True
        out.is_xyz = out.is_xyz.clone()
        out.is_xyz[s] = False
        out.times_predicted = out.times_predicted.clone()
        out.times_predicted[s] = 0
        out.times_matched = out.times_matched.clone()
        out.times_matched[s] = 0
    return out
