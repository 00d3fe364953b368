"""The designs of the STAR and BRIEF CUDA kernels (``csrc/star.cu``,
``csrc/brief.cu``), emulated on the CPU in numpy and held bit for bit
against their plain versions.

The kernels run only on a GPU (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py`` check them there).  These tests check, without a card,
what a kernel's arithmetic cannot show: that the tiling covers every
output once, that every read of a tile or frame lands on a value the
kernel has computed, and that the edge rules (clamped gradient and box
indices, pixels outside the image skipped by the NMS) give the plain
chain's maps at every border.  Each emulation follows its kernel's index
arithmetic at the kernel's own tile sizes (the constants mirrored in
``ops/star_kernel.py`` and ``ops/brief_kernel.py``, checked against the
sources here), and the BRIEF one reads its tables from the committed
pattern header.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openekfmonoslam_tpu_torch.ops import brief_kernel, cuda_lib, star_kernel
from openekfmonoslam_tpu_torch.vision import brief, star

F32 = np.float32


def _texture(seed, h, w):
    """A dark noisy frame with bright square blobs (many STAR peaks)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 30, (h, w))
    for _ in range(max(h * w // 80, 1)):
        y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(1, 6)
        img[max(y - r, 0):y + r, max(x - r, 0):x + r] = rng.integers(60, 256)
    return img.astype(np.uint8)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


# ------------------------------------------------------------- sources

def test_shipped_pattern_header_is_generated():
    """(a) csrc/brief_pattern.cuh is pattern_header()'s output, byte for
    byte, from make_shared_pattern(256, 33, 7)."""
    assert brief_kernel.HEADER.read_bytes() == \
        brief_kernel.pattern_header().encode()
    text = brief_kernel.HEADER.read_text()
    points, pairs = brief.make_shared_pattern(256, 33, 7)
    assert f"static constexpr int half = {brief.pattern_half(points)};" in text
    assert f"point[{len(points)}][2]" in text and \
        f"pair[{len(pairs)}][2]" in text


def test_kernel_constants_mirror_the_sources():
    src = (Path(cuda_lib.CSRC) / "brief.cu").read_text()
    assert f"#define BR_TILE_W {brief_kernel.TILE_W}" in src
    assert f"#define BR_TILE_H {brief_kernel.TILE_H}" in src
    assert f"#define BR_MAX_BITS {brief_kernel.MAX_BITS}" in src
    assert '#include "brief_pattern.cuh"' in src
    src = (Path(cuda_lib.CSRC) / "star.cu").read_text()
    assert f"#define STAR_TILE_H {star_kernel.TILE_H}" in src
    assert f"#define STAR_FRAME_W {star_kernel.FRAME_W}" in src
    assert (f"#define STAR_SMEM_MAX ({star_kernel.SMEM_MAX // 1024} * 1024)"
            in src)


@pytest.mark.parametrize("n_bits,patch,variant", [
    (256, 33, "s256"), (128, 33, "generic"), (512, 33, "generic"),
    (256, 15, "generic"), (256, 49, "generic")])
def test_brief_variant_follows_the_pattern(n_bits, patch, variant):
    pattern = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(n_bits, patch), "cpu")
    assert pattern.variant == variant
    assert pattern.tile_offsets.shape == (n_bits, 2)


@pytest.mark.parametrize("max_size,radius,route", [
    (16, 2, "staged"), (4, 1, "staged"), (32, 3, "staged"),
    (44, 0, "staged"), (45, 2, "direct"), (63, 3, "direct"),
    (64, 1, "direct"), (128, 2, "direct")])
def test_star_route_follows_the_settings(max_size, radius, route):
    s = star_kernel.StarSettings(max_size=max_size, nms_radius=radius)
    got, smem = star_kernel.star_plan(s)
    assert got == route and smem <= star_kernel.SMEM_MAX


# ------------------------------------------------------------- BRIEF

def _header_tables():
    text = brief_kernel.HEADER.read_text()

    def table(name):
        body = re.search(rf"{name}\[\d+\]\[2\] = \{{(.*?)\}};", text,
                         re.S).group(1)
        return np.array(re.findall(r"\{(-?\d+), (-?\d+)\}", body), np.int64)

    half = int(re.search(r"int half = (\d+);", text).group(1))
    return table("point"), table("pair"), half


def _brief_emulation(img, bit_of):
    """Planes made the kernels' way: each 64 x 16 output tile staged with
    its halo (zeros past the image), then ``bit_of(flat_tile, centre, b)``
    per bit; every interior pixel written once."""
    tw_, th_ = brief_kernel.TILE_W, brief_kernel.TILE_H
    half, n_bits = bit_of.half, bit_of.n_bits
    h, w = img.shape
    ih, iw = h - 2 * half, w - 2 * half
    tw, th = tw_ + 2 * half, th_ + 2 * half
    out = np.zeros((n_bits // 32, ih, iw), np.uint32)
    written = np.zeros((ih, iw), np.int64)
    for y0 in range(0, math.ceil(ih / th_) * th_, th_):
        for x0 in range(0, math.ceil(iw / tw_) * tw_, tw_):
            tile = np.zeros((th, tw), F32)
            part = img[y0:y0 + th, x0:x0 + tw]
            tile[:part.shape[0], :part.shape[1]] = part
            rows, cols = min(th_, ih - y0), min(tw_, iw - x0)
            r, c = np.meshgrid(np.arange(rows), np.arange(cols),
                               indexing="ij")
            centre = (r + half) * tw + c + half
            words = bit_of(tile.ravel(), centre, tw)
            out[:, y0:y0 + rows, x0:x0 + cols] = words
            written[y0:y0 + rows, x0:x0 + cols] += 1
    assert (written == 1).all()
    return out.view(np.int32)


class _Shipped:
    """The s256 variant: a pixel's 64 samples loaded first, then the 256
    compares by the header's pair table."""

    def __init__(self):
        self.points, self.pairs, self.half = _header_tables()
        self.n_bits = len(self.pairs)

    def __call__(self, flat, centre, tw):
        off = self.points[:, 0] * tw + self.points[:, 1]
        samples = flat[centre[None] + off[:, None, None]]     # (64, r, c)
        words = []
        for w8 in range(self.n_bits // 32):
            acc = np.zeros(centre.shape, np.uint32)
            for j in range(32):
                i1, i2 = self.pairs[32 * w8 + j]
                acc |= (samples[i1] < samples[i2]).astype(np.uint32) << j
            words.append(acc)
        return np.stack(words)


class _Generic:
    """The generic variant: each bit's pair of tile offsets, as the
    wrapper hands them to the kernel."""

    def __init__(self, pattern):
        self.pattern = pattern
        self.half, self.n_bits = pattern.half, pattern.pairs.shape[0]

    def __call__(self, flat, centre, tw):
        assert tw == brief_kernel.TILE_W + 2 * self.half
        off = self.pattern.tile_offsets
        words = []
        for w8 in range(self.n_bits // 32):
            acc = np.zeros(centre.shape, np.uint32)
            for j in range(32):
                o1, o2 = off[32 * w8 + j]
                acc |= (flat[centre + o1] < flat[centre + o2]
                        ).astype(np.uint32) << j
            words.append(acc)
        return np.stack(words)


def _smoothed(seed, h, w):
    return brief.smooth(torch.tensor(_texture(seed, h, w)))


@pytest.mark.parametrize("h,w", [(483, 645), (301, 97), (33, 33),
                                 (47, 101)])
def test_brief_shipped_emulation_equals_plain(h, w):
    """(b) The s256 variant's order gives the plain planes bit for bit."""
    smoothed = _smoothed(h + w, h, w)
    pattern = brief_kernel.BriefPattern.make(
        *brief_kernel.shipped_pattern(), "cpu")
    got = _brief_emulation(smoothed.numpy(), _Shipped())
    want = brief_kernel.dense_planes_plain(smoothed, pattern)
    assert got.shape == (8, h - 32, w - 32)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("h,w,n_bits,patch", [
    (483, 645, 256, 33), (50, 70, 256, 15), (120, 150, 512, 33),
    (97, 130, 128, 49), (70, 66, 512, 15)])
def test_brief_generic_emulation_equals_plain(h, w, n_bits, patch):
    """(b) The generic variant's offsets give the plain planes bit for
    bit, the shipped pattern included."""
    smoothed = _smoothed(h * w, h, w)
    pattern = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(n_bits, patch), "cpu")
    got = _brief_emulation(smoothed.numpy(), _Generic(pattern))
    want = brief_kernel.dense_planes_plain(smoothed, pattern)
    assert len(got) == len(want) == n_bits // 32
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())


# ------------------------------------------------------------- STAR

class _Local:
    """A frame-sized map in shared memory: reading an entry that no stage
    computed fails the test."""

    def __init__(self, fh, fw):
        self.v = np.zeros((fh, fw), F32)
        self.ok = np.zeros((fh, fw), bool)

    def put(self, i, j, v):
        self.v[i, j] = v
        self.ok[i, j] = True

    def __getitem__(self, ij):
        assert self.ok[ij].all(), "read of an uncomputed frame entry"
        return self.v[ij]


def _response(src, row, col, p):
    """Stage A at frame pixels whose box corner (y + o, x + o') is
    src[row + o, col + o'], rounded as star.cu does (the fused terms as
    the plain chain writes them)."""
    def box(n):
        top, bot = p.pad - n, p.pad + n + 1
        a, b = src[row + bot, col + bot], src[row + top, col + bot]
        c, d = src[row + bot, col + top], src[row + top, col + top]
        return ((a - b) - c) + d

    m = None
    for k in range(p.n_sizes):
        n = p.size[k]
        s_in, s_out = box(n), box(2 * n)
        r_in, r_out = F32(p.r_in[k]), F32(p.r_out[k])
        if p.fuse[k] == star.FUSE_INNER:
            r = (s_in.astype(np.float64) * float(r_in)
                 - (s_out * r_out).astype(np.float64)).astype(F32)
        elif p.fuse[k] == star.FUSE_OUTER:
            r = ((s_in * r_in).astype(np.float64)
                 - s_out.astype(np.float64) * float(r_out)).astype(F32)
        else:
            r = s_in * r_in - s_out * r_out
        m = np.abs(r) if m is None else np.maximum(m, np.abs(r))
    return m


def _grid(i0, i1, j0, j1):
    return np.meshgrid(np.arange(i0, i1), np.arange(j0, j1), indexing="ij")


def _star_emulation(ii, h, w, s, route):
    """(raw, nms) made the kernel's way, block by block: the five stages on
    each block's frame, each on the region star.cu gives it.  Stages A to
    C store, at a frame pixel outside the image, the value at its clamped
    pixel and read neighbours unclamped; stage D stores -inf outside the
    image, and the NMS reads it with no bounds check."""
    p = star_kernel.star_params(h, w, ii.shape[1], s)
    fw, th = star_kernel.FRAME_W, star_kernel.TILE_H
    r = s.nms_radius
    e = 3 + r
    fh, tw = th + 2 * e, fw - 2 * e
    zero, half_ = F32(0), F32(0.5)
    lt, thr = F32(p.line_threshold), F32(p.response_threshold)
    raw_out = np.zeros((h, w), F32)
    nms_out = np.zeros((h, w), F32)
    written = np.zeros((h, w), np.int64)
    for by in range(math.ceil(h / th)):
        for bx in range(math.ceil(w / tw)):
            fy, fx = by * th - e, bx * tw - e
            ilo, ihi = max(0, -fy), min(fh, h - fy)
            jlo, jhi = max(0, -fx), min(fw, w - fx)

            def cy(i):
                return np.clip(i, ilo, ihi - 1)

            def cx(j):
                return np.clip(j, jlo, jhi - 1)

            # A: the whole frame, at the clamped pixel
            best = _Local(fh, fw)
            i, j = _grid(0, fh, 0, fw)
            ci, cj = cy(i), cx(j)
            if route == "staged":
                wh = ihi - ilo + 2 * p.pad - 1
                ww = jhi - jlo + 2 * p.pad - 1
                win = ii[fy + ilo + 1:fy + ilo + 1 + wh,
                         fx + jlo + 1:fx + jlo + 1 + ww]
                assert win.shape == (wh, ww)
                best.put(i, j, _response(win, ci - ilo - 1, cj - jlo - 1, p))
            else:
                best.put(i, j, _response(ii, fy + ci, fx + cj, p))
            # B
            rx, ry = _Local(fh, fw), _Local(fh, fw)
            i, j = _grid(1, fh - 1, 1, fw - 1)
            ci, cj = cy(i), cx(j)
            rx.put(i, j, half_ * (best[ci, cj + 1] - best[ci, cj - 1]))
            ry.put(i, j, half_ * (best[ci + 1, cj] - best[ci - 1, cj]))
            # C
            vxx, vyy, vxy = (_Local(fh, fw) for _ in range(3))
            i, j = _grid(3, fh - 3, 1, fw - 1)
            ci, cj = cy(i), cx(j)
            sxx = syy = sxy = zero
            for d in range(-2, 3):
                gx, gy = rx[ci + d, cj], ry[ci + d, cj]
                sxx, syy, sxy = sxx + gx * gx, syy + gy * gy, sxy + gx * gy
            vxx.put(i, j, sxx)
            vyy.put(i, j, syy)
            vxy.put(i, j, sxy)
            # D: raw, -inf outside the image
            raw = _Local(fh, fw)
            i, j = _grid(3, fh - 3, 3, fw - 3)
            sxx = syy = sxy = zero
            for d in range(-2, 3):
                q = (i, j + d)
                sxx, syy, sxy = sxx + vxx[q], syy + vyy[q], sxy + vxy[q]
            det = sxx * syy - sxy * sxy
            tr = sxx + syy
            not_line = (det > 0) & (tr * tr < lt * det)
            b = np.where(not_line, best[i, j], zero)
            inside = (i >= ilo) & (i < ihi) & (j >= jlo) & (j < jhi)
            raw.put(i, j, np.where(inside, np.where(b >= thr, b, zero),
                                   F32(-np.inf)))
            # E: a row max over the pre-NMS rows, then a column max
            rowmax = _Local(fh, fw)
            i, j = _grid(3, fh - 3, e, fw - e)
            m = raw[i, j]
            for bb in range(1, r + 1):
                m = np.maximum(m, np.maximum(raw[i, j - bb], raw[i, j + bb]))
            rowmax.put(i, j, m)
            i, j = _grid(max(ilo, e), min(ihi, e + th), max(jlo, e),
                         min(jhi, fw - e))
            c = raw[i, j]
            pooled = np.maximum(c, rowmax[i, j])
            for a in range(1, r + 1):
                pooled = np.maximum(pooled, np.maximum(rowmax[i - a, j],
                                                       rowmax[i + a, j]))
            y, x = fy + i, fx + j
            raw_out[y, x] = c
            nms_out[y, x] = np.where((c >= pooled) & (c > 0), c, zero)
            written[y, x] += 1
    assert (written == 1).all()
    return raw_out, nms_out


def _star_case(h, w, s, route):
    gray = torch.tensor(_texture(h * 1000 + w, h, w))
    ii = star._integral(gray, star.integral_pad(s.max_size))
    raw, nms = _star_emulation(ii.numpy(), h, w, s, route)
    raw_p, nms_p = star_kernel.star_plain(ii, h, w, s)
    assert np.array_equal(_bits(raw), _bits(raw_p.numpy()))
    assert np.array_equal(_bits(nms), _bits(nms_p.numpy()))
    return int((nms_p > 0).sum())


@pytest.mark.parametrize("route", ["staged", "direct"])
@pytest.mark.parametrize("radius", [1, 2, 3, 5])
@pytest.mark.parametrize("h,w", [(483, 645), (37, 50), (17, 9), (5, 7),
                                 (12, 40), (1, 3)])
def test_star_tile_emulation_equals_plain(h, w, radius, route):
    """(c) The tile decomposition, both routes, at the kernel's tile size
    and every border: raw and nms equal star_plain bit for bit."""
    s = star_kernel.StarSettings(max_size=16, response_threshold=10.0,
                                 nms_radius=radius)
    peaks = _star_case(h, w, s, route)
    if h * w > 1000:
        assert peaks > 0


@pytest.mark.parametrize("h,w,max_size,route", [
    (200, 131, 32, "staged"), (200, 131, 45, "direct"),
    (90, 140, 64, "direct"), (45, 61, 4, "staged")])
def test_star_tile_emulation_other_max_sizes(h, w, max_size, route):
    s = star_kernel.StarSettings(max_size=max_size, response_threshold=5.0,
                                 line_threshold=6.0)
    assert _star_case(h, w, s, route) > 0
