"""The other front-end profiles' vision modules against the JAX package:
FAST, Harris / Shi-Tomasi, DoG / DoH, ORB and the SURF-64 float
descriptors, and the port's ``Frontend`` per profile.

Inputs are made with numpy from a seed (blocky and blob textures, odd
sizes such as 121x133, a flat frame) and go through both packages; the JAX
side runs jitted, as its engine step does.  XLA's CPU code multiplies by a
constant divisor's reciprocal and contracts a product into the add that
consumes it, and the port reproduces that rounding.  Bounds:
  * identical: FAST, Harris and Shi-Tomasi (in the front end's form,
    feeding ``quality_threshold``), ``quality_threshold``, the DoG map and
    its blur, 2x2 mean and upsampling, the DoH map at even frame sizes,
    pyramid FAST with and without Harris ranking, the ORB moment maps,
    ``make_pattern``, ``steered_extract`` on JAX's angles (and the ORB
    descriptors of the whole chain: 0 bits differ);
  * the DoH map at odd sizes: identical at least 17 px from the edge (XLA
    stops a contraction in its edge branches there; every front end's
    border is at least that wide with the default BRIEF patch), and within
    1e-6 of the map's largest value in the edge band;
  * ``angles_at``: within 1 ulp (atan2 in float64, rounded once);
  * ``surf64``: within 1e-6 of unit-norm vectors; ``l2_distance``: within
    1e-5 on distances up to 4 (float32 sums in the library's order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.vision import brief as jbrief
from openekfmonoslam_tpu.vision import dog as jdog
from openekfmonoslam_tpu.vision import fast as jfast
from openekfmonoslam_tpu.vision import floatdesc as jfd
from openekfmonoslam_tpu.vision import frontend as jfront
from openekfmonoslam_tpu.vision import harris as jharris
from openekfmonoslam_tpu.vision import matching as jmatch
from openekfmonoslam_tpu.vision import orb as jorb
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.vision import brief as tbrief
from openekfmonoslam_tpu_torch.vision import dog as tdog
from openekfmonoslam_tpu_torch.vision import fast as tfast
from openekfmonoslam_tpu_torch.vision import floatdesc as tfd
from openekfmonoslam_tpu_torch.vision import frontend as tfront
from openekfmonoslam_tpu_torch.vision import harris as tharris
from openekfmonoslam_tpu_torch.vision import matching as tmatch
from openekfmonoslam_tpu_torch.vision import orb as torb
from test_torch_live import make_texture

SHAPES = [(120, 160), (121, 133), (97, 131)]
EVEN = [(120, 128), (120, 160)]


def blocky(seed, shape):
    """4x4 blocks of random grey plus noise: corners for FAST and Harris."""
    rng = np.random.default_rng(seed)
    h, w = shape
    big = np.kron(rng.integers(0, 255, (h // 4 + 1, w // 4 + 1)),
                  np.ones((4, 4)))[:h, :w]
    return np.clip(big + rng.integers(0, 30, shape), 0, 255).astype(np.uint8)


def blobs(seed, shape):
    rng = np.random.default_rng(seed)
    g = make_texture(rng, *shape, n_blobs=shape[0] * shape[1] // 60)
    return np.clip(g.astype(np.int32) + rng.integers(0, 20, shape), 0,
                   255).astype(np.uint8)


def frames(shape):
    return [blocky(1, shape), blobs(2, shape)]


FLAT = np.full((50, 60), 77, np.uint8)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.int32), b.view(np.int32))


def ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------- FAST

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", [20.0, 7.5])
def test_fast_scores_bit_identical(shape, threshold):
    fn = jax.jit(jfast.fast_scores, static_argnums=1)
    for g in frames(shape) + [blocky(3, shape).astype(np.float32) * 0.37]:
        want = fn(jnp.asarray(g), threshold)
        got = tfast.fast_scores(_t(g), threshold)
        assert same_bits(want, got.numpy())
    assert (np.asarray(want) > 0).sum() >= 50


def test_fast_scores_flat_frame_and_border():
    want = jax.jit(jfast.fast_scores, static_argnums=1)(jnp.asarray(FLAT),
                                                        20.0)
    got = tfast.fast_scores(_t(FLAT), 20.0).numpy()
    assert same_bits(want, got) and not got.any()
    g = blocky(4, (40, 48))
    s = tfast.fast_scores(_t(g), 5.0).numpy()
    assert not s[:3].any() and not s[-3:].any()
    assert not s[:, :3].any() and not s[:, -3:].any() and s.any()


# ------------------------------------------------- Harris / Shi-Tomasi

@pytest.mark.parametrize("shape", SHAPES + [(480, 640)])
def test_harris_and_shi_tomasi_bit_identical(shape):
    fns = {q: (jax.jit(lambda x, q=q: jharris.quality_threshold(
                   jharris.harris_scores(x, 0.04), q)),
                   jax.jit(lambda x, q=q: jharris.quality_threshold(
                       jharris.shi_tomasi_scores(x), q)))
           for q in (0.01, 0.0)}
    for g in frames(shape)[:1 if shape[0] > 200 else 2]:
        G, T = jnp.asarray(g), _t(g)
        for q, (harris_fn, shi_fn) in fns.items():
            got = tharris.quality_threshold(tharris.harris_scores(T, 0.04), q)
            assert same_bits(harris_fn(G), got.numpy())
            got = tharris.quality_threshold(tharris.shi_tomasi_scores(T), q)
            assert same_bits(shi_fn(G), got.numpy())
        assert same_bits(jax.jit(jharris.harris_scores)(G),
                         tharris.harris_scores(T).numpy())
        for a, b in zip(jax.jit(jharris.structure_tensor)(G),
                        tharris.structure_tensor(T)):
            assert same_bits(a, b.numpy())


@pytest.mark.parametrize("quality", [0.01, 0.3])
def test_quality_threshold_bit_identical(quality):
    s = np.asarray(jax.jit(jharris.harris_scores)(jnp.asarray(
        blocky(5, (97, 131)))))
    want = jax.jit(jharris.quality_threshold, static_argnums=1)(
        jnp.asarray(s), quality)
    got = tharris.quality_threshold(_t(s), quality)
    assert same_bits(want, got.numpy()) and (np.asarray(want) > 0).any()


def test_harris_flat_frame_is_zero():
    for fn, tfn in ((jharris.harris_scores, tharris.harris_scores),
                    (jharris.shi_tomasi_scores, tharris.shi_tomasi_scores)):
        want = jax.jit(fn)(jnp.asarray(FLAT))
        got = tfn(_t(FLAT)).numpy()
        assert same_bits(want, got) and not got.any()


# ------------------------------------------------------------ DoG / DoH

@pytest.mark.parametrize("sigma", [1.6, 0.9, 2.5])
def test_gauss_kernel_and_blur_bit_identical(sigma):
    np.testing.assert_array_equal(jdog._gauss_kernel(sigma),
                                  tdog._gauss_kernel(sigma))
    x = blobs(6, (97, 131)).astype(np.float32) / np.float32(255)
    want = jax.jit(jdog.blur, static_argnums=1)(jnp.asarray(x), sigma)
    assert same_bits(want, tdog.blur(_t(x), sigma).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_downsample_and_upsample_bit_identical(shape):
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    want = jax.jit(jdog._downsample2)(jnp.asarray(x))
    assert same_bits(want, tdog._downsample2(_t(x)).numpy())
    for f in (2, 4, 8):
        small = x[::f, ::f]
        want = jax.jit(jdog._upsample_to, static_argnums=(1, 2, 3))(
            jnp.asarray(small), shape[0], shape[1], f)
        got = tdog._upsample_to(_t(small), shape[0], shape[1], f)
        assert same_bits(want, got.numpy())


@pytest.mark.parametrize("shape,quality", [(s, 0.01) for s in SHAPES]
                         + [((50, 60), 0.0)])
def test_dog_scores_bit_identical(shape, quality):
    fn = jax.jit(lambda x: jdog.dog_scores(x, 1.6, 3, 0.04, 10.0, 2,
                                           quality))
    for g in frames(shape):
        want = fn(jnp.asarray(g))
        got = tdog.dog_scores(_t(g), 1.6, 3, 0.04, 10.0, 2, quality)
        assert same_bits(want, got.numpy())
    assert (np.asarray(want) > 0).sum() >= 10


@pytest.mark.parametrize("shape", EVEN + [(240, 320), (96, 128)])
@pytest.mark.parametrize("quality", [0.0, 0.05])
def test_doh_scores_bit_identical_at_even_sizes(shape, quality):
    g = blocky(8, shape)
    want = jax.jit(lambda x: jdog.doh_scores(x, quality=quality))(
        jnp.asarray(g))
    got = tdog.doh_scores(_t(g), quality=quality)
    assert same_bits(want, got.numpy()) and (np.asarray(want) > 0).any()


@pytest.mark.parametrize("shape", [(121, 133), (97, 131)])
def test_doh_scores_at_odd_sizes_identical_inside_the_border(shape):
    g = blocky(9, shape)
    want = np.asarray(jax.jit(lambda x: jdog.doh_scores(x, quality=0.0))(
        jnp.asarray(g)))
    got = tdog.doh_scores(_t(g), quality=0.0).numpy()
    m = 17
    assert same_bits(want[m:-m, m:-m], got[m:-m, m:-m])
    # the edge band: the determinant cancels there, so bound the error by
    # the map's scale
    assert np.abs(want - got).max() <= 1e-6 * want.max()


def test_dog_and_doh_flat_frame_are_zero():
    for jf, tf in ((jdog.dog_scores, tdog.dog_scores),
                   (jdog.doh_scores, tdog.doh_scores)):
        want = jax.jit(jf)(jnp.asarray(FLAT))
        got = tf(_t(FLAT)).numpy()
        assert same_bits(want, got) and not got.any()


# ----------------------------------------------------------------- ORB

@pytest.mark.parametrize("args", [(256, 33, 7), (256, 17, 7), (512, 21, 3)])
def test_make_pattern_identical(args):
    a, b = jbrief.make_pattern(*args), tbrief.make_pattern(*args)
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [7, 3])
def test_centroid_moment_maps_bit_identical(shape, radius):
    g = blobs(10, shape)
    want = jax.jit(lambda x: jorb.centroid_moment_maps(
        jbrief.smooth(x, 2.0), radius))(jnp.asarray(g))
    got = torb.centroid_moment_maps(tbrief.smooth(_t(g), 2.0), radius)
    for a, b in zip(want, got):
        assert same_bits(a, b.numpy())


def _orb_inputs(shape, seed=11, n=300):
    g = blobs(seed, shape)
    sm = np.asarray(jax.jit(jbrief.smooth)(jnp.asarray(g)))
    m10, m01 = (np.asarray(a) for a in jax.jit(
        jorb.centroid_moment_maps, static_argnums=1)(jnp.asarray(sm), 7))
    rng = np.random.default_rng(seed)
    yx = np.stack([rng.integers(0, shape[0], n),
                   rng.integers(0, shape[1], n)], -1).astype(np.int32)
    return sm, m10, m01, yx


@pytest.mark.parametrize("shape", SHAPES)
def test_angles_within_one_ulp(shape):
    sm, m10, m01, yx = _orb_inputs(shape)
    want = jax.jit(jorb.angles_at)(jnp.asarray(m10), jnp.asarray(m01),
                                   jnp.asarray(yx))
    got = torb.angles_at(_t(m10), _t(m01), _t(yx))
    assert got.dtype == torch.float32
    assert ulps(want, got.numpy()).max() <= 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("patch", [33, 17])
def test_steered_extract_bit_identical(shape, patch):
    sm, m10, m01, yx = _orb_inputs(shape)
    pattern = jbrief.make_pattern(256, patch, 7)
    ang = np.asarray(jax.jit(jorb.angles_at)(
        jnp.asarray(m10), jnp.asarray(m01), jnp.asarray(yx)))
    want = np.asarray(jax.jit(jorb.steered_extract)(
        jnp.asarray(sm), jnp.asarray(yx), jnp.asarray(ang),
        jnp.asarray(pattern)))
    got = torb.steered_extract(_t(sm), _t(yx), _t(ang), _t(pattern))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy().view(np.uint32))
    # the whole chain, each package with its own angles: count the bits
    # that differ (an angle's ulp could move an offset across .5)
    want = np.asarray(jax.jit(lambda s, a, b, y, p: jorb.steered_extract(
        s, y, jorb.angles_at(a, b, y), p))(
        jnp.asarray(sm), jnp.asarray(m10), jnp.asarray(m01),
        jnp.asarray(yx), jnp.asarray(pattern)))
    got = torb.steered_extract(_t(sm), _t(yx), torb.angles_at(
        _t(m10), _t(m01), _t(yx)), _t(pattern)).numpy().view(np.uint32)
    assert int(np.unpackbits((want ^ got).view(np.uint8)).sum()) == 0


@pytest.mark.parametrize("shape", [(120, 128), (121, 133), (97, 131),
                                   (120, 160), (240, 320), (480, 640)])
@pytest.mark.parametrize("harris_rank", [True, False])
def test_pyramid_fast_scores_bit_identical(shape, harris_rank):
    g = blocky(12, shape)
    for n_levels in (4, 2) if shape == (120, 160) else (4,):
        want = jax.jit(lambda x: jorb.pyramid_fast_scores(
            x, 20.0, n_levels, harris_rank))(jnp.asarray(g))
        got = torb.pyramid_fast_scores(_t(g), 20.0, n_levels, harris_rank)
        assert same_bits(want, got.numpy()) and (np.asarray(want) > 0).any()


# -------------------------------------------------- SURF-64 float desc

def test_patch_offsets_identical():
    assert jfd.DESC_DIM == tfd.DESC_DIM == 64
    for r in (10, 7):
        for a, b in zip(jfd._patch_offsets(r), tfd._patch_offsets(r)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_surf64_and_l2_distance_within_tolerance(shape):
    sm, _, _, yx = _orb_inputs(shape, seed=13, n=200)
    want = np.asarray(jax.jit(jfd.surf64)(jnp.asarray(sm), jnp.asarray(yx)))
    got = tfd.surf64(_t(sm), _t(yx))
    assert got.dtype == torch.float32 and got.shape == (200, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(want, axis=1), 1.0, atol=1e-5)
    dj = np.asarray(jax.jit(jfd.l2_distance)(jnp.asarray(want[:40]),
                                             jnp.asarray(want)))
    dt = tfd.l2_distance(_t(want[:40]), _t(want)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    assert dt.min() >= 0.0 and dj.max() > 1.0


def test_matching_sentinel_follows_the_distance_dtype():
    rng = np.random.default_rng(14)
    F, K = 12, 30
    uv = rng.uniform(0, 60, (F, 2))
    S = np.tile(np.eye(2) * 4.0, (F, 1, 1))
    vis = rng.random(F) < 0.9
    kp = np.concatenate([uv[:6] + rng.normal(0, 1, (6, 2)),
                         rng.uniform(0, 60, (K - 6, 2))])
    kvalid = rng.random(K) < 0.9
    kd = rng.normal(0, 1, (K, 64)).astype(np.float32)
    kd /= np.linalg.norm(kd, axis=1, keepdims=True)
    md = kd[:F] + rng.normal(0, 0.05, (F, 64)).astype(np.float32)
    want = jmatch.match_predictions(
        jnp.asarray(uv), jnp.asarray(S), jnp.asarray(vis), jnp.asarray(md),
        jnp.asarray(kp), jnp.asarray(kvalid), jnp.asarray(kd), 9.0, 1.0,
        distance_fn=jfd.l2_distance)
    got = tmatch.match_predictions(
        _t(uv), _t(S), _t(vis), _t(md), _t(kp), _t(kvalid), _t(kd), 9.0,
        1.0, distance_fn=tfd.l2_distance)
    assert np.array_equal(np.asarray(want.matched), got.matched.numpy())
    assert got.matched.any() and not got.matched.all()
    np.testing.assert_allclose(got.distance.numpy(),
                               np.asarray(want.distance), rtol=1e-5)
    assert (got.distance.numpy()[~got.matched.numpy()] == 1e30).all()


# ------------------------------------------------------ Frontend contract

PROFILES = [("FAST", "BRIEF"), ("STAR", "BRIEF"), ("ORB", "ORB"),
            ("SIFT", "SURF"), ("SURF", "SURF"), ("HARRIS", "BRIEF"),
            ("SHI_TOMASI", "ORB"), ("GFTT", "SIFT"), ("SHITOMASI", "BRIEF")]


def _config(mod, det, desc, patch=17):
    return mod.SlamConfig(
        detector=mod.DetectorConfig(kind=det, quality=0.005,
                                    surf_quality=0.01,
                                    star_response_threshold=5.0),
        descriptor=mod.DescriptorConfig(kind=desc, patch_size=patch))


@pytest.mark.parametrize("det,desc", PROFILES)
def test_frontend_contract_per_profile(det, desc):
    """precompute's keys, score maps identical to the jitted JAX
    precompute (the step's chain) at the engine's 120x128, and describe's
    dtype, width and values."""
    jf = jfront.Frontend(_config(jcfg, det, desc))
    tf = tfront.Frontend(_config(tcfg, det, desc), "cpu")
    g = blocky(15, (120, 128))
    jaux = jax.jit(jf.precompute)(jnp.asarray(g))
    taux = tf.precompute(_t(g))
    assert set(jaux) == set(taux)
    if det != "STAR":      # STAR: tests/test_torch_vision.py (its kernel)
        for k in ("score_raw", "score_nms"):
            assert same_bits(jaux[k], taux[k].numpy()), k
    rng = np.random.default_rng(16)
    yx = np.stack([rng.integers(10, 110, 40), rng.integers(10, 118, 40)],
                  -1).astype(np.int32)
    want = np.asarray(jax.jit(jf.describe)(jaux, jnp.asarray(yx)))
    got = tf.describe(taux, _t(yx))
    assert tuple(got.shape) == want.shape == (40, tf.desc_width)
    assert tf.desc_width == jf.desc_width
    if jf.is_binary:
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy().view(np.uint32))
        assert tf.distance(got, got).dtype == torch.int32
    else:
        assert got.dtype == torch.float32 and tf.desc_width == 64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert tf.distance(got, got).dtype == torch.float32
    z = tf.zero_descriptors(3, "cpu")
    assert z.dtype == got.dtype and tuple(z.shape) == (3, tf.desc_width)


def test_brief_planes_for_every_brief_detector_use_the_shared_pattern():
    for det in ("FAST", "HARRIS", "SHI_TOMASI", "SIFT"):
        tf = tfront.Frontend(_config(tcfg, det, "BRIEF", patch=33), "cpu")
        assert tf.brief_pattern.variant == "s256"
        tf = tfront.Frontend(_config(tcfg, det, "BRIEF", patch=17), "cpu")
        assert tf.brief_pattern.variant == "generic"


def test_ncc_and_patch_follow_the_jax_frontend():
    """PATCH descriptors (with either matcher) describe as the jitted JAX
    front end does; the NCC matcher without them raises what JAX
    raises."""
    g = blocky(15, (120, 128))
    yx = np.asarray([[20, 30], [60, 64], [100, 110]], np.int32)
    for matcher in ("descriptor", "ncc"):
        cfg = dataclasses.replace(_config(tcfg, "FAST", "PATCH"),
                                  matcher=matcher)
        jcf = dataclasses.replace(_config(jcfg, "FAST", "PATCH"),
                                  matcher=matcher)
        tf, jf = tfront.Frontend(cfg, "cpu"), jfront.Frontend(jcf)
        got = tf.describe(tf.precompute(torch.as_tensor(g)),
                          torch.as_tensor(yx))
        want = jax.jit(lambda a, k: jf.describe(jf.precompute(a), k))(
            jnp.asarray(g), jnp.asarray(yx))
        assert got.dtype == torch.float32 and tf.desc_width == 225
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    for mod, make in ((tcfg, lambda c: tfront.Frontend(c, "cpu")),
                      (jcfg, jfront.Frontend)):
        cfg = dataclasses.replace(_config(mod, "FAST", "BRIEF"),
                                  matcher="ncc")
        with pytest.raises(ValueError, match="requires descriptor kind "
                           "'PATCH'"):
            make(cfg)


def test_descriptor_widths_match_the_jax_config():
    for kind in ("BRIEF", "ORB", "SURF", "SIFT", "PATCH"):
        a = jcfg.DescriptorConfig(kind=kind)
        b = tcfg.DescriptorConfig(kind=kind)
        assert a.width == b.width and a.is_binary == b.is_binary
    assert tcfg.DescriptorConfig(kind="SURF").width == 64
