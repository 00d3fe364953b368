"""The ported vision modules against the JAX package, module by module.

Inputs are made with numpy from a seed and go through both packages; the
JAX side runs jitted, as its engine step does (XLA then multiplies by a
box area's reciprocal and fuses multiply-adds, which the port reproduces:
vision/star.py, vision/brief.py).  Bounds:
  * BRIEF point and pair tables, the smoothed image, the bit-planes,
    descriptor lookups and Hamming distances: identical;
  * STAR maps: identical on frames whose integral image is exact in
    float32 (the padded mean an integer); on other frames the two integral
    images differ by float32 reassociation, so scores agree within 0.05
    (on values of 30 and up), at most 0.1% of pixels cross the threshold,
    and the NMS peak sets coincide;
  * keypoint selection (ties included), gate masks, matches, zone-balanced
    picks and subpixel refinement: identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.config import SlamConfig as JConfig
from openekfmonoslam_tpu.vision import brief as jbrief
from openekfmonoslam_tpu.vision import detect as jdetect
from openekfmonoslam_tpu.vision import fast as jfast
from openekfmonoslam_tpu.vision import matching as jmatch
from openekfmonoslam_tpu.vision import star as jstar
from openekfmonoslam_tpu_torch.ops import brief_kernel, star_kernel
from openekfmonoslam_tpu_torch.vision import brief as tbrief
from openekfmonoslam_tpu_torch.vision import detect as tdetect
from openekfmonoslam_tpu_torch.vision import fast as tfast
from openekfmonoslam_tpu_torch.vision import matching as tmatch
from openekfmonoslam_tpu_torch.vision import star as tstar
from test_torch_live import exact_integral_frame, make_texture

SHAPES = [(120, 160), (97, 131)]


def _frame(seed, shape, exact):
    rng = np.random.default_rng(seed)
    g = make_texture(rng, *shape, n_blobs=shape[0] * shape[1] // 60)
    g = np.clip(g.astype(np.int32) + rng.integers(0, 20, shape), 0, 255)
    g = g.astype(np.uint8)
    return exact_integral_frame(g, tstar.integral_pad(16)) if exact else g


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n_bits,patch,seed", [(256, 33, 7), (512, 21, 3)])
def test_brief_pattern_tables_identical(n_bits, patch, seed):
    for a, b in zip(jbrief.make_shared_pattern(n_bits, patch, seed),
                    tbrief.make_shared_pattern(n_bits, patch, seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(jbrief.gaussian_kernel(2.0),
                                  tbrief.gaussian_kernel(2.0))


@pytest.mark.parametrize("shape", SHAPES + [(480, 640)])
def test_smooth_bit_identical(shape):
    g = _frame(1, shape, exact=False)
    want = np.asarray(jax.jit(jbrief.smooth)(jnp.asarray(g)))
    got = tbrief.smooth(torch.as_tensor(g)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_brief_planes_and_descriptors_bit_identical(shape):
    g = _frame(2, shape, exact=False)
    points, pairs = tbrief.make_shared_pattern()
    sm = tbrief.smooth(torch.as_tensor(g))
    want = jax.jit(lambda s: jbrief.dense_descriptors_shared(
        s, points, pairs))(jnp.asarray(sm.numpy()))
    pattern = brief_kernel.BriefPattern.make(points, pairs, "cpu")
    got = brief_kernel.dense_planes(sm, pattern)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert b.dtype == torch.int32 and np.array_equal(np.asarray(a),
                                                         _u32(b))
    rng = np.random.default_rng(3)
    yx = np.stack([rng.integers(17, shape[0] - 17, 50),
                   rng.integers(17, shape[1] - 17, 50)], 1).astype(np.int32)
    dj = np.asarray(jbrief.lookup_descriptors(want, jnp.asarray(yx),
                                              pattern.half))
    dt = tbrief.lookup_descriptors(got, torch.as_tensor(yx), pattern.half)
    assert np.array_equal(dj, _u32(dt))
    hj = np.asarray(jbrief.hamming_distance(jnp.asarray(dj[:20]),
                                            jnp.asarray(dj)))
    ht = tbrief.hamming_distance(dt[:20], dt)
    assert ht.dtype == torch.int32 and np.array_equal(hj, ht.numpy())


def test_hamming_distance_identical_on_random_words():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2 ** 32, (17, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (33, 8), dtype=np.uint64).astype(np.uint32)
    b[:3] = a[:3]
    b[3] = ~a[3]
    want = np.asarray(jbrief.hamming_distance(jnp.asarray(a),
                                              jnp.asarray(b)))
    got = tbrief.hamming_distance(torch.as_tensor(a.view(np.int32)),
                                  torch.as_tensor(b.view(np.int32)))
    assert np.array_equal(want, got.numpy())
    assert want[3, 3] == 256 and want[0, 0] == 0


def _jax_star(g):
    def f(gray):
        raw = jstar.star_scores(gray)
        return raw, jfast.non_max_suppress(raw, 2)
    return [np.asarray(a) for a in jax.jit(f)(jnp.asarray(g))]


@pytest.mark.parametrize("shape", SHAPES)
def test_star_maps_identical_on_exact_integrals(shape):
    g = _frame(5, shape, exact=True)
    raw_j, nms_j = _jax_star(g)
    raw_t, nms_t = star_kernel.star_scores_fused(torch.as_tensor(g),
                                                 star_kernel.StarSettings())
    assert np.array_equal(raw_j, raw_t.numpy())
    assert np.array_equal(nms_j, nms_t.numpy())
    assert (nms_j > 0).sum() >= 50


@pytest.mark.parametrize("shape", SHAPES)
def test_star_maps_within_tolerance_on_other_frames(shape):
    g = _frame(6, shape, exact=False)
    raw_j, nms_j = _jax_star(g)
    raw_t, nms_t = (a.numpy() for a in star_kernel.star_scores_fused(
        torch.as_tensor(g), star_kernel.StarSettings()))
    both = (raw_j > 0) & (raw_t > 0)
    assert np.abs(raw_j - raw_t)[both].max() <= 0.05
    # a score within that error of the threshold may cross it
    assert np.mean((raw_j > 0) != (raw_t > 0)) <= 1e-3
    assert np.array_equal(nms_j > 0, nms_t > 0) and (nms_j > 0).sum() >= 50


def test_star_responses_and_fused_terms():
    g = _frame(7, (97, 131), exact=True)
    want = np.asarray(jax.jit(lambda x: jstar.star_responses(x)[0])(
        jnp.asarray(g)))
    got, sizes = tstar.star_responses(torch.as_tensor(g))
    assert sizes == jstar.star_sizes(16) == tstar.star_sizes(16)
    # star_responses alone compiles to other fusions than star_scores, so
    # its roundings differ in the last bit; the maps agree to float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    modes = [tstar.fused_term(n, sizes) for n in sizes]
    assert modes == [tstar.FUSE_INNER, tstar.FUSE_NONE, tstar.FUSE_INNER,
                     tstar.FUSE_NONE, tstar.FUSE_OUTER, tstar.FUSE_NONE,
                     tstar.FUSE_INNER, tstar.FUSE_OUTER]


@pytest.mark.parametrize("K", [16, 64])
def test_detect_keypoints_identical_with_ties(K):
    rng = np.random.default_rng(K)
    score = rng.choice([0.0, 1.0, 2.0, 2.5, 3.0], size=(40, 56),
                       p=[0.6, 0.1, 0.1, 0.1, 0.1]).astype(np.float32)
    mask = rng.random((40, 56)) < 0.8
    want = jfast.detect_keypoints(jnp.asarray(score), jnp.asarray(mask), K)
    got = tfast.detect_keypoints(torch.as_tensor(score),
                                 torch.as_tensor(mask), K)
    assert np.array_equal(np.asarray(want.yx), got.yx.numpy())
    assert np.array_equal(np.asarray(want.score), got.score.numpy())
    assert np.array_equal(np.asarray(want.valid), got.valid.numpy())


def test_non_max_suppress_ignores_outside_pixels():
    rng = np.random.default_rng(8)
    score = (rng.random((23, 31)) * (rng.random((23, 31)) < 0.3)
             ).astype(np.float32)
    score[0, 0] = score[-1, -1] = 5.0          # corner maxima: -inf padding
    for r in (1, 2, 3):
        want = np.asarray(jfast.non_max_suppress(jnp.asarray(score), r))
        got = tfast.non_max_suppress(torch.as_tensor(score), r).numpy()
        assert np.array_equal(want, got)


def test_subpixel_refine_identical():
    rng = np.random.default_rng(9)
    raw = (rng.random((50, 70)) * 60).astype(np.float32).astype(np.float64)
    raw[10, 10:13] = 7.0                      # a flat run: zero denominator
    xy = np.concatenate([rng.uniform(-3, 75, (30, 2)), [[11.0, 10.0]]])
    valid = rng.random(31) < 0.8
    want = np.asarray(jax.jit(jfast.subpixel_refine)(
        jnp.asarray(raw), jnp.asarray(xy), jnp.asarray(valid)))
    got = tfast.subpixel_refine(torch.as_tensor(raw), torch.as_tensor(xy),
                                torch.as_tensor(valid)).numpy()
    assert np.array_equal(want, got)


def _predictions(rng, F, h, w):
    uv = np.stack([rng.uniform(-10, w + 10, F), rng.uniform(-10, h + 10, F)],
                  1)
    A = rng.normal(0, 1.5, (F, 2, 2))
    S = A @ np.transpose(A, (0, 2, 1)) + np.eye(2) * rng.uniform(0.3, 3, F)[
        :, None, None]
    return uv, S, rng.random(F) < 0.8


@pytest.mark.parametrize("block", [4, 1])
def test_ellipse_union_mask_identical(block):
    rng = np.random.default_rng(10 + block)
    uv, S, vis = _predictions(rng, 12, 120, 160)
    gate = 4.0 * 5.9915
    want = np.asarray(jax.jit(jmatch.ellipse_union_mask,
                              static_argnums=(0, 4, 5))(
        (120, 160), jnp.asarray(uv), jnp.asarray(S), jnp.asarray(vis), gate,
        block))
    got = tmatch.ellipse_union_mask(
        (120, 160), torch.as_tensor(uv), torch.as_tensor(S),
        torch.as_tensor(vis), gate, block).numpy()
    assert np.array_equal(want, got) and 0 < want.mean() < 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_predictions_identical(seed):
    rng = np.random.default_rng(seed)
    F, K = 12, 40
    uv, S, vis = _predictions(rng, F, 120, 160)
    map_desc = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint64).astype(
        np.uint32)
    owner = rng.integers(0, F, K)
    kp_xy = np.round(uv[owner] + rng.normal(0, 2.0, (K, 2)))
    kp_desc = map_desc[owner] ^ (rng.random((K, 8)) < 0.05).astype(np.uint32)
    kp_desc[::7] = kp_desc[1::7][:len(kp_desc[::7])]      # duplicate: ties
    kp_valid = rng.random(K) < 0.9
    gate, coef = 4.0 * 5.9915, JConfig().ekf.matching_comp_coef_second_best_vs_first
    want = jax.jit(jmatch.match_predictions, static_argnums=(7, 8))(
        jnp.asarray(uv), jnp.asarray(S), jnp.asarray(vis),
        jnp.asarray(map_desc), jnp.asarray(kp_xy), jnp.asarray(kp_valid),
        jnp.asarray(kp_desc), gate, coef)
    got = tmatch.match_predictions(
        torch.as_tensor(uv), torch.as_tensor(S), torch.as_tensor(vis),
        torch.as_tensor(map_desc.view(np.int32)), torch.as_tensor(kp_xy),
        torch.as_tensor(kp_valid), torch.as_tensor(kp_desc.view(np.int32)),
        gate, coef)
    assert np.asarray(want.matched).sum() >= 3
    for name in ("z", "matched", "distance", "refreshed"):
        assert np.array_equal(np.asarray(getattr(want, name)),
                              getattr(got, name).numpy()), name
    assert np.array_equal(np.asarray(want.desc), _u32(got.desc))


@pytest.mark.parametrize("needed,zones", [(7, 2), (100, 4), (0, 2)])
def test_select_zone_balanced_identical(needed, zones):
    rng = np.random.default_rng(needed + zones)
    K, F, C, h, w = 64, 10, 24, 120, 160
    kp_xy = np.stack([rng.integers(17, w - 17, K), rng.integers(17, h - 17,
                                                                K)], 1)
    kp_xy = kp_xy.astype(np.float32)
    score = rng.choice([10.0, 20.0, 30.0], K).astype(np.float32)  # ties
    avail = rng.random(K) < 0.85
    pred_uv = np.stack([rng.uniform(0, w, F), rng.uniform(0, h, F)],
                       1).astype(np.float32)
    pred_vis = rng.random(F) < 0.7
    radius = 2.0 * float(np.sqrt(JConfig().ekf.
                                 detect_new_features_image_mask_ellipse_size
                                 * 5.9915))
    want = jdetect.select_zone_balanced(
        jnp.asarray(kp_xy), jnp.asarray(score), jnp.asarray(avail),
        jnp.asarray(pred_uv), jnp.asarray(pred_vis), jnp.int32(needed),
        jnp.asarray(radius, jnp.float32), zones, w, h, max_new=C)
    got = tdetect.select_zone_balanced(
        torch.as_tensor(kp_xy), torch.as_tensor(score),
        torch.as_tensor(avail), torch.as_tensor(pred_uv),
        torch.as_tensor(pred_vis), min(needed, C), radius, zones, w, h,
        max_new=C)
    assert np.array_equal(np.asarray(want.valid), got.valid.numpy())
    assert np.array_equal(np.asarray(want.uv), got.uv.numpy())
    assert np.array_equal(np.asarray(want.kp_index), got.kp_index.numpy())
    n = int(got.valid.sum())
    assert n <= min(needed, C) and (n > 0) == (needed > 0)
