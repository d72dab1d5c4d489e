"""Analytic unit tests for the core ray ops (SURVEY.md §4 strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.ops import (
    composite,
    compute_weights,
    get_rays,
    ray_aabb_intersect,
    sample_pdf,
    stratified_sample,
)


def test_stratified_deterministic_is_linspace():
    t = stratified_sample(4, 8, 2.0, 6.0, key=None)
    np.testing.assert_allclose(t[0], np.linspace(2.0, 6.0, 8), rtol=1e-6)
    assert t.shape == (4, 8)


def test_stratified_jitter_stays_in_bins():
    t = stratified_sample(512, 64, 2.0, 6.0, key=jax.random.key(0))
    lin = np.linspace(2.0, 6.0, 64)
    mids = 0.5 * (lin[1:] + lin[:-1])
    lower = np.concatenate([[lin[0]], mids])
    upper = np.concatenate([mids, [lin[-1]]])
    t = np.asarray(t)
    assert (t >= lower - 1e-6).all() and (t <= upper + 1e-6).all()
    # jitter actually happened
    assert np.abs(t - lin).max() > 1e-3


def test_stratified_lindisp():
    t = stratified_sample(1, 3, 1.0, 4.0, key=None, lindisp=True)
    # disparity-linear: 1/t linear between 1 and 0.25
    np.testing.assert_allclose(1.0 / t[0], [1.0, 0.625, 0.25], rtol=1e-6)


def test_compute_weights_opaque_wall():
    # one huge-density sample: all weight lands on it
    sigma = jnp.array([[0.0, 1e8, 0.0, 0.0]])
    t = jnp.array([[1.0, 2.0, 3.0, 4.0]])
    w, alpha, trans = compute_weights(sigma, t)
    np.testing.assert_allclose(w[0, 1], 1.0, atol=1e-5)
    np.testing.assert_allclose(w[0, 2:], 0.0, atol=1e-5)
    # transmittance is exclusive: first sample sees T=1
    np.testing.assert_allclose(trans[0, 0], 1.0)


def test_compute_weights_matches_closed_form():
    # constant density sigma over uniform spacing d: alpha = 1-exp(-s*d),
    # w_i = alpha * (1-alpha)^i (up to eps), last delta = 1e10 -> alpha=1
    s, d, n = 0.7, 0.5, 6
    sigma = jnp.full((1, n), s)
    t = jnp.arange(n, dtype=jnp.float32)[None] * d
    w, _, _ = compute_weights(sigma, t)
    a = 1 - np.exp(-s * d)
    expect = [a * (1 - a) ** i for i in range(n - 1)] + [(1 - a) ** (n - 1)]
    np.testing.assert_allclose(w[0], expect, rtol=1e-4)


def test_compute_weights_sum_le_one():
    key = jax.random.key(1)
    sigma = jax.random.uniform(key, (128, 64)) * 5
    t = jnp.sort(jax.random.uniform(jax.random.key(2), (128, 64)) * 4 + 2, axis=-1)
    w, _, _ = compute_weights(sigma, t)
    assert (np.asarray(w.sum(-1)) <= 1.0 + 1e-5).all()


def test_sample_pdf_concentrates_on_peak():
    # weights concentrated in one bin -> samples land inside that bin
    bins = jnp.linspace(0.0, 1.0, 9)[None].repeat(4, 0)  # 8 bins
    weights = jnp.zeros((4, 8)).at[:, 3].set(1.0)
    samples = sample_pdf(bins, weights, 64, key=jax.random.key(0))
    s = np.asarray(samples)
    frac_in_peak = ((s >= bins[0, 3]) & (s <= bins[0, 4])).mean()
    assert frac_in_peak > 0.95


def test_sample_pdf_uniform_weights_uniform_samples():
    bins = jnp.linspace(2.0, 6.0, 65)[None].repeat(2, 0)
    weights = jnp.ones((2, 64))
    s = sample_pdf(bins, weights, 128, key=None)  # deterministic linspace u
    np.testing.assert_allclose(np.asarray(s[0]), np.linspace(2.0, 6.0, 128), atol=2e-2)


def test_sample_pdf_monotonic_when_deterministic():
    key = jax.random.key(3)
    w = jax.random.uniform(key, (8, 62))
    bins = jnp.linspace(2.0, 6.0, 63)[None].repeat(8, 0)
    s = np.asarray(sample_pdf(bins, w, 128, key=None))
    assert (np.diff(s, axis=-1) >= -1e-6).all()


def test_composite_white_background():
    rgb = jnp.zeros((2, 4, 3))
    w = jnp.zeros((2, 4))  # fully transparent
    t = jnp.broadcast_to(jnp.linspace(2, 6, 4), (2, 4))
    rgb_map, depth, acc = composite(rgb, w, t, white_bkgd=True)
    np.testing.assert_allclose(rgb_map, 1.0)  # empty ray -> white
    np.testing.assert_allclose(acc, 0.0)


def test_composite_expected_depth():
    rgb = jnp.ones((1, 3, 3)) * 0.5
    w = jnp.array([[0.25, 0.5, 0.25]])
    t = jnp.array([[2.0, 4.0, 6.0]])
    _, depth, acc = composite(rgb, w, t, white_bkgd=False)
    np.testing.assert_allclose(depth[0], 4.0)
    np.testing.assert_allclose(acc[0], 1.0)


def test_get_rays_center_pixel_points_forward():
    H = W = 4
    f = 2.0
    K_inv = jnp.linalg.inv(jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]]))
    c2w = jnp.eye(4)
    uv = jnp.array([[W / 2, H / 2]])
    o, d = get_rays(uv, K_inv, c2w)
    np.testing.assert_allclose(o[0], 0.0)
    np.testing.assert_allclose(d[0], [0.0, 0.0, -1.0], atol=1e-6)


def test_get_rays_respects_c2w_translation():
    K_inv = jnp.eye(3)
    c2w = jnp.array([[1, 0, 0, 5.0], [0, 1, 0, -2.0], [0, 0, 1, 3.0], [0, 0, 0, 1.0]])
    uv = jnp.zeros((3, 2))
    o, _ = get_rays(uv, K_inv, c2w)
    np.testing.assert_allclose(o, np.tile([5.0, -2.0, 3.0], (3, 1)))


def test_ray_aabb():
    o = jnp.array([[0.0, 0.0, -10.0], [50.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    near, far, hit = ray_aabb_intersect(o, d, [-1, -1, -1], [1, 1, 1], 2.0, 6.0)
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(near[0], 9.0)
    np.testing.assert_allclose(far[0], 11.0)
    np.testing.assert_allclose(near[1], 2.0)  # miss falls back to defaults


def test_ops_are_jittable_and_grad_safe():
    def loss(sigma):
        t = stratified_sample(4, 16, 2.0, 6.0, key=None)
        w, _, _ = compute_weights(sigma, t)
        rgb = jnp.ones((4, 16, 3)) * 0.3
        rgb_map, _, _ = composite(rgb, w, t, white_bkgd=True)
        return jnp.sum(rgb_map)

    sigma = jnp.ones((4, 16))
    g = jax.jit(jax.grad(loss))(sigma)
    assert np.isfinite(np.asarray(g)).all()


def test_get_rays_directions_unit_norm():
    """get_rays normalises directions like the reference (blender.py:126)
    and every other ray generator in the framework."""
    H = W = 8
    f = 3.0
    K_inv = jnp.linalg.inv(
        jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]]))
    c2w = jnp.eye(4)
    uv = jnp.stack(jnp.meshgrid(jnp.arange(W * 1.0),
                                jnp.arange(H * 1.0)), -1).reshape(-1, 2)
    _, d = get_rays(uv, K_inv, c2w)
    np.testing.assert_allclose(jnp.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    _, d_raw = get_rays(uv, K_inv, c2w, normalize=False)
    corner = jnp.linalg.norm(d_raw, axis=-1)
    assert float(corner.max()) > 1.5  # un-normalised corners are longer
