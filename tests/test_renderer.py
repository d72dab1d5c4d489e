"""Renderer tests: identity-field network (the reference's `run.py --type
input` TestNet strategy, run.py:6-8,27-49) plus analytic volume checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    RenderSettings,
    Renderer,
    render_rays,
)


class SphereField:
    """Analytic test field: opaque-ish red unit sphere at origin.

    raw sigma is pre-activation; rgb pre-sigmoid. Plays the role of the
    reference's fake TestNet (run.py:6-8).
    """

    def __init__(self, radius=1.0, density=50.0):
        self.radius = radius
        self.density = density

    def apply(self, params, pts, viewdirs, model=""):
        inside = jnp.linalg.norm(pts, axis=-1) < self.radius
        sigma = jnp.where(inside, self.density, 0.0)
        rgb = jnp.broadcast_to(
            jnp.array([10.0, -10.0, -10.0]), pts.shape[:-1] + (3,)
        )  # sigmoid -> ~(1, 0, 0)
        return jnp.concatenate([rgb, sigma[..., None]], axis=-1)


def _rays_through_origin(n=8):
    o = jnp.tile(jnp.array([[0.0, 0.0, 4.0]]), (n, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1))
    return o, d


def _apply(field):
    return lambda p, pts, vd, model: field.apply(p, pts, vd, model)


def test_identity_field_renders_red_sphere():
    field = SphereField()
    s = RenderSettings(N_samples=64, N_importance=128, white_bkgd=True)
    o, d = _rays_through_origin()
    out = render_rays(_apply(field), None, o, d, None, s, train=False)
    rgb = np.asarray(out["rgb"])
    # ray hits the sphere: red, depth near front surface (4 - 1 = 3)
    np.testing.assert_allclose(rgb[:, 0], 1.0, atol=0.02)
    np.testing.assert_allclose(rgb[:, 1:], 0.0, atol=0.02)
    assert abs(float(out["depth"][0]) - 3.0) < 0.1


def test_miss_rays_are_white_background():
    field = SphereField()
    s = RenderSettings(white_bkgd=True)
    o = jnp.tile(jnp.array([[3.0, 3.0, 4.0]]), (4, 1))  # offset: misses sphere
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (4, 1))
    out = render_rays(_apply(field), None, o, d, None, s, train=False)
    np.testing.assert_allclose(np.asarray(out["rgb"]), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out["acc"]), 0.0, atol=1e-3)


def test_hierarchical_sampling_improves_surface_depth():
    """Fine pass should localize the surface better than a 16-sample
    coarse-only pass."""
    field = SphereField(density=500.0)
    o, d = _rays_through_origin(4)
    s_co = RenderSettings(N_samples=16, N_importance=0)
    s_hier = RenderSettings(N_samples=16, N_importance=64)
    out_c = render_rays(_apply(field), None, o, d, None, s_co, train=False)
    out_h = render_rays(_apply(field), None, o, d, None, s_hier, train=False)
    err_c = abs(float(out_c["depth"][0]) - 3.0)
    err_h = abs(float(out_h["depth"][0]) - 3.0)
    assert err_h <= err_c + 1e-6
    assert err_h < 0.05


def test_render_rays_train_mode_stochastic_but_finite():
    field = SphereField()
    s = RenderSettings(perturb=True, raw_noise_std=1.0)
    o, d = _rays_through_origin(4)
    out1 = render_rays(_apply(field), None, o, d, jax.random.key(0), s, train=True)
    out2 = render_rays(_apply(field), None, o, d, jax.random.key(1), s, train=True)
    assert np.isfinite(np.asarray(out1["rgb"])).all()
    assert not np.allclose(np.asarray(out1["rgb"]), np.asarray(out2["rgb"]))
    # eval ignores keys -> deterministic
    e1 = render_rays(_apply(field), None, o, d, None, s, train=False)
    e2 = render_rays(_apply(field), None, o, d, None, s, train=False)
    np.testing.assert_array_equal(np.asarray(e1["rgb"]), np.asarray(e2["rgb"]))


def test_fast_sampling_close_to_dense():
    field = SphereField()
    o, d = _rays_through_origin(8)
    s_dense = RenderSettings(fast_sampling=False)
    s_fast = RenderSettings(fast_sampling=True)
    out_d = render_rays(_apply(field), None, o, d, None, s_dense, train=False)
    out_f = render_rays(_apply(field), None, o, d, None, s_fast, train=False)
    np.testing.assert_allclose(
        np.asarray(out_d["rgb"]), np.asarray(out_f["rgb"]), atol=0.05
    )


def test_renderer_object_api_batch_contract():
    """Reference contract: batch rays (B, N_rays, 3) -> flat outputs
    (volume_renderer.py:301-303,432)."""
    from nerf_replication_tpu.config import default_cfg

    cfg = default_cfg()
    cfg.task_arg.N_samples = 16
    cfg.task_arg.N_importance = 16
    field = SphereField()

    class FakeNet:
        def apply(self, params, pts, viewdirs, model=""):
            return field.apply(params, pts, viewdirs, model)

    r = Renderer(FakeNet(), cfg=cfg)
    o, d = _rays_through_origin(6)
    batch = {"rays_o": o.reshape(2, 3, 3), "rays_d": d.reshape(2, 3, 3)}
    rgb, depth = r.render(batch, params=None)
    assert rgb.shape == (6, 3)
    assert depth.shape == (6,)


def test_eval_chunking_matches_unchunked():
    from nerf_replication_tpu.config import default_cfg

    cfg = default_cfg()
    cfg.task_arg.N_samples = 16
    cfg.task_arg.N_importance = 8
    cfg.task_arg.ray_chunk = 4
    field = SphereField()

    class FakeNet:
        def apply(self, params, pts, viewdirs, model=""):
            return field.apply(params, pts, viewdirs, model)

    r = Renderer(FakeNet(), cfg=cfg)
    o, d = _rays_through_origin(10)  # 10 rays, chunk 4 -> padding exercised
    out = r.render_rays_batch(None, o, d)
    s = RenderSettings.from_cfg(cfg)
    ref = render_rays(_apply(field), None, o, d, None, s, train=False)
    np.testing.assert_allclose(
        np.asarray(out["rgb"]), np.asarray(ref["rgb"]), atol=1e-5
    )


def test_render_image_fast_matches_dense():
    """Compacted eval (coarse-everywhere + fine-on-active) must match the
    dense hierarchical render."""
    from nerf_replication_tpu.config import default_cfg

    cfg = default_cfg()
    cfg.task_arg.update({"N_samples": 16, "N_importance": 16,
                         "ray_chunk": 8, "fast_sampling": True})
    field = SphereField()

    class FakeNet:
        def apply(self, params, pts, viewdirs, model=""):
            return field.apply(params, pts, viewdirs, model)

    r = Renderer(FakeNet(), cfg=cfg)
    # mix of hit rays and miss rays
    o_hit, d_hit = _rays_through_origin(5)
    o_miss = jnp.tile(jnp.array([[3.0, 3.0, 4.0]]), (6, 1))
    d_miss = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (6, 1))
    ro = jnp.concatenate([o_hit, o_miss])
    rd = jnp.concatenate([d_hit, d_miss])

    fast = r.render_image_fast(None, ro, rd)
    dense = r.render_rays_batch(None, ro, rd)
    np.testing.assert_allclose(np.asarray(fast["rgb"]),
                               np.asarray(dense["rgb"]), atol=2e-3)
    # miss rays are white and were never fine-rendered
    np.testing.assert_allclose(fast["rgb"][5:], 1.0, atol=1e-3)


def test_frame_renderer_matches_dense():
    """Single-dispatch frame renderer (device ray-gen + static top-K
    compaction) must match the flat dense render."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.datasets.pipeline import rays_for_camera

    cfg = default_cfg()
    cfg.task_arg.update({"N_samples": 16, "N_importance": 16,
                         "ray_chunk": 32})
    field = SphereField()

    class FakeNet:
        def apply(self, params, pts, viewdirs, model=""):
            return field.apply(params, pts, viewdirs, model)

    H = W = 12
    focal = 12.0
    c2w = jnp.eye(4).at[2, 3].set(4.0)
    r = Renderer(FakeNet(), cfg=cfg)
    frame_fn = r.make_frame_renderer(H, W, focal, capacity=0.6)
    rgb = np.asarray(frame_fn(None, c2w))

    ro, rd = rays_for_camera(c2w, H, W, focal)
    dense = r.render_rays_batch(None, ro, rd)
    # active rays match exactly; background rays differ only if capacity
    # clipped them (here capacity 0.6 > occupancy)
    np.testing.assert_allclose(rgb, np.asarray(dense["rgb"]), atol=2e-3)


def test_golden_render_values():
    """Golden regression pin: exact renderer numerics for a fixed analytic
    scene (catches silent changes to sampling/CDF/compositing math)."""
    field = SphereField(radius=1.0, density=50.0)
    s = RenderSettings(N_samples=32, N_importance=32)
    o = jnp.array([[0.0, 0.0, 4.0], [0.5, 0.0, 4.0], [2.0, 2.0, 4.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [-0.1, 0.05, -1.0], [0.0, 0.0, -1.0]])
    out = render_rays(_apply(field), None, o, d, None, s, train=False)
    np.testing.assert_allclose(
        np.asarray(out["rgb"]),
        [[9.9995458e-01, 4.5397876e-05, 4.5397876e-05],
         [9.9995458e-01, 4.5397868e-05, 4.5397868e-05],
         [1.0, 1.0, 1.0]], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(out["depth"]), [3.0189638, 3.0495806, 0.0],
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out["acc"]), [1.0, 1.0, 0.0], atol=1e-6)


def test_ess_verbose_stats():
    """fast_sampling + ess_verbose exposes the reference's ESS/ERT debug
    statistics (volume_renderer.py:198-244) as outputs."""
    import jax

    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings,
        render_rays,
    )

    class Field:
        def apply(self, params, pts, viewdirs, model=""):
            sigma = jnp.where(jnp.linalg.norm(pts, axis=-1) < 0.8, 30.0, 0.0)
            return jnp.concatenate(
                [pts, sigma[..., None]], axis=-1)

    apply_fn = lambda p, pts, vd, m: Field().apply(p, pts, vd, m)
    s = RenderSettings(N_samples=16, N_importance=16, fast_sampling=True,
                       ess_verbose=True)
    ro = jnp.tile(jnp.array([[0.0, 0.0, 4.0]]), (32, 1))
    rd = jax.random.normal(jax.random.key(0), (32, 3)) * 0.3 + jnp.array(
        [0.0, 0.0, -1.0])
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    out = render_rays(apply_fn, None, ro, rd, None, s, train=False)
    st = out["ess_stats"]
    assert int(st["total_rays"]) == 32
    assert 0 <= int(st["empty_rays"]) <= 32
    assert 0.0 <= float(st["valid_fine_frac"]) <= 1.0
    assert int(st["skipped_points"]) >= 0


def test_fine_stage_ert_full_capacity_matches_dense():
    """fine_stage_ert with full survivor capacity reproduces fine_stage
    exactly (same deltas, same cumprod epsilon, no dropped rays)."""
    import jax

    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings, fine_stage, fine_stage_ert)

    key = jax.random.key(0)
    n, S = 96, 16
    s = RenderSettings(N_samples=S, N_importance=8, white_bkgd=True,
                       density_activation="softplus", ert_segments=3,
                       perturb=False)
    ro = jax.random.normal(key, (n, 3))
    rd = jax.random.normal(jax.random.key(1), (n, 3))
    vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    t_c = jnp.sort(jax.random.uniform(jax.random.key(2), (n, S),
                                      minval=2.0, maxval=6.0), axis=-1)
    w_c = jax.random.uniform(jax.random.key(3), (n, S))

    def apply_fn(params, pts, viewdirs, branch):
        del params, branch
        h = jnp.sin(pts.sum(-1, keepdims=True) * 3.0)
        return jnp.concatenate(
            [h, h * 0.5, -h, jnp.cos(pts[..., :1] * 2.0)], axis=-1)

    dense = fine_stage(apply_fn, None, ro, rd, vd, t_c, w_c, None, None, s)
    seg = fine_stage_ert(apply_fn, None, ro, rd, vd, t_c, w_c, s,
                         surv_frac=(1.0, 1.0))
    np.testing.assert_allclose(np.asarray(seg["rgb"]),
                               np.asarray(dense["rgb"]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(seg["depth"]),
                               np.asarray(dense["depth"]), atol=1e-4)
    assert int(seg["stats"]["ert_overflow"]) == 0


def test_fine_stage_ert_drops_only_saturated_tail():
    """With tight capacity, rays that saturate early must still be exact;
    the overall image error stays bounded by the dropped transmittance."""
    import jax

    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings, fine_stage, fine_stage_ert)

    key = jax.random.key(0)
    n, S = 128, 16
    s = RenderSettings(N_samples=S, N_importance=8, white_bkgd=True,
                       density_activation="softplus", ert_segments=2,
                       perturb=False)
    ro = jnp.zeros((n, 3))
    rd = jax.random.normal(key, (n, 3))
    vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    t_c = jnp.tile(jnp.linspace(2.0, 6.0, S)[None], (n, 1))
    w_c = jnp.ones((n, S))

    def apply_fn(params, pts, viewdirs, branch):
        # half the rays hit a dense wall early (saturate), half stay empty
        dense_ray = pts[..., 1:2] > 0
        sigma = jnp.where(dense_ray, 50.0, -5.0)
        return jnp.concatenate(
            [jnp.ones_like(sigma), jnp.zeros_like(sigma),
             jnp.zeros_like(sigma), sigma], axis=-1)

    dense = fine_stage(apply_fn, None, ro, rd, vd, t_c, w_c, None, None, s)
    seg = fine_stage_ert(apply_fn, None, ro, rd, vd, t_c, w_c, s,
                         surv_frac=(0.6,))
    err = np.abs(np.asarray(seg["rgb"]) - np.asarray(dense["rgb"])).max()
    assert err < 1e-3, err


def test_render_settings_ert_from_cfg():
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings)

    cfg = default_cfg()
    cfg.task_arg.update({"ert_segments": 3, "ert_eps": 1e-3,
                         "ert_frac": [0.7, 0.5], "ert_split": 0.5})
    s = RenderSettings.from_cfg(cfg)
    assert s.ert_segments == 3
    assert s.ert_eps == pytest.approx(1e-3)
    assert s.ert_frac == (0.7, 0.5)
    assert s.ert_split == 0.5
    assert hash(s) is not None  # stays jit-static-safe
