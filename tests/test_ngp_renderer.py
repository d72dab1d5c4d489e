"""Structural tests for the NGP occupancy-raymarch frame renderer
(models/nerf/renderer/ngp_renderer.py). Quality-vs-dense is gated on
the GPU in bench.py and chip_smoke.py; here we verify the static-shape
machinery: culling, compaction and chunking invariance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.config.cfg_node import CN
from nerf_replication_tpu.models.nerf.network import init_params, make_network
from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
    make_ngp_frame_renderer,
)
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
    RenderSettings,
)


def _tiny_ngp_cfg():
    return CN({
        "task_arg": {"use_viewdirs": True},
        "network": {
            "dtype": "float32",
            "nerf": {"W": 16, "D": 2, "V_D": 1, "skips": [1]},
            "xyz_encoder": {
                "type": "cuda_hashgrid", "backend": "brick",
                "input_dim": 3, "num_levels": 3, "level_dim": 2,
                "base_resolution": 4, "desired_resolution": 16,
                "log2_hashmap_size": 10, "log2_bricks": 4,
                "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2],
            },
            "dir_encoder": {"type": "sphere_harmonics", "degree": 2},
        },
    })


@pytest.fixture(scope="module")
def ngp():
    net = make_network(_tiny_ngp_cfg())
    params = init_params(net, jax.random.key(0))
    return net, params


def _apply(net):
    return lambda p, pts, vd, m: net.apply(p, pts, vd, model=m)


def _frame_setup(ngp, grid_value, **kw):
    net, params = ngp
    apply_fn = _apply(net)
    s = RenderSettings(N_samples=8, N_importance=8, ray_chunk=64,
                       density_activation="softplus")
    grid = np.full((8, 8, 8), grid_value, np.uint8)
    occupancy = (grid, (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    H = W = 8
    focal = 0.5 * W / np.tan(0.3)
    fn = make_ngp_frame_renderer(
        apply_fn, H, W, focal=focal, occupancy=occupancy, s=s,
        out_dtype=jnp.float32, return_stats=True, **kw)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    return fn, params, jnp.asarray(c2w)


def test_empty_grid_renders_background(ngp):
    fn, params, c2w = _frame_setup(ngp, grid_value=0, n_candidates=8,
                                   n_coarse=4, n_fine=4, capacity=0.5)
    rgb, stats = fn(params, c2w)
    assert int(stats["active_rays"]) == 0
    np.testing.assert_allclose(np.asarray(rgb), 1.0, atol=1e-6)


def test_full_grid_all_active_and_chunk_invariant(ngp):
    fn, params, c2w = _frame_setup(ngp, grid_value=1, n_candidates=8,
                                   n_coarse=8, n_fine=4, capacity=1.0,
                                   fine_capacity=1.0, probe_sub=1)
    rgb, stats = fn(params, c2w)
    assert int(stats["active_rays"]) == 64
    assert int(stats["coarse_overflow"]) == 0
    # chunking must not change the image (same compaction order per ray)
    net, params2 = ngp
    apply_fn = _apply(net)
    s2 = RenderSettings(N_samples=8, N_importance=8, ray_chunk=32,
                        density_activation="softplus")
    fn2 = make_ngp_frame_renderer(
        apply_fn, 8, 8, focal=0.5 * 8 / np.tan(0.3),
        occupancy=(np.ones((8, 8, 8), np.uint8),
                   (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2),
        s=s2, n_candidates=8, n_coarse=8, n_fine=4, capacity=1.0,
        fine_capacity=1.0, probe_sub=1, out_dtype=jnp.float32,
        return_stats=True)
    rgb2, _ = fn2(params, c2w)
    np.testing.assert_allclose(np.asarray(rgb), np.asarray(rgb2),
                               atol=1e-5)


def test_uint8_output(ngp):
    fn, params, c2w = _frame_setup(ngp, grid_value=1, n_candidates=8,
                                   n_coarse=4, n_fine=4, capacity=0.5)
    # rebuild with uint8 out
    net, _ = ngp
    apply_fn = _apply(net)
    s = RenderSettings(N_samples=8, N_importance=8, ray_chunk=64,
                       density_activation="softplus")
    fn8 = make_ngp_frame_renderer(
        apply_fn, 8, 8, focal=0.5 * 8 / np.tan(0.3),
        occupancy=(np.ones((8, 8, 8), np.uint8),
                   (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2),
        s=s, n_candidates=8, n_coarse=4, n_fine=4, capacity=0.5,
        out_dtype=jnp.uint8)
    img = fn8(params, c2w)
    assert img.dtype == jnp.uint8 and img.shape == (64, 3)


def test_shallow_dilation_rejected(ngp):
    net, params = ngp
    apply_fn = _apply(net)
    s = RenderSettings()
    with pytest.raises(ValueError, match="dilated"):
        make_ngp_frame_renderer(
            apply_fn, 8, 8, focal=10.0,
            occupancy=(np.ones((8, 8, 8), np.uint8),
                       (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 1),
            s=s, probe_sub=4)


def test_mid_coarse_compaction_matches(ngp):
    """occ_capacity: with a full grid every active ray has occupied
    candidates, so a roomy occ_capacity must reproduce the
    no-compaction image exactly; with a half-empty selection grid the
    culled rays must composite as pure background."""
    fn, params, c2w = _frame_setup(ngp, grid_value=1, n_candidates=8,
                                   n_coarse=8, n_fine=4, capacity=1.0,
                                   fine_capacity=1.0, probe_sub=1)
    rgb_ref, _ = fn(params, c2w)
    net, _ = ngp
    apply_fn = _apply(net)
    s = RenderSettings(N_samples=8, N_importance=8, ray_chunk=32,
                       density_activation="softplus")
    occ = (np.ones((8, 8, 8), np.uint8),
           (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    fn_mid = make_ngp_frame_renderer(
        apply_fn, 8, 8, focal=0.5 * 8 / np.tan(0.3), occupancy=occ,
        s=s, n_candidates=8, n_coarse=8, n_fine=4, capacity=1.0,
        fine_capacity=1.0, probe_sub=1, out_dtype=jnp.float32,
        return_stats=True, occ_capacity=1.0)
    rgb_mid, stats = fn_mid(params, c2w)
    assert int(stats["occ_rays"]) == 64
    assert int(stats["occ_overflow"]) == 0
    np.testing.assert_allclose(np.asarray(rgb_mid), np.asarray(rgb_ref),
                               atol=1e-5)

    # selection grid empty in the x<0 half: those rays render as bg
    sel = np.ones((8, 8, 8), np.uint8)
    sel[:4] = 0
    fn_half = make_ngp_frame_renderer(
        apply_fn, 8, 8, focal=0.5 * 8 / np.tan(0.3), occupancy=occ,
        s=s, n_candidates=8, n_coarse=8, n_fine=4, capacity=1.0,
        fine_capacity=1.0, probe_sub=1, out_dtype=jnp.float32,
        return_stats=True, occ_capacity=0.5,
        select_occupancy=(sel, occ[1]))
    rgb_half, stats_h = fn_half(params, c2w)
    n_occ_rays = int(stats_h["occ_rays"])
    assert 0 < n_occ_rays < 64
    img = np.asarray(rgb_half).reshape(8, 8, 3)
    # at least the culled count renders exact background
    n_bg = int((img == 1.0).all(-1).sum())
    assert n_bg >= 64 - n_occ_rays - int(stats_h["occ_overflow"])


def test_probe_stride_and_auto_sub(ngp):
    """stride-2 probe on a dilate-2 grid keeps every ray active and
    renders within sample-placement jitter of the stride-1 image (the
    doubled margin widens spans on oblique rays, moving the uniform
    candidate lattice slightly — quality arbitrated by the bench gate);
    too-coarse stride raises."""
    fn, params, c2w = _frame_setup(ngp, grid_value=1, n_candidates=8,
                                   n_coarse=8, n_fine=4, capacity=1.0,
                                   fine_capacity=1.0, probe_sub=1)
    rgb_ref, _ = fn(params, c2w)
    net, _ = ngp
    apply_fn = _apply(net)
    s = RenderSettings(N_samples=8, N_importance=8, ray_chunk=64,
                       density_activation="softplus")
    occ = (np.ones((8, 8, 8), np.uint8),
           (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    fn2 = make_ngp_frame_renderer(
        apply_fn, 8, 8, focal=0.5 * 8 / np.tan(0.3), occupancy=occ,
        s=s, n_candidates=8, n_coarse=8, n_fine=4, capacity=1.0,
        fine_capacity=1.0, probe_sub="auto", probe_stride=2,
        out_dtype=jnp.float32, return_stats=True)
    rgb2, stats = fn2(params, c2w)
    assert int(stats["active_rays"]) == 64
    np.testing.assert_allclose(np.asarray(rgb2), np.asarray(rgb_ref),
                               atol=3e-2)
    with pytest.raises(ValueError, match="stride"):
        make_ngp_frame_renderer(
            apply_fn, 8, 8, focal=0.5 * 8 / np.tan(0.3), occupancy=occ,
            s=s, probe_stride=4)


def test_rank_select_matches_sort_oracle():
    """The rank-by-cumsum candidate selection must equal the two-class
    stable-sort + stride-selection formulation it replaced (numpy
    oracle), across occupancy densities incl. all-empty and all-full."""
    rng = np.random.default_rng(3)
    c, C, M = 129, 16, 6
    te = rng.uniform(2, 3, (c,)).astype(np.float32)
    span = rng.uniform(0.5, 3, (c,)).astype(np.float32)
    occ = rng.random((c, C)) < rng.random((c, 1))
    occ[0], occ[1] = False, True
    uu = (np.arange(C, dtype=np.float32) + 0.5) / C
    t_cand = te[:, None] + span[:, None] * uu[None, :]

    # oracle: stable sort by (occupied-first, depth), stride the pool
    score = np.where(occ, 0.0, 2.0) + uu[None, :] * 1e-3
    order = np.argsort(score, axis=-1, kind="stable")
    t_sorted = np.take_along_axis(t_cand, order, axis=-1)
    pool = np.maximum(occ.sum(-1), M)
    j = np.arange(M)
    pos = (j[None, :] * pool[:, None]) // M
    t_ref = np.sort(np.take_along_axis(t_sorted, pos, axis=-1), -1)

    # renderer formulation (mirrors select_chunk)
    occ_i = occ.astype(np.int64)
    n_occ = occ_i.sum(-1)
    rank = np.where(occ, np.cumsum(occ_i, -1),
                    n_occ[:, None] + np.cumsum(1 - occ_i, -1))
    pos1 = (j[None, :] * np.maximum(n_occ, M)[:, None]) // M + 1
    k_sel = np.argmax(pos1[..., None] == rank[:, None, :], axis=-1)
    t_new = np.sort(np.take_along_axis(t_cand, k_sel, axis=-1), -1)
    np.testing.assert_array_equal(t_ref, t_new)
