"""The float32 products that a GPU may run in TF32 are pinned: ray
directions (frame renderers and the training pipeline) and the NGP
renderer's coarse-sample pick. Each site against a float64 numpy
reference, and equal to the same call at highest matmul precision."""

import jax
import jax.numpy as jnp
import numpy as np

from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
    select_coarse_samples,
)
from nerf_replication_tpu.ops.ray_ops import camera_rays
from nerf_replication_tpu.utils.synthetic_scene import look_at_pose

POSE = look_at_pose(np.array([3.1, -2.2, 1.7]))


def _dirs64(u, v, cx, cy, focal, pose):
    d = np.stack([(u - cx) / focal, -(v - cy) / focal, -np.ones_like(u)],
                 -1).astype(np.float64) @ pose[:3, :3].astype(np.float64).T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_camera_rays_full_precision():
    H, W, focal = 12, 16, 20.0
    fn = jax.jit(lambda c2w: camera_rays(H, W, focal, c2w))
    ro, rd = fn(jnp.asarray(POSE))
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    ref = _dirs64(us.ravel(), vs.ravel(), W / 2, H / 2, focal, POSE)
    np.testing.assert_allclose(np.asarray(rd), ref, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ro), np.broadcast_to(
        POSE[:3, 3], ref.shape), atol=0)
    with jax.default_matmul_precision("highest"):
        _, rd_hi = jax.jit(lambda c2w: camera_rays(H, W, focal, c2w))(
            jnp.asarray(POSE))
    np.testing.assert_array_equal(np.asarray(rd), np.asarray(rd_hi))


def test_pipeline_rays_full_precision():
    n, H, W, focal = 3, 10, 14, 18.0
    poses = np.stack([look_at_pose(np.array([3.0, 1.0 * i, 1.5]))
                      for i in range(n)])
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    images = np.zeros((n, H, W, 3), np.uint8)
    for across in (False, True):
        pipe = DeviceRayPipeline(images, poses, K, n_rays=32,
                                 sample_across_images=across)
        rays = jax.jit(pipe.rays_for_pose)(jnp.asarray(poses[1]))[1]
        us, vs = np.meshgrid(np.arange(W), np.arange(H))
        ref = _dirs64(us.ravel(), vs.ravel(), W / 2, H / 2, focal, poses[1])
        np.testing.assert_allclose(np.asarray(rays), ref, atol=1e-6)
        with jax.default_matmul_precision("highest"):
            hi = jax.jit(pipe.sample)(jax.random.key(0), 10 ** 6)
        lo = jax.jit(pipe.sample)(jax.random.key(0), 10 ** 6)
        np.testing.assert_array_equal(np.asarray(lo["rays_d"]),
                                      np.asarray(hi["rays_d"]))


def test_coarse_sample_pick_is_exact():
    rng = np.random.default_rng(0)
    c, C, M = 64, 24, 10
    t_cand = np.sort(rng.uniform(2.0, 6.0, (c, C)).astype(np.float32), -1)
    occ = rng.uniform(size=(c, C)) < 0.4
    got = np.asarray(jax.jit(select_coarse_samples, static_argnums=2)(
        jnp.asarray(t_cand), jnp.asarray(occ), M))
    # every pick is one of the candidates, bit for bit
    for row in range(c):
        assert np.isin(got[row], t_cand[row]).all()
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(jax.jit(select_coarse_samples, static_argnums=2)(
            jnp.asarray(t_cand), jnp.asarray(occ), M))
    np.testing.assert_array_equal(got, hi)
