"""Device-resident training ray pipeline — the training hot path.

The reference feeds training through a torch DataLoader with 4 worker
processes + per-batch ``to_cuda`` host->device copies
(src/datasets/make_dataset.py:73-100, trainer.py:51). Here the whole
split stays resident in device memory (lego: 100×800×800×3 uint8 ≈ 192 MB)
and draw each 1024-ray batch *inside the jitted train step* from a
threefry key: zero host->device transfer per step, fully deterministic,
and shardable over the data mesh axis.

Batch semantics mirror the reference blender loader: one random image per
step, N_rays random pixels from it (blender.py:106-111), with optional
center ``precrop`` for the first ``precrop_iters`` steps (the reference
config carries precrop keys but never implements them; we do).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


class DeviceRayPipeline:
    def __init__(
        self,
        images: np.ndarray,   # (N, H, W, 3) float32 in [0,1]
        poses: np.ndarray,    # (N, 4, 4) c2w
        K: np.ndarray,        # (3, 3)
        n_rays: int = 1024,
        precrop_iters: int = 0,
        precrop_frac: float = 0.5,
        sample_across_images: bool = False,
        alphas: np.ndarray | None = None,   # (N, H, W) GT coverage
    ):
        # images live on device as uint8 (PNG sources are 8-bit, so the
        # /255 round-trip is exact): 4x less HBM and upload than f32 —
        # lego-scale is 100x800x800x3 = 192 MB vs 768 MB
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = np.round(np.clip(images, 0.0, 1.0) * 255.0
                              ).astype(np.uint8)
        self.images = jnp.asarray(images)
        self.poses = jnp.asarray(poses)
        self.alphas = None
        if alphas is not None:
            a = np.asarray(alphas)
            if a.dtype != np.uint8:
                a = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
            self.alphas = jnp.asarray(a)
        self.n_images, self.H, self.W = images.shape[:3]
        self.focal = float(K[0, 0])
        self.cx = float(K[0, 2])
        self.cy = float(K[1, 2])
        self.n_rays = n_rays
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self.sample_across_images = sample_across_images

    # -- ray math (pure; used inside the jitted train step) ------------------
    def _pixel_rays(self, pose, u, v):
        dirs = jnp.stack(
            [(u - self.cx) / self.focal,
             -(v - self.cy) / self.focal,
             -jnp.ones_like(u)],
            axis=-1,
        )
        rays_d = jnp.matmul(dirs, pose[:3, :3].T,
                            precision=jax.lax.Precision.HIGHEST)
        rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = jnp.broadcast_to(pose[:3, 3], rays_d.shape)
        return rays_o, rays_d

    def data(self) -> dict:
        """Device arrays to PASS AS ARGUMENTS through a jit boundary.

        Closing over the image stack instead would embed it as an HLO
        constant — at lego scale that is a multi-hundred-MB literal the
        compiler must swallow per program. Callers thread this
        dict into ``sample(..., data=...)``."""
        d = {"images": self.images, "poses": self.poses}
        if self.alphas is not None:
            d["alphas"] = self.alphas
        return d

    def sample(self, key: jax.Array, step: jax.Array | int = 1 << 30,
               data: dict | None = None) -> dict:
        """Draw one training batch. Trace-safe: call inside jit.

        Returns {rays_o, rays_d, colors} each (n_rays, ...). ``step``
        drives the precrop schedule (traced int is fine). ``data``
        (see :meth:`data`) avoids constant-capturing the image stack.
        """
        images = self.images if data is None else data["images"]
        poses = self.poses if data is None else data["poses"]
        alphas = (self.alphas if data is None
                  else data.get("alphas", self.alphas))
        k_img, k_pix = jax.random.split(key)
        step = jnp.asarray(step)
        in_precrop = step < self.precrop_iters

        # pixel bounds: full image, or the center crop during precrop
        dW = int(self.W // 2 * self.precrop_frac)
        dH = int(self.H // 2 * self.precrop_frac)
        u_lo = jnp.where(in_precrop, self.W // 2 - dW, 0)
        u_hi = jnp.where(in_precrop, self.W // 2 + dW, self.W)
        v_lo = jnp.where(in_precrop, self.H // 2 - dH, 0)
        v_hi = jnp.where(in_precrop, self.H // 2 + dH, self.H)

        ku, kv = jax.random.split(k_pix)
        u = jax.random.randint(ku, (self.n_rays,), u_lo, u_hi)
        v = jax.random.randint(kv, (self.n_rays,), v_lo, v_hi)

        alpha = None
        if self.sample_across_images:
            img_idx = jax.random.randint(k_img, (self.n_rays,), 0, self.n_images)
            colors = images[img_idx, v, u]
            if alphas is not None:
                alpha = alphas[img_idx, v, u]
            pose = poses[img_idx]               # (n_rays, 4, 4)
            dirs = jnp.stack(
                [(u - self.cx) / self.focal,
                 -(v - self.cy) / self.focal,
                 -jnp.ones_like(u, dtype=jnp.float32)],
                axis=-1,
            )
            rays_d = jnp.einsum("nij,nj->ni", pose[:, :3, :3], dirs,
                                precision=jax.lax.Precision.HIGHEST)
            rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
            rays_o = pose[:, :3, 3]
        else:
            img_idx = jax.random.randint(k_img, (), 0, self.n_images)
            colors = images[img_idx, v, u]
            if alphas is not None:
                alpha = alphas[img_idx, v, u]
            rays_o, rays_d = self._pixel_rays(
                poses[img_idx], u.astype(jnp.float32), v.astype(jnp.float32)
            )
        colors = colors.astype(jnp.float32) / 255.0
        batch = {"rays_o": rays_o, "rays_d": rays_d, "colors": colors}
        if alpha is not None:
            batch["alpha"] = alpha.astype(jnp.float32) / 255.0
        return batch

    def rays_for_pose(self, pose: jnp.ndarray):
        """All H*W rays of one camera (deterministic eval grid)."""
        us, vs = jnp.meshgrid(
            jnp.arange(self.W, dtype=jnp.float32),
            jnp.arange(self.H, dtype=jnp.float32),
        )
        return self._pixel_rays(pose, us.ravel(), vs.ravel())


def make_train_pipeline(cfg, dataset) -> DeviceRayPipeline:
    """The training pipeline of ``cfg.task_arg`` over a dataset that
    exposes ``as_arrays`` (and ``alpha_arrays`` for random backgrounds)."""
    images, poses, K = dataset.as_arrays()
    ta = cfg.task_arg
    alphas = None
    if bool(ta.get("random_bkgd", False)) and hasattr(dataset, "alpha_arrays"):
        alphas = dataset.alpha_arrays()
    return DeviceRayPipeline(
        images, poses, K,
        n_rays=int(ta.get("N_rays", 1024)),
        precrop_iters=int(ta.get("precrop_iters", 0)),
        precrop_frac=float(ta.get("precrop_frac", 0.5)),
        alphas=alphas,
    )


def rays_for_camera(pose, H, W, focal, cx=None, cy=None):
    """Standalone full-image ray grid (world frame, normalised dirs)."""
    cx = W / 2.0 if cx is None else cx
    cy = H / 2.0 if cy is None else cy
    us, vs = jnp.meshgrid(
        jnp.arange(W, dtype=jnp.float32), jnp.arange(H, dtype=jnp.float32)
    )
    u, v = us.ravel(), vs.ravel()
    dirs = jnp.stack([(u - cx) / focal, -(v - cy) / focal, -jnp.ones_like(u)], -1)
    pose = jnp.asarray(pose)
    rays_d = jnp.matmul(dirs, pose[:3, :3].T,
                        precision=jax.lax.Precision.HIGHEST)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = jnp.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o, rays_d
