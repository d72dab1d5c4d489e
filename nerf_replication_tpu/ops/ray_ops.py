"""Core volume-rendering ray ops.

Pure, shape-static, jit-friendly re-designs of the reference renderer's
building blocks (src/models/nerf/renderer/volume_renderer.py):

* :func:`stratified_sample` — coarse depths with optional per-bin jitter
  (reference ``stratified_sample_points_from_rays`` :27-65).
* :func:`compute_weights` — alpha compositing weights via exclusive
  cumulative transmittance (reference ``weights_computation`` :67-96).
* :func:`sample_pdf` — hierarchical inverse-CDF importance resampling
  (reference ``fine_sample_points`` :98-272, minus the debug prints).
* :func:`composite` — weighted RGB/depth/acc integration with optional
  white background (reference ``render`` :412-430).
* :func:`get_rays` — pixel grid -> world-space rays (reference
  src/datasets/nerf/blender.py:120-127) done on device.

Everything is dense and statically shaped: the reference's three nested
Python chunk loops exist only to fit GPU memory and are replaced by XLA
tiling (an outer ``lax.map`` over ray tiles lives in the renderer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def get_rays(uv: jnp.ndarray, K_inv: jnp.ndarray, c2w: jnp.ndarray,
             normalize: bool = True):
    """World-space rays through pixel centers.

    Args:
      uv: (..., 2) float pixel coordinates (x, y).
      K_inv: (3, 3) inverse intrinsics.
      c2w: (3, 4) or (4, 4) camera-to-world (OpenGL convention: camera
        looks along -z, as in the Blender transforms.json files).
      normalize: unit-length directions (default) — the reference
        parametrisation (blender.py:126 ``rays_d /= norm``) and what every
        ray generator in this framework uses.

    Returns:
      (rays_o, rays_d): each (..., 3).
    """
    x, y = uv[..., 0], uv[..., 1]
    # camera-frame directions: (x - cx)/fx, -(y - cy)/fy, -1
    ones = jnp.ones_like(x)
    pix = jnp.stack([x, y, ones], axis=-1)
    cam = pix @ K_inv.T
    dirs = jnp.stack([cam[..., 0], -cam[..., 1], -ones], axis=-1)
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    rays_d = dirs @ R.T
    if normalize:
        rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = jnp.broadcast_to(t, rays_d.shape)
    return rays_o, rays_d


def camera_rays(H: int, W: int, focal: float, c2w: jnp.ndarray):
    """All H*W rays of a pinhole camera with the principal point at the
    image centre (blender convention: -z forward, +y up): (rays_o,
    rays_d) (H*W, 3) f32 in the world frame, directions normalised. The
    rotation runs at full f32 precision: bf16 or TF32 inputs would move
    directions by ~1e-3 relative, several finest hash cells at the far
    plane."""
    us, vs = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                          jnp.arange(H, dtype=jnp.float32))
    u, v = us.ravel(), vs.ravel()
    dirs = jnp.stack([(u - W / 2.0) / focal, -(v - H / 2.0) / focal,
                      -jnp.ones_like(u)], -1)
    rays_d = jnp.matmul(dirs, c2w[:3, :3].T,
                        precision=jax.lax.Precision.HIGHEST)
    rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    return jnp.broadcast_to(c2w[:3, 3], rays_d.shape), rays_d


def stratified_sample(
    n_rays: int,
    n_samples: int,
    near: float,
    far: float,
    key: jax.Array | None = None,
    lindisp: bool = False,
) -> jnp.ndarray:
    """Coarse sample depths ``t`` of shape (n_rays, n_samples).

    With a PRNG ``key``, each sample is jittered uniformly within its
    stratum (training); with ``key=None`` the deterministic bin centers
    (linspace) are used (eval) — the reference's ``perturb`` switch
    (volume_renderer.py:47-60).
    """
    u = jnp.linspace(0.0, 1.0, n_samples)
    if lindisp:
        t = 1.0 / (1.0 / near * (1.0 - u) + 1.0 / far * u)
    else:
        t = near * (1.0 - u) + far * u
    t = jnp.broadcast_to(t, (n_rays, n_samples))
    if key is not None:
        mids = 0.5 * (t[..., 1:] + t[..., :-1])
        upper = jnp.concatenate([mids, t[..., -1:]], axis=-1)
        lower = jnp.concatenate([t[..., :1], mids], axis=-1)
        r = jax.random.uniform(key, t.shape)
        t = lower + (upper - lower) * r
    return t


def density_activation(name: str):
    """'relu' (reference volume_renderer.py:419 parity) or 'softplus'
    (strictly positive gradient — prevents the dead-ReLU white-background
    collapse where sigma<0 everywhere kills all gradients)."""
    if name == "softplus":
        return jax.nn.softplus
    return jax.nn.relu


def compute_weights(
    sigma: jnp.ndarray,
    t: jnp.ndarray,
    rays_d: jnp.ndarray | None = None,
    raw_noise_std: float = 0.0,
    key: jax.Array | None = None,
    alpha_eps: float = 1e-10,
    activation=None,
    finite_tail: bool = False,
):
    """Compositing weights from raw densities.

    Args:
      sigma: (..., S) raw density (pre-activation).
      t: (..., S) sample depths.
      rays_d: (..., 3) unnormalised ray directions; when given, interval
        lengths are scaled by ``|rays_d|`` so sigma is in world units.
      raw_noise_std / key: optional Gaussian regularisation noise added to
        raw sigma during training (reference cfg ``raw_noise_std``).

    Returns:
      (weights, alpha, trans): each (..., S). ``trans`` is the exclusive
      transmittance T_i = prod_{j<i}(1 - alpha_j + eps)
      (reference weights_computation, volume_renderer.py:80-95, with the
      1e10 far-tail delta).

    ``finite_tail``: use the last sample spacing as the tail delta
    instead of the reference's 1e10. REQUIRED for strictly-positive
    density activations (softplus): sigma > 0 times an infinite tail
    makes the last sample absorb ALL remaining transmittance, so
    acc == 1 on every ray — background compositing (and any
    background-dependent loss term) is structurally dead, and the model
    must paint the background into a far fog shell (the round-2 "white
    fog" failure). relu configs keep the reference semantics.
    """
    delta = t[..., 1:] - t[..., :-1]
    tail = (delta[..., -1:] if finite_tail
            else jnp.full_like(delta[..., :1], 1e10))
    delta = jnp.concatenate([delta, tail], axis=-1)
    if rays_d is not None:
        delta = delta * jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    if raw_noise_std > 0.0 and key is not None:
        sigma = sigma + jax.random.normal(key, sigma.shape) * raw_noise_std
    act = activation if activation is not None else jax.nn.relu
    alpha = 1.0 - jnp.exp(-act(sigma) * delta)
    # exclusive cumprod of (1 - alpha): T_0 = 1
    trans = jnp.cumprod(1.0 - alpha + alpha_eps, axis=-1)
    trans = jnp.concatenate([jnp.ones_like(trans[..., :1]), trans[..., :-1]], axis=-1)
    weights = alpha * trans
    return weights, alpha, trans


def sample_pdf(
    bins: jnp.ndarray,
    weights: jnp.ndarray,
    n_importance: int,
    key: jax.Array | None = None,
    eps: float = 1e-5,
) -> jnp.ndarray:
    """Inverse-CDF importance sampling of ``n_importance`` new depths.

    Args:
      bins: (..., B+1) bin edges (the coarse sample midpoints).
      weights: (..., B) coarse compositing weights for the bins.
      key: PRNG key for uniform u (training); None -> deterministic
        linspace u (eval), matching the reference's train/test split
        (volume_renderer.py:143-147).

    Returns:
      (..., n_importance) sampled depths (NOT sorted into the coarse set;
      the caller unions + sorts).
    """
    weights = weights + eps
    pdf = weights / jnp.sum(weights, axis=-1, keepdims=True)
    cdf = jnp.cumsum(pdf, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)  # (..., B+1)

    if key is not None:
        u = jax.random.uniform(key, cdf.shape[:-1] + (n_importance,))
    else:
        u = jnp.linspace(0.0, 1.0, n_importance)
        u = jnp.broadcast_to(u, cdf.shape[:-1] + (n_importance,))

    # Inverse CDF without searchsorted + take_along_axis (per-ray
    # sequential scans and gathers): exploit that cdf AND bins are both
    # monotone per ray: the right-bisection endpoints are
    #   below = argmax_i {cdf_i <= u}   -> max of masked (cdf, bins)
    #   above = argmin_j {cdf_j >  u}   -> min of masked (cdf, bins)
    # expressed as masked min/max reductions over the bin axis — one
    # reduction fusion, no gathers, no batched matmuls. Tie/tail behavior
    # matches torch.searchsorted(right=True) + clamped gathers
    # (volume_renderer.py:152-264): duplicates pick the last <=-entry /
    # first >-entry; u beyond the final cdf degenerates to the last edge.
    BIG = jnp.float32(1e10)
    uu = u[..., :, None]          # (..., M, 1)
    cc = cdf[..., None, :]        # (..., 1, B+1)
    bb = bins[..., None, :]       # (..., 1, B+1)
    ge = uu >= cc                 # (..., M, B+1)

    cdf_below = jnp.max(jnp.where(ge, cc, -BIG), axis=-1)
    bin_below = jnp.max(jnp.where(ge, bb, -BIG), axis=-1)
    cdf_above = jnp.min(jnp.where(ge, BIG, cc), axis=-1)
    bin_above = jnp.min(jnp.where(ge, BIG, bb), axis=-1)
    # tail: u >= cdf[..., -1] leaves the "above" set empty -> last edge
    tail = cdf_above >= BIG
    cdf_above = jnp.where(tail, cdf[..., -1:], cdf_above)
    bin_above = jnp.where(tail, bins[..., -1:], bin_above)

    denom = cdf_above - cdf_below
    denom = jnp.where(denom < eps, 1.0, denom)
    frac = (u - cdf_below) / denom
    return bin_below + frac * (bin_above - bin_below)


def composite(
    rgb: jnp.ndarray,
    weights: jnp.ndarray,
    t: jnp.ndarray,
    white_bkgd: bool = False,
):
    """Integrate per-sample radiance into per-ray RGB/depth/acc.

    reference volume_renderer.py:425-430: ``rgb = sum(w*c)``,
    ``depth = sum(w*t)``, white background composites ``rgb += 1 - acc``.
    """
    rgb_map = jnp.sum(weights[..., None] * rgb, axis=-2)
    depth_map = jnp.sum(weights * t, axis=-1)
    acc_map = jnp.sum(weights, axis=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map


def ray_aabb_intersect(
    rays_o: jnp.ndarray, rays_d: jnp.ndarray, bbox_min, bbox_max,
    near_default: float, far_default: float,
):
    """Slab-test near/far per ray against an AABB (reference
    src/utils/data_utils.py:601 ``get_near_far`` capability)."""
    inv_d = 1.0 / jnp.where(jnp.abs(rays_d) < 1e-10, 1e-10, rays_d)
    t0 = (jnp.asarray(bbox_min) - rays_o) * inv_d
    t1 = (jnp.asarray(bbox_max) - rays_o) * inv_d
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = tmax > jnp.maximum(tmin, 0.0)
    near = jnp.where(hit, jnp.maximum(tmin, 0.0), near_default)
    far = jnp.where(hit, tmax, far_default)
    return near, far, hit
