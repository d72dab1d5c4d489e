"""Procedural NeRF-synthetic-format scene generator.

This environment ships no copy of the Blender lego dataset (the
reference's ``data/`` is empty), so we generate a *procedural* scene —
colored constant-density primitives inside the [-1,1]^3 cube — and
render ground-truth images by exact volume rendering along each ray.
Output follows the NeRF-synthetic layout the Blender loader reads
(reference src/datasets/nerf/blender.py): ``transforms_{split}.json``
with ``camera_angle_x`` + ``frames[].file_path/transform_matrix``, RGBA
PNGs, and ``*_depth_0001.png`` / ``*_normal_0001.png`` for the test
split.

The analytic field doubles as a training target: a NeRF trained on
these images must reproduce them, giving a real PSNR convergence signal
without external data.
"""

from __future__ import annotations

import json
import os

import numpy as np

# scene primitives: (center xyz, radius, rgb, density) spheres
DEFAULT_SPHERES = [
    ((0.0, 0.0, 0.0), 0.45, (0.85, 0.15, 0.10), 40.0),
    ((0.55, 0.0, 0.25), 0.28, (0.10, 0.70, 0.20), 60.0),
    ((-0.5, 0.35, -0.2), 0.25, (0.15, 0.25, 0.90), 60.0),
    ((0.0, -0.55, 0.4), 0.2, (0.95, 0.85, 0.10), 80.0),
    ((-0.1, 0.55, 0.45), 0.18, (0.90, 0.40, 0.80), 80.0),
]

# "hard" benchmark scene: many sharp (high-density) primitives carrying
# procedural 3-D plaid textures at three octaves (finest period ~0.05
# world units ≈ 8 px at 800² from the r=4 orbit) — the high-frequency
# content the flagship quality claim must survive, absent real lego
# data.
# Entry: (center, radius, rgb, density, tex_amp, tex_freq, tex_phase)
HARD_SPHERES = [
    ((0.0, 0.0, -0.15), 0.55, (0.80, 0.25, 0.15), 250.0,
     0.45, (23.0, 31.0, 17.0), (0.0, 1.3, 2.1)),
    ((0.62, 0.15, 0.18), 0.30, (0.15, 0.65, 0.25), 250.0,
     0.50, (55.0, 47.0, 61.0), (0.7, 0.2, 1.9)),
    ((-0.58, 0.30, -0.05), 0.27, (0.20, 0.30, 0.85), 250.0,
     0.50, (71.0, 83.0, 64.0), (2.3, 0.9, 0.4)),
    ((0.05, -0.60, 0.32), 0.24, (0.92, 0.80, 0.15), 250.0,
     0.45, (120.0, 95.0, 110.0), (1.1, 2.8, 0.6)),
    ((-0.15, 0.58, 0.40), 0.22, (0.85, 0.35, 0.75), 250.0,
     0.40, (140.0, 150.0, 125.0), (0.3, 1.7, 2.9)),
    ((0.35, 0.48, -0.38), 0.20, (0.25, 0.80, 0.80), 250.0,
     0.50, (90.0, 75.0, 105.0), (1.9, 0.5, 1.2)),
    ((-0.42, -0.45, 0.05), 0.23, (0.95, 0.55, 0.20), 250.0,
     0.45, (65.0, 58.0, 80.0), (2.6, 1.4, 0.8)),
    ((0.10, 0.05, 0.62), 0.18, (0.60, 0.60, 0.95), 250.0,
     0.50, (105.0, 130.0, 88.0), (0.9, 2.2, 1.6)),
]

# "med": the same geometry at lego-class texture frequencies (finest
# period ~20 px at 800² — comparable to lego's brick detail), the
# closest stand-in for the lego quality claim; "hard" stresses beyond it
MED_SPHERES = [
    (c, r, col, dens, amp, tuple(f * 0.4 for f in freq), ph)
    for (c, r, col, dens, amp, freq, ph) in HARD_SPHERES
]

SCENES = {"probe": DEFAULT_SPHERES, "hard": HARD_SPHERES,
          "med": MED_SPHERES}


def variant_spheres(name: str, n_min: int = 6, n_max: int = 9):
    """Deterministic per-name scene variant at med-class texture
    frequencies — the 8-scene sweep's stand-ins for the NeRF-synthetic
    scene list (chair/drums/..., BASELINE.json configs) in this
    offline environment. Same name -> same scene, any process."""
    import zlib

    g = np.random.default_rng(zlib.crc32(name.encode()) & 0xFFFFFFFF)
    n = int(g.integers(n_min, n_max + 1))
    spheres = [((0.0, 0.0, 0.0), 0.5, tuple(g.uniform(0.2, 0.9, 3)),
                220.0, 0.45, tuple(g.uniform(8.0, 25.0, 3)),
                tuple(g.uniform(0, 2 * np.pi, 3)))]
    for _ in range(n - 1):
        u = g.normal(size=3)
        u = u / np.linalg.norm(u)
        c = u * g.uniform(0.35, 0.75)
        spheres.append((
            tuple(c), float(g.uniform(0.15, 0.35)),
            tuple(g.uniform(0.1, 0.95, 3)), float(g.uniform(180, 260)),
            float(g.uniform(0.35, 0.5)), tuple(g.uniform(15.0, 60.0, 3)),
            tuple(g.uniform(0, 2 * np.pi, 3))))
    return spheres
CAMERA_ANGLE_X = 0.6911112070083618  # matches blender lego fov


def _tex_mod(pts, amp, freq, phase, np_=np):
    """3-D plaid modulation in [1-amp, 1+amp]; per-channel phase offsets
    decorrelate the color channels."""
    out = []
    for c in range(3):
        s = (np_.sin(freq[0] * pts[..., 0] + phase[0] + 1.1 * c)
             * np_.sin(freq[1] * pts[..., 1] + phase[1] + 0.7 * c)
             * np_.sin(freq[2] * pts[..., 2] + phase[2] + 1.9 * c))
        out.append(1.0 + amp * s)
    return np_.stack(out, -1)


def _sphere_fields(sphere):
    """Normalize a scene entry to (center, radius, rgb, density, tex)."""
    if len(sphere) == 4:
        center, radius, color, density = sphere
        return center, radius, color, density, None
    center, radius, color, density, amp, freq, phase = sphere
    return center, radius, color, density, (amp, freq, phase)


def field(pts: np.ndarray, spheres=DEFAULT_SPHERES):
    """sigma (...,), rgb (..., 3) of the analytic volume at pts (..., 3)."""
    sigma = np.zeros(pts.shape[:-1], dtype=np.float32)
    rgb = np.zeros(pts.shape[:-1] + (3,), dtype=np.float32)
    weight = np.zeros(pts.shape[:-1], dtype=np.float32)
    for sphere in spheres:
        center, radius, color, density, tex = _sphere_fields(sphere)
        inside = np.linalg.norm(pts - np.array(center), axis=-1) < radius
        sigma = np.where(inside, sigma + density, sigma)
        w = inside.astype(np.float32) * density
        col = np.array(color, dtype=np.float32)
        if tex is not None:
            col = np.clip(col * _tex_mod(pts, *tex), 0.0, 1.0)
        rgb += w[..., None] * col
        weight += w
    rgb = np.where(weight[..., None] > 0, rgb / np.maximum(weight[..., None], 1e-8), 0.0)
    return sigma, rgb


def normal_field(pts: np.ndarray, spheres=DEFAULT_SPHERES):
    """Surface normal of the nearest primitive (for test-split normals)."""
    best = np.full(pts.shape[:-1], np.inf, dtype=np.float32)
    normal = np.zeros_like(pts)
    for sphere in spheres:
        center, radius = _sphere_fields(sphere)[:2]
        d = pts - np.array(center, dtype=np.float32)
        dist = np.abs(np.linalg.norm(d, axis=-1) - radius)
        closer = dist < best
        best = np.where(closer, dist, best)
        n = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
        normal = np.where(closer[..., None], n, normal)
    return normal


def look_at_pose(eye: np.ndarray) -> np.ndarray:
    """c2w (4,4), OpenGL convention (camera -z looks at the origin)."""
    forward = -eye / np.linalg.norm(eye)            # camera -z
    up = np.array([0.0, 0.0, 1.0])
    if abs(forward @ up) > 0.999:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w


def camera_rays(pose: np.ndarray, H: int, W: int, focal: float):
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32) ,
                         np.arange(H, dtype=np.float32))
    dirs = np.stack(
        [(us - W / 2.0) / focal, -(vs - H / 2.0) / focal, -np.ones_like(us)], -1)
    rays_d = dirs @ pose[:3, :3].T
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o, rays_d


def render_gt(pose, H, W, focal, spheres=DEFAULT_SPHERES,
              n_samples=384, near=2.0, far=6.0):
    """Exact-ish volume render (dense midpoint quadrature): returns
    rgb (H,W,3), alpha (H,W), depth (H,W). Integration runs as a jitted
    JAX program — plain numpy is ~20x slower here."""
    import jax
    import jax.numpy as jnp

    rays_o, rays_d = camera_rays(pose, H, W, focal)
    t = jnp.linspace(near, far, n_samples, dtype=jnp.float32)
    dt = (far - near) / (n_samples - 1)
    parsed = [_sphere_fields(s) for s in spheres]
    centers = jnp.asarray([p[0] for p in parsed], dtype=jnp.float32)
    radii = jnp.asarray([p[1] for p in parsed], dtype=jnp.float32)
    colors = jnp.asarray([p[2] for p in parsed], dtype=jnp.float32)
    densities = jnp.asarray([p[3] for p in parsed], dtype=jnp.float32)
    texes = [p[4] for p in parsed]

    @jax.jit
    def integrate(o, d):
        pts = o[:, None, :] + d[:, None, :] * t[None, :, None]  # (N,S,3)
        # (N, S, K) membership over K spheres
        dist = jnp.linalg.norm(pts[..., None, :] - centers, axis=-1)
        inside = (dist < radii).astype(jnp.float32)
        w_k = inside * densities
        sigma = w_k.sum(-1)
        wsum = jnp.maximum(w_k.sum(-1, keepdims=True), 1e-8)
        col_k = jnp.broadcast_to(colors, pts.shape[:-1] + colors.shape)
        if any(tx is not None for tx in texes):
            col_k = jnp.stack(
                [jnp.clip(colors[k] * _tex_mod(pts, *texes[k], np_=jnp),
                          0.0, 1.0)
                 if texes[k] is not None
                 else jnp.broadcast_to(colors[k], pts.shape[:-1] + (3,))
                 for k in range(len(parsed))], axis=-2)
        rgb = (w_k[..., None] * col_k).sum(-2) / wsum
        alpha = 1.0 - jnp.exp(-sigma * dt)
        trans = jnp.cumprod(1.0 - alpha + 1e-10, axis=-1)
        trans = jnp.concatenate(
            [jnp.ones_like(trans[..., :1]), trans[..., :-1]], -1)
        w = alpha * trans
        rgb_ray = (w[..., None] * rgb).sum(-2)
        acc = w.sum(-1)
        depth = (w * t[None]).sum(-1) / jnp.maximum(acc, 1e-8)
        return rgb_ray, acc, depth

    # tile rays: the (N, S, K, 3) membership intermediate at 800x800x384
    # would be ~24 GB un-tiled
    chunk = 10000
    n = H * W
    n_pad = (-n) % chunk
    ro = np.pad(rays_o.reshape(-1, 3), ((0, n_pad), (0, 0)))
    rd = np.pad(rays_d.reshape(-1, 3), ((0, n_pad), (0, 0)),
                constant_values=1.0)

    @jax.jit
    def integrate_tiled(o, d):
        return jax.lax.map(
            lambda t: integrate(t[0], t[1]),
            (o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3)))

    rgb, acc, depth = integrate_tiled(jnp.asarray(ro), jnp.asarray(rd))
    return (np.asarray(rgb).reshape(-1, 3)[:n].reshape(H, W, 3),
            np.asarray(acc).reshape(-1)[:n].reshape(H, W),
            np.asarray(depth).reshape(-1)[:n].reshape(H, W))


def generate_scene(
    out_root: str,
    scene: str = "probe",
    H: int = 200,
    W: int = 200,
    n_train: int = 30,
    n_val: int = 4,
    n_test: int = 8,
    radius: float = 4.0,
    seed: int = 0,
    spheres=None,
):
    """Write a complete NeRF-synthetic-format scene; returns its dir."""
    from .png import write_png

    if spheres is None:
        spheres = SCENES.get(scene, DEFAULT_SPHERES)
    rng = np.random.default_rng(seed)
    scene_dir = os.path.join(out_root, scene)
    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2.0))

    def poses_for(n, split_seed):
        g = np.random.default_rng(seed + split_seed)
        phis = g.uniform(0, 2 * np.pi, n)
        thetas = np.arccos(g.uniform(0.15, 0.85, n))  # avoid poles
        eyes = np.stack(
            [radius * np.sin(thetas) * np.cos(phis),
             radius * np.sin(thetas) * np.sin(phis),
             radius * np.cos(thetas)], -1)
        return [look_at_pose(e) for e in eyes]

    for split, n, sseed in (("train", n_train, 1), ("val", n_val, 2),
                            ("test", n_test, 3)):
        split_dir = os.path.join(scene_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        frames = []
        for i, pose in enumerate(poses_for(n, sseed)):
            rgb, alpha, depth = render_gt(pose, H, W, focal, spheres)
            rgba = np.concatenate([rgb, alpha[..., None]], -1)
            name = f"r_{i}"
            write_png(os.path.join(split_dir, name + ".png"),
                      (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            if split == "test":
                d8 = (np.clip(depth / 8.0, 0, 1) * 255).astype(np.uint8)
                write_png(os.path.join(split_dir, name + "_depth_0001.png"),
                          d8)
                rays_o, rays_d = camera_rays(pose, H, W, focal)
                pts = rays_o + rays_d * depth[..., None]
                nrm = normal_field(pts)
                n8 = ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)
                write_png(os.path.join(split_dir, name + "_normal_0001.png"),
                          n8)
            frames.append({
                "file_path": f"./{split}/{name}",
                "rotation": 0.0,
                "transform_matrix": pose.tolist(),
            })
        with open(os.path.join(scene_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return scene_dir
