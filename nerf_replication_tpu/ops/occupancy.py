"""Occupancy grid: instant-ngp-style empty-space skipping, static shapes.

The reference's ESS/ERT (volume_renderer.py:132-244) derives validity
masks from the CURRENT batch's coarse densities — every ray still pays
the coarse MLP. An occupancy grid caches where the trained field has
mass (the instant-ngp density-bitfield idea) so background rays are
culled BEFORE any MLP call:

* :func:`build_occupancy_grid` — query the trained density on an R^3
  lattice (chunked, one jitted program), threshold, then conservatively
  dilate by max-pooling so thin structures straddling cell borders stay
  covered.
* :func:`rays_active` — probe each ray's coarse sample positions
  against the grid (one cheap uint8 gather per sample, no MLP); a ray
  with no occupied probe renders as pure background.

Quality contract: culling is per-RAY, and active rays run the exact
dense coarse+fine math — outputs for active rays are identical to the
dense renderer. The dilation radius must exceed the probe step so a
ray cannot step over an occupied cell (the frame renderer sizes this
automatically).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def build_occupancy_grid(density_fn, params, resolution: int = 64,
                         bbox=(-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
                         threshold: float = 0.01, dilate: int = 2,
                         chunk: int = 65536):
    """Returns (grid uint8 (R, R, R), bbox tuple).

    density_fn(params, pts (N,3)) -> activated sigma (N,). ``threshold``
    is in density units: alpha over one cell ~= 1 - exp(-sigma * cell).
    """
    lo = np.asarray(bbox[:3], np.float32)
    hi = np.asarray(bbox[3:], np.float32)
    r = resolution
    centers = (np.arange(r, dtype=np.float32) + 0.5) / r
    grid_pts = np.stack(np.meshgrid(
        lo[0] + centers * (hi[0] - lo[0]),
        lo[1] + centers * (hi[1] - lo[1]),
        lo[2] + centers * (hi[2] - lo[2]), indexing="ij"), -1).reshape(-1, 3)

    n = grid_pts.shape[0]
    n_pad = (-n) % chunk
    pts = np.pad(grid_pts, ((0, n_pad), (0, 0))).reshape(-1, chunk, 3)

    @jax.jit
    def query(params, pts):
        sigma = jax.lax.map(lambda p: density_fn(params, p), pts)
        occ = (sigma > threshold).astype(jnp.uint8)
        return occ

    occ = np.asarray(query(params, jnp.asarray(pts))).reshape(-1)[:n]
    grid = occ.reshape(r, r, r)
    if dilate > 0:
        grid = _dilate(grid, dilate)
    return grid, tuple(np.concatenate([lo, hi]).tolist())


def _dilate(grid: np.ndarray, k: int) -> np.ndarray:
    """Conservative max-pool dilation by k cells along each axis (host
    numpy — runs once per grid build)."""
    out = grid.copy()
    for axis in range(3):
        acc = out.copy()
        for s in range(1, k + 1):
            acc = np.maximum(acc, np.roll(out, s, axis=axis))
            acc = np.maximum(acc, np.roll(out, -s, axis=axis))
            # roll wraps; zero the wrapped borders
            sl = [slice(None)] * 3
            sl[axis] = slice(0, s)
            acc[tuple(sl)] = np.maximum(grid, out)[tuple(sl)]
        out = acc
    # redo borders conservatively: wrap artifacts only ADD occupancy at
    # edges, which is safe (conservative), so keep it simple
    return out


def ray_spans(rays_o, rays_d, t_probe, grid, bbox, margin: float = 0.0):
    """Per-ray occupied span [t_enter, t_exit] from grid probes.

    The instant-ngp raymarcher advances rays only through occupied
    cells; the static-shape analog bounds each ray's sample
    range to the first..last occupied probe (one dense probe pass, then
    masked min/max reductions — no data-dependent loops).

    Args:
      rays_o/rays_d: (N, 3); t_probe: (S,) probe depths; grid (R,R,R)
      uint8 (dilated); bbox (6,); margin: widen the span by this much on
      each side (callers pass ~2 probe steps so a surface straddling a
      probe interval stays inside).

    Returns (active (N,), t_enter (N,), t_exit (N,)): inactive rays get
    the full [t_probe[0], t_probe[-1]] span.
    """
    lo = jnp.asarray(bbox[:3], jnp.float32)
    hi = jnp.asarray(bbox[3:], jnp.float32)
    r = grid.shape[0]
    t = jnp.asarray(t_probe)
    pts = rays_o[:, None] + rays_d[:, None] * t[None, :, None]   # (N, S, 3)
    u = (pts - lo) / (hi - lo)
    inside = jnp.all((u >= 0.0) & (u < 1.0), axis=-1)
    cell = jnp.clip((u * r).astype(jnp.int32), 0, r - 1)
    flat = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
    occ = jnp.take(grid.reshape(-1), flat.reshape(-1),
                   axis=0).reshape(flat.shape)
    hit = (occ > 0) & inside                                      # (N, S)
    active = jnp.any(hit, axis=-1)
    t_lo = jnp.float32(t[0])
    t_hi = jnp.float32(t[-1])
    BIG = jnp.float32(1e10)
    t_enter = jnp.min(jnp.where(hit, t[None, :], BIG), axis=-1)
    t_exit = jnp.max(jnp.where(hit, t[None, :], -BIG), axis=-1)
    t_enter = jnp.clip(t_enter - margin, t_lo, t_hi)
    t_exit = jnp.clip(t_exit + margin, t_lo, t_hi)
    t_enter = jnp.where(active, t_enter, t_lo)
    t_exit = jnp.where(active, t_exit, t_hi)
    return active, t_enter, t_exit


def points_occupied(pts, grid, bbox):
    """(..., 3) world points -> (...) bool occupancy (points outside the
    bbox are unoccupied). Trace-safe."""
    lo = jnp.asarray(bbox[:3], jnp.float32)
    hi = jnp.asarray(bbox[3:], jnp.float32)
    r = grid.shape[0]
    u = (pts - lo) / (hi - lo)
    inside = jnp.all((u >= 0.0) & (u < 1.0), axis=-1)
    cell = jnp.clip((u * r).astype(jnp.int32), 0, r - 1)
    flat = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
    occ = jnp.take(grid.reshape(-1), flat.reshape(-1),
                   axis=0).reshape(flat.shape)
    return (occ > 0) & inside


def rays_active(rays_o, rays_d, t_probe, grid, bbox):
    """Probe occupancy along each ray at depths ``t_probe``.

    Args:
      rays_o/rays_d: (N, 3); t_probe: (S,) or (N, S) sample depths.
      grid: (R, R, R) uint8; bbox: (6,) lo/hi.

    Returns active (N,) bool: any probe lands in an occupied cell.
    Trace-safe (pure jnp) — call inside jit.
    """
    lo = jnp.asarray(bbox[:3], jnp.float32)
    hi = jnp.asarray(bbox[3:], jnp.float32)
    r = grid.shape[0]
    t = jnp.broadcast_to(jnp.asarray(t_probe),
                         (rays_o.shape[0],) + jnp.shape(t_probe)[-1:])
    pts = rays_o[:, None] + rays_d[:, None] * t[..., None]    # (N, S, 3)
    u = (pts - lo) / (hi - lo)
    inside = jnp.all((u >= 0.0) & (u < 1.0), axis=-1)          # (N, S)
    cell = jnp.clip((u * r).astype(jnp.int32), 0, r - 1)
    flat = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
    occ = jnp.take(grid.reshape(-1), flat.reshape(-1),
                   axis=0).reshape(flat.shape)
    return jnp.any((occ > 0) & inside, axis=-1)
