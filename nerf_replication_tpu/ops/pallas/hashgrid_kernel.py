"""Bricked multi-resolution hash-grid encode: plain jnp and Pallas Triton.

Covers the reference's CUDA hash encoder (hashencoder.cu:78-271) for the
bricked parameter layout that the NGP configs and checkpoints use:

* Each level's table stores BRICKS of 4^3 cells = 5^3 = 125 vertices. A
  brick is ONE table row of 256 floats: feature 0 of vertex v at column
  v, feature 1 at column 128+v (v = vx*25 + vy*5 + vz in [0,124]).
* Coarse levels store bricks densely; fine levels hash the BRICK
  coordinate with the instant-ngp XOR primes (hashencoder.cu:37-52), so
  collisions alias 4^3-cell blocks instead of single vertices.

Interpolation inside a brick is instant-ngp trilinear interpolation.
Per (point, level) the encode computes the brick row and the 8 in-brick
corner columns, gathers 16 scalars from the flattened ``(n_rows*256,)``
table and interpolates. Two implementations share that arithmetic
(:func:`_level_corners`):

* :func:`brick_encode_jnp` — plain jnp: XLA's gather forward and, by
  autodiff, XLA's scatter-add backward.
* :func:`brick_encode_triton` — the CUDA kernel's design through Pallas
  Triton: one program per block of points gathers the corners of every
  level and interpolates; the backward recomputes the corners and
  ``atomic_add``-s the weighted upstream gradient into an f32 table
  gradient (hashencoder.cu:201-271).

:func:`brick_encode` picks one from ``jax.default_backend()``. The
vertex-exact formulation stays available as
``HashGridEncoder(backend="xla")``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BRICK = 4          # cells per brick side
BW = BRICK + 1     # vertices per brick side
ROW = 256          # floats per table row: [f0 x 125 pad | f1 x 125 pad]
BLOCK = 128        # points per Triton program (a power of two)
_PRIMES = (1, 2654435761, 805459861)
_CP = plgpu.CompilerParams(num_warps=4, num_stages=1)


class BrickLayout(NamedTuple):
    """Static description of the bricked multi-level table."""
    scales: tuple          # cells per side, per level
    bsides: tuple          # bricks per side, per level
    offsets: tuple         # first table row per level (+ total at end)
    use_hash: tuple        # whether the level hashes brick coords
    n_rows: int            # total table rows


def make_brick_layout(n_levels: int, base_resolution: int,
                      finest_resolution: int, log2_bricks: int = 12,
                      per_level_scale: float = 2.0) -> BrickLayout:
    if finest_resolution and finest_resolution > 0 and n_levels > 1:
        b = (finest_resolution / base_resolution) ** (1.0 / (n_levels - 1))
    else:
        b = per_level_scale
    cap = 2 ** log2_bricks
    scales, bsides, offsets, use_hash = [], [], [0], []
    for i in range(n_levels):
        res = int(np.ceil(base_resolution * (b ** i)))
        bs = -(-res // BRICK)
        dense = bs ** 3
        n = min(dense, cap)
        n = int(np.ceil(n / 128) * 128)  # 128-aligned rows per level
        scales.append(res)
        bsides.append(bs)
        use_hash.append(dense > cap)
        offsets.append(offsets[-1] + n)
    return BrickLayout(tuple(scales), tuple(bsides), tuple(offsets),
                       tuple(use_hash), offsets[-1])


def _brick_id(layout: BrickLayout, l: int, bc):
    """Per-component brick coords (3 x (N,) int32) -> LOCAL brick id."""
    if layout.use_hash[l]:
        cap = layout.offsets[l + 1] - layout.offsets[l]
        cap_pow2 = 1 << int(np.floor(np.log2(cap)))
        h = bc[0].astype(jnp.uint32)
        h = h ^ (bc[1].astype(jnp.uint32) * jnp.uint32(_PRIMES[1]))
        h = h ^ (bc[2].astype(jnp.uint32) * jnp.uint32(_PRIMES[2]))
        return (h & jnp.uint32(cap_pow2 - 1)).astype(jnp.int32)
    bs = layout.bsides[l]
    return (bc[0] * bs + bc[1]) * bs + bc[2]


def _level_corners(layout: BrickLayout, l: int, px, py, pz):
    """Coordinates (B,) in [0,1] -> flat table index of feature 0 of the 8
    trilinear corners (B, 8) int32 and their weights (B, 8) f32. Corner
    c has offsets (c>>2 & 1, c>>1 & 1, c & 1). Shared by the jnp encode
    and both Triton kernels."""
    res = layout.scales[l]
    cells, fracs = [], []
    for p in (px, py, pz):
        pos = p * res
        cell = jnp.clip(jnp.floor(pos), 0.0, res - 1.0)
        fracs.append(pos - cell)
        cells.append(cell.astype(jnp.int32))
    row = layout.offsets[l] + _brick_id(
        layout, l, [c >> 2 for c in cells])           # // BRICK
    loc = [c & (BRICK - 1) for c in cells]
    corner = jax.lax.broadcasted_iota(jnp.int32, (1, 8), 1)
    d = [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1]
    v = ((loc[0][:, None] + d[0]) * (BW * BW)
         + (loc[1][:, None] + d[1]) * BW + (loc[2][:, None] + d[2]))
    w = None
    for a in range(3):
        f = fracs[a][:, None]
        wa = jnp.where(d[a] == 1, f, 1.0 - f)
        w = wa if w is None else w * wa
    return row[:, None] * ROW + v, w


# -- plain jnp -----------------------------------------------------------------

def brick_encode_jnp(layout: BrickLayout, table, x):
    """x (N, 3) in [0,1], table (n_rows, 256) -> (N, 2L) features; a
    gather of the 16 corner scalars per (point, level)."""
    flat = table.astype(jnp.float32).reshape(-1)
    x = x.astype(jnp.float32)
    feats = []
    for l in range(len(layout.scales)):
        idx, w = _level_corners(layout, l, x[:, 0], x[:, 1], x[:, 2])
        for f in range(2):
            vals = flat.at[idx + f * 128].get(mode="promise_in_bounds")
            feats.append(jnp.sum(w * vals, axis=-1))
    return jnp.stack(feats, axis=-1)


# -- Pallas Triton -------------------------------------------------------------

def _fwd_kernel(layout, npad, x_ref, tab_ref, out_ref):
    start = pl.multiple_of(pl.program_id(0) * BLOCK, BLOCK)
    px, py, pz = (x_ref[pl.ds(a * npad + start, BLOCK)] for a in range(3))
    for l in range(len(layout.scales)):
        idx, w = _level_corners(layout, l, px, py, pz)
        for f in range(2):
            vals = tab_ref[idx + f * 128]
            out_ref[pl.ds((2 * l + f) * npad + start, BLOCK)] = jnp.sum(
                w * vals, axis=1)


def _bwd_kernel(layout, npad, interpret, x_ref, g_ref, _zero_ref, dtab_ref):
    start = pl.multiple_of(pl.program_id(0) * BLOCK, BLOCK)
    px, py, pz = (x_ref[pl.ds(a * npad + start, BLOCK)] for a in range(3))
    for l in range(len(layout.scales)):
        idx, w = _level_corners(layout, l, px, py, pz)
        for f in range(2):
            g = g_ref[pl.ds((2 * l + f) * npad + start, BLOCK)]
            if interpret:
                # the interpreter discharges atomic_add as a gather plus a
                # scatter-SET, which keeps one of several equal indices;
                # a scatter-add of the same indices and values is the
                # atomic's semantics
                dtab_ref[...] = dtab_ref[...].at[idx + f * 128].add(
                    w * g[:, None])
            else:
                plgpu.atomic_add(dtab_ref, idx + f * 128, w * g[:, None])


def _pad_t(a, npad):
    """(N, C) -> column-major flat (C * npad,) f32, zero-padded rows."""
    a = a.astype(jnp.float32)
    return jnp.pad(a.T, ((0, 0), (0, npad - a.shape[0]))).reshape(-1)


def _triton_fwd(layout, table, x, interpret=False):
    n, L = x.shape[0], len(layout.scales)
    npad = -(-n // BLOCK) * BLOCK
    out = pl.pallas_call(
        partial(_fwd_kernel, layout, npad),
        out_shape=jax.ShapeDtypeStruct((2 * L * npad,), jnp.float32),
        grid=(npad // BLOCK,),
        compiler_params=_CP,
        interpret=interpret,
        name="brick_encode_fwd",
    )(_pad_t(x, npad), table.astype(jnp.float32).reshape(-1))
    return out.reshape(2 * L, npad)[:, :n].T


def _triton_bwd(layout, x, g, interpret=False):
    """Table gradient (n_rows, 256) f32 of the encode at x for cotangent g."""
    n = x.shape[0]
    npad = -(-n // BLOCK) * BLOCK
    dtab = pl.pallas_call(
        partial(_bwd_kernel, layout, npad, interpret),
        out_shape=jax.ShapeDtypeStruct((layout.n_rows * ROW,), jnp.float32),
        grid=(npad // BLOCK,),
        input_output_aliases={2: 0},
        compiler_params=_CP,
        interpret=interpret,
        name="brick_encode_bwd",
    )(_pad_t(x, npad), _pad_t(g, npad),
      jnp.zeros((layout.n_rows * ROW,), jnp.float32))
    return dtab.reshape(layout.n_rows, ROW)


@partial(jax.custom_vjp, nondiff_argnums=(0, 3))
def brick_encode_triton(layout: BrickLayout, table, x, interpret=False):
    """Same contract as :func:`brick_encode_jnp`; ``interpret`` runs the
    kernels in the Pallas interpreter (tests)."""
    return _triton_fwd(layout, table, x, interpret)


def _vjp_fwd(layout, table, x, interpret):
    return _triton_fwd(layout, table, x, interpret), (table, x)


def _vjp_bwd(layout, interpret, res, g):
    table, x = res
    dtab = _triton_bwd(layout, x, g, interpret)
    return dtab.astype(table.dtype), jnp.zeros_like(x)


brick_encode_triton.defvjp(_vjp_fwd, _vjp_bwd)


def select_encode(platform: str):
    """The brick encode for a JAX platform name."""
    if platform == "gpu":
        return brick_encode_triton
    if platform == "cpu":
        return brick_encode_jnp
    raise NotImplementedError(
        f"no brick hash-grid encode for platform {platform!r}")


def brick_encode(layout: BrickLayout, table, x):
    """x (N, 3) in [0,1], table (n_rows, 256) -> (N, 2L) features, by the
    implementation for the default backend."""
    return select_encode(jax.default_backend())(layout, table, x)
