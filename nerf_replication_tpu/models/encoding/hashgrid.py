"""Multi-resolution hash-grid encoders (instant-ngp style).

Capability parity with the reference's CUDA hash encoder
(src/models/encoding/hashencoder/src/hashencoder.cu: prime-XOR spatial
hash :37-52, dense-below/hash-above-threshold indexing :56-74, per-level
2^D-corner linear interpolation :78-197) and its composite autograd
wrappers (hashencoder/hashgrid.py: HashEncoder :121-219, TriPlane
:222-238, Motion2d :241-286, HashLatent :289-303, HashEncoder4d
:306-318, HashEncoderCoef :321-351), plus the pure-tensor fallbacks
(src/models/encoding/hashgrid.py:12-134, triplane.py:8-102).

The vertex-exact ("xla") forward is ONE fused gather over all levels —
corner indices carry per-level global offsets into the concatenated
table, so the 2^D-corner interpolation for every level is a single
``jnp.take`` + weighted sum (XLA fuses the weighting). The backward is
a ``custom_vjp`` that either scatter-adds the gradient rows or sorts
them by table index and segment-sums them — a deterministic form of
the CUDA kernel's ``atomicAdd`` (hashencoder.cu:254-269). The "brick"
backend is the bricked encode of ``ops/pallas/hashgrid_kernel.py``.
Input gradients (needed when upstream modules
warp the query points, e.g. Motion2D's deformation MLP) use the
analytic interpolation-weight derivative, matching the CUDA
``kernel_input_backward`` (hashencoder.cu:275-297), and are gated by
``input_grad`` so plain point encoders skip the extra gather.

Notes vs the reference:
* the reference nudges the table size to the next prime (sympy isprime,
  hashgrid.py:26-30) for its python fallback but uses power-of-two
  tables in CUDA; we keep power-of-two (fast modulo as bit-and).
* the reference CUDA wrapper contains a live ipdb breakpoint
  (hashgrid.py:136) making it unrunnable as shipped; n/a here.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..module import Dense, Module

EPS = 1e-6
# instant-ngp hash primes (hashencoder.cu:37-52); first dim un-multiplied
_PRIMES = (1, 2654435761, 805459861, 3674653429)


def _level_layout(input_dim, n_levels, log2_hashmap_size, base_resolution,
                  finest_resolution, per_level_scale):
    """Resolutions, table offsets and dense/hash switch per level
    (reference hashgrid.py:41-52 semantics, 8-aligned like
    hashencoder/hashgrid.py:171)."""
    if finest_resolution and finest_resolution > 0 and n_levels > 1:
        b = (finest_resolution / base_resolution) ** (1.0 / (n_levels - 1))
    else:
        b = per_level_scale
    table_size = 2 ** log2_hashmap_size
    scales, offsets, use_hash = [], [0], []
    for i in range(n_levels):
        res = int(np.ceil(base_resolution * (b ** i)))
        scales.append(res)
        dense = (res + 1) ** input_dim
        n_entries = min(dense, table_size)
        n_entries = int(np.ceil(n_entries / 8) * 8)  # 8-aligned
        use_hash.append(dense > table_size)
        offsets.append(offsets[-1] + n_entries)
    return scales, offsets, use_hash, table_size


def normalize_to_unit(x, bounds):
    """Clamp to bounds and scale into [0,1]^D by the max side (reference
    hashgrid.py:84-87)."""
    lo = jnp.asarray(bounds[: x.shape[-1]], dtype=x.dtype)
    hi = jnp.asarray(bounds[x.shape[-1]:], dtype=x.dtype)
    x = jnp.clip(x, lo, hi)
    return (x - lo) / (jnp.max(hi - lo) + EPS)


# -- fused functional core ------------------------------------------------------
# layout: (scales, offsets, use_hash, table_size, D, F, input_grad,
#          sorted_bwd) — all static/hashable (custom_vjp nondiff arg)


def _corners(D: int) -> np.ndarray:
    return np.stack(
        np.meshgrid(*([np.array([0, 1])] * D), indexing="ij"),
        axis=-1).reshape(-1, D)


def _indices_weights(layout, x):
    """x (N, D) in [0,1] -> global table rows (N, L*C) int32 and
    interpolation weights (N, L*C) f32. One pass of cheap elementwise math for
    ALL levels (the gather itself happens once, in the caller)."""
    scales, offsets, use_hash, table_size, D, F, *_ = layout
    corners = jnp.asarray(_corners(D))                  # (C, D)
    idx_all, w_all = [], []
    for l, res in enumerate(scales):
        pos = x * res
        base = jnp.floor(pos)
        frac = pos - base
        cidx = base.astype(jnp.int32)[:, None, :] + corners[None]  # (N,C,D)
        cidx = jnp.clip(cidx, 0, res)
        if use_hash[l]:
            h = cidx[..., 0].astype(jnp.uint32)  # prime[0] == 1
            for d in range(1, D):
                h = h ^ (cidx[..., d].astype(jnp.uint32) *
                         jnp.uint32(_PRIMES[d]))
            idx = (h % jnp.uint32(table_size)).astype(jnp.int32)
        else:
            idx = cidx[..., 0]
            for d in range(1, D):
                idx = idx * (res + 1) + cidx[..., d]
        idx_all.append(idx + offsets[l])
        w_all.append(jnp.prod(
            jnp.where(corners[None] == 1, frac[:, None, :],
                      1.0 - frac[:, None, :]), axis=-1))
    return (jnp.concatenate(idx_all, axis=-1),
            jnp.concatenate(w_all, axis=-1))


def _encode_fwd_impl(layout, table, x):
    scales, offsets, use_hash, table_size, D, F, *_ = layout
    L = len(scales)
    C = 2 ** D
    n = x.shape[0]
    idx, w = _indices_weights(layout, x)
    vals = jnp.take(table, idx.reshape(-1), axis=0).reshape(n, L, C, F)
    out = (w.reshape(n, L, C, 1).astype(vals.dtype) * vals).sum(axis=2)
    return out.reshape(n, L * F).astype(jnp.float32)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def hash_encode(layout, table, x):
    """Fused multi-level hash-grid encode with a custom backward."""
    return _encode_fwd_impl(layout, table, x)


def _encode_fwd(layout, table, x):
    return _encode_fwd_impl(layout, table, x), (table, x)


def _encode_bwd(layout, res, g):
    scales, offsets, use_hash, table_size, D, F, input_grad, sorted_bwd = \
        layout
    table, x = res
    L = len(scales)
    C = 2 ** D
    n = x.shape[0]
    idx, w = _indices_weights(layout, x)                 # recomputed (cheap)
    g4 = g.reshape(n, L, 1, F)
    u3 = w.reshape(n, L, C, 1) * g4                      # (N, L, C, F)
    if sorted_bwd:
        # level-batched multi-operand sort + ONE flat segment-sum:
        # * per-level ids live in [offset_l, offset_{l+1}), so the
        #   level-major concatenation of per-level-sorted ids is GLOBALLY
        #   sorted — no flat 15M-element sort needed;
        # * lax.sort carries the gradient rows as extra operands, so
        #   there is no post-sort gather of the update rows.
        ids3 = idx.reshape(n, L, C).transpose(1, 0, 2).reshape(L, n * C)
        u_lvl = u3.transpose(1, 0, 2, 3).reshape(L, n * C, F)
        ops = jax.lax.sort(
            (ids3,) + tuple(u_lvl[..., f] for f in range(F)),
            dimension=-1, num_keys=1)
        ids_sorted = ops[0].reshape(-1)
        u_sorted = jnp.stack([o.reshape(-1) for o in ops[1:]], axis=-1)
        dtable = jax.ops.segment_sum(
            u_sorted, ids_sorted, num_segments=table.shape[0],
            indices_are_sorted=True)
    else:
        dtable = jnp.zeros((table.shape[0], F), u3.dtype).at[
            idx.reshape(-1)].add(u3.reshape(-1, F))
    dtable = dtable.astype(table.dtype)

    if not input_grad:
        return dtable, jnp.zeros_like(x)

    # analytic d(out)/dx through the interpolation weights
    # (hashencoder.cu:275-297): w = prod_d (corner_d ? frac_d : 1-frac_d)
    vals = jnp.take(table, idx.reshape(-1), axis=0).reshape(n, L, C, F)
    vg = (vals.astype(jnp.float32) * g4).sum(-1)         # (N, L, C) dL/dw
    corners = jnp.asarray(_corners(D))                   # (C, D)
    dx = jnp.zeros_like(x)
    for l, res in enumerate(scales):
        pos = x * res
        frac = pos - jnp.floor(pos)                      # (N, D)
        term = jnp.where(corners[None] == 1, frac[:, None, :],
                         1.0 - frac[:, None, :])         # (N, C, D)
        sign = jnp.where(corners[None] == 1, 1.0, -1.0)
        for d in range(D):
            others = [term[..., dd] for dd in range(D) if dd != d]
            prod = others[0]
            for o in others[1:]:
                prod = prod * o
            dwdx = sign[..., d] * prod                   # (N, C)
            dx = dx.at[:, d].add(
                (vg[:, l, :] * dwdx).sum(-1) * res)
    return dtable, dx


hash_encode.defvjp(_encode_fwd, _encode_bwd)


class HashGridEncoder(Module):
    """D-dimensional multi-resolution hash grid, D in {2, 3, 4}.

    ``backend="xla"`` is the vertex-exact instant-ngp formulation;
    ``backend="brick"`` (D=3, F=2, input_grad=False only) switches to
    the bricked encode (ops/pallas/hashgrid_kernel), which hashes 4^3-cell
    bricks instead of vertices. The two backends have different
    parameter shapes and are not checkpoint-compatible with each other.
    """

    input_dim: int = 3
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = -1
    per_level_scale: float = 2.0
    bounds: tuple = ()        # optional (2*D,) world bounds for normalize
    # True when upstream modules need d(out)/dx (warped/learned query
    # points, e.g. Motion2D); plain point encoders skip the extra gather
    input_grad: bool = True
    # sort+segment-sum backward (deterministic) vs plain scatter-add
    sorted_bwd: bool = True
    # gather dtype: bfloat16 halves the random-access HBM traffic; params
    # stay float32 for the optimizer
    compute_dtype: str = "float32"
    # "xla" (vertex-exact) or "brick" (bricked table)
    backend: str = "xla"
    log2_bricks: int = 12     # brick-table cap per level (brick backend)

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    # reference-compatible alias
    @property
    def out_dim(self) -> int:
        return self.output_dim

    @classmethod
    def from_cfg(cls, enc_cfg, **overrides):
        """Accepts both our names and the reference YAML names
        (num_levels/level_dim/desired_resolution/...)."""
        g = enc_cfg.get
        kw = dict(
            input_dim=g("input_dim", 3),
            n_levels=g("n_levels", g("num_levels", 16)),
            n_features=g("n_features", g("level_dim", 2)),
            log2_hashmap_size=g("log2_hashmap_size", 19),
            base_resolution=g("base_resolution", 16),
            finest_resolution=g("finest_resolution",
                                g("desired_resolution", -1)),
            per_level_scale=g("per_level_scale", 2.0),
            bounds=tuple(g("bounds", g("bbox", ()))),
            # YAML-driven plain point encoders don't need d(out)/dx —
            # sample positions carry no gradient; composite encoders
            # (constructed directly) keep the default True
            input_grad=bool(g("input_grad", False)),
            sorted_bwd=bool(g("sorted_bwd", True)),
            compute_dtype=str(g("compute_dtype", "float32")),
            backend=str(g("backend", "xla")),
            log2_bricks=int(g("log2_bricks", 12)),
        )
        kw.update(overrides)
        return cls(**kw)

    def setup(self):
        if self.backend == "brick":
            if (self.input_dim, self.n_features) != (3, 2) or self.input_grad:
                raise ValueError(
                    "brick backend supports input_dim=3, n_features=2, "
                    "input_grad=False; use backend='xla' otherwise")
            from nerf_replication_tpu.ops.pallas import hashgrid_kernel as hk
            self._brick_layout = hk.make_brick_layout(
                self.n_levels, self.base_resolution, self.finest_resolution,
                log2_bricks=self.log2_bricks,
                per_level_scale=self.per_level_scale)
            self.table = self.param(
                "table",
                lambda key, shape: jax.random.uniform(
                    key, shape, jnp.float32, -1e-4, 1e-4),
                (self._brick_layout.n_rows, hk.ROW),
            )
            return
        scales, offsets, use_hash, table_size = _level_layout(
            self.input_dim, self.n_levels, self.log2_hashmap_size,
            self.base_resolution, self.finest_resolution,
            self.per_level_scale)
        self._scales = scales
        self._offsets = offsets
        self._use_hash = use_hash
        self._table_size = table_size
        self.table = self.param(
            "table",
            lambda key, shape: jax.random.uniform(
                key, shape, jnp.float32, -1e-4, 1e-4),
            (offsets[-1], self.n_features),
        )

    def __call__(self, x: jnp.ndarray, bounds=None, normalize: bool | None = None):
        """x (..., D) -> (..., L*F). If ``bounds`` (or self.bounds) given
        and normalize is not False, x is world-space and normalised."""
        shape = x.shape[:-1]
        x = x.reshape(-1, self.input_dim)
        b = bounds if bounds is not None else (self.bounds or None)
        if normalize is None:
            normalize = b is not None
        if normalize and b is not None:
            x = normalize_to_unit(x, b)
        x = jnp.clip(x, 0.0, 1.0)

        if self.backend == "brick":
            from nerf_replication_tpu.ops.pallas import hashgrid_kernel as hk
            out = hk.brick_encode(self._brick_layout, self.table, x)
            return out.reshape(*shape, self.output_dim)

        layout = (tuple(self._scales), tuple(self._offsets),
                  tuple(self._use_hash), self._table_size, self.input_dim,
                  self.n_features, self.input_grad, self.sorted_bwd)
        table = self.table
        if self.compute_dtype != "float32":
            table = table.astype(jnp.dtype(self.compute_dtype))
        out = hash_encode(layout, table, x)
        return out.reshape(*shape, self.output_dim)


class TriPlaneEncoder(Module):
    """Three 2-D grids over (xy, yz, xz), concatenated (reference
    TriPlane, hashencoder/hashgrid.py:222-238 / triplane.py:86-102)."""

    plane_kw: Any = None
    bounds: tuple = ()

    @classmethod
    def from_cfg(cls, enc_cfg):
        base = HashGridEncoder.from_cfg(enc_cfg, input_dim=2, bounds=())
        kw = {f: getattr(base, f) for f in (
            "input_dim", "n_levels", "n_features", "log2_hashmap_size",
            "base_resolution", "finest_resolution", "per_level_scale")}
        return cls(plane_kw=tuple(sorted(kw.items())),
                   bounds=tuple(enc_cfg.get("bounds", enc_cfg.get("bbox", ()))))

    @property
    def output_dim(self):
        kw = dict(self.plane_kw)
        return 3 * kw["n_levels"] * kw["n_features"]

    def setup(self):
        kw = dict(self.plane_kw)
        self.xy_plane = HashGridEncoder(**kw)
        self.yz_plane = HashGridEncoder(**kw)
        self.xz_plane = HashGridEncoder(**kw)

    def __call__(self, xyz, bounds=None):
        b = bounds if bounds is not None else (self.bounds or None)
        if b is not None:
            xyz = normalize_to_unit(xyz, b)
        return jnp.concatenate([
            self.xy_plane(xyz[..., (0, 1)], normalize=False),
            self.yz_plane(xyz[..., (1, 2)], normalize=False),
            self.xz_plane(xyz[..., (0, 2)], normalize=False),
        ], axis=-1)


class Motion2DEncoder(Module):
    """Triplane + time-conditioned deformation MLP (reference Motion2d,
    hashencoder/hashgrid.py:241-286). The reference's python-level
    ``if t != 0`` branch becomes a ``jnp.where`` blend."""

    plane_kw: Any = None
    bounds: tuple = ()
    num_frames: int = 2
    mlp_width: int = 128
    mlp_depth: int = 8

    @classmethod
    def from_cfg(cls, enc_cfg):
        tri = TriPlaneEncoder.from_cfg(enc_cfg)
        return cls(plane_kw=tri.plane_kw, bounds=tri.bounds,
                   num_frames=int(enc_cfg.get("num_frames", 2)))

    @property
    def output_dim(self):
        kw = dict(self.plane_kw)
        return 3 * kw["n_levels"] * kw["n_features"]

    def setup(self):
        kw = dict(self.plane_kw)
        self.xy_plane = HashGridEncoder(**kw)
        self.yz_plane = HashGridEncoder(**kw)
        self.xz_plane = HashGridEncoder(**kw)
        self.mlp = [Dense(self.mlp_width) for _ in range(self.mlp_depth)]
        self.mlp_out = Dense(3)

    def __call__(self, xyzt, bounds=None):
        b = bounds if bounds is not None else (self.bounds or None)
        xyz = xyzt[..., :3]
        if b is not None:
            xyz = normalize_to_unit(xyz, b)
        t = xyzt[..., 3:] / max(self.num_frames - 1, 1)
        h = jnp.concatenate([xyz, t], axis=-1)
        for layer in self.mlp:
            h = jax.nn.relu(layer(h))
        delta = jax.nn.sigmoid(self.mlp_out(h))
        warped = jnp.clip(xyz + 2.0 * delta - 1.0, 0.0, 1.0)
        xyz_eff = jnp.where(t > 0, warped, xyz)
        return jnp.concatenate([
            self.xy_plane(xyz_eff[..., (0, 1)], normalize=False),
            self.yz_plane(xyz_eff[..., (1, 2)], normalize=False),
            self.xz_plane(xyz_eff[..., (0, 2)], normalize=False),
        ], axis=-1)


class HashLatentEncoder(Module):
    """Hash(xyz) + per-frame latent code concat (reference HashLatent,
    hashencoder/hashgrid.py:289-303)."""

    grid_kw: Any = None
    bounds: tuple = ()
    num_frames: int = 2
    latent_dim: int = 32

    @classmethod
    def from_cfg(cls, enc_cfg):
        base = HashGridEncoder.from_cfg(enc_cfg, input_dim=3, bounds=())
        kw = {f: getattr(base, f) for f in (
            "input_dim", "n_levels", "n_features", "log2_hashmap_size",
            "base_resolution", "finest_resolution", "per_level_scale")}
        return cls(grid_kw=tuple(sorted(kw.items())),
                   bounds=tuple(enc_cfg.get("bounds", enc_cfg.get("bbox", ()))),
                   num_frames=int(enc_cfg.get("num_frames", 2)),
                   latent_dim=int(enc_cfg.get("latent_dim", 32)))

    @property
    def output_dim(self):
        kw = dict(self.grid_kw)
        return kw["n_levels"] * kw["n_features"] + self.latent_dim

    def setup(self):
        self.grid = HashGridEncoder(**dict(self.grid_kw))
        self.latent_t = self.param(
            "latent_t",
            lambda key, shape: jax.random.uniform(
                key, shape, jnp.float32, -1e-4, 1e-4),
            (self.num_frames, self.latent_dim))

    def __call__(self, xyzt, bounds=None):
        b = bounds if bounds is not None else (self.bounds or None)
        xyz = xyzt[..., :3]
        if b is not None:
            xyz = normalize_to_unit(xyz, b)
        t_idx = jnp.clip(xyzt[..., 3].astype(jnp.int32), 0,
                         self.num_frames - 1)
        return jnp.concatenate(
            [self.grid(xyz, normalize=False), self.latent_t[t_idx]], axis=-1)


class HashGrid4DEncoder(Module):
    """4-D (xyz + normalized t) hash grid (reference HashEncoder4d,
    hashencoder/hashgrid.py:306-318)."""

    grid_kw: Any = None
    bounds: tuple = ()
    num_frames: int = 2

    @classmethod
    def from_cfg(cls, enc_cfg):
        base = HashGridEncoder.from_cfg(enc_cfg, input_dim=4, bounds=())
        kw = {f: getattr(base, f) for f in (
            "input_dim", "n_levels", "n_features", "log2_hashmap_size",
            "base_resolution", "finest_resolution", "per_level_scale")}
        return cls(grid_kw=tuple(sorted(kw.items())),
                   bounds=tuple(enc_cfg.get("bounds", enc_cfg.get("bbox", ()))),
                   num_frames=int(enc_cfg.get("num_frames", 2)))

    @property
    def output_dim(self):
        kw = dict(self.grid_kw)
        return kw["n_levels"] * kw["n_features"]

    def setup(self):
        self.grid = HashGridEncoder(**dict(self.grid_kw))

    def __call__(self, xyzt, bounds=None):
        b = bounds if bounds is not None else (self.bounds or None)
        xyz = xyzt[..., :3]
        if b is not None:
            xyz = normalize_to_unit(xyz, b)
        t = xyzt[..., 3:] / max(self.num_frames, 1)
        return self.grid(jnp.concatenate([xyz, t], axis=-1), normalize=False)


class HashCoefEncoder(Module):
    """Coefficient-mixed hash bases (reference HashEncoderCoef,
    hashencoder/hashgrid.py:321-351): K 3-D basis grids mixed by a
    softmax over a 4-D coefficient grid + MLP."""

    grid_kw: Any = None
    bounds: tuple = ()
    num_frames: int = 2
    basis_num: int = 6

    @classmethod
    def from_cfg(cls, enc_cfg):
        base = HashGridEncoder.from_cfg(enc_cfg, input_dim=3, bounds=())
        kw = {f: getattr(base, f) for f in (
            "input_dim", "n_levels", "n_features", "log2_hashmap_size",
            "base_resolution", "finest_resolution", "per_level_scale")}
        return cls(grid_kw=tuple(sorted(kw.items())),
                   bounds=tuple(enc_cfg.get("bounds", enc_cfg.get("bbox", ()))),
                   num_frames=int(enc_cfg.get("num_frames", 2)),
                   basis_num=int(enc_cfg.get("basis_num", 6)))

    @property
    def output_dim(self):
        kw = dict(self.grid_kw)
        return kw["n_levels"] * kw["n_features"]

    def setup(self):
        kw = dict(self.grid_kw)
        self.basis = [HashGridEncoder(**kw) for _ in range(self.basis_num)]
        coef_kw = dict(kw)
        coef_kw["input_dim"] = 4
        coef_kw["log2_hashmap_size"] = 20
        self.coefs = HashGridEncoder(**coef_kw)
        self.coef_mlp_hidden = Dense(64)
        self.coef_mlp_out = Dense(self.basis_num)

    def __call__(self, xyzt, bounds=None):
        b = bounds if bounds is not None else (self.bounds or None)
        xyz = xyzt[..., :3]
        if b is not None:
            xyz = normalize_to_unit(xyz, b)
        t = xyzt[..., 3:] / max(self.num_frames, 1)
        coef_in = jnp.concatenate([xyz, t], axis=-1)
        h = jax.nn.relu(self.coef_mlp_hidden(self.coefs(coef_in, normalize=False)))
        coefs = jax.nn.softmax(self.coef_mlp_out(h), axis=-1)
        embs = jnp.stack(
            [g(xyz, normalize=False) for g in self.basis], axis=-2)  # (N,K,E)
        return jnp.sum(embs * coefs[..., None], axis=-2)
