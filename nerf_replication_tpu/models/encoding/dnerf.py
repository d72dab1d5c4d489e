"""Deformation-field (D-NeRF style) encoders.

Capability parity with the reference's dnerf family:
* ``dnerf`` — freq-encoded (xyz, t) through a skip MLP predicting a
  deformation delta, then freq-encode the warped xyz
  (src/models/encoding/dnerf.py:12-104). The reference's
  ``if t[0] == -1`` canonical-frame branch becomes a where-blend.
* ``dnerf_ngp_*`` / ``cuda_dnerf_ngp_tensorf`` — hash-grid canonical
  encoding with a factored spacetime tensor (CP-style, per-axis
  (frames x reso) grids) predicting the delta
  (hashencoder/hashgrid.py DNeRFNGP :354-427, hashgrid.py :135-307).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..module import Dense, Module
from .freq import freq_encode
from .hashgrid import HashGridEncoder, normalize_to_unit


class DNeRFEncoder(Module):
    variant: str = "dnerf"
    freq: int = 10
    time_freq: int = 10
    width: int = 256
    depth: int = 8
    skips: tuple = (4,)
    num_frames: int = 2
    bounds: tuple = ()
    grid_kw: Any = None      # for ngp variants
    tensor_feat: int = 64
    tensor_reso: int = 256

    @classmethod
    def from_cfg(cls, enc_cfg, variant: str = "dnerf"):
        kw = dict(
            variant=variant,
            freq=int(enc_cfg.get("freq", 10)),
            width=int(enc_cfg.get("W", 256)),
            depth=int(enc_cfg.get("D", 8)),
            num_frames=int(enc_cfg.get("num_frames", 2)),
            bounds=tuple(enc_cfg.get("bounds", enc_cfg.get("bbox", ()))),
        )
        if "ngp" in variant or "tensorf" in variant:
            base = HashGridEncoder.from_cfg(enc_cfg, input_dim=3, bounds=())
            kw["grid_kw"] = tuple(sorted(
                {f: getattr(base, f) for f in (
                    "input_dim", "n_levels", "n_features",
                    "log2_hashmap_size", "base_resolution",
                    "finest_resolution", "per_level_scale")}.items()))
        return cls(**kw)

    @property
    def output_dim(self):
        if self.grid_kw is not None:
            kw = dict(self.grid_kw)
            return kw["n_levels"] * kw["n_features"]
        return 3 * (1 + 2 * self.freq)

    def setup(self):
        if self.grid_kw is not None:
            self.grid = HashGridEncoder(**dict(self.grid_kw))
            # CP-factored spacetime tensors: 3 axes x (3, F, frames, reso)
            self.st_feat = [
                self.param(f"st_feat_{i}",
                           lambda key, shape: 0.1 * jax.random.normal(
                               key, shape),
                           (3, self.tensor_feat, self.num_frames,
                            self.tensor_reso))
                for i in range(3)
            ]
        else:
            self.time_mlp = [Dense(self.width) for _ in range(self.depth)]
            self.time_out = Dense(3)

    # -- dnerf (freq MLP) ------------------------------------------------------
    def _mlp_delta(self, xyz, t):
        enc = jnp.concatenate(
            [freq_encode(xyz, self.freq), freq_encode(t, self.freq)], axis=-1)
        h = enc
        for i, layer in enumerate(self.time_mlp):
            h = jax.nn.relu(layer(h))
            if i in self.skips:
                h = jnp.concatenate([enc, h], axis=-1)
        return self.time_out(h)

    # -- ngp/tensorf delta: bilinear sample of factored grids ------------------
    def _tensor_delta(self, xyz, t):
        """delta_xyz[..., i] = sum_f prod_axis bilerp(st_feat_i[axis], (coord_axis, t))."""
        tt = t[..., 0] / max(self.num_frames - 1, 1)

        def sample_plane(plane, u, v):
            # plane (F, T, R); u=t in [0,1], v=coord in [0,1]; align_corners
            T, R = plane.shape[-2:]
            pu = u * (T - 1)
            pv = v * (R - 1)
            u0 = jnp.clip(jnp.floor(pu).astype(jnp.int32), 0, T - 1)
            v0 = jnp.clip(jnp.floor(pv).astype(jnp.int32), 0, R - 1)
            u1 = jnp.clip(u0 + 1, 0, T - 1)
            v1 = jnp.clip(v0 + 1, 0, R - 1)
            fu = (pu - u0)[..., None]
            fv = (pv - v0)[..., None]
            g = lambda a, b: plane[:, a, b].T  # (N, F)
            return ((1 - fu) * (1 - fv) * g(u0, v0) +
                    (1 - fu) * fv * g(u0, v1) +
                    fu * (1 - fv) * g(u1, v0) + fu * fv * g(u1, v1))

        deltas = []
        for i in range(3):
            prod = None
            for axis in range(3):
                feat = sample_plane(self.st_feat[i][axis], tt, xyz[..., axis])
                prod = feat if prod is None else prod * feat
            deltas.append(prod.sum(-1))
        return jnp.stack(deltas, axis=-1)

    def __call__(self, xyzt, bounds=None):
        b = bounds if bounds is not None else (self.bounds or None)
        xyz, t = xyzt[..., :3], xyzt[..., 3:]
        if self.grid_kw is not None:
            if b is not None:
                xyz = normalize_to_unit(xyz, b)
            delta = self._tensor_delta(xyz, t)
            warped = jnp.clip(xyz + delta, 0.0, 1.0)
            xyz_eff = jnp.where(t > 0, warped, xyz)
            return self.grid(xyz_eff, normalize=False)
        # pure dnerf: canonical frame (t == -1) skips deformation
        tn = t / max(self.num_frames - 1, 1)
        delta = self._mlp_delta(xyz, tn)
        xyz_eff = jnp.where(t >= 0, xyz + delta, xyz)
        return freq_encode(xyz_eff, self.freq)
