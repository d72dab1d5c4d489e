"""NeRF model (coarse + fine MLP).

Capability parity with reference src/models/nerf/network.py:

* :class:`NeRFMLP` — the paper's MLP: D×W trunk with a skip concat of the
  encoded input at ``skips`` (reference NeRF 9-75), a raw density head and
  a view-conditioned RGB branch (feature W -> concat dir encoding ->
  W//2 -> 3). Outputs RAW values; sigmoid/relu are applied by the
  renderer, matching volume_renderer.py:418-419.
* :class:`Network` — owns coarse+fine MLPs and the xyz/dir encoders from
  config (reference Network 126-161).

Differences: no ``batchify`` chunking (network.py:163-171) — points are
evaluated as one big (N, C) matmul batch; matmuls run in a configurable
compute dtype (default bfloat16) with float32 params and float32 outputs.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ...config.cfg_node import CN
from ..encoding import get_encoder
from ..module import Dense, Module, constant_init


class NeRFMLP(Module):
    depth: int = 8
    width: int = 256
    view_depth: int = 1
    skips: Sequence[int] = (4,)
    use_viewdirs: bool = True
    dtype: Any = jnp.bfloat16
    # initial density-head bias. softplus(0)=0.69 makes a fresh field
    # nearly opaque (acc~1 on every ray), which kills the gradient of
    # any background-dependent loss term (random_bkgd training would
    # collapse into constant-grey fog). instant-ngp-style low-density
    # init (e.g. -4 -> sigma_0=0.018) keeps rays transparent at start.
    density_bias: float = 0.0

    def setup(self):
        # parameters are created on first call, so only the layers of
        # the configured branch (viewdirs or not) enter the tree
        dense = lambda w, **kw: Dense(w, dtype=self.dtype, **kw)
        self.pts = [dense(self.width) for _ in range(self.depth)]
        self.alpha = dense(1, bias_init=constant_init(self.density_bias))
        self.feature = dense(self.width)
        self.views = [dense(self.width // 2) for _ in range(self.view_depth)]
        self.rgb = dense(3)
        self.output = dense(4)

    def __call__(self, pts_feat: jnp.ndarray, view_feat: jnp.ndarray | None = None):
        """(N, C_pts), (N, C_dir) -> raw (N, 4) = [rgb, sigma] (float32)."""
        x = pts_feat.astype(self.dtype)
        h = x
        for i, layer in enumerate(self.pts):
            h = jax.nn.relu(layer(h))
            # reference concatenates the encoded input after layer i when
            # i is in skips (network.py:53-57)
            if i in self.skips:
                h = jnp.concatenate([x, h], axis=-1)

        if self.use_viewdirs:
            sigma = self.alpha(h)
            feat = self.feature(h)
            h = jnp.concatenate([feat, view_feat.astype(self.dtype)], axis=-1)
            for layer in self.views:
                h = jax.nn.relu(layer(h))
            rgb = self.rgb(h)
            raw = jnp.concatenate([rgb, sigma], axis=-1)
        else:
            raw = self.output(h)
        return raw.astype(jnp.float32)


class Network(Module):
    """Coarse + fine NeRF with config-selected encoders.

    ``model`` selects the head: "" / "coarse" for coarse (reference uses
    the empty string, network.py:199), "fine" for fine. Submodules are
    constructed by :func:`make_network` and passed in as attributes (keeps
    the module's static fields hashable for jit).
    """

    coarse: NeRFMLP
    fine: NeRFMLP
    xyz_encoder: Any
    dir_encoder: Any
    use_viewdirs: bool = True

    def __call__(self, pts: jnp.ndarray, viewdirs: jnp.ndarray | None = None,
                 model: str = ""):
        """pts (..., 3), viewdirs broadcastable (..., 3) -> raw (..., 4)."""
        shape = pts.shape[:-1]
        pts_flat = pts.reshape(-1, pts.shape[-1])
        pts_feat = self.xyz_encoder(pts_flat)
        view_feat = None
        if self.use_viewdirs and viewdirs is not None:
            dirs = jnp.broadcast_to(viewdirs, shape + (viewdirs.shape[-1],))
            view_feat = self.dir_encoder(dirs.reshape(-1, dirs.shape[-1]))
        mlp = self.fine if model == "fine" else self.coarse
        raw = mlp(pts_feat, view_feat)
        return raw.reshape(*shape, 4)

    def density(self, pts: jnp.ndarray, model: str = "fine"):
        """Density-only query (for mesh extraction / occupancy probing)."""
        zero_dirs = jnp.zeros_like(pts[..., :1]) * jnp.zeros((3,), pts.dtype)
        raw = self(pts, zero_dirs, model=model)
        return raw[..., 3]


def load_weights_from_keras(weights: list, depth: int = 8):
    """Original-NeRF TF/Keras weight list -> one branch's params.

    Capability parity with reference network.py:76-123: the list layout is
    [pts_0 W, pts_0 b, ..., pts_{D-1} W, b, feature W, b, views_0 W, b,
    rgb W, b, alpha W, b]. Keras kernels are (in, out) like Flax — no
    transpose needed (the reference transposes for torch's (out, in)).
    """
    import numpy as np

    p = {}
    for i in range(depth):
        p[f"pts_{i}"] = {"kernel": jnp.asarray(np.asarray(weights[2 * i])),
                         "bias": jnp.asarray(np.asarray(weights[2 * i + 1]))}
    base = 2 * depth
    for off, name in ((0, "feature"), (2, "views_0"), (4, "rgb"),
                      (6, "alpha")):
        p[name] = {"kernel": jnp.asarray(np.asarray(weights[base + off])),
                   "bias": jnp.asarray(np.asarray(weights[base + off + 1]))}
    return p


def init_params(net: Network, key, dtype=jnp.float32):
    """Initialise BOTH coarse and fine branches (a plain ``init`` traces
    only the branch selected by ``model``)."""
    pts = jnp.zeros((2, 2, 3), dtype)
    dirs = jnp.zeros((2, 1, 3), dtype)

    def touch_both(module, pts, dirs):
        module(pts, dirs, model="")
        return module(pts, dirs, model="fine")

    return net.init(key, pts, dirs, method=touch_both)


def make_network(cfg: CN) -> Network:
    c = cfg.network
    # time-conditioned encoders read cfg.num_frames globally in the
    # reference (e.g. hashencoder/hashgrid.py:252); propagate it into the
    # encoder sub-configs unless they set their own
    if "num_frames" in cfg:
        for key in ("xyz_encoder", "dir_encoder"):
            enc = c.get(key)
            if enc is not None and "num_frames" not in enc:
                enc["num_frames"] = cfg.num_frames
    use_viewdirs = bool(cfg.get("task_arg", {}).get("use_viewdirs", True))
    dtype = jnp.dtype(c.get("dtype", "bfloat16"))
    mk = lambda: NeRFMLP(
        depth=c.nerf.D,
        width=c.nerf.W,
        view_depth=c.nerf.get("V_D", 1),
        skips=tuple(c.nerf.skips),
        use_viewdirs=use_viewdirs,
        dtype=dtype,
        density_bias=float(c.nerf.get("density_bias", 0.0)),
    )
    return Network(
        coarse=mk(),
        fine=mk(),
        xyz_encoder=get_encoder(c.xyz_encoder),
        dir_encoder=get_encoder(c.dir_encoder),
        use_viewdirs=use_viewdirs,
    )
