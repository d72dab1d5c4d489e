"""The in-repo parameter-tree layer (models/module.py): the committed
checkpoints' trees, and agreement with flax.linen on init and forward."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.config import default_cfg, load_cfg_tree
from nerf_replication_tpu.models import make_network
from nerf_replication_tpu.models.module import Dense, Module
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# checkpoint dir -> (config, log2_bricks of its table or None)
CHECKPOINTS = {"hard": ("configs/nerf/hard.yaml", None),
               "hard_ngp_b9": ("configs/nerf/hard_ngp.yaml", 9)}


def _net(name):
    path, bricks = CHECKPOINTS[name]
    cfg = load_cfg_tree(os.path.join(ROOT, path), default_cfg())
    if bricks is not None:
        cfg.network.xyz_encoder.log2_bricks = bricks
    return make_network(cfg)


def _shapes(tree):
    return {jax.tree_util.keystr(p): np.shape(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_tree_matches_committed_checkpoint(name):
    ckpt = load_pretrain(os.path.join(ROOT, "data", "pretrain", name))
    assert ckpt is not None
    assert _shapes(init_params(_net(name), jax.random.key(0))) == \
        _shapes(ckpt)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_checkpoint_renders_finite(name):
    net = _net(name)
    params = jax.tree.map(jnp.asarray, load_pretrain(
        os.path.join(ROOT, "data", "pretrain", name)))
    pts = jax.random.uniform(jax.random.key(1), (16, 4, 3), minval=-1.0,
                             maxval=1.0)
    dirs = jax.random.normal(jax.random.key(2), (16, 1, 3))
    raw = np.asarray(net.apply(params, pts, dirs, model="fine"))
    assert raw.shape == (16, 4, 4) and np.isfinite(raw).all()


# -- agreement with flax.linen ----------------------------------------------------

nn = pytest.importorskip("flax.linen")


class _FlaxMLP(nn.Module):
    """The NeRF MLP as the flax version of network.py wrote it."""
    depth: int
    width: int
    skips: tuple
    dtype: object
    density_bias: float = 0.0

    @nn.compact
    def __call__(self, x, v):
        def dense(w, name, **kw):
            return nn.Dense(w, dtype=self.dtype, param_dtype=jnp.float32,
                            name=name, **kw)
        x = x.astype(self.dtype)
        h = x
        for i in range(self.depth):
            h = nn.relu(dense(self.width, f"pts_{i}")(h))
            if i in self.skips:
                h = jnp.concatenate([x, h], -1)
        sigma = dense(1, "alpha", bias_init=nn.initializers.constant(
            self.density_bias))(h)
        h = jnp.concatenate([dense(self.width, "feature")(h),
                             v.astype(self.dtype)], -1)
        h = nn.relu(dense(self.width // 2, "views_0")(h))
        return jnp.concatenate([dense(3, "rgb")(h), sigma],
                               -1).astype(jnp.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_nerf_mlp_init_and_forward_match_flax(dtype):
    from nerf_replication_tpu.models.nerf.network import NeRFMLP

    x = jax.random.normal(jax.random.key(3), (9, 63))
    v = jax.random.normal(jax.random.key(4), (9, 27))
    ours = NeRFMLP(depth=8, width=64, skips=(4,), dtype=dtype,
                   density_bias=-4.0)
    theirs = _FlaxMLP(depth=8, width=64, skips=(4,), dtype=dtype,
                      density_bias=-4.0)
    p_ours = ours.init(jax.random.key(5), x, v)
    p_theirs = theirs.init(jax.random.key(5), x, v)
    jax.tree.map(np.testing.assert_array_equal, p_ours,
                 jax.tree.map(np.asarray, p_theirs))
    np.testing.assert_array_equal(np.asarray(ours.apply(p_ours, x, v)),
                                  np.asarray(theirs.apply(p_ours, x, v)))


def test_setup_lists_and_fields_named_like_flax():
    class Inner(Module):
        def setup(self):
            self.layers = [Dense(3), Dense(2)]

        def __call__(self, x):
            return self.layers[1](self.layers[0](x))

    class Outer(Module):
        inner: Module

        def __call__(self, x):
            return self.inner(x)

    tree = Outer(Inner()).init(jax.random.key(0), jnp.ones((1, 4)))
    assert _shapes(tree) == {
        "['params']['inner']['layers_0']['bias']": (3,),
        "['params']['inner']['layers_0']['kernel']": (4, 3),
        "['params']['inner']['layers_1']['bias']": (2,),
        "['params']['inner']['layers_1']['kernel']": (3, 2)}

