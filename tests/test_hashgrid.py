"""Hash-grid encoder family tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.config import CN
from nerf_replication_tpu.models.encoding import get_encoder
from nerf_replication_tpu.models.encoding.hashgrid import (
    HashGridEncoder,
    _level_layout,
)


def _grid(**kw):
    defaults = dict(input_dim=3, n_levels=4, n_features=2,
                    log2_hashmap_size=12, base_resolution=4,
                    per_level_scale=2.0)
    defaults.update(kw)
    return HashGridEncoder(**defaults)


def test_level_layout_dense_then_hash():
    scales, offsets, use_hash, T = _level_layout(
        3, 4, 12, 4, -1, 2.0)
    assert scales == [4, 8, 16, 32]
    # (4+1)^3=125 dense, (8+1)^3=729 dense, (16+1)^3=4913 > 4096 hash
    assert use_hash == [False, False, True, True]
    assert offsets[1] - offsets[0] == 128  # 125 -> 8-aligned
    assert offsets[3] - offsets[2] == 4096


def test_forward_shape_and_grad():
    enc = _grid()
    x = jax.random.uniform(jax.random.key(0), (32, 3))
    params = enc.init(jax.random.key(1), x)
    out = enc.apply(params, x)
    assert out.shape == (32, 8)

    def loss(p):
        return jnp.sum(enc.apply(p, x) ** 2)

    g = jax.grad(loss)(params)
    table_grad = g["params"]["table"]
    assert np.isfinite(np.asarray(table_grad)).all()
    # gradient is sparse: only touched entries are nonzero
    assert (np.asarray(table_grad) != 0).sum() > 0
    assert (np.asarray(table_grad) != 0).mean() < 0.5


def test_interpolation_is_continuous():
    """Feature must be continuous across a grid cell boundary."""
    enc = _grid(n_levels=1, base_resolution=4, log2_hashmap_size=12)
    params = enc.init(jax.random.key(0), jnp.zeros((1, 3)))
    eps = 1e-4
    below = jnp.array([[0.25 - eps, 0.3, 0.3]])
    above = jnp.array([[0.25 + eps, 0.3, 0.3]])
    f_below = enc.apply(params, below)
    f_above = enc.apply(params, above)
    np.testing.assert_allclose(np.asarray(f_below), np.asarray(f_above),
                               atol=1e-3)


def test_exact_at_grid_corners():
    """At integer grid coordinates the encoding equals the table entry."""
    enc = _grid(n_levels=1, base_resolution=4)
    x = jnp.array([[0.5, 0.5, 0.5]])  # grid coord (2,2,2), dense level
    params = enc.init(jax.random.key(0), x)
    table = params["params"]["table"]
    idx = 2 * 25 + 2 * 5 + 2  # dense index at res 4 -> (res+1)=5 stride
    np.testing.assert_allclose(
        np.asarray(enc.apply(params, x))[0],
        np.asarray(table[idx]), rtol=1e-5)


def test_normalization_bounds():
    enc = _grid(bounds=(-2.0, -2.0, -2.0, 2.0, 2.0, 2.0))
    x = jnp.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])  # clamped to bounds
    params = enc.init(jax.random.key(0), x)
    out = enc.apply(params, x)
    assert np.isfinite(np.asarray(out)).all()


def test_jit_and_batch_dims():
    enc = _grid()
    x = jax.random.uniform(jax.random.key(0), (4, 7, 3))
    params = enc.init(jax.random.key(1), x)
    out = jax.jit(enc.apply)(params, x)
    assert out.shape == (4, 7, 8)


@pytest.mark.parametrize("etype,extra", [
    ("cuda_hashgrid", {}),
    ("hashgrid", {}),
    ("cuda_triplane", {}),
    ("triplane", {}),
    ("cuda_hashgrid_latent", {"num_frames": 3}),
    ("cuda_hashgrid_4d", {"num_frames": 3}),
    ("cuda_hashgrid_coef", {"num_frames": 3, "basis_num": 2}),
    ("cuda_motion2d", {"num_frames": 3}),
])
def test_encoder_zoo_dispatch(etype, extra):
    cfg = CN({"type": etype, "num_levels": 2, "level_dim": 2,
              "base_resolution": 4, "log2_hashmap_size": 10,
              "per_level_scale": 2.0,
              "bounds": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], **extra})
    enc = get_encoder(cfg)
    needs_time = etype in ("cuda_hashgrid_latent", "cuda_hashgrid_4d",
                           "cuda_hashgrid_coef", "cuda_motion2d")
    x = jax.random.uniform(jax.random.key(0), (16, 4 if needs_time else 3))
    params = enc.init(jax.random.key(1), x)
    out = enc.apply(params, x)
    assert out.shape == (16, enc.output_dim)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("variant", ["dnerf", "dnerf_ngp_tensorf"])
def test_dnerf_encoders(variant):
    cfg = CN({"type": variant, "freq": 4, "W": 32, "D": 2,
              "num_frames": 3, "num_levels": 2, "level_dim": 2,
              "base_resolution": 4, "log2_hashmap_size": 10,
              "bounds": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]})
    enc = get_encoder(cfg)
    xyzt = jnp.concatenate(
        [jax.random.uniform(jax.random.key(0), (8, 3)),
         jnp.ones((8, 1))], axis=-1)
    params = enc.init(jax.random.key(1), xyzt)
    out = enc.apply(params, xyzt)
    assert out.shape == (8, enc.output_dim)
    # canonical frame (t=0 / t=-1) also works
    t0 = xyzt.at[:, 3].set(-1.0 if variant == "dnerf" else 0.0)
    out0 = enc.apply(params, t0)
    assert np.isfinite(np.asarray(out0)).all()


def test_sh_encoder():
    from nerf_replication_tpu.models.encoding.sh import SHEncoder

    enc = SHEncoder(degree=4)
    assert enc.output_dim == 16
    d = jax.random.normal(jax.random.key(0), (10, 3))
    out = enc(d)
    assert out.shape == (10, 16)
    # degree-0 term is the constant 1/(2 sqrt(pi))
    np.testing.assert_allclose(np.asarray(out[:, 0]), 0.28209479, rtol=1e-5)


def test_hashgrid_trains_to_fit_field():
    """The grid must be able to overfit a smooth target — validates the
    scatter-add backward end to end."""
    import optax

    enc = _grid(n_levels=4, base_resolution=4, log2_hashmap_size=14)
    x = jax.random.uniform(jax.random.key(0), (512, 3))
    target = jnp.sin(4.0 * x[:, :1]) * jnp.cos(3.0 * x[:, 1:2])

    from nerf_replication_tpu.models.module import Dense, Module

    class Model(Module):
        def setup(self):
            self.grid = _grid(n_levels=4, base_resolution=4,
                              log2_hashmap_size=14)
            self.head = Dense(1)

        def __call__(self, x):
            return self.head(self.grid(x))

    model = Model()
    params = model.init(jax.random.key(1), x)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            return jnp.mean((model.apply(p, x) - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    loss0 = None
    for i in range(200):
        params, opt_state, loss = step(params, opt_state)
        if i == 0:
            loss0 = float(loss)
    assert float(loss) < 0.05 * loss0, (loss0, float(loss))


def test_global_num_frames_propagates():
    """Reference reads cfg.num_frames globally (hashencoder/hashgrid.py:252);
    make_network must inject it into time-conditioned encoder configs."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.models import make_network

    cfg = default_cfg()
    cfg.num_frames = 7
    cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = CN({
        "type": "cuda_hashgrid_latent", "num_levels": 2, "level_dim": 2,
        "base_resolution": 4, "log2_hashmap_size": 10,
        "bounds": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]})
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    net = make_network(cfg)
    assert net.xyz_encoder.num_frames == 7


def test_sorted_bwd_matches_scatter_and_autodiff():
    """The custom sorted-segment-sum backward must equal both the plain
    scatter-add backward and raw autodiff of the take-based forward."""
    from nerf_replication_tpu.models.encoding.hashgrid import (
        _encode_fwd_impl, hash_encode)

    enc_s = _grid(sorted_bwd=True)
    enc_p = _grid(sorted_bwd=False)
    x = jax.random.uniform(jax.random.key(0), (64, 3))
    params = enc_s.init(jax.random.key(1), x)
    cot = jax.random.normal(jax.random.key(2), (64, 8))

    def loss(enc):
        return lambda p: jnp.sum(enc.apply(p, x) * cot)

    g_sorted = jax.grad(loss(enc_s))(params)["params"]["table"]
    g_scatter = jax.grad(loss(enc_p))(params)["params"]["table"]
    np.testing.assert_allclose(np.asarray(g_sorted), np.asarray(g_scatter),
                               rtol=1e-5, atol=1e-7)

    # raw autodiff of the take-based forward (no custom_vjp)
    scales, offsets, use_hash, T = _level_layout(3, 4, 12, 4, -1, 2.0)
    layout = (tuple(scales), tuple(offsets), tuple(use_hash), T, 3, 2,
              True, True)
    table = params["params"]["table"]

    g_auto = jax.grad(
        lambda t: jnp.sum(_encode_fwd_impl(layout, t, x) * cot))(table)
    np.testing.assert_allclose(np.asarray(g_sorted), np.asarray(g_auto),
                               rtol=1e-5, atol=1e-7)


def test_input_grad_matches_autodiff():
    """d(out)/dx via the analytic weight derivative must equal autodiff
    of the take-based forward (the CUDA kernel_input_backward analog)."""
    from nerf_replication_tpu.models.encoding.hashgrid import (
        _encode_fwd_impl, _level_layout, hash_encode)

    scales, offsets, use_hash, T = _level_layout(3, 3, 12, 4, -1, 2.0)
    layout = (tuple(scales), tuple(offsets), tuple(use_hash), T, 3, 2,
              True, True)
    key = jax.random.key(0)
    table = jax.random.normal(key, (offsets[-1], 2)) * 0.1
    # keep x away from cell boundaries (floor() kinks break equality)
    x = (jnp.floor(jax.random.uniform(jax.random.key(1), (32, 3)) * 4) +
         jnp.array([0.3, 0.5, 0.7])) / 4.0
    cot = jax.random.normal(jax.random.key(2), (32, 6))

    gx_custom = jax.grad(
        lambda xx: jnp.sum(hash_encode(layout, table, xx) * cot))(x)
    gx_auto = jax.grad(
        lambda xx: jnp.sum(_encode_fwd_impl(layout, table, xx) * cot))(x)
    np.testing.assert_allclose(np.asarray(gx_custom), np.asarray(gx_auto),
                               rtol=1e-4, atol=1e-5)


def test_motion2d_deformation_gets_gradients():
    """Composite encoders warp query points through a learned MLP — the
    hash grid must propagate input gradients to the deformation params."""
    from nerf_replication_tpu.models.encoding.hashgrid import Motion2DEncoder

    enc = Motion2DEncoder.from_cfg(CN({
        "num_levels": 2, "level_dim": 2, "base_resolution": 4,
        "log2_hashmap_size": 10, "per_level_scale": 2.0,
        "bounds": [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], "num_frames": 3}))
    xyzt = jnp.concatenate(
        [jax.random.uniform(jax.random.key(0), (16, 3)) * 1.6 - 0.8,
         jnp.ones((16, 1))], axis=-1)
    params = enc.init(jax.random.key(1), xyzt)

    g = jax.grad(lambda p: jnp.sum(enc.apply(p, xyzt) ** 2))(params)
    mlp_kernels = [np.asarray(v["kernel"])
                   for k, v in g["params"].items() if k.startswith("mlp")]
    assert mlp_kernels, list(g["params"])
    assert any(np.abs(k).max() > 0 for k in mlp_kernels), (
        "deformation MLP receives zero gradient — input_grad path broken")


def test_fused_encode_matches_numpy_oracle():
    """Independent per-point numpy reimplementation of the multi-level
    hash interpolation (hash, dense indexing, trilinear weights) — guards
    the shared _indices_weights helper itself."""
    from nerf_replication_tpu.models.encoding.hashgrid import (
        _PRIMES, _level_layout, hash_encode)

    D, L, log2, base = 3, 3, 10, 4
    scales, offsets, use_hash, T = _level_layout(D, L, log2, base, -1, 2.0)
    layout = (tuple(scales), tuple(offsets), tuple(use_hash), T, D, 2,
              False, True)
    rng = np.random.default_rng(0)
    table = rng.normal(size=(offsets[-1], 2)).astype(np.float32)
    x = rng.uniform(0, 1, (20, 3)).astype(np.float32)

    got = np.asarray(hash_encode(layout, jnp.asarray(table),
                                 jnp.asarray(x)))

    want = np.zeros((20, L * 2), np.float32)
    for n in range(20):
        for l, res in enumerate(scales):
            pos = x[n] * res
            b = np.floor(pos).astype(np.int64)
            f = pos - b
            acc = np.zeros(2, np.float64)
            for cx in (0, 1):
                for cy in (0, 1):
                    for cz in (0, 1):
                        c = np.minimum(np.maximum(
                            b + [cx, cy, cz], 0), res)
                        if use_hash[l]:
                            h = np.uint32(c[0])
                            h ^= np.uint32(np.uint32(c[1]) *
                                           np.uint32(_PRIMES[1]))
                            h ^= np.uint32(np.uint32(c[2]) *
                                           np.uint32(_PRIMES[2]))
                            idx = int(h % np.uint32(T))
                        else:
                            idx = int((c[0] * (res + 1) + c[1])
                                      * (res + 1) + c[2])
                        w = ((f[0] if cx else 1 - f[0])
                             * (f[1] if cy else 1 - f[1])
                             * (f[2] if cz else 1 - f[2]))
                        acc += w * table[idx + offsets[l]]
            want[n, 2 * l: 2 * l + 2] = acc
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


# -- bricked backend (Triton kernels in interpret mode on CPU) ---------------

from nerf_replication_tpu.ops.pallas.hashgrid_kernel import (  # noqa: E402
    brick_encode_jnp,
    brick_encode_triton,
    _level_corners,
    make_brick_layout,
)


def test_brick_layout():
    lay = make_brick_layout(4, 16, 128, log2_bricks=10)
    assert lay.scales == (16, 32, 64, 128)
    assert lay.bsides == (4, 8, 16, 32)
    # 64, 512 dense; 4096 -> capped 1024 hash; 32768 -> capped hash
    assert lay.use_hash == (False, False, True, True)
    assert lay.offsets[1] - lay.offsets[0] == 128   # 64 -> 128-aligned
    assert lay.offsets[3] - lay.offsets[2] == 1024


def test_brick_ids_in_range():
    """Every corner of every level indexes its own level's rows."""
    lay = make_brick_layout(4, 16, 128, log2_bricks=10)
    x = jax.random.uniform(jax.random.key(0), (256, 3))
    for l in range(4):
        idx, w = _level_corners(lay, l, x[:, 0], x[:, 1], x[:, 2])
        assert idx.shape == (256, 8)
        rows = np.asarray(idx) // 256
        assert rows.min() >= lay.offsets[l]
        assert rows.max() < lay.offsets[l + 1]
        # feature-0 columns: in-brick vertices 0..124
        assert int(np.asarray(idx % 256).max()) < 125
        np.testing.assert_allclose(np.asarray(w).sum(-1), 1.0, rtol=1e-5)


def test_brick_kernel_matches_reference():
    lay = make_brick_layout(3, 8, 32, log2_bricks=9)
    key = jax.random.key(0)
    table = jax.random.uniform(key, (lay.n_rows, 256), jnp.float32, -1, 1)
    x = jax.random.uniform(jax.random.key(1), (700, 3))
    out_k = brick_encode_triton(lay, table, x, True)
    out_r = brick_encode_jnp(lay, table, x)
    # the same 8 products per feature, summed in another order
    np.testing.assert_allclose(np.asarray(out_k), np.asarray(out_r),
                               atol=1e-6, rtol=1e-5)


def test_brick_kernel_grad_matches_reference():
    lay = make_brick_layout(3, 8, 32, log2_bricks=9)
    key = jax.random.key(0)
    table = jax.random.uniform(key, (lay.n_rows, 256), jnp.float32, -1, 1)
    x = jax.random.uniform(jax.random.key(1), (300, 3))

    gk = jax.grad(
        lambda t: (brick_encode_triton(lay, t, x, True) ** 2).sum())(table)
    gr = jax.grad(lambda t: (brick_encode_jnp(lay, t, x) ** 2).sum())(table)
    denom = float(jnp.abs(gr).max())
    # f32 table gradients on both sides (no bf16 step); sums of the same
    # contributions in another order
    assert float(jnp.abs(gk - gr).max()) / denom < 1e-5


def test_brick_encoder_module():
    enc = HashGridEncoder(input_dim=3, n_levels=3, n_features=2,
                          base_resolution=8, finest_resolution=32,
                          input_grad=False, backend="brick", log2_bricks=9)
    x = jax.random.uniform(jax.random.key(0), (64, 3))
    params = enc.init(jax.random.key(1), x)
    out = enc.apply(params, x)
    assert out.shape == (64, 6)
    g = jax.grad(lambda p: (enc.apply(p, x) ** 2).sum())(params)
    gt = g["params"]["table"]
    assert bool(jnp.any(gt != 0))
