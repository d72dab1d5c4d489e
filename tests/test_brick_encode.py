"""Bricked hash-grid encode (ops/pallas/hashgrid_kernel.py): the Triton
kernels in interpret mode against the plain-jnp encode, the plain-jnp
encode against a numpy oracle, the platform choice, and (marked ``gpu``)
the compiled kernels on the card at the flagship layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.ops.pallas import hashgrid_kernel as hk

LAYOUTS = {
    # every level stores its bricks densely
    "all_dense": lambda: hk.make_brick_layout(3, 4, 16, log2_bricks=12),
    # levels 1-3 hash their brick coordinates into 128-row tables
    "hashed": lambda: hk.make_brick_layout(4, 8, 64, log2_bricks=4),
    # configs/nerf/hard_ngp.yaml: 12 levels, 16..512, 2^12 bricks/level
    "hard_ngp": lambda: hk.make_brick_layout(12, 16, 512, log2_bricks=12),
}
# a multiple of the Triton block, and one that is not
SIZES = (2 * hk.BLOCK, 300)


def _inputs(layout, n, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    table = jax.random.normal(k1, (layout.n_rows, hk.ROW), jnp.float32)
    x = jax.random.uniform(k2, (n, 3))
    cot = jax.random.normal(k3, (n, 2 * len(layout.scales)))
    return table, x, cot


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_triton_forward_matches_jnp(name, n):
    layout = LAYOUTS[name]()
    table, x, _ = _inputs(layout, n)
    out = hk.brick_encode_triton(layout, table, x, True)
    ref = hk.brick_encode_jnp(layout, table, x)
    assert out.shape == (n, 2 * len(layout.scales))
    # the same 8 products per feature, summed in another order
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_triton_table_gradient_matches_jnp(name, n):
    layout = LAYOUTS[name]()
    table, x, cot = _inputs(layout, n, seed=1)

    def grad(enc):
        return np.asarray(jax.grad(
            lambda t: jnp.sum(enc(layout, t, x) * cot))(table))

    g = grad(lambda lay, t, xx: hk.brick_encode_triton(lay, t, xx, True))
    g_ref = grad(hk.brick_encode_jnp)
    assert g.shape == (layout.n_rows, hk.ROW)
    # f32 accumulation on both sides; only the summation order differs
    err = np.abs(g - g_ref).max() / np.abs(g_ref).max()
    assert err < 1e-5, err


def _numpy_oracle(layout, table, x):
    """Per-point reimplementation from the layout definition: brick
    row (dense or prime-XOR hashed brick coordinates), in-brick vertex
    columns v = vx*25 + vy*5 + vz (feature 1 at 128+v), trilinear
    weights."""
    table = np.asarray(table, np.float64)
    x = np.asarray(x, np.float64)
    out = np.zeros((x.shape[0], 2 * len(layout.scales)))
    for l, res in enumerate(layout.scales):
        pos = x.astype(np.float32) * np.float32(res)
        cell = np.clip(np.floor(pos), 0, res - 1).astype(np.int64)
        frac = pos.astype(np.float64) - cell
        bc, loc = cell // 4, cell % 4
        if layout.use_hash[l]:
            cap = layout.offsets[l + 1] - layout.offsets[l]
            cap2 = 1 << int(np.floor(np.log2(cap)))
            h = (bc[:, 0].astype(np.uint64)
                 ^ ((bc[:, 1].astype(np.uint64) * 2654435761) & 0xFFFFFFFF)
                 ^ ((bc[:, 2].astype(np.uint64) * 805459861) & 0xFFFFFFFF))
            bid = (h % cap2).astype(np.int64)
        else:
            bs = layout.bsides[l]
            bid = (bc[:, 0] * bs + bc[:, 1]) * bs + bc[:, 2]
        row = layout.offsets[l] + bid
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    d = np.array([dx, dy, dz])
                    v = ((loc[:, 0] + dx) * 25 + (loc[:, 1] + dy) * 5
                         + loc[:, 2] + dz)
                    w = np.prod(np.where(d == 1, frac, 1.0 - frac), axis=-1)
                    out[:, 2 * l] += w * table[row, v]
                    out[:, 2 * l + 1] += w * table[row, 128 + v]
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_jnp_encode_matches_numpy_oracle(name):
    layout = LAYOUTS[name]()
    table, x, _ = _inputs(layout, 200, seed=2)
    got = np.asarray(hk.brick_encode_jnp(layout, table, x))
    np.testing.assert_allclose(got, _numpy_oracle(layout, table, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("platform,expected", [
    ("gpu", "brick_encode_triton"),
    ("cpu", "brick_encode_jnp"),
])
def test_select_encode_by_platform(platform, expected):
    assert hk.select_encode(platform) is getattr(hk, expected)


def test_select_encode_refuses_other_platforms():
    with pytest.raises(NotImplementedError, match="rocm"):
        hk.select_encode("rocm")


def test_brick_encode_dispatches_on_default_backend(monkeypatch):
    layout = LAYOUTS["hashed"]()
    table, x, _ = _inputs(layout, 16)
    calls = []
    monkeypatch.setattr(hk, "select_encode",
                        lambda p: calls.append(p) or hk.brick_encode_jnp)
    hk.brick_encode(layout, table, x)
    assert calls == [jax.default_backend()]


@pytest.mark.gpu
def test_triton_encode_compiled_on_card(gpu_device):
    """The compiled kernels at the hard_ngp layout on one train step's
    worth of points (1024 rays x 112 samples), against plain jnp."""
    layout = LAYOUTS["hard_ngp"]()
    with jax.default_device(gpu_device):
        table, x, cot = _inputs(layout, 1024 * 112, seed=3)
        out = hk.brick_encode_triton(layout, table, x)
        ref = hk.brick_encode_jnp(layout, table, x)
        g = jax.grad(lambda t: jnp.sum(
            hk.brick_encode_triton(layout, t, x) * cot))(table)
        g_ref = jax.grad(lambda t: jnp.sum(
            hk.brick_encode_jnp(layout, t, x) * cot))(table)
    out, ref, g, g_ref = map(np.asarray, (out, ref, g, g_ref))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    # atomic_add order changes from run to run
    assert np.abs(g - g_ref).max() / np.abs(g_ref).max() < 1e-4
