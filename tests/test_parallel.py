"""Multi-device (simulated 8-CPU mesh) tests — the capability the
reference never tests (SURVEY.md §4): sharded data-parallel training
steps and sharded eval rendering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_replication_tpu.parallel.mesh import (
    data_sharded,
    make_dp_epoch_runner,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch,
)


def test_mesh_uses_all_devices():
    mesh = make_mesh()
    assert len(mesh.devices.ravel()) == 8
    assert mesh.axis_names == ("data",)


def test_shard_batch_places_leading_axis():
    mesh = make_mesh()
    batch = {"rays_o": np.zeros((16, 3), np.float32)}
    sharded = shard_batch(batch, mesh)
    shard_shapes = [s.data.shape for s in sharded["rays_o"].addressable_shards]
    assert all(s == (2, 3) for s in shard_shapes)


def test_dp_train_step_matches_single_device():
    """Gradient math must be identical whether rays are sharded over 8
    devices or computed on one."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_trainer

    cfg = default_cfg()
    cfg.ep_iter = 1
    cfg.task_arg.update({"N_rays": 32, "N_samples": 8, "N_importance": 8,
                         "white_bkgd": True})
    cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3, "freq": 4}
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    cfg.network.dtype = "float32"

    net = make_network(cfg)
    params = init_params(net, jax.random.key(0))
    trainer = make_trainer(cfg, net)
    state0 = trainer.init_state(params)

    key = jax.random.key(1)
    ro = jnp.tile(jnp.array([[0.0, 0.0, 4.0]]), (32, 1))
    rd = jax.random.normal(key, (32, 3)) * 0.1 + jnp.array([0.0, 0.0, -1.0])
    colors = jax.random.uniform(jax.random.key(2), (32, 3))
    batch = {"rays_o": ro, "rays_d": rd, "colors": colors}

    # single-device
    s1, stats1 = jax.jit(trainer._train_step_inner)(
        jax.tree.map(jnp.copy, state0), batch, jax.random.key(3))

    # 8-device sharded
    mesh = make_mesh()
    rep = replicated(mesh)
    dat = data_sharded(mesh)
    state_r = replicate_tree(jax.tree.map(jnp.copy, state0), mesh)
    batch_s = shard_batch(batch, mesh)
    step = jax.jit(trainer._train_step_inner,
                   in_shardings=(rep, dat, rep),
                   out_shardings=(rep, rep))
    s8, stats8 = step(state_r, batch_s, jax.random.key(3))

    np.testing.assert_allclose(
        float(stats1["loss"]), float(stats8["loss"]), rtol=1e-5)
    l1 = jax.tree.leaves(s1["params"])
    l8 = jax.tree.leaves(s8["params"])
    for a, b in zip(l1, l8):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)


def test_dryrun_multichip_entrypoint():
    """The data-parallel phase of chip_smoke.py (two sharded train steps,
    sharded eval and frame renders vs one device) on 8 CPU devices."""
    import chip_smoke

    chip_smoke.multi_device_phase(8, tiny=True)


def test_sharded_eval_render_matches():
    """Full-image rays sharded over 8 devices produce the same image as
    unsharded rendering."""
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings,
        render_rays,
    )

    class Field:
        def apply(self, params, pts, viewdirs, model=""):
            sigma = jnp.where(jnp.linalg.norm(pts, axis=-1) < 1.0, 30.0, 0.0)
            rgb = jnp.broadcast_to(jnp.array([3.0, -3.0, 0.0]),
                                   pts.shape[:-1] + (3,))
            return jnp.concatenate([rgb, sigma[..., None]], axis=-1)

    apply_fn = lambda p, pts, vd, m: Field().apply(p, pts, vd, m)
    s = RenderSettings(N_samples=16, N_importance=16)
    n = 64
    ro = jnp.tile(jnp.array([[0.0, 0.0, 4.0]]), (n, 1))
    rd = jax.random.normal(jax.random.key(0), (n, 3)) * 0.1 + jnp.array(
        [0.0, 0.0, -1.0])

    ref = render_rays(apply_fn, None, ro, rd, None, s, train=False)["rgb"]

    mesh = make_mesh()
    dat = data_sharded(mesh)

    def render(params, ro, rd):
        return render_rays(apply_fn, params, ro, rd, None, s, train=False)["rgb"]

    fn = jax.jit(render, in_shardings=(None, dat, dat), out_shardings=dat)
    out = fn(None, jax.device_put(ro, dat), jax.device_put(rd, dat))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_trainer_train_device_with_mesh(tmp_path):
    """train.py's DP path: Trainer.train_device over an 8-device mesh."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.train.recorder import Recorder

    cfg = default_cfg()
    cfg.ep_iter = 3
    cfg.task_arg.update({"N_rays": 64, "N_samples": 8, "N_importance": 8})
    cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3, "freq": 4}
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    cfg.network.dtype = "float32"
    cfg.record_dir = str(tmp_path / "rec")

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 8, 8, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    K = np.array([[8.0, 0, 4], [0, 8, 4], [0, 0, 1]], np.float32)
    pipe = DeviceRayPipeline(images, poses, K, n_rays=64)

    mesh = make_mesh()
    net = make_network(cfg)
    trainer = make_trainer(cfg, net, mesh=mesh)
    state = trainer.init_state(init_params(net, jax.random.key(0)))
    rec = Recorder(cfg, process_index=0)
    state = trainer.train_device(0, pipe, state, rec)
    assert int(state["step"]) == 3
    loss0 = rec.loss_stats["loss"].avg
    state = trainer.train_device(1, pipe, state, rec)
    assert int(state["step"]) == 6
    assert np.isfinite(loss0)


def test_renderer_eval_dp_default_and_bitwise_equal():
    """The PRODUCT eval path (Renderer.render_rays_batch /
    render_image_fast) shards ray chunks over the mesh by default when
    multiple devices exist, and the sharded image equals the
    single-device image bitwise."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
        RenderSettings,
    )

    cfg = default_cfg()
    cfg.task_arg.update({"N_samples": 8, "N_importance": 8,
                         "ray_chunk": 40})  # 40 rounds up to 40 (8|40)
    cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3, "freq": 4}
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    cfg.network.dtype = "float32"
    net = make_network(cfg)
    params = init_params(net, jax.random.key(0))
    settings = RenderSettings.from_cfg(cfg)

    n = 100  # not a multiple of the chunk -> exercises padding
    ro = jnp.tile(jnp.array([[0.0, 0.0, 4.0]]), (n, 1))
    rd = jax.random.normal(jax.random.key(1), (n, 3)) * 0.1 + jnp.array(
        [0.0, 0.0, -1.0])
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)

    r_dp = Renderer(net, settings=settings)            # auto: 8-dev mesh
    assert r_dp.mesh is not None and len(r_dp.mesh.devices.ravel()) == 8
    r_1 = Renderer(net, settings=settings, mesh=None)  # single-device

    # XLA may reassociate reductions differently under sharding on rays
    # with near-tie inverse-CDF endpoints: demand exact equality on the
    # overwhelming majority and tight closeness everywhere
    def assert_same(a, b, atol=5e-4):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=atol)
        exact = np.mean(np.all(
            a.reshape(n, -1) == b.reshape(n, -1), axis=-1))
        assert exact > 0.9, f"only {exact:.0%} rays bitwise-equal"

    out_dp = r_dp.render_rays_batch(params, ro, rd)
    out_1 = r_1.render_rays_batch(params, ro, rd)
    assert_same(out_dp["rgb"], out_1["rgb"])
    assert_same(out_dp["depth"], out_1["depth"], atol=5e-3)  # t in [2,6]

    f_dp = r_dp.render_image_fast(params, ro, rd)
    f_1 = r_1.render_image_fast(params, ro, rd)
    assert_same(f_dp["rgb"], f_1["rgb"])

    # chunk size honors the mesh divisibility requirement
    assert r_dp._eval_chunk_size(100) % 8 == 0


def test_host_loader_train_path_uses_mesh():
    """Trainer.train (the host-loader parity path) must be data-parallel
    when a mesh is given — reference-shaped (B=1, N, ...) batches shard
    on the ray axis."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.train.recorder import Recorder

    def build():
        cfg = default_cfg()
        cfg.ep_iter = 2
        cfg.task_arg.update({"N_rays": 32, "N_samples": 8,
                             "N_importance": 8})
        cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
        cfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3,
                                   "freq": 4}
        cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3,
                                   "freq": 2}
        cfg.network.dtype = "float32"
        return cfg

    def batches():
        out = []
        for i in range(2):
            rng = np.random.default_rng(i)
            rd = (rng.normal(size=(1, 32, 3)) * 0.1 +
                  np.array([0.0, 0.0, -1.0])).astype(np.float32)
            rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
            out.append({
                "rays_o": np.tile(np.array([[[0.0, 0.0, 4.0]]],
                                           np.float32), (1, 32, 1)),
                "rays_d": rd,
                "colors": rng.uniform(size=(1, 32, 3)).astype(np.float32),
                "meta": {"H": 8, "W": 8},
            })
        return out

    def run(mesh):
        cfg = build()
        net = make_network(cfg)
        trainer = make_trainer(cfg, net, mesh=mesh)
        state = trainer.init_state(init_params(net, jax.random.key(0)))
        rec = Recorder(cfg, process_index=1)
        state = trainer.train(0, batches(), state, rec,
                              key=jax.random.key(5))
        return jax.tree.map(np.asarray, state["params"])

    p1 = run(None)
    p8 = run(make_mesh())
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p8)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)


def test_brick_encoder_grads_shard_over_mesh():
    """Brick hash encoder under the data mesh: table gradients from an
    8-way sharded batch must match the single-device grads."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nerf_replication_tpu.ops.pallas.hashgrid_kernel import (
        brick_encode, make_brick_layout)

    lay = make_brick_layout(2, 8, 16, log2_bricks=9)
    key = jax.random.key(0)
    table = jax.random.uniform(key, (lay.n_rows, 256), jnp.float32, -1, 1)
    x = jax.random.uniform(jax.random.key(1), (64, 3))

    def loss(t, xx):
        return (brick_encode(lay, t, xx) ** 2).sum()

    g_single = jax.grad(loss)(table, x)

    mesh = make_mesh()
    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    tr = jax.device_put(table, NamedSharding(mesh, P()))

    @jax.jit
    def sharded_grad(t, xx):
        return jax.grad(loss)(t, xx)

    g_mesh = sharded_grad(tr, xs)
    np.testing.assert_allclose(np.asarray(g_mesh), np.asarray(g_single),
                               atol=2e-2, rtol=2e-2)


def _tiny_freq_setup():
    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
        RenderSettings,
    )
    import os as _os
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    cfg = load_cfg_tree(_os.path.join(root, "configs/nerf/lego.yaml"),
                        default_cfg())
    cfg.task_arg.N_samples = 8
    cfg.task_arg.N_importance = 8
    cfg.network.dtype = "float32"
    cfg.network.nerf.W = 32
    cfg.network.nerf.D = 2
    cfg.network.nerf.skips = [1]
    net = make_network(cfg)
    params = init_params(net, jax.random.key(0))
    s = RenderSettings(N_samples=8, N_importance=8, ray_chunk=32)
    return Renderer(net, settings=s, mesh=None), params, s


def test_frame_renderer_sharded_matches_single():
    """The compacted frame renderer with in/out mesh
    shardings must reproduce the single-device frame bitwise-ish."""
    renderer, params, s = _tiny_freq_setup()
    H = W = 8
    focal = 0.5 * W / np.tan(0.3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    occ = (np.ones((8, 8, 8), np.uint8),
           (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    fn1 = renderer.make_frame_renderer(H, W, focal, capacity=0.75,
                                       occupancy=occ,
                                       out_dtype=jnp.float32)
    mesh = make_mesh()
    fn8 = renderer.make_frame_renderer(H, W, focal, capacity=0.75,
                                       occupancy=occ,
                                       out_dtype=jnp.float32, mesh=mesh)
    img1 = np.asarray(fn1(params, jnp.asarray(c2w)))
    with mesh:
        img8 = np.asarray(fn8(params, jnp.asarray(c2w)))
    # sharded f32 reduction order perturbs the inverse-CDF bin choice
    # for a few near-tie samples; a real sharding bug produces
    # large-area garbage, not isolated 1e-3 wiggles
    diff = np.abs(img8 - img1)
    assert np.mean(diff > 1e-3) < 0.05, f"{np.mean(diff > 1e-3):.3f}"
    assert diff.max() < 2e-2, f"max diff {diff.max():.3e}"


def test_ngp_frame_renderer_sharded_matches_single():
    from nerf_replication_tpu.config.cfg_node import CN
    from nerf_replication_tpu.models.nerf.network import (
        init_params,
        make_network as mk_nerf,
    )
    from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
        make_ngp_frame_renderer,
    )
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings,
    )

    cfg = CN({"task_arg": {"use_viewdirs": True},
              "network": {"dtype": "float32",
                          "nerf": {"W": 16, "D": 2, "V_D": 1, "skips": [1]},
                          "xyz_encoder": {
                              "type": "cuda_hashgrid", "backend": "brick",
                              "input_dim": 3, "num_levels": 3,
                              "level_dim": 2, "base_resolution": 4,
                              "desired_resolution": 16, "log2_bricks": 4,
                              "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]},
                          "dir_encoder": {"type": "sphere_harmonics",
                                          "degree": 2}}})
    net = mk_nerf(cfg)
    params = init_params(net, jax.random.key(0))
    apply_fn = lambda p, pts, vd, m: net.apply(p, pts, vd, model=m)
    s = RenderSettings(ray_chunk=32, density_activation="softplus")
    occ = (np.ones((8, 8, 8), np.uint8),
           (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    kw = dict(n_candidates=8, n_coarse=6, n_fine=6, capacity=0.75,
              probe_sub=1, out_dtype=jnp.float32)
    H = W = 8
    focal = 0.5 * W / np.tan(0.3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    fn1 = make_ngp_frame_renderer(apply_fn, H, W, focal, occ, s, **kw)
    mesh = make_mesh()
    fn8 = make_ngp_frame_renderer(apply_fn, H, W, focal, occ, s,
                                  mesh=mesh, **kw)
    img1 = np.asarray(fn1(params, jnp.asarray(c2w)))
    with mesh:
        img8 = np.asarray(fn8(params, jnp.asarray(c2w)))
    np.testing.assert_allclose(img8, img1, atol=1e-5)
