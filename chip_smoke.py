#!/usr/bin/env python
"""Smoke run of the main paths on one GPU, in one process.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --devices 4   # four cards: the data-parallel phase

Phases on one card (a failed check raises; the script exits non-zero):

1. device — JAX must find a GPU (there is no CPU fallback); prints the
   card's name and power limit, its device kind and the JAX version.
2. set-up (untimed) — the procedural 800x800 "hard" scene, generated from
   its seed when missing.
3. frequency training — ``configs/nerf/hard.yaml`` (8x256 coarse+fine,
   64+128 samples, 1024 rays, the 100-view split on the device) through
   ``Trainer.train_device``, the ``train.py`` path; plus one bf16 render
   of the initial params against the float32 render at highest matmul
   precision.
4. NGP training — ``configs/nerf/hard_ngp.yaml`` (brick layout, 12
   levels) the same way; plus the Triton hash-grid encode's forward and
   table gradient on one train step's points against the plain-jnp
   encode on the CPU.
5. frames — one 800x800 frame per render family from the committed
   checkpoints (``freq`` compacted frame renderer, ``freq_rm`` and
   ``ngp`` occupancy raymarch), each with its compiled memory analysis
   and its PSNR against the dense hierarchical render of the same pose.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nerf_replication_tpu.config import default_cfg, load_cfg_tree  # noqa: E402
from nerf_replication_tpu.evaluators.metrics import psnr_uint8  # noqa: E402
from nerf_replication_tpu.models import make_network  # noqa: E402
from nerf_replication_tpu.models.nerf.network import init_params  # noqa: E402
from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (  # noqa: E402
    make_ngp_frame_renderer,
)
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (  # noqa: E402
    Renderer,
    RenderSettings,
    render_rays,
)
from nerf_replication_tpu.ops.occupancy import build_occupancy_grid  # noqa: E402
from nerf_replication_tpu.ops.pallas import hashgrid_kernel as hk  # noqa: E402
from nerf_replication_tpu.ops.ray_ops import density_activation  # noqa: E402

SCENE_ROOT = os.path.join(ROOT, "data", "synthetic")
H = W = 800
FRAME_GATE_DB = 40.0      # frame-vs-dense PSNR floor (the bench's gate)
# one compiled frame program run twice on the same input, max |rgb|
# difference: the frame paths hold no atomics, so the runs agree bit for
# bit; a misread GEMM operand showed here as differences near 0.9
FRAME_RERUN_TOL = 1e-3
# bf16 MLP vs f32 at highest precision, max |rgb| difference: bf16 keeps
# 8 mantissa bits (2^-9 relative rounding per operand), compounded over
# ~10 layers of 256-wide sums; the sigmoid slope is <= 1/4
RENDER_BF16_TOL = 3e-2
# Triton encode vs plain jnp on the CPU, max error over max |reference|:
# the forward sums the same 8 products in another order; the table
# gradient adds ~100 contributions per coarse entry with atomics, whose
# order changes from run to run
ENCODE_FWD_TOL = 1e-5
ENCODE_GRAD_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cfg_of(path: str):
    return load_cfg_tree(os.path.join(ROOT, path), default_cfg())


# -- phase 1 ---------------------------------------------------------------------

def device_phase() -> bool:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(line)
    log(f"device_kind: {dev.device_kind}, devices: {len(jax.devices())}, "
        f"jax {jax.__version__}")
    return True


# -- phase 2 ---------------------------------------------------------------------

def ensure_scene(root: str = SCENE_ROOT, H: int = H, W: int = W,
                 n_train: int = 100, n_val: int = 4, n_test: int = 8):
    """The procedural flagship scene; transforms_test.json is written
    last, so its presence means a complete scene."""
    from nerf_replication_tpu.utils.synthetic_scene import generate_scene

    if not os.path.exists(os.path.join(root, "hard", "transforms_test.json")):
        t0 = time.time()
        generate_scene(root, scene="hard", H=H, W=W, n_train=n_train,
                       n_val=n_val, n_test=n_test)
        log(f"set-up: generated the hard scene in {time.time() - t0:.1f}s")


# -- phases 3 and 4 -----------------------------------------------------------------

def train_phase(name: str, cfg, epochs: int = 2):
    """``epochs`` epochs of one SCAN_CHUNK of steps through
    Trainer.train_device; returns (cfg, net, pipeline, state)."""
    from nerf_replication_tpu.datasets.make_dataset import make_dataset
    from nerf_replication_tpu.datasets.pipeline import make_train_pipeline
    from nerf_replication_tpu.train import make_recorder, make_trainer
    from nerf_replication_tpu.train.trainers.trainer import Trainer

    cfg.ep_iter = int(cfg.get("scan_chunk", Trainer.SCAN_CHUNK))
    cfg.record_dir = os.path.join(ROOT, "data", "record", "chip_smoke", name)
    pipeline = make_train_pipeline(cfg, make_dataset(cfg, is_train=True))
    net = make_network(cfg)
    trainer = make_trainer(cfg, net)
    recorder = make_recorder(cfg)
    state = trainer.init_state(init_params(net, jax.random.key(0)))

    batch = jax.jit(pipeline.sample)(jax.random.key(1), 0, pipeline.data())
    loss0 = float(jax.jit(
        lambda p, b: trainer.wrapper.loss_fn(p, b, jax.random.key(2))[0])(
            state["params"], batch))
    walls = []
    for epoch in range(epochs):
        t0 = time.time()
        state = trainer.train_device(epoch, pipeline, state, recorder)
        walls.append(time.time() - t0)
    last = float(recorder.loss_stats["loss"].deque[-1])
    n_rays = int(cfg.task_arg.N_rays)
    rays_s = cfg.ep_iter * n_rays / walls[-1]
    log(f"{name} train: step 0 loss {loss0:.5f}, step "
        f"{epochs * cfg.ep_iter} loss {last:.5f}, {rays_s:,.0f} rays/s "
        f"(epoch of {cfg.ep_iter} steps: first {walls[0]:.2f}s with "
        f"compilation, last {walls[-1]:.3f}s)")
    if not (np.isfinite(loss0) and np.isfinite(last)):
        raise AssertionError(f"{name}: non-finite loss {loss0}, {last}")
    return cfg, net, pipeline, state


def eval_rays(pipeline, key: int = 3):
    """One training batch's rays, past the precrop schedule."""
    b = jax.jit(pipeline.sample)(jax.random.key(key), 10 ** 6, pipeline.data())
    return b["rays_o"], b["rays_d"]


def check_bf16_render(cfg, params, rays_o, rays_d):
    """One eval render of ``params`` with the configured bf16 MLP against
    the same call in float32 at highest matmul precision."""
    settings = RenderSettings.from_cfg(cfg)
    outs = []
    for dtype, precision in (("bfloat16", "default"), ("float32", "highest")):
        c = cfg.clone()
        c.network.dtype = dtype
        net = make_network(c)
        apply_fn = lambda p, pts, vd, m, net=net: net.apply(p, pts, vd, model=m)
        with jax.default_matmul_precision(precision):
            fn = jax.jit(lambda p, o, d, apply_fn=apply_fn: render_rays(
                apply_fn, p, o, d, None, settings, train=False)["rgb"])
            outs.append(np.asarray(fn(params, rays_o, rays_d)))
    diff = float(np.abs(outs[0] - outs[1]).max())
    log(f"freq render bf16 vs f32-highest: max |rgb diff| {diff:.3e} "
        f"(tolerance {RENDER_BF16_TOL:.0e})")
    if not diff <= RENDER_BF16_TOL:
        raise AssertionError(f"bf16 render diverges: {diff:.3e}")


def encode_layout(cfg) -> hk.BrickLayout:
    e = cfg.network.xyz_encoder
    return hk.make_brick_layout(
        int(e.num_levels), int(e.base_resolution),
        int(e.desired_resolution), log2_bricks=int(e.log2_bricks))


def check_encode(cfg, rays_o, rays_d):
    """The Triton encode's forward and table gradient on one train step's
    points (N_rays x (N_samples + N_importance)) against the plain-jnp
    encode on the CPU, with the configured layout and a random table."""
    from nerf_replication_tpu.models.encoding.hashgrid import normalize_to_unit

    ta = cfg.task_arg
    layout = encode_layout(cfg)
    n_s = int(ta.N_samples) + int(ta.N_importance)
    t = jnp.linspace(float(ta.near), float(ta.far), n_s)
    pts = (rays_o[:, None] + rays_d[:, None] * t[None, :, None]).reshape(-1, 3)
    x = jnp.clip(normalize_to_unit(
        pts, tuple(cfg.network.xyz_encoder.bounds)), 0.0, 1.0)
    table = jax.random.normal(jax.random.key(4), (layout.n_rows, hk.ROW))
    cot = jax.random.normal(jax.random.key(5), (x.shape[0], 2 * len(layout.scales)))

    def fwd_grad(enc):
        fwd = lambda tab, xx: enc(layout, tab, xx)
        g = jax.grad(lambda tab, xx, c: jnp.sum(fwd(tab, xx) * c))
        return jax.jit(fwd), jax.jit(g)

    f, g = fwd_grad(hk.brick_encode_triton)
    out, grad = np.asarray(f(table, x)), np.asarray(g(table, x, cot))
    cpu = jax.devices("cpu")[0]
    fr, gr = fwd_grad(hk.brick_encode_jnp)
    args = jax.device_put((table, x, cot), cpu)
    ref, gref = np.asarray(fr(*args[:2])), np.asarray(gr(*args))
    e_f = float(np.abs(out - ref).max() / np.abs(ref).max())
    e_g = float(np.abs(grad - gref).max() / np.abs(gref).max())
    log(f"encode vs plain jnp on {x.shape[0]:,} points, {layout.n_rows} "
        f"table rows: forward {e_f:.2e} (tolerance {ENCODE_FWD_TOL:.0e}), "
        f"table gradient {e_g:.2e} (tolerance {ENCODE_GRAD_TOL:.0e}), "
        "relative to max |reference|")
    if not (e_f <= ENCODE_FWD_TOL and e_g <= ENCODE_GRAD_TOL):
        raise AssertionError("encode differs from the plain-jnp reference")


# -- phase 5 ---------------------------------------------------------------------

def ray_grid(H, W, focal, c2w):
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    dirs = np.stack([(us.ravel() - W / 2.0) / focal,
                     -(vs.ravel() - H / 2.0) / focal,
                     -np.ones(H * W, np.float32)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def test_pose():
    """The first test view of the scene and its focal length at W."""
    with open(os.path.join(SCENE_ROOT, "hard", "transforms_test.json")) as f:
        meta = json.load(f)
    pose = np.asarray(meta["frames"][0]["transform_matrix"], np.float32)
    return pose, 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))


def occupancy_grids(apply_fn, params, settings):
    """Span-probe grid (64^3, dilated 2) and candidate-selection grid
    (128^3, dilated 1), as the bench builds them."""
    act = density_activation(settings.density_activation)

    def density_fn(p, pts):
        return act(apply_fn(p, pts[:, None, :], jnp.zeros((1, 1, 3)),
                            "fine")[:, 0, 3])

    grid, bbox = build_occupancy_grid(density_fn, params, resolution=64,
                                      threshold=0.02, dilate=2)
    sel = build_occupancy_grid(density_fn, params, resolution=128,
                               threshold=0.02, dilate=1)
    return (grid, bbox, 2), sel


def frame_check(family: str, frame_fn, params, pose, dense):
    pose = jnp.asarray(pose)
    compiled = frame_fn.lower(params, pose).compile()
    log(f"{family} frame memory_analysis: {compiled.memory_analysis()}")
    first = np.asarray(compiled(params, pose))
    t0 = time.time()
    img = np.asarray(compiled(params, pose))
    wall = time.time() - t0
    rerun = float(np.abs(img - first).max())
    q = psnr_uint8(img.reshape(dense.shape), dense)
    log(f"{family} frame {H}x{W}: {q:.2f} dB vs dense (gate "
        f"{FRAME_GATE_DB:.0f}), rerun max |diff| {rerun:.1e} (tolerance "
        f"{FRAME_RERUN_TOL:.0e}), {wall:.3f}s warm")
    if not q >= FRAME_GATE_DB:
        raise AssertionError(f"{family} frame below the gate: {q:.2f} dB")
    if not rerun <= FRAME_RERUN_TOL:
        raise AssertionError(
            f"{family} frame changes between runs: {rerun:.3e}")


def dense_frame(renderer, params, pose, focal):
    ro, rd = ray_grid(H, W, focal, pose)
    rgb = renderer.render_rays_batch(params, ro, rd)["rgb"]
    return np.clip(np.asarray(rgb), 0.0, 1.0).reshape(H, W, 3)


def pretrained(name: str):
    from nerf_replication_tpu.utils.ckpt_utils import load_pretrain

    trained = load_pretrain(os.path.join(ROOT, "data", "pretrain", name))
    if trained is None:
        raise FileNotFoundError(f"data/pretrain/{name}/pretrain.ckpt")
    return jax.tree.map(jnp.asarray, trained)


def raymarch_frame(apply_fn, params, settings, pose, focal):
    occupancy, select = occupancy_grids(apply_fn, params, settings)
    # the bench ladder's top step, every ray in budget: a smoke of the
    # path, not a tuned operating point
    return make_ngp_frame_renderer(
        apply_fn, H, W, focal, occupancy, settings, n_candidates=64,
        n_coarse=32, n_fine=24, capacity=1.0, fine_capacity=1.0,
        out_dtype=jnp.float32, select_occupancy=select, probe_sub="auto",
        probe_stride=2)


def frames_phase():
    pose, focal = test_pose()

    cfg = cfg_of("configs/nerf/hard.yaml")
    net = make_network(cfg)
    params = pretrained("hard")
    settings = dataclasses.replace(RenderSettings.from_cfg(cfg),
                                   fast_sampling=False)
    renderer = Renderer(net, settings=settings, mesh=None)
    dense = dense_frame(renderer, params, pose, focal)
    frame_check("freq", renderer.make_frame_renderer(
        H, W, focal, capacity=1.0, coarse_capacity=1.0), params, pose, dense)
    frame_check("freq_rm", raymarch_frame(
        renderer.apply_fn, params, settings, pose, focal), params, pose, dense)

    cfg = cfg_of("configs/nerf/hard_ngp.yaml")
    params = pretrained("hard_ngp_b9")
    cfg.network.xyz_encoder.log2_bricks = 9    # the checkpoint's table
    net = make_network(cfg)
    settings = dataclasses.replace(RenderSettings.from_cfg(cfg),
                                   fast_sampling=False)
    renderer = Renderer(net, settings=settings, mesh=None)
    dense = dense_frame(renderer, params, pose, focal)
    frame_check("ngp", raymarch_frame(
        renderer.apply_fn, params, settings, pose, focal), params, pose, dense)


# -- several cards ---------------------------------------------------------------

def multi_device_phase(n_devices: int, tiny: bool = False) -> None:
    """Two data-parallel train steps on an ``n_devices`` mesh against the
    same steps on one device, then a sharded eval render and sharded
    frame renders (freq compacted, NGP raymarch) against one device.
    Full widths (hard.yaml / hard_ngp.yaml networks, 1024 rays, 800x800
    views of seeded random images) unless ``tiny``."""
    from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
    from nerf_replication_tpu.parallel.mesh import (
        make_dp_epoch_runner,
        make_mesh,
        replicate_tree,
    )
    from nerf_replication_tpu.train import make_trainer

    size = 8 if tiny else H
    cfg = cfg_of("configs/nerf/hard.yaml")
    if tiny:
        cfg.task_arg.N_samples = cfg.task_arg.N_importance = 16
        cfg.task_arg.N_rays = cfg.task_arg.ray_chunk = 64
        cfg.network.nerf.W, cfg.network.nerf.D = 32, 4
        cfg.network.nerf.skips = [2]
    # f32 for the sharded == single comparison: bf16 reassociation noise
    # through Adam's ~sign(g) first steps would swamp real divergence
    cfg.network.dtype = "float32"
    cfg.ep_iter = 2
    net = make_network(cfg)
    params = init_params(net, jax.random.key(0))
    mesh = make_mesh(n_devices=n_devices)

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, 2, 3] = 4.0
    focal = size / (2.0 * np.tan(0.3))
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]],
                 np.float32)
    pipeline = DeviceRayPipeline(images, poses, K,
                                 n_rays=int(cfg.task_arg.N_rays))

    def two_steps(m):
        trainer = make_trainer(cfg, net, mesh=m)
        state = replicate_tree(
            trainer.init_state(jax.tree.map(jnp.copy, params)), m)
        run = make_dp_epoch_runner(trainer, pipeline, m, n_steps=2)
        with m:
            state, stats = run(state, jax.random.key(0), 0, pipeline.data())
        return state, np.asarray(stats["loss"])

    state_n, loss_n = two_steps(mesh)
    state_1, loss_1 = two_steps(make_mesh(n_devices=1))
    if not np.all(np.isfinite(loss_n)):
        raise AssertionError(f"non-finite sharded loss {loss_n}")
    # per-step losses are scale-sensitive (a wrong psum/mean factor shows
    # here even though Adam's scale invariance would hide it in params)
    np.testing.assert_allclose(loss_n, loss_1, rtol=1e-4, err_msg=(
        "sharded per-step losses diverge from single-device"))
    diffs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b)))),
        state_n["params"], state_1["params"])
    max_diff = max(jax.tree.leaves(diffs))
    # Adam's first steps are ~lr*sign(g): reassociation noise on
    # near-zero grads can flip single updates, so the bound is a few lr
    # (lr=5e-4) — real divergence (wrong sharding) lands far above
    if not max_diff < 3e-3:
        raise AssertionError(f"sharded params diverge: {max_diff:.3e}")

    # the renders below all use the single-device params, so only the
    # sharding differs between the two sides
    params = state_1["params"]
    settings = RenderSettings.from_cfg(cfg)
    r_n = Renderer(net, settings=settings, mesh=mesh)
    r_1 = Renderer(net, settings=settings, mesh=None)
    ro, rd = pipeline.rays_for_pose(pipeline.poses[0])
    n_eval = min(ro.shape[0], 40000)
    img_n = r_n.render_rays_batch(params, ro[:n_eval], rd[:n_eval])
    img_1 = r_1.render_rays_batch(params, ro[:n_eval], rd[:n_eval])
    eval_diff = float(np.max(np.abs(img_n["rgb"] - img_1["rgb"])))
    if not eval_diff < 1e-3:
        raise AssertionError(f"sharded eval diverges: {eval_diff:.3e}")

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    occ = (np.ones((8, 8, 8), np.uint8), (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    kw = dict(capacity=0.75, occupancy=occ, out_dtype=jnp.float32)
    f1 = np.asarray(r_1.make_frame_renderer(size, size, focal, **kw)(
        params, jnp.asarray(c2w)))
    with mesh:
        fn = np.asarray(r_n.make_frame_renderer(
            size, size, focal, mesh=mesh, **kw)(params, jnp.asarray(c2w)))
    frame_diff = float(np.max(np.abs(fn - f1)))
    # f32 reduction order perturbs near-tie inverse-CDF bins on a few
    # rays; real sharding bugs are >>0.1
    if not frame_diff < 5e-2:
        raise AssertionError(f"sharded frame diverges: {frame_diff:.3e}")

    ngp_cfg = cfg_of("configs/nerf/hard_ngp.yaml")
    if tiny:
        ngp_cfg.network.nerf.W, ngp_cfg.network.nerf.D = 16, 2
        enc = ngp_cfg.network.xyz_encoder
        enc.num_levels, enc.base_resolution = 3, 4
        enc.desired_resolution, enc.log2_bricks = 16, 4
    ngp_net = make_network(ngp_cfg)
    ngp_params = init_params(ngp_net, jax.random.key(0))
    ngp_apply = lambda p, pts, vd, m: ngp_net.apply(p, pts, vd, model=m)
    chunk = 32 if tiny else 8000
    ngp_kw = dict(n_candidates=8, n_coarse=6, n_fine=6, capacity=0.75,
                  probe_sub=1, out_dtype=jnp.float32, occ_capacity=0.75)
    g1 = np.asarray(make_ngp_frame_renderer(
        ngp_apply, size, size, focal, occ, RenderSettings(ray_chunk=chunk),
        **ngp_kw)(ngp_params, jnp.asarray(c2w)))
    with mesh:
        gn = np.asarray(make_ngp_frame_renderer(
            ngp_apply, size, size, focal, occ,
            RenderSettings(ray_chunk=chunk), mesh=mesh, **ngp_kw)(
                ngp_params, jnp.asarray(c2w)))
    ngp_diff = float(np.max(np.abs(gn - g1)))
    if not ngp_diff < 5e-2:
        raise AssertionError(f"sharded NGP frame diverges: {ngp_diff:.3e}")
    log(f"data-parallel on {n_devices} devices vs one: losses {loss_n} vs "
        f"{loss_1}, max param diff {max_diff:.2e}, eval diff "
        f"{eval_diff:.2e}, frame diff {frame_diff:.2e}, NGP frame diff "
        f"{ngp_diff:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the data-parallel phase on this many "
                         "cards (default 1: the one-card phases)")
    args = ap.parse_args(argv)
    if not device_phase():
        return 1
    from nerf_replication_tpu.utils.compile_cache import enable_compile_cache

    os.chdir(ROOT)          # the configs name data paths from the root
    enable_compile_cache()
    if args.devices > 1:
        if len(jax.devices()) < args.devices:
            raise RuntimeError(
                f"--devices {args.devices}: JAX sees {len(jax.devices())}")
        multi_device_phase(args.devices)
    else:
        ensure_scene()
        cfg, net, pipeline, _ = train_phase(
            "freq", cfg_of("configs/nerf/hard.yaml"))
        check_bf16_render(cfg, init_params(net, jax.random.key(0)),
                          *eval_rays(pipeline))
        cfg, _, pipeline, _ = train_phase(
            "ngp", cfg_of("configs/nerf/hard_ngp.yaml"))
        check_encode(cfg, *eval_rays(pipeline))
        frames_phase()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
