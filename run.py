#!/usr/bin/env python
"""Staged debug/eval harness.

Capability parity with reference run.py: ``--type
{dataset,input,network,evaluate,mesh}`` dispatched via
``globals()["run_" + type]`` (run.py:187-188).

* dataset  — iterate the loader, print ray shapes (run.py:11-25)
* input    — drive the renderer with a fake identity-field network to
  validate sampling geometry before a model exists (run.py:6-8, 27-49)
* network  — render 4 views with a trained net, per-view PSNR + PNG dump
  (run.py:51-143)
* evaluate — full metric evaluation + fps benchmark,
  fps = 1/mean(net_time[1:]) (run.py:145-184)
* mesh     — extract a density-field mesh (the reference ships
  src/utils/mesh_utils.py but never wires it to a CLI; we do)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nerf_replication_tpu.config import init_global_cfg
from nerf_replication_tpu.utils.compile_cache import enable_compile_cache
from nerf_replication_tpu.utils.png import write_png

# set by the __main__ block below: the stages read the parsed config
cfg = args = None


class TestNet:
    """Identity-field fake network (reference TestNet, run.py:6-8):
    rgb = raw point coords, sigma = 1 — validates sampling geometry."""

    def apply(self, params, pts, viewdirs, model=""):
        import jax.numpy as jnp

        sigma = jnp.ones(pts.shape[:-1] + (1,), pts.dtype)
        return jnp.concatenate([pts, sigma], axis=-1)


def run_dataset():
    from nerf_replication_tpu.datasets import make_data_loader

    data_loader = make_data_loader(cfg, is_train=False)
    for i, batch in enumerate(data_loader):
        if i == 0:
            print("rays_o shape:", batch["rays_o"].shape)
            print("rays_d shape:", batch["rays_d"].shape)
            print("example rays_o[0]:", batch["rays_o"][0, 0])
            print("example rays_d[0]:", batch["rays_d"][0, 0])
        print(f"batch {i}: keys={sorted(batch.keys())}")


def run_input():
    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.models.nerf.renderer import make_renderer

    data_loader = make_data_loader(cfg, is_train=False)
    renderer = make_renderer(cfg, TestNet())
    for batch in data_loader:
        print("dataset output's rays_o shape:", batch["rays_o"].shape)
        print("dataset output's rays_d shape:", batch["rays_d"].shape)
        rgb, depth = renderer.render(batch, params=None)
        print("render ok: rgb", rgb.shape, "depth", depth.shape,
              "depth range", float(depth.min()), float(depth.max()))
        break


def run_network():
    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.evaluators.metrics import psnr_uint8
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.renderer import make_renderer
    from nerf_replication_tpu.utils.ckpt_utils import load_network

    network = make_network(cfg)
    params = load_network(cfg.trained_model_dir, resume=cfg.resume,
                          epoch=cfg.test.epoch)
    renderer = make_renderer(cfg, network)
    data_loader = make_data_loader(cfg, is_train=False)

    out_dir = os.path.join(cfg.result_dir, "network_debug")
    os.makedirs(out_dir, exist_ok=True)
    total_time = 0.0
    for count, batch in enumerate(data_loader):
        t0 = time.time()
        rgb, depth = renderer.render(batch, params=params)
        rgb = np.asarray(rgb)
        total_time += time.time() - t0
        H = int(np.asarray(batch["H"]).reshape(-1)[0])
        W = int(np.asarray(batch["W"]).reshape(-1)[0])
        gt = np.asarray(batch["colors"]).reshape(-1, 3)
        print(f"view {count}: psnr {psnr_uint8(rgb, gt):.2f}")
        write_png(os.path.join(out_dir, f"view{count:03d}.png"),
                  (np.clip(rgb.reshape(H, W, 3), 0, 1) * 255).astype(np.uint8))
        if count == 3:
            break
    print("total_time:", total_time)


def run_evaluate():

    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.evaluators import make_evaluator
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.renderer import make_renderer
    from nerf_replication_tpu.utils.ckpt_utils import load_network

    print(f"trained_model_dir: {cfg.trained_model_dir}")
    network = make_network(cfg)
    params = load_network(cfg.trained_model_dir, resume=cfg.resume,
                          epoch=cfg.test.epoch)
    data_loader = make_data_loader(cfg, is_train=False)
    evaluator = make_evaluator(cfg)
    renderer = make_renderer(cfg, network)

    # task_arg.fast_render: occupancy-raymarch frame path (instant-ngp
    # eval semantics; quality bound by the occupancy grid, see
    # ngp_renderer.py). The frame renderer is model-agnostic: NGP nets
    # and the 8x256 frequency flagship ride the same renderer apply.
    frame_fn = None
    fast_apply = renderer.apply_fn
    if bool(cfg.task_arg.get("fast_render", 0)):
        import jax
        import jax.numpy as jnp

        from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
            make_ngp_frame_renderer,
        )
        from nerf_replication_tpu.ops.occupancy import build_occupancy_grid
        from nerf_replication_tpu.ops.ray_ops import density_activation

        act = density_activation(
            cfg.task_arg.get("density_activation", "relu"))

        def density_fn(p, pts):
            return act(fast_apply(p, pts[:, None, :],
                                  jnp.zeros((1, 1, 3)), "fine")[:, 0, 3])

        grid, bbox = build_occupancy_grid(
            density_fn, params,
            resolution=int(cfg.task_arg.get("occ_resolution", 64)),
            threshold=float(cfg.task_arg.get("occ_threshold", 0.02)),
            dilate=2)
        print(f"occupancy grid: {float(grid.mean()):.3f} occupied")
        # finer low-dilation grid for candidate selection (see
        # ngp_renderer.make_ngp_frame_renderer docstring)
        select_occupancy = None
        sel_res = int(cfg.task_arg.get("occ_sel_resolution", 128))
        if sel_res > grid.shape[0]:
            select_occupancy = build_occupancy_grid(
                density_fn, params, resolution=sel_res,
                threshold=float(cfg.task_arg.get("occ_threshold", 0.02)),
                dilate=1)
        from nerf_replication_tpu.models.nerf.renderer.volume_renderer \
            import RenderSettings

        _settings = RenderSettings.from_cfg(cfg)

        def make_frame(H, W, focal):
            return make_ngp_frame_renderer(
                fast_apply, H, W, focal, (grid, bbox, 2), _settings,
                n_candidates=int(cfg.task_arg.get("fast_candidates", 32)),
                n_coarse=int(cfg.task_arg.get("fast_coarse", 16)),
                n_fine=int(cfg.task_arg.get("fast_fine", 16)),
                capacity=float(cfg.task_arg.get("fast_capacity", 0.4)),
                out_dtype=jnp.float32, return_depth=True,
                select_occupancy=select_occupancy,
                occ_capacity=float(cfg.task_arg.get(
                    "fast_occ_capacity", 0.0)) or None,
                probe_sub=cfg.task_arg.get("fast_probe_sub", 4),
                probe_stride=int(cfg.task_arg.get(
                    "fast_probe_stride", 1)))

        _frame_cache = {}

        def frame_fn(batch):
            H = int(np.asarray(batch["H"]).reshape(-1)[0])
            W = int(np.asarray(batch["W"]).reshape(-1)[0])
            focal = float(np.asarray(batch["focal"]).reshape(-1)[0])
            key = (H, W, focal)
            if key not in _frame_cache:
                _frame_cache[key] = make_frame(H, W, focal)
            pose = jnp.asarray(
                np.asarray(batch["pose"]).reshape(4, 4))
            return _frame_cache[key](params, pose)

    net_time = []
    for i, batch in enumerate(data_loader):
        profiling = bool(cfg.get("profile", False)) and i == 1
        if profiling:
            from nerf_replication_tpu.utils.profiling import trace

            trace_cm = trace(os.path.join(cfg.record_dir, "trace"))
            trace_cm.__enter__()
        t0 = time.time()
        if frame_fn is not None and "pose" in batch:
            output = frame_fn(batch)
        else:
            output = renderer.render(batch, params=params)
        # host fetch of the frame: the completion fence for the timing
        float(np.asarray(output[0]).sum())
        net_time.append(time.time() - t0)
        if profiling:
            trace_cm.__exit__(None, None, None)
            print("profiler trace:", os.path.join(cfg.record_dir, "trace"))
        evaluator.evaluate(output, batch)
    result = evaluator.summarize()
    print(result)
    times = net_time[1:] if len(net_time) > 1 else net_time
    print("net_time: ", float(np.mean(times)))
    print("fps: ", 1.0 / float(np.mean(times)))
    return result


def run_mesh():
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.utils.ckpt_utils import load_network
    from nerf_replication_tpu.utils.mesh_utils import extract_mesh

    network = make_network(cfg)
    params = load_network(cfg.trained_model_dir, resume=cfg.resume,
                          epoch=cfg.test.epoch)
    out = os.path.join(cfg.result_dir, "mesh.ply")
    os.makedirs(cfg.result_dir, exist_ok=True)
    extract_mesh(network, params, out, level=cfg.level,
                 resolution=cfg.resolution)
    print("mesh written to", out)


if __name__ == "__main__":
    cfg, args = init_global_cfg()
    enable_compile_cache()
    globals()["run_" + args.type]()
