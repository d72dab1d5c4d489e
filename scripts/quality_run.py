#!/usr/bin/env python
"""Flagship quality run: train the exact lego-schedule NeRF (64+128
samples, 1024 rays, Adam 5e-4 exponential) on the procedural "hard"
textured scene at 800x800 with 100 train views, and log the val-PSNR
trajectory against the wall-clock budget (BASELINE.md north star:
>=30 dB in <10 min; this runs on one GPU and reports the trajectory
against single-device time).

Env knobs: QR_MINUTES (train budget, default 14), QR_VAL_EVERY (epochs
between val renders, default 4), QR_SCENE_ROOT (default data/synthetic).

Outputs:
  result/quality_run.jsonl   — {"epoch", "step", "train_s", "val_psnr"}
  data/pretrain/hard/        — final params (bench + warm starts)
  data/trained_model/...     — full checkpoint (latest)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# smoke runs with a custom scene root keep their logs there, away from
# the real result/quality_run.jsonl
_BASE = os.environ.get("QR_SCENE_ROOT", os.path.join(ROOT, "data"))
OUT = os.environ.get("QR_OUT") or (
    os.path.join(ROOT, "result", "quality_run.jsonl")
    if _BASE.startswith(ROOT) else
    os.path.join(_BASE, "quality_run.jsonl"))


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def main():
    import jax
    import numpy as np

    from nerf_replication_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.datasets.nerf.blender import Dataset
    from nerf_replication_tpu.datasets.pipeline import (
        DeviceRayPipeline,
        rays_for_camera,
    )
    from nerf_replication_tpu.evaluators.metrics import psnr_uint8, ssim
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
        RenderSettings,
    )
    from nerf_replication_tpu.train import make_recorder, make_trainer
    from nerf_replication_tpu.utils.ckpt_utils import save_model, save_pretrain
    from nerf_replication_tpu.utils.png import write_png
    from nerf_replication_tpu.utils.synthetic_scene import generate_scene

    budget_s = float(os.environ.get("QR_MINUTES", "14")) * 60.0
    val_every = int(os.environ.get("QR_VAL_EVERY", "4"))
    size = int(os.environ.get("QR_SIZE", "800"))       # CPU smoke: 64
    n_train = int(os.environ.get("QR_TRAIN_VIEWS", "100"))
    scene_root = os.environ.get(
        "QR_SCENE_ROOT", os.path.join(ROOT, "data", "synthetic"))
    scene = os.environ.get("QR_SCENE", "hard")

    scene_dir = os.path.join(scene_root, scene)
    if not os.path.exists(os.path.join(scene_dir, "transforms_train.json")):
        print(f"generating {scene} scene ({size}x{size}, {n_train} "
              "train views)...", flush=True)
        t0 = time.time()
        generate_scene(scene_root, scene=scene, H=size, W=size,
                       n_train=n_train, n_val=4, n_test=8)
        print(f"scene generated in {time.time() - t0:.0f}s", flush=True)

    cfg_file = os.environ.get("QR_CFG", "configs/nerf/hard.yaml")
    cfg = load_cfg_tree(os.path.join(ROOT, cfg_file), default_cfg())
    cfg.train_dataset.data_root = scene_root
    cfg.test_dataset.data_root = scene_root
    cfg.scene = scene
    cfg.exp_name = scene + ("_ngp" if "ngp" in cfg_file else "")
    for ds in (cfg.train_dataset, cfg.test_dataset):
        ds.H = ds.W = size
    if os.environ.get("QR_MAX_EPOCH"):
        cfg.train.epoch = int(os.environ["QR_MAX_EPOCH"])
    if os.environ.get("QR_BRICKS"):   # brick-encoder capacity ablations
        cfg.network.xyz_encoder["log2_bricks"] = int(os.environ["QR_BRICKS"])
        cfg.exp_name += "_b" + os.environ["QR_BRICKS"]
    # derive AFTER every exp_name suffix so ablations never overwrite
    # the base experiment's checkpoints
    cfg.trained_model_dir = os.path.join(
        "data/trained_model/nerf-replication", scene, cfg.exp_name)
    if size <= 128:  # CPU smoke settings
        cfg.task_arg.update({"N_rays": 128, "N_samples": 16,
                             "N_importance": 16, "ray_chunk": 2048,
                             "precrop_iters": 50})
        cfg.ep_iter = 20

    net = make_network(cfg)
    params = init_params(net, jax.random.key(int(cfg.get("seed", 0))))
    trainer = make_trainer(cfg, net)
    recorder = make_recorder(cfg)
    state = trainer.init_state(params)

    start_epoch = 0
    if os.environ.get("QR_RESUME", "0") == "1":
        from nerf_replication_tpu.utils.ckpt_utils import load_model
        payload = load_model(cfg.trained_model_dir, resume=True)
        if payload is not None:
            state = {"params": payload["net"], "opt_state": payload["optim"],
                     "step": payload["scheduler"].get("step", 0)}
            start_epoch = payload["epoch"] + 1
            print(f"resumed from epoch {payload['epoch']}", flush=True)
    step0 = int(state["step"])

    train_ds = Dataset(cfg, **{**cfg.train_dataset, "split": "train"})
    images, poses, K = train_ds.as_arrays()
    ta = cfg.task_arg
    alphas = (train_ds.alpha_arrays()
              if hasattr(train_ds, "alpha_arrays") else None)
    pipeline = DeviceRayPipeline(
        images, poses, K,
        n_rays=int(ta.get("N_rays", 1024)),
        precrop_iters=int(ta.get("precrop_iters", 0)),
        precrop_frac=float(ta.get("precrop_frac", 0.5)),
        alphas=alphas if bool(ta.get("random_bkgd", False)) else None)

    val_ds = Dataset(cfg, **{**cfg.test_dataset, "split": "val"})
    val_img = val_ds.images[0]
    val_pose = val_ds.poses[0]
    H, W, focal = val_ds.H, val_ds.W, val_ds.focal

    settings = RenderSettings.from_cfg(cfg)
    renderer = Renderer(net, settings=settings, mesh=None)
    ro, rd = rays_for_camera(val_pose, H, W, focal)
    ro = np.asarray(ro)
    rd = np.asarray(rd)

    def val_psnr(params):
        out = renderer.render_image_fast(params, ro, rd)
        pred = np.clip(out["rgb"].reshape(H, W, 3), 0, 1)
        return float(psnr_uint8(pred, val_img)), pred

    def unwrap(state):
        return state["params"]

    train_s = 0.0
    emit({"event": "start", "budget_s": budget_s,
          "n_train_views": len(train_ds.images), "H": H, "W": W,
          "start_epoch": start_epoch})
    epoch = start_epoch
    while train_s < budget_s and epoch < int(cfg.train.epoch):
        t0 = time.time()
        state = trainer.train_device(epoch, pipeline, state, recorder)
        train_s += time.time() - t0
        if (epoch + 1) % val_every == 0 or train_s >= budget_s:
            psnr, pred = val_psnr(unwrap(state))
            emit({"epoch": epoch, "step": int(state["step"]),
                  "train_s": round(train_s, 1), "val_psnr": round(psnr, 2)})
            # checkpoint at every val so an interrupted run loses at most
            # val_every epochs (QR_RESUME=1 picks this up)
            save_model(unwrap(state), state["opt_state"],
                       {"step": int(state["step"])},
                       recorder.state_dict(), epoch,
                       cfg.trained_model_dir, latest=True)
        epoch += 1

    # persist: full checkpoint + small params-only warm start for bench
    sched_state = {"step": int(state["step"])}
    save_model(unwrap(state), state["opt_state"], sched_state,
               recorder.state_dict(), epoch - 1, cfg.trained_model_dir,
               latest=True)
    save_pretrain(unwrap(state), cfg.exp_name,
                  model_dir=os.path.join(ROOT, "data", "pretrain",
                                         cfg.exp_name))

    # final: full test-split metrics (uint8 PSNR + win-7 SSIM, reference
    # definitions) over all 8 test views at 800x800
    test_ds = Dataset(cfg, **{**cfg.test_dataset, "split": "test"})
    psnrs, ssims = [], []
    os.makedirs(os.path.join(ROOT, "result", scene), exist_ok=True)
    for i, (img, pose) in enumerate(zip(test_ds.images, test_ds.poses)):
        tro, trd = rays_for_camera(pose, test_ds.H, test_ds.W, test_ds.focal)
        out = renderer.render_image_fast(
            unwrap(state), np.asarray(tro), np.asarray(trd))
        pred = np.clip(out["rgb"].reshape(test_ds.H, test_ds.W, 3), 0, 1)
        p8 = (pred * 255).astype(np.uint8)
        g8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        psnrs.append(psnr_uint8(pred, img))
        ssims.append(ssim(p8, g8, win_size=7, channel_axis=2))
        write_png(os.path.join(ROOT, "result", scene, f"test{i}_pred.png"),
                  p8)
        emit({"test_view": i, "psnr": round(psnrs[-1], 2),
              "ssim": round(float(ssims[-1]), 4)})
    n_rays = int(ta.get("N_rays", 1024))
    emit({"event": "final", "train_s": round(train_s, 1),
          "steps": int(state["step"]),
          # rays/s over THIS run's steps (resume keeps the global step
          # counter but train_s only covers this process)
          "rays_per_s": round((int(state["step"]) - step0) * n_rays
                              / max(train_s, 1e-9), 1),
          "test_psnr": round(float(np.mean(psnrs)), 2),
          "test_ssim": round(float(np.mean(ssims)), 4)})


if __name__ == "__main__":
    main()
