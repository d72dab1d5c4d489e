#!/usr/bin/env python
"""Hash-grid (instant-ngp style) training throughput on the probe_ngp
config (target: >= 20,000 train rays/s per device).

Prints one JSON line:
  {"metric": "ngp_train_rays_per_sec_per_chip", "value": N,
   "unit": "rays/s", "vs_baseline": null}

Env: BENCH_NGP_STEPS (default 300), BENCH_NGP_RAYS (1024),
BENCH_NGP_SORTED=0 to use the plain scatter backward,
BENCH_NGP_DTYPE=bfloat16 for bf16 table gathers.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import numpy as np

    from nerf_replication_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.train.recorder import Recorder

    steps = int(os.environ.get("BENCH_NGP_STEPS", "300"))
    n_rays = int(os.environ.get("BENCH_NGP_RAYS", "1024"))

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_cfg_tree(os.path.join(root, "configs/nerf/probe_ngp.yaml"),
                        default_cfg())
    cfg.ep_iter = steps
    cfg.task_arg.N_rays = n_rays
    cfg.task_arg.precrop_iters = 0
    if os.environ.get("BENCH_NGP_SORTED", "1") == "0":
        cfg.network.xyz_encoder["sorted_bwd"] = False
    if os.environ.get("BENCH_NGP_DTYPE"):
        cfg.network.xyz_encoder["compute_dtype"] = \
            os.environ["BENCH_NGP_DTYPE"]
    if os.environ.get("BENCH_NGP_SCAN"):
        cfg.scan_chunk = int(os.environ["BENCH_NGP_SCAN"])
    if os.environ.get("BENCH_NGP_BACKEND"):
        cfg.network.xyz_encoder["backend"] = os.environ["BENCH_NGP_BACKEND"]
    if os.environ.get("BENCH_NGP_BRICKS"):
        cfg.network.xyz_encoder["log2_bricks"] = \
            int(os.environ["BENCH_NGP_BRICKS"])

    net = make_network(cfg)
    params = init_params(net, jax.random.key(0))

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(8, 64, 64, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[:, 2, 3] = 4.0
    K = np.array([[64.0, 0, 32], [0, 64, 32], [0, 0, 1]], np.float32)
    pipe = DeviceRayPipeline(images, poses, K, n_rays=n_rays)

    trainer = make_trainer(cfg, net)
    state = trainer.init_state(params)
    rec = Recorder(cfg, process_index=1)  # silent

    state = trainer.train_device(0, pipe, state, rec)  # compile + warm
    t0 = time.time()
    state = trainer.train_device(1, pipe, state, rec)
    wall = time.time() - t0
    rays_per_sec = steps * n_rays / wall

    print(json.dumps({
        "metric": "ngp_train_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()
