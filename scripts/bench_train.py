#!/usr/bin/env python
"""Training-throughput benchmark: rays/s per device on the flagship config
(BASELINE.md secondary metric "train rays/sec/device").

Prints one JSON line:
  {"metric": "train_rays_per_sec_per_chip", "value": N, "unit": "rays/s",
   "vs_baseline": null}
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

    from __graft_entry__ import _flagship
    from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.train.recorder import Recorder

    n_rays = int(os.environ.get("BENCH_TRAIN_RAYS", "1024"))
    steps = int(os.environ.get("BENCH_TRAIN_STEPS", "500"))
    cfg, net, params, settings, apply_fn = _flagship()
    cfg.ep_iter = steps
    cfg.task_arg.N_rays = n_rays

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
        "metric": "train_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()
