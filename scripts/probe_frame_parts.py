#!/usr/bin/env python
"""Strip-profile the NGP frame renderer: where does the frame time go?

Times the pipeline truncated at each stage (make_ngp_frame_renderer's
``stage`` knob) plus a null-field variant (apply_fn returns zeros) that
keeps ALL the machinery but no encode/MLP work:

  probe       span probe + active compaction + scatter
  coarse      + candidate selection + field eval (M pts) + composite
  full        + fine CDF round (F pts) + merge + composite
  full-null   full machinery, zero-cost field

field-eval cost = full - full-null; candidate machinery = coarse -
probe - (coarse-eval share) etc. Run on the GPU. Env: same knobs as
bench.py ngp mode (BENCH_NGP_CKPT, BENCH_NGP_LADDER step via PROBE_CMF,
PROBE_CAP / PROBE_FCAP from the bench autocap line).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
        make_ngp_frame_renderer,
    )
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        RenderSettings,
    )
    from nerf_replication_tpu.ops.ray_ops import density_activation
    from nerf_replication_tpu.utils.ckpt_utils import load_pretrain
    from nerf_replication_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    H = W = int(os.environ.get("BENCH_SIZE", "800"))
    C, M, F = (int(v) for v in os.environ.get(
        "PROBE_CMF", "32,14,12").split(","))
    cap = float(os.environ.get("PROBE_CAP", "0.38"))
    fcap = float(os.environ.get("PROBE_FCAP", "0.23"))
    ocap = float(os.environ.get("PROBE_OCAP", "0")) or None

    family = os.environ.get("PROBE_FAMILY", "ngp")
    if family == "freq":
        # frequency flagship through the same raymarch machinery
        # (bench.py BENCH_MODEL=freq_rm)
        from nerf_replication_tpu.models.nerf.renderer.volume_renderer \
            import Renderer

        cfg = load_cfg_tree(os.path.join(ROOT, "configs/nerf/hard.yaml"),
                            default_cfg())
        ckpt = os.environ.get(
            "BENCH_FREQ_CKPT", os.path.join(ROOT, "data/pretrain/hard"))
        trained = load_pretrain(ckpt)
        if trained is None:
            sys.exit(f"probe_frame_parts: no checkpoint at {ckpt} -- "
                     "train it first (scripts/quality_run.py)")
        params = jax.tree.map(jnp.asarray, trained)
        bricks = "freq"
        net = make_network(cfg)
        settings = dataclasses.replace(
            RenderSettings.from_cfg(cfg), ray_chunk=8000,
            fast_sampling=False)
        apply_fn = Renderer(net, settings=settings, mesh=None).apply_fn
    else:
        cfg = load_cfg_tree(os.path.join(ROOT, "configs/nerf/hard_ngp.yaml"),
                            default_cfg())
        ckpt = os.environ.get(
            "BENCH_NGP_CKPT", os.path.join(ROOT, "data/pretrain/hard_ngp_b9"))
        trained = load_pretrain(ckpt)
        if trained is None:
            sys.exit(f"probe_frame_parts: no checkpoint at {ckpt} -- "
                     "train it first (scripts/quality_run.py)")
        params = jax.tree.map(jnp.asarray, trained)
        rows = params["params"]["xyz_encoder"]["table"].shape[0]
        bricks = bench._detect_bricks(rows, cfg.network.xyz_encoder)
        cfg.network.xyz_encoder["log2_bricks"] = bricks
        net = make_network(cfg)
        apply_fn = lambda p, pts, vd, m: net.apply(p, pts, vd, model=m)
        settings = dataclasses.replace(
            RenderSettings.from_cfg(cfg), ray_chunk=8000,
            fast_sampling=False)
    act = density_activation(settings.density_activation)

    def density_fn(p, pts):
        return act(apply_fn(p, pts[:, None, :],
                            jnp.zeros((1, 1, 3)), "fine")[:, 0, 3])

    occ_cache = bench._cache_path(
        "occ", ckpt, bench._ckpt_mtime(ckpt), 64, 0.02, bricks)
    cached = bench._cache_load(occ_cache)
    if cached is not None:
        grid, bbox = jnp.asarray(cached["grid"]), tuple(
            float(b) for b in cached["bbox"])
    else:
        from nerf_replication_tpu.ops.occupancy import build_occupancy_grid
        grid, bbox = build_occupancy_grid(density_fn, params,
                                          resolution=64, threshold=0.02,
                                          dilate=2)
    occupancy = (grid, bbox, 2)

    select_occupancy = None
    if os.environ.get("PROBE_SEL", "0") == "1":
        sel_cache = bench._cache_path(
            "occsel", ckpt, bench._ckpt_mtime(ckpt), 128, 0.02, bricks)
        cached = bench._cache_load(sel_cache)
        if cached is None:
            print("no cached 128^3 selection grid; run bench.py first")
            sys.exit(1)
        select_occupancy = (jnp.asarray(cached["grid"]), tuple(
            float(b) for b in cached["bbox"]))

    settings = dataclasses.replace(
        settings,
        ray_chunk=int(os.environ.get("PROBE_CHUNK", settings.ray_chunk)))
    psub = os.environ.get("PROBE_PSUB", "auto")
    psub = psub if psub == "auto" else int(psub)
    pstride = int(os.environ.get("PROBE_PSTRIDE", "2"))
    print(f"family={family} C,M,F={C},{M},{F} chunk={settings.ray_chunk} "
          f"sel={select_occupancy is not None} cap={cap}/{fcap} "
          f"probe={psub}/{pstride}")

    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
    pose = jnp.asarray(bench.orbit_poses(4)[0])

    def null_apply(_params, pts, viewdirs, model):
        return jnp.zeros(pts.shape[:-1] + (4,), jnp.float32)

    variants = {
        "probe": dict(stage="probe"),
        "coarse": dict(stage="coarse"),
        "full": dict(stage="full"),
        "full-null": dict(stage="full", apply=null_apply),
        "coarse-null": dict(stage="coarse", apply=null_apply),
    }
    only = os.environ.get("PROBE_VARIANTS", "")
    if only:
        variants = {k: v for k, v in variants.items()
                    if k in only.split(",")}
    results = {}
    for name, v in variants.items():
        fn = make_ngp_frame_renderer(
            v.get("apply", apply_fn), H, W, focal=focal,
            occupancy=occupancy, s=settings, n_candidates=C, n_coarse=M,
            n_fine=F, capacity=cap, fine_capacity=fcap,
            out_dtype=jnp.float32, stage=v["stage"],
            select_occupancy=select_occupancy, occ_capacity=ocap,
            probe_sub=psub, probe_stride=pstride)
        # device-fenced: reduce on device, fetch 4 bytes (a full-frame
        # f32 fetch would add its host transfer to every variant)
        timed = jax.jit(lambda p, c: jnp.sum(fn(p, c)))
        float(timed(params, pose))  # compile + warm
        times = []
        for _ in range(5):
            t0 = time.time()
            float(timed(params, pose))
            times.append(time.time() - t0)
        dt = float(np.median(times))
        results[name] = round(dt, 4)
        print(f"{name:12s} {dt * 1e3:8.1f} ms  (times="
              f"{[round(t * 1e3) for t in times]})", flush=True)

    d = results
    if all(k in d for k in ("probe", "coarse", "full", "full-null",
                            "coarse-null")):
        print(json.dumps({
            "probe+compact": d["probe"],
            "coarse_machinery": round(d["coarse-null"] - d["probe"], 4),
            "coarse_field_eval": round(d["coarse"] - d["coarse-null"], 4),
            "fine_machinery": round(d["full-null"] - d["coarse-null"], 4),
            "fine_field_eval": round(
                (d["full"] - d["full-null"])
                - (d["coarse"] - d["coarse-null"]), 4),
            "full": d["full"],
        }, indent=2))
    out_p = os.environ.get(
        "PROBE_OUT", os.path.join(ROOT, "result", "probe_frame_parts.json"))
    with open(out_p, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", out_p)


if __name__ == "__main__":
    main()
