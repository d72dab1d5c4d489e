#!/usr/bin/env python
"""Benchmark: 800x800 render fps on the flagship model, run on a GPU.

Prints ONE JSON line:
  {"metric": "render_fps_800x800", "value": N, "unit": "fps",
   "vs_baseline": N / 5.0, "platform": ..., "size": ...}
(baseline: the BASELINE.md north-star target of 5 fps at 800x800).

A backend that fails to start, or an accelerator that is missing (JAX
landing on the CPU without ``JAX_PLATFORMS=cpu`` having asked for it),
ends the run with a non-zero exit and no metric.

Three model modes (BENCH_MODEL env, default: ngp when an NGP checkpoint
exists, else freq):

* ngp  — the brick-hash-grid instant-ngp-class flagship through the
  occupancy-raymarch renderer (ngp_renderer.py): span-bounded
  occupied-selected sampling, two-stage compaction. An in-bench QUALITY
  GATE renders one pose on the dense hierarchical path and walks a
  sample-count ladder until the fast frame is within BENCH_NGP_GATE dB
  (default 40) of the dense frame — the headline number is always
  backed by a measured fidelity check.
* freq — the 8x256 frequency flagship through the compacted frame
  renderer (dense-exact for active rays).
* freq_rm — the same frequency flagship through the occupancy-raymarch
  frame path (the NGP machinery is model-agnostic): ~26 pts/ray instead
  of 192, same GT-drop/frame-vs-dense quality gate as ngp mode.
  Knobs: BENCH_FREQ_CFG, BENCH_FREQ_CKPT + the shared ngp gate knobs.

Env knobs (shared): BENCH_SIZE, BENCH_FRAMES.
freq: BENCH_FAST, BENCH_CAPACITY, BENCH_COARSE_CAPACITY, BENCH_OCC,
      BENCH_RAY_CHUNK, BENCH_ERT, BENCH_ERT_FRAC.
ngp:  BENCH_NGP_CFG, BENCH_NGP_CKPT, BENCH_NGP_GATE, BENCH_NGP_LADDER
      ("C,M,F;C,M,F;..."), BENCH_OCC_RES, BENCH_OCC_THRESH,
      BENCH_RAY_CHUNK.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# before the backend probe: the package sets XLA's GPU flags on import
import nerf_replication_tpu  # noqa: E402,F401

ROOT = os.path.dirname(os.path.abspath(__file__))


_TAG = os.environ.get("BENCH_TAG", "r5")
_JSON_PATHS = [os.path.join(ROOT, "result", f"bench_{_TAG}.json")]
_LOG_PATH = os.path.join(ROOT, "result", f"bench_{_TAG}.log")


class _TeeStderr:
    """Duplicate stderr into result/bench_<tag>.log so every run —
    including one that is killed — leaves its log behind."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "w")
        self._orig = sys.stderr

    def write(self, s):
        self._orig.write(s)
        self._f.write(s)
        self._f.flush()

    def flush(self):
        self._orig.flush()
        self._f.flush()

    def __getattr__(self, name):
        # isatty/fileno/encoding/...: libraries that probe stderr
        # (warnings, absl, tqdm) must see a full file-like object
        return getattr(self._orig, name)


def _emit_obj(obj):
    """Print the metric line AND persist it to result/ unconditionally."""
    line = json.dumps(obj)
    print(line, flush=True)
    for p in _JSON_PATHS:
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w") as f:
                f.write(line + "\n")
        except OSError as e:
            print(f"bench: cannot persist {p}: {e}", file=sys.stderr)
    try:
        with open(os.path.join(ROOT, "result", "bench_history.jsonl"),
                  "a") as f:
            f.write(json.dumps({**obj, "ts": time.time(),
                                "tag": _TAG}) + "\n")
    except OSError:
        pass


def _probe_backend():
    """Initialize the JAX backend. Returns the platform name, or None if
    init failed."""
    import jax
    try:
        platform = jax.devices()[0].platform
    except Exception as e:  # noqa: BLE001 — backend init failure
        log(f"bench: backend init failed: {type(e).__name__}: {e}")
        return None
    log(f"bench: backend platform = {platform}")
    return platform


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _ckpt_mtime(ckpt_dir):
    try:
        return max((os.path.getmtime(os.path.join(ckpt_dir, f))
                    for f in os.listdir(ckpt_dir)), default=0.0)
    except OSError:
        return 0.0


def _cache_path(kind, *key):
    """result/bench_cache/<kind>-<hash>.npz for expensive gate inputs
    (occupancy grid, dense reference frames) that depend only on the
    checkpoint + render geometry. Keyed by checkpoint mtime, so a
    retrain invalidates. BENCH_CACHE=0 disables."""
    import hashlib
    h = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
    d = os.path.join(ROOT, "result", "bench_cache")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{kind}-{h}.npz")


def _cache_load(path):
    import numpy as np
    if os.environ.get("BENCH_CACHE", "1") != "1":
        return None
    try:
        if os.path.exists(path):
            return np.load(path)
    except Exception as e:  # noqa: BLE001 — cache is best-effort
        log(f"bench cache: ignoring unreadable {path}: {e}")
    return None


def _cache_save(path, **arrs):
    import numpy as np
    if os.environ.get("BENCH_CACHE", "1") != "1":
        return
    np.savez(path, **arrs)


def emit(fps, gate=None):
    import jax

    platform = jax.default_backend()
    obj = {
        "metric": "render_fps_800x800",
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 5.0, 3),
        "platform": platform,
        "size": int(os.environ.get("BENCH_SIZE", "800")),
    }
    if gate:
        obj["gate"] = gate
    _emit_obj(obj)


def orbit_poses(frames):
    import numpy as np

    from nerf_replication_tpu.utils.synthetic_scene import look_at_pose

    return [look_at_pose(np.array(
        [4.0 * np.cos(a), 4.0 * np.sin(a), 1.5], dtype=np.float32))
        for a in np.linspace(0, 2 * np.pi, frames + 1)[:-1]]


def time_frames(frame_fn, params, poses, fetch):
    """Throughput timing with one-frame overlap: dispatch frame i+1
    before fetching frame i (the host download rides under the next
    frame's device work)."""
    import numpy as np
    pending = []
    t0 = time.time()
    for pose in poses:
        pending.append(frame_fn(params, pose))
        if len(pending) > 1:
            fetch(pending.pop(0))
    while pending:
        fetch(pending.pop(0))
    wall = time.time() - t0
    per = wall / len(poses)
    log(f"frames: {len(poses)} in {wall:.2f}s ({per:.3f}s/frame)")
    return 1.0 / per


def ray_grid(H, W, focal, c2w):
    import numpy as np
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    dirs = np.stack([(us.ravel() - W / 2.0) / focal,
                     -(vs.ravel() - H / 2.0) / focal,
                     -np.ones(H * W, np.float32)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def _detect_bricks(table_rows, enc_cfg):
    """Infer log2_bricks from a checkpoint's table row count."""
    from nerf_replication_tpu.ops.pallas.hashgrid_kernel import (
        make_brick_layout,
    )
    for b in (12, 11, 10, 9, 8, 13, 14):
        lay = make_brick_layout(
            int(enc_cfg.get("num_levels", 16)),
            int(enc_cfg.get("base_resolution", 16)),
            int(enc_cfg.get("desired_resolution", -1)),
            log2_bricks=b)
        if lay.n_rows == table_rows:
            return b
    return None


def run_ngp():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
        RenderSettings,
    )
    from nerf_replication_tpu.utils.ckpt_utils import load_pretrain

    cfg_file = os.environ.get("BENCH_NGP_CFG", "configs/nerf/hard_ngp.yaml")
    cfg = load_cfg_tree(os.path.join(ROOT, cfg_file), default_cfg())
    ckpt = os.environ.get("BENCH_NGP_CKPT", "") or _ngp_checkpoint()
    trained = load_pretrain(ckpt) if ckpt else None
    if trained is None:
        raise FileNotFoundError(f"ngp bench: no NGP checkpoint ({ckpt!r})")
    params = jax.tree.map(jnp.asarray, trained)
    rows = params["params"]["xyz_encoder"]["table"].shape[0]
    bricks = _detect_bricks(rows, cfg.network.xyz_encoder)
    if bricks is None:
        raise ValueError(f"ngp bench: table rows {rows} match no "
                         "log2_bricks setting of the config")
    cfg.network.xyz_encoder["log2_bricks"] = bricks
    log(f"ngp bench: checkpoint {ckpt} (log2_bricks={bricks})")

    net = make_network(cfg)
    settings = dataclasses.replace(
        RenderSettings.from_cfg(cfg),
        ray_chunk=int(os.environ.get(
            "BENCH_RAY_CHUNK", cfg.task_arg.get("ray_chunk", 8000))),
        fast_sampling=False)
    apply_fn = Renderer(net, settings=settings, mesh=None).apply_fn
    _raymarch_bench(cfg, net, params, settings, apply_fn, ckpt,
                    cache_key=bricks, family="ngp")


def run_freq_raymarch():
    """The 8x256 frequency flagship through the occupancy-raymarch frame
    path (BENCH_MODEL=freq_rm): same gate/ladder as the NGP mode, but
    the field is the paper NeRF MLP. The raymarch path needs ~26 pts/ray
    instead of the compacted dense path's 192."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nerf_replication_tpu.config import default_cfg, load_cfg_tree
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
        RenderSettings,
    )
    from nerf_replication_tpu.utils.ckpt_utils import load_pretrain

    cfg_file = os.environ.get("BENCH_FREQ_CFG", "configs/nerf/hard.yaml")
    cfg = load_cfg_tree(os.path.join(ROOT, cfg_file), default_cfg())
    ckpt = os.environ.get(
        "BENCH_FREQ_CKPT", os.path.join(ROOT, "data", "pretrain", "hard"))
    trained = load_pretrain(ckpt) if os.path.isdir(ckpt) else None
    if trained is None:
        raise FileNotFoundError(f"freq_rm bench: no checkpoint at {ckpt}")
    params = jax.tree.map(jnp.asarray, trained)
    net = make_network(cfg)
    # the raymarch path carries ~10 samples/ray (vs the NGP dense path's
    # 192 that forced the 8k tile), so the flagship 40k ray tile fits
    settings = dataclasses.replace(
        RenderSettings.from_cfg(cfg),
        ray_chunk=int(os.environ.get(
            "BENCH_RAY_CHUNK", cfg.task_arg.get("ray_chunk", 40000))),
        fast_sampling=False)
    apply_fn = Renderer(net, settings=settings, mesh=None).apply_fn
    log(f"freq_rm bench: checkpoint {ckpt}")
    _raymarch_bench(cfg, net, params, settings, apply_fn, ckpt,
                    cache_key="freq", family="freq_rm")


def _raymarch_bench(cfg, net, params, settings, apply_fn, ckpt, cache_key,
                    family):
    """Shared occupancy-raymarch benchmark: grid build (cached), dense
    reference (cached), GT-drop/frame-vs-dense quality gate over the
    sample-count ladder with autocap, timed frames, metric emission."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerf_replication_tpu.evaluators.metrics import psnr_uint8
    from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
        make_ngp_frame_renderer,
    )
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
    )
    from nerf_replication_tpu.ops.occupancy import build_occupancy_grid
    from nerf_replication_tpu.ops.ray_ops import density_activation

    H = W = int(os.environ.get("BENCH_SIZE", "800"))
    frames = int(os.environ.get("BENCH_FRAMES", "4"))
    gate_db = float(os.environ.get("BENCH_NGP_GATE", "40"))
    act = density_activation(settings.density_activation)

    def density_fn(p, pts):
        return act(apply_fn(p, pts[:, None, :],
                            jnp.zeros((1, 1, 3)), "fine")[:, 0, 3])

    occ_res = int(os.environ.get("BENCH_OCC_RES", "64"))
    occ_thresh = float(os.environ.get("BENCH_OCC_THRESH", "0.02"))
    ck_mtime = _ckpt_mtime(ckpt)
    grid_cache = _cache_path(
        "occ", ckpt, ck_mtime, occ_res, occ_thresh, cache_key)
    cached = _cache_load(grid_cache)
    t0 = time.time()
    if cached is not None:
        grid, bbox = jnp.asarray(cached["grid"]), tuple(
            float(b) for b in cached["bbox"])
        log(f"occupancy grid: {float(grid.mean()):.3f} occupied (cached)")
    else:
        grid, bbox = build_occupancy_grid(
            density_fn, params, resolution=occ_res,
            threshold=occ_thresh, dilate=2)
        _cache_save(grid_cache, grid=np.asarray(grid),
                    bbox=np.asarray(bbox, np.float64))
        log(f"occupancy grid: {float(grid.mean()):.3f} occupied, built "
            f"in {time.time() - t0:.1f}s")
    occupancy = (grid, bbox, 2)

    # finer low-dilation SELECTION grid (candidate filtering only; the
    # span probe stays on the 64^3 grid — see ngp_renderer docstring)
    sel_res = int(os.environ.get("BENCH_SEL_RES", "128"))
    select_occupancy = None
    if sel_res > grid.shape[0]:
        sel_cache = _cache_path(
            "occsel", ckpt, ck_mtime, sel_res, occ_thresh, cache_key)
        cached = _cache_load(sel_cache)
        if cached is not None:
            select_occupancy = (jnp.asarray(cached["grid"]), tuple(
                float(b) for b in cached["bbox"]))
            log(f"selection grid: {float(select_occupancy[0].mean()):.3f}"
                " occupied (cached)")
        else:
            t0 = time.time()
            sgrid, sbbox = build_occupancy_grid(
                density_fn, params, resolution=sel_res,
                threshold=occ_thresh, dilate=1)
            _cache_save(sel_cache, grid=np.asarray(sgrid),
                        bbox=np.asarray(sbbox, np.float64))
            select_occupancy = (sgrid, sbbox)
            log(f"selection grid: {float(sgrid.mean()):.3f} occupied, "
                f"built in {time.time() - t0:.1f}s")

    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
    poses = orbit_poses(frames)

    # --- quality-gate targets -----------------------------------------
    # Primary gate: fast-path test
    # PSNR within BENCH_NGP_GATE_DROP dB (default 0.2) of the DENSE
    # render's test PSNR on real GT views. Falls back to the
    # frame-vs-dense >= BENCH_NGP_GATE dB criterion when the scene's
    # test split is unavailable at bench size.
    gate_drop = float(os.environ.get("BENCH_NGP_GATE_DROP", "0.2"))
    n_gt = int(os.environ.get("BENCH_NGP_GT_VIEWS", "2"))
    gt_imgs, gt_poses = [], []
    try:
        from nerf_replication_tpu.datasets.nerf.blender import (
            Dataset as BlenderDS,
        )
        ds = BlenderDS(cfg, **{**dict(cfg.test_dataset), "split": "test"})
        if ds.H == H and ds.W == W and len(ds.images) > 0:
            stride = max(1, len(ds.images) // n_gt)
            idx = list(range(0, len(ds.images), stride))[:n_gt]
            gt_imgs = [ds.images[i] for i in idx]
            gt_poses = [ds.poses[i] for i in idx]
            focal = float(ds.focal)
            log(f"gate: {len(idx)} GT test views {idx} "
                f"(drop budget {gate_drop} dB)")
    except Exception as e:  # noqa: BLE001 — gate falls back, bench runs
        log(f"gate: no GT test split ({e})")
    if not gt_imgs:
        # the frame-vs-dense criterion is weaker than
        # the GT-drop criterion — make the downgrade impossible to miss
        log("WARNING: no GT views at bench size — quality gate degrades "
            f"to the frame-vs-dense >= {gate_db} dB criterion; numbers "
            "gated this way are marked gate=frame-vs-dense in the JSON")

    # --- dense reference frames, product dense math --------------------
    renderer = Renderer(net, settings=settings, mesh=None)
    gate_poses = gt_poses if gt_imgs else [poses[0]]
    dense_cache = _cache_path(
        "dense", ckpt, ck_mtime, H, W, len(gate_poses), round(focal, 3),
        settings.N_samples, settings.N_importance)
    cached = _cache_load(dense_cache)
    if cached is not None:
        dense_imgs = [cached[f"img{i}"] for i in range(len(gate_poses))]
        dense_s = float(cached["dense_s"])
        log(f"dense reference: {dense_s:.1f}s/frame (cached)")
    else:
        dense_imgs = []
        t0 = time.time()
        for pose in gate_poses:
            ro0, rd0 = ray_grid(H, W, focal, pose)
            dense = renderer.render_rays_batch(params, ro0, rd0)
            dense_imgs.append(
                np.clip(np.asarray(dense["rgb"]), 0, 1).reshape(H, W, 3))
        dense_s = (time.time() - t0) / len(gate_poses)
        _cache_save(dense_cache, dense_s=dense_s,
                    **{f"img{i}": im for i, im in enumerate(dense_imgs)})
        log(f"dense reference: {dense_s:.1f}s/frame "
            f"({1 / dense_s:.3f} fps)")
    dense_psnr = None
    if gt_imgs:
        dense_psnr = float(np.mean([
            psnr_uint8(d, g) for d, g in zip(dense_imgs, gt_imgs)]))
        log(f"dense test PSNR: {dense_psnr:.2f} dB "
            f"(fast path must reach {dense_psnr - gate_drop:.2f})")

    def fetch(res):
        img = res[0] if isinstance(res, tuple) else res
        return np.asarray(img)

    def gate_psnr(fn, label, first_img=None):
        """Quality-gate a candidate renderer: GT-drop criterion when
        test views exist, else frame-vs-dense PSNR. Returns
        (passed, q_vs_dense_frame)."""
        imgs = []
        for i, pose in enumerate(gate_poses):
            if i == 0 and first_img is not None:
                imgs.append(first_img)
            else:
                im, _ = fn(params, jnp.asarray(pose))
                imgs.append(np.asarray(im))
        norm = lambda im: im.reshape(H, W, 3).astype(np.float32) / 255.0
        q = psnr_uint8(norm(imgs[0]), dense_imgs[0])
        if gt_imgs:
            fast = float(np.mean([
                psnr_uint8(norm(im), gt)
                for im, gt in zip(imgs, gt_imgs)]))
            drop = dense_psnr - fast
            log(f"{label}: test {fast:.2f} dB (drop {drop:+.2f} vs "
                f"dense, budget {gate_drop}; {q:.1f} dB vs dense frame)")
            return drop <= gate_drop, q
        log(f"{label}: {q:.1f} dB vs dense (gate {gate_db})")
        return q >= gate_db, q

    ladder_env = os.environ.get(
        "BENCH_NGP_LADDER",
        "16,8,6;24,10,8;32,10,10;32,12,10;32,12,12;32,14,12;"
        "40,16,14;48,20,16;64,32,24")
    ladder = [tuple(int(v) for v in step.split(","))
              for step in ladder_env.split(";") if step]
    capacity = float(os.environ.get("BENCH_CAPACITY", "0.35"))
    fine_cap = None
    occ_cap = capacity
    frame_fn = None
    chosen = None
    probe_sub = os.environ.get("BENCH_PROBE_SUB", "auto")
    probe_sub = probe_sub if probe_sub == "auto" else int(probe_sub)
    probe_stride = int(os.environ.get("BENCH_PROBE_STRIDE", "2"))
    # ladder cache: start from the last passing step for this checkpoint
    # + geometry, skipping the failed lower steps entirely (each ladder
    # step is a fresh compile).
    # The gate is still verified every run — only the walk is skipped.
    # key includes the probe/selection/autocap knobs: a ladder step (and
    # its measured caps) that passed under one acceleration setting must
    # not seed a run under another
    # the ladder string itself is part of the key: inserting a new
    # intermediate step must re-walk the ladder, not resume at a
    # coarser cached pass that would mask the cheaper step
    lad_cache = _cache_path(
        "ladder", ckpt, ck_mtime, H, W, family, probe_sub, probe_stride,
        sel_res, os.environ.get("BENCH_AUTOCAP", "1"), ladder_env)
    lcached = _cache_load(lad_cache)
    if lcached is not None:
        c0 = tuple(int(v) for v in lcached["cmf"])
        ladder = [c0] + [s for s in ladder if s != c0]
        capacity = float(lcached["cap"])
        occ_cap = float(lcached["ocap"])
        fc = float(lcached["fcap"])
        fine_cap = None if fc < 0 else fc
        log(f"ladder cache: starting at C,M,F={c0} (caps "
            f"{capacity:.2f}/{occ_cap:.2f}/{fc:.2f})")
    for C, M, F in ladder:
        def build(cap, fcap, ocap, C=C, M=M, F=F):
            return make_ngp_frame_renderer(
                apply_fn, H, W, focal=focal, occupancy=occupancy,
                s=settings, n_candidates=C, n_coarse=M, n_fine=F,
                capacity=cap, fine_capacity=fcap, out_dtype=jnp.uint8,
                return_stats=True, select_occupancy=select_occupancy,
                occ_capacity=ocap, probe_sub=probe_sub,
                probe_stride=probe_stride)

        fn = build(capacity, fine_cap, occ_cap)
        img, stats = fn(params, jnp.asarray(gate_poses[0]))
        img = np.asarray(img)
        stats = {k: float(v) for k, v in stats.items()}
        if os.environ.get("BENCH_AUTOCAP", "1") == "1":
            # right-size the static ray budgets to the measured frame:
            # active rays bound the coarse selection, rays with >=1
            # occupied candidate bound the coarse FIELD EVAL, rays with
            # non-trivial coarse opacity bound the fine pass
            active_frac = stats["active_rays"] / (H * W)
            new_cap = min(1.0, active_frac * 1.1 + 0.02)
            new_occ = min(new_cap,
                          stats["occ_rays"] / (H * W) * 1.15 + 0.01)
            new_fine = min(new_occ,
                           stats["nontrivial_rays"] / (H * W) * 1.15
                           + 0.01)
            if (abs(new_cap - capacity) > 0.015
                    or fine_cap is None
                    or abs(new_occ - occ_cap) > 0.015
                    or abs(new_fine - fine_cap) > 0.015):
                log(f"autocap: active {active_frac:.3f} -> cap "
                    f"{new_cap:.2f}, occ {new_occ:.2f}, "
                    f"fine {new_fine:.2f}")
                capacity, occ_cap, fine_cap = new_cap, new_occ, new_fine
                fn = build(capacity, fine_cap, occ_cap)
                img, stats = fn(params, jnp.asarray(gate_poses[0]))
                img = np.asarray(img)
                stats = {k: float(v) for k, v in stats.items()}
        log(f"ladder C={C} M={M} F={F}: stats={stats}")
        passed, q = gate_psnr(fn, f"ladder C={C} M={M} F={F}",
                              first_img=img)
        if passed:
            frame_fn, chosen = fn, (C, M, F, q)
            break
    if frame_fn is None and (probe_sub != 4 or probe_stride != 1):
        # the probe acceleration (auto-sub lattice / stride-2 depth
        # steps) should be quality-neutral, but never let it cost the
        # gate: retry the passing r3 ladder step conservatively
        log("ngp gate: no ladder step passed with accelerated probe; "
            "retrying with probe_sub=4 stride=1")
        probe_sub, probe_stride = 4, 1
        for C, M, F in ladder:
            fn = make_ngp_frame_renderer(
                apply_fn, H, W, focal=focal, occupancy=occupancy,
                s=settings, n_candidates=C, n_coarse=M, n_fine=F,
                capacity=capacity, fine_capacity=fine_cap,
                out_dtype=jnp.uint8, return_stats=True,
                select_occupancy=select_occupancy, occ_capacity=occ_cap)
            passed, q = gate_psnr(
                fn, f"ladder(conservative) C={C} M={M} F={F}")
            if passed:
                frame_fn, chosen = fn, (C, M, F, q)
                break
    if frame_fn is None:
        log("ngp gate: no ladder step passed; reporting dense-path fps")
        emit(1.0 / dense_s,
             gate={"kind": "dense-fallback", "family": family})
        return
    log(f"ngp gate PASSED at C,M,F={chosen[:3]} "
        f"({chosen[3]:.1f} dB vs dense frame)")
    _cache_save(lad_cache, cmf=np.asarray(chosen[:3], np.int32),
                cap=capacity, ocap=occ_cap,
                fcap=-1.0 if fine_cap is None else fine_cap)

    fps = time_frames(frame_fn, params, [jnp.asarray(p) for p in poses],
                      fetch)
    emit(fps, gate={
        "kind": "gt-drop" if gt_imgs else "frame-vs-dense",
        "family": family,
        "ladder": list(chosen[:3]),
        "q_vs_dense_db": round(chosen[3], 2),
        **({"drop_budget_db": gate_drop, "dense_test_psnr":
            round(dense_psnr, 2)} if gt_imgs else
           {"gate_db": gate_db})})


def run_freq():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _flagship
    from nerf_replication_tpu.models.nerf.renderer.volume_renderer import (
        Renderer,
    )
    from nerf_replication_tpu.ops.ray_ops import density_activation
    from nerf_replication_tpu.utils.ckpt_utils import load_pretrain

    H = W = int(os.environ.get("BENCH_SIZE", "800"))
    frames = int(os.environ.get("BENCH_FRAMES", "4"))
    fast = os.environ.get("BENCH_FAST", "1") == "1"
    use_occ = os.environ.get("BENCH_OCC", "1") == "1"

    cfg, net, params, settings, apply_fn = _flagship()
    ray_chunk = int(os.environ.get("BENCH_RAY_CHUNK",
                                   cfg.task_arg.get("ray_chunk", 40000)))

    # trained flagship (quality_run.py artifact): enables content-true
    # occupancy culling and a softplus density matching its training
    pre_dir = os.path.join(ROOT, "data", "pretrain", "hard")
    trained = load_pretrain(pre_dir) if os.path.isdir(pre_dir) else None
    density_act = "relu"
    if trained is not None:
        params = jax.tree.map(jnp.asarray, trained)
        density_act = "softplus"  # hard.yaml task_arg.density_activation
        log("bench: using trained 'hard' checkpoint")
    else:
        use_occ = False
        log("bench: no trained checkpoint; random params, static capacity")

    # BENCH_ERT unset -> try 2-segment surface-split ERT behind an
    # automated fidelity gate; explicit value -> obey
    ert_env = os.environ.get("BENCH_ERT", "")
    settings = dataclasses.replace(
        settings, ray_chunk=ray_chunk, fast_sampling=fast,
        density_activation=density_act,
        ert_segments=int(ert_env) if ert_env else 1,
        ert_frac=tuple(float(f) for f in
                       os.environ.get("BENCH_ERT_FRAC", "").split(",")
                       if f))
    renderer = Renderer(net, settings=settings, mesh=None)

    occupancy = None
    if use_occ and fast:
        from nerf_replication_tpu.ops.occupancy import build_occupancy_grid

        act = density_activation(density_act)

        def density_fn(p, pts):
            return act(apply_fn(p, pts[:, None, :],
                                jnp.zeros((1, 1, 3)), "fine")[:, 0, 3])

        t0 = time.time()
        grid, bbox = build_occupancy_grid(
            density_fn, params,
            resolution=int(os.environ.get("BENCH_OCC_RES", "64")),
            threshold=float(os.environ.get("BENCH_OCC_THRESH", "0.05")),
            dilate=2)
        log(f"occupancy grid: {float(grid.mean()):.3f} occupied, built "
            f"in {time.time() - t0:.1f}s")
        occupancy = (grid, bbox, 2)

    capacity = float(os.environ.get("BENCH_CAPACITY",
                                    "0.35" if occupancy else "0.5"))
    coarse_capacity = float(os.environ.get("BENCH_COARSE_CAPACITY", "0.4"))
    focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)

    def build(cap, ccap):
        return renderer.make_frame_renderer(
            H, W, focal=focal,
            capacity=cap if fast else 1.0,
            coarse_capacity=ccap if fast else 1.0,
            out_dtype=jnp.uint8, occupancy=occupancy, return_stats=True)

    frame_fn = build(capacity, coarse_capacity)
    poses = orbit_poses(frames)

    def fetch(res):
        # host transfer of the frame: the completion fence
        img = res[0] if isinstance(res, tuple) else res
        return np.asarray(img)

    # warmup / compile; then right-size the static ray budgets to the
    # measured scene coverage (BENCH_AUTOCAP=0 keeps the env knobs)
    img, stats = frame_fn(params, jnp.asarray(poses[0]))
    fetch((img,))
    stats = {k: int(v) for k, v in stats.items()}
    log(f"frame stats: {stats}")
    if (occupancy is not None and fast
            and os.environ.get("BENCH_AUTOCAP", "1") == "1"):
        active_frac = stats["active_rays"] / (H * W)
        new_ccap = min(1.0, active_frac * 1.15 + 0.02)
        new_cap = min(new_ccap, active_frac * 1.10 + 0.02)
        if abs(new_ccap - coarse_capacity) > 0.03 or \
                abs(new_cap - capacity) > 0.03:
            log(f"autocap: active {active_frac:.3f} -> coarse "
                f"{new_ccap:.2f}, fine {new_cap:.2f}")
            capacity, coarse_capacity = new_cap, new_ccap
            frame_fn = build(capacity, coarse_capacity)
            img, stats = frame_fn(params, jnp.asarray(poses[0]))
            fetch((img,))
            stats = {k: int(v) for k, v in stats.items()}
            log(f"frame stats: {stats}")
    if stats.get("coarse_overflow", 0) or stats.get("fine_overflow", 0):
        log("WARNING: capacity overflow — some real rays rendered "
            "coarse-only or as background; raise BENCH_CAPACITY/"
            "BENCH_COARSE_CAPACITY for full quality")

    gate_info = {"kind": "freq", "ert": "env" if ert_env else "off"}
    if ert_env == "" and occupancy is not None and fast:
        # automated ERT gate: promote 2-segment surface-split ERT only
        # when the rendered frame stays within BENCH_ERT_GATE dB of the
        # dense frame (scripts/ert_fidelity.py logic in the product path)
        from nerf_replication_tpu.evaluators.metrics import psnr_uint8

        gate = float(os.environ.get("BENCH_ERT_GATE", "45"))
        dense_img = fetch(frame_fn(params, jnp.asarray(poses[0])))
        renderer.settings = dataclasses.replace(
            renderer.settings, ert_segments=2)
        ert_fn = build(capacity, coarse_capacity)
        ert_img = fetch(ert_fn(params, jnp.asarray(poses[0])))
        q = psnr_uint8(ert_img.astype(np.float32) / 255.0,
                       dense_img.astype(np.float32) / 255.0)
        if q >= gate:
            log(f"ERT gate PASSED ({q:.1f} dB >= {gate}): 2-segment ERT on")
            frame_fn = ert_fn
            gate_info = {"kind": "freq-ert", "q_vs_dense_db": round(q, 1),
                         "gate_db": gate}
        else:
            log(f"ERT gate failed ({q:.1f} dB < {gate}): dense path kept")
            renderer.settings = dataclasses.replace(
                renderer.settings, ert_segments=1)
            gate_info = {"kind": "freq-dense", "q_vs_dense_db": round(q, 1)}

    fps = time_frames(frame_fn, params, [jnp.asarray(p) for p in poses],
                      fetch)
    emit(fps, gate=gate_info)


def _ngp_checkpoint() -> str:
    """The first committed NGP checkpoint, smaller tables first."""
    for cand in ("hard_ngp_b9", "hard_ngp_b10", "hard_ngp",
                 "med_ngp_b9", "med_ngp_b10", "med_ngp"):
        d = os.path.join(ROOT, "data", "pretrain", cand)
        if os.path.isdir(d):
            return d
    return ""


def main():
    sys.stderr = _TeeStderr(_LOG_PATH)
    platform = _probe_backend()
    if platform is None:
        sys.exit("bench: the JAX backend failed to initialize")
    if platform == "cpu" and "cpu" not in os.environ.get("JAX_PLATFORMS", ""):
        # an accelerator that failed to start leaves JAX on the CPU; a
        # dense gate render at 800^2 takes hours there
        sys.exit("bench: no accelerator (JAX fell back to the CPU); set "
                 "JAX_PLATFORMS=cpu to run on the CPU on purpose")

    from nerf_replication_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    mode = os.environ.get("BENCH_MODEL", "") or (
        "ngp" if _ngp_checkpoint() else "freq")
    log(f"bench mode: {mode}")
    _JSON_PATHS.append(os.path.join(
        ROOT, "result", f"bench_{mode}_{_TAG}.json"))
    if mode == "ngp":
        run_ngp()
    elif mode == "freq_rm":
        run_freq_raymarch()
    else:
        run_freq()
    import shutil

    shutil.copyfile(_LOG_PATH, os.path.join(
        ROOT, "result", f"bench_{mode}_{_TAG}.log"))


if __name__ == "__main__":
    main()
