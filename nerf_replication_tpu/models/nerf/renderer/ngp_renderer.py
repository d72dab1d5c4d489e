"""Occupancy-raymarch renderer for the brick-NGP model family.

The reference's CUDA hash encoder exists to serve instant-ngp-style
models whose *renderer* marches rays through an occupancy bitfield with
early termination (hashencoder.cu:78-197 is the encode half; the
raymarch half lives upstream in instant-ngp). This module is the
whole: static-shape compaction instead of per-ray dynamic marching, one
jitted program per frame.

Pipeline (all shapes compile-time static):

1. device-side ray generation from the camera pose;
2. occupied-span probe on a subsampled pixel lattice
   (:func:`...ops.occupancy.ray_spans`): per-ray ``[t_enter, t_exit]``
   bounds from the cached occupancy grid — background rays composite as
   pure background without ever touching the MLP;
3. active-ray compaction (stable argsort, static capacity);
4. span-bounded coarse pass: ``n_candidates`` uniform positions inside
   the span, keep the ``n_coarse`` landing in occupied cells (lax.sort
   selection — empty pockets inside the span are skipped exactly where
   the field is ~zero), evaluate, composite with gap-capped deltas;
5. opacity compaction (top-k by coarse acc, static capacity);
6. inverse-CDF fine samples in up to TWO rounds; evaluate ONLY the new
   fine points; merge with the saved coarse raws by a multi-operand
   ``lax.sort`` (no re-evaluation of coarse positions, no gathers);
   composite;
7. scatter back, optional uint8 output.

``n_fine2`` > 0 adds a second importance round: re-derive the CDF
from the merged round-1 weights and concentrate ``n_fine2`` more
samples where transmittance actually drops. Measured on the trained
hard scene it is NOT better than spending the same extra samples in
one round (24,10,8+8 → 0.27 dB drop vs 32,14,12+0 → 0.00), so the
default stays 0; the knob remains for fields with razor-thin softplus
shells where one round cannot bracket the surface. (The ~35 dB
fast-vs-dense error floor that motivated it was actually a
reduced-precision ray-direction matmul, now pinned to f32.)

Sample counts: active rays pay ``n_coarse + n_fine`` MLP/encode points
(vs ``N_samples + (N_samples + N_importance)`` on the dense path — 3-6x
fewer), and culled rays pay nothing.

Differences vs the dense hierarchical render (quality-gated in
bench.py against it):
* every evaluation uses the FINE branch (the dense path's final image
  is the fine composite; mixing branches would bias the merge);
* sampling is restricted to the grid-occupied span (conservative:
  dilated grid, threshold ~alpha-negligible);
* the far-tail delta is the local sample spacing, not the reference's
  1e10 (volume_renderer.py:80-95) — a span-bounded last sample sits ON
  the surface, where an infinite tail would absorb everything;
* deltas across skipped-empty gaps are capped at twice the candidate
  spacing (the field is ~zero there; an uncapped delta would bleed the
  pre-gap sample's density across the gap).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ....ops.occupancy import points_occupied, ray_spans
from ....ops.ray_ops import camera_rays, density_activation, sample_pdf
from .volume_renderer import RenderSettings


def select_coarse_samples(t_cand, occ, M: int):
    """Keep ``M`` of the depth-ordered candidates ``t_cand`` (c, C) with
    coverage: occupied-first (ascending depth within each class),
    striding evenly through the occupied pool — a plain top-M would
    cluster at the span front whenever more than M candidates are
    occupied. Rank-by-cumsum IS that stable two-class sort permutation,
    so no lax.sort is needed: occupied candidate k gets rank
    cumsum(occ)[k], unoccupied ranks follow after n_occ. Returns the
    selected depths (c, M), ascending; each is a candidate taken by a
    gather, so exactly."""
    occ_i = occ.astype(jnp.int32)
    n_occ = occ_i.sum(-1)                                         # (c,)
    rank = jnp.where(occ, jnp.cumsum(occ_i, axis=-1),
                     n_occ[:, None] + jnp.cumsum(1 - occ_i, axis=-1))
    pool = jnp.maximum(n_occ, M)
    j = jnp.arange(M, dtype=jnp.int32)
    pos = (j[None, :] * pool[:, None]) // M + 1                   # (c, M)
    # ranks are a permutation of 1..C and pos <= C, so each pos names
    # exactly one candidate
    k_sel = jnp.argmax(pos[..., None] == rank[:, None, :], axis=-1)
    return jax.lax.sort(jnp.take_along_axis(t_cand, k_sel, axis=-1),
                        dimension=-1)


def _gap_capped_weights(sigma, t, span, n_candidates, act, cap_mult=2.0):
    """Compositing weights over non-uniformly selected samples.

    ``delta_i = min(t_{i+1} - t_i, cap)`` with ``cap = cap_mult x
    span / n_candidates`` (the candidate spacing); the tail delta is the
    cap. Gaps wider than the cap are skipped-empty regions (see module
    doc); capping approximates zero absorption across them.
    """
    cap = (cap_mult * span / n_candidates)[..., None]
    delta = jnp.concatenate(
        [t[..., 1:] - t[..., :-1],
         jnp.broadcast_to(cap, t[..., :1].shape)], axis=-1)
    delta = jnp.minimum(delta, cap)
    alpha = 1.0 - jnp.exp(-act(sigma) * delta)
    trans = jnp.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = jnp.concatenate(
        [jnp.ones_like(trans[..., :1]), trans[..., :-1]], axis=-1)
    return alpha * trans


def make_ngp_frame_renderer(
    apply_fn, H: int, W: int, focal: float, occupancy,
    s: RenderSettings, n_candidates: int = 32, n_coarse: int = 16,
    n_fine: int = 16, capacity: float = 0.35,
    fine_capacity: float | None = None, probe_sub: int | str = 4,
    out_dtype=jnp.uint8, return_stats: bool = False, mesh=None,
    return_depth: bool = False, n_fine2: int = 0, stage: str = "full",
    select_occupancy=None, occ_capacity: float | None = None,
    probe_stride: int = 1,
):
    """Build ``jit(fn)(params, c2w) -> rgb (H*W, 3)[, depth][, stats]``.

    ``occupancy`` is ``(grid, bbox)`` or ``(grid, bbox, dilate)`` from
    ops/occupancy.py; the grid must be dilated >= 2 cells (1 for the
    probe step + 1 for the ``probe_sub``-pixel ray divergence).
    ``capacity``/``fine_capacity`` are fractions of H*W bounding the
    active / fine-pass ray counts (static shapes; overflow reported in
    ``stats``). ``occ_capacity`` (fraction of H*W) bounds the MID-COARSE
    compaction: candidate selection runs on all ``capacity`` rays, but
    only rays with >=1 occupied selection-grid candidate reach the
    coarse field eval (the rest are grid-proven background). Size it
    from the measured ``occ_rays`` stat (~1.15x); ``None`` disables the
    mid compaction (every probed-active ray is evaluated).
    ``probe_sub="auto"`` picks the largest probe-lattice stride (of
    8/5/4/2/1) whose ray divergence stays inside one grid cell;
    ``probe_stride`` widens the depth step to that many grid cells
    (sound for stride <= 2*(dilate-1)+1 — a dilated blob spans
    1+2*dilate cells and cannot be stepped over). ``n_fine2`` > 0 adds an optional second importance
    round (see module doc). ``mesh``: a data Mesh shards each frame WITHIN the pose
    (ray tensors P('data'), params replicated) so one frame uses every
    device. ``stage`` ("probe"|"coarse"|"full") truncates the pipeline for
    strip-profiling (scripts/probe_frame_parts.py): "probe" stops after
    span probe + active compaction, "coarse" after the coarse composite.
    ``select_occupancy``: optional second ``(grid, bbox[, dilate])`` used
    only for candidate SELECTION inside the span (step 4) — a finer,
    less-dilated grid here concentrates the ``n_coarse`` samples on the
    true surface without paying the finer grid's cost in the span probe
    (the probe lattice stride is bounded by the grid cell size, so a
    128-cubed probe grid would force ``probe_sub=1``: 8x the probe
    work). Defaults to the probe grid.
    """
    if n_coarse > n_candidates:
        # select_coarse_samples ranks candidates; with n_coarse >
        # n_candidates some ranks name no candidate
        raise ValueError(
            f"n_coarse={n_coarse} must be <= n_candidates={n_candidates}")
    n = H * W
    chunk = min(s.ray_chunk, n)
    n_pad = (-n) % chunk
    n_full = n + n_pad
    k1 = min(n_full, -(-int(n_full * capacity) // chunk) * chunk)
    k1m = k1
    if occ_capacity is not None:
        k1m = min(k1, -(-int(n_full * occ_capacity) // chunk) * chunk)
    k2 = int(n_full * (fine_capacity if fine_capacity is not None
                       else capacity * 0.85))
    k2 = min(k1m, -(-k2 // chunk) * chunk)

    grid = jnp.asarray(np.asarray(occupancy[0], np.uint8))
    bbox = tuple(float(b) for b in occupancy[1])
    dilate = int(occupancy[2]) if len(occupancy) > 2 else 2
    if select_occupancy is not None:
        sel_grid = jnp.asarray(np.asarray(select_occupancy[0], np.uint8))
        sel_bbox = tuple(float(b) for b in select_occupancy[1])
    else:
        sel_grid, sel_bbox = grid, bbox
    if dilate < 2:
        if probe_sub == "auto":
            probe_sub = 1       # auto degrades; explicit >1 is an error
        elif probe_sub > 1:
            raise ValueError(
                "ngp frame renderer: probe_sub > 1 needs a grid dilated "
                ">= 2 cells (1 probe step + 1 ray divergence); rebuild "
                "the grid with dilate>=2 or pass probe_sub=1")
    r = grid.shape[0]
    cell = max((bbox[3 + d] - bbox[d]) / r for d in range(3))
    if probe_stride > 1:
        # sound for dilate >= 2: every occupied cell becomes a blob
        # >= 1+2*dilate = 5 cells wide, so a probe every 2 cells cannot
        # step over one; the span margin (2 probe steps) scales with the
        # widened step automatically
        if probe_stride > 2 * (dilate - 1) + 1:
            raise ValueError(
                f"probe_stride {probe_stride} too coarse for dilate="
                f"{dilate}: occupied blobs are 1+2*dilate cells wide and "
                "a stride above 2*(dilate-1)+1 can miss one")
    n_probe = int(np.ceil((s.far - s.near) / (cell * probe_stride))) + 1
    ok_sub = lambda q: (q == 1 or (q * s.far / focal <= cell
                                   and H % q == 0 and W % q == 0))
    if probe_sub == "auto":
        # largest lattice stride whose worst-case ray divergence stays
        # inside one probe-grid cell (the dilation budget)
        sub = next(q for q in (8, 5, 4, 2, 1) if ok_sub(q))
    else:
        sub = probe_sub if ok_sub(probe_sub) else 1
    act = density_activation(s.density_activation)
    assert k1 % chunk == 0 and k2 % chunk == 0
    M, F, C, F2 = n_coarse, n_fine, n_candidates, n_fine2

    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        n_dev = len(mesh.devices.ravel())
        if chunk % n_dev:
            raise ValueError(
                f"ray_chunk {chunk} must be divisible by the mesh size "
                f"{n_dev} for a sharded frame renderer")

        def cst(x, *spec):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, _P(*spec)))
    else:
        cst = lambda x, *spec: x

    def fn(params, c2w):
        rays_o, rays_d = camera_rays(H, W, focal, c2w)
        rays_d = cst(rays_d, "data")
        rays_o = cst(rays_o + 0.0, "data")

        # --- span probe on the subsampled lattice -----------------------
        t_probe = jnp.linspace(s.near, s.far, n_probe)
        step = (s.far - s.near) / (n_probe - 1)
        if sub > 1:
            rd_s = rays_d.reshape(H, W, 3)[sub // 2::sub, sub // 2::sub]
            rd_s = rd_s.reshape(-1, 3)
            ro_s = jnp.broadcast_to(c2w[:3, 3], rd_s.shape)
            act_s, te_s, tx_s = ray_spans(ro_s, rd_s, t_probe, grid, bbox,
                                          margin=2.0 * step)
            rep = lambda x: jnp.repeat(jnp.repeat(
                x.reshape(H // sub, W // sub), sub, axis=0),
                sub, axis=1).reshape(-1)
            active, t_enter, t_exit = rep(act_s), rep(te_s), rep(tx_s)
        else:
            active, t_enter, t_exit = ray_spans(
                rays_o, rays_d, t_probe, grid, bbox, margin=2.0 * step)
        active = jnp.pad(active, (0, n_pad)) & (jnp.arange(n_full) < n)

        # --- active compaction ------------------------------------------
        # stable partition (actives first, index order kept) == the
        # argsort(~active) permutation, via cumsum slots + one scatter
        # instead of an O(n log^2 n) 640k-element sort
        act_i = active.astype(jnp.int32)
        n_act = act_i.sum()
        slot = jnp.where(active, jnp.cumsum(act_i) - 1,
                         n_act + jnp.cumsum(1 - act_i) - 1)
        order1 = jnp.zeros((n_full,), jnp.int32).at[slot].set(
            jnp.arange(n_full, dtype=jnp.int32), unique_indices=True)
        sel1 = order1[:k1]
        take = lambda x: jnp.take(
            jnp.pad(x, ((0, n_pad),) + ((0, 0),) * (x.ndim - 1)),
            sel1, axis=0, unique_indices=True)
        ro1, rd1 = take(rays_o), take(rays_d)
        te1, tx1 = take(t_enter), take(t_exit)
        span1 = jnp.maximum(tx1 - te1, 1e-3)
        stats = {"active_rays": active.sum(),
                 "coarse_overflow": jnp.maximum(active.sum() - k1, 0)}
        if stage == "probe":
            rgb = jnp.zeros((n_full, 3)).at[sel1].set(
                jnp.stack([te1, tx1, span1], -1),
                unique_indices=True)[:n].astype(jnp.float32)
            return (rgb, stats) if return_stats else rgb

        # --- coarse sample SELECTION (no field eval) --------------------
        def select_chunk(args):
            ro, rd, te, span = args
            uu = (jnp.arange(C, dtype=jnp.float32) + 0.5) / C
            t_cand = te[:, None] + span[:, None] * uu[None, :]   # (c, C)
            p_cand = ro[:, None] + rd[:, None] * t_cand[..., None]
            occ_c = points_occupied(p_cand, sel_grid, sel_bbox)
            t_c = select_coarse_samples(t_cand, occ_c, M)         # (c, M)
            return t_c, occ_c.sum(-1)

        t_c1, n_occ = jax.lax.map(
            select_chunk,
            (cst(ro1.reshape(-1, chunk, 3), None, "data"),
             cst(rd1.reshape(-1, chunk, 3), None, "data"),
             cst(te1.reshape(-1, chunk), None, "data"),
             cst(span1.reshape(-1, chunk), None, "data")))
        t_c1 = t_c1.reshape(k1, M)
        n_occ = n_occ.reshape(k1)
        stats["mean_occupied_candidates"] = n_occ.mean()

        # --- mid-coarse compaction: only rays with >=1 occupied
        # candidate reach the field eval. The span probe's dilated grid
        # marks ~1.6x more rays active than have any (finer, less
        # dilated) selection-grid candidate; those extra rays are
        # grid-proven background and composite as bg with NO MLP work.
        live1 = (sel1 < n) & jnp.take(active, sel1, unique_indices=True)
        if occ_capacity is not None:
            occ_any = live1 & (n_occ > 0)
            stats["occ_rays"] = occ_any.sum()
            stats["occ_overflow"] = jnp.maximum(occ_any.sum() - k1m, 0)
            # stable partition (occ rays first) via cumsum slots — same
            # permutation as argsort(~occ_any), no k1-element sort
            occ_i2 = occ_any.astype(jnp.int32)
            n_occ2 = occ_i2.sum()
            slot2 = jnp.where(occ_any, jnp.cumsum(occ_i2) - 1,
                              n_occ2 + jnp.cumsum(1 - occ_i2) - 1)
            sel1b = jnp.zeros((k1,), jnp.int32).at[slot2].set(
                jnp.arange(k1, dtype=jnp.int32),
                unique_indices=True)[:k1m]
            takeb = lambda x: jnp.take(x, sel1b, axis=0,
                                       unique_indices=True)
            ro1b, rd1b = takeb(ro1), takeb(rd1)
            sp1b, t_c1b = takeb(span1), takeb(t_c1)
            live1b = takeb(occ_any)
        else:
            # no mid compaction: every probed-active ray is evaluated
            # AND composited (exact pre-occ_capacity semantics)
            sel1b = jnp.arange(k1)
            ro1b, rd1b, sp1b, t_c1b = ro1, rd1, span1, t_c1
            live1b = live1

        # --- coarse field eval + composite on the compacted set ---------
        def coarse_chunk(args):
            ro, rd, span, t_c = args
            pts = ro[:, None] + rd[:, None] * t_c[..., None]
            vd = rd[:, None]
            raw = apply_fn(params, pts, vd, "fine")
            w = _gap_capped_weights(raw[..., 3], t_c, span, C, act)
            rgb = jax.nn.sigmoid(raw[..., :3])
            acc = w.sum(-1)
            rgb_map = (w[..., None] * rgb).sum(-2)
            depth_map = (w * t_c).sum(-1)
            if s.white_bkgd:
                rgb_map = rgb_map + (1.0 - acc[..., None])
            return rgb_map, depth_map, acc, raw

        rgb1, depth1, acc1, raw_c1 = jax.lax.map(
            coarse_chunk,
            (cst(ro1b.reshape(-1, chunk, 3), None, "data"),
             cst(rd1b.reshape(-1, chunk, 3), None, "data"),
             cst(sp1b.reshape(-1, chunk), None, "data"),
             cst(t_c1b.reshape(-1, chunk, M), None, "data")))
        rgb1 = rgb1.reshape(k1m, 3)
        depth1 = depth1.reshape(k1m)
        acc1 = acc1.reshape(k1m)
        raw_c1 = raw_c1.reshape(k1m, M, 4)
        if stage == "coarse":
            bg0 = 1.0 if s.white_bkgd else 0.0
            g1b = jnp.take(sel1, sel1b, unique_indices=True)
            rgb = jnp.full((n_full, 3), bg0).at[g1b].set(
                jnp.where(live1b[:, None], rgb1, bg0),
                unique_indices=True)[:n].astype(jnp.float32)
            return (rgb, stats) if return_stats else rgb

        # --- fine-pass compaction by coarse opacity ---------------------
        acc_key = jnp.where(live1b, acc1, -1.0)
        # top-k (ties lower-index-first) == argsort(-acc_key)[:k2]
        _, sel2 = jax.lax.top_k(acc_key, k2)
        stats["nontrivial_rays"] = (acc_key > 1e-3).sum()
        stats["fine_overflow"] = jnp.maximum((acc_key > 1e-3).sum() - k2, 0)
        take2 = lambda x: jnp.take(x, sel2, axis=0, unique_indices=True)
        ro2, rd2 = take2(ro1b), take2(rd1b)
        sp2 = take2(sp1b)
        t_c2, raw_c2 = take2(t_c1b), take2(raw_c1)

        # --- fine: CDF rounds, merge with saved coarse raws -------------
        def fine_chunk(args):
            ro, rd, span, t_c, raw_c = args

            def cdf_round(t_prev, raw_prev, n_new):
                """One importance round: CDF over the current merged
                sample set -> n_new depths -> evaluate -> sorted merge."""
                w = _gap_capped_weights(raw_prev[..., 3], t_prev, span,
                                        C, act)
                w_bins = 0.5 * (w[..., :-1] + w[..., 1:])
                t_new = sample_pdf(t_prev, w_bins, n_new, key=None)
                pts = ro[:, None] + rd[:, None] * t_new[..., None]
                raw_new = apply_fn(params, pts, rd[:, None], "fine")
                t_cat = jnp.concatenate([t_prev, t_new], axis=-1)
                ops = jax.lax.sort(
                    (t_cat,) + tuple(jnp.concatenate(
                        [raw_prev[..., i], raw_new[..., i]], axis=-1)
                        for i in range(4)),
                    dimension=-1, num_keys=1)
                return ops[0], jnp.stack(ops[1:], axis=-1)

            t_all, raw_all = cdf_round(t_c, raw_c, F)
            if F2 > 0:
                t_all, raw_all = cdf_round(t_all, raw_all, F2)
            rgb_all = jax.nn.sigmoid(raw_all[..., :3])
            w_all = _gap_capped_weights(raw_all[..., 3], t_all, span,
                                        C, act)
            acc = w_all.sum(-1)
            rgb_map = (w_all[..., None] * rgb_all).sum(-2)
            depth_map = (w_all * t_all).sum(-1)
            if s.white_bkgd:
                rgb_map = rgb_map + (1.0 - acc[..., None])
            return rgb_map, depth_map

        fine_rgb, fine_depth = jax.lax.map(
            fine_chunk,
            (cst(ro2.reshape(-1, chunk, 3), None, "data"),
             cst(rd2.reshape(-1, chunk, 3), None, "data"),
             cst(sp2.reshape(-1, chunk), None, "data"),
             cst(t_c2.reshape(-1, chunk, M), None, "data"),
             cst(raw_c2.reshape(-1, chunk, M, 4), None, "data")))
        fine_rgb = fine_rgb.reshape(k2, 3)
        fine_depth = fine_depth.reshape(k2)

        # --- assemble ----------------------------------------------------
        # grid-proven-empty rays composite as pure background even when
        # capacity slack pulled them into the coarse set
        bg = 1.0 if s.white_bkgd else 0.0
        g1b = jnp.take(sel1, sel1b, unique_indices=True)
        rgb1 = jnp.where(live1b[:, None], rgb1, bg)
        rgb = jnp.full((n_full, 3), bg).at[g1b].set(
            rgb1, unique_indices=True)
        sel_full = jnp.take(g1b, sel2, unique_indices=True)
        act2 = jnp.take(live1b, sel2, unique_indices=True)
        fine_rgb = jnp.where(act2[:, None], fine_rgb, bg)
        rgb = rgb.at[sel_full].set(fine_rgb, unique_indices=True)[:n]
        if out_dtype == jnp.uint8:
            rgb = jnp.round(jnp.clip(rgb, 0.0, 1.0) * 255.0
                            ).astype(jnp.uint8)
        else:
            rgb = rgb.astype(out_dtype)
        out = (rgb,)
        if return_depth:
            depth = jnp.zeros((n_full,)).at[g1b].set(
                jnp.where(live1b, depth1, 0.0), unique_indices=True)
            depth = depth.at[sel_full].set(
                jnp.where(act2, fine_depth, 0.0),
                unique_indices=True)[:n]
            out = out + (depth,)
        if return_stats:
            out = out + (stats,)
        return out if len(out) > 1 else out[0]

    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as _P

    rep = NamedSharding(mesh, _P())
    return jax.jit(fn, in_shardings=(rep, rep))
