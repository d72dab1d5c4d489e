"""Volume renderer.

Capability parity with reference
src/models/nerf/renderer/volume_renderer.py, redesigned as ONE jitted XLA
program per ray-batch instead of three nested Python chunk loops:

  stratified coarse sampling -> coarse MLP -> compositing weights ->
  inverse-CDF importance resampling -> union sort -> fine MLP ->
  alpha compositing (white background).

Reference mapping:
* ``stratified_sample`` / ``compute_weights`` / ``sample_pdf`` /
  ``composite`` live in ``nerf_replication_tpu.ops.ray_ops``.
* ESS/ERT ``fast_sampling`` masks (reference fine_sample_points:112-244)
  are computed densely (`jnp.where`), matching the reference's
  dense-scatter-zeros network path (network.py:234-253).
* Eval-time chunking over rays is a single ``lax.map`` over fixed tiles
  (replaces rays_size=160000 / sample_size=64 / chunk=512 loops,
  volume_renderer.py:19-20,321,386-397).

Documented quirk fixes vs the reference:
* Renderer knobs read from ``cfg.task_arg`` (where the shipped YAML puts
  them) with top-level fallback; the reference read only top-level keys
  and silently ran on Python defaults (volume_renderer.py:14-24).
* ``perturb`` is active during training; the reference compared
  ``cfg.task`` (always "nerf-replication"/"run") against "train", so its
  jitter never fired (volume_renderer.py:21-22).
* Importance-sampling weights are ``stop_gradient``-ed and an optional
  coarse RGB loss output is provided (standard NeRF); the reference
  backprops through the CDF and supervises only the fine image.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ....ops.ray_ops import (
    camera_rays,
    compute_weights,
    composite,
    density_activation,
    sample_pdf,
    stratified_sample,
)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static renderer configuration (hashable -> usable as a jit static)."""

    N_samples: int = 64
    N_importance: int = 128
    near: float = 2.0
    far: float = 6.0
    white_bkgd: bool = True
    lindisp: bool = False
    perturb: bool = True
    raw_noise_std: float = 0.0
    fast_sampling: bool = False
    weights_threshold: float = 0.25
    ert_threshold: float = 0.45
    ess_verbose: bool = False  # emit ESS/ERT mask statistics (reference
    #                            volume_renderer.py:198-244 debug prints)
    ray_chunk: int = 8192  # eval tile size for lax.map over rays
    density_activation: str = "relu"  # 'softplus' avoids dead-ReLU collapse
    # segmented fine pass with early-ray-termination compaction (the
    # compacting form of the reference's ERT cummax threshold,
    # volume_renderer.py:161-171): >1 splits the fine samples into that
    # many segments and drops saturated rays between segments via
    # static-capacity top-K on remaining transmittance. 1 = dense.
    ert_segments: int = 1
    ert_eps: float = 1e-4
    ert_frac: tuple = ()   # per-boundary survivor fractions; () = default
    ert_split: float = 2.0 / 3.0  # fraction of samples in segment 0
    # finite far-tail delta (last sample spacing) instead of the
    # reference 1e10 — REQUIRED with softplus density (see
    # ray_ops.compute_weights); relu configs keep reference semantics
    finite_tail: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "RenderSettings":
        ta = cfg.get("task_arg", {})
        get = lambda k, d: ta.get(k, cfg.get(k, d))
        return cls(
            N_samples=int(get("N_samples", 64)),
            N_importance=int(get("N_importance", 128)),
            near=float(get("near", 2.0)),
            far=float(get("far", 6.0)),
            white_bkgd=bool(get("white_bkgd", True)),
            lindisp=bool(get("lindisp", False)),
            perturb=bool(get("perturb", True)),
            raw_noise_std=float(get("raw_noise_std", 0.0)),
            fast_sampling=bool(get("fast_sampling", False)),
            weights_threshold=float(get("weights_threshold", 0.25)),
            ert_threshold=float(get("ert_threshold", 0.45)),
            ess_verbose=bool(get("ess_verbose", False)),
            ray_chunk=int(get("ray_chunk", 8192)),
            density_activation=str(get("density_activation", "relu")),
            ert_segments=int(get("ert_segments", 1)),
            ert_eps=float(get("ert_eps", 1e-4)),
            ert_frac=tuple(float(f) for f in get("ert_frac", ())),
            ert_split=float(get("ert_split", 2.0 / 3.0)),
            finite_tail=bool(get("finite_tail", False)),
        )


def _ess_ert_mask(density_relu, t_coarse, t_fine_idx_below, s: RenderSettings):
    """Dense ESS/ERT validity mask for fine samples.

    Reference fine_sample_points:112-192 — empty-ray classification,
    object/background split, ESS empty-bin test on trimmed weights, ERT
    cummax transmittance cutoff — reproduced with dense jnp ops (no
    gathers over ragged shapes).
    Returns (N_rays, N_importance) bool.
    """
    density_sum = density_relu.sum(axis=-1)
    empty_ray = density_sum < 1e-3
    object_ray = density_relu.max(axis=-1) > 0.5

    weights, _, trans = compute_weights(density_relu, t_coarse)
    w = weights[..., 1:-1]
    T = trans[..., 1:-1]

    empty_bins = w < s.weights_threshold  # (N, S-2)

    # ERT: once transmittance drops below threshold, everything after is
    # invalid (cummax of the padded mask, fine_sample_points:161-171)
    ert_base = T < s.ert_threshold
    ert_padded = jnp.concatenate(
        [jnp.zeros_like(ert_base[..., :1], dtype=bool), ert_base], axis=-1
    )
    ert_bins = jax.lax.cummax(ert_padded.astype(jnp.int32), axis=ert_padded.ndim - 1)[
        ..., 1:
    ].astype(bool)

    below = jnp.clip(t_fine_idx_below, 0, w.shape[-1] - 1)
    take = lambda m: jnp.take_along_axis(m, below, axis=-1)
    ert_invalid = take(ert_bins)
    below_empty = take(empty_bins)
    above_empty = jnp.take_along_axis(
        empty_bins, jnp.clip(t_fine_idx_below + 1, 0, w.shape[-1] - 1), axis=-1
    )
    ess_invalid = jnp.where(
        object_ray[..., None], below_empty & above_empty, below_empty | above_empty
    )
    valid = ~(ess_invalid | ert_invalid)
    return jnp.where(empty_ray[..., None], False, valid)


def fine_stage(
    apply_fn,
    params,
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    viewdirs: jnp.ndarray,
    t_coarse: jnp.ndarray,
    w_c: jnp.ndarray,
    key_cdf,
    key_noise,
    s: RenderSettings,
    train: bool = False,
    density_coarse: jnp.ndarray | None = None,
):
    """Hierarchical fine pass given coarse depths + weights: inverse-CDF
    resample, union sort, fine MLP, composite. Shared by render_rays and
    the compacted frame renderer (which feeds SAVED coarse weights so the
    coarse MLP is not re-evaluated for surviving rays).

    ``density_coarse`` (activated coarse densities, (N, N_samples))
    switches on the dense ESS/ERT masking of the reference's
    ``fast_sampling`` path: invalid fine samples contribute zero density,
    mirroring the reference's zero-filled scatter (network.py:234-253).
    """
    bins = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
    w_mid = jax.lax.stop_gradient(w_c[..., 1:-1])
    t_fine = sample_pdf(bins, w_mid, s.N_importance, key=key_cdf)
    t_cat = jnp.concatenate([t_coarse, t_fine], axis=-1)
    if density_coarse is None:
        t_all = jnp.sort(t_cat, axis=-1)
        valid_sorted = None
    else:
        # masked path needs the permutation to sort the validity flags
        # alongside the depths (argsort+gather; the unmasked hot path
        # keeps the cheaper jnp.sort)
        order = jnp.argsort(t_cat, axis=-1)
        t_all = jnp.take_along_axis(t_cat, order, axis=-1)
        below = (
            jax.vmap(lambda b, v: jnp.searchsorted(b, v, side="right"))(
                bins, t_fine)
            - 1
        )
        valid_f = _ess_ert_mask(density_coarse, t_coarse, below, s)
        valid_all = jnp.concatenate(
            [jnp.ones_like(t_coarse, dtype=bool), valid_f], axis=-1)
        valid_sorted = jnp.take_along_axis(valid_all, order, axis=-1)
    pts_all = rays_o[:, None] + rays_d[:, None] * t_all[..., None]
    raw_f = apply_fn(params, pts_all, viewdirs[:, None], "fine")
    if valid_sorted is not None:
        raw_f = jnp.where(valid_sorted[..., None], raw_f, 0.0)
    rgb_f = jax.nn.sigmoid(raw_f[..., :3])
    noise_key = key_noise if (train and s.raw_noise_std > 0) else None
    w_f, _, _ = compute_weights(
        raw_f[..., 3], t_all, raw_noise_std=s.raw_noise_std, key=noise_key,
        activation=density_activation(s.density_activation),
        finite_tail=s.finite_tail)
    rgb_map, depth_map, acc_map = composite(rgb_f, w_f, t_all, s.white_bkgd)
    out = {"rgb": rgb_map, "depth": depth_map, "acc": acc_map,
           "raw": raw_f, "t_all": t_all}
    if valid_sorted is not None and s.ess_verbose:
        # ESS/ERT debug statistics (reference volume_renderer.py:198-244):
        # empty-ray count, per-ray valid-sample fraction, skip fraction
        empty_ray = density_coarse.sum(axis=-1) < 1e-3
        out["ess_stats"] = {
            "empty_rays": empty_ray.sum(),
            "total_rays": jnp.int32(t_all.shape[0]),
            "valid_fine_frac": valid_sorted.mean(),
            "skipped_points": (~valid_sorted).sum(),
        }
    return out


def fine_stage_ert(
    apply_fn,
    params,
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    viewdirs: jnp.ndarray,
    t_coarse: jnp.ndarray,
    w_c: jnp.ndarray,
    s: RenderSettings,
    n_seg: int | None = None,
    surv_frac: tuple | None = None,
):
    """Segmented fine pass with early-ray-termination compaction.

    The reference's ERT thresholds per-SAMPLE via a transmittance cummax
    (volume_renderer.py:161-171) — a masking trick that saves nothing on
    dense hardware. The compacting form: evaluate the sorted fine
    samples in ``n_seg`` segments; between segments keep only the rays
    whose remaining transmittance is largest (static-capacity top-K, so
    every shape stays compile-time constant) and stop marching the rest.

    Weight math is EXACT for surviving rays: deltas are taken from the
    global sorted depth vector (with the reference's 1e10 tail) and the
    carried transmittance includes the same +1e-10 cumprod epsilon as
    :func:`compute_weights`, so a run with full capacity reproduces
    :func:`fine_stage` bitwise. A dropped ray loses only its tail
    contribution, bounded by its remaining transmittance (<= ert_eps up
    to the capacity overflow reported in ``stats``).

    Eval-only (deterministic CDF samples, no noise).
    """
    n = rays_o.shape[0]
    n_seg = int(s.ert_segments if n_seg is None else n_seg)
    bins = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
    w_mid = jax.lax.stop_gradient(w_c[..., 1:-1])
    t_fine = sample_pdf(bins, w_mid, s.N_importance, key=None)
    t_all = jnp.sort(jnp.concatenate([t_coarse, t_fine], axis=-1), axis=-1)
    S = t_all.shape[-1]
    # the inverse-CDF samples cluster around surfaces (mid-array in the
    # sorted union), so saturation mostly happens in the FIRST ~2/3 of
    # the samples: give segment 0 that span and split the tail evenly.
    # Even splits would cut before the surface and drop live rays.
    first = int(round(S * float(s.ert_split)))
    first = max(1, min(S - (n_seg - 1), first))
    rest = S - first
    k_tail = -(-rest // max(n_seg - 1, 1))
    bounds = [0, first]
    while bounds[-1] < S:
        bounds.append(min(S, bounds[-1] + k_tail))
    n_seg = len(bounds) - 1
    d_ = t_all[:, 1:] - t_all[:, :-1]
    tail_ = (d_[:, -1:] if s.finite_tail
             else jnp.full((n, 1), 1e10, t_all.dtype))
    delta = jnp.concatenate([d_, tail_], axis=1)
    act = density_activation(s.density_activation)
    if surv_frac is None:
        surv_frac = (s.ert_frac if s.ert_frac else
                     tuple(0.5 * (0.8 ** i) for i in range(n_seg - 1)))
    # user-supplied fractions may be shorter than n_seg-1 boundaries
    # (e.g. BENCH_ERT=3 with a single BENCH_ERT_FRAC value): extend with
    # the default decay from the last given value
    surv_frac = tuple(surv_frac)
    if len(surv_frac) < n_seg - 1:
        last = surv_frac[-1] if surv_frac else 0.5
        surv_frac = surv_frac + tuple(
            last * (0.8 ** (i + 1))
            for i in range(n_seg - 1 - len(surv_frac)))

    rgb_acc = jnp.zeros((n, 3), jnp.float32)
    depth_acc = jnp.zeros((n,), jnp.float32)
    acc_acc = jnp.zeros((n,), jnp.float32)

    gidx = jnp.arange(n)
    ro, rd, vd = rays_o, rays_d, viewdirs
    T = jnp.ones((n,), jnp.float32)
    overflow = jnp.int32(0)
    for seg in range(n_seg):
        ts = t_all[:, bounds[seg]:bounds[seg + 1]]
        ds_ = delta[:, bounds[seg]:bounds[seg + 1]]
        pts = ro[:, None] + rd[:, None] * ts[..., None]
        raw = apply_fn(params, pts, vd[:, None], "fine")
        rgb = jax.nn.sigmoid(raw[..., :3])
        alpha = 1.0 - jnp.exp(-act(raw[..., 3]) * ds_)
        one_m = 1.0 - alpha + 1e-10          # compute_weights epsilon
        trans_local = jnp.cumprod(one_m, axis=-1)
        trans_excl = jnp.concatenate(
            [jnp.ones_like(trans_local[:, :1]), trans_local[:, :-1]],
            axis=1)
        w = T[:, None] * trans_excl * alpha
        rgb_acc = rgb_acc.at[gidx].add(
            (w[..., None] * rgb).sum(axis=1), unique_indices=True)
        depth_acc = depth_acc.at[gidx].add((w * ts).sum(axis=1),
                                           unique_indices=True)
        acc_acc = acc_acc.at[gidx].add(w.sum(axis=1), unique_indices=True)
        T = T * trans_local[:, -1]
        if seg < n_seg - 1:
            kk = int(-(-n * float(surv_frac[seg]) // 128) * 128)
            kk = min(int(T.shape[0]), max(1, kk))
            vals, sel = jax.lax.top_k(T, kk)
            overflow = overflow + ((T > s.ert_eps).sum()
                                   - (vals > s.ert_eps).sum())
            gidx = jnp.take(gidx, sel)
            ro = jnp.take(ro, sel, axis=0)
            rd = jnp.take(rd, sel, axis=0)
            vd = jnp.take(vd, sel, axis=0)
            t_all = jnp.take(t_all, sel, axis=0)
            delta = jnp.take(delta, sel, axis=0)
            T = vals
    rgb_map = rgb_acc
    if s.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_acc[..., None])
    return {"rgb": rgb_map, "depth": depth_acc, "acc": acc_acc,
            "stats": {"ert_overflow": overflow}}


def render_rays(
    apply_fn,
    params,
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    key: jax.Array | None,
    s: RenderSettings,
    train: bool = False,
):
    """Render a flat batch of rays. The whole chain is one XLA program.

    Args:
      apply_fn: ``apply_fn(params, pts, viewdirs, model) -> raw (..., 4)``.
      rays_o/rays_d: (N, 3) world-space rays (directions unnormalised).
      key: PRNG key (training: jitter/noise); None for deterministic eval.

    Returns a dict: rgb, depth, acc, plus rgb_coarse/depth_coarse/acc_coarse
    when N_importance > 0.
    """
    n_rays = rays_o.shape[0]
    k_jitter = k_cdf = k_noise_c = k_noise_f = None
    if key is not None:
        k_jitter, k_cdf, k_noise_c, k_noise_f = jax.random.split(key, 4)

    perturb_key = k_jitter if (train and s.perturb) else None
    t_coarse = stratified_sample(
        n_rays, s.N_samples, s.near, s.far, key=perturb_key, lindisp=s.lindisp
    )
    pts_coarse = rays_o[:, None] + rays_d[:, None] * t_coarse[..., None]
    viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    raw_c = apply_fn(params, pts_coarse, viewdirs[:, None], "")
    rgb_c = jax.nn.sigmoid(raw_c[..., :3])
    noise_key = k_noise_c if (train and s.raw_noise_std > 0) else None
    w_c, _, _ = compute_weights(
        raw_c[..., 3], t_coarse, raw_noise_std=s.raw_noise_std, key=noise_key,
        activation=density_activation(s.density_activation),
        finite_tail=s.finite_tail,
    )
    rgb_map_c, depth_map_c, acc_map_c = composite(rgb_c, w_c, t_coarse, s.white_bkgd)

    out = {"rgb": rgb_map_c, "depth": depth_map_c, "acc": acc_map_c}
    if s.N_importance <= 0:
        # coarse-only callers (the compacted frame renderer) reuse the
        # weights for the fine stage; hierarchical outputs omit them to
        # keep eval host transfers small
        out["weights"] = w_c
        return out

    # fast_sampling switches on the dense ESS/ERT masking inside
    # fine_stage (reference fast_sampling semantics; importance weights
    # are stop_gradient-ed there — quirk fix, see module doc)
    density_c = (
        density_activation(s.density_activation)(raw_c[..., 3])
        if s.fast_sampling else None)
    fine = fine_stage(apply_fn, params, rays_o, rays_d, viewdirs,
                      t_coarse, w_c, k_cdf if train else None,
                      k_noise_f, s, train=train, density_coarse=density_c)
    out.update(rgb=fine["rgb"], depth=fine["depth"], acc=fine["acc"],
               rgb_coarse=rgb_map_c, depth_coarse=depth_map_c,
               acc_coarse=acc_map_c)
    if "ess_stats" in fine:
        out["ess_stats"] = fine["ess_stats"]
    return out


class Renderer:
    """Object API parity: ``Renderer(net).render(batch) -> (rgb, depth)``
    (reference volume_renderer.py:290-432). ``net`` is the Network;
    params are passed per call (functional) or bound via ``bind_params``."""

    def __init__(self, net, cfg=None, settings: RenderSettings | None = None,
                 mesh="auto"):
        self.net = net
        self.settings = settings or (
            RenderSettings.from_cfg(cfg) if cfg is not None else RenderSettings()
        )
        self._params = None

        def apply_fn(params, pts, viewdirs, model):
            return net.apply(params, pts, viewdirs, model=model)

        self.apply_fn = apply_fn
        self._render_train = jax.jit(
            partial(render_rays, apply_fn, s=self.settings, train=True)
        )
        # multi-device: shard eval ray chunks over the data mesh (params
        # replicated) — the reference shards eval views across ranks via
        # DistributedSampler (src/datasets/samplers.py:75-131); sharding
        # WITHIN the image uses all devices even for a single view
        if mesh == "auto":
            mesh = None
            if len(jax.devices()) > 1:
                from ....parallel.mesh import make_mesh

                mesh = make_mesh(cfg)
        self.mesh = mesh
        self._build_eval_chunk_fns(apply_fn)

    def _build_eval_chunk_fns(self, apply_fn):
        # eval chunks run WITHOUT the dense per-sample masks: at eval time
        # the ESS/ERT capability is realised by ray compaction
        # (render_image_fast), so surviving rays match the dense render
        # bit-for-bit
        eval_settings = dataclasses.replace(self.settings, fast_sampling=False)
        coarse_only = dataclasses.replace(eval_settings, N_importance=0)
        fine_fn = partial(render_rays, apply_fn, key=None, s=eval_settings,
                          train=False)
        coarse_fn = partial(render_rays, apply_fn, key=None, s=coarse_only,
                            train=False)
        if self.mesh is not None and len(self.mesh.devices.ravel()) > 1:
            from ....parallel.mesh import make_dp_eval_render

            self._render_eval_chunk = make_dp_eval_render(fine_fn, self.mesh)
            self._render_coarse_chunk = make_dp_eval_render(
                coarse_fn, self.mesh)
        else:
            self._render_eval_chunk = jax.jit(fine_fn)
            self._render_coarse_chunk = jax.jit(coarse_fn)

    def _eval_chunk_size(self, n: int) -> int:
        """Eval tile size: ``ray_chunk`` capped by n, rounded up to a
        multiple of the mesh size so sharded chunks split evenly."""
        chunk = min(self.settings.ray_chunk, n)
        if self.mesh is not None:
            n_dev = len(self.mesh.devices.ravel())
            chunk = -(-chunk // n_dev) * n_dev
        return chunk

    def bind_params(self, params):
        self._params = params
        return self

    def render_rays_batch(self, params, rays_o, rays_d, key=None, train=False):
        """Flat (N,3) rays -> output dict. Eval tiles rays at
        ``settings.ray_chunk`` granularity; tiling/padding/assembly run in
        host numpy so the only device work is the pre-jitted chunk render
        (one compiled shape, no per-call eager device ops)."""
        if train:
            return self._render_train(params, rays_o, rays_d, key)
        rays_o = np.asarray(rays_o)
        rays_d = np.asarray(rays_d)
        n = rays_o.shape[0]
        chunk = self._eval_chunk_size(n)
        n_pad = (-n) % chunk
        ro = np.pad(rays_o, ((0, n_pad), (0, 0))).reshape(-1, chunk, 3)
        rd = np.pad(rays_d, ((0, n_pad), (0, 0)),
                    constant_values=1.0).reshape(-1, chunk, 3)
        pending = [self._render_eval_chunk(params, ro[t], rd[t])
                   for t in range(ro.shape[0])]
        out = {}
        for k in pending[0]:
            out[k] = np.concatenate(
                [np.asarray(p[k]) for p in pending], axis=0)[:n]
        return out

    def render_image_fast(self, params, rays_o, rays_d, eps: float = 1e-3):
        """Eval-time empty-space skipping (the reference's ESS/ERT
        fast_sampling capability re-designed as ray compaction):

        1. coarse-only pass over ALL rays (1/4 of the dense FLOPs),
        2. compact: keep rays whose coarse opacity exceeds ``eps``
           (host-side index build — the only host sync per image),
        3. full hierarchical render ONLY for surviving rays in fixed-size
           tiles (one compiled shape, Python loop over tiles),
        4. scatter fine results back; background rays keep the coarse
           composite (white background for true misses).

        On lego-like scenes ~60% of rays are background -> ~1.7x fewer
        point evaluations than the dense path.
        """
        import numpy as np

        # All padding/chunking/gather/scatter run in HOST numpy: the only
        # device programs here are the two pre-jitted chunk renders, each
        # compiled once. Host roundtrips are a few MB/frame.
        rays_o = np.asarray(rays_o)
        rays_d = np.asarray(rays_d)
        n = rays_o.shape[0]
        chunk = self._eval_chunk_size(n)
        n_pad = (-n) % chunk
        ro = np.pad(rays_o, ((0, n_pad), (0, 0))).reshape(-1, chunk, 3)
        rd = np.pad(rays_d, ((0, n_pad), (0, 0)),
                    constant_values=1.0).reshape(-1, chunk, 3)

        out_rgb = np.empty((n + n_pad, 3), np.float32)
        out_depth = np.empty(n + n_pad, np.float32)
        out_acc = np.empty(n + n_pad, np.float32)
        pending = []
        for t in range(ro.shape[0]):
            pending.append(
                (t, self._render_coarse_chunk(params, ro[t], rd[t])))
        for t, out in pending:  # async dispatch above, fetch here
            sl = slice(t * chunk, (t + 1) * chunk)
            out_rgb[sl] = np.asarray(out["rgb"])
            out_depth[sl] = np.asarray(out["depth"])
            out_acc[sl] = np.asarray(out["acc"])
        out_rgb, out_depth, out_acc = (
            out_rgb[:n], out_depth[:n], out_acc[:n])

        active = np.nonzero(out_acc > eps)[0]
        if active.size:
            pad = (-active.size) % chunk
            idx = np.concatenate([active, np.zeros(pad, np.int64)])
            ro_a = rays_o[idx].reshape(-1, chunk, 3)
            rd_a = rays_d[idx].reshape(-1, chunk, 3)
            pending = [(t, self._render_eval_chunk(params, ro_a[t], rd_a[t]))
                       for t in range(ro_a.shape[0])]
            fine_rgb = np.concatenate(
                [np.asarray(o["rgb"]) for _, o in pending])[:active.size]
            fine_depth = np.concatenate(
                [np.asarray(o["depth"]) for _, o in pending])[:active.size]
            fine_acc = np.concatenate(
                [np.asarray(o["acc"]) for _, o in pending])[:active.size]
            out_rgb[active] = fine_rgb
            out_depth[active] = fine_depth
            out_acc[active] = fine_acc
        return {"rgb": out_rgb, "depth": out_depth, "acc": out_acc}

    def make_frame_renderer(self, H: int, W: int, focal: float,
                            capacity: float = 0.5, out_dtype=jnp.float32,
                            occupancy=None, coarse_capacity: float | None
                            = None, return_stats: bool = False,
                            mesh=None):
        """ONE jitted program per frame: device-side ray generation from
        the camera pose, static-capacity top-K ray compaction (ESS with
        no host roundtrip), fine render of survivors, scatter-back.

        Two culling stages:
        1. ``occupancy=(grid, bbox)`` (see ops/occupancy.py): rays whose
           probes never touch an occupied cell skip the COARSE pass too
           and composite as pure background — the instant-ngp bitfield
           idea. ``coarse_capacity`` bounds the coarse survivor count
           (default: ``capacity`` + margin).
        2. top-K by coarse opacity bounds the fine survivor count at
           ``capacity`` (reuses saved coarse weights — the coarse MLP is
           not re-evaluated).

        Active rays run the exact dense coarse+fine math; only rays the
        (conservative, dilated) grid proves empty — or beyond static
        capacity, reported via ``return_stats`` overflow counters — take
        the cheap path.

        Host traffic per frame is one (4,4) pose up and one (H*W, 3)
        image down (uint8 when ``out_dtype`` says so).

        Returns jit(fn)(params, c2w) -> rgb (H*W, 3)
        [, stats dict when return_stats].

        ``mesh``: a data Mesh shards the frame WITHIN the pose — ray
        tensors ride P('data') and each lax.map chunk is split over the
        devices (params replicated), so a single frame uses every device.
        """
        s = dataclasses.replace(self.settings, fast_sampling=False)
        coarse_s = dataclasses.replace(s, N_importance=0)
        n = H * W
        chunk = min(s.ray_chunk, n)
        n_pad = (-n) % chunk
        n_full = n + n_pad
        # budgets round UP to whole chunks (capped at n_full) so a
        # requested margin is never silently floored away
        k = min(n_full, -(-int(n_full * capacity) // chunk) * chunk)
        k1 = int(n_full * (coarse_capacity if coarse_capacity is not None
                           else min(1.0, capacity * 1.5)))
        k1 = min(n_full, -(-k1 // chunk) * chunk)
        k1 = max(k1, k)
        apply_fn = self.apply_fn

        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as _P

            n_dev = len(mesh.devices.ravel())
            if chunk % n_dev:
                raise ValueError(
                    f"ray_chunk {chunk} must be divisible by the mesh "
                    f"size {n_dev} for a sharded frame renderer")

            def cst(x, *spec):
                return jax.lax.with_sharding_constraint(
                    x, NamedSharding(mesh, _P(*spec)))
        else:
            cst = lambda x, *spec: x

        if occupancy is not None:
            from ....ops.occupancy import rays_active

            occ_grid = jnp.asarray(np.asarray(occupancy[0], np.uint8))
            occ_bbox = tuple(float(b) for b in occupancy[1])
            # occupancy tuples may carry their dilation radius as a 3rd
            # element; conservatively assume the minimum (1) otherwise
            occ_dilate = int(occupancy[2]) if len(occupancy) > 2 else 1
            # probe step must stay under the grid's dilation margin so a
            # ray cannot step across an occupied cell unseen
            r = occ_grid.shape[0]
            cell = max((occ_bbox[3 + d] - occ_bbox[d]) / r for d in range(3))
            n_probe = int(np.ceil((s.far - s.near) / cell)) + 1
            # probe on a subsampled pixel lattice: neighbouring rays
            # diverge by at most q px, i.e. far*q/focal in world units —
            # sound as long as that stays under the grid's dilation
            # margin (>= 1 cell of the >=2-cell dilation is reserved for
            # the probe step itself, so subsampling needs dilate >= 2).
            # Cuts probe gathers q^2 x.
            occ_sub = 1
            if occ_dilate >= 2:
                for q in (4, 2):
                    if q * s.far / focal <= cell and H % q == 0 \
                            and W % q == 0:
                        occ_sub = q
                        break

        def fn(params, c2w):
            rays_o, rays_d = camera_rays(H, W, focal, c2w)
            ro = cst(jnp.pad(rays_o, ((0, n_pad), (0, 0))), "data")
            rd = cst(jnp.pad(rays_d, ((0, n_pad), (0, 0)),
                             constant_values=1.0), "data")
            stats = {}

            def coarse_chunks(cro, crd):
                # chunk axis sharded: every device cooperates on each
                # lax.map iteration (the map axis stays sequential)
                out = jax.lax.map(
                    lambda rr: render_rays(apply_fn, params, rr[0], rr[1],
                                           None, coarse_s, train=False),
                    (cst(cro.reshape(-1, chunk, 3), None, "data"),
                     cst(crd.reshape(-1, chunk, 3), None, "data")))
                m = cro.shape[0]
                return (out["rgb"].reshape(m, 3), out["acc"].reshape(m),
                        out["weights"].reshape(m, s.N_samples))

            bg = 1.0 if s.white_bkgd else 0.0
            if occupancy is None:
                sel1 = None                     # coarse set = all rays
                rgb1, acc1, w1 = coarse_chunks(ro, rd)
                k1_eff = n_full
                stats["coarse_rays"] = jnp.int32(n_full)
            else:
                # probe on the subsampled lattice (occ_sub px spacing; see
                # soundness note above), then broadcast to full res
                t_probe = jnp.linspace(s.near, s.far, n_probe)
                if occ_sub > 1:
                    sub = rays_d.reshape(H, W, 3)[occ_sub // 2::occ_sub,
                                                  occ_sub // 2::occ_sub]
                    act = rays_active(
                        jnp.broadcast_to(c2w[:3, 3], sub.reshape(-1, 3).shape),
                        sub.reshape(-1, 3), t_probe, occ_grid, occ_bbox)
                    act = jnp.repeat(jnp.repeat(
                        act.reshape(H // occ_sub, W // occ_sub),
                        occ_sub, axis=0), occ_sub, axis=1).reshape(-1)
                    active = jnp.pad(act, (0, n_pad))
                else:
                    active = rays_active(ro, rd, t_probe, occ_grid,
                                         occ_bbox)
                    active = active & (jnp.arange(n_full) < n)
                # stable partition (actives first, index order kept) ==
                # argsort(~active), via cumsum slots + one scatter
                # instead of a full-frame sort
                act_i = active.astype(jnp.int32)
                slot = jnp.where(
                    active, jnp.cumsum(act_i) - 1,
                    act_i.sum() + jnp.cumsum(1 - act_i) - 1)
                sel1 = jnp.zeros((n_full,), jnp.int32).at[slot].set(
                    jnp.arange(n_full, dtype=jnp.int32),
                    unique_indices=True)[:k1]
                rgb1, acc1, w1 = coarse_chunks(
                    jnp.take(ro, sel1, axis=0, unique_indices=True),
                    jnp.take(rd, sel1, axis=0, unique_indices=True))
                k1_eff = k1
                n_active = active.sum()
                stats["active_rays"] = n_active
                stats["coarse_overflow"] = jnp.maximum(n_active - k1, 0)
                stats["coarse_rays"] = jnp.int32(k1)

            # fine selection among the COARSE SURVIVORS (k1 rows — never
            # scattered back to full size): top-k by coarse opacity.
            # Padding-filler rays are forced to acc 0 so they sort last
            # (their ray data is garbage and must not win fine slots).
            k_eff = min(k, k1_eff)
            live1 = (jnp.arange(n_full) < n) if sel1 is None else (sel1 < n)
            acc1 = jnp.where(live1, acc1, 0.0)
            # top-k (ties lower-index-first) == argsort(-acc1)[:k_eff]
            _, sel2 = jax.lax.top_k(acc1, k_eff)
            # rays with real opacity beyond the fine budget render
            # coarse-only; report how many
            stats["fine_overflow"] = jnp.maximum(
                (acc1 > 1e-3).sum() - k_eff, 0)

            # fine pass reuses the SAVED coarse weights: the coarse MLP is
            # not re-evaluated for survivors (saves N_samples/(N_samples +
            # N_importance+N_samples) of the survivor FLOPs)
            t_coarse = stratified_sample(chunk, s.N_samples, s.near, s.far,
                                         key=None, lindisp=s.lindisp)

            def fine_chunk(rr):
                cro, crd, cw = rr
                vd = crd / jnp.linalg.norm(crd, axis=-1, keepdims=True)
                if s.ert_segments > 1:
                    return fine_stage_ert(apply_fn, params, cro, crd, vd,
                                          t_coarse, cw, s)["rgb"]
                return fine_stage(apply_fn, params, cro, crd, vd, t_coarse,
                                  cw, None, None, s, train=False)["rgb"]

            sel_full = (sel2 if sel1 is None else
                        jnp.take(sel1, sel2, unique_indices=True))
            fine = jax.lax.map(
                fine_chunk,
                (cst(jnp.take(ro, sel_full, axis=0,
                              unique_indices=True).reshape(-1, chunk, 3),
                     None, "data"),
                 cst(jnp.take(rd, sel_full, axis=0,
                              unique_indices=True).reshape(-1, chunk, 3),
                     None, "data"),
                 cst(jnp.take(w1, sel2, axis=0,
                              unique_indices=True).reshape(
                         -1, chunk, s.N_samples), None, "data")))
            # assemble: background -> coarse composite for the coarse set
            # -> fine for the fine set (row scatters with unique indices)
            if sel1 is None:
                rgb = rgb1
            else:
                rgb = jnp.full((n_full, 3), bg).at[sel1].set(
                    rgb1, unique_indices=True)
            rgb = rgb.at[sel_full].set(fine.reshape(k_eff, 3),
                                       unique_indices=True)[:n]
            if out_dtype == jnp.uint8:
                rgb = jnp.round(jnp.clip(rgb, 0.0, 1.0) * 255.0
                                ).astype(jnp.uint8)
            else:
                rgb = rgb.astype(out_dtype)
            return (rgb, stats) if return_stats else rgb

        if mesh is None:
            return jax.jit(fn)
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        rep = NamedSharding(mesh, _P())
        return jax.jit(fn, in_shardings=(rep, rep))

    def render(self, batch, params=None, key=None, train=False):
        """Reference-contract entry: batch has rays_o/rays_d shaped
        (B, N_rays, 3); returns (rgb_values, depth_values) flattened to
        (B*N_rays, ...) like volume_renderer.py:301-303,432."""
        params = params if params is not None else self._params
        rays_o = jnp.asarray(batch["rays_o"]).reshape(-1, 3)
        rays_d = jnp.asarray(batch["rays_d"]).reshape(-1, 3)
        if not train and self.settings.fast_sampling and \
                self.settings.N_importance > 0:
            out = self.render_image_fast(params, rays_o, rays_d)
        else:
            out = self.render_rays_batch(params, rays_o, rays_d, key=key,
                                         train=train)
        return out["rgb"], out["depth"]


def make_renderer(cfg, network) -> Renderer:
    return Renderer(network, cfg=cfg)
