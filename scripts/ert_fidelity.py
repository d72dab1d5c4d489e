#!/usr/bin/env python
"""Measure segmented-ERT fidelity vs the dense-exact frame renderer on
the trained flagship checkpoint: renders the same 800x800 frame with
ert_segments in {1, 2} and reports PSNR / max pixel diff between them."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("BENCH_FRAMES", "1")
import numpy as np, jax, jax.numpy as jnp, dataclasses
from nerf_replication_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

from nerf_replication_tpu.config import default_cfg, load_cfg_tree
from nerf_replication_tpu.models import make_network
from nerf_replication_tpu.models.nerf.renderer.volume_renderer import Renderer, RenderSettings
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain
from nerf_replication_tpu.ops.occupancy import build_occupancy_grid
from nerf_replication_tpu.ops.ray_ops import density_activation
from nerf_replication_tpu.evaluators.metrics import psnr_uint8

os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
cfg = load_cfg_tree("configs/nerf/lego.yaml", default_cfg())
net = make_network(cfg)
params = load_pretrain("data/pretrain/hard")
params = jax.tree.map(jnp.asarray, params)
H = W = 800
focal = 0.5 * W / np.tan(0.5 * 0.6911112070083618)
settings = dataclasses.replace(RenderSettings.from_cfg(cfg), ray_chunk=40000,
                               fast_sampling=True, density_activation="softplus")
renderer = Renderer(net, settings=settings, mesh=None)
act = density_activation("softplus")
apply_fn = renderer.apply_fn
def density_fn(p, pts):
    return act(apply_fn(p, pts[:, None, :], jnp.zeros((1, 1, 3)), "fine")[:, 0, 3])
grid, bbox = build_occupancy_grid(density_fn, params, resolution=64, threshold=0.05, dilate=2)
occ = (grid, bbox, 2)

from nerf_replication_tpu.utils.synthetic_scene import look_at_pose
pose = look_at_pose(np.array([2.5, 2.5, 2.0], np.float32))

imgs = {}
for nseg, frac in ((1, ()), (2, (0.5,)), (2, (0.35,))):
    st = dataclasses.replace(settings, ert_segments=nseg, ert_frac=frac)
    renderer.settings = st
    fr = renderer.make_frame_renderer(H, W, focal, capacity=0.35,
                                      coarse_capacity=0.4,
                                      out_dtype=jnp.uint8, occupancy=occ)
    img = np.asarray(fr(params, jnp.asarray(pose, jnp.float32)))
    imgs[(nseg, frac)] = img.astype(np.float32) / 255.0
    print("nseg", nseg, frac, "done", flush=True)
base = imgs[(1, ())]
for k, im in imgs.items():
    if k == (1, ()):
        continue
    p = psnr_uint8(im.reshape(H, W, 3), base.reshape(H, W, 3))
    diff = np.abs(im - base)
    print("PSNR%s vs dense: %.2f dB; maxdiff %.4f; pixels>1.5/255: %.5f" %
          (k, p, diff.max(), (diff.max(-1) > (1.5/255)).mean()), flush=True)
