"""Blender / NeRF-synthetic dataset (host side).

Capability parity with reference src/datasets/nerf/blender.py: loads
``transforms_{split}.json`` + PNGs, computes intrinsics from
``camera_angle_x`` (blender.py:102-103), train split returns a random
N_rays-pixel subsample per image (106-111), test/val return all H*W
pixels (112-115) plus depth/normal maps and H/W/id (56-65, 148-157).
Rays are generated in the world frame with normalised directions
(120-127).

Documented quirk fixes vs the reference:
* honors ``cfg.scene`` — the reference hardcodes ``"lego"``
  (blender.py:28).
* honors ``cams`` [start, stop, step] frame selection and ``test_skip``
  — accepted but unused in the reference.
* alpha channel is composited onto the background
  (``rgb*a + bg*(1-a)``, standard NeRF) instead of dropped
  (blender.py:53); set ``keep_alpha_quirk: True`` to reproduce the
  reference behavior.
* N_rays comes from ``task_arg.N_rays`` — the reference hardcodes 1024
  (blender.py:107).

This class is the parity/API path; the training hot loop uses the
device-resident pipeline in ``nerf_replication_tpu.datasets.pipeline``
built from ``as_arrays()``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ...registry import register
from ...utils.png import read_png, resize


def _load_png(path: str, size: tuple[int, int], resample: str) -> np.ndarray:
    return resize(read_png(path), size, resample).astype(np.float32)


class Dataset:
    def __init__(self, cfg=None, **kwargs):
        self.data_root = kwargs.get("data_root", "data/nerf_synthetic")
        scene = (cfg.get("scene", "lego") if cfg is not None else
                 kwargs.get("scene", "lego"))
        self.scene_root = os.path.join(self.data_root, scene)
        self.split = kwargs.get("split", "val")
        self.H = int(kwargs.get("H", 800))
        self.W = int(kwargs.get("W", 800))
        self.input_ratio = float(kwargs.get("input_ratio", 1.0))
        ta = cfg.get("task_arg", {}) if cfg is not None else {}
        self.n_rays = int(ta.get("N_rays", 1024))
        self.white_bkgd = bool(ta.get("white_bkgd", True))
        self.keep_alpha_quirk = bool(ta.get("keep_alpha_quirk", False))
        test_skip = int(ta.get("test_skip", 1))
        cams = kwargs.get("cams", [0, -1, 1])
        self._rng = np.random.default_rng(kwargs.get("seed", None))

        with open(os.path.join(self.scene_root, f"transforms_{self.split}.json")) as f:
            meta = json.load(f)
        self.camera_angle_x = float(meta["camera_angle_x"])

        if self.input_ratio != 1.0:
            self.H = int(self.H * self.input_ratio)
            self.W = int(self.W * self.input_ratio)

        frames = meta["frames"]
        start, stop, step = (list(cams) + [0, -1, 1])[:3]
        stop = len(frames) if stop == -1 else stop
        frames = frames[start:stop:step]
        if self.split in ("test", "val") and test_skip > 1:
            frames = frames[::test_skip]

        size = (self.W, self.H)
        self.images = []       # (H, W, 3) float32 in [0, 1]
        self.poses = []        # (4, 4) float32 c2w
        self.depths = []
        self.normals = []
        self.alphas = []       # (H, W) float32 GT coverage (when RGBA)
        for frame in frames:
            img_path = os.path.join(self.scene_root, frame["file_path"] + ".png")
            img = _load_png(img_path, size, "bilinear") / 255.0
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            if img.shape[-1] == 4:
                self.alphas.append(img[..., 3].astype(np.float32))
                if self.keep_alpha_quirk:
                    img = img[..., :3]
                else:
                    bg = 1.0 if self.white_bkgd else 0.0
                    img = img[..., :3] * img[..., 3:] + bg * (1.0 - img[..., 3:])
            self.images.append(img.astype(np.float32))
            self.poses.append(np.array(frame["transform_matrix"], dtype=np.float32))

            if self.split == "test":
                dpath = os.path.join(
                    self.scene_root, frame["file_path"] + "_depth_0001.png")
                npath = os.path.join(
                    self.scene_root, frame["file_path"] + "_normal_0001.png")
                if os.path.exists(dpath):
                    self.depths.append(
                        _load_png(dpath, size, "nearest"))
                if os.path.exists(npath):
                    self.normals.append(
                        _load_png(npath, size, "bilinear") / 255.0)

    # -- intrinsics ----------------------------------------------------------
    @property
    def focal(self) -> float:
        return self.W / (2.0 * np.tan(self.camera_angle_x / 2.0))

    def intrinsics(self) -> np.ndarray:
        f = self.focal
        return np.array(
            [[f, 0, self.W / 2.0], [0, f, self.H / 2.0], [0, 0, 1.0]],
            dtype=np.float32,
        )

    # -- ray generation ------------------------------------------------------
    def _rays_for_pixels(self, pose: np.ndarray, u: np.ndarray, v: np.ndarray):
        f = self.focal
        cx, cy = self.W / 2.0, self.H / 2.0
        dirs = np.stack(
            [(u - cx) / f, -(v - cy) / f, -np.ones_like(u, dtype=np.float32)], -1
        )
        rays_d = dirs @ pose[:3, :3].T
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape).copy()
        return rays_o.astype(np.float32), rays_d.astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        image = self.images[index]
        pose = self.poses[index]
        if self.split == "train":
            idx = self._rng.choice(self.H * self.W, self.n_rays, replace=False)
            u = (idx % self.W).astype(np.float32)
            v = (idx // self.W).astype(np.float32)
        else:
            us, vs = np.meshgrid(np.arange(self.W), np.arange(self.H))
            u = us.ravel().astype(np.float32)
            v = vs.ravel().astype(np.float32)
        colors = image[v.astype(np.int64), u.astype(np.int64)]
        rays_o, rays_d = self._rays_for_pixels(pose, u, v)

        out = {
            "colors": colors,
            "rays_o": rays_o,
            "rays_d": rays_d,
            "H": np.int32(self.H),
            "W": np.int32(self.W),
            "id": np.int32(index),
            # camera for pose-based fast renderers (extra keys are
            # harmless to the reference contract)
            "pose": pose.astype(np.float32),
            "focal": np.float32(self.focal),
        }
        if self.split == "test":
            if index < len(self.depths):
                out["depth"] = self.depths[index][
                    v.astype(np.int64), u.astype(np.int64)]
            if index < len(self.normals):
                out["normal"] = self.normals[index][
                    v.astype(np.int64), u.astype(np.int64)]
        return out

    def __len__(self) -> int:
        return len(self.images)

    # -- device pipeline feed --------------------------------------------
    def as_arrays(self):
        """Whole split as stacked arrays for the device-resident sampler:
        (images (N,H,W,3) f32, poses (N,4,4) f32, K (3,3) f32)."""
        return (
            np.stack(self.images),
            np.stack(self.poses),
            self.intrinsics(),
        )

    def alpha_arrays(self):
        """(N, H, W) float32 GT coverage, or None when the source images
        carried no alpha channel (random-background training needs it)."""
        if len(self.alphas) != len(self.images):
            return None
        return np.stack(self.alphas)


@register("dataset", "nerf.blender", aliases=(
    "src.datasets.nerf.blender", "nerf_replication_tpu.datasets.nerf.blender"))
def _make_blender(cfg, **kwargs):
    return Dataset(cfg=cfg, **kwargs)
