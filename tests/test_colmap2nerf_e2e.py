"""End-to-end colmap2nerf: a synthetic COLMAP binary model round-trips
through the converter into a transforms.json the Blender loader parses,
with poses surviving the OpenCV->OpenGL conversion exactly."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
from PIL import Image as PILImage

from nerf_replication_tpu.utils.colmap.model_io import (
    Camera,
    Image,
    rotmat2qvec,
    write_cameras_binary,
    write_images_binary,
)
from nerf_replication_tpu.utils.synthetic_scene import look_at_pose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_model(tmp_path, n_views=6, radius=2.5):
    """Synthetic reconstruction: cameras orbiting the origin."""
    sparse = tmp_path / "sparse"
    imgdir = tmp_path / "images"
    sparse.mkdir()
    imgdir.mkdir()

    cams = {1: Camera(1, "PINHOLE", 64, 48,
                      np.array([70.0, 70.0, 32.0, 24.0]))}
    flip = np.diag([1.0, -1.0, -1.0])
    imgs = {}
    gl_poses = []
    rng = np.random.default_rng(0)
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = np.array([radius * np.cos(a), radius * np.sin(a), 1.0],
                       np.float32)
        c2w_gl = look_at_pose(eye).astype(np.float64)
        gl_poses.append(c2w_gl)
        # OpenGL c2w -> COLMAP (OpenCV) w2c
        c2w_cv = c2w_gl.copy()
        c2w_cv[:3, :3] = c2w_cv[:3, :3] @ flip
        w2c = np.linalg.inv(c2w_cv)
        name = f"r_{i:03d}.png"
        imgs[i + 1] = Image(
            i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            rng.uniform(0, 64, (3, 2)), np.array([1, 2, 3], np.int64))
        PILImage.fromarray(
            rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
                str(imgdir / name))
    write_cameras_binary(cams, str(sparse / "cameras.bin"))
    write_images_binary(imgs, str(sparse / "images.bin"))
    return sparse, imgdir, gl_poses


def _run_converter(argv):
    old = sys.argv
    sys.argv = ["colmap2nerf.py"] + argv
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "colmap2nerf.py"),
                       run_name="__main__")
    finally:
        sys.argv = old


def test_colmap2nerf_end_to_end(tmp_path):
    sparse, imgdir, gl_poses = _make_model(tmp_path)
    out = tmp_path / "transforms.json"
    _run_converter(["--text", str(sparse), "--images", str(imgdir),
                    "--out", str(out), "--keep_colmap_coords"])

    with open(out) as f:
        meta = json.load(f)
    assert len(meta["frames"]) == 6
    # intrinsics: fov from PINHOLE fl_x=70, w=64
    np.testing.assert_allclose(
        meta["camera_angle_x"], 2 * np.arctan(32.0 / 70.0), rtol=1e-6)
    assert meta["aabb_scale"] == 16

    # poses survive the CV->GL round trip exactly (sorted by image name)
    for i, fr in enumerate(meta["frames"]):
        np.testing.assert_allclose(
            np.array(fr["transform_matrix"]), gl_poses[i], atol=1e-6)
        assert fr["sharpness"] > 0.0  # images existed and were scored

    # recentred/rescaled variant: cameras land at ~radius 4 (lego-like)
    out2 = tmp_path / "transforms_scaled.json"
    _run_converter(["--text", str(sparse), "--images", str(imgdir),
                    "--out", str(out2)])
    with open(out2) as f:
        meta2 = json.load(f)
    d = [np.linalg.norm(np.array(fr["transform_matrix"])[:3, 3])
         for fr in meta2["frames"]]
    np.testing.assert_allclose(np.mean(d), 4.0, rtol=0.25)


@pytest.mark.parametrize("model,params,want", [
    # COLMAP fisheye parameter orders (reference colmap2nerf.py:251-269)
    ("SIMPLE_RADIAL_FISHEYE", [70.0, 32.0, 24.0, 0.03],
     {"fl_x": 70.0, "fl_y": 70.0, "cx": 32.0, "cy": 24.0, "k1": 0.03,
      "k2": 0.0, "k3": 0.0, "k4": 0.0}),
    ("RADIAL_FISHEYE", [70.0, 32.0, 24.0, 0.03, -0.01],
     {"fl_x": 70.0, "fl_y": 70.0, "cx": 32.0, "cy": 24.0, "k1": 0.03,
      "k2": -0.01, "k3": 0.0, "k4": 0.0}),
    ("OPENCV_FISHEYE", [70.0, 68.0, 32.0, 24.0, 0.03, -0.01, 0.002,
                        -0.0005],
     {"fl_x": 70.0, "fl_y": 68.0, "cx": 32.0, "cy": 24.0, "k1": 0.03,
      "k2": -0.01, "k3": 0.002, "k4": -0.0005}),
])
def test_colmap2nerf_fisheye_models(tmp_path, model, params, want):
    """Fisheye camera models convert with correct k1-k4 fields and the
    is_fisheye flag (reference scripts/colmap2nerf.py:36,251-269)."""
    sparse, imgdir, _ = _make_model(tmp_path)
    from nerf_replication_tpu.utils.colmap.model_io import (
        write_cameras_binary as _wcb,
    )
    _wcb({1: Camera(1, model, 64, 48, np.array(params))},
         str(sparse / "cameras.bin"))
    out = tmp_path / "transforms_fe.json"
    _run_converter(["--text", str(sparse), "--images", str(imgdir),
                    "--out", str(out), "--keep_colmap_coords"])
    with open(out) as f:
        meta = json.load(f)
    assert meta["is_fisheye"] is True
    for key, val in want.items():
        np.testing.assert_allclose(meta[key], val, rtol=1e-9,
                                   err_msg=f"{model}:{key}")
    np.testing.assert_allclose(
        meta["camera_angle_x"], 2 * np.arctan(32.0 / 70.0), rtol=1e-6)


def test_colmap2nerf_pinhole_not_fisheye(tmp_path):
    """Non-fisheye models keep is_fisheye False and zero k3/k4."""
    sparse, imgdir, _ = _make_model(tmp_path)
    out = tmp_path / "transforms.json"
    _run_converter(["--text", str(sparse), "--images", str(imgdir),
                    "--out", str(out), "--keep_colmap_coords"])
    with open(out) as f:
        meta = json.load(f)
    assert meta["is_fisheye"] is False
    assert meta["k3"] == 0.0 and meta["k4"] == 0.0


def test_colmap2nerf_output_feeds_blender_loader(tmp_path):
    """The converter's transforms.json is consumable by the Blender
    dataset class (the real-capture ingestion contract)."""
    sparse, imgdir, _ = _make_model(tmp_path)
    scene_dir = tmp_path / "capture"
    scene_dir.mkdir()
    out = scene_dir / "transforms_train.json"
    _run_converter(["--text", str(sparse),
                    "--images", str(imgdir), "--out", str(out)])

    from nerf_replication_tpu.datasets.nerf.blender import Dataset

    ds = Dataset(None, data_root=str(tmp_path), scene="capture",
                 split="train", H=48, W=64, input_ratio=1.0)
    assert len(ds.images) == 6
    item = ds[0]
    assert item["rays_o"].shape[-1] == 3
