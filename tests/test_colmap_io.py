import numpy as np

from nerf_replication_tpu.utils.colmap.model_io import (
    Camera,
    Image,
    qvec2rotmat,
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
    rotmat2qvec,
    write_cameras_binary,
    write_cameras_text,
    write_images_binary,
    write_images_text,
)


def _fixture():
    cams = {1: Camera(1, "PINHOLE", 640, 480,
                      np.array([500.0, 510.0, 320.0, 240.0]))}
    q = np.array([0.9238795, 0.0, 0.3826834, 0.0])
    q = q / np.linalg.norm(q)
    imgs = {
        2: Image(2, q, np.array([0.1, -0.2, 3.0]), 1, "r_0.png",
                 np.array([[1.0, 2.0], [3.5, 4.5]]),
                 np.array([7, -1], dtype=np.int64)),
    }
    return cams, imgs


def test_text_roundtrip(tmp_path):
    cams, imgs = _fixture()
    write_cameras_text(cams, str(tmp_path / "cameras.txt"))
    write_images_text(imgs, str(tmp_path / "images.txt"))
    cams2 = read_cameras_text(str(tmp_path / "cameras.txt"))
    imgs2 = read_images_text(str(tmp_path / "images.txt"))
    np.testing.assert_allclose(cams2[1].params, cams[1].params)
    assert cams2[1].model == "PINHOLE"
    np.testing.assert_allclose(imgs2[2].qvec, imgs[2].qvec)
    np.testing.assert_allclose(imgs2[2].xys, imgs[2].xys)
    assert imgs2[2].name == "r_0.png"


def test_binary_roundtrip(tmp_path):
    cams, imgs = _fixture()
    write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    write_images_binary(imgs, str(tmp_path / "images.bin"))
    cams2 = read_cameras_binary(str(tmp_path / "cameras.bin"))
    imgs2 = read_images_binary(str(tmp_path / "images.bin"))
    np.testing.assert_allclose(cams2[1].params, cams[1].params)
    np.testing.assert_allclose(imgs2[2].tvec, imgs[2].tvec)
    np.testing.assert_array_equal(imgs2[2].point3D_ids, imgs[2].point3D_ids)


def test_quaternion_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        R = qvec2rotmat(q)
        # R must be a rotation
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-10)
        q2 = rotmat2qvec(R)
        if q2[0] < 0:
            q2 = -q2
        np.testing.assert_allclose(q2, q, atol=1e-8)


def test_colmap2nerf_pose_conversion(tmp_path):
    """End-to-end: write a tiny text model, convert, check transforms."""
    import json
    import subprocess
    import sys

    cams, imgs = _fixture()
    write_cameras_text(cams, str(tmp_path / "cameras.txt"))
    write_images_text(imgs, str(tmp_path / "images.txt"))
    out = tmp_path / "transforms.json"
    res = subprocess.run(
        [sys.executable, "scripts/colmap2nerf.py",
         "--text", str(tmp_path), "--images", str(tmp_path),
         "--out", str(out), "--keep_colmap_coords"],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    data = json.loads(out.read_text())
    assert len(data["frames"]) == 1
    assert abs(data["camera_angle_x"] - 2 * np.arctan(640 / (2 * 500))) < 1e-6
    M = np.array(data["frames"][0]["transform_matrix"])
    # camera-to-world: M @ w2c(openGL-flipped) == identity
    R = qvec2rotmat(imgs[2].qvec)
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = imgs[2].tvec
    c2w = np.linalg.inv(w2c)
    c2w[:3, :3] = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    np.testing.assert_allclose(M, c2w, atol=1e-8)


def test_images_text_zero_observation_image(tmp_path):
    """COLMAP writes an EMPTY POINTS2D line for images with no points;
    the positional pairing must not desynchronise."""
    cams, imgs = _fixture()
    imgs[5] = Image(5, imgs[2].qvec, np.array([1.0, 2.0, 3.0]), 1,
                    "r_1.png", np.zeros((0, 2)),
                    np.zeros((0,), dtype=np.int64))
    write_images_text(imgs, str(tmp_path / "images.txt"))
    imgs2 = read_images_text(str(tmp_path / "images.txt"))
    assert set(imgs2) == {2, 5}
    assert imgs2[5].xys.shape == (0, 2)
    np.testing.assert_allclose(imgs2[2].xys, imgs[2].xys)
    # zero-obs image FIRST (followed by a populated one) must also pair
    order = {5: imgs[5], 2: imgs[2]}
    write_images_text(order, str(tmp_path / "images2.txt"))
    imgs3 = read_images_text(str(tmp_path / "images2.txt"))
    assert imgs3[5].xys.shape == (0, 2)
    np.testing.assert_allclose(imgs3[2].xys, imgs[2].xys)
