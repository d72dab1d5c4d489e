"""PNG codec and resampling (utils/png.py) against Pillow."""

import struct
import zlib

import numpy as np
import pytest

from nerf_replication_tpu.utils.png import read_png, resize, write_png

Image = pytest.importorskip("PIL.Image")

MODES = {"L": 1, "RGB": 3, "RGBA": 4}


def _image(c, h=23, w=31, seed=0):
    yy, xx = np.mgrid[:h, :w]
    rng = np.random.default_rng(seed)
    smooth = (np.sin(xx / 5.0) * np.cos(yy / 7.0) + 1.0) * 120.0
    chans = [smooth, smooth[::-1], smooth[:, ::-1], 255.0 - smooth / 2.0]
    img = np.stack(chans[:c], -1) + rng.integers(0, 8, (h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("mode", list(MODES))
def test_round_trip_and_pillow_reads_ours(mode, tmp_path):
    img = _image(MODES[mode])
    path = str(tmp_path / "a.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    pil = Image.open(path)
    assert pil.mode == mode
    np.testing.assert_array_equal(np.asarray(pil), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img, ftype):
    """PNG bytes with row filter ``ftype`` on every row (test-side
    encoder, PNG spec section 9)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            pred = np.array([_paeth(a, b, cc)
                             for a, b, cc in zip(left, up, ul)])
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_reads_each_row_filter(ftype, tmp_path):
    img = _image(4, seed=ftype)
    path = tmp_path / f"f{ftype}.png"
    path.write_bytes(_filtered_png(img, ftype))
    # Pillow agrees the file holds img, so the file is a valid PNG
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(str(path)), img)


@pytest.mark.parametrize("mode", list(MODES))
def test_reads_pillow_written_files(mode, tmp_path):
    """Pillow picks row filters adaptively (sub, up and Paeth on these
    images); the decode must match Pillow's own."""
    for seed in range(3):
        img = _image(MODES[mode], seed=seed)
        path = str(tmp_path / f"p{seed}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("method,pil", [
    ("nearest", "NEAREST"), ("bilinear", "BILINEAR"), ("box", "BOX")])
def test_resize_matches_pillow(method, pil):
    img = _image(3, h=40, w=50)
    ours = resize(img, (25, 20), method).astype(int)
    theirs = np.asarray(Image.fromarray(img).resize(
        (25, 20), getattr(Image, pil))).astype(int)
    # float resampling vs Pillow's 8-bit fixed point
    assert np.abs(ours - theirs).max() <= 1
