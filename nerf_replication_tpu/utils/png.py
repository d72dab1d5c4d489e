"""PNG codec and PIL-style resampling in numpy and zlib.

``write_png`` stores 8-bit L, RGB or RGBA images with filter 0 on every
row. ``read_png`` reads non-interlaced 8-bit grayscale, RGB and RGBA
files with any of the five row filters (0-4), as written
by Pillow or by ``write_png``. ``resize`` resamples like Pillow's
``Image.resize`` for 8-bit images (nearest, bilinear, box), computed in
float: results agree with Pillow's fixed-point output to +-1, or +-2 for
RGBA with alpha >= 128 (Pillow premultiplies alpha in 8 bits, which
loses more where alpha is small).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the 8-bit types this codec handles
_CHANNELS = {0: 1, 2: 3, 6: 4}
_TYPES = {c: t for t, c in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """img (H, W) or (H, W, C) uint8 with C in (1, 3, 4) -> PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _TYPES:
        raise ValueError(f"write_png: {c} channels unsupported")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of decompressed scanlines."""
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:        # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            cur = line + prior
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            cur = line.astype(np.int64)
            up = prior.astype(np.int64)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                if ftype == 3:
                    pred = (a + int(up[i])) >> 1
                else:
                    c = int(up[i - bpp]) if i >= bpp else 0
                    pred = _paeth(a, int(up[i]), c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """PNG file -> uint8 (H, W) for grayscale, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_SIG), [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: only non-interlaced 8-bit L/RGB/RGBA PNGs are "
            f"supported (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


# -- resampling ------------------------------------------------------------------

def _weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) resampling matrix of Pillow's separable filters."""
    scale = n_in / n_out
    m = np.zeros((n_out, n_in), np.float64)
    if method == "nearest":
        src = np.minimum(((np.arange(n_out) + 0.5) * scale).astype(np.int64),
                         n_in - 1)
        m[np.arange(n_out), src] = 1.0
        return m
    if method == "bilinear":
        support, filt = 1.0, lambda x: np.maximum(1.0 - np.abs(x), 0.0)
    elif method == "box":
        support = 0.5
        filt = lambda x: ((x >= -0.5) & (x < 0.5)).astype(np.float64)
    else:
        raise ValueError(f"unknown resample method {method!r}")
    fscale = max(scale, 1.0)
    support *= fscale
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = np.arange(lo, hi)
        k = filt((x - center + 0.5) / fscale)
        if k.sum() > 0:
            m[o, lo:hi] = k / k.sum()
    return m


def resize(img: np.ndarray, size: tuple[int, int],
           method: str = "bilinear") -> np.ndarray:
    """uint8 (H, W[, C]) -> uint8 (h, w[, C]) for ``size=(w, h)``, the
    argument order of ``PIL.Image.resize``."""
    w, h = size
    img = np.asarray(img)
    if img.shape[:2] == (h, w):
        return img
    wy = _weights(img.shape[0], h, method)
    wx = _weights(img.shape[1], w, method)
    a = img.astype(np.float64)
    rgba = a.ndim == 3 and a.shape[-1] == 4
    if rgba:    # Pillow resamples RGBA with premultiplied alpha
        a[..., :3] *= a[..., 3:] / 255.0
    out = np.tensordot(wy, a, axes=(1, 0))
    out = np.swapaxes(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
    if rgba:
        alpha = out[..., 3:]
        out[..., :3] = np.where(alpha > 0, out[..., :3] * 255.0
                                / np.maximum(alpha, 1e-12), 0.0)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
