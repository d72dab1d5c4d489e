"""Visualization helpers (parity: src/utils/vis_utils.py, 36 LoC)."""

from __future__ import annotations

import numpy as np

from .img_utils import colorize, horizon_concate, visualize_depth_numpy


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray):
    """Write ``img`` (float in [0,1] or uint8) as a PNG file."""
    from .png import write_png

    write_png(path, to_uint8(img) if img.dtype != np.uint8 else img)


def compare_images(gt: np.ndarray, pred: np.ndarray, error_gain: float = 4.0):
    """[gt | pred | amplified error] strip for eval dumps."""
    err = np.abs(np.asarray(gt, np.float32) - np.asarray(pred, np.float32))
    err_vis = colorize(np.clip(err.mean(-1) * error_gain, 0, 1))
    strip = horizon_concate(np.asarray(gt, np.float32),
                            np.asarray(pred, np.float32))
    return horizon_concate(strip, err_vis)


__all__ = ["to_uint8", "save_image", "compare_images", "colorize",
           "horizon_concate", "visualize_depth_numpy"]
