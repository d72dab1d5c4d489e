"""NeRF evaluator: per-image MSE/PSNR/SSIM + PNG dumps.

Capability parity with reference src/evaluators/nerf.py:14-132 —
float MSE on clipped images (:100-103), uint8-quantized PSNR (:23-30),
win-7 channel-last SSIM on uint8 images (:69-78), pred/gt PNG dumps to
``result_dir/images/view{i:03d}_{pred,gt}.png`` (:55-62), and
``summarize() -> {mse, psnr, ssim}`` means (:123-132).
"""

from __future__ import annotations

import os

import numpy as np

from ..registry import register
from .metrics import psnr_uint8, ssim


class Evaluator:
    def __init__(self, cfg=None):
        self.cfg = cfg
        self.mse: list[float] = []
        self.psnr: list[float] = []
        self.ssim: list[float] = []
        self.result_dir = (
            os.path.join(cfg.result_dir, "images") if cfg is not None else None
        )
        self.save_images = cfg is None or bool(cfg.get("save_result", True))

    def _dump(self, img_pred, img_gt, view_id: int):
        if not self.result_dir:
            return
        from ..utils.png import write_png

        os.makedirs(self.result_dir, exist_ok=True)
        for tag, img in (("pred", img_pred), ("gt", img_gt)):
            write_png(
                os.path.join(self.result_dir, f"view{view_id:03d}_{tag}.png"),
                (np.clip(img, 0, 1) * 255).astype(np.uint8))

    def evaluate(self, output, batch) -> dict:
        """output: (rgb_pred, depth_pred) tuple or dict with 'rgb';
        batch: colors/H/W/id (reference evaluate(), nerf.py:80-120)."""
        if isinstance(output, dict):
            rgb_pred = output["rgb"]
        else:
            rgb_pred = output[0]
        rgb_pred = np.clip(np.asarray(rgb_pred).reshape(-1, 3), 0, 1)
        rgb_gt = np.clip(
            np.asarray(batch["colors"])[..., :3].reshape(-1, 3), 0, 1)

        mse = float(np.mean((rgb_pred - rgb_gt) ** 2))
        self.mse.append(mse)
        self.psnr.append(psnr_uint8(rgb_pred, rgb_gt))

        H = int(np.asarray(batch["H"]).reshape(-1)[0])
        W = int(np.asarray(batch["W"]).reshape(-1)[0])
        view_id = int(np.asarray(batch.get("id", 0)).reshape(-1)[0])
        assert H * W == rgb_pred.shape[0], (
            f"rgb size mismatch: H*W={H * W} vs N_rays={rgb_pred.shape[0]}")
        pred_img = rgb_pred.reshape(H, W, 3)
        gt_img = rgb_gt.reshape(H, W, 3)

        if self.save_images:
            self._dump(pred_img, gt_img, view_id)
        p8 = (pred_img * 255).astype(np.uint8)
        g8 = (gt_img * 255).astype(np.uint8)
        self.ssim.append(ssim(p8, g8, win_size=7, channel_axis=2))
        return {"mse": mse, "psnr": self.psnr[-1], "ssim": self.ssim[-1]}

    def summarize(self) -> dict:
        out = {
            "mse": float(np.mean(self.mse)) if self.mse else 0.0,
            "psnr": float(np.mean(self.psnr)) if self.psnr else 0.0,
            "ssim": float(np.mean(self.ssim)) if self.ssim else 0.0,
        }
        self.mse, self.psnr, self.ssim = [], [], []
        return out


@register("evaluator", "nerf", aliases=(
    "src.evaluators.nerf", "nerf_replication_tpu.evaluators.nerf"))
def _make_nerf_evaluator(cfg):
    return Evaluator(cfg)
