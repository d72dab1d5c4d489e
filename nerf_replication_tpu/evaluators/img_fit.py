"""img_fit evaluator (parity: src/evaluators/img_fit.py:14-40):
float PSNR, side-by-side gt/pred image (PNG here; the reference writes
a jpg), metrics.json dump."""

from __future__ import annotations

import json
import os

import numpy as np

from ..registry import register
from .metrics import psnr


class Evaluator:
    def __init__(self, cfg=None):
        self.cfg = cfg
        self.psnrs: list[float] = []
        self.result_dir = cfg.result_dir if cfg is not None else None
        if self.result_dir:
            os.makedirs(os.path.join(self.result_dir, "vis"), exist_ok=True)

    def evaluate(self, output, batch) -> dict:
        H = int(np.asarray(batch["meta"]["H"]).reshape(-1)[0])
        W = int(np.asarray(batch["meta"]["W"]).reshape(-1)[0])
        pred = np.asarray(output["rgb"]).reshape(H, W, 3)
        gt = np.asarray(batch["rgb"]).reshape(H, W, 3)
        val = psnr(gt, pred, data_range=1.0)
        self.psnrs.append(val)
        if self.result_dir:
            from ..utils.png import write_png

            side = np.concatenate([gt, pred], axis=1)
            write_png(os.path.join(self.result_dir, "vis", "res.png"),
                      (np.clip(side, 0, 1) * 255).astype(np.uint8))
        return {"psnr": val}

    def summarize(self) -> dict:
        ret = {"psnr": float(np.mean(self.psnrs)) if self.psnrs else 0.0}
        print(ret)
        self.psnrs = []
        if self.result_dir:
            with open(os.path.join(self.result_dir, "metrics.json"), "w") as f:
                json.dump(ret, f)
        return ret


@register("evaluator", "img_fit", aliases=(
    "src.evaluators.img_fit", "nerf_replication_tpu.evaluators.img_fit"))
def _make_img_fit_evaluator(cfg):
    return Evaluator(cfg)
