"""2D image-fitting network (uv -> rgb MLP).

Capability parity with reference src/models/img_fit/network.py:8-55:
freq-encoded uv through a D×W relu MLP with a sigmoid RGB head;
``forward(batch)`` calling convention returning ``{"rgb": ...}``. The
reference's chunked ``batchify`` (network.py:40-50) is unnecessary under
XLA — one matmul batch.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..encoding import get_encoder
from ..module import Dense, Module


class ImgFitMLP(Module):
    depth: int = 4
    width: int = 128
    uv_encoder: Any = None
    dtype: Any = jnp.float32

    def setup(self):
        self.backbone = [Dense(self.width, dtype=self.dtype)
                         for _ in range(self.depth)]
        self.output = Dense(3, dtype=self.dtype)

    def __call__(self, batch: dict) -> dict:
        uv = jnp.asarray(batch["uv"])
        shape = uv.shape[:-1]
        x = self.uv_encoder(uv.reshape(-1, uv.shape[-1])).astype(self.dtype)
        for layer in self.backbone:
            x = jax.nn.relu(layer(x))
        rgb = jax.nn.sigmoid(self.output(x))
        return {"rgb": rgb.astype(jnp.float32).reshape(*shape, 3)}


def make_network(cfg):
    c = cfg.network
    return ImgFitMLP(
        depth=c.get("D", 4),
        width=c.get("W", 128),
        uv_encoder=get_encoder(c.uv_encoder),
        dtype=jnp.dtype(c.get("dtype", "float32")),
    )
