"""Frequency (NeRF positional) encoding.

Capability parity with reference src/models/encoding/freq.py:2-33:
identity passthrough + [sin, cos] at log-spaced bands 2^0 .. 2^(freq-1).
Output dim = input_dim * (1 + 2*freq).

Pure function + a thin param-free module wrapper; XLA fuses it into one
elementwise op chain, no kernel needed.
"""

from __future__ import annotations

import jax.numpy as jnp


def freq_encode(x: jnp.ndarray, n_freqs: int, include_input: bool = True) -> jnp.ndarray:
    """Encode (..., D) -> (..., D*(include_input + 2*n_freqs)).

    Band layout matches the reference: for each frequency f = 2^i the
    features [sin(f*x), cos(f*x)] over all input dims, frequencies ordered
    i = 0..n_freqs-1, identity first.
    """
    feats = [x] if include_input else []
    freqs = 2.0 ** jnp.arange(n_freqs, dtype=x.dtype)
    xb = x[..., None] * freqs                      # (..., D, F)
    sin = jnp.moveaxis(jnp.sin(xb), -1, -2)        # (..., F, D)
    cos = jnp.moveaxis(jnp.cos(xb), -1, -2)        # (..., F, D)
    # flat order: [f0: sin(all dims), cos(all dims); f1: ...] — matches the
    # reference loop `for freq: for fn in (sin, cos): fn(x*freq)`
    # (freq.py:18-26)
    sc = jnp.stack([sin, cos], axis=-2)            # (..., F, 2, D)
    feats.append(sc.reshape(*x.shape[:-1], -1))
    return jnp.concatenate(feats, axis=-1)


class FrequencyEncoder:
    """Param-free encoder object exposing ``output_dim`` like the reference
    encoder modules (freq.py:28-33)."""

    def __init__(self, input_dim: int = 3, freq: int = 10, include_input: bool = True):
        self.input_dim = input_dim
        self.n_freqs = freq
        self.include_input = include_input
        self.output_dim = input_dim * (int(include_input) + 2 * freq)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return freq_encode(x, self.n_freqs, self.include_input)
