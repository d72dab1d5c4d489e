"""Encoder dispatch.

Parity with reference src/models/encoding/__init__.py:6-86 ``get_encoder``:
the same config ``type`` names dispatch to this package's encoders. The
reference's ``cuda_*`` names are kept as aliases of the Pallas/XLA
implementations (there is no CUDA here). Notes on reference quirks:

* ``sphere_harmonics`` is a no-op passthrough in the reference
  (__init__.py:79-80); we implement real spherical harmonics.
* ``grid_hash`` references an undefined class in the reference
  (__init__.py:81-84, NameError); we map it to the hash-grid encoder.

Returned encoders are callables with an ``output_dim`` attribute;
parameterised ones (hash grids, triplanes, deformation nets) are Flax
modules.
"""

from __future__ import annotations

from .freq import FrequencyEncoder, freq_encode


def get_encoder(enc_cfg):
    t = enc_cfg.type
    if t == "frequency":
        return FrequencyEncoder(
            input_dim=enc_cfg.get("input_dim", 3),
            freq=enc_cfg.get("freq", 10),
            include_input=bool(enc_cfg.get("include_input", True)),
        )
    if t == "sphere_harmonics":
        from .sh import SHEncoder
        return SHEncoder(degree=enc_cfg.get("degree", 4),
                         input_dim=enc_cfg.get("input_dim", 3))
    if t in ("hashgrid", "cuda_hashgrid", "grid_hash"):
        from .hashgrid import HashGridEncoder
        return HashGridEncoder.from_cfg(enc_cfg)
    if t in ("triplane", "cuda_triplane"):
        from .triplane import TriPlaneEncoder
        return TriPlaneEncoder.from_cfg(enc_cfg)
    if t == "cuda_hashgrid_latent":
        from .hashgrid import HashLatentEncoder
        return HashLatentEncoder.from_cfg(enc_cfg)
    if t == "cuda_hashgrid_4d":
        from .hashgrid import HashGrid4DEncoder
        return HashGrid4DEncoder.from_cfg(enc_cfg)
    if t == "cuda_hashgrid_coef":
        from .hashgrid import HashCoefEncoder
        return HashCoefEncoder.from_cfg(enc_cfg)
    if t == "cuda_motion2d":
        from .triplane import Motion2DEncoder
        return Motion2DEncoder.from_cfg(enc_cfg)
    if t in ("dnerf", "dnerf_mlp_tensorf", "dnerf_ngp_mlp", "dnerf_ngp_tensorf",
             "cuda_dnerf_ngp_tensorf"):
        from .dnerf import DNeRFEncoder
        return DNeRFEncoder.from_cfg(enc_cfg, variant=t)
    raise ValueError(f"unknown encoder type: {t!r}")


__all__ = ["get_encoder", "FrequencyEncoder", "freq_encode"]
