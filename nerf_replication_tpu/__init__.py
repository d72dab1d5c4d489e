"""nerf_replication_tpu — a NeRF replication framework in JAX.

A JAX/XLA/Pallas framework with the capabilities of the
rkin100g/Nerf-Replication reference (PyTorch/CUDA): SPMD over device
meshes, one fused XLA program per render, a Pallas (Triton) kernel for
the hash-grid encode on the GPU.

Importing the package turns off XLA's Triton GEMMs on the GPU (cuBLAS
runs the dots instead) unless ``XLA_FLAGS`` already names
``--xla_gpu_enable_triton_gemm``. With them, on an H100 under JAX 0.9,
this package's MLP dots returned wrong values now and then: one compiled
800x800 frame program gave frames that differed by up to 0.9 in a pixel
from run to run, and two builds of one occupancy grid differed. With
cuBLAS both are repeatable and the frame matches the dense render. XLA
reads the flag when it first uses the GPU, so import the package before
any JAX computation.
"""

import os as _os

TRITON_GEMM_FLAG = "--xla_gpu_enable_triton_gemm"
if TRITON_GEMM_FLAG not in _os.environ.get("XLA_FLAGS", ""):
    _os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "") + " "
                                + TRITON_GEMM_FLAG + "=false").strip()

__version__ = "0.1.0"
