"""Film grain synthesis engine in JAX (VFGS capability parity).

A JAX/XLA/Pallas implementation of InterDigital's Versatile Film Grain
model: FGC SEI (frequency-filtering + auto-regressive) and AFGS1 metadata
drive a sample-adapted grain blending engine, vectorized over whole frames
with GF(2) LFSR jump-ahead replacing the reference's serial PRNG.
Bit-exact with the C model; one fused Triton kernel per batch on NVIDIA
GPUs; shards over frames and tile rows on device meshes.
"""

from .pipeline import GrainPipeline
from .models.hw import HwRegs
from .models import config as fgs_config

__version__ = "0.1.0"
__all__ = ["GrainPipeline", "HwRegs", "fgs_config"]
