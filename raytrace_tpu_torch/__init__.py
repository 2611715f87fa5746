"""raytrace_tpu_torch: the PyTorch + CUDA port of raytrace_tpu.

The same whistler ray tracer (Haselgrove ray equations over the Stix cold
plasma dispersion relation, dipole field, CA1992 plasmasphere) for one
NVIDIA H100: plain functions on tensors, with the stepping engine a
hand-written CUDA kernel (csrc/step_chunk.cu). Module paths mirror the
JAX package's, so every module has its counterpart there; the JAX package
is the reference the port's tests hold it to. This package never imports
jax or raytrace_tpu.
"""

from . import constants

__version__ = "0.1.0"
