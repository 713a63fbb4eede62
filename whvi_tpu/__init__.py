"""whvi_tpu — Walsh-Hadamard Variational Inference in JAX, for NVIDIA GPUs.

A from-scratch JAX / XLA framework with the capabilities of the
reference PyTorch implementation (ltdung/WHVI): functional core over
parameter pytrees, explicit PRNG keys, one jitted train step, mesh
sharding for scale. It runs on one or more NVIDIA H100 cards (and on
the CPU for tests). See SURVEY.md for the reference structural analysis
this build follows.
"""

__version__ = "0.5.0"
