"""tdnnf_nas_torch — PyTorch/CUDA port of ``tdnnf_nas_tpu`` for NVIDIA Hopper.

Sub-packages mirror the JAX package.  Host-side graph, LM, tree and egs
code is carried as numpy copies (the JAX package's host modules import
``jax`` on the way); the device side is PyTorch, with the blocked and the
dense denominator scans as hand-written CUDA kernels (``csrc/``) built
with ``nvcc`` at first use (``ops/cuda_build.py``).  This package never
imports ``jax``.
"""
