"""PyTorch + CUDA port of the align-free short-read map path.

The JAX package `bucketmap_tpu` is the reference; this package computes
the same results with torch tensors on an explicit device, and runs its
three hot kernels (coarse score, fine window, sequential tally) as
hand-written CUDA C++ for Hopper (`csrc/`). On a CPU tensor each kernel
wrapper takes its plain PyTorch version instead. No module here imports
jax; the JAX package's host-only modules (config, index builder, FASTQ
and SAM IO, simulator) are reused as they are.
"""
