"""PyTorch + CUDA port of the short-read mapper.

The JAX package `bucketmap_tpu` is the reference; this package computes
the same results with torch tensors on an explicit device, on one device
or over a (data, bucket) mesh of torch.distributed ranks, and runs its
kernels (coarse score, presence gather, chunk scan, fine window,
sequential tally, banded DP) as hand-written CUDA C++ for Hopper
(`csrc/`). On a CPU tensor each kernel wrapper takes its plain PyTorch
version instead. No module here imports jax; the JAX package's host-only
modules (config, index builder, FASTQ and SAM IO, simulator,
`parallel/distributed.py:shard_fastq`) are reused as they are.
"""
