"""PyTorch + CUDA port of the short-read mapper.

The JAX package `bucketmap_tpu` is the reference; this package computes
the same results with torch tensors on an explicit device, on one device
or over a (data, bucket) mesh of torch.distributed ranks, and runs its
kernels (coarse score, presence gather, chunk scan, fine window,
sequential tally, banded DP) as hand-written CUDA C++ for Hopper
(`csrc/`). On a CPU tensor each kernel wrapper takes its plain PyTorch
version instead. No module here imports jax or anything of the JAX
package: the host modules (config, index builder, FASTA/FASTQ/SAM IO and
the native host library, sampler, simulator, `shard_fastq`) are the
port's own copies, laid out as in the JAX package, so the port runs
where only torch is installed.
"""
