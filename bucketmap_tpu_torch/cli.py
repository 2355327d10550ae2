"""Command line for the torch port: the `map` subcommand.

  python -m bucketmap_tpu_torch.cli map -i IND -q reads.fastq -o out.sam \\
      [--index-dir DIR] [--batch-size N] [--device cuda|cpu] [params]

Same flags as the JAX package's `map` command, plus --device (default
cuda); --align aligns every location (CIGARs, DP-based MAPQ).
With --device cuda and no usable CUDA device it fails; it maps on the
CPU only when --device cpu is given. Index artifacts are those
`index/builder.py:save_index` writes, the same files the JAX package's
`index` command writes, or the reference's .qgram/.bucket_id/.kmers_index
with -g.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from bucketmap_tpu_torch.config import MapperConfig


def _add_param_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", "--index-seed", type=int, default=9)
    p.add_argument("-l", "--query-seed", type=int, default=12)
    p.add_argument("-r", "--read-len", type=int, default=300)
    p.add_argument("-s", "--mapper-samples", type=int, default=15)
    p.add_argument("-d", "--distinguishability", type=float, default=0.5)
    p.add_argument("-b", "--average-base-quality", type=int, default=25)
    p.add_argument("-e", "--max-error-rate", type=float, default=0.4)
    p.add_argument("-n", "--max-indel-rate", type=float, default=0.02)
    p.add_argument("-p", "--locator-samples", type=int, default=10)
    p.add_argument("-u", "--quality", type=int, default=40)
    p.add_argument("-f", "--kmer-frac", type=float, default=1.0)
    p.add_argument("--bucket-len", type=int, default=65536)


def _config_from(args) -> MapperConfig:
    return MapperConfig(
        bucket_len=args.bucket_len, read_len=args.read_len,
        index_seed=args.index_seed, query_seed=args.query_seed,
        mapper_samples=args.mapper_samples,
        distinguishability=args.distinguishability,
        average_base_quality=args.average_base_quality,
        seed_miss_rate=args.max_error_rate, indel_rate=args.max_indel_rate,
        locator_samples=args.locator_samples, quality_threshold=args.quality,
        kmer_fraction=args.kmer_frac)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bucketmap-tpu-torch",
        description="DNA read mapper, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_map = sub.add_parser("map", help="map reads to SAM")
    p_map.add_argument("-q", "--query-file", required=True)
    p_map.add_argument("-i", "--index-indicator", required=True)
    p_map.add_argument("-o", "--output-file", required=True)
    p_map.add_argument("--index-dir", default=".")
    p_map.add_argument("-g", "--genome", default=None,
                       help="FASTA (only needed when loading a reference-format index)")
    p_map.add_argument("--align", action="store_true",
                       help="banded alignment with CIGARs")
    p_map.add_argument("--batch-size", type=int, default=1024)
    p_map.add_argument("--device", default="cuda",
                       help="torch device to map on (default cuda)")
    _add_param_flags(p_map)
    args = parser.parse_args(argv)

    import torch

    from bucketmap_tpu_torch.index import builder
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        print(f"[ERROR]\t\tbad --device {args.device!r}: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda" and not torch.cuda.is_available():
        print("[ERROR]\t\tCUDA is not available (torch.cuda.is_available() "
              "is false); pass --device cpu to map on the CPU.",
              file=sys.stderr)
        return 1

    cfg = _config_from(args)
    base = os.path.join(args.index_dir, args.index_indicator)
    if os.path.exists(base + ".bmtpu.json"):
        index = builder.load_index(args.index_dir, args.index_indicator)
    elif os.path.exists(base + ".qgram"):
        index = builder.import_reference_format(
            args.index_dir, args.index_indicator, cfg, args.genome)
    else:
        print(f"[ERROR]\t\tno index named {args.index_indicator} in "
              f"{args.index_dir}", file=sys.stderr)
        return 1
    pipe = BucketMapPipeline(index, device=device, align=args.align,
                             batch_size=args.batch_size,
                             pair_batch=args.batch_size)
    t0 = time.time()
    stats = pipe.map_fastq(args.query_file, args.output_file)
    dt = time.time() - t0
    print(f"[BENCHMARK]\tElapsed time for bucket mapping: {dt:.2f} s "
          f"({dt*1e6/max(1,stats.num_reads):.1f} us/seq) on {device}.")
    print(f"[BENCHMARK]\tReads with at least one candidate bucket: "
          f"{stats.reads_with_candidates} "
          f"({100.0*stats.reads_with_candidates/max(1,stats.num_reads):.2f}%).")
    print(f"[BENCHMARK]\tTotal mapped locations: {stats.mapped_locations} "
          f"({stats.mapped_locations/max(1,stats.num_reads):.3f} per sequence).")
    if device.type == "cuda":
        print(f"[BENCHMARK]\tDevice memory peak: "
              f"{torch.cuda.max_memory_allocated(device)} bytes.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
