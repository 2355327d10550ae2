"""Command line for the torch port, with the JAX package's subcommands:

  bucketmap-tpu-torch index  -g genome.fasta -i IND [--index-dir DIR] [params]
  bucketmap-tpu-torch map    -i IND -q reads.fastq -o out.sam [--align]
                             [--device cuda|cpu] [params]
  bucketmap-tpu-torch simulate -g genome.fasta -o DIR --name sim -n 100000 [...]
  bucketmap-tpu-torch analyze-sam out.sam --fastq reads.fastq [--ground-truth f]
  bucketmap-tpu-torch analyze-fastq reads.fastq

(`python -m bucketmap_tpu_torch.cli ...`). Flags, files, printed reports
and exit codes are the JAX package's `bucketmap_tpu/cli.py`: `index`
writes the files its `index` writes (refusing an existing artifact
without --force, before the build), `simulate` the same FASTQ and truth
files for a seed. `index`, `simulate` and the analyzers run on the host.
`map` adds --device (default cuda): with no usable CUDA device it fails;
it maps on the CPU only when --device cpu is given. It loads the index
that `index` (of either package) saved, or the reference's
.qgram/.bucket_id/.kmers_index with -g.
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


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="bucketmap-tpu-torch",
        description="DNA read mapper, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_idx = sub.add_parser("index", help="build the bucket index (-x mode)")
    p_idx.add_argument("-g", "--genome", required=True)
    p_idx.add_argument("-i", "--index-indicator", required=True)
    p_idx.add_argument("--index-dir", default=".")
    p_idx.add_argument("--export-reference-format", action="store_true",
                       help="also write .qgram/.bucket_id/.kmers_index")
    p_idx.add_argument("--no-fine-index", action="store_true",
                       help="skip the positional fine index (slower fine "
                            "stage, smaller artifact)")
    p_idx.add_argument("--force", action="store_true",
                       help="overwrite an existing index artifact (the "
                            "default refuses, like the reference's "
                            "utils.h:104-144 guards)")
    _add_param_flags(p_idx)

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

    p_sim = sub.add_parser("simulate", help="generate simulated reads + ground truth")
    p_sim.add_argument("-g", "--genome", required=True)
    p_sim.add_argument("-o", "--output-dir", required=True)
    p_sim.add_argument("--name", default="sim")
    p_sim.add_argument("-c", "--count", type=int, default=100000)
    p_sim.add_argument("--substitution-rate", type=float, default=0.002)
    p_sim.add_argument("--insertion-rate", type=float, default=0.00025)
    p_sim.add_argument("--deletion-rate", type=float, default=0.00025)
    p_sim.add_argument("--no-error", action="store_true")
    p_sim.add_argument("--seed", type=int, default=0)
    _add_param_flags(p_sim)

    p_asam = sub.add_parser("analyze-sam", help="score a SAM against ground truth")
    p_asam.add_argument("sam")
    p_asam.add_argument("--fastq", required=True)
    p_asam.add_argument("--ground-truth", default=None)
    p_asam.add_argument("--best-alignment", default=None)
    p_asam.add_argument("--fasta", default=None)
    p_asam.add_argument("--dwgsim", action="store_true")
    p_asam.add_argument("--tolerance", type=int, default=5)

    p_afq = sub.add_parser("analyze-fastq", help="FASTQ statistics")
    p_afq.add_argument("fastq")
    return parser


def _index(args) -> int:
    from bucketmap_tpu_torch.index import builder
    from bucketmap_tpu_torch.utils.debug import resource_report

    cfg = _config_from(args)
    # refuse to clobber BEFORE the (expensive) build, like the
    # reference's pre-index guard (bucket_indexer.h:178-186)
    base = os.path.join(args.index_dir, args.index_indicator)
    if not args.force and os.path.exists(base + ".bmtpu.json"):
        print(f"[ERROR]\t\tThe index file already exists: "
              f"{base}.bmtpu.json (use --force to overwrite).",
              file=sys.stderr)
        return 1
    t0 = time.time()
    index = builder.build_index_from_fasta(args.genome, cfg, verbose=True)
    if not args.no_fine_index:
        builder.build_fine_index(index)
    builder.save_index(index, args.index_dir, args.index_indicator,
                       overwrite=args.force)
    if args.export_reference_format:
        builder.export_reference_format(index, args.index_dir,
                                        args.index_indicator,
                                        overwrite=args.force)
    print(f"[BENCHMARK]\tElapsed time for creating and storing index files: "
          f"{time.time()-t0:.2f} s ({index.n_buckets} buckets).")
    print(f"[BENCHMARK]\tMaximum resident set size: "
          f"{resource_report()['peak_host_rss_kb']} KB.")
    return 0


def _map(args) -> int:
    import torch

    from bucketmap_tpu_torch.index import builder
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.utils.debug import resource_report

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
    rsrc = resource_report()
    hbm = rsrc["device_hbm_peak_bytes"]
    print(f"[BENCHMARK]\tMaximum resident set size: "
          f"{rsrc['peak_host_rss_kb']} KB"
          + (f"; device HBM peak: {hbm} bytes." if hbm is not None
             else "."))
    return 0


def _simulate(args) -> int:
    from bucketmap_tpu_torch.sim.simulator import ShortReadSimulator

    cfg = _config_from(args)
    sim = ShortReadSimulator(
        cfg, substitution_rate=args.substitution_rate,
        insertion_rate=args.insertion_rate,
        deletion_rate=args.deletion_rate, seed=args.seed)
    sim.read(args.genome)
    paths = sim.generate(args.output_dir, args.name, args.count,
                         simulate_error=not args.no_error)
    for k, v in paths.items():
        print(f"[INFO]\t\t{k}: {v}")
    return 0


def _analyze_sam(args) -> int:
    from bucketmap_tpu_torch.bench.sam_analyzer import SamAnalyzer

    an = SamAnalyzer(error_tolerance=args.tolerance)
    if args.fasta:
        an.read_fasta_file(args.fasta)
    an.read_sequence_file(args.fastq, is_dwgsim=args.dwgsim)
    if args.ground_truth:
        an.read_ground_truth_file(args.ground_truth)
    if args.best_alignment:
        an.read_best_alignment_file(args.best_alignment)
    an.benchmark(args.sam)
    return 0


def _analyze_fastq(args) -> int:
    from bucketmap_tpu_torch.bench.fastq_analyzer import analyze_fastq

    analyze_fastq(args.fastq)
    return 0


_COMMANDS = {"index": _index, "map": _map, "simulate": _simulate,
             "analyze-sam": _analyze_sam, "analyze-fastq": _analyze_fastq}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return _COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
