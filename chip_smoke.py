#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mbp 1700] [--reads 131072]

Phases, each reported on its own line:
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, whether nvcc and triton are present; exits non-zero
     without a CUDA device;
  2. build: the eight CUDA kernels of the six sources in
     bucketmap_tpu_torch/csrc, one nvcc for sm_90a per source, all
     started together, and the C++ host library from csrc/host with g++;
  3. world: the bench world (bench.py's seeded repeat genome, index and
     simulated 300 bp reads), cached under .bench_cache/;
  4. main path: BucketMapPipeline(..., device="cuda").map_fastq over all
     reads in batches of 16384, writing SAM; checks accuracy against the
     ground truth and that every kernel was launched;
  5. map-stage kernels against their plain PyTorch versions on the main
     path's own inputs from one batch (fine_search, the tiled vote's
     search, on the first vote chunk's lanes; fine_window, off the map
     path since the fused search, on the same chunk's windows; the fused
     search's proposals those of fine_window and the plain-torch pass
     around it): exact equality; each kernel's
     device time (a spin kernel keeps the device ahead of the host; the
     L2 flushed before each launch, and warm), its time as one call on
     an idle device, its bound from this run's inputs and its share of
     it; the coarse score also at 32 samples per read-strand (six bit
     planes, the batch's sample rows regrouped), and at the full batch
     (exact against its plain version, and its device time and bound);
     the first chunk's vote search before the fused kernel (174
     launches) and after it, one call on an idle device each, in turns;
     fine_search word for word against fine_search_plain where its
     narrowing decides: 4096 lanes on the map table's segments longer
     than 128 slots (its deepest included), and on a made table whose
     segments need one to three ballot rounds (up to 200,000 slots);
  6. align mode: BucketMapPipeline(..., align=True).map_fastq over the
     same reads, DP sub-batches of 16384 pairs; checks accuracy, CIGAR
     lengths and that the fused DP (dp_runs) and every map-stage kernel
     launched;
  7. the DP kernels on phase 6's first sub-batch: the packed-ops path
     (BandedAligner.align_batch, the dp_fwd kernel and the per-cell
     traceback) on its first 4096 located pairs, dp_fwd launched and its
     scores those of dp_runs; dp_fwd and dp_runs against their plain
     versions on those pairs (exact, times, bounds), dp_runs also at
     band 128 on random pairs (both wrap rules) and at Q 8192, where the
     strip lives in device scratch; at the full 16384-pair sub-batch
     both kernels' device times and bounds, the whole sub-batch's
     vector (unpack, windows, dp_runs, packing) word for word the one
     dp_runs_plain gives, and that call's time on an idle device;
  8. the mesh step on torch.distributed (nccl, one rank, mesh (1, 1)):
     the staged coarse branch's two kernels against their plain versions
     on phase 5's rows (exact, times; the chunk scan also at 32 samples;
     the presence gather also at the full batch and on ragged shapes:
     widths 811, 300 and 100 words, 7 and 1001 samples, nq 1, 4 and 16,
     repeated rows), one batch through the mesh step
     with each coarse path (word for word the single-device step of
     phase 5), then BucketMapPipeline(mesh=..., coarse_path="staged")
     over all reads: SAM byte for byte phase 4's, the accuracy floors,
     and the staged kernels launched in place of the fused one;
  9. vote paths and device builds: (a) the occupancy table built on the
     device equals the host table word for word, timed beside its
     upload, and a step on it equals phase 5's vector; (b) with no fine
     tables (vote path "scan") one batch equals phase 5's vector, ms per
     vote chunk and the device peak, and the map of all reads gives
     phase 4's SAM byte for byte, tally launched and neither fine_search
     nor fine_window;
     (c) on a 100 Mbp bench world (the JAX package builds the 2-D
     packed, prefix and positional tables only on the host, in numpy:
     minutes and ~17 GB of host memory at 1.7 Gbp) one batch through the
     tiled, packed, prefix, sorted and scan paths, the five vectors equal
     word for word, with ms per vote chunk for each;
 10. the command line in this process (`cli.main`): `map --device cuda`
     on the bench world's saved index, align-free and --align, SAMs byte
     for byte phases 4 and 6's, the map kernels (and dp_runs) launched;
     `analyze-sam` on phase 4's SAM (its mapped share score_sam's, both
     correct shares above the floor) and `analyze-fastq`; then on a 20
     Mbp repeat genome `index --export-reference-format`, `simulate`,
     `map` from the saved and from the reference-format index, the
     second under utils.debug.validation_mode (the same SAM), and
     `analyze-sam` above the floors; each command's seconds and
     resource_report();
 11. the FM-index: FMIndex of a 4.6 Mbp random genome, the 32,768 seeds
     (max_errors=1) of 16,384 simulated reads searched by
     exact_search_batch on the card, equal to the CPU on every lane and
     to backward_search on the first 256 non-empty ranges, its ms per
     call and launches (torch.profiler through utils.debug.maybe_trace);
     FMIndexMapper, and FMIndexLocator (initialize, then locate), on the
     card against the CPU's mapper on 1,024 reads; a BiFMIndex of the
     genome's first 1 Mbp extended left and right over 256 seeded
     20-mers (backward_search's range); a BucketFMIndexer of the genome,
     saved and loaded, each of 256 seeded 20-mers found at its offset in
     its bucket's index;
 12. the research tree: (a) RepetitiveRegionFilter (k=9) over every
     bucket of the bench world's genome (profiles and the Jaccard matrix
     on the card), its 64 x 2,048 block at seeded bucket ids equal to the
     CPU's from those buckets' own profiles, symmetric, zero diagonal;
     seconds, device peak, pairs with JI > 0.5; (b) MLPBucketClassifier
     (k=9, d_model=2048) on a 20 Mbp random genome (306 buckets): three
     steps on the card and on the CPU from one seeded initialisation
     (losses within 1e-4 relative, parameters after step one within
     1e-5), then a fit of MLP_STEPS steps on the card, ms a step and its
     accuracy on 1,024 fresh reads (floor 0.5); (c) DQNAgent (k=6,
     d_model=512) on tests/test_research.py's environment, final average
     reward above 0.4; no kernel launched;
 13. experiments.error_sweep_production.run on the bench world's index
     and genome, 16,384 reads at each read length 100, 150 and 300 with
     0.2% substitutions and 0.025% indels; the 300 bp row at phase 4's
     floors, the map kernels launched;
 14. ONT long reads (bench.py's BMTPU_BENCH_LONG=1, cut from 100,000 to
     16,384 reads of ~7.5 kbp at 2% substitutions, insertions and
     deletions each) on phase 3's index at the reference's long-read
     flags (-s 30 -e 0.9 -n 0.1 -p 20 -u 5): (a) align-free, mapped >= 97
     and correct within bench.py's long-read tolerance (2% of the mean
     length, +-150 at 7.5 kbp) >= 93, the three map kernels against
     their plain versions on one batch of its segment rows (the coarse
     score at 30 samples, five bit planes; fine_search at p = 20; the
     tally at 160 proposals), the chunk's search before and after;
     (b) the segment-stitched align mode, mapped >= 97, correct within
     +-10 >= 95, every CIGAR consuming its SEQ, MAPQ in [0, 60]; dp_runs
     against dp_runs_plain on the stitcher's first DP sub-batch at the
     geometry that call uses (band 128, lo 32, no wrap rule, 48 runs a
     pair), the sub-batch's vector word for word; the host seconds of
     the stitching loop;
 15. the GRCh38-scale world (bench.py's BMTPU_BENCH_GENOME_MBP=3100
     BMTPU_BENCH_FRAC=0.25; repeat genome, FracMinHash f=0.25, cut from
     1,000,000 to 131,072 reads), after every earlier device table is
     freed: the seconds of the genome, the index, the reads and the
     device tables; the tiled fine table (~47,300 buckets, 3.1e9 slots,
     past 2^31 elements); map_fastq over all reads, mapped >= 97 and
     correct within +-10 >= 95; the map kernels against their plain
     versions on one batch, fine_window on windows past element 2^31 of
     its table (the batch's and windows made from the table's own slots
     up to its last), fine_search on rows past element 2^31 (the batch's
     lanes on buckets past it, and lanes made on those buckets up to the
     last), coarse_score at the full batch on the ~1,479-word
     occupancy table, and the batch's step vector through the tiled
     path word for word the scan path's (the JAX build's route here);
 16. bench_torch.py and the profilers, after phase 15 (its ONT and
     f=0.25 caches warm): the 1,000,000 reads of bench.py's default world
     simulated after phase 14 from the genome phase 3 made (their seconds
     on a line of their own); each bench_torch.py run in its own process,
     so that its host RSS is its own: (1) at bench.py's defaults,
     align-free, its accuracy columns BENCH_MODES_r05.json's (99.57 /
     98.48 / 98.48 / 1.2222), io_native, the map kernels launched; (2) in
     align mode at its defaults (batch 8,192), r05's 99.45 / 98.45 / 52.35
     / 1.5584, dp_runs launched, phase 6's CIGAR check on its SAM; (3) BMTPU_BENCH_LONG=1 on phase 14's 16,384 reads (the same
     cache names), align-free and in align mode, each run's columns
     phase 14's; (4) the 3.1 Gbp f=0.25 world on phase 15's reads, its
     columns phase 15's; then in this process (5) profile_step,
     profile_coarse_sub and profile_select on the first 16,384 reads of
     (1)'s FASTQ (the decomposition's vector step_packed's word for word,
     the staged branch's score the fused one's, each part's result its
     method's; the tables of device ms, launches and host ms by stage, and
     the vote search stage's on a line of its own) and
     profile_driver over 8 batches (the sequential cycle's SAM map_reads'
     byte for byte); (6) profile_grch38_warmup on phase 15's world (index
     load, init, first and steady batch), then profile_pipeline over 12
     batches of its reads; (7) the align, finewin, mesh and coarse
     profilers on the 1.7 Gbp world: profile_align on one full-width
     sub-batch (8,192 pairs; the decomposition's runs vector one
     _align_runs call's), profile_finewin at its defaults (40,960 pairs
     of (1)'s reads on their ground-truth buckets; the kernel and plain
     modes identical), profile_mesh "both" over 2 batches (the (1, 1)
     nccl mesh's decoded lanes and counts the single device's) and
     profile_coarse at 1,700 Mbp and 8,192 reads (rows A, B, D, E, K and
     S one checksum), each printing its tables and raising where a check
     fails or it launched none of its path's kernels (PROFILE_KERNELS).
Each phase checks the launches of the kernels its path runs (on the
tiled path fine_search once per live vote chunk, fine_window never; on
the others neither). Any failure
raises and exits non-zero, and so does finding jax, flax, optax, the JAX
package or its research tree imported. The last two lines are a JSON
object per kernel (with its launches in phases 14-15 under
"mode_launches") and the run's JSON result.
"""

from __future__ import annotations

import argparse
import filecmp
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16384
COARSE_ROWS = 2048            # read-strands compared in the coarse check
MIN_MAPPED, MIN_CORRECT = 97.0, 95.0
DP_PAIRS = 4096               # located pairs in the DP check
MAP_KERNELS = ("coarse_score", "fine_search", "tally")
ALIGN_KERNELS = MAP_KERNELS + ("dp_runs",)
STAGED_KERNELS = ("presence_gather", "chunk_scan", "fine_search", "tally")
# bounds: the published H100 SXM HBM3 rate, and the int32 rate of its CUDA
# cores (132 SMs x 64 INT32 lanes x 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
L2_FLUSH_BYTES = 256 << 20    # written before a cold launch: > the 50 MB L2
DP_OPS_PER_CELL = 15          # int ops of one DP cell's recurrence
SCRATCH_Q = 8192              # a query width whose band-128 strip needs scratch
WIDE_S = 32                   # samples per read-strand of the six-plane checks
FM_MIN_AT_TRUTH = 0.75        # FMIndexMapper (max_errors=1): reads at their locus
MLP_STEPS = 1000              # phase 12's fit of the k=9 MLP, 128 reads a step
MLP_MIN_ACCURACY = 0.5        # its floor on 1,024 fresh reads (chance 1/306)
MLP_GRAD_TOL = 1e-5           # step one's gradients, card against CPU,
                              # relative to each tensor's largest (float32
                              # sums of up to 2,048 terms in either order)
ONT_READS = 16384             # phase 14's long reads (bench.py: 100,000)
ONT_MIN_CORRECT_DRIFT = 93.0  # align-free, correct within bench.py's
                              # long-read tolerance (reference 95.68)
GRCH38_MBP, GRCH38_FRAC = 3100.0, 0.25   # phase 15's world
GRCH38_READS = 8 * BATCH      # its short reads (bench.py: 1,000,000)
WINDOW_MADE = 4096            # windows made from the 3.1 Gbp table's slots
DEEP_T = 2048                 # 128-slot rows a bucket of the made deep table
DEEP_SLOTS = 200_000          # its deepest segment: three ballot rounds
NARROW_LANES = 4096           # lanes of each narrowing check
PAST_ELEMENT = 2**31          # phase 15 holds fine_window and fine_search
                              # past this element
BENCH_READS = 1000000         # phase 16: bench.py's default read count
# BENCH_MODES_r05.json's accuracy columns at bench.py's defaults (the JAX
# build's 1,000,000-read runs on the 1.7 Gbp world): mapped, correct within
# +-10 and +-5, locations a read; the port computes the same integers
R05 = {"align-free": (99.57, 98.48, 98.48, 1.2222),
       "align": (99.45, 98.45, 52.35, 1.5584)}
DRIVER_BATCHES = 8            # phase 16's profile_driver cycles
PIPELINE_BATCHES = 12         # phase 16's profile_pipeline batches
# phase 16 (7): the kernels each profiler must launch
PROFILE_KERNELS = {"align": ("dp_fwd", "dp_runs"),
                   "finewin": ("fine_search", "tally"),
                   "mesh": ("coarse_score", "fine_search", "tally"),
                   "coarse": ("coarse_score", "presence_gather", "chunk_scan")}
ALIGN_PAIRS = 8192            # profile_align's pairs: one full sub-batch
FINEWIN_PAIRS = 40960         # profile_finewin's default pairs
MESH_BATCHES = 2              # profile_mesh "both" batches
COARSE_MBP, COARSE_READS = 1700.0, 8192   # profile_coarse's defaults


def log(msg: str) -> None:
    print(msg, flush=True)


def call_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over reps of one call between two CUDA events on an idle
    device, as the runs before the kernels' redesign timed them. Where the
    host takes longer to reach the launch (argument checks, allocation,
    the ctypes call) than the kernel takes to run, this is the host's
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


class DeviceTimer:
    """A kernel's time on the device alone: a spin kernel keeps the
    device busy while the host enqueues every timed call between its two
    CUDA events, so no event pair waits for the host (checked: the spin
    must outlast the enqueueing, else it runs again, longer). cold=True
    writes 256 MB before each call, so the call finds nothing of its
    inputs in the L2, as the main path finds its large tables."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush_buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                     device=device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        b.synchronize()
        self.cycles_per_ms = 10_000_000 / a.elapsed_time(b)

    def ms(self, fn, reps: int = 10, cold: bool = False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            if cold:
                self.flush_buf.fill_(i)
            fn()
        lead_ms = 2.0 * (time.perf_counter() - t0) / 3 * 1e3 * reps + 5.0
        torch.cuda.synchronize()
        for _ in range(4):
            starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
            ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
            torch.cuda._sleep(int(lead_ms * self.cycles_per_ms))
            gate = torch.cuda.Event()
            gate.record()
            for i in range(reps):
                if cold:
                    self.flush_buf.fill_(i)
                starts[i].record()
                fn()
                ends[i].record()
            ahead = not gate.query()
            torch.cuda.synchronize()
            if ahead:
                times = sorted(a.elapsed_time(b) for a, b in zip(starts, ends))
                return times[len(times) // 2]
            lead_ms *= 4
        raise RuntimeError("the host could not enqueue ahead of the device")


def unique_rows_bytes(torch, table, rows) -> int:
    """Bytes of the distinct table rows a gather reads, each once."""
    return torch.unique(rows).numel() * table.shape[1] * 4


def coarse_bound(torch, table, rows, s: int):
    """(bytes, int ops) of the coarse score on these rows: the distinct
    rows read once, the row indices, the three outputs; an AND per
    gathered row word, 3 ops per plane per sample word for the
    ripple-carry count, 4 per plane per output word for max and count."""
    R, nq = rows.shape
    w, planes = table.shape[1], s.bit_length()
    B2 = R // s
    return (unique_rows_bytes(torch, table, rows) + rows.numel() * 4
            + B2 * w * 4 * (2 + planes),
            R * w * (nq - 1 + 3 * planes) + B2 * w * 4 * planes)


def presence_bound(torch, table, rows):
    """(bytes, int ops) of the presence gather: distinct rows once, the
    indices, one output word per sample word; an AND per row word."""
    R, nq = rows.shape
    w = table.shape[1]
    return (unique_rows_bytes(torch, table, rows) + rows.numel() * 4
            + R * w * 4, R * w * (nq - 1))


def scan_bound(presence, s: int):
    """(bytes, int ops) of the chunk scan: the presence words once, the
    three outputs; as coarse_bound for the count and the max."""
    w, planes = presence.shape[-1], s.bit_length()
    outer = presence.numel() // (s * w)
    return (presence.numel() * 4 + outer * w * 4 * (2 + planes),
            presence.numel() * 3 * planes + outer * w * 4 * planes)


def window_bound(torch, ftf, frow, n_occ: int):
    """(bytes, int ops) of the fine window: each distinct 128-slot table
    row that a window covers read once, 16 bytes of arguments per window,
    its O output slots; 4 ops per window slot (mask, compare, range)."""
    f = frow.to(torch.int64).clamp(0, ftf.shape[0] - 3)
    sub = torch.unique(f[:, None] + torch.arange(3, device=f.device)).numel()
    R = frow.numel()
    return sub * 512 + R * 16 + R * n_occ * 4, R * 384 * 4


def search_bound(torch, fine_packed, fine_ptab, vote_bucket, lane_rc,
                 lane_read, samp_hash, samp_idx, lengths, k: int,
                 low_bits: int, search_steps: int):
    """(bytes, int ops) of the fine search on these lanes, each byte
    counted once: each distinct 128-slot table row that a row's window
    covers; the narrowing, taken as the plain version's probes (rows
    whose interval is not yet empty), one 32-byte sector per distinct
    probed sector that lies outside those window rows; each distinct
    32-byte fine_ptab sector of the segment bounds; each lane's bucket,
    strand and read, each distinct read's samples and length; the two
    (P, p*O) int32 outputs. 4 ops per window slot (mask, compare,
    range), as window_bound."""
    from bucketmap_tpu_torch.ops.vote import (MAX_OCC, WINDOW_ROWS, targets,
                                              window_args)

    rd = lane_read
    P, p = lane_read.shape[0], samp_hash.shape[1]
    args = (lane_rc, samp_hash[rd], samp_idx[rd], lengths[rd])
    (ftf, frow, *_), _ = window_args(fine_packed, fine_ptab, vote_bucket,
                                     *args, k, low_bits, search_steps)
    f = frow.to(torch.int64).clamp(0, ftf.shape[0] - WINDOW_ROWS)
    win_rows = torch.unique(f[:, None] + torch.arange(WINDOW_ROWS,
                                                      device=f.device))
    tgt_hash, _ = targets(*args, k)
    bid = vote_bucket[:, None]
    prefix = tgt_hash >> low_bits
    w = fine_ptab.shape[1]
    cells = bid * w + prefix
    sectors = torch.unique(torch.cat([cells, cells + 1]) * 4 // 32).numel()
    low_mask = (1 << low_bits) - 1
    low = tgt_hash & low_mask
    lo = fine_ptab[bid, prefix].to(torch.int64)
    hi = fine_ptab[bid, prefix + 1].to(torch.int64)
    lpos = fine_packed.shape[1] * 128
    probed = [win_rows[:0]]
    for _ in range(max(0, search_steps - 7)):
        active = lo < hi
        mid = (lo + hi) // 2
        mc = mid.clamp(0, lpos - 1)
        probed.append(torch.unique((bid * lpos + mc)[active] // 8))
        below = active & ((fine_packed[bid, mc // 128, mc % 128] & low_mask)
                          < low)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    probed = torch.unique(torch.cat(probed))       # 8 slots a sector
    outside = int((~torch.isin(probed // 16, win_rows)).sum())
    reads = torch.unique(rd).numel()
    return (win_rows.numel() * 512 + outside * 32 + sectors * 32 + P * 17
            + reads * (p * 16 + 4) + 2 * P * p * MAX_OCC * 4,
            frow.numel() * 384 * 4)


def tally_bound(torch, prop, valid, p: int, n_occ: int, indel: int):
    """(bytes, int ops) of the tally: the proposals and flags once, three
    outputs per pair; 5 ops per (valid step, live slot) comparison and 6
    per valid step, the live slots counted by running the vote."""
    P, S = prop.shape
    pos = torch.zeros_like(prop)
    created = torch.zeros(prop.shape, dtype=torch.bool, device=prop.device)
    ok = valid != 0
    comparisons = torch.zeros((), dtype=torch.int64, device=prop.device)
    for j in range(p):
        tol = torch.where(created.any(dim=1, keepdim=True), indel, 0)
        for o in range(n_occ):
            idx = j * n_occ + o
            pcur, v = prop[:, idx:idx + 1], ok[:, idx:idx + 1]
            comparisons += (created.sum(dim=1, keepdim=True) * v).sum()
            close = created & ((pos - pcur).abs() <= tol)
            hit = v & ~close.any(dim=1, keepdim=True)
            pos[:, idx:idx + 1] = torch.where(hit, pcur, pos[:, idx:idx + 1])
            created[:, idx:idx + 1] |= hit
    return (2 * P * S * 4 + 3 * P * 4,
            5 * int(comparisons) + 6 * int(ok.sum()))


def dp_bound(textp, qcodes, band: int):
    """(bytes, int ops) of the forward DP: the windows, queries, lengths
    and widths once, one direction byte per cell and the final row;
    DP_OPS_PER_CELL per cell of the Q x band strip of every pair."""
    P, W = textp.shape
    Q = qcodes.shape[1]
    return (P * W + P * Q + 8 * P + (Q + 1) * P * band + P * band * 4,
            P * Q * band * DP_OPS_PER_CELL)


def runs_bound(textp, qcodes, qlen, band: int, mr: int):
    """(bytes, int ops) of the fused DP: the inputs once, the five head
    rows and MR runs per pair; DP_OPS_PER_CELL per cell of the rows the
    traceback can reach (1..min(qlen, Q)) of every pair."""
    P, W = textp.shape
    Q = qcodes.shape[1]
    rows = int(qlen.clamp(0, Q).sum())
    return (P * W + P * Q + 8 * P + 5 * 4 * P + P * mr * 4,
            rows * band * DP_OPS_PER_CELL)


def random_pairs(torch, dev, P: int, Q: int, rate: float, seed: int):
    """(textp, qcodes, qlen, width, band, lo) on the card for the DP
    checks: random windows; per row, by row index mod 4, a copy of the
    window's first Q bases with 3% substitutions, a query that inserts
    one base after every two of its window from position 80 on (one run
    per base and a half), a random query, or a copy with a window cut
    short; qlen Q/2..Q (Q for the inserting rows)."""
    from bucketmap_tpu_torch.ops.align import band_geometry

    g = torch.Generator().manual_seed(seed)
    band, lo = band_geometry(Q, rate)
    text = torch.randint(0, 4, (P, Q + band), generator=g)
    kind = torch.arange(P) % 4
    qlen = torch.randint(Q // 2, Q + 1, (P,), generator=g)
    qlen[kind == 1] = Q
    m = torch.arange(Q)
    ins = text[:, (80 + 2 * (m // 3) + (m % 3 != 0).long())
               .clamp_max(Q + band - 1)]
    ins = torch.where(m % 3 == 2, (ins + 2) % 4, ins)
    sub = torch.rand((P, Q), generator=g) < 0.03
    copy = torch.where(sub, (text[:, :Q] + torch.randint(
        1, 4, (P, Q), generator=g)) % 4, text[:, :Q])
    q = torch.where((kind == 1)[:, None], ins, copy)
    q = torch.where((kind == 2)[:, None],
                    torch.randint(0, 4, (P, Q), generator=g), q)
    width = torch.minimum(qlen + 1 + (qlen * rate).long(),
                          torch.tensor(Q + band))
    width = torch.where(kind == 3, torch.randint(0, Q, (P,), generator=g),
                        width)
    text = torch.where(torch.arange(Q + band) < width[:, None], text, 4)
    textp = torch.nn.functional.pad(text, (lo, 0), value=4)
    return (textp.to(torch.uint8).to(dev), q.to(torch.uint8).to(dev),
            qlen.to(torch.int32).to(dev), width.to(torch.int32).to(dev),
            band, lo)


def dp_runs_shape_checks(torch, dev) -> None:
    """dp_runs against dp_runs_plain, exactly, on random pairs at band
    128 (Q 256) with each wrap rule, and at Q SCRATCH_Q, whose strip
    lives in device scratch."""
    from bucketmap_tpu_torch import kernels
    from bucketmap_tpu_torch.ops.align import dp_runs, dp_runs_plain

    for P, Q, seed in ((2048, 256, 1), (64, SCRATCH_Q, 2)):
        rp = random_pairs(torch, dev, P, Q, 0.1, seed)
        textp, band = rp[0], rp[4]
        scratch = kernels.library().bm_dp_runs_scratch_bytes(
            P, textp.shape[1], Q, band)
        if (scratch > 0) != (Q == SCRATCH_Q):
            raise RuntimeError(f"dp_runs at Q {Q}, band {band}: scratch "
                               f"bytes {scratch}")
        for wrap in ((True, False) if Q < SCRATCH_Q else (False,)):
            head = dp_runs_plain(*rp, wrap)[0]
            check_equal(torch, "dp_runs", f"{P} random pairs, Q {Q}, band "
                        f"{band}, wrap_star {wrap}, strip in "
                        f"{'device scratch' if scratch else 'shared memory'}"
                        f" (runs per row up to {int(head[2].max())}, "
                        f"{int(head[4].sum())} unterminated)",
                        lambda: dp_runs(*rp, wrap),
                        lambda: dp_runs_plain(*rp, wrap))


def bound_of(nbytes: int, nops: int):
    """(least ms, "bytes" or "operations") on the H100."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def compare(torch, kern, plain):
    """(equal, max_abs_err) of a kernel against its plain version on the
    same inputs."""
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    return (all(torch.equal(a, b) for a, b in zip(got, want)),
            max_abs_err(torch, got, want))


def check_kernel(torch, timer, name, src, replaces, kern, plain, shape,
                 bound, launches: int, main_launches: int) -> dict:
    """A kernel against its plain version on the same inputs (exact
    equality), its times and its bound; returns its report entry."""
    equal, err = compare(torch, kern, plain)
    cold = timer.ms(kern, cold=True)
    warm = timer.ms(kern)
    call = call_ms(torch, kern)
    plain_ms = call_ms(torch, plain, reps=5, warmup=1)
    bound_ms, bound_by = bound_of(*bound)
    log(f"[kernel] {name}: {shape}; equal {equal} max_abs_err {err}; device "
        f"{cold:.4f} ms with the L2 flushed, {warm:.4f} ms warm; one call on "
        f"an idle device {call:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({bound[0] / 1e6:.3f} MB, "
        f"{bound[1] / 1e6:.3f} M int ops), share {bound_ms / cold:.3f}; "
        f"launches on its path {launches}, on the main path {main_launches}")
    if not equal:
        raise RuntimeError(f"{name} disagrees with its plain version")
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": cold,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def check_equal(torch, name, what, kern, plain) -> None:
    """A kernel against its plain version on the same inputs, exactly,
    untimed."""
    equal, err = compare(torch, kern, plain)
    log(f"[kernel] {name}: {what}; equal {equal} max_abs_err {err}")
    if not equal:
        raise RuntimeError(f"{name} disagrees with its plain version ({what})")


def full_size(torch, timer, name, what, fn, bound) -> None:
    """Log a kernel's device time at a full batch beside its bound."""
    cold = timer.ms(fn, reps=5, cold=True)
    bound_ms, bound_by = bound_of(*bound)
    log(f"[kernel] {name} at {what}: device {cold:.4f} ms with the L2 "
        f"flushed; bound {bound_ms:.4f} ms by {bound_by} "
        f"({bound[0] / 1e9:.3f} GB, {bound[1] / 1e9:.3f} G int ops), share "
        f"{bound_ms / cold:.3f}")


def check_cigars(sam_path: str):
    """(records, records with CIGAR '*', records whose CIGAR's M+I length
    differs from the read length, records whose MAPQ lies outside
    [0, 60])."""
    n = star = bad = bad_mapq = 0
    with open(sam_path) as f:
        for line in f:
            if line[0] == "@":
                continue
            c = line.split("\t", 10)
            n += 1
            bad_mapq += not 0 <= int(c[4]) <= 60
            if c[5] == "*":
                star += 1
                continue
            num, qlen = 0, 0
            for ch in c[5]:
                if ch.isdigit():
                    num = num * 10 + ord(ch) - 48
                else:
                    qlen += num if ch in "MI" else 0
                    num = 0
            bad += qlen != len(c[9])
    return n, star, bad, bad_mapq


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def max_abs_err(torch, got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def map_kernel_cases(torch, pipe, batch):
    """The first BATCH segment rows of `batch` through the step of `pipe`
    up to each map kernel: (the four kernels' check_kernel cases, the
    step's inputs {"packed", "rows_all", "table", "wargs", "lanes"}). The
    coarse case takes COARSE_ROWS read-strands, the window, search and
    tally cases the first vote chunk; the fused search's proposals must
    be those of the window kernel and the plain-torch pass around it."""
    from bucketmap_tpu_torch.ops.coarse import coarse_score, coarse_score_plain
    from bucketmap_tpu_torch.ops.encoding import unpack_reads
    from bucketmap_tpu_torch.ops.vote import (fine_search, fine_search_plain,
                                              fine_window, fine_window_plain,
                                              tally, tally_plain)

    dm = pipe.device
    fl = dm.fine
    cfg = dm.cfg
    n_buckets = dm.index.n_buckets
    codes, quals, seg_len, _, _ = pipe._all_segments(batch)
    packed = dm.pack(codes[:BATCH], quals[:BATCH], seg_len[:BATCH])
    c, q_ok, lens = unpack_reads(packed, cfg.read_len, cfg.query_seed)
    both, _, _ = dm.coarse.sample_hashes(c, q_ok, lens)
    s = cfg.mapper_samples
    rows_all = dm.coarse.gram_rows(both)
    rows = rows_all[: COARSE_ROWS * s].contiguous()
    table = dm.coarse.qgram_words
    lanes = dm.compact_lanes(packed)
    sargs = (fl.fine_packed, fl.fine_ptab, *dm.chunk_lanes(lanes, 0),
             cfg.query_seed, fl.low_bits, fl.search_steps)
    targs = fl.search_lanes(*dm.chunk_lanes(lanes, 0))
    vargs = dm.chunk_args(lanes, 0)
    wargs, tgt_idx = fl.window_args(*vargs)
    P, p = vargs[2].shape
    before = fl.tally_args(fine_window(*wargs).reshape(P, p, -1), tgt_idx,
                           vargs[1])
    equal = all(torch.equal(a, b) for a, b in zip(targs[:2], before[:2]))
    log(f"[kernel] fine_search: the first vote chunk's proposals equal to "
        f"window_args + fine_window + tally_args's {equal}")
    if not equal:
        raise RuntimeError("the fused search's proposals differ from the "
                           "window kernel's")
    cases = [
        ("coarse_score", "bucketmap_tpu_torch/csrc/coarse_score.cu",
         "bucketmap_tpu/ops/coarse.py:256",
         lambda: coarse_score(table, rows, n_buckets, s),
         lambda: coarse_score_plain(table, rows, n_buckets, s),
         f"{COARSE_ROWS} read-strands x {s} samples ({s.bit_length()} bit "
         f"planes) x {table.shape[1]} words",
         coarse_bound(torch, table, rows, s)),
        ("fine_window", "bucketmap_tpu_torch/csrc/fine_window.cu",
         "bucketmap_tpu/ops/vote.py:54",
         lambda: (fine_window(*wargs),), lambda: (fine_window_plain(*wargs),),
         f"{wargs[1].shape[0]} windows of one {P}-lane vote chunk",
         window_bound(torch, wargs[0], wargs[1], wargs[5])),
        ("fine_search", "bucketmap_tpu_torch/csrc/fine_window.cu",
         "bucketmap_tpu/ops/vote.py:54",
         lambda: fine_search(*sargs), lambda: fine_search_plain(*sargs),
         f"one {P}-lane vote chunk x {p} samples ({P * p} rows, "
         f"search_steps {fl.search_steps}, "
         f"{int((targs[1] != 0).sum())} valid proposals)",
         search_bound(torch, *sargs)),
        ("tally", "bucketmap_tpu_torch/csrc/tally.cu",
         "bucketmap_tpu/ops/vote.py:186",
         lambda: tally(*targs), lambda: tally_plain(*targs),
         f"{P} pairs x {targs[0].shape[1]} proposals "
         f"({int((targs[1] != 0).sum())} valid)",
         tally_bound(torch, *targs[:5])),
    ]
    return cases, {"packed": packed, "rows_all": rows_all, "table": table,
                   "wargs": wargs, "lanes": lanes}


def deep_table(torch, dev, low_bits: int, seed: int = 12):
    """A two-bucket tiled fine table made from `seed`, its segments from
    empty to DEEP_SLOTS slots: bucket 0's prefixes hold 0-40 slots but
    for 20 of 129-4,224 (one ballot round of the fine-search kernel) and
    6 of 4,225-20,000 (two); bucket 1's prefix 2,048 holds DEEP_SLOTS
    (three: more than 128 * 33**2), the rest 0-10. Low bits lean to 0,
    so runs of one low pass 128 and 4,224 slots. Returns (fine_packed
    (2, DEEP_T, 128) int32, fine_ptab (2, 4097) int32, search_steps)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = [rng.integers(0, 41, 4096), rng.integers(0, 11, 4096)]
    deep = rng.choice(4096, 26, replace=False)
    lengths[0][deep[:20]] = rng.integers(129, 4225, 20)
    lengths[0][deep[20:]] = rng.integers(4225, 20001, 6)
    lengths[1][2048] = DEEP_SLOTS
    packed = np.full((2, DEEP_T * 128), -1, np.int64)
    ptab = np.zeros((2, 4097), np.int64)
    for b, n in enumerate(lengths):
        prefix = np.repeat(np.arange(4096), n)
        low = np.floor(rng.random(prefix.size) ** 3 * (1 << low_bits))
        key = np.sort((prefix << low_bits) | low.astype(np.int64))
        pos = rng.integers(0, 1 << (31 - low_bits), key.size)
        packed[b, :key.size] = (pos << low_bits) | (key & ((1 << low_bits)
                                                           - 1))
        ptab[b, 1:] = np.cumsum(n)
    if ptab[:, -1].max() > DEEP_T * 128:
        raise RuntimeError("the made deep table overflows its buckets")
    return (torch.from_numpy(packed.astype(np.int32)).reshape(2, DEEP_T, 128)
            .to(dev), torch.from_numpy(ptab.astype(np.int32)).to(dev),
            int(max(n.max() for n in lengths)).bit_length())


def narrowing_lanes(torch, fine_packed, fine_ptab, low_bits: int, k: int,
                    p: int, read_len: int, seed: int):
    """NARROW_LANES lanes of p samples on the segments of fine_ptab longer
    than 128 slots (fine_search's lane arguments after the tables): the
    first lane on the deepest, half the lanes on the NARROW_LANES / 8
    deepest, the rest on any; each sample targets its lane's segment with the
    low bits of one of its slots at a uniform depth, or (one in four) a
    uniform low; half the lanes reverse-complement; lane_read a
    permutation. Returns (the lane arguments, {"rows": P * p, "deepest":
    the deepest segment's slots, "> 128",
    "> 4,224", "> 139,392": rows on segments longer than that, "first
    match past 384": matched rows whose first equal-low slot lies 384 or
    more slots into its segment})."""
    from bucketmap_tpu_torch.ops.encoding import revcomp_hash
    from bucketmap_tpu_torch.ops.vote import lower_bound

    dev = fine_packed.device
    g = torch.Generator(device=dev).manual_seed(seed)
    P, T = NARROW_LANES, fine_packed.shape[1]
    seg = (fine_ptab[:, 1:] - fine_ptab[:, :-1]).to(torch.int64)
    long_ = (seg > 128).nonzero()
    deepest = seg[long_[:, 0], long_[:, 1]].argsort(descending=True)
    pick = torch.randint(0, long_.shape[0], (P,), generator=g, device=dev)
    top = deepest[:max(1, P // 8)]              # half the lanes on these
    pick[: P // 2] = top[torch.randint(0, top.numel(), (P // 2,),
                                       generator=g, device=dev)]
    pick[0] = deepest[0]
    bid, prefix = long_[pick, 0], long_[pick, 1]
    lo = fine_ptab[bid, prefix].to(torch.int64)[:, None]
    n = seg[bid, prefix][:, None]
    low_mask = (1 << low_bits) - 1
    slot = lo + (torch.rand((P, p), generator=g, device=dev) * n).long()
    low = fine_packed[bid[:, None], slot // 128, slot % 128].to(
        torch.int64) & low_mask
    anylow = torch.randint(0, low_mask + 1, (P, p), generator=g, device=dev)
    low = torch.where(torch.rand((P, p), generator=g, device=dev) < 0.25,
                      anylow, low)
    tgt = (prefix[:, None] << low_bits) | low
    rc = torch.rand(P, generator=g, device=dev) < 0.5
    lane_read = torch.randperm(P, generator=g, device=dev)
    samp_hash = torch.empty_like(tgt)
    samp_hash[lane_read] = torch.where(rc[:, None], revcomp_hash(tgt, k), tgt)
    samp_idx = torch.randint(0, read_len - k + 1, (P, p), generator=g,
                             device=dev)
    lengths = torch.full((P,), read_len, dtype=torch.int32, device=dev)

    def probe(mid):
        mc = mid.clamp(0, T * 128 - 1)
        return (fine_packed[bid[:, None], mc // 128, mc % 128].to(torch.int64)
                & low_mask)

    hi = lo + n
    first, _ = lower_bound(lo.expand(P, p), hi.expand(P, p), low,
                           int(n.max()).bit_length() + 1, probe)
    hit = (first < hi) & (probe(first) == low)
    rows = {"rows": P * p, "deepest": int(n.max())}
    for m in (128, 4224, 139392):
        rows[f"> {m:,}"] = int((n > m).sum()) * p
    rows["first match past 384"] = int((hit & (first - lo >= 384)).sum())
    return (bid, rc, lane_read, samp_hash, samp_idx, lengths), rows


def narrowing_checks(torch, fl, read_len: int) -> None:
    """fine_search against fine_search_plain, word for word, where the
    kernel's narrowing decides: on this table's segments longer than
    128 slots (its deepest included), and on deep_table's (one to three
    ballot rounds, search_steps from its deepest segment). Each case must
    hold rows on segments over 128 slots and rows whose first match lies
    past the window a segment's start would give; the made table's
    also rows on segments over 4,224 and 139,392 slots."""
    from bucketmap_tpu_torch.ops.vote import fine_search, fine_search_plain

    k, lb, p = fl.cfg.query_seed, fl.low_bits, fl.cfg.locator_samples
    made = deep_table(torch, fl.fine_packed.device, lb)
    for what, (fp, pt, steps), need in (
            ("the map's table", (fl.fine_packed, fl.fine_ptab,
                                 fl.search_steps), ("> 128",)),
            ("a made table", made, ("> 128", "> 4,224", "> 139,392"))):
        lanes, rows = narrowing_lanes(torch, fp, pt, lb, k, p, read_len,
                                      seed=5)
        sargs = (fp, pt, *lanes, k, lb, steps)
        check_equal(torch, "fine_search",
                    f"narrowing on {what} (search_steps {steps}), "
                    f"{NARROW_LANES} lanes x {p} samples: rows {rows}",
                    lambda: fine_search(*sargs),
                    lambda: fine_search_plain(*sargs))
        short = [m for m in need + ("first match past 384",) if not rows[m]]
        if short:
            raise RuntimeError(f"the narrowing check on {what} holds no rows "
                               f"{short}: {rows}")


def traced_kernels(torch, dev, runs: dict) -> dict:
    """{name: (device kernels, their device ms, copies)} of one call of
    each runs[name]() under torch.profiler, stage by stage
    (experiments.stages). DeviceTimer could not time the 174-launch
    search of the step before the fused kernel (the host never got ahead
    of its spin kernel), so the sum of a path's kernel times stands for
    its device time."""
    from torch.profiler import ProfilerActivity, profile

    from bucketmap_tpu_torch.experiments.stages import (StageClock,
                                                        kernels_by_stage)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in runs.values():      # a trace can lose its first records
            fn()
        clock = StageClock(dev, sync=True)
        for name, fn in runs.items():
            with clock(name):
                fn()
    by_stage = kernels_by_stage(prof)
    return {name: tuple(by_stage.get(name, (0, 0.0, 0))) for name in runs}


def search_before_after(torch, dm, lanes, what: str) -> None:
    """The vote search of the first chunk as the step ran it before the
    fused kernel (chunk_args' gathers, window_args' plain-torch probes,
    fine_window, tally_args) and as it runs now (fine_search on the
    chunk's lanes): one call on an idle device each, in turns (the host's
    time where the host is the slower); then under torch.profiler one
    call each, its device kernels, copies and the sum of their device
    times (traced_kernels)."""
    from bucketmap_tpu_torch.ops.vote import fine_window

    fl = dm.fine

    def before():
        vargs = dm.chunk_args(lanes, 0)
        wargs, tgt_idx = fl.window_args(*vargs)
        P, p = vargs[2].shape
        return fl.tally_args(fine_window(*wargs).reshape(P, p, -1), tgt_idx,
                             vargs[1])[:2]

    def after():
        return fl.search_lanes(*dm.chunk_lanes(lanes, 0))[:2]

    runs = {"before": before, "after": after}
    calls = {"before": [], "after": []}
    for name in ("before", "after", "after", "before"):
        calls[name].append(call_ms(torch, runs[name]))
    traced = {name: (f"{n} kernels and {copies} copies, {ms:.4f} ms of "
                     f"kernel time")
              for name, (n, ms, copies) in
              traced_kernels(torch, dm.device, runs).items()}
    log(f"[kernel] the vote search of one {dm.vote_chunk}-lane chunk "
        f"({what}); before (chunk_args + window_args + fine_window + "
        f"tally_args): one call on an idle device "
        f"{', '.join(f'{t:.4f}' for t in calls['before'])} ms, traced "
        f"{traced['before']}; after (fine_search): one call "
        f"{', '.join(f'{t:.4f}' for t in calls['after'])} ms, traced "
        f"{traced['after']}; card {card_name_and_limit()}")


def timed_map(torch, dev, pipe, fastq: str, sam: str):
    """pipe.map_fastq(fastq, sam) with the launch counts set to 0 just
    before it: (stats, seconds, launches, device peak GiB)."""
    from bucketmap_tpu_torch import kernels

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = pipe.map_fastq(fastq, sam)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (stats, seconds, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated(dev) / 2**30)


def host_rss() -> str:
    """This process's resident host memory now and its peak so far."""
    from bucketmap_tpu_torch.utils.debug import resource_report

    with open("/proc/self/statm") as f:
        now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource_report()["peak_host_rss_kb"] * 1024
    return (f"host RSS {now / 2**30:.2f} GiB (process peak so far "
            f"{peak / 2**30:.2f} GiB)")


def score_long(sam: str, gt: str, index, stats):
    """bench.py's long-read scores: (% mapped, % correct within +-10, +-5,
    and +-tol, tol) with tol = max(10, 2% of the mean read length)."""
    from bucketmap_tpu_torch import world

    tol = max(10, int(0.02 * stats.num_bases / max(1, stats.num_reads)))
    mapped, c10 = world.score_sam(sam, gt, index)
    c5 = world.score_sam(sam, gt, index, tol=5)[1]
    return mapped, c10, c5, world.score_sam(sam, gt, index, tol=tol)[1], tol


def bench_columns(mapped, c10, c5, stats, drift=None) -> dict:
    """A run's accuracy columns as bench_torch.py prints them (and
    bench.py): rounded to 2 digits, locations a read to 4; drift = (tol,
    % correct within +-tol) for long reads."""
    out = {"pct_mapped": round(mapped, 2),
           "pct_correct_position": round(c10, 2),
           "pct_correct_position_tol5": round(c5, 2),
           "locations_per_read": round(stats.mapped_locations
                                       / stats.num_reads, 4)}
    if drift is not None:
        out[f"pct_correct_position_tol{drift[0]}"] = round(drift[1], 2)
    return out


class CallLog:
    """While entered, the named functions of `owner` (an object's methods
    or a module's functions) are wrapped to keep, per name, the seconds
    spent in them, the keyword arguments of each call and the first
    call's positional arguments and result; the originals are put back on
    exit."""

    def __init__(self, owner, *names):
        self.owner, self.names = owner, names
        self.seconds = dict.fromkeys(names, 0.0)
        self.kwargs = {n: [] for n in names}
        self.first_args = {}
        self.first = {}
        self.saved = {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.owner, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.kwargs[_name].append(kw)
                t0 = time.perf_counter()
                try:
                    out = _fn(*a, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
                self.first_args.setdefault(_name, a)
                self.first.setdefault(_name, out)
                return out

            setattr(self.owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.owner, name, fn)


def mesh_phase(torch, timer, index, fastq, gt, sam, dev, rows_all, packed,
               vec_single, main_launches: dict) -> list:
    """Phase 8, on the one rank of an initialized nccl group: the staged
    kernels against their plain versions, the mesh step with each coarse
    path against the single-device step, and the staged mesh pipeline
    against phase 4's SAM. Returns the staged kernels' report entries,
    their launches those of the staged mesh pipeline."""
    from bucketmap_tpu_torch import kernels, world
    from bucketmap_tpu_torch.mapper.device_pipeline import DeviceMapper
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.ops.coarse import (chunk_scan, chunk_scan_plain,
                                                presence_gather,
                                                presence_gather_plain)
    from bucketmap_tpu_torch.parallel import sharding

    n = index.n_buckets
    s = index.config.mapper_samples
    mesh = sharding.make_mesh(1, 1)
    t0 = time.perf_counter()
    pipe = BucketMapPipeline(index, device=dev, batch_size=BATCH,
                             pair_batch=BATCH, mesh=mesh, coarse_path="staged")
    torch.cuda.synchronize()
    dm = pipe.device
    table = dm.coarse.qgram_words
    w = table.shape[1]
    log(f"[mesh] nccl, world size 1, mesh {mesh.shape}: staged pipeline "
        f"ready in {time.perf_counter() - t0:.1f} s (lane budget "
        f"{dm.lane_budget}, vote chunk {dm.vote_chunk}, out_cap {dm.out_cap})")

    # the staged kernels on the main path's rows (phase 5's first batch)
    rows = rows_all[: COARSE_ROWS * s].contiguous()
    presence = presence_gather(table, rows).reshape(COARSE_ROWS // 2, 2, s, w)
    wide = presence_gather(table, rows_all[: COARSE_ROWS * WIDE_S]
                           .contiguous()).reshape(COARSE_ROWS, WIDE_S, w)
    check_equal(torch, "chunk_scan", f"{COARSE_ROWS} read-strands x {WIDE_S} "
                f"samples (six bit planes) x {w} words",
                lambda: chunk_scan(wide, n), lambda: chunk_scan_plain(wide, n))
    del wide
    cases = [
        ("presence_gather", "bucketmap_tpu_torch/csrc/presence_gather.cu",
         "bucketmap_tpu/ops/coarse.py:179",
         lambda: (presence_gather(table, rows),),
         lambda: (presence_gather_plain(table, rows),),
         f"{rows.shape[0]} samples ({COARSE_ROWS} read-strands x {s}) x "
         f"{rows.shape[1]} rows x {w} words", presence_bound(torch, table, rows)),
        ("chunk_scan", "bucketmap_tpu_torch/csrc/chunk_scan.cu",
         "bucketmap_tpu/ops/coarse.py:94",
         lambda: chunk_scan(presence, n), lambda: chunk_scan_plain(presence, n),
         f"{COARSE_ROWS} read-strands x {s} samples x {w} words",
         scan_bound(presence, s)),
    ]
    # the presence gather at the full batch and on ragged shapes
    check_equal(torch, "presence_gather", f"the full batch "
                f"({rows_all.shape[0]} samples x {rows_all.shape[1]} rows x "
                f"{w} words)", lambda: (presence_gather(table, rows_all),),
                lambda: (presence_gather_plain(table, rows_all),))
    gc.collect()
    torch.cuda.empty_cache()
    for wr, R, nq, rep in ((w, 1001, 4, True), (300, 1001, 1, False),
                           (100, 7, 16, False), (w, 1001, 16, True)):
        tr = table[:, :wr].contiguous()
        rr = torch.cat([rows_all[i * R:(i + 1) * R] for i in range(4)],
                       dim=1)[:, :nq].contiguous()
        if rep:
            rr[::3] = rr[0]
        check_equal(torch, "presence_gather", f"{R} samples x {nq} rows x "
                    f"{wr} words{', every third row the first' if rep else ''}",
                    lambda: (presence_gather(tr, rr),),
                    lambda: (presence_gather_plain(tr, rr),))
    del tr, rr
    B2 = rows_all.shape[0] // s
    full_size(torch, timer, "presence_gather",
              f"the full batch ({B2} read-strands)",
              lambda: presence_gather(table, rows_all),
              presence_bound(torch, table, rows_all))
    full = presence_gather(table, rows_all).reshape(B2 // 2, 2, s, w)
    full_size(torch, timer, "chunk_scan",
              f"the full batch ({B2} read-strands, presence "
              f"{full.numel() * 4 / 1e9:.2f} GB)", lambda: chunk_scan(full, n),
              scan_bound(full, s))
    del full

    # one batch through the mesh step, each coarse path
    fused = DeviceMapper(index, dev, batch_size=BATCH, vote_chunk=dm.vote_chunk,
                         tables=dm.tables, mesh=mesh)
    for path, mdm in (("staged", dm), ("fused", fused)):
        vec = mdm.step_packed(packed).cpu()
        equal = torch.equal(vec, vec_single)
        log(f"[mesh] step ({path}) on phase 5's batch: {vec.shape[0]} words, "
            f"equal to the single-device step {equal}")
        if not equal:
            raise RuntimeError(f"the mesh step ({path}) differs from the "
                               f"single-device step")
    del fused

    # the staged mesh pipeline over all reads
    sam_mesh = os.path.join(HERE, ".bench_cache", "chip_smoke_mesh.sam")
    stats, map_s, launches, peak = timed_map(torch, dev, pipe, fastq,
                                             sam_mesh)
    mapped, correct = world.score_sam(sam_mesh, gt, index)
    same = filecmp.cmp(sam, sam_mesh, shallow=False)
    log(f"[mesh] staged mesh pipeline: {stats.num_reads} reads in "
        f"{map_s:.2f} s = {stats.num_reads / map_s:.1f} reads/s; pct_mapped "
        f"{mapped:.2f} pct_correct_position(+-10) {correct:.2f}; SAM equal "
        f"to phase 4's {same}; step+decode {stats.fine_seconds:.2f} s; "
        f"device peak {peak:.2f} GiB; launches {launches}; card "
        f"{card_name_and_limit()}")
    if not same:
        raise RuntimeError("the staged mesh pipeline's SAM differs from the "
                           "single-device SAM")
    if mapped < MIN_MAPPED or correct < MIN_CORRECT:
        raise RuntimeError(f"mesh accuracy below the floor: mapped "
                           f"{mapped:.2f}, correct {correct:.2f}")
    check_map_launches(launches, STAGED_KERNELS, "the staged mesh pipeline")
    if launches["coarse_score"]:
        raise RuntimeError(f"the staged path launched {launches}")
    # the staged kernels on the main path's rows, their launches this
    # pipeline's
    report = [check_kernel(torch, timer, *case, launches[case[0]],
                           main_launches[case[0]]) for case in cases]
    del presence, cases
    return report


def vote_paths_phase(torch, index, fastq, gt, sam, dev, packed, vec_single,
                     candidate_pairs: int) -> None:
    """Phase 9: the device occupancy build, the scan vote at full scale,
    and the five vote paths on one batch of a 100 Mbp world."""
    import dataclasses

    import numpy as np

    from bucketmap_tpu_torch import kernels, world
    from bucketmap_tpu_torch.index.builder import build_fine_index
    from bucketmap_tpu_torch.device import upload_u32
    from bucketmap_tpu_torch.index.device_build import \
        build_occupancy_on_device
    from bucketmap_tpu_torch.mapper.device_pipeline import DeviceMapper
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) the occupancy table, built on the device and uploaded, in turns
    host_qw = np.asarray(index.qgram_words)
    up, up1 = timed(lambda: upload_u32(host_qw, dev))
    occ, b1 = timed(lambda: build_occupancy_on_device(index, dev))
    del occ
    occ, b2 = timed(lambda: build_occupancy_on_device(index, dev))
    del up
    up, up2 = timed(lambda: upload_u32(host_qw, dev))
    equal = torch.equal(occ, up)
    log(f"[occupancy] {tuple(occ.shape)} words ({occ.numel() * 4 / 1e9:.3f} "
        f"GB): device build {b1:.4f} s, {b2:.4f} s; upload {up1:.4f} s, "
        f"{up2:.4f} s; equal to the host table {equal}; card "
        f"{card_name_and_limit()}")
    if not equal:
        raise RuntimeError("the device occupancy table differs from the host "
                           "table")
    del occ, up
    chunk = min(4096, BATCH)
    dm, init_s = timed(lambda: DeviceMapper(index, dev, batch_size=BATCH,
                                            vote_chunk=chunk,
                                            occupancy_build="device"))
    vec = dm.step_packed(packed).cpu()
    log(f"[occupancy] step on the device-built table (mapper ready in "
        f"{init_s:.1f} s): equal to phase 5's vector {torch.equal(vec, vec_single)}")
    if not torch.equal(vec, vec_single):
        raise RuntimeError("the step on the device occupancy table differs")
    del dm
    torch.cuda.empty_cache()

    # (b) the table-free scan at full scale
    pipe, init_s = timed(lambda: BucketMapPipeline(
        index, device=dev, batch_size=BATCH, pair_batch=BATCH,
        fine_build="host"))
    dm = pipe.device
    if dm.vote_path != "scan":
        raise RuntimeError(f"expected the scan vote path, got {dm.vote_path}")
    vec = dm.step_packed(packed).cpu()
    lanes = dm.compact_lanes(packed)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    chunk_ms = call_ms(torch, lambda: dm.fine.vote(*dm.chunk_args(lanes, 0)),
                         reps=3, warmup=1)
    chunk_peak = torch.cuda.max_memory_allocated(dev) - base
    n_chunks = -(-candidate_pairs // dm.vote_chunk)
    log(f"[scan] pipeline ready in {init_s:.1f} s; one batch: equal to phase "
        f"5's vector {torch.equal(vec, vec_single)}; {chunk_ms:.4f} ms per "
        f"{dm.vote_chunk}-lane vote chunk, {chunk_peak / 2**30:.2f} GiB above "
        f"the tables; phase 4's {candidate_pairs} candidate pairs are ~"
        f"{n_chunks} chunks, ~{n_chunks * chunk_ms / 1e3:.1f} s of vote")
    if not torch.equal(vec, vec_single):
        raise RuntimeError("the scan path's step differs from phase 5's")
    del lanes
    sam_scan = os.path.join(HERE, ".bench_cache", "chip_smoke_scan.sam")
    stats, map_s, launches, peak = timed_map(torch, dev, pipe, fastq,
                                             sam_scan)
    mapped, correct = world.score_sam(sam_scan, gt, index)
    same = filecmp.cmp(sam, sam_scan, shallow=False)
    log(f"[scan] {stats.num_reads} reads in {map_s:.2f} s = "
        f"{stats.num_reads / map_s:.1f} reads/s; pct_mapped {mapped:.2f} "
        f"pct_correct_position(+-10) {correct:.2f}; SAM equal to phase 4's "
        f"{same}; step+decode {stats.fine_seconds:.2f} s; device peak "
        f"{peak:.2f} GiB; launches {launches}; card {card_name_and_limit()}")
    if not same:
        raise RuntimeError("the scan path's SAM differs from phase 4's")
    if mapped < MIN_MAPPED or correct < MIN_CORRECT:
        raise RuntimeError(f"scan accuracy below the floor: mapped "
                           f"{mapped:.2f}, correct {correct:.2f}")
    if launches["tally"] == 0 or launches["fine_search"] \
            or launches["fine_window"]:
        raise RuntimeError(f"the scan path launched {launches}")
    del pipe, dm
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the five vote paths on a 100 Mbp world
    idx, fq100, _, world_s = world.bench_world(
        os.path.join(HERE, ".bench_cache"), 100, BATCH)
    t0 = time.perf_counter()
    build_fine_index(idx, keep_unpacked=True)
    log(f"[paths] 100 Mbp world, {idx.n_buckets} buckets, ready in "
        f"{world_s:.1f} s; host fine tables (2-D packed, prefix, positions) "
        f"built in {time.perf_counter() - t0:.1f} s")
    fine = ("fine_packed", "fine_ptab", "fine_low", "fine_pos")
    keep = {"tiled": fine, "packed": fine, "prefix": fine[1:],
            "sorted": fine[3:], "scan": ()}
    batch = world.first_reads(fq100, BATCH)
    rl = idx.config.read_len
    codes = np.zeros((batch.num_reads, rl), np.uint8)
    quals = np.zeros((batch.num_reads, rl), np.uint8)
    width = min(batch.codes.shape[1], rl)
    codes[:, :width] = batch.codes[:, :width]
    quals[:, :width] = batch.quals[:, :width]
    seg_len = np.minimum(batch.lengths, rl).astype(np.int32)
    vecs = {}
    for path, kept in keep.items():
        one = dataclasses.replace(idx, **{n: None for n in fine
                                          if n not in kept})
        dm, init_s = timed(lambda: DeviceMapper(
            one, dev, batch_size=BATCH, vote_chunk=chunk,
            fine_build="device" if path == "tiled" else "host"))
        if dm.vote_path != path:
            raise RuntimeError(f"expected vote path {path}, got {dm.vote_path}")
        p100 = dm.pack(codes, quals, seg_len)
        kernels.reset_launches()
        vecs[path] = dm.step_packed(p100).cpu()
        launches = dict(kernels.LAUNCHES)
        lanes = dm.compact_lanes(p100)
        ms = call_ms(torch, lambda: dm.fine.vote(*dm.chunk_args(lanes, 0)),
                       reps=5, warmup=1)
        log(f"[paths] {path}: tables in {init_s:.2f} s; {lanes['n_valid']} "
            f"lanes; {ms:.4f} ms per {dm.vote_chunk}-lane vote chunk; equal to "
            f"the tiled vector {torch.equal(vecs[path], vecs['tiled'])}; step "
            f"launches {launches}")
        if not torch.equal(vecs[path], vecs["tiled"]):
            raise RuntimeError(f"the {path} vote path's vector differs")
        tiled_ok = launches["fine_search"] == launches["tally"] \
            if path == "tiled" else launches["fine_search"] == 0
        if launches["tally"] == 0 or launches["fine_window"] or not tiled_ok:
            raise RuntimeError(f"the {path} path launched {launches}")
        del dm, lanes, p100, one
        torch.cuda.empty_cache()
    log(f"[paths] five vote paths equal word for word on "
        f"{vecs['tiled'].shape[0]} words; card {card_name_and_limit()}")


def run_cli(torch, argv, what: str):
    """One command through the port's `cli.main`, in this process so that
    `kernels.LAUNCHES` counts its launches (set to 0 just before it):
    its output echoed, its seconds, launches and resource_report()
    logged; raises unless it returns 0. Returns (output, launches)."""
    import contextlib
    import io

    from bucketmap_tpu_torch import cli, kernels
    from bucketmap_tpu_torch.utils.debug import resource_report

    argv = [str(a) for a in argv]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    out = buf.getvalue()
    log(f"[cli] $ bucketmap-tpu-torch {' '.join(argv)}")
    for line in out.splitlines():
        log(line)
    log(f"[cli] {what}: exit {rc} in {seconds:.2f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; resources "
        f"{resource_report()}")
    if rc != 0:
        raise RuntimeError(f"the command line's {what} returned {rc}")
    return out, launches


def report_numbers(out: str):
    """(% mapped, % correct) from analyze-sam's report, computed from its
    integer counts as the analyzer computes them; the simulator's truth
    gives every read one locus, so the read count is the uniquely mapped
    truth."""
    import re

    count = {}
    for key, label in (("total", "Total number of reads"),
                       ("random", "Total number of random reads"),
                       ("mapped", "Total number of mapped reads"),
                       ("correct", "Correctly mapped (sensitivity)")):
        count[key] = int(re.search(re.escape(label) + r": (\d+)", out)[1])
    return (100.0 * count["mapped"] / max(1, count["total"] - count["random"]),
            100.0 * count["correct"] / max(1, count["total"]))


def check_map_launches(launches: dict, kernels_run, what: str) -> None:
    """Every kernel of kernels_run launched, and the tiled vote's: one
    fine_search a live vote chunk (as many as tally), fine_window never."""
    idle = [k for k in kernels_run if launches[k] == 0]
    if idle:
        raise RuntimeError(f"{what} never launched: {idle}")
    if launches["fine_window"] or launches["fine_search"] != launches["tally"]:
        raise RuntimeError(f"{what}: the tiled vote must launch fine_search "
                           f"once per live vote chunk and fine_window never: "
                           f"{launches}")


def cli_phase(torch, device: str, index, cache_dir: str, idx_name: str,
              fastq: str, gt: str, sam: str, sam_al: str,
              rt_mbp: float = 20.0, rt_reads: int = BATCH) -> None:
    """Phase 10, the command line: `map` on the bench world's saved index
    (align-free and --align; the SAMs of phases 4 and 6 byte for byte),
    `analyze-sam` (its mapped share score_sam's) and `analyze-fastq` on
    phase 4's files, then index -> simulate -> map (saved and
    reference-format index, the same SAM) -> analyze-sam on a small
    repeat genome. `device` is the map's --device."""
    import contextlib
    import shutil

    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.io.fasta import write_fasta
    from bucketmap_tpu_torch.ops.host_encoding import decode_to_ascii
    from bucketmap_tpu_torch.sim.simulator import repeat_genome
    from bucketmap_tpu_torch.utils.debug import validation_mode

    cuda = device.startswith("cuda")
    # (a) map, both modes, on the cached index
    for what, extra, want, run in (("map", [], sam, MAP_KERNELS),
                                   ("map --align", ["--align"], sam_al,
                                    ALIGN_KERNELS)):
        out_sam = os.path.join(cache_dir, "chip_smoke_cli.sam")
        _, launches = run_cli(torch, ["map", "--device", device, "-i",
                                      idx_name, "--index-dir", cache_dir, "-q",
                                      fastq, "-o", out_sam, "--batch-size",
                                      BATCH] + extra, what)
        same = filecmp.cmp(want, out_sam, shallow=False)
        log(f"[cli] {what}: SAM equal to {os.path.basename(want)} {same}")
        if not same:
            raise RuntimeError(f"the command line's {what} SAM differs from "
                               f"{want}")
        if cuda:
            check_map_launches(launches, run, f"the command line's {what}")
    # (b) analyze-sam against score_sam, (c) analyze-fastq
    out, _ = run_cli(torch, ["analyze-sam", sam, "--fastq", fastq,
                             "--ground-truth", gt, "--tolerance", 10],
                     "analyze-sam")
    pct_mapped, sensitivity = report_numbers(out)
    mapped, correct = world.score_sam(sam, gt, index)
    log(f"[cli] analyze-sam: pct_mapped {pct_mapped:.4f} (score_sam "
        f"{mapped:.4f}); sensitivity {sensitivity:.4f} (score_sam correct "
        f"{correct:.4f}; the analyzer's window sits one base off score_sam's)")
    if abs(pct_mapped - mapped) > 1e-9:
        raise RuntimeError("analyze-sam's mapped share differs from score_sam's")
    if min(sensitivity, correct) < MIN_CORRECT:
        raise RuntimeError("analyze-sam's sensitivity or score_sam's correct "
                           "share is below the floor")
    run_cli(torch, ["analyze-fastq", fastq], "analyze-fastq")

    # (d) index -> simulate -> map -> analyze on a small repeat genome
    rt = os.path.join(cache_dir, "cli_roundtrip")
    shutil.rmtree(rt, ignore_errors=True)
    os.makedirs(os.path.join(rt, "ref"))
    fasta = os.path.join(rt, "g.fasta")
    t0 = time.perf_counter()
    write_fasta(fasta, [(r.id, decode_to_ascii(r.codes))
                        for r in repeat_genome(int(rt_mbp * 1e6), seed=3,
                                               n_refs=2)])
    log(f"[cli] {rt_mbp:g} Mbp repeat genome written in "
        f"{time.perf_counter() - t0:.2f} s")
    run_cli(torch, ["index", "-g", fasta, "-i", "rt", "--index-dir", rt,
                    "--export-reference-format", "--force"], "index")
    run_cli(torch, ["simulate", "-g", fasta, "-o", rt, "--name", "rt", "-c",
                    rt_reads], "simulate")
    for ext in (".qgram", ".bucket_id", ".kmers_index"):
        shutil.copy(os.path.join(rt, "rt" + ext), os.path.join(rt, "ref"))
    rt_fastq = os.path.join(rt, "rt.fastq")
    sams = []
    # the second map runs under validation_mode: every kernel launch
    # synchronises and would raise naming its kernel
    for what, extra, mode in (
            ("map (saved index)", ["--index-dir", rt], contextlib.nullcontext),
            ("map (reference format, validation_mode)",
             ["--index-dir", os.path.join(rt, "ref"), "-g", fasta],
             validation_mode)):
        sams.append(os.path.join(rt, f"rt{len(sams)}.sam"))
        with mode():
            _, launches = run_cli(torch, ["map", "--device", device, "-i",
                                          "rt", "-q", rt_fastq, "-o",
                                          sams[-1], "--batch-size", BATCH]
                                  + extra, what)
        if cuda:
            check_map_launches(launches, MAP_KERNELS,
                               f"the command line's {what}")
    same = filecmp.cmp(*sams, shallow=False)
    log(f"[cli] the two round-trip SAMs equal {same}")
    if not same:
        raise RuntimeError("the map from the reference-format index differs "
                           "from the map from the saved index")
    out, _ = run_cli(torch, ["analyze-sam", sams[0], "--fastq", rt_fastq,
                             "--ground-truth",
                             os.path.join(rt, "rt.position_ground_truth"),
                             "--tolerance", 10], "analyze-sam (round trip)")
    pct_mapped, sensitivity = report_numbers(out)
    if pct_mapped < MIN_MAPPED or sensitivity < MIN_CORRECT:
        raise RuntimeError(f"round trip below the floor: mapped "
                           f"{pct_mapped:.2f}, sensitivity {sensitivity:.2f}")


def fm_phase(torch, dev, genome_bp: int = 4_600_000, n_reads: int = BATCH,
             n_map: int = 1024, n_scalar: int = 256, bi_bp: int = 1_000_000,
             cache_dir: str = os.path.join(HERE, ".bench_cache")) -> None:
    """Phase 11, the FM-index: built on an E. coli-scale random genome;
    the two seeds (max_errors=1) of n_reads simulated reads, put on the
    strand the index holds, searched on `dev` lane for lane as on the CPU
    and, for the first n_scalar non-empty ranges, as backward_search
    finds them; its time and launches per call; FMIndexMapper on `dev`,
    and FMIndexLocator on `dev` (initialize, then locate), against the
    CPU's mapper on the first n_map reads; a BiFMIndex of the genome's
    first bi_bp bases, extended left and right over n_scalar seeded
    20-mers; a BucketFMIndexer of the genome, saved and loaded, its
    bucket indexes finding n_scalar seeded 20-mers of their buckets."""
    import numpy as np

    from bucketmap_tpu_torch.config import MapperConfig
    from bucketmap_tpu_torch.index.builder import iterate_buckets
    from bucketmap_tpu_torch.index.fm import (BiFMIndex, BucketFMIndexer,
                                              FMIndex, FMIndexLocator,
                                              FMIndexMapper,
                                              exact_search_batch)
    from bucketmap_tpu_torch.io.fasta import FastaRecord
    from bucketmap_tpu_torch.io.fastq import read_fastq
    from bucketmap_tpu_torch.ops.host_encoding import revcomp_codes
    from bucketmap_tpu_torch.sim.simulator import (ShortReadSimulator,
                                                   random_genome)
    from bucketmap_tpu_torch.utils.debug import maybe_trace

    cuda = torch.device(dev).type == "cuda"
    genome = random_genome(genome_bp, seed=1, n_refs=2)
    t0 = time.perf_counter()
    fmi = FMIndex.build(genome)
    log(f"[fm] FMIndex of a {genome_bp} bp random genome (2 references) "
        f"built in {time.perf_counter() - t0:.2f} s: {fmi.occ.shape[0]} occ "
        f"checkpoints, {len(fmi.sa_vals)} SA samples")
    sim = ShortReadSimulator(MapperConfig(bucket_len=65536, read_len=300),
                             substitution_rate=0.002, insertion_rate=0.00025,
                             deletion_rate=0.00025, seed=2)
    sim.read(genome)
    paths = sim.generate(os.path.join(cache_dir, "fm"), "fm", n_reads)
    batch = read_fastq(paths["fastq"])
    truth = np.loadtxt(paths["position_gt"], usecols=(0, 1, 2), dtype=np.int64,
                       ndmin=2)
    codes, lens = batch.codes.copy(), batch.lengths.astype(np.int64)
    for i in np.nonzero(truth[:, 2])[0]:
        codes[i, :lens[i]] = revcomp_codes(codes[i, :lens[i]])
    mapper = FMIndexMapper(fmi, max_errors=1, device=dev)
    mapper.text = np.concatenate([r.codes for r in genome])
    pats, plens, _ = mapper.seed_batch(codes, lens)

    def search():
        return exact_search_batch(fmi, pats, plens, device=dev)

    t0 = time.perf_counter()
    lo, hi = search()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lo_h, hi_h = exact_search_batch(fmi, pats, plens, device="cpu")
    cpu_s = time.perf_counter() - t0
    lanes_equal = np.array_equal(lo, lo_h) and np.array_equal(hi, hi_h)
    nonempty = np.nonzero(lo < hi)[0]
    scalar = all(fmi.backward_search(pats[i, :plens[i]]) == (lo[i], hi[i])
                 for i in nonempty[:n_scalar])
    if cuda:
        ms = call_ms(torch, search, reps=5, warmup=1)
    else:
        t0 = time.perf_counter()
        search()
        ms = (time.perf_counter() - t0) * 1e3
    with maybe_trace(os.path.join(cache_dir, "fm_trace")) as prof:
        search()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels_run = [e for e in device_events if not e.name.startswith("Mem")]
    launches = (f"{len(kernels_run)} kernels + "
                f"{len(device_events) - len(kernels_run)} copies "
                f"(torch.profiler)" if device_events else
                "not measured (the profiler saw no device event)")
    log(f"[fm] exact_search_batch on {dev}: {len(pats)} patterns "
        f"(m {pats.shape[1]}, longest {int(plens.max())}), "
        f"{len(nonempty)} non-empty; equal to the CPU on every lane "
        f"{lanes_equal}; first {min(n_scalar, len(nonempty))} non-empty equal "
        f"to backward_search {scalar}; {ms:.4f} ms per call (call_ms; first "
        f"call with the upload {first_s:.3f} s, the CPU's {cpu_s:.3f} s); "
        f"launches per call {launches}")
    if not (lanes_equal and scalar):
        raise RuntimeError("exact_search_batch on the device differs")

    hits = []
    for m_dev in (dev, "cpu"):
        m = mapper if m_dev == dev else FMIndexMapper(fmi, max_errors=1,
                                                      device="cpu")
        m.text = mapper.text
        t0 = time.perf_counter()
        hits.append(m.map_reads(codes[:n_map], lens[:n_map]))
        log(f"[fm] FMIndexMapper on {m_dev}: {n_map} reads in "
            f"{time.perf_counter() - t0:.2f} s")
    same = hits[0] == hits[1]
    at_truth = sum(any(h.ref_id == truth[i, 0]
                       and abs(h.position - (truth[i, 1] - 1)) <= 1
                       for h in row) for i, row in enumerate(hits[0]))
    log(f"[fm] hits equal to the CPU mapper's {same}; reads with a hit at "
        f"the true locus (+-1) {at_truth} of {n_map} "
        f"({100.0 * at_truth / n_map:.2f}%)")
    if not same:
        raise RuntimeError("FMIndexMapper's hits on the device differ")
    if at_truth < FM_MIN_AT_TRUTH * n_map:
        raise RuntimeError("FMIndexMapper found too few reads at their locus")

    # the rest of the family: the locator, the bidirectional index and the
    # per-bucket indexes
    fm_dir = os.path.join(cache_dir, "fm")
    locator = FMIndexLocator(max_errors=1, device=dev)
    t0 = time.perf_counter()
    locator.initialize(genome, fm_dir, "fm_locator")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    located = locator.locate(codes[:n_map], lens[:n_map])
    log(f"[fm] FMIndexLocator on {dev}: initialize (index built and saved) "
        f"{init_s:.2f} s, locate {n_map} reads {time.perf_counter() - t0:.2f} "
        f"s; hits equal to the CPU mapper's {located == hits[1]}")
    if located != hits[1]:
        raise RuntimeError("FMIndexLocator's hits on the device differ from "
                           "the CPU mapper's")
    rng = np.random.default_rng(11)
    cut = [FastaRecord(r.id, r.codes[:bi_bp // len(genome)]) for r in genome]
    t0 = time.perf_counter()
    bi = BiFMIndex.build(cut)
    bi_s = time.perf_counter() - t0
    bi_ok = 0
    for _ in range(n_scalar):
        rec = cut[int(rng.integers(len(cut)))].codes
        at = int(rng.integers(len(rec) - 20))
        pat = rec[at:at + 20]
        left = right = bi.init_range()
        for c in pat[::-1]:
            left = bi.extend_left(left, int(c))
        for c in pat:
            right = bi.extend_right(right, int(c))
        lo_, hi_ = bi.fwd.backward_search(pat)
        bi_ok += (left[:2] == (lo_, hi_) and hi_ > lo_
                  and right[1] - right[0] == hi_ - lo_
                  and left[3] - left[2] == hi_ - lo_)
    bucket_cfg = MapperConfig(bucket_len=65536, read_len=300)
    t0 = time.perf_counter()
    n_fm_buckets = BucketFMIndexer(bucket_cfg).index(genome, fm_dir,
                                                     "fm_buckets")
    bfm_s = time.perf_counter() - t0
    loaded = BucketFMIndexer.load(bucket_cfg, fm_dir, "fm_buckets")
    buckets = [c for _rid, _start, c in iterate_buckets(genome, bucket_cfg)]
    bfm_ok = 0
    for _ in range(n_scalar):
        b = int(rng.integers(len(buckets)))
        at = int(rng.integers(len(buckets[b]) - 20))
        bfm_ok += at in set(loaded.buckets[b].find_all(buckets[b][at:at + 20])
                            .tolist())
    log(f"[fm] BiFMIndex of {sum(len(r.codes) for r in cut)} bp built in "
        f"{bi_s:.2f} s: {bi_ok} of {n_scalar} 20-mers give backward_search's "
        f"range extending left and its width extending right; "
        f"BucketFMIndexer: {n_fm_buckets} bucket indexes built and saved in "
        f"{bfm_s:.2f} s, loaded back, {bfm_ok} of {n_scalar} 20-mers found "
        f"at their offset in their bucket's index")
    if bi_ok != n_scalar or n_fm_buckets != len(buckets) \
            or bfm_ok != n_scalar:
        raise RuntimeError("the bidirectional or per-bucket FM-index "
                           "searches differ")


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def param_diff(torch, net, ref) -> list:
    """Per parameter of two copies of a network: (elements that differ,
    the largest difference, the first differing flat index or -1, the
    values of `net` and `ref` there)."""
    out = []
    for a, b in zip(net.parameters(), ref.parameters()):
        a, b = a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1)
        ne = torch.nonzero(a != b).flatten()
        i = int(ne[0]) if ne.numel() else -1
        out.append((ne.numel(), float((a - b).abs().max()), i,
                    float(a[i]) if i >= 0 else None,
                    float(b[i]) if i >= 0 else None))
    return out


def step_one_errors(torch, net, ref, eps: float = 1e-8):
    """After one Adam step of two copies of a network from the same
    weights on the same batch: (largest gradient difference relative to
    its tensor's largest gradient, largest parameter difference where the
    reference's |gradient| >= eps, the same where it is below, the count
    of those entries). Adam's first step is lr * g / (|g| + eps): below
    eps it is lr / eps = 1e5 times the gradient, so a float32 rounding of
    a cancelling sum moves it by ~1e-5 there, and only the gradient says
    whether the two agree."""
    grad_err = step_err = tiny_err = 0.0
    n_tiny = 0
    for a, b in zip(net.parameters(), ref.parameters()):
        g = b.grad
        grad_err = max(grad_err, float((a.grad.cpu() - g).abs().max()
                                       / g.abs().max()))
        diff = (a.detach().cpu() - b.detach()).abs()
        tiny = g.abs() < eps
        n_tiny += int(tiny.sum())
        if (~tiny).any():
            step_err = max(step_err, float(diff[~tiny].max()))
        if tiny.any():
            tiny_err = max(tiny_err, float(diff[tiny].max()))
    return grad_err, step_err, tiny_err, n_tiny


def research_phase(torch, dev, genome, cfg, block=(64, 2048),
                   mlp_genome_bp: int = 20_000_000, d_model: int = 2048,
                   fit_steps: int = MLP_STEPS, dqn_d_model: int = 512) -> None:
    """Phase 12, the research tree on `dev`: (a) the repeat filter over
    every bucket of `genome`, its Jaccard block at block[0] x block[1]
    seeded bucket ids equal to the CPU's from those buckets' own profiles;
    (b) the MLP classifier: three steps on `dev` and on the CPU from one
    seeded initialisation, then a fit on `dev` and its accuracy; (c) the
    DQN on tests/test_research.py's environment. No kernel launches."""
    import numpy as np

    from bucketmap_tpu_torch import kernels
    from bucketmap_tpu_torch.config import MapperConfig
    from bucketmap_tpu_torch.index.builder import iterate_buckets
    from bucketmap_tpu_torch.research import neural
    from bucketmap_tpu_torch.sim.simulator import random_genome

    cuda = torch.device(dev).type == "cuda"
    kernels.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # (a) the repeat filter over the whole genome
    filt = neural.RepetitiveRegionFilter(cfg, k=9, device=dev)
    t0 = time.perf_counter()
    prof = filt.read(genome)
    sync(torch, dev)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ji = filt.ji_matrix(prof)
    ji_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    B = prof.shape[0]
    symmetric = np.array_equal(ji, ji.T)
    diag_zero = not np.diag(ji).any()
    pairs = int(np.count_nonzero(ji > 0.5)) // 2
    ji_mean = float(ji.sum(dtype=np.float64)) / max(1, B * (B - 1))
    rng = np.random.default_rng(12)
    rows = rng.choice(B, min(block[0], B), replace=False)
    cols = rng.choice(B, min(block[1], B), replace=False)
    buckets = [c for _rid, _start, c in iterate_buckets(genome, cfg)]
    cpu_filt = neural.RepetitiveRegionFilter(cfg, k=9, device="cpu")
    t0 = time.perf_counter()
    pr = cpu_filt.profile_buckets([buckets[i] for i in rows])
    pc = cpu_filt.profile_buckets([buckets[i] for i in cols])
    want = neural.jaccard(pr @ pc.T, pr.sum(1), pc.sum(1))
    want[torch.from_numpy(rows[:, None] == cols[None, :])] = 0.0
    cpu_s = time.perf_counter() - t0
    prof_equal = (torch.equal(prof[torch.from_numpy(rows).to(prof.device)]
                              .cpu(), pr)
                  and torch.equal(prof[torch.from_numpy(cols).to(prof.device)]
                                  .cpu(), pc))
    block_equal = np.array_equal(ji[np.ix_(rows, cols)], want.numpy())
    log(f"[research] repeat filter (k=9) on {dev}: {B} buckets x "
        f"{prof.shape[1]} canonical 9-mers ({prof.numel() * 4 / 1e9:.2f} GB "
        f"of profiles), read {read_s:.2f} s; ji_matrix ({B} x {B}, "
        f"{ji.nbytes / 1e9:.2f} GB, {2 * B * B * prof.shape[1] / 1e12:.1f} "
        f"T flop, TF32 "
        f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}) "
        f"{ji_s:.2f} s with the copy to the host; device peak {peak:.2f} GiB; "
        f"pairs with JI > 0.5: {pairs}, mean JI off the diagonal "
        f"{ji_mean:.4f}, largest {float(ji.max()):.4f}; symmetric "
        f"{symmetric}, zero diagonal "
        f"{diag_zero}; block {len(rows)} x {len(cols)} equal to the CPU's "
        f"{block_equal} (profiles equal {prof_equal}; the CPU {cpu_s:.2f} s)")
    if not (symmetric and diag_zero and block_equal and prof_equal):
        raise RuntimeError("the repeat filter's Jaccard matrix differs from "
                           "the CPU's")
    del prof, ji, buckets, pr, pc, want, filt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (b) the MLP classifier at its full width
    mlp_cfg = MapperConfig(bucket_len=65536, read_len=300)
    ds = neural.ReadDataset(random_genome(mlp_genome_bp, seed=3, n_refs=2),
                            mlp_cfg, seed=4)
    clfs = [neural.MLPBucketClassifier(k=9, d_model=d_model, seed=0,
                                       device=d) for d in (dev, "cpu")]
    # the initialisation, drawn on the CPU and copied to `dev`, held at
    # each stage: a second CPU draw, the copy read back right after
    # `.to(dev)`, and read back again once the device is idle
    clfs[1].init(ds.n_buckets)
    redraw = neural.mlp(clfs[1].n_canonical, d_model, ds.n_buckets, 0)
    init_diff = {"CPU redraw": param_diff(torch, redraw, clfs[1].net)}
    del redraw
    clfs[0].init(ds.n_buckets)
    init_diff["device copy"] = param_diff(torch, clfs[0].net, clfs[1].net)
    sync(torch, dev)
    init_diff["device copy re-read"] = param_diff(torch, clfs[0].net,
                                                  clfs[1].net)
    n_params = sum(p.numel() for p in clfs[1].net.parameters())
    same_init = not any(d[0] for diffs in init_diff.values() for d in diffs)
    losses = ([], [])
    for step in range(3):
        codes, lens, labels = ds.batch(128)
        labels = torch.from_numpy(labels.astype(np.int64))
        for clf, out in zip(clfs, losses):
            out.append(float(clf.train_step(clf.profiles(codes, lens),
                                            labels.to(clf.device))))
        if step == 0:
            grad_err, step_err, tiny_err, n_tiny = step_one_errors(
                torch, clfs[0].net, clfs[1].net)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"[research] MLP (k=9, d_model={d_model}, {ds.n_buckets} buckets, "
        f"{n_params} parameters): the same initialisation on {dev} and the "
        f"CPU {same_init} (per stage and tensor: differing elements, the "
        f"largest difference, the first differing element and its values "
        f"there: {init_diff}); three steps, losses {losses[0]} on {dev}, "
        f"{losses[1]} on the CPU (largest relative difference {loss_rel:.3g}"
        f"); step one: gradients within {grad_err:.3g} of each tensor's "
        f"largest, parameters within "
        f"{step_err:.3g} where |gradient| >= Adam's eps, and within "
        f"{tiny_err:.3g} on the {n_tiny} below it")
    if not same_init or loss_rel > 1e-4 or grad_err > MLP_GRAD_TOL \
            or step_err > 1e-5:
        raise RuntimeError("the MLP's steps on the device differ from the "
                           "CPU's")
    clf = clfs[0]
    del clfs
    gc.collect()
    sync(torch, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fit = clf.fit(ds, steps=fit_steps, batch_size=128)
    sync(torch, dev)
    fit_s = time.perf_counter() - t0
    acc = clf.accuracy(ds, n=1024)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    log(f"[research] MLP fit on {dev}: {fit_steps} steps of 128 reads in "
        f"{fit_s:.2f} s = {fit_s / fit_steps * 1e3:.3f} ms a step (host "
        f"batches and profiles included); loss {fit[0]:.4f} -> "
        f"{np.mean(fit[-20:]):.4f} (last 20); accuracy on 1,024 fresh reads "
        f"{acc:.4f} (chance {1 / ds.n_buckets:.4f}); device peak "
        f"{peak:.2f} GiB")
    if acc < MLP_MIN_ACCURACY:
        raise RuntimeError(f"MLP accuracy {acc} below {MLP_MIN_ACCURACY}")
    del clf, ds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (c) the DQN on tests/test_research.py's environment
    env = neural.ReferenceGenomeEnv(random_genome(8 * 1024, seed=15,
                                                  n_refs=1),
                                    bucket_length=1024, read_length=80,
                                    substitution_rate=0.0, seed=16)
    agent = neural.DQNAgent(env, k=6, d_model=dqn_d_model, lr=3e-3, eps=0.3,
                            seed=17, device=dev)
    t0 = time.perf_counter()
    avg = agent.learn(total_timesteps=800, batch_size=32)
    sync(torch, dev)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"[research] DQN (k=6, d_model={dqn_d_model}) on {dev}: 800 steps in "
        f"{time.perf_counter() - t0:.2f} s, final average reward {avg:.2f} "
        f"(random 0.125); kernel launches in phase 12 {launched}")
    if avg <= 0.4:
        raise RuntimeError(f"DQN final average reward {avg} <= 0.4")
    if launched:
        raise RuntimeError(f"the research tree launched kernels: {launched}")


def sweep_phase(torch, dev, index, genome, cache_dir: str,
                n: int = BATCH) -> None:
    """Phase 13: experiments.error_sweep_production.run on the bench world
    at three read lengths, 0.2% substitutions and 0.025% indels; the
    300 bp row at the main path's floors, the map kernels launched."""
    from bucketmap_tpu_torch import kernels
    from bucketmap_tpu_torch.experiments import error_sweep_production

    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = error_sweep_production.run(index, genome, cache_dir, n=n,
                                      read_lens=(100, 150, 300),
                                      sub_rates=(0.002,),
                                      indel_rates=(0.00025,), device=dev)
    launches = dict(kernels.LAUNCHES)
    log(f"[sweep] {len(rows)} configurations of {n} reads in "
        f"{time.perf_counter() - t0:.1f} s (simulation and warm-up "
        f"included); launches {launches}")
    last = rows[-1]
    if last["pct_mapped"] < MIN_MAPPED or \
            last["pct_correct_position"] < MIN_CORRECT:
        raise RuntimeError(f"the sweep's 300 bp row is below the floor: "
                           f"{last}")
    if torch.device(dev).type == "cuda":
        check_map_launches(launches, MAP_KERNELS, "the production sweep")


def ont_phase(torch, timer, dev, index, genome, cache_dir: str,
              main_launches: dict, genome_mbp: float) -> dict:
    """Phase 14, ONT long reads on the bench world: ONT_READS reads of
    ~7.5 kbp (world.bench_reads) mapped on `index` at the reference's
    long-read flags (world.ont_config): (a) align-free, the accuracy
    floors, the map kernels against their plain versions on one batch of
    its segment rows; (b) the segment-stitched align mode, its floors,
    CIGAR lengths and MAPQ range, dp_runs and dp_fwd against their plain
    versions on the stitcher's first DP sub-batch at the geometry that
    call uses, the first packed-ops re-run (dp_fwd, which writes the
    records of an overflowing sub-batch) against the same path on
    dp_fwd_plain, and the host seconds of the stitching loop. genome_mbp
    names the reads' cache files. Returns (each run's launches by run
    name, each run's bench_columns: "align-free", "stitched align")."""
    import dataclasses
    from unittest import mock

    import numpy as np

    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.device import upload_u32
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.ops import align as align_ops
    from bucketmap_tpu_torch.ops.align import (dp_fwd, dp_fwd_plain, dp_runs,
                                               dp_runs_plain, pack_qcodes,
                                               run_budget, runs_vector)

    n_reads = ONT_READS
    fastq, gt, sim_s = world.bench_reads(cache_dir, n_reads, genome_mbp,
                                         genome, long=True, log=log)
    ont = dataclasses.replace(index, config=world.ont_config(index.config))
    cfg = ont.config
    out, cols = {}, {}

    def report_run(what, sam, stats, seconds, launches, peak):
        mapped, c10, c5, ctol, tol = score_long(sam, gt, ont, stats)
        cols[what] = bench_columns(mapped, c10, c5, stats, (tol, ctol))
        log(f"[ont] {what}: {stats.num_reads} reads, {stats.num_bases} bases "
            f"(mean {stats.num_bases / stats.num_reads:.1f} bp), in "
            f"{seconds:.2f} s = {stats.num_reads / seconds:.1f} reads/s, "
            f"{stats.num_bases / seconds:.1f} bases/s; pct_mapped "
            f"{mapped:.2f}; pct_correct_position +-10 {c10:.2f}, +-5 "
            f"{c5:.2f}, +-{tol} {ctol:.2f}; locations/read "
            f"{stats.mapped_locations / stats.num_reads:.4f}; candidate "
            f"pairs {stats.candidate_pairs}; step+decode "
            f"{stats.fine_seconds:.2f} s, segmenting "
            f"{stats.coarse_seconds:.2f} s, SAM {stats.output_seconds:.2f} s;"
            f" device peak {peak:.2f} GiB; {host_rss()}; launches {launches}")
        if stats.num_reads < n_reads:
            raise RuntimeError(f"{what}: mapped {stats.num_reads} of "
                               f"{n_reads} reads")
        return mapped, c10, ctol

    # (a) align-free
    pipe = BucketMapPipeline(ont, device=dev, batch_size=BATCH,
                             pair_batch=BATCH)
    log(f"[ont] {n_reads} long reads ready in {sim_s:.1f} s; flags -s "
        f"{cfg.mapper_samples} -e {cfg.seed_miss_rate} -n {cfg.indel_rate} "
        f"-p {cfg.locator_samples} -u {cfg.quality_threshold} on phase 3's "
        f"index; {cfg.num_segment_samples} segments of {cfg.read_len} bp a "
        f"read")
    sam = os.path.join(cache_dir, "chip_smoke_ont.sam")
    stats, seconds, launches, peak = timed_map(torch, dev, pipe, fastq, sam)
    mapped, _, ctol = report_run("align-free", sam, stats, seconds, launches,
                                 peak)
    if mapped < MIN_MAPPED or ctol < ONT_MIN_CORRECT_DRIFT:
        raise RuntimeError(f"ONT align-free below the floor: mapped "
                           f"{mapped:.2f} (>= {MIN_MAPPED}), correct within "
                           f"the drift tolerance {ctol:.2f} (>= "
                           f"{ONT_MIN_CORRECT_DRIFT})")
    check_map_launches(launches, MAP_KERNELS, "ONT align-free")
    out["ont"] = launches
    batch = world.first_reads(fastq, -(-BATCH // cfg.num_segment_samples))
    cases, ins = map_kernel_cases(torch, pipe, batch)
    for case in cases:
        check_kernel(torch, timer, *case, launches[case[0]],
                     main_launches[case[0]])
    search_before_after(torch, pipe.device, ins["lanes"],
                        f"ONT, p = {cfg.locator_samples}")
    del pipe, cases, ins, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the segment-stitched align mode
    pipe = BucketMapPipeline(ont, device=dev, align=True, batch_size=BATCH,
                             pair_batch=BATCH)
    al = pipe.aligner
    sam_al = os.path.join(cache_dir, "chip_smoke_ont_align.sam")
    with CallLog(pipe, "_align_long_emit", "_emit_records") as emit, \
            CallLog(al, "align_batch_runs_stream", "_sub_batch",
                    "_ops_rerun") as dp:
        stats, seconds, launches, peak = timed_map(torch, dev, pipe, fastq,
                                                   sam_al)
    mapped, c10, _ = report_run("stitched align", sam_al, stats, seconds,
                                launches, peak)
    n_rec, n_star, bad, bad_mapq = check_cigars(sam_al)
    dp_s = dp.seconds["align_batch_runs_stream"]
    stitch_s = emit.seconds["_align_long_emit"] - dp_s \
        - emit.seconds["_emit_records"]
    log(f"[ont] stitched align: records {n_rec} (CIGAR '*' {n_star}, CIGAR "
        f"query length != SEQ length {bad}, MAPQ outside [0, 60] "
        f"{bad_mapq}); DP sub-batches {al.counts['sub_batches']} pairs "
        f"{al.counts['pairs']} packed-ops re-runs {al.counts['ops_reruns']}; "
        f"host seconds: the DP calls with their runs unpacked {dp_s:.2f}, "
        f"the stitching loop {stitch_s:.2f}, SAM formatting "
        f"{emit.seconds['_emit_records']:.2f}")
    if mapped < MIN_MAPPED or c10 < MIN_CORRECT:
        raise RuntimeError(f"ONT align below the floor: mapped {mapped:.2f} "
                           f"(>= {MIN_MAPPED}), correct {c10:.2f} (>= "
                           f"{MIN_CORRECT})")
    if n_star or bad or bad_mapq:
        raise RuntimeError("ONT align records with a '*' CIGAR, a CIGAR "
                           "that does not consume SEQ or a MAPQ outside "
                           "[0, 60]")
    # a sub-batch with an unterminated traceback re-runs through the
    # packed-ops path (dp_fwd), as the reference's does; at these flags
    # every sub-batch has one
    check_map_launches(launches, ALIGN_KERNELS + ("dp_fwd",),
                       "ONT stitched align")
    out["ont_align"] = launches

    # dp_runs on the stitcher's first sub-batch, at the call's geometry
    kw = dp.kwargs["align_batch_runs_stream"][0]
    wrap, cap = kw["wrap_star"], kw["run_cap_per_pair"]
    qc, (qlen, bids, offs, is_rc, width) = dp.first["_sub_batch"]
    P = qc.shape[0]
    Qp = -(-qc.shape[1] // 16) * 16
    qfull = torch.zeros((P, Qp), dtype=torch.uint8, device=dev)
    qfull[:, :qc.shape[1]] = torch.from_numpy(qc.astype("uint8")).to(dev)
    textp, band, lo = al._text_windows(Qp, bids, offs, is_rc, width)
    mr = run_budget(band)[1]
    n = DP_PAIRS
    dargs = (textp[:n].contiguous(), qfull[:n].contiguous(),
             qlen[:n].contiguous(), width[:n].contiguous(), band, lo)
    shape = (f"the stitcher's first sub-batch: {n} of its {P} segment "
             f"pairs, Q {Qp}, band {band}, lo {lo}")
    check_kernel(torch, timer, "dp_fwd", "bucketmap_tpu_torch/csrc/dp_fwd.cu",
                 "bucketmap_tpu/ops/align.py:95", lambda: dp_fwd(*dargs),
                 lambda: dp_fwd_plain(*dargs), shape,
                 dp_bound(dargs[0], dargs[1], band), launches["dp_fwd"],
                 main_launches["dp_fwd"])
    check_kernel(torch, timer, "dp_runs", "bucketmap_tpu_torch/csrc/dp_fwd.cu",
                 "bucketmap_tpu/ops/align.py:95",
                 lambda: dp_runs(*dargs, wrap),
                 lambda: dp_runs_plain(*dargs, wrap),
                 f"{shape}, MR {mr}, wrap_star {wrap}, run cap {cap} a pair",
                 runs_bound(*dargs[:3], band, mr), launches["dp_runs"],
                 main_launches["dp_runs"])
    # the first packed-ops re-run, whose scores, begins and ops became
    # the sub-batch's records, against the same path on dp_fwd_plain
    rerun = dp.first_args["_ops_rerun"]
    with mock.patch.object(align_ops, "dp_fwd", dp_fwd_plain):
        want = al._ops_rerun(*rerun)
    equal = all(np.array_equal(a, b)
                for a, b in zip(dp.first["_ops_rerun"], want))
    log(f"[kernel] dp_fwd: the stitcher's first packed-ops re-run (pairs "
        f"{rerun[-2]}..{rerun[-1]}, Q {rerun[0].shape[1]}) as its scores, "
        f"begins and packed ops: equal to the same path on dp_fwd_plain "
        f"{equal}")
    if not equal:
        raise RuntimeError("the stitcher's packed-ops re-run differs from "
                           "the one dp_fwd_plain gives")
    full = (textp, qfull, qlen, width, band, lo)
    run_cap = -(-cap * P // 2) * 2
    vec = al._align_runs(upload_u32(pack_qcodes(qc), dev), qlen, bids, offs,
                         is_rc, width, run_cap=run_cap, wrap_star=wrap)
    equal = torch.equal(vec, runs_vector(*dp_runs_plain(*full, wrap),
                                         run_cap))
    log(f"[kernel] dp_runs: the stitcher's whole first sub-batch ({P} "
        f"pairs) as its vector (header {vec[:4].tolist()}, {vec.numel()} "
        f"words): equal to dp_runs_plain's {equal}")
    if not equal:
        raise RuntimeError("the stitcher's sub-batch vector differs from the "
                           "one dp_runs_plain gives")
    full_size(torch, timer, "dp_runs", f"the stitcher's whole first "
              f"sub-batch ({P} pairs)", lambda: dp_runs(*full, wrap),
              runs_bound(textp, qfull, qlen, band, mr))
    return out, cols


def grch38_phase(torch, timer, dev, cache_dir: str,
                 main_launches: dict) -> dict:
    """Phase 15, the GRCh38-scale world at FracMinHash f = GRCH38_FRAC
    (world.bench_world): (a) the device tables (the tiled fine table past
    2^31 elements), the map kernels against their plain versions on one
    batch, fine_window on windows past element 2^31 of its table (the
    batch's, and windows made from the table's own slots up to its last),
    coarse_score at the full batch, and the batch's step vector through
    the tiled path against the scan path's; (b) map_fastq align-free over
    all reads, the accuracy floors. Returns (the map's launches, its
    bench_columns)."""
    import numpy as np

    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.mapper import device_pipeline
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.ops.coarse import coarse_score, coarse_score_plain
    from bucketmap_tpu_torch.ops.vote import (WINDOW_ROWS, fine_search,
                                              fine_search_plain, fine_window,
                                              fine_window_plain)

    genome_mbp, n_reads = GRCH38_MBP, GRCH38_READS
    log(f"[grch38] device memory before the phase: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated; "
        f"{host_rss()}")
    index, fastq, gt, world_s = world.bench_world(
        cache_dir, genome_mbp, n_reads, log=log, kmer_fraction=GRCH38_FRAC)
    cfg = index.config
    absent = float((np.asarray(index.kmer_to_row) < 0).mean())
    log(f"[grch38] {genome_mbp:g} Mbp world at kmer_fraction "
        f"{cfg.kmer_fraction:g}: {index.n_buckets} buckets, occupancy "
        f"{tuple(index.qgram_words.shape)} words ({absent:.4f} of the "
        f"{cfg.num_qgrams} q-grams have no row), {n_reads} reads; ready in "
        f"{world_s:.1f} s")

    # the device tables
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with CallLog(device_pipeline, "build_fine_index_on_device") as build:
        pipe = BucketMapPipeline(index, device=dev, batch_size=BATCH,
                                 pair_batch=BATCH)
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dm = pipe.device
    ftf = dm.fine.fine_packed.reshape(-1, 128)
    log(f"[grch38] device tables ready in {init_s:.1f} s, of which the fine "
        f"build {build.seconds['build_fine_index_on_device']:.1f} s; vote "
        f"path {dm.vote_path}; fine table {tuple(dm.fine.fine_packed.shape)} "
        f"int32 = {ftf.numel()} elements ({ftf.numel() / 2**31:.3f} x 2^31, "
        f"{ftf.numel() * 4 / 2**30:.2f} GiB), search_steps "
        f"{dm.fine.search_steps}; {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
        f" GiB allocated, build peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if dm.vote_path != "tiled" or ftf.numel() <= PAST_ELEMENT:
        raise RuntimeError(f"expected the tiled vote path over a table past "
                           f"{PAST_ELEMENT} elements, got {dm.vote_path} over "
                           f"{ftf.numel()}")
    # (b) the map over all reads, before (a)'s checks add their launches
    sam = os.path.join(cache_dir, "chip_smoke_grch38.sam")
    stats, seconds, launches, peak = timed_map(torch, dev, pipe, fastq, sam)
    mapped, correct = world.score_sam(sam, gt, index)
    cols = bench_columns(mapped, correct,
                         world.score_sam(sam, gt, index, tol=5)[1], stats)
    log(f"[grch38] {stats.num_reads} reads in {seconds:.2f} s = "
        f"{stats.num_reads / seconds:.1f} reads/s; pct_mapped {mapped:.2f} "
        f"pct_correct_position(+-10) {correct:.2f} locations/read "
        f"{stats.mapped_locations / stats.num_reads:.4f}; candidate pairs "
        f"{stats.candidate_pairs}; step+decode {stats.fine_seconds:.2f} s, "
        f"SAM writer {stats.output_seconds:.2f} s; device peak {peak:.2f} "
        f"GiB; {host_rss()}; launches {launches}; card "
        f"{card_name_and_limit()}")
    if stats.num_reads < n_reads:
        raise RuntimeError(f"mapped {stats.num_reads} of {n_reads} reads")
    if mapped < MIN_MAPPED or correct < MIN_CORRECT:
        raise RuntimeError(f"the 3.1 Gbp world below the floor: mapped "
                           f"{mapped:.2f}, correct {correct:.2f}")
    check_map_launches(launches, MAP_KERNELS, "the 3.1 Gbp world")

    # (a) the kernels on this world's inputs
    cases, ins = map_kernel_cases(torch, pipe, world.first_reads(fastq, BATCH))
    packed, rows_all, table = ins["packed"], ins["rows_all"], ins["table"]
    # fine_window on windows past element PAST_ELEMENT: the batch's first
    # vote chunk's, and windows made from the table's own slots
    _, frow, lo_rel, hi_rel, low, n_occ, low_bits = ins["wargs"]
    first_row = PAST_ELEMENT // 128
    past = torch.nonzero(frow.to(torch.int64) >= first_row).flatten()
    g = torch.Generator().manual_seed(15)
    nt = ftf.shape[0]
    mrow = torch.randint(first_row, nt - WINDOW_ROWS + 1, (WINDOW_MADE,),
                         generator=g)
    mrow[-1] = nt - WINDOW_ROWS
    slot = torch.randint(0, WINDOW_ROWS * 128, (WINDOW_MADE,), generator=g)
    mrow, slot = mrow.to(dev), slot.to(dev)
    mlow = ftf.reshape(-1)[mrow * 128 + slot] & ((1 << low_bits) - 1)
    wargs = (ftf, torch.cat([frow[past], mrow.to(torch.int32)]),
             torch.cat([lo_rel[past], torch.zeros_like(mrow, dtype=torch.int32)]),
             torch.cat([hi_rel[past], torch.full_like(
                 mrow, WINDOW_ROWS * 128, dtype=torch.int32)]),
             torch.cat([low[past], mlow.to(torch.int32)]), n_occ, low_bits)
    fl = dm.fine
    T = fl.fine_packed.shape[1]
    first_bucket = -(-first_row // T)
    by_name = {case[0]: i for i, case in enumerate(cases)}
    cases[by_name["fine_window"]] = (
        *cases[by_name["fine_window"]][:3], lambda: (fine_window(*wargs),),
        lambda: (fine_window_plain(*wargs),),
        f"{past.numel()} of the first vote chunk's {frow.numel()} "
        f"windows past element {PAST_ELEMENT} (buckets >= {first_bucket}) "
        f"and {WINDOW_MADE} made from the table's slots up to its last "
        f"window (elements up to {ftf.numel()})",
        window_bound(torch, ftf, wargs[1], n_occ))
    # fine_search on rows past element PAST_ELEMENT: the batch's lanes on
    # buckets >= first_bucket, and lanes made on those buckets up to the
    # table's last, each with a read of the batch drawn at random
    lanes = ins["lanes"]
    nv = lanes["n_valid"]
    mine = torch.nonzero(lanes["vote_bucket"][:nv] >= first_bucket
                         ).flatten()[:WINDOW_MADE]
    n_fb = fl.fine_packed.shape[0]
    mb = torch.randint(first_bucket, n_fb, (WINDOW_MADE,), generator=g)
    mb[-1] = n_fb - 1
    mr = torch.randint(0, lanes["samp_hash"].shape[0], (WINDOW_MADE,),
                       generator=g)
    mrc = torch.rand(WINDOW_MADE, generator=g) < 0.5
    sargs = (fl.fine_packed, fl.fine_ptab,
             torch.cat([lanes["vote_bucket"][mine], mb.to(dev)]),
             torch.cat([lanes["lane_rc"][mine], mrc.to(dev)]),
             torch.cat([lanes["lane_read"][mine], mr.to(dev)]),
             lanes["samp_hash"], lanes["samp_idx"], lanes["lengths"],
             cfg.query_seed, fl.low_bits, fl.search_steps)
    n_valid_prop = int((fine_search_plain(*sargs)[1] != 0).sum())
    cases[by_name["fine_search"]] = (
        *cases[by_name["fine_search"]][:3], lambda: fine_search(*sargs),
        lambda: fine_search_plain(*sargs),
        f"{mine.numel()} of the batch's lanes on buckets >= {first_bucket} "
        f"(rows past element {PAST_ELEMENT}) and {WINDOW_MADE} made on "
        f"those buckets up to the table's last ({n_fb - 1}), x "
        f"{cfg.locator_samples} samples ({n_valid_prop} valid proposals)",
        search_bound(torch, *sargs))
    for case in cases:
        check_kernel(torch, timer, *case, launches[case[0]],
                     main_launches[case[0]])
    s = cfg.mapper_samples
    check_equal(torch, "coarse_score", f"the full batch "
                f"({rows_all.shape[0] // s} read-strands x {s} samples x "
                f"{table.shape[1]} words)",
                lambda: coarse_score(table, rows_all, index.n_buckets, s),
                lambda: coarse_score_plain(table, rows_all, index.n_buckets,
                                           s))
    full_size(torch, timer, "coarse_score",
              f"the full batch ({rows_all.shape[0] // s} read-strands, "
              f"{table.shape[1]} words)",
              lambda: coarse_score(table, rows_all, index.n_buckets, s),
              coarse_bound(torch, table, rows_all, s))
    vec = dm.step_packed(packed).cpu()
    del cases, ins, rows_all, wargs, mrow, slot, mlow, lanes, sargs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scan = device_pipeline.DeviceMapper(index, dev, batch_size=BATCH,
                                        vote_chunk=dm.vote_chunk,
                                        fine_build="host")
    scan_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    vec_scan = scan.step_packed(packed).cpu()
    scan_s = time.perf_counter() - t0
    equal = torch.equal(vec, vec_scan)
    log(f"[grch38] one batch's step vector ({vec.shape[0]} words) through "
        f"the tiled path equal to the scan path's {equal} (scan mapper "
        f"{scan.vote_path}, ready in {scan_init:.1f} s, its step "
        f"{scan_s:.2f} s)")
    if scan.vote_path != "scan" or not equal:
        raise RuntimeError("the tiled path's step vector differs from the "
                           "scan path's")
    del scan, packed, pipe, dm, ftf
    gc.collect()
    torch.cuda.empty_cache()
    return launches, cols


def run_bench(what: str, cache_dir: str, timeout: float, device: str = "cuda",
              **knobs):
    """`python3 bench_torch.py` in its own process (its host RSS its own)
    with the BMTPU_BENCH_* knobs given: logs its [bench] and [world] lines
    and its JSON line; returns (the JSON object, its timed map's kernel
    launches, the process's seconds). Raises where it fails."""
    env = dict(os.environ, BMTPU_BENCH_CACHE=cache_dir,
               **{f"BMTPU_BENCH_{k}": str(v) for k, v in knobs.items()})
    t0 = time.perf_counter()
    # through a shell that forks it: a process exec'd straight from this
    # one starts its ru_maxrss at this process's peak (Linux keeps the
    # high-water mark of the image it replaces); the shell's child starts
    # from the shell's
    res = subprocess.run(["sh", "-c", '"$0" "$1" --device "$2"; exit $?',
                          sys.executable, os.path.join(HERE, "bench_torch.py"),
                          device], cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    launches = None
    for ln in res.stderr.splitlines():
        if ln.startswith(("[bench]", "[world]")):
            log(f"[bench] {what}: {ln}")
        marker = "kernel launches in the timed map: "
        if marker in ln:
            launches = json.loads(ln.split(marker, 1)[1])
    if res.returncode or launches is None:
        raise RuntimeError(f"bench_torch.py ({what}) failed, rc "
                           f"{res.returncode}: {res.stderr[-3000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"[bench] {what}: {json.dumps(out)} ({seconds:.1f} s of process)")
    return out, launches, seconds


def check_columns(what: str, got: dict, want: dict) -> None:
    """Raise unless bench_torch's accuracy columns `got` equal `want`."""
    diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    log(f"[bench] {what}: accuracy columns {'equal' if not diff else 'DIFFER'}"
        f" {want if not diff else diff}")
    if diff:
        raise RuntimeError(f"{what}: bench_torch.py's columns (got, want) "
                           f"{diff}")


def bench_phase(torch, dev, cache_dir: str, genome_mbp: float, fastq: str,
                ont_cols: dict, grch38_cols: dict) -> None:
    """Phase 16, bench_torch.py and the profilers: (1) bench_torch.py at
    bench.py's defaults, align-free (1,000,000 reads), its accuracy
    columns R05's, io_native, the three map kernels launched; (2) in align
    mode at its defaults, R05's columns, dp_runs launched, phase 6's CIGAR
    check (query lengths) on its SAM; (3) BMTPU_BENCH_LONG=1 with phase 14's reads,
    align-free and in align mode, each run's columns phase 14's; (4) the
    3.1 Gbp f=0.25 world with phase 15's reads, its columns phase 15's;
    (5) profile_step, profile_coarse_sub and profile_select on the first
    16,384 reads of (1)'s FASTQ (the decomposition's vector step_packed's
    word for word, the staged branch's score the fused one's, the
    coarse and select decompositions equal to their methods) and
    profile_driver over DRIVER_BATCHES batches (the sequential cycle's SAM
    map_reads' byte for byte); (6) profile_grch38_warmup on phase 15's
    world, then profile_pipeline over PIPELINE_BATCHES batches of its
    reads; (7) four_profilers. The R05 equality holds at 1,700 Mbp only; another genome size
    reports the columns."""
    from bucketmap_tpu_torch import world
    from bucketmap_tpu_torch.experiments import (profile_coarse_sub,
                                                 profile_driver,
                                                 profile_grch38_warmup,
                                                 profile_pipeline,
                                                 profile_select, profile_step)
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

    mbp = {"GENOME_MBP": f"{genome_mbp:g}"}
    one_m = {"READS": BENCH_READS, **mbp}
    keys = ("pct_mapped", "pct_correct_position",
            "pct_correct_position_tol5", "locations_per_read")
    # (1) and (2): bench.py's defaults
    for mode, knobs, kernels_run in (
            ("align-free", {}, MAP_KERNELS),
            ("align", {"ALIGN": 1}, ALIGN_KERNELS)):
        out, launches, _ = run_bench(f"1M {mode}", cache_dir, 900, dev.type,
                                     **one_m, **knobs)
        check_map_launches(launches, kernels_run, f"bench_torch {mode}")
        if not out["io_native"]:
            raise RuntimeError("bench_torch.py ran without the C++ host "
                               "library")
        if genome_mbp == 1700:
            check_columns(f"1M {mode} against BENCH_MODES_r05.json", out,
                          dict(zip(keys, R05[mode])))
        if mode == "align":
            tag = world.reads_name(genome_mbp, BENCH_READS)[len("reads_"):]
            n_rec, n_star, bad, bad_mapq = check_cigars(
                os.path.join(cache_dir, f"out_{tag}_al.sam"))
            log(f"[bench] 1M align: records {n_rec} (CIGAR '*' {n_star}, "
                f"CIGAR query length != SEQ length {bad}, MAPQ outside "
                f"[0, 60] {bad_mapq})")
            if bad:
                raise RuntimeError("bench_torch.py's align SAM has CIGARs "
                                   "whose query length is not the read's")
    # (3) ONT, phase 14's reads, and (4) the 3.1 Gbp world, phase 15's
    for what, knobs, want in (
            ("ONT align-free", {"LONG": 1, "READS": ONT_READS, **mbp},
             ont_cols["align-free"]),
            ("ONT align", {"LONG": 1, "READS": ONT_READS, "ALIGN": 1, **mbp},
             ont_cols["stitched align"]),
            ("3.1 Gbp f=0.25", {"GENOME_MBP": f"{GRCH38_MBP:g}",
                                "FRAC": GRCH38_FRAC, "READS": GRCH38_READS},
             grch38_cols)):
        out, launches, _ = run_bench(what, cache_dir, 900, dev.type, **knobs)
        check_map_launches(launches, ALIGN_KERNELS if "ALIGN" in knobs
                           else MAP_KERNELS, f"bench_torch {what}")
        check_columns(f"{what} against phase {15 if 'FRAC' in knobs else 14}",
                      out, want)

    # (5) the step, coarse, select and driver profiles
    t0 = time.perf_counter()
    index = world.bench_index(cache_dir, genome_mbp, world.bench_config())[0]
    pipe = BucketMapPipeline(index, device=dev, batch_size=BATCH,
                             pair_batch=BATCH)
    batch = world.first_reads(fastq, DRIVER_BATCHES * BATCH)
    codes, quals, seg_len, _, _ = pipe._all_segments(batch.head(BATCH))
    packed = pipe.device.pack(codes, quals, seg_len)
    dm = pipe.device
    log(f"[profile] the bench world's index and pipeline ready in "
        f"{time.perf_counter() - t0:.1f} s; {card_name_and_limit()}")
    trace = os.path.join(cache_dir, "profile_trace")
    step = profile_step.profile(dm, packed, 3, trace, log)
    srch = step["stages"]["stages"]["search"]
    dev_ms = "not measured" if srch["device_ms"] is None \
        else f"{srch['device_ms']:.3f}"
    log(f"[profile] the step's vote search ({dm.vote_path} path): "
        f"{srch['calls']} chunks, launches {srch['launches']}, device ms "
        f"{dev_ms}, host ms {srch['host_ms']:.3f}, event ms "
        f"{srch['event_ms']:.3f}; the whole step {step['step']['launches']} "
        f"launches, wall {step['step']['wall_ms']:.3f} ms; "
        f"{card_name_and_limit()}")
    sub = profile_coarse_sub.profile(dm, packed, 3, trace, log)
    sel = profile_select.profile(dm, packed, 3, trace, log)
    drv = profile_driver.profile(pipe, batch, DRIVER_BATCHES, cache_dir, log)
    if not (step["vec_equal"] and step["staged_equal"] and sub["equal"]
            and sel["equal"] and drv["sam_equal"]):
        raise RuntimeError("a profile's decomposition differs from what the "
                           "pipeline computes")
    if not step["stages"]["traced"]:
        log("[profile] torch.profiler saw no device event: launches and "
            "device ms not measured")
    del pipe, dm, index, batch, packed
    gc.collect()
    torch.cuda.empty_cache()

    # (6) the 3.1 Gbp world's start-up, then the step's throughput there
    pipe, _, _ = profile_grch38_warmup.profile(
        cache_dir, GRCH38_MBP, GRCH38_FRAC, GRCH38_READS, BATCH, dev, log)
    fq = world.bench_reads(cache_dir, GRCH38_READS, GRCH38_MBP,
                           kmer_fraction=GRCH38_FRAC)[0]
    profile_pipeline.profile(pipe, world.first_reads(fq, GRCH38_READS),
                             PIPELINE_BATCHES, log)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # (7) the align, finewin, mesh and coarse profilers
    four_profilers(torch, dev, cache_dir, genome_mbp, fastq)


def four_profilers(torch, dev, cache_dir: str, genome_mbp: float,
                   fastq: str) -> dict:
    """Phase 16 (7): profile_align, profile_finewin, profile_mesh ("both")
    and profile_coarse on the bench world's index and `fastq` (its first
    reads, their buckets from the ground truth beside it), each under
    reset launch counts: raises where a profiler's check fails (each
    raises itself) or it launched none of a kernel of PROFILE_KERNELS.
    Returns {profiler: (its result, its launches, its seconds)}."""
    from bucketmap_tpu_torch import kernels, world
    from bucketmap_tpu_torch.experiments import (profile_align,
                                                 profile_coarse,
                                                 profile_finewin,
                                                 profile_mesh)

    t0 = time.perf_counter()
    index = world.bench_index(cache_dir, genome_mbp, world.bench_config())[0]
    gt = fastq[:-len(".fastq")] + ".bucket_ground_truth"
    trace = os.path.join(cache_dir, "profile_trace")
    log(f"[profile] the bench world's index loaded in "
        f"{time.perf_counter() - t0:.1f} s; {card_name_and_limit()}")

    def finewin():
        fl = profile_finewin.locator(index, dev)
        lane_args = profile_finewin.lanes(
            fl, world.first_reads(fastq, FINEWIN_PAIRS),
            *profile_finewin.ground_truth(gt, FINEWIN_PAIRS))
        return profile_finewin.profile(fl, lane_args, 1024, trace, log)

    runs = {
        "align": lambda: profile_align.profile(
            index, dev, ALIGN_PAIRS, ALIGN_PAIRS, trace, log),
        "finewin": finewin,
        "mesh": lambda: profile_mesh.profile(
            index, profile_mesh.bench_reads(index, fastq,
                                            MESH_BATCHES * BATCH),
            MESH_BATCHES, BATCH, "both", dev, trace, log),
        "coarse": lambda: profile_coarse.profile(
            profile_coarse.made_index(COARSE_MBP, COARSE_READS), dev, trace,
            log),
    }
    out = {}
    for name, fn in runs.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        got = {k: kernels.LAUNCHES[k] for k in PROFILE_KERNELS[name]}
        log(f"[profile] profile_{name}: {seconds:.1f} s, launches {got}; "
            f"{card_name_and_limit()}")
        if not all(got.values()):
            raise RuntimeError(f"profile_{name} launched none of "
                               f"{[k for k, n in got.items() if not n]}")
        out[name] = (res, got, seconds)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mbp", type=float, default=1700.0)
    ap.add_argument("--reads", type=int, default=8 * BATCH)
    args = ap.parse_args()

    # ---- 1. environment --------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        print("[env] torch.cuda.is_available() is false: this run needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    card = card_name_and_limit()
    log(card)
    sys.path.insert(0, HERE)
    from bucketmap_tpu_torch import kernels, world
    from bucketmap_tpu_torch.device import upload_u32
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.ops.align import (dp_fwd, dp_fwd_plain, dp_runs,
                                               dp_runs_plain, pack_qcodes,
                                               run_budget, runs_vector)
    from bucketmap_tpu_torch.ops.coarse import coarse_score, coarse_score_plain
    from bucketmap_tpu_torch.parallel import distributed
    triton = importlib.util.find_spec("triton")
    nvcc = kernels.nvcc()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} nvcc {nvcc or 'absent'} "
        f"triton {'present' if triton else 'absent'}")
    dev = torch.device("cuda", 0)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    regs = [ln.strip() for ln in kernels.BUILD_INFO.get("log", "").splitlines()
            if "registers" in ln]
    log(f"[build] {len(kernels.SOURCES)} CUDA sources -> "
        f"{kernels.BUILD_INFO['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.BUILD_INFO['seconds']:.2f} s, sm_90a); ptxas: "
        f"{'; '.join(sorted(set(regs)))}")
    from bucketmap_tpu_torch.io import native
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the C++ host library (bucketmap_tpu_torch/csrc/"
                           "host) did not build")
    log(f"[build] C++ host library (g++) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. world --------------------------------------------------------
    t0 = time.perf_counter()
    genome = world.bench_genome(args.genome_mbp)   # phases 12-13 read it too
    genome_s = time.perf_counter() - t0
    index, fastq, gt, world_s = world.bench_world(
        os.path.join(HERE, ".bench_cache"), args.genome_mbp, args.reads,
        genome=genome)
    cfg = index.config
    log(f"[world] {args.genome_mbp:g} Mbp repeat genome made in "
        f"{genome_s:.1f} s, {index.n_buckets} buckets, {args.reads} reads of "
        f"{cfg.read_len} bp, bucket_len {cfg.bucket_len}: ready in "
        f"{world_s:.1f} s more")

    # ---- 4. main path ----------------------------------------------------
    t0 = time.perf_counter()
    pipe = BucketMapPipeline(index, device=dev, batch_size=BATCH,
                             pair_batch=BATCH)
    torch.cuda.synchronize()
    log(f"[init] device tables ready in {time.perf_counter() - t0:.1f} s "
        f"(fine index built on the device: search_steps "
        f"{pipe.device.fine.search_steps}, low_bits {pipe.device.fine.low_bits}"
        f"; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated)")
    sam = os.path.join(HERE, ".bench_cache", "chip_smoke.sam")
    stats, map_s, launches, peak = timed_map(torch, dev, pipe, fastq, sam)
    mapped, correct = world.score_sam(sam, gt, index)
    log(f"[map] {stats.num_reads} reads in {map_s:.2f} s = "
        f"{stats.num_reads / map_s:.1f} reads/s; pct_mapped {mapped:.2f} "
        f"pct_correct_position(+-10) {correct:.2f} locations/read "
        f"{stats.mapped_locations / stats.num_reads:.4f}; candidate pairs "
        f"{stats.candidate_pairs}; step+decode {stats.fine_seconds:.2f} s, "
        f"segmenting {stats.coarse_seconds:.2f} s, SAM writer "
        f"{stats.output_seconds:.2f} s; device peak {peak:.2f} GiB; "
        f"launches {launches}")
    if stats.num_reads < args.reads:
        raise RuntimeError(f"mapped {stats.num_reads} of {args.reads} reads")
    candidate_pairs = stats.candidate_pairs
    if mapped < MIN_MAPPED or correct < MIN_CORRECT:
        raise RuntimeError(f"accuracy below the floor: mapped {mapped:.2f} "
                           f"(>= {MIN_MAPPED}), correct {correct:.2f} "
                           f"(>= {MIN_CORRECT})")
    check_map_launches(launches, MAP_KERNELS, "the main path")
    if launches["presence_gather"] or launches["chunk_scan"]:
        raise RuntimeError(f"the fused path launched the staged kernels: "
                           f"{launches}")

    # ---- 5. kernels against plain versions on main-path inputs ----------
    dm = pipe.device
    timer = DeviceTimer(torch, dev)
    cases, ins = map_kernel_cases(torch, pipe, world.first_reads(fastq, BATCH))
    report = [check_kernel(torch, timer, *case, launches[case[0]],
                           launches[case[0]]) for case in cases]
    search_before_after(torch, dm, ins["lanes"], "the main path")
    narrowing_checks(torch, dm.fine, cfg.read_len)
    packed, rows_all, table = ins["packed"], ins["rows_all"], ins["table"]
    s = cfg.mapper_samples
    wide = rows_all[: COARSE_ROWS * WIDE_S].contiguous()
    check_equal(torch, "coarse_score", f"{COARSE_ROWS} read-strands x "
                f"{WIDE_S} samples (six bit planes) x {table.shape[1]} words",
                lambda: coarse_score(table, wide, index.n_buckets, WIDE_S),
                lambda: coarse_score_plain(table, wide, index.n_buckets,
                                           WIDE_S))
    del wide
    check_equal(torch, "coarse_score", f"the full batch "
                f"({rows_all.shape[0] // s} read-strands x {s} samples x "
                f"{table.shape[1]} words)",
                lambda: coarse_score(table, rows_all, index.n_buckets, s),
                lambda: coarse_score_plain(table, rows_all, index.n_buckets,
                                           s))
    gc.collect()
    torch.cuda.empty_cache()
    full_size(torch, timer, "coarse_score",
              f"the full batch ({rows_all.shape[0] // s} read-strands)",
              lambda: coarse_score(table, rows_all, index.n_buckets, s),
              coarse_bound(torch, table, rows_all, s))
    # the single-device step's vector of this batch, for phase 8
    vec_single = dm.step_packed(packed).cpu()
    del cases, ins, pipe, dm, table
    torch.cuda.empty_cache()

    # ---- 6. align mode ---------------------------------------------------
    t0 = time.perf_counter()
    pipe = BucketMapPipeline(index, device=dev, align=True, batch_size=BATCH,
                             pair_batch=BATCH)
    torch.cuda.synchronize()
    log(f"[init] align pipeline ready in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated)")
    al = pipe.aligner
    sam_al = os.path.join(HERE, ".bench_cache", "chip_smoke_align.sam")

    with CallLog(al, "_sub_batch") as sub:
        stats, align_s, al_launches, peak = timed_map(torch, dev, pipe,
                                                      fastq, sam_al)
    mapped, correct = world.score_sam(sam_al, gt, index)
    n_rec, n_star, bad, _ = check_cigars(sam_al)
    log(f"[align] {stats.num_reads} reads in {align_s:.2f} s = "
        f"{stats.num_reads / align_s:.1f} reads/s; pct_mapped {mapped:.2f} "
        f"pct_correct_position(+-10) {correct:.2f} locations/read "
        f"{stats.mapped_locations / stats.num_reads:.4f}; DP sub-batches "
        f"{al.counts['sub_batches']} pairs {al.counts['pairs']} ops re-runs "
        f"{al.counts['ops_reruns']}; locate (step+decode) "
        f"{stats.fine_seconds:.2f} s, segmenting {stats.coarse_seconds:.2f} s, "
        f"align+SAM {stats.output_seconds:.2f} s; records {n_rec} ('*' "
        f"{n_star}); device peak {peak:.2f} GiB; launches {al_launches}")
    if stats.num_reads < args.reads:
        raise RuntimeError(f"aligned {stats.num_reads} of {args.reads} reads")
    if mapped < MIN_MAPPED or correct < MIN_CORRECT:
        raise RuntimeError(f"align accuracy below the floor: mapped "
                           f"{mapped:.2f} (>= {MIN_MAPPED}), correct "
                           f"{correct:.2f} (>= {MIN_CORRECT})")
    if bad:
        raise RuntimeError(f"{bad} records have a CIGAR whose query length "
                           f"is not the read length")
    check_map_launches(al_launches, ALIGN_KERNELS, "the align path")

    # ---- 7. the DP kernels on the main path's pairs ---------------------
    qc, (qlen, bids, offs, is_rc, width) = sub.first["_sub_batch"]
    P = qc.shape[0]
    Qp = -(-qc.shape[1] // 16) * 16            # the runs path's query width
    qfull = torch.zeros((P, Qp), dtype=torch.uint8, device=dev)
    qfull[:, :qc.shape[1]] = torch.from_numpy(qc.astype("uint8")).to(dev)
    textp, band, lo = al._text_windows(Qp, bids, offs, is_rc, width)
    mr = run_budget(band)[1]
    n = DP_PAIRS
    dargs = (textp[:n].contiguous(), qfull[:n].contiguous(),
             qlen[:n].contiguous(), width[:n].contiguous(), band, lo)
    # the packed-ops path, which the runs path re-runs a sub-batch through
    # when its run budget overflows
    host = [t[:n].cpu().numpy() for t in (qlen, bids, offs, is_rc)]
    kernels.reset_launches()
    sc_ops = al.align_batch(qc[:n], *host)[0]
    torch.cuda.synchronize()
    ops_launches = dict(kernels.LAUNCHES)
    same = torch.equal(torch.from_numpy(sc_ops), dp_runs(*dargs, True)[0][0]
                       .cpu())
    log(f"[align] packed-ops path (align_batch) on {n} located pairs: "
        f"launches {ops_launches}; scores equal to dp_runs's {same}")
    if ops_launches["dp_fwd"] == 0 or not same:
        raise RuntimeError("the packed-ops path did not launch dp_fwd or "
                           "its scores differ from dp_runs's")
    shape = f"{n} located pairs, Q {Qp}, band {band}, lo {lo}"
    report.append(check_kernel(
        torch, timer, "dp_fwd", "bucketmap_tpu_torch/csrc/dp_fwd.cu",
        "bucketmap_tpu/ops/align.py:95", lambda: dp_fwd(*dargs),
        lambda: dp_fwd_plain(*dargs), shape,
        dp_bound(dargs[0], dargs[1], band), ops_launches["dp_fwd"],
        launches["dp_fwd"]))
    report.append(check_kernel(
        torch, timer, "dp_runs", "bucketmap_tpu_torch/csrc/dp_fwd.cu",
        "bucketmap_tpu/ops/align.py:95", lambda: dp_runs(*dargs, True),
        lambda: dp_runs_plain(*dargs, True), f"{shape}, MR {mr}",
        runs_bound(*dargs[:3], band, mr), al_launches["dp_runs"],
        launches["dp_runs"]))
    dp_runs_shape_checks(torch, dev)
    full = (textp, qfull, qlen, width, band, lo)
    what = f"the full sub-batch ({P} pairs)"
    full_size(torch, timer, "dp_fwd", what, lambda: dp_fwd(*full),
              dp_bound(textp, qfull, band))
    full_size(torch, timer, "dp_runs", what, lambda: dp_runs(*full, True),
              runs_bound(textp, qfull, qlen, band, mr))
    qpk = upload_u32(pack_qcodes(qc), dev)
    run_cap = -(-al.run_cap_per_pair * P // 2) * 2
    vec = al._align_runs(qpk, qlen, bids, offs, is_rc, width, run_cap=run_cap)
    want = runs_vector(*dp_runs_plain(*full, True), run_cap)
    equal = torch.equal(vec, want)
    log(f"[kernel] dp_runs: {what}, as the sub-batch's vector (header "
        f"{vec[:4].tolist()}, {vec.numel()} words): equal to dp_runs_plain's "
        f"{equal}")
    if not equal:
        raise RuntimeError("the sub-batch's vector differs from the one "
                           "dp_runs_plain gives")
    runs_full_ms = timer.ms(lambda: dp_runs(*full, True), reps=5)
    win_ms = call_ms(torch, lambda: al._text_windows(
        Qp, bids, offs, is_rc, width), reps=5, warmup=1)
    sub_ms = call_ms(torch, lambda: al._align_runs(
        qpk, qlen, bids, offs, is_rc, width, run_cap=run_cap), reps=5,
        warmup=1)
    log(f"[kernel] one whole align sub-batch ({P} pairs; unpack, windows, "
        f"fused DP + traceback + RLE, packing), one call on an idle device: "
        f"{sub_ms:.4f} ms, of which windows {win_ms:.4f} ms; dp_runs on the "
        f"device {runs_full_ms:.4f} ms warm")
    del pipe, al, sub, qc, qfull, textp, dargs, full, qpk, vec, want
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8. the mesh step and the staged coarse branch ------------------
    with distributed.one_rank_group(dev) as mdev:
        report += mesh_phase(torch, timer, index, fastq, gt, sam, mdev,
                             rows_all, packed, vec_single, launches)

    # ---- 9. vote paths and device builds --------------------------------
    vote_paths_phase(torch, index, fastq, gt, sam, dev, packed, vec_single,
                     candidate_pairs)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. the command line ---------------------------------------------
    cli_phase(torch, "cuda", index, os.path.join(HERE, ".bench_cache"),
              world.index_name(args.genome_mbp), fastq, gt, sam, sam_al)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11. the FM-index -------------------------------------------------
    fm_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 12. the research tree --------------------------------------------
    research_phase(torch, dev, genome, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 13. the production error sweep, cut -----------------------------
    sweep_phase(torch, dev, index, genome, os.path.join(HERE, ".bench_cache"))

    # ---- 14. ONT long reads, align-free and stitched align ---------------
    mode_launches, ont_cols = ont_phase(torch, timer, dev, index, genome,
                                        os.path.join(HERE, ".bench_cache"),
                                        launches, args.genome_mbp)
    # phase 16's reads, bench.py's default world, from the genome held here
    bench_fq = world.bench_reads(os.path.join(HERE, ".bench_cache"),
                                 BENCH_READS, args.genome_mbp, genome)
    log(f"[bench] {BENCH_READS} reads of bench.py's default world ready in "
        f"{bench_fq[2]:.1f} s")
    del genome, index, rows_all, packed
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15. the 3.1 Gbp FracMinHash f=0.25 world ------------------------
    grch38_launches, grch38_cols = grch38_phase(
        torch, timer, dev, os.path.join(HERE, ".bench_cache"), launches)
    mode_launches[f"grch38_f{GRCH38_FRAC:g}"] = grch38_launches

    # ---- 16. bench_torch.py and the profilers ----------------------------
    bench_phase(torch, dev, os.path.join(HERE, ".bench_cache"),
                args.genome_mbp, bench_fq[0], ont_cols, grch38_cols)
    gc.collect()
    torch.cuda.empty_cache()
    for k in report:
        k["mode_launches"] = {m: n[k["name"]] for m, n in mode_launches.items()}

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "flax", "optax", "bucketmap_tpu", "research"))
    if foreign:
        raise RuntimeError(f"the port imported the JAX package, its research "
                           f"tree or jax: {foreign}")

    log(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
