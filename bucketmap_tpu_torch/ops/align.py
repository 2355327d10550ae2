"""Align stage on torch: banded semi-global alignment with CIGARs.

Counterpart of `bucketmap_tpu/ops/align.py:BandedAligner`, with the same
results: global alignment of each query against a text window of its
bucket with free end gaps on the text only, edit scheme (match 0,
mismatch and gaps -1), the score, the begin position in the text and a
CIGAR from a diagonal-first traceback. Reverse-strand pairs align the
original read against the reverse-complemented window, and report the
begin in that window's coordinates (the reference's POS quirk, kept).

Two kernels of `csrc/dp_fwd.cu` run the DP on a CUDA tensor; their
plain versions run on a CPU tensor. `dp_runs` (the device-RLE path,
`align_batch_runs_stream`) is the DP with the run-jump traceback and
each row's run-length encoding fused behind it: it returns each pair's
score, begin and merged runs. `dp_fwd` (the packed-ops path and its
overflow re-run) returns every direction byte for the per-cell
traceback in plain torch. Window extraction and the cross-pair packing
of the runs are plain torch. The packed genome is held on the device as
int32 words, with zero words past each bucket's end.
"""

from __future__ import annotations

import numpy as np
import torch

from bucketmap_tpu_torch.index.builder import BucketIndex
from bucketmap_tpu_torch import kernels
from bucketmap_tpu_torch.device import (host_tensor, i64_to_i32,
                                        resolve_device, upload_u32)
from bucketmap_tpu_torch.utils.debug import no_stage

NEG = -(10**8)
BAND = 128
LO = 32          # j - i >= -LO
_OP_CHARS = {1: "M", 2: "I", 3: "D"}
_NT_PAD = 4      # 128-word zero tiles past each bucket, as the reference pads
MAX_PAIR_BATCH = 16384
# Per-row run cap of the device RLE. A record-worthy alignment at quality
# threshold qt >= 0 has at most 60 - qt edits, ~2x that many runs.
MAX_ROW_RUNS = 128


def band_geometry(Q: int, indel_rate: float) -> tuple[int, int]:
    """(band, lo) for a query width Q at the config's indel rate: the
    diagonals a real alignment can reach (window slack plus net-indel
    drift), Q rounded up to 64, and the legacy (128, 32) where that would
    exceed it."""
    qb = -(-Q // 64) * 64
    drift = int(np.ceil(indel_rate * qb)) + 8
    lo = -(-drift // 8) * 8
    hi = 1 + int(indel_rate * qb) + drift
    band = max(32, -(-(lo + hi) // 16) * 16)
    if lo > LO or band > BAND:
        return BAND, LO
    return band, lo


def pack_qcodes(q: np.ndarray) -> np.ndarray:
    """2-bit-pack a (P, Q) uint8 code matrix into (P, ceil(Q/16)) uint32,
    LSB first."""
    P, Q = q.shape
    W = -(-Q // 16)
    qp = np.zeros((P, W * 16), np.uint32)
    qp[:, :Q] = q
    qp = qp.reshape(P, W, 16) << (np.arange(16, dtype=np.uint32)
                                  * 2)[None, None, :]
    return np.bitwise_or.reduce(qp, axis=2)


def dp_fwd_plain(textp: torch.Tensor, qcodes: torch.Tensor, qlen, width,
                 band: int, lo: int):
    """Plain PyTorch version of the forward DP kernel, one row at a time.

    textp (P, W) window text left-padded by lo (sentinel 4), qcodes
    (P, Q), qlen/width (P,). Returns dirs (Q+1, P, band) uint8, one byte
    dir | min(run, 63) << 2 per cell (dir 1 diagonal, 2 up, 3 left, 0
    none), and final (P, band) int32, the row i == qlen."""
    P, Q = qcodes.shape
    dev = textp.device
    i32 = torch.int32
    text = textp.to(i32)
    q = qcodes.to(i32)
    d_idx = torch.arange(band, dtype=i32, device=dev)[None, :]
    width = width.to(i32)[:, None]
    qlen = qlen.to(i32)[:, None]
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    j0 = d_idx - lo
    row0 = torch.where((j0 >= 0) & (j0 <= width), zero, neg)
    negcol = torch.full((P, 1), NEG, dtype=i32, device=dev)
    zcol = torch.zeros((P, 1), dtype=i32, device=dev)
    prev = row0
    prev_db = torch.zeros((P, band), dtype=i32, device=dev)
    final = torch.where(qlen == 0, row0, neg)
    dirs = torch.zeros((Q + 1, P, band), dtype=torch.uint8, device=dev)
    for i in range(1, Q + 1):
        trow = text[:, i - 1:i - 1 + band]
        diag = prev + torch.where(trow == q[:, i - 1:i], zero, zero - 1)
        up = torch.cat([prev[:, 1:], negcol], dim=1) - 1
        base = torch.maximum(diag, up)
        m = torch.cummax(base + d_idx, dim=1).values - d_idx
        j = i + d_idx - lo
        valid = (j >= 0) & (j <= width)
        m = torch.where(valid, m, neg)
        dir_ = torch.where(m == diag, 1, torch.where(m == up, 2, 3)).to(i32)
        dir_ = torch.where(valid & (m > NEG // 2), dir_, zero)
        pd, pr = prev_db & 3, prev_db >> 2
        run1 = (torch.where(pd == 1, pr, zero) + 1).clamp_max(63)
        pd_up = torch.cat([pd[:, 1:], zcol], dim=1)
        pr_up = torch.cat([pr[:, 1:], zcol], dim=1)
        run2 = (torch.where(pd_up == 2, pr_up, zero) + 1).clamp_max(63)
        last = torch.cummax(torch.where(dir_ != 3, d_idx, zero - 1),
                            dim=1).values
        run3 = (d_idx - last).clamp_max(63)
        run = torch.where(dir_ == 1, run1, torch.where(
            dir_ == 2, run2, torch.where(dir_ == 3, run3, zero)))
        db = torch.where(dir_ > 0, dir_ | (run << 2), zero)
        dirs[i] = db.to(torch.uint8)
        final = torch.where(qlen == i, m, final)
        prev, prev_db = m, db
    return dirs, final


def _check_dp_args(textp, qcodes, qlen, width, band: int, lo: int):
    """(P, W, Q) of a DP kernel's arguments; raises on what it does not
    take."""
    P, W = textp.shape
    Q = qcodes.shape[1]
    kernels.require(textp, "textp", torch.uint8, (P, W))
    kernels.require(qcodes, "qcodes", torch.uint8, (P, Q))
    kernels.require(qlen, "qlen", torch.int32, (P,))
    kernels.require(width, "width", torch.int32, (P,))
    for name, t in (("qcodes", qcodes), ("qlen", qlen), ("width", width)):
        if t.device != textp.device:
            raise ValueError(f"{name} and textp must be on the same device")
    if not (1 <= band <= BAND and 0 <= lo < band and W >= Q + band - 1):
        raise ValueError(f"bad geometry: band {band}, lo {lo}, W {W}, Q {Q}")
    return P, W, Q


def dp_fwd(textp: torch.Tensor, qcodes: torch.Tensor, qlen, width,
           band: int, lo: int):
    """Forward DP: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Same arguments and results as dp_fwd_plain; the kernel
    takes textp and qcodes as uint8, qlen and width as int32."""
    if textp.device.type == "cpu":
        return dp_fwd_plain(textp, qcodes, qlen, width, band, lo)
    P, W, Q = _check_dp_args(textp, qcodes, qlen, width, band, lo)
    dirs = torch.empty((Q + 1, P, band), dtype=torch.uint8, device=textp.device)
    final = torch.empty((P, band), dtype=torch.int32, device=textp.device)
    err = kernels.library().bm_dp_fwd(
        textp.data_ptr(), qcodes.data_ptr(), qlen.data_ptr(), width.data_ptr(),
        P, W, Q, band, lo, dirs.data_ptr(), final.data_ptr(),
        kernels.stream_handle(textp))
    kernels.check(err, "dp_fwd")
    kernels.LAUNCHES["dp_fwd"] += 1
    return dirs, final


def run_budget(band: int) -> tuple[int, int]:
    """(T2, MR) at this band: the run-jump budget of the traceback, and
    the runs kept per row."""
    T2 = 192 if band >= BAND else 64
    return T2, min(MAX_ROW_RUNS, T2)


def dp_runs_plain(textp: torch.Tensor, qcodes: torch.Tensor, qlen, width,
                  band: int, lo: int, wrap_star: bool):
    """Plain PyTorch version of the fused DP + run-jump traceback + per-row
    RLE kernel: dp_fwd_plain, then the traceback and the RLE in torch.

    Arguments as dp_fwd_plain. The traceback starts at (qlen, the
    smallest d at the final row's max) and each step jumps a whole
    same-op chain (runs capped at 63), T2 steps at most (run_budget);
    wrap_star starts rows with score < -60 at row 0, so their traceback
    is empty. The jumps in query order (reversed), with adjacent ones of
    the same op (a chain split by the 63 cap) merged, are the row's runs.
    Returns head (5, P) int32, rows score, begin (final d - lo), run
    count (also the runs past the cap), longest kept run, unterminated
    (0/1); and runs (P, MR) int32, the first MR runs as length << 2 |
    op, 0 past them."""
    P, Q = qcodes.shape
    dev = textp.device
    i64 = torch.int64
    dirs, final = dp_fwd_plain(textp, qcodes, qlen, width, band, lo)
    score = final.amax(dim=1).to(i64)
    flat = dirs.reshape(-1)
    row = P * band
    pbase = torch.arange(P, dtype=i64, device=dev) * band
    qlen64 = qlen.to(i64)
    T, MR = run_budget(band)
    i = torch.where(score < -60, 0, qlen64) if wrap_star else qlen64
    d = first_max_index(final)
    ops, lens = [], []
    for _ in range(T):
        # the byte at d clamped to the band; d itself is not clamped
        b = flat[i.clamp_max(Q) * row + pbase + d.clamp(0, band - 1)].to(i64)
        active = i > 0
        op = torch.where(active, b & 3, 0)
        run = torch.where(active, b >> 2, 0)
        i = torch.where((op == 1) | (op == 2), i - run, i)
        d = torch.where(op == 2, d + run, torch.where(op == 3, d - run, d))
        ops.append(op)
        lens.append(run)

    col = torch.arange(T, dtype=i64, device=dev)[None, :]
    # query order = reversed traceback order; a chain split by the 63 cap
    # leaves adjacent entries with the same op, merged here
    codes = torch.stack(ops, dim=1).flip(1)
    weights = torch.stack(lens, dim=1).flip(1)
    nz = codes != 0
    key = torch.where(nz, col * 4 + codes, -1)
    prev_key = torch.cummax(torch.nn.functional.pad(
        key[:, :-1], (1, 0), value=-1), dim=1).values
    prev_code = torch.where(prev_key >= 0, prev_key & 3, 0)
    isstart = nz & (codes != prev_code)
    run_id = torch.cumsum(isstart, dim=1) - 1
    n_runs = isstart.sum(dim=1)
    # per-run length (summed) and op (one per run) by run id; column MR
    # collects the entries past the row cap and the zeros
    rid = torch.where(nz & (run_id < MR), run_id, MR)
    acc = torch.zeros((2, P, MR + 1), dtype=i64, device=dev)
    rlen = acc[0].scatter_add_(1, rid, weights)[:, :MR]
    rop = acc[1].scatter_(1, rid, codes)[:, :MR]
    ridx = torch.arange(MR, dtype=i64, device=dev)[None, :]
    valid_run = ridx < n_runs.clamp_max(MR)[:, None]
    head = torch.stack([score, d - lo, n_runs,
                        torch.where(valid_run, rlen, 0).amax(dim=1),
                        (i > 0).to(i64)]).to(torch.int32)
    return head, torch.where(valid_run, (rlen << 2) | rop, 0).to(torch.int32)


def dp_runs(textp: torch.Tensor, qcodes: torch.Tensor, qlen, width,
            band: int, lo: int, wrap_star: bool):
    """Fused DP + run-jump traceback + per-row RLE: the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors. Same arguments and
    results as dp_runs_plain; the kernel takes textp and qcodes as uint8,
    qlen and width as int32."""
    if textp.device.type == "cpu":
        return dp_runs_plain(textp, qcodes, qlen, width, band, lo, wrap_star)
    P, W, Q = _check_dp_args(textp, qcodes, qlen, width, band, lo)
    T, MR = run_budget(band)
    dev = textp.device
    lib = kernels.library()
    nbytes = lib.bm_dp_runs_scratch_bytes(P, W, Q, band)
    if nbytes < 0:
        raise ValueError(f"Q {Q} is too long for the fused DP's staging")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes
               else None)
    head = torch.empty((5, P), dtype=torch.int32, device=dev)
    runs = torch.empty((P, MR), dtype=torch.int32, device=dev)
    err = lib.bm_dp_runs(
        textp.data_ptr(), qcodes.data_ptr(), qlen.data_ptr(), width.data_ptr(),
        P, W, Q, band, lo, T, MR, int(wrap_star),
        None if scratch is None else scratch.data_ptr(), head.data_ptr(),
        runs.data_ptr(), kernels.stream_handle(textp))
    kernels.check(err, "dp_runs")
    kernels.LAUNCHES["dp_runs"] += 1
    return head, runs


def runs_vector(head: torch.Tensor, runs: torch.Tensor,
                run_cap: int) -> torch.Tensor:
    """The device-RLE vector (BandedAligner._align_runs's layout) of
    dp_runs's outputs: the header, score, begin and run count per row,
    and the rows' kept runs back to back in run_cap uint16 slots, two per
    int32 word. Slot s belongs to the row whose span [goff - n_runs, goff)
    holds it, as that row's run s - (goff - n_runs); runs past a row's
    kept MR, and slots past the last row, stay 0."""
    P, MR = runs.shape
    dev = runs.device
    n_runs = head[2].to(torch.int64)
    goff = torch.cumsum(n_runs, dim=0)
    slot = torch.arange(run_cap, dtype=torch.int64, device=dev)
    row = torch.searchsorted(goff, slot, right=True)
    rowc = row.clamp_max(P - 1)
    k = slot - (goff - n_runs)[rowc]
    take = (row < P) & (k < MR)
    flat = torch.where(take, runs.reshape(-1)[rowc * MR + k.clamp_max(MR - 1)],
                       0).to(torch.int64).reshape(run_cap // 2, 2)
    runs_w = i64_to_i32(flat[:, 0] | (flat[:, 1] << 16))
    hdr = torch.stack([goff[-1], n_runs.amax(), head[3].amax().to(torch.int64),
                       head[4].sum()]).to(torch.int32)
    return torch.cat([hdr, head[:3].reshape(-1), runs_w])


def first_max_index(final: torch.Tensor) -> torch.Tensor:
    """(P,) smallest d where final[:, d] equals the row's max."""
    band = final.shape[1]
    d_idx = torch.arange(band, dtype=torch.int64, device=final.device)
    best = final.amax(dim=1, keepdim=True)
    return torch.where(final == best, d_idx, band).amin(dim=1)


class BandedAligner:
    def __init__(self, index: BucketIndex, device, pair_batch: int = 512):
        self.device = resolve_device(device)
        self.index = index
        self.cfg = index.config
        self.pair_batch = pair_batch
        bp = np.asarray(index.buckets_packed)
        n, wb = bp.shape
        self.words = wb
        self.padded_words = (-(-wb // 128) + _NT_PAD) * 128
        self.buckets_packed = torch.zeros((n, self.padded_words),
                                          dtype=torch.int32, device=self.device)
        self.buckets_packed[:, :wb] = upload_u32(bp, self.device)
        self.bucket_lengths = np.asarray(index.bucket_lengths)
        # device-RLE run budget per pair (shared across the sub-batch);
        # overflow falls back to the packed-ops path for that sub-batch
        self.run_cap_per_pair = 8
        # DP sub-batches run, pairs aligned, overflow re-runs; and, summed
        # over the runs-path sub-batches, the shapes of their dp_runs
        # launches: padded rows launched, rows the traceback can reach
        # (min(qlen, Q) of the real pairs), launched rows times the text
        # width, times Q and times the kept runs MR, and reachable rows
        # times the band
        self.counts = {"sub_batches": 0, "pairs": 0, "ops_reruns": 0,
                       "dp_launched_rows": 0, "dp_rows": 0,
                       "dp_row_text": 0, "dp_row_query": 0,
                       "dp_row_runs": 0, "dp_row_band": 0}
        # entered around each part of a runs-mode sub-batch: "pad and
        # upload", "pack", "runs vector", "download", "consume" (a
        # profiler's StageClock, experiments/profile_align.py)
        self.stage = no_stage

    # ------------------------------------------------------------------
    def _extract_windows(self, bucket_ids, offsets, wmax: int) -> torch.Tensor:
        """(P, wmax) int32 base codes of each pair's text window.

        The window starts at word0 = offset // 16, clamped so words_needed
        = wmax // 16 + 2 words fit in the bucket, plus a base shift
        clamped to 16 * words_needed - wmax: near the packed bucket end
        the window is shifted left, as the reference's is. Words past the
        bucket read as 0."""
        dev = self.buckets_packed.device
        wn = wmax // 16 + 2
        off = offsets.to(torch.int64).clamp_min(0)
        word0 = (off // 16).clamp(0, max(0, self.words - wn))
        start = (off - word0 * 16).clamp(0, 16 * wn - wmax)
        g = (word0 * 16 + start)[:, None] + torch.arange(
            wmax, dtype=torch.int64, device=dev)[None, :]
        word = (g >> 4).clamp_max(self.padded_words - 1)
        w = self.buckets_packed[bucket_ids.to(torch.int64)[:, None], word]
        return (w >> ((g & 15) * 2).to(torch.int32)) & 3

    def _text_windows(self, Q: int, bucket_ids, offsets, is_rc, width):
        """The DP's text: windows for a query width Q, reverse-complemented
        for reverse-strand pairs (text[j] = 3 - window[width - 1 - j]),
        sentinel 4 past width, left-padded by lo. Returns (textp (P, lo +
        Q + band) uint8, band, lo)."""
        band, lo = band_geometry(Q, self.cfg.indel_rate)
        wmax = Q + band
        text = self._extract_windows(bucket_ids, offsets, wmax)
        j = torch.arange(wmax, dtype=torch.int64, device=text.device)[None, :]
        w = width.to(torch.int64)[:, None]
        rc = is_rc[:, None]
        src = torch.where(rc, w - 1 - j, j).clamp(0, wmax - 1)
        text = torch.gather(text, 1, src)
        text = torch.where(rc, 3 - text, text)
        text = torch.where(j < w, text, 4)
        textp = torch.nn.functional.pad(text, (lo, 0), value=4)
        return textp.to(torch.uint8), band, lo

    def _align_core(self, qcodes, qlen, bucket_ids, offsets, is_rc, width,
                    tb_mode: str = "cell", wrap_star: bool = True):
        """qcodes (P, Q) uint8; qlen/offsets/width (P,) int32; is_rc (P,)
        bool, all on the aligner's device.

        tb_mode "cell": (score, begin, ops (P, Q + 2*lo) uint8), the
        traceback one cell per step, ops in traceback order (0 = unused),
        on dp_fwd's direction bytes: the dp_fwd kernel on the card, its
        plain version on the CPU, the traceback in plain torch on both.
        tb_mode "runs": dp_runs's (head (5, P), runs (P, MR)), each step
        of the traceback jumping a whole same-op chain (runs capped at
        63), the jumps merged into runs per row: the fused dp_runs kernel
        on the card, dp_runs_plain on the CPU. wrap_star starts rows with
        score < -60 at row 0, so their traceback is empty."""
        P, Q = qcodes.shape
        textp, band, lo = self._text_windows(Q, bucket_ids, offsets, is_rc,
                                             width)
        if tb_mode == "runs":
            return dp_runs(textp, qcodes.contiguous(), qlen, width, band, lo,
                           wrap_star)
        dirs, final = dp_fwd(textp, qcodes.contiguous(), qlen, width, band, lo)
        score = final.amax(dim=1)
        flat = dirs.reshape(-1)
        row = P * band
        pbase = torch.arange(P, dtype=torch.int64, device=dirs.device) * band
        # per-cell traceback: as many steps as the reference's unroll-by-4
        # loop takes, since an unfinished traceback's final d depends on it
        max_ops = Q + 2 * lo
        i, d = qlen.to(torch.int64), first_max_index(final)
        ops = []
        for _ in range(-(-max_ops // 4) * 4):
            active = i > 0
            b = flat[i * row + pbase + d.clamp(0, band - 1)]
            op = torch.where(active, b.to(torch.int64) & 3, 0)
            ops.append(op)
            i = torch.where(active & (op != 3), i - 1, i)
            d = torch.where(op == 2, d + 1, torch.where(op == 3, d - 1, d))
        ops = torch.stack(ops[:max_ops], dim=1).to(torch.uint8)
        return score, d - lo, ops

    def _align_ops(self, qcodes, qlen, bucket_ids, offsets, is_rc, width):
        """Packed-ops output: (score, begin, ops packed 16 per word, LSB
        first, as int64 holding the uint32 word)."""
        P, Q = qcodes.shape
        score, begin, ops = self._align_core(qcodes, qlen, bucket_ids,
                                             offsets, is_rc, width)
        max_ops = ops.shape[1]
        ow = -(-max_ops // 16)
        opsp = torch.nn.functional.pad(ops.to(torch.int64),
                                       (0, ow * 16 - max_ops))
        shifts = torch.arange(16, dtype=torch.int64, device=ops.device) * 2
        packed = (opsp.reshape(P, ow, 16) << shifts).sum(dim=2)
        return score, begin, packed

    def _align_runs(self, qpacked, qlen, bucket_ids, offsets, is_rc, width,
                    run_cap: int, wrap_star: bool = True) -> torch.Tensor:
        """Device-RLE output: one int32 vector per sub-batch, the layout
        of the reference's `_align_runs_impl`:
          [0] total_runs  [1] max_runs_in_any_row  [2] max_run_len
          [3] n_unterminated_tracebacks
          [4      : 4+P ]  score
          [4+P    : 4+2P]  begin
          [4+2P   : 4+3P]  n_runs
          [4+3P   :     ]  run_cap/2 words, 2 uint16 runs per word
                           (run = length << 2 | op, query order)
        qpacked (P, W) int32 holds the query codes 2-bit packed. Rows'
        runs are laid back to back; overflow (total_runs > run_cap, a row
        with > MAX_ROW_RUNS runs, a run longer than 16383 or an
        unterminated traceback) is flagged in the header for the caller.
        wrap_star: rows with score < -60 emit no runs (their SAM CIGAR is
        '*')."""
        P, W = qpacked.shape
        dev = qpacked.device
        shifts = torch.arange(16, dtype=torch.int32, device=dev) * 2
        qcodes = ((qpacked[:, :, None] >> shifts) & 3).reshape(P, W * 16)
        return runs_vector(*self._align_core(
            qcodes.to(torch.uint8), qlen, bucket_ids, offsets, is_rc, width,
            tb_mode="runs", wrap_star=wrap_star), run_cap)

    # ------------------------------------------------------------------
    def _width(self, qlen, bucket_ids, offsets) -> np.ndarray:
        """Text window width: qlen + 1 + trunc(indel_rate * qlen), cut at
        the bucket end."""
        return np.minimum(
            qlen + 1 + (self.cfg.indel_rate * qlen).astype(np.int64),
            self.bucket_lengths[bucket_ids] - offsets,
        ).astype(np.int32)

    def _padded(self, a, s, e, fill=0) -> np.ndarray:
        """Host rows [s, e) of `a`, padded with `fill` to the sub-batch
        size."""
        a = np.asarray(a[s:e])
        pad = min(self.pair_batch, MAX_PAIR_BATCH) - (e - s)
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                           a.dtype)])
        return a

    def _sub_batch(self, qcodes, qlen, bucket_ids, offsets, is_rc, width, s,
                   e):
        """Device tensors of rows [s, e), padded to the sub-batch size
        (padding rows have qlen = width = 1): (qcodes (pb, Q) uint8 host
        array, (qlen, bucket_ids, offsets, is_rc, width))."""
        def put(a, dtype, fill=0):
            return host_tensor(self._padded(a, s, e, fill).astype(dtype)) \
                .to(self.device)

        return (self._padded(qcodes, s, e),
                (put(qlen, np.int32, 1), put(bucket_ids, np.int32),
                 put(offsets, np.int32), put(is_rc, np.bool_),
                 put(width, np.int32, 1)))

    def _ops_sub_batch(self, qc, args, n):
        """Packed-ops path on one padded sub-batch; (sc, bg, packed_ops)
        numpy for its first n rows."""
        qt = host_tensor(qc.astype(np.uint8)).to(self.device)
        sc, bg, packed = self._align_ops(qt, *args)
        return (sc.cpu().numpy()[:n], bg.cpu().numpy()[:n].astype(np.int32),
                packed.cpu().numpy()[:n].astype(np.uint32))

    def _run_batched(self, qcodes, qlen, bucket_ids, offsets, is_rc, consume,
                     mode: str = "ops", run_cap_per_pair: int | None = None,
                     wrap_star: bool = True):
        """Sub-batch loop over rows of at most pair_batch (<= 16384)
        pairs. mode "ops": consume(s, e, sc, bg, packed_ops) with packed
        2-bit traceback rows. mode "runs": consume(s, e, vec) with the
        device-RLE vector (_align_runs layout)."""
        n = len(bucket_ids)
        width = self._width(qlen, bucket_ids, offsets)
        pb = min(self.pair_batch, MAX_PAIR_BATCH)
        if mode == "runs":
            cpp = run_cap_per_pair or self.run_cap_per_pair
            run_cap = -(-cpp * pb // 2) * 2              # even
            # the query width after packing, and its launch geometry
            q = -(-qcodes.shape[1] // 16) * 16
            band, lo = band_geometry(q, self.cfg.indel_rate)
            row_cells = {"dp_launched_rows": 1, "dp_row_text": lo + q + band,
                         "dp_row_query": q, "dp_row_runs": run_budget(band)[1]}
        counts = self.counts
        stage = self.stage
        for s in range(0, n, pb):
            e = min(s + pb, n)
            with stage("pad and upload"):
                qc, args = self._sub_batch(qcodes, qlen, bucket_ids, offsets,
                                           is_rc, width, s, e)
            counts["sub_batches"] += 1
            counts["pairs"] += e - s
            if mode == "runs":
                for k, v in row_cells.items():
                    counts[k] += pb * v
                rows = int(np.minimum(qlen[s:e], q).sum())
                counts["dp_rows"] += rows
                counts["dp_row_band"] += rows * band
                with stage("pack"):
                    qp = upload_u32(pack_qcodes(qc), self.device)
                with stage("runs vector"):
                    vec = self._align_runs(qp, *args, run_cap=run_cap,
                                           wrap_star=wrap_star)
                with stage("download"):
                    vec = vec.cpu().numpy()
                with stage("consume"):
                    consume(s, e, vec)
            else:
                consume(s, e, *self._ops_sub_batch(qc, args, e - s))

    def _ops_rerun(self, qcodes, qlen, bucket_ids, offsets, is_rc, s, e):
        """Overflow fallback: rows [s, e) through the packed-ops path;
        returns (sc, bg, packed_ops) numpy."""
        width = self._width(qlen, bucket_ids, offsets)
        qc, args = self._sub_batch(qcodes, qlen, bucket_ids, offsets, is_rc,
                                   width, s, e)
        self.counts["ops_reruns"] += 1
        return self._ops_sub_batch(qc, args, e - s)

    def align_batch_runs_stream(self, qcodes, qlen, bucket_ids, offsets,
                                is_rc, emit_runs,
                                run_cap_per_pair: int | None = None,
                                wrap_star: bool = True):
        """Streaming alignment with device-RLE'd CIGARs: per sub-batch,
        `emit_runs(s, e, sc, bg, n_runs, runs, row_off)`; runs is a uint16
        array (length << 2 | op, query order), row i's runs are
        runs[row_off[i] : row_off[i+1]]. Sub-batches whose run budget
        overflows re-run through the packed-ops path."""
        q = qcodes.shape[1]
        max_ops = q + 2 * band_geometry(q, self.cfg.indel_rate)[1]
        pb = min(self.pair_batch, MAX_PAIR_BATCH)
        shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]

        def consume(s, e, vec):
            total, max_row = int(vec[0]), int(vec[1])
            nr_all = vec[4 + 2 * pb: 4 + 3 * pb]
            cap = (len(vec) - 4 - 3 * pb) * 2
            # vec[2] > 16383 overflows the uint16 length field; vec[3]
            # counts tracebacks unfinished within the run-jump budget
            if total > cap or max_row > MAX_ROW_RUNS \
                    or int(vec[2]) > 16383 or int(vec[3]) > 0:
                sc, bg, pk = self._ops_rerun(qcodes, qlen, bucket_ids,
                                             offsets, is_rc, s, e)
                ops = ((pk[:, :, None] >> shifts) & 3).astype(np.uint8)
                ops = ops.reshape(e - s, -1)[:, :max_ops]
                nrs = np.zeros(e - s, np.int64)
                runs_l = []
                for i in range(e - s):
                    # the wrap rule of the device RLE: score < -60 rows
                    # emit no runs (short-read path only)
                    row = (ops[i] if not wrap_star or sc[i] >= -60
                           else ops[i][:0])
                    nz = row[row != 0][::-1].astype(np.uint16)
                    if len(nz):
                        ch = np.nonzero(np.diff(nz))[0]
                        st = np.concatenate([[0], ch + 1])
                        en = np.concatenate([ch + 1, [len(nz)]])
                        runs_l.append(((en - st).astype(np.uint16) << 2)
                                      | nz[st])
                        nrs[i] = len(st)
                    else:
                        runs_l.append(np.zeros(0, np.uint16))
                runs = (np.concatenate(runs_l) if runs_l
                        else np.zeros(0, np.uint16))
                row_off = np.zeros(e - s + 1, np.int64)
                np.cumsum(nrs, out=row_off[1:])
                emit_runs(s, e, sc.astype(np.int32), bg.astype(np.int32),
                          nrs.astype(np.int32), runs, row_off)
                return
            sc = vec[4: 4 + pb][: e - s]
            bg = vec[4 + pb: 4 + 2 * pb][: e - s]
            nr = nr_all[: e - s]
            runs = vec[4 + 3 * pb:].view(np.uint16)
            row_off = np.zeros(e - s + 1, np.int64)
            np.cumsum(nr, out=row_off[1:])
            emit_runs(s, e, sc, bg, nr, runs, row_off)

        self._run_batched(qcodes, qlen, bucket_ids, offsets, is_rc, consume,
                          mode="runs", run_cap_per_pair=run_cap_per_pair,
                          wrap_star=wrap_star)

    def align_batch(self, qcodes: np.ndarray, qlen, bucket_ids, offsets,
                    is_rc):
        """Packed-ops path over all rows: returns (score, begin, ops)
        numpy, ops (n, Q + 2*lo) uint8 in traceback order."""
        n = len(bucket_ids)
        q = qcodes.shape[1]
        max_ops = q + 2 * band_geometry(q, self.cfg.indel_rate)[1]
        ow = -(-max_ops // 16)
        out_s = np.zeros(n, np.int32)
        out_b = np.zeros(n, np.int32)
        out_ops = np.zeros((n, max_ops), np.uint8)
        shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]

        def consume(s, e, sc, bg, pk):
            out_s[s:e] = sc
            out_b[s:e] = bg
            ops = ((pk[:, :, None] >> shifts) & 3).astype(np.uint8)
            out_ops[s:e] = ops.reshape(e - s, ow * 16)[:, :max_ops]

        self._run_batched(qcodes, qlen, bucket_ids, offsets, is_rc, consume)
        return out_s, out_b, out_ops

    def align_batch_stream(self, qcodes, qlen, bucket_ids, offsets, is_rc,
                           emit):
        """Streaming alignment: per sub-batch the device RLE's runs become
        CIGAR bytes on the host (native C when available), handed to
        `emit(s, e, scores, begins, cigar_buf, offs)` for rows [s, e),
        offs (e-s+1,)."""
        from bucketmap_tpu_torch.io import native

        use_native = native.available()

        def emit_runs(s, e, sc, bg, nr, runs, row_off):
            res = native.runs_to_cigar(runs, row_off) if use_native else None
            if res is not None:
                buf, offs = res
            else:
                parts = []
                offs = np.zeros(e - s + 1, np.int64)
                for i in range(e - s):
                    rr = runs[row_off[i]: row_off[i + 1]]
                    c = "".join(f"{int(v) >> 2}{_OP_CHARS[int(v) & 3]}"
                                for v in rr)
                    parts.append(c.encode())
                    offs[i + 1] = offs[i] + len(parts[-1])
                buf = b"".join(parts)
            emit(s, e, sc, bg, buf, offs)

        self.align_batch_runs_stream(qcodes, qlen, bucket_ids, offsets,
                                     is_rc, emit_runs)

    def align_batch_cigars(self, qcodes, qlen, bucket_ids, offsets, is_rc):
        """Collected align_batch_stream: (score, begin, cigar_buf bytes,
        offsets (n+1,))."""
        n = len(bucket_ids)
        out_s = np.zeros(n, np.int32)
        out_b = np.zeros(n, np.int32)
        bufs: list[bytes] = []
        lens = np.zeros(n, np.int64)

        def emit(s, e, sc, bg, buf, offs):
            out_s[s:e] = sc
            out_b[s:e] = bg
            bufs.append(buf)
            lens[s:e] = np.diff(offs)

        self.align_batch_stream(qcodes, qlen, bucket_ids, offsets, is_rc, emit)
        offsets_out = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets_out[1:])
        return out_s, out_b, b"".join(bufs), offsets_out


def ops_to_cigar(ops_row: np.ndarray) -> str:
    """Op codes in traceback order -> CIGAR string."""
    codes = ops_row[ops_row != 0][::-1]
    if len(codes) == 0:
        return "*"
    change = np.nonzero(np.diff(codes))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [len(codes)]])
    return "".join(f"{e - s}{_OP_CHARS[int(codes[s])]}"
                   for s, e in zip(starts, ends))
