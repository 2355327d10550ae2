// Native index construction for bucketmap_tpu.
//
// The offline index build is host-side and memory-bound; the numpy
// builder spends ~60 ns/base in windowed k-mer hashing and ~90 ns/base
// in per-bucket stable argsorts (profiled). These routines do the same
// work as a rolling-hash walk + two-pass LSD counting radix sort at
// ~5-10 ns/base, threaded, producing bit-identical tables
// (tests/test_index_and_sim.py asserts equality vs the numpy oracle).
//
// Semantics being matched (reference, for parity):
//   * occupancy: bucket_indexer.h:49-61 — set bit[bucket] in the row of
//     every sampled q-gram present in the bucket (incl. the read_len
//     overlap tail, so boundary-spanning q-grams land in both buckets);
//   * fine slots: builder.py:build_fine_index — per bucket, positions
//     stable-sorted by ascending k-mer hash, packed (pos<<low)|hash_low,
//     with the 12-bit-prefix segment table.
//
// ABI: plain C, ctypes-friendly, like bmtpu_io.cpp.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// number of worker threads: the build is memory-bound, hyperthreads
// don't help; cap at 8
inline int n_threads() {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    return (int)(hw > 8 ? 8 : hw);
}

}  // namespace

extern "C" {

// Occupancy + bucket packing for ONE FASTA record.
//   codes: (total,) uint8 2-bit base codes
//   q, bucket_len, read_len: config (bucket_len % 16 == 0)
//   ktr: (4^q,) int32 FracMinHash row table, -1 = unsampled
//   qg: (G+1, W) uint32 occupancy bit-matrix, row-major
//   b0: global index of this record's first bucket
//   bp: (N, Wb) uint32 packed bucket rows (zero-initialised by caller)
// Returns the number of buckets emitted for this record.
//
// Threaded over 32-bucket groups: all buckets of one group share the
// same word column (bucket>>5), so no two threads ever RMW the same
// qg word.
int64_t bmtpu_build_occupancy(const uint8_t* codes, int64_t total, int64_t q,
                              int64_t bucket_len, int64_t read_len,
                              const int32_t* ktr, uint32_t* qg, int64_t W,
                              int64_t b0, uint32_t* bp, int64_t Wb) {
    if (total <= 0) return 0;
    int64_t n_b = (total + bucket_len - 1) / bucket_len;
    // count emitted buckets (residuals <= read_len are skipped;
    // utils.h:88-90) — bucket i is emitted iff end-start > read_len
    int64_t emitted = 0;
    std::vector<int64_t> starts;  // start offset per EMITTED bucket
    starts.reserve(n_b);
    for (int64_t i = 0; i < n_b; i++) {
        int64_t start = i * bucket_len;
        int64_t end = start + bucket_len + read_len;
        if (end > total) end = total;
        if (end - start <= read_len) continue;
        starts.push_back(start);
        emitted++;
    }
    const uint32_t mask = (q >= 16) ? 0xFFFFFFFFu : ((1u << (2 * q)) - 1);

    auto work = [&](int64_t lo, int64_t hi) {  // emitted-bucket range
        for (int64_t e_i = lo; e_i < hi; e_i++) {
            int64_t start = starts[e_i];
            int64_t end = start + bucket_len + read_len;
            if (end > total) end = total;
            int64_t b = b0 + e_i;
            const int64_t word = b >> 5;
            const uint32_t bit = 1u << (b & 31);
            // rolling q-gram hash over [start, end)
            uint32_t h = 0;
            for (int64_t j = start; j < end; j++) {
                h = ((h << 2) | codes[j]) & mask;
                if (j - start >= q - 1) {
                    int32_t row = ktr[h];
                    if (row >= 0) qg[(int64_t)row * W + word] |= bit;
                }
            }
            // pack [start, end) into bp row (16 bases/word, LSB-first);
            // row is pre-zeroed so the tail padding decodes as 'A'
            uint32_t* out = bp + b * Wb;
            int64_t len = end - start;
            for (int64_t w = 0; w < (len + 15) / 16; w++) {
                uint32_t v = 0;
                int64_t base = start + w * 16;
                int64_t lim = (base + 16 <= end) ? 16 : end - base;
                for (int64_t t = 0; t < lim; t++)
                    v |= (uint32_t)(codes[base + t] & 3) << (2 * t);
                out[w] = v;
            }
        }
    };

    int nt = n_threads();
    if (emitted < 64 || nt == 1) {
        work(0, emitted);
        return emitted;
    }
    // partition on 32-bucket-group boundaries relative to b0&31 so each
    // qg word column belongs to exactly one thread
    std::vector<std::thread> threads;
    int64_t groups = ((b0 + emitted - 1) >> 5) - (b0 >> 5) + 1;
    int64_t per = (groups + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t g_lo = (b0 >> 5) + t * per;
        int64_t g_hi = g_lo + per;
        // emitted-bucket indices whose global id falls in [g_lo<<5, g_hi<<5)
        int64_t lo = g_lo * 32 - b0;
        int64_t hi = g_hi * 32 - b0;
        if (lo < 0) lo = 0;
        if (hi > emitted) hi = emitted;
        if (lo >= hi) continue;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    return emitted;
}

// Positional fine index for buckets [0, n): per bucket, k-mer positions
// stable-sorted by ascending hash via two-pass LSD counting radix
// (low_bits then 12-bit prefix), emitted as (pos<<low_bits)|hash_low
// uint32 slots plus the 4097-entry prefix segment table.
//   bp: (n, wb) uint32 packed bucket rows; lengths: (n,) int32
//   k: query seed (2k-12 == low_bits, 0 <= low_bits <= 16)
//   fine_packed: (n, lpos) uint32 out; ptab: (n, 4097) int32 out
//   lpos = wb*16 - k + 1
// Returns the max prefix-segment length over all buckets (for
// fine_search_steps), or -1 on bad arguments.
int64_t bmtpu_build_fine(const uint32_t* bp, int64_t n, int64_t wb,
                         const int32_t* lengths, int64_t k, int64_t low_bits,
                         uint32_t* fine_packed, int32_t* ptab, int64_t lpos) {
    if (low_bits < 0 || low_bits > 16 || k < 6 || k > 15) return -1;
    const int64_t lb = wb * 16;
    if (lpos != lb - k + 1) return -1;
    const uint32_t low_mask = (uint32_t)((1u << low_bits) - 1);
    const int64_t low_bins = (int64_t)1 << low_bits;
    const uint32_t hmask = (1u << (2 * k)) - 1;

    std::vector<int64_t> max_seg_per_thread;
    int nt = n_threads();
    if (n < 4) nt = 1;
    max_seg_per_thread.assign(nt, 1);

    auto work = [&](int t, int64_t lo, int64_t hi) {
        // per-thread scratch
        std::vector<uint32_t> hashes(lpos), tmp_h(lpos);
        std::vector<int32_t> pos(lpos), tmp_p(lpos);
        std::vector<int32_t> counts(low_bins > 4096 ? low_bins : 4096);
        int64_t max_seg = 1;
        for (int64_t b = lo; b < hi; b++) {
            const uint32_t* row = bp + b * wb;
            int64_t n_valid = (int64_t)lengths[b] - k + 1;
            if (n_valid < 0) n_valid = 0;
            if (n_valid > lpos) n_valid = lpos;
            // rolling hash from the packed row
            {
                uint32_t h = 0;
                uint32_t word = 0;
                for (int64_t j = 0; j < n_valid + k - 1; j++) {
                    if ((j & 15) == 0) word = row[j >> 4];
                    h = ((h << 2) | ((word >> (2 * (j & 15))) & 3u)) & hmask;
                    if (j >= k - 1) {
                        hashes[j - (k - 1)] = h;
                        pos[j - (k - 1)] = (int32_t)(j - (k - 1));
                    }
                }
            }
            // pass 1: stable counting sort by low_bits
            if (low_bits > 0) {
                std::memset(counts.data(), 0, low_bins * sizeof(int32_t));
                for (int64_t i = 0; i < n_valid; i++)
                    counts[hashes[i] & low_mask]++;
                int32_t acc = 0;
                for (int64_t i = 0; i < low_bins; i++) {
                    int32_t c = counts[i];
                    counts[i] = acc;
                    acc += c;
                }
                for (int64_t i = 0; i < n_valid; i++) {
                    int32_t d = counts[hashes[i] & low_mask]++;
                    tmp_h[d] = hashes[i];
                    tmp_p[d] = pos[i];
                }
            } else {
                std::memcpy(tmp_h.data(), hashes.data(),
                            n_valid * sizeof(uint32_t));
                std::memcpy(tmp_p.data(), pos.data(),
                            n_valid * sizeof(int32_t));
            }
            // pass 2: stable counting sort by the 12-bit prefix
            std::memset(counts.data(), 0, 4096 * sizeof(int32_t));
            for (int64_t i = 0; i < n_valid; i++)
                counts[tmp_h[i] >> low_bits]++;
            int32_t* pt = ptab + b * 4097;
            {
                int32_t acc = 0;
                for (int64_t i = 0; i < 4096; i++) {
                    int32_t c = counts[i];
                    pt[i] = acc;
                    counts[i] = acc;
                    acc += c;
                    if (c > max_seg) max_seg = c;
                }
                pt[4096] = acc;  // == n_valid
            }
            uint32_t* out = fine_packed + b * lpos;
            for (int64_t i = 0; i < n_valid; i++) {
                int32_t d = counts[tmp_h[i] >> low_bits]++;
                out[d] = ((uint32_t)tmp_p[i] << low_bits)
                         | (tmp_h[i] & low_mask);
            }
            for (int64_t i = n_valid; i < lpos; i++) out[i] = 0xFFFFFFFFu;
        }
        max_seg_per_thread[t] = max_seg;
    };

    if (nt == 1) {
        work(0, 0, n);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (n + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            int64_t lo = t * per, hi = lo + per;
            if (hi > n) hi = n;
            if (lo >= hi) continue;
            threads.emplace_back(work, t, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    int64_t max_seg = 1;
    for (int64_t m : max_seg_per_thread)
        if (m > max_seg) max_seg = m;
    return max_seg;
}

}  // extern "C"
