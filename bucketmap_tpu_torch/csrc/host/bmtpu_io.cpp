// Native host-side IO for bucketmap_tpu_torch: FASTQ parsing and SAM
// record formatting. The device pipeline consumes fixed-shape uint8
// matrices; these routines produce/consume them at memory bandwidth so
// the host input/output path keeps up with the device stages. A copy of
// the JAX package's csrc/bmtpu_io.cpp.
//
// Build: bucketmap_tpu_torch/io/native.py runs g++ at first use ->
// bucketmap_tpu_torch/csrc/build/host/<hash>/libbmtorch_host.so
// ABI: plain C, ctypes-friendly. All sizes int64.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>

namespace {

// dna4 encoding: A=0 C=1 G=2 T=3; anything else (incl. N) -> A, matching
// seqan3 dna4 conversion (utils.h:181-189 of the reference). A table, so
// the parse of random bases takes no branch.
struct BaseCodes {
    unsigned char code[256];
    BaseCodes() {
        memset(code, 0, sizeof(code));
        code['C'] = code['c'] = 1;
        code['G'] = code['g'] = 2;
        code['T'] = code['t'] = 3;
    }
};
const BaseCodes kBase;

// Index of the first '\n' in buf[i, size), or size; i itself where
// i >= size.
inline int64_t line_end(const char* __restrict__ buf, int64_t i,
                        int64_t size) {
    if (i >= size) return i;
    const void* nl = memchr(buf + i, '\n', (size_t)(size - i));
    return nl ? (const char*)nl - buf : size;
}

}  // namespace

extern "C" {

// First pass over a FASTQ buffer: number of reads and max read length.
// Returns 0 on success, -1 on malformed input.
int64_t bmtpu_fastq_stat(const char* __restrict__ buf, int64_t size,
                         int64_t* __restrict__ n_reads,
                         int64_t* __restrict__ max_len) {
    int64_t reads = 0, maxl = 0;
    int64_t i = 0;
    while (i < size) {
        if (buf[i] != '@') return -1;
        i = line_end(buf, i, size) + 1;                    // header
        int64_t seq_start = i;
        i = line_end(buf, i, size);                        // sequence
        int64_t len = i - seq_start;
        if (len > maxl) maxl = len;
        i++;
        if (i >= size || buf[i] != '+') return -1;
        i = line_end(buf, i, size) + 1;                    // plus line
        i += len;                                          // quality
        if (i > size) return -1;
        if (i < size && buf[i] != '\n') return -1;
        i++;
        reads++;
    }
    *n_reads = reads;
    *max_len = maxl;
    return 0;
}

// Second pass: fill fixed-shape output matrices.
//   codes/quals:      (n, max_len) uint8 — 2-bit base codes / phred ranks
//   seq_ascii/qual_ascii: (n, max_len) uint8 raw bytes (for SAM echo)
//   lengths:          (n,) int32
//   id_offsets:       (n+1,) int64 offsets into ids_buf
//   ids_buf:          concatenated read names (no '@'), capacity ids_cap
// Returns total id bytes written, or -1 on malformed input / overflow.
int64_t bmtpu_fastq_parse(const char* __restrict__ buf, int64_t size,
                          int64_t max_len,
                          unsigned char* __restrict__ codes,
                          unsigned char* __restrict__ quals,
                          unsigned char* __restrict__ seq_ascii,
                          unsigned char* __restrict__ qual_ascii,
                          int32_t* __restrict__ lengths,
                          int64_t* __restrict__ id_offsets,
                          char* __restrict__ ids_buf, int64_t ids_cap) {
    int64_t i = 0, r = 0, idpos = 0;
    while (i < size) {
        if (buf[i] != '@') return -1;
        i++;
        int64_t id_start = i;
        i = line_end(buf, i, size);
        int64_t id_len = i - id_start;
        if (id_len && buf[id_start + id_len - 1] == '\r') id_len--;
        if (idpos + id_len > ids_cap) return -1;
        id_offsets[r] = idpos;
        memcpy(ids_buf + idpos, buf + id_start, id_len);
        idpos += id_len;
        i++;

        int64_t seq_start = i;
        i = line_end(buf, i, size);
        int64_t len = i - seq_start;
        if (len > max_len) return -1;
        lengths[r] = (int32_t)len;
        const unsigned char* seq = (const unsigned char*)buf + seq_start;
        unsigned char* crow = codes + r * max_len;
        memcpy(seq_ascii + r * max_len, seq, len);
        for (int64_t j = 0; j < len; j++) crow[j] = kBase.code[seq[j]];
        i = line_end(buf, i + 1, size) + 1;  // '+' line
        const unsigned char* qual = (const unsigned char*)buf + i;
        unsigned char* qrow = quals + r * max_len;
        memcpy(qual_ascii + r * max_len, qual, len);
        for (int64_t j = 0; j < len; j++)
            qrow[j] = (unsigned char)(qual[j] >= 33 ? qual[j] - 33 : 0);
        i += len + 1;
        r++;
    }
    id_offsets[r] = idpos;
    return idpos;
}

// Record cut of a FASTQ stream: counts the newlines of buf[0, size) up to
// `want`. Returns how many it counted and sets *after to the byte after
// the last one counted (0 where it counted none), so where it returns
// `want`, buf[0, *after) holds want / 4 whole records.
int64_t bmtpu_fastq_cut(const char* __restrict__ buf, int64_t size,
                        int64_t want, int64_t* __restrict__ after) {
    int64_t seen = 0, i = 0, end = 0;
    while (seen < want) {
        i = line_end(buf, i, size);
        if (i >= size) break;
        end = ++i;
        seen++;
    }
    *after = end;
    return seen;
}

// Pack a batch of reads into the device transfer layout (the native
// twin of encoding.pack_reads — identical output): per row
//   [cw words: 2-bit codes, 16 bases/word LSB-first |
//    qw words: k-window quality-gate bitmask (sum of phred ranks over
//              each k-window >= min_q) | 1 word: length].
// codes/quals: (n, L) uint8, rows zero-padded past length (windows over
// padding are computed like the numpy version; callers mask by length).
void bmtpu_pack_reads(int64_t n, int64_t L, const unsigned char* codes,
                      const unsigned char* quals, const int32_t* lengths,
                      int64_t k, int64_t min_q, uint32_t* out) {
    const int64_t cw = (L + 15) / 16;
    const int64_t K = L - k + 1;
    const int64_t qw = (K + 31) / 32;
    const int64_t stride = cw + qw + 1;
    for (int64_t r = 0; r < n; r++) {
        const unsigned char* crow = codes + r * L;
        const unsigned char* qrow = quals + r * L;
        uint32_t* orow = out + r * stride;
        for (int64_t w = 0; w < cw; w++) {
            uint32_t v = 0;
            const int64_t base = w * 16;
            const int64_t lim = (base + 16 <= L) ? 16 : L - base;
            for (int64_t j = 0; j < lim; j++)
                v |= (uint32_t)(crow[base + j] & 3) << (2 * j);
            orow[w] = v;
        }
        uint32_t* qout = orow + cw;
        for (int64_t w = 0; w < qw; w++) qout[w] = 0;
        int64_t sum = 0;
        for (int64_t j = 0; j < k && j < L; j++) sum += qrow[j];
        for (int64_t i = 0; i < K; i++) {
            if (sum >= min_q) qout[i >> 5] |= (uint32_t)1 << (i & 31);
            if (i + 1 < K) sum += (int64_t)qrow[i + k] - (int64_t)qrow[i];
        }
        orow[cw + qw] = (uint32_t)lengths[r];
    }
}

// Run-length-encode banded-DP tracebacks into CIGAR strings.
//   packed: (n, ow) uint32 rows of 2-bit op codes (1=M 2=I 3=D), 16/word
//           LSB-first, in REVERSED traceback order; 0-codes pad the tail.
//   max_ops: number of valid code positions per row (<= 16*ow).
//   out_buf/out_offsets: concatenated CIGAR bytes + (n+1) offsets; a row
//           with no ops gets an empty span (caller prints "*").
// Returns total bytes written, or -1 on overflow.
int64_t bmtpu_cigar_rle(int64_t n, int64_t ow, int64_t max_ops,
                        const uint32_t* packed, char* out_buf, int64_t cap,
                        int64_t* out_offsets) {
    static const char op_char[4] = {'?', 'M', 'I', 'D'};
    int64_t w = 0;
    // heap scratch: max_ops is Q + pad for long reads, no fixed cap
    unsigned char* codes = (unsigned char*)malloc((size_t)max_ops);
    if (codes == NULL) return -1;
    for (int64_t r = 0; r < n; r++) {
        out_offsets[r] = w;
        const uint32_t* row = packed + r * ow;
        int64_t len = 0;  // nonzero codes, zeros skipped ANYWHERE in the
        // row (not only as tail padding) to match the Python
        // ops_to_cigar fallback on degenerate tracebacks that cross an
        // invalid (dir=0) cell while i>0
        for (int64_t t = 0; t < max_ops; t++) {
            unsigned char c = (unsigned char)((row[t >> 4] >> (2 * (t & 15))) & 3);
            if (c != 0) codes[len++] = c;
        }
        // reversed codes -> emit runs back-to-front
        int64_t t = len - 1;
        while (t >= 0) {
            unsigned char c = codes[t];
            int64_t s = t;
            while (s > 0 && codes[s - 1] == c) s--;
            if (w + 16 > cap) { free(codes); return -1; }
            w += sprintf(out_buf + w, "%lld%c", (long long)(t - s + 1),
                         op_char[c]);
            t = s - 1;
        }
    }
    free(codes);
    out_offsets[n] = w;
    return w;
}

// Format device-RLE'd CIGAR runs into strings. Each run is a uint16
// (length << 2 | op), ops 1=M 2=I 3=D, already in query order; row r's
// runs are runs[row_off[r] .. row_off[r+1]). A row with no runs gets an
// empty span (caller prints "*").
// Returns total bytes written, or -1 on overflow.
int64_t bmtpu_runs_to_cigar(int64_t n, const uint16_t* runs,
                            const int64_t* row_off, char* out_buf,
                            int64_t cap, int64_t* out_offsets) {
    static const char op_char[4] = {'?', 'M', 'I', 'D'};
    int64_t w = 0;
    for (int64_t r = 0; r < n; r++) {
        out_offsets[r] = w;
        for (int64_t t = row_off[r]; t < row_off[r + 1]; t++) {
            uint16_t v = runs[t];
            if (w + 8 > cap) return -1;
            w += sprintf(out_buf + w, "%u%c", (unsigned)(v >> 2),
                         op_char[v & 3]);
        }
    }
    out_offsets[n] = w;
    return w;
}

// Format SAM alignment records into `out` (capacity out_cap).
//   n records; per-record fields:
//     qname: ids_buf + id_offsets[qid[i]] .. id_offsets[qid[i]+1]
//     flag[i], pos0[i] (0-based; printed 1-based), mapq[i]
//     rname: rnames_buf + rname_offsets[rid[i]] .. (names pre-truncated)
//     cigar: cigar_buf + cigar_offsets[i] .. cigar_offsets[i+1] (empty -> "*")
//     seq/qual: seq_ascii/qual_ascii row read_row[i], first seq_len[i] bytes
// Returns bytes written, or -1 on overflow.
int64_t bmtpu_format_sam(int64_t n,
                         const int32_t* qid, const int64_t* id_offsets,
                         const char* ids_buf,
                         const int32_t* flag, const int32_t* rid,
                         const int64_t* rname_offsets, const char* rnames_buf,
                         const int64_t* pos0, const int32_t* mapq,
                         const int64_t* cigar_offsets, const char* cigar_buf,
                         const int32_t* read_row, const int32_t* seq_len,
                         const unsigned char* seq_ascii,
                         const unsigned char* qual_ascii, int64_t max_len,
                         char* out, int64_t out_cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t q0 = id_offsets[qid[i]], q1 = id_offsets[qid[i] + 1];
        int64_t r0 = rname_offsets[rid[i]], r1 = rname_offsets[rid[i] + 1];
        int64_t c0 = cigar_offsets[i], c1 = cigar_offsets[i + 1];
        int64_t slen = seq_len[i];
        // worst case: fields + numbers + seq + qual
        if (w + (q1 - q0) + (r1 - r0) + (c1 - c0) + 2 * slen + 64 > out_cap)
            return -1;
        memcpy(out + w, ids_buf + q0, q1 - q0); w += q1 - q0;
        w += sprintf(out + w, "\t%d\t", flag[i]);
        memcpy(out + w, rnames_buf + r0, r1 - r0); w += r1 - r0;
        w += sprintf(out + w, "\t%lld\t%d\t",
                     (long long)(pos0[i] + 1), mapq[i]);
        if (c1 > c0) { memcpy(out + w, cigar_buf + c0, c1 - c0); w += c1 - c0; }
        else { out[w++] = '*'; }
        memcpy(out + w, "\t*\t0\t0\t", 7); w += 7;
        const unsigned char* srow = seq_ascii + (int64_t)read_row[i] * max_len;
        memcpy(out + w, srow, slen); w += slen;
        out[w++] = '\t';
        const unsigned char* qrow = qual_ascii + (int64_t)read_row[i] * max_len;
        memcpy(out + w, qrow, slen); w += slen;
        out[w++] = '\n';
    }
    return w;
}

}  // extern "C"
