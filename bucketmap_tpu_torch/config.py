"""Runtime configuration for the mapper.

The port's copy of `bucketmap_tpu/config.py`, field for field. Mirrors
the reference CLI parameter vocabulary (bucket_map/main.cpp:12-124) but
makes everything runtime-configurable — the reference bakes NUM_BUCKETS /
BUCKET_LEN / genome path in at compile time (CMakeLists.txt:13-58); we
do not.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    # Bucket decomposition (reference: compile-time BM_BUCKET_LEN; utils.h:60-102).
    bucket_len: int = 65536
    # -r / --read-len: maximum read (segment) length.
    read_len: int = 300
    # -k / --index-seed: q-gram length used in the occupancy index.
    index_seed: int = 9
    # -l / --query-seed: k-mer length used for querying (mapper + locator).
    query_seed: int = 12
    # -s / --mapper-samples: number of k-mer samples drawn by the coarse mapper.
    mapper_samples: int = 15
    # -d / --distinguishability: max fraction of buckets a sampled k-mer may hit.
    distinguishability: float = 0.5
    # -b / --average-base-quality: per-base phred-rank threshold (gate is sum over k).
    average_base_quality: int = 25
    # -e / --max-error-rate: fraction of k-mer samples allowed to miss.
    seed_miss_rate: float = 0.4
    # -n / --max-indel-rate.
    indel_rate: float = 0.02
    # -p / --locator-samples: k-mer samples drawn by the fine locator.
    locator_samples: int = 10
    # -u / --quality: min alignment quality for SAM output (align mode).
    quality_threshold: int = 40
    # -f / --kmer-frac: FracMinHash fraction of q-grams kept in the index.
    kmer_fraction: float = 1.0
    # Cap on candidate buckets per strand (reference: num_candidate_buckets=30,
    # q_gram_mapper.h:285).
    max_candidate_buckets: int = 30
    # Long reads (> 2*read_len) decompose into this many segments
    # (reference: num_segment_samples=5, q_gram_mapper.h:286,510-516).
    num_segment_samples: int = 5
    # FracMinHash universal-hash table size (main.cpp:176 HASH_TABLE_SIZE).
    hash_table_size: int = 10000
    # Seed for the FracMinHash universal hash (reference uses srand(time);
    # we make it reproducible).
    frac_hash_seed: int = 0

    # ---- derived quantities -------------------------------------------------
    @property
    def num_fault_tolerance(self) -> int:
        """Cascade depth: ceil(mapper_samples * seed_miss_rate) (main.cpp:207)."""
        return int(math.ceil(self.mapper_samples * self.seed_miss_rate))

    @property
    def min_coarse_hits(self) -> int:
        """A bucket is a candidate only if >= this many sampled k-mers hit
        (fault_tolerate_filter levels, q_gram_mapper.h:83-102)."""
        return self.mapper_samples - self.num_fault_tolerance + 1

    @property
    def mapper_min_kmer_quality(self) -> int:
        """Gate: rolling phred-rank sum over k >= b*k (q_gram_mapper.h:303)."""
        return self.average_base_quality * self.query_seed

    @property
    def allowed_mismatch(self) -> int:
        """Locator: ceil(seed_miss_rate * locator_samples) (bucket_locator.h:419)."""
        return int(math.ceil(self.seed_miss_rate * self.locator_samples))

    @property
    def min_vote(self) -> int:
        """Min votes for an offset to be accepted (bucket_locator.h:284)."""
        return self.locator_samples - self.allowed_mismatch

    @property
    def allowed_indel(self) -> int:
        """ceil(indel_rate * read_len) (bucket_locator.h:420)."""
        return int(math.ceil(self.indel_rate * self.read_len))

    @property
    def num_qgrams(self) -> int:
        return 4**self.index_seed

    @property
    def qgrams_per_kmer(self) -> int:
        """A k-mer contains k-q+1 q-grams (q_gram_mapper.h:402)."""
        return self.query_seed - self.index_seed + 1

    @property
    def min_good_kmers(self) -> int:
        """Segments with fewer good k-mers than 0.2*samples are skipped
        (strict '<', q_gram_mapper.h:445)."""
        return int(math.ceil(0.2 * self.mapper_samples))

    @property
    def frac_hash_threshold(self) -> int:
        """FracMinHash keep-threshold (main.cpp:185)."""
        return int(self.hash_table_size * self.kmer_fraction)

    def validate(self) -> None:
        if self.query_seed < self.index_seed:
            raise ValueError("query_seed must be >= index_seed (main.cpp:194-198)")
        if self.query_seed > 16:
            raise ValueError("query_seed must fit a 32-bit hash (k <= 16)")
        if self.bucket_len % 16 != 0:
            raise ValueError("bucket_len must be a multiple of 16 (2-bit packing)")


DEFAULT_CONFIG = MapperConfig()
