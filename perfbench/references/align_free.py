"""BucketMap's align-free records of a read: `core/reference.py`'s
plain reference (CIGAR '*', MAPQ min(60, 6 * votes), the read's first
read_len bases located), the reference of every mix that names none.
A read's records depend on the read alone."""

from __future__ import annotations

from core.reference import Params, ReferenceIndex


class AlignFree:
    depends = ()

    def __init__(self, index: ReferenceIndex):
        self.index = index
        self.names = index.names
        self.layout = index.layout

    def records(self, codes, quality: int, name: bytes, instance) -> list:
        return self.index.records(codes, quality, name)


def ensure(cache_dir: str, state_dir: str, config: dict, genome):
    """Its state is `core/reference.py`'s, in `cache_dir/reference`;
    `state_dir` is not used."""
    index, built = ReferenceIndex.ensure(cache_dir, Params(config["mapper"]),
                                         genome)
    return AlignFree(index), built
