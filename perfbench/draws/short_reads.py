"""Short reads of one length at a mix's substitution, insertion and
deletion rates, loci uniform over the buckets: `core/reads.py`'s draw,
the draw of every mix that names none."""

from core.reads import draw  # noqa: F401
