"""The (data, bucket) mesh over the ranks of a torch.distributed job.

Counterpart of `bucketmap_tpu/parallel/sharding.py:make_mesh`. Read
batches shard on the "data" axis; the occupancy matrix and the fine
tables shard by bucket range on the "bucket" axis. Rank r sits at
(di, bi) = divmod(r, bucket), the row-major layout of
`np.asarray(devices).reshape(data, bucket)`, and each rank holds the
process groups of its bucket axis (the ranks that share its reads), its
data axis and the world.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    Dd: int               # data shards
    Db: int               # bucket shards
    di: int               # this rank's data index
    bi: int               # this rank's bucket index
    bucket_group: object  # ranks (di, 0..Db)
    data_group: object    # ranks (0..Dd, bi)
    world_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.Dd, "bucket": self.Db}

    @property
    def rank(self) -> int:
        return self.di * self.Db + self.bi


def default_split(n: int) -> tuple[int, int]:
    """(data, bucket) for n ranks, as the JAX make_mesh picks it: all data
    below 4 ranks, two bucket shards from 4 (even n), four from 8 (n a
    multiple of 4)."""
    data, bucket = n, 1
    if n >= 4 and n % 2 == 0:
        data, bucket = n // 2, 2
    if n >= 8 and n % 4 == 0:
        data, bucket = n // 4, 4
    return data, bucket


def make_mesh(data: int | None = None, bucket: int | None = None) -> Mesh:
    """The mesh over dist.get_world_size() ranks; every rank must call it,
    in the same order as its other collectives (it creates groups)."""
    n = dist.get_world_size()
    if data is None or bucket is None:
        data, bucket = default_split(n)
    if data * bucket != n:
        raise ValueError(f"mesh ({data}, {bucket}) does not cover the "
                         f"{n} ranks of the job")
    di, bi = divmod(dist.get_rank(), bucket)
    bucket_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * bucket + b for b in range(bucket)])
        if d == di:
            bucket_group = g
    for b in range(bucket):
        g = dist.new_group([d * bucket + b for d in range(data)])
        if b == bi:
            data_group = g
    return Mesh(data, bucket, di, bi, bucket_group, data_group,
                dist.group.WORLD)
