"""Process bootstrap and read sharding for a multi-process mesh.

Counterpart of `bucketmap_tpu/parallel/distributed.py` on
torch.distributed:

  * ``initialize()`` wraps ``torch.distributed.init_process_group``; rank,
    world size and rendezvous come from the arguments or, as torchrun sets
    them, from RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT.
  * ``free_port()`` picks a loopback port for a one-host rendezvous;
    ``one_rank_group()`` is a process group of one rank, torn down on
    exit.
  * ``global_read_batch()`` cuts a batch that every rank holds down to the
    rank's own rows on the data axis.
  * ``shard_fastq()`` writes one host's round-robin shard of a FASTQ
    file, as the JAX module's does.
"""

from __future__ import annotations

import contextlib
import gc
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from bucketmap_tpu_torch.io.fastq import read_fastq


def initialize(backend: str | None = None, init_method: str | None = None,
               rank: int | None = None,
               world_size: int | None = None) -> torch.device:
    """Join the job's process group and return this rank's device.

    backend: "nccl" (one CUDA device per rank: LOCAL_RANK, else rank modulo
    the visible devices) or "gloo" (CPU tensors); by default nccl when
    CUDA is available, else gloo. A failing NCCL raises: nothing here
    switches backend. init_method defaults to "env://" (MASTER_ADDR and
    MASTER_PORT); "tcp://host:port" and "file://path" work as in
    init_process_group."""
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA, and "
                               "torch.cuda.is_available() is false")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return device


def free_port() -> int:
    """A free TCP port on the loopback interface, for a one-host
    rendezvous (init_method "tcp://127.0.0.1:<port>")."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device, init_method: str | None = None):
    """A process group of one rank (a (1, 1) mesh on one card or the CPU)
    on `device`'s backend, nccl on a card and gloo on the CPU, rendezvous
    at init_method (default a free loopback port); yields this rank's
    device. On exit the mesh's objects are collected before
    destroy_process_group: groups kept alive by reference cycles to
    interpreter exit made gloo ranks abort."""
    dev = torch.device(device)
    out = initialize(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or f"tcp://127.0.0.1:{free_port()}",
        rank=0, world_size=1)
    try:
        yield out
    finally:
        gc.collect()
        dist.destroy_process_group()


def global_read_batch(mesh, codes: np.ndarray, quals: np.ndarray,
                      lengths: np.ndarray):
    """This rank's rows [di*B/Dd, (di+1)*B/Dd) of a batch that every rank
    holds whole."""
    B = codes.shape[0]
    if B % mesh.Dd:
        raise ValueError(f"batch of {B} rows does not split over "
                         f"{mesh.Dd} data shards")
    sl = slice(mesh.di * (B // mesh.Dd), (mesh.di + 1) * (B // mesh.Dd))
    return codes[sl], quals[sl], np.asarray(lengths, np.int32)[sl]


def shard_fastq(path, out_dir, num_shards: int, shard_id: int) -> str:
    """Write this host's shard (reads i with i % num_shards == shard_id)
    to out_dir and return the shard path. Deterministic by read index."""
    batch = read_fastq(path)
    sel = np.arange(shard_id, batch.num_reads, num_shards)
    out = os.path.join(str(out_dir), f"shard_{shard_id}_of_{num_shards}.fastq")
    ids = batch.ids
    with open(out, "w") as f:
        for i in sel:
            n = int(batch.lengths[i])
            f.write(f"@{ids[i]}\n"
                    f"{batch.seq_ascii[i, :n].tobytes().decode()}\n+\n"
                    f"{batch.qual_ascii[i, :n].tobytes().decode()}\n")
    return out
