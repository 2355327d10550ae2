"""The port's mesh step on torch.distributed against the JAX mesh step.

Four ranks are spawned on the gloo backend (a FileStore under the test's
tmp dir, so parallel test workers never race for a port) for the meshes
(data, bucket) = (2, 2) and (1, 4); the second has shards that hold only
padding buckets. On the world of tests/test_sharded_step.py each rank
checks, for both coarse paths:

  * its occupancy shard equals the JAX mesh's shard of that bucket range;
  * the gathered step vector equals the JAX mesh step's, word for word;
  * rank 0's SAM equals the JAX mesh pipeline's byte for byte, with one
    pair per read (on the (1, 4) mesh the lane budget overflows and the
    split retry runs) and in align mode;
  * on host fine tables sharded with the JAX fills (the prefix tables, or
    none for the scan), the step vector equals the JAX mesh step's.

Beside those: the default mesh split against the JAX make_mesh, a rank's
rows of a batch, and initialize refusing nccl where there is no CUDA.
The children make the world with the port's own config, builder and
simulator and import neither jax nor the JAX package (each asserts it);
this module imports those only inside test bodies and the JAX-side
fixture, which makes the same world with the JAX package.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
PATHS = ("fused", "staged")
HOST_VOTES = ("prefix", "scan")   # vote paths on host tables, sharded
B = 16            # step batch, and the align pipeline's batch
N_READS = 64      # reads of the split-retry pipeline (align: the first 48)
N_ALIGN = 48
JOIN_S = 120


def _world(port: bool):
    """tests/test_sharded_step.py:_world(fine=False), made by the port's
    modules or the JAX package's (the same index and reads:
    tests/test_torch_host.py); the port builds its own fine tables."""
    if port:
        from bucketmap_tpu_torch.config import MapperConfig
        from bucketmap_tpu_torch.index.builder import build_index
        from bucketmap_tpu_torch.sim.simulator import (ShortReadSimulator,
                                                       random_genome)
    else:
        from bucketmap_tpu.config import MapperConfig
        from bucketmap_tpu.index.builder import build_index
        from bucketmap_tpu.sim.simulator import (ShortReadSimulator,
                                                 random_genome)

    cfg = MapperConfig(bucket_len=1024, read_len=100, index_seed=7,
                       query_seed=10, mapper_samples=8, locator_samples=6,
                       max_candidate_buckets=6)
    genome = random_genome(60_000, seed=11, n_refs=2)
    index = build_index(genome, cfg)
    sim = ShortReadSimulator(cfg, substitution_rate=0.01, seed=12)
    sim.read(genome)
    return cfg, index, sim


def _host_index(index, vote, port: bool):
    """A copy of the index with host fine tables that make the vote path
    `vote`: the prefix tables alone, or none (the scan)."""
    import dataclasses

    if port:
        from bucketmap_tpu_torch.index.builder import build_fine_index
    else:
        from bucketmap_tpu.index.builder import build_fine_index

    idx = dataclasses.replace(index)
    if vote == "prefix":
        build_fine_index(idx, keep_unpacked=True)
        idx.fine_packed = None
    return idx


def _reads(sim, cfg, n):
    codes = np.zeros((n, cfg.read_len), np.uint8)
    quals = np.full((n, cfg.read_len), 36, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        c, *_ = sim.sample()
        c = c[: cfg.read_len]
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return codes, quals, lengths


def _read_batch(codes, quals, lengths, n, port: bool):
    if port:
        from bucketmap_tpu_torch.io.fastq import ReadBatch
    else:
        from bucketmap_tpu.io.fastq import ReadBatch
    return ReadBatch.from_arrays([str(i) for i in range(n)], codes[:n],
                                 quals[:n], lengths[:n])


def _pipe_args(kind):
    """(batch_size, pairs_per_read, align, reads) of the two pipeline runs.
    One pair per read in batches of 32 overflows the per-shard lane
    budget of the (1, 4) mesh, so its split retry runs."""
    return ((32, 1, False, N_READS) if kind == "split"
            else (B, 16, True, N_ALIGN))


def _rank_main(rank, world, store, out_dir, data, bucket):
    """One rank: join the gloo group, run _rank_work, save its results for
    the parent."""
    import gc

    import torch.distributed as dist

    from bucketmap_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", init_method=f"file://{store}",
                           rank=rank, world_size=world)
    try:
        out = _rank_work(rank, out_dir, data, bucket)
        bad = [m for m in sys.modules if m in ("jax", "bucketmap_tpu")
               or m.startswith(("jax.", "bucketmap_tpu."))]
        assert not bad, bad
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        # rank 0 aligns alone: leave the group together, not while a peer
        # still works
        dist.barrier()
    finally:
        # the wrapped methods below make reference cycles: free the mesh's
        # groups now, not at interpreter exit after the group is gone
        gc.collect()
        dist.destroy_process_group()


def _rank_work(rank, out_dir, data, bucket) -> dict:
    """Its occupancy shard, the gathered step vector and rank 0's SAMs,
    for both coarse paths."""
    from bucketmap_tpu_torch.mapper.device_pipeline import DeviceMapper
    from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(data, bucket)
    assert (mesh.di, mesh.bi) == divmod(rank, bucket)
    cfg, index, sim = _world(port=True)
    codes, quals, lengths = _reads(sim, cfg, N_READS)
    out, tables = {}, None
    for path in PATHS:
        dm = DeviceMapper(index, "cpu", batch_size=B, pairs_per_read=16,
                          vote_chunk=B, mesh=mesh, coarse_path=path,
                          tables=tables)
        tables = dm.tables
        staged = []
        presence = dm.coarse.presence
        dm.coarse.presence = lambda *a: staged.append(1) or presence(*a)
        out[f"vec_{path}"] = dm.step(codes[:B], quals[:B],
                                     lengths[:B]).numpy()
        # a mesh step keeps its floors however many lanes are valid
        out[f"budgets_{path}"] = (dm.step_budgets(4 * dm.lane_budget)
                                  + (dm.lane_budget, dm.out_cap))
        out[f"staged_{path}"] = len(staged)
        for kind in ("split", "align"):
            bs, ppr, align, n = _pipe_args(kind)
            pipe = BucketMapPipeline(index, device="cpu", batch_size=bs,
                                     pair_batch=B, pairs_per_read=ppr,
                                     mesh=mesh, align=align,
                                     coarse_path=path)
            splits = []
            split = pipe._locate_split
            pipe._locate_split = lambda *a: splits.append(1) or split(*a)
            sam = os.path.join(out_dir, f"{kind}_{path}.sam")
            stats = pipe.map_reads(_read_batch(codes, quals, lengths, n,
                                               port=True), sam)
            out[f"splits_{kind}_{path}"] = len(splits)
            out[f"steps_{kind}_{path}"] = (stats.steps, stats.grown_steps,
                                           stats.split_steps)
            out[f"aligner_{kind}_{path}"] = pipe.aligner is not None
    out["qgram"] = tables["qgram_words"].numpy()
    for vote in HOST_VOTES:
        dm = DeviceMapper(_host_index(index, vote, port=True), "cpu",
                          batch_size=B,
                          pairs_per_read=16, vote_chunk=B, mesh=mesh,
                          fine_build="host")
        out[f"vote_path_{vote}"] = dm.vote_path
        out[f"vec_host_{vote}"] = dm.step(codes[:B], quals[:B],
                                          lengths[:B]).numpy()
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, tmp_path_factory):
    """Spawn the four ranks of one mesh, joined within JOIN_S seconds."""
    data, bucket = MESHES[request.param]
    d = tmp_path_factory.mktemp(f"mesh{request.param}")
    ctx = mp.start_processes(_rank_main, nprocs=4, join=False,
                             start_method="spawn",
                             args=(4, str(d / "store"), str(d), data, bucket))
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"mesh {request.param} ranks did not "
                                     f"finish within {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return data, bucket, d, outs


@pytest.fixture(scope="module")
def jax_side(mesh_run):
    """The JAX mesh (on 4 of the 8 virtual CPU devices) on the same world:
    occupancy shards, the step vector and the pipelines' SAMs."""
    import jax

    from bucketmap_tpu.index.builder import build_fine_index
    from bucketmap_tpu.mapper.device_pipeline import DeviceMapper
    from bucketmap_tpu.mapper.pipeline import BucketMapPipeline
    from bucketmap_tpu.parallel.sharding import make_mesh

    data, bucket, d, _ = mesh_run
    cfg, index, sim = _world(port=False)
    build_fine_index(index)
    codes, quals, lengths = _reads(sim, cfg, N_READS)
    mesh = make_mesh(4, data=data, bucket=bucket)
    jm = DeviceMapper(index, batch_size=B, pairs_per_read=16, vote_chunk=B,
                      mesh=mesh)
    vec = np.asarray(jax.device_get(jm.step(codes[:B], quals[:B],
                                            lengths[:B])))
    qw = jm.coarse.qgram_words
    wl = qw.shape[1] // bucket
    shards = {s.index[1].start // wl: np.asarray(s.data)
              for s in qw.addressable_shards}
    for kind in ("split", "align"):
        bs, ppr, align, n = _pipe_args(kind)
        BucketMapPipeline(index, batch_size=bs, pair_batch=B,
                          pairs_per_read=ppr, mesh=mesh, align=align
                          ).map_reads(_read_batch(codes, quals, lengths, n,
                                                  port=False),
                                      d / f"jax_{kind}.sam")
    host_votes = {}
    for vote in HOST_VOTES:
        hm = DeviceMapper(_host_index(_world(port=False)[1], vote,
                                      port=False), batch_size=B,
                          pairs_per_read=16, vote_chunk=B, mesh=mesh)
        host_votes[vote] = (hm._vote_path, np.asarray(jax.device_get(
            hm.step(codes[:B], quals[:B], lengths[:B]))))
    return jm, vec, shards, host_votes


def test_mesh_occupancy_shards_match_jax(mesh_run, jax_side):
    data, bucket, _, outs = mesh_run
    _, _, shards, _ = jax_side
    assert sorted(shards) == list(range(bucket))
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["qgram"].view(np.uint32),
                                      shards[rank % bucket])


@pytest.mark.parametrize("path", PATHS)
def test_mesh_step_vector_matches_jax(mesh_run, jax_side, path):
    _, _, _, outs = mesh_run
    jm, want, _, _ = jax_side
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"vec_{path}"], want,
                                      err_msg=f"rank {rank}")
        assert (out[f"staged_{path}"] > 0) == (path == "staged")
    host = jm.decode_out(want)
    assert len(host["lane_read"]) >= B * 0.8
    assert int(host["local_valid"].max()) <= jm.lane_budget


@pytest.mark.parametrize("vote", HOST_VOTES)
def test_mesh_host_table_votes_match_jax(mesh_run, jax_side, vote):
    """Host fine tables sharded by bucket range with the JAX fills: the
    port's mesh takes the JAX mesh's vote path and gives its vector."""
    _, _, _, outs = mesh_run
    jpath, want = jax_side[3][vote]
    assert jpath == vote
    for rank, out in enumerate(outs):
        assert str(out[f"vote_path_{vote}"]) == vote
        np.testing.assert_array_equal(out[f"vec_host_{vote}"], want,
                                      err_msg=f"rank {rank}")
    assert want[0] > 0


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["split", "align"])
def test_mesh_pipeline_sam_matches_jax(mesh_run, jax_side, kind, path):
    _, bucket, d, outs = mesh_run
    want = (d / f"jax_{kind}.sam").read_bytes()
    assert (d / f"{kind}_{path}.sam").read_bytes() == want
    records = [ln for ln in want.splitlines() if not ln.startswith(b"@")]
    assert len(records) >= _pipe_args(kind)[3] * 0.8
    # every rank takes the same split-retry decisions; only rank 0 aligns
    splits = {int(out[f"splits_{kind}_{path}"]) for out in outs}
    assert len(splits) == 1
    assert (splits.pop() > 0) == (kind == "split" and bucket == 4)
    assert [bool(out[f"aligner_{kind}_{path}"]) for out in outs] == \
        [kind == "align", False, False, False]


@pytest.mark.parametrize("path", PATHS)
def test_mesh_keeps_fixed_budgets(mesh_run, path):
    """A mesh step keeps its fixed lane budget and output capacity (its
    all_gather takes vectors of one length from every rank): on the
    (1, 4) mesh one pair per read overflows the budget and the batch is
    split, on every rank alike, and no step grows."""
    _, bucket, _, outs = mesh_run
    for rank, out in enumerate(outs):
        lanes, cap, floor_lanes, floor_cap = (int(x) for x in
                                              out[f"budgets_{path}"])
        assert (lanes, cap) == (floor_lanes, floor_cap), rank
        steps, grown, split = (int(x) for x in out[f"steps_split_{path}"])
        assert grown == 0 and (split > 0) == (bucket == 4), rank
        assert steps == -(-N_READS // _pipe_args("split")[0]) + split, rank


@pytest.mark.parametrize("n", range(1, 9))
def test_default_split_matches_jax_make_mesh(n):
    from bucketmap_tpu.parallel.sharding import make_mesh
    from bucketmap_tpu_torch.parallel.sharding import default_split

    m = make_mesh(n)
    assert default_split(n) == (m.shape["data"], m.shape["bucket"])


def test_global_read_batch_is_the_ranks_rows():
    from bucketmap_tpu_torch.parallel.distributed import global_read_batch
    from bucketmap_tpu_torch.parallel.sharding import Mesh

    codes = np.arange(8 * 4, dtype=np.uint8).reshape(8, 4)
    quals = codes + 1
    lengths = np.arange(8)
    for di in range(2):
        mesh = Mesh(2, 2, di, 1, None, None, None)
        c, q, ln = global_read_batch(mesh, codes, quals, lengths)
        np.testing.assert_array_equal(c, codes[4 * di: 4 * di + 4])
        np.testing.assert_array_equal(q, quals[4 * di: 4 * di + 4])
        assert ln.dtype == np.int32
        assert ln.tolist() == list(range(4 * di, 4 * di + 4))
    with pytest.raises(ValueError, match="data shards"):
        global_read_batch(Mesh(3, 1, 0, 0, None, None, None), codes, quals,
                          lengths)


def test_initialize_refuses_nccl_without_cuda(tmp_path):
    """No silent switch to gloo: nccl without CUDA raises before joining."""
    import torch.distributed as dist

    from bucketmap_tpu_torch.parallel.distributed import initialize

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="nccl"):
        initialize(backend="nccl", init_method=f"file://{tmp_path}/store",
                   rank=0, world_size=1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        initialize(backend="mpi", init_method=f"file://{tmp_path}/store",
                   rank=0, world_size=1)
