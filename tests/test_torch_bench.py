"""bench_torch.py and the step profilers on the CPU: bench.py's world at 2
Mbp (2,000 reads, batches of 512) made through bench_torch.settings into
a temporary cache and mapped by bench_torch in both modes, its SAM byte
for byte the JAX BucketMapPipeline's on the same cached index and FASTQ,
its JSON line carrying every key bench.py prints, its percentages
bench.py's score_sam on the JAX SAM; bench_torch's knobs bench.py's; a
cache hit putting the run's query flags back; each profiler's
decomposition equal to what the pipeline computes; the align, finewin,
mesh and coarse profilers' results equal the JAX package's on the same
inputs (the coarse rows' checksums the JAX script's own); and every
entry point refusing to run without a card unless the CPU is asked for.
The JAX package's C++ host library is never loaded here (its numpy paths
give the same bytes)."""

import contextlib
import importlib
import io
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketmap_tpu.index import builder as jax_builder
from bucketmap_tpu.io import native as jax_native
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu.ops import align as jax_align
from bucketmap_tpu.ops import encoding as jax_enc
from bucketmap_tpu.ops.coarse import _chunk_scan_jnp
from bucketmap_tpu.ops.vote import FineLocator as JaxFine
from bucketmap_tpu_torch import world
from bucketmap_tpu_torch.experiments import (profile_align, profile_coarse,
                                             profile_coarse_sub,
                                             profile_driver, profile_finewin,
                                             profile_grch38_warmup,
                                             profile_mesh, profile_pipeline,
                                             profile_select, profile_step)
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline
from bucketmap_tpu_torch.ops.align import BandedAligner, pack_qcodes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench  # noqa: E402  (reads its knobs at import; loads no jax)
import bench_torch  # noqa: E402

MBP, READS, BATCH = 2.0, 2000, 512
# what bench.py's JSON line holds in every mode (bench.py:300-315)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "pct_mapped",
              "pct_correct_position", "pct_correct_position_tol5",
              "locations_per_read", "warmup_seconds", "peak_host_rss_kb",
              "device_hbm_peak_bytes", "device_hbm_peak_source", "io_native"}
PROFILERS = (profile_step, profile_coarse_sub, profile_select, profile_driver,
             profile_pipeline, profile_grch38_warmup, profile_align,
             profile_finewin, profile_mesh, profile_coarse)


def env(cache, **knobs) -> dict:
    out = {"BMTPU_BENCH_GENOME_MBP": f"{MBP:g}", "BMTPU_BENCH_READS":
           str(READS), "BMTPU_BENCH_BATCH": str(BATCH),
           "BMTPU_BENCH_CACHE": str(cache)}
    out.update({f"BMTPU_BENCH_{k}": v for k, v in knobs.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """cache -> {align: (bench_torch's JSON object, its SAM, the JAX SAM),
    "jax_step": the align-free JAX pipeline's DeviceMapper}, both modes
    mapped by bench_torch on the CPU and by the JAX pipeline on the index
    and reads bench_torch cached (the JAX index given its host fine
    tables: the JAX device build compiles for ~30 s on the CPU)."""
    cache = tmp_path_factory.mktemp("torch_bench")
    tag = world.reads_name(MBP, READS)[len("reads_"):]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_tried", True)
        mp.setattr(jax_native, "_lib", None)
        mp.setenv("BMTPU_DEVICE_FINE", "0")
        for align in (False, True):
            knobs = {"ALIGN": "1", "PAIR_BATCH": str(BATCH)} if align else {}
            res = bench_torch.main(["--device", "cpu"],
                                   environ=env(cache, **knobs))
            if not align:
                index = jax_builder.load_index(str(cache),
                                               world.index_name(MBP))
                jax_builder.build_fine_index(index)
            sam = cache / f"out_{tag}{'_al' if align else ''}.sam"
            jax_sam = cache / f"jax_{int(align)}.sam"
            jax_pipe = JaxPipeline(index, align=align, batch_size=BATCH,
                                   pair_batch=BATCH)
            jax_pipe.map_fastq(str(cache / f"reads_{tag}.fastq"),
                               str(jax_sam))
            out[align] = res, sam, jax_sam
            if not align:
                out["jax_step"] = jax_pipe.device
    return cache, out


@pytest.mark.parametrize("align", [False, True])
def test_bench_torch_sam_and_scores_match_jax_pipeline(runs, align):
    cache, out = runs
    res, sam, jax_sam = out[align]
    assert sam.read_bytes() == jax_sam.read_bytes()
    assert BENCH_KEYS | {"batch", "device", "power_limit_w"} <= set(res)
    assert (res["batch"], res["device"], res["power_limit_w"]) == \
        (BATCH, "cpu", None)
    assert res["io_native"] is True
    tag = world.reads_name(MBP, READS)
    index = jax_builder.load_index(str(cache), world.index_name(MBP))
    gt = str(cache / f"{tag}.position_ground_truth")
    mapped, correct = bench.score_sam(str(jax_sam), gt, index)
    _, tol5 = bench.score_sam(str(jax_sam), gt, index, tol=5)
    assert (res["pct_mapped"], res["pct_correct_position"],
            res["pct_correct_position_tol5"]) == \
        (round(mapped, 2), round(correct, 2), round(tol5, 2))
    assert res["pct_mapped"] > 97 and res["value"] > 0
    assert ("index_build_seconds" in res) == (not align)
    assert ("align" if align else "align-free") in res["metric"]


def test_importing_bench_loads_no_jax():
    code = ("import sys; import bench, bench_torch; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'bucketmap_tpu')]")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("knobs", [
    {}, {"BMTPU_BENCH_ALIGN": "1", "BMTPU_BENCH_FRAC": "0.25",
         "BMTPU_BENCH_GENOME_MBP": "3100"},
    {"BMTPU_BENCH_LONG": "1", "BMTPU_BENCH_UNIFORM": "1",
     "BMTPU_BENCH_HOST_FINE": "1", "BMTPU_BENCH_BATCH": "4096",
     "BMTPU_BENCH_CACHE": "/c"}])
def test_settings_are_bench_pys_knobs(knobs, monkeypatch):
    """bench_torch.settings reads bench.py's knobs with its defaults:
    bench.py re-imported under the same environment agrees."""
    for k in list(os.environ):
        if k.startswith("BMTPU_BENCH_"):
            monkeypatch.delenv(k)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    ref = importlib.reload(bench)
    s = bench_torch.settings(knobs)
    assert (s["genome_mbp"], s["reads"], s["batch"], s["align"], s["long"],
            s["frac"], s["uniform"], s["host_fine"]) == \
        (ref.GENOME_MBP, ref.NUM_READS, ref.BATCH, ref.ALIGN, ref.LONG,
         ref.FRAC, ref.UNIFORM, ref.HOST_FINE)
    assert s["cache"] == ref.CACHE
    assert bench_torch.baseline_reads_per_sec(s) == \
        ref.BASELINE_READS_PER_SEC_NOALIGN


def test_cache_hit_puts_the_runs_query_flags_back(tmp_path):
    """An index built at the long-read flags and loaded for a short-read
    run (and the other way round) carries the loading run's flags; its
    cache names are bench.py's, the uniform genome's tagged "u"."""
    genome = world.bench_genome(0.2, uniform=True)
    long_cfg = world.bench_config(long=True)
    idx, _, built = world.bench_index(str(tmp_path), 0.2, long_cfg, genome,
                                      uniform=True, log=str)
    assert built is not None and idx.config == long_cfg
    assert (tmp_path / "idx_0.2u.bmtpu.json").exists()
    short = world.bench_config()
    hit, _, again = world.bench_index(str(tmp_path), 0.2, short,
                                      uniform=True, log=str)
    assert again is None and hit.config == short
    hit, _, _ = world.bench_index(str(tmp_path), 0.2, long_cfg, uniform=True,
                                  log=str)
    assert hit.config == long_cfg
    assert world.reads_name(0.2, 16, 0.25, uniform=True, long=True) == \
        "reads_g0.2u_f0.25m_r16_long"
    fastq, gt, _ = world.bench_reads(str(tmp_path), 16, 0.2, genome,
                                     uniform=True, log=str)
    assert fastq == str(tmp_path / "reads_g0.2um_r16.fastq")
    assert open(gt).read().count("\n") == 16


@pytest.fixture(scope="module")
def pipe(runs):
    """The bench world's align-free pipeline on the CPU, and its reads."""
    cache, _ = runs
    index = world.bench_index(str(cache), MBP, world.bench_config())[0]
    fastq = str(cache / f"{world.reads_name(MBP, READS)}.fastq")
    return (BucketMapPipeline(index, device="cpu", batch_size=BATCH,
                              pair_batch=BATCH),
            world.first_reads(fastq, 3 * BATCH))


def test_profile_step_decomposition_is_the_step(pipe):
    p, batch = pipe
    dm = p.device
    codes, quals, seg_len, _, _ = p._all_segments(batch.head(BATCH))
    packed = dm.pack(codes, quals, seg_len)
    out = profile_step.decompose(dm, packed)
    assert torch.equal(out["vec"], dm.step_packed(packed).cpu())
    assert out["staged_equal"]
    from bucketmap_tpu_torch.experiments.stages import StageClock
    clock = StageClock("cpu")
    again = profile_step.decompose(dm, packed, clock)
    assert torch.equal(again["vec"], out["vec"])
    assert dm.stage is not clock
    assert {"step", "unpack", "coarse", "select", "prepare", "compact",
            "search", "tally", "pack", "download", "staged presence",
            "staged chunk scan"} == set(clock.order)
    assert clock.calls["search"] == clock.calls["tally"] >= 1


def test_profile_coarse_and_select_decompositions(pipe):
    p, batch = pipe
    dm = p.device
    cfg = dm.cfg
    codes, quals, seg_len, _, _ = p._all_segments(batch.head(BATCH))
    packed = dm.pack(codes, quals, seg_len)
    from bucketmap_tpu_torch.ops.encoding import unpack_reads
    sub = profile_coarse_sub.decompose(dm.coarse, *unpack_reads(
        packed, cfg.read_len, cfg.query_seed))
    assert sub["equal"]
    assert sub["rows"].shape == (BATCH * 2 * cfg.mapper_samples,
                                 cfg.qgrams_per_kmer)
    sel = profile_select.decompose(dm.coarse,
                                   *profile_select.scored(dm, packed))
    assert sel["equal"] and (sel["cand"] >= 0).any()


def test_profile_driver_cycle_gives_map_reads_sam(pipe, tmp_path):
    p, batch = pipe
    stats = profile_driver.cycle(p, batch, tmp_path / "a.sam")
    want = p.map_reads(batch, tmp_path / "b.sam")
    assert (tmp_path / "a.sam").read_bytes() == \
        (tmp_path / "b.sam").read_bytes()
    assert stats.num_reads == want.num_reads == 3 * BATCH
    assert p.stage is not None and stats.mapped_locations > 0


def test_profile_pipeline_batches_are_steps(pipe):
    p, batch = pipe
    rows = p._all_segments(batch)[:3]
    outs = profile_pipeline.run_batches(p.device, rows, 4)
    assert len(outs) == 4
    # the fourth wraps around to the first batch's rows
    assert torch.equal(outs[3], outs[0])
    assert torch.equal(outs[1], p.device.step(*(r[BATCH:2 * BATCH]
                                                for r in rows)))


def test_profile_grch38_warmup_split(runs):
    cache, _ = runs
    from bucketmap_tpu_torch.experiments.stages import StageClock
    clock = StageClock("cpu", sync=True)
    p, reads, stats = profile_grch38_warmup.warmup_split(
        str(cache), MBP, 1.0, READS, BATCH, "cpu", clock)
    assert clock.order == ["index load", "pipeline init", "first batch",
                           "steady batch"]
    assert stats.num_reads == reads.num_reads == BATCH
    assert p.device.vote_path == "tiled"


def _jax_index(cache):
    return jax_builder.load_index(str(cache), world.index_name(MBP))


def test_profile_align_pairs_and_decomposition_match_jax(runs, pipe):
    """pairs() draws the JAX script's pairs (its per-pair decode loop,
    experiments/profile_align.py:32-53, repeated here); the
    decomposition's runs vector and DP-only scores equal the JAX
    aligner's _align_runs and _align_core on them."""
    cache, _ = runs
    index = pipe[0].index
    P = 64
    qcodes, qlen, bids, offs, is_rc = profile_align.pairs(index, P)
    rng = np.random.default_rng(3)
    blen = np.asarray(index.bucket_lengths)
    want_bids = rng.integers(0, index.n_buckets, P).astype(np.int32)
    want_offs = (rng.random(P) * (blen[want_bids] - 400)).astype(np.int32)
    bp = np.asarray(index.buckets_packed)
    want = np.zeros((P, 304), np.uint8)
    for i in range(P):
        w0 = want_offs[i] // 16
        words = bp[want_bids[i], w0: w0 + 20]
        bases = ((words[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
                 ).reshape(-1).astype(np.uint8)
        st = want_offs[i] - w0 * 16
        want[i, :300] = bases[st: st + 300]
    sub = rng.random((P, 304)) < 0.002
    want = np.where(sub, (want + 1 + (rng.random((P, 304)) * 3)
                          .astype(np.uint8)) % 4, want).astype(np.uint8)
    np.testing.assert_array_equal(qcodes, want)
    np.testing.assert_array_equal(bids, want_bids)
    np.testing.assert_array_equal(offs, want_offs)
    assert sub.any() and (qlen == 300).all() and not is_rc.any()

    al = BandedAligner(index, "cpu", pair_batch=P // 2)
    from bucketmap_tpu_torch.experiments.stages import StageClock
    al.stage = clock = StageClock("cpu")
    al.align_batch_runs_stream(qcodes, qlen, bids, offs, is_rc,
                               lambda *a: None)
    assert clock.order == ["pad and upload", "pack", "runs vector",
                           "download", "consume"]
    assert clock.calls["consume"] == 2
    out = profile_align.decompose(al, qcodes, qlen, bids, offs, is_rc)
    assert out["equal"]
    ref = jax_align.BandedAligner(_jax_index(cache), pair_batch=P)
    width = al._width(qlen, bids, offs)
    args = tuple(jnp.asarray(a) for a in (qlen, bids, offs, is_rc, width))
    runs_vec = ref._align_runs(ref.buckets_tiled, jnp.asarray(
        pack_qcodes(qcodes)), *args, run_cap=-(-8 * P // 2) * 2)
    np.testing.assert_array_equal(out["runs"].numpy(), np.asarray(runs_vec))
    score = jax.jit(lambda *a: ref._align_core(*a)[0])(
        ref.buckets_tiled, jnp.asarray(qcodes), *args)
    np.testing.assert_array_equal(out["dp_score"].numpy(), np.asarray(score))


def test_profile_finewin_modes_match_jax_vote(runs, pipe):
    """Both modes' offset, votes and accept on the bench reads' first
    pairs and ground-truth buckets equal the JAX FineLocator's vote on
    the same tiled table (its jnp window backend)."""
    cache, _ = runs
    index = pipe[0].index
    cfg = index.config
    n, chunk = 1024, 256
    tag = world.reads_name(MBP, READS)
    bucket, rc = profile_finewin.ground_truth(
        str(cache / f"{tag}.bucket_ground_truth"), n)
    batch = world.first_reads(str(cache / f"{tag}.fastq"), n)
    fl = profile_finewin.locator(index, "cpu")
    lane_args = profile_finewin.lanes(fl, batch, bucket, rc)
    out = profile_finewin.decompose(fl, lane_args, chunk)
    assert out["equal"] and rc.any() and (~rc).any()

    jfl = JaxFine(_jax_index(cache), pair_batch=chunk)
    assert jfl._finewin_mode == "jnp"
    jfl.fine_packed = jnp.asarray(fl.fine_packed.numpy().view(np.uint32))
    jfl.fine_ptab = jnp.asarray(fl.fine_ptab.numpy())
    jfl.fine_low = jfl.fine_pos = None
    jfl.search_steps, jfl.low_bits = fl.search_steps, fl.low_bits
    lengths = np.minimum(batch.lengths, cfg.read_len).astype(np.int32)
    sh, si = jfl.prepare(batch.codes, batch.quals, lengths)
    np.testing.assert_array_equal(lane_args[2].numpy(), sh.astype(np.int64))
    want = jfl.vote(bucket, rc, sh, si, lengths)
    assert want[2].sum() > 0.9 * n
    for mode in profile_finewin.MODES:
        for got, w, what in zip(out[mode], want, ("offset", "votes",
                                                  "accept")):
            np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{mode} {what}")


def test_profile_mesh_one_rank_mesh_decodes_as_single_and_jax(
        runs, pipe, tmp_path, monkeypatch):
    """On a gloo group of one rank, the (1, 1) mesh's decoded accepted
    lanes and counts equal the single device's and the JAX
    DeviceMapper.step's, batch by batch; both steps enter the same
    stages."""
    cache, out = runs
    index = pipe[0].index
    nb = 2
    reads = profile_mesh.bench_reads(
        index, str(cache / f"{world.reads_name(MBP, READS)}.fastq"),
        nb * BATCH)
    got = profile_mesh.decompose(index, reads, nb, BATCH, "cpu", "both",
                                 init_method=f"file://{tmp_path}/store")
    assert got["equal"] and set(got) == {"single", "mesh 1x1", "equal"}
    assert not torch.distributed.is_initialized()
    jdm = out["jax_step"]
    monkeypatch.setattr(jax_native, "_tried", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    for i in range(nb):
        want = jdm.decode_out(np.asarray(jdm.step(
            *(a[i * BATCH:(i + 1) * BATCH] for a in reads))))
        mine = got["mesh 1x1"]["decoded"][i]
        np.testing.assert_array_equal(profile_mesh.accepted_rows(mine),
                                      profile_mesh.accepted_rows(want))
        np.testing.assert_array_equal(mine["counts"], want["counts"])
    assert got["single"]["accepted"] > 0.9 * nb * BATCH

    from bucketmap_tpu_torch.experiments.stages import StageClock

    def stages(label, dm, _):
        dm.stage = clock = StageClock("cpu")
        dm.step(*(a[:BATCH] for a in reads))
        return clock.order

    order = profile_mesh.over_mappers(index, "cpu", "both", BATCH, stages,
                                      init_method=f"file://{tmp_path}/s2")
    assert order["mesh 1x1"] == order["single"] == [
        "unpack", "coarse", "select", "prepare", "compact", "search",
        "tally", "pack"]


def test_profile_coarse_rows_match_jax():
    """At 2 Mbp and 16 reads: the made index is the JAX script's draw, the
    counting rows share one checksum, row A equals the JAX package's
    count (_chunk_scan_jnp over the ANDed rows) read-strand by
    read-strand, and every row's checksum is the one the JAX script
    prints."""
    made = profile_coarse.made_index(2.0, 16)
    f = profile_coarse.Formulations(made, "cpu")
    out = profile_coarse.decompose(f)
    assert out["equal"]
    cfg = made["cfg"]
    s, k, q = cfg.mapper_samples, cfg.query_seed, cfg.index_seed
    g, w = k - q + 1, made["w"]
    kmers = jax_enc.kmer_hashes(made["codes"], k)
    samp = kmers[:, ::max(1, kmers.shape[1] // s)][:, :s]
    both = np.stack([samp, jax_enc.revcomp_hash(samp, k)], axis=1)
    grams = (both[..., None].astype(np.int64) >> (2 * np.arange(g))) \
        & (4**q - 1)
    rows = made["kmer_to_row"][grams]                      # (B, 2, s, g)
    np.testing.assert_array_equal(f.rows().numpy(), rows.reshape(-1, g))
    presence = np.bitwise_and.reduce(made["qgram_words"][rows], axis=3)
    cm, _, _ = _chunk_scan_jnp(jnp.asarray(presence), jnp.int32(32 * w))
    np.testing.assert_array_equal(out["A"].numpy(),
                                  np.asarray(cm).max(axis=2))
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(printed):
        mp.setattr(sys, "argv", ["profile_coarse.py", "2", "16"])
        runpy.run_path(os.path.join(REPO, "experiments", "profile_coarse.py"))
    want = {ln[0]: int(ln.rsplit("checksum ", 1)[1].rstrip(")"))
            for ln in printed.getvalue().splitlines() if "checksum" in ln}
    assert set(want) == set("ABCDEFG")
    assert want == {c: out["checksums"][c] for c in want}


@pytest.mark.parametrize("entry", ["bench_torch"] +
                         [m.__name__.rsplit(".", 1)[1] for m in PROFILERS])
def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(entry,
                                                              tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    mod = bench_torch if entry == "bench_torch" else \
        importlib.import_module(f"bucketmap_tpu_torch.experiments.{entry}")
    kw = {"environ": env(tmp_path)} if entry == "bench_torch" else {}
    with pytest.raises(RuntimeError, match="is_available"):
        mod.main(["--cache-dir", str(tmp_path)] if kw == {} else [], **kw)
    assert os.listdir(tmp_path) == []
