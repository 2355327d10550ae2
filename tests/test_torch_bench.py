"""bench_torch.py and the step profilers on the CPU: bench.py's world at 2
Mbp (2,000 reads, batches of 512) made through bench_torch.settings into
a temporary cache and mapped by bench_torch in both modes, its SAM byte
for byte the JAX BucketMapPipeline's on the same cached index and FASTQ,
its JSON line carrying every key bench.py prints, its percentages
bench.py's score_sam on the JAX SAM; bench_torch's knobs bench.py's; a
cache hit putting the run's query flags back; each profiler's
decomposition equal to what the pipeline computes; and every entry
point refusing to run without a card unless the CPU is asked for. The
JAX package's C++ host library is never loaded here (its numpy paths
give the same bytes)."""

import importlib
import os
import subprocess
import sys

import pytest
import torch

from bucketmap_tpu.index import builder as jax_builder
from bucketmap_tpu.io import native as jax_native
from bucketmap_tpu.mapper.pipeline import BucketMapPipeline as JaxPipeline
from bucketmap_tpu_torch import world
from bucketmap_tpu_torch.experiments import (profile_coarse_sub,
                                             profile_driver,
                                             profile_grch38_warmup,
                                             profile_pipeline, profile_select,
                                             profile_step)
from bucketmap_tpu_torch.mapper.pipeline import BucketMapPipeline

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
             profile_pipeline, profile_grch38_warmup)


def env(cache, **knobs) -> dict:
    out = {"BMTPU_BENCH_GENOME_MBP": f"{MBP:g}", "BMTPU_BENCH_READS":
           str(READS), "BMTPU_BENCH_BATCH": str(BATCH),
           "BMTPU_BENCH_CACHE": str(cache)}
    out.update({f"BMTPU_BENCH_{k}": v for k, v in knobs.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """cache -> {align: (bench_torch's JSON object, its SAM, the JAX SAM)},
    both modes mapped by bench_torch on the CPU and by the JAX pipeline on
    the index and reads bench_torch cached (the JAX index given its host
    fine tables: the JAX device build compiles for ~30 s on the CPU)."""
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
            JaxPipeline(index, align=align, batch_size=BATCH,
                        pair_batch=BATCH).map_fastq(
                str(cache / f"reads_{tag}.fastq"), str(jax_sam))
            out[align] = res, sam, jax_sam
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
