"""The port's research tree (`bucketmap_tpu_torch/research/`) against the
JAX build's `research/` on the same inputs.

Exact (tolerance 0): the canonical k-mer table, revcomp_hash, the
profiles, the read dataset and the environment, the four numpy
classifiers, the theory model and the Jaccard matrix. The trained float
models start from the JAX model's weights (`params_from_flax`): MLP
logits within 1e-5, one Adam step within 1e-5 per parameter and 1e-6
relative in the loss, 20 steps' losses within 1e-4 relative; DQN Q
values and one step within the same bounds, and the same actions over a
short `learn` where every greedy pick's margin exceeds twice the drift.
The port on its own meets `tests/test_research.py`'s accuracy bars.
JAX runs only a few jitted steps here, never a whole fit or learn."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bucketmap_tpu.config import MapperConfig as JaxConfig
from bucketmap_tpu.io.fasta import FastaRecord
from bucketmap_tpu.ops.encoding import revcomp_hash as jax_revcomp_hash
from bucketmap_tpu.sim.simulator import ShortReadSimulator, random_genome
from bucketmap_tpu_torch.config import MapperConfig
from bucketmap_tpu_torch.ops.host_encoding import revcomp_hash
from bucketmap_tpu_torch.research import classifiers, neural, theory
from research import classifiers as jax_classifiers
from research import neural as jax_neural
from research import theory as jax_theory

CFG = dict(bucket_len=4096, read_len=150)


def carried(jax_params):
    return neural.params_from_flax(jax_params)


def max_param_err(net, jax_params) -> float:
    want = carried(jax_params)
    return max(float((want[k] - v).abs().max())
               for k, v in net.state_dict().items())


# ---- profiles -------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 6, 9])
def test_canonical_kmer_table_matches(k):
    table, n = neural.canonical_kmer_table(k)
    want, n_want = jax_neural.canonical_kmer_table(k)
    assert n == n_want and table.dtype == want.dtype
    np.testing.assert_array_equal(table, want)
    h = np.arange(4**k, dtype=np.uint32)
    assert (table[h] == table[revcomp_hash(h, k)]).all()


@pytest.mark.parametrize("k", [1, 5, 12, 16])
def test_revcomp_hash_matches(k):
    rng = np.random.default_rng(k)
    h = rng.integers(0, 4**k, 1000, dtype=np.uint64).astype(np.uint32)
    got = revcomp_hash(h, k)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jax_revcomp_hash(h, k, xp=np))
    np.testing.assert_array_equal(revcomp_hash(got, k), h)


@pytest.mark.parametrize("k", [5, 6])
def test_kmer_profile_batch_matches(k):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (6, 57)).astype(np.uint8)
    lengths = np.array([57, 40, k - 1, k, 0, 13], np.int32)
    table, n = neural.canonical_kmer_table(k)
    want = jax_neural.kmer_profile_batch(jnp.asarray(codes),
                                         jnp.asarray(lengths), k,
                                         jnp.asarray(table), n)
    got = neural.kmer_profile_batch(torch.from_numpy(codes),
                                    torch.from_numpy(lengths), k,
                                    torch.from_numpy(table.astype(np.int64)),
                                    n)
    assert got.dtype == torch.float32 and got.shape == (6, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2].sum() == 0 and got[3].sum() == 1 and got[4].sum() == 0


def test_read_dataset_and_env_match():
    genome = random_genome(16 * 2048, seed=11, n_refs=1)
    jds = jax_neural.ReadDataset(genome, JaxConfig(bucket_len=2048,
                                                   read_len=100),
                                 substitution_rate=0.05, seed=12)
    ds = neural.ReadDataset(genome, MapperConfig(bucket_len=2048,
                                                 read_len=100),
                            substitution_rate=0.05, seed=12)
    assert ds.n_buckets == jds.n_buckets == 16
    for n in (1, 64, 7):
        for got, want in zip(ds.batch(n), jds.batch(n)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    envs = [pkg.ReferenceGenomeEnv(genome, bucket_length=1024,
                                   read_length=80, substitution_rate=0.02,
                                   seed=16)
            for pkg in (neural, jax_neural)]
    assert envs[0].num_chunks == envs[1].num_chunks == 32
    np.testing.assert_array_equal(envs[0].reset(), envs[1].reset())
    for t in range(60):
        a = t % 32
        got, want = envs[0].step(a), envs[1].step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        assert envs[0].last_observation_bucket == \
            envs[1].last_observation_bucket


# ---- numpy classifiers and the theory model -------------------------------

@pytest.fixture(scope="module")
def world():
    """test_research.py's world: a 60 kbp genome and its forward reads."""
    genome = random_genome(60_000, seed=51, n_refs=1)
    sim = ShortReadSimulator(JaxConfig(**CFG), substitution_rate=0.005,
                             seed=52)
    sim.read(genome)
    reads = []
    for _ in range(60):
        c, bucket, _start, rc, _ = sim.sample()
        if not rc:
            reads.append((c[: CFG["read_len"]], bucket))
    return genome, reads


CLASSIFIERS = [("KMerExistence", 9, {}), ("KMerFrequency", 7, {}),
               ("MarkovChain", 5, {}),
               ("GappedKMerFrequency", 7, {"gap": 5, "seed": 3})]


@pytest.mark.parametrize("name,k,kw", CLASSIFIERS,
                         ids=[c[0] for c in CLASSIFIERS])
def test_classifier_matches_jax(world, name, k, kw):
    genome, reads = world
    model = getattr(classifiers, name)(MapperConfig(**CFG), k=k, **kw)
    ref = getattr(jax_classifiers, name)(JaxConfig(**CFG), k=k, **kw)
    model.read(genome)
    ref.read(genome)
    assert model.n_buckets == ref.n_buckets
    table = "trans" if name == "MarkovChain" else "matrix"
    got, want = getattr(model, table), getattr(ref, table)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name == "GappedKMerFrequency":
        np.testing.assert_array_equal(model.shape, ref.shape)
        assert model.span == ref.span
    assert [model.query(c) for c, _ in reads] == [ref.query(c)
                                                  for c, _ in reads]


@pytest.mark.parametrize("name,k,kw", CLASSIFIERS,
                         ids=[c[0] for c in CLASSIFIERS])
def test_port_classifier_accuracy(world, name, k, kw):
    genome, reads = world
    model = getattr(classifiers, name)(MapperConfig(**CFG), k=k, **kw)
    model.read(genome)
    assert model.n_buckets > 5
    correct = sum(1 for codes, bucket in reads if model.query(codes) == bucket)
    assert correct >= 0.8 * len(reads), f"{correct}/{len(reads)}"


def test_gapped_shape_checks_match_jax(world):
    genome, _ = world
    flat = classifiers.GappedKMerFrequency(MapperConfig(**CFG), k=7,
                                           shape=list(range(7)))
    flat.read(genome)
    ungapped = classifiers.KMerFrequency(MapperConfig(**CFG), k=7)
    ungapped.read(genome)
    np.testing.assert_array_equal(flat.matrix, ungapped.matrix)
    for shape in ([0, 1, 1, 2, 3, 4, 5], [0, 1, 2]):
        for pkg, cfg in ((classifiers, MapperConfig(**CFG)),
                         (jax_classifiers, JaxConfig(**CFG))):
            with pytest.raises(ValueError):
                pkg.GappedKMerFrequency(cfg, k=7, shape=shape)


def test_theory_matches_jax():
    args = (7_000_000, 700, 20, 8, 11)
    got = theory.KmerFrequencyModel(*args)
    want = jax_theory.KmerFrequencyModel(*args)
    assert got.correctness(n_sim=150, seed=1) == \
        want.correctness(n_sim=150, seed=1)
    small = (1_000_000, 100, 10, 6, 9)
    assert theory.KmerFrequencyModel(*small).sweep([5, 7], [5, 20], n_sim=50) \
        == jax_theory.KmerFrequencyModel(*small).sweep([5, 7], [5, 20],
                                                         n_sim=50)


# ---- the repetitive-region filter -----------------------------------------

def _duplicate_world(ragged: bool = False):
    """test_research.py's world: buckets 0 and 3 share a segment. ragged
    adds a 1,500 bp record, whose second bucket is 476 bp long, so a
    padded call holds rows of two lengths."""
    rng = np.random.default_rng(14)
    seg = rng.integers(0, 4, 1024 + 64).astype(np.uint8)
    other = rng.integers(0, 4, 2 * 1024).astype(np.uint8)
    codes = np.concatenate([seg[:1024], other, seg[:1024],
                            rng.integers(0, 4, 1024 + 64).astype(np.uint8)])
    recs = [FastaRecord("chr", codes)]
    if ragged:
        recs.append(FastaRecord("chr2", rng.integers(0, 4, 1500)
                                .astype(np.uint8)))
    return recs


@pytest.mark.parametrize("per_call,ragged", [(1, False), (4, True),
                                             (256, True)])
def test_filter_matches_jax(per_call, ragged):
    recs = _duplicate_world(ragged)
    filt = neural.RepetitiveRegionFilter(MapperConfig(bucket_len=1024,
                                                      read_len=64), k=9,
                                         device="cpu",
                                         buckets_per_call=per_call)
    ref = jax_neural.RepetitiveRegionFilter(JaxConfig(bucket_len=1024,
                                                      read_len=64), k=9)
    prof = filt.read(recs)
    want_prof = ref.read(recs)
    assert prof.shape == (7 if ragged else 5, 131072)
    assert prof.dtype == torch.float32
    np.testing.assert_array_equal(prof.numpy(), np.asarray(want_prof))
    ji = filt.ji_matrix(prof)
    want = ref.ji_matrix(want_prof)
    assert ji.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(ji, want)
    # a block of rows and columns from the blocks' own profiles
    rows, cols = np.array([3, 0, 4]), np.array([0, 1, 2, 3, 4])
    block = neural.jaccard(prof[rows] @ prof[cols].T, prof[rows].sum(1),
                           prof[cols].sum(1))
    block[torch.from_numpy(rows[:, None] == cols[None, :])] = 0.0
    np.testing.assert_array_equal(block.numpy(), want[np.ix_(rows, cols)])


def test_port_filter_detects_duplicates():
    filt = neural.RepetitiveRegionFilter(MapperConfig(bucket_len=1024,
                                                      read_len=64), k=9,
                                         device="cpu")
    ji = filt.ji_matrix(filt.read(_duplicate_world()))
    assert ji.shape[0] >= 5
    assert np.allclose(ji, ji.T)
    assert np.allclose(np.diag(ji), 0.0)
    dup = ji[0, 3]
    rand_max = np.sort(ji[np.triu_indices_from(ji, k=1)])[-2]
    assert dup > 0.8 and dup > rand_max + 0.3


# ---- the MLP classifier ----------------------------------------------------

def _mlp_pair():
    genome = random_genome(16 * 2048, seed=11, n_refs=1)
    jds = jax_neural.ReadDataset(genome, JaxConfig(bucket_len=2048,
                                                   read_len=100),
                                 substitution_rate=0.01, seed=12)
    ref = jax_neural.MLPBucketClassifier(k=6, d_model=256, seed=13)
    ref.init(jds.n_buckets)
    clf = neural.MLPBucketClassifier(k=6, d_model=256, seed=13, device="cpu")
    clf.init(jds.n_buckets)
    clf.net.load_state_dict(carried(ref.params))
    return jds, ref, clf


def test_mlp_matches_jax_through_carried_weights():
    jds, ref, clf = _mlp_pair()
    codes, lens, labels = jds.batch(64)
    prof = clf.profiles(codes, lens)
    np.testing.assert_array_equal(prof.numpy(),
                                  np.asarray(ref.profiles(codes, lens)))
    with torch.no_grad():
        logits = clf.net(prof).numpy()
    assert np.abs(logits - np.asarray(ref._apply(ref.params, prof.numpy()))
                  ).max() <= 1e-5
    np.testing.assert_array_equal(clf.predict(codes, lens),
                                  ref.predict(codes, lens))
    got_losses, want_losses = [], []
    for step in range(20):
        if step:
            codes, lens, labels = jds.batch(64)
            prof = clf.profiles(codes, lens)
        ref.params, ref._opt_state, loss = ref._train_step(
            ref.params, ref._opt_state, jnp.asarray(prof.numpy()),
            jnp.asarray(labels))
        want_losses.append(float(loss))
        got_losses.append(float(clf.train_step(
            prof, torch.from_numpy(labels.astype(np.int64)))))
        if step == 0:
            assert max_param_err(clf.net, ref.params) <= 1e-5
            np.testing.assert_allclose(got_losses[0], want_losses[0],
                                       rtol=1e-6)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)


def test_port_mlp_learns():
    genome = random_genome(16 * 2048, seed=11, n_refs=1)
    ds = neural.ReadDataset(genome, MapperConfig(bucket_len=2048,
                                                 read_len=100),
                            substitution_rate=0.01, seed=12)
    clf = neural.MLPBucketClassifier(k=6, d_model=256, seed=13, device="cpu")
    losses = clf.fit(ds, steps=150, batch_size=64)
    assert len(losses) == 150 and losses[-1] < losses[0]
    acc = clf.accuracy(ds, n=256)
    assert acc > 0.9, f"classifier accuracy {acc}"


def test_mlp_initialises_as_flax_dense():
    """LeCun normal truncated at two standard deviations, zero bias, the
    same draw for the same seed."""
    net = neural.mlp(2080, 512, 16, seed=5)
    w = net[0].weight.detach()
    std = (1.0 / 2080) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.01
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert not net[0].bias.detach().any()
    again = neural.mlp(2080, 512, 16, seed=5)
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_research_models_need_the_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        neural.MLPBucketClassifier(k=3, d_model=8)
    with pytest.raises(RuntimeError, match="cuda"):
        neural.RepetitiveRegionFilter(MapperConfig(), k=3)


# ---- the DQN ---------------------------------------------------------------

DQN = dict(k=6, d_model=512, lr=3e-3, eps=0.3, seed=17)


def _dqn_pair():
    genome = random_genome(8 * 1024, seed=15, n_refs=1)
    envs = [pkg.ReferenceGenomeEnv(genome, bucket_length=1024,
                                   read_length=80, substitution_rate=0.0,
                                   seed=16) for pkg in (neural, jax_neural)]
    ref = jax_neural.DQNAgent(envs[1], **DQN)
    agent = neural.DQNAgent(envs[0], device="cpu", **DQN)
    agent.net.load_state_dict(carried(ref.params))
    return agent, ref


def test_dqn_matches_jax_through_carried_weights():
    agent, ref = _dqn_pair()
    obs = [agent.env.reset() for _ in range(32)]
    prof = torch.cat([agent._profile(o) for o in obs])
    np.testing.assert_array_equal(
        prof.numpy(), np.concatenate([np.asarray(ref._profile(o))
                                      for o in obs]))
    q = agent.q_values(prof).numpy()
    assert np.abs(q - np.asarray(ref._apply(ref.params, prof.numpy()))
                  ).max() <= 1e-5
    rng = np.random.default_rng(0)
    actions = rng.integers(0, 8, 32).astype(np.int32)
    rewards = rng.integers(0, 2, 32).astype(np.float32)
    ref.params, ref._opt_state, loss = ref._train_step(
        ref.params, ref._opt_state, jnp.asarray(prof.numpy()),
        jnp.asarray(actions), jnp.asarray(rewards))
    got = agent.train_step(prof, torch.from_numpy(actions),
                           torch.from_numpy(rewards))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    assert max_param_err(agent.net, ref.params) <= 1e-5


def test_dqn_learn_takes_the_jax_actions():
    """A short learn from carried weights: the same epsilon draws, the
    same replay samples and, at every greedy act, the same argmax, each
    by a margin over twice the float drift between the two Q rows."""
    agent, ref = _dqn_pair()
    acts = ([], [])
    qs = ([], [])
    for i, (a, env) in enumerate(((agent, agent.env), (ref, ref.env))):
        step = env.step
        env.step = lambda action, step=step, i=i: (acts[i].append(action),
                                                   step(action))[1]
    q_values = agent.q_values
    agent.q_values = lambda p: (lambda q: (qs[0].append(q[0].numpy()),
                                           q)[1])(q_values(p))
    apply = ref._apply
    ref._apply = lambda p, x: (lambda q: (qs[1].append(np.asarray(q)[0]),
                                          q)[1])(apply(p, x))
    got = agent.learn(total_timesteps=100, batch_size=32)
    want = ref.learn(total_timesteps=100, batch_size=32)
    assert acts[0] == acts[1] and got == want
    got_q, want_q = np.array(qs[0]), np.array(qs[1])
    assert len(got_q) == len(want_q) > 50
    drift = np.abs(got_q - want_q).max(axis=1)
    top2 = np.sort(want_q, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 2 * drift).all()


def test_port_dqn_learns():
    genome = random_genome(8 * 1024, seed=15, n_refs=1)
    env = neural.ReferenceGenomeEnv(genome, bucket_length=1024,
                                    read_length=80, substitution_rate=0.0,
                                    seed=16)
    assert env.num_chunks == 8
    obs = env.reset()
    assert obs.shape == (80,) and env.last_observation_bucket in range(8)
    _obs2, r, done, _ = env.step(env.last_observation_bucket)
    assert r == 1 and done
    agent = neural.DQNAgent(env, k=5, d_model=128, lr=3e-3, eps=0.3,
                            seed=17, device="cpu")
    avg = agent.learn(total_timesteps=800, batch_size=32)
    assert avg > 0.4, f"DQN final avg reward {avg} (random = 1/8)"
