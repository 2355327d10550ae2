"""The torch port's device encoding (bucketmap_tpu_torch.ops.encoding) and
u32-as-int32 helpers against the JAX package's jnp results, exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bucketmap_tpu.ops import encoding as jenc
from bucketmap_tpu_torch import device as tdev
from bucketmap_tpu_torch.ops import encoding as tenc


def _reads(seed, B=24, L=100):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    quals = rng.integers(0, 41, (B, L)).astype(np.uint8)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[0] = L
    return codes, quals, lengths


def test_unpack_2bit_matches_jnp():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (7, 5), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jenc.unpack_2bit(jnp.asarray(words), 70, xp=jnp))
    got = tenc.unpack_2bit(torch.from_numpy(words.view(np.int32)), 70).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [8, 12])
def test_kmer_and_revcomp_hashes_match_jnp(k):
    codes, _, _ = _reads(2 + k)
    want_h = np.asarray(jenc.kmer_hashes(jnp.asarray(codes), k, xp=jnp))
    got_h = tenc.kmer_hashes(torch.from_numpy(codes), k).numpy()
    np.testing.assert_array_equal(got_h, want_h.astype(np.int64))
    want_rc = np.asarray(jenc.revcomp_hash(jnp.asarray(want_h), k, xp=jnp))
    got_rc = tenc.revcomp_hash(torch.from_numpy(got_h), k).numpy()
    np.testing.assert_array_equal(got_rc, want_rc.astype(np.int64))


@pytest.mark.parametrize("k", [8, 12])
def test_unpack_reads_matches_jnp(k):
    codes, quals, lengths = _reads(3 + k)
    packed = jenc.pack_reads(codes, quals, lengths, k, 25 * k)
    want = jenc.unpack_reads(jnp.asarray(packed), codes.shape[1], k, xp=jnp)
    got = tenc.unpack_reads(torch.from_numpy(packed.view(np.int32)),
                            codes.shape[1], k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_u32_helpers():
    rng = np.random.default_rng(4)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:3] = [0, 0xFFFFFFFF, 0x80000000]
    t = torch.from_numpy(w.view(np.int32))
    for n in (0, 1, 7, 31):
        np.testing.assert_array_equal(tdev.srl(t, n).numpy().view(np.uint32),
                                      w >> n)
    want_pop = np.array([bin(int(x)).count("1") for x in w], np.int32)
    np.testing.assert_array_equal(tdev.popcount32(t).numpy(), want_pop)
    as64 = torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(tdev.i64_to_i32(as64).numpy(), w.view(np.int32))
    np.testing.assert_array_equal(tdev.popcount32(as64).numpy(), want_pop)


def test_cuda_device_is_never_picked_silently():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdev.resolve_device("cuda")
    assert tdev.resolve_device("cpu").type == "cpu"
