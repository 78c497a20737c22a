"""The port's hash functions, open-addressing table and the primitives they
use against the JAX package (ops/hashing.py, ops/hashtable.py,
ops/primitives.py), exact: the same numpy-seeded keys go to both, and every
output is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import hashing as jh
from dwarf_bench_tpu.ops import hashtable as jt
from dwarf_bench_tpu.ops import primitives as jp
from dwarf_bench_tpu_torch.ops import hashing as th
from dwarf_bench_tpu_torch.ops import hashtable as tt
from dwarf_bench_tpu_torch.ops import primitives as tp

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _u32(x):
    return np.asarray(x.numpy()).view(np.uint32) if x.dtype == torch.int32 \
        else x.numpy()


@pytest.fixture
def keys(rng):
    k = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([k, EDGES])


@pytest.mark.parametrize("seed", [0, 42, 0x9E3779B9, 2**32 - 1])
@pytest.mark.parametrize("size", [None, 1, 1000, 2**25, 2**31 + 11])
def test_murmur3(keys, seed, size):
    ref = np.asarray(jh.murmur3_32(jnp.asarray(keys), seed, size))
    assert np.array_equal(_u32(th.murmur3_32(_t(keys), seed, size)), ref)
    # scalars (the cuckoo chain walk) agree with the tensor form
    for k in EDGES:
        assert th.murmur3_32(int(k), seed, size) == int(
            jh.murmur3_32(jnp.uint32(k), seed, size))


@pytest.mark.parametrize("size", [1, 7, 1000, 2**31 + 1])
def test_simple_hashes(keys, size):
    ref = np.asarray(jh.simple_hash(jnp.asarray(keys), size))
    assert np.array_equal(_u32(th.simple_hash(_t(keys), size)), ref)
    for offset in (0, 5, 2**32 - 1):
        ref = np.asarray(jh.simple_hash_with_offset(jnp.asarray(keys), size,
                                                    offset))
        got = th.simple_hash_with_offset(_t(keys), size, offset)
        assert np.array_equal(_u32(got), ref)


@pytest.mark.parametrize("p", (2, 7, 31, 43))
@pytest.mark.parametrize("size", [1, 97, 1 << 20, 2**31 - 1])
def test_polynomial_hash(keys, p, size):
    ref = np.asarray(jh.polynomial_hash(jnp.asarray(keys), size, p))
    assert np.array_equal(_u32(th.polynomial_hash(_t(keys), size, p)), ref)
    for k in EDGES:
        assert th.polynomial_hash(int(k), size, p) == int(ref[
            np.flatnonzero(keys == k)[0]])


@pytest.mark.parametrize("a,b,buckets", [(1, 0, 1024), (0x9E3779B9, 77, 100),
                                         (2**32 - 1, 2**32 - 1, 1)])
def test_affine_hash(keys, a, b, buckets):
    ref = np.asarray(jh.affine_hash(jnp.asarray(keys), a, b,
                                    jh.SLAB_HASH_PRIME, buckets))
    got = th.affine_hash(_t(keys), a, b, th.SLAB_HASH_PRIME, buckets)
    assert np.array_equal(_u32(got), ref)
    assert th.SLAB_HASH_PRIME == jh.SLAB_HASH_PRIME
    assert th.POLYNOMIAL_PRIMES == jh.POLYNOMIAL_PRIMES


def _same_table(got, ref):
    assert np.array_equal(_u32(got.keys), np.asarray(ref.keys))
    assert len(got.payload) == len(ref.payload)
    for g, r in zip(got.payload, ref.payload):
        assert np.array_equal(_u32(g), np.asarray(r))
    assert int(got.max_probe) == int(ref.max_probe)


def _both_builds(keys, home, size, payload=(), valid=None):
    ref = jt.build(jnp.asarray(keys), jnp.asarray(home), size,
                   payload=tuple(jnp.asarray(p) for p in payload),
                   valid=None if valid is None else jnp.asarray(valid))
    got = tt.build(_t(keys), _t(home), size,
                   payload=tuple(_t(p) for p in payload),
                   valid=None if valid is None else torch.from_numpy(valid))
    _same_table(got, ref)
    return got, ref


def _same_probe(got_table, ref_table, queries, home, max_steps=None):
    rf, rs = jt.probe(ref_table, jnp.asarray(queries), jnp.asarray(home),
                      None if max_steps is None else jnp.int32(max_steps))
    gf, gs = tt.probe(got_table, _t(queries), _t(home), max_steps)
    assert np.array_equal(gf.numpy(), np.asarray(rf))
    assert np.array_equal(gs.numpy(), np.asarray(rs))


@pytest.mark.parametrize("load", [0.3, 0.9, 1.0])
def test_build_and_probe(rng, load):
    n = 1000
    size = int(np.ceil(n / load))
    keys = rng.choice(np.arange(1, 10 * n + 1), n, replace=False).astype(
        np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    home = np.asarray(jh.murmur3_32(jnp.asarray(keys), 42, size))
    got, ref = _both_builds(keys, home, size, payload=(vals,))
    absent = np.arange(10 * n + 1, 10 * n + 300, dtype=np.uint32)
    q = np.concatenate([keys, absent, EDGES])
    qh = np.asarray(jh.murmur3_32(jnp.asarray(q), 42, size))
    _same_probe(got, ref, q, qh)
    _same_probe(got, ref, q, qh, max_steps=size)
    _same_probe(got, ref, q, qh, max_steps=2)  # cut chains
    rf, rv = jt.lookup(ref, jnp.asarray(q), jnp.asarray(qh), default=7)
    gf, gv = tt.lookup(got, _t(q), _t(qh), default=7)
    assert np.array_equal(gf.numpy(), np.asarray(rf))
    assert np.array_equal(_u32(gv), np.asarray(rv))


def test_wraparound_and_collision_chain():
    for keys, home in (([7, 8, 9], [6, 6, 6]), ([10, 20, 30], [3, 3, 3]),
                       ([1, 2, 3, 4, 5, 6, 7, 8], [7] * 8)):
        keys = np.array(keys, np.uint32)
        home = np.array(home, np.uint32)
        got, ref = _both_builds(keys, home, 8)
        _same_probe(got, ref, keys, home)


def test_duplicates_take_a_slot_each(rng):
    keys = rng.integers(1, 50, 300).astype(np.uint32)  # many duplicates
    size = 600
    home = np.asarray(jh.murmur3_32(jnp.asarray(keys), 3, size))
    got, ref = _both_builds(keys, home, size)
    assert int(got.max_probe) > 1
    _same_probe(got, ref, keys, home)


def test_valid_mask_padding(rng):
    n, size = 64, 256
    keys = rng.choice(np.arange(1, 641), n, replace=False).astype(np.uint32)
    home = np.asarray(jh.murmur3_32(jnp.asarray(keys), 3, size))
    keys_p = np.concatenate([keys, np.full(32, 0xFFFFFFFF, np.uint32)])
    home_p = np.concatenate([home, np.zeros(32, np.uint32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(32, bool)])
    got, ref = _both_builds(keys_p, home_p, size, valid=valid)
    _same_probe(got, ref, keys, home)


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_segment_primitives(rng, n):
    keys = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    seg = np.array(jp.segment_ids_from_sorted(jnp.asarray(keys)))
    got = tp.segment_ids_from_sorted(torch.from_numpy(keys))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), seg)
    ref = np.asarray(jp.rank_in_segment(jnp.asarray(seg)))
    got = tp.rank_in_segment(torch.from_numpy(seg))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)


def test_cummax_and_unsigned_sort(keys):
    signed = keys.view(np.int32)
    ref = np.asarray(jp.cummax(jnp.asarray(signed)))
    assert np.array_equal(tp.cummax(_t(keys)).numpy(), ref)
    ref = np.asarray(jp.cummax(jnp.asarray(keys)))  # uint32 order
    assert np.array_equal(_u32(tp.cummax(_t(keys), unsigned=True)), ref)
    vals = np.arange(keys.size, dtype=np.uint32)
    rk, rv = jp.sort_by_key(jnp.asarray(keys), jnp.asarray(vals))
    gk, gv = tp.sort_by_key(_t(keys), _t(vals), unsigned=True)
    assert np.array_equal(_u32(gk), np.asarray(rk))
    assert np.array_equal(_u32(gv), np.asarray(rv))
