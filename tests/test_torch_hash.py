"""The slab (bucketized) and cuckoo tables against the JAX package
(ops/bucket_hash.py, ops/cuckoo.py), exact: the same numpy-seeded keys go to
both builds, and the tables, counts, rounds and answers must agree."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import bucket_hash as jbh
from dwarf_bench_tpu.ops import cuckoo as jck
from dwarf_bench_tpu.ops.merge_lookup import merge_lookup_bitonic as jmlb
from dwarf_bench_tpu_torch.ops import bucket_hash as tbh
from dwarf_bench_tpu_torch.ops import cuckoo as tck
from dwarf_bench_tpu_torch.ops.merge_lookup import merge_lookup_bitonic as tmlb


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _u32(x):
    return x.numpy().view(np.uint32)


def _eq(got, ref):
    return np.array_equal(_u32(got), np.asarray(ref))


def _both_bucket_builds(keys, vals, nb, **kw):
    jkw = {k: np.uint32(v) if k.startswith("hash") else v
           for k, v in kw.items()}
    ref = jbh.build(jnp.asarray(keys), jnp.asarray(vals), nb, **jkw)
    got = tbh.build(_t(keys), _t(vals), nb, **kw)
    for field in ("keys", "vals", "overflow_keys", "overflow_vals",
                  "sorted_keys"):
        assert _eq(getattr(got, field), getattr(ref, field)), field
    assert int(got.overflow_count) == int(ref.overflow_count)
    assert (got.hash_a, got.hash_b) == (int(ref.hash_a), int(ref.hash_b))
    assert got.num_buckets == ref.num_buckets
    assert got.capacity == ref.capacity
    return got, ref


@pytest.mark.parametrize("nb,kw", [(None, {}), (4, {"capacity": 8}),
                                   (64, {"hash_a": 0x9E3779B9,
                                         "hash_b": 12345})])
def test_bucket_build_and_find_distinct(rng, nb, kw):
    n = 2000
    keys = rng.choice(np.arange(1, 20001), n, replace=False).astype(np.uint32)
    keys[:2] = [2**31 + 5, 2**32 - 2]  # keys at and above 2^31
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    nb = nb or jbh.calculate_buckets_count(n)
    got, ref = _both_bucket_builds(keys, vals, nb, **kw)
    if "capacity" in kw:
        assert int(got.overflow_count) > 0
    assert _eq(got.sorted_vals, ref.sorted_vals)  # distinct keys
    q = np.concatenate([rng.permutation(keys)[:1000],
                        np.arange(20001, 21001, dtype=np.uint32),
                        np.array([0, 2**32 - 1, 2**31 + 5], np.uint32)])
    for engine in ("tile", "merge", "merge_legacy"):
        rf, rv = jbh.find(ref, jnp.asarray(q), engine=engine)
        gf, gv = tbh.find(got, _t(q), engine=engine)
        assert np.array_equal(gf.numpy(), np.asarray(rf)), engine
        assert _eq(gv, rv), engine
    gf, _ = tbh.find(got, _t(q))  # CPU tensor, default engine: tile
    assert gf.numpy()[:1000].all() and not gf.numpy()[1000:2000].any()


def test_bucket_find_val16(rng):
    n = 3000
    keys = (rng.permutation(2 * n)[:n] + 1).astype(np.uint32)
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    got, ref = _both_bucket_builds(keys, vals, jbh.calculate_buckets_count(n))
    q = np.concatenate([keys[: n // 2],
                        rng.integers(0, n, n - n // 2).astype(np.uint32)
                        + np.uint32(4 * n)])
    rf, rv = jbh.find(ref, jnp.asarray(q), engine="merge", val_bits=16)
    gf, gv = tbh.find(got, _t(q), engine="merge", val_bits=16)
    assert np.array_equal(gf.numpy(), np.asarray(rf))
    assert _eq(gv, rv)


def test_bucket_duplicate_keys(rng):
    """SlabHashBuild's data: duplicate keys in [1, 10000]. The tile layout
    and the overflow column are deterministic in both; sorted_vals is
    compared where keys are distinct, found everywhere."""
    n = 4096
    keys = rng.integers(1, 300, n).astype(np.uint32)
    got, ref = _both_bucket_builds(keys, keys, tbh.calculate_buckets_count(n))
    sk = _u32(got.sorted_keys)
    single = np.isin(sk, np.flatnonzero(np.bincount(sk) == 1))
    assert np.array_equal(_u32(got.sorted_vals)[single],
                          np.asarray(ref.sorted_vals)[single])
    q = np.concatenate([keys, np.arange(300, 400, dtype=np.uint32)])
    for engine in ("tile", "merge"):
        rf, rv = jbh.find(ref, jnp.asarray(q), engine=engine)
        gf, gv = tbh.find(got, _t(q), engine=engine)
        assert np.array_equal(gf.numpy(), np.asarray(rf))
        if engine == "tile":  # sums a bucket's matches: deterministic
            assert _eq(gv, rv)
        else:  # one duplicate's value, which is the key itself here
            assert np.array_equal(_u32(gv), np.where(gf.numpy(), q, 0))


def test_buckets_heuristic():
    for n, util in ((1900, 60), (1, 60), (1 << 24, 60), (1000, 10)):
        assert tbh.calculate_buckets_count(n, util) == \
            jbh.calculate_buckets_count(n, util)


def _both_cuckoo_builds(keys, size, s1, s2, max_iters, values=None,
                        compact_cap=None):
    ref = jck.build(jnp.asarray(keys), size, np.uint32(s1), np.uint32(s2),
                    max_iters,
                    values=None if values is None else jnp.asarray(values),
                    compact_cap=compact_cap)
    got = tck.build(_t(keys), size, s1, s2, max_iters,
                    values=None if values is None else _t(values),
                    compact_cap=compact_cap)
    assert _eq(got.keys, ref.keys)
    assert got.success == bool(ref.success)
    assert got.rounds == int(ref.rounds)
    assert _eq(got.keys_sorted, ref.keys_sorted)
    assert _eq(got.vals_sorted, ref.vals_sorted)
    assert len(got.payload) == len(ref.payload)
    for g, r in zip(got.payload, ref.payload):
        assert _eq(g, r)
    assert (got.seed1, got.seed2) == (int(ref.seed1), int(ref.seed2))
    return got, ref


@pytest.mark.parametrize("n,mult,kw,with_values", [
    (500, 4, {}, False),
    (8192, 4, {"compact_cap": 256}, True),  # full rounds, then active set
    (8192, 4, {"compact_cap": 8192}, False),  # no full round at all
    (1 << 14, 4, {}, True),  # active set re-compacted at the tail cap
    (4000, 2, {"max_iters": 2}, True),  # rounds run out: the chain walk
    (4000, 1.25, {"max_iters": 3}, False),  # ... reaches its cap: failure
])
def test_cuckoo_build(rng, n, mult, kw, with_values):
    keys = (rng.permutation(2 * n)[:n] + 1).astype(np.uint32)
    keys[0] = 2**32 - 2
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    kw = dict(kw)
    max_iters = kw.pop("max_iters", 256)
    got, ref = _both_cuckoo_builds(
        keys, int(mult * n), 0x9E3779B9, 0x85EBCA6B, max_iters,
        values=vals if with_values else None, **kw)
    q = np.concatenate([keys[: n // 2], np.arange(2 * n + 1, 2 * n + 1001,
                                                  dtype=np.uint32)])
    assert np.array_equal(tck.has(got, _t(q)).numpy(),
                          np.asarray(jck.has(ref, jnp.asarray(q))))
    # the merge engine of the bulk has/at, called as the CUDA dispatch does
    rf, _ = jmlb(ref.keys_sorted, jnp.zeros_like(ref.keys_sorted),
                 jnp.asarray(q), membership=True)
    gf, _ = tmlb(got.keys_sorted, torch.zeros_like(got.keys_sorted), _t(q),
                 membership=True)
    assert np.array_equal(gf.numpy(), np.asarray(rf))
    if with_values:
        rf, rv = jck.at(ref, jnp.asarray(q))
        gf, gv = tck.at(got, _t(q))
        assert np.array_equal(gf.numpy(), np.asarray(rf))
        assert _eq(gv, rv)
        rf, rv = jmlb(ref.keys_sorted, ref.vals_sorted, jnp.asarray(q))
        gf, gv = tmlb(got.keys_sorted, got.vals_sorted, _t(q))
        assert np.array_equal(gf.numpy(), np.asarray(rf))
        assert _eq(gv, rv)
    if got.success:
        assert tck.has(got, _t(keys)).all()


def test_cuckoo_unplaceable_set_reports_failure():
    """3 keys sharing both buckets cannot cohabit 2 slots: success False in
    both packages (tests/test_hashtable.py:123)."""
    size, s1, s2 = 8, 11, 22
    cand = np.arange(1, 20001, dtype=np.uint32)
    h1 = tck.hash1(_t(cand), s1, size).numpy()
    h2 = tck._hash2(_t(cand), s2, size).numpy()
    trio = None
    for pair in range(size * size):
        if pair // size == pair % size:
            continue
        m = (h1 == pair // size) & (h2 == pair % size)
        if int(m.sum()) >= 3:
            trio = cand[m][:3]
            break
    assert trio is not None
    got, _ = _both_cuckoo_builds(trio, size, s1, s2, 64)
    assert not got.success
    got, _ = _both_cuckoo_builds(trio[:2], size, s1, s2, 64)
    assert got.success
