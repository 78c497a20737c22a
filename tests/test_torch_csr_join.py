"""The general CSR join on the CPU: ``csr_join.build`` held field by field
against the JAX package's ``build`` (ids as sets per key: both sorts are
unstable), and the four probes against the JAX ``probe`` on wide keys with
duplicates and EMPTY padding. ``probe_merge_bitonic`` is ``probe_merge`` on
the CPU, as in the JAX package; its bitonic engine runs here too, with the
kernels' plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwarf_bench_tpu.ops import csr_join as jax_csr
from dwarf_bench_tpu_torch.ops import csr_join

EMPTY = np.uint32(0xFFFFFFFF)
PROBES = ["probe", "probe_sorted", "probe_merge", "probe_merge_bitonic",
          "_probe_merge_bitonic"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _u(t):
    return t.numpy().view(np.uint32)


def _columns(rng, na, nb, distinct=700):
    """Wide uint32 keys (past any 2^14 window, 0 and 0xFFFFFFFE included)
    with duplicates, EMPTY padding rows on both sides; B hits and misses."""
    pool = rng.integers(1, 2**32 - 1, distinct, dtype=np.uint64)
    pool = pool.astype(np.uint32)
    pool[:2] = [0, 0xFFFFFFFE]
    a = rng.choice(pool, na)
    a[rng.integers(0, na, na // 50)] = EMPTY
    b = np.concatenate([rng.choice(pool, nb - nb // 3),
                        rng.integers(0, 2**32, nb // 3,
                                     dtype=np.uint64).astype(np.uint32)])
    b[rng.integers(0, nb, nb // 40)] = EMPTY
    rng.shuffle(b)
    return a, b


def _distinct(a):
    return len(np.unique(a[a != EMPTY]))


@pytest.mark.parametrize("na,extra_cap", [(5000, 0), (5000, 37), (1, 0),
                                          (70_001, 5)])
def test_build_matches_jax(rng, na, extra_cap):
    a, _ = _columns(rng, na, 10)
    d = max(_distinct(a), 1)
    cap, ht = d + extra_cap, 2 * d + 1
    jt = jax_csr.build(jnp.asarray(a), cap, ht)
    tt = csr_join.build(_t(a), cap, ht)
    assert np.array_equal(tt.pos.numpy(), np.asarray(jt.pos))
    assert np.array_equal(tt.counts.numpy(), np.asarray(jt.counts))
    assert np.array_equal(_u(tt.distinct_keys), np.asarray(jt.distinct_keys))
    assert int(tt.num_distinct) == int(jt.num_distinct)
    assert tt.num_distinct.dtype == torch.int32
    # the hash table is built from the same distinct keys
    assert np.array_equal(_u(tt.table.keys), np.asarray(jt.table.keys))
    assert np.array_equal(tt.table.payload[0].numpy(),
                          np.asarray(jt.table.payload[0]))
    assert int(tt.table.max_probe) == int(jt.table.max_probe)
    # ids: the same set under every key's view
    got, ref = _u(tt.id_buffer), np.asarray(jt.id_buffer)
    for p, c in zip(np.asarray(jt.pos)[:d], np.asarray(jt.counts)[:d]):
        assert set(got[p:p + c]) == set(ref[p:p + c])


def test_build_row_ids(rng):
    a, _ = _columns(rng, 3000, 10)
    d = _distinct(a)
    rid = rng.permutation(10**6)[:3000].astype(np.uint32)
    jt = jax_csr.build(jnp.asarray(a), d, 2 * d, row_ids=jnp.asarray(rid))
    tt = csr_join.build(_t(a), d, 2 * d, row_ids=_t(rid))
    got, ref = _u(tt.id_buffer), np.asarray(jt.id_buffer)
    for p, c in zip(np.asarray(jt.pos), np.asarray(jt.counts)):
        assert set(got[p:p + c]) == set(ref[p:p + c])


@pytest.mark.parametrize("extra_cap", [0, 11])
@pytest.mark.parametrize("name", PROBES)
def test_probes_match_jax_probe(rng, name, extra_cap):
    a, b = _columns(rng, 6000, 9000)
    d = _distinct(a)
    cap, ht = d + extra_cap, 2 * d
    jt = jax_csr.build(jnp.asarray(a), cap, ht)
    ref = jax_csr.probe(jt, jnp.asarray(b))
    res = getattr(csr_join, name)(csr_join.build(_t(a), cap, ht), _t(b))
    assert np.array_equal(res.found.numpy(), np.asarray(ref.found))
    assert np.array_equal(res.pos.numpy(), np.asarray(ref.pos))
    assert np.array_equal(res.counts.numpy(), np.asarray(ref.counts))
    assert res.pos.dtype == res.counts.dtype == torch.int32


def test_probe_merge_repairs_reference_faults():
    """Two inputs where the JAX ``probe_merge`` disagrees with the JAX
    ``probe``: an absent key 0 (found at position -1) and the largest key
    when distinct_cap leaves no EMPTY padding row (count 2^30 - pos). The
    port's probe_merge gives ``probe``'s answers on both (ROADMAP queue
    3)."""
    a = np.array([5, 5, 7], np.uint32)
    b = np.array([0, 5, 7, 3], np.uint32)
    jt = jax_csr.build(jnp.asarray(a), 2, 4)
    ref = jax_csr.probe(jt, jnp.asarray(b))
    bad = jax_csr.probe_merge(jt, jnp.asarray(b))
    assert list(np.asarray(bad.found)) == [True, True, True, False]
    assert int(bad.pos[0]) == -1 and int(bad.counts[2]) == (1 << 30) - 2
    tt = csr_join.build(_t(a), 2, 4)
    for name in PROBES:
        res = getattr(csr_join, name)(tt, _t(b))
        assert np.array_equal(res.found.numpy(), np.asarray(ref.found))
        assert np.array_equal(res.pos.numpy(), np.asarray(ref.pos))
        assert np.array_equal(res.counts.numpy(), np.asarray(ref.counts))


def test_join_id_sets_match_oracle(rng):
    a, b = _columns(rng, 2000, 1500, distinct=300)
    d = _distinct(a)
    tt = csr_join.build(_t(a), d, 2 * d)
    sets = csr_join.join_id_sets(tt, csr_join.probe_merge(tt, _t(b)))
    oracle = csr_join.oracle_id_sets(a, b)
    # EMPTY rows are padding: never a match on either side
    for s, o, k in zip(sets, oracle, b):
        assert s == (set() if k == EMPTY else {i for i in o
                                               if a[i] != EMPTY})
    jt = jax_csr.build(jnp.asarray(a), d, 2 * d)
    jsets = jax_csr.join_id_sets(jt, jax_csr.probe(jt, jnp.asarray(b)))
    assert sets == jsets
