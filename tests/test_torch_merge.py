"""The bulk probe engine against the JAX package, exact: the bitonic merge
twin (ops/bitonic.py), the fill twin against ``merge_fill_pallas`` in
interpret mode, and ``merge_lookup`` / ``merge_lookup_bitonic`` /
``sort_table`` (ops/merge_lookup.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import merge_lookup as jml
from dwarf_bench_tpu.ops.bitonic import merge_bitonic as jax_merge_bitonic
from dwarf_bench_tpu.ops.merge_fill_pallas import merge_fill_pallas
from dwarf_bench_tpu_torch.ops import bitonic_cuda, merge_fill_cuda
from dwarf_bench_tpu_torch.ops import merge_lookup as tml

TAG = np.uint32(0x80000000)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _u32(x):
    return x.numpy().view(np.uint32)


def _bitonic_input(rng, n, ncols, key_hi, split=0.37):
    """A bitonic sequence under the (key, aux) order: ascending prefix,
    descending suffix, with ties in key (and in aux when aux_hi is small)."""
    keys = rng.integers(0, key_hi, n, dtype=np.uint64).astype(np.uint32)
    aux = rng.integers(0, 4, n).astype(np.uint32)  # ties in (key, aux) too
    a = int(n * split)
    o1 = np.lexsort((aux[:a], keys[:a]))
    o2 = np.lexsort((aux[a:], keys[a:]))[::-1]
    k = np.concatenate([keys[:a][o1], keys[a:][o2]])
    ax = np.concatenate([aux[:a][o1], aux[a:][o2]])
    pays = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(2)]
    return (k, ax, *pays)[:ncols]


@pytest.mark.parametrize("n,key_hi,ncols,num_cmp", [
    (1, 2**32, 2, 2), (2, 3, 2, 1), (8, 2**32, 4, 2), (1 << 10, 50, 3, 2),
    (1 << 10, 50, 4, 1), (1 << 12, 7, 2, 2), (1 << 16, 2**32, 2, 2),
    (1 << 16, 50, 3, 2), (1 << 16, 2**32, 4, 1),
])
def test_bitonic_twin_matches_jax(rng, n, key_hi, ncols, num_cmp):
    cols = _bitonic_input(rng, n, ncols, key_hi)
    ref = jax_merge_bitonic(tuple(jnp.asarray(c) for c in cols),
                            num_cmp=num_cmp)
    got = bitonic_cuda.merge_bitonic(tuple(_t(c) for c in cols),
                                     num_cmp=num_cmp)
    for g, r in zip(got, ref):
        assert np.array_equal(_u32(g), np.asarray(r))


def test_bitonic_same_network_on_any_input(rng):
    """The same pairs and tie rule give JAX's output even on input that is
    not bitonic (the network is the contract, not just the sorted order)."""
    cols = [rng.integers(0, 5, 256).astype(np.uint32) for _ in range(3)]
    ref = jax_merge_bitonic(tuple(jnp.asarray(c) for c in cols))
    got = bitonic_cuda.merge_bitonic(tuple(_t(c) for c in cols))
    for g, r in zip(got, ref):
        assert np.array_equal(_u32(g), np.asarray(r))


def test_bitonic_rejects_bad_shapes():
    with pytest.raises(ValueError):
        bitonic_cuda.merge_bitonic((_t([1, 2, 3]), _t([1, 2, 3])))
    with pytest.raises(ValueError):
        bitonic_cuda.merge_bitonic((_t([1, 2]),))
    with pytest.raises(ValueError):
        bitonic_cuda.merge_bitonic((_t([1, 2]),) * 2, num_cmp=3)


@pytest.mark.parametrize("ncols", [2, 3, 4])
@pytest.mark.parametrize("tile_bits", [None, 9, 10, 11, 12])
def test_merge_plan_covers_every_stride_once(ncols, tile_bits):
    """Every stride n/2 ... 1 in exactly one pass, highest first; strided
    passes keep a run of >= 32 rows below lo and fit the tile; the tile fits
    the shared memory the kernel assumes."""
    def plan_of(n):
        if tile_bits is None:
            return bitonic_cuda.merge_plan(n, ncols)
        return bitonic_cuda._tiled_plan(n, ncols, tile_bits)

    for m in range(27):
        plan = plan_of(1 << m)
        L = plan.tile_bits
        assert bitonic_cuda.MIN_TILE_BITS <= L <= bitonic_cuda.TILE_BITS
        assert ncols * 4 << L <= bitonic_cuda.MAX_SMEM_BYTES
        bits = [b for lo, hi in plan.passes for b in range(hi - 1, lo - 1, -1)]
        assert bits == list(range(m - 1, -1, -1))
        assert [hi for _, hi in plan.passes][0] == m
        *strided, last = plan.passes
        assert last == (0, min(m, L))
        for lo, hi in strided:
            w = hi - lo
            assert 1 <= w and lo >= 5 and lo >= L
            assert L - w >= 5  # the run: 32 or more consecutive rows
        # the fewest passes: each strided one as wide as the run allows
        width = L - 5
        assert len(strided) == max(0, -(-(m - L) // width))
    assert plan_of(0).passes == ()


def test_merge_plan_takes_three_passes_at_2p25():
    for ncols in (2, 3, 4):
        assert len(bitonic_cuda.merge_plan(1 << 25, ncols).passes) == 3
    with pytest.raises(ValueError):
        bitonic_cuda._tiled_plan(1 << 10, 2, 8)
    with pytest.raises(ValueError):
        bitonic_cuda._tiled_plan(1 << 10, 2, 13)
    with pytest.raises(ValueError):
        bitonic_cuda.merge_plan(1 << 10, 5)


def _tile_rows(n, tile_bits, lo, hi):
    """(tiles, rows) global row of each local index of each tile of the pass
    over stride bits [lo, hi), by csrc/bitonic.cu's ``tile_base`` and
    ``global_of``; a tile longer than n keeps its first n rows."""
    L = tile_bits
    run = 0 if lo == 0 else L - (hi - lo)
    j = torch.arange(min(1 << L, n), dtype=torch.int64)
    local = (j & ((1 << run) - 1)) | ((j >> run) << lo)
    t = torch.arange(max(n >> L, 1), dtype=torch.int64)
    low_bits = lo - run
    base = (((t & ((1 << low_bits) - 1)) << run)
            | ((t >> low_bits) << (lo + L - run)))
    return base[:, None] | local[None, :], run


def _tiled_schedule(cols, num_cmp, plan):
    """The kernel's schedule in plain PyTorch: gather each pass's tiles,
    run that pass's stages inside every tile (local bits [run, L) for a
    strided pass, [0, hi) for the last), highest first, scatter back."""
    n = cols[0].numel()
    vals = [c.to(torch.int64) & 0xFFFFFFFF for c in cols]  # unsigned order
    for lo, hi in plan.passes:
        rows, run = _tile_rows(n, plan.tile_bits, lo, hi)
        assert torch.equal(torch.sort(rows.flatten())[0], torch.arange(n))
        tiles = [v[rows] for v in vals]
        width = rows.shape[1]
        stage_bits = (range(hi - 1, -1, -1) if lo == 0
                      else range(plan.tile_bits - 1, run - 1, -1))
        for b in stage_bits:
            s = 1 << b
            shaped = [t.view(t.shape[0], width // (2 * s), 2, s) for t in tiles]
            k_lo, k_hi = shaped[0][:, :, 0], shaped[0][:, :, 1]
            swap = k_hi < k_lo
            if num_cmp == 2:
                a_lo, a_hi = shaped[1][:, :, 0], shaped[1][:, :, 1]
                swap |= (k_hi == k_lo) & (a_hi < a_lo)
            tiles = [torch.stack([torch.where(swap, t[:, :, 1], t[:, :, 0]),
                                  torch.where(swap, t[:, :, 0], t[:, :, 1])],
                                 2).view(t.shape[0], width) for t in shaped]
        for v, t in zip(vals, tiles):
            v[rows] = t
    return [v.to(torch.int32) for v in
            (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31) for v in vals)]


@pytest.mark.parametrize("tile_bits", [9, 10, 11, 12])
@pytest.mark.parametrize("m,ncols,num_cmp,bitonic", [
    (0, 2, 2, True), (3, 3, 1, True), (9, 2, 2, True), (11, 4, 2, True),
    (13, 2, 1, True), (14, 3, 2, True), (16, 2, 2, True), (16, 4, 1, True),
    (10, 3, 2, False), (16, 2, 2, False),
])
def test_tiled_schedule_matches_jax(rng, tile_bits, m, ncols, num_cmp,
                                    bitonic):
    """Small tiles force every pass kind (strided passes of 1 to L - 5
    bits, with and without a run wider than 32 rows, and a last pass that
    is one short tile or one of many); bitonic and arbitrary input."""
    n = 1 << m
    if bitonic:
        cols = _bitonic_input(rng, n, ncols, 40)
    else:
        cols = [rng.integers(0, 6, n).astype(np.uint32) for _ in range(ncols)]
    plan = bitonic_cuda._tiled_plan(n, ncols, tile_bits)
    ref = jax_merge_bitonic(tuple(jnp.asarray(c) for c in cols),
                            num_cmp=num_cmp)
    got = _tiled_schedule([_t(c) for c in cols], num_cmp, plan)
    for g, r in zip(got, ref):
        assert np.array_equal(_u32(g), np.asarray(r))


@pytest.mark.parametrize("m", range(16))
def test_tiled_schedule_of_the_default_plan_matches_jax(rng, m):
    """The plan the wrapper takes at every N = 2^m up to 2^15: one short
    tile, one full tile, then one strided pass before the last."""
    n, ncols = 1 << m, 2 + m % 3
    cols = _bitonic_input(rng, n, ncols, 1 << 12)
    ref = jax_merge_bitonic(tuple(jnp.asarray(c) for c in cols), num_cmp=2)
    got = _tiled_schedule([_t(c) for c in cols], 2,
                          bitonic_cuda.merge_plan(n, ncols))
    for g, r in zip(got, ref):
        assert np.array_equal(_u32(g), np.asarray(r))


@pytest.fixture(scope="module")
def merged_2p15():
    """The merged order of tests/test_bitonic_pallas.py's fill test:
    2^14 table rows, 2^14 queries (half hits, key 0 first)."""
    rng = np.random.default_rng(777)
    nt = nq = 1 << 14
    keys = np.sort(rng.choice(1 << 20, nt, replace=False).astype(np.uint32))
    keys[-3:] = [2**31, 2**32 - 2, 2**32 - 1]  # high keys and an EMPTY row
    vals = rng.integers(0, 1 << 32, nt, dtype=np.uint64).astype(np.uint32)
    q = np.concatenate([
        rng.permutation(keys[:-1])[: nq // 2],
        rng.integers(1 << 21, 1 << 22, nq - nq // 2).astype(np.uint32),
    ])
    q[:3] = [0, 2**32 - 1, 2**32 - 2]
    rng.shuffle(q)
    qi = np.arange(nq, dtype=np.uint32)
    order = np.lexsort((qi, q))
    dv = vals - np.roll(vals, 1)
    dv[0] = vals[0]
    ka = np.concatenate([keys, q[order][::-1]])
    aa = np.concatenate([dv & 0xFFFF, (TAG | qi[order])[::-1]])
    dvc = np.concatenate([dv, np.zeros(nq, np.uint32)])
    sk, sa, sdv = (np.asarray(x) for x in jax_merge_bitonic(
        (jnp.asarray(ka), jnp.asarray(aa), jnp.asarray(dvc))))
    return sk, sa, sdv, nq


@pytest.mark.parametrize("val16,memb", [(True, False), (False, False),
                                        (False, True)])
def test_fill_twin_matches_pallas(merged_2p15, val16, memb):
    sk, sa, sdv, nq = merged_2p15
    rdest, rval = merge_fill_pallas(
        jnp.asarray(sk), jnp.asarray(sa), jnp.asarray(sdv), nq,
        val16=val16, membership=memb, interpret=True)
    dest, val = merge_fill_cuda.merge_fill(
        _t(sk), _t(sa), _t(sdv), nq, val16=val16, membership=memb)
    assert np.array_equal(_u32(dest), np.asarray(rdest))
    assert np.array_equal(_u32(val), np.asarray(rval))
    # the last query rows of the order (nq cut) become non-real
    small = merge_fill_cuda.merge_fill(_t(sk), _t(sa), _t(sdv), 5,
                                       val16=val16, membership=memb)[0]
    assert int((small != -1).sum()) == 5


def _look_back_views(seed, p_prefix=0.3):
    """What a look-back reads of its predecessors: at the first read of a
    window, a predecessor is unpublished or torn one time in five each;
    from then on its aggregate, or with ``p_prefix`` its inclusive prefix,
    fixed for each (tile, predecessor)."""
    rng = np.random.default_rng(seed)
    final = {}

    def seen(tile, pred, attempt):
        if attempt == 0:
            r = rng.random()
            if r < 0.4:
                return "none" if r < 0.2 else "torn"
        if (tile, pred) not in final:
            final[tile, pred] = ("prefix" if rng.random() < p_prefix
                                 else "aggregate")
        return final[tile, pred]

    return seen


FILL_MODES = [(True, False), (False, False), (False, True)]


@pytest.fixture(scope="module")
def pallas_fill(merged_2p15):
    sk, sa, sdv, nq = merged_2p15
    return {(val16, memb): tuple(np.asarray(r) for r in merge_fill_pallas(
        jnp.asarray(sk), jnp.asarray(sa), jnp.asarray(sdv), nq, val16=val16,
        membership=memb, interpret=True)) for val16, memb in FILL_MODES}


@pytest.mark.parametrize("val16,memb", FILL_MODES)
@pytest.mark.parametrize("warps,vecs,lanes,window,views", [
    (16, 4, 32, 32, None),  # the kernel's tile, every predecessor a prefix
    (16, 4, 32, 32, 1),  # the kernel's tile and window
    (1, 1, 2, 4, 2),  # 8-row tiles
    (2, 1, 2, 32, 3),  # 16
    (1, 2, 4, 3, 4),  # 32
    (2, 2, 4, 32, 5),  # 64
])
def test_lookback_schedule_matches_pallas(merged_2p15, pallas_fill, val16,
                                          memb, warps, vecs, lanes, window,
                                          views):
    """The kernel's schedule (per-tile pair aggregates, the look-back's
    combine up to the nearest inclusive prefix, the in-tile exclusive scan)
    at small tiles, with predecessors unpublished, torn, aggregates or
    prefixes, equals the Pallas kernel bit for bit."""
    sk, sa, sdv, nq = merged_2p15
    seen = None if views is None else _look_back_views(views)
    dest, val, reads = merge_fill_cuda._lookback_fill(
        _t(sk), _t(sa), _t(sdv), nq, val16, memb, warps=warps, vecs=vecs,
        lanes=lanes, window=window, seen=seen)
    rdest, rval = pallas_fill[val16, memb]
    assert np.array_equal(_u32(dest), rdest)
    assert np.array_equal(_u32(val), rval)
    if views is not None and warps * vecs * lanes * 4 <= 64:  # many tiles
        assert reads["torn"] and reads["none"] and reads["aggregate"]


@pytest.mark.parametrize("mode", ["val32", "val16", "membership"])
@pytest.mark.parametrize("n", [0, 1, 7, 9, 15, 17, 63, 65, 1000, 4099])
def test_lookback_schedule_any_length(rng, n, mode):
    """Odd lengths fill the last 16-row tile with the identity; the
    schedule equals the plain twin."""
    sk = _t(rng.integers(0, 2**32, n, dtype=np.uint64))
    sk[: min(n, 2)] = -1  # EMPTY rows
    sa = _t(rng.integers(0, 2**32, n, dtype=np.uint64))
    dv = _t(rng.integers(0, 2**32, n, dtype=np.uint64))
    kw = dict(val16=mode == "val16", membership=mode == "membership")
    got = merge_fill_cuda._lookback_fill(
        sk, sa, dv, n // 2, **kw, warps=2, vecs=1, lanes=2, window=4,
        seen=_look_back_views(n))
    exp = merge_fill_cuda.merge_fill_plain(sk, sa, dv, n // 2, **kw)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


def test_lookback_rereads_torn_status_words(rng):
    """A predecessor whose two words carry different flags (the sum word of
    its prefix, the max word of its aggregate) is read again until they
    agree; taking the torn pair would mix a prefix's sum with an
    aggregate's max. Groups of three 8-row tiles: 8 table rows, then two
    tiles of queries for the last of them, so the second query tile finds
    its key only through the prefix of a tile with no table row (aggregate
    max 0)."""
    groups, tile = 13, 8
    keys = (100 * np.arange(groups)[:, None] + np.arange(3 * tile)).clip(
        max=100 * np.arange(groups)[:, None] + tile - 1)
    qidx = np.arange(groups * 2 * tile, dtype=np.uint32).reshape(groups, -1)
    aux = np.concatenate([rng.integers(0, 2**16, (groups, tile)),
                          TAG | qidx], 1)
    sk, sa = _t(keys.ravel()), _t(aux.ravel())
    n = sk.numel()
    torn_reads = 3

    def seen(tile, pred, attempt):
        if pred == tile - 1 and attempt < torn_reads:
            return "torn"
        return "aggregate" if pred else "prefix"

    exp = merge_fill_cuda.merge_fill_plain(sk, sa, None, n, val16=True)
    dest, val, reads = merge_fill_cuda._lookback_fill(
        sk, sa, None, n, val16=True, warps=1, vecs=1, lanes=2, window=4,
        seen=seen)
    assert torch.equal(dest, exp[0]) and torch.equal(val, exp[1])
    assert reads["torn"] == torn_reads * (n // 8 - 1)
    agg, inc = (5, 7), (105, 9)
    s, m = merge_fill_cuda._status_words("torn", agg, inc)
    assert s >> 32 != m >> 32 and (s & 0xFFFFFFFF, m & 0xFFFFFFFF) == (105, 7)


def test_fill_any_length():
    """The CUDA fill takes any N: the twin on an odd length equals the
    contract's scalar reference."""
    sk = np.array([3, 3, 5, 7, 7, 9, 0xFFFFFFFF], np.uint32)
    sa = np.array([10, TAG | 0, 20, TAG | 1, TAG | 2, 0, TAG | 3], np.uint32)
    dest, val = merge_fill_cuda.merge_fill(_t(sk), _t(sa), None, 4,
                                           val16=True)
    assert list(_u32(dest)) == [0xFFFFFFFF, 1, 0xFFFFFFFF, 2, 4, 0xFFFFFFFF,
                                6]
    assert list(_u32(val)) == [0, 10, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError):
        merge_fill_cuda.merge_fill(_t(sk), _t(sa), None, 4)  # no dv


def _queries(rng, keys, nq):
    q = np.concatenate([
        rng.permutation(keys)[: nq // 2],
        rng.integers(1 << 21, 1 << 22, nq - nq // 2).astype(np.uint32),
    ])
    q[: min(nq, 4)] = [0, 0xFFFFFFFF, 0, 5][: min(nq, 4)]  # edges, duplicates
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("nt,nq", [(1, 7), (1000, 3000), (5000, 5000)])
def test_merge_lookup_legacy(rng, nt, nq):
    keys = rng.choice(1 << 20, nt, replace=False).astype(np.uint32)
    keys[0] = 0
    vals = rng.integers(0, 2**32, nt, dtype=np.uint64).astype(np.uint32)
    q = _queries(rng, keys, nq)
    jsk, jsv = jml.sort_table(jnp.asarray(keys), jnp.asarray(vals))
    sk, sv = tml.sort_table(_t(keys), _t(vals))
    assert np.array_equal(_u32(sk), np.asarray(jsk))
    assert np.array_equal(_u32(sv), np.asarray(jsv))
    rf, rv = jml.merge_lookup(jsk, jsv, jnp.asarray(q))
    gf, gv = tml.merge_lookup(sk, sv, _t(q))
    assert np.array_equal(gf.numpy(), np.asarray(rf))
    assert np.array_equal(_u32(gv), np.asarray(rv))


@pytest.mark.parametrize("mode", ["val16", "val32", "membership"])
@pytest.mark.parametrize("compact_first", [False, True])
def test_merge_lookup_bitonic(rng, mode, compact_first):
    nt, nq = 3000, 5000
    keys = rng.choice(1 << 20, nt, replace=False).astype(np.uint32)
    keys[:2] = [0, 0xFFFFFFFF]  # key 0, and EMPTY (unfindable by contract)
    hi = 1 << 16 if mode == "val16" else 1 << 32
    vals = rng.integers(0, hi, nt, dtype=np.uint64).astype(np.uint32)
    q = _queries(rng, keys, nq)
    kw = dict(val_bits=16 if mode == "val16" else 32,
              membership=mode == "membership", compact_first=compact_first)
    jsk, jsv = jml.sort_table(jnp.asarray(keys), jnp.asarray(vals))
    rf, rv = jml.merge_lookup_bitonic(jsk, jsv, jnp.asarray(q), **kw)
    sk, sv = tml.sort_table(_t(keys), _t(vals))
    gf, gv = tml.merge_lookup_bitonic(sk, sv, _t(q), **kw)
    assert np.array_equal(gf.numpy(), np.asarray(rf))
    assert np.array_equal(_u32(gv), np.asarray(rv))
    d = dict(zip(keys.tolist(), vals.tolist()))
    d.pop(0xFFFFFFFF)
    assert np.array_equal(gf.numpy(), np.array([int(k) in d for k in q]))


def test_merge_lookup_bitonic_empty_and_single():
    sk, sv = tml.sort_table(_t([5]), _t([9]))
    f, v = tml.merge_lookup_bitonic(sk, sv, _t([]))
    assert f.shape == (0,) and v.shape == (0,)
    f, v = tml.merge_lookup_bitonic(sk, sv, _t([5]))
    assert f.tolist() == [True] and v.tolist() == [9]
