"""The port's headline bench (``python -m dwarf_bench_tpu_torch.bench``) on
the CPU at small sizes: each component's timed call against the function
the JAX package's ``bench.py`` times, on the same numpy input (exact; the
join by its id sets, since the JAX pair sort is unstable), the data drawn
as the JAX bench draws it, every key of the JAX bench's line, and the exit
codes."""

import ast
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu.ops import bucket_hash as jax_bucket_hash
from dwarf_bench_tpu.ops import csr_join as jax_csr_join
from dwarf_bench_tpu.ops import cuckoo as jax_cuckoo
from dwarf_bench_tpu.ops import groupby as jax_groupby
from dwarf_bench_tpu.ops import reduce as jax_reduce
from dwarf_bench_tpu.ops import scan as jax_scan
from dwarf_bench_tpu.ops import sort as jax_sort
from dwarf_bench_tpu_torch import bench
from dwarf_bench_tpu_torch.ops import bucket_hash, csr_join, cuckoo, filter_cuda
from dwarf_bench_tpu_torch.ops.reduce import reduce_sum

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = {"radix": 1 << 14, "groupby": 1 << 14, "groupby_big": 1 << 13,
         "join": 1 << 12, "scan": 1 << 16, "scan_sel50_extra": 1 << 12,
         "reduce_extra": 1 << 14}


def _np(t):
    return t.numpy()


def _u32(t):
    return t.numpy().view(np.uint32)


def _id_sets(pos, counts, id_buffer):
    idb = np.asarray(id_buffer)
    return [set(idb[p: p + c].tolist())
            for p, c in zip(np.asarray(pos).tolist(),
                            np.asarray(counts).tolist())]


def test_radix_case_matches_jax():
    n = SMALL["radix"]
    case = bench.radix_case(n, np.random.default_rng(0), CPU)
    X = np.random.default_rng(0).integers(1, 10000, n,
                                          endpoint=True).astype(np.int32)
    assert np.array_equal(_np(case.args[0]), X)
    exp = np.asarray(jax_sort.sort_host_dispatch(X)(jnp.asarray(X)))
    assert np.array_equal(_np(case.fn(*case.args)), exp)


@pytest.mark.parametrize("name,groups", [("groupby", 64),
                                         ("groupby_big", 1 << 16)])
def test_groupby_cases_match_jax(name, groups):
    n = SMALL[name]
    case = bench.component_case(name, n, np.random.default_rng(0), CPU)
    rng = np.random.default_rng(0)
    K = rng.integers(0, groups, n).astype(np.uint32)
    V = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    assert np.array_equal(_u32(case.args[0]), K)
    assert np.array_equal(_u32(case.args[1]), V)
    exp = np.asarray(jax_groupby.groupby_sum(jnp.asarray(K), jnp.asarray(V),
                                             groups, vals_below_2p14=True))
    assert np.array_equal(_u32(case.fn(*case.args)), exp)


def test_join_case_matches_jax_by_id_sets():
    n = SMALL["join"]
    case = bench.join_case(n, np.random.default_rng(0), CPU)
    rng = np.random.default_rng(0)
    A = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    B = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    assert np.array_equal(_u32(case.args[0]), A)
    assert np.array_equal(_u32(case.args[1]), B)
    t = jax_csr_join.build_dense(jnp.asarray(A))
    r = jax_csr_join.probe_dense(t, jnp.asarray(B), hi_rows=128)
    pos, counts, id_buffer = case.fn(*case.args)
    assert np.array_equal(_np(counts), np.asarray(r.counts))
    assert _id_sets(_np(pos), _np(counts), _np(id_buffer)) == _id_sets(
        r.pos, r.counts, t.id_buffer)
    assert _id_sets(_np(pos), _np(counts), _np(id_buffer)) == \
        csr_join.oracle_id_sets(A, B)
    case.check((pos, counts, id_buffer))


def test_scan_case_matches_jax():
    n = SMALL["scan"]
    case = bench.scan_case(n, np.random.default_rng(0), CPU)
    X = np.random.default_rng(0).integers(1, 10000, n,
                                          endpoint=True).astype(np.int32)
    assert np.array_equal(_np(case.args[0]), X)
    assert case.fn.keywords == {"assume_sparse": True}
    out, count = case.fn(*case.args)
    jout, jcount = jax_scan.filter_sparse(jnp.asarray(X))
    c = int(jcount)
    assert int(count) == c and c > 0
    assert np.array_equal(_np(out[:c]), np.asarray(jout)[:c])


def test_extras_match_jax():
    """The filter at x < 5000 (the JAX bench's CPU path: filter_two_pass)
    and the sum (reduce_sum_xla), on the extras' draws."""
    rng = np.random.default_rng(0)
    X = rng.integers(1, 10000, SMALL["scan_sel50_extra"],
                     endpoint=True).astype(np.int32)
    out, count = filter_cuda.filter(torch.from_numpy(X), 5000)
    jout, jcount = jax_scan.filter_two_pass(jnp.asarray(X), 5000)
    c = int(jcount)
    assert int(count) == c and np.array_equal(_np(out[:c]),
                                              np.asarray(jout)[:c])
    X = rng.integers(1, 10000, SMALL["reduce_extra"],
                     endpoint=True).astype(np.int32)
    assert int(reduce_sum(torch.from_numpy(X))) == int(
        jax_reduce.reduce_sum_xla(jnp.asarray(X)))


def test_hash_extra_calls_match_jax():
    """The config-#4 extra's calls on its draws at 4096 keys: the slab
    build and 16-bit find, the cuckoo build with the bench's first seeds,
    and ``has``, against the JAX package's."""
    n = 4096
    rng = np.random.default_rng(0)
    keys = rng.permutation(2 * n)[:n].astype(np.uint32) + 1
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    probes = np.empty(n, np.uint32)
    probes[: n // 2] = keys[: n // 2]
    probes[n // 2:] = rng.integers(0, n, n // 2).astype(np.uint32) \
        + np.uint32(4 * n)
    dk, dv, dp = (torch.from_numpy(a.view(np.int32))
                  for a in (keys, vals, probes))
    nb = bucket_hash.calculate_buckets_count(n)
    found, val = bucket_hash.find(bucket_hash.build(dk, dv, num_buckets=nb),
                                  dp, val_bits=16)
    jt = jax_bucket_hash.build(jnp.asarray(keys), jnp.asarray(vals),
                               num_buckets=nb)
    jfound, jval = jax_bucket_hash.find(jt, jnp.asarray(probes), val_bits=16)
    assert np.array_equal(_np(found), np.asarray(jfound))
    hit = _np(found)
    assert np.array_equal(_u32(val)[hit], np.asarray(jval)[hit])
    seeds = (0x9E3779B9, 0x85EBCA6B)
    ct = cuckoo.build(dk, 4 * n, *seeds, 256)
    jct = jax_cuckoo.build(jnp.asarray(keys), 4 * n, np.uint32(seeds[0]),
                           np.uint32(seeds[1]), 256)
    assert ct.success and bool(jct.success)
    assert np.array_equal(_np(cuckoo.has(ct, dp)),
                          np.asarray(jax_cuckoo.has(jct, jnp.asarray(probes))))


@pytest.mark.parametrize("name", bench.COMPONENTS)
def test_components_check_and_time(name):
    extras = {}
    cold, warm, events = bench.run_component(
        name, SMALL[name], np.random.default_rng(0), CPU, extras)
    assert cold > 0 and warm > 0 and events > 0
    if name == "join":
        assert extras["join_build_ms"] > 0 and extras["join_probe_ms"] > 0


@pytest.mark.parametrize("name", bench.COMPONENTS)
def test_checks_catch_a_wrong_answer(name):
    case = bench.component_case(name, SMALL[name],
                                np.random.default_rng(0), CPU)
    out = case.fn(*case.args)
    case.check(out)
    if name == "join":
        pos, counts, id_buffer = out
        bad = (pos, counts, id_buffer.flip(0))
    elif name == "scan":
        bad = (out[0] + 1, out[1])
    else:
        bad = out.clone()
        bad[-1] += 1
    with pytest.raises(bench.BenchMismatch):
        case.check(bad)


@pytest.mark.parametrize("seed", range(4))
def test_join_views_ok_is_the_id_set_contract(seed):
    rng = np.random.default_rng(seed)
    A = rng.integers(1, 40, 300)
    B = rng.integers(0, 45, 200)
    t = csr_join.build_dense(torch.from_numpy(A.astype(np.int32)))
    r = csr_join.probe_dense(t, torch.from_numpy(B.astype(np.int32)))
    pos, counts, idb = _np(r.pos), _np(r.counts), _np(t.id_buffer)
    assert _id_sets(pos, counts, idb) == csr_join.oracle_id_sets(A, B)
    assert bench.join_views_ok(A, B, pos, counts, idb)
    # ids swapped across two keys, a count cut, a position moved
    swap = idb.copy()
    i = int(np.argmax(A[idb] != A[idb][0]))
    swap[[0, i]] = swap[[i, 0]]
    cut = counts.copy()
    cut[np.argmax(cut)] -= 1
    moved = pos.copy()
    moved[np.argmax(counts)] += 1
    for args in ((pos, counts, swap), (pos, cut, idb), (moved, counts, idb)):
        assert not bench.join_views_ok(A, B, *args)


def _root_bench_keys():
    """Every key of the line the root bench.py prints: the literal keys of
    the dict it dumps and every ``extras[...]`` it sets."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "extras"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"):
            keys |= {k.value for k in node.args[0].keys
                     if isinstance(k, ast.Constant)}
    return keys


@pytest.fixture
def small_bench(monkeypatch):
    monkeypatch.setattr(bench, "SIZES", dict(SMALL))
    monkeypatch.setenv("BENCH_HASH_N", "4096")


def test_line_carries_every_key_of_the_jax_bench(small_bench, capsys):
    assert bench.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    root = _root_bench_keys()
    assert len(root) >= 25 and {"metric", "value", "vs_baseline"} <= root
    assert root <= set(line), root - set(line)
    assert {"components_rows_per_s_warm", "components_events_ms", "torch",
            "cuda", "nvcc"} <= set(line)
    assert line["skipped"] == []
    assert set(line["components_rows_per_s"]) == set(bench.COMPONENTS)
    assert line["frac_of_achievable"] == {}
    assert line["reduce_frac_of_achievable"] is None
    assert line["device"] == "cpu" and line["value"] > 0
    assert line["cuckoo_build_2p24_converged"] is True


def test_a_raising_component_exits_1(small_bench, capsys, monkeypatch):
    def broken(*args):
        raise RuntimeError("no such luck")

    monkeypatch.setattr(bench, "radix_case", broken)
    assert bench.main(["--device=cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["skipped"] == ["radix:RuntimeError"]
    assert "radix" not in line["components_rows_per_s"]
    assert set(line["components_rows_per_s"]) == set(bench.COMPONENTS) - {
        "radix"}


def test_a_budget_skip_is_not_a_failure(small_bench, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_TIME_BUDGET_S", "0")
    assert bench.main(["--device=cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["skipped"] == [*bench.COMPONENTS, "scan_sel50_extra",
                               "reduce_extra", "hash2p24_extra"]
    assert line["value"] == 0.0


def test_without_cuda_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device=gpu"])
