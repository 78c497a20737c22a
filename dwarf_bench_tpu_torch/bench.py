"""Headline benchmark of dwarf_bench_tpu_torch: prints ONE JSON line
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}``.

    python -m dwarf_bench_tpu_torch.bench [--device=gpu|cpu]

The port of the JAX package's ``bench.py`` (bench.py:68-447), at its sizes
and on data drawn from ``np.random.default_rng(0)`` in its order. Five
components enter the geometric mean of rows/s (bench.py:376-382):

  * radix: ``sort.sort_host_dispatch(X)`` over 2^22 int32 in [1, 10000];
  * groupby: ``groupby.groupby_sum`` over 2^22 rows, G = 64;
  * groupby_big: the same over 2^20 rows, G = 2^16;
  * join: ``csr_join.build_dense`` + ``probe_dense(hi_rows=128)`` over 2^20
    x 2^20 keys in [1, 10000], ``id_buffer`` among the outputs, after the
    host check ``dense_applicable``;
  * scan: ``scan.filter_sparse(x, assume_sparse=True)`` over 2^24 rows,
    x < 5, after the host check ``sparse_caps_ok``.

Each component's call is checked once against a host oracle, then timed by
``utils.timing.time_device_looped_inplace``: the slope of CUDA-graph
replays of 17 calls against 1, so the host's dispatch is not in it. The
geomean (``value``) and ``components_rows_per_s`` take the cold reading, an
L2 eviction before each call, since every input but the scan's fits the
card's 50 MB L2 and would otherwise be read from there;
``components_rows_per_s_warm`` gives the reading without the eviction, and
``components_events_ms`` the CSV's per-call CUDA-event time of the same
call (``kernel_time``), which holds the host's dispatch.
``vs_baseline`` is the geomean over the geomean of 70 % of each
component's bandwidth roofline (``utils.roofline``), as in the JAX bench.

Three extras stay out of the geomean (bench.py:383-387): the filter kernel
at 2^20 and x < 5000 (selectivity 0.5); ``reduce_sum`` at 2^24 with its
share of the roofline; and the BASELINE config-#4 hash extra at 2^24 keys
(``BENCH_HASH_N`` overrides the size), whose builds are timed by ``timed``
and whose probes, which read back to the host, by ``time_amortized``.

Components run in order while ``BENCH_TIME_BUDGET_S`` (default 900 s) has
room; one that does not fit is listed in ``skipped``. One that raises is
listed there too, with its exception's name, and then the process exits 1
after printing the line (the JAX bench exits 0): a failure must not read as
a smaller geomean. It runs on the card; ``--device=cpu`` is the only way
onto the CPU (host-clock slopes there, no device metric).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from functools import partial
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from .common.device import resolve_device
from .common.options import parse_device_type
from .ops import bucket_hash, csr_join, cuckoo, filter_cuda, groupby, scan, sort
from .ops.reduce import reduce_oracle, reduce_sum
from .utils.kernel_times import card_line
from .utils.roofline import (
    ACHIEVABLE_ROWS_PER_S,
    BYTES_PER_ROW,
    device_bandwidth,
)
from .utils.timing import (
    kernel_time,
    time_amortized,
    time_device_looped_inplace,
    timed,
)

COMPONENTS = ("radix", "groupby", "groupby_big", "join", "scan")
# the JAX bench's sizes (rows a component or extra)
SIZES = {
    "radix": 1 << 22,
    "groupby": 1 << 22,
    "groupby_big": 1 << 20,
    "join": 1 << 20,
    "scan": 1 << 24,
    "scan_sel50_extra": 1 << 20,
    "reduce_extra": 1 << 24,
}
TIMING_METHOD = (
    "CUDA-graph replay slope (T_17 - T_1) / 16, min of 2 repeats, each call "
    "after an L2 eviction (256 MB written, half read back; the evictions' "
    "own slope subtracted); warm: the same without the eviction; host "
    "dispatch excluded"
)


class BenchMismatch(Exception):
    """A component's answer differs from its host oracle."""


class Case(NamedTuple):
    """A timed call ``fn(*args)`` over ``rows`` rows and the check of its
    output against a host oracle (raises BenchMismatch)."""

    fn: Callable
    args: tuple
    rows: int
    check: Callable[[Any], None]


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A 32-bit numpy column on ``device`` (uint32 as int32 bit patterns)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise BenchMismatch(what)


def radix_case(n: int, rng, device) -> Case:
    X = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)

    def check(out):
        _require(np.array_equal(_host(out), np.sort(X)),
                 "radix: the sorted column differs from np.sort")

    # the host range check picks the counting pipeline once (the JAX
    # bench's sort_host_dispatch); sort_auto would read the span back
    return Case(sort.sort_host_dispatch(X), (_put(X, device),), n, check)


def groupby_case(n: int, num_groups: int, rng, device) -> Case:
    K = rng.integers(0, num_groups, n).astype(np.uint32)
    V = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)

    def check(out):
        _require(np.array_equal(_host(out).view(np.uint32),
                                groupby.groupby_oracle(K, V, num_groups)),
                 f"groupby G={num_groups}: the sums differ from the oracle")

    fn = partial(groupby.groupby_sum, num_groups=num_groups,
                 vals_below_2p14=True)
    return Case(fn, (_put(K, device), _put(V, device)), n, check)


def join_fn(a: torch.Tensor, b: torch.Tensor):
    """The dense CSR join as the JAX bench times it: build, probe, and
    ``id_buffer`` among the outputs (the reference's build_id_buffer
    phase is part of the build)."""
    t = csr_join.build_dense(a)
    r = csr_join.probe_dense(t, b, hi_rows=128)
    return r.pos, r.counts, t.id_buffer


def join_views_ok(A: np.ndarray, B: np.ndarray, pos: np.ndarray,
                  counts: np.ndarray, id_buffer: np.ndarray) -> bool:
    """Whether each B row's view ``id_buffer[pos : pos + counts]`` is the
    set of A rows with its key (the id-set contract of
    ``csr_join.oracle_id_sets``), in O(n): ``id_buffer`` is a permutation
    of A's rows grouped by ascending key, and each view is its key's whole
    group."""
    A = np.asarray(A, np.int64)
    B = np.asarray(B, np.int64)
    ids = np.asarray(id_buffer, np.int64)
    if ids.shape != A.shape or not np.array_equal(np.sort(ids),
                                                  np.arange(A.size)):
        return False
    grouped = A[ids]
    if np.any(grouped[1:] < grouped[:-1]):
        return False
    keys, first, size = np.unique(grouped, return_index=True,
                                  return_counts=True)
    at = np.searchsorted(keys, B)
    hit = (at < keys.size) & (keys[np.minimum(at, keys.size - 1)] == B)
    at = np.minimum(at, keys.size - 1)
    exp_pos = np.where(hit, first[at], 0)
    exp_cnt = np.where(hit, size[at], 0)
    return (np.array_equal(np.asarray(counts, np.int64), exp_cnt)
            and np.array_equal(np.asarray(pos, np.int64), exp_pos))


def join_case(n: int, rng, device) -> Case:
    A = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    B = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    # keys span < 2^14, checked on the host as the reference sizes its table
    # (join_omnisci.cpp:55-58): the dense CSR index applies
    if not csr_join.dense_applicable(A, B):
        raise ValueError("join: keys do not fit the dense index")

    def check(out):
        pos, counts, id_buffer = (_host(t) for t in out)
        _require(join_views_ok(A, B, pos, counts, id_buffer),
                 "join: a probe row's id set differs from the oracle's")

    return Case(join_fn, (_put(A, device), _put(B, device)), n, check)


def scan_case(n: int, rng, device) -> Case:
    X = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    # the caps checked once on the host: the sparse pipeline then reads
    # nothing back from the card
    sparse = scan.sparse_caps_ok(X)
    fn = partial(scan.filter_sparse, assume_sparse=sparse)
    exp = scan.filter_oracle(X)

    def check(out):
        vals, count = out
        c = int(count)
        _require(c == exp.size and np.array_equal(_host(vals[:c]), exp),
                 "scan: the kept rows differ from filter_oracle")

    return Case(fn, (_put(X, device),), n, check)


def component_case(name: str, n: int, rng, device) -> Case:
    if name == "radix":
        return radix_case(n, rng, device)
    if name == "groupby":
        return groupby_case(n, 64, rng, device)
    if name == "groupby_big":
        # the BASELINE.json GroupBy config: 2^16 distinct keys
        return groupby_case(n, 1 << 16, rng, device)
    if name == "join":
        return join_case(n, rng, device)
    if name == "scan":
        return scan_case(n, rng, device)
    raise ValueError(f"unknown component {name!r}")


def _time(fn, *args, cold: bool = True) -> float:
    return time_device_looped_inplace(fn, *args, cold=cold)


def run_component(name: str, n: int, rng, device, extras: dict):
    """(cold rows/s, warm rows/s, per-call event seconds) of component
    ``name`` at ``n`` rows, after one call checked against its oracle. The
    per-call events are the CSV's ``kernel_time`` of the same call, host
    dispatch and all, beside the slopes. The join also writes its build and
    probe times (cold) into ``extras``."""
    case = component_case(name, n, rng, device)
    case.check(case.fn(*case.args))
    cold = _time(case.fn, *case.args)
    warm = _time(case.fn, *case.args, cold=False)
    events = kernel_time(case.fn, *case.args)
    if name == "join":
        # the reference reports the phases apart (join/join.cpp:111-113);
        # timed as separate calls, so they can sum past the whole
        a, b = case.args
        extras["join_build_ms"] = _time(csr_join.build_dense, a) * 1e3
        table = csr_join.build_dense(a)
        extras["join_probe_ms"] = _time(
            partial(csr_join.probe_dense, hi_rows=128), table, b) * 1e3
    return case.rows / cold, case.rows / warm, events


def run_scan_sel50_extra(n: int, rng, device, extras: dict) -> None:
    """BASELINE config #1 at its stated selectivity: x < 5000 over 2^20
    uniform [1, 10000] rows, a dense compaction (the ``filter`` kernel)."""
    X = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    x = _put(X, device)
    fn = partial(filter_cuda.filter, threshold=5000)
    vals, count = fn(x)
    exp = scan.filter_oracle(X, 5000)
    c = int(count)
    _require(c == exp.size and np.array_equal(_host(vals[:c]), exp),
             "scan_sel50: the kept rows differ from filter_oracle")
    t = _time(fn, x)
    extras["scan_sel50_rows_per_s"] = n / t
    extras["scan_sel50_ms"] = t * 1e3


def run_reduce_extra(n: int, rng, device, extras: dict, bw: float) -> None:
    """The read-bound witness (reduce/reduce.cpp:50-61): ``reduce_sum`` at
    2^24 rows, cold, and its share of the bandwidth roofline."""
    X = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    x = _put(X, device)
    _require(int(reduce_sum(x)) == reduce_oracle(X),
             "reduce: the sum differs from reduce_oracle")
    t = _time(reduce_sum, x)
    extras["reduce_rows_per_s"] = n / t
    extras["reduce_roofline_frac"] = (n / t) / (bw / BYTES_PER_ROW["reduce"])
    achievable = ACHIEVABLE_ROWS_PER_S.get("reduce")
    extras["reduce_frac_of_achievable"] = (
        None if achievable is None else (n / t) / achievable)


def run_hash2p24_extra(rng, device, extras: dict) -> None:
    """BASELINE config #4 at bench scale (bench.py:301-372): a slab build
    and ``find(val_bits=16)`` over 2^24 distinct keys and 2^24 probes at
    50 % hits, then a cuckoo build at 4n slots with the host re-seed loop
    and ``has``. Builds are single timed runs; the probes read back to the
    host, so the queue-k slope times them."""
    n = int(os.environ.get("BENCH_HASH_N", str(1 << 24)))
    keys = rng.permutation(2 * n)[:n].astype(np.uint32) + 1  # distinct
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    # half inserted keys, half absent ones (keys are <= 2n; these pass 4n)
    probes = np.empty(n, np.uint32)
    probes[: n // 2] = keys[: n // 2]
    probes[n // 2:] = (rng.integers(0, n, n // 2).astype(np.uint32)
                       + np.uint32(4 * n))
    dk, dv, dp = (_put(a, device) for a in (keys, vals, probes))
    order = np.argsort(keys)
    at = np.minimum(np.searchsorted(keys[order], probes), n - 1)
    exp_found = keys[order][at] == probes
    exp_val = np.where(exp_found, vals[order][at], 0).astype(np.uint32)

    nb = bucket_hash.calculate_buckets_count(n)
    build_fn = partial(bucket_hash.build, num_buckets=nb)
    tbl, _ = timed(build_fn, dk, dv)  # warm
    _, t_build = timed(build_fn, dk, dv)
    # values are [1, 10000]: val_bits=16 is host knowledge, as in radix
    probe_fn = partial(bucket_hash.find, val_bits=16)
    found, val = probe_fn(tbl, dp)
    _require(np.array_equal(_host(found), exp_found)
             and np.array_equal(_host(val).view(np.uint32)[exp_found],
                                exp_val[exp_found]),
             "slab find: differs from the sorted-keys oracle")
    t_probe = time_amortized(probe_fn, tbl, dp)
    extras["slab_build_2p24_ms"] = t_build * 1e3
    extras["slab_probe_hit50_2p24_ms"] = t_probe * 1e3
    extras["slab_probe_hit50_rows_per_s"] = n / t_probe

    # free the slab table before the 256 MB cuckoo build
    del tbl, found, val
    ht_size = 4 * n
    max_iters = 256  # rounds cap; the host re-seeds on non-convergence
    t0 = time.time()
    attempt = 0
    while True:  # host rebuild loop (cuckoo_hash_build.cpp:43-93)
        seeds = (0x9E3779B9 + attempt, 0x85EBCA6B + 2 * attempt)
        ct, _ = timed(cuckoo.build, dk, ht_size, *seeds, max_iters)
        if ct.success or attempt >= 4:
            break
        attempt += 1
    extras["cuckoo_build_2p24_ms"] = (time.time() - t0) * 1e3
    extras["cuckoo_build_2p24_rounds"] = int(ct.rounds)
    extras["cuckoo_build_2p24_attempts"] = attempt + 1
    extras["cuckoo_build_2p24_converged"] = bool(ct.success)
    _, t_warm = timed(cuckoo.build, dk, ht_size, *seeds, max_iters)
    extras["cuckoo_build_2p24_warm_ms"] = t_warm * 1e3
    _require(bool(ct.success)
             and np.array_equal(_host(cuckoo.has(ct, dp)), exp_found),
             "cuckoo has: differs from the sorted-keys oracle")
    t_has = time_amortized(cuckoo.has, ct, dp)
    extras["cuckoo_probe_hit50_2p24_ms"] = t_has * 1e3
    extras["cuckoo_probe_hit50_rows_per_s"] = n / t_has


def _nvcc_version():
    from .ops import _build

    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        return None
    proc = subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip().splitlines()[-1] if proc.returncode == 0 \
        else None


def geomean(values) -> float:
    values = list(values)
    if not values:
        return 0.0
    return float(np.exp(np.mean([np.log(v) for v in values])))


def run(device) -> tuple:
    """(the JSON line as a dict, whether a component or extra raised)."""
    rng = np.random.default_rng(0)
    bw = device_bandwidth(device)
    budget = float(os.environ.get("BENCH_TIME_BUDGET_S", "900"))
    t_start = time.time()
    measured: Dict[str, float] = {}
    warm: Dict[str, float] = {}
    events: Dict[str, float] = {}
    skipped = []
    extras: Dict[str, Any] = {}
    failed = False

    def attempt(name, min_budget, fn):
        nonlocal failed
        if budget - (time.time() - t_start) < min_budget:
            skipped.append(name)
            return
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - listed, then exit 1
            failed = True
            skipped.append(f"{name}:{type(e).__name__}")
            traceback.print_exc(file=sys.stderr)

    def component(name):
        def go():
            cold, warm[name], t = run_component(name, SIZES[name], rng,
                                                device, extras)
            measured[name] = cold
            events[name] = t * 1e3
        return go

    for name in COMPONENTS:
        attempt(name, 10, component(name))
    attempt("scan_sel50_extra", 10, lambda: run_scan_sel50_extra(
        SIZES["scan_sel50_extra"], rng, device, extras))
    attempt("reduce_extra", 10, lambda: run_reduce_extra(
        SIZES["reduce_extra"], rng, device, extras, bw))
    attempt("hash2p24_extra", 60, lambda: run_hash2p24_extra(
        rng, device, extras))

    target = {op: 0.7 * bw / BYTES_PER_ROW[op] for op in measured}
    geo = geomean(measured.values())
    vs = geo / geomean(target.values()) if measured else 0.0
    line = {
        "metric": "query_ops_rows_per_s_geomean",
        "value": geo,
        "unit": "rows/s",
        "vs_baseline": vs,
        "components_rows_per_s": measured,
        "components_rows_per_s_warm": warm,
        "components_events_ms": events,
        "components_roofline_frac": {
            op: v / (bw / BYTES_PER_ROW[op]) for op, v in measured.items()},
        "targets_rows_per_s": target,
        "frac_of_achievable": {
            op: v / ACHIEVABLE_ROWS_PER_S[op] for op, v in measured.items()
            if op in ACHIEVABLE_ROWS_PER_S},
        "skipped": skipped,
        "timing_method": TIMING_METHOD if device.type == "cuda" else
        "host-clock slope of 17 calls against 1 (CPU: no device metric)",
        "elapsed_s": time.time() - t_start,
        "device": card_line() if device.type == "cuda" else str(device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": _nvcc_version(),
        **extras,
    }
    return line, failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="gpu",
                        help="gpu (the default: the card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(parse_device_type(args.device))
    line, failed = run(device)
    print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
