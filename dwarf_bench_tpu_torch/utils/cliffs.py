"""The adaptive engines' dispatch cliffs at the sizes the benchmark runs, and
the cross-engine fuzz: the cases of the JAX package's
``tests/test_cliffs_slow.py`` and ``tests/test_engine_fuzz.py`` on the port,
each held to a host oracle.

The engines and their cliffs:

  * ``scan.filter_sparse``: the caps ``cap_single = max(16384, n >> 10)``,
    ``cap_mc = max(512, n >> 15)`` and ``cap_melems = max(4096, n >> 12)``
    on the counts of phase A and the tail, and the guard on thresholds
    within 512 of INT32_MIN (the window encoding would wrap). The sparse
    branch runs the kernels chunk_stats, cumsum, scan_tail_streams,
    compact_mask and emit_prefix; the general one, after phase A and the
    tail, the ``filter`` kernel.
  * ``csr_join.build_dense`` + ``probe_dense``: the table's ``packed_ok``
    (every count < 2^12 and n <= 2^20) and ``packed3_ok`` (bucket-relative
    offsets < 2^14, counts < 2^10), which pick the JAX probe's engine
    (packed3, packed, two gathers), over the count histogram (hi128).
  * ``sort.sort_auto``: the span read on the host: the counting sort
    (histogram, cumsum) with hi80 below 80·128, hi128 below 2^14, and
    ``torch.sort`` above.

``CASES`` holds every case of the two JAX files at their sizes, on their
data: ``default_rng(12345)``, their ``rng`` fixture, drawn anew for each
case as the fixture is (so the JAX fuzz's filter and join trials, which do
not use their trial number, draw the same input each time). Seven more
cases cross the cliffs exactly at 2^22 rows: each of the filter's caps at
the count it bounds (the sparse branch) and one below it (the general
one), and columns whose span is exactly 80·128 - 1, 80·128 and 2^14 - 1
(the sort's hi80 / hi128 switch and the last hi128 span).

``run(case, device)`` draws the inputs, calls the engine once and checks
the call against its host oracle: the filter's rows (``filter_oracle``),
the join's probe (found, counts and the start of each key's rows, by
``searchsorted``), its ``id_buffer`` (a permutation of the rows grouped by
key) and its flags (recomputed from the key counts), the sort's column
(``np.sort``). The
branch taken is read from ``ops.trace.TAKEN`` (the join's from its
flags) and must be the one the host predicts, which must be the branch
the case is there to cross, where it names one. The reads back to the
host are read from ``ops.trace.READS`` and must be those ``READS``
documents (``expected_reads``): the sort's span two, the checked filter's
caps one, none where the threshold lies within 512 of INT32_MIN or the
input is not int32, and none counted for the join. On the card the engine runs
a second time, timed by CUDA events, and every kernel of the branch must
have launched in the first call (``_build.LAUNCHES``).
``tests/test_torch_cliffs.py`` runs every case on the CPU beside the JAX
package; ``tests/test_torch_cliffs_gpu.py`` and ``chip_smoke.py``
(``phase_cliffs``) run them on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import _build, csr_join, scan, sort, trace

SEED = 12345  # the JAX tests' rng fixture (tests/conftest.py)

FILTER_N = 1 << 22
JOIN_N = 1 << 20
SORT_N = 1 << 22
SORT_BASE = 123456

# the kernels each branch must launch on the card
PHASE_A_TAIL = ("chunk_stats", "cumsum", "scan_tail_streams")
BRANCH_KERNELS = {
    "filter_sparse:sparse": PHASE_A_TAIL + ("compact_mask", "emit_prefix"),
    "filter_sparse:general": PHASE_A_TAIL + ("filter",),
    "sort_auto:hi80": ("histogram", "cumsum"),
    "sort_auto:hi128": ("histogram", "cumsum"),
    "sort_auto:torch.sort": (),
    "dense_join:packed3": ("histogram",),
    "dense_join:packed": ("histogram",),
    "dense_join:two-gather": ("histogram",),
}


class Case(NamedTuple):
    name: str
    engine: str  # "filter_sparse", "dense_join" or "sort_auto"
    # (a fresh default_rng(SEED), n) -> the engine's inputs
    make: Callable[[np.random.Generator, Optional[int]], dict]
    n: Optional[int] = None  # None: the case draws its size
    # the branch the case is there to cross, as the JAX test states it
    # (None: drawn, as in the fuzz)
    branch: Optional[str] = None


class Outcome(NamedTuple):
    name: str
    branch: str
    expected_branch: str
    count: int  # rows out: the filter's matches, the join's pairs, n
    exact: bool  # outputs and flags equal to the host oracle's
    why: str  # the first disagreement, "" when exact
    ms: Optional[float]  # one call's CUDA events (the card only)
    launched: Dict[str, int]
    missing: Tuple[str, ...]  # kernels of the branch not launched
    out: Any  # the engine's outputs (tensors on the device)
    reads: Dict[str, int]  # ``trace.READS`` of the call, by site
    expected_reads: Dict[str, int]

    @property
    def ok(self) -> bool:
        return self.exact and self.branch == self.expected_branch \
            and not self.missing and self.reads == self.expected_reads

    def line(self) -> str:
        ms = "not timed" if self.ms is None else f"{self.ms!r} ms"
        return (f"cliff {self.name}: branch {self.branch} (host predicts "
                f"{self.expected_branch}), count {self.count}, "
                f"{'exact' if self.exact else 'NOT EXACT: ' + self.why}, "
                f"{ms}, launched {self.launched}, reads {self.reads}"
                + (f", NOT LAUNCHED {list(self.missing)}" if self.missing
                   else "")
                + (f", READS EXPECTED {self.expected_reads}"
                   if self.reads != self.expected_reads else ""))


# -- the cases ----------------------------------------------------------------

def _filter(threshold: int, wide: bool = False):
    def make(rng, n):
        if wide:
            x = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
        else:
            x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
        return {"x": x, "threshold": threshold, "caps": {}}
    return make


def _filter_cap_boundary(cap: str, below: int):
    """Threshold 40 at n rows: every cap set to the count it bounds (the
    sparse branch holds), ``cap`` then ``below`` under it."""
    def make(rng, n):
        x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
        n_single, n_multi, n_melems = scan.sparse_counts(x, 40)
        caps = {"cap_single": n_single, "cap_mc": n_multi,
                "cap_melems": n_melems}
        caps[cap] -= below
        return {"x": x, "threshold": 40, "caps": caps}
    return make


def _join(hot_key: int = 0, hot_rows: int = 0):
    def make(rng, n):
        A = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
        if hot_rows:
            A[:hot_rows] = hot_key
        B = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
        return {"A": A, "B": B}
    return make


def _sort_span(span_edges: bool = False, wide: bool = False):
    def make(rng, n):
        if wide:
            return {"x": rng.integers(-(2**31), 2**31 - 1, n).astype(
                np.int32)}
        x = (SORT_BASE + rng.integers(0, (1 << 14) - 1, n)).astype(np.int32)
        if span_edges:  # span 2^14: one past the counting bound
            x[0] = SORT_BASE - 1
            x[1] = SORT_BASE + (1 << 14) - 1
        return {"x": x}
    return make


FUZZ_BITS = [1, 3, 8, 13, 14, 15, 16, 20, 24, 14, 13, 15]


def _sort_exact_span(span: int):
    """A column whose span is exactly ``span``."""
    def make(rng, n):
        x = (SORT_BASE + rng.integers(0, span + 1, n)).astype(np.int32)
        x[0], x[1] = SORT_BASE, SORT_BASE + span
        return {"x": x}
    return make


def _sort_fuzz(trial: int, n_hi: int):
    def make(rng, n):
        n = int(rng.integers(1, n_hi))
        lo = int(rng.integers(-(2**28), 2**28))
        span = int(rng.integers(1, 2**FUZZ_BITS[trial]))
        x = rng.integers(lo, lo + span, n, endpoint=True).astype(np.int32)
        return {"x": x}
    return make


def _sort_span_wrap(rng, n):
    return {"x": np.array([-(2**31), 2**31 - 1, 0, 5, -7], np.int32)}


def _filter_fuzz(rng, n):
    n = int(rng.integers(1, 80_000))
    hi = int(rng.integers(2, 20_000))
    thr = int(rng.integers(1, hi + 1))
    x = rng.integers(1, hi, n, endpoint=True).astype(np.int32)
    return {"x": x, "threshold": thr, "caps": {}}


def _join_fuzz(rng, n):
    n = int(rng.integers(2, 20_000))
    lo = int(rng.integers(0, 2**20))
    span = int(rng.integers(1, (1 << 14) - 1))
    A = (lo + rng.integers(0, span, n, endpoint=True)).astype(np.uint32)
    B = (lo + rng.integers(0, span, n, endpoint=True)).astype(np.uint32)
    return {"A": A, "B": B}


CASES: List[Case] = (
    # tests/test_cliffs_slow.py TestFilterSparseCliffs (n = 2^22): at 2^22
    # only x < 5 keeps every cap (cap_mc = 512 trips from x < 40 on)
    [Case(f"filter_2p22_x_lt_{t}", "filter_sparse", _filter(t), FILTER_N,
          "sparse" if t == 5 else "general")
     for t in (5, 40, 80, 200, 5000, 600)]
    + [Case("filter_2p22_thr_near_int32_min", "filter_sparse",
            _filter(-(2**31) + 100, wide=True), FILTER_N, "general")]
    # each cap at its count, then one below
    + [Case("filter_2p22_caps_at_counts", "filter_sparse",
            _filter_cap_boundary("cap_single", 0), FILTER_N, "sparse")]
    + [Case(f"filter_2p22_{cap}_one_below", "filter_sparse",
            _filter_cap_boundary(cap, 1), FILTER_N, "general")
       for cap in ("cap_single", "cap_mc", "cap_melems")]
    # TestDenseJoinEngineCliffs
    + [Case("join_packed3_2p20", "dense_join", _join(), JOIN_N, "packed3"),
       Case("join_two_gather_2p21", "dense_join", _join(), 1 << 21,
            "two-gather"),
       Case("join_hot_key_5000_rows_2p20", "dense_join", _join(777, 5000),
            JOIN_N, "two-gather"),
       Case("join_count_2000_2p20", "dense_join", _join(4242, 2000), JOIN_N,
            "packed")]
    # TestSortAutoSpanCliff
    + [Case("sort_narrow_span_2p22", "sort_auto", _sort_span(), SORT_N,
            "hi128"),
       Case("sort_span_2p14_2p22", "sort_auto", _sort_span(span_edges=True),
            SORT_N, "torch.sort"),
       Case("sort_across_the_sign_2p22", "sort_auto", _sort_span(wide=True),
            SORT_N, "torch.sort")]
    # the counting sort's switches, at their exact spans
    + [Case(f"sort_span_{s}_2p22", "sort_auto", _sort_exact_span(s), SORT_N,
            b) for s, b in ((80 * 128 - 1, "hi80"), (80 * 128, "hi128"),
                            ((1 << 14) - 1, "hi128"))]
    # tests/test_engine_fuzz.py
    + [Case(f"fuzz_sort_ranges_{t}", "sort_auto", _sort_fuzz(t, 60_000))
       for t in range(12)]
    + [Case(f"fuzz_sort_dispatch_{t}", "sort_auto", _sort_fuzz(t, 30_000))
       for t in range(12)]
    + [Case("fuzz_sort_span_wrap", "sort_auto", _sort_span_wrap,
            branch="torch.sort")]
    + [Case(f"fuzz_filter_{t}", "filter_sparse", _filter_fuzz)
       for t in range(10)]
    + [Case(f"fuzz_join_{t}", "dense_join", _join_fuzz) for t in range(8)]
)
BY_NAME = {c.name: c for c in CASES}


def inputs(case: Case) -> dict:
    """The case's inputs (numpy), drawn from a fresh default_rng(SEED)."""
    return case.make(np.random.default_rng(SEED), case.n)


# -- the host oracles -----------------------------------------------------------

def sort_branch(x: np.ndarray) -> str:
    """The branch ``sort_auto`` must take: by the column's span."""
    span = int(x.max()) - int(x.min())
    if span < sort._NARROW_BINS:
        return "hi80"
    return "hi128" if span < (1 << sort._RANGE_BITS) else "torch.sort"


def join_flags(A: np.ndarray) -> Dict[str, bool]:
    """``packed_ok`` and ``packed3_ok`` from the host's key counts, as
    ``build_dense`` defines them."""
    k = A.astype(np.int64) - int(A.min())
    counts = np.bincount(k, minlength=1 << 14)
    pos = np.cumsum(counts) - counts
    buckets = counts.reshape(128, 128).sum(axis=1)
    rel = pos - np.repeat(np.cumsum(buckets) - buckets, 128)
    n = A.shape[0]
    return {"packed_ok": bool(counts.max() < 4096 and n <= (1 << 20)),
            "packed3_ok": bool(rel.max() < (1 << 14)
                               and counts.max() < 1024 and n <= (1 << 24))}


def join_branch(flags: Dict[str, bool]) -> str:
    """The JAX probe's engine for a table with these flags
    (``dwarf_bench_tpu/ops/csr_join.py`` probe_dense's conds)."""
    if flags["packed3_ok"]:
        return "packed3"
    return "packed" if flags["packed_ok"] else "two-gather"


def check_join(A, B, found, counts, pos, id_buffer) -> str:
    """The first disagreement of a dense join's probe and ``id_buffer``
    with the host oracle, "" if none (the JAX test's ``_check_probe``)."""
    ak = np.sort(A.astype(np.int64))
    b = B.astype(np.int64)
    lo = np.searchsorted(ak, b, side="left")
    exp_cnt = np.searchsorted(ak, b, side="right") - lo
    if not np.array_equal(found, exp_cnt > 0):
        return "found"
    if not np.array_equal(counts[found], exp_cnt[found]):
        return "counts"
    if not np.array_equal(pos[found].astype(np.int64), lo[found]):
        return "pos"
    idb = id_buffer.astype(np.int64)
    if not np.array_equal(np.sort(idb), np.arange(A.shape[0])):
        return "id_buffer is not a permutation of the rows"
    gk = A[idb]
    if not np.all(gk[1:] >= gk[:-1]):
        return "id_buffer is not grouped by key"
    return ""


# -- the port's calls -----------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def call(case: Case, data: dict, device: torch.device):
    """The port's engine on ``data`` placed on ``device``: a function of no
    arguments (so the card can time a second call) returning its outputs."""
    if case.engine == "filter_sparse":
        x = torch.from_numpy(data["x"]).to(device)
        return lambda: scan.filter_sparse(x, data["threshold"],
                                          **data["caps"])
    if case.engine == "dense_join":
        a = torch.from_numpy(data["A"].view(np.int32)).to(device)
        b = torch.from_numpy(data["B"].view(np.int32)).to(device)

        def join():
            t = csr_join.build_dense(a)
            return t, csr_join.probe_dense(t, b)
        return join
    x = torch.from_numpy(data["x"]).to(device)
    return lambda: sort.sort_auto(x)


def judge(case: Case, data: dict, out) -> Tuple[str, str, int, str]:
    """(branch taken, branch the host predicts, count, first disagreement
    or "") of one call's outputs; the branch of the filter and the sort is
    filled in by ``run`` from ``trace.TAKEN``."""
    if case.engine == "filter_sparse":
        x, thr = data["x"], data["threshold"]
        got, count = out
        count = int(count)
        exp = scan.filter_oracle(x, thr)
        why = "" if count == len(exp) and np.array_equal(
            _host(got)[:count], exp) else \
            f"count {count} against {len(exp)}, or the rows"
        sparse = scan.sparse_caps_ok(x, thr, **data["caps"])
        return "", "sparse" if sparse else "general", count, why
    if case.engine == "dense_join":
        A, B = data["A"], data["B"]
        t, res = out
        flags = {"packed_ok": bool(t.packed_ok),
                 "packed3_ok": bool(t.packed3_ok)}
        exp_flags = join_flags(A)
        found = _host(res.found)
        counts = _host(res.counts)
        why = ""
        if not csr_join.dense_applicable(A, B):
            why = "dense_applicable is False"
        elif flags != exp_flags:
            why = f"flags {flags} against {exp_flags}"
        else:
            why = check_join(A, B, found, counts, _host(res.pos),
                             _host(t.id_buffer))
        return (join_branch(flags), join_branch(exp_flags),
                int(counts[found].sum()), why)
    x = data["x"]
    got = _host(out)
    why = "" if np.array_equal(got, np.sort(x)) else "the sorted column"
    return "", sort_branch(x), x.shape[0], why


def expected_reads(case: Case, data: dict) -> Dict[str, int]:
    """The reads back to the host one call of ``case`` makes, by
    ``trace.READS`` site, as that counter's docstring documents them."""
    if case.engine == "sort_auto":
        n = data["x"].shape[0]
        return {"sort_auto.max": 1, "sort_auto.min": 1} if n else {}
    if case.engine == "filter_sparse":
        x, thr = data["x"], int(data["threshold"])
        checked = x.dtype == np.int32 and x.shape[0] < (1 << 30) \
            and thr > -(2**31) + 512
        return {"filter_sparse.caps": 1} if checked else {}
    return {}


def run(case: Case, device: torch.device) -> Outcome:
    """One case on ``device``, checked against its host oracle (see the
    module's docstring)."""
    data = inputs(case)
    fn = call(case, data, device)
    launches_before = dict(_build.LAUNCHES)
    taken_before = dict(trace.TAKEN)
    reads_before = dict(trace.READS)
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launched = {k: v - launches_before[k] for k, v in _build.LAUNCHES.items()
                if v > launches_before[k]}
    taken = [k for k, v in trace.TAKEN.items()
             if v > taken_before.get(k, 0)]
    reads = {k: v - reads_before.get(k, 0) for k, v in trace.READS.items()
             if v > reads_before.get(k, 0)}
    branch, expected, count, why = judge(case, data, out)
    if case.branch is not None and expected != case.branch and not why:
        why = f"the host predicts {expected}, not the case's {case.branch}"
    if case.engine != "dense_join":
        branch = ",".join(k.split(":", 1)[1] for k in taken)
    ms = None
    missing: Tuple[str, ...] = ()
    if device.type == "cuda":
        missing = tuple(k for k in BRANCH_KERNELS.get(
            f"{case.engine}:{branch}", ()) if k not in launched)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    return Outcome(case.name, branch, expected, count, why == "", why, ms,
                   launched, missing, out, reads, expected_reads(case, data))
