"""The dense CSR join (``csr_join.build_dense`` + ``probe_dense(hi_rows=
128)``, the path the join cells run) against the benchmark's plain
reference (``benchmark/reference/join.py``: the sorted build keys and two
``searchsorted`` calls a probe key, and an independent check of
``id_buffer``) on the CPU: over a few seeds at 2^12 to 2^16 rows with keys
in [1, 10000], with EMPTY (-1) rows on either side, a single key, keys
spanning exactly 16383, and probe keys absent from the build side. The file
imports no JAX."""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dwarf_bench_tpu_torch.ops import csr_join, trace  # noqa: E402

REFERENCE = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
             / "reference" / "join.py")


def _reference():
    spec = importlib.util.spec_from_file_location("bm_reference_join",
                                                  REFERENCE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


reference = _reference()


def _join(a: torch.Tensor, b: torch.Tensor):
    t = csr_join.build_dense(a)
    r = csr_join.probe_dense(t, b, hi_rows=128)
    return r.found, r.pos, r.counts, t.id_buffer


def _check(a: torch.Tensor, b: torch.Tensor):
    """The port's outputs against the reference, field for field, and the
    reference's views against a per-key count of the build side."""
    found, pos, counts, id_buffer = _join(a, b)
    want = reference.expected(a, b, {})
    assert found.dtype == want[0].dtype == torch.bool
    assert pos.dtype == counts.dtype == want[1].dtype == torch.int32
    assert torch.equal(found, want[0])
    assert torch.equal(pos, want[1])
    assert torch.equal(counts, want[2])
    assert reference.id_buffer_faults(a, id_buffer) == (0, 0)
    # each found view is exactly its key's build rows
    keys = a.numpy()
    for i in np.flatnonzero(found.numpy())[:64]:
        view = id_buffer[pos[i]:pos[i] + counts[i]].numpy()
        assert set(view.tolist()) == set(
            np.flatnonzero(keys == int(b[i])).tolist())
    return found, pos, counts, id_buffer


def _uniform(seed: int, n: int, lo: int = 1, hi: int = 10000):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(lo, hi, n, endpoint=True)
                             .astype(np.int32)),
            torch.from_numpy(rng.integers(lo, hi, n, endpoint=True)
                             .astype(np.int32)))


@pytest.mark.parametrize("n", [1 << 12, 1 << 14, 1 << 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_join_matches_the_benchmark_reference(seed, n):
    a, b = _uniform(seed, n)
    before = trace.TAKEN["csr_join:dense"]
    found, *_ = _check(a, b)
    assert trace.TAKEN["csr_join:dense"] == before + 1
    assert bool(found.any())


def _with_empty(seed: int, n: int, side: str):
    a, b = _uniform(seed, n)
    rng = np.random.default_rng(seed + 100)
    for t in ((a,) if side == "build" else (b,) if side == "probe"
              else (a, b)):
        t[torch.from_numpy(rng.choice(n, n // 16, replace=False))] = -1
    return a, b


EDGES = {
    "empty_build_rows": lambda: _with_empty(3, 1 << 12, "build"),
    "empty_probe_rows": lambda: _with_empty(4, 1 << 12, "probe"),
    "empty_both_sides": lambda: _with_empty(5, 1 << 12, "both"),
    "single_key": lambda: (torch.full((4096,), 77, dtype=torch.int32),
                           torch.tensor([76, 77, 78, -1] * 1024,
                                        dtype=torch.int32)),
    "span_16383": lambda: _uniform(6, 1 << 14, 5, 5 + 16383),
    "span_16383_at_the_ends": lambda: (
        torch.tensor([5, 5 + 16383] * 2048, dtype=torch.int32),
        torch.tensor([5, 5 + 16383, 6, 4, 5 + 16384] * 800,
                     dtype=torch.int32)),
    "span_16383_across_2p31": lambda: _uniform(7, 1 << 12, 2**31 - 8000,
                                               2**31 - 8000 + 16383),
}


def _wrap(t: torch.Tensor) -> torch.Tensor:
    """int64 values to their int32 bit patterns."""
    return ((t.to(torch.int64) + 2**31) % 2**32 - 2**31).to(torch.int32)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_dense_join_edges_match_the_reference(case):
    a, b = EDGES[case]()
    a, b = _wrap(a), _wrap(b)
    found, pos, counts, _ = _check(a, b)
    # EMPTY probe rows are never found, and where not found both are 0
    assert not bool(found[b == -1].any())
    assert not bool(pos[~found].any()) and not bool(counts[~found].any())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("absent", ["below", "gap", "above"])
def test_probe_keys_absent_from_the_build_side(seed, absent):
    a, b = _uniform(seed, 1 << 13, 100, 9000)
    a = a[(a < 4000) | (a > 4100)]  # a gap of keys inside the range
    extra = {"below": (1, 99), "gap": (4000, 4100),
             "above": (9001, 10000)}[absent]
    rng = np.random.default_rng(seed + 7)
    idx = torch.from_numpy(rng.choice(b.numel(), 512, replace=False))
    b[idx] = torch.from_numpy(rng.integers(*extra, 512, endpoint=True)
                              .astype(np.int32))
    found, *_ = _check(a, b)
    assert not bool(found[idx].any())


def test_reference_views_by_hand():
    a = torch.tensor([7, 3, 7, -1, 9, 3, 7], dtype=torch.int32)
    b = torch.tensor([7, 4, 3, -1, 9, 10], dtype=torch.int32)
    found, pos, counts = reference.expected(a, b, {})
    assert found.tolist() == [True, False, True, False, True, False]
    assert pos.tolist() == [2, 0, 0, 0, 5, 0]
    assert counts.tolist() == [3, 0, 2, 0, 1, 0]


def test_control_fails_where_the_port_holds():
    a, b = _uniform(8, 1 << 14)
    got = _join(a, b)
    ctl = reference.control(a, b, {})
    assert [t.dtype for t in ctl] == [t.dtype for t in got]
    assert not torch.equal(ctl[1], got[1])
    assert reference.id_buffer_faults(a, ctl[3])[1] > 0
