"""Port parity of the scaling harness and its model
(``dwarf_bench_tpu_torch/scripts/{scaling,scaling_model}.py``) against the
JAX package's ``scripts/benchmark_scaling.py`` and ``scripts/scaling_model.py``
on the CPU.

  * ``scaling.py`` on gloo worlds of 1 and 2 spawned processes at 2^10
    rows a chip (one module fixture): the JSON lines' keys are the JAX
    script's, and its joins and sort ran without overflow (a rank raises
    otherwise); the host arrays of every world equal the JAX script's own
    draws, captured from its ``shard_rows`` calls while its builders and
    timer are stubbed.
  * ``record_collectives`` on a gloo world of 8 (``scaling_model.tally_ops``
    at 2^14 rows a chip, one module fixture) against
    ``extract_collectives`` of the JAX builders compiled on conftest's 8
    virtual CPU devices at the same size: per kind, the same result-byte
    multisets, except where the port moves more by construction, each
    relation stated exactly (no tolerance: bytes are integers).
  * the model's compute term: the bench line's component rates by the JAX
    ``build_ops``' keys (its "sort" is the bench's radix), a line that no
    card wrote refused, and the world-of-one projection written apart.

The JAX ``scaling_model.py`` sets JAX_PLATFORMS, XLA_FLAGS and
``jax_platforms`` at import; conftest has set the same values already, so
loading it here changes nothing (checked below).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
from collections import Counter

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu_torch.scripts import scaling, scaling_model

REPO = pathlib.Path(__file__).resolve().parents[1]
R_SCALING = 1 << 10
R_TALLY = 1 << 14


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_model():
    before = (os.environ.get("JAX_PLATFORMS"), os.environ.get("XLA_FLAGS"),
              jax.config.jax_platforms, len(jax.devices()))
    mod = _load("scaling_model")
    after = (os.environ.get("JAX_PLATFORMS"), os.environ.get("XLA_FLAGS"),
             jax.config.jax_platforms, len(jax.devices()))
    assert before == after
    return mod


# -- scaling.py ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    """(JSON lines, results) of the port on gloo worlds 1 and 2."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = scaling.run(torch.device("cpu"), R_SCALING, 64, 0,
                              worlds=(1, 2))
    return [json.loads(x) for x in buf.getvalue().splitlines()], results


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's arrays (in its ``shard_rows`` call order) and JSON
    lines at R_SCALING on meshes 1, 2, 4, 8, its builders and timer
    stubbed (only its data and its lines are compared)."""
    import dwarf_bench_tpu.parallel as jpar
    import dwarf_bench_tpu.utils.timing as jtiming

    calls = []
    zero = np.zeros(1, np.int32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jpar, "shard_rows",
                   lambda mesh, *a: calls.append(a) or a)
        mp.setattr(jpar, "make_mesh", lambda n: n)
        mp.setattr(jpar, "dist_groupby_dense", lambda *a, **k: None)
        mp.setattr(jpar, "dist_filter", lambda *a, **k: None)
        mp.setattr(jpar, "dist_csr_join_ring", lambda *a, **k: None)
        mp.setattr(jpar, "dist_csr_join",
                   lambda *a, **k: lambda *x: (zero, zero, zero, zero))
        mp.setattr(jpar, "dist_sort",
                   lambda *a, **k: lambda *x: (zero, zero, zero))
        mp.setattr(jtiming, "time_amortized", lambda *a, **k: 1e-3)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert _load("benchmark_scaling").main(
                ["--rows_per_chip", str(R_SCALING)]) == 0
    finally:
        mp.undo()
    return calls, [json.loads(x) for x in buf.getvalue().splitlines()]


def test_scaling_draws_the_jax_scripts_data(jax_run):
    """Every mesh size's arrays, drawn from one default_rng(0) in the JAX
    script's order: (keys, vals), (A, B), (x,), (xs,) a mesh size."""
    calls, _ = jax_run
    rng = np.random.default_rng(0)
    assert len(calls) == 4 * len(scaling.CPU_WORLDS)
    for i, n_chips in enumerate(scaling.CPU_WORLDS):
        got = scaling.draw(rng, n_chips, R_SCALING, 64)
        exp = [a for c in calls[4 * i: 4 * i + 4] for a in c]
        assert len(exp) == len(scaling.ARRAYS)
        for name, e in zip(scaling.ARRAYS, exp):
            assert got[name].dtype == e.dtype
            assert np.array_equal(got[name], e), (n_chips, name)


def test_scaling_lines_have_the_jax_keys(port_run, jax_run):
    lines, _ = port_run
    _, jax_lines = jax_run
    port_ops = [x for x in lines if "chips" in x]
    jax_ops = [x for x in jax_lines if "chips" in x]
    assert [sorted(x) for x in port_ops] == [sorted(x) for x in
                                             jax_ops[:len(port_ops)]]
    assert [(x["op"], x["chips"], x["rows"]) for x in port_ops] == \
        [(x["op"], x["chips"], x["rows"]) for x in jax_ops[:len(port_ops)]]
    port_eff = [x for x in lines if "scaling_efficiency" in x]
    jax_eff = [x for x in jax_lines if "scaling_efficiency" in x]
    assert [x["op"] for x in port_eff] == [x["op"] for x in jax_eff]
    assert all(sorted(x) == ["op", "scaling_efficiency"] for x in port_eff)
    assert all(set(x["scaling_efficiency"]) == {"1", "2"} for x in port_eff)
    assert all(x["rows_per_s"] > 0 for x in port_ops)


def test_scaling_builder_sizes_are_the_jax_scripts():
    """cap = max(256, (R // n) * 4), as benchmark_scaling.py:72."""
    for n in (1, 2, 4, 8):
        for R in (1 << 10, 1 << 18, 1 << 20):
            assert scaling.join_capacity(n, R) == max(256, (R // n) * 4)


def test_scaling_results_per_world(port_run):
    """Both worlds timed every op (a rank raises on a shuffle or sort
    overflow, so the run's end means overflow 0); the CPU runs launch no
    kernel."""
    _, results = port_run
    for op in scaling.OPS:
        assert set(results[op]) == {1, 2}
        assert all(r["seconds"] > 0 for r in results[op].values())
    assert results["launches"] == {1: {}, 2: {}}


def test_scaling_on_the_card_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling.main(["--rows_per_chip", "1024"])


# -- record_collectives and scaling_model.py ----------------------------------

@pytest.fixture(scope="module")
def tally():
    return scaling_model.tally_ops(R_TALLY)


@pytest.fixture(scope="module")
def jax_tally(jax_model):
    return {name: jax_model.extract_collectives(
        fn.lower(*args).compile().as_text())
        for name, fn, args, _, _ in jax_model.build_ops(R_TALLY)}


def _bytes(colls, kind):
    return Counter(colls.get(kind, []))


def test_tally_has_the_jax_builders(tally, jax_tally):
    assert list(tally) == list(jax_tally)
    for name, op in tally.items():
        assert set(op["collectives"]) == set(jax_tally[name]), name


@pytest.mark.parametrize("name", ["dist_groupby_dense", "dist_sort",
                                  "dist_filter"])
def test_tally_equals_the_hlo(tally, jax_tally, name):
    """Where the port sends what the HLO sends: every kind's byte
    multiset is the same."""
    got = tally[name]["collectives"]
    exp = jax_tally[name]
    for kind in set(got) | set(exp):
        assert _bytes(got, kind) == _bytes(exp, kind), (name, kind)


def test_tally_shuffles_pack_their_columns(tally, jax_tally):
    """The port's exchange sends keys, payloads and per-slot counts in one
    (n, 1 + cols x capacity) int32 buffer; the HLO keeps the columns the
    program reads as separate all-to-alls of (n, capacity) and drops the
    rest. Dense join: each of the port's two (A, B) exchanges = two key
    columns' bytes (keys and row ids) + the counts (n x 4 bytes), against
    the HLO's two key all-to-alls; the shuffle group-by: one exchange =
    the HLO's keys + values + the counts."""
    n = scaling_model.N_DEV
    cap = 2 * R_TALLY // n
    col = n * cap * 4
    assert jax_tally["dist_csr_join_dense"]["all-to-all"] == [col, col]
    assert tally["dist_csr_join_dense"]["collectives"]["all-to-all"] == \
        [2 * col + 4 * n] * 2
    assert sorted(jax_tally["dist_groupby_shuffle"]["all-to-all"]) == \
        [col, col]
    assert tally["dist_groupby_shuffle"]["collectives"]["all-to-all"] == \
        [2 * col + 4 * n]
    for name in ("dist_csr_join_dense", "dist_csr_join_ring"):
        assert _bytes(tally[name]["collectives"], "all-reduce") == \
            _bytes(jax_tally[name], "all-reduce")


def test_tally_ring_hops(tally, jax_tally):
    """The ring moves its (chunk, counts) pair as one message a hop: n hops
    of 2 x 4R bytes. The HLO moves the two as separate permutes, and drops
    the last hop's chunk, which nothing reads: 2n - 1 permutes of 4R."""
    n = scaling_model.N_DEV
    chunk = 4 * R_TALLY
    assert jax_tally["dist_csr_join_ring"]["collective-permute"] == \
        [chunk] * (2 * n - 1)
    got = tally["dist_csr_join_ring"]["collectives"]["collective-permute"]
    assert got == [2 * chunk] * n
    assert sum(got) == sum(
        jax_tally["dist_csr_join_ring"]["collective-permute"]) + chunk


def test_model_functions_equal_the_jax_ones(jax_model, tally):
    """``wire_bytes_per_chip`` and ``project`` as the JAX script has them,
    given the JAX script's rates by its compute keys."""
    for kind in jax_model._COLLECTIVES:
        for n in (2, 8, 32, 256):
            for b in (4, 4096, 262176):
                assert scaling_model.wire_bytes_per_chip(kind, b, n) == \
                    jax_model.wire_bytes_per_chip(kind, b, n)
    rates = jax_model.SINGLE_CHIP_ROWS_PER_S
    for name, op in tally.items():
        for key in rates:
            for n in (8, 32, 256):
                args = (name, op["collectives"], key, R_TALLY, 7, n, 90e9)
                assert scaling_model.project(*args, rates) == \
                    jax_model.project(*args)


def test_model_without_compute_json_exits_2(tally, monkeypatch, capsys,
                                            tmp_path):
    """No built-in rates: without a bench line the tally is printed and the
    exit code is 2, with or without a world-of-one compute file."""
    monkeypatch.setattr(scaling_model, "tally_ops", lambda R: tally)
    for extra in ([], ["--compute_json", _compute(tmp_path)]):
        assert scaling_model.main(["--rows-per-chip", str(R_TALLY), "--out",
                                   str(tmp_path), *extra]) == 2
        out, err = capsys.readouterr()
        for name in tally:
            assert out.count(f"{name}: collectives=") == 1
        assert "no --bench_json" in err
        assert not (tmp_path / "scaling_model.json").exists()


def _compute(tmp_path, platform="gpu", rows=R_TALLY):
    path = tmp_path / "compute.json"
    path.write_text(json.dumps({
        "rows_per_chip": rows, "device": {"platform": platform,
                                          "kind": "a card", "count": 1},
        "card": "a card, 700.00 W",
        "rows_per_s": {op: 1e9 for op in scaling.OPS}}))
    return str(path)


# rows/s of the bench's components, as a card's line gives them
BENCH_RATES = {"radix": 58.6e9, "groupby": 290e9, "groupby_big": 38.2e9,
               "join": 3.18e9, "scan": 118e9}


def _bench(tmp_path, **change):
    from dwarf_bench_tpu_torch.bench import TIMING_METHOD

    line = {"metric": "query_ops_rows_per_s_geomean", "value": 1.0,
            "components_rows_per_s": dict(BENCH_RATES), "skipped": [],
            "timing_method": TIMING_METHOD,
            "device": "NVIDIA H100 80GB HBM3, 700.00 W"}
    line.update(change)
    path = tmp_path / "bench.json"
    # a file of the bench's stdout: its line last
    path.write_text("a line before it\n" + json.dumps(line) + "\n")
    return str(path)


def test_model_refuses_rates_not_of_a_card(tmp_path):
    with pytest.raises(ValueError, match="not a card"):
        scaling_model.load_compute(_compute(tmp_path, "cpu"), R_TALLY)
    with pytest.raises(ValueError, match="rows per chip"):
        scaling_model.load_compute(_compute(tmp_path, rows=1 << 20), R_TALLY)


@pytest.mark.parametrize("change,match", [
    ({"device": "cpu"}, "not a card"),
    ({"device": "nvidia-smi failed"}, "not a card"),
    ({"timing_method": "host-clock slope of 17 calls against 1 (CPU: no "
                       "device metric)"}, "timing method"),
    ({"skipped": ["join"]}, "component join"),
    ({"skipped": ["radix:RuntimeError"]}, "component radix"),
    ({"components_rows_per_s": {k: v for k, v in BENCH_RATES.items()
                                if k != "scan"}}, "component scan"),
])
def test_model_refuses_a_bench_line_no_card_wrote(tmp_path, change, match):
    """A bench line from the CPU, by another timer, or with a component
    the model needs skipped, raised or missing, is refused."""
    with pytest.raises(ValueError, match=match):
        scaling_model.load_bench(_bench(tmp_path, **change),
                                 scaling_model.COMPUTE_KEYS)


def test_model_reads_the_bench_line(tmp_path):
    """The rates by the JAX model's keys: its "sort" is the bench's radix;
    groupby_big, which no operator reads, may be skipped."""
    got = scaling_model.load_bench(
        _bench(tmp_path, skipped=["groupby_big", "hash2p24_extra"]),
        scaling_model.COMPUTE_KEYS)
    assert got["rows_per_s"] == {"join": 3.18e9, "groupby": 290e9,
                                 "sort": 58.6e9, "scan": 118e9}
    assert got["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_model_compute_keys_are_the_jax_ones(jax_model, tally):
    """Each operator's compute key is the JAX ``build_ops``' own (read from
    the JAX script, not copied), and each key's bench component is the one
    the JAX rates were taken from (BENCH_r04.json's components, within
    their rounding): "sort" is the radix."""
    jax_keys = {name: key for name, _, _, key, _ in
                jax_model.build_ops(R_TALLY)}
    assert {name: op["compute_key"] for name, op in tally.items()} == \
        jax_keys
    assert set(jax_model.SINGLE_CHIP_ROWS_PER_S) == \
        set(scaling_model.BENCH_COMPONENT)
    assert set(jax_keys.values()) == set(scaling_model.COMPUTE_KEYS)
    r04 = json.loads((REPO / "BENCH_r04.json").read_text())
    comps = r04["parsed"]["components_rows_per_s"]
    for key, rate in jax_model.SINGLE_CHIP_ROWS_PER_S.items():
        comp = comps[scaling_model.BENCH_COMPONENT[key]]
        assert abs(rate - comp) <= 0.005 * comp, (key, rate, comp)


def test_model_charges_the_bench_component(tally, tmp_path):
    """At 2^20 rows a GPU both joins are charged 2^20 / the bench's join
    rate, the sort 2^20 / its radix rate, as the JAX model charges them."""
    R = 1 << 20
    bench = scaling_model.load_bench(_bench(tmp_path),
                                     scaling_model.COMPUTE_KEYS)
    got = scaling_model.model(tally, bench, R)
    for name in ("dist_csr_join_dense", "dist_csr_join_ring"):
        entry = got["ops"][name]
        assert entry["compute_component"] == "join"
        assert entry["bench_component"] == "join"
        for p in entry["projection"].values():
            assert p["t_compute_ms"] == round(R / BENCH_RATES["join"] * 1e3,
                                              4)
    for p in got["ops"]["dist_sort"]["projection"].values():
        assert p["t_compute_ms"] == round(R / BENCH_RATES["radix"] * 1e3, 4)
    assert got["ops"]["dist_sort"]["bench_component"] == "radix"
    assert "projection_world_of_one" not in got["ops"]["dist_sort"]


def test_model_json(tally, monkeypatch, tmp_path, capsys):
    """With a bench line the model writes scaling_model.json into --out:
    six ops, projections at 8 (NVLink), 32 and 256 (InfiniBand), and the
    link figures with their sources; with a world-of-one file too, its
    projection is written apart, labelled, and the headline is unchanged."""
    monkeypatch.setattr(scaling_model, "tally_ops", lambda R: tally)
    assert scaling_model.main(["--rows-per-chip", str(R_TALLY),
                               "--bench_json", _bench(tmp_path),
                               "--out", str(tmp_path)]) == 0
    alone = json.loads((tmp_path / "scaling_model.json").read_text())
    assert "world_of_one" not in alone
    assert scaling_model.main(["--rows-per-chip", str(R_TALLY),
                               "--bench_json", _bench(tmp_path),
                               "--compute_json", _compute(tmp_path),
                               "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "scaling_model.json").read_text())
    assert got["B_NVLINK"] == 450e9 and got["B_IB"] == 50e9
    assert set(got["sources"]) == {"B_NVLINK", "B_IB"}
    assert got["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert "not the headline" in got["world_of_one"]["source"]
    assert list(got["ops"]) == list(tally)
    for name, entry in got["ops"].items():
        assert entry["collectives_8rank_result_bytes"] == \
            tally[name]["collectives"]
        assert entry["projection"] == alone["ops"][name]["projection"]
        assert entry["world_op"] in scaling.OPS
        for proj in ("projection", "projection_world_of_one"):
            links = {n: p["link"] for n, p in entry[proj].items()}
            assert links == {"8": "nvlink", "32": "ib", "256": "ib"}
            for p in entry[proj].values():
                assert p["eff_no_overlap_half_bw"] <= p["eff_no_overlap"] \
                    <= p["eff_no_overlap_2x_bw"] <= 1.0
        for p in entry["projection_world_of_one"].values():
            assert p["t_compute_ms"] == round(R_TALLY / 1e9 * 1e3, 4)
    out = capsys.readouterr().out
    assert "scaling_model.json" in out
    assert out.count("world of one: ") == 3 * len(tally)


def test_record_collectives_records_and_closes():
    """The open recorder notes every call, in order, and nothing after it
    closes; a second recorder cannot open inside it."""
    from dwarf_bench_tpu_torch.parallel import collectives

    t = torch.zeros((2, 3), dtype=torch.int32)
    with collectives.record_collectives() as calls:
        collectives._note("all-gather", t)
        collectives._note("all-reduce", t[0])
        with pytest.raises(RuntimeError, match="already open"):
            with collectives.record_collectives():
                pass
    collectives._note("all-reduce", t)
    assert calls == [("all-gather", 24), ("all-reduce", 12)]
    assert collectives._tally is None


def test_world_timer_follows_the_agreed_times():
    """time_amortized_world's slope is the agreed depths' (here a world
    whose slowest rank took 0 s at depth 4 and 1 s at depth 20), whatever
    this rank measured."""
    from dwarf_bench_tpu_torch.utils.timing import time_amortized_world

    calls = []
    slope = time_amortized_world(lambda x: calls.append(x), torch.zeros(1),
                                 agree=lambda v: [0.0, 1.0, v[2]], k=4)
    assert slope == 1.0 / 16
    assert len(calls) == 1 + 2 * 4 + 2 * 20


def test_model_refuses_the_results_directory():
    with pytest.raises(ValueError, match="results/ holds"):
        scaling_model.main(["--out", str(REPO / "results")])
