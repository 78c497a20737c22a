"""The port's committed results (``results_torch/``, written on the card by
``results_torch/run.sh``) read on the CPU:

  * ``scripts/report.py`` lists every size of every grid of
    ``scripts/sweeps.py`` from its CSVs (the GPU half, one directory a
    grid), each size keeping all but its slowest iteration, and the 50 %-hit
    harness's one size; every CSV has the JAX package's header for the
    same file (``results/sweeps/``: ``device_type,buf_size_bytes,<header>``)
    and its ``.log`` beside it, with no ``FAILED`` line;
  * the bench line passes the scaling model's card check, and
    ``scaling_model.json`` holds the headline projection from it and the
    world-of-one projection beside it, labelled, for the six operators;
  * the README names the card as ``nvidia-smi`` gives it.
"""

from __future__ import annotations

import json
import pathlib

import pytest

pytest.importorskip("torch")

from dwarf_bench_tpu_torch.scripts import report, scaling_model, sweeps

REPO = pathlib.Path(__file__).resolve().parents[1]
RESULTS = REPO / "results_torch"
SWEEPS = RESULTS / "sweeps"
SCALING = RESULTS / "scaling"


def _reported(csv, capsys):
    """(device, buf_size_bytes, iterations kept) of each line of
    ``report.py``'s table."""
    assert report.main([str(csv)]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    return [(r.split()[0], int(r.split()[1]), int(r.split()[3]))
            for r in rows]


def _check_files(csv):
    jax_csv = REPO / "results" / "sweeps" / csv.name
    header = csv.read_text().splitlines()[0]
    assert header == jax_csv.read_text().splitlines()[0]
    assert header.startswith("device_type,buf_size_bytes,")
    log = csv.with_suffix(".log")
    assert log.exists()
    assert "FAILED" not in log.read_text()


@pytest.mark.parametrize("grid", sorted(sweeps.GRIDS))
def test_report_lists_every_size_of_the_grid(grid, capsys):
    g = sweeps.GRIDS[grid]
    for dwarf in g.dwarfs:
        csv = SWEEPS / grid / sweeps.csv_name(g, dwarf)
        _check_files(csv)
        assert _reported(csv, capsys) == [
            ("GPU", 4 * size, g.iterations - 1) for size in sorted(g.sizes)]


def test_report_lists_hash_hit50(capsys):
    """Config #4 at 50 % hits: 9 rows a phase (slab, cuckoo) at 2^24 keys,
    one size in the report."""
    csv = SWEEPS / "hash_hit50" / "report_hash_hit50.csv"
    _check_files(csv)
    assert _reported(csv, capsys) == [("GPU", 4 << 24, 17)]


def test_every_committed_csv_is_read():
    expected = {SWEEPS / grid / sweeps.csv_name(g, dwarf)
                for grid, g in sweeps.GRIDS.items() for dwarf in g.dwarfs}
    expected.add(SWEEPS / "hash_hit50" / "report_hash_hit50.csv")
    assert set(RESULTS.rglob("*.csv")) == expected


def test_bench_line_is_a_cards():
    bench = scaling_model.load_bench(str(SCALING / "bench.json"),
                                     scaling_model.COMPUTE_KEYS)
    assert set(bench["rows_per_s"]) == set(scaling_model.COMPUTE_KEYS)


def test_scaling_model_holds_both_projections():
    got = json.loads((SCALING / "scaling_model.json").read_text())
    bench = scaling_model.load_bench(str(SCALING / "bench.json"),
                                     scaling_model.COMPUTE_KEYS)
    assert got["rows_per_chip"] == 1 << 20
    assert got["device"] == bench["device"]
    assert got["single_gpu_rows_per_s"] == bench["rows_per_s"]
    assert "not the headline" in got["world_of_one"]["source"]
    assert list(got["ops"]) == ["dist_csr_join_dense", "dist_csr_join_ring",
                                "dist_groupby_shuffle", "dist_groupby_dense",
                                "dist_sort", "dist_filter"]
    for entry in got["ops"].values():
        rate = bench["rows_per_s"][entry["compute_component"]]
        for n in ("8", "32", "256"):
            assert entry["projection"][n]["t_compute_ms"] == \
                round((1 << 20) / rate * 1e3, 4)
            assert set(entry["projection_world_of_one"][n]) == \
                set(entry["projection"][n])


def test_readme_names_the_card():
    card = (RESULTS / "card.txt").read_text().strip()
    assert scaling_model._CARD_LINE.match(card)
    assert card in (RESULTS / "README.md").read_text()
