"""The benchmark of ``dwarf_bench_tpu_torch`` on an NVIDIA card.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell is
made of lives in a file found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``queries/<kind>.py`` with its
``reference/<kind>.py`` and ``work/<kind>.py``, and ``metrics/<name>.py``
for each per-layer metric. README.md says how to add one.
"""
