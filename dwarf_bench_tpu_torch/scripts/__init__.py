"""The port of the JAX package's ``scripts/``: the sweep grids and their
runner (``sweeps``), the report (``report``), the 50 %-hit hash harness
(``hash_hit50``), the release packager (``release``), and the scaling
harness and its communication model (``scaling``, ``scaling_model``).

Each runs as ``python -m dwarf_bench_tpu_torch.scripts.<name>``, on the card
unless the caller asks for the CPU, and writes what it makes to an ``--out``
directory (never to the repository's ``results/``).
"""

import os

# the repository's results/: the JAX package's committed TPU artifacts
_RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results")


def check_out(path: str) -> str:
    """``path`` as an output directory; raises ValueError inside the
    repository's ``results/``, whose files are the JAX package's."""
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(_RESULTS)]) == \
            os.path.realpath(_RESULTS):
        raise ValueError(f"--out {path}: results/ holds the JAX package's "
                         "committed results; write elsewhere")
    return path
