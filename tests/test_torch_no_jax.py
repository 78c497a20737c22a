"""dwarf_bench_tpu_torch and chip_smoke.py import no JAX, neither directly
nor through the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "dwarf_bench_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "dwarf_bench_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_import_loads_no_jax():
    pytest.importorskip("torch")  # the port imports torch
    code = (
        "import sys\n"
        "import dwarf_bench_tpu_torch, dwarf_bench_tpu_torch.cli\n"
        "import dwarf_bench_tpu_torch.ops.csr_join, chip_smoke\n"
        "import dwarf_bench_tpu_torch.ops.scan, dwarf_bench_tpu_torch.dwarfs.scan\n"
        "import dwarf_bench_tpu_torch.ops.cuckoo, dwarf_bench_tpu_torch.ops.join\n"
        "import dwarf_bench_tpu_torch.ops.bucket_hash, dwarf_bench_tpu_torch.ops.reduce\n"
        "import dwarf_bench_tpu_torch.dwarfs.hash_build, dwarf_bench_tpu_torch.dwarfs.probe\n"
        "import dwarf_bench_tpu_torch.dwarfs.reduce, dwarf_bench_tpu_torch.native\n"
        "import dwarf_bench_tpu_torch.ops.chunk_stats_cuda, dwarf_bench_tpu_torch.ops.probe_cuda\n"
        "import dwarf_bench_tpu_torch.ops.hist_cuda, dwarf_bench_tpu_torch.ops.groupby_cuda\n"
        "import dwarf_bench_tpu_torch.ops.scan_tail_cuda, dwarf_bench_tpu_torch.dwarfs.join\n"
        "import dwarf_bench_tpu_torch.api, dwarf_bench_tpu_torch.dwarfs.constant\n"
        "import dwarf_bench_tpu_torch.dwarfs.groupby, dwarf_bench_tpu_torch.ops.groupby\n"
        "import dwarf_bench_tpu_torch.ops.vadd_cuda, dwarf_bench_tpu_torch.ops.lock_add_cuda\n"
        "import dwarf_bench_tpu_torch.ops.measure_variants\n"
        "import dwarf_bench_tpu_torch.utils.kernel_times\n"
        "import dwarf_bench_tpu_torch.utils.timing, dwarf_bench_tpu_torch.utils.roofline\n"
        "import dwarf_bench_tpu_torch.bench, dwarf_bench_tpu_torch.entry\n"
        "import dwarf_bench_tpu_torch.parallel, dwarf_bench_tpu_torch.dryrun\n"
        "import dwarf_bench_tpu_torch.parallel.dist_join\n"
        "import dwarf_bench_tpu_torch.parallel.collectives\n"
        "import dwarf_bench_tpu_torch.examples.bench_usage\n"
        "import dwarf_bench_tpu_torch.examples.vadd, dwarf_bench_tpu_torch.examples.lock_add\n"
        "import dwarf_bench_tpu_torch.scripts.report, dwarf_bench_tpu_torch.scripts.sweeps\n"
        "import dwarf_bench_tpu_torch.scripts.hash_hit50, dwarf_bench_tpu_torch.scripts.release\n"
        "import dwarf_bench_tpu_torch.scripts.scaling, dwarf_bench_tpu_torch.scripts.scaling_model\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dwarf_bench_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
