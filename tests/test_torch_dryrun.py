"""The multi-chip dry run (``python -m dwarf_bench_tpu_torch.dryrun``), the
port of ``__graft_entry__.dryrun_multichip``: on the CPU it spawns a gloo
world that runs every distributed query with the JAX dry run's data and
oracle checks; without ``--device`` it runs on the card and raises where
there is none."""

import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from dwarf_bench_tpu_torch import dryrun

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("world,rows", [(4, 256), (8, 64), (2, 256)])
def test_dryrun_on_a_gloo_world(world, rows):
    """Worlds of 4 and 8 run the 2-D (dcn, ici) joins too; 2 does not."""
    proc = subprocess.run(
        [sys.executable, "-m", "dwarf_bench_tpu_torch.dryrun", "--device",
         "cpu", "--world", str(world), "--rows_per_chip", str(rows)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"dryrun_multichip({world}) OK" in proc.stdout


def test_dryrun_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main([])


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_dryrun_in_process(world_of_one):
    dryrun.dryrun_multichip(1, 64)


def test_a_wrong_answer_fails_the_dryrun(world_of_one, monkeypatch):
    """A sort that returns its buffer reversed fails the sort's check."""
    real = dryrun.dist_sort

    def reversed_sort(mesh, capacity_per_chip):
        fn = real(mesh, capacity_per_chip)

        def local(x):
            out, valid, overflow = fn(x)
            return out.flip(0), valid, overflow

        return local

    monkeypatch.setattr(dryrun, "dist_sort", reversed_sort)
    with pytest.raises(AssertionError, match="dist sort mismatch"):
        dryrun.dryrun_multichip(1, 64)
