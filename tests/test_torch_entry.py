"""The port's flagship entry (``dwarf_bench_tpu_torch/entry.py``) against
the JAX package's ``__graft_entry__.entry()`` on the CPU: the same inputs,
``found`` and ``counts`` equal, and the same id set for every probe row
(the JAX pair sort is unstable)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

import __graft_entry__
from dwarf_bench_tpu_torch import entry as entry_mod
from dwarf_bench_tpu_torch.ops import csr_join

REPO = pathlib.Path(__file__).resolve().parents[1]


def _id_sets(pos, counts, id_buffer):
    idb = np.asarray(id_buffer)
    return [set(idb[p: p + c].tolist())
            for p, c in zip(np.asarray(pos).tolist(),
                            np.asarray(counts).tolist())]


def test_entry_matches_the_jax_entry():
    fn, (a, b) = entry_mod.entry("cpu")
    jfn, (ja, jb) = __graft_entry__.entry()
    assert np.array_equal(a.numpy().view(np.uint32), np.asarray(ja))
    assert np.array_equal(b.numpy().view(np.uint32), np.asarray(jb))
    found, pos, counts, id_buffer = fn(a, b)
    jfound, jpos, jcounts, jid = jfn(ja, jb)
    assert found.dtype == torch.bool and found.shape == (entry_mod.N,)
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    sets = _id_sets(pos.numpy(), counts.numpy(), id_buffer.numpy())
    assert sets == _id_sets(jpos, jcounts, jid)
    assert sets == csr_join.oracle_id_sets(np.asarray(ja), np.asarray(jb))


def test_entry_runs_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry_mod.entry()
    _, (a, b) = entry_mod.entry("cpu")
    assert a.device.type == "cpu" and b.device.type == "cpu"


def test_entry_main_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "dwarf_bench_tpu_torch.entry",
         "--device=cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "entry OK: [(4096,), (4096,), (4096,), (4096,)]" in proc.stdout
