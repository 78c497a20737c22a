"""Multi-process runtime test of the port, the analog of
tests/test_multihost.py: two OS processes bring up the process group with
``init_multihost`` from ``env://`` (gloo, ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``), so the collectives cross real process
boundaries. Each process runs the same JAX-free program (``WORKER``): the
dense group-by over the 1-D mesh, the hash-shuffle join and the skew join
across the two processes, and the two-hop join over ``make_mesh_2d()``'s
default layout (one host: (1, 2)); each checks its own outputs against host
oracles and prints MULTIHOST_OK."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

# the worker imports torch and the port
pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from dwarf_bench_tpu_torch.parallel import (
    dist_csr_join, dist_csr_join_2d, dist_csr_join_skew, dist_groupby_dense,
    init_multihost, make_mesh, make_mesh_2d, shard_rows,
)

init_multihost(device="cpu")
nproc, pid = dist.get_world_size(), dist.get_rank()
assert nproc == 2, nproc
rng = np.random.default_rng(7)  # identical data in every process
per_chip = 2048
n = nproc * per_chip

mesh = make_mesh()
G = 64
keys = rng.integers(0, G, n).astype(np.uint32)
vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
out = dist_groupby_dense(mesh, G)(*shard_rows(mesh, keys, vals))
expected = np.zeros(G, np.uint32)
np.add.at(expected, keys.astype(np.int64), vals)
assert np.array_equal(out.numpy().view(np.uint32), expected), "group-by"

A = rng.integers(1, 2000, n, endpoint=True).astype(np.uint32)
B = rng.integers(1, 2000, n, endpoint=True).astype(np.uint32)
ca, cb = Counter(A.tolist()), Counter(B.tolist())
exp_total = sum(ca[k] * cb.get(k, 0) for k in ca)
cap = per_chip
join = dist_csr_join(mesh, rows_per_chip=per_chip, distinct_cap=nproc * cap,
                     ht_size=2 * nproc * cap + 2, shuffle_capacity=cap)
_, _, total, ov = join(*shard_rows(mesh, A, B))
assert int(ov) == 0 and int(total) == exp_total, (int(ov), int(total))

mesh2 = make_mesh_2d()
assert tuple(mesh2.shape) == (1, nproc), mesh2.shape
j2 = dist_csr_join_2d(mesh2, rows_per_chip=per_chip, distinct_cap=2 * cap,
                      ht_size=4 * cap + 2, cap_ici=cap, cap_dcn=nproc * cap)
_, _, total2, ov2 = j2(*shard_rows(mesh2, A, B))
assert int(ov2) == 0 and int(total2) == exp_total, "2-D join"

As = rng.integers(1, 5000, n, endpoint=True).astype(np.uint32)
Bs = rng.integers(1, 5000, n, endpoint=True).astype(np.uint32)
As[rng.random(n) < 0.5] = 7
Bs[rng.random(n) < 0.5] = 7
# one key holds half of both sides; slots at twice the light tail's
# expectation (512 rows a slot) overflow on the key's owner in the plain
# hash shuffle (its 1024 rows from each source) and not in the skew join
scap = per_chip // 2
sizes = dict(rows_per_chip=per_chip, distinct_cap=nproc * scap,
             ht_size=2 * nproc * scap + 2, shuffle_capacity=scap)
das, dbs = shard_rows(mesh, As, Bs)
ov_plain = dist_csr_join(mesh, **sizes)(das, dbs)[3].clone()
dist.all_reduce(ov_plain)
assert int(ov_plain) > 0, "the plain shuffle should overflow"
_, heavy, total_s, ov_s = dist_csr_join_skew(mesh, **sizes)(das, dbs)
assert int(ov_s) == 0, "skew overflow"
cas = np.bincount(As, minlength=5001).astype(np.uint64)
cbs = np.bincount(Bs, minlength=5001).astype(np.uint64)
assert int(total_s) == int(np.sum(cas * cbs)), "skew total"
lo = pid * per_chip
exp_heavy = np.where(Bs[lo:lo + per_chip] == 7, cas[7], 0)
assert exp_heavy.any()
assert np.array_equal(heavy.numpy().astype(np.uint64), exp_heavy)
dist.destroy_process_group()
print("MULTIHOST_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_world():
    nproc = 2
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            MASTER_ADDR="localhost",
            MASTER_PORT=str(port),
            RANK=str(rank),
            WORLD_SIZE=str(nproc),
            OMP_NUM_THREADS="1",
            PYTHONPATH=os.pathsep.join(
                [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep)
            ).strip(os.pathsep),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIHOST_OK" in out, out
