"""The multi-chip dry run: one step of every distributed query the JAX
package's ``__graft_entry__.dryrun_multichip`` runs (__graft_entry__.py:46-197),
on a world of ranks, with its data and its oracle checks.

    python -m dwarf_bench_tpu_torch.dryrun [--world N] [--device cpu|gpu]
                                           [--rows_per_chip R]

On the card (the default) it spawns one NCCL rank a card, the world being
``torch.cuda.device_count()``; without CUDA it raises. ``--device cpu``
spawns a gloo world of N processes (default 4) on this host. Each rank
reads ``MASTER_ADDR`` and ``MASTER_PORT`` (``init_multihost``), which the
launcher sets to a free port of localhost.

The step: the hash-shuffle CSR join (general and dense), the ring join,
the dense and shuffle group-bys, the filter and the sample sort, the 1:1
join of materialised rows against the seq_join oracle, and on a world of 4
or more (even) the 2-D (dcn, ici) two-hop join and 2-D ring. Every rank
checks its own outputs; a failed check raises and the launcher exits 1.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from .common.datagen import make_unique_random
from .common.device import resolve_device
from .common.options import parse_device_type
from .ops.join import seq_join_oracle
from .parallel import (
    dist_csr_join,
    dist_csr_join_2d,
    dist_csr_join_ring,
    dist_csr_join_ring_2d,
    dist_filter,
    dist_groupby_dense,
    dist_groupby_shuffle,
    dist_hash_join_rows,
    dist_sort,
    init_multihost,
    make_mesh,
    make_mesh_2d,
    shard_rows,
)
from .parallel.collectives import all_gather, psum
from .parallel.mesh import ROW_AXIS


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def dryrun_multichip(n_devices: int, per_chip: int = 256) -> None:
    """One step of each distributed query on every rank of the world (all
    ranks call it, ``n_devices`` of them, after ``init_multihost``)."""
    mesh = make_mesh(n_devices)
    group = mesh.get_group(ROW_AXIS)
    me = mesh.get_local_rank(ROW_AXIS)
    n = n_devices * per_chip
    rng = np.random.default_rng(1)
    A = rng.integers(1, 500, n, endpoint=True).astype(np.uint32)
    B = rng.integers(1, 500, n, endpoint=True).astype(np.uint32)
    V = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    G = 64
    cap = per_chip  # generous per-destination capacity at small shapes

    # the hash-shuffle CSR join (all_to_all, local join, psum)
    join_fn = dist_csr_join(mesh, rows_per_chip=per_chip,
                            distinct_cap=n_devices * cap,
                            ht_size=2 * n_devices * cap,
                            shuffle_capacity=cap)
    da, db = shard_rows(mesh, A, B)
    _, _, total, overflow = join_fn(da, db)
    _check(int(overflow) == 0, "shuffle overflow")
    ca, cb = Counter(A.tolist()), Counter(B.tolist())
    expected = sum(ca[k] * cb.get(k, 0) for k in ca)
    _check(int(total) == expected,
           f"dist join total {int(total)} != oracle {expected}")

    # the dense engine (key span < 2^14)
    join_dense = dist_csr_join(mesh, rows_per_chip=per_chip,
                               distinct_cap=n_devices * cap,
                               ht_size=2 * n_devices * cap,
                               shuffle_capacity=cap, dense=True)
    _, _, total_d, ov_d = join_dense(da, db)
    _check(int(ov_d) == 0 and int(total_d) == expected, "dense dist join")

    # the ring join (no shuffle)
    join_ring = dist_csr_join_ring(mesh, rows_per_chip=per_chip,
                                   distinct_cap=per_chip,
                                   ht_size=2 * per_chip + 2)
    _, _, total_r = join_ring(da, db)
    _check(int(total_r) == expected, "ring join total")

    # the group-bys, both shapes
    keys = (A % G).astype(np.uint32)
    dk, dv = shard_rows(mesh, keys, V)
    dense = dist_groupby_dense(mesh, G)(dk, dv)
    part, ov2 = dist_groupby_shuffle(mesh, G, cap)(dk, dv)
    _check(int(ov2) == 0, "group-by shuffle overflow")
    _check(torch.equal(psum(part, group), dense),
           "dense vs shuffle group-by mismatch")
    oracle = np.zeros(G, np.uint32)
    np.add.at(oracle, keys.astype(np.int64), V)
    _check(np.array_equal(_u32(dense), oracle), "group-by vs oracle")

    # the filter and the sample sort
    out, cnt, off, total = dist_filter(mesh, 5000, per_chip)(
        shard_rows(mesh, A.astype(np.int32)))
    hits = A[A < 5000]
    _check(int(total) == hits.size, "filter total")
    c, o = int(cnt), int(off)
    _check(np.array_equal(_u32(out[:c]), hits[o:o + c]), "filter rows")

    out, valid, overflow = dist_sort(mesh, per_chip * 2)(shard_rows(mesh, A))
    _check(int(overflow) == 0, "sort overflow")
    counts = all_gather(valid, group).cpu().numpy()
    lo = int(counts[:me].sum())
    _check(np.array_equal(_u32(out[:int(valid)]),
                          np.sort(A)[lo:lo + int(valid)]),
           "dist sort mismatch")

    # the 1:1 join of materialised (key, a_val, b_val) rows
    ak = make_unique_random(n, seed=21)
    av = make_unique_random(n, seed=22)
    bk = make_unique_random(n, seed=23)
    bv = make_unique_random(n, seed=24)
    rows_fn = dist_hash_join_rows(mesh, shuffle_capacity=cap,
                                  ht_size=2 * n_devices * cap)
    k_o, a_o, b_o, cnt_o, ov_r = rows_fn(*shard_rows(mesh, ak, av, bk, bv))
    _check(int(ov_r) == 0, "rows join overflow")
    m = int(cnt_o)
    mine = list(zip(*(_u32(c[:m]).tolist() for c in (k_o, a_o, b_o))))
    everyone = [None] * n_devices
    dist.all_gather_object(everyone, mine, group=group)
    got = np.array(sorted(r for rows in everyone for r in rows),
                   dtype=np.uint64).reshape(-1, 3)
    _check(np.array_equal(got, seq_join_oracle(ak, av, bk, bv)),
           "dist rows join mismatch")

    # the 2-D (dcn, ici) mesh: the two-hop join and the 2-D ring
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_mesh_2d(2, n_devices // 2)
        j2 = dist_csr_join_2d(mesh2, rows_per_chip=per_chip,
                              distinct_cap=2 * cap, ht_size=4 * cap + 2,
                              cap_ici=cap, cap_dcn=cap)
        da2, db2 = shard_rows(mesh2, A, B)
        _, _, total_2d, ov_2d = j2(da2, db2)
        _check(int(ov_2d) == 0 and int(total_2d) == expected, "2-D join")
        r2 = dist_csr_join_ring_2d(mesh2, rows_per_chip=per_chip,
                                   distinct_cap=per_chip,
                                   ht_size=2 * per_chip + 2)
        _, _, total_r2 = r2(da2, db2)
        _check(int(total_r2) == expected, "2-D ring join total")


def _rank(rank: int, world: int, device: str, per_chip: int) -> None:
    init_multihost(num_processes=world, process_id=rank, device=device)
    try:
        dryrun_multichip(world, per_chip)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="gpu",
                        help="gpu (the default: one rank a card) or cpu")
    parser.add_argument("--world", type=int, default=None,
                        help="ranks (default: the cards; 4 on the CPU)")
    parser.add_argument("--rows_per_chip", type=int, default=256)
    args = parser.parse_args(argv)
    dev = resolve_device(parse_device_type(args.device))
    world = args.world
    if world is None:
        world = torch.cuda.device_count() if dev.type == "cuda" else 4
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(_free_port())
    torch.multiprocessing.start_processes(
        _rank, args=(world, args.device, args.rows_per_chip), nprocs=world,
        start_method="spawn")
    print(f"dryrun_multichip({world}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
