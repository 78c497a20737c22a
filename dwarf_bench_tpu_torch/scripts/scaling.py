"""Scaling harness: the distributed group-by, CSR join, ring join, filter
and sample sort over worlds of 1 .. N ranks, the port of
``scripts/benchmark_scaling.py`` (BASELINE.json: rows/s scaling efficiency
of 80 % or more).

    python -m dwarf_bench_tpu_torch.scripts.scaling [--device gpu|cpu]
        [--rows_per_chip R] [--groups G] [--seed S]
        [--compute_json PATH]

A mesh of the port spans its world (``parallel.make_mesh``), so the launcher
starts one world for each mesh size, with its own port: on the card (the
default) NCCL worlds of 1, 2, 4 ... up to ``torch.cuda.device_count()``
ranks, one a card; with ``--device cpu`` gloo worlds of 1, 2, 4 and 8
spawned processes (one intra-op thread each), whose times are the host's,
not a card's. The launcher draws every host array from one
``default_rng(seed)`` in the JAX script's order across the mesh sizes
(``draw``), and each rank takes its ``shard_rows`` slice of them, so every
world sees the JAX script's data. The builders take the JAX script's
arguments; a join or sort that overflows its capacity raises.

Each call is timed on every rank by ``utils/timing.time_amortized_world(...,
k=4)``, the JAX script's ``time_amortized`` with the ranks agreeing on each
depth's time by ``all_reduce(MAX)``, so a world's time is its slowest
rank's; rows/s = rows / time. The launcher
prints the JAX script's JSON lines (``op``, ``chips``, ``rows``,
``rows_per_s``, and ``scaling_efficiency`` where more than one world ran).
``--compute_json`` writes the world of one's rows/s per op, beside the
device, its card line (``nvidia-smi`` name and power limit) and the kernel
launches of that world's rank: the compute term of ``scaling_model``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..common.device import resolve_device
from ..common.options import parse_device_type
from ..ops import _build
from ..ops.csr_join import dense_applicable
from ..parallel import (
    dist_csr_join,
    dist_csr_join_ring,
    dist_filter,
    dist_groupby_dense,
    dist_sort,
    init_multihost,
    make_mesh,
    shard_rows,
)
from ..utils.roofline import scaling_efficiency
from ..utils.timing import time_amortized_world

MESH_SIZES = (1, 2, 4, 8, 16, 32)
CPU_WORLDS = (1, 2, 4, 8)
# the JAX script's ops, in the order it prints them for a mesh size
OPS = ("dist_groupby", "dist_csr_join", "dist_filter", "dist_csr_join_ring",
       "dist_sort")
# the JAX script's result keys, in the order of its efficiency lines
RESULT_KEYS = {"dist_groupby": "groupby", "dist_csr_join": "join",
               "dist_csr_join_ring": "join_ring", "dist_filter": "filter",
               "dist_sort": "sort"}
ARRAYS = ("keys", "vals", "A", "B", "x", "xs")


def draw(rng, n_chips: int, rows_per_chip: int, groups: int) -> dict:
    """The host arrays of one mesh size, drawn from ``rng`` in the JAX
    script's order (benchmark_scaling.py:50-118)."""
    n = n_chips * rows_per_chip
    keys = rng.integers(0, groups, n).astype(np.uint32)
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    A = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    B = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    x = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    xs = rng.integers(1, 1 << 30, n).astype(np.uint32)
    return dict(keys=keys, vals=vals, A=A, B=B, x=x, xs=xs)


def join_capacity(n_chips: int, rows_per_chip: int) -> int:
    return max(256, (rows_per_chip // max(n_chips, 1)) * 4)


def _world_max(device: torch.device):
    """A function of floats that returns each one's largest value over the
    world."""
    def agree(values):
        t = torch.tensor(values, dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()
    return agree


def _require_zero(overflow: torch.Tensor, what: str) -> None:
    total = overflow.to(torch.int64).reshape(1).clone()
    dist.all_reduce(total)
    if int(total) != 0:
        raise RuntimeError(f"{what}: {int(total)} rows overflowed")


def _rank(rank: int, world: int, port: int, device: str, rows_per_chip: int,
          groups: int, dense: bool, data_dir: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", num_processes=world, process_id=rank,
                   device=device)
    try:
        R = rows_per_chip
        mesh = make_mesh(world)
        arrays = {k: np.load(os.path.join(data_dir, f"{k}.npy"),
                             mmap_mode="r") for k in ARRAYS}
        dk, dv = shard_rows(mesh, arrays["keys"], arrays["vals"])
        da, db = shard_rows(mesh, arrays["A"], arrays["B"])
        dx = shard_rows(mesh, arrays["x"])
        dxs = shard_rows(mesh, arrays["xs"])
        dev = dk.device
        agree = _world_max(dev)
        _build.reset_launches()
        cap = join_capacity(world, R)
        jfn = dist_csr_join(mesh, rows_per_chip=R, distinct_cap=world * cap,
                            ht_size=2 * world * cap, shuffle_capacity=cap,
                            dense=dense)
        _require_zero(jfn(da, db)[3], "dist_csr_join shuffle")
        sfn = dist_sort(mesh, R * 2)
        _require_zero(sfn(dxs)[2], "dist_sort partition")
        calls = {
            "dist_groupby": (dist_groupby_dense(mesh, groups), (dk, dv)),
            "dist_csr_join": (jfn, (da, db)),
            "dist_filter": (dist_filter(mesh, 5000, R), (dx,)),
            "dist_csr_join_ring": (dist_csr_join_ring(
                mesh, rows_per_chip=R, distinct_cap=R, ht_size=2 * R + 2,
                dense=dense), (da, db)),
            "dist_sort": (sfn, (dxs,)),
        }
        seconds = {op: time_amortized_world(fn, *args, agree=agree, k=4)
                   for op, (fn, args) in calls.items()}
        if rank == 0:
            with open(os.path.join(data_dir, "result.json"), "w") as f:
                json.dump({"seconds": seconds,
                           "launches": {k: v for k, v in
                                        _build.LAUNCHES.items() if v}}, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world: int, device: str, rows_per_chip: int, groups: int,
              arrays: dict) -> dict:
    """One world of ``world`` spawned ranks over ``arrays``; returns rank
    0's {"seconds": {op: s}, "launches": {...}}."""
    with tempfile.TemporaryDirectory() as data_dir:
        for k in ARRAYS:
            np.save(os.path.join(data_dir, f"{k}.npy"), arrays[k])
        torch.multiprocessing.start_processes(
            _rank, args=(world, free_port(), device, rows_per_chip, groups,
                         dense_applicable(arrays["A"], arrays["B"]),
                         data_dir),
            nprocs=world, start_method="spawn")
        with open(os.path.join(data_dir, "result.json")) as f:
            return json.load(f)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def worlds_for(dev: torch.device) -> tuple:
    if dev.type == "cpu":
        return CPU_WORLDS
    return tuple(n for n in MESH_SIZES if n <= torch.cuda.device_count())


def run(dev: torch.device, rows_per_chip: int, groups: int, seed: int,
        worlds=None) -> Dict[str, Dict[int, dict]]:
    """Every world in turn; prints the JSON lines and returns
    {op: {world: {"rows_per_s": ..., "seconds": ...}}} and, under
    "launches", {world: launches}."""
    device = "cpu" if dev.type == "cpu" else "gpu"
    worlds = tuple(worlds or worlds_for(dev))
    rng = np.random.default_rng(seed)
    results: Dict[str, Dict[int, dict]] = {op: {} for op in OPS}
    results["launches"] = {}
    # the JAX script draws every mesh size's arrays in turn from one rng
    for n_chips in worlds:
        arrays = draw(rng, n_chips, rows_per_chip, groups)
        got = run_world(n_chips, device, rows_per_chip, groups, arrays)
        n = n_chips * rows_per_chip
        for op in OPS:
            t = got["seconds"][op]
            results[op][n_chips] = {"rows_per_s": n / t, "seconds": t}
            print(json.dumps({"op": op, "chips": n_chips, "rows": n,
                              "rows_per_s": round(n / t)}), flush=True)
        results["launches"][n_chips] = got["launches"]
    for op in RESULT_KEYS:
        by_n = {n: r["rows_per_s"] for n, r in results[op].items()}
        if len(by_n) > 1:
            eff = scaling_efficiency(by_n)
            print(json.dumps({"op": RESULT_KEYS[op], "scaling_efficiency": {
                str(k): round(v, 3) for k, v in eff.items()}}), flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="gpu",
                   help="gpu (the default: NCCL, one rank a card) or cpu "
                        "(gloo worlds of spawned processes)")
    p.add_argument("--rows_per_chip", type=int, default=1 << 18)
    p.add_argument("--groups", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_json", default="",
                   help="write the world of one's rows/s per op here")
    args = p.parse_args(argv)
    dev = resolve_device(parse_device_type(args.device))
    results = run(dev, args.rows_per_chip, args.groups, args.seed)
    if args.compute_json:
        info = {"platform": "cpu", "kind": "cpu", "count": 0}
        card = None
        if dev.type == "cuda":
            info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count()}
            card = card_line()
        with open(args.compute_json, "w") as f:
            json.dump({"rows_per_chip": args.rows_per_chip,
                       "groups": args.groups, "seed": args.seed,
                       "device": info, "card": card,
                       "rows_per_s": {op: results[op][1]["rows_per_s"]
                                      for op in OPS},
                       "launches": results["launches"][1]}, f, indent=1)
        print(f"wrote {args.compute_json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
