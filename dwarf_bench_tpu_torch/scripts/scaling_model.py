"""Communication-cost model and projected multi-GPU scaling: the port of
``scripts/scaling_model.py``.

The host of the port's card has one H100, so no multi-GPU scaling can be
measured there; what can be produced is a per-operator model: the bytes
each collective of a distributed operator moves, a link rate, and the
card's own time for the operator's rows, giving projected efficiencies at
8, 32 and 256 GPUs.

  * **Bytes.** The JAX script reads them from the compiled HLO of its
    builders on an 8-device virtual mesh. The port has no HLO: every
    collective of ``parallel/`` goes through ``parallel/collectives.py``,
    and ``record_collectives`` tallies each call's kind and result bytes.
    ``build_ops`` runs the JAX script's six builders with its arguments,
    once, on a gloo world of 8 CPU processes: a byte count, which does not
    depend on the device (the card's host cannot hold an NCCL world of 8).
  * **Compute**, as in the JAX model: ``t_comp = rows_per_chip /
    rate[key]``, the rate the single-GPU bench's component ``key`` reached
    (``--bench_json``: the line ``python -m dwarf_bench_tpu_torch.bench``
    printed on the card; its cold ``components_rows_per_s``, the slope of
    CUDA-graph replays, with no host dispatch in it). The keys are the JAX
    ``build_ops``' (both joins ``join``, both group-bys ``groupby``, the
    sort ``sort``, the filter ``scan``), and ``BENCH_COMPONENT`` maps them
    onto the bench's names. As in the JAX model, each rate is the bench
    component's at its own size (radix and groupby 2^22 rows, join 2^20,
    scan 2^24), not at ``rows_per_chip``. A line that no card wrote (its
    ``device`` not an ``nvidia-smi`` card line, another timing method, or a
    needed component skipped or missing) is refused. Without
    ``--bench_json`` the model prints the byte tally and exits 2.
  * **World of one** (``--compute_json``, optional, never the headline):
    the rows/s that ``scaling.py --device gpu --compute_json PATH`` measured
    for the same operator on an NCCL world of one rank at the same rows per
    chip. That rate is a host-clock slope of queued calls, so it holds the
    host's dispatch as well as the card's time, and it varies between runs
    as host times do. Its projection is written beside the headline as
    ``projection_world_of_one``.
  * **Links** (model parameters from public figures, not measured here;
    the JSON carries a band of half and twice each): NVLink 4 within an
    8-GPU NVSwitch node and InfiniBand NDR across nodes. Up to 8 GPUs the
    bytes ride NVLink; beyond, every byte is charged to InfiniBand.

    python -m dwarf_bench_tpu_torch.scripts.scaling_model
        [--rows-per-chip 1048576] [--bench_json PATH] [--compute_json PATH]
        [--out DIR]

Writes ``<out>/scaling_model.json`` (never the repository's
``results/scaling_model.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..bench import TIMING_METHOD
from ..parallel import (
    dist_csr_join,
    dist_csr_join_ring,
    dist_filter,
    dist_groupby_dense,
    dist_groupby_shuffle,
    dist_sort,
    init_multihost,
    make_mesh,
    shard_rows,
)
from ..parallel.collectives import record_collectives
from . import check_out
from .scaling import free_port

# -- link rates: STATED MODEL PARAMETERS, public figures ---------------------
# NVLink 4 on the H100 SXM5: 18 links of 25 GB/s a direction, 450 GB/s a
# direction a GPU (900 GB/s both ways; NVIDIA H100 Tensor Core GPU data
# sheet), all-to-all within an 8-GPU NVSwitch node (DGX H100).
B_NVLINK = 450e9
NVLINK_DOMAIN = 8
# InfiniBand NDR: one 400 Gb/s ConnectX-7 port a GPU, 50 GB/s a direction
# (the DGX H100 node's eight compute-fabric ports), across nodes.
B_IB = 50e9
# each rate's band: the model is also given half and twice it
BAND = 2.0
SOURCES = {
    "B_NVLINK": "NVIDIA H100 data sheet, SXM5: NVLink 4, 18 links, 900 GB/s "
                "bidirectional a GPU; 8-GPU NVSwitch node (DGX H100)",
    "B_IB": "InfiniBand NDR, 400 Gb/s a port, one ConnectX-7 port a GPU "
            "(DGX H100 compute fabric)",
}

N_DEV = 8
PROJECT_TO = (8, 32, 256)

# The JAX model's compute keys are the single-chip bench's component names
# (its rates, scripts/scaling_model.py:60-67, are BENCH_r04.json's
# components), except its "sort": 9.13e9 (scripts/scaling_model.py:66) is
# the bench's "radix" (BENCH_r04.json: radix 9127132314).
BENCH_COMPONENT = {"join": "join", "groupby": "groupby",
                   "groupby_big": "groupby_big", "sort": "radix",
                   "scan": "scan"}
# the compute keys of build_ops' operators
COMPUTE_KEYS = ("join", "groupby", "sort", "scan")
# a card line as nvidia-smi --query-gpu=name,power.limit gives it
_CARD_LINE = re.compile(r"^\S.*, \d+(\.\d+)? W$")


def wire_bytes_per_chip(kind: str, result_bytes: int, n: int) -> float:
    """Bytes a single chip puts on the interconnect for ONE instance of
    the collective, as a function of chip count n (ring algorithms):

      all-to-all:        result is the per-chip buffer; (n-1)/n of it
                         crosses links. With the repo's capacity
                         convention (per-(src,dst) capacity ∝ R/n) the
                         buffer size is n-INDEPENDENT, so the 8-dev
                         extraction carries over.
      all-gather:        the 8-dev result holds 8 shards; at n chips the
                         gathered buffer is (n/8)x larger and a chip
                         receives (n-1)/n of it → result_bytes·(n-1)/8.
      all-reduce (psum): ring all-reduce moves 2·(n-1)/n of the buffer
                         (result shape is n-independent).
      reduce-scatter:    (n-1)/n of the input buffer.
      collective-permute:the whole buffer crosses one link per hop
                         (payload n-independent; hop count handled by the
                         caller).
    """
    f = (n - 1) / n
    if kind == "all-to-all":
        return result_bytes * f
    if kind == "all-gather":
        return result_bytes * (n - 1) / 8
    if kind == "all-reduce":
        return 2 * result_bytes * f
    if kind == "reduce-scatter":
        return result_bytes * f
    if kind == "collective-permute":
        return result_bytes
    return result_bytes


def build_ops(mesh, rows_per_chip: int):
    """(name, fn, args, compute_key, world_op, hops) for each distributed
    operator of the JAX script (scaling_model.py:150-191), with its
    arguments, on this rank's shard of its data. ``compute_key`` is the JAX
    script's compute key (``BENCH_COMPONENT`` names the bench component it
    reads); ``world_op`` names the ``scaling.py`` operator whose world-of-one
    rows/s is the labelled second projection. ``hops`` is 1 for the ring
    join too: the tally holds each of the port's 8 hops as an instance,
    where the JAX HLO holds one loop body (hops 7). ``project`` charges
    each instance (n - 1) / 7 times, so the port's ring is charged
    8 (n - 1) / 7 hops at n chips where it makes n: exact at 8, 31/28 of
    its bytes at 32 and 255/224 at 256."""
    R = rows_per_chip
    rng = np.random.default_rng(0)
    n = N_DEV * R
    keys = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    vals = rng.integers(1, 10000, n, endpoint=True).astype(np.uint32)
    ints = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    gkeys = rng.integers(0, 64, n).astype(np.uint32)
    keys, vals, ints, gkeys = shard_rows(mesh, keys, vals, ints, gkeys)

    cap = 2 * R // N_DEV  # per-(src,dst) shuffle capacity: 2x balanced
    return [
        ("dist_csr_join_dense",
         dist_csr_join(mesh, R, 16384, 65536, cap, dense=True),
         (keys, keys), "join", "dist_csr_join", 1),
        ("dist_csr_join_ring", dist_csr_join_ring(mesh, R, 16384, 65536),
         (keys, keys), "join", "dist_csr_join_ring", 1),
        ("dist_groupby_shuffle", dist_groupby_shuffle(mesh, 64, cap),
         (gkeys, vals), "groupby", "dist_groupby", 1),
        ("dist_groupby_dense", dist_groupby_dense(mesh, 64), (gkeys, vals),
         "groupby", "dist_groupby", 1),
        ("dist_sort", dist_sort(mesh, cap), (ints,), "sort", "dist_sort", 1),
        ("dist_filter", dist_filter(mesh, 5000, R), (ints,), "scan",
         "dist_filter", 1),
    ]


def _tally_rank(rank: int, port: int, rows_per_chip: int,
                out_path: str) -> None:
    torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", num_processes=N_DEV,
                   process_id=rank, device="cpu")
    try:
        ops = {}
        for name, fn, args, key, world_op, hops in build_ops(
                make_mesh(N_DEV), rows_per_chip):
            with record_collectives() as calls:
                fn(*args)
            colls = {}
            for kind, nbytes in calls:
                colls.setdefault(kind, []).append(nbytes)
            ops[name] = {"collectives": colls, "compute_key": key,
                         "world_op": world_op, "hops": hops}
        every = [None] * N_DEV
        dist.all_gather_object(every, ops)
        if any(o != ops for o in every):
            raise RuntimeError("the ranks' collective tallies differ")
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(ops, f)
    finally:
        dist.destroy_process_group()


def tally_ops(rows_per_chip: int) -> dict:
    """{name: {"collectives": {kind: [result bytes of each call]},
    "compute_key": ..., "world_op": ..., "hops": ...}} of ``build_ops`` on a
    gloo world of 8 spawned CPU processes (rank 0's; every rank's must be
    the same)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "tally.json")
        torch.multiprocessing.start_processes(
            _tally_rank, args=(free_port(), rows_per_chip, out_path),
            nprocs=N_DEV, start_method="spawn")
        with open(out_path) as f:
            return json.load(f)


def project(name, colls, compute_key, rows_per_chip, hops, n_chips, bw,
            rates):
    """Projected efficiency at n_chips: T_comp / (T_comp + T_comm) with
    no overlap (pessimistic) and max(T_comp, T_comm) (full overlap).
    ``rates``: the card's rows/s by ``compute_key``."""
    t_comp = rows_per_chip / rates[compute_key]
    total_wire = 0.0
    for kind, instances in colls.items():
        for b in instances:
            w = wire_bytes_per_chip(kind, b, n_chips)
            if kind == "collective-permute":
                w *= hops * (n_chips - 1) / 7  # hops scale with n
            total_wire += w
    t_comm = total_wire / bw
    eff_serial = t_comp / (t_comp + t_comm)
    eff_overlap = t_comp / max(t_comp, t_comm)
    return t_comp, t_comm, eff_serial, eff_overlap


def load_bench(path: str, keys) -> dict:
    """The card's rows/s by compute key (``BENCH_COMPONENT``) from the
    line ``python -m dwarf_bench_tpu_torch.bench`` printed (the last
    non-empty line of ``path``), for each of ``keys``; raises unless a card
    wrote it by the bench's device timer with every needed component
    measured."""
    with open(path) as f:
        lines = [x for x in f.read().splitlines() if x.strip()]
    if not lines:
        raise ValueError(f"{path}: no bench line")
    got = json.loads(lines[-1])
    device = got.get("device")
    if not isinstance(device, str) or not _CARD_LINE.match(device):
        raise ValueError(f"{path}: device {device!r} is not a card's "
                         "nvidia-smi line")
    if got.get("timing_method") != TIMING_METHOD:
        raise ValueError(f"{path}: timing method "
                         f"{got.get('timing_method')!r} is not the bench's "
                         "device timer")
    skipped = {s.split(":")[0] for s in got.get("skipped", [])}
    comps = got.get("components_rows_per_s", {})
    rates = {}
    for key in keys:
        comp = BENCH_COMPONENT[key]
        if comp in skipped or not comps.get(comp, 0) > 0:
            raise ValueError(f"{path}: component {comp} was skipped or not "
                             "measured")
        rates[key] = comps[comp]
    return {"rows_per_s": rates, "device": device,
            "timing_method": got["timing_method"], "torch": got.get("torch"),
            "cuda": got.get("cuda")}


def load_compute(path: str, rows_per_chip: int) -> dict:
    """The card's world-of-one rows/s per operator from ``scaling.py
    --device gpu --compute_json``; raises unless it is a card's, at
    ``rows_per_chip``."""
    with open(path) as f:
        got = json.load(f)
    if got["device"]["platform"] != "gpu":
        raise ValueError(f"{path}: measured on {got['device']}, not a card")
    if got["rows_per_chip"] != rows_per_chip:
        raise ValueError(f"{path}: measured at {got['rows_per_chip']} rows "
                         f"per chip, not {rows_per_chip}")
    return got


def projections(colls, key, R, hops, rates) -> dict:
    """{n: the projection at n GPUs} for an operator whose compute term is
    ``R / rates[key]``."""
    out = {}
    for n in PROJECT_TO:
        link, bw = (("nvlink", B_NVLINK) if n <= NVLINK_DOMAIN
                    else ("ib", B_IB))

        def at(b):
            return project(None, colls, key, R, hops, n, b, rates)

        t_comp, t_comm, es, eo = at(bw)
        out[str(n)] = {
            "link": link,
            "t_compute_ms": round(t_comp * 1e3, 4),
            "t_comm_ms": round(t_comm * 1e3, 4),
            "eff_no_overlap": round(es, 4),
            "eff_full_overlap": round(eo, 4),
            "eff_no_overlap_half_bw": round(at(bw / BAND)[2], 4),
            "eff_no_overlap_2x_bw": round(at(bw * BAND)[2], 4),
            "t_comm_nvlink_ms": round(at(B_NVLINK)[1] * 1e3, 4),
            "eff_no_overlap_ib": round(at(B_IB)[2], 4),
        }
    return out


def model(tally: dict, bench: dict, rows_per_chip: int,
          compute: Optional[dict] = None) -> dict:
    """The projections of every operator of ``tally``: ``projection`` from
    the bench line's rates (``load_bench``), and, when ``compute`` (the
    world of one, ``load_compute``) is given, ``projection_world_of_one``
    beside it."""
    R = rows_per_chip
    results = {"rows_per_chip": R, "B_NVLINK": B_NVLINK, "B_IB": B_IB,
               "nvlink_domain": NVLINK_DOMAIN, "band": BAND,
               "sources": SOURCES, "device": bench["device"],
               "compute_source": "bench line: components_rows_per_s (cold, "
                                 "CUDA-graph replay slope) at each "
                                 "component's own size",
               "timing_method": bench["timing_method"],
               "bench_component": BENCH_COMPONENT,
               "single_gpu_rows_per_s": bench["rows_per_s"], "ops": {}}
    if compute is not None:
        results["world_of_one"] = {
            "source": "scaling.py --device gpu --compute_json: host-clock "
                      "slope of queued calls on an NCCL world of one, "
                      "host dispatch included; not the headline",
            "device": compute["device"], "card": compute["card"],
            "rows_per_s": compute["rows_per_s"]}
    for name, op in tally.items():
        colls, key, hops = op["collectives"], op["compute_key"], op["hops"]
        entry = {"collectives_8rank_result_bytes": colls,
                 "compute_component": key,
                 "bench_component": BENCH_COMPONENT[key],
                 "serial_hops": hops,
                 "projection": projections(colls, key, R, hops,
                                           bench["rows_per_s"])}
        if compute is not None:
            entry["world_op"] = op["world_op"]
            entry["projection_world_of_one"] = projections(
                colls, op["world_op"], R, hops, compute["rows_per_s"])
        results["ops"][name] = entry
    return results


def print_projection(label: str, name: str, proj: dict) -> None:
    for n in PROJECT_TO:
        p = proj[str(n)]
        print(f"  {label}{name} N={n}: comp {p['t_compute_ms']} ms, "
              f"{p['link']} comm {p['t_comm_ms']} ms, "
              f"eff(serial) {p['eff_no_overlap']} "
              f"[{p['eff_no_overlap_half_bw']}, "
              f"{p['eff_no_overlap_2x_bw']}], "
              f"eff(overlap) {p['eff_full_overlap']}", flush=True)


def print_tally(tally: dict) -> None:
    for name, op in tally.items():
        colls = op["collectives"]
        counts = {k: len(v) for k, v in colls.items()}
        total = {k: sum(v) for k, v in colls.items()}
        print(f"{name}: collectives={counts} result bytes={total}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-per-chip", type=int, default=1 << 20)
    ap.add_argument("--bench_json", default="",
                    help="the line python -m dwarf_bench_tpu_torch.bench "
                         "printed on the card: the compute term")
    ap.add_argument("--compute_json", default="",
                    help="scaling.py --device gpu --compute_json's output: "
                         "the labelled world-of-one projection")
    ap.add_argument("--out", default=".",
                    help="directory of scaling_model.json")
    args = ap.parse_args(argv)
    R = args.rows_per_chip
    check_out(args.out)
    bench = load_bench(args.bench_json, COMPUTE_KEYS) if args.bench_json \
        else None
    compute = load_compute(args.compute_json, R) if args.compute_json \
        else None
    tally = tally_ops(R)
    print_tally(tally)
    if bench is None:
        print("no --bench_json: the model has no compute term (the line "
              "python -m dwarf_bench_tpu_torch.bench printed on the card)",
              file=sys.stderr)
        return 2
    results = model(tally, bench, R, compute)
    print(f"compute: the bench components on {bench['device']} "
          f"{bench['rows_per_s']!r}", flush=True)
    for name, entry in results["ops"].items():
        print_projection("", name, entry["projection"])
    if compute is not None:
        print(f"world of one (host-clock slope, not the headline): "
              f"{compute['device']['kind']} ({compute['card']}) at {R} rows",
              flush=True)
        for name, entry in results["ops"].items():
            print_projection("world of one: ", name,
                             entry["projection_world_of_one"])
    os.makedirs(args.out, exist_ok=True)
    out = os.path.join(args.out, "scaling_model.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
