"""The inputs of tests/test_torch_parallel.py and the port's side of its
cases, run on every rank of a gloo world. It holds no test and imports no
JAX: each spawned rank imports it, ``run_rank`` runs every case of ``CASES``
on the rank's shards and saves the rank's outputs (``rank<r>.npz``, a key
``<case>/<output index>`` an array, int32 bit patterns as they come).

The inputs of a case come from ``np.random.default_rng`` of the case's own
seed, so the test builds the same arrays for the JAX side.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

import torch
import torch.distributed as dist

from dwarf_bench_tpu_torch.common.datagen import make_unique_random
from dwarf_bench_tpu_torch.parallel import (
    dist_csr_join,
    dist_csr_join_2d,
    dist_csr_join_ring,
    dist_csr_join_ring_2d,
    dist_csr_join_skew,
    dist_filter,
    dist_groupby_dense,
    dist_groupby_shuffle,
    dist_hash_join_rows,
    dist_sort,
    init_multihost,
    make_mesh,
    make_mesh_2d,
    partition_for_shuffle,
    partition_for_shuffle_2d,
    shard_rows,
)
from dwarf_bench_tpu_torch.parallel.mesh import DCN_AXIS, ICI_AXIS, ROW_AXIS

N_DEV = 8
EMPTY = np.uint32(0xFFFFFFFF)


def _keys(rng, lo, hi, n):
    return rng.integers(lo, hi, n, endpoint=True).astype(np.uint32)


def _groupby(seed, G, per_chip, cap=None):
    rng = np.random.default_rng(seed)
    n = N_DEV * per_chip
    keys = rng.integers(0, G, n).astype(np.uint32)
    keys[rng.random(n) < 0.01] = EMPTY  # padding lands in no group
    vals = _keys(rng, 1, 10000, n)
    return {"arrays": (keys, vals), "G": G, "cap": cap}


def _join(seed, per_chip, hi, cap_div=4):
    rng = np.random.default_rng(seed)
    n = N_DEV * per_chip
    return {"arrays": (_keys(rng, 1, hi, n), _keys(rng, 1, hi, n)),
            "per_chip": per_chip, "cap": (per_chip // N_DEV) * cap_div}


def _ring_skew(seed):
    rng = np.random.default_rng(seed)
    n = N_DEV * 512
    A = _keys(rng, 1, 100, n)
    A[: n // 2] = 7
    return {"arrays": (A, _keys(rng, 1, 100, n)), "per_chip": 512}


def _shuffle(seed, multi=False):
    rng = np.random.default_rng(seed)
    n = N_DEV * 512
    keys = rng.integers(1, 100000, n).astype(np.uint32)
    if not multi:
        return {"arrays": (keys, np.arange(n, dtype=np.uint32)),
                "cap": (n // N_DEV // N_DEV) * 4}
    v64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    return {"arrays": (keys, (v64 & 0xFFFFFFFF).astype(np.uint32),
                       (v64 >> 32).astype(np.uint32),
                       np.arange(n, dtype=np.uint32)),
            "cap": (n // N_DEV // N_DEV) * 4}


def _filter(seed, per_chip, threshold):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 10000, N_DEV * per_chip, endpoint=True)
    return {"arrays": (x.astype(np.int32),), "threshold": threshold,
            "cap": per_chip}


def _sort(seed):
    rng = np.random.default_rng(seed)
    n = N_DEV * 2048
    return {"arrays": (rng.integers(1, 100000, n).astype(np.uint32),),
            "cap": (n // N_DEV) * 2}


def _skew_heavy(seed):
    rng = np.random.default_rng(seed)
    per_chip = 1024
    n = N_DEV * per_chip
    A, B = _keys(rng, 1, 2000, n), _keys(rng, 1, 2000, n)
    A[rng.random(n) < 0.5] = 777
    B[rng.random(n) < 0.5] = 777
    return {"arrays": (A, B), "per_chip": per_chip,
            "cap": (per_chip // N_DEV) * 4}


def _rows(seed):
    n = N_DEV * 512
    return {"arrays": tuple(make_unique_random(n, seed=seed + i)
                            for i in range(4)),
            "cap": (n // N_DEV // N_DEV) * 4}


def _shuffle_2d(seed):
    rng = np.random.default_rng(seed)
    n = N_DEV * 512
    return {"arrays": (rng.integers(1, 100000, n).astype(np.uint32),
                       np.arange(n, dtype=np.uint32)),
            "cap1": (n // 8 // 4) * 4, "cap2": (n // 8 // 2) * 4}


def _zipf(seed):
    rng = np.random.default_rng(seed)
    per_chip = 1024
    n = N_DEV * per_chip
    A = np.minimum(rng.zipf(1.3, n), 1 << 20).astype(np.uint32)
    B = np.minimum(rng.zipf(1.3, n), 1 << 20).astype(np.uint32)
    return {"arrays": (A, B), "per_chip": per_chip,
            "cap": (per_chip // N_DEV) * 4}


def _threshold(seed):
    """A key just above the heavy threshold (shuffle_capacity // 2) and one
    just below; B2 plants probes of both in chip 0's first rows."""
    rng = np.random.default_rng(seed)
    per_chip = 1024
    n = N_DEV * per_chip
    cap = (per_chip // N_DEV) * 4  # 512: threshold 256
    thr = cap // 2
    A, B = _keys(rng, 1, 5000, n), _keys(rng, 1, 5000, n)
    A[: thr + 8] = 100001
    A[thr + 8: 2 * thr] = 100002
    B2 = B.copy()
    B2[:4] = 100001
    B2[4:8] = 100002
    return {"arrays": (A, B, B2), "per_chip": per_chip, "cap": cap}


def _scale(seed, hot):
    rng = np.random.default_rng(seed)
    per_chip = 1 << 13
    n = N_DEV * per_chip
    A, B = _keys(rng, 1, 10000, n), _keys(rng, 1, 10000, n)
    if hot:
        A[rng.random(n) < 0.12] = 7
        B[rng.random(n) < 0.12] = 7
    return {"arrays": (A, B), "per_chip": per_chip,
            "cap": (per_chip // N_DEV) * 2}


def inputs(name: str) -> dict:
    """The inputs of case ``name``: ``arrays`` (the global host columns)
    and its sizes."""
    return {
        "groupby_dense": lambda: _groupby(1, 64, 4096),
        "groupby_dense_sorted": lambda: _groupby(2, 8192, 2048),
        "groupby_shuffle": lambda: _groupby(3, 128, 2048, cap=1024),
        "join": lambda: _join(4, 1024, 2000),
        "join_dense": lambda: _join(4, 1024, 2000),
        "ring": lambda: _join(5, 512, 800),
        "ring_dense": lambda: _join(5, 512, 800),
        "ring_skew": lambda: _ring_skew(6),
        "shuffle": lambda: _shuffle(7),
        "shuffle_multi": lambda: _shuffle(8, multi=True),
        "filter": lambda: _filter(9, 2048, 5000),
        "filter_sparse": lambda: _filter(10, 1 << 14, 5),
        "sort": lambda: _sort(11),
        "skew_heavy": lambda: _skew_heavy(12),
        "skew_uniform": lambda: _join(13, 512, 50000),
        "rows": lambda: _rows(14),
        "shuffle_2d": lambda: _shuffle_2d(18),
        "join_2d": lambda: _join(19, 1024, 2000, cap_div=2),
        "join_2d_dense": lambda: _join(19, 1024, 2000, cap_div=2),
        "ring_2d": lambda: _join(20, 512, 800),
        "skew_zipf": lambda: _zipf(21),
        "skew_threshold": lambda: _threshold(22),
        "scale_join": lambda: _scale(23, hot=False),
        "scale_skew": lambda: _scale(24, hot=True),
    }[name]()


def _join_sizes(p):
    return dict(rows_per_chip=p["per_chip"], distinct_cap=N_DEV * p["cap"],
                ht_size=2 * N_DEV * p["cap"], shuffle_capacity=p["cap"])


def _ring_sizes(p):
    per = p["per_chip"]
    return dict(rows_per_chip=per, distinct_cap=per, ht_size=2 * per + 2)


def _2d_sizes(p):
    per = p["per_chip"]
    cap1, cap2 = (per // 4) * 2, (per // 2) * 2
    return dict(rows_per_chip=per, distinct_cap=2 * cap2,
                ht_size=4 * cap2 + 2, cap_ici=cap1, cap_dcn=cap2)


def _scale_sizes(p):
    return dict(rows_per_chip=p["per_chip"], distinct_cap=1 << 14,
                ht_size=1 << 15, shuffle_capacity=p["cap"])


def run_case(name, mesh, mesh2):
    """This rank's outputs of case ``name`` (a tuple of tensors)."""
    p = inputs(name)
    arrays = p["arrays"]
    if name in ("groupby_dense", "groupby_dense_sorted"):
        return (dist_groupby_dense(mesh, p["G"])(*shard_rows(mesh, *arrays)),)
    if name == "groupby_shuffle":
        return dist_groupby_shuffle(mesh, p["G"], p["cap"])(
            *shard_rows(mesh, *arrays))
    if name in ("join", "join_dense"):
        return dist_csr_join(mesh, **_join_sizes(p),
                             dense=name == "join_dense")(
            *shard_rows(mesh, *arrays))
    if name in ("ring", "ring_dense", "ring_skew"):
        return dist_csr_join_ring(mesh, **_ring_sizes(p),
                                  dense=name == "ring_dense")(
            *shard_rows(mesh, *arrays))
    if name in ("shuffle", "shuffle_multi"):
        k, *cols = shard_rows(mesh, *arrays)
        rk, rcols, rcnt, ov = partition_for_shuffle(
            k, tuple(cols) if name == "shuffle_multi" else cols[0], N_DEV,
            p["cap"], mesh.get_group(ROW_AXIS))
        rcols = rcols if name == "shuffle_multi" else (rcols,)
        return (rk, *rcols, rcnt, ov)
    if name in ("filter", "filter_sparse"):
        return dist_filter(mesh, p["threshold"], p["cap"])(
            shard_rows(mesh, *arrays))
    if name == "sort":
        return dist_sort(mesh, p["cap"])(shard_rows(mesh, *arrays))
    if name in ("skew_heavy", "skew_uniform", "skew_zipf"):
        da, db = shard_rows(mesh, *arrays)
        extra = ({"heavy_cap": 32, "candidates_per_chip": 16}
                 if name == "skew_zipf" else {})
        skew = dist_csr_join_skew(mesh, **_join_sizes(p), **extra)(da, db)
        plain = dist_csr_join(mesh, **_join_sizes(p))(da, db)
        return (*skew, plain[3])
    if name == "skew_threshold":
        A, B, B2 = shard_rows(mesh, *arrays)
        fn = dist_csr_join_skew(mesh, **_join_sizes(p))
        return (*fn(A, B), *fn(A, B2))
    if name == "rows":
        return dist_hash_join_rows(mesh, shuffle_capacity=p["cap"],
                                   ht_size=2 * N_DEV * p["cap"])(
            *shard_rows(mesh, *arrays))
    if name == "shuffle_2d":
        k, v = shard_rows(mesh2, *arrays)
        rk, rv, rcnt, ov = partition_for_shuffle_2d(
            k, v, 2, 4, p["cap1"], p["cap2"], mesh2.get_group(DCN_AXIS),
            mesh2.get_group(ICI_AXIS))
        return rk, rv, rcnt, ov
    if name in ("join_2d", "join_2d_dense"):
        return dist_csr_join_2d(mesh2, **_2d_sizes(p),
                                dense=name == "join_2d_dense")(
            *shard_rows(mesh2, *arrays))
    if name == "ring_2d":
        return dist_csr_join_ring_2d(mesh2, **_ring_sizes(p))(
            *shard_rows(mesh2, *arrays))
    if name == "scale_join":
        return dist_csr_join(mesh, **_scale_sizes(p))(
            *shard_rows(mesh, *arrays))
    if name == "scale_skew":
        return dist_csr_join_skew(mesh, **_scale_sizes(p))(
            *shard_rows(mesh, *arrays))
    raise KeyError(name)


CASES = ("groupby_dense", "groupby_dense_sorted", "groupby_shuffle", "join",
         "join_dense", "ring", "ring_dense", "ring_skew", "shuffle",
         "shuffle_multi", "filter", "filter_sparse", "sort", "skew_heavy",
         "skew_uniform", "rows", "shuffle_2d", "join_2d", "join_2d_dense",
         "ring_2d", "skew_zipf", "skew_threshold", "scale_join",
         "scale_skew")


def run_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank: bring up gloo, run every case, save this rank's outputs.
    One intra-op thread a rank: the world shares the host's cores."""
    torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", num_processes=world, process_id=rank,
                   device="cpu")
    try:
        mesh = make_mesh()
        mesh2 = make_mesh_2d(2, world // 2)
        saved = {}
        for name in CASES:
            for i, t in enumerate(run_case(name, mesh, mesh2)):
                saved[f"{name}/{i}"] = torch.as_tensor(t).cpu().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **saved)
    finally:
        dist.destroy_process_group()
