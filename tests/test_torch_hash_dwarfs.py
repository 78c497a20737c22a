"""The hash-family and Reduce dwarfs end to end on the CPU: the port's CLI
against the JAX package's CLI on the same arguments (validity, CSV header
and row schema), and the join dwarfs' result rows against the JAX
pipelines' on the dwarfs' own data."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from dwarf_bench_tpu import native as jax_native
from dwarf_bench_tpu.cli import main as jax_main
from dwarf_bench_tpu.common.datagen import derive_seed, make_unique_random
from dwarf_bench_tpu.dwarfs.join import _slab_probe_join as jax_slab_probe
from dwarf_bench_tpu.ops import bucket_hash as jbh
from dwarf_bench_tpu.ops import join as jj
from dwarf_bench_tpu_torch import cli, native, populate_registry
from dwarf_bench_tpu_torch.dwarfs.join import _slab_probe_join
from dwarf_bench_tpu_torch.ops import bucket_hash as tbh
from dwarf_bench_tpu_torch.ops import join as tj

DWARFS = ["ReduceDPCPP", "HashBuild", "HashBuildNonBitmask", "CuckooHashBuild",
          "SlabHashBuild", "SlabProbe", "Join", "NestedLoopJoin", "SlabJoin"]


def _csv_rows(path):
    return [line.split(",") for line in open(path).read().splitlines()]


@pytest.mark.parametrize("dwarf", DWARFS)
def test_cli_matches_jax_package(tmp_path, dwarf):
    args = [dwarf, "--device=cpu", "--input_size", "1000", "4096",
            "--iterations=2"]
    port_csv, jax_csv = tmp_path / "port.csv", tmp_path / "jax.csv"
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert cli.main([*args, f"--report_path={port_csv}"]) == 0
        assert jax_main([*args, f"--report_path={jax_csv}"]) == 0
    results = populate_registry().find(dwarf).get_results()
    assert len(results) == 4 and all(r.result.valid for r in results)
    assert f"[{dwarf}] 4/4 runs valid" in err.getvalue()
    port, ref = _csv_rows(port_csv), _csv_rows(jax_csv)
    assert open(port_csv).readline() == open(jax_csv).readline()
    assert len(port) == len(ref) == 1 + 2 * 2
    for p, r in zip(port[1:], ref[1:]):
        assert len(p) == len(r)
        assert p[:2] == r[:2]  # device_type, buf_size_bytes
        assert all(float(x) >= 0 for x in p[2:])


def _tables(n):
    return tuple(make_unique_random(n, seed=derive_seed(0, n, i))
                 for i in range(4))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _same_rows(got, ref):
    c = int(ref.count)
    assert int(got.count) == c
    for g, r in zip((got.keys, got.a_vals, got.b_vals),
                    (ref.keys, ref.a_vals, ref.b_vals)):
        assert np.array_equal(g[:c].numpy().view(np.uint32),
                              np.asarray(r[:c]))
    return c


@pytest.mark.parametrize("n", [1000, 4096])
def test_join_rows_match_jax(n):
    """Join, NestedLoopJoin and SlabJoin on their dwarfs' data: the same
    rows in the same order as the JAX pipelines, and the oracle's rows."""
    ak, av, bk, bv = _tables(n)
    expected = native.seq_join_sorted(ak, av, bk, bv)
    assert np.array_equal(expected, jax_native.seq_join_sorted(ak, av, bk, bv))
    assert native.join_count(ak, bk) == len(expected) == \
        jax_native.join_count(ak, bk)
    seed = derive_seed(0, n, 4) & 0xFFFFFFFF
    jt = jj.hash_join_build(jnp.asarray(ak), jnp.asarray(av), 2 * n,
                            np.uint32(seed))
    tt = tj.hash_join_build(_t(ak), _t(av), 2 * n, seed)
    got = tj.hash_join_probe(tt, _t(bk), _t(bv), seed)
    ref = jj.hash_join_probe(jt, jnp.asarray(bk), jnp.asarray(bv),
                             np.uint32(seed))
    assert _same_rows(got, ref) == len(expected)
    assert np.array_equal(tj.join_rows_sorted(got), expected)

    got = tj.nested_loop_join(_t(ak), _t(av), _t(bk), _t(bv))
    ref = jj.nested_loop_join(*(jnp.asarray(x) for x in (ak, av, bk, bv)))
    assert _same_rows(got, ref) == len(expected)

    jtab = jbh.build(jnp.asarray(ak), jnp.asarray(av), 1024)
    ttab = tbh.build(_t(ak), _t(av), 1024)
    got = _slab_probe_join(ttab, _t(bk), _t(bv))
    ref = jax_slab_probe(jtab, jnp.asarray(bk), jnp.asarray(bv))
    assert _same_rows(got, ref) == len(expected)


def test_seq_join_oracle_duplicates(rng):
    """The vectorized oracle against the JAX package's loop on keys with
    duplicates on both sides."""
    ak, bk = (rng.integers(1, 30, 200).astype(np.uint32) for _ in range(2))
    av, bv = (rng.integers(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    got = tj.seq_join_oracle(ak, av, bk, bv)
    assert np.array_equal(got, jj.seq_join_oracle(ak, av, bk, bv))
    assert native.join_count(ak, bk) == len(got)
    empty = tj.seq_join_oracle(ak[:0], av[:0], bk, bv)
    assert empty.shape == (0, 3)
