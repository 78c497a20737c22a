"""GroupByLocal (``groupby_partials``, ``groupby_merge``, the dwarf) and the
Constant* dwarfs of the port against the JAX package on the CPU, exactly."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwarf_bench_tpu import cli as jax_cli
from dwarf_bench_tpu.dwarfs import populate_registry as jax_registry
from dwarf_bench_tpu.ops import groupby as jax_gb
from dwarf_bench_tpu_torch import cli, populate_registry
from dwarf_bench_tpu_torch.ops import groupby

CONSTANTS = ("ConstantExample", "ConstantExampleCAPI",
             "ConstantExampleDPCPP")


@pytest.mark.parametrize("num_groups", [16, 20, 4096])
@pytest.mark.parametrize("executors", [1, 3, 8, 1024])
def test_partials_and_merge_match_jax(rng, executors, num_groups):
    """n = 5003 is no multiple of any executor count above 1; keys out of
    range (negative, G and past it) are dropped. The executor-offset keys
    take groupby_small up to 4096 partial groups, the weighted histogram up
    to 2^16 (1024 x 20), the sort engine past it (1024 x 4096)."""
    n = 5003
    k = rng.integers(-5, num_groups + 5, n).astype(np.int32)
    k[:3] = [-(2**31), num_groups, 2**31 - 1]
    v = rng.integers(1, 10000, n, endpoint=True).astype(np.int32)
    ref = jax_gb.groupby_partials(jnp.asarray(k), jnp.asarray(v),
                                  num_groups, executors)
    got = groupby.groupby_partials(torch.from_numpy(k), torch.from_numpy(v),
                                   num_groups, executors)
    assert got.dtype == torch.int32
    assert got.shape == (executors, num_groups)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    merged = groupby.groupby_merge(got)
    assert np.array_equal(merged.numpy().view(np.uint32),
                          np.asarray(jax_gb.groupby_merge(ref)))


def test_merge_wraps_mod_2_32():
    partials = torch.full((3, 2), 2**31 - 1, dtype=torch.int32)
    merged = groupby.groupby_merge(partials)
    assert merged.numpy().view(np.uint32).tolist() == \
        [(3 * (2**31 - 1)) % 2**32] * 2


def test_partials_edge_cases():
    empty = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(groupby.groupby_partials(empty, empty, 4, 3),
                       torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        groupby.groupby_partials(empty, empty, 4, 0)


def _csv(main, tmp_path, name, argv):
    path = tmp_path / f"{name}.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main([*argv, f"--report_path={path}"])
    return rc, open(path).read().splitlines()


def test_groupby_local_cli_matches_jax(tmp_path):
    argv = ["GroupByLocal", "--device=cpu", "--input_size", "256", "1000",
            "--iterations=2", "--groups_count=16", "--executors=8"]
    rc, lines = _csv(cli.main, tmp_path, "torch", argv)
    jrc, jlines = _csv(jax_cli.main, tmp_path, "jax", argv)
    assert rc == jrc == 0
    assert lines[0] == jlines[0] == (
        "device_type,buf_size_bytes,total_time,group_by_time,reduction_time")
    assert len(lines) == len(jlines) == 1 + 2 * 2
    assert [line.split(",")[:2] for line in lines[1:]] == \
        [line.split(",")[:2] for line in jlines[1:]]
    results = populate_registry().find("GroupByLocal").get_results()
    assert len(results) == 4 and all(r.result.valid for r in results)


@pytest.mark.parametrize("groups,executors", [(64, 64), (20, 1024)])
def test_groupby_local_valid(groups, executors):
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["GroupByLocal", "--device=cpu", "--input_size",
                       "40000", f"--groups_count={groups}",
                       f"--executors={executors}", "--iterations=2"])
    assert rc == 0
    results = populate_registry().find("GroupByLocal").get_results()
    assert len(results) == 2 and all(r.result.valid for r in results)
    assert all(r.result.host_time >= r.result.group_by_time > 0
               for r in results)


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, [line for line in out.getvalue().splitlines()
                if line.startswith("42 =")]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_dwarfs_match_jax(name):
    argv = [name, "--device=cpu", "--iterations=3"]
    rc, lines = _stdout(cli.main, argv)
    jrc, jlines = _stdout(jax_cli.main, argv)
    assert rc == jrc == 0
    assert lines == jlines == ["42 = 42"] * 3
    assert len(populate_registry().find(name).get_results()) == 0
    assert len(jax_registry().find(name).get_results()) == 0


def test_constant_dpcpp_cuda_is_pinned_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = _stdout(cli.main, ["ConstantExampleDPCPPCuda",
                                   "--device=cpu"])
    assert rc == 1 and lines == []


def test_constant_widths():
    reg = populate_registry()
    assert [reg.find(n).width for n in CONSTANTS] == [1, 1, 16]
    assert reg.find("ConstantExampleDPCPPCuda").width == 16
