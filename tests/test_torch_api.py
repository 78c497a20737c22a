"""The port's library API (``dwarf_bench_tpu_torch/api.py``) and registry
against the JAX package's on the CPU."""

import contextlib
import io
import json

import pytest

pytest.importorskip("torch")

import torch

import dwarf_bench_tpu.api as jax_api
from dwarf_bench_tpu import cli as jax_cli
from dwarf_bench_tpu.dwarfs import _ALL_DWARFS as JAX_DWARFS
from dwarf_bench_tpu_torch import (
    ApiDeviceType,
    DwarfBench,
    DwarfBenchException,
    DwarfKind,
    RunConfig,
    api,
    cli,
)
from dwarf_bench_tpu_torch.dwarfs import _ALL_DWARFS


def test_registry_holds_the_jax_dwarfs_in_order():
    names = [cls().name for cls in _ALL_DWARFS]
    assert len(names) == 24
    assert names == [cls().name for cls in JAX_DWARFS]


def test_list_prints_what_the_jax_cli_prints(capsys):
    assert jax_cli.main(["list"]) == 0
    expected = capsys.readouterr().out
    assert cli.main(["list"]) == 0
    assert capsys.readouterr().out == expected
    assert len(expected.splitlines()) == 1 + 24


@pytest.mark.parametrize("kind", list(DwarfKind))
def test_make_measurements_matches_jax(kind):
    conf = RunConfig(device=ApiDeviceType.CPU, input_size=256, iterations=2,
                     dwarf=kind)
    jconf = jax_api.RunConfig(device=jax_api.ApiDeviceType.CPU,
                              input_size=256, iterations=2,
                              dwarf=jax_api.DwarfKind[kind.name])
    with contextlib.redirect_stdout(io.StringIO()):
        ms = DwarfBench().make_measurements(conf)
        jms = jax_api.DwarfBench().makeMeasurements(jconf)
    assert len(ms) == len(jms) == 2
    # data_size quirk preserved: element count, not bytes (bench.cpp:96-98)
    assert [m.data_size for m in ms] == [m.data_size for m in jms] == [256, 256]
    assert all(isinstance(m.microseconds, int) and m.microseconds >= 0
               for m in ms)
    impl = api._dwarf_to_string(api._IMPL[kind], ApiDeviceType.CPU)
    results = cli.populate_registry().find(impl).get_results()
    assert all(r.result.valid for r in results)


@pytest.mark.parametrize("device", ["CPU", "GPU", "TPU"])
@pytest.mark.parametrize("impl", sorted(api._HAS_ACCEL_VARIANT
                                        | set(api._IMPL.values())))
def test_accelerator_renaming_matches_jax(impl, device):
    name = api._dwarf_to_string(impl, ApiDeviceType[device])
    assert name == jax_api._dwarf_to_string(impl,
                                            jax_api.ApiDeviceType[device])
    assert cli.populate_registry().find(name) is not None


def test_impl_map_matches_jax():
    assert {k.name: v for k, v in api._IMPL.items()} == \
        {k.name: v for k, v in jax_api._IMPL.items()}
    assert api._HAS_ACCEL_VARIANT == jax_api._HAS_ACCEL_VARIANT


def test_tpu_is_an_alias_of_gpu():
    assert ApiDeviceType.TPU is ApiDeviceType.GPU
    assert ApiDeviceType.CPU is not ApiDeviceType.GPU


@pytest.mark.parametrize("kind", list(DwarfKind))
def test_gpu_without_cuda_raises_dwarf_bench_exception(monkeypatch, kind):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = RunConfig(device=ApiDeviceType.GPU, input_size=64, iterations=1,
                     dwarf=kind)
    with pytest.raises(DwarfBenchException, match="CUDA is not available"):
        DwarfBench().make_measurements(conf)


@pytest.mark.parametrize("dwarf,extra", [("Radix", []),
                                         ("GroupBy", ["--groups_count=64"])])
def test_profile_dir_writes_a_trace_per_run_call(tmp_path, capsys, dwarf,
                                                 extra):
    """``--profile_dir`` (the JAX CLI's flag and RunOptions field): each run
    call, whatever its sizes, writes one torch.profiler Chrome trace, which
    holds the dwarf's operators; without it nothing is written."""
    out = tmp_path / "traces"
    args = [dwarf, "--device=cpu", "--input_size", "1024", "2048",
            "--iterations=2", *extra]
    parsed = jax_cli.build_parser().parse_args(args + ["--profile_dir", "p"])
    assert parsed.profile_dir == "p"
    assert cli.build_parser().parse_args(args).profile_dir == ""
    assert cli.main(args) == 0
    assert not out.exists()
    for calls in (1, 2):
        assert cli.main(args + [f"--profile_dir={out}"]) == 0
        traces = sorted(out.iterdir())
        assert len(traces) == calls
    capsys.readouterr()
    for trace in traces:
        assert trace.name.startswith(f"{dwarf}-")
        assert trace.name.endswith(".pt.trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
