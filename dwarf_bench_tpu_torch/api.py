"""Embedding library API, the equivalent of the reference's ``dbench``
shared library facade (bench.hpp:13-96, bench.cpp:12-123) and of
``dwarf_bench_tpu/api.py``.

Public surface: ``DwarfBench.make_measurements(RunConfig) ->
list[Measurement]`` with the enums ``DwarfKind`` (Scan/Join/GroupBy/Sort)
and ``ApiDeviceType`` (CPU/GPU; TPU is kept as an alias of GPU, the
accelerator, for callers written against the JAX package). The public ->
implementation map mirrors bench.cpp:107-123 (Sort -> Radix, Join ->
JoinOmnisci, GroupBy -> GroupBy, Scan -> DPLScan), with the accelerator
renaming of bench.cpp:12-65 to the ``*Cuda`` registry names.

The accelerator is the card: asking for it without CUDA raises, wrapped in
``DwarfBenchException`` like every error of a dwarf.

Behavioural quirk kept knowingly: ``Measurement.data_size`` is the element
count, not bytes. The reference documents bytes (bench.hpp:29) but returns
``stoi(params["buf_size"])`` with a "todo make bytes counting"
(bench.cpp:96-98); the CSV path reports bytes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List

from .common.options import DeviceType, GroupByRunOptions, RunOptions
from .dwarfs import populate_registry


class DwarfKind(enum.Enum):
    """Public dwarf list (bench.hpp:12-17)."""

    Scan = "Scan"
    Join = "Join"
    GroupBy = "GroupBy"
    Sort = "Sort"


class ApiDeviceType(enum.Enum):
    """bench.hpp:23: the CPU or the accelerator."""

    CPU = "CPU"
    GPU = "GPU"
    TPU = "GPU"  # alias: the JAX package's name for its accelerator


@dataclass
class Measurement:
    """bench.hpp:31-34."""

    data_size: int
    microseconds: int


@dataclass
class RunConfig:
    """bench.hpp:42-47."""

    device: ApiDeviceType
    input_size: int
    iterations: int
    dwarf: DwarfKind


class DwarfBenchException(Exception):
    """bench.hpp:89-96."""


_IMPL = {  # bench.cpp:107-123
    DwarfKind.Scan: "DPLScan",
    DwarfKind.Join: "JoinOmnisci",
    DwarfKind.GroupBy: "GroupBy",
    DwarfKind.Sort: "Radix",
}

_HAS_ACCEL_VARIANT = {"DPLScan", "Radix", "JoinOmnisci", "GroupBy",
                      "ConstantExampleDPCPP"}  # bench.cpp:12-65


def _dwarf_to_string(impl: str, device: ApiDeviceType) -> str:
    if device != ApiDeviceType.CPU and impl in _HAS_ACCEL_VARIANT:
        return impl + "Cuda"
    return impl


class DwarfBench:
    """bench.hpp:52-70."""

    def make_measurements(self, conf: RunConfig) -> List[Measurement]:
        registry = populate_registry()
        opts = RunOptions(
            device_ty=(
                DeviceType.CPU
                if conf.device == ApiDeviceType.CPU
                else DeviceType.GPU
            ),
            input_size=[conf.input_size],
            iterations=conf.iterations,
            report_path="",
        )
        # the reference hardcodes GroupByRunOptions(opts, 20, 1024)
        # (bench.cpp:80)
        gopts = GroupByRunOptions.from_options(opts, 20, 1024)
        name = _dwarf_to_string(_IMPL[conf.dwarf], conf.device)
        dwarf = registry.find(name)
        if dwarf is None:
            raise DwarfBenchException(f"unknown dwarf: {name}")
        dwarf.clear_results()
        try:
            dwarf.init(gopts)
            dwarf.run(gopts)
        except Exception as e:  # bench.cpp wraps into DwarfBenchException
            raise DwarfBenchException(str(e)) from e
        return [
            Measurement(
                data_size=int(res.params["buf_size"]),
                microseconds=int(res.result.host_time * 1e6),
            )
            for res in dwarf.get_results()
        ]

    # snake_case is idiomatic here; keep the reference spelling too
    makeMeasurements = make_measurements
