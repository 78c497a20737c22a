from .datagen import (
    check_first,
    derive_seed,
    make_random,
    make_random_scalar,
    make_random_uniform_binary,
    make_unique_random,
)
from .device import resolve_device
from .dwarf import Dwarf
from .meter import Meter
from .options import (
    DeviceType,
    GroupByRunOptions,
    RunOptions,
    parse_device_type,
    to_string,
)
from .registry import Registry
from .result import (
    DEFAULT_REPORT_HEADER,
    DwarfParams,
    DwarfRunResult,
    GroupByAggResult,
    HashJoinResult,
    MeasureResults,
    Result,
)

__all__ = [
    "check_first",
    "derive_seed",
    "make_random",
    "make_random_scalar",
    "make_random_uniform_binary",
    "make_unique_random",
    "resolve_device",
    "Dwarf",
    "Meter",
    "DeviceType",
    "GroupByRunOptions",
    "RunOptions",
    "parse_device_type",
    "to_string",
    "Registry",
    "DEFAULT_REPORT_HEADER",
    "DwarfParams",
    "DwarfRunResult",
    "GroupByAggResult",
    "HashJoinResult",
    "MeasureResults",
    "Result",
]
