"""Dwarf registration, the equivalent of register_dwarfs.cpp:20-56.

Registry names match the reference: all 24 dwarfs, registered in the order
of ``dwarf_bench_tpu/dwarfs/__init__.py``. The ``*Cuda`` names are pinned to
the GPU and raise without CUDA.
"""

from __future__ import annotations

from ..common.registry import Registry
from .constant import (
    ConstantExample,
    ConstantExampleCAPI,
    ConstantExampleDPCPP,
    ConstantExampleDPCPPCuda,
)
from .groupby import GroupBy, GroupByCuda, GroupByLocal
from .hash_build import (
    CuckooHashBuild,
    HashBuild,
    HashBuildNonBitmask,
    SlabHashBuild,
)
from .join import Join, JoinOmnisci, JoinOmnisciCuda, NestedLoopJoin, SlabJoin
from .probe import SlabProbe
from .reduce import ReduceDPCPP
from .scan import DPLScan, DPLScanCuda, TwoPassScan
from .sort import Radix, RadixCuda, TBBSort

_ALL_DWARFS = (
    # EXPERIMENTAL gate (register_dwarfs.cpp:22-26)
    TwoPassScan,
    ConstantExample,
    ConstantExampleCAPI,
    # always (register_dwarfs.cpp:28)
    TBBSort,
    # DPCPP_ENABLED gate (register_dwarfs.cpp:30-40)
    ConstantExampleDPCPP,
    DPLScan,
    Radix,
    HashBuild,
    NestedLoopJoin,
    GroupBy,
    GroupByLocal,
    Join,
    HashBuildNonBitmask,
    JoinOmnisci,
    # DPCPP+EXPERIMENTAL gate (register_dwarfs.cpp:41-46)
    ReduceDPCPP,
    CuckooHashBuild,
    SlabHashBuild,
    SlabJoin,
    SlabProbe,
    # CUDA_ENABLED gate (register_dwarfs.cpp:48-53)
    ConstantExampleDPCPPCuda,
    DPLScanCuda,
    RadixCuda,
    JoinOmnisciCuda,
    GroupByCuda,
)


def populate_registry() -> Registry:
    registry = Registry.instance()
    for cls in _ALL_DWARFS:
        registry.registerd(cls())
    return registry
