"""Dwarf registration, the equivalent of register_dwarfs.cpp:20-56.

Registry names match the reference. The ported dwarfs are registered in the
relative order of ``dwarf_bench_tpu/dwarfs/__init__.py``; the ``*Cuda``
names are pinned to the GPU and raise without CUDA.
"""

from __future__ import annotations

from ..common.registry import Registry
from .groupby import GroupBy, GroupByCuda
from .join import JoinOmnisci, JoinOmnisciCuda
from .sort import Radix, RadixCuda, TBBSort

_ALL_DWARFS = (
    # always (register_dwarfs.cpp:28)
    TBBSort,
    # DPCPP_ENABLED gate (register_dwarfs.cpp:30-40)
    Radix,
    GroupBy,
    JoinOmnisci,
    # CUDA_ENABLED gate (register_dwarfs.cpp:48-53)
    RadixCuda,
    JoinOmnisciCuda,
    GroupByCuda,
)


def populate_registry() -> Registry:
    registry = Registry.instance()
    for cls in _ALL_DWARFS:
        registry.registerd(cls())
    return registry
