"""Run options for dwarfs.

Equivalent of the reference's ``common/options.{hpp,cpp}`` (reference:
common/options.hpp:6-21, common/options.cpp:3-33), which models devices as
CPU/GPU/iGPU. Here the accelerator is one CUDA GPU; ``cuda`` is accepted as
an alias of ``gpu``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List


class DeviceType(enum.Enum):
    """Execution device. Reference: common/options.hpp:7."""

    CPU = "CPU"
    GPU = "GPU"
    DEFAULT = "DEFAULT"

    def __str__(self) -> str:
        return to_string(self)


def parse_device_type(s: str) -> DeviceType:
    """Parse a device string the way the reference's ``operator>>`` does
    (common/options.cpp:3-18): case-insensitive; unknown strings map to
    Default."""
    t = s.strip().lower()
    if t == "cpu":
        return DeviceType.CPU
    if t in ("gpu", "cuda"):
        return DeviceType.GPU
    return DeviceType.DEFAULT


def to_string(dt: DeviceType) -> str:
    """CSV/report device name (reference: common/options.cpp:20-33, where
    Default prints as the accelerator name)."""
    if dt == DeviceType.CPU:
        return "CPU"
    return "GPU"


@dataclasses.dataclass
class RunOptions:
    """Reference: common/options.hpp:6-14."""

    device_ty: DeviceType = DeviceType.DEFAULT
    input_size: List[int] = dataclasses.field(default_factory=list)
    iterations: int = 1
    root_path: str = ""
    report_path: str = ""
    # Deliberate deviation from the reference, as in the JAX package: every
    # generator derives from this seed (the reference uses random_device).
    seed: int = 0
    # Extension beyond the reference CSV schema: opt-in so the default
    # report stays byte-compatible.
    extended_report: bool = False


@dataclasses.dataclass
class GroupByRunOptions(RunOptions):
    """Reference: common/options.hpp:16-21."""

    groups_count: int = 1
    executors: int = 1

    @classmethod
    def from_options(
        cls, opts: RunOptions, groups_count: int, executors: int
    ) -> "GroupByRunOptions":
        return cls(
            **dataclasses.asdict(opts),
            groups_count=groups_count,
            executors=executors,
        )
