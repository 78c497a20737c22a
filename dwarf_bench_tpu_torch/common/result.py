"""Results and CSV reporting.

Equivalent of the reference's ``common/result.{hpp,cpp}``. The CSV
schema is kept byte-compatible with the reference so its analysis notebook
(scripts/report-sample.ipynb) works unchanged:

  ``device_type,buf_size_bytes,<per-dwarf header>``

with ``buf_size_bytes = buf_size * 4`` (sizeof int, reference:
common/result.cpp:67-69) and timings in milliseconds truncated to microsecond
resolution (duration_cast<microseconds>(d).count() / 1000.0, reference:
common/result.cpp:72-78). Files are opened in append mode and the header is
written only when the file does not yet exist (common/result.cpp:59-66).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

DwarfParams = Dict[str, str]

DEFAULT_REPORT_HEADER = "host_time_ms,kernel_time_ms"

_SIZEOF_INT = 4


def _fmt_ms(seconds: float) -> str:
    """Format a duration in seconds as ms with µs resolution, matching the
    reference's duration_cast<microseconds>(d).count() / 1000.0 and C++
    default ostream double formatting (up to 6 significant digits)."""
    ms = int(seconds * 1e6) / 1000.0
    return f"{ms:g}"


@dataclass
class Result:
    """Per-iteration measurement. Reference: common/result.hpp:12-27.

    Durations are stored in seconds (floats); the reference stores
    duration<double, micro>."""

    thread_x: int = 1
    thread_y: int = 1
    thread_z: int = 1
    group_size: int = 1
    bytes: int = 0
    iterations: int = 0
    bytes_per_iteration: int = 0
    kernel_time: float = 0.0  # seconds
    host_time: float = 0.0  # seconds
    valid: bool = True

    def get_reported_timings_list(self) -> List[float]:
        """Reference: common/result.cpp:16-18."""
        return [self.host_time, self.kernel_time]

    def __str__(self) -> str:
        # Reference prints µs (common/result.cpp:9-14).
        return (
            f"Kernel duration: {self.kernel_time * 1e6:g} us\n"
            f"Host duration:   {self.host_time * 1e6:g} us\n"
        )


@dataclass
class HashJoinResult(Result):
    """Reference: common/result.hpp:29-33. Note: the reference does NOT
    override get_reported_timings_list for joins — build/probe times appear in
    stdout output only, not in the CSV. Mirrored here."""

    probe_time: float = 0.0
    build_time: float = 0.0

    def __str__(self) -> str:
        return super().__str__() + (
            f"Build time: {self.build_time * 1e6:g} us\n"
            f"Probe time: {self.probe_time * 1e6:g} us\n"
        )


@dataclass
class GroupByAggResult(Result):
    """Reference: common/result.hpp:35-40."""

    group_by_time: float = 0.0
    reduction_time: float = 0.0

    def get_reported_timings_list(self) -> List[float]:
        """Reference: common/result.cpp:37-39."""
        return [self.host_time, self.group_by_time, self.reduction_time]

    def __str__(self) -> str:
        return super().__str__() + (
            f"Group stage time: {self.group_by_time * 1e6:g} us\n"
            f"Reduce stage time: {self.reduction_time * 1e6:g} us\n"
        )


@dataclass
class DwarfRunResult:
    """Reference: common/result.hpp:53-56."""

    params: DwarfParams
    result: Result


class MeasureResults:
    """Accumulates DwarfRunResults and writes the reference-schema CSV.

    Reference: common/result.hpp:58-78, common/result.cpp:41-94.
    """

    def __init__(self, name: str):
        self._name = name
        self._header = DEFAULT_REPORT_HEADER
        self._results: List[DwarfRunResult] = []

    def __iter__(self):
        return iter(self._results)

    def __len__(self) -> int:
        return len(self._results)

    def add_result(self, params: DwarfParams, result: Result) -> None:
        self._results.append(DwarfRunResult(dict(params), result))

    def set_report_header(self, header: str) -> None:
        self._header = header

    def write_csv(self, filename: str, extended: bool = False) -> None:
        """Append-mode CSV writer; header only on file creation
        (reference: common/result.cpp:59-91). ``extended`` adds a rows_per_s
        column (SURVEY.md §5.5 extension; off by default for byte parity)."""
        exists = os.path.exists(filename)
        ext_header = ",rows_per_s" if extended else ""
        with open(filename, "a") as of:
            if not exists:
                of.write(
                    f"device_type,buf_size_bytes,{self._header}{ext_header}\n"
                )
            for res in self._results:
                buf_size = int(res.params["buf_size"])
                buf_size_bytes = buf_size * _SIZEOF_INT
                timings = res.result.get_reported_timings_list()
                row = ",".join(_fmt_ms(t) for t in timings)
                if extended:
                    rps = (
                        buf_size / res.result.host_time
                        if res.result.host_time > 0
                        else 0.0
                    )
                    row += f",{rps:.0f}"
                of.write(f"{res.params['device_type']},{buf_size_bytes},{row}\n")

    def clear(self) -> None:
        self._results.clear()
