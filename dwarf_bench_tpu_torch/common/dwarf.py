"""Dwarf abstract base class.

Reference: common/dwarf.hpp:6-40 — a dwarf is one benchmark unit with a name,
``init``/``run`` hooks, a Meter accumulating MeasureResults, and ``report``
that pretty-prints to stdout or appends to the CSV at ``report_path``.
"""

from __future__ import annotations

import abc

from .meter import Meter
from .options import RunOptions
from .result import DEFAULT_REPORT_HEADER, MeasureResults


class Dwarf(abc.ABC):
    def __init__(self, name: str):
        self._name = name
        self._results = MeasureResults(name)
        self._meter = Meter(name, self._results)
        self.reporting_header = DEFAULT_REPORT_HEADER

    @property
    def name(self) -> str:
        return self._name

    @abc.abstractmethod
    def init(self, opts: RunOptions) -> None:
        ...

    @abc.abstractmethod
    def run(self, opts: RunOptions) -> None:
        ...

    def report(self, opts: RunOptions) -> None:
        """Reference: common/dwarf.hpp:17-26."""
        if not opts.report_path:
            for res in self._results:
                print(res.result, end="")
        else:
            self._results.set_report_header(self.reporting_header)
            self._results.write_csv(
                opts.report_path,
                extended=getattr(opts, "extended_report", False),
            )
            # the reference-schema CSV has no validity column; surface the
            # per-run oracle outcome on stderr so sweep logs carry the
            # correctness evidence alongside the timing artifact
            import sys

            n = len(self._results)
            nv = sum(1 for r in self._results if r.result.valid)
            print(f"[{self._name}] {nv}/{n} runs valid", file=sys.stderr)

    def meter(self) -> Meter:
        return self._meter

    def get_results(self) -> MeasureResults:
        return self._results

    def clear_results(self) -> None:
        self._results.clear()
