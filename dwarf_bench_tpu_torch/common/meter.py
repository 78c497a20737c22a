"""Meter: accumulates per-run results with stable + per-run params merged.

Reference: common/meter.{hpp,cpp} — ``concat`` merges stable params
(device_type) with incoming per-run params (buf_size); the stable params win
on key conflicts the way std::map::insert does (no overwrite of existing keys,
common/meter.cpp:3-8).
"""

from __future__ import annotations

from typing import Optional

from .options import RunOptions
from .result import DwarfParams, MeasureResults, Result


class Meter:
    def __init__(self, name: str, results: MeasureResults):
        self._name = name
        self._results = results
        self._params: DwarfParams = {}
        self._opts: Optional[RunOptions] = None

    def add_result(self, params: DwarfParams, result: Result) -> None:
        # std::map::insert semantics: keys already present in the stable
        # params are NOT overwritten by incoming ones (meter.cpp:3-8).
        merged = dict(params)
        merged.update(self._params)
        self._results.add_result(merged, result)

    def set_params(self, params: DwarfParams) -> None:
        self._params = dict(params)

    def set_opts(self, opts: RunOptions) -> None:
        self._opts = opts

    @property
    def opts(self) -> RunOptions:
        assert self._opts is not None, "Meter.set_opts was never called"
        return self._opts
