"""The operators' own tracing: the branch each adaptive engine took, the
values read back to the host, and spans on the profiler's clock.

``TAKEN["<engine>:<branch>"]`` counts the calls of ``sort.sort_auto``
(branches ``hi80``, ``hi128`` and ``torch.sort``), ``scan.filter_sparse``
(``sparse``, and ``general`` where a cap trips, the threshold is within 512
of INT32_MIN, or the input is not int32) and ``groupby.groupby_sum``
(``small`` for G <= 4096, ``2level`` for G <= 2^16 with values vouched below
2^14, ``sorted`` otherwise) by the branch they took, and the CSR join
indexes built (``csr_join:dense`` a ``csr_join.build_dense`` call,
``csr_join:general`` a ``csr_join.build`` call).
``_build.LAUNCHES`` counts the kernels a run launched, on the card only; this
counter says which side of a dispatch cliff a call fell on, on the CPU too
(``utils/cliffs.py`` reads it).

``READS[site]`` counts the device values an operator read back to the host
through ``read``, on every device: ``sort_auto`` reads two a call
(``sort_auto.max``, ``sort_auto.min``), ``filter_sparse`` one
(``filter_sparse.caps``) unless ``assume_sparse=True``, where it reads none;
``groupby_sum``, ``build_dense`` and ``probe_dense`` read none.

Spans, on the profiler's clock: ``torch.profiler.record_function`` while a
profiler records, nothing otherwise. The operators and the wrappers read the
profiler's own flag once a call (``begin`` at their head) and open no span
and enter no ``with`` block while it is down; an operator marks its phases
with ``if sp: sp.next(name)``, which costs a test of a local while no
profiler records. The spans land in the profiler's trace
beside the card's kernels, on one clock: the benchmark's ``--trace 1`` runs
and the dwarf CLI's ``--profile_dir`` traces carry them. The names:

  * ``sort_auto``, ``filter_sparse``, ``groupby_sum``, ``build_dense``,
    ``probe_dense``: the operator call (``groupby_sum`` and
    ``probe_dense`` have no phases: ``groupby_sum``'s one branch is a
    wrapper's span or, for ``sorted``, eager ops; ``probe_dense`` is
    eager gathers);
  * ``sort_auto.span``, ``.histogram``, ``.expand``, ``.torch_sort``;
    ``filter_sparse.phase_a``, ``.tail``, ``.caps``, ``.phase_b``,
    ``.order``, ``.emit``, ``.general``; ``build_dense.histogram``,
    ``.positions``, ``.id_sort``, ``.layouts``: its phases;
  * ``read.<site>``: a read back to the host (``read``);
  * ``kernel.<name>``: a kernel wrapper, from its checks to its launch,
    ``<name>`` its ``_build.LAUNCHES`` name (on the CPU, its plain twin);
    ``groupby_sum`` opens ``kernel.groupby_small`` or
    ``kernel.weighted_histogram``, ``build_dense.histogram``
    ``kernel.histogram``.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

TAKEN: collections.Counter = collections.Counter()
READS: collections.Counter = collections.Counter()


def take(engine: str, branch: str) -> None:
    TAKEN[f"{engine}:{branch}"] += 1


def begin(name: str):
    """``Spans(name)`` while a profiler records, else None: an operator or
    a wrapper calls it once at its head, marks its phases under ``if sp:``
    and closes it in a ``finally``. ``torch.profiler.profile``'s
    ``start()`` and its ``with`` both set the flag read here."""
    if _profiler._is_profiler_enabled:
        return Spans(name)
    return None


class Spans:
    """A call's span and its phases' spans, one phase open at a time:
    ``next(name)`` ends the open phase and opens ``name``; ``close()`` ends
    the open phase and the call's span."""

    __slots__ = ("_open",)

    def __init__(self, name: str):
        self._open = [self._enter(name)]

    @staticmethod
    def _enter(name: str):
        rf = record_function(name)
        rf.__enter__()
        return rf

    def next(self, name: str) -> None:
        if len(self._open) > 1:
            self._open.pop().__exit__(None, None, None)
        self._open.append(self._enter(name))

    def close(self) -> None:
        while self._open:
            self._open.pop().__exit__(None, None, None)


def read(value: torch.Tensor, site: str):
    """``value.item()``: one element as a Python bool (a bool tensor) or
    int, read back to the host inside the span ``read.<site>`` and counted
    in ``READS[site]``."""
    READS[site] += 1
    if _profiler._is_profiler_enabled:
        with record_function(f"read.{site}"):
            return value.item()
    return value.item()
