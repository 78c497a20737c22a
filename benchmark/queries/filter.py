"""Query kind ``filter``: ``dwarf_bench_tpu_torch.ops.scan.filter_sparse``
(the checked dispatch) on a device-resident int32 range. The operator reads
its caps' predicate back to the host and then runs the sparse pipeline or
the ``filter`` kernel. It returns ``(out, count)``, ``count`` a 0-d device
tensor and ``out[:count]`` the kept rows.

Inputs: the configuration's ``table``, drawn on the card. A query
``(column, offset, rows)`` keeps the rows of that range below the traffic's
``threshold``.

Compared with the reference: the kept rows in order up to ``count``, and
``count``.
"""

from __future__ import annotations

import torch

from benchmark import data
from benchmark.reference import filter as reference
from benchmark.work import filter as work

# every number compared is exact: no row may differ
LIMITS = {"wrong_rows": 0}

make_inputs = data.one_table
args = data.table_range


def program(params: dict):
    from dwarf_bench_tpu_torch.ops.scan import filter_sparse

    threshold = int(params["threshold"])
    return lambda x: filter_sparse(x, threshold=threshold)


def control(params: dict):
    return lambda x: reference.control(x, params)


def written(out) -> torch.Tensor:
    """The kept rows' count (a 0-d device tensor; read after the window)."""
    return out[1]


def compare(out, args: tuple, params: dict) -> dict:
    """``wrong_rows``: kept rows, up to the shorter count, that differ from
    the reference's in value or position, plus the count's distance from the
    reference's."""
    vals, count = out
    ref = reference.expected(*args, params)
    count = int(count)
    m = max(0, min(count, ref.numel(), vals.numel()))
    wrong = int((vals[:m] != ref[:m]).sum()) + abs(count - ref.numel())
    return {"wrong_rows": wrong}
