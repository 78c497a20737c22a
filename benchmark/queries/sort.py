"""Query kind ``sort``: ``dwarf_bench_tpu_torch.ops.sort.sort_auto`` on a
device-resident int32 range. The operator reads the range's span back to
the host and then runs the hi80 or hi128 counting sort or ``torch.sort``.

Inputs: the configuration's ``table``, drawn on the card. A query
``(column, offset, rows)`` sorts that range of the table.

Compared with the reference: every element of the sorted output.
"""

from __future__ import annotations

from benchmark import data
from benchmark.reference import sort as reference
from benchmark.work import sort as work

# every number compared is exact: no element may differ
LIMITS = {"wrong_elements": 0}

make_inputs = data.one_table
args = data.table_range


def program(params: dict):
    from dwarf_bench_tpu_torch.ops.sort import sort_auto

    return sort_auto


def control(params: dict):
    return lambda x: reference.control(x, params)


def written(out) -> int:
    """Rows the query writes besides its input's size (none beyond it)."""
    return 0


def compare(out, args: tuple, params: dict) -> dict:
    """``wrong_elements``: positions whose value differs from the
    reference's, plus the difference in length."""
    ref = reference.expected(*args, params)
    out = out.reshape(-1)
    m = min(out.numel(), ref.numel())
    wrong = int((out[:m] != ref[:m]).sum()) + abs(out.numel() - ref.numel())
    return {"wrong_elements": wrong}
