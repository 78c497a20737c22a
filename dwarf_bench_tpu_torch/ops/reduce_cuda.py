"""int32 sum mod 2^32: CUDA kernel (``csrc/reduce.cu``) and its plain
PyTorch twin.

The contract of ``dwarf_bench_tpu/ops/reduce.py`` ``reduce_sum_pallas``: the
sum of an int32 vector of any length (0 included) as a 0-d int32 tensor,
wrapping mod 2^32 like the reference's ``int`` accumulator. A wrapper takes
the twin only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .primitives import wrap_i32

# The kernel's scratch (one lasting buffer a stream): a ticket word, then one
# word a block; 1024 blocks is more than a wave of csrc/reduce.cu on any card
# of up to 256 SMs. The kernel leaves the ticket 0, as it finds it.
SCRATCH_WORDS = 1 + 1024


def reduce_sum_plain(x: torch.Tensor) -> torch.Tensor:
    _build.check_vectors("reduce_sum", x)
    return wrap_i32(x.sum(dtype=torch.int64))


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    device = _build.check_vectors("reduce_sum", x)
    if device.type == "cpu":
        return reduce_sum_plain(x)
    # a 0-d int32 tensor of its own on x's card; new_empty costs less host
    # time than torch.empty (PERF.md §6)
    out = x.new_empty(())
    scratch = _build.stream_scratch("reduce_sum", device, SCRATCH_WORDS)
    _build.launch("dbt_reduce_sum", device, x.data_ptr(), x.numel(),
                  out.data_ptr(), scratch.data_ptr(), scratch.numel())
    _build.LAUNCHES["reduce_sum"] += 1
    return out
