"""The flagship entry point: one forward step of the dense CSR hash join.

The port of the JAX package's ``__graft_entry__.entry``
(__graft_entry__.py:17-43): ``entry()`` returns ``(forward, (a, b))``, where
``forward(a, b)`` builds the dense CSR index of table A
(``csr_join.build_dense``: the count histogram kernel and one pair sort)
and probes it with table B (``csr_join.probe_dense``), returning ``(found,
pos, counts, id_buffer)``; ``a`` and ``b`` are 4096 keys each in [1, 10000]
from ``np.random.default_rng(0)``, on the card. ``id_buffer`` is an output,
so the build's id grouping (the reference's build_id_buffer phase) is part
of the step.

    python -m dwarf_bench_tpu_torch.entry [--device=gpu|cpu]

The multi-chip dry run (``__graft_entry__.dryrun_multichip``) waits for the
port's distributed layer.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .common.device import resolve_device
from .common.options import parse_device_type
from .ops import csr_join

N = 4096


def forward(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Build the dense CSR index of ``a_keys`` and probe it with
    ``b_keys``: ``(found, pos, counts, id_buffer)``. The keys must span
    less than 2^14 (``csr_join.dense_applicable``), as the benchmark's
    [1, 10000] keys do."""
    table = csr_join.build_dense(a_keys)
    res = csr_join.probe_dense(table, b_keys)
    return res.found, res.pos, res.counts, table.id_buffer


def entry(device="gpu"):
    """``(forward, (a, b))`` with the two key columns on ``device``: the
    card unless the CPU is asked for (``"cpu"``); raises without CUDA
    otherwise."""
    dev = resolve_device(parse_device_type(str(device)))
    rng = np.random.default_rng(0)
    a = rng.integers(1, 10000, N, endpoint=True).astype(np.uint32)
    b = rng.integers(1, 10000, N, endpoint=True).astype(np.uint32)
    return forward, tuple(torch.from_numpy(k.view(np.int32)).to(dev)
                          for k in (a, b))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="gpu",
                        help="gpu (the default: the card) or cpu")
    args = parser.parse_args(argv)
    fn, inputs = entry(args.device)
    out = fn(*inputs)
    print("entry OK:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
