"""Device-side synchronization demo, the port of ``examples/lock_add.py``
(the reference's example/lock_add/lock_add.cpp:50-63): 64 blocks each take
a device-wide CAS spin lock and add one to a counter (``grid_accumulate``,
``csrc/lock_add.cu``; its plain version on the CPU).

    python -m dwarf_bench_tpu_torch.examples.lock_add [--device=cpu]
"""

from __future__ import annotations

import sys

from ..ops.lock_add_cuda import grid_accumulate
from . import parse_device


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    total = int(grid_accumulate(64, device=device)[0, 0])
    print(f"64 = {total}")
    return 0 if total == 64 else 1


if __name__ == "__main__":
    sys.exit(main())
