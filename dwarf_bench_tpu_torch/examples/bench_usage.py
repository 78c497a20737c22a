"""Library usage demo, the port of ``examples/bench_usage.py`` (the
reference's example/bench_usage/main.cpp:19-33): run two dwarfs through the
public facade and print each run's measurement.

    python -m dwarf_bench_tpu_torch.examples.bench_usage [--device=cpu]
"""

from __future__ import annotations

import sys

from ..api import ApiDeviceType, DwarfBench, DwarfKind, RunConfig
from . import parse_device


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    api_device = ApiDeviceType.CPU if device.type == "cpu" else \
        ApiDeviceType.GPU
    db = DwarfBench()
    for kind in (DwarfKind.Sort, DwarfKind.GroupBy):
        conf = RunConfig(
            device=api_device,
            input_size=1024,
            iterations=10,
            dwarf=kind,
        )
        for m in db.make_measurements(conf):
            print(f"{kind.value}: dataSize={m.data_size} "
                  f"microseconds={m.microseconds}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
