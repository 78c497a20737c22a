"""CLI, the equivalent of the reference's ``dwarf_bench`` binary
(main.cpp:13-101) and of ``dwarf_bench_tpu/cli.py``: positional dwarf name
(or ``list``), ``--device``, multitoken ``--input_size``, ``--iterations``,
``--report_path``, ``--groups_count``, ``--executors``. GroupBy dwarfs get
their options upgraded to GroupByRunOptions exactly like main.cpp:87-92
(name contains "GroupBy").

Like the reference, a dwarf's exception is caught and printed; unlike it,
the exit code is then 1, so a failed run is not mistaken for a finished one.
"""

from __future__ import annotations

import argparse
import sys

from .common.options import GroupByRunOptions, RunOptions, parse_device_type
from .dwarfs import populate_registry


def is_groupby(dwarf_name: str) -> bool:
    """main.cpp:9-11."""
    return "GroupBy" in dwarf_name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dwarf_bench_tpu_torch",
        description="Dwarf bench (PyTorch + CUDA)",
    )
    p.add_argument(
        "dwarf",
        nargs="?",
        default="",
        help="Dwarf to run. List all with 'list'.",
    )
    p.add_argument(
        "--input_size",
        type=int,
        nargs="+",
        default=None,
        help="Data array size, usually a column size in elements",
    )
    p.add_argument(
        "--iterations",
        type=int,
        default=1,
        help="Number of iterations to run a bmark.",
    )
    p.add_argument(
        "--device",
        type=str,
        default="default",
        help="Device to run on (cpu | gpu; cuda is an alias of gpu).",
    )
    p.add_argument(
        "--report_path",
        type=str,
        default="",
        help="Full/Relative path to a report file.",
    )
    p.add_argument(
        "--groups_count",
        type=int,
        default=1,
        help="Number of unique keys for dwarfs with keys "
        "(groupby, hash build etc.).",
    )
    p.add_argument(
        "--executors",
        type=int,
        default=1,
        help="Number of executors for GroupByLocal.",
    )
    p.add_argument(
        "--extended_report",
        action="store_true",
        help="Add rows_per_s to the CSV (extension; default schema matches "
        "the reference byte-for-byte).",
    )
    p.add_argument(
        "--seed",
        type=int,
        default=0,
        help="Data-generation seed (deterministic; deviation from the "
        "reference's random_device).",
    )
    return p


def main(argv=None) -> int:
    registry = populate_registry()
    args = build_parser().parse_args(argv)

    if args.dwarf == "list":
        print("Supported dwarfs:")
        for name, _ in registry:
            print(f"\t{name}")
        return 0

    dwarf = registry.find(args.dwarf)
    if dwarf is None:
        print(
            "List supported dwarfs to run with "
            f"'{sys.argv[0]} list'",
            file=sys.stderr,
        )
        return 1

    opts = RunOptions(
        device_ty=parse_device_type(args.device),
        input_size=args.input_size or [1],
        iterations=args.iterations,
        report_path=args.report_path,
        seed=args.seed,
        extended_report=args.extended_report,
    )
    if is_groupby(args.dwarf):
        opts = GroupByRunOptions.from_options(
            opts, args.groups_count, args.executors
        )

    try:
        # fresh results per invocation (the registry is a long-lived
        # singleton; the reference constructs fresh dwarfs per process)
        dwarf.clear_results()
        dwarf.init(opts)
        dwarf.run(opts)
        dwarf.report(opts)
    except Exception as e:  # main.cpp:97-99
        print(f"Caught exception: {e!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
