"""Report post-processing, the port of ``scripts/report.py`` (the
reference's scripts/report-sample.ipynb): per (device, size), drop the
slowest iteration (the warm-up) and take the mean of the rest; print a
table and optionally plot it.

    python -m dwarf_bench_tpu_torch.scripts.report report.csv \\
        [--column host_time_ms] [--plot out.png]

``--plot`` needs matplotlib and raises where it is not installed.
"""

from __future__ import annotations

import argparse
import csv
import sys
from collections import defaultdict


def load(path: str):
    with open(path) as f:
        return list(csv.DictReader(f))


def summarize(rows, column: str):
    """[(device, buf_size_bytes, mean of ``column``, iterations kept)],
    sorted by device and size."""
    groups = defaultdict(list)
    for r in rows:
        key = (r["device_type"], int(r["buf_size_bytes"]))
        groups[key].append(float(r[column]))
    out = []
    for (dev, size), vals in sorted(groups.items()):
        # drop the slowest iteration (warmup convention, notebook cells 6-7)
        if len(vals) > 1:
            vals = sorted(vals)[:-1]
        out.append((dev, size, sum(vals) / len(vals), len(vals)))
    return out


def table(summary, column: str) -> str:
    lines = [f"{'device':8s} {'buf_size_bytes':>16s} "
             f"{'mean_' + column:>20s} {'n':>4s}"]
    for dev, size, mean, n in summary:
        lines.append(f"{dev:8s} {size:16d} {mean:20.3f} {n:4d}")
    return "\n".join(lines)


def plot(summary, column: str, path: str) -> None:
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(f"--plot {path}: matplotlib is not installed "
                           "here; run the report without --plot") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    devices = sorted({d for d, _, _, _ in summary})
    fig, ax = plt.subplots(figsize=(8, 5))
    for dev in devices:
        pts = [(s, m) for d, s, m, _ in summary if d == dev]
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                label=dev)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("buffer size (bytes)")
    ax.set_ylabel(f"mean {column}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("csv_path")
    p.add_argument("--column", default="host_time_ms")
    p.add_argument("--plot", default="")
    args = p.parse_args(argv)

    rows = load(args.csv_path)
    if not rows:
        print("empty report", file=sys.stderr)
        return 1
    summary = summarize(rows, args.column)
    print(table(summary, args.column))
    if args.plot:
        plot(summary, args.column, args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
