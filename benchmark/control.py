"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size and load.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--seconds 2]

For each seed of ``--seeds`` one short window of the port, and for each of
``--control-seeds`` one of the control (the query kind's reference with a
guarantee broken, ``reference/<kind>.py``) in the port's place, all in one
process; each run's compared numbers are printed as one JSON line, then the
lower reading (the largest the port gave) and the upper reading (the
smallest the control gave) of each number. The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    params = cell.traffic.get("params", {})
    readings = {"program": {}, "control": {}}
    runs = [("program", s, None) for s in args.seeds] + [
        ("control", s, cell.kind.control(params)) for s in args.control_seeds]
    for side, seed, program in runs:
        result, errors = harness.run_cell(cell, seed, args.seconds, False,
                                          device, program=program)
        checks = {k: c["value"] for k, c in result["checks"].items()}
        for k, v in checks.items():
            readings[side].setdefault(k, []).append(v)
        print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": checks, "errors": errors}), flush=True)
    summary = {
        k: {"lower": max(readings["program"].get(k, [0])),
            "upper": min(readings["control"].get(k, [0])),
            "limit": c}
        for k, c in cell.kind.LIMITS.items()}
    print(json.dumps({"workload": cell.name, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
