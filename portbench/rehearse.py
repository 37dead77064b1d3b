"""Rehearse a cell on the CPU, at a small size, through the port's plain
PyTorch versions of its kernels (``device="cpu"``).

    python3 portbench/rehearse.py --workload <cell> [--seed 1] [--seconds 2] [--scale 16] [--trace 0|1]

It runs the cell's set-up, loop, check and metric readers, and prints one
JSON line with the route, the check and which readers found something to
read.  It prints no metric's value: a CPU time is no device metric.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--scale", type=int, default=16)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from portbench import harness, spec

    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, args.workload)
    rec = harness.measure(
        cell, args.seed, args.seconds, bool(args.trace), torch.device("cpu"),
        T_PROCESS, scale=args.scale,
    )
    found, empty = [], []
    for m in spec.metrics_for(bench, cell.name, bool(args.trace)):
        value = spec.metric_reader(m["name"]).read(rec)
        (empty if value is None else found).append(m["name"])
    print(json.dumps({
        "rehearsal": "cpu",
        "cell": cell.name,
        "correct": rec["correct"],
        "route": rec["route"],
        "src": rec["src"],
        "dst": rec["dst"],
        "requests": len(rec["requests"]),
        "failed": sum(not r.ok for r in rec["requests"]),
        "checked_frames": rec["checked_frames"],
        "readers_found": found,
        "readers_empty": empty,
        "checks": rec["checks"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
