"""Measure one cell of ``BENCHMARK.json`` on the CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from anywhere; the checkout is the directory above this file.  Prints
the route and the card on standard error, then the compared numbers beside
their limits as its last lines there, and one JSON line on standard
output: ``correct``, ``attempted`` and ``failed`` requests, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``.  Without a CUDA card it exits with 2 and prints no result.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)  # the checkout, not this directory

# Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = {"jax", "jaxlib", "flax", "avir_tpu"}


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e!r})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness, spec

    t_import = time.time() - T_PROCESS

    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(
            f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}"
        )
        return 2
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the CUDA context, before the planner's clock
    harness.log(
        f"set-up: torch imported at {t_import:.3f} s, "
        f"CUDA context at {time.time() - T_PROCESS:.3f} s"
    )
    rec = harness.measure(
        cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS
    )
    found = forbidden_modules()
    if found:
        harness.log(f"modules that may not be loaded are: {found}")
        return 3

    metrics = {}
    for m in spec.metrics_for(bench, cell.name, bool(args.trace)):
        value = spec.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sl = rec["slice"]
    dev = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": rec["memory_peak_bytes"],
    }
    if args.trace and sl is not None:
        dev["busy_s"] = sl.busy_s()
        dev["window_s"] = sl.span_s
    requests = rec["requests"]
    result = {
        "correct": rec["correct"],
        "attempted": len(requests),
        "failed": sum(not r.ok for r in requests),
        "metrics": metrics,
        "device": dev,
    }
    if args.trace and sl is not None:
        result["breakdown"] = {
            "device_ops": sl.seconds_by_op()[:10],
            "idle_gaps": sl.idle_gaps()[:10],
        }
    result["checks"] = rec["checks"]

    harness.log(f"card: {card_power_limit()}")
    harness.log(
        f"window {rec['window_s']:.3f} s, {len(requests)} requests, "
        f"checked {rec['checked_frames']} frames, bound {rec['bound']}"
    )
    if sl is not None:
        harness.log(
            f"traced slice {sl.span_s:.4f} s, {sl.frames} frames, "
            f"{len(sl.device_ops)} device operations, {len(sl.host_spans)} spans"
        )
    for name, c in rec["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
