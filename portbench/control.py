"""The readings that the check's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For each seed of ``--seeds`` it makes the cell's frame pool, runs as many
requests as a run's check compares through the port's device function at
the cell's own size and load, and compares their outputs with the float64
reference: the sound readings.  For each seed of ``--control-seeds`` it
puts the reference computed in bfloat16 (the operators, the frames and
the intermediate) in the program's place and compares that: the control,
which has to come out as not correct.  One JSON line per seed.  The
benchmark's own runs do not run this.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)


def program_readings(cell, fn, ref, seed: int, device, scale: int = 1) -> dict:
    """The check's readings of the port's outputs for ``seed``: the
    cell's ``check_requests`` requests, back to back as in the window."""
    import torch

    from portbench import check, harness

    mix = cell.traffic
    src, _ = harness.geometry(mix, scale)
    pool = harness.make_pool(seed, mix["pool_frames"], (src[1], src[0], cell.config["channels"]), device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    client = harness.Client(fn, pool, mix["frames_per_request"], sync)
    readings = check.Readings()
    for k in range(mix["check_requests"]):
        req, outs = client.request(k)
        if not req.ok:
            readings.bad_frames += req.frames
            continue
        for j, out in enumerate(outs):
            readings.add(out, ref, ref.forward(client.frame(k, j)))
    return readings.result()


def control_readings(cell, ref, seed: int, device, scale: int = 1) -> dict:
    """The same readings with the bfloat16 reference as the program."""
    import torch

    from portbench import check, harness

    mix = cell.traffic
    src, _ = harness.geometry(mix, scale)
    pool = harness.make_pool(seed, mix["pool_frames"], (src[1], src[0], cell.config["channels"]), device)
    readings = check.Readings()
    n = mix["frames_per_request"]
    for k in range(mix["check_requests"]):
        for j in range(n):
            x = pool[(k * n + j) % pool.shape[0]]
            low = ref.finish(ref.forward(x, dtype=torch.bfloat16)).to(torch.uint8)
            readings.add(low, ref, ref.forward(x))
    return readings.result()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=int, default=1)
    args = p.parse_args(argv)
    import torch

    from portbench import harness, spec

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, args.workload)
    src, dst = harness.geometry(cell.traffic, args.scale)
    prog = spec.program(cell.config["resizer"])
    fn = prog.make(cell.config, src, dst, device)
    harness.log(f"route {cell.name}: {prog.route(fn)} src {src} dst {dst}")
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        line = {"cell": cell.name, "seed": seed}
        if seed in seeds:
            line["program"] = program_readings(cell, fn, ref, seed, device, args.scale)
        if seed in controls:
            line["control"] = control_readings(cell, ref, seed, device, args.scale)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
