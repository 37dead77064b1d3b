"""The readings that the check's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 [--dither errdiff]

For each seed of ``--seeds`` it makes the cell's frame pool, runs as many
requests as a run's check compares through the port's device function at
the cell's own size and load, and compares their outputs with the float64
reference: the sound readings.  For each seed of ``--control-seeds`` it
puts the reference computed in bfloat16 (the operators, the frames and
the intermediate) in the program's place and compares that: the control,
which has to come out as not correct.  For a dithering reference (one
with ``errdiff``) the bfloat16 frame is error-diffused as well, and a
second control beside it, ``control_rounded``, is the float64 frame
rounded with no diffusion.  ``--dither`` runs the cell's configuration
with another dither, and the reference with it: the readings that a
dithering cell's limits are set from before that cell exists.  One JSON
line per seed, with the seconds that each side took: the program's
include its requests, which take well under a second.  The benchmark's
own runs do not run this.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
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
    pool = cell_pool(cell, seed, device, scale)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    client = harness.Client(fn, pool, mix["frames_per_request"], sync)
    readings = check.Readings(getattr(torch, cell.config["out_dtype"]))
    for k in range(mix["check_requests"]):
        req, outs = client.request(k)
        if not req.ok:
            readings.bad_frames += req.frames
            continue
        readings.add_all(outs, ref, (ref.forward(client.frame(k, j)) for j in range(len(outs))))
    return readings.result()


def cell_pool(cell, seed: int, device, scale: int = 1):
    """The frame pool that a run of ``cell`` with ``seed`` makes."""
    from portbench import harness

    mix = cell.traffic
    src, _ = harness.geometry(mix, scale)
    shape = (src[1], src[0], cell.config["channels"])
    return harness.make_pool(seed, mix["pool_frames"], shape, device, cell.config["in_dtype"])


def control_readings(cell, ref, seed: int, device, scale: int = 1, rounded: bool = False) -> dict:
    """The same readings with the bfloat16 reference as the program; with
    ``rounded``, the float64 reference rounded with no diffusion."""
    import torch

    from portbench import check

    mix = cell.traffic
    pool = cell_pool(cell, seed, device, scale)
    out_dtype = getattr(torch, cell.config["out_dtype"])
    readings = check.Readings(out_dtype)
    plain = dataclasses.replace(ref, errdiff=None)
    n = mix["frames_per_request"]
    for k in range(mix["check_requests"]):
        frames = [pool[(k * n + j) % pool.shape[0]] for j in range(n)]
        if rounded:
            lows = [plain.finish(ref.forward(x)).to(out_dtype) for x in frames]
        else:
            # Frames finished together: a diffusion walks them all at once.
            g = max(1, check.GROUP_BYTES // (8 * ref.v.shape[0] * ref.h.shape[0] * frames[0].shape[-1]))
            lows = []
            for i in range(0, n, g):
                y = torch.stack([ref.forward(x, dtype=torch.bfloat16) for x in frames[i : i + g]])
                lows += list(ref.finish(y).to(out_dtype))
        readings.add_all(lows, ref, (ref.forward(x) for x in frames))
    return readings.result()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=int, default=1)
    p.add_argument("--dither", help="run the configuration with this dither")
    args = p.parse_args(argv)
    import torch

    from portbench import check, harness, spec

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, args.workload)
    if args.dither:
        cell = dataclasses.replace(cell, config={**cell.config, "dither": args.dither})
    src, dst = harness.geometry(cell.traffic, args.scale)
    prog = spec.program(cell.config["resizer"])
    fn = prog.make(cell.config, src, dst, device)
    harness.log(
        f"route {cell.name}: {prog.route(fn)} src {src} dst {dst} dither "
        f"{cell.config['dither']} tolerance {check.TOLERANCE}"
    )
    ref = spec.reference(cell.config["resizer"]).build(cell.config, src, dst)
    sides = {
        "program": lambda seed: program_readings(cell, fn, ref, seed, device, args.scale),
        "control": lambda seed: control_readings(cell, ref, seed, device, args.scale),
        "control_rounded": lambda seed: control_readings(
            cell, ref, seed, device, args.scale, rounded=True
        ),
    }
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        line = {"cell": cell.name, "dither": cell.config["dither"], "seed": seed, "seconds": {}}
        wanted = ["program"] * (seed in seeds) + ["control"] * (seed in controls)
        if seed in controls and ref.errdiff is not None:
            wanted.append("control_rounded")
        for side in wanted:
            t0 = time.perf_counter()
            line[side] = sides[side](seed)
            line["seconds"][side] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
