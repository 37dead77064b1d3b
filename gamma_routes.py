"""The three int8 gamma routes timed against each other on the card, at
every full-size shape where the ring kernel K6 is viable.

Run from the root of a checkout, on a machine with an NVIDIA card and
nvcc:  python3 gamma_routes.py

At 7680x4320 -> 1920x1080, 3840x2160 -> 1280x720, 7680x4320 -> 1280x720
and 7680x4320 -> 960x540 u8 RGB, and 7680x4320 -> 1920x1080 u8 RGBA
(alpha index 3), all with sRGB gamma, it builds the executor of each
route that AVIR_TPU_GAMMA_ROUTE names ("ring": K6; "inkernel": K1 int8
vh with the linearization from its shared table; "prologue": K5, then K1
on the limb planes), checks that the three give the same bits on one
random image, and times each route's whole call with CUDA events (L2
flushed before each call) in turns: ring, inkernel, prologue, prologue,
inkernel, ring.  Prints one JSON line a shape: each route's two times in
ms, its launch key, the route "auto" builds, and the card.  The "auto"
rule of models/runtime.py rests on these times.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

# (name, src_w, src_h, new_w, new_h, channels): tests/test_torch_ring.py's
# AUTO_RING shapes.
SHAPES = (
    ("8k_to_1080p", 7680, 4320, 1920, 1080, 3),
    ("4k_to_720p", 3840, 2160, 1280, 720, 3),
    ("8k_to_720p", 7680, 4320, 1280, 720, 3),
    ("8k_to_540p", 7680, 4320, 960, 540, 3),
    ("8k_to_1080p_rgba", 7680, 4320, 1920, 1080, 4),
)
ROUTES = ("ring", "inkernel", "prologue")
CALLS = 30
SEED = 7


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from avir_tpu_torch.models.runtime import GAMMA_ROUTE_ENV, make_avir_executor
    from avir_tpu_torch.plan.plan import build_resize_plan

    dev = torch.device("cuda")
    card = cs._card()
    gen = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for name, sw, sh, nw, nh, c in SHAPES:
        plan = build_resize_plan(sw, sh, nw, nh, c, np.uint8, np.uint8,
                                 use_srgb_gamma=True, alpha_index=3 if c == 4 else -1)
        fns = {}
        try:
            for route in ROUTES:
                os.environ[GAMMA_ROUTE_ENV] = route
                fns[route] = make_avir_executor(plan, device=dev)
        finally:
            os.environ.pop(GAMMA_ROUTE_ENV, None)
        auto = make_avir_executor(plan, device=dev)
        x = torch.from_numpy(gen.integers(0, 256, (sh, sw * c), dtype=np.uint8)).to(dev)
        outs = {route: fn(x) for route, fn in fns.items()}
        outs["auto"] = auto(x)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(out, outs["inkernel"]) for out in outs.values())
        ms = {route: [] for route in ROUTES}
        for route in ROUTES + ROUTES[::-1]:
            ms[route].append(cs._time_ms(lambda: fns[route](x), CALLS, flush))
        print(json.dumps({
            "shape": name, "ms": ms, "bit_equal": bit_equal,
            "launch_key": {route: fn.ops.launch_key for route, fn in fns.items()},
            "auto": auto.ops.launch_key, "card": card,
        }), flush=True)
        if not bit_equal:
            return 1
        del fns, auto, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
