"""Kernels: 100 x the error diffusion's bound for one frame
(``diffusion.py``: the float32 frame read once and the output written
once, over the HBM's rate) over K4's device time per frame in the traced
slice (its ``wavefront`` operations).  None where the slice has none."""

import numpy as np

from portbench import diffusion, spec

LAYER = "kernels"
MOVES = "mpix_per_s"


def read(rec: dict):
    k4_s = diffusion.seconds_a_frame(rec["slice"])
    if k4_s is None:
        return None
    config = spec.load_cell(spec.load_benchmark(), rec["cell"]).config
    out_itemsize = np.dtype(config["out_dtype"]).itemsize
    return 100.0 * diffusion.bound(rec["dst"], rec["channels"], out_itemsize)["bound_s"] / k4_s
