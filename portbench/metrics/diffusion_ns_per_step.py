"""Kernels: K4's device time per frame in the traced slice (its
``wavefront`` operations) over the frame's dependent anti-diagonals,
W + 2(H - 1) (``diffusion.steps``): the pace of the diffusion's chain, in
ns a step.  None where the slice has no such operation."""

from portbench import diffusion

LAYER = "kernels"
MOVES = "mpix_per_s"


def read(rec: dict):
    k4_s = diffusion.seconds_a_frame(rec["slice"])
    n = diffusion.steps(rec["dst"])
    if k4_s is None or not n:
        return None
    return k4_s / n * 1e9
