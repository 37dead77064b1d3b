"""End to end: process start to the start of the window (imports, CUDA
context, plan and operands, the frame pool, the warm-up requests; on a
checkout's first run also the kernels' build)."""

LAYER = "end to end"
MOVES = None


def read(rec: dict):
    return rec["setup_s"]
