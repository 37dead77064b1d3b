"""Kernels: 100 x the benchmark's bound for one frame over the device time
of all operations per frame in the traced slice."""

LAYER = "kernels"
MOVES = "mpix_per_s"


def read(rec: dict):
    sl = rec["slice"]
    if sl is None or not sl.device_ops:
        return None
    return 100.0 * rec["bound"]["bound_s"] / (sl.device_seconds() / sl.frames)
