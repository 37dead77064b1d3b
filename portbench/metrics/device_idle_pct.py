"""Device: 100 x (1 - the device time per frame over the time per frame
of the window's untraced requests).  The device time per frame is the
traced slice's (device operations only: the profiler does not slow them);
the pace is the untraced requests', since under the profiler each launch
costs the host more, and a slice's own idle share reads that cost."""

LAYER = "device"
MOVES = "mpix_per_s"


def read(rec: dict):
    sl = rec["slice"]
    if sl is None or not sl.device_ops:
        return None
    frames = sum(r.frames for r in rec["requests"] if r.ok and not r.traced)
    if not frames:
        return None
    pace = (rec["window_s"] - rec["slice_wall_s"]) / frames
    return 100.0 * (1.0 - sl.device_seconds() / sl.frames / pace)
