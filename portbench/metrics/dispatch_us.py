"""Device function and K1 host call: host microseconds per frame call,
with no sync, over the window's untraced requests (each request's
dispatch span summed, over their frames)."""

LAYER = "device function and K1 host call"
MOVES = "mpix_per_s"


def read(rec: dict):
    reqs = [r for r in rec["requests"] if r.ok and not r.traced]
    frames = sum(r.frames for r in reqs)
    if not frames:
        return None
    return sum(r.dispatch_s for r in reqs) / frames * 1e6
