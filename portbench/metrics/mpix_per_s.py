"""End to end: input megapixels of every request completed in the window,
over the window's seconds (first dispatch to the last request's end)."""

LAYER = "end to end"
MOVES = None


def read(rec: dict):
    done = [r for r in rec["requests"] if r.ok]
    if not done:
        return None
    w, h = rec["src"]
    return sum(r.frames for r in done) * w * h * 1e-6 / rec["window_s"]
