"""End to end: the 95th percentile (nearest rank) of the latency of every
request completed in the window, from its first dispatch to the end of
the synchronisation on its last output."""

import math

LAYER = "end to end"
MOVES = None


def read(rec: dict):
    lat = sorted(r.latency_s for r in rec["requests"] if r.ok)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
