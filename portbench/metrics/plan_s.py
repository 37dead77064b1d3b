"""Planner and operands: host seconds of the ``make_*_fn`` call in
set-up (planning, filter design, tap quantization, routing, operands to
the device)."""

LAYER = "planner and operands"
MOVES = "setup_s"


def read(rec: dict):
    return rec["plan_s"]
