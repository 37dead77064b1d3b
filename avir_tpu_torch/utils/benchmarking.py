"""Timing helpers on the CUDA card.

Counterpart of the JAX package's ``utils/benchmarking.py``: ``wall_ms`` is
the best host wall time of a call that ends in ``torch.cuda.synchronize``;
``device_ms`` is the device time per call from CUDA events around ``n``
calls on the current stream, with a per-kernel breakdown from
``torch.profiler`` (empty when the profiler records no device time).  A
device measurement without a card raises; it never reports a CPU time
under a device name.
"""

from __future__ import annotations

import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def wall_ms(fn, *args, n: int = 10) -> float:
    """Best of ``n`` host wall times of ``fn(*args)`` in ms, after one
    warm-up call, each ending when the card is idle."""
    fn(*args)
    _sync()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def device_ms(fn, *args, n: int = 10) -> tuple[float, dict[str, float]]:
    """(device ms per call, {kernel name: ms per call}) of ``fn(*args)`` on
    the card: CUDA events around ``n`` calls after one warm-up call, then
    a ``torch.profiler`` pass for the breakdown."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA card")
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    end.synchronize()
    total = start.elapsed_time(end) / n
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if us > 0:
            ops[ev.key] = us / 1e3 / n
    return total, ops
