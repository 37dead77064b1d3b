"""Set-up, the closed-loop client, the measured window and the check.

One client on one stream sends requests back to back: a request
dispatches each of its frames through the port's device function, waits
for the last output with a synchronisation, and records its latency.  The
frames come from a pool made on the device from the seed and walked
cyclically.  ``measure`` runs set-up, the window and the check and
returns what the metric readers read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import random
import sys
import time

import numpy as np
import torch

from . import check, roofline, spec, tracing

WARMUP_REQUESTS = 2
TRACE_FRAMES = 960  # frames in the traced slice, rounded up to whole requests


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Request:
    k: int
    start: float
    dispatched: float
    done: float
    frames: int
    ok: bool
    traced: bool = False

    @property
    def latency_s(self) -> float:
        return self.done - self.start

    @property
    def dispatch_s(self) -> float:
        return self.dispatched - self.start


def geometry(traffic: dict, scale: int = 1) -> tuple[tuple[int, int], tuple[int, int]]:
    """(src, dst) as (width, height), each side divided by ``scale`` (the
    CPU rehearsal's small copy of the mix)."""

    def cut(wh):
        return tuple(max(8, round(v / scale)) for v in wh)

    return cut(traffic["src"]), cut(traffic["dst"])


def make_pool(seed: int, frames: int, shape: tuple, device, dtype: str = "uint8") -> torch.Tensor:
    """``frames`` distinct uniform frames of ``shape`` and ``dtype``
    ("uint8" or "uint16", a configuration's ``in_dtype``), made on
    ``device`` from ``seed`` in one call."""
    dt = getattr(torch, dtype)
    if dt not in (torch.uint8, torch.uint16):
        raise ValueError(f"the pool holds uint8 or uint16 frames, not {dtype}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # u16 values are drawn as int32: not every build draws uint16 itself.
    draw = dt if dt == torch.uint8 else torch.int32
    return torch.randint(
        0, torch.iinfo(dt).max + 1, (frames, *shape), dtype=draw, device=device, generator=gen
    ).to(dt)


class Client:
    def __init__(self, fn, pool: torch.Tensor, frames_per_request: int, sync):
        self.fn, self.pool, self.frames, self.sync = fn, pool, frames_per_request, sync
        self.first_error = None

    def frame(self, k: int, j: int) -> torch.Tensor:
        return self.pool[(k * self.frames + j) % self.pool.shape[0]]

    def request(self, k: int, span=contextlib.nullcontext) -> tuple[Request, list | None]:
        start = time.perf_counter()
        try:
            with span(f"{tracing.SPAN_PREFIX}dispatch.{k}"):
                outs = [self.fn(self.frame(k, j)) for j in range(self.frames)]
            dispatched = time.perf_counter()
            with span(f"{tracing.SPAN_PREFIX}sync.{k}"):
                self.sync()
            done = time.perf_counter()
        except (RuntimeError, ValueError) as e:
            if self.first_error is None:
                self.first_error = repr(e)
                log(f"request {k} failed: {e!r}")
            now = time.perf_counter()
            return Request(k, start, now, now, self.frames, False), None
        return Request(k, start, dispatched, done, self.frames, True), outs


class Sample:
    """A reservoir of ``size`` completed requests with their outputs,
    drawn uniformly over the window from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen, self.kept = size, random.Random(seed), 0, []

    def offer(self, k: int, outs: list) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((k, outs))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = (k, outs)


def window(client: Client, seconds: float, sample: Sample, trace: bool, cuda: bool):
    """Requests back to back until ``seconds`` have passed; every request
    started before then runs to its end.  With ``trace``, the first whole
    requests of at least TRACE_FRAMES frames from a quarter of the way in
    run under the profiler.  Returns (requests, window seconds, slice, the
    slice's host seconds with the profiler's start and stop)."""
    requests, slice_, slice_wall_s = [], None, 0.0
    n_traced = math.ceil(TRACE_FRAMES / client.frames)
    k = 0

    def finish(req, outs):
        requests.append(req)
        if req.ok:
            sample.offer(req.k, outs)

    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        if trace and slice_ is None and time.perf_counter() >= start + seconds / 4:
            def run(span, k0=k):
                for n in range(n_traced):
                    req, outs = client.request(k0 + n, span)
                    req.traced = True
                    finish(req, outs)

            t0 = time.perf_counter()
            _, slice_ = tracing.traced(run, n_traced * client.frames, cuda)
            slice_wall_s = time.perf_counter() - t0
            k += n_traced
            continue
        finish(*client.request(k))
        k += 1
    return requests, requests[-1].done - start, slice_, slice_wall_s


def measure(
    cell: spec.Cell,
    seed: int,
    seconds: float,
    trace: bool,
    device: torch.device,
    t_process: float,
    scale: int = 1,
    fault=None,
) -> dict:
    """Set-up, the window and the check of one run on ``device``.
    ``t_process`` is the wall-clock time the process started (set-up is
    measured from it); ``fault`` wraps the device function (the tests'
    broken timed path)."""
    cfg, mix = cell.config, cell.traffic
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError("the harness drives one client in a closed loop")
    cuda = device.type == "cuda"
    src, dst = geometry(mix, scale)
    channels = cfg["channels"]
    prog = spec.program(cfg["resizer"])  # imports the port
    phases = {"port imported": time.time() - t_process}
    t0 = time.perf_counter()
    fn = prog.make(cfg, src, dst, device)
    plan_s = time.perf_counter() - t0
    phases["plan"] = time.time() - t_process
    route = prog.route(fn)
    log(f"route {cell.name}: {route} src {src} dst {dst}")
    if fault is not None:
        fn = fault(fn)
    pool = make_pool(seed, mix["pool_frames"], (src[1], src[0], channels), device, cfg["in_dtype"])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    client = Client(fn, pool, mix["frames_per_request"], sync)
    sync()
    phases["pool"] = time.time() - t_process
    for k in range(-WARMUP_REQUESTS, 0):
        client.request(k)
    setup_s = time.time() - t_process
    phases["warm-up"] = setup_s
    log("set-up, seconds from process start at the end of each phase: " + ", ".join(
        f"{name} {t:.3f}" for name, t in phases.items()))

    sample = Sample(mix["check_requests"], seed)
    requests, window_s, slice_, slice_wall_s = window(client, seconds, sample, trace, cuda)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else None

    # The program's state goes before the reference runs.
    del fn, client.fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = spec.reference(cfg["resizer"]).build(cfg, src, dst)
    readings = check.Readings(getattr(torch, cfg["out_dtype"]))
    readings.bad_frames += sum(r.frames for r in requests if not r.ok)
    for k, outs in sample.kept:
        readings.bad_frames += mix["frames_per_request"] - len(outs)
        readings.add_all(outs, ref, (ref.forward(client.frame(k, j)) for j in range(len(outs))))
    correct, checks = check.judge(readings.result(), cell.limits)
    in_size, out_size = (np.dtype(cfg[k]).itemsize for k in ("in_dtype", "out_dtype"))
    return {
        "cell": cell.name,
        "seed": seed,
        "route": route,
        "src": src,
        "dst": dst,
        "channels": channels,
        "setup_s": setup_s,
        "plan_s": plan_s,
        "requests": requests,
        "window_s": window_s,
        "slice": slice_,
        "slice_wall_s": slice_wall_s,
        "memory_peak_bytes": memory_peak,
        "bound": roofline.bound(ref, channels, in_size, out_size),
        "correct": correct,
        "checks": checks,
        "checked_frames": readings.frames,
    }
