"""Spans of the port's own layers, on the host's wall clock.

Off by default.  ``enable()`` turns it on and ``disable()`` off;
``request(k)`` sets the caller's request identifier, which every span
started while it is set carries (``None`` clears it); ``drain()`` returns
the recorded spans with the count of those dropped past ``LIMIT``, and
empties the store.

A span is a ``Span``: its name, start and end in ns of ``time.time_ns()``
(the clock ``torch.profiler``'s Chrome trace places through its
``baseTimeNanoseconds``), the request, its own id, the id of the span open
around it on the same thread (its parent, or None) and that thread.

Span sites on a per-frame path test ``trace.on`` once and take the plain
path when it is false::

    if trace.on:
        return trace.call("frame", body, x)
    return body(x)

The set-up path uses the context manager ``span(name)``.  While the
tracer is on, each collection of Python's garbage collector is a span
named ``gc.gen<n>``, a child of the span it interrupted.

The port's spans: ``setup.make_fn`` (a ``make_resize_fn`` or
``make_lancir_resize_fn`` call) around ``setup.plan`` (the plan) and
``setup.operands`` (the executor: operators, routing, operands on the
device), which holds ``setup.ring_operands`` where an int8 gamma plan
on the "ring" route tries the ring kernel K6 (its viability and cluster
plan); ``frame`` (a device function's call) around ``k1.call``
(``apply_fused_int8``) or ``k6.call`` (``apply_fused_ring``), or on the
split route ``split.call`` (``apply_fused_split``) and, for an
error-diffused output, then ``k4.call`` (``errdiff_wavefront``); each
call around its ``k1.launch``, ``k6.launch``, ``split.launch`` or
``k4.launch`` (the kernel's ``ctypes`` call, on the card only).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from typing import NamedTuple

LIMIT = 1 << 20  # spans kept until drained; later ones are counted as dropped

on = False  # the one global a span site tests

_records: list[tuple] = []
_dropped = 0
_request = None
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    request: object
    id: int
    parent: int | None
    thread: int


def enable() -> None:
    """Record spans (and the garbage collector's collections) from now on."""
    global on
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    on = True


def disable() -> None:
    """Record nothing more; what is recorded stays until drained."""
    global on
    on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def request(k) -> None:
    """Tag every span started from now on with ``k`` (None: no request)."""
    global _request
    _request = k


def drain() -> tuple[list[Span], int]:
    """(the spans recorded since the last drain, in the order they ended;
    the number dropped past LIMIT), and empty the store."""
    global _records, _dropped
    with _lock:
        records, dropped = _records, _dropped
        _records, _dropped = [], 0
    return [Span(*r) for r in records], dropped


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _begin() -> tuple:
    stack = _stack()
    sid = next(_ids)
    parent = stack[-1] if stack else None
    stack.append(sid)
    return sid, parent, _request, time.time_ns()


def _end(name: str, opened: tuple) -> None:
    t1 = time.time_ns()
    sid, parent, req, t0 = opened
    _stack().pop()
    if len(_records) < LIMIT:
        _records.append((name, t0, t1, req, sid, parent, threading.get_ident()))
    else:
        _drop()


def _drop() -> None:
    global _dropped
    with _lock:
        _dropped += 1


def call(name: str, f, *args):
    """``f(*args)`` inside a span ``name`` (``_begin`` and ``_end`` inlined:
    this is the per-frame path)."""
    try:
        stack = _local.stack
    except AttributeError:
        stack = _local.stack = []
    sid = next(_ids)
    parent = stack[-1] if stack else None
    stack.append(sid)
    req = _request
    t0 = time.time_ns()
    try:
        return f(*args)
    finally:
        t1 = time.time_ns()
        stack.pop()
        if len(_records) < LIMIT:
            _records.append((name, t0, t1, req, sid, parent, threading.get_ident()))
        else:
            _drop()


@contextlib.contextmanager
def span(name: str):
    """A span ``name`` around the ``with`` block, while the tracer is on."""
    if not on:
        yield
        return
    opened = _begin()
    try:
        yield
    finally:
        _end(name, opened)


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _local.gc = _begin()
    elif getattr(_local, "gc", None) is not None:
        opened, _local.gc = _local.gc, None
        _end(f"gc.gen{info['generation']}", opened)
