"""The port's tracer (avir_tpu_torch/utils/trace.py) on the CPU: off by
default, the set-up and frame spans with their nesting and request, the
store's bound, and the garbage collector's spans."""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

import avir_tpu_torch as at
from avir_tpu_torch.utils import trace


@pytest.fixture
def tracer():
    trace.disable()
    trace.request(None)
    trace.drain()
    yield trace
    trace.disable()
    trace.request(None)
    trace.drain()


def small_fns():
    fa = at.make_resize_fn((48, 64, 3), np.uint8, 32, 24, device="cpu")
    fl = at.make_lancir_resize_fn((48, 64, 3), np.uint8, 128, 96, device="cpu")
    return fa, fl


def frame(seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (48, 64, 3), dtype=torch.uint8, generator=gen)


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_by_default_and_an_untraced_call_records_nothing(tracer):
    assert trace.on is False
    fa, fl = small_fns()
    fa(frame())
    fl(frame())
    gc.collect()
    assert trace.drain() == ([], 0)
    assert trace._on_gc not in gc.callbacks


@pytest.mark.parametrize("make", [at.make_resize_fn, at.make_lancir_resize_fn])
def test_set_up_tree(tracer, make):
    trace.enable()
    make((48, 64, 3), np.uint8, 32, 24, device="cpu")
    trace.disable()
    spans, dropped = trace.drain()
    assert dropped == 0
    root, = by_name(spans, "setup.make_fn")
    assert root.parent is None
    kids = [s for s in spans if s.parent == root.id and not s.name.startswith("gc.")]
    assert [s.name for s in kids] == ["setup.plan", "setup.operands"]
    plan, operands = kids
    assert root.start_ns <= plan.start_ns <= plan.end_ns <= operands.start_ns
    assert operands.end_ns <= root.end_ns
    assert all(s.thread == root.thread and s.request is None for s in spans)


def test_frame_holds_k1_call_with_the_request(tracer):
    fa, fl = small_fns()
    x = frame(1)
    want_a, want_l = fa(x), fl(x)
    trace.enable()
    trace.request(41)
    got_a = fa(x)
    trace.request(42)
    got_l = fl(x)
    trace.request(None)
    fa(x)
    trace.disable()
    spans, _ = trace.drain()
    assert torch.equal(got_a, want_a) and torch.equal(got_l, want_l)
    frames = by_name(spans, "frame")
    calls = by_name(spans, "k1.call")
    assert [f.request for f in frames] == [41, 42, None]
    assert len(calls) == 3
    for f, c in zip(frames, calls):
        assert f.parent is None and c.parent == f.id and c.request == f.request
        assert f.start_ns <= c.start_ns <= c.end_ns <= f.end_ns
    # On the CPU the plain version runs: no launch.
    assert by_name(spans, "k1.launch") == []


def test_drain_empties_the_store_and_the_bound_counts_drops(tracer, monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 5)
    gc.disable()  # no collection spans among the eight
    try:
        trace.enable()
        for _ in range(8):
            trace.call("x", int, 3)
        with trace.span("y"):
            pass
        trace.disable()
    finally:
        gc.enable()
    spans, dropped = trace.drain()
    assert [s.name for s in spans] == ["x"] * 5 and dropped == 4
    assert trace.drain() == ([], 0)


def test_span_nesting_and_errors(tracer):
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("outer"):
            trace.call("inner", int, "3")
            trace.call("bad", int, "x")
    with trace.span("after"):
        pass
    trace.disable()
    spans, _ = trace.drain()
    names = {s.name: s for s in spans}
    assert set(names) >= {"outer", "inner", "bad", "after"}
    assert names["inner"].parent == names["outer"].id
    assert names["bad"].parent == names["outer"].id
    assert names["after"].parent is None


def test_gc_spans_only_while_on(tracer):
    gc.disable()  # only the collections the test asks for
    try:
        gc.collect()
        assert trace.drain() == ([], 0)
        trace.enable()
        trace.request(5)
        with trace.span("work"):
            gc.collect(1)
        gc.collect()
        trace.disable()
        gc.collect()
    finally:
        gc.enable()
    spans, _ = trace.drain()
    work, = by_name(spans, "work")
    inner, = by_name(spans, "gc.gen1")
    outer, = by_name(spans, "gc.gen2")
    assert inner.parent == work.id and outer.parent is None
    assert inner.request == outer.request == 5
    assert len([s for s in spans if s.name.startswith("gc.")]) == 2
