"""Split the host's time of a cell of ``BENCHMARK.json`` by the port's own
spans (avir_tpu_torch/utils/trace.py), on the CUDA card.

    python3 span_split.py --workload <cell> --seed <n> [--seconds 10]

It runs the cell as ``portbench/run.py`` does (the port's device function,
the frame pool made on the card from the seed, two warm-up requests, one
client in a closed loop for ``--seconds``), with the tracer on in three
places:

- set-up: around the first ``make`` (``setup.plan``, ``setup.operands``
  and, where the ring kernel K6 is tried, ``setup.ring_operands``);
  after the window, ``make`` again with the tracer off and on in turns;
- a quarter into the window: whole requests of at least 960 frames under
  ``torch.profiler``, as the benchmark's traced slice, with the tracer on;
  each idle gap of the card is named by the benchmark's request span and
  the innermost port span open at its middle, and the kernels' launches
  in the slice are counted by form (``forms_now``);
- half way in: the first whole requests of at least 960 frames and 16
  requests with the tracer on and no profiler (the span slice): the
  per-frame split and the turnaround between requests.

Every other request runs untraced and gives ``dispatch_us`` and the pace,
as the benchmark's reader does.  After the window, blocks of requests run
with the tracer off and on in turns (its cost a frame), and a span site
alone is timed off and on.  Prints one JSON line.  With ``--device
cpu`` (a rehearsal, small with ``--scale``) the port's plain versions run
and the line says which readings were found, not their values.
"""

import argparse
import collections
import gc
import json
import math
import statistics
import subprocess
import sys
import time

TRACE_FRAMES = 960  # frames in each slice, rounded up to whole requests
SPAN_REQUESTS = 16  # requests in the span slice, at least
SETUP_PAIRS = 2  # make() with the tracer off, then on, this many times
ALTERNATING_PAIRS = 5  # blocks of requests with the tracer off and on, after the window
# The kernels whose host call and launch the port spans: K1 int8, K6, K1
# split and K4.
KERNELS = ("k1", "k6", "split", "k4")
# A frame's parts: its own time, then each kernel's call (self) and launch.
PARTS = ("fn_self_us",) + tuple(f"{k}_{p}_us" for k in KERNELS for p in ("prep", "launch"))
LAUNCHES = {f"{k}.launch" for k in KERNELS}


def forms_now() -> dict:
    """The port's launch counters by form, copied: K1 split's by
    instantiation (``fused_split.forms``), K1 int8 hv's by pipeline form
    (``fused_kernel.hv_forms``) and K4's by launch bound
    (``wavefront.forms``)."""
    from avir_tpu_torch.ops.cuda import fused_kernel, fused_split, wavefront

    return {
        "split": dict(fused_split.forms),
        "hv": dict(fused_kernel.hv_forms),
        "k4": {str(k): v for k, v in wavefront.forms.items()},
    }


def forms_since(before: dict) -> dict:
    """The launches by form counted since ``forms_now`` gave ``before``,
    the forms that took none left out."""
    return {
        kind: {k: v - before[kind].get(k, 0) for k, v in counts.items()
               if v > before[kind].get(k, 0)}
        for kind, counts in forms_now().items()
    }


def children_ns(spans) -> collections.Counter:
    """{span id: the summed duration of its direct children in ns} (a
    thread's children never overlap)."""
    kids = collections.Counter()
    for s in spans:
        if s.parent is not None:
            kids[s.parent] += s.end_ns - s.start_ns
    return kids


def per_frame(spans) -> dict:
    """The span slice's means over its frames, in us: ``frame``'s self
    time (``fn_self_us``), each kernel's ``<k>.call`` self time
    (``k1_prep_us``, ``k6_prep_us``, ``split_prep_us``, ``k4_prep_us``)
    and ``<k>.launch`` duration (``k1_launch_us`` and so on), None for a
    kernel no frame calls; launches a frame; and the garbage collector's
    spans."""
    parts = frame_parts(spans)
    n = len(parts)
    if not n:
        return {"frames": 0}

    def mean_us(name):
        vals = [p[2][name] for p in parts if p[2][name] is not None]
        return sum(vals) / n * 1e-3 if vals else None

    gcs = [s for s in spans if s.name.startswith("gc.")]
    gc_us = collections.Counter()
    for s in gcs:
        gc_us[s.name] += (s.end_ns - s.start_ns) * 1e-3
    return {
        "frames": n,
        **{name: mean_us(name) for name in PARTS},
        "launches_per_frame": sum(
            p[2][f"{k}_launch_us"] is not None for p in parts for k in KERNELS
        ) / n,
        "gc_us": dict(sorted(gc_us.items())),
        "gc_count": collections.Counter(s.name for s in gcs),
    }


def frame_parts(spans) -> list:
    """[(request, start ns, {part: ns}), ...], one a ``frame`` span; the
    parts are PARTS (None where the frame has no such part)."""
    kids = children_ns(spans)
    by_parent = collections.defaultdict(list)
    for s in spans:
        by_parent[s.parent].append(s)
    out = []
    for f in spans:
        if f.name != "frame":
            continue
        got = dict.fromkeys(PARTS)
        got["fn_self_us"] = f.end_ns - f.start_ns - kids[f.id]
        for k in KERNELS:
            calls = [c for c in by_parent[f.id] if c.name == f"{k}.call"]
            if calls:
                c = calls[0]
                got[f"{k}_prep_us"] = c.end_ns - c.start_ns - kids[c.id]
                launches = [x for x in by_parent[c.id] if x.name == f"{k}.launch"]
                if launches:
                    got[f"{k}_launch_us"] = launches[0].end_ns - launches[0].start_ns
        out.append((f.request, f.start_ns, got))
    return out


def first_and_later(spans) -> dict:
    """Medians in us of each part of a frame call, for each request's first
    frame and for its later ones."""
    parts = sorted(frame_parts(spans), key=lambda p: p[1])
    seen, groups = set(), {"first": [], "later": []}
    for p in parts:
        groups["later" if p[0] in seen else "first"].append(p)
        seen.add(p[0])
    out = {}
    for group, rows in groups.items():
        for name in PARTS:
            vals = [r[2][name] for r in rows if r[2][name] is not None]
            if vals:
                out[f"{group}.{name}"] = statistics.median(vals) * 1e-3
    return out


def span_cost_ns(n: int = 100_000) -> dict:
    """ns a span site costs on this host: off (the test and a plain call)
    and on (``trace.call`` around the same call), best of three runs of
    ``n`` calls each."""
    from avir_tpu_torch.utils import trace

    def body(i):
        return i

    def site(i):
        if trace.on:
            return trace.call("x", body, i)
        return body(i)

    best = {}
    for state in ("bare", "off", "on") * 3:
        f = body if state == "bare" else site
        if state == "on":
            trace.enable()
        t0 = time.perf_counter_ns()
        for i in range(n):
            f(i)
        ns = (time.perf_counter_ns() - t0) / n
        trace.disable()
        trace.drain()
        best[state] = min(best.get(state, ns), ns)
    return best


def alternating(client, k0: int, n: int, pairs: int = ALTERNATING_PAIRS) -> dict:
    """Blocks of ``n`` requests with the tracer off and on in turns (off,
    on, on, off, ...), after the window: the median dispatch a frame of
    each state's blocks, in us, and their difference (the tracer's cost
    on, the port's spans alone)."""
    from avir_tpu_torch.utils import trace

    per = {"off": [], "on": []}
    k = k0
    for state in ("off", "on", "on", "off") * (pairs // 2) + ("off", "on") * (pairs % 2):
        if state == "on":
            trace.enable()
        reqs = []
        for _ in range(n):
            trace.request(k if state == "on" else None)
            reqs.append(client.request(k)[0])  # its outputs freed at once, as in the window
            k += 1
        trace.request(None)
        trace.disable()
        trace.drain()
        per[state].append(dispatch_per_frame_us(reqs))
    off, on = statistics.median(per["off"]), statistics.median(per["on"])
    return {"dispatch_us_off": per["off"], "dispatch_us_on": per["on"],
            "tracer_on_us_a_frame": on - off}


def _request_of(name: str) -> int:
    return int(name.rsplit(".", 1)[1])


def turnaround(spans) -> dict:
    """Medians over the span slice's requests after its first, in us: from
    the end of ``pb.sync.<k-1>`` to the end of request k's first kernel
    launch, ``<k>.launch`` of KERNELS (``turnaround_us``: host time in which
    the card has no work of the loop's), and its parts: ``pb.finish.<k-1>``,
    from there to ``pb.dispatch.<k>``, and from there to the first launch's
    end."""
    ends, starts = {}, {}
    for s in spans:
        for kind in ("sync", "finish", "dispatch"):
            if s.name.startswith(f"pb.{kind}."):
                k = _request_of(s.name)
                ends[kind, k], starts[kind, k] = s.end_ns, s.start_ns
    first = {}
    for s in spans:
        if s.name in LAUNCHES and s.request is not None:
            first[s.request] = min(first.get(s.request, s.end_ns), s.end_ns)
    parts = collections.defaultdict(list)
    for k in sorted(first):
        if ("sync", k - 1) not in ends or ("dispatch", k) not in starts:
            continue
        parts["turnaround_us"].append(first[k] - ends["sync", k - 1])
        if ("finish", k - 1) in ends:
            parts["finish_us"].append(ends["finish", k - 1] - starts["finish", k - 1])
            parts["to_dispatch_us"].append(starts["dispatch", k] - ends["finish", k - 1])
        parts["to_first_launch_us"].append(first[k] - starts["dispatch", k])
    out = {name: statistics.median(v) * 1e-3 for name, v in parts.items()}
    out["turnaround_requests"] = len(parts["turnaround_us"])
    return out


def innermost(spans_us, t_us: float):
    """The name of the innermost span of ``spans_us`` [(name, start, end)]
    open at ``t_us``, or None."""
    open_ = [(s, -e, n) for n, s, e in spans_us if s <= t_us <= e]
    return max(open_)[2] if open_ else None


def named_gaps(sl, port_spans, base_ns: int) -> list:
    """The profiler slice's idle gaps, [[name, seconds], ...] the longest
    first: the benchmark's request span at the gap's middle (as its
    ``breakdown`` names it), then ``/`` and the innermost port span there."""
    port_us = [(s.name, (s.start_ns - base_ns) * 1e-3, (s.end_ns - base_ns) * 1e-3)
               for s in port_spans]
    edges = [sl.start_us]
    for s, e in sl.busy_intervals():
        edges += [s, e]
    edges.append(sl.end_us)
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            name = sl.host_activity(mid)
            inner = innermost(port_us, mid)
            gaps.append([f"{name} / {inner}" if inner else name, (b - a) * 1e-6])
    return sorted(gaps, key=lambda p: -p[1])


def sync_tails_us(sl) -> list:
    """For each ``pb.sync`` span of the profiler slice that the card's last
    operation ended inside: the us from that end to the sync's return (the
    host's wake-up, on the profiler's clock)."""
    busy = sl.busy_intervals()
    tails = []
    for name, s, d in sl.host_spans:
        if name.startswith("pb.sync."):
            ends = [e for _, e in busy if s <= e <= s + d]
            if ends:
                tails.append(s + d - max(ends))
    return tails


def gap_totals(gaps) -> dict:
    """Idle seconds summed by the gap's kind (dispatch, sync, finish,
    between requests) and port span."""
    total = collections.Counter()
    for name, sec in gaps:
        where, _, inner = name.partition(" / ")
        kind = where if where == "between requests" else where.split(" ")[0]
        total[f"{kind} / {inner}" if inner else kind] += sec
    return dict(total.most_common())


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e!r})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def window(client, seconds: float, sample, cuda: bool,
           trace_frames: int = TRACE_FRAMES, span_requests: int = SPAN_REQUESTS) -> dict:
    """The closed loop, with the profiler slice a quarter in and the span
    slice half way in (both run, if the window ends first)."""
    from avir_tpu_torch.utils import trace
    from portbench import tracing

    requests, marked = [], set()
    n_prof = math.ceil(trace_frames / client.frames)
    n_span = max(math.ceil(trace_frames / client.frames), span_requests)
    got = {}

    def finish(req, outs):
        requests.append(req)
        if req.ok:
            sample.offer(req.k, outs)

    def slice_requests(k0, n, span, profiled=False):
        trace.enable()
        for k in range(k0, k0 + n):
            trace.request(k)
            res = client.request(k, span)
            res[0].traced = profiled
            with span(f"{tracing.SPAN_PREFIX}finish.{k}"):
                finish(*res)
                del res
        trace.request(None)
        trace.disable()
        marked.update(range(k0, k0 + n))

    k = 0
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline or "spans" not in got:
        now = time.perf_counter()
        if "prof" not in got and now >= start + seconds / 4:
            holder = []

            def run(span, k0=k):
                holder.append(span)
                slice_requests(k0, n_prof, span, profiled=True)

            t0 = time.perf_counter()
            before = forms_now()
            _, sl = tracing.traced(run, n_prof * client.frames, cuda)
            got["prof_wall_s"] = time.perf_counter() - t0
            got["prof_forms"] = forms_since(before)
            raw = holder[0].spans[0][1]
            got["prof"] = sl, trace.drain()[0], raw - round(sl.host_spans[0][1] * 1e3)
            k += n_prof
            continue
        if "spans" not in got and now >= start + seconds / 2:
            t0 = time.perf_counter()
            slice_requests(k, n_span, trace.span)
            got["span_wall_s"] = time.perf_counter() - t0
            got["spans"], got["dropped"] = trace.drain()
            got["spanned"] = set(range(k, k + n_span))
            k += n_span
            continue
        finish(*client.request(k))
        k += 1
    got["requests"] = requests
    got["plain"] = [r for r in requests if r.ok and r.k not in marked]
    got["window_s"] = requests[-1].done - start
    return got


def host_parts(split: dict) -> list:
    """[fn_self_us, then prep and launch of each kernel the frames call]
    (K1's where they call none)."""
    called = [k for k in KERNELS if split.get(f"{k}_prep_us") is not None] or [KERNELS[0]]
    return [split.get("fn_self_us")] + [
        split.get(f"{k}_{p}_us") for k in called for p in ("prep", "launch")
    ]


def dispatch_per_frame_us(reqs):
    frames = sum(r.frames for r in reqs)
    return sum(r.dispatch_s for r in reqs) / frames * 1e6 if frames else None


def measure(cell, seed: int, seconds: float, device, scale: int = 1,
            trace_frames: int = TRACE_FRAMES, span_requests: int = SPAN_REQUESTS,
            alternating_pairs: int = ALTERNATING_PAIRS) -> dict:
    import torch

    from avir_tpu_torch.utils import trace
    from portbench import harness, spec

    cfg, mix = cell.config, cell.traffic
    cuda = device.type == "cuda"
    src, dst = harness.geometry(mix, scale)
    prog = spec.program(cfg["resizer"])

    def make():
        t0 = time.perf_counter()
        fn = prog.make(cfg, src, dst, device)
        return fn, time.perf_counter() - t0

    trace.enable()
    fn, plan_s = make()
    trace.disable()
    setup, _ = trace.drain()
    dur = {s.name: (s.end_ns - s.start_ns) * 1e-9 for s in setup}
    pool = harness.make_pool(
        seed, mix["pool_frames"], (src[1], src[0], cfg["channels"]), device, cfg["in_dtype"]
    )
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    client = harness.Client(fn, pool, mix["frames_per_request"], sync)
    sync()
    for k in range(-harness.WARMUP_REQUESTS, 0):
        client.request(k)
    sample = harness.Sample(mix["check_requests"], seed)
    got = window(client, seconds, sample, cuda, trace_frames, span_requests)
    failed = sum(not r.ok for r in got["requests"])
    n_block = max(math.ceil(trace_frames / client.frames), span_requests)
    alt = alternating(client, got["requests"][-1].k + 1, n_block, alternating_pairs)
    cost_ns = span_cost_ns()

    del fn, client.fn, sample
    gc.collect()
    makes = {"off": [], "on": []}
    for _ in range(SETUP_PAIRS):
        for state in ("off", "on"):
            if state == "on":
                trace.enable()
            extra, seconds_ = make()
            trace.disable()
            trace.drain()
            makes[state].append(seconds_)
            del extra
            gc.collect()

    spans = got["spans"]
    spanned = [r for r in got["requests"] if r.ok and r.k in got["spanned"]]
    plain_us = dispatch_per_frame_us(got["plain"])
    spanned_us = dispatch_per_frame_us(spanned)
    split = per_frame(spans)
    sl, prof_spans, base_ns = got["prof"]
    gaps = named_gaps(sl, prof_spans, base_ns)
    plain_frames = sum(r.frames for r in got["plain"])
    pace_s = (got["window_s"] - got["prof_wall_s"] - got["span_wall_s"]) / plain_frames
    dev_frame_s = sl.device_seconds() / sl.frames
    parts = host_parts(split)
    profiled = [r for r in got["requests"] if r.ok and r.traced]
    prof_split = per_frame(prof_spans)
    tails = sync_tails_us(sl)
    return {
        "cell": cell.name,
        "seed": seed,
        "src": src,
        "dst": dst,
        "requests": len(got["requests"]),
        "failed": failed,
        "plan_s": plan_s,
        "make_fn_s": dur.get("setup.make_fn"),
        "plan_build_s": dur.get("setup.plan"),
        "operands_s": dur.get("setup.operands"),
        "ring_operands_s": dur.get("setup.ring_operands"),
        "plan_s_tracer_off": makes["off"],
        "plan_s_tracer_on": makes["on"],
        "dispatch_us": plain_us,
        "dispatch_us_spanned": spanned_us,
        "tracer_on_us_window": spanned_us - plain_us if plain_us and spanned_us else None,
        "alternating": alt,
        "span_site_ns": cost_ns,
        **{k: v for k, v in split.items() if k != "frames"},
        "span_frames": split["frames"],
        "span_requests": len(spanned),
        "dropped": got["dropped"],
        "harness_us": plain_us - sum(parts) if plain_us and None not in parts else None,
        "harness_us_spanned": spanned_us - sum(parts) if None not in parts else None,
        "profiler_slice": {
            "dispatch_us": dispatch_per_frame_us(profiled),
            **{k: prof_split.get(k) for k in PARTS},
            "sync_tail_us": statistics.median(tails) if tails else None,
            "frames": sl.frames,
            "forms": got["prof_forms"],
        },
        **turnaround(spans),
        "frame_parts_us": first_and_later(spans),
        "pace_us": pace_s * 1e6,
        "device_us_a_frame": dev_frame_s * 1e6 if sl.device_ops else None,
        "device_idle_pct": 100.0 * (1.0 - dev_frame_s / pace_s) if sl.device_ops else None,
        "idle_us_a_request": (pace_s - dev_frame_s) * mix["frames_per_request"] * 1e6
        if sl.device_ops else None,
        "idle_gaps": gaps[:10],
        "idle_by_span": gap_totals(gaps),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=int, default=1)
    args = p.parse_args(argv)
    import torch

    from portbench import harness, spec

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            harness.log("no CUDA card")
            return 2
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
        torch.zeros(1, device=device)
    cell = spec.load_cell(spec.load_benchmark(), args.workload)
    rec = measure(cell, args.seed, args.seconds, device, args.scale)
    if device.type == "cuda":
        rec["card"] = card()
    else:
        rec = {"rehearsal": "cpu", "cell": rec["cell"],
               "found": sorted(k for k, v in rec.items() if v is not None),
               "empty": sorted(k for k, v in rec.items() if v is None)}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
