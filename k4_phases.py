"""Where K4's time goes on the card: cycles a diagonal step of the
error-diffusion wavefront (csrc/wavefront.cu) by phase, and how often a
hand-off read found its word not yet written.

Run from the root of a checkout, on a machine with an NVIDIA card and
nvcc:  python3 k4_phases.py [DIR] [--warps N] [--ahead K] [--shape H,W,C]

It builds two copies of DIR's avir_tpu_torch/ops/cuda/csrc/wavefront.cu
(DIR: a checkout, this script's own by default, e.g. an older commit
unpacked into build/parent) into build/k4_phases/: the source as it is
(for ptxas's report, and timed), and a timed copy in which every thread
reads clock64 at the step's phase boundaries, each read made to wait for
the value its phase produced, and lane 0 of each warp writes its sums to a
device array at the end.  The timed copy also counts the reads of a word
handed over from another warp or from the row group above that found it
not yet written (the shipped kernel counts nothing; the counters' branches
are followed by a __syncwarp).  Each design of the kernel is known by a
text only its source has:

  barrier: the shared ring of the last four steps' noise with a
  __syncthreads every step;
  shuffle: the row above by a warp shuffle, a tagged shared-memory ring
  between warps read a chunk at a time, no barrier in the step loop.

``--ahead K`` builds both copies with kAhead = K (the shuffle design's
steps a chunk).  ``--warps N`` runs row groups of N warps (default: the
wrapper's).  ``--shape H,W,C`` runs that image alone and adds each warp's
phases (the first 16 warps).

Both copies are called through DIR's own wrapper
(wavefront.LAUNCH.through(copy), so DIR must have that launch entry),
checked bit-equal to the shipped kernel, and timed with CUDA events, L2
flushed before each launch, at 3840x2160x3 and 1920x1080x3 (a float32
image quantized to u8, the errdiff cells' K4).  Prints one JSON line per
shape: the mean cycles a step in each phase (chunk phases spread over the
chunk's steps; waits include a warp's start behind the warps and groups
above), the miss shares, ptxas's registers and spills of each
instantiation, the SM clock and the three times.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

SHAPES = ((2160, 3840, 3), (1080, 1920, 3))
SEED = 7
SLOTS = 1 << 20
WARPS_MAX = 32

_HEAD = r"""
__device__ unsigned long long g_phases[%d];
__device__ unsigned long long g_counts[4];  // ring reads, misses; group reads, misses
// The clock, read once v is ready (the read is predicated on v).
__device__ __forceinline__ unsigned long long k4p_clock(unsigned v) {
  unsigned long long n;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %%1, 0xffffffff;\n\t@p mov.u64 %%0, 0;\n"
               "\t@!p mov.u64 %%0, %%%%clock64;\n\t}" : "=l"(n) : "r"(v));
  return n;
}
#define MARKU(k, u) do { const unsigned long long n_ = k4p_clock(u); acc_[k] += n_ - t_; t_ = n_; } while (0)
#define MARK(k, v) MARKU(k, __float_as_uint(v))
"""

_PROLOGUE = ("  unsigned long long t0_ = clock64(), t_ = t0_, acc_[%d] = {}, steps_ = 0;\n"
             "  unsigned long long reads_r_ = 0, miss_r_ = 0, reads_g_ = 0, miss_g_ = 0;\n")


def _epilogue(n: int) -> str:
    return (
        "  if ((threadIdx.x & 31) == 0) {\n"
        f"    unsigned long long* o_ = g_phases + (static_cast<size_t>(g) * {WARPS_MAX} + "
        f"(threadIdx.x >> 5)) * {n + 2};\n"
        f"    for (int i_ = 0; i_ < {n}; ++i_) o_[i_] = acc_[i_];\n"
        f"    o_[{n}] = steps_;\n    o_[{n + 1}] = clock64() - t0_;\n"
        "  }\n"
        "  if (reads_r_) { atomicAdd(&g_counts[0], reads_r_); atomicAdd(&g_counts[1], miss_r_); }\n"
        "  if (reads_g_) { atomicAdd(&g_counts[2], reads_g_); atomicAdd(&g_counts[3], miss_g_); }\n"
    )


# Each design: (name, a text only its source has, phases in the order
# they run, edits as (old, new) with MARK(k, v) at the end of phase k, the
# text before which the epilogue goes, the text after which the head
# goes, the kernel's opening line).
DESIGNS = (
    ("barrier", "ring[t & 3][tid] = noise;",
     ("image value", "row above: ring loads", "arithmetic", "barrier",
      "chunk stores and fetch", "group hand-off wait"),
     (
         ("      const int t = t0 + k;\n      const int x = t - 2 * y;\n",
          "      const int t = t0 + k;\n      const int x = t - 2 * y;\n"
          "      ++steps_;\n      MARK(0, s_cur[k]);\n"),
         ("      hp2 = hp1;\n      hp1 = d1;\n",
          "      hp2 = hp1;\n      hp1 = d1;\n"
          "      MARKU(1, __float_as_uint(d1) ^ __float_as_uint(d2) ^ __float_as_uint(d3));\n"),
         ("      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;\n",
          "      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;\n      MARK(2, noise);\n"),
         ("      ring[t & 3][tid] = noise;\n      __syncthreads();\n",
          "      ring[t & 3][tid] = noise;\n      __syncthreads();\n      MARK(3, 0.0f);\n"),
         ("    fetch(a, src, n_up, y, t0 + kAhead, s_nxt, h_nxt);\n"
          "    if (top) await_words(a, n_up, t0, h_cur);\n",
          "    fetch(a, src, n_up, y, t0 + kAhead, s_nxt, h_nxt);\n    MARK(4, 0.0f);\n"
          "    if (top) {\n"
          "      for (int k_ = 0; k_ < kAhead; ++k_) {\n"
          "        if (t0 + k_ + 1 < a.w) { ++reads_g_; miss_g_ += !(h_cur[k_] & kWritten); }\n"
          "      }\n"
          "      await_words(a, n_up, t0, h_cur);\n"
          "    }\n"
          "    MARKU(5, static_cast<unsigned>(h_cur[kAhead - 1]));\n"),
     ),
     "      h_cur[k] = h_nxt[k];\n    }\n  }\n",
     "namespace {\n",
     "wavefront(const Args a) {\n"),
    ("shuffle", "__shfl_up_sync(kFull, n1, shfl)",
     ("ring store, then image value", "row above: shuffle", "arithmetic", "last ring store",
      "flow control", "group hand-off wait", "warp hand-off wait", "chunk stores"),
     (
         ("      const int x = t - 2 * y;\n      const float up = ",
          "      const int x = t - 2 * y;\n      ++steps_;\n      MARK(0, s[k]);\n      const float up = "),
         ("      p2 = p1;\n      p1 = d1;\n", "      p2 = p1;\n      p1 = d1;\n      MARK(1, d1);\n"),
         ("      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;\n",
          "      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;\n      MARK(2, noise);\n"),
         ("      n[k] = noise;\n    }\n", "      n[k] = noise;\n    }\n    MARK(3, 0.0f);\n"),
         ("      store_word_if(valid && publish, n_own + x * a.c, n[k]);\n    }\n",
          "      store_word_if(valid && publish, n_own + x * a.c, n[k]);\n    }\n    MARK(7, 0.0f);\n"),
         ("    int seen = read ? progress(done, r_lo, r_hi) : INT_MAX;\n",
          "    int seen = read ? progress(done, r_lo, r_hi) : INT_MAX;\n    MARK(4, 0.0f);\n"),
         ("    await_words<K>(a, n_up, t0, h);\n",
          "    if (top) {\n"
          "      for (int k_ = 0; k_ < K; ++k_) {\n"
          "        if (t0 + k_ + 1 < a.w) { ++reads_g_; miss_g_ += !(h[k_] & kWritten); }\n"
          "      }\n"
          "    }\n"
          "    await_words<K>(a, n_up, t0, h);\n"
          "    MARKU(5, static_cast<unsigned>(h[K - 1]));\n"),
         ("    load_ring_words<K>(from_ring, ring_up, slots, a.ring_mask, t0, w);\n",
          "    load_ring_words<K>(from_ring, ring_up, slots, a.ring_mask, t0, w);\n"
          "    if (from_ring) {\n"
          "      for (int k_ = 0; k_ < K; ++k_) {\n"
          "        if (t0 + k_ > 0) { ++reads_r_; miss_r_ += static_cast<int>(w[k_] >> 32) != t0 + k_; }\n"
          "      }\n"
          "    }\n"),
         ("    await_ring<K>(from_ring, ring_up, slots, a.ring_mask, t0, w);\n",
          "    await_ring<K>(from_ring, ring_up, slots, a.ring_mask, t0, w);\n"
          "    __syncwarp();\n"
          "    MARKU(6, static_cast<unsigned>(w[K - 1]));\n"),
     ),
     "      seen = progress(done, r_lo, r_hi);\n    }\n  }\n",
     "namespace {\n",
     "wavefront(const Args a) {\n"),
)


def _timed_source(src: str, ahead: int | None) -> tuple[str, str, tuple]:
    """(the source with ``ahead``, its timed copy, the design's name and
    phases)."""
    name, _, phases, edits, end, head_after, opening = next(
        d for d in DESIGNS if d[1] in src)
    if ahead is not None:
        src, n = re.subn(r"constexpr int kAhead = \d+;", f"constexpr int kAhead = {ahead};", src)
        if n != 1:
            raise RuntimeError("wavefront.cu changed: no single kAhead")
    n = len(phases)
    timed = src
    edits = (
        *edits,
        (head_after, head_after + _HEAD % SLOTS),
        (opening, opening + _PROLOGUE % n),
        (end, end + _epilogue(n)),
    )
    for old, new in edits:
        if timed.count(old) != 1:
            raise RuntimeError(f"wavefront.cu changed: no single {old!r}")
        timed = timed.replace(old, new)
    timed += (
        '\nextern "C" int k4_phases_read(void* host, int n, void* counts) {\n'
        "  cudaError_t e = cudaMemcpyFromSymbol(host, g_phases, n * sizeof(unsigned long long));\n"
        "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(counts, g_counts, sizeof(g_counts));\n"
        "  return static_cast<int>(e);\n}\n"
        'extern "C" int k4_phases_reset() {\n'
        "  const unsigned long long zero[4] = {};\n"
        "  return static_cast<int>(cudaMemcpyToSymbol(g_counts, zero, sizeof(zero)));\n}\n"
    )
    return src, timed, (name, phases)


def ptxas_report(log: str) -> dict:
    """{kernel (mangled name): {registers, spill_stores, spill_loads}}
    from ``nvcc -Xptxas -v``'s output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _build(root: str, out_root: str, ahead: int | None):
    from avir_tpu_torch.ops.cuda import build

    csrc = os.path.join(root, "avir_tpu_torch", "ops", "cuda", "csrc")
    with open(os.path.join(csrc, "wavefront.cu")) as f:
        plain, timed, design = _timed_source(f.read(), ahead)
    tag = f"{hashlib.sha256(os.path.abspath(root).encode()).hexdigest()[:12]}_{ahead or 0}"
    out = os.path.join(out_root, "build", "k4_phases", tag)
    os.makedirs(out, exist_ok=True)
    procs = {}
    for kind, text in (("plain", plain), ("timed", timed)):
        src = os.path.join(out, f"wavefront_{kind}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"libwavefront_{kind}.so")
        procs[kind] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for kind, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {kind} copy:\n{log}")
        libs[kind], reports[kind] = ctypes.CDLL(lib), ptxas_report(log)
    return libs, reports, design


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root", nargs="?", default=None,
                   help="checkout whose kernel is timed (default: this script's)")
    p.add_argument("--warps", type=int, default=None, help="warps of a row group")
    p.add_argument("--ahead", type=int, default=None, help="kAhead of both copies")
    p.add_argument("--shape", default=None,
                   help="H,W,C to run instead of the two frames (and each warp's phases)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or here)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from avir_tpu_torch.ops.cuda import wavefront as wf

    wf.LAUNCH.function()  # the shipped library, built before the copies
    libs, reports, (design, phases) = _build(root, here, args.ahead)
    timed = libs["timed"]
    timed.k4_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    n = len(phases)
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    shapes = SHAPES if args.shape is None else (tuple(int(v) for v in args.shape.split(",")),)
    for h, w, c in shapes:
        img = torch.from_numpy(
            (np.random.default_rng(SEED).random((h, w, c)) * 255.0).astype(np.float32)).to(dev)
        rows = wf.group_rows_for(h, c, None if args.warps is None else args.warps * 32 // c)
        groups = -(-h // rows)
        warps = -(-rows * c // 32)
        if groups * WARPS_MAX * (n + 2) > SLOTS:
            raise RuntimeError("too many groups for the phase array")

        def run(lib=None):
            if lib is None:
                return wf.errdiff_wavefront(img, 0, 255.0, out_dtype=torch.uint8, block_rows=rows)
            with wf.LAUNCH.through(lib):
                return wf.errdiff_wavefront(img, 0, 255.0, out_dtype=torch.uint8, block_rows=rows)

        want = run()
        torch.cuda.synchronize()
        if timed.k4_phases_reset():
            raise RuntimeError("resetting the counters failed")
        got = run(timed)
        torch.cuda.synchronize()
        plain_equal = bool(torch.equal(run(libs["plain"]), want))
        bit_equal = bool(torch.equal(got, want))
        sums = np.zeros(groups * WARPS_MAX * (n + 2), dtype=np.uint64)
        counts = np.zeros(4, dtype=np.uint64)
        if timed.k4_phases_read(sums.ctypes.data, sums.size, counts.ctypes.data):
            raise RuntimeError("reading the phase sums failed")
        per = sums.reshape(groups, WARPS_MAX, n + 2)[:, :warps].reshape(-1, n + 2)
        per = per.astype(np.float64)
        steps = per[:, n].sum()
        tot = per[:, :n].sum(axis=0)
        ring_reads, ring_miss, group_reads, group_miss = (int(v) for v in counts)
        print(json.dumps({
            "shape": f"{w}x{h}x{c}", "design": design, "root": root, "ahead": args.ahead,
            "group_rows": rows, "groups": groups, "warps_a_group": warps,
            "bit_equal_to_kernel": bit_equal, "plain_copy_bit_equal": plain_equal,
            "steps_a_warp": float(steps / len(per)),
            "cycles_a_step": {name: float(tot[k] / steps) for k, name in enumerate(phases)},
            "cycles_a_step_total": float(tot.sum() / steps),
            "cycles_a_warp": float(per[:, n + 1].mean()),
            "cycles_a_warp_max": float(per[:, n + 1].max()),
            "critical_steps": wf.critical_steps(h, w),
            "ring_reads": ring_reads, "ring_miss_share": ring_miss / ring_reads if ring_reads else None,
            "group_reads": group_reads,
            "group_miss_share": group_miss / group_reads if group_reads else None,
            "ptxas_shipped": reports["plain"], "ptxas_timed_copy": reports["timed"],
            **({"by_warp": [{"steps": float(v[n]), "cycles": float(v[n + 1]),
                             **{name: float(v[k] / max(v[n], 1)) for k, name in enumerate(phases)}}
                            for v in per[:16]]} if args.shape else {}),
            "sm_clock": clock,
            "kernel_ms": cs._time_ms(run, 10, flush),
            "plain_copy_ms": cs._time_ms(lambda: run(libs["plain"]), 10, flush),
            "timed_copy_ms": cs._time_ms(lambda: run(timed), 10, flush),
            "card": cs._card(),
        }), flush=True)
        if not (bit_equal and plain_equal):
            print("a copy differs from the kernel", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
