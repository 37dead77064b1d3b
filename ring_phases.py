"""Where K6's time goes on the card: per-phase cycles of the ring kernel
and its time at one resident block an SM against its usual two.

Run from the root of a checkout, on a machine with an NVIDIA card and
nvcc:  python3 ring_phases.py

It builds a copy of avir_tpu_torch/ops/cuda/csrc/fused_ring.cu into
build/ring_phases/ with two changes: thread 0 of every block reads clock64
at the kernel's phase boundaries and writes its per-phase sums to a
device array at the end (each block its own slots), and the launch can ask
for extra dynamic shared memory (so that one block fits an SM instead of
two).  The copy is called through the shipped wrapper
(apply_fused_ring inside fused_ring.LAUNCH.through(copy)), checked
bit-equal to the shipped kernel, and timed with CUDA events (L2 flushed)
at 8K -> 1080p and 4K -> 720p u8 RGB gamma.  Prints one JSON line per
shape: the mean cycles a slice spends in each phase, for the blocks that
own a segment and for those that do not, the SM clock, and the times at
two and at one block an SM.  Phase sums are thread 0's view: they include
its waits at the block and cluster barriers.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

# (marker in fused_ring.cu, what goes before it): the phase that ends there.
PHASES = (
    ("    if (p > p0) cluster_wait();  // the peers", "slice start"),
    ("      // ---- first (vertical) pass", "second barrier, lane taps, V taps landed"),
    ("      // ---- requantize into the intermediate's limbs", "first pass"),
    ("    cluster_arrive();\n    // The next slice's new rows", "requantize, second pass, shares"),
    ("    cluster_wait();  // every block's share", "next slice's linearization"),
    ("    // ---- this block's outputs", "first barrier"),
    ("      store4(a, vb, r0 + r", "peers' shares read"),
    ("    cluster_arrive();  // done reading the peers' shares\n", "gamma-out and store"),
)
SHAPES = ((7680, 4320, 1920, 1080), (3840, 2160, 1280, 720))
SEED = 7


def _timed_source(src: str) -> str:
    """fused_ring.cu with the phase marks and the extra shared memory."""
    head = (
        "__device__ unsigned long long g_phases[1 << 20];\n"
        "static size_t g_extra_smem = 0;\n"
        "#define MARK(k) do { if (threadIdx.x == 0) { const unsigned long long n_ = "
        "clock64(); acc_[k] += n_ - t_; t_ = n_; } } while (0)\n"
    )
    n = len(PHASES)
    edits = [(m, f"    MARK({k});\n{m}") for k, (m, _) in enumerate(PHASES)]
    edits += [
        ("namespace {\n\nusing namespace mma_s8;", head + "namespace {\n\nusing namespace mma_s8;"),
        ("  int done = -1;",
         f"  unsigned long long t_ = clock64(), acc_[{n}] = {{}};\n  int done = -1;"),
        ("  if (p1 > p0) cluster_wait();  // no block leaves",
         f"  if (threadIdx.x == 0) for (int k = 0; k < {n}; ++k)\n"
         f"    g_phases[(blockIdx.y * gridDim.x + blockIdx.x) * {n} + k] = acc_[k];\n"
         "  if (p1 > p0) cluster_wait();  // no block leaves"),
        ("  const size_t bytes = smem_bytes(ring_rows);\n  if (ring_rows % 32",
         "  const size_t bytes = smem_bytes(ring_rows) + g_extra_smem;\n  if (ring_rows % 32"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_ring.cu changed: no single {old!r}")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int ring_phases_read(void* host, int n) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phases, n * sizeof(unsigned long long)));\n"
        "}\n"
        'extern "C" void ring_phases_extra_smem(int bytes) { g_extra_smem = bytes; }\n'
    )


def _build(root: str) -> ctypes.CDLL:
    from avir_tpu_torch.ops.cuda import build

    csrc = os.path.join(root, "avir_tpu_torch", "ops", "cuda", "csrc")
    out = os.path.join(root, "build", "ring_phases")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "fused_ring_phases.cu")
    with open(os.path.join(csrc, "fused_ring.cu")) as f:
        text = _timed_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libfused_ring_phases.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from avir_tpu_torch.models.runtime import GAMMA_ROUTE_ENV, make_avir_executor
    from avir_tpu_torch.ops.cuda import fused_ring as fr
    from avir_tpu_torch.plan.plan import build_resize_plan

    lib = _build(root)
    lib.ring_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ring_phases_extra_smem.argtypes = [ctypes.c_int]
    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    for sw, sh, nw, nh in SHAPES:
        plan = build_resize_plan(sw, sh, nw, nh, 3, np.uint8, np.uint8, use_srgb_gamma=True)
        os.environ[GAMMA_ROUTE_ENV] = "ring"
        try:
            ops = make_avir_executor(plan, device=dev).ops
        finally:
            del os.environ[GAMMA_ROUTE_ENV]
        x = torch.from_numpy(gen.integers(0, 256, (sh, sw * 3), dtype=np.uint8)).to(dev)
        n_cl, parts = ops.chunk_of.shape[0], ops.part_ptr.shape[0] - 1

        def call():
            with fr.LAUNCH.through(lib):
                return fr.apply_fused_ring(ops, x)

        want = fr.apply_fused_ring(ops, x)
        out = call()
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(out, want))
        blocks = n_cl * ops.cluster * parts
        sums = np.zeros(blocks * len(PHASES), dtype=np.uint64)
        if lib.ring_phases_read(sums.ctypes.data, sums.size):
            raise RuntimeError("reading the phase sums failed")
        per = sums.reshape(blocks, len(PHASES)).astype(np.float64)
        slices = np.repeat(np.diff(ops.part_ptr.cpu().numpy()), n_cl * ops.cluster)
        owner = np.tile(ops.seg_of.cpu().numpy() >= 0, parts)
        times = {}
        for label, extra in (("two_blocks_an_sm", 0), ("one_block_an_sm", 60_000)):
            lib.ring_phases_extra_smem(extra)
            times[f"{label}_ms"] = cs._time_ms(call, 20, flush)
        lib.ring_phases_extra_smem(0)
        print(json.dumps({
            "shape": f"{sw}x{sh}->{nw}x{nh}", "bit_equal_to_kernel": bit_equal,
            "cluster": ops.cluster, "blocks": blocks, "parts": parts,
            "cycles_a_slice_owner": {
                name: float((per[owner, k] / slices[owner]).mean())
                for k, (_, name) in enumerate(PHASES)
            },
            "cycles_a_slice_idle": {
                name: float((per[~owner, k] / slices[~owner]).mean())
                for k, (_, name) in enumerate(PHASES)
            } if (~owner).any() else None,
            "sm_clock": clock, **times, "card": cs._card(),
        }))
        if not bit_equal:
            print("timed copy differs from the kernel", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
