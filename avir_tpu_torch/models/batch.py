"""Batch execution: N same-shape frames through one single-image executor.

The JAX package batches by ``jax.vmap`` of the single-image executor into
one device program (``models/avir.py:resize_batch`` there).  Here each
frame keeps the single-image route and launches its kernels once, on the
caller's current (compute) stream, so every frame has the bits of
``resize``.  What the batch adds is the copies:

  - the runner owns pinned host staging, two buffers per direction, and
    two device input buffers, allocated at its first call and reused by
    every later call (the runner is cached with its executor);
  - frame i+1's host->device copy and frame i-1's device->host copy run on
    their own copy streams while frame i's kernels run; CUDA events order
    them: a frame's kernels wait for its upload, an upload into a device
    buffer waits until the kernels of the frame two back have read it, a
    download waits for its frame's kernels;
  - a pinned buffer is written by the host only after the event of its
    last copy has completed; a result tensor, allocated on the compute
    stream and read by the download stream, is marked with
    ``record_stream`` so the allocator does not reuse it early;
  - results land in the caller's array (``out=``, reused pages) or a new
    one, through the pinned output buffers.

On a CPU device (tests) the frames run one after another, with no
staging.  A call locks the runner, so two threads may share a resizer.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch


class BatchRunner:
    """Runs ``fn`` ([H, W*C] -> [new_h, new_w*C] on ``device``) over frames
    [N, H, W, C] into [N, new_h, new_w, C].  ``in_dtype`` is the device
    input type (float64 frames are cast to float32 on the host, as
    ``resize`` does)."""

    def __init__(
        self,
        fn: Callable[[torch.Tensor], torch.Tensor],
        in_shape: tuple[int, int, int],
        in_dtype: torch.dtype,
        out_shape: tuple[int, int, int],
        out_dtype: torch.dtype,
        device: torch.device,
    ):
        self.fn = fn
        self.in_shape = in_shape
        self.in_dtype = in_dtype
        self.out_shape = out_shape
        self.out_dtype = out_dtype
        self.device = device
        self.staging: dict[str, list[torch.Tensor]] | None = None
        self._lock = threading.Lock()

    def __call__(self, frames: np.ndarray, out: np.ndarray) -> np.ndarray:
        if frames.shape[1:] != self.in_shape:
            raise ValueError(
                f"frames {frames.shape[1:]} != planned {self.in_shape}"
            )
        if out.shape != (len(frames), *self.out_shape):
            raise ValueError(
                f"out shape {out.shape} != result "
                f"{(len(frames), *self.out_shape)}"
            )
        with self._lock:
            if self.device.type == "cuda":
                self._run_cuda(frames, out)
            else:
                self._run_host(frames, out)
        return out

    def _flat(self, t: torch.Tensor) -> torch.Tensor:
        h, w, c = self.in_shape
        return t.reshape(h, w * c)

    def _run_host(self, frames: np.ndarray, out: np.ndarray) -> None:
        for i in range(len(frames)):
            x = torch.from_numpy(np.ascontiguousarray(frames[i]))
            y = self.fn(self._flat(x.to(self.in_dtype)).to(self.device))
            torch.from_numpy(out[i]).copy_(y.cpu().reshape(self.out_shape))

    def _allocate(self) -> dict[str, list[torch.Tensor]]:
        h, w, c = self.in_shape
        dev = self.device
        st = {
            "in_host": [
                torch.empty(self.in_shape, dtype=self.in_dtype, pin_memory=True)
                for _ in range(2)
            ],
            "out_host": [
                torch.empty(self.out_shape, dtype=self.out_dtype, pin_memory=True)
                for _ in range(2)
            ],
            "in_dev": [
                torch.empty((h, w * c), dtype=self.in_dtype, device=dev)
                for _ in range(2)
            ],
        }
        self._h2d = torch.cuda.Stream(dev)
        self._d2h = torch.cuda.Stream(dev)
        for t in st["in_dev"]:
            t.record_stream(self._h2d)
        # Per slot: upload done, kernels done reading the device input,
        # download done.
        self._uploaded = [torch.cuda.Event() for _ in range(2)]
        self._consumed = [torch.cuda.Event() for _ in range(2)]
        self._downloaded = [torch.cuda.Event() for _ in range(2)]
        return st

    def _run_cuda(self, frames: np.ndarray, out: np.ndarray) -> None:
        if self.staging is None:
            self.staging = self._allocate()
        st = self.staging
        compute = torch.cuda.current_stream(self.device)
        n = len(frames)

        def upload(i: int) -> None:
            s = i % 2
            self._uploaded[s].synchronize()  # the slot's last upload is done
            st["in_host"][s].copy_(torch.from_numpy(frames[i]))
            with torch.cuda.stream(self._h2d):
                self._h2d.wait_event(self._consumed[s])
                st["in_dev"][s].copy_(self._flat(st["in_host"][s]), non_blocking=True)
                self._uploaded[s].record(self._h2d)

        def deliver(i: int) -> None:
            s = i % 2
            self._downloaded[s].synchronize()
            torch.from_numpy(out[i]).copy_(st["out_host"][s])

        upload(0)
        for i in range(n):
            s = i % 2
            compute.wait_event(self._uploaded[s])
            y = self.fn(st["in_dev"][s])
            self._consumed[s].record(compute)
            if i >= 2:
                deliver(i - 2)  # frees out_host[s]
            with torch.cuda.stream(self._d2h):
                self._d2h.wait_event(self._consumed[s])
                st["out_host"][s].copy_(y.reshape(self.out_shape), non_blocking=True)
                y.record_stream(self._d2h)
                self._downloaded[s].record(self._d2h)
            if i + 1 < n:
                upload(i + 1)
        for i in range(max(0, n - 2), n):
            deliver(i)
