"""The comparison that decides ``correct``.

Each output frame of the sampled requests is held against the float64
reference of the same input frame.  The readings:

- ``excess_lsb``: the largest distance, over every output value, between
  the port's value and the reference's exact value clamped to the output
  range, less the half LSB that rounding may take;
- ``mismatch_ppm``, for a reference that rounds: output values that
  differ from the reference's rounded value, per million values;
- ``diffusion_miss_ppm``, for a reference with ``errdiff``: output values
  that break AVIR's error-diffusion rule by more than ``TOLERANCE`` steps
  (``reference/errdiff.py:misses``), per million values.  An error-
  diffused output has no bit-exact twin: a flip at a half step carries
  on through the diffused noise, so it is held to the rule instead;
- ``bad_frames``: frames that are missing, of the wrong shape or type, or
  whose request failed.

The reference's frames are in the output type's units, so an LSB is 1
for u8 and for u16 alike.  ``judge`` holds the three readings that the
reference decides (``judged``), each to the limit that the cell's
``limits/<cell>.json`` gives it; one with no reading or no limit is not
correct.
"""

from __future__ import annotations

import dataclasses

import torch

from .reference import errdiff


def judged(dithered: bool) -> tuple[str, str, str]:
    """The readings that decide ``correct`` for a reference that
    error-diffuses (``dithered``) or rounds."""
    return ("excess_lsb", "diffusion_miss_ppm" if dithered else "mismatch_ppm", "bad_frames")


# The rule's slack, in quantisation steps, for an output error-diffused in
# float32 against the float64 frame.  The port's own small error is
# carried on by the rule, so it reads above 0 at any slack; the slack was
# chosen where the port stands farthest from the nearest wrong dither,
# Floyd and Steinberg's weights (two 480x270 frames of the segment mix
# cut by 8, on the CPU, ppm):
#   slack        0       0.01    0.02    0.03    0.05    0.1
#   port    13,770   5,970   2,400   1,740   1,200     630
#   F-S     30,090  21,420  14,820   9,990   4,620   1,410
# At 0.03, on an H100 at 1080p -> 4K, the port reads 2,072-2,082 and the
# controls 168,000 and more (PERF.md section 2).
TOLERANCE = 0.03

# Bytes of float64 frames read by diffusion in one walk: a 60-frame 4K
# u8 RGB segment (11.9 GB) in one.  A walk costs by its diagonals'
# launches, not by its width: on an H100 a segment took 3.5 s in one walk
# and 8.3-9.7 s in three.
GROUP_BYTES = 12 << 30


@dataclasses.dataclass
class Readings:
    out_dtype: torch.dtype = torch.uint8
    dithered: bool = False  # set from the reference by add_all
    excess: float = float("-inf")
    mismatches: int = 0  # rounded values, or values that break the rule
    values: int = 0
    frames: int = 0
    bad_frames: int = 0

    def add(self, out, ref, exact: torch.Tensor) -> None:
        """Compare the port's ``out`` with ``exact``, the reference's
        float64 frame before rounding."""
        self.add_all([out], ref, [exact])

    def add_all(self, outs: list, ref, exacts) -> None:
        """Compare the port's outputs ``outs`` with their exact frames
        ``exacts`` (an iterable, taken one at a time).  For a dithering
        reference the frames are read by diffusion together, up to
        GROUP_BYTES a walk."""
        self.dithered = ref.errdiff is not None
        group = []
        for out, exact in zip(outs, exacts):
            if (
                not isinstance(out, torch.Tensor)
                or out.dtype != self.out_dtype
                or tuple(out.shape) != tuple(exact.shape)
            ):
                self.bad_frames += 1
                continue
            got = out.to(exact.device, torch.float64)
            dist = (got - exact.clamp(0.0, ref.clamp)).abs().max().item()
            self.excess = max(self.excess, dist - 0.5)
            self.values += got.numel()
            self.frames += 1
            if not self.dithered:
                self.mismatches += int((got != ref.finish(exact)).sum().item())
                continue
            del got
            group.append((out.to(exact.device), exact))
            if len(group) * exact.nbytes >= GROUP_BYTES:
                self._misses(group, ref)
        if group:
            self._misses(group, ref)

    def _misses(self, group: list, ref) -> None:
        """Count the values of the frames of ``group`` (emptied) that break
        the rule, in one walk: [H, W, frames x channels]."""
        outs, exacts = zip(*group)
        group.clear()
        h, w, _ = exacts[0].shape
        out = torch.stack(outs, dim=2).reshape(h, w, -1)
        exact = torch.stack(exacts, dim=2).reshape(h, w, -1)
        del outs, exacts
        self.mismatches += errdiff.misses(out, exact, ref.errdiff, 1.0, ref.clamp, TOLERANCE)

    def result(self) -> dict:
        """The readings that ``judge`` holds: ``judged(self.dithered)``."""
        excess, misses, bad = judged(self.dithered)
        return {
            excess: self.excess if self.frames else None,
            misses: 1e6 * self.mismatches / self.values if self.values else None,
            bad: self.bad_frames,
        }


def judge(readings: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}) over ``judged``'s
    readings (those of a dithered output where ``readings`` has
    ``diffusion_miss_ppm``).  A reading that is missing, or a limit not
    set (no limits file, or none for that reading), is not correct."""
    limits = limits or {}
    checks = {}
    correct = True
    for name in judged("diffusion_miss_ppm" in readings):
        value = readings.get(name)
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or value > limit:
            correct = False
    return correct, checks
