"""The comparison that decides ``correct``.

Each output frame of the sampled requests is held against the float64
reference of the same input frame.  Three numbers are compared, each
with the limit of ``limits/<cell>.json``:

- ``excess_lsb``: the largest distance, over every output value, between
  the port's value and the reference's exact value clamped to the output
  range, less the half LSB that rounding may take;
- ``mismatch_ppm``: output values that differ from the reference's
  rounded value, per million values;
- ``bad_frames``: frames that are missing, of the wrong shape or type, or
  whose request failed (limit 0).
"""

from __future__ import annotations

import dataclasses

import torch

NAMES = ("excess_lsb", "mismatch_ppm", "bad_frames")


@dataclasses.dataclass
class Readings:
    excess: float = float("-inf")
    mismatches: int = 0
    values: int = 0
    frames: int = 0
    bad_frames: int = 0

    def add(self, out, ref, exact: torch.Tensor) -> None:
        """Compare the port's ``out`` with ``exact``, the reference's
        float64 frame before rounding."""
        want = ref.finish(exact)
        if (
            not isinstance(out, torch.Tensor)
            or out.dtype != torch.uint8
            or tuple(out.shape) != tuple(exact.shape)
        ):
            self.bad_frames += 1
            return
        got = out.to(exact.device, torch.float64)
        dist = (got - exact.clamp(0.0, ref.clamp)).abs().max().item()
        self.excess = max(self.excess, dist - 0.5)
        self.mismatches += int((got != want).sum().item())
        self.values += got.numel()
        self.frames += 1

    def result(self) -> dict:
        return {
            "excess_lsb": self.excess if self.frames else None,
            "mismatch_ppm": 1e6 * self.mismatches / self.values if self.values else None,
            "bad_frames": self.bad_frames,
        }


def judge(readings: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}).  A reading that is
    missing, or a limit not yet set, is not correct."""
    checks = {}
    correct = True
    for name in NAMES:
        value = readings.get(name)
        limit = None if limits is None else limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or value > limit:
            correct = False
    return correct, checks
