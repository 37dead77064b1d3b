"""Persistent plan cache: composed banded operators on disk.

Counterpart of the JAX package's ``plan/cache.py``: a warm process start
skips the float64 filter design and composition (the reference amortizes
filter design by bank caching, avir.h:1741-1747, 2693-2714).  Entries are
``.npz`` files keyed by a hash of every plan-affecting argument.

The default directory is this package's own (``$AVIR_TPU_TORCH_CACHE``,
else ``avir_tpu_torch`` under ``$XDG_CACHE_HOME`` or ``~/.cache``), so the
two packages never read each other's plans.  Unlike the JAX package's
entries, an entry also keeps ``out_float64``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import tempfile

import numpy as np

from .compose import BandedOp
from .plan import AxisPlan, ResizePlan, build_resize_plan

CACHE_ENV = "AVIR_TPU_TORCH_CACHE"

_SCALARS = (
    "src_w", "src_h", "new_w", "new_h", "el_count", "use_srgb_gamma",
    "in_gamma_mult", "out_gamma_mult", "alpha_index", "is_in_float",
    "is_out_float", "in_type_max", "out_type_max", "res_bit_depth",
    "out_float64",
)


def default_cache_dir() -> pathlib.Path:
    if CACHE_ENV in os.environ:
        return pathlib.Path(os.environ[CACHE_ENV])
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return pathlib.Path(base) / "avir_tpu_torch"


def plan_cache_key(kwargs: dict) -> str:
    blob = json.dumps(
        {k: repr(v) for k, v in sorted(kwargs.items())}, sort_keys=True
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def save_plan(plan: ResizePlan, path: pathlib.Path) -> None:
    arrays = {}
    meta = {k: getattr(plan, k) for k in _SCALARS}
    for ax in ("h", "v"):
        a: AxisPlan = getattr(plan, ax)
        arrays[f"{ax}_starts"] = a.op.starts
        arrays[f"{ax}_taps"] = a.op.taps
        meta[f"{ax}_n_in"] = a.op.n_in
        meta[f"{ax}_n_out"] = a.op.n_out
        meta[f"{ax}_build_mode"] = a.build_mode
        meta[f"{ax}_k"] = a.k
        meta[f"{ax}_o"] = a.o
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, meta=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_plan(path: pathlib.Path) -> ResizePlan | None:
    """The plan stored at ``path``, or None when it cannot be read."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            axes = {
                ax: AxisPlan(
                    op=BandedOp(
                        n_in=int(meta[f"{ax}_n_in"]),
                        n_out=int(meta[f"{ax}_n_out"]),
                        starts=z[f"{ax}_starts"],
                        taps=z[f"{ax}_taps"],
                    ),
                    build_mode=int(meta[f"{ax}_build_mode"]),
                    k=float(meta[f"{ax}_k"]),
                    o=float(meta[f"{ax}_o"]),
                )
                for ax in ("h", "v")
            }
        return ResizePlan(
            h=axes["h"], v=axes["v"], **{k: meta[k] for k in _SCALARS}
        )
    except (OSError, KeyError, ValueError, json.JSONDecodeError):
        return None


def build_resize_plan_cached(
    *, cache_dir: os.PathLike | None = None, **kwargs
) -> ResizePlan:
    """``build_resize_plan`` with a disk cache in ``cache_dir`` (None: the
    default directory, see the module docstring)."""
    cdir = pathlib.Path(cache_dir) if cache_dir else default_cache_dir()
    path = cdir / f"plan_{plan_cache_key(kwargs)}.npz"
    if path.exists():
        plan = load_plan(path)
        if plan is not None:
            return plan
    plan = build_resize_plan(**kwargs)
    try:
        save_plan(plan, path)
    except OSError:
        pass  # a read-only cache directory: the plan is still returned
    return plan
