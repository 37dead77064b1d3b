"""The port's scaling model (avir_tpu_torch/parallel/scaling_model.py)
against the JAX package's: run with the JAX package's TPU link constants
passed in, every ScalePoint is equal (the model's arithmetic and the
planner it reads are the same); run with its own defaults, the constants
are the H100 data-sheet ones.  The JAX cases of tests/test_scaling_model.py
that do not need ``suggest_grid`` (tests/test_torch_sharded_2d.py holds it)."""

import dataclasses
import inspect

import numpy as np
import pytest

from avir_tpu.parallel import scaling_model as jsm
from avir_tpu.plan.lancir_plan import build_lancir_plan as jax_build_lancir_plan
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

from avir_tpu_torch.parallel import scaling_model as sm
from avir_tpu_torch.parallel.sharded import shard_v_blocked
from avir_tpu_torch.plan.lancir_plan import build_lancir_plan
from avir_tpu_torch.plan.plan import build_resize_plan

JAX_LINKS = dict(bw=jsm.V5E_ICI_BW, lat=jsm.V5E_ICI_LAT, t_dispatch=jsm.T_DISPATCH)

PLANS = {
    # (kind, src_w, src_h, new_w, new_h, in type)
    "8k_to_1080p": ("avir", 7680, 4320, 1920, 1080, np.uint8),
    "16k_to_4k": ("avir", 16384, 16384, 4096, 4096, np.uint8),
    "lancir_small": ("lancir", 1536, 1024, 768, 512, np.uint8),
    "avir_small": ("avir", 1536, 1024, 768, 512, np.uint8),
    "lancir_u16": ("lancir", 1536, 1024, 768, 512, np.uint16),
    "avir_f32": ("avir", 1536, 1024, 768, 512, np.float32),
}
_CACHE = {}


def _plans(name):
    """(port plan, JAX plan) of a PLANS entry, built once."""
    if name not in _CACHE:
        kind, sw, sh, nw, nh, dt = PLANS[name]
        build = (build_resize_plan, jax_build_resize_plan) if kind == "avir" else (
            build_lancir_plan, jax_build_lancir_plan)
        _CACHE[name] = tuple(b(sw, sh, nw, nh, 3, dt, dt) for b in build)
    return _CACHE[name]


def _rows(points):
    return [dataclasses.asdict(p) for p in points]


@pytest.mark.parametrize("name,t_chip,n_devs,kw", [
    ("8k_to_1080p", 334e-6, (2, 4, 8), {}),
    ("16k_to_4k", 1.34e-3, (2, 4, 8), {}),
    ("lancir_small", 100e-6, (2, 4), {}),
    ("avir_small", 1e-3, (8,), dict(cores=4)),
    ("avir_small", 1e-3, (8,), {}),
    ("lancir_u16", 100e-6, (2,), {}),
    ("avir_f32", 100e-6, (2,), {}),
])
def test_model_scaling_equals_jax(name, t_chip, n_devs, kw):
    port, jax_plan = _plans(name)
    got = sm.model_scaling(port, t_chip, n_devs=n_devs, **JAX_LINKS, **kw)
    want = jsm.model_scaling(jax_plan, t_chip, n_devs=n_devs, **JAX_LINKS, **kw)
    assert all(isinstance(p, sm.ScalePoint) for p in got)
    assert _rows(got) == _rows(want)
    assert sm.format_table(got) == jsm.format_table(want)


def test_model_scaling_errdiff_equals_jax():
    port, jax_plan = _plans("8k_to_1080p")
    args = (334e-6, 2.16e-3)
    got = sm.model_scaling_errdiff(port, *args, n_devs=(2, 4, 8), **JAX_LINKS)
    want = jsm.model_scaling_errdiff(jax_plan, *args, n_devs=(2, 4, 8), **JAX_LINKS)
    assert _rows(got) == _rows(want)
    assert sm.format_table_errdiff(got) == jsm.format_table_errdiff(want)


def test_model_scaling_2d_equals_jax():
    port, jax_plan = _plans("avir_small")
    got = sm.model_scaling_2d(port, 1e-3, **JAX_LINKS)
    want = jsm.model_scaling_2d(jax_plan, 1e-3, **JAX_LINKS)
    assert _rows(got) == _rows(want)
    assert sm.format_table_2d(got) == jsm.format_table_2d(want)


def test_halo_bytes_exact_and_eff_bounded_on_h100_links():
    """The JAX package's first case on the port's own defaults: halo rows
    and bytes are the planner's and efficiency is in (0, 1].  Without the
    per-launch overhead it falls with the rank count; with the card's
    measured one (T_DISPATCH) it need not: the launches a strip drop from
    three to one where the strips lose their interior blocks (n = 8)."""
    port, _ = _plans("8k_to_1080p")
    pts = sm.model_scaling(port, 334e-6, n_devs=(2, 4, 8))
    for p in pts:
        sv = shard_v_blocked(port.v.op, p.n_dev, 4320 + ((-4320) % p.n_dev))
        assert p.halo_rows == max(sv.halo_lo, sv.halo_hi)
        assert p.halo_bytes == p.halo_rows * 7680 * 3
        assert 0.0 < p.efficiency <= 1.0
    free = sm.model_scaling(port, 334e-6, n_devs=(2, 4, 8), t_dispatch=0.0)
    effs = [p.efficiency for p in free]
    assert effs == sorted(effs, reverse=True)


def test_defaults_are_the_h100_fabric():
    assert sm.NVLINK_BW == 450e9          # NVLink 4: 900 GB/s both ways
    assert sm.IB_NDR_BW == 50e9           # NDR InfiniBand: 400 Gb/s per host
    assert sm.PCIE5_BW == 64e9            # PCIe Gen5 x16, each way
    for fn in (sm.model_scaling, sm.model_scaling_errdiff, sm.model_scaling_2d):
        params = inspect.signature(fn).parameters
        assert params["bw"].default == sm.NVLINK_BW
        assert params["lat"].default == sm.NVLINK_LAT
        assert params["t_dispatch"].default == sm.T_DISPATCH
    names = set(vars(sm))
    assert not {n for n in names if "V5E" in n or "DCN" in n or "ICI" in n}


def test_model_scaling_2d_takes_measured_rank_compute():
    """A measured per-rank compute time replaces the modeled compute term
    of its grid and of no other; the halo terms stay as they were."""
    port, _ = _plans("avir_small")
    base = sm.model_scaling_2d(port, 1e-3, grids=((1, 2), (2, 2)))
    got = sm.model_scaling_2d(port, 1e-3, grids=((1, 2), (2, 2)), t_rank_s={(2, 2): 400e-6})
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(base[0])
    p, q = got[1], base[1]
    assert p.t_comp_us == pytest.approx(400.0)
    assert (p.t_exposed_col_us, p.t_exposed_row_us) == (q.t_exposed_col_us, q.t_exposed_row_us)
    assert p.t_step_us == pytest.approx(400.0 + p.t_exposed_col_us + p.t_exposed_row_us)
    assert p.efficiency == pytest.approx(1e-3 / (4 * p.t_step_us * 1e-6))
