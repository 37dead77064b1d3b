"""The port's public API beyond ``resize`` on the CPU (the kernels' plain
versions), each case of tests/test_api_extras.py and
tests/test_device_exec.py run through both packages on the same seeded
inputs, the port held to the JAX package's output at ROADMAP.md's gates:
int8 and error diffusion at trunc_bits=0 bit-exact where the JAX package
runs the same arithmetic, the split route within 1 LSB (max x 1e-4 for
float), the float64 host route at the JAX test's own tolerance.

``test_vmapped_paths_disable_lane_split`` has no counterpart: it checks
that the JAX package builds batch and traceable executors with
``split_lanes=False`` (the TPU's aliased out_init lane split cannot carry
a vmap batch dimension); the port has no such split and no vmap (a batch
is a loop over frames), so there is nothing to hold.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import GOLDEN_DIR, load_golden, psnr, xorshift128_fill

import avir_tpu
from avir_tpu.models.host_reference import (
    execute_plan_rows_numpy as jax_rows_oracle,
)
from avir_tpu.ops.dither import errdiff_dither_jnp, errdiff_dither_wavefront_jnp
from avir_tpu.plan.plan import build_resize_plan as jax_build_resize_plan

import avir_tpu_torch
from avir_tpu_torch.models import avir as port_avir
from avir_tpu_torch.models.host_reference import (
    execute_plan_numpy,
    execute_plan_rows_numpy,
)
from avir_tpu_torch.ops.cuda import wavefront as wf
from avir_tpu_torch.plan.cache import build_resize_plan_cached
from avir_tpu_torch.plan.plan import build_resize_plan

from test_torch_plan import DT

torch.set_num_threads(1)
CPU = dict(device="cpu")

with open(GOLDEN_DIR / "manifest.json") as f:
    _M = json.load(f)
AVIR_CONFIGS = [n for n, c in _M.items() if c.get("kind") == "avir"]
LANCIR_CONFIGS = [n for n, c in _M.items() if c.get("kind") == "lancir"]


def _lsb(a, b) -> float:
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


# ---------------------------------------------------------------------------
# tests/test_device_exec.py: every golden config through both packages
# ---------------------------------------------------------------------------


def _device_exec_gate(out, ref, cfg):
    """tests/test_device_exec.py's gate: float atol 1e-4; integers 1 LSB
    (u8) or 4 LSB (u16), plus one quantization step for error diffusion,
    and >= 60 dB."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if cfg["tout"] in ("f32", "f64"):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
        return
    peak = 255.0 if cfg["tout"] == "u8" else 65535.0
    tol = 1 if cfg["tout"] == "u8" else 4
    if cfg.get("dither") == "errd":
        tol += 1 << ((8 if cfg["tout"] == "u8" else 16) - cfg["bitdepth"])
    assert _lsb(out, ref) <= tol
    assert psnr(out, ref, peak) >= 60.0


def _golden_src(cfg):
    return xorshift128_fill(
        (cfg["sh"], cfg["sw"], cfg["ch"]), DT[cfg["tin"]], cfg["seed"]
    )


@pytest.mark.parametrize("name", AVIR_CONFIGS)
def test_avir_device_golden_both_packages(name):
    cfg = _M[name]
    src = _golden_src(cfg)
    kw = dict(
        k=cfg["k"], ox=cfg["ox"], oy=cfg["oy"], out_dtype=DT[cfg["tout"]],
        use_srgb_gamma=bool(cfg["gamma"]), alpha_index=cfg["alphaidx"],
        dither="errdiff" if cfg["dither"] == "errd" else "default",
    )

    def run(pkg, **extra):
        return pkg.ImageResizer(
            res_bit_depth=cfg["bitdepth"], params=pkg.preset(cfg["preset"])
        ).resize(src, cfg["nw"], cfg["nh"], **kw, **extra)

    out = run(avir_tpu_torch, **CPU)
    _device_exec_gate(out, load_golden(name), cfg)
    _device_exec_gate(out, run(avir_tpu), cfg)


@pytest.mark.parametrize("name", LANCIR_CONFIGS)
def test_lancir_device_golden_both_packages(name):
    cfg = _M[name]
    src = _golden_src(cfg)
    kw = dict(
        kx=cfg["kx"], ky=cfg["ky"], ox=cfg["ox"], oy=cfg["oy"], la=cfg["la"],
        out_dtype=DT[cfg["tout"]],
    )
    out = avir_tpu_torch.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw, **CPU)
    _device_exec_gate(out, load_golden(name), cfg)
    _device_exec_gate(
        out, avir_tpu.LancIR().resize(src, cfg["nw"], cfg["nh"], **kw), cfg
    )


def test_grayscale_2d_roundtrip():
    src = xorshift128_fill((40, 30), np.uint8, 77)
    out = avir_tpu_torch.resize(src, 45, 60, **CPU)
    assert out.shape == (60, 45) and out.dtype == np.uint8
    assert _lsb(out, avir_tpu.resize(src, 45, 60)) <= 1


def test_fast_mode_quality():
    """split2 both passes clears 50 dB against the port's and the JAX
    package's default route."""
    cfg = _M["a_readme"]
    src = xorshift128_fill((cfg["sh"], cfg["sw"], cfg["ch"]), np.uint8, cfg["seed"])
    fastv = avir_tpu_torch.resize(src, cfg["nw"], cfg["nh"], precision="fast", **CPU)
    assert psnr(avir_tpu_torch.resize(src, cfg["nw"], cfg["nh"], **CPU), fastv, 255.0) >= 50.0
    assert psnr(avir_tpu.resize(src, cfg["nw"], cfg["nh"]), fastv, 255.0) >= 50.0


# ---------------------------------------------------------------------------
# tests/test_api_extras.py
# ---------------------------------------------------------------------------


def test_resize_batch_matches_loop():
    """Each frame of the batch is the single resize, bit for bit (the JAX
    package's test allows 1 LSB for its vmapped program; the port runs the
    single-image executor per frame), and within 1 LSB of the JAX
    package's batch."""
    batch = np.stack(
        [xorshift128_fill((40, 56, 3), np.uint8, 100 + i) for i in range(3)]
    )
    rz = avir_tpu_torch.ImageResizer()
    got = rz.resize_batch(batch, 28, 20, **CPU)
    assert got.shape == (3, 20, 28, 3) and got.dtype == np.uint8
    for i in range(3):
        np.testing.assert_array_equal(got[i], rz.resize(batch[i], 28, 20, **CPU))
    assert _lsb(got, avir_tpu.ImageResizer().resize_batch(batch, 28, 20)) <= 1


@pytest.mark.parametrize(
    "kw, dtype, c",
    [
        ({}, np.uint16, 3),
        ({"dither": "errdiff"}, np.uint8, 3),
        ({"use_srgb_gamma": True, "alpha_index": 3}, np.uint8, 4),
        ({"out_dtype": np.float64}, np.float64, 2),
        ({"precision": "exact"}, np.uint8, 5),
    ],
)
def test_resize_batch_keeps_single_image_bits(kw, dtype, c):
    """Every route through resize_batch gives each frame the bits of
    resize, into a caller's ``out`` (a strided view) as well."""
    batch = np.stack(
        [xorshift128_fill((30, 44, c), dtype, 7 + i) for i in range(3)]
    )
    rz = avir_tpu_torch.ImageResizer()
    singles = np.stack([rz.resize(f, 21, 17, **kw, **CPU) for f in batch])
    np.testing.assert_array_equal(rz.resize_batch(batch, 21, 17, **kw, **CPU), singles)
    big = np.zeros((3, 20, 25, c), singles.dtype)
    view = big[:, 2:19, 3:24]
    assert rz.resize_batch(batch, 21, 17, out=view, **kw, **CPU) is view
    np.testing.assert_array_equal(view, singles)
    assert not big[:, :2].any() and not big[:, 19:].any()


def test_degenerate_inputs():
    """Zero source -> blank output, zero target -> error, a 1-pixel
    source resizes by edge replication, as in the JAX package."""
    for pkg, kw in ((avir_tpu_torch, CPU), (avir_tpu, {})):
        rz, lz = pkg.ImageResizer(), pkg.LancIR()
        out = rz.resize(np.zeros((0, 0, 3), dtype=np.uint8), 8, 6, **kw)
        assert out.shape == (6, 8, 3) and not out.any()
        out = lz.resize(np.zeros((0, 5, 3), dtype=np.uint8), 8, 6, **kw)
        assert out.shape == (6, 8, 3) and not out.any()
        with pytest.raises(ValueError):
            rz.resize(np.zeros((4, 4, 3), dtype=np.uint8), 0, 6, **kw)
        with pytest.raises(ValueError):
            lz.resize(np.zeros((4, 4, 3), dtype=np.uint8), 8, 0, **kw)
    one = np.full((1, 1, 3), 200, dtype=np.uint8)
    for fn in (avir_tpu_torch.ImageResizer().resize, avir_tpu_torch.LancIR().resize):
        out = fn(one, 5, 4, **CPU)
        assert out.shape == (4, 5, 3) and np.abs(out.astype(int) - 200).max() <= 1
    np.testing.assert_array_equal(
        avir_tpu_torch.resize(one, 5, 4, **CPU), avir_tpu.resize(one, 5, 4)
    )


PLAN_KW = dict(
    src_w=97, src_h=61, new_w=151, new_h=83, el_count=3,
    in_dtype=np.uint8, out_dtype=np.uint8,
)


def test_plan_cache_roundtrip(tmp_path):
    p1 = build_resize_plan_cached(cache_dir=tmp_path, **PLAN_KW)
    assert len(list(tmp_path.glob("plan_*.npz"))) == 1
    p2 = build_resize_plan_cached(cache_dir=tmp_path, **PLAN_KW)  # a hit
    ref = build_resize_plan(**PLAN_KW)
    jref = jax_build_resize_plan(**PLAN_KW)
    for ax in ("h", "v"):
        a, b, c = getattr(p1, ax).op, getattr(p2, ax).op, getattr(ref, ax).op
        j = getattr(jref, ax).op
        for x in (a, b, c):
            np.testing.assert_array_equal(x.starts, np.asarray(j.starts))
            np.testing.assert_array_equal(x.taps, np.asarray(j.taps))
            assert (x.n_in, x.n_out) == (j.n_in, j.n_out)


def test_plan_cache_keeps_float64_output(tmp_path):
    kw = dict(PLAN_KW, in_dtype=np.float64, out_dtype=np.float64)
    build_resize_plan_cached(cache_dir=tmp_path, **kw)
    assert build_resize_plan_cached(cache_dir=tmp_path, **kw).out_float64


def test_plan_cache_used_by_resizer(tmp_path, monkeypatch):
    """The resizer's cache lives in the port's own directory: the JAX
    package's (AVIR_TPU_CACHE) is never read or written."""
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    monkeypatch.setenv("AVIR_TPU_TORCH_CACHE", str(ours))
    monkeypatch.setenv("AVIR_TPU_CACHE", str(theirs))
    src = xorshift128_fill((40, 56, 3), np.uint8, 9)
    out1 = avir_tpu_torch.ImageResizer(plan_cache=True).resize(src, 28, 20, **CPU)
    assert len(list(ours.glob("plan_*.npz"))) == 1 and not theirs.exists()
    out2 = avir_tpu_torch.ImageResizer(plan_cache=True).resize(src, 28, 20, **CPU)
    np.testing.assert_array_equal(out1, out2)
    jax_out = avir_tpu.ImageResizer(plan_cache=True).resize(src, 28, 20)
    assert _lsb(out1, jax_out) <= 1
    assert len(list(ours.glob("plan_*.npz"))) == 1


def test_float64_dtype_round_trip():
    src = xorshift128_fill((40, 30, 3), np.float64, 12)
    out = avir_tpu_torch.resize(src, 20, 15, **CPU)
    assert out.dtype == np.float64
    np.testing.assert_allclose(
        out, avir_tpu_torch.resize(src.astype(np.float32), 20, 15, **CPU),
        rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(out, avir_tpu.resize(src, 20, 15), rtol=0, atol=1e-4)
    lout = avir_tpu_torch.lancir_resize(src, 20, 15, **CPU)
    assert lout.dtype == np.float64


def test_f64_host_route_matches_golden():
    """precision="f64" is the float64 host oracle: the golden a_f64 dump
    and the JAX package's host route at the JAX test's tolerance (5e-7);
    engine="host" is the same route."""
    cfg = _M["a_f64"]
    src = xorshift128_fill((cfg["sh"], cfg["sw"], cfg["ch"]), np.float64, cfg["seed"])
    rz = avir_tpu_torch.ImageResizer(res_bit_depth=cfg["bitdepth"])
    out = rz.resize(src, cfg["nw"], cfg["nh"], precision="f64")
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, load_golden("a_f64"), rtol=0, atol=5e-7)
    jax_out = avir_tpu.ImageResizer(res_bit_depth=cfg["bitdepth"]).resize(
        src, cfg["nw"], cfg["nh"], precision="f64"
    )
    np.testing.assert_allclose(out, jax_out, rtol=0, atol=5e-7)
    np.testing.assert_array_equal(
        out, rz.resize(src, cfg["nw"], cfg["nh"], engine="host")
    )


def test_f64_host_route_int_and_errdiff():
    """Integer output and error diffusion (the native scan) on the host
    route: equal to the JAX package's host route, within 1 LSB of the
    device route, the dithered image within 2 of the undithered."""
    src = xorshift128_fill((48, 64, 3), np.uint8, 77)
    rz, jrz = avir_tpu_torch.ImageResizer(), avir_tpu.ImageResizer()
    host = rz.resize(src, 32, 24, precision="f64")
    assert host.dtype == np.uint8
    np.testing.assert_array_equal(host, jrz.resize(src, 32, 24, precision="f64"))
    assert _lsb(host, rz.resize(src, 32, 24, **CPU)) <= 1
    for spelling in ("errdiff", "errdiff-device", "errdiff-wavefront"):
        hd = rz.resize(src, 32, 24, precision="f64", dither=spelling)
        assert hd.dtype == np.uint8 and hd.shape == (24, 32, 3)
        np.testing.assert_array_equal(
            hd, jrz.resize(src, 32, 24, precision="f64", dither=spelling)
        )
        assert _lsb(hd, host) <= 2


def test_f64_lancir_host_route():
    src = xorshift128_fill((40, 56, 3), np.uint8, 31)
    lz = avir_tpu_torch.LancIR()
    host = lz.resize(src, 28, 20, precision="f64")
    assert host.dtype == np.uint8
    np.testing.assert_array_equal(host, avir_tpu.LancIR().resize(src, 28, 20, precision="f64"))
    assert _lsb(host, lz.resize(src, 28, 20, **CPU)) <= 1
    srcf = xorshift128_fill((30, 40, 2), np.float64, 32)
    outf = lz.resize(srcf, 50, 60, precision="f64")
    assert outf.dtype == np.float64
    np.testing.assert_allclose(
        outf, avir_tpu.LancIR().resize(srcf, 50, 60, precision="f64"), rtol=0, atol=5e-7
    )
    np.testing.assert_allclose(
        outf, lz.resize(srcf.astype(np.float32), 50, 60, **CPU), rtol=0, atol=5e-5
    )


def test_out_param_strided_destination():
    src = xorshift128_fill((48, 64, 3), np.uint8, 21)
    big = np.zeros((60, 80, 3), dtype=np.uint8)
    view = big[10:34, 20:52]
    rz = avir_tpu_torch.ImageResizer()
    assert rz.resize(src, 32, 24, out=view, **CPU) is view
    np.testing.assert_array_equal(view, rz.resize(src, 32, 24, **CPU))
    assert _lsb(view, avir_tpu.ImageResizer().resize(src, 32, 24)) <= 1
    assert not big[:10].any() and not big[34:].any()
    lz = avir_tpu_torch.LancIR()
    view2 = big[10:34, 20:52]
    assert lz.resize(src, 32, 24, out=view2, **CPU) is view2
    np.testing.assert_array_equal(view2, lz.resize(src, 32, 24, **CPU))
    with pytest.raises(ValueError):
        rz.resize(src, 32, 24, out=np.zeros((5, 5, 3), np.uint8), **CPU)


def test_lancir_resize_batch():
    batch = np.stack(
        [xorshift128_fill((48, 64, 3), np.uint8, 200 + i) for i in range(3)]
    )
    lz = avir_tpu_torch.LancIR()
    got = lz.resize_batch(batch, 40, 30, **CPU)
    assert got.shape == (3, 30, 40, 3) and got.dtype == np.uint8
    for i in range(3):
        np.testing.assert_array_equal(got[i], lz.resize(batch[i], 40, 30, **CPU))
    assert _lsb(got, avir_tpu.LancIR().resize_batch(batch, 40, 30)) <= 1
    gf = lz.resize_batch(batch, 40, 30, precision="f64")
    np.testing.assert_array_equal(
        gf, avir_tpu.LancIR().resize_batch(batch, 40, 30, precision="f64")
    )
    assert _lsb(gf, got) <= 1


def _noise_dither(calls):
    def noise_dither(img, trunc_bits, out_max, rnd_seed):
        calls.append((img.shape, img.dtype, trunc_bits, out_max, rnd_seed))
        rng = np.random.default_rng(rnd_seed)
        noisy = img + rng.uniform(-0.5, 0.5, img.shape)
        return np.clip(np.floor(noisy + 0.5), 0, out_max)

    return noise_dither


def test_custom_ditherer_slot():
    """A callable ditherer gets the float64 pre-dither image with
    trunc_bits, out_max and rnd_seed, on the device route (the split
    route's image, never int8), the host route and per batch frame; held
    to the JAX package's slot within 1 LSB (the split route's pre-dither
    image against XLA's)."""
    calls = []
    dith = _noise_dither(calls)
    src = xorshift128_fill((48, 64, 3), np.uint8, 99)
    rz = avir_tpu_torch.ImageResizer()
    out1 = rz.resize(src, 32, 24, dither=dith, rnd_seed=1, **CPU)
    out2 = rz.resize(src, 32, 24, dither=dith, rnd_seed=2, **CPU)
    base = rz.resize(src, 32, 24, **CPU)
    assert out1.dtype == np.uint8 and out1.shape == (24, 32, 3)
    assert calls[0] == ((24, 32, 3), np.float64, 0, 255.0, 1)
    assert not np.array_equal(out1, out2)
    assert _lsb(out1, base) <= 2
    jout1 = avir_tpu.ImageResizer().resize(src, 32, 24, dither=dith, rnd_seed=1)
    assert _lsb(out1, jout1) <= 1
    outh = rz.resize(src, 32, 24, dither=dith, rnd_seed=1, precision="f64")
    np.testing.assert_array_equal(
        outh,
        avir_tpu.ImageResizer().resize(src, 32, 24, dither=dith, rnd_seed=1, precision="f64"),
    )
    assert _lsb(outh, out1) <= 1
    outb = rz.resize_batch(np.stack([src, src]), 32, 24, dither=dith, rnd_seed=1, **CPU)
    np.testing.assert_array_equal(outb[0], out1)
    np.testing.assert_array_equal(outb[1], out1)


def test_custom_ditherer_reads_the_split_route():
    """The pre-dither image of the custom slot comes from a route that keeps
    full precision (the executor is built with return_predither)."""
    fn = avir_tpu_torch.ImageResizer()._route(
        48, 64, 3, np.dtype(np.uint8), 32, 24, dither=_noise_dither([]), **CPU
    ).fn
    assert fn.route == "split"
    x = torch.from_numpy(xorshift128_fill((48, 64 * 3), np.uint8, 5))
    assert fn(x).dtype == torch.float32


def test_strided_view_roi_input():
    big = xorshift128_fill((100, 140, 3), np.uint8, 55)
    view = big[20:68, 30:94]
    assert not view.flags["C_CONTIGUOUS"]
    dense = np.ascontiguousarray(view)
    rz, lz = avir_tpu_torch.ImageResizer(), avir_tpu_torch.LancIR()
    np.testing.assert_array_equal(rz.resize(view, 32, 24, **CPU), rz.resize(dense, 32, 24, **CPU))
    np.testing.assert_array_equal(
        rz.resize(view, 32, 24, precision="f64"), rz.resize(dense, 32, 24, precision="f64")
    )
    np.testing.assert_array_equal(
        rz.resize(view, 32, 24, precision="f64"),
        avir_tpu.ImageResizer().resize(view, 32, 24, precision="f64"),
    )
    np.testing.assert_array_equal(lz.resize(view, 32, 24, **CPU), lz.resize(dense, 32, 24, **CPU))
    np.testing.assert_array_equal(
        lz.resize(view, 32, 24, precision="f64"), lz.resize(dense, 32, 24, precision="f64")
    )
    rgba = xorshift128_fill((40, 56, 4), np.uint8, 56)
    rgb_view = rgba[:, :, :3]
    np.testing.assert_array_equal(
        rz.resize(rgb_view, 28, 20, **CPU),
        rz.resize(np.ascontiguousarray(rgb_view), 28, 20, **CPU),
    )


def test_host_route_reads_the_view_uncopied(monkeypatch):
    """The host route hands the oracle the caller's strided view itself."""
    seen = []
    orig = port_avir.execute_plan_numpy

    def spy(plan, src3, **kw):
        seen.append(src3)
        return orig(plan, src3, **kw)

    monkeypatch.setattr(port_avir, "execute_plan_numpy", spy)
    big = xorshift128_fill((60, 80, 3), np.uint8, 3)
    view = big[5:45, 10:70]
    avir_tpu_torch.resize(view, 30, 20, precision="f64")
    assert seen and np.shares_memory(seen[0], big)
    assert seen[0].strides == view.strides


def test_make_resize_fn_traceable():
    """make_resize_fn: a function on tensors of its device, per frame (the
    JAX test vmaps it), equal to resize and within 1 LSB of the JAX
    package's function; grayscale float output with gamma."""
    rng = np.random.default_rng(9)
    batch = rng.integers(0, 256, (3, 60, 80, 3), dtype=np.uint8)
    fn = avir_tpu_torch.make_resize_fn((60, 80, 3), np.uint8, 40, 30, **CPU)
    jfn = avir_tpu.make_resize_fn((60, 80, 3), np.uint8, 40, 30)
    for i in range(3):
        out = fn(torch.from_numpy(batch[i]))
        assert isinstance(out, torch.Tensor) and out.shape == (30, 40, 3)
        np.testing.assert_array_equal(out.numpy(), avir_tpu_torch.resize(batch[i], 40, 30, **CPU))
        assert _lsb(out.numpy(), np.asarray(jfn(jnp.asarray(batch[i])))) <= 1
    g = rng.integers(0, 256, (50, 70), dtype=np.uint8)
    kw = dict(out_dtype=np.float32, use_srgb_gamma=True)
    fng = avir_tpu_torch.make_resize_fn((50, 70), np.uint8, 35, 25, **kw, **CPU)
    og = fng(torch.from_numpy(g)).numpy()
    assert og.shape == (25, 35) and og.dtype == np.float32
    ref = avir_tpu.ImageResizer().resize(g, 35, 25, **kw)
    assert np.abs(og - ref).max() <= 1e-3
    with pytest.raises(ValueError, match="shape"):
        fn(torch.from_numpy(g))
    with pytest.raises(ValueError, match="uint8"):
        fn(torch.zeros((60, 80, 3)))


def test_make_lancir_resize_fn_traceable():
    rng = np.random.default_rng(13)
    batch = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    fn = avir_tpu_torch.make_lancir_resize_fn((48, 64, 3), np.uint8, 80, 56, **CPU)
    jfn = avir_tpu.make_lancir_resize_fn((48, 64, 3), np.uint8, 80, 56)
    for i in range(2):
        out = fn(torch.from_numpy(batch[i])).numpy()
        assert out.shape == (56, 80, 3) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, avir_tpu_torch.lancir_resize(batch[i], 80, 56, **CPU))
        assert _lsb(out, np.asarray(jfn(jnp.asarray(batch[i])))) <= 1


def test_make_resize_fn_flat_layout():
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    fn = avir_tpu_torch.make_resize_fn((60, 80, 3), np.uint8, 40, 30, flat=True, **CPU)
    out = fn(torch.from_numpy(img.reshape(60, 240))).numpy()
    assert out.shape == (30, 40 * 3)
    np.testing.assert_array_equal(out.reshape(30, 40, 3), avir_tpu_torch.resize(img, 40, 30, **CPU))
    assert _lsb(out.reshape(30, 40, 3), avir_tpu.resize(img, 40, 30)) <= 1


def test_device_functions_refuse_host_routes():
    for kw in ({"precision": "f64"}, {"engine": "host"}, {"engine": "xla"}):
        with pytest.raises(ValueError):
            avir_tpu_torch.make_resize_fn((20, 30, 3), np.uint8, 15, 10, **kw, **CPU)
    with pytest.raises(ValueError):
        avir_tpu_torch.make_lancir_resize_fn(
            (20, 30, 3), np.uint8, 15, 10, precision="f64", **CPU
        )


def test_sampled_row_oracle_matches_full():
    """execute_plan_rows_numpy == execute_plan_numpy[rows] exactly, in the
    caller's row order, and equal to the JAX package's."""
    for gamma, tin, tout in (
        (False, np.uint8, np.uint8),
        (True, np.uint8, np.uint8),
        (False, np.uint16, np.uint16),
        (True, np.uint16, np.float32),
    ):
        src = xorshift128_fill((96, 64, 3), tin, 55)
        plan = build_resize_plan(64, 96, 40, 60, 3, tin, tout, use_srgb_gamma=gamma)
        jplan = jax_build_resize_plan(64, 96, 40, 60, 3, tin, tout, use_srgb_gamma=gamma)
        full = execute_plan_numpy(plan, src)
        for rows in (np.array([0, 1, 7, 30, 31, 59]), np.array([30, 7, 59, 7])):
            got = execute_plan_rows_numpy(plan, src, rows)
            np.testing.assert_array_equal(got, full[rows])
            np.testing.assert_array_equal(got, jax_rows_oracle(jplan, src, rows))


def test_float_in_u16_out_large_taps():
    rng = np.random.default_rng(8)
    src = rng.random((60, 85, 2), dtype=np.float32)
    kw = dict(k=0.2836, ox=0.711, oy=-1.365, out_dtype=np.uint16)
    out = avir_tpu_torch.ImageResizer(
        res_bit_depth=16, params=avir_tpu_torch.preset("high")
    ).resize(src, 19, 88, **kw, **CPU)
    plan = build_resize_plan(
        85, 60, 19, 88, 2, np.float32, np.uint16, k=0.2836, ox=0.711, oy=-1.365,
        params=avir_tpu_torch.preset("high"), res_bit_depth=16,
    )
    assert _lsb(out, execute_plan_numpy(plan, src)) <= 4
    jout = avir_tpu.ImageResizer(
        res_bit_depth=16, params=avir_tpu.preset("high")
    ).resize(src, 19, 88, **kw)
    assert _lsb(out, jout) <= 4


# ---------------------------------------------------------------------------
# errdiff-device on K4, the engine spellings, C > 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "h, w, c, tb, om",
    [
        (17, 23, 3, 0, 255.0), (32, 8, 1, 0, 255.0), (1, 16, 3, 0, 255.0),
        (16, 1, 3, 0, 255.0), (20, 31, 4, 0, 65535.0), (12, 15, 5, 0, 255.0),
        (9, 40, 4, 2, 255.0), (24, 24, 3, 4, 255.0), (11, 13, 8, 4, 65535.0),
    ],
)
def test_errdiff_device_k4_matches_sequential_scan(h, w, c, tb, om):
    """dither="errdiff-device" runs K4 (its plain version here) in the scan's
    sum order: bit-equal to the JAX package's sequential nested scan
    errdiff_dither_jnp at trunc_bits=0, within one quantization step
    otherwise (the JAX package's engine tolerance,
    wavefront_kernel.py:25-30)."""
    img = (np.random.default_rng(h * 100 + w).random((h, w, c)) * om).astype(np.float32)
    got = wf.errdiff_wavefront(torch.from_numpy(img), tb, om, scan_order=True).numpy()
    want = np.asarray(errdiff_dither_jnp(jnp.asarray(img), tb, om))
    if tb == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= om / (int(om) >> tb)


def test_wavefront_order_gap_at_16_bit():
    """The finding behind the scan order: the JAX package's own wavefront
    and sequential scan differ by one step on isolated pixels of a 16-bit
    image at trunc_bits=0; K4 gives each engine's bits in its order."""
    img = (np.random.default_rng(7).random((20, 31, 4)) * 65535.0).astype(np.float32)
    seq = np.asarray(errdiff_dither_jnp(jnp.asarray(img), 0, 65535.0))
    wav = np.asarray(errdiff_dither_wavefront_jnp(jnp.asarray(img), 0, 65535.0))
    x = torch.from_numpy(img)
    np.testing.assert_array_equal(wf.errdiff_wavefront(x, 0, 65535.0).numpy(), wav)
    np.testing.assert_array_equal(
        wf.errdiff_wavefront(x, 0, 65535.0, scan_order=True).numpy(), seq
    )
    assert 0 < np.count_nonzero(wav != seq) and np.abs(wav - seq).max() == 1.0


@pytest.mark.parametrize(
    "dtype, bits, c", [(np.uint8, 8, 3), (np.uint16, 16, 4), (np.uint8, 6, 5)]
)
def test_errdiff_device_resize(dtype, bits, c):
    """errdiff-device runs one K4 route in the scan's order: within one
    quantization step of errdiff (the wavefront's order) and of the JAX
    package's errdiff-device resize, and bit-equal to K4's plain version
    in scan order on the port's own pre-dither image."""
    src = xorshift128_fill((48, 64, c), dtype, 11)
    rz = avir_tpu_torch.ImageResizer(res_bit_depth=bits)
    dev = rz.resize(src, 40, 30, dither="errdiff-device", **CPU)
    step = (1 << ((8 if dtype == np.uint8 else 16) - bits)) + 1
    assert _lsb(dev, rz.resize(src, 40, 30, dither="errdiff", **CPU)) <= step
    jdev = avir_tpu.ImageResizer(res_bit_depth=bits).resize(
        src, 40, 30, dither="errdiff-device"
    )
    assert _lsb(dev, jdev) <= step
    fn = rz._route(48, 64, c, np.dtype(dtype), 40, 30, dither="errdiff", **CPU).fn
    pre = rz._route(
        48, 64, c, np.dtype(dtype), 40, 30, dither=lambda *a: a[0], **CPU
    ).fn(torch.from_numpy(src.reshape(48, -1)))
    assert fn.route == "split"
    out_max = 255.0 if dtype == np.uint8 else 65535.0
    want = wf.errdiff_wavefront(
        pre.reshape(30, 40, c), (8 if dtype == np.uint8 else 16) - bits, out_max,
        out_dtype=torch.uint8 if dtype == np.uint8 else torch.uint16,
        scan_order=True,
    ).numpy()
    np.testing.assert_array_equal(dev, want)


def test_engine_spellings():
    src = xorshift128_fill((48, 64, 3), np.uint8, 12)
    rz = avir_tpu_torch.ImageResizer()
    np.testing.assert_array_equal(
        rz.resize(src, 32, 24, engine="pallas", **CPU), rz.resize(src, 32, 24, **CPU)
    )
    with pytest.raises(ValueError, match="precision='exact'"):
        rz.resize(src, 32, 24, engine="xla", **CPU)
    with pytest.raises(ValueError, match="unknown engine"):
        rz.resize(src, 32, 24, engine="tpu", **CPU)
    with pytest.raises(ValueError, match="unknown dither"):
        rz.resize(src, 32, 24, dither="bayer", **CPU)


@pytest.mark.parametrize("c", [5, 8])
@pytest.mark.parametrize(
    "tin, tout, kw",
    [
        (np.uint8, np.uint8, {}),                       # int8 route
        (np.uint16, np.uint16, {"res_bit_depth": 16}),  # split route
        (np.float32, np.float32, {"precision": "exact"}),
        (np.uint8, np.uint8, {"dither": "errdiff"}),    # split + K4
    ],
)
@pytest.mark.parametrize("size", [(24, 20), (70, 50)], ids=["down", "up"])
def test_more_than_four_channels(c, tin, tout, kw, size):
    """C = 5 and C = 8 run on every route and match the JAX package, which
    has no channel limit."""
    src = xorshift128_fill((37, 45, c), tin, 40 + c)
    nw, nh = size
    out = avir_tpu_torch.resize(src, nw, nh, out_dtype=tout, **kw, **CPU)
    ref = avir_tpu.resize(src, nw, nh, out_dtype=tout, **kw)
    assert out.shape == (nh, nw, c) and out.dtype == np.dtype(tout)
    if tout == np.float32:
        assert np.abs(out - ref).max() <= np.abs(ref).max() * 1e-4
    else:
        assert _lsb(out, ref) <= 1 + (1 if kw.get("dither") else 0)


@pytest.mark.parametrize("c", [5, 8])
def test_more_than_four_channels_lancir(c):
    src = xorshift128_fill((37, 45, c), np.uint8, 60 + c)
    for nw, nh in ((24, 20), (70, 50)):
        out = avir_tpu_torch.lancir_resize(src, nw, nh, **CPU)
        assert _lsb(out, avir_tpu.lancir_resize(src, nw, nh)) <= 1
