"""imageresize-equivalent command line tool.

Mirrors the reference's ``imageresize`` utility surface (flags recovered
from the prebuilt binary's usage strings and
the reference's README.md:234-249): JPG/PNG/PNG-48/WebP input and
output, ``--out-size``, ``--algparams`` quality presets, ``--dither``,
``--1bit``, ``--lancir``, ``--gamma``, ``--force-8bit``,
``--out-quality``, ``--jpeg-low-cs``, ``--zero-flush``,
``--auto-scale``.  Counterpart of the JAX package's ``cli.py``, with the
same options and outputs, plus ``--device`` (default: the CUDA card;
``cpu`` runs the kernels' plain versions).  PNG I/O (incl. 16-bit) uses
the native codec; Pillow is imported only for JPEG/WebP and for PNGs the
codec does not read.

Usage:
  python -m avir_tpu_torch.cli in.jpg out.png --out-size=1024x768 [options]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load an image as [H, W, C] uint8 or uint16."""
    p = pathlib.Path(path)
    ext = p.suffix.lower()
    data = p.read_bytes()
    if ext == ".png":
        from . import native

        try:
            return native.png_decode(data)
        except (ValueError, RuntimeError):
            pass  # palette/interlaced etc. — fall through to Pillow
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    if img.mode == "I;16":
        return np.asarray(img, dtype=np.uint16)[:, :, None]
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def save_image(
    path: str, img: np.ndarray, quality: int = 90, jpeg_low_cs: bool = False
) -> None:
    p = pathlib.Path(path)
    ext = p.suffix.lower()
    if ext == ".png":
        from . import native

        p.write_bytes(native.png_encode(img))
        return
    from PIL import Image

    if img.dtype == np.uint16:
        raise SystemExit(
            "16-bit output requires .png (use --force-8bit for "
            f"{ext})"
        )
    arr = img[:, :, 0] if img.shape[2] == 1 else img
    pil = Image.fromarray(arr)
    if ext in (".jpg", ".jpeg"):
        if pil.mode == "RGBA":
            pil = pil.convert("RGB")
        pil.save(
            str(p),
            quality=quality,
            # Pillow subsampling codes: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0.
            # The reference binary's usage string promises "4:2:2
            # chrominance sub-sampling" for this flag.
            subsampling=1 if jpeg_low_cs else 0,
        )
    elif ext == ".webp":
        pil.save(str(p), quality=quality)
    else:
        raise SystemExit(f"unsupported output extension {ext!r}")


def parse_size(s: str) -> tuple[int, int]:
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError:
        raise SystemExit(f"invalid --out-size {s!r} (expected WIDTHxHEIGHT)")


def resolve_size(w: int, h: int, sw: int, sh: int) -> tuple[int, int]:
    if w == 0 and h == 0:
        raise SystemExit("--out-size width and height cannot both be 0")
    if w == 0:
        w = max(1, round(h * sw / sh))
    if h == 0:
        h = max(1, round(w * sh / sw))
    return w, h


def run_one(src: np.ndarray, new_w: int, new_h: int, args) -> np.ndarray:
    import avir_tpu_torch

    ch = src.shape[2]
    out_dtype = (
        np.uint8
        if (args.force_8bit or src.dtype == np.uint8)
        else src.dtype
    )
    if args.lancir:
        if src.dtype != np.uint8 or args.dither or args.gamma:
            raise SystemExit(
                "--lancir supports only 8-bit input without dither/gamma"
            )
        return avir_tpu_torch.lancir_resize(src, new_w, new_h, device=args.device)

    res_bits = 8 if out_dtype == np.uint8 else 16
    if args.one_bit:
        if not args.dither:
            raise SystemExit("--1bit requires --dither")
        res_bits = 1
    rz = avir_tpu_torch.ImageResizer(
        res_bit_depth=res_bits,
        src_bit_depth=8 if src.dtype == np.uint8 else 16,
        params=avir_tpu_torch.preset(args.algparams),
    )
    if args.zero_flush > 0 and ch == 4:
        # Flush-to-zero by alpha runs on the INPUT, zeroing the whole
        # pixel (RGB and alpha) below the threshold BEFORE resizing —
        # verified against the shipped imageresize binary
        # (tests/test_reference_binary.py): near-transparent source
        # colors must not bleed into the resized image.
        src = np.array(src)
        src[src[:, :, 3] < args.zero_flush] = 0
    out = rz.resize(
        src,
        new_w,
        new_h,
        out_dtype=out_dtype,
        use_srgb_gamma=args.gamma,
        # Gamma bypasses the alpha channel only for 4-channel images
        # with alpha first or last (avir.h:2520-2527); 2-channel
        # grey+alpha has no bypass in the reference either.
        alpha_index=3 if ch == 4 and args.gamma else -1,
        dither="errdiff" if args.dither else "default",
        device=args.device,
    )
    return out


def crop_for_aspect(
    src: np.ndarray, nw: int, nh: int, align: str
) -> np.ndarray:
    """Crop the input to the output aspect ratio with 0/1/2 (start/
    center/end) per-axis alignment, matching the reference tool's
    --crop semantics (binary usage strings)."""
    if len(align) != 2 or any(ch not in "012" for ch in align):
        raise SystemExit(f"invalid --crop {align!r} (two digits 0/1/2)")
    ax, ay = int(align[0]), int(align[1])
    sh, sw = src.shape[:2]
    target = nw / nh
    if sw / sh > target:  # too wide: crop width
        cw = max(1, round(sh * target))
        off = {0: 0, 1: (sw - cw) // 2, 2: sw - cw}[ax]
        return src[:, off : off + cw]
    ch_ = max(1, round(sw / target))
    off = {0: 0, 1: (sh - ch_) // 2, 2: sh - ch_}[ay]
    return src[off : off + ch_]


def add_reflection(img: np.ndarray, spec: str) -> np.ndarray:
    """Append a vertically-flipped, alpha-faded reflection below the
    resized image — the reference tool's HEIGHT*ALPHA1[*ALPHA2]
    effect, applied AFTER resizing (HEIGHT is in output pixels).
    Semantics verified against the shipped
    imageresize binary (tests/test_reference_binary.py): the result is
    always RGBA (the original part gets alpha 255 / its own alpha);
    reflection rows keep the flipped colors verbatim and fade via
    alpha = rint(alpha_flipped * linspace(A1, A2, HEIGHT))."""
    parts = spec.split("*")
    if len(parts) not in (2, 3):
        raise SystemExit(f"invalid --reflection {spec!r}")
    try:
        height = int(parts[0])
        a1 = float(parts[1])
        a2 = float(parts[2]) if len(parts) == 3 else 0.0
    except ValueError:
        raise SystemExit(f"invalid --reflection {spec!r}")
    if img.dtype != np.uint8:
        raise SystemExit("--reflection supports 8-bit images only")
    ch = img.shape[2]
    if ch in (1, 2):  # expand grey(-alpha) to RGB(A)
        rgb = np.repeat(img[:, :, :1], 3, axis=2)
    else:
        rgb = img[:, :, :3]
    if ch in (2, 4):
        alpha = img[:, :, -1]
    else:
        alpha = np.full(img.shape[:2], 255, np.uint8)
    height = min(height, img.shape[0])
    base = np.concatenate([rgb, alpha[:, :, None]], axis=2)
    if height <= 0:
        return base
    ramp = np.linspace(a1, a2, height)[:, None]
    r_alpha = np.clip(
        np.rint(alpha[-height:][::-1].astype(np.float64) * ramp),
        0, 255,
    ).astype(np.uint8)
    refl = np.concatenate(
        [rgb[-height:][::-1], r_alpha[:, :, None]], axis=2
    )
    return np.concatenate([base, refl], axis=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="avir-imageresize",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument("input", help="input image (.jpg/.png/.webp)")
    ap.add_argument("output", help="output image (.jpg/.png/.webp)")
    ap.add_argument(
        "--out-size",
        default=None,
        help="WIDTHxHEIGHT; 0 auto-calculates from aspect (e.g. 1024x0)",
    )
    ap.add_argument(
        "--algparams",
        default="def",
        choices=["ulr", "lr", "low", "def", "high", "ultra"],
        help="resizing quality preset",
    )
    ap.add_argument(
        "--dither", action="store_true",
        help="error-diffusion dithering instead of rounding",
    )
    ap.add_argument(
        "--1bit", dest="one_bit", action="store_true",
        help="1-bit dithered output (quality evaluation; needs --dither)",
    )
    ap.add_argument(
        "--lancir", action="store_true",
        help="use the LANCIR algorithm (8-bit, no dither/gamma)",
    )
    ap.add_argument(
        "-g", "--gamma", action="store_true",
        help="sRGB gamma-corrected (linear-light) resizing",
    )
    ap.add_argument(
        "--force-8bit", action="store_true",
        help="force 8-bit output from 16-bit input",
    )
    ap.add_argument(
        "--out-quality", type=int, default=90,
        help="JPG/WebP quality 1..100 (ignored for PNG)",
    )
    ap.add_argument(
        "--jpeg-low-cs", action="store_true",
        help="4:2:2 chrominance subsampling for smaller JPEGs",
    )
    ap.add_argument(
        "--zero-flush", type=int, default=0,
        help="flush RGB to zero where alpha < value (1..255)",
    )
    ap.add_argument(
        "--crop", default=None,
        help="two digits (0/1/2 each) for horizontal/vertical alignment; "
        'crops the input so the resize is proportional (e.g. "11" = '
        "center-center); requires both --out-size values non-zero",
    )
    ap.add_argument(
        "--fit", action="store_true",
        help="resize proportionally to fit inside --out-size "
        "(cannot be combined with --crop)",
    )
    ap.add_argument(
        "--reflection", default=None,
        help='HEIGHT*ALPHA1[*ALPHA2] reflection effect (e.g. "15*0.4"), '
        "8-bit images only",
    )
    ap.add_argument(
        "--auto-scale", default=None,
        help='semicolon-delimited scale factors, e.g. "0.25;0.5;1.0"; '
        "suffixes output filenames and prints produced dimensions",
    )
    ap.add_argument(
        "-t", "--num-threads", type=int, default=0,
        help="accepted for compatibility (device execution ignores it)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device to resize on (default: the CUDA card; 'cpu' "
        "runs the kernels' plain PyTorch versions)",
    )
    args = ap.parse_args(argv)

    src = load_image(args.input)
    sh, sw = src.shape[:2]

    if args.crop is not None and args.fit:
        raise SystemExit("--crop cannot be used together with --fit")

    if args.auto_scale:
        scales = [float(s) for s in args.auto_scale.split(";") if s]
        if not scales:
            raise SystemExit("--auto-scale is empty")
        outp = pathlib.Path(args.output)
        produced = {}
        for i, sc in enumerate(scales):
            nw, nh = max(1, round(sw * sc)), max(1, round(sh * sc))
            out = run_one(src, nw, nh, args)
            if args.reflection:
                # the reflection height scales with the factor
                # (verified against the shipped binary: 80x60 + h=10
                # reflection at 0.5 -> 40x35 = 30 + 5)
                parts = args.reflection.split("*")
                hs = int(int(parts[0]) * sc + 0.5)
                out = add_reflection(
                    out, "*".join([str(hs)] + parts[1:])
                )
            # the reference tool suffixes produced files "-1", "-2", …
            # and prints a {"__file-list": {path: {f, w, h}}} JSON map
            path = outp.with_name(f"{outp.stem}-{i + 1}{outp.suffix}")
            save_image(
                str(path), out, args.out_quality, args.jpeg_low_cs
            )
            produced[str(path)] = {
                "f": i, "w": out.shape[1], "h": out.shape[0]
            }
        print(json.dumps({"__file-list": produced}))
        return 0

    if not args.out_size:
        raise SystemExit("--out-size is required (e.g. --out-size=1024x768)")
    nw, nh = parse_size(args.out_size)
    if args.crop is not None:
        if nw == 0 or nh == 0:
            raise SystemExit("--crop requires both --out-size values")
        src = crop_for_aspect(src, nw, nh, args.crop)
        sh, sw = src.shape[:2]
    elif args.fit:
        if nw == 0 or nh == 0:
            raise SystemExit("--fit requires both --out-size values")
        scale = min(nw / sw, nh / sh)
        nw = max(1, round(sw * scale))
        nh = max(1, round(sh * scale))
    nw, nh = resolve_size(nw, nh, sw, sh)
    out = run_one(src, nw, nh, args)
    if args.reflection:
        # output effect: HEIGHT is in output pixels (verified against
        # the shipped binary at non-unit scales)
        out = add_reflection(out, args.reflection)
    save_image(args.output, out, args.out_quality, args.jpeg_low_cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
