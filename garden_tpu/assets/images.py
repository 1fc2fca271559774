"""Host-side image loading for the resource pipeline.

Rebuild of ResourceSystem's image loaders (reference:
source/system/resource.cpp image loading paths; supported formats at
include/garden/system/resource.hpp:136-151 — png/webp/exr/hdr + Basis).
Device mapping: images decode on the host (PIL for png/webp/jpeg/bmp, a tiny
native reader for Radiance .hdr) into float32 numpy arrays that upload into
the scene's texture array / sprite atlas. Basis/KTX GPU-codec formats are
n/a (XLA owns device memory layout).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

try:
    from PIL import Image
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def load_image(path: str, linearize: bool = True) -> np.ndarray:
    """Load an image file -> float32 (H, W, 4) RGBA in [0, 1] (linear by
    default; pass linearize=False for data textures like normal maps)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".exr":
        return load_exr(path)
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable: cannot decode " + path)
    img = Image.open(path).convert("RGBA")
    arr = np.asarray(img, np.float32) / 255.0
    if linearize:
        rgb = srgb_to_linear(arr[..., :3])
        arr = np.concatenate([rgb, arr[..., 3:4]], axis=-1)
    return arr


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader -> float32 (H, W, 4), linear.
    Supports the common 32-bit_rle_rgbe format (flat or RLE scanlines)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b""):
                break
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError("unsupported HDR orientation")
        h, w = int(dims[1]), int(dims[3])
        data = f.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2:
            # adaptive RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:            # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:  # flat scanline
            row = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    exp = rgbe[..., 3].astype(np.int32) - 136  # 128 + 8 mantissa bits
    scale = np.ldexp(np.ones_like(exp, np.float32), exp)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return np.concatenate([rgb, np.ones((h, w, 1), np.float32)], axis=-1)


def save_png(path: str, image: np.ndarray) -> None:
    """Store a float [0,1] or uint8 image as PNG (debug dumps / examples)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable")
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def resize_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Host-side resize (for texture-array slot normalization)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable")
    h, w = size
    u8 = np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8)
    out = Image.fromarray(u8).resize((w, h), Image.BILINEAR)
    return np.asarray(out, np.float32) / 255.0


def load_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR 2.0 scanline reader -> float32 (H, W, 4) RGBA.

    Covers the common interchange subset (reference loads .exr via a full
    library, resource.hpp:136-151): single-part scanline images, HALF or
    FLOAT channels, NO_COMPRESSION or ZIP/ZIPS (zlib). Tiled, deep, and
    PIZ/PXR24/B44 images are rejected with a clear error.
    """
    import zlib
    import struct

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError(f"{path}: not an EXR file")
    version = data[4]
    flags = data[5:8]
    if flags[1] & 0x02:
        raise ValueError(f"{path}: tiled EXR unsupported (scanline only)")
    off = 8

    def read_cstr(o):
        end = data.index(b"\x00", o)
        return data[o:end].decode("latin1"), end + 1

    # parse the header attribute list
    attrs = {}
    while True:
        if data[off] == 0:
            off += 1
            break
        name, off = read_cstr(off)
        atype, off = read_cstr(off)
        size = struct.unpack_from("<i", data, off)[0]
        off += 4
        attrs[name] = (atype, data[off:off + size])
        off += size

    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):      # NONE, ZIPS, ZIP
        raise ValueError(
            f"{path}: compression {comp} unsupported (NONE/ZIP/ZIPS only)")
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    w = xmax - xmin + 1
    h = ymax - ymin + 1

    # channel list: sequence of (name, type i32, pLinear, 3 pad, xs, ys)
    chans = []
    cb = attrs["channels"][1]
    co = 0
    while cb[co] != 0:
        end = cb.index(b"\x00", co)
        cname = cb[co:end].decode("latin1")
        ctype = struct.unpack_from("<i", cb, end + 1)[0]  # 0=uint,1=half,2=float
        chans.append((cname, ctype))
        co = end + 1 + 16
    chans_in_file = list(chans)  # EXR stores channels alphabetically

    lines_per_block = 1 if comp in (0, 2) else 16
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", data, off)

    def ctype_np(t):
        return np.float16 if t == 1 else (
            np.float32 if t == 2 else np.uint32)

    planes = {c: np.zeros((h, w), np.float32) for c, _ in chans_in_file}
    for bo in offsets:
        y0, size = struct.unpack_from("<ii", data, bo)
        raw = data[bo + 8: bo + 8 + size]
        ny = min(lines_per_block, ymax - y0 + 1)
        if comp in (2, 3):
            raw = zlib.decompress(raw)
            # EXR zip predictor: delta-decode (t[i] = t[i-1] + raw[i] - 128
            # for i >= 1) then de-interleave the two halves
            arr = np.frombuffer(raw, np.uint8).astype(np.int64)
            arr = arr - 128
            if len(arr):
                arr[0] += 128
            arr = (np.cumsum(arr) % 256).astype(np.uint8)
            half = (len(arr) + 1) // 2
            out = np.empty(len(arr), np.uint8)
            out[0::2] = arr[:half]
            out[1::2] = arr[half:]
            raw = out.tobytes()
        # scanlines: for each line, channels in file order, w samples each
        lo = 0
        for line in range(ny):
            yy = y0 - ymin + line
            if yy >= h:
                break
            for cname, ctp in chans_in_file:
                npt = ctype_np(ctp)
                nbytes = w * np.dtype(npt).itemsize
                vals = np.frombuffer(raw[lo:lo + nbytes], npt)
                planes[cname][yy] = vals.astype(np.float32)
                lo += nbytes

    out = np.zeros((h, w, 4), np.float32)
    out[..., 3] = 1.0
    for i, c in enumerate("RGB"):
        if c in planes:
            out[..., i] = planes[c]
    if "A" in planes:
        out[..., 3] = planes["A"]
    if "Y" in planes and "R" not in planes:  # luminance-only
        out[..., 0] = out[..., 1] = out[..., 2] = planes["Y"]
    return out
