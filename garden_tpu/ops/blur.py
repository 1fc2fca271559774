"""Shared image-process kernels: blurs and downsamples.

Rebuild of GpuProcessSystem (include/garden/system/render/gpu-process.hpp:29,
shaders/process/*: box/bilateral/gaussian blurs, normal-aware downsample,
GGX blur chains used by reflections/refraction). All separable filters are
expressed as dense shifted adds — XLA fuses the taps into one pass.
"""

from __future__ import annotations

import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


from garden_tpu.ops.shifts import Shifter


def gaussian_kernel(radius: int, sigma: Optional[float] = None) -> np.ndarray:
    sigma = sigma or max(radius / 2.0, 1e-3)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: Array, radius: int = 2, sigma: Optional[float] = None) -> Array:
    """Separable gaussian blur (process/gaussian-blur.frag)."""
    k = gaussian_kernel(radius, sigma)
    at = Shifter(img, 0, radius)
    out = jnp.zeros_like(img)
    for i, wgt in enumerate(k):
        out = out + at(0, radius - i) * wgt
    at = Shifter(out, radius, 0)
    out = jnp.zeros_like(img)
    for i, wgt in enumerate(k):
        out = out + at(radius - i, 0) * wgt
    return out


def box_blur(img: Array, radius: int = 1) -> Array:
    """Box blur (process/box-blur.frag)."""
    n = 2 * radius + 1
    at = Shifter(img, 0, radius)
    out = jnp.zeros_like(img)
    for d in range(-radius, radius + 1):
        out = out + at(0, -d)
    at = Shifter(out / n, radius, 0)
    out = jnp.zeros_like(img)
    for d in range(-radius, radius + 1):
        out = out + at(-d, 0)
    return out / n


def bilateral_blur(img: Array, guide_depth: Array, radius: int = 2,
                   depth_sigma: float = 0.1) -> Array:
    """Depth-aware (bilateral) blur — used for AO/shadow denoise
    (process/bilateral-blur.frag)."""
    k = gaussian_kernel(radius)
    g_at = Shifter(guide_depth, radius, radius)
    i_at = Shifter(img, radius, radius)
    acc = jnp.zeros_like(img)
    wacc = jnp.zeros(img.shape[:2] + (1,) * (img.ndim - 2), img.dtype)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = k[dy + radius] * k[dx + radius]
            d = g_at(-dy, -dx)
            dw = jnp.exp(-jnp.abs(d - guide_depth) / depth_sigma)
            w = wgt * dw
            while w.ndim < img.ndim:
                w = w[..., None]
            acc = acc + i_at(-dy, -dx) * w
            wacc = wacc + w
    return acc / jnp.maximum(wacc, 1e-6)


def downsample2x(img: Array) -> Array:
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    return x.reshape((h // 2, 2, w // 2, 2) + x.shape[2:]).mean(axis=(1, 3))


def decimate2x(img: Array) -> Array:
    """2x mean-pool decimation via reduce_window. A strided slice
    (`x[::2, ::2]`) can lower to a gather, and a single 5-D
    reshape+reduce forces layout copies; native window reduction does
    neither and antialiases as a bonus."""
    import jax
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    x = img[:h, :w]
    chan = x.ndim == 3
    if not chan:
        x = x[..., None]
    out = jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (2, 2, 1), (2, 2, 1), "VALID") * 0.25
    return out if chan else out[..., 0]


def upsample2x_to(x: Array, th: int, tw: int) -> Array:
    """(h, w, ...) -> (th, tw, ...) via repeat + 3x3 tent — the dense
    replacement for jax.image.resize 'linear' (which lowers to gathers)."""
    chan = x.ndim == 3
    if not chan:
        x = x[..., None]
    up = jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1)
    if up.shape[0] < th or up.shape[1] < tw:
        up = jnp.pad(up, ((0, max(th - up.shape[0], 0)),
                          (0, max(tw - up.shape[1], 0)), (0, 0)), mode="edge")
    up = up[:th, :tw]
    p = jnp.pad(up, ((1, 1), (1, 1), (0, 0)), mode="edge")
    out = (
        p[0:-2, 0:-2] + 2 * p[0:-2, 1:-1] + p[0:-2, 2:]
        + 2 * p[1:-1, 0:-2] + 4 * p[1:-1, 1:-1] + 2 * p[1:-1, 2:]
        + p[2:, 0:-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
    ) / 16.0
    return out if chan else out[..., 0]


def ggx_blur_chain(img: Array, levels: int = 4) -> list:
    """Progressively blurred mip chain for rough reflections (the reference's
    GGX blur chain for refraction, deferred.cpp:584-604)."""
    chain = [img]
    for _ in range(levels):
        chain.append(downsample2x(gaussian_blur(chain[-1], radius=1)))
    return chain


def bilateral_upsample_to(x: Array, guide_lo: Array, guide_full: Array,
                          th: int, tw: int) -> Array:
    """Depth-guided (joint bilateral) upsample of a low-res factor `x`
    (h, w[, c]) to (th, tw[, c]) using a low-res guide (h, w) and the
    full-res guide (th, tw) — typically view depth. Each output pixel
    blends the repeated low-res neighborhood weighted by guide similarity,
    so decimated shadow/AO factors keep crisp silhouettes at depth edges
    (the industry half-res-resolve + bilateral-upsample pattern). All
    dense ops (repeat + shifted adds); handles any power-of-two ratio by
    repeated 2x application."""
    chan = x.ndim == 3
    if not chan:
        x = x[..., None]

    def up_to(a, h, w):
        while a.shape[0] < h or a.shape[1] < w:
            a = jnp.repeat(jnp.repeat(a, 2, axis=0), 2, axis=1)
        return a[:h, :w]

    upx = up_to(x, th, tw)
    upg = up_to(guide_lo[..., None], th, tw)[..., 0]

    x_at = Shifter(upx, 1, 1)
    g_at = Shifter(upg, 1, 1)

    eps = 1e-3
    acc = jnp.zeros((th, tw, x.shape[-1]), x.dtype)
    wsum = jnp.zeros((th, tw, 1), x.dtype)
    scale = jnp.maximum(jnp.abs(guide_full), 1.0)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1), (0, -1), (-1, 0)):
        cand = x_at(dy, dx)
        g = g_at(dy, dx)
        w = 1.0 / (jnp.abs(g - guide_full) / scale + eps)
        acc = acc + cand * w[..., None]
        wsum = wsum + w[..., None]
    out = acc / jnp.maximum(wsum, 1e-9)
    return out if chan else out[..., 0]
