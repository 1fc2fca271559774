"""Tone mapping + auto exposure.

Rebuild of ToneMappingSystem (include/garden/system/render/tone-mapping.hpp:
30-60, shaders/tone-mapping/functions.h:19-21: ACES and Uchimura curves,
exposure from the luminance buffer, dither) and AutoExposureSystem
(auto-exposure.hpp:45-65: 256-bin luminance histogram + temporal adaptation;
shaders/auto-exposure/*.comp).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from garden_tpu.core import math3d as m3

Array = jnp.ndarray

MIN_LOG_LUM = -10.0
MAX_LOG_LUM = 6.0


def aces(x: Array) -> Array:
    """ACES filmic fit (Narkowicz), as in tone-mapping/aces.h."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def uchimura(x: Array, p: float = 1.0, a: float = 1.0, m: float = 0.22,
             l: float = 0.4, c: float = 1.33, b: float = 0.0) -> Array:
    """Uchimura (Gran Turismo) curve, as in tone-mapping/uchimura.h."""
    l0 = ((p - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * p) / (p - s1)
    cp = -c2 / p

    w0 = 1.0 - jnp.clip((x - m) / jnp.maximum(l0, 1e-6), 0.0, 1.0) ** 2 * (
        3.0 - 2.0 * jnp.clip((x - m) / jnp.maximum(l0, 1e-6), 0.0, 1.0))
    w0 = jnp.where(x < m, 1.0, jnp.where(x > s0, 0.0, w0))
    w2 = jnp.where(x > s0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2

    toe = m * jnp.power(jnp.maximum(x, 1e-9) / m, c) + b
    linear = m + a * (x - m)
    shoulder = p - (p - s1) * jnp.exp(cp * (x - s0))
    return jnp.clip(toe * w0 + linear * w1 + shoulder * w2, 0.0, 1.0)


def luminance_histogram(hdr: Array, bins: int = 256) -> Array:
    """256-bin log-luminance histogram (auto-exposure.hpp:65 analog).

    Computed on an 8x-downsampled luminance plane (exposure metering is a
    trimmed MEAN over ~32K samples — statistically indistinguishable from
    full res), binned DENSELY: a scatter-add histogram collides on the
    few busy bins, and the one-hot compare must stay small enough that its
    (P, bins) f32 materialization is cheap (33 MB at 1080p/8, against
    133 MB at /4)."""
    lum = m3.luminance(hdr)
    if lum.ndim == 2 and lum.shape[0] >= 16 and lum.shape[1] >= 16:
        h8, w8 = (lum.shape[0] // 8) * 8, (lum.shape[1] // 8) * 8
        lum = lum[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8).mean(axis=(1, 3))
    log_lum = jnp.where(
        lum > 1e-6, jnp.log2(jnp.maximum(lum, 1e-6)), MIN_LOG_LUM
    )
    t = (log_lum - MIN_LOG_LUM) / (MAX_LOG_LUM - MIN_LOG_LUM)
    bucket = jnp.clip((t * bins).astype(jnp.int32), 0, bins - 1)
    onehot = (bucket.reshape(-1, 1)
              == jnp.arange(bins, dtype=jnp.int32)[None, :])
    return jnp.sum(onehot.astype(jnp.float32), axis=0)


def average_luminance_from_histogram(hist: Array, low_cut: float = 0.5,
                                     high_cut: float = 0.95) -> Array:
    """Trimmed-mean log luminance (reject darkest/brightest tails as the
    reference's average compute shader does)."""
    bins = hist.shape[0]
    total = jnp.sum(hist)
    cdf = jnp.cumsum(hist)
    # a bin is kept if its population overlaps the [low_cut, high_cut] band
    keep = (cdf >= total * low_cut) & (cdf - hist <= total * high_cut)
    centers = MIN_LOG_LUM + (jnp.arange(bins, dtype=jnp.float32) + 0.5) / bins * (
        MAX_LOG_LUM - MIN_LOG_LUM
    )
    w = hist * keep
    mean_log = jnp.sum(centers * w) / jnp.maximum(jnp.sum(w), 1.0)
    return jnp.exp2(mean_log)


def adapt_exposure(prev_avg_lum: Array, target_avg_lum: Array, delta_time: Array,
                   speed_up: float = 3.0, speed_down: float = 1.0) -> Array:
    """Temporal eye adaptation (auto-exposure.cpp:25-103 analog)."""
    speed = jnp.where(target_avg_lum > prev_avg_lum, speed_up, speed_down)
    t = 1.0 - jnp.exp(-delta_time * speed)
    return prev_avg_lum + (target_avg_lum - prev_avg_lum) * t


def exposure_from_luminance(avg_lum: Array, key: float = 0.18,
                            compensation: float = 0.0) -> Array:
    return key / jnp.maximum(avg_lum, 1e-4) * jnp.exp2(compensation)


def tone_map(hdr: Array, exposure: Array, mode: str = "aces",
             dither_seed: Array = None) -> Array:
    """HDR (H,W,3) -> LDR float sRGB in [0,1] (quantize with `to_uint8`)."""
    x = hdr * exposure
    curve = aces if mode == "aces" else uchimura
    ldr = curve(x)
    srgb = m3.linear_to_srgb(ldr)
    if dither_seed is not None:
        noise = jax.random.uniform(dither_seed, srgb.shape, minval=-0.5 / 255,
                                   maxval=0.5 / 255)
        srgb = jnp.clip(srgb + noise, 0.0, 1.0)
    return srgb


def to_uint8(srgb: Array) -> Array:
    return (jnp.clip(srgb, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
