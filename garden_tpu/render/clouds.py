"""Volumetric clouds: raymarched noise layer.

Rebuild of CloudsRenderSystem (include/garden/system/render/clouds.hpp:46,
source/system/render/clouds.cpp:117-269 — Horizon-Zero-Dawn-style raymarch
through prebaked 3D noise). The reference bakes 3D noise textures once and
samples them per step; texture sampling is a gather here, so the noise
evaluates *procedurally* per step (ops/noise.py perlin3 is dense
elementwise math — the same trade as the atmosphere's analytic
transmittance).

A flat cloud slab [base, top] is marched with a fixed step count; density =
remapped fBm with a coverage threshold; lighting = Beer-Lambert toward the
sun with an ambient floor; composited over the sky by alpha.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from garden_tpu.core import math3d as m3
from garden_tpu.ops import noise

Array = jnp.ndarray


def _density(p: Array, time: Array, coverage: float, seed: int = 0) -> Array:
    """Cloud density at world positions (..., 3), wind-scrolled.

    Perlin-Worley base eroded by Worley detail — the same two-texture recipe
    the reference prebakes (clouds.cpp:117-269), evaluated procedurally per
    step (dense elementwise math instead of 3D texture gathers)."""
    x = p[..., 0] * 0.004 + time * 0.01
    y = p[..., 1] * 0.01
    z = p[..., 2] * 0.004
    base = noise.perlin_worley3(x, z, y, seed=seed)
    base = 0.7 * base + 0.3 * noise.perlin_worley3(
        x * 2.0, z * 2.0, y * 2.0, seed=seed + 3)
    shaped = jnp.clip((base - (1.0 - coverage * 1.6)) / 0.4, 0.0, 1.0)
    # detail erosion: high-frequency worley carves the edges
    detail = 1.0 - noise.worley3(x * 6.0, z * 6.0, y * 6.0, seed=seed + 5)
    return jnp.clip(shaped - (1.0 - shaped) * detail * 0.3, 0.0, 1.0)


def render_clouds(
    view_dir: Array,        # (..., 3)
    sun_dir_to_light: Array,
    camera_height: float = 0.2,
    time: Array = 0.0,
    base_km: float = 1.2,
    top_km: float = 2.4,
    coverage: float = 0.45,
    steps: int = 10,
    seed: int = 0,
) -> Tuple[Array, Array]:
    """Returns (cloud rgb (..., 3), alpha (...,)) for sky-ray directions."""
    v = m3.normalize(view_dir)
    l = m3.normalize(sun_dir_to_light)
    time = jnp.asarray(time, jnp.float32)

    mu = v[..., 1]
    up = mu > 0.02  # only above the horizon
    mu_safe = jnp.where(up, jnp.maximum(mu, 0.02), 1.0)
    t0 = (base_km - camera_height) / mu_safe
    t1 = (top_km - camera_height) / mu_safe
    seg = jnp.maximum(t1 - t0, 0.0)
    dt = seg / steps

    # phase: silver lining toward the sun
    cos_sun = m3.dot(v, l)
    phase = 0.6 + 0.4 * jnp.clip(cos_sun, 0.0, 1.0) ** 8 * 4.0

    sun_light = jnp.clip(l[1], 0.0, 1.0)
    bright = (0.9 + 0.4 * phase)[..., None] * jnp.asarray([1.0, 0.98, 0.95]) \
        * sun_light
    dark = jnp.asarray([0.25, 0.28, 0.34]) * (0.3 + 0.7 * sun_light)

    trans = jnp.ones_like(mu)
    light_acc = jnp.zeros_like(mu)
    for i in range(steps):
        t = t0 + (i + 0.5) * dt
        p = v * t[..., None] * 1000.0  # km -> world units for noise scale
        h01 = ((camera_height + t * mu) - base_km) / (top_km - base_km)
        height_falloff = jnp.clip(4.0 * h01 * (1.0 - h01), 0.0, 1.0)
        dens = _density(p, time, coverage, seed) * height_falloff
        dens = jnp.where(up, dens, 0.0)
        # Beer-Lambert toward the sun, two taps along the light ray
        occ = (_density(p + l * 200.0, time, coverage, seed) * 0.5
               + _density(p + l * 600.0, time, coverage, seed) * 0.3)
        shade = jnp.exp(-occ * 2.0)
        # powder term: dark cores brighten toward edges (HZD's sugar-powder
        # look, the in-scatter approximation of clouds.cpp lighting)
        powder = 1.0 - jnp.exp(-dens * 4.0)
        absorb = dens * dt * 3.0
        contrib = trans * (1.0 - jnp.exp(-absorb))
        light_acc = light_acc + contrib * shade * (0.4 + 0.6 * powder)
        trans = trans * jnp.exp(-absorb)

    alpha = jnp.where(up, 1.0 - trans, 0.0)
    lit = light_acc[..., None] * bright + alpha[..., None] * 0.25 * dark
    safe_a = jnp.maximum(alpha, 1e-5)[..., None]
    rgb = lit / safe_a
    # distance fade at the horizon
    fade = jnp.clip((mu - 0.02) / 0.08, 0.0, 1.0)
    alpha = alpha * fade
    return rgb, alpha


def composite_clouds(sky: Array, rgb: Array, alpha: Array) -> Array:
    return sky * (1.0 - alpha[..., None]) + rgb * alpha[..., None]


def cloud_shadow(
    positions: Array,        # (..., 3) world-space ground points
    sun_dir_to_light: Array,
    time: Array = 0.0,
    base_km: float = 1.2,
    coverage: float = 0.45,
    seed: int = 0,
) -> Array:
    """Sun transmittance through the cloud layer at ground points (...,) —
    the CloudsRenderSystem shadow pass (clouds.cpp shadow map) as a direct
    per-pixel evaluation: project each point along the sun ray to the cloud
    base and attenuate by the density there."""
    l = m3.normalize(sun_dir_to_light)
    mu = jnp.maximum(l[1], 0.05)
    # distance along the sun ray to the cloud base (km -> world units)
    t = (base_km * 1000.0 - positions[..., 1]) / mu
    p = positions + l * t[..., None]
    dens = _density(p, jnp.asarray(time, jnp.float32), coverage, seed)
    dens = 0.7 * dens + 0.3 * _density(p + l * 400.0,
                                       jnp.asarray(time, jnp.float32),
                                       coverage, seed)
    return jnp.exp(-dens * 2.5)
