"""Horizon-based ambient occlusion from depth + normals.

Rebuild of HbaoRenderSystem (include/garden/system/render/hbao.hpp:39,
source/system/render/hbao.cpp + shaders/hbao.frag): screen-space AO written
into the PBR lighting AO buffer, here returned as an (H, W) factor.

This IS horizon-based line sampling (Bavoil/Sainz HBAO), not a per-tap
heuristic: for each of N screen-space directions the kernel marches
outward and keeps the MAXIMUM elevation angle of any sample above the
surface's tangent plane — the horizon. Occlusion per direction is
sin(horizon) - sin(bias), weighted by the world-space falloff at the
horizon sample, and the per-direction MAX (instead of a per-tap sum) is
what makes it horizon-based: five samples of the same ridge occlude
exactly as much as one, and only the highest silhouette in each direction
counts.

Formulation: per-pixel jittered taps are dynamic gathers, which lower to
the slow generic-gather path. Instead each (direction, step) tap uses a
FIXED pixel offset — one edge-padded shift of the position buffer, a pure
dense elementwise op — so the whole pass is
N_DIRS x N_STEPS shifted fused ops, zero gathers. The world-space falloff
keeps far-apart samples from occluding, which is what the reference's
depth-scaled screen radius bought.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from garden_tpu.core import math3d as m3
from garden_tpu.ops.shifts import Shifter

Array = jnp.ndarray

N_DIRS = 8
STEP_RADII = (2, 4, 7, 11, 16)  # fixed pixel radii marched per direction
ANGLE_BIAS = 0.1                # sin of the tangent bias (hbao.frag bias)


_MAX_RADIUS = 16  # largest STEP_RADII entry: the one-time pad size


def compute_hbao(
    position: Array,     # (H, W, 3) world positions
    normal: Array,       # (H, W, 3)
    visible: Array,      # (H, W)
    camera_pos: Array,
    radius: float = 1.0,
    intensity: float = 1.0,
    base_pixel_step: float = 8.0,  # kept for API compat; steps are fixed
    half_res: bool = False,
) -> Array:
    """AO factor (H, W), 1 = unoccluded.

    half_res: march at half resolution and joint-bilaterally upsample by
    view depth (AO is low-frequency; half-res does a quarter of the 8x5
    tap work with the same horizons — the reference's HBAO likewise
    renders sub-res into the AO buffer,
    pbr-lighting.cpp blur-chain consumers)."""
    if half_res:
        from garden_tpu.ops.blur import bilateral_upsample_to, decimate2x
        h, w = visible.shape
        depth_full = m3.length(position - camera_pos)
        pos_lo = decimate2x(position)
        ao_lo = compute_hbao(pos_lo, decimate2x(normal),
                             decimate2x(visible.astype(jnp.float32)) > 0.5,
                             camera_pos, radius=radius, intensity=intensity)
        depth_lo = m3.length(pos_lo - camera_pos)
        ao = bilateral_upsample_to(ao_lo[..., None], depth_lo, depth_full,
                                   h, w)[..., 0]
        return jnp.where(visible, jnp.clip(ao, 0.0, 1.0), 1.0)

    # pad once to the maximum march radius; every (direction, step) tap is
    # then a single fused slice (see ops/shifts.py — the per-tap edge-pad
    # version traced to ~1400 HLO ops for this pass alone)
    pos_at = Shifter(position, _MAX_RADIUS, _MAX_RADIUS)
    vis_at = Shifter(visible, _MAX_RADIUS, _MAX_RADIUS)
    occlusion = jnp.zeros(visible.shape, jnp.float32)
    for d in range(N_DIRS):
        ang = 2.0 * math.pi * (d + 0.5) / N_DIRS
        ux, uy = math.cos(ang), math.sin(ang)
        # horizon search along this direction: max weighted elevation
        horizon = jnp.zeros(visible.shape, jnp.float32)
        for r_px in STEP_RADII:
            dy = int(round(uy * r_px))
            dx = int(round(ux * r_px))
            sample_pos = pos_at(-dy, -dx)
            sample_vis = vis_at(-dy, -dx)
            delta = sample_pos - position
            dlen = m3.length(delta)
            # elevation above the tangent plane (sin of the sample angle)
            sin_h = m3.dot(delta, normal) / jnp.maximum(dlen, 1e-6)
            falloff = jnp.clip(1.0 - dlen / radius, 0.0, 1.0)
            cand = jnp.clip(sin_h - ANGLE_BIAS, 0.0, 1.0) * falloff
            horizon = jnp.maximum(horizon,
                                  jnp.where(sample_vis, cand, 0.0))
        occlusion = occlusion + horizon

    ao = 1.0 - jnp.clip(occlusion / N_DIRS * intensity, 0.0, 1.0)
    return jnp.where(visible, ao, 1.0)
