"""Screen-space global illumination: the PbrLighting GI-buffer producer.

Rebuild of the reference's GI buffer path: PbrLightingSystem registers a GI
buffer with its own blur chain and PreGI/GI/PostGI events
(include/garden/system/render/pbr-lighting.hpp:92,
source/system/render/pbr-lighting.cpp:473-494) but ships no producer — apps
plug one in. This module is the engine-native producer: one-bounce diffuse
irradiance gathered in screen space from the PREVIOUS frame's lit HDR (the
same temporal flow as render/ssr.py — bounced light lags one frame, which
breaks the lighting<->GI cycle), feeding `lighting.resolve(gi=...)`.

Data-parallel formulation (vs a fragment-shader ray march): per-pixel jittered
rays are dynamic gathers (the slow generic-gather path, see hbao.py). The
gather here is near-field and low-frequency, so every radiance tap uses a
FIXED screen offset — one edge-padded shift of the (radiance, position,
normal) planes (ops/shifts.py Shifter, pure dense elementwise work). The only
random gather is ONE reprojection fetch of the previous HDR at the march
resolution. The reference's GI blur chain becomes the depth-guided
bilateral upsample (the same machinery as the shadow/AO resolves).

Weight per tap: Lambert at the receiver x Lambert at the sender x a
world-space range falloff — the standard screen-space one-bounce estimator
(e.g. Deferred Massive-Lighting SSGI variants), normalized to the tap count.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.ops.shifts import Shifter

Array = jnp.ndarray

N_DIRS = 8
STEP_RADII = (2, 5, 10)      # fixed pixel radii per direction (march res)
_MAX_RADIUS = 10


def compute_ssgi(
    position: Array,          # (H, W, 3) world positions
    normal: Array,            # (H, W, 3)
    visible: Array,           # (H, W)
    depth: Array,             # (H, W) current reverse-Z depth (guide)
    prev_hdr: Array,          # (H, W, 3) previous frame's lit radiance
    prev_view_proj: Array,    # (4, 4)
    *,
    intensity: float = 1.0,
    world_radius: float = 4.0,
    half_res: bool = True,
) -> Array:
    """One-bounce diffuse GI irradiance (H, W, 3), 0 where nothing bounces."""
    from garden_tpu.ops.blur import bilateral_upsample_to, decimate2x

    full_h, full_w = depth.shape
    pos, nrm, dep, vis = position, normal, depth, visible
    if half_res:
        pos = decimate2x(pos)
        nrm = decimate2x(nrm)
        dep = decimate2x(dep)
        vis = decimate2x(visible.astype(jnp.float32)) > 0.5
    h, w = dep.shape

    # ONE reprojection gather: previous-frame radiance sampled at this
    # frame's surface points -> a "bounce source" plane in CURRENT screen
    # space; all taps below are dense shifts of it (unrolled per-component
    # transform — see math3d.apply_mat4 notes)
    m = prev_view_proj
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    cw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    inv_w = 1.0 / jnp.maximum(cw, 1e-6)
    pu = ((m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]) * inv_w
          * 0.5 + 0.5) * full_w
    pv = (0.5 - (m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]) * inv_w
          * 0.5) * full_h
    prev_ok = (cw > 1e-6) & (pu >= 0) & (pu < full_w) \
        & (pv >= 0) & (pv < full_h)
    pui = jnp.clip(pu.astype(jnp.int32), 0, full_w - 1)
    pvi = jnp.clip(pv.astype(jnp.int32), 0, full_h - 1)
    radiance = prev_hdr.reshape(-1, 3)[pvi * full_w + pui]   # (h, w, 3)
    radiance = jnp.where((prev_ok & vis)[..., None],
                         radiance.astype(jnp.float32), 0.0)

    rad_at = Shifter(radiance, _MAX_RADIUS, _MAX_RADIUS)
    pos_at = Shifter(pos, _MAX_RADIUS, _MAX_RADIUS)
    nrm_at = Shifter(nrm, _MAX_RADIUS, _MAX_RADIUS)
    vis_at = Shifter(vis.astype(jnp.float32), _MAX_RADIUS, _MAX_RADIUS)

    gi = jnp.zeros_like(radiance)
    n_taps = 0
    for d in range(N_DIRS):
        ang = 2.0 * math.pi * (d + 0.5) / N_DIRS
        ux, uy = math.cos(ang), math.sin(ang)
        for r in STEP_RADII:
            dy, dx = int(round(uy * r)), int(round(ux * r))
            if dy == 0 and dx == 0:
                continue
            p_t = pos_at(dy, dx)
            to_s = p_t - pos                       # receiver -> sender
            dist = jnp.sqrt(jnp.maximum(m3.dot(to_s, to_s), 1e-8))
            dir_s = to_s / dist[..., None]
            cos_r = jnp.maximum(m3.dot(nrm, dir_s), 0.0)
            cos_s = jnp.maximum(m3.dot(nrm_at(dy, dx), -dir_s), 0.0)
            fall = jnp.clip(1.0 - dist / world_radius, 0.0, 1.0)
            wgt = cos_r * cos_s * fall * vis_at(dy, dx)
            gi = gi + rad_at(dy, dx) * wgt[..., None]
            n_taps += 1

    # hemisphere normalization: each tap stands for an equal solid-angle
    # share of the 2*pi hemisphere band the fixed radii cover
    gi = gi * (intensity * 2.0 * math.pi / max(n_taps, 1))
    gi = jnp.where(vis[..., None], gi, 0.0)

    if half_res:
        # the GI buffer's blur chain (pbr-lighting.cpp:473-494) -> one
        # depth-guided upsample (GI is low-frequency; edges stay crisp)
        gi = bilateral_upsample_to(gi, dep, depth, full_h, full_w)
    return gi
