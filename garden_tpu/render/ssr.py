"""Screen-space reflections: the PbrLightingSystem reflection-buffer path.

Rebuild of the reference's reflection buffer registration + SSR consumer
(include/garden/system/render/pbr-lighting.hpp:92 registers shadow/AO/
reflection/GI buffers; source/system/render/pbr-lighting.cpp:473-494 wires
their blur chains; source/system/render/hiz.cpp:104-173 notes the Hi-Z
pyramid exists for the SSR ray-march consumer).

Data-parallel design (vs the reference's per-pixel Hi-Z walk in a fragment
shader): the march runs at REDUCED resolution with the step axis
VECTORIZED — K dense (h, w) depth taps instead of a per-pixel variable-
length walk, then one argmax picks each ray's first hit. Data-dependent
per-pixel loops don't vectorize; K dense gathers do. Hit color
samples the PREVIOUS frame's HDR via reprojection (the standard temporal
flow — reflections lag one frame, which also breaks the lighting<->SSR
cycle), with IBL/sky specular as the fallback where rays miss or exit the
screen. The glossy spread comes from roughness-dependent confidence fade +
the bilateral upsample's smoothing rather than a separate blur chain.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.core.config import SSRConfig

Array = jnp.ndarray


def trace(
    g: Dict[str, Array],          # full-res G-buffer (position/normal/...)
    depth: Array,                 # (H, W) current reverse-Z depth
    prev_hdr: Array,              # (H, W, 3) previous frame's HDR radiance
    prev_view_proj: Array,        # (4, 4) previous frame camera
    constants: Dict[str, Array],
    cfg: SSRConfig,
) -> Tuple[Array, Array]:
    """-> (reflection rgb (H, W, 3), confidence (H, W) in [0, 1]).

    Confidence 0 means "use the IBL fallback"; the resolve mixes by it.
    """
    from garden_tpu.ops.blur import bilateral_upsample_to, decimate2x

    full_h, full_w = depth.shape
    step = max(int(cfg.trace_step), 1)
    pos, nrm, dep = g["position"], g["normal"], depth
    for _ in range(int(np.log2(step)) if step > 1 else 0):
        pos = decimate2x(pos)
        nrm = decimate2x(nrm)
        dep = decimate2x(dep)
    h, w = dep.shape

    cam = constants["camera_pos"]
    view_proj = constants["view_proj"]
    v = m3.normalize(cam - pos)                      # surface -> camera
    r = m3.reflect(-v, m3.normalize(nrm))            # reflection ray

    # geometric step schedule: fine near the surface, coarse far out
    ts = cfg.max_distance * (
        np.geomspace(cfg.first_step, 1.0, cfg.steps).astype(np.float32))

    # march: vectorize the step axis -> (K, h, w) sample points
    p = pos[None] + r[None] * ts[:, None, None, None]   # (K, h, w, 3)
    hp = jnp.concatenate([p, jnp.ones_like(p[..., :1])], -1)
    clip = m3.einsum("ij,khwj->khwi", view_proj, hp)
    behind_cam = clip[..., 3] < 1e-6
    ndc = clip[..., :3] / jnp.maximum(clip[..., 3:4], 1e-6)
    u = (ndc[..., 0] * 0.5 + 0.5) * w                   # low-res texels
    vv = (0.5 - ndc[..., 1] * 0.5) * h
    ray_z = ndc[..., 2]                                 # reverse-Z

    on_screen = (u >= 0) & (u < w) & (vv >= 0) & (vv < h) & ~behind_cam
    ui = jnp.clip(u.astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(vv.astype(jnp.int32), 0, h - 1)
    scene_z = dep.reshape(-1)[vi * w + ui]              # (K, h, w) K gathers

    # hit: the ray went behind the depth surface (reverse-Z: smaller z is
    # farther) but not deeper than the thickness acceptance band, and the
    # stored surface exists (z > 0)
    z_scale = jnp.maximum(scene_z, 1e-4)
    hit = (on_screen & (scene_z > 0.0)
           & (ray_z <= scene_z)
           & (ray_z >= scene_z - cfg.thickness * z_scale))

    # first hit along the ray as a dense mask reduction — NO argmax +
    # take_along_axis (lowers to a generic gather; the same
    # fix as fxaa._end_search, math3d.py one-hot notes)
    first_mask = (hit & (jnp.cumsum(hit.astype(jnp.float32), axis=0)
                         <= 1.0)).astype(jnp.float32)     # (K, h, w)
    any_hit = jnp.any(hit, axis=0)
    sel = lambda a: jnp.sum(a * first_mask, axis=0)
    hit_p = jnp.sum(p * first_mask[..., None], axis=0)
    hit_u = sel(u)
    hit_v = sel(vv)

    # reproject the hit point into the PREVIOUS frame to fetch its color
    hq = jnp.concatenate([hit_p, jnp.ones_like(hit_p[..., :1])], -1)
    pclip = m3.einsum("ij,hwj->hwi", prev_view_proj, hq)
    pndc = pclip[..., :2] / jnp.maximum(pclip[..., 3:4], 1e-6)
    pu = (pndc[..., 0] * 0.5 + 0.5) * full_w
    pv = (0.5 - pndc[..., 1] * 0.5) * full_h
    prev_ok = (pu >= 0) & (pu < full_w) & (pv >= 0) & (pv < full_h)
    pui = jnp.clip(pu.astype(jnp.int32), 0, full_w - 1)
    pvi = jnp.clip(pv.astype(jnp.int32), 0, full_h - 1)
    color = prev_hdr.reshape(-1, 3)[pvi * full_w + pui]  # (h, w, 3)

    # confidence: hit, reprojectable, ray leaves the surface (no self-hit
    # mirror rays into the surface), fade at screen edges (partial
    # information) and with roughness (glossy falls back to prefiltered IBL)
    rough = g["roughness"]
    for _ in range(int(np.log2(step)) if step > 1 else 0):
        rough = decimate2x(rough)
    edge_x = jnp.minimum(hit_u, w - 1 - hit_u) / (0.1 * w)
    edge_y = jnp.minimum(hit_v, h - 1 - hit_v) / (0.1 * h)
    edge_fade = jnp.clip(jnp.minimum(edge_x, edge_y), 0.0, 1.0)
    rough_fade = jnp.clip(1.0 - rough / jnp.maximum(cfg.max_roughness, 1e-3),
                          0.0, 1.0)
    facing = m3.dot(r, nrm) > 1e-4
    conf = (any_hit & prev_ok & facing).astype(jnp.float32) \
        * edge_fade * rough_fade
    color = jnp.where(conf[..., None] > 0.0, color, 0.0)

    if step > 1:
        # depth-guided upsample keeps reflection silhouettes on geometry
        # edges (same machinery as the shadow resolve)
        packed = jnp.concatenate([color, conf[..., None]], -1)
        packed = bilateral_upsample_to(packed, dep, depth, full_h, full_w)
        color, conf = packed[..., :3], jnp.clip(packed[..., 3], 0.0, 1.0)
    return color, conf
