"""FXAA 3.11 post-process anti-aliasing.

Rebuild of FxaaRenderSystem (include/garden/system/render/fxaa.hpp:37,
shaders/fxaa.frag — FXAA 3.11 quality variant): luminance edge detection,
edge-ORIENTED end-search along the edge direction, sub-pixel offset from
the relative end distances, plus the separate sub-pixel aliasing lowpass.

Data-parallel mapping of the per-pixel marching loop: the reference shader
walks a data-dependent number of taps per fragment. Data-dependent walks
don't vectorize, so the march is a FIXED schedule of K distances sampled
densely for every pixel as shifted-image reads (pure elementwise
adds/selects), and each ray's end is picked with a first-true argmax
over the step axis — the same dense-march pattern as render/ssr.py. Both
edge orientations (horizontal/vertical) are evaluated dense and selected
per pixel, which costs 2x the shifts but keeps zero gathers.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from garden_tpu.ops.shifts import Shifter

Array = jnp.ndarray

EDGE_THRESHOLD = 1.0 / 8.0        # fxaa.frag qualityEdgeThreshold
EDGE_THRESHOLD_MIN = 1.0 / 24.0   # ... qualityEdgeThresholdMin
SUBPIX_QUALITY = 0.75             # ... qualitySubpix
# fixed march schedule (distances in pixels from the origin): the 3.11
# quality-12 preset's growing step pattern, truncated to 9 taps
_STEPS = np.array([1, 2, 3, 4, 5, 7, 9, 12, 16], dtype=np.int32)


def _luma(rgb: Array) -> Array:
    # fxaa.frag uses a green-weighted luma; keep Rec.601 for test parity
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def _end_search(edge_luma_pos: Array, edge_luma_neg: Array, is_neg: Array,
                local_avg: Array, grad_scaled: Array, axis: int):
    """March both ways along the edge; -> (dist-, dist+, end luma-, end+).

    edge_luma_pos/neg: (H, W) luma averaged across the edge toward the
    positive/negative perpendicular side; is_neg selects which applies to
    each origin pixel. axis=1 marches along x (horizontal edge), axis=0
    along y.
    """
    # pad each searched image once along the march axis; every tap is one
    # fused slice (ops/shifts.py)
    reach = int(_STEPS[-1])
    ry, rx = (0, reach) if axis == 1 else (reach, 0)
    pos_at = Shifter(edge_luma_pos, ry, rx)
    neg_at = Shifter(edge_luma_neg, ry, rx)
    dists, lumas = [], []
    for sign in (-1, 1):
        # first hit as a SEQUENTIAL carry over the unrolled schedule: each
        # step is (H, W) elementwise selects XLA fuses into one pass. The
        # previous formulation stacked all K taps into (K, H, W) buffers
        # and reduced with a cumsum-masked sum — materializing four 75 MB
        # stacks per frame. (An argmax+take_along_axis draft was worse
        # still — the math3d.py one-hot notes.)
        found = jnp.zeros(local_avg.shape, bool)
        # unfound rays clamp to the schedule's reach (shader behavior:
        # distance saturates at the last tap)
        dist = jnp.full(local_avg.shape, float(reach), local_avg.dtype)
        end_luma = jnp.zeros(local_avg.shape, local_avg.dtype)
        for d in _STEPS:
            dy, dx = (0, sign * int(d)) if axis == 1 else (sign * int(d), 0)
            tap = jnp.where(is_neg, neg_at(-dy, -dx), pos_at(-dy, -dx))
            delta = tap - local_avg
            hit = jnp.abs(delta) >= grad_scaled
            new = hit & ~found
            dist = jnp.where(new, float(d), dist)
            end_luma = jnp.where(new, delta, end_luma)
            found = found | hit
        dists.append(dist)
        lumas.append(end_luma)
    return dists[0], dists[1], lumas[0], lumas[1]


def apply_fxaa(ldr: Array) -> Array:
    """ldr: (H, W, 3) float in [0,1] -> antialiased (H, W, 3)."""
    luma = _luma(ldr)
    lum_at = Shifter(luma, 1, 1)
    l_n = lum_at(1, 0)
    l_s = lum_at(-1, 0)
    l_w = lum_at(0, 1)
    l_e = lum_at(0, -1)
    l_nw = lum_at(1, 1)
    l_ne = lum_at(1, -1)
    l_sw = lum_at(-1, 1)
    l_se = lum_at(-1, -1)

    l_min = jnp.minimum(luma, jnp.minimum(jnp.minimum(l_n, l_s),
                                          jnp.minimum(l_w, l_e)))
    l_max = jnp.maximum(luma, jnp.maximum(jnp.maximum(l_n, l_s),
                                          jnp.maximum(l_w, l_e)))
    rng = l_max - l_min
    edge = rng >= jnp.maximum(EDGE_THRESHOLD_MIN, l_max * EDGE_THRESHOLD)

    # edge orientation from second-derivative luma contrast (fxaa.frag
    # edgeHorz/edgeVert 3x3 stencils): a HORIZONTAL edge produces strong
    # luma curvature VERTICALLY (per-column |up + down - 2 center|), and
    # vice versa
    edge_h = (jnp.abs(l_nw + l_sw - 2.0 * l_w)
              + 2.0 * jnp.abs(l_n + l_s - 2.0 * luma)
              + jnp.abs(l_ne + l_se - 2.0 * l_e))
    edge_v = (jnp.abs(l_nw + l_ne - 2.0 * l_n)
              + 2.0 * jnp.abs(l_w + l_e - 2.0 * luma)
              + jnp.abs(l_sw + l_se - 2.0 * l_s))
    horiz = edge_h >= edge_v          # edge runs horizontally -> blend in y

    # pick the perpendicular side with the steeper gradient
    l_perp_neg = jnp.where(horiz, l_n, l_w)     # -1 in the perp axis
    l_perp_pos = jnp.where(horiz, l_s, l_e)
    grad_neg = jnp.abs(l_perp_neg - luma)
    grad_pos = jnp.abs(l_perp_pos - luma)
    is_neg = grad_neg >= grad_pos
    grad_scaled = 0.25 * jnp.maximum(grad_neg, grad_pos)
    l_nb = jnp.where(is_neg, l_perp_neg, l_perp_pos)
    local_avg = 0.5 * (luma + l_nb)

    # luma on the half-pixel edge row/column, one image per (orientation,
    # side): avg of the two pixels straddling the edge
    eh_neg = 0.5 * (luma + l_n)       # horizontal edge, upper side
    eh_pos = 0.5 * (luma + l_s)
    ev_neg = 0.5 * (luma + l_w)       # vertical edge, left side
    ev_pos = 0.5 * (luma + l_e)

    dh_n, dh_p, eh_end_n, eh_end_p = _end_search(
        eh_pos, eh_neg, is_neg, local_avg, grad_scaled, axis=1)
    dv_n, dv_p, ev_end_n, ev_end_p = _end_search(
        ev_pos, ev_neg, is_neg, local_avg, grad_scaled, axis=0)
    dist_n = jnp.where(horiz, dh_n, dv_n)
    dist_p = jnp.where(horiz, dh_p, dv_p)
    end_n = jnp.where(horiz, eh_end_n, ev_end_n)
    end_p = jnp.where(horiz, eh_end_p, ev_end_p)

    # sub-pixel offset from the nearer end (fxaa.frag pixelOffset):
    # 0 at the edge's end, 0.5 at its middle
    edge_len = dist_n + dist_p
    nearer_neg = dist_n < dist_p
    dist_near = jnp.minimum(dist_n, dist_p)
    offset = 0.5 - dist_near / jnp.maximum(edge_len, 1e-6)
    # variation check: only blend when the nearer end's luma steps the
    # same way as the center relative to the edge average (otherwise the
    # pixel is past the silhouette's corner)
    center_below = luma < local_avg
    end_near = jnp.where(nearer_neg, end_n, end_p)
    good = (end_near < 0.0) != center_below
    offset = jnp.where(good, offset, 0.0)

    # independent sub-pixel aliasing filter (fxaa.frag subPixelOffset):
    # 3x3 lowpass luma contrast, squared smoothstep, scaled by quality
    l_avg = (2.0 * (l_n + l_s + l_w + l_e)
             + (l_nw + l_ne + l_sw + l_se)) / 12.0
    sub = jnp.clip(jnp.abs(l_avg - luma) / jnp.maximum(rng, 1e-6), 0.0, 1.0)
    sub = (-2.0 * sub + 3.0) * sub * sub
    sub_offset = sub * sub * SUBPIX_QUALITY
    offset = jnp.maximum(offset, sub_offset)

    # final: resample a half-pixel toward the chosen perpendicular side,
    # weighted by the offset == lerp with the straddled neighbor
    ldr_at = Shifter(ldr, 1, 1)
    nb_rgb_h = jnp.where(is_neg[..., None], ldr_at(1, 0), ldr_at(-1, 0))
    nb_rgb_v = jnp.where(is_neg[..., None], ldr_at(0, 1), ldr_at(0, -1))
    nb_rgb = jnp.where(horiz[..., None], nb_rgb_h, nb_rgb_v)
    o = offset[..., None]
    out = ldr * (1.0 - o) + nb_rgb * o
    return jnp.where(edge[..., None], out, ldr)
