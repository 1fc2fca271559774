"""SMAA 1x: subpixel morphological antialiasing.

Rebuild of SmaaRenderSystem (reference: include/garden/system/render/
smaa.hpp:37 + shaders/smaa/*, the Jimenez et al. 3-pass pipeline):
1. luma edge detection with local-contrast adaptation,
2. blend-weight calculation from edge run lengths,
3. neighborhood blending.

Data-parallel redesign notes:
- The reference samples precomputed AreaTex/SearchTex textures. Those
  textures are themselves just tabulated analytic coverage of a
  revectorized edge line — here the coverage integral is evaluated
  directly in-code from the run lengths (no textures, no gathers).
- Edge searches are fixed-radius (SEARCH_STEPS) cumulative products of
  shifted edge masks — dense elementwise work, no data-dependent loops.
- Diagonal patterns (the reference's diag search + diag AreaTex section,
  shaders/smaa/*): handled analytically for the four corner orientations —
  a corner pixel whose same-oriented corner repeats at a diagonal
  neighbor lies on a revectorized 45-degree line, whose exact coverage
  is 1/2 split across the two outside neighbors. Diag-handled pixels
  skip the orthogonal patterns (the reference's diag-first priority).
  Non-45-degree diagonal patterns (the distance-graded diag AreaTex
  entries) fall through to the orthogonal handling.

All shifts are pad+slice (dense); the whole pipeline is ~30 elementwise
ops per pixel and fuses into a handful of XLA kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from garden_tpu.ops.shifts import Shifter

Array = jnp.ndarray

EDGE_THRESHOLD = 0.1
LOCAL_CONTRAST_FACTOR = 2.0
SEARCH_STEPS = 8


def _luma(img: Array) -> Array:
    return (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
            + 0.0722 * img[..., 2])


def detect_edges(img: Array) -> Array:
    """(H, W, 2) booleans: [left edge, top edge] per pixel, with SMAA's
    local-contrast adaptation (an edge is suppressed when a neighboring
    contrast is more than 2x stronger)."""
    l = _luma(img)
    l_at = Shifter(l, 2, 2)  # pad once; each tap is one fused slice
    d_left = jnp.abs(l - l_at(0, -1))
    d_top = jnp.abs(l - l_at(-1, 0))
    left = d_left >= EDGE_THRESHOLD
    top = d_top >= EDGE_THRESHOLD

    d_right = jnp.abs(l - l_at(0, 1))
    d_bottom = jnp.abs(l - l_at(1, 0))
    d_leftleft = jnp.abs(l_at(0, -1) - l_at(0, -2))
    d_toptop = jnp.abs(l_at(-1, 0) - l_at(-2, 0))
    max_l = jnp.maximum(jnp.maximum(d_right, d_bottom),
                        jnp.maximum(d_top, d_leftleft))
    max_t = jnp.maximum(jnp.maximum(d_right, d_bottom),
                        jnp.maximum(d_left, d_toptop))
    left &= d_left >= max_l / LOCAL_CONTRAST_FACTOR
    top &= d_top >= max_t / LOCAL_CONTRAST_FACTOR
    return jnp.stack([left, top], axis=-1)


def _runs(edge_at: Shifter, dy: int, dx: int) -> Array:
    """Length of the contiguous edge run in direction (dy, dx), up to
    SEARCH_STEPS, NOT counting the center pixel. Dense cumulative product
    of shifted masks."""
    run = jnp.zeros((edge_at.h, edge_at.w), jnp.float32)
    alive = jnp.ones((edge_at.h, edge_at.w), bool)
    for s in range(1, SEARCH_STEPS + 1):
        alive = alive & edge_at(dy * s, dx * s)
        run = run + alive.astype(jnp.float32)
    return run


def _area(d1: Array, d2: Array, c1: Array, c2: Array) -> Array:
    """Analytic SMAA coverage: the revectorized edge is a line from
    (-d1 - 0.5, c1 * 0.5) to (d2 + 0.5, c2 * 0.5) in (along-edge,
    across-edge) coordinates; returns the SIGNED mean across-edge offset
    over the center pixel — |value| is the blend weight toward the
    crossing side, sign picks the side. This is the function AreaTex
    tabulates for orthogonal patterns."""
    span = d1 + d2 + 1.0
    # line height at the center pixel's midpoint (distance d1 + 0.5 from
    # the left end, minus the half-pixel origin shift)
    t = (d1 + 0.5) / jnp.maximum(span, 1e-6)
    h = c1 * 0.5 + (c2 * 0.5 - c1 * 0.5) * t
    # pixels with no crossing at either end (straight edge): no blending
    return jnp.where((c1 == 0.0) & (c2 == 0.0), 0.0, h)


def blending_weights(edges: Array) -> Array:
    """(H, W, 4) blend weights [up, down, left, right] per pixel."""
    left_e = edges[..., 0]   # vertical edge on the pixel's left border
    top_e = edges[..., 1]    # horizontal edge on the pixel's top border
    r = SEARCH_STEPS + 1
    le_at = Shifter(left_e, r, r)
    te_at = Shifter(top_e, r, r)

    # ---- horizontal (top) edges: search left/right along the edge ------
    d1 = _runs(te_at, 0, -1)
    d2 = _runs(te_at, 0, 1)
    # crossing edges at the run ends: a LEFT edge (vertical) at the end
    # pixel or the one above marks which way the surface continues
    c1 = jnp.zeros_like(d1)
    c2 = jnp.zeros_like(d2)
    for s in range(SEARCH_STEPS + 1):
        at_end1 = d1 == s
        at_end2 = d2 == s
        # crossing above (+0.5) or below (-0.5) at each end
        cross1_up = le_at(-1, -s)
        cross1_dn = le_at(0, -s)
        cross2_up = le_at(-1, s + 1)
        cross2_dn = le_at(0, s + 1)
        c1 = jnp.where(at_end1 & cross1_up, 1.0,
                       jnp.where(at_end1 & cross1_dn, -1.0, c1))
        c2 = jnp.where(at_end2 & cross2_up, 1.0,
                       jnp.where(at_end2 & cross2_dn, -1.0, c2))
    h = _area(d1, d2, c1, c2)
    w_up = jnp.where(top_e, jnp.maximum(h, 0.0), 0.0)
    w_dn = jnp.where(top_e, jnp.maximum(-h, 0.0), 0.0)

    # ---- vertical (left) edges: search up/down -------------------------
    d1v = _runs(le_at, -1, 0)
    d2v = _runs(le_at, 1, 0)
    c1v = jnp.zeros_like(d1v)
    c2v = jnp.zeros_like(d2v)
    for s in range(SEARCH_STEPS + 1):
        at_end1 = d1v == s
        at_end2 = d2v == s
        cross1_l = te_at(-s, -1)
        cross1_r = te_at(-s, 0)
        cross2_l = te_at(s + 1, -1)
        cross2_r = te_at(s + 1, 0)
        c1v = jnp.where(at_end1 & cross1_l, 1.0,
                        jnp.where(at_end1 & cross1_r, -1.0, c1v))
        c2v = jnp.where(at_end2 & cross2_l, 1.0,
                        jnp.where(at_end2 & cross2_r, -1.0, c2v))
    v = _area(d1v, d2v, c1v, c2v)
    w_left = jnp.where(left_e, jnp.maximum(v, 0.0), 0.0)
    w_right = jnp.where(left_e, jnp.maximum(-v, 0.0), 0.0)

    return jnp.stack([w_up, w_dn, w_left, w_right], axis=-1)


def _diag_patterns(edges: Array):
    """Diagonal patterns (smaa.hpp:37 diag search / diag AreaTex analog).

    A CORNER pixel (two perpendicular border edges) whose same-oriented
    corner repeats at a diagonal neighbor sits on a 45-degree staircase.
    The revectorized line x = y + 1/2 covers the boundary pixel by exactly
    7/8 on the inside and 1/8 on the outside (the integral the diag
    AreaTex tabulates for the 45-degree entries), so each handled pixel
    blends 1/8 toward the mean of its two outside neighbors. Returns
    (handled (H, W) bool, n1 (dy, dx) map, n2 map) as stacked per-corner
    data: handled mask + per-pixel outside-neighbor offsets encoded as 4
    one-hot corner masks for apply_smaa's direct blend."""
    left_e = edges[..., 0]
    top_e = edges[..., 1]
    le_at = Shifter(left_e, 1, 1)
    te_at = Shifter(top_e, 1, 1)
    right_e = le_at(0, 1)     # right border edge = next pixel's left edge
    bot_e = te_at(1, 0)       # bottom border edge = next row's top edge
    out = []
    for corner, offs in (
            (left_e & top_e, ((-1, 0), (0, -1))),    # outside up-left
            (right_e & top_e, ((-1, 0), (0, 1))),    # outside up-right
            (left_e & bot_e, ((1, 0), (0, -1))),     # outside down-left
            (right_e & bot_e, ((1, 0), (0, 1)))):    # outside down-right
        c_at = Shifter(corner, 1, 1)
        on_diag = corner & (c_at(1, 1) | c_at(-1, -1)
                            | c_at(1, -1) | c_at(-1, 1))
        out.append((on_diag, offs))
    return out


def neighborhood_blend(img: Array, weights: Array) -> Array:
    """Final pass: blend each pixel with its 4 neighbors by the computed
    coverage weights (weights of the pixel's own edges plus the opposing
    weights stored on neighboring pixels)."""
    w_at = Shifter(weights, 1, 1)
    w_up = weights[..., 0]
    w_dn = weights[..., 1]
    w_left = weights[..., 2]
    w_right = weights[..., 3]
    # opposing weights from neighbors: the pixel below's 'up' weight
    # blends THIS pixel downward, etc.
    w_from_below = w_at(1, 0)[..., 0]
    w_from_right = w_at(0, 1)[..., 2]

    total = (w_up + w_dn + w_left + w_right
             + w_from_below + w_from_right)
    i_at = Shifter(img, 1, 1)
    blend = (
        w_up[..., None] * i_at(-1, 0)
        + w_dn[..., None] * i_at(1, 0)
        + w_left[..., None] * i_at(0, -1)
        + w_right[..., None] * i_at(0, 1)
        + w_from_below[..., None] * i_at(1, 0)
        + w_from_right[..., None] * i_at(0, 1)
    )
    t = jnp.clip(total, 0.0, 1.0)[..., None]
    safe = jnp.maximum(total, 1e-6)[..., None]
    return img * (1.0 - t) + (blend / safe) * t


def apply_smaa(img: Array) -> Array:
    """Full SMAA 1x chain on an LDR (H, W, 3) image in [0, 1].

    Diagonal patterns resolve FIRST and their pixels skip the orthogonal
    weights (the reference's SMAACalculateDiagWeights early-out); the
    diag blend applies directly (1/8 toward the two outside neighbors —
    see _diag_patterns) instead of through the edge-weight flow, which
    would double-count the two sides of the diagonal."""
    edges = detect_edges(img)
    diags = _diag_patterns(edges)
    handled = jnp.zeros(img.shape[:2], bool)
    diag_out = img
    i_at = Shifter(img, 1, 1)
    for on_diag, ((dy1, dx1), (dy2, dx2)) in diags:
        # 7/8 self + 1/16 per outside neighbor (the 45-deg coverage)
        target = img * 0.875 + (i_at(dy1, dx1) + i_at(dy2, dx2)) * 0.0625
        diag_out = jnp.where(on_diag[..., None], target, diag_out)
        handled = handled | on_diag
    weights = blending_weights(edges)
    weights = jnp.where(handled[..., None], 0.0, weights)
    out = neighborhood_blend(img, weights)
    return jnp.where(handled[..., None], diag_out, out)
