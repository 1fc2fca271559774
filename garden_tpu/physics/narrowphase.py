"""Narrowphase: batched analytic contact generation.

Rebuild of Jolt's narrowphase contact generation as stepped by the reference
(source/system/physics.cpp:1186-1193; speculative contact margin and convex
radius conventions from include/garden/system/physics.hpp:874-881). Instead
of per-pair virtual dispatch, every supported shape-pair kernel runs
vectorized over the whole candidate pair list and `jnp.select` picks the
right result per pair — branch-free, dense elementwise work.

Supported pairs: sphere/box/capsule/plane cross products (box-box runs the
full 15-axis SAT including the 9 edge-edge cross axes), hull pairs
(vertex-face SAT over face normals of both hulls), heightfield pairs
(candidate-point surface sampling), triangle-mesh pairs (bucketed
closest-point-on-triangle), and compound pairs (per-child dispatch,
including hull-vs-compound).

Manifold layout per pair (fixed MAX_POINTS=4, masked):
- `point`  f32[..., 4, 3]: world contact position
- `normal` f32[..., 4, 3]: unit normal pointing from body A to body B
- `pen`    f32[..., 4]: penetration depth (>0 overlapping; values in
  (-margin, 0] are speculative contacts)
- `valid`  bool[..., 4]

Convention: impulses P = lambda*n are applied v_a -= invm_a*P,
v_b += invm_b*P; pairs approach when dot(v_b - v_a, n) < 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.physics import shapes as sh

Array = jnp.ndarray
MAX_POINTS = 4

# numpy, not jnp: module import must not initialize the device backend
_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)],
    dtype=np.float32,
)  # (8, 3)


def _empty_manifold(shape) -> Dict[str, Array]:
    return {
        "point": jnp.zeros(shape + (MAX_POINTS, 3), jnp.float32),
        "normal": jnp.zeros(shape + (MAX_POINTS, 3), jnp.float32),
        # finite sentinel: -inf would produce NaN through the one-hot
        # contractions used for compaction (0 * -inf)
        "pen": jnp.full(shape + (MAX_POINTS,), -1e30, jnp.float32),
        "valid": jnp.zeros(shape + (MAX_POINTS,), bool),
    }


def _one_point(shape, point, normal, pen, valid) -> Dict[str, Array]:
    m = _empty_manifold(shape)
    m["point"] = m["point"].at[..., 0, :].set(point)
    m["normal"] = m["normal"].at[..., 0, :].set(normal)
    m["pen"] = m["pen"].at[..., 0].set(pen)
    m["valid"] = m["valid"].at[..., 0].set(valid)
    return m


def _plane_world(pos_b: Array, quat_b: Array, params_b: Array) -> Tuple[Array, Array]:
    """Plane local (n, d) -> world (n_w, d_w) with n_w.x + d_w = 0 on plane."""
    n_w = m3.quat_rotate(quat_b, params_b[..., :3])
    d_w = params_b[..., 3] - m3.dot(n_w, pos_b)
    return n_w, d_w


# -- sphere kernels ---------------------------------------------------------


def sphere_sphere(pa, ra, pb, rb, margin):
    d = pb - pa
    dist = m3.length(d)
    safe = jnp.maximum(dist, 1e-9)
    n = d / safe[..., None]
    n = jnp.where(dist[..., None] < 1e-9,
                  jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), n.shape), n)
    pen = ra + rb - dist
    # clamp the lever arm for deep penetrations (contact point stays on the
    # body surface even if centers overlap)
    point = pa + n * (ra - 0.5 * jnp.clip(pen, 0.0, ra))[..., None]
    return _one_point(pa.shape[:-1], point, n, pen, pen > -margin)


def sphere_plane(pa, ra, n_w, d_w, margin):
    s = m3.dot(n_w, pa) + d_w
    pen = ra - s
    point = pa - n_w * (ra - 0.5 * jnp.clip(pen, 0.0, ra))[..., None]
    # normal A(sphere) -> B(plane) is down into the plane
    return _one_point(pa.shape[:-1], point, -n_w, pen, pen > -margin)


def sphere_box(pa, ra, pb, qb, half_b, margin):
    """Sphere A vs oriented box B."""
    rb = m3.quat_to_mat3(qb)
    c_l = m3.einsum("...ji,...j->...i", rb, pa - pb)  # R^T (pa - pb)
    clamped = jnp.clip(c_l, -half_b, half_b)
    delta = c_l - clamped
    dist = m3.length(delta)
    outside = dist > 1e-9

    # outside: normal from box surface toward sphere center
    n_out_l = delta / jnp.maximum(dist, 1e-9)[..., None]

    # inside: push out along the axis of least depth
    depth_axis = half_b - jnp.abs(c_l)  # (.., 3)
    axis = jnp.argmin(depth_axis, axis=-1)
    sign = jnp.sign(m3.select_scalar(c_l, axis))
    sign = jnp.where(sign == 0.0, 1.0, sign)
    n_in_l = m3.onehot(axis, 3) * sign[..., None]
    inside_dist = -jnp.min(depth_axis, axis=-1)  # negative depth into box

    n_l = jnp.where(outside[..., None], n_out_l, n_in_l)
    surf_dist = jnp.where(outside, dist, inside_dist)
    pen = ra - surf_dist
    n_w = m3.einsum("...ij,...j->...i", rb, n_l)  # box B -> sphere A
    closest_w = m3.einsum("...ij,...j->...i", rb, clamped) + pb
    point = closest_w - n_w * (0.5 * pen)[..., None]
    # normal A(sphere) -> B(box) = -n_w
    return _one_point(pa.shape[:-1], point, -n_w, pen, pen > -margin)


# -- capsule helpers ---------------------------------------------------------


def _capsule_segment(p, q, half_height):
    """Capsule world segment endpoints (local Y axis)."""
    axis = m3.quat_rotate(q, jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), p.shape))
    return p - axis * half_height[..., None], p + axis * half_height[..., None]


def _closest_on_segment(a0, a1, p):
    d = a1 - a0
    t = m3.dot(p - a0, d) / jnp.maximum(m3.dot(d, d), 1e-12)
    return a0 + d * jnp.clip(t, 0.0, 1.0)[..., None]


def _closest_segment_segment(p1, q1, p2, q2):
    """Closest points between segments (Ericson, Real-Time Collision
    Detection 5.1.9), vectorized."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = m3.dot(d1, d1)
    e = m3.dot(d2, d2)
    f = m3.dot(d2, r)
    c = m3.dot(d1, r)
    b = m3.dot(d1, d2)
    denom = a * e - b * b
    s = jnp.where(denom > 1e-12, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-12), 0.0, 1.0), 0.0)
    t = (b * s + f) / jnp.maximum(e, 1e-12)
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.clip((b * t_cl - c) / jnp.maximum(a, 1e-12), 0.0, 1.0)
    return p1 + d1 * s[..., None], p2 + d2 * t_cl[..., None]


def capsule_plane(pa, qa, ra, hha, n_w, d_w, margin):
    """Two sphere contacts at the capsule segment ends."""
    e0, e1 = _capsule_segment(pa, qa, hha)
    m = _empty_manifold(pa.shape[:-1])
    for i, e in enumerate((e0, e1)):
        s = m3.dot(n_w, e) + d_w
        pen = ra - s
        point = e - n_w * (ra - 0.5 * pen)[..., None]
        m["point"] = m["point"].at[..., i, :].set(point)
        m["normal"] = m["normal"].at[..., i, :].set(-n_w)
        m["pen"] = m["pen"].at[..., i].set(pen)
        m["valid"] = m["valid"].at[..., i].set(pen > -margin)
    return m


def capsule_capsule(pa, qa, ra, hha, pb, qb, rb, hhb, margin):
    a0, a1 = _capsule_segment(pa, qa, hha)
    b0, b1 = _capsule_segment(pb, qb, hhb)
    ca, cb = _closest_segment_segment(a0, a1, b0, b1)
    return sphere_sphere(ca, ra, cb, rb, margin)


def capsule_sphere(pa, qa, ra, hha, pb, rb, margin):
    a0, a1 = _capsule_segment(pa, qa, hha)
    ca = _closest_on_segment(a0, a1, pb)
    return sphere_sphere(ca, ra, pb, rb, margin)


def capsule_box(pa, qa, ra, hha, pb, qb, half_b, margin):
    """Capsule vs box: sphere-box contacts at the two segment endpoints AND
    at the segment point closest to the box, merged (deepest 4). A capsule
    lying flat on a face gets the 2-endpoint manifold it needs to rest
    without jitter; a capsule across an edge gets the mid contact plus
    tilted endpoint contacts (round-2 weak #5: the old single-point
    closest-to-center approximation rolled/jittered on edges)."""
    a0, a1 = _capsule_segment(pa, qa, hha)
    ca = _closest_on_segment(a0, a1, pb)
    mans = [sphere_box(e, ra, pb, qb, half_b, margin) for e in (a0, a1, ca)]
    return _merge_top4(mans)


# -- box kernels --------------------------------------------------------------


def _box_corners_world(p, q, half, rot=None):
    """(..., 8, 3) world corners — explicit sign combination of the scaled
    box axes (a broadcasted elementwise form instead of a tiny batched
    matmul of low arithmetic intensity).

    rot: optional precomputed rotation (the dispatch precomputes it ONCE
    per BODY and rides it in the pair record — per-pair quat math ran at
    P = N*K rows, 9x the per-body row count)."""
    r = m3.quat_to_mat3(q) if rot is None else rot
    ax = r[..., :, 0] * half[..., 0:1]          # (..., 3) scaled axes
    ay = r[..., :, 1] * half[..., 1:2]
    az = r[..., :, 2] * half[..., 2:3]
    s = jnp.asarray(_CORNER_SIGNS)               # (8, 3)
    return (p[..., None, :]
            + s[:, 0:1] * ax[..., None, :]
            + s[:, 1:2] * ay[..., None, :]
            + s[:, 2:3] * az[..., None, :])


def _dot3(a, b):
    """Explicit 3-component dot over broadcasted operands: elementwise work
    that fuses, instead of a low-intensity dot_general."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def box_plane(pa, qa, half_a, n_w, d_w, margin, ra=None):
    corners = _box_corners_world(pa, qa, half_a, rot=ra)  # (..., 8, 3)
    s = _dot3(corners, n_w[..., None, :]) + d_w[..., None]
    pen = -s  # corner below plane -> positive
    marg = jnp.asarray(margin)[..., None]
    pen = jnp.where(pen > -marg, pen, -1e30)
    nrm = jnp.broadcast_to((-n_w)[..., None, :], corners.shape)
    return _top4_manifold(pa.shape[:-1], pen, corners, nrm)


def _top4(x: Array) -> Tuple[Array, Array]:
    """top_k(4) that tolerates fewer than 4 candidates: pads with -inf
    (reported invalid downstream) and clamps indices into valid range."""
    n = x.shape[-1]
    if n < MAX_POINTS:
        pad = jnp.full(x.shape[:-1] + (MAX_POINTS - n,), -1e30, x.dtype)
        x = jnp.concatenate([x, pad], axis=-1)
    val, idx = jax.lax.top_k(x, MAX_POINTS)
    return val, jnp.minimum(idx, n - 1)


def _top4_sorted(pen: Array, columns) -> Tuple[Array, list]:
    """Keep the 4 deepest candidates of `pen` (..., n) along with per-
    candidate payload `columns` (list of (..., n) arrays) — ONE variadic
    lax.sort instead of top_k + batched (.., 4, n) one-hot row
    contractions of low arithmetic intensity.

    Ranking uses depth QUANTIZED to 1 mm so the kept SET is stable while
    a resting body rocks by less than that: face-face manifolds offer ~8
    equally-deep candidates whose exact depths reorder with sub-mm pose
    noise, and a churning top-4 re-keys the warm-start impulses every
    step — the solver then re-converges from cold each step and resting
    stacks hold a standing oscillation instead of sleeping (seen on
    hull-hull at ~0.3 m/s forever). Ties keep candidate-enumeration order
    (lax.sort is stable), which is pose-independent."""
    n = pen.shape[-1]
    if n < MAX_POINTS:
        padshape = pen.shape[:-1] + (MAX_POINTS - n,)
        pen = jnp.concatenate(
            [pen, jnp.full(padshape, -1e30, pen.dtype)], axis=-1)
        columns = [jnp.concatenate(
            [c, jnp.zeros(padshape, c.dtype)], axis=-1) for c in columns]
    rank = jnp.ceil(pen * 1e3)          # 1 mm depth buckets
    out = jax.lax.sort([-rank, pen] + list(columns), num_keys=1)
    return out[1][..., :MAX_POINTS], [c[..., :MAX_POINTS] for c in out[2:]]


def _top4_manifold(shape, pen: Array, point: Array, normal: Array,
                   flip_normal: bool = False) -> Dict[str, Array]:
    """Manifold of the 4 deepest candidates; pen (..., n) already carries
    -1e30 for invalid slots; point/normal (..., n, 3)."""
    cols = [point[..., i] for i in range(3)] + [normal[..., i] for i in range(3)]
    top_pen, out = _top4_sorted(pen, cols)
    m = _empty_manifold(shape)
    m["pen"] = top_pen
    m["point"] = jnp.stack(out[0:3], axis=-1)
    nrm = jnp.stack(out[3:6], axis=-1)
    m["normal"] = -nrm if flip_normal else nrm
    m["valid"] = top_pen > -1e29
    return m


def _take4_rows(x: Array, idx: Array) -> Array:
    """x[..., idx, :] for the top-4 indices — dense one-hot contraction
    over the small k here (math3d one-hot notes)."""
    return m3.gather_rows(x, idx)


def box_box(pa, qa, half_a, pb, qb, half_b, margin, ra=None, rb=None):
    """Full-SAT box manifold: 6 face normals + 9 edge-cross axes.

    Minimal-overlap axis over all 15 separating-axis candidates (Jolt/Bullet
    convention, slight bias toward face axes for manifold stability). Face
    case: per-corner penetrations past the opposing face plane, deepest 4
    kept. Edge case: single contact at the closest point between the two
    supporting edges (the configuration round-1 lacked; oblique box stacks
    interpenetrated without it).
    """
    shape = pa.shape[:-1]
    if ra is None:
        ra = m3.quat_to_mat3(qa)  # columns are A's axes
    if rb is None:
        rb = m3.quat_to_mat3(qb)
    d = pb - pa

    # candidate face axes: world-space face normals of A and B -> (..., 6, 3)
    a_cols = jnp.swapaxes(ra, -1, -2)   # (..., 3, 3) rows = A's axes
    b_cols = jnp.swapaxes(rb, -1, -2)
    axes = jnp.concatenate([a_cols, b_cols], axis=-2)

    def proj_radius(rot, half, axis):
        # sum_i half_i * |dot(col_i(rot), axis)| ; rot cols are box axes
        cols = jnp.swapaxes(rot, -1, -2)  # (..., 3(axis), 3)
        # explicit per-axis |dot|: elementwise broadcasting instead of
        # the tiny batched dot_general this einsum lowers to
        acc = 0.0
        for a_i in range(3):
            acc = acc + half[..., a_i, None] * jnp.abs(
                _dot3(cols[..., a_i, None, :], axis))
        return acc

    r_a = proj_radius(ra, half_a, axes)  # (..., 6)
    r_b = proj_radius(rb, half_b, axes)
    dist = _dot3(axes, d[..., None, :])  # signed center distance
    overlap = r_a + r_b - jnp.abs(dist)  # (..., 6)

    # edge-cross axes: a_i x b_j -> (..., 9, 3), degenerate (parallel) pairs
    # get +inf overlap so they never win
    ecross = jnp.cross(a_cols[..., :, None, :], b_cols[..., None, :, :])
    ecross = ecross.reshape(shape + (9, 3))
    elen = m3.length(ecross)
    edeg = elen < 1e-6
    eaxes = ecross / jnp.maximum(elen, 1e-9)[..., None]
    er_a = proj_radius(ra, half_a, eaxes)
    er_b = proj_radius(rb, half_b, eaxes)
    edist = _dot3(eaxes, d[..., None, :])
    eoverlap = jnp.where(edeg, 1e30, er_a + er_b - jnp.abs(edist))

    all_overlap = jnp.concatenate([overlap, eoverlap], axis=-1)  # (..., 15)
    separated = jnp.any(all_overlap < -jnp.asarray(margin)[..., None], axis=-1)

    best_face = jnp.argmin(overlap, axis=-1)
    face_overlap = m3.select_scalar(overlap, best_face)
    best_edge = jnp.argmin(eoverlap, axis=-1)
    edge_overlap = m3.select_scalar(eoverlap, best_edge)
    # face bias (Bullet's rel/abs tolerance): only take the edge axis when
    # it is clearly more separating, avoiding face<->edge flip jitter
    use_edge = edge_overlap < face_overlap * 0.95 - 0.01

    # ---- face-axis manifold --------------------------------------------
    axis = m3.select_row(axes, best_face)
    sign = jnp.sign(m3.select_scalar(dist, best_face))
    sign = jnp.where(sign == 0.0, 1.0, sign)
    n = axis * sign[..., None]  # unit normal pointing A -> B

    rn_a = m3.select_scalar(r_a, best_face)
    rn_b = m3.select_scalar(r_b, best_face)

    corners_a = _box_corners_world(pa, qa, half_a)  # (..., 8, 3)
    corners_b = _box_corners_world(pb, qb, half_b)
    # corners of B past A's face toward B: pen = r_a(n) - dot(c - pa, n)
    pen_b = rn_a[..., None] - _dot3(corners_b - pa[..., None, :], n[..., None, :])
    # corners of A past B's face toward A: pen = r_b(n) + dot(c - pb, n)
    pen_a = rn_b[..., None] + _dot3(corners_a - pb[..., None, :], n[..., None, :])

    pen = jnp.concatenate([pen_b, pen_a], axis=-1)  # (..., 16)
    point = jnp.concatenate([corners_b, corners_a], axis=-2)

    top_pen, cols4 = _top4_sorted(
        pen, [point[..., 0], point[..., 1], point[..., 2]])
    face_point = jnp.stack(cols4, axis=-1)

    # ---- edge-axis contact ---------------------------------------------
    en = m3.select_row(eaxes, best_edge)
    esign = jnp.sign(m3.select_scalar(edist, best_edge))
    esign = jnp.where(esign == 0.0, 1.0, esign)
    en = en * esign[..., None]  # A -> B
    ei = best_edge // 3         # edge direction index on A
    ej = best_edge % 3          # edge direction index on B
    dir_a = m3.select_row(a_cols, ei)
    dir_b = m3.select_row(b_cols, ej)
    # supporting edge midpoint on A: extreme corner along +n in the two
    # axes != ei; on B: extreme along -n in axes != ej
    sup_a = jnp.zeros_like(pa)
    sup_b = jnp.zeros_like(pb)
    for k in range(3):
        ak = a_cols[..., k, :]
        bk = b_cols[..., k, :]
        sa = jnp.sign(m3.dot(ak, en))
        sa = jnp.where(sa == 0.0, 1.0, sa)
        sb = jnp.sign(m3.dot(bk, -en))
        sb = jnp.where(sb == 0.0, 1.0, sb)
        sup_a = sup_a + jnp.where((ei == k)[..., None], 0.0,
                                  (sa * half_a[..., k])[..., None] * ak)
        sup_b = sup_b + jnp.where((ej == k)[..., None], 0.0,
                                  (sb * half_b[..., k])[..., None] * bk)
    ha_i = m3.select_scalar(half_a, ei)
    hb_j = m3.select_scalar(half_b, ej)
    ea0 = pa + sup_a - dir_a * ha_i[..., None]
    ea1 = pa + sup_a + dir_a * ha_i[..., None]
    eb0 = pb + sup_b - dir_b * hb_j[..., None]
    eb1 = pb + sup_b + dir_b * hb_j[..., None]
    ca, cb = _closest_segment_segment(ea0, ea1, eb0, eb1)
    edge_point = 0.5 * (ca + cb)

    # ---- merge ----------------------------------------------------------
    m = _empty_manifold(shape)
    ue = use_edge[..., None]
    m["pen"] = jnp.where(
        ue,
        jnp.concatenate([edge_overlap[..., None],
                         jnp.full(shape + (MAX_POINTS - 1,), -1e30)], -1),
        top_pen,
    )
    m["point"] = jnp.where(ue[..., None],
                           edge_point[..., None, :], face_point)
    m["normal"] = jnp.where(ue[..., None], en[..., None, :],
                            jnp.broadcast_to(n[..., None, :], m["normal"].shape))
    m["valid"] = (m["pen"] > -jnp.asarray(margin)[..., None]) & ~separated[..., None]
    return m


# -- convex hull kernels -------------------------------------------------------
#
# Hulls are point clouds + outward face normals from the ShapeTable side pools
# (ConvexHullShape analog, physics.hpp:103-153). The contact strategy mirrors
# the box path: SAT over both hulls' face normals PLUS the pairwise cross
# products of each hull's distinct edge directions (up to 8 per hull, deduped
# at build time — not 32x32 raw edge crosses), then vertices past the
# opposing support plane. Edge contacts resolve along the winning cross axis.


def _hull_world(p, q, params, tables):
    """World-space hull data for a batch of pairs: verts (..., HV, 3) with
    validity, face normals (..., HF, 3) with validity."""
    hidx = params[..., 0].astype(jnp.int32)
    verts_l = tables["hull_verts"][hidx]          # (..., HV, 3)
    vvalid = tables["hull_vert_valid"][hidx]
    faces_l = tables["hull_face_n"][hidx]
    fvalid = tables["hull_face_valid"][hidx]
    rot = m3.quat_to_mat3(q)
    verts_w = m3.einsum("...ij,...kj->...ki", rot, verts_l) + p[..., None, :]
    faces_w = m3.einsum("...ij,...kj->...ki", rot, faces_l)
    return verts_w, vvalid, faces_w, fvalid


def _cloud_cloud(pts_a, va, axes_a, fa, pts_b, vb, axes_b, fb, d_ab, margin,
                 edges_a=None, ea_valid=None, edges_b=None, eb_valid=None):
    """Generic convex-cloud SAT manifold. pts/axes are world-space with
    validity masks; d_ab = pb - pa fixes the normal orientation A -> B.

    edges_a/edges_b: optional (..., E, 3) distinct edge DIRECTIONS of each
    body — their pairwise cross products join the SAT axis set, closing
    the round-2 gap where oblique hull-hull edge contacts interpenetrated
    (face-normal axes alone miss edge-edge separating axes)."""
    axes_list = [axes_a, axes_b]
    valid_list = [fa, fb]
    if edges_a is not None and edges_b is not None:
        cross = jnp.cross(edges_a[..., :, None, :], edges_b[..., None, :, :])
        cl = m3.length(cross)
        e_sh = cross.shape[:-3] + (cross.shape[-3] * cross.shape[-2], 3)
        cross = (cross / jnp.maximum(cl, 1e-9)[..., None]).reshape(e_sh)
        cvalid = ((ea_valid[..., :, None] & eb_valid[..., None, :])
                  & (cl > 1e-6)).reshape(e_sh[:-1])
        axes_list.append(cross)
        valid_list.append(cvalid)
    axes = jnp.concatenate(axes_list, axis=-2)              # (..., F, 3)
    avalid = jnp.concatenate(valid_list, axis=-1)

    def project(pts, valid, axes):
        # (..., F, P) dot products; invalid verts excluded from min/max
        dots = m3.einsum("...fi,...pi->...fp", axes, pts)
        big = jnp.float32(1e30)
        lo = jnp.min(jnp.where(valid[..., None, :], dots, big), axis=-1)
        hi = jnp.max(jnp.where(valid[..., None, :], dots, -big), axis=-1)
        return lo, hi

    lo_a, hi_a = project(pts_a, va, axes)
    lo_b, hi_b = project(pts_b, vb, axes)
    overlap = jnp.minimum(hi_a, hi_b) - jnp.maximum(lo_a, lo_b)
    overlap = jnp.where(avalid, overlap, 1e30)

    separated = jnp.any(overlap < -jnp.asarray(margin)[..., None], axis=-1)
    best = jnp.argmin(overlap, axis=-1)
    best_overlap = m3.select_scalar(overlap, best)
    axis = m3.select_row(axes, best)
    sign = jnp.sign(m3.dot(axis, d_ab))
    sign = jnp.where(sign == 0.0, 1.0, sign)
    n = axis * sign[..., None]                                # A -> B

    # support planes along n: A's far side toward B, B's far side toward A
    sup_a = jnp.max(jnp.where(va, m3.einsum("...pi,...i->...p", pts_a, n), -1e30), axis=-1)
    sup_b = jnp.min(jnp.where(vb, m3.einsum("...pi,...i->...p", pts_b, n), 1e30), axis=-1)
    # verts of B past A's support plane (B in front of A along n)
    pen_b = sup_a[..., None] - m3.einsum("...pi,...i->...p", pts_b, n)
    pen_b = jnp.where(vb, pen_b, -1e30)
    # verts of A past B's support plane
    pen_a = m3.einsum("...pi,...i->...p", pts_a, n) - sup_b[..., None]
    pen_a = jnp.where(va, pen_a, -1e30)
    pen = jnp.concatenate([pen_b, pen_a], axis=-1)
    # penetration of each point capped at the SAT overlap (vertices deep past
    # the plane on a shallow-overlap axis otherwise overstate depth)
    pen = jnp.minimum(pen, best_overlap[..., None])
    point = jnp.concatenate([pts_b, pts_a], axis=-2)

    marg = jnp.asarray(margin)[..., None]
    pen = jnp.where((pen > -marg) & ~separated[..., None], pen, -1e30)
    top_pen, cols4 = _top4_sorted(
        pen, [point[..., 0], point[..., 1], point[..., 2]])
    m = _empty_manifold(pts_a.shape[:-2])
    m["pen"] = top_pen
    m["point"] = jnp.stack(cols4, axis=-1)
    m["normal"] = jnp.broadcast_to(n[..., None, :], m["normal"].shape)
    m["valid"] = top_pen > -1e29
    return m


def _box_cloud(p, q, half):
    """Box as a point cloud: 8 world corners + 3 face axes, all valid."""
    corners = _box_corners_world(p, q, half)
    axes = jnp.swapaxes(m3.quat_to_mat3(q), -1, -2)  # (..., 3, 3) rows = axes
    shape = p.shape[:-1]
    return (corners, jnp.ones(shape + (8,), bool),
            axes, jnp.ones(shape + (3,), bool))


def _hull_world_edges(q, params, tables):
    """World-rotated distinct edge directions of a hull (..., E, 3)."""
    hidx = params[..., 0].astype(jnp.int32)
    dirs_l = tables["hull_edge_dirs"][hidx]
    evalid = tables["hull_edge_valid"][hidx]
    rot = m3.quat_to_mat3(q)
    return m3.einsum("...ij,...kj->...ki", rot, dirs_l), evalid


def hull_hull(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    va_pts, va, fa_n, fa = _hull_world(pa, qa, prm_a, tables)
    vb_pts, vb, fb_n, fb = _hull_world(pb, qb, prm_b, tables)
    ea, eav = _hull_world_edges(qa, prm_a, tables)
    eb, ebv = _hull_world_edges(qb, prm_b, tables)
    return _cloud_cloud(va_pts, va, fa_n, fa, vb_pts, vb, fb_n, fb,
                        pb - pa, margin,
                        edges_a=ea, ea_valid=eav, edges_b=eb, eb_valid=ebv)


def box_hull(pa, qa, half_a, pb, qb, prm_b, tables, margin):
    a_pts, av, a_axes, af = _box_cloud(pa, qa, half_a)
    b_pts, bv, b_axes, bf = _hull_world(pb, qb, prm_b, tables)
    # box edge directions = its 3 local axes (already a_axes rows)
    eb, ebv = _hull_world_edges(qb, prm_b, tables)
    shape = pa.shape[:-1]
    return _cloud_cloud(a_pts, av, a_axes, af, b_pts, bv, b_axes, bf,
                        pb - pa, margin,
                        edges_a=a_axes, ea_valid=jnp.ones(shape + (3,), bool),
                        edges_b=eb, eb_valid=ebv)


def sphere_hull(pa, ra, pb, qb, prm_b, tables, margin):
    """Face-region contact: deepest face plane of the hull vs the sphere
    center (exact when the closest feature is a face; edge/vertex regions
    resolve via the nearest face plane)."""
    verts_w, vv, faces_w, fv = _hull_world(pb, qb, prm_b, tables)
    # world support offset per face: d_f = max over verts of dot(n_f, v)
    dots = m3.einsum("...fi,...pi->...fp", faces_w, verts_w)
    d_f = jnp.max(jnp.where(vv[..., None, :], dots, -1e30), axis=-1)
    s_f = m3.einsum("...fi,...i->...f", faces_w, pa) - d_f  # signed dist
    s_f = jnp.where(fv, s_f, -1e30)
    best = jnp.argmax(s_f, axis=-1)
    s = m3.select_scalar(s_f, best)
    n = m3.select_row(faces_w, best)
    pen = ra - s
    point = pa - n * (ra - 0.5 * jnp.clip(pen, 0.0, ra))[..., None]
    # normal A(sphere) -> B(hull) = -n (into the hull)
    return _one_point(pa.shape[:-1], point, -n, pen, pen > -margin)


def capsule_hull(pa, qa, ra, hha, pb, qb, prm_b, tables, margin):
    """Two endpoint spheres against the hull (2-point manifold)."""
    e0, e1 = _capsule_segment(pa, qa, hha)
    m0 = sphere_hull(e0, ra, pb, qb, prm_b, tables, margin)
    m1 = sphere_hull(e1, ra, pb, qb, prm_b, tables, margin)
    m = _empty_manifold(pa.shape[:-1])
    for i, src in enumerate((m0, m1)):
        m["point"] = m["point"].at[..., i, :].set(src["point"][..., 0, :])
        m["normal"] = m["normal"].at[..., i, :].set(src["normal"][..., 0, :])
        m["pen"] = m["pen"].at[..., i].set(src["pen"][..., 0])
        m["valid"] = m["valid"].at[..., i].set(src["valid"][..., 0])
    return m


def hull_plane(pa, qa, prm_a, n_w, d_w, tables, margin):
    """Hull vertices below the plane, deepest 4 (box_plane generalized)."""
    verts_w, vv, _, _ = _hull_world(pa, qa, prm_a, tables)
    s = m3.einsum("...pi,...i->...p", verts_w, n_w) + d_w[..., None]
    marg = jnp.asarray(margin)[..., None]
    pen = jnp.where(vv & (-s > -marg), -s, -1e30)
    nrm = jnp.broadcast_to((-n_w)[..., None, :], verts_w.shape)
    return _top4_manifold(pa.shape[:-1], pen, verts_w, nrm)


# -- heightfield kernels --------------------------------------------------------
#
# The heightfield (HeightFieldShape analog) is sampled under candidate points
# of the other body: each sample picks the 2-triangle cell beneath the point
# and produces a plane contact against that triangle (exact for contact
# features above the cell; no side-wall contacts, same as Jolt's active-edge
# default behavior for walkable terrain).


def _hf_plane_at(p_l, params_b, tables):
    """Local surface plane under local point p_l: (normal_l, point-on-plane,
    inside-grid mask). Grid is centered on the local origin, spacing `cell`."""
    shp = p_l.shape[:-1]
    hidx = jnp.broadcast_to(params_b[..., 0].astype(jnp.int32), shp)
    cell = jnp.broadcast_to(params_b[..., 1], shp)
    nx = jnp.broadcast_to(params_b[..., 2], shp)
    nz = jnp.broadcast_to(params_b[..., 3], shp)
    gx = p_l[..., 0] / cell + (nx - 1.0) * 0.5
    gz = p_l[..., 2] / cell + (nz - 1.0) * 0.5
    inside = (gx >= 0.0) & (gx <= nx - 1.0) & (gz >= 0.0) & (gz <= nz - 1.0)
    ix = jnp.clip(jnp.floor(gx), 0.0, nx - 2.0).astype(jnp.int32)
    iz = jnp.clip(jnp.floor(gz), 0.0, nz - 2.0).astype(jnp.int32)
    fx = jnp.clip(gx - ix, 0.0, 1.0)
    fz = jnp.clip(gz - iz, 0.0, 1.0)
    h = tables["hf_heights"]
    h00 = h[hidx, iz, ix]
    h10 = h[hidx, iz, ix + 1]
    h01 = h[hidx, iz + 1, ix]
    h11 = h[hidx, iz + 1, ix + 1]
    # two triangles per cell split along fx + fz = 1 (mesh.heightfield order)
    lower = fx + fz <= 1.0
    nrm1 = jnp.stack([-(h10 - h00), cell, -(h01 - h00)], axis=-1)
    nrm2 = jnp.stack([-(h11 - h01), cell, -(h11 - h10)], axis=-1)
    n_l = m3.normalize(jnp.where(lower[..., None], nrm1, nrm2))
    x0 = (ix.astype(jnp.float32) - (nx - 1.0) * 0.5) * cell
    z0 = (iz.astype(jnp.float32) - (nz - 1.0) * 0.5) * cell
    p1 = jnp.stack([x0, h00, z0], axis=-1)
    p2 = jnp.stack([x0 + cell, h11, z0 + cell], axis=-1)
    p_on = jnp.where(lower[..., None], p1, p2)
    return n_l, p_on, inside


def _points_vs_heightfield(points_w, pvalid, radius, pb, qb, prm_b, tables,
                           margin):
    """Plane contacts for a batch of candidate points (..., P, 3) against the
    heightfield body at (pb, qb). radius: per-point sphere radius (0 for
    corners/verts). Returns top-4 manifold; normals point A -> B (down into
    the terrain)."""
    rot = m3.quat_to_mat3(qb)
    p_l = m3.einsum("...ji,...pj->...pi", rot, points_w - pb[..., None, :])
    n_l, p_on, inside = _hf_plane_at(p_l, prm_b[..., None, :], tables)
    pen = radius - m3.dot(n_l, p_l - p_on)
    marg = jnp.asarray(margin)
    while marg.ndim < pen.ndim:
        marg = marg[..., None]
    pen = jnp.where(pvalid & inside & (pen > -marg), pen, -1e30)
    n_w = m3.einsum("...ij,...pj->...pi", rot, n_l)
    # contact point on the body surface (sphere-offset along the normal)
    point = points_w - n_w * radius[..., None]
    return _top4_manifold(points_w.shape[:-2], pen, point, n_w,
                          flip_normal=True)


def sphere_heightfield(pa, ra, pb, qb, prm_b, tables, margin):
    pts = pa[..., None, :]
    return _points_vs_heightfield(
        pts, jnp.ones(pts.shape[:-1], bool), ra[..., None],
        pb, qb, prm_b, tables, margin)


def capsule_heightfield(pa, qa, ra, hha, pb, qb, prm_b, tables, margin):
    e0, e1 = _capsule_segment(pa, qa, hha)
    pts = jnp.stack([e0, e1], axis=-2)
    return _points_vs_heightfield(
        pts, jnp.ones(pts.shape[:-1], bool),
        jnp.broadcast_to(ra[..., None], pts.shape[:-1]),
        pb, qb, prm_b, tables, margin)


def box_heightfield(pa, qa, half_a, pb, qb, prm_b, tables, margin):
    pts = _box_corners_world(pa, qa, half_a)
    return _points_vs_heightfield(
        pts, jnp.ones(pts.shape[:-1], bool), jnp.zeros(pts.shape[:-1]),
        pb, qb, prm_b, tables, margin)


def hull_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    pts, pvalid, _, _ = _hull_world(pa, qa, prm_a, tables)
    return _points_vs_heightfield(
        pts, pvalid, jnp.zeros(pts.shape[:-1]), pb, qb, prm_b, tables, margin)


# -- compound kernels ------------------------------------------------------------
#
# A compound is up to MAX_CHILDREN convex children (sphere/box/capsule) with
# local offsets (StaticCompoundShape analog). Contact = union of per-child
# manifolds, deepest 4 kept. Compound children are statically unrolled;
# compound-vs-compound runs every child pair (MAX_CHILDREN^2, the analog of
# Jolt's recursive dispatch), and hull-vs-compound runs each child against
# the hull.


def _convex_pair(ta, pa, qa, prm_a, tb, pb, qb, prm_b, margin, present):
    """Contact manifold between two convex primitives whose types are runtime
    values in {SPHERE, BOX, CAPSULE}: evaluates the possible kernels and
    selects per pair. `present`: static set bounding the kernel set."""
    kernels = []

    def add(cond, fn):
        kernels.append((cond, fn()))

    types = present & {sh.SPHERE, sh.BOX, sh.CAPSULE}
    if sh.SPHERE in types:
        add((ta == sh.SPHERE) & (tb == sh.SPHERE),
            lambda: sphere_sphere(pa, prm_a[..., 0], pb, prm_b[..., 0], margin))
    if sh.SPHERE in types and sh.BOX in types:
        add((ta == sh.SPHERE) & (tb == sh.BOX),
            lambda: sphere_box(pa, prm_a[..., 0], pb, qb, prm_b[..., :3], margin))
        add((ta == sh.BOX) & (tb == sh.SPHERE),
            lambda: _flip(sphere_box(pb, prm_b[..., 0], pa, qa,
                                     prm_a[..., :3], margin)))
    if sh.SPHERE in types and sh.CAPSULE in types:
        add((ta == sh.SPHERE) & (tb == sh.CAPSULE),
            lambda: _flip(capsule_sphere(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                         pa, prm_a[..., 0], margin)))
        add((ta == sh.CAPSULE) & (tb == sh.SPHERE),
            lambda: capsule_sphere(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                   pb, prm_b[..., 0], margin))
    if sh.BOX in types:
        add((ta == sh.BOX) & (tb == sh.BOX),
            lambda: box_box(pa, qa, prm_a[..., :3], pb, qb, prm_b[..., :3], margin))
    if sh.BOX in types and sh.CAPSULE in types:
        add((ta == sh.BOX) & (tb == sh.CAPSULE),
            lambda: _flip(capsule_box(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                      pa, qa, prm_a[..., :3], margin)))
        add((ta == sh.CAPSULE) & (tb == sh.BOX),
            lambda: capsule_box(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                pb, qb, prm_b[..., :3], margin))
    if sh.CAPSULE in types:
        add((ta == sh.CAPSULE) & (tb == sh.CAPSULE),
            lambda: capsule_capsule(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                    pb, qb, prm_b[..., 0], prm_b[..., 1], margin))

    out = _empty_manifold(pa.shape[:-1])
    for field in ("point", "normal", "pen", "valid"):
        acc = out[field]
        for cond, man in kernels:
            c = cond
            while c.ndim < acc.ndim:
                c = c[..., None]
            acc = jnp.where(c, man[field], acc)
        out[field] = acc
    return out


def _merge_top4(manifolds):
    """Merge several manifolds into one, keeping the 4 deepest valid points."""
    pen = jnp.concatenate(
        [jnp.where(m["valid"], m["pen"], -1e30) for m in manifolds], axis=-1)
    point = jnp.concatenate([m["point"] for m in manifolds], axis=-2)
    normal = jnp.concatenate([m["normal"] for m in manifolds], axis=-2)
    return _top4_manifold(pen.shape[:-1], pen, point, normal)


def _compound_children_world(pb, qb, prm_b, tables):
    """World pose + type/params of each compound child slot."""
    cidx = prm_b[..., 0].astype(jnp.int32)
    ctype = tables["comp_type"][cidx]            # (..., K)
    cparams = tables["comp_params"][cidx]        # (..., K, 4)
    cpos_l = tables["comp_pos"][cidx]
    cquat_l = tables["comp_quat"][cidx]
    cpos_w = pb[..., None, :] + m3.quat_rotate(
        jnp.broadcast_to(qb[..., None, :], cquat_l.shape), cpos_l)
    cquat_w = m3.quat_mul(
        jnp.broadcast_to(qb[..., None, :], cquat_l.shape), cquat_l)
    return ctype, cparams, cpos_w, cquat_w


def convex_compound(ta, pa, qa, prm_a, pb, qb, prm_b, tables, margin, present):
    """Convex primitive A vs compound B: per-child _convex_pair, merged."""
    ctype, cparams, cpos_w, cquat_w = _compound_children_world(
        pb, qb, prm_b, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        man = _convex_pair(ta, pa, qa, prm_a,
                           ctype[..., k], cpos_w[..., k, :],
                           cquat_w[..., k, :], cparams[..., k, :],
                           margin, present)
        man["valid"] = man["valid"] & (ctype[..., k] != sh.EMPTY)[..., None]
        mans.append(man)
    return _merge_top4(mans)


def compound_compound(pa, qa, prm_a, pb, qb, prm_b, tables, margin,
                      present):
    """Compound A vs compound B: every child pair through _convex_pair,
    deepest 4 kept (closes the round-2 gap where two multi-part bodies
    passed through each other; the reference handles this via Jolt's
    recursive shape dispatch)."""
    ta_c, pa_c, ppos_a, pquat_a = _compound_children_world(
        pa, qa, prm_a, tables)
    tb_c, pb_c, ppos_b, pquat_b = _compound_children_world(
        pb, qb, prm_b, tables)
    mans = []
    for i in range(sh.MAX_CHILDREN):
        for j in range(sh.MAX_CHILDREN):
            man = _convex_pair(
                ta_c[..., i], ppos_a[..., i, :], pquat_a[..., i, :],
                pa_c[..., i, :],
                tb_c[..., j], ppos_b[..., j, :], pquat_b[..., j, :],
                pb_c[..., j, :],
                margin, present)
            man["valid"] = man["valid"] & (
                (ta_c[..., i] != sh.EMPTY)
                & (tb_c[..., j] != sh.EMPTY))[..., None]
            mans.append(man)
    return _merge_top4(mans)


def compound_plane(pa, qa, prm_a, n_w, d_w, tables, margin, present):
    """Compound A vs plane B: per-child plane kernel, merged."""
    ctype, cparams, cpos_w, cquat_w = _compound_children_world(
        pa, qa, prm_a, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk = ctype[..., k]
        pk, qk, prmk = cpos_w[..., k, :], cquat_w[..., k, :], cparams[..., k, :]
        parts = []
        if sh.SPHERE in present:
            parts.append((tk == sh.SPHERE,
                          sphere_plane(pk, prmk[..., 0], n_w, d_w, margin)))
        if sh.BOX in present:
            parts.append((tk == sh.BOX,
                          box_plane(pk, qk, prmk[..., :3], n_w, d_w, margin)))
        if sh.CAPSULE in present:
            parts.append((tk == sh.CAPSULE,
                          capsule_plane(pk, qk, prmk[..., 0], prmk[..., 1],
                                        n_w, d_w, margin)))
        man = _empty_manifold(pa.shape[:-1])
        for field in ("point", "normal", "pen", "valid"):
            acc = man[field]
            for cond, m_ in parts:
                c = cond
                while c.ndim < acc.ndim:
                    c = c[..., None]
                acc = jnp.where(c, m_[field], acc)
            man[field] = acc
        mans.append(man)
    return _merge_top4(mans)


def compound_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    """Compound A vs heightfield B: sample under child centers + box corners
    approximated by each child's support points (sphere centers / capsule
    endpoints / box corners)."""
    ctype, cparams, cpos_w, cquat_w = _compound_children_world(
        pa, qa, prm_a, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk = ctype[..., k]
        pk, qk, prmk = cpos_w[..., k, :], cquat_w[..., k, :], cparams[..., k, :]
        sphere_m = sphere_heightfield(pk, prmk[..., 0], pb, qb, prm_b,
                                      tables, margin)
        box_m = box_heightfield(pk, qk, prmk[..., :3], pb, qb, prm_b,
                                tables, margin)
        cap_m = capsule_heightfield(pk, qk, prmk[..., 0], prmk[..., 1],
                                    pb, qb, prm_b, tables, margin)
        man = _empty_manifold(pa.shape[:-1])
        for field in ("point", "normal", "pen", "valid"):
            acc = man[field]
            for cond, m_ in ((tk == sh.SPHERE, sphere_m),
                             (tk == sh.BOX, box_m), (tk == sh.CAPSULE, cap_m)):
                c = cond
                while c.ndim < acc.ndim:
                    c = c[..., None]
                acc = jnp.where(c, m_[field], acc)
            man[field] = acc
        mans.append(man)
    return _merge_top4(mans)




# -- triangle-mesh kernels ----------------------------------------------------
#
# MESH bodies (static concave level geometry, MeshShape analog) store a
# triangle soup binned into a uniform local grid of fixed-capacity buckets
# (shapes.py ShapeTable.mesh). Contact generation mirrors the heightfield
# pattern: candidate points (sphere center / capsule endpoints / box corners
# / hull verts) look up their containing cell's bucket and test its
# triangles with a branch-free closest-point-on-triangle; the deepest 4
# contacts survive. One-sided: contacts only push out the triangle's front
# face (CCW winding), with back-side capture capped at half a grid cell so
# thin walls don't catapult bodies through.


def _closest_on_triangle(p, a, b, c):
    """Branch-free closest point on triangle abc to p (Ericson 5.1.5),
    batched over leading dims."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = m3.dot(ab, ap)
    d2 = m3.dot(ac, ap)
    bp = p - b
    d3 = m3.dot(ab, bp)
    d4 = m3.dot(ac, bp)
    cp = p - c
    d5 = m3.dot(ab, cp)
    d6 = m3.dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = jnp.maximum(va + vb + vc, 1e-12)
    v = vb / denom
    w = vc / denom
    interior = a + ab * v[..., None] + ac * w[..., None]

    t_ab = jnp.clip(d1 / jnp.where(jnp.abs(d1 - d3) < 1e-12, 1e-12, d1 - d3),
                    0.0, 1.0)
    on_ab = a + ab * t_ab[..., None]
    t_ac = jnp.clip(d2 / jnp.where(jnp.abs(d2 - d6) < 1e-12, 1e-12, d2 - d6),
                    0.0, 1.0)
    on_ac = a + ac * t_ac[..., None]
    t_bc = jnp.clip(
        (d4 - d3) / jnp.where(jnp.abs((d4 - d3) + (d5 - d6)) < 1e-12, 1e-12,
                              (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    on_bc = b + (c - b) * t_bc[..., None]

    out = interior
    out = jnp.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                    on_ab, out)
    out = jnp.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], on_ac, out)
    out = jnp.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                    on_bc, out)
    out = jnp.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    out = jnp.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = jnp.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    return out


def _points_vs_mesh(points_w, pvalid, radius, pb, qb, prm_b, tables, margin):
    """Contacts for candidate points (..., P, 3) against the mesh body at
    (pb, qb). radius: per-point sphere radius. Returns top-4 manifold;
    normals point A -> B (into the mesh surface)."""
    rot = m3.quat_to_mat3(qb)
    p_l = m3.einsum("...ji,...pj->...pi", rot, points_w - pb[..., None, :])
    shp = p_l.shape[:-1]                          # (..., P)

    midx = jnp.broadcast_to(prm_b[..., 0].astype(jnp.int32)[..., None], shp)
    info = tables["mesh_info"][midx]              # (..., P, 8)
    origin = info[..., 0:3]
    cell = info[..., 3]
    g = tables["mesh_cells"].shape[1]
    g_dim = int(round(g ** (1.0 / 3.0)))
    while g_dim ** 3 < g:
        g_dim += 1

    c_idx = jnp.clip(((p_l - origin) / cell[..., None]).astype(jnp.int32),
                     0, g_dim - 1)
    ckey = (c_idx[..., 0] * g_dim + c_idx[..., 1]) * g_dim + c_idx[..., 2]
    bucket = tables["mesh_cells"][midx, ckey]     # (..., P, B)
    tri = tables["mesh_tris"][midx[..., None], jnp.maximum(bucket, 0)]
    # tri: (..., P, B, 3, 3) local triangle vertices
    a, b_, c_ = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    n_f = m3.normalize(jnp.cross(b_ - a, c_ - a))

    pq = p_l[..., None, :]                        # (..., P, 1, 3)
    closest = _closest_on_triangle(pq, a, b_, c_)
    d = pq - closest
    dist = m3.length(d)
    side = m3.dot(d, n_f)                         # signed by front/back
    # front side: euclidean distance to the closest point (correct edge/
    # vertex rounding). Back side: distance along the FACE normal only — a
    # point just under the surface near an internal edge must read as a
    # shallow face contact, not a deep lateral "edge" contact (the classic
    # internal-edge catch; Jolt solves it with active-edge flags).
    sdist = jnp.where(side >= 0.0, dist, side)
    # normal: from surface toward the point for front-side separation;
    # face normal when on/behind the plane (pushes back out the front)
    n_l = jnp.where(((dist > 1e-6) & (side > 0.0))[..., None],
                    d / jnp.maximum(dist, 1e-6)[..., None], n_f)
    pen = radius[..., None] - sdist
    # back-side capture cap: deeper than half a cell = wrong-face capture
    back_cap = radius[..., None] + 0.5 * cell[..., None]
    marg = jnp.asarray(margin)
    while marg.ndim < pen.ndim:
        marg = marg[..., None]
    valid = (bucket >= 0) & pvalid[..., None] & (pen > -marg)
    valid &= pen < back_cap
    # back-side capture requires the point to project INSIDE the triangle
    # (closest == in-plane projection, lateral offset ~0 — the thin-wall
    # case). A point BEHIND the plane whose closest point sits on an edge
    # is laterally outside the face's prism: it belongs to an adjacent
    # face, and treating it as a back-side hit here read the face-plane
    # depth through empty space (a ramp's far slope kicked bodies UP the
    # near slope through its extended plane).
    lat2 = jnp.maximum(dist * dist - side * side, 0.0)
    lat_eps = 1e-3 * cell[..., None]
    valid &= (side >= 0.0) | (lat2 < lat_eps * lat_eps)

    n_w = m3.einsum("...ij,...pbj->...pbi", rot, n_l)
    point = points_w[..., None, :] - n_w * radius[..., None, None]

    flat = shp[:-1] + (shp[-1] * bucket.shape[-1],)
    pen_f = jnp.where(valid, pen, -1e30).reshape(flat)
    return _top4_manifold(shp[:-1], pen_f, point.reshape(flat + (3,)),
                          n_w.reshape(flat + (3,)), flip_normal=True)


def sphere_mesh(pa, ra, pb, qb, prm_b, tables, margin):
    pts = pa[..., None, :]
    return _points_vs_mesh(pts, jnp.ones(pts.shape[:-1], bool),
                           ra[..., None], pb, qb, prm_b, tables, margin)


def capsule_mesh(pa, qa, ra, hha, pb, qb, prm_b, tables, margin):
    e0, e1 = _capsule_segment(pa, qa, hha)
    pts = jnp.stack([e0, 0.5 * (e0 + e1), e1], axis=-2)
    return _points_vs_mesh(pts, jnp.ones(pts.shape[:-1], bool),
                           jnp.broadcast_to(ra[..., None], pts.shape[:-1]),
                           pb, qb, prm_b, tables, margin)


def box_mesh(pa, qa, half_a, pb, qb, prm_b, tables, margin):
    pts = _box_corners_world(pa, qa, half_a)
    return _points_vs_mesh(pts, jnp.ones(pts.shape[:-1], bool),
                           jnp.zeros(pts.shape[:-1]), pb, qb, prm_b, tables,
                           margin)


def hull_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    pts, pvalid, _, _ = _hull_world(pa, qa, prm_a, tables)
    return _points_vs_mesh(pts, pvalid, jnp.zeros(pts.shape[:-1]),
                           pb, qb, prm_b, tables, margin)


def compound_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin):
    """Compound A vs mesh B: each child's support points vs the mesh."""
    ctype, cparams, cpos_w, cquat_w = _compound_children_world(
        pa, qa, prm_a, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk = ctype[..., k]
        pk, qk, prmk = cpos_w[..., k, :], cquat_w[..., k, :], cparams[..., k, :]
        sphere_m = sphere_mesh(pk, prmk[..., 0], pb, qb, prm_b, tables,
                               margin)
        box_m = box_mesh(pk, qk, prmk[..., :3], pb, qb, prm_b, tables,
                         margin)
        cap_m = capsule_mesh(pk, qk, prmk[..., 0], prmk[..., 1], pb, qb,
                             prm_b, tables, margin)
        man = _empty_manifold(pa.shape[:-1])
        for field in ("point", "normal", "pen", "valid"):
            acc = man[field]
            for cond, m_ in ((tk == sh.SPHERE, sphere_m),
                             (tk == sh.BOX, box_m), (tk == sh.CAPSULE, cap_m)):
                c = cond
                while c.ndim < acc.ndim:
                    c = c[..., None]
                acc = jnp.where(c, m_[field], acc)
            man[field] = acc
        mans.append(man)
    return _merge_top4(mans)




def hull_compound(pa, qa, prm_a, pb, qb, prm_b, tables, margin, present):
    """Hull A vs compound B: each compound child (sphere/box/capsule) tests
    against the hull with the existing convex-vs-hull kernels (closes the
    round-2 gap where HULL(4) x COMPOUND(5) pairs silently produced no
    contacts). Normals are flipped to point A(hull) -> B(compound)."""
    ctype, cparams, cpos_w, cquat_w = _compound_children_world(
        pb, qb, prm_b, tables)
    mans = []
    for k in range(sh.MAX_CHILDREN):
        tk = ctype[..., k]
        pk, qk, prmk = cpos_w[..., k, :], cquat_w[..., k, :], cparams[..., k, :]
        # child -> hull manifolds (normal child->hull); flip for A->B
        sphere_m = _flip(sphere_hull(pk, prmk[..., 0], pa, qa, prm_a,
                                     tables, margin))
        box_m = _flip(box_hull(pk, qk, prmk[..., :3], pa, qa, prm_a,
                               tables, margin))
        cap_m = _flip(capsule_hull(pk, qk, prmk[..., 0], prmk[..., 1],
                                   pa, qa, prm_a, tables, margin))
        man = _empty_manifold(pa.shape[:-1])
        for field in ("point", "normal", "pen", "valid"):
            acc = man[field]
            for cond, m_ in ((tk == sh.SPHERE, sphere_m),
                             (tk == sh.BOX, box_m), (tk == sh.CAPSULE, cap_m)):
                c = cond
                while c.ndim < acc.ndim:
                    c = c[..., None]
                acc = jnp.where(c, m_[field], acc)
            man[field] = acc
        mans.append(man)
    return _merge_top4(mans)


# -- dispatch -----------------------------------------------------------------




def generate_contacts(
    pos: Array, quat: Array, stype: Array, params: Array,
    pair_i: Array, pair_j: Array, pair_valid: Array,
    margin: float,
    present_types: frozenset = None,
    tables: Dict[str, Array] = None,
    row_major_k: int = None,
) -> Dict[str, Array]:
    """Contact manifolds for candidate pairs.

    pair_i/pair_j: int32[P] body indices; returns manifolds with shape
    (P, MAX_POINTS, ...) plus bodies `a`/`b` per pair. Pairs are canonically
    ordered so that type(a) <= type(b) (normals flip when swapped).

    `present_types` (static, from ShapeTable.present_types()) prunes kernels
    for shape types the scene doesn't contain — a trace-time specialization,
    like the reference's pipeline variants.

    Gather discipline: per-pair body attributes come from TWO packed record
    row gathers (pos+quat+params+type in one (N, 12) row) instead of eight
    separate array gathers — random gathers pay per op and per row, not
    per byte.
    """
    body_margin = margin if (hasattr(margin, "ndim") and margin.ndim == 1
                             and margin.shape[0] == pos.shape[0]) else None
    # NOTE: per-body quat_to_mat3 results (9 extra columns) stay out of
    # this record — wider rows slow the P-row gather more than the
    # per-pair quat math costs; kernels recompute rotations from quats
    cols = [pos, quat, params, stype.astype(jnp.float32)[:, None]]
    if body_margin is not None:
        cols.append(body_margin[:, None])
    record = jnp.concatenate(cols, axis=-1)
    n = pos.shape[0]
    p_total = pair_i.shape[0]
    if row_major_k is not None and p_total == n * row_major_k:
        # pair_i = repeat(arange(n), k): the row-body record fetch is a
        # structured repeat, not a random gather (saves one P-row gather)
        rec_i = jnp.repeat(record, row_major_k, axis=0)
    else:
        rec_i = record[pair_i]
    rec_j = record[pair_j]                        # (P, 12|13) THE gather
    ta0 = rec_i[:, 11].astype(jnp.int32)
    tb0 = rec_j[:, 11].astype(jnp.int32)
    # canonical order: by type, then by INDEX for same-type pairs. The
    # index tie-break matters for the symmetric row layout (solver.py):
    # rows (i, j) and (j, i) must evaluate the IDENTICAL canonical pair so
    # their manifolds match bitwise — same-type kernels enumerate
    # candidate points in A/B order, and equal-depth top-4 ties otherwise
    # select DIFFERENT points in the two rows (seen as a 3-of-4-point
    # manifold overlap on stacked hulls), leaving unpaired impulses that
    # slowly torque resting bodies.
    swap = (ta0 > tb0) | ((ta0 == tb0) & (pair_i > pair_j))
    a = jnp.where(swap, pair_j, pair_i)
    b = jnp.where(swap, pair_i, pair_j)
    # canonical (type-sorted) ordering applied densely to fetched rows
    rec_a = jnp.where(swap[:, None], rec_j, rec_i)
    rec_b = jnp.where(swap[:, None], rec_i, rec_j)
    pa, qa, prm_a = rec_a[:, 0:3], rec_a[:, 3:7], rec_a[:, 7:11]
    pb, qb, prm_b = rec_b[:, 0:3], rec_b[:, 3:7], rec_b[:, 7:11]
    ta = rec_a[:, 11].astype(jnp.int32)
    tb = rec_b[:, 11].astype(jnp.int32)
    if body_margin is not None:
        margin = jnp.maximum(rec_a[:, 12], rec_b[:, 12])

    n_w, d_w = _plane_world(pb, qb, prm_b)

    kernels = []
    conds = []

    def have(*types) -> bool:
        return present_types is None or all(t in present_types for t in types)

    def add(cond, man_fn):
        conds.append(cond)
        kernels.append(man_fn())

    if have(sh.SPHERE):
        add((ta == sh.SPHERE) & (tb == sh.SPHERE),
            lambda: sphere_sphere(pa, prm_a[..., 0], pb, prm_b[..., 0], margin))
    if have(sh.SPHERE, sh.BOX):
        add((ta == sh.SPHERE) & (tb == sh.BOX),
            lambda: sphere_box(pa, prm_a[..., 0], pb, qb, prm_b[..., :3], margin))
    if have(sh.SPHERE, sh.CAPSULE):
        add((ta == sh.SPHERE) & (tb == sh.CAPSULE),
            lambda: _flip(capsule_sphere(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                         pa, prm_a[..., 0], margin)))
    if have(sh.SPHERE, sh.PLANE):
        add((ta == sh.SPHERE) & (tb == sh.PLANE),
            lambda: sphere_plane(pa, prm_a[..., 0], n_w, d_w, margin))
    if have(sh.BOX):
        add((ta == sh.BOX) & (tb == sh.BOX),
            lambda: box_box(pa, qa, prm_a[..., :3], pb, qb, prm_b[..., :3],
                            margin))
    if have(sh.BOX, sh.CAPSULE):
        add((ta == sh.BOX) & (tb == sh.CAPSULE),
            lambda: _flip(capsule_box(pb, qb, prm_b[..., 0], prm_b[..., 1],
                                      pa, qa, prm_a[..., :3], margin)))
    if have(sh.BOX, sh.PLANE):
        add((ta == sh.BOX) & (tb == sh.PLANE),
            lambda: box_plane(pa, qa, prm_a[..., :3], n_w, d_w, margin))
    if have(sh.CAPSULE):
        add((ta == sh.CAPSULE) & (tb == sh.CAPSULE),
            lambda: capsule_capsule(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                    pb, qb, prm_b[..., 0], prm_b[..., 1], margin))
    if have(sh.CAPSULE, sh.PLANE):
        add((ta == sh.CAPSULE) & (tb == sh.PLANE),
            lambda: capsule_plane(pa, qa, prm_a[..., 0], prm_a[..., 1], n_w, d_w, margin))

    # hull pairs (ConvexHullShape, physics.hpp:103-153)
    if have(sh.SPHERE, sh.HULL):
        add((ta == sh.SPHERE) & (tb == sh.HULL),
            lambda: sphere_hull(pa, prm_a[..., 0], pb, qb, prm_b, tables, margin))
    if have(sh.BOX, sh.HULL):
        add((ta == sh.BOX) & (tb == sh.HULL),
            lambda: box_hull(pa, qa, prm_a[..., :3], pb, qb, prm_b, tables, margin))
    if have(sh.CAPSULE, sh.HULL):
        add((ta == sh.CAPSULE) & (tb == sh.HULL),
            lambda: capsule_hull(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                 pb, qb, prm_b, tables, margin))
    if have(sh.HULL):
        add((ta == sh.HULL) & (tb == sh.HULL),
            lambda: hull_hull(pa, qa, prm_a, pb, qb, prm_b, tables, margin))
    if have(sh.HULL, sh.PLANE):
        add((ta == sh.HULL) & (tb == sh.PLANE),
            lambda: hull_plane(pa, qa, prm_a, n_w, d_w, tables, margin))

    # heightfield pairs (HeightFieldShape)
    if have(sh.SPHERE, sh.HEIGHTFIELD):
        add((ta == sh.SPHERE) & (tb == sh.HEIGHTFIELD),
            lambda: sphere_heightfield(pa, prm_a[..., 0], pb, qb, prm_b,
                                       tables, margin))
    if have(sh.BOX, sh.HEIGHTFIELD):
        add((ta == sh.BOX) & (tb == sh.HEIGHTFIELD),
            lambda: box_heightfield(pa, qa, prm_a[..., :3], pb, qb, prm_b,
                                    tables, margin))
    if have(sh.CAPSULE, sh.HEIGHTFIELD):
        add((ta == sh.CAPSULE) & (tb == sh.HEIGHTFIELD),
            lambda: capsule_heightfield(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                        pb, qb, prm_b, tables, margin))
    if have(sh.HULL, sh.HEIGHTFIELD):
        add((ta == sh.HULL) & (tb == sh.HEIGHTFIELD),
            lambda: hull_heightfield(pa, qa, prm_a, pb, qb, prm_b, tables,
                                     margin))

    # compound pairs (StaticCompoundShape / decorated shapes)
    if have(sh.COMPOUND):
        present = present_types or frozenset(
            (sh.SPHERE, sh.BOX, sh.CAPSULE))
        add(((ta == sh.SPHERE) | (ta == sh.BOX) | (ta == sh.CAPSULE))
            & (tb == sh.COMPOUND),
            lambda: convex_compound(ta, pa, qa, prm_a, pb, qb, prm_b,
                                    tables, margin, present))
        if have(sh.PLANE):
            add((ta == sh.COMPOUND) & (tb == sh.PLANE),
                lambda: compound_plane(pa, qa, prm_a, n_w, d_w, tables,
                                       margin, present))
        if have(sh.HEIGHTFIELD):
            add((ta == sh.COMPOUND) & (tb == sh.HEIGHTFIELD),
                lambda: compound_heightfield(pa, qa, prm_a, pb, qb, prm_b,
                                             tables, margin))
        if have(sh.HULL):
            add((ta == sh.HULL) & (tb == sh.COMPOUND),
                lambda: hull_compound(pa, qa, prm_a, pb, qb, prm_b,
                                      tables, margin, present))
        add((ta == sh.COMPOUND) & (tb == sh.COMPOUND),
            lambda: compound_compound(pa, qa, prm_a, pb, qb, prm_b,
                                      tables, margin, present))

    # triangle-mesh pairs (MeshShape; always the B side, largest type id)
    if have(sh.SPHERE, sh.MESH):
        add((ta == sh.SPHERE) & (tb == sh.MESH),
            lambda: sphere_mesh(pa, prm_a[..., 0], pb, qb, prm_b, tables,
                                margin))
    if have(sh.BOX, sh.MESH):
        add((ta == sh.BOX) & (tb == sh.MESH),
            lambda: box_mesh(pa, qa, prm_a[..., :3], pb, qb, prm_b, tables,
                             margin))
    if have(sh.CAPSULE, sh.MESH):
        add((ta == sh.CAPSULE) & (tb == sh.MESH),
            lambda: capsule_mesh(pa, qa, prm_a[..., 0], prm_a[..., 1],
                                 pb, qb, prm_b, tables, margin))
    if have(sh.HULL, sh.MESH):
        add((ta == sh.HULL) & (tb == sh.MESH),
            lambda: hull_mesh(pa, qa, prm_a, pb, qb, prm_b, tables, margin))
    if have(sh.COMPOUND, sh.MESH):
        add((ta == sh.COMPOUND) & (tb == sh.MESH),
            lambda: compound_mesh(pa, qa, prm_a, pb, qb, prm_b, tables,
                                  margin))

    out = _empty_manifold(pair_i.shape)
    for field in ("point", "normal", "pen", "valid"):
        acc = out[field]
        for cond, man in zip(conds, kernels):
            c = cond
            while c.ndim < acc.ndim:
                c = c[..., None]
            acc = jnp.where(c, man[field], acc)
        out[field] = acc

    out["valid"] &= pair_valid[..., None]
    out["a"] = a
    out["b"] = b
    return out


def _flip(man: Dict[str, Array]) -> Dict[str, Array]:
    """Flip a manifold's normal direction (A<->B swap)."""
    return dict(man, normal=-man["normal"])
