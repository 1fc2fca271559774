"""Cascaded shadow maps.

Rebuild of CsmRenderSystem (include/garden/system/render/csm.hpp:36-90,
source/system/render/csm.cpp): 3 cascades fitted to slices of the camera
frustum (split ratios (0.1, 0.25) of shadow distance 100), depth-only
rasterization per cascade from the light's orthographic view, PCF-filtered
compare on resolve with constant+normal bias. The reference renders cascades
through IShadowMeshRenderSystem passes (mesh.cpp:795-847); here all cascades
raster side by side into ONE mixed-resolution atlas:

    y=0  +-----------------+--------+
         |                 |   c1   |
         |   cascade 0     +--------+
         |   (largest)     |   c2   |
         |                 +--------+
         +-----------------+

(2D shelf packing, `cascade_layout`: smaller cascades stack vertically —
fewer raster tiles and a binning key space that keeps the packed sort.)
One triangle-setup pass vectorized over cascades, one binning sort, one
Triton depth-kernel launch. Per-cascade caster culling falls out of setup validity
(triangles outside a cascade's ortho bounds never bin); far cascades can run
at reduced resolution (ShadowConfig.cascade_sizes), which cuts raster work
roughly with pixel count while keeping screen-space texel density.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.core.config import ShadowConfig
from garden_tpu.ops.shifts import Shifter
from garden_tpu.render import raster

Array = jnp.ndarray

NEAR_EPS = 1e-6


def cascade_splits(cfg: ShadowConfig, near: float) -> List[float]:
    """View-space split depths [near, s1, ..., far] (csm.hpp:89-90):
    exactly cascade_count slices — the LAST cascade always reaches the
    shadow distance, so configs with fewer cascades than split ratios
    merge the far range instead of truncating shadow coverage."""
    d = cfg.distance
    ratios = list(cfg.split_ratios)[:max(cfg.cascade_count - 1, 0)]
    return [near] + [r * d for r in ratios] + [d]


def cascade_layout(cfg: ShadowConfig) -> Tuple[Tuple[int, ...],
                                               Tuple[Tuple[int, int], ...],
                                               int, int]:
    """(sizes, (x0, y0) offsets, atlas_width, atlas_height): a 2D shelf
    packing of the cascade rects. Cascade 0 sits at the origin; smaller
    cascades STACK VERTICALLY in columns to its right while they fit under
    cascade 0's height. For the common mixed-resolution config
    (2048, 1024, 1024) this packs 3072x2048 instead of the 4096x2048
    horizontal strip — 25% fewer raster tiles AND a tile-key space small
    enough for the packed single-operand binning sort (31 bits at 3 x 123K
    triangles; the horizontal strip needed 32 and fell back to the ~2x
    slower variadic sort)."""
    sizes = cfg.cascade_sizes or (cfg.map_size,) * cfg.cascade_count
    h0 = max(sizes)
    offs = [(0, 0)]
    col_x, col_w, cur_y = sizes[0], 0, 0
    for s in sizes[1:]:
        if cur_y + s > h0:      # column full -> open a new one
            col_x, cur_y = col_x + col_w, 0
            col_w = 0
        offs.append((col_x, cur_y))
        cur_y += s
        col_w = max(col_w, s)
    atlas_w = col_x + col_w if len(sizes) > 1 else sizes[0]
    return sizes, tuple(offs), int(atlas_w), int(h0)


def fit_cascades(
    inv_view_proj: Array,   # camera inverse view-proj
    light_dir: Array,       # direction the light travels (sun -> scene)
    cam_near: float,
    splits: List[float],    # [near, s1, ..., far] view-space split depths
    near_clip_proj: float,
) -> Dict[str, Array]:
    """ONE shared light view + per-cascade ortho crops.

    Each cascade's frustum-slice corners (from NDC via inv_view_proj,
    reverse-Z: depth = near/viewdist) produce a light-space AABB -> ortho
    window in the SHARED view. Sharing the view (instead of a per-slice
    lookAt as csm.cpp fits) is equivalent up to the ortho translation and
    lets render_cascades transform every caster vertex to light space
    ONCE, with per-cascade coords as cheap affine maps instead of three
    per-cascade 4x4 transforms of every caster.

    Returns {"view" (4,4), "projs" (C,4,4) ortho crops, "lvps" (C,4,4)}.
    """
    light_dir = m3.normalize(light_dir)
    up = jnp.where(jnp.abs(light_dir[1]) > 0.95,
                   jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))

    def slice_corners(split_near, split_far):
        # reverse-Z infinite projection: ndc_z = near / dist
        z0 = near_clip_proj / jnp.maximum(split_near, near_clip_proj)
        z1 = near_clip_proj / jnp.maximum(split_far, near_clip_proj)
        corners = []
        for x in (-1.0, 1.0):
            for y in (-1.0, 1.0):
                for z in (z0, z1):
                    h = m3.matmul(inv_view_proj, jnp.array([x, y, z, 1.0]))
                    corners.append(h[:3] / h[3])
        return jnp.stack(corners)  # (8, 3)

    c_count = len(splits) - 1
    all_corners = [slice_corners(jnp.float32(splits[i]),
                                 jnp.float32(splits[i + 1]))
                   for i in range(c_count)]
    center = jnp.mean(jnp.concatenate(all_corners), axis=0)
    eye = center - light_dir * 200.0
    view = m3.look_at(eye, center, up)

    projs = []
    for corners in all_corners:
        lc = m3.apply_mat4(view, corners)  # corners in light space
        lo = jnp.min(lc, axis=0)
        hi = jnp.max(lc, axis=0)
        # extend the near plane backwards to catch off-slice casters
        projs.append(m3.orthographic(lo[0], hi[0], lo[1], hi[1],
                                     -hi[2] - 100.0, -lo[2],
                                     reverse_z=True))
    projs = jnp.stack(projs)
    lvps = m3.einsum("cij,jk->cik", projs, view)
    return {"view": view, "projs": projs, "lvps": lvps}


def _setup_cascades(
    lx: Array,              # (3, T) SHARED light-space x per corner
    ly: Array,              # (3, T)
    lz: Array,              # (3, T)
    tri_valid: Array,       # (T,) base triangle validity
    sizes: Tuple[int, ...],
    offsets: Tuple[Tuple[int, int], ...],
    projs: Array,           # (C, 4, 4) ortho crops (fit_cascades)
) -> Dict[str, Array]:
    """Triangle setup for every cascade at once, in ATLAS pixel coords.

    The batched twin of raster.setup_triangles_planes. The light view is
    SHARED (fit_cascades), so each cascade's pixel coords are an affine
    map of the one light-space position: sx = x*ax_c + bx_c etc., with
    the coefficients read straight off the ortho matrices (bitwise
    consistent with the lvps the resolve uses). No per-cascade 4x4
    transform, no w division (ortho w == 1), no near clip. Fields come
    out corner-major (3, C*T) / (C*T,) — T stays in the minor dim
    throughout (see setup_triangles_planes) — ready for one binning pass."""
    c = projs.shape[0]
    t = lx.shape[1]
    size = jnp.array(sizes, jnp.float32).reshape(1, c, 1)     # (1, C, 1)
    xoff = jnp.array([o[0] for o in offsets],
                     jnp.float32).reshape(1, c, 1)
    yoff = jnp.array([o[1] for o in offsets],
                     jnp.float32).reshape(1, c, 1)
    p = lambda i, j: projs[:, i, j].reshape(1, c, 1)

    x = lx[:, None, :]                                         # (3, 1, T)
    y = ly[:, None, :]
    zl = lz[:, None, :]
    # ndc = diag(p00, p11, p22) * ls + (p03, p13, p23); fold the viewport
    # into the affine: sx = (ndc_x*0.5 + 0.5)*size + xoff
    sx = x * (p(0, 0) * 0.5 * size) + (p(0, 3) * 0.5 + 0.5) * size + xoff
    sy = y * (-p(1, 1) * 0.5 * size) + (0.5 - p(1, 3) * 0.5) * size + yoff
    z = zl * p(2, 2) + p(2, 3)                                 # (3, C, T)

    ax = sx[1] - sx[0]                                         # (C, T)
    ay = sy[1] - sy[0]
    bx = sx[2] - sx[0]
    by = sy[2] - sy[0]
    area = ax * by - ay * bx
    front = area < -1e-8

    xmin = jnp.min(sx, axis=0)                                 # (C, T)
    xmax = jnp.max(sx, axis=0)
    ymin = jnp.min(sy, axis=0)
    ymax = jnp.max(sy, axis=0)
    # per-cascade viewport cull: this IS the per-cascade caster culling
    # (mesh.cpp:795-847 culls per cascade frustum) — triangles outside a
    # cascade's ortho bounds never reach binning for that cascade
    x0 = xoff[0]
    y0 = yoff[0]
    s2 = size[0]
    on_screen = ((xmax >= x0) & (xmin < x0 + s2)
                 & (ymax >= y0) & (ymin < y0 + s2))

    valid = tri_valid[None, :] & front & on_screen             # (C, T)
    flat = lambda a: a.reshape((c * t,))
    return {
        "sx": sx.reshape(3, c * t), "sy": sy.reshape(3, c * t),
        "z": z.reshape(3, c * t),
        "inv_area": flat(
            jnp.where(valid, 1.0 / jnp.where(front, -area, 1.0), 0.0)),
        "xmin": flat(xmin), "xmax": flat(xmax),
        "ymin": flat(ymin), "ymax": flat(ymax),
        "valid": flat(valid),
    }


def light_planes(pos_planes: Tuple[Array, Array, Array],
                 light: Dict[str, Array]) -> Tuple[Array, Array, Array]:
    """World corner planes (3 x (3, T)) -> SHARED light-view planes: ONE
    transform for all cascades (fit_cascades); per-cascade coords are the
    affine maps of _setup_cascades. Unrolled per component (see
    math3d.apply_mat4 notes)."""
    px, py, pz = pos_planes
    v = light["view"]
    return tuple(v[i, 0] * px + v[i, 1] * py + v[i, 2] * pz + v[i, 3]
                 for i in range(3))


def atlas_depth_inputs(
    lplanes: Tuple[Array, Array, Array],
    mask: Array,               # (T,) casters for this atlas
    light: Dict[str, Array],
    cfg: ShadowConfig,
    max_per_tile: int = 256,
    translucent: bool = False,
) -> Dict[str, Any]:
    """Setup + binning of one cascade-atlas pass: the keyword arguments
    of raster.rasterize_depth (setup, tile_tris, counts, big_list, width,
    height, tile, atlas_bounds, tri_atlas, tile_h). `translucent` bins for
    the ordered tint blend too: id-ordered slot lists at half capacity."""
    sizes, offsets, atlas_w, atlas_h = cascade_layout(cfg)
    c_count = light["projs"].shape[0]
    t = lplanes[0].shape[1]
    bounds = tuple((offsets[ci][0], offsets[ci][0] + sizes[ci],
                    offsets[ci][1], offsets[ci][1] + sizes[ci])
                   for ci in range(c_count))
    with jax.named_scope("setup"):
        setup = _setup_cascades(*lplanes, mask, sizes, offsets,
                                light["projs"])
    # NOTE on early-z ordering: binning depth-ordered (front-to-back from
    # the light) to drive raster._depth_kernel's early-z termination costs
    # a rank scatter + inverse gather, and on the dense-pile flagship gap
    # pixels see the ground plane between casters, which keeps every
    # tile's near coverage incomplete. The kernel keeps the termination
    # (free when bins are unordered) for scenes that do cover.
    th = cfg.atlas_tile_h or 128
    cap = max(64, (max_per_tile * th // 128) // 16 * 16)
    fy = cfg.atlas_foot_y or max(2, min(8, 256 // th))
    with jax.named_scope("bin"):
        # the opaque depth raster reduces per pixel order-independently,
        # so a 2x2 footprint qualifies for corner binning: ONE sorted entry
        # per caster instead of foot*foot_y slot copies. Light-space ground
        # and other large casters ride the big list, which every atlas
        # tile draws.
        if translucent:
            tiles, counts, big = raster.bin_triangles(
                setup, atlas_w, atlas_h, 128, max(32, cap // 2), foot=2,
                tile_h=th, foot_y=fy)
        elif fy == 2:
            tiles, counts, big = raster.bin_triangles_corner(
                setup, atlas_w, atlas_h, 128, cap, max_big=256, tile_h=th)
        else:
            tiles, counts, big = raster.bin_triangles(
                setup, atlas_w, atlas_h, 128, cap, foot=2, max_big=256,
                tile_h=th, foot_y=fy)
    return dict(setup=setup, tile_tris=tiles, counts=counts, big_list=big,
                width=atlas_w, height=atlas_h, tile=128,
                atlas_bounds=bounds,
                tri_atlas=jnp.repeat(jnp.arange(c_count, dtype=jnp.int32), t),
                tile_h=th)


def render_cascades(
    world_positions: Array,
    indices: Array,
    tri_valid: Array,
    light: Dict[str, Array],   # fit_cascades output (shared view + crops)
    cfg: ShadowConfig,
    max_per_tile: int = 256,
    tri_world: Array = None,
    tri_translucent: Array = None,
    tri_tint: Array = None,
    pos_planes: Tuple[Array, Array, Array] = None,
) -> Tuple[Array, Optional[Array]]:
    """Shadow raster for all cascades -> (depth_atlas, trans_atlas):
    depth_atlas (H, W) = opaque reverse-Z depth (the D16 map, csm.hpp:56-64)
    in the cascade-atlas layout of `cascade_layout`; trans_atlas (H, W, 4) =
    translucent caster transmittance tint rgb + nearest translucent caster
    depth (the sRGB translucent map — sunlight through tinted glass), or
    None for opaque-only scenes.

    pos_planes: per-component (3, T) world corner planes
    (mesh.transform_triangle_planes) — the preferred input.
    tri_world: (T, 3, 3) fallback (converted to planes).
    tri_translucent/tri_tint enable the translucent map ((T,) mask +
    (T, 4) rgba); omitted = opaque only."""
    if pos_planes is None:
        if tri_world is None:
            tri_world = world_positions[indices]         # (T, 3, 3)
        pos_planes = tuple(jnp.transpose(tri_world[..., i])
                           for i in range(3))            # 3 x (3, T)
    with_trans = tri_translucent is not None and tri_tint is not None
    lplanes = light_planes(pos_planes, light)
    opaque_mask = tri_valid & (~tri_translucent if with_trans
                               else jnp.ones_like(tri_valid))
    opaque = atlas_depth_inputs(lplanes, opaque_mask, light, cfg,
                                max_per_tile)
    with jax.named_scope("raster"):
        depth_atlas = raster.rasterize_depth(**opaque)

    trans_atlas = None
    if with_trans:
        trans = atlas_depth_inputs(lplanes, tri_valid & tri_translucent,
                                   light, cfg, max_per_tile,
                                   translucent=True)
        tdepth = raster.rasterize_depth(**trans)
        # transmitted tint: translucent casters blend src-over onto a
        # fully-lit white background in bin order, z-tested against the
        # opaque depth (only casters the sun reaches matter)
        c_count = light["projs"].shape[0]
        atlas_w, atlas_h = trans["width"], trans["height"]
        tint = raster.rasterize_sorted_blend(
            trans["setup"], jnp.tile(tri_tint, (c_count, 1)),
            trans["tile_tris"], trans["counts"], trans["big_list"],
            depth_atlas, jnp.ones((atlas_h, atlas_w, 3), jnp.float32),
            atlas_w, atlas_h, 128, atlas_bounds=trans["atlas_bounds"],
            tri_atlas=trans["tri_atlas"], tile_h=trans["tile_h"])
        trans_atlas = jnp.concatenate([tint, tdepth[..., None]], axis=-1)
    return depth_atlas, trans_atlas


def _project_cascades(
    position: Array,        # (h, w, 3) biased world positions
    view_depth: Array,      # (h, w)
    light: Dict[str, Array],  # fit_cascades output
    cfg: ShadowConfig,
    splits: List[float],
) -> Tuple[Array, Array, Array, Array]:
    """Per-pixel atlas (u, v), reverse-Z compare depth z, and validity.

    ONE dense transform to the shared light view, then every cascade is
    an affine map of it (selected by view distance) — no (h, w)-indexed
    gather of per-pixel matrices, and a third of the transform work of
    per-cascade 4x4 einsums."""
    sizes, offsets, _, _ = cascade_layout(cfg)
    projs = light["projs"]
    c_count = len(sizes)
    cascade = jnp.zeros_like(view_depth, dtype=jnp.int32)
    for i in range(1, c_count):
        cascade = jnp.where(view_depth > splits[i], i, cascade)

    ls = m3.einsum("ij,hwj->hwi", light["view"][:3, :3], position) \
        + light["view"][:3, 3]
    u = jnp.zeros_like(view_depth)
    v = jnp.zeros_like(view_depth)
    z = jnp.zeros_like(view_depth)
    inside = jnp.zeros_like(view_depth, dtype=bool)
    for i in range(c_count):
        s_i = float(sizes[i])
        x_i = float(offsets[i][0])
        y_i = float(offsets[i][1])
        # ortho rows: ndc = diag(p00, p11, p22) * ls + (p03, p13, p23)
        u_i = (ls[..., 0] * projs[i, 0, 0] + projs[i, 0, 3]) \
            * (0.5 * s_i) + (0.5 * s_i + x_i)
        v_i = (ls[..., 1] * projs[i, 1, 1] + projs[i, 1, 3]) \
            * (-0.5 * s_i) + (0.5 * s_i + y_i)
        z_i = ls[..., 2] * projs[i, 2, 2] + projs[i, 2, 3]
        sel = cascade == i
        u = jnp.where(sel, u_i, u)
        v = jnp.where(sel, v_i, v)
        z = jnp.where(sel, z_i, z)
        inside |= sel & ((u_i >= x_i + 1) & (u_i < x_i + s_i - 1)
                         & (v_i >= y_i + 1) & (v_i < y_i + s_i - 1))
    ok = inside & (view_depth < splits[-1])
    return u, v, z + cfg.bias_constant, ok


def resolve_shadow(
    position: Array,         # (H, W, 3) world positions
    normal: Array,           # (H, W, 3)
    view_depth: Array,       # (H, W) distance from camera (for cascade pick)
    depth_atlas: Array,      # (Ha, Wa) opaque cascade-atlas depth
    trans_atlas: Optional[Array],  # (Ha, Wa, 4) tint+depth, or None
    light: Dict[str, Array],  # fit_cascades output (shared view + crops)
    cfg: ShadowConfig,
    splits: List[float],
    light_dir: Array,
) -> Array:
    """PCF shadow factor (H, W, 3), (1,1,1) = fully lit: the scalar opaque
    factor times the translucent casters' transmittance tint (the csm.gsl
    resolve + translucent-map modulation)."""
    atlas_w = depth_atlas.shape[1]

    # decimated resolve: the shadow-map lookup gather is latency-bound per
    # pixel, so
    # the compare tap runs every `resolve_step` pixels and the factor
    # upsamples DEPTH-GUIDED (joint bilateral) so silhouettes stay crisp
    # at geometry edges. The translucent tint map is low-frequency and
    # always resolves at >= quarter density.
    step = max(int(getattr(cfg, "resolve_step", 1)), 1)
    full_shape = position.shape[:2]
    view_depth_full = view_depth
    if step > 1:
        from garden_tpu.ops.blur import decimate2x
        # power-of-two knob (validated in ShadowConfig): each level is one
        # 2x decimation, so step=2 -> 1 level, 4 -> 2, 8 -> 3
        for _ in range(int(np.log2(step))):
            position = decimate2x(position)
            normal = decimate2x(normal)
            view_depth = decimate2x(view_depth)

    # normal-offset bias (csm.hpp bias settings)
    offset_pos = position + normal * cfg.bias_normal
    u, v, z, ok = _project_cascades(offset_pos, view_depth,
                                    light, cfg, splits)
    flat = jnp.clip(v.astype(jnp.int32), 0, depth_atlas.shape[0] - 1) \
        * atlas_w + jnp.clip(u.astype(jnp.int32), 0, atlas_w - 1)

    # single shadow-map tap + screen-space 3x3 smoothing of the binary
    # factor: per-pixel gathers are the expensive op, so the PCF softening
    # moves from light space (9 gathers) to screen space (8 dense shifted
    # adds) — visually equivalent for small radii.
    # reverse-Z: lenient compare (z + bias >= occ) prevents self-shadow acne
    occ = depth_atlas.reshape(-1)[flat]
    lit = jnp.where(z >= occ, 1.0, 0.0)
    lit = jnp.where(ok, lit, 1.0)

    if trans_atlas is not None:
        # translucent modulation at quarter density (the tint map is
        # low-frequency): recompute the projection on further-decimated
        # positions — strided slices of the full-res index arrays lower to
        # gathers; dense decimation + a small re-projection is cheap
        from garden_tpu.ops.blur import decimate2x
        tsub = max(4 // step, 1)
        if tsub > 1:
            pos_t, nrm_t, vd_t = position, normal, view_depth
            for _ in range(int(np.log2(tsub))):
                pos_t = decimate2x(pos_t)
                nrm_t = decimate2x(nrm_t)
                vd_t = decimate2x(vd_t)
            u_t, v_t, z_t, ok_t = _project_cascades(
                pos_t + nrm_t * cfg.bias_normal, vd_t,
                light, cfg, splits)
            flat_t = jnp.clip(v_t.astype(jnp.int32), 0,
                              depth_atlas.shape[0] - 1) * atlas_w \
                + jnp.clip(u_t.astype(jnp.int32), 0, atlas_w - 1)
        else:
            flat_t, z_t, ok_t = flat, z, ok
        trow = trans_atlas.reshape(-1, 4)[flat_t]
        tint_lo = jnp.where(((z_t < trow[..., 3]) & ok_t)[..., None],
                            trow[..., 0:3], 1.0)
        if tsub > 1:
            tint = jnp.repeat(jnp.repeat(tint_lo, tsub, axis=0),
                              tsub, axis=1)
            tint = tint[:lit.shape[0], :lit.shape[1]]
        else:
            tint = tint_lo
    else:
        tint = 1.0

    r = cfg.pcf_radius
    if r > 0:
        lit_at = Shifter(lit, r, r)  # pad once; each PCF tap is one slice
        acc = jnp.zeros_like(lit)
        n = 0
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                acc = acc + lit_at(dy, dx)
                n += 1
        lit = acc / n
    lit = lit[..., None] * tint               # (h, w, 3)
    if step > 1:
        from garden_tpu.ops.blur import bilateral_upsample_to
        # depth-guided upsample: crisp shadow silhouettes at depth edges
        lit = bilateral_upsample_to(lit, view_depth, view_depth_full,
                                    full_shape[0], full_shape[1])
    return lit
