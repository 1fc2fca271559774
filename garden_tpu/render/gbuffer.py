"""Deferred G-buffer reconstruction from the visibility buffer.

Rebuild of the reference's G-buffer contents (DeferredRenderSystem layout,
include/garden/system/render/deferred.hpp:20-26,79-92) — the raster stage
only wrote (tri id, barycentrics, depth); this pass reconstructs per-pixel
shading inputs (visibility-buffer deferred shading).

Per-pixel gathers are the expensive op, so the pass does exactly ONE: all
per-triangle shading data (3 vertex normals, 3 uvs, material row, instance
id, previous-frame corners, 1/w) is packed into a (T, 36) record at frame
start and fetched per pixel in a single row gather `records[tri_id]` (the
flagship's record table is ~20 MB and stays in the GPU's L2). World
position is NOT gathered at all — it reconstructs from the depth buffer and
the inverse view-projection, the classic deferred trick.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax.numpy as jnp

from garden_tpu.core import math3d as m3

Array = jnp.ndarray

# record layout: [n0 n1 n2 (9) | uv x3 (6) | material (9) | base-texture (1)
# | instance (1) | prev-screen x3 (6) | inv_w (3) | pad] — inv_w rides the
# record so perspective correction needs no second per-pixel gather
REC_WIDTH = 36


def pack_triangle_records(scene: Dict[str, Array],
                          world_normals: Optional[Array] = None,
                          prev_screen: Optional[Array] = None,
                          inv_w: Optional[Array] = None,
                          tri_normals: Optional[Array] = None,
                          prev_screen_tri: Optional[Array] = None,
                          tri_instance_np=None) -> Array:
    """(T, 32) per-triangle shading records: [n0 n1 n2 (9) | uv0 uv1 uv2 (6)
    | material row (10) | instance (1) | prev screen xy x3 (6)].

    tri_normals: (T, 3, 3) per-triangle world normals (from
    mesh.transform_triangles) — preferred: the vertex-pool fallback
    world_normals[indices] is a (T*3)-row gather.

    prev_screen / prev_screen_tri: previous-frame screen positions per
    vertex (V, 2) or per triangle corner (T, 3, 2). Riding them in the
    record makes per-pixel velocity a barycentric interpolation — no
    extra per-pixel gathers (the velocity pass analog of
    deferred.cpp:463-489)."""
    idx = scene["indices"]                       # (T, 3)
    n = (tri_normals if tri_normals is not None
         else world_normals[idx])                # (T, 3, 3)
    uv = scene.get("tri_uvs")                    # precomputed static
    if uv is None:
        uv = scene["uvs"][idx]                   # (T, 3, 2)
    inst = jnp.maximum(scene["tri_instance"], 0)
    mat = None
    if tri_instance_np is not None:
        # blocked scenes: ONE (I,)-row material gather + a dense
        # instance->triangle broadcast replaces the (T,)-row gather pair
        # (mesh.expand_instance_to_tris)
        from garden_tpu.render.mesh import expand_instance_to_tris
        mat_inst = scene["materials"][scene["inst_material"]]   # (I, 12)
        mat = expand_instance_to_tris(mat_inst, tri_instance_np,
                                      int(idx.shape[0]))
    if mat is None:
        mat_id = scene["inst_material"][inst]
        mat = scene["materials"][mat_id]         # (T, 12)
    t = idx.shape[0]
    if prev_screen_tri is not None:
        prev = prev_screen_tri.reshape(-1, 6)
    elif prev_screen is not None:
        prev = prev_screen[idx].reshape(-1, 6)
    else:
        prev = jnp.zeros((t, 6), jnp.float32)
    if inv_w is None:
        inv_w_c = jnp.zeros((t, 3), jnp.float32)
    elif inv_w.shape[0] == 3 and inv_w.shape != (t, 3):
        # corner-major (3, T) planes (setup_triangles_planes) -> rows
        inv_w_c = jnp.stack([inv_w[0], inv_w[1], inv_w[2]], axis=-1)
    else:
        inv_w_c = inv_w
    parts = [
        n.reshape(-1, 9),
        uv.reshape(-1, 6),
        mat[:, :9],                              # props (alpha is OIT-only)
        mat[:, 10:11],                           # base-texture index
        scene["tri_instance"].astype(jnp.float32)[:, None],
        prev,
        inv_w_c,
    ]
    rec = jnp.concatenate(parts, axis=-1)
    pad = REC_WIDTH - rec.shape[-1]
    return jnp.pad(rec, ((0, 0), (0, pad)))


def reconstruct_position(depth: Array, constants: Dict[str, Array]) -> Array:
    """World position from reverse-Z depth + inverse view-projection.

    Unrolled per-component: the einsum form lowers to a (HW, 4) x (4, 4)
    dot_general over the whole frame; the unrolled fma chain fuses into
    its consumers."""
    h, w = depth.shape
    x = ((jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 - 1.0)[None, :]
    y = (1.0 - (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * 2.0)[:, None]
    d = jnp.maximum(depth, 1e-9)
    m = constants["inv_view_proj"]
    comps = [m[i, 0] * x + m[i, 1] * y + m[i, 2] * d + m[i, 3]
             for i in range(4)]
    inv_w4 = 1.0 / jnp.maximum(comps[3], 1e-9)
    return jnp.stack([comps[0] * inv_w4, comps[1] * inv_w4,
                      comps[2] * inv_w4], axis=-1)


def shade_gbuffer(
    vis: Dict[str, Array],
    setup: Dict[str, Array],
    scene: Dict[str, Array],
    world_positions: Array,   # (V, 3) kept for API compat (unused)
    world_normals: Array,     # (V, 3)
    constants: Optional[Dict[str, Array]] = None,
    records: Optional[Array] = None,
    with_velocity: bool = False,
    textures: Optional[Array] = None,
) -> Dict[str, Array]:
    """Reconstruct per-pixel attributes -> G-buffer planes (H, W, C).

    records: (T, REC_WIDTH) pack_triangle_records output; built here from
    the scene when omitted."""
    tri = jnp.maximum(vis["tri_id"], 0)          # (H, W)
    visible = vis["tri_id"] >= 0

    if records is None:
        records = pack_triangle_records(scene, world_normals,
                                        inv_w=setup["inv_w"])
    rec = records[tri]                           # (H, W, 36): the ONE gather
    ch = lambda a, b: rec[..., a:b]
    chs = lambda a: rec[..., a]

    b0 = vis["b0"]
    b1 = vis["b1"]
    b2 = 1.0 - b0 - b1

    # perspective-correct barycentrics: w_i = screen bary * (1/w_i), renorm;
    # inv_w rides the ONE record gather (slots 32:35)
    inv_w = ch(32, 35)
    pw = jnp.stack([b0, b1, b2], axis=-1) * inv_w
    pw = pw / jnp.maximum(jnp.sum(pw, axis=-1, keepdims=True), 1e-12)

    normal = m3.normalize(
        ch(0, 3) * pw[..., 0:1]
        + ch(3, 6) * pw[..., 1:2]
        + ch(6, 9) * pw[..., 2:3]
    )
    uv = (ch(9, 11) * pw[..., 0:1]
          + ch(11, 13) * pw[..., 1:2]
          + ch(13, 15) * pw[..., 2:3])

    if constants is not None:
        position = reconstruct_position(vis["depth"], constants)
        position = jnp.where(visible[..., None], position, 0.0)
    else:  # fallback: interpolate gathered vertex positions
        idx = scene["indices"][tri]
        vals = world_positions[idx]
        position = jnp.sum(vals * pw[..., None], axis=-2)

    tex_id = chs(24).astype(jnp.int32)
    inst = chs(25).astype(jnp.int32)

    base_color = ch(15, 18)
    if textures is not None and textures.shape[0] > 0:
        # base-color texture sample (resource.cpp image loads feeding the
        # deferred.hpp:20 base-color target): nearest-texel, one row gather;
        # untextured pixels keep the flat material color
        s = textures.shape[1]
        uvw = uv - jnp.floor(uv)                     # wrap
        tx = jnp.clip((uvw[..., 0] * s).astype(jnp.int32), 0, s - 1)
        ty = jnp.clip((uvw[..., 1] * s).astype(jnp.int32), 0, s - 1)
        flat = jnp.clip(tex_id, 0, textures.shape[0] - 1) * (s * s) \
            + ty * s + tx
        texel = textures.reshape(-1, 4)[flat]        # (H, W, 4)
        base_color = jnp.where((tex_id >= 0)[..., None],
                               base_color * texel[..., :3], base_color)

    g = {
        "visible": visible,
        "depth": vis["depth"],
        "position": position,
        "normal": normal,
        "uv": uv,
        "base_color": base_color,
        "metallic": chs(18),
        "roughness": chs(19),
        "emissive": ch(20, 23),
        "reflectance": chs(23),
        "instance": jnp.where(visible, inst, -1),
    }
    if with_velocity:
        # previous-frame screen position interpolated from the record
        # (RG16F velocity plane, deferred.hpp:79-92 / deferred.cpp:463-489).
        # Screen positions are affine in screen space, so SCREEN barycentrics
        # are the right weights here (perspective-corrected weights would
        # reintroduce the perspective divide and bias static pixels).
        prev_xy = (ch(26, 28) * b0[..., None]
                   + ch(28, 30) * b1[..., None]
                   + ch(30, 32) * b2[..., None])
        h, w = vis["depth"].shape
        cur_x = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5
        cur_y = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
        vel = jnp.stack(
            [jnp.broadcast_to(cur_x, vis["depth"].shape) - prev_xy[..., 0],
             jnp.broadcast_to(cur_y, vis["depth"].shape) - prev_xy[..., 1]],
            axis=-1)
        g["velocity"] = jnp.where(visible[..., None], vel, 0.0)
    return g
