"""Weighted-blended order-independent transparency.

Rebuild of OitRenderSystem (include/garden/system/render/oit.hpp:38,
shaders/oit.frag — McGuire/Bavoil weighted-blended OIT): translucent
geometry rasterizes into an accumulation buffer (premultiplied color *
depth-weight) and a reveal buffer (product of 1-alpha); a fullscreen
composite blends over the opaque HDR. No sorting needed — the weight
function handles ordering approximately, which is why the reference pairs
it with back-to-front sorted translucency only for refractive cases.

The plain-XLA raster mirrors the sorted blend but accumulates instead of
depth-testing (translucents never write depth, they test against the opaque
depth buffer). The sums and the reveal product do not depend on order, so
there is no kernel: one loop over list slots with every tile's pixels in one
array.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from garden_tpu.render import raster

Array = jnp.ndarray


def rasterize_oit(
    setup: Dict[str, Array],
    tri_colors: Array,      # (T, 4) premultiplied-ready rgba per triangle
    tile_tris: Array,
    counts: Array,
    opaque_depth: Array,    # (H, W)
    width: int,
    height: int,
    tile: int,
    tile_h: int = None,
) -> Tuple[Array, Array]:
    """Returns (accum (H, W, 4), reveal (H, W)). tile_tris/counts are one
    flat list per tile (raster.merge_big_list)."""
    th = tile_h or tile
    # pack records densely FIRST, fetch with one row gather
    t_count = setup["valid"].shape[0]
    sx, sy, z = setup["sx"], setup["sy"], setup["z"]    # (3, T) corner-major
    xy = jnp.stack([sx[0], sy[0], sx[1], sy[1], sx[2], sy[2]], axis=-1)
    records = jnp.concatenate(
        [xy, jnp.stack([z[0], z[1], z[2]], axis=-1),
         setup["inv_area"][:, None], tri_colors,
         jnp.zeros((t_count, 2), jnp.float32)],
        axis=-1,
    )  # (T, 16)
    # all-zero sentinel row for empty (-1) slots: alpha 0 accumulates
    # nothing (mapping holes to record 0 double-counted triangle 0)
    records = jnp.concatenate(
        [records, jnp.zeros((1, 16), jnp.float32)], axis=0)
    live = jnp.arange(tile_tris.shape[1])[None, :] < counts[:, None]
    data = records[jnp.where(live & (tile_tris >= 0), tile_tris, t_count)]

    px, py = raster.tiled_pixel_centres(width, height, tile, th)
    opaque = raster.image_to_tiles(opaque_depth, tile, th, fill=2.0)

    def body(s, carry):
        acc, reveal = carry
        d = jax.lax.dynamic_index_in_dim(data, s, axis=1, keepdims=False)
        f = lambda k: d[:, k:k + 1]                      # (tiles, 1)
        x0, y0, x1, y1, x2, y2 = (f(k) for k in range(6))
        e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1)
        e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2)
        e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0)
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
        zp = (e0 * f(9)) * f(6) + (e1 * f(9)) * f(7) + (e2 * f(9)) * f(8)
        # visible if in front of the opaque surface (reverse-Z)
        vis = inside & (zp >= opaque) & (zp <= 1.0)
        alpha = f(13)
        # McGuire depth weight (oit.frag): nearer (larger reverse-Z) heavier
        wv = jnp.where(vis, jnp.clip(zp * zp * 10.0 + 0.01, 0.01, 30.0)
                       * alpha, 0.0)
        rgbw = jnp.concatenate([d[:, None, 10:13], jnp.ones_like(
            d[:, None, 0:1])], axis=-1)                  # (tiles, 1, 4)
        return (acc + rgbw * wv[..., None],
                reveal * jnp.where(vis, 1.0 - alpha, 1.0))

    n_px = px.shape[1]
    acc = jnp.zeros((px.shape[0], n_px, 4), jnp.float32)
    reveal = jnp.ones((px.shape[0], n_px), jnp.float32)
    acc, reveal = jax.lax.fori_loop(0, data.shape[1], body, (acc, reveal))
    return (raster.tiles_to_image(acc, width, height, tile, th),
            raster.tiles_to_image(reveal, width, height, tile, th))


def composite(hdr_opaque: Array, accum: Array, reveal: Array) -> Array:
    """Fullscreen OIT composite (oit.frag analog)."""
    avg_color = accum[..., :3] / jnp.maximum(accum[..., 3:4], 1e-5)
    any_frag = accum[..., 3] > 0.0
    out = avg_color * (1.0 - reveal[..., None]) + hdr_opaque * reveal[..., None]
    return jnp.where(any_frag[..., None], out, hdr_opaque)
