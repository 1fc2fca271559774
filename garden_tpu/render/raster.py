"""Software rasterization: triangle setup, tile binning, Triton raster kernels.

The replacement for the reference's hardware raster draw path
(MeshRenderSystem's DrawIndexed commands into the G-buffer render pass,
mesh.cpp:556-719 + VulkanCommandBuffer replay). Architecture (CuRast-style
tiled software raster, see PAPERS.md):

1. `setup_triangles` (XLA): clip-space verts -> screen coords, reverse-Z
   depths, 1/w for perspective-correct interpolation, backface/near culls.
2. `bin_triangles` (XLA): each triangle emits (tile, tri) pairs for its
   screen-tile footprint (up to FOOT x FOOT tiles); one global sort by tile
   key; per-tile contiguous ranges found by searchsorted. Triangles with a
   bigger footprint go to a small 'big list' SHARED by every tile (one
   extra kernel block, drawn first) — fixed capacities everywhere,
   overflow drops triangles (back-to-front artifacts only, never OOM).
3. `rasterize_visibility` (Pallas through Triton, one program per
   sub-block of a screen tile): each program loops its tile's binned
   triangles (dynamic trip count), evaluates edge functions over its
   pixels, and keeps the nearest hit per pixel: a visibility buffer of
   (tri id, barycentrics, depth). Shading is deferred to a separate gather
   pass (render/gbuffer.py) so raster work is independent of material cost.

The visibility buffer replaces the reference's G-buffer *raster* stage; the
G-buffer itself is reconstructed in gbuffer.py. Depth-only rasterization for
shadow maps (`rasterize_depth`) is the same loop with a max-reduce. Each
kernel has a plain-XLA twin (`*_reference`) that evaluates every slot of
every tile; the ordered blend is plain XLA only.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from garden_tpu.ops.segments import run_edges as _run_edges

Array = jnp.ndarray

FOOT = 4  # max tile footprint edge for per-tile binning (else 'big list')
NEAR_EPS = 1e-6


def _interpret() -> bool:
    """Pallas kernels compile for the GPU through Triton; on the CPU (the
    test host) they run in the Pallas interpreter. Any other backend has
    no route and is an error, never a silent interpreter run."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no Pallas raster route for backend {backend!r}")


def setup_triangles(
    clip: Array,          # (V, 4) clip-space positions
    indices: Array,       # (T, 3)
    tri_valid: Array,     # (T,)
    width: int,
    height: int,
) -> Dict[str, Array]:
    """Screen-space triangle setup from a vertex pool (one (T,3) gather)."""
    return setup_triangles_tv(clip[indices], tri_valid, width, height)


def setup_triangles_tv(
    v: Array,             # (T, 3, 4) clip-space triangle vertices
    tri_valid: Array,     # (T,)
    width: int,
    height: int,
) -> Dict[str, Array]:
    """Screen-space triangle setup from pre-gathered triangle vertices.

    Multi-pass renderers (main + shadow cascades) should gather world-space
    triangle vertices ONCE and transform per pass instead of gathering
    clip[indices] per pass. Prefer setup_triangles_planes for corner-major
    clip components."""
    comps = tuple(jnp.transpose(v[..., i]) for i in range(4))   # (3, T) x4
    return setup_triangles_planes(*comps, tri_valid, width, height)


def setup_triangles_planes(
    cx: Array,            # (3, T) clip x per corner (corner-major)
    cy: Array,
    cz: Array,
    cw: Array,
    tri_valid: Array,     # (T,)
    width: int,
    height: int,
) -> Dict[str, Array]:
    """Screen-space setup from PER-COMPONENT clip planes.

    The 2-D per-corner fields (sx/sy/z/inv_w) keep T in the minor dim,
    so every elementwise op runs over contiguous triangle rows instead of
    a 3-wide corner axis."""
    # conservative near clip: reject triangles with any vertex behind the
    # near plane (finely tessellated scenes make this loss negligible)
    in_front = jnp.all(cw > NEAR_EPS, axis=0)
    w_safe = jnp.maximum(cw, NEAR_EPS)
    inv_w = 1.0 / w_safe                  # (3, T)
    sx = (cx * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - cy * inv_w * 0.5) * height   # y-down screen
    z = cz * inv_w                        # reverse-Z in [0, 1]

    # signed area in screen space; CCW meshes become CW after the y-flip,
    # so front faces have negative area here. Cull area >= 0 (backfaces).
    ax = sx[1] - sx[0]
    ay = sy[1] - sy[0]
    bx = sx[2] - sx[0]
    by = sy[2] - sy[0]
    area = ax * by - ay * bx
    front = area < -1e-8

    xmin = jnp.min(sx, axis=0)
    xmax = jnp.max(sx, axis=0)
    ymin = jnp.min(sy, axis=0)
    ymax = jnp.max(sy, axis=0)
    on_screen = (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)

    valid = tri_valid & in_front & front & on_screen
    # edges e_i sum to -area (positive for front faces); bary_i = e_i/(-area)
    return {
        "sx": sx, "sy": sy, "z": z, "inv_w": inv_w,   # (3, T) corner-major
        "inv_area": jnp.where(valid, 1.0 / jnp.where(front, -area, 1.0), 0.0),
        "xmin": xmin, "xmax": xmax, "ymin": ymin, "ymax": ymax,
        "valid": valid,
    }


def bin_triangles(
    setup: Dict[str, Array],
    width: int,
    height: int,
    tile: int,
    max_per_tile: int,
    max_big: int = 64,
    priority: Array = None,
    bucket_priority: Array = None,
    foot: int = None,
    tile_h: int = None,
    foot_y: int = None,
) -> Tuple[Array, ...]:
    """Returns (tile_tris (tiles, max_per_tile) int32 padded with -1,
    counts (tiles,) int32, big_list (max_big,) int32 padded with -1).
    tiles = tiles_y * tiles_x, row-major.

    Triangles whose tile footprint exceeds foot x foot_y go to the SHARED
    big list, which raster kernels read as one (B, 16) block instead of a
    per-tile prefix, so mostly-empty targets like the cascade atlas do not
    gather B big slots into every tile's records. Kernels draw the big
    block FIRST, so bin order = big, then grid.

    priority: optional int32[T] ordering key — entries within a tile come
    out sorted by ascending priority instead of triangle id (the
    back-to-front translucent sort, mesh.hpp:204; priorities must be a
    permutation of [0, T)). The big list stays in id order.

    bucket_priority: optional int32[T] COARSE ordering key in [0, 16):
    rides as 4 extra bits inside the packed binning sort, so tile entries
    come out bucket-ordered with NO argsort, NO inverse-permutation
    scatter and NO per-tile remap gather (the exact `priority` path costs
    all three). Right for order-as-a-HEURISTIC
    uses — the opaque front-to-back overflow-drop policy — not for
    correctness-ordered blending. Mutually exclusive with `priority`.

    tile_h: rectangular tiles (tile wide, tile_h tall; see tile_layout_ok).
    foot_y: y-footprint for short tiles (defaults to foot scaled so the
    covered pixel span matches the x span)."""
    FOOT = foot if foot is not None else globals()["FOOT"]
    th = tile_h or tile
    FOOT_Y = foot_y if foot_y is not None else FOOT
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    n_tiles = tiles_x * tiles_y
    t = setup["valid"].shape[0]

    tx0 = jnp.clip(jnp.floor(setup["xmin"] / tile).astype(jnp.int32), 0, tiles_x - 1)
    tx1 = jnp.clip(jnp.floor(setup["xmax"] / tile).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(setup["ymin"] / th).astype(jnp.int32), 0, tiles_y - 1)
    ty1 = jnp.clip(jnp.floor(setup["ymax"] / th).astype(jnp.int32), 0, tiles_y - 1)
    nx = tx1 - tx0 + 1
    ny = ty1 - ty0 + 1
    small = setup["valid"] & (nx <= FOOT) & (ny <= FOOT_Y)
    big = setup["valid"] & ~small

    # (tri, k) pair emission for small triangles, in (K, T) orientation:
    # T in the minor dim keeps every emission op over contiguous triangle
    # rows. Pair order changes, the sort canonicalizes it.
    k = jnp.arange(FOOT * FOOT_Y, dtype=jnp.int32)
    kx = k % FOOT
    ky = k // FOOT
    ptx = tx0[None, :] + kx[:, None]
    pty = ty0[None, :] + ky[:, None]
    pair_ok = (small[None, :] & (kx[:, None] < nx[None, :])
               & (ky[:, None] < ny[None, :]))
    # THREE key classes: tile keys, then a reserved BIG key (n_tiles) for
    # every slot of a big triangle, then the sentinel (n_tiles + 1). Big
    # triangles ride the SAME sort as a contiguous run of K identical
    # copies each — the big list falls out of the run by striding, with no
    # separate (T,)-wide top_k selection
    key = jnp.where(pair_ok, pty * tiles_x + ptx,
                    jnp.where(big[None, :], n_tiles, n_tiles + 1))
    key = key.reshape(-1)
    tri_of_pair = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.int32)[None, :], (FOOT * FOOT_Y, t)
    ).reshape(-1)

    # ONE single-operand sort of (key << bits | payload): applying an
    # argsort permutation would be two pair-count random gathers; the
    # packed sort gets key and payload ordered together
    if priority is None:
        payload = tri_of_pair
    else:  # emission is per-triangle-row: broadcast, don't gather
        payload = jnp.broadcast_to(
            priority[None, :], (FOOT * FOOT_Y, t)).reshape(-1)
    tri_bits = max(int(np.ceil(np.log2(max(t, 2)))), 1)
    bkt_bits = 0
    if bucket_priority is not None:
        assert priority is None, "priority and bucket_priority are exclusive"
        bkt_bits = 4
        # coarse order rides between tile key and triangle id
        key = (key << bkt_bits) | jnp.broadcast_to(
            jnp.clip(bucket_priority, 0, 15)[None, :],
            (FOOT * FOOT_Y, t)).reshape(-1)
    key_bits = max(int(np.ceil(np.log2(n_tiles + 3))), 1) + bkt_bits
    if tri_bits + key_bits <= 31:
        packed = jnp.sort((key << tri_bits) | payload)
        key_sorted = packed >> (tri_bits + bkt_bits)
        pay_sorted = packed & ((1 << tri_bits) - 1)
    else:  # huge scenes: variadic sort (no permutation gathers either);
        # payload is a SECONDARY key so equal-key runs come out
        # payload-ordered — the big-run striding below requires each big
        # triangle's K copies consecutive (the packed path has this by
        # construction)
        key_sorted, pay_sorted = jax.lax.sort(
            (key, payload), num_keys=2)
        key_sorted = key_sorted >> bkt_bits

    # start/end of each tile's contiguous run: keys are integers and the
    # queries are consecutive, so side-right(i) == side-left(i+1) — ONE
    # edge table of n_tiles+1 probes replaces the left+right pair, built
    # by _run_edges' dense two-level count (jnp.searchsorted lowers to a
    # while-loop binary search of ~21 serial steps; the dense count is a
    # few fused ops)
    edges = _run_edges(key_sorted, n_tiles + 2)
    start = edges[:n_tiles]
    end = edges[1:n_tiles + 1]
    big_run = (edges[n_tiles], edges[n_tiles + 1])
    take = jnp.arange(max_per_tile, dtype=jnp.int32)
    gather = start[:, None] + take[None, :]
    ok = gather < end[:, None]
    gather = jnp.clip(gather, 0, key.shape[0] - 1)
    tile_pay = pay_sorted[gather]                      # (tiles, C) small gather
    if priority is not None:
        # invert the priority permutation at tile-list granularity only
        inv = jnp.zeros((t,), jnp.int32).at[priority].set(
            jnp.arange(t, dtype=jnp.int32))
        tile_pay = inv[jnp.clip(tile_pay, 0, t - 1)]
    tile_tris = jnp.where(ok, tile_pay, -1)            # (tiles, C)
    counts = jnp.minimum(end - start, max_per_tile).astype(jnp.int32)

    # big triangles: fixed global list, shared across tiles — extracted
    # from the reserved-key run of the SAME sort. Each big triangle holds
    # K identical consecutive copies there (same packed key|payload), so
    # striding by K yields each once, ascending (id order with no
    # priority; back-to-front under `priority`, which is MORE correct for
    # the ordered-blend consumers than the old id-ordered top_k list)
    max_big = min(max_big, t)
    kk = FOOT * FOOT_Y
    big_cnt = (big_run[1] - big_run[0]) // kk
    pos = big_run[0] + jnp.arange(max_big, dtype=jnp.int32) * kk
    big_pay = pay_sorted[jnp.clip(pos, 0, key.shape[0] - 1)]
    if priority is not None:
        big_pay = inv[jnp.clip(big_pay, 0, t - 1)]
    big_list = jnp.where(jnp.arange(max_big) < big_cnt,
                         big_pay.astype(jnp.int32), -1)      # (B,)
    return tile_tris, counts, big_list


def bin_triangles_corner(
    setup: Dict[str, Array],
    width: int,
    height: int,
    tile: int,
    max_per_tile: int,
    max_big: int = 64,
    tile_h: int = None,
) -> Tuple[Array, ...]:
    """bin_triangles for ORDER-FREE consumers (depth-only raster), at a
    quarter of the sort cost: each small triangle is sorted ONCE by its
    TOP-LEFT tile instead of emitting foot*foot_y=4 slot copies, and each
    tile assembles its list from the 4 runs that can reach it (own,
    left, up, up-left) with dense run arithmetic + one payload gather.

    The footprint constraint is fixed at 2x2 tiles (the foot=2/foot_y=2
    configuration every cascade pass uses); larger triangles ride the
    shared big list exactly as in bin_triangles. Entries come out in
    (run, id) order — NOT globally id-sorted — which is only legal for
    consumers that reduce per pixel order-independently (rasterize_depth's
    max). On the flagship cascade atlas it sorts a quarter of the 1.48M
    slot copies.

    Returns the same tuple shapes as bin_triangles."""
    th = tile_h or tile
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    n_tiles = tiles_x * tiles_y
    t = setup["valid"].shape[0]

    tx0 = jnp.clip(jnp.floor(setup["xmin"] / tile).astype(jnp.int32),
                   0, tiles_x - 1)
    tx1 = jnp.clip(jnp.floor(setup["xmax"] / tile).astype(jnp.int32),
                   0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(setup["ymin"] / th).astype(jnp.int32),
                   0, tiles_y - 1)
    ty1 = jnp.clip(jnp.floor(setup["ymax"] / th).astype(jnp.int32),
                   0, tiles_y - 1)
    nx = tx1 - tx0 + 1
    ny = ty1 - ty0 + 1
    small = setup["valid"] & (nx <= 2) & (ny <= 2)
    big = setup["valid"] & ~small

    key = jnp.where(small, ty0 * tiles_x + tx0,
                    jnp.where(big, n_tiles, n_tiles + 1))
    tri_bits = max(int(np.ceil(np.log2(max(t, 2)))), 1)
    key_bits = max(int(np.ceil(np.log2(n_tiles + 3))), 1)
    ids = jnp.arange(t, dtype=jnp.int32)
    if tri_bits + key_bits <= 31:
        packed = jnp.sort((key << tri_bits) | ids)
        key_sorted = packed >> tri_bits
        pay_sorted = packed & ((1 << tri_bits) - 1)
    else:
        key_sorted, pay_sorted = jax.lax.sort((key, ids), num_keys=2)

    edges = _run_edges(key_sorted, n_tiles + 2)
    start = edges[:n_tiles]
    length = edges[1:n_tiles + 1] - start
    big_run = (edges[n_tiles], edges[n_tiles + 1])

    # the 4 runs that can contribute to tile k: own (k), left (k-1, only
    # when the tile is not in column 0), up (k-tiles_x), up-left; border
    # runs are masked to zero length instead of wrapping
    col0 = (jnp.arange(n_tiles, dtype=jnp.int32) % tiles_x) == 0
    row0 = jnp.arange(n_tiles, dtype=jnp.int32) < tiles_x

    def run(shift, dead):
        s = jnp.roll(start, shift)
        l = jnp.where(dead, 0, jnp.roll(length, shift))
        return s, l

    s0, l0 = start, length
    s1, l1 = run(1, col0)
    s2, l2 = run(tiles_x, row0)
    s3, l3 = run(tiles_x + 1, row0 | col0)

    # slot j of a tile's list walks the concatenation of the 4 runs:
    # dense 4-way select of (source position, required-footprint bits)
    c1 = l0 + l1
    c2 = c1 + l2
    c3 = c2 + l3
    j = jnp.arange(max_per_tile, dtype=jnp.int32)[None, :]   # (1, C)
    in0 = j < l0[:, None]
    in1 = (j >= l0[:, None]) & (j < c1[:, None])
    in2 = (j >= c1[:, None]) & (j < c2[:, None])
    in3 = (j >= c2[:, None]) & (j < c3[:, None])
    src = jnp.where(
        in0, s0[:, None] + j,
        jnp.where(in1, s1[:, None] + (j - l0[:, None]),
                  jnp.where(in2, s2[:, None] + (j - c1[:, None]),
                            s3[:, None] + (j - c2[:, None]))))
    any_run = in0 | in1 | in2 | in3
    pay = pay_sorted[jnp.clip(src, 0, t - 1)]                # (tiles, C)

    # coverage filter: an entry fetched from the left/up/up-left run only
    # covers this tile if its footprint extends right/down; footprint bits
    # ride a tiny (T,) side table fetched by the same indices
    fp = ((nx > 1).astype(jnp.int32)
          | ((ny > 1).astype(jnp.int32) << 1))               # (T,)
    fpe = fp[jnp.clip(pay, 0, t - 1)]                        # (tiles, C)
    need = (jnp.where(in1 | in3, 1, 0) | jnp.where(in2 | in3, 2, 0))
    covered = any_run & ((fpe & need) == need)

    # compact the holes (order-free consumers): ascending sort pushes
    # dropped slots (sentinel INT_MAX) to the tail, then -1 them
    slot_val = jnp.where(covered, pay, jnp.int32(2147483647))
    slot_val = jnp.sort(slot_val, axis=1)
    tile_tris = jnp.where(slot_val == 2147483647, -1, slot_val)
    counts = jnp.sum(covered.astype(jnp.int32), axis=1)

    max_big = min(max_big, t)
    big_cnt = big_run[1] - big_run[0]
    pos = big_run[0] + jnp.arange(max_big, dtype=jnp.int32)
    big_pay = pay_sorted[jnp.clip(pos, 0, t - 1)]
    big_list = jnp.where(jnp.arange(max_big) < big_cnt,
                         big_pay.astype(jnp.int32), -1)
    return tile_tris, counts, big_list


def merge_big_list(tile_tris: Array, counts: Array,
                   big_list: Array) -> Tuple[Array, Array]:
    """Prepend the shared big list to every tile's row — the pre-split
    combined format, for consumers that loop one flat per-tile list (OIT).
    Returns (tile_tris (tiles, B + C), counts including the big prefix)."""
    n_tiles = tile_tris.shape[0]
    b = big_list.shape[0]
    big_tile = jnp.broadcast_to(big_list[None, :], (n_tiles, b))
    merged = jnp.concatenate([big_tile, tile_tris], axis=1)
    big_n = jnp.sum(big_list >= 0)
    merged_counts = jnp.where(counts > 0, b + counts, big_n).astype(jnp.int32)
    return merged, merged_counts


def _pack_edge_records(setup: Dict[str, Array],
                       tri_atlas: Array = None) -> Array:
    """(T + 1, 16) per-triangle records in edge-COEFFICIENT form:
    [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | S | z2 | dz0 | dz1 | inv_area |
     tri_id | atlas].

    e_k(px, py) = a_k*px + b_k*py + c_k, and e0+e1+e2 = S (= -area,
    positive for front faces), so the raster inner loop is 2 FMAs per edge
    plus one subtraction for e2 — about half the per-(triangle, pixel)
    work of evaluating the three edge determinants from vertex positions.

    Row i carries its own id i in slot 14 (exact in f32 for ids < 2^24)
    and row T is a SENTINEL (id -1, inv_area 0): empty tile-list slots
    index the sentinel and rasterize nothing.

    Inputs are corner-major (3, T) planes (setup_triangles_planes); only
    the final record stack materializes the (T, 16) row layout the
    per-tile gather needs."""
    sx, sy, z = setup["sx"], setup["sy"], setup["z"]      # (3, T)
    a, b, c = [], [], []
    for k in range(3):
        x1, y1 = sx[(k + 1) % 3], sy[(k + 1) % 3]
        x2, y2 = sx[(k + 2) % 3], sy[(k + 2) % 3]
        a.append(y2 - y1)
        b.append(-(x2 - x1))
        c.append(y1 * (x2 - x1) - x1 * (y2 - y1))
    # S = e0 at v0 (e1, e2 vanish there)
    s_const = a[0] * sx[0] + b[0] * sy[0] + c[0]
    z2 = z[2]
    t_count = sx.shape[1]
    ids = jnp.arange(t_count, dtype=jnp.float32)
    atlas = (tri_atlas.astype(jnp.float32) if tri_atlas is not None
             else jnp.zeros((t_count,), jnp.float32))
    rec = jnp.stack(
        a + b + c + [s_const, z2, z[0] - z2, z[1] - z2,
                     setup["inv_area"], ids, atlas], axis=-1)   # (T, 16)
    sentinel = jnp.zeros((1, 16), jnp.float32).at[0, 14].set(-1.0)
    return jnp.concatenate([rec, sentinel], axis=0)       # (T + 1, 16)


def _safe_ids(tile_tris: Array, t_count: int) -> Array:
    """Map empty (-1) slots to the sentinel record row (index t_count)."""
    return jnp.where(tile_tris >= 0, tile_tris, t_count)


# -- tile geometry shared by the kernels and the plain forms ----------------

def tiled_pixel_centres(width: int, height: int, tile: int,
                        tile_h: int = None) -> Tuple[Array, Array]:
    """(px, py), each (tiles, th * tile): pixel centres of every bin tile,
    row-major within the tile, tiles row-major over the padded frame."""
    th = tile_h or tile
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    col = jnp.arange(tile, dtype=jnp.int32)
    row = jnp.arange(th, dtype=jnp.int32)
    tx = jnp.arange(tiles_x, dtype=jnp.int32)
    ty = jnp.arange(tiles_y, dtype=jnp.int32)
    shape = (tiles_y, tiles_x, th, tile)
    px = jnp.broadcast_to(
        (tx[None, :, None, None] * tile + col[None, None, None, :]), shape)
    py = jnp.broadcast_to(
        (ty[:, None, None, None] * th + row[None, None, :, None]), shape)
    n = tiles_x * tiles_y
    return (px.reshape(n, th * tile).astype(jnp.float32) + 0.5,
            py.reshape(n, th * tile).astype(jnp.float32) + 0.5)


def image_to_tiles(img: Array, tile: int, tile_h: int = None,
                   fill: float = 0.0) -> Array:
    """(H, W, ...) -> (tiles, th * tile, ...), padding the frame to whole
    tiles with `fill`."""
    th = tile_h or tile
    h, w = img.shape[:2]
    tiles_x = -(-w // tile)
    tiles_y = -(-h // th)
    rest = img.shape[2:]
    pad = ((0, tiles_y * th - h), (0, tiles_x * tile - w)) + ((0, 0),) * len(rest)
    img = jnp.pad(img, pad, constant_values=fill)
    img = img.reshape((tiles_y, th, tiles_x, tile) + rest)
    img = jnp.moveaxis(img, 2, 1)
    return img.reshape((tiles_x * tiles_y, th * tile) + rest)


def tiles_to_image(t: Array, width: int, height: int, tile: int,
                   tile_h: int = None) -> Array:
    """Inverse of image_to_tiles, cropped to (height, width, ...)."""
    th = tile_h or tile
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    rest = t.shape[2:]
    img = t.reshape((tiles_y, tiles_x, th, tile) + rest)
    img = jnp.moveaxis(img, 1, 2)
    img = img.reshape((tiles_y * th, tiles_x * tile) + rest)
    return img[:height, :width]


def _grid_slots(tile_tris: Array, counts: Array) -> Array:
    """Each tile's list with every slot at or past its count emptied."""
    c = tile_tris.shape[1]
    live = jnp.arange(c, dtype=jnp.int32)[None, :] < counts[:, None]
    return jnp.where(live, tile_tris, -1)


def _slot_records(records: Array, tile_tris: Array, counts: Array,
                  big_list: Array) -> Array:
    """(tiles, B + C, 16): each tile's records in raster order — the
    shared big list first, then the tile's own list; empty slots and
    slots past the count hold the sentinel row."""
    t_count = records.shape[0] - 1
    n_tiles = tile_tris.shape[0]
    big = jnp.broadcast_to(big_list[None, :], (n_tiles, big_list.shape[0]))
    slots = jnp.concatenate([big, _grid_slots(tile_tris, counts)], axis=1)
    return records[_safe_ids(slots, t_count)]


def _atlas_rect(idx, atlas_bounds: tuple):
    """Cascade-atlas clip rect (x0, x1, y0, y1) of atlas index `idx` (a
    float, scalar or array): a short select chain over the static
    `atlas_bounds` tuple (C is 2-4); an index outside it gets an empty
    rect. Clipped geometry extending past its cascade's ortho bounds must
    not bleed into a neighbour's atlas region."""
    x0a = x1a = y0a = y1a = jnp.zeros_like(idx)
    for ci, (x0, x1, y0, y1) in enumerate(atlas_bounds):
        m = idx == float(ci)
        x0a = jnp.where(m, float(x0), x0a)
        x1a = jnp.where(m, float(x1), x1a)
        y0a = jnp.where(m, float(y0), y0a)
        y1a = jnp.where(m, float(y1), y1a)
    return x0a, x1a, y0a, y1a


def _in_rect(px, py, rect):
    x0, x1, y0, y1 = rect
    return (px >= x0) & (px < x1) & (py >= y0) & (py < y1)


# -- Triton raster kernels ----------------------------------------------------
#
# A bin tile (tile wide, th tall) is cut into (bh, bw) sub-blocks of about
# _BLOCK_PX pixels; one program rasterizes one sub-block (8 pixels per
# thread at 4 warps, all state in registers) and walks its bin tile's list
# TRI_STEP slots per loop iteration, with a data-dependent trip count read
# from the tile's count. Programs run in no order, so every sub-block
# reads its tile's list itself; neighbours re-read it from L2. Records are
# gathered per tile in XLA first, so a slot's 16 floats are one 64-byte
# line.

_BLOCK_PX = 1024
_NUM_WARPS = 4
_NUM_STAGES = 2
TRI_STEP = 8  # list slots per loop iteration (unrolled); early-z granularity


def tile_layout_ok(tile: int, tile_h: int = None) -> bool:
    """Whether a raster tile layout lowers through Triton: block
    dimensions must be powers of two, so tile width and height must be.
    The frame itself need not be a tile multiple (outputs pad and crop)."""
    th = tile_h or tile
    return all(v > 0 and v & (v - 1) == 0 for v in (tile, th))


def _check_layout(fn: str, tile: int, th: int) -> None:
    if not tile_layout_ok(tile, th):
        raise ValueError(
            f"{fn}: tile={tile}x{th} is not a power-of-two layout "
            f"(Triton block dimensions are powers of two)")


def _block_shape(tile: int, th: int) -> Tuple[int, int]:
    bh = min(th, 32)
    return bh, min(tile, max(_BLOCK_PX // bh, 1))


def _pad_slots(tile_tris: Array) -> Array:
    """Pad the slot axis to a TRI_STEP multiple with empty slots, so a
    loop iteration never reads past the list."""
    c = tile_tris.shape[-1]
    pad = (-c) % TRI_STEP
    if not pad:
        return tile_tris
    widths = ((0, 0),) * (tile_tris.ndim - 1) + ((0, pad),)
    return jnp.pad(tile_tris, widths, constant_values=-1)


def _big_inputs(records: Array, big_list: Array) -> Tuple[Array, Array]:
    """(big_data (B_pad, 16), big_n (1,)) kernel inputs from the shared big
    list: B pads to a TRI_STEP multiple, holes hit the sentinel row, and
    big_n covers every slot up to the last live entry."""
    t_count = records.shape[0] - 1
    big_list = _pad_slots(big_list)
    big_data = records[_safe_ids(big_list, t_count)]
    pos = jnp.arange(1, big_list.shape[0] + 1, dtype=jnp.int32)
    big_n = jnp.max(jnp.where(big_list >= 0, pos, 0)).reshape(1)
    return big_data, big_n.astype(jnp.int32)


def _block_coords(tiles_x: int, sub_y: int, sub_x: int, bh: int, bw: int):
    """(bin tile index, px, py) of this program's (bh, bw) sub-block."""
    gy = pl.program_id(0)
    gx = pl.program_id(1)
    tile_idx = jax.lax.div(gy, sub_y) * tiles_x + jax.lax.div(gx, sub_x)
    row = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    px = (gx * bw + col).astype(jnp.float32) + 0.5
    py = (gy * bh + row).astype(jnp.float32) + 0.5
    return tile_idx, px, py


def _walk(load, n, hit, carry):
    """Fold `hit` over the first ceil(n / TRI_STEP) * TRI_STEP slots."""
    def body(g, carry):
        for u in range(TRI_STEP):
            carry = hit(carry, load(g * TRI_STEP + u))
        return carry

    groups = jax.lax.div(n + (TRI_STEP - 1), TRI_STEP)
    return jax.lax.fori_loop(0, groups, body, carry)


def _edges(d, px, py):
    """Edge values and screen barycentrics of record `d` (16 scalars) at
    the block's pixel centres."""
    e0 = d[0] * px + d[3] * py + d[6]
    e1 = d[1] * px + d[4] * py + d[7]
    e2 = d[9] - e0 - e1                    # e0+e1+e2 = S (= -area)
    b0 = e0 * d[13]
    b1 = e1 * d[13]
    z = d[10] + b0 * d[11] + b1 * d[12]
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
    # padded/invalid slots hit the sentinel record: tri_id < 0
    return inside & (z <= 1.0) & (d[14] >= 0.0), z, b0, b1


def _vis_kernel(counts_ref, data_ref, big_n_ref, big_ref,
                depth_ref, id_ref, b0_ref, b1_ref,
                *, tiles_x: int, sub_y: int, sub_x: int, bh: int, bw: int):
    """Visibility raster of one sub-block: nearest hit per pixel as
    (reverse-Z depth, tri id, screen barycentrics b0/b1). The shared big
    list draws first, then the tile's own list; a later slot replaces the
    running hit only when strictly nearer, so ties keep the first slot."""
    tile_idx, px, py = _block_coords(tiles_x, sub_y, sub_x, bh, bw)

    def hit(carry, d):
        depth, ids, b0s, b1s = carry
        cand, z, b0, b1 = _edges(d, px, py)
        keep = cand & (z > depth)
        return (jnp.where(keep, z, depth),
                jnp.where(keep, d[14].astype(jnp.int32), ids),
                jnp.where(keep, b0, b0s), jnp.where(keep, b1, b1s))

    zero = jnp.zeros((bh, bw), jnp.float32)
    carry = (zero, jnp.full((bh, bw), -1, jnp.int32), zero, zero)
    carry = _walk(lambda s: [big_ref[s, k] for k in range(15)],
                  big_n_ref[0], hit, carry)
    carry = _walk(lambda s: [data_ref[tile_idx, s, k] for k in range(15)],
                  counts_ref[tile_idx], hit, carry)
    depth_ref[...], id_ref[...], b0_ref[...], b1_ref[...] = carry


def _depth_kernel(counts_ref, data_ref, bound_ref, big_n_ref, big_ref,
                  depth_ref,
                  *, tiles_x: int, sub_y: int, sub_x: int, bh: int, bw: int,
                  atlas_bounds: tuple = ()):
    """Depth-only raster of one sub-block (shadow cascades): the edge loop
    of _vis_kernel with a plain max instead of the id/barycentric
    tracking. The shared big list draws first, then the tile's own list.

    EARLY-Z TERMINATION: `bound_ref[tile, g]` is the max reverse-Z depth
    any record of the tile's list groups g.. can reach (a suffix max built
    in rasterize_depth). Once every pixel of the sub-block is covered at
    z >= that bound, no remaining caster can win the max and the loop
    stops — bins ordered front-to-back from the light stop early."""
    tile_idx, px, py = _block_coords(tiles_x, sub_y, sub_x, bh, bw)
    n_rec = 16 if atlas_bounds else 15

    def hit(depth, d):
        cand, z, _, _ = _edges(d, px, py)
        if atlas_bounds:
            cand &= _in_rect(px, py, _atlas_rect(d[15], atlas_bounds))
        return jnp.where(cand & (z > depth), z, depth)

    depth = _walk(lambda s: [big_ref[s, k] for k in range(n_rec)],
                  big_n_ref[0], hit, jnp.zeros((bh, bw), jnp.float32))
    groups = jax.lax.div(counts_ref[tile_idx] + (TRI_STEP - 1), TRI_STEP)

    def cond(carry):
        g, done, _ = carry
        return (g < groups) & jnp.logical_not(done)

    def body(carry):
        g, _, depth = carry
        for u in range(TRI_STEP):
            s = g * TRI_STEP + u
            depth = hit(depth, [data_ref[tile_idx, s, k]
                                for k in range(n_rec)])
        done = jnp.min(depth) >= bound_ref[tile_idx, g + 1]
        return g + 1, done, depth

    _, _, depth = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.bool_(False), depth))
    depth_ref[...] = depth


def _raster_call(kernel, name: str, inputs, out_dtypes, *, width: int,
                 height: int, tile: int, th: int, **static):
    """Launch `kernel` over the (bh, bw) sub-blocks of the tile grid.
    Inputs are whole arrays the kernel indexes itself; outputs are
    (h_pad, w_pad) planes cropped to (height, width)."""
    tiles_x = -(-width // tile)
    tiles_y = -(-height // th)
    bh, bw = _block_shape(tile, th)
    sub_y, sub_x = th // bh, tile // bw
    out_spec = pl.BlockSpec((bh, bw), lambda gy, gx: (gy, gx))
    outs = pl.pallas_call(
        functools.partial(kernel, tiles_x=tiles_x, sub_y=sub_y, sub_x=sub_x,
                          bh=bh, bw=bw, **static),
        grid=(tiles_y * sub_y, tiles_x * sub_x),
        in_specs=[pl.BlockSpec() for _ in inputs],
        out_specs=tuple(out_spec for _ in out_dtypes),
        out_shape=tuple(
            jax.ShapeDtypeStruct((tiles_y * th, tiles_x * tile), dt)
            for dt in out_dtypes),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=_NUM_STAGES),
        interpret=_interpret(),
        name=name,
    )(*inputs)
    return [o[:height, :width] for o in outs]


def rasterize_visibility(
    setup: Dict[str, Array],
    tile_tris: Array,   # (tiles, C)
    counts: Array,      # (tiles,)
    big_list: Array,    # (B,) shared big-triangle list
    width: int,
    height: int,
    tile: int,
    tile_h: int = None,
) -> Dict[str, Array]:
    """Visibility buffer: depth (H,W) reverse-Z, tri id (H,W), screen
    barycentrics b0/b1 (H,W). See _vis_kernel; the plain form is
    rasterize_visibility_reference."""
    th = tile_h or tile
    _check_layout("rasterize_visibility", tile, th)
    records = _pack_edge_records(setup)                     # (T + 1, 16)
    t_count = records.shape[0] - 1
    tile_tris = _pad_slots(_grid_slots(tile_tris, counts))
    data = records[_safe_ids(tile_tris, t_count)]           # (tiles, C, 16)
    big_data, big_n = _big_inputs(records, big_list)
    depth, tri_id, b0, b1 = _raster_call(
        _vis_kernel, "raster_visibility",
        (counts.astype(jnp.int32), data, big_n, big_data),
        (jnp.float32, jnp.int32, jnp.float32, jnp.float32),
        width=width, height=height, tile=tile, th=th)
    return {"depth": depth, "tri_id": tri_id, "b0": b0, "b1": b1}


def _early_z_bound(data: Array, tile_tris: Array) -> Array:
    """(tiles, G + 1) early-z table for _depth_kernel: entry g is the max
    reverse-Z any record of slot groups g.. can reach (zmax = z2 +
    max(dz0, dz1, 0), record cols 10-12); the last column is -1."""
    n_tiles, c = tile_tris.shape
    rec_zmax = data[:, :, 10] + jnp.maximum(
        jnp.maximum(data[:, :, 11], data[:, :, 12]), 0.0)
    rec_zmax = jnp.where(tile_tris >= 0, rec_zmax, -1.0)
    grp = rec_zmax.reshape(n_tiles, c // TRI_STEP, TRI_STEP).max(axis=2)
    suffix = jnp.flip(jax.lax.cummax(jnp.flip(grp, 1), axis=1), 1)
    return jnp.concatenate(
        [suffix, jnp.full((n_tiles, 1), -1.0, jnp.float32)], axis=1)


def rasterize_depth(
    setup: Dict[str, Array],
    tile_tris: Array,
    counts: Array,
    big_list: Array,
    width: int,
    height: int,
    tile: int,
    atlas_bounds: tuple = (),
    tri_atlas: Array = None,
    tile_h: int = None,
) -> Array:
    """Depth-only raster (shadow maps: the CSM cascade passes,
    csm.hpp:36-64) via _depth_kernel. `atlas_bounds` (per-cascade
    (x0, x1, y0, y1) rects) + `tri_atlas` enable the cascade-atlas guard
    (see _atlas_rect). The plain form is rasterize_depth_reference."""
    th = tile_h or tile
    _check_layout("rasterize_depth", tile, th)
    records = _pack_edge_records(setup, tri_atlas)
    t_count = records.shape[0] - 1
    tile_tris = _pad_slots(_grid_slots(tile_tris, counts))
    data = records[_safe_ids(tile_tris, t_count)]
    big_data, big_n = _big_inputs(records, big_list)
    (depth,) = _raster_call(
        _depth_kernel, "raster_depth",
        (counts.astype(jnp.int32), data, _early_z_bound(data, tile_tris),
         big_n, big_data),
        (jnp.float32,),
        width=width, height=height, tile=tile, th=th,
        atlas_bounds=tuple(atlas_bounds))
    return depth


# -- plain references ----------------------------------------------------------
#
# Written apart from the kernels: for each tile, every slot of its list
# (big list first) is evaluated in order over the tile's pixels, with no
# early exit, as one (slots, pixels) array per tile. lax.map bounds the
# live set to `batch` tiles.

def _reference_tiles(setup, tile_tris, counts, big_list, width, height,
                     tile, th, tri_atlas=None):
    records = _pack_edge_records(setup, tri_atlas)
    data = _slot_records(records, tile_tris, counts, big_list)
    px, py = tiled_pixel_centres(width, height, tile, th)
    return data, px, py


def _reference_edges(d, px, py):
    """Per-(slot, pixel) candidate mask, depth and barycentrics."""
    col = lambda k: d[:, k:k + 1]                       # (S, 1)
    e0 = col(0) * px[None, :] + col(3) * py[None, :] + col(6)
    e1 = col(1) * px[None, :] + col(4) * py[None, :] + col(7)
    e2 = col(9) - e0 - e1
    b0 = e0 * col(13)
    b1 = e1 * col(13)
    z = col(10) + b0 * col(11) + b1 * col(12)
    cand = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z <= 1.0) & (z > 0.0)
            & (col(14) >= 0.0))
    return cand, z, b0, b1


def rasterize_visibility_reference(
    setup: Dict[str, Array], tile_tris: Array, counts: Array,
    big_list: Array, width: int, height: int, tile: int,
    tile_h: int = None, batch: int = 32,
) -> Dict[str, Array]:
    """Plain-XLA twin of rasterize_visibility. The winner at a pixel is
    the FIRST slot holding the nearest candidate depth. Also returns
    `margin`: the winner's depth minus the nearest depth of any other
    slot (0 where uncovered), which says where the winner is unambiguous."""
    th = tile_h or tile
    data, px, py = _reference_tiles(setup, tile_tris, counts, big_list,
                                    width, height, tile, th)

    def one_tile(args):
        d, x, y = args
        cand, z, b0, b1 = _reference_edges(d, x, y)
        zc = jnp.where(cand, z, 0.0)
        win = jnp.argmax(zc, axis=0)                     # first max
        best = jnp.max(zc, axis=0)
        covered = best > 0.0
        pick = lambda a: jnp.take_along_axis(a, win[None, :], axis=0)[0]
        others = jnp.where(
            jnp.arange(d.shape[0])[:, None] == win[None, :], 0.0, zc)
        return (jnp.where(covered, best, 0.0),
                jnp.where(covered, d[win, 14].astype(jnp.int32), -1),
                jnp.where(covered, pick(b0), 0.0),
                jnp.where(covered, pick(b1), 0.0),
                jnp.where(covered, best - jnp.max(others, axis=0), 0.0))

    outs = jax.lax.map(one_tile, (data, px, py), batch_size=batch)
    img = lambda a: tiles_to_image(a, width, height, tile, th)
    depth, tri_id, b0, b1, margin = map(img, outs)
    return {"depth": depth, "tri_id": tri_id, "b0": b0, "b1": b1,
            "margin": margin}


def rasterize_depth_reference(
    setup: Dict[str, Array], tile_tris: Array, counts: Array,
    big_list: Array, width: int, height: int, tile: int,
    atlas_bounds: tuple = (), tri_atlas: Array = None, tile_h: int = None,
    batch: int = 32,
) -> Array:
    """Plain-XLA twin of rasterize_depth: the max candidate depth over
    every slot of each tile's list."""
    th = tile_h or tile
    data, px, py = _reference_tiles(setup, tile_tris, counts, big_list,
                                    width, height, tile, th, tri_atlas)
    rects = (jnp.asarray(atlas_bounds, jnp.float32) if atlas_bounds
             else None)

    def one_tile(args):
        d, x, y = args
        cand, z, _, _ = _reference_edges(d, x, y)
        if rects is not None:
            ci = d[:, 15].astype(jnp.int32)
            known = (ci >= 0) & (ci < rects.shape[0])
            r = jnp.where(known[:, None], rects[jnp.clip(ci, 0, rects.shape[0] - 1)], 0.0)
            cand &= ((x[None, :] >= r[:, 0:1]) & (x[None, :] < r[:, 1:2])
                     & (y[None, :] >= r[:, 2:3]) & (y[None, :] < r[:, 3:4]))
        return jnp.max(jnp.where(cand, z, 0.0), axis=0)

    depth = jax.lax.map(one_tile, (data, px, py), batch_size=batch)
    return tiles_to_image(depth, width, height, tile, th)


# -- ordered blend (plain XLA) -----------------------------------------------

def rasterize_sorted_blend(
    setup: Dict[str, Array],
    tri_rgba: Array,    # (T, 4) premixed color+alpha per triangle
    tile_tris: Array,
    counts: Array,
    big_list: Array,
    opaque_depth: Array,  # (H, W) reverse-Z
    hdr: Array,           # (H, W, 3) blend destination
    width: int,
    height: int,
    tile: int,
    atlas_bounds: tuple = (),
    tri_atlas: Array = None,
    tile_h: int = None,
) -> Array:
    """Alpha-blend binned triangles over the HDR in bin order (sorted
    translucent path — the Translucent render type, mesh.hpp:30-40):
    triangles composite src-over in slot order (big list first, then
    back-to-front when binned with a depth priority, mesh.hpp:204),
    z-tested against the opaque depth plane (reverse-Z: pass when
    z >= opaque). The ordered blend is a scan, so this is a loop over
    slots with every tile's pixels in one array.
    atlas_bounds: per-cascade (x0, x1, y0, y1) pixel rects."""
    th = tile_h or tile
    t_count = setup["valid"].shape[0]
    sx, sy, z = setup["sx"], setup["sy"], setup["z"]      # (3, T)
    xy = jnp.stack([sx[0], sy[0], sx[1], sy[1], sx[2], sy[2]], axis=-1)
    atlas_col = (tri_atlas.astype(jnp.float32)[:, None]
                 if tri_atlas is not None
                 else jnp.zeros((t_count, 1), jnp.float32))
    records = jnp.concatenate(
        [xy, jnp.stack([z[0], z[1], z[2]], axis=-1),
         setup["inv_area"][:, None],
         jnp.arange(t_count, dtype=jnp.float32)[:, None],   # tri_id
         tri_rgba,
         atlas_col],
        axis=-1,
    )
    # sentinel row: id -1, alpha 0 (empty slots blend nothing)
    records = jnp.concatenate(
        [records, jnp.zeros((1, 16), jnp.float32).at[0, 10].set(-1.0)],
        axis=0)
    data = _slot_records(records, tile_tris, counts, big_list)
    px, py = tiled_pixel_centres(width, height, tile, th)
    opaque_z = image_to_tiles(opaque_depth, tile, th)        # (tiles, P)
    rgb = image_to_tiles(hdr, tile, th)                      # (tiles, P, 3)

    def body(s, rgb):
        d = jax.lax.dynamic_index_in_dim(data, s, axis=1, keepdims=False)
        f = lambda k: d[:, k:k + 1]                          # (tiles, 1)
        x0, y0, x1, y1, x2, y2 = (f(k) for k in range(6))
        e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1)
        e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2)
        e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0)
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
        b0 = e0 * f(9)
        b1 = e1 * f(9)
        zp = b0 * f(6) + b1 * f(7) + (1.0 - b0 - b1) * f(8)
        hit = inside & (zp >= opaque_z) & (zp <= 1.0) & (f(10) >= 0.0)
        if atlas_bounds:
            hit &= _in_rect(px, py, _atlas_rect(f(15), atlas_bounds))
        a = jnp.where(hit, f(14), 0.0)[..., None]
        return rgb * (1.0 - a) + d[:, None, 11:14] * a

    rgb = jax.lax.fori_loop(0, data.shape[1], body, rgb)
    return tiles_to_image(rgb, width, height, tile, th)


def render_pass(
    clip: Array,
    indices: Array,
    tri_valid: Array,
    width: int,
    height: int,
    tile: int,
    max_per_tile: int,
) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """Full raster pass: setup -> bin -> rasterize. Returns (vis, setup)."""
    setup = setup_triangles(clip, indices, tri_valid, width, height)
    tile_tris, counts, big = bin_triangles(setup, width, height, tile,
                                           max_per_tile)
    vis = rasterize_visibility(setup, tile_tris, counts, big,
                               width, height, tile)
    return vis, setup
