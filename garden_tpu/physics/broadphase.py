"""Broadphase: uniform spatial grid over sorted cell keys.

Rebuild of Jolt's broadphase pair sweep as invoked by the reference
(source/system/physics.cpp:1186-1193 steps JPH::PhysicsSystem::Update which
runs its quad-tree broadphase; capacity contract maxBodyPairCount=65536 at
include/garden/system/physics.hpp:680). A quad-tree walk is pointer-chasing
and accelerator-hostile; the idiomatic device analog is a uniform grid.

Cost model: random gathers are the scarce resource next to dense
elementwise work, so the design minimizes gather count and volume:

1. every body's AABB QUANTIZES to a 10-bit-per-axis integer box (floor
   minima, ceil maxima — a conservative superset of the true box, at most
   1/1024 of the world coarser per side) and inserts into the (up to)
   2x2x2 quantized cells it touches — 8 keys per body; cell keys are
   HASHED down to O(bodies) buckets (dense giant-grid tables cost
   milliseconds of init traffic while ~99% empty), then ONE packed sort
   of (bucket << bits | body)
2. a (bucket, slot, 3)-int32 table is built with three SCALAR scatters:
   [id | layer | active], [qmin xyz], [qmax xyz] — the quantized box
   rides IN the table entry, so no downstream per-candidate fetch exists
   at all (an earlier design row-gathered each candidate's f32 AABB: N*8C
   rows, the step's hottest op)
3. each body row-gathers its 8 cells' entry lists (N*8 narrow rows —
   gathers price per ROW)
4. all pair filters (quantized-box overlap, layers, self, active) run
   densely on the fetched ints; the conservative quantization only ADDS
   near-miss candidates, which narrowphase rejects on true geometry
5. duplicate pair findings (the same pair shared by several cells, or
   injected by a hash-bucket collision) are killed by the home-cell rule
   ON THE QUANTIZED BOXES: a pair counts only in the cell containing
   max(qmin_i, qmin_j) — both rows compute it from the SAME quantized
   values, so the rule stays exactly symmetric (the solver's mirrored
   row layout requires it), and for q-overlapping pairs the home point
   lies inside the q-intersection, hence inside both scan windows
6. compaction to the per-body budget via top_k over the (already small)
   candidate row

Bodies whose AABB exceeds a cell (planes, heightfields, long boxes) are
"global" bodies: every body is tested against all `max_globals` of them,
bypassing the grid (Jolt's NonMoving broadphase layer plays a similar role,
physics.hpp:194-225).

Output is `(cand_idx, valid)` in a fixed (N, K) layout: body i's k-th
candidate. Overflow beyond K candidates is dropped, mirroring Jolt's fixed
pair budget.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.physics import shapes as sh

Array = jnp.ndarray


def body_aabbs(pos: Array, quat: Array, stype: Array, params: Array,
               margin: float = 0.0, hull_ext: Array = None,
               comp_ext: Array = None) -> Tuple[Array, Array]:
    """World AABBs for all bodies, expanded by the speculative margin."""
    lmin, lmax = sh.local_aabb(stype, params, hull_ext=hull_ext,
                               comp_ext=comp_ext)
    wmin, wmax = m3.aabb_transform(lmin, lmax, pos, quat)
    return wmin - margin, wmax + margin


def find_candidates(
    pos: Array,
    aabb_min: Array,
    aabb_max: Array,
    active: Array,
    dynamic: Array,
    layer: Array,           # int32[N]
    layer_table: Array,     # bool[L, L] collision filter table
    is_global: Array,       # bool[N] grid-bypassing big bodies
    *,
    cell_size: float,
    grid_dim: int,
    cand_per_cell: int,
    max_candidates: int,
    max_globals: int,
) -> Tuple[Array, Array]:
    """Return (cand_idx int32[N, K], cand_valid bool[N, K]),
    K = max_candidates + max_globals. Grid pairs appear in BOTH rows
    (symmetric row layout, see solver.py); rows exist only for dynamic
    bodies."""
    n = pos.shape[0]
    half_world = 0.5 * cell_size * grid_dim
    # 10-bit quantization of the world per axis; spc = quant steps per
    # grid cell (grid_dim must divide 1024 — power-of-two grids)
    assert 1024 % grid_dim == 0, "grid_dim must divide 1024"
    spc = 1024 // grid_dim
    inv_q = 1024.0 / (cell_size * grid_dim)
    qmin = jnp.clip(jnp.floor((aabb_min + half_world) * inv_q), 0,
                    1023).astype(jnp.int32)                     # (N, 3)
    qmax = jnp.clip(jnp.ceil((aabb_max + half_world) * inv_q), 0,
                    1023).astype(jnp.int32)

    # the 2x2x2 insertion is exact only when every grid AABB spans
    # <= 2*cell_size per axis; world.collide() enforces that invariant
    # (including the quantization inflation) by clamping the speculative
    # margin and routing over-span non-dynamic bodies through the global
    # list before calling here
    cmin = qmin // spc
    cmax = jnp.minimum(qmax // spc, grid_dim - 1)
    cmax = jnp.minimum(cmax, cmin + 1)      # at most 2 cells per axis

    in_grid = active & ~is_global
    n_cells = grid_dim ** 3 + 2             # + sentinel + spare
    sentinel = n_cells - 1

    # 1. 8 insertion keys per body (dups where the AABB spans < 2 cells are
    # collapsed to the sentinel so each (cell, body) appears once).
    # Per-axis (N, 8) planes — the (N, 8, 3) stacked form puts a 3-wide
    # axis minor, which every reduction then strides over
    offs = np.array([(ox, oy, oz) for ox in (0, 1) for oy in (0, 1)
                     for oz in (0, 1)], np.int32)        # (8, 3)
    cx8 = cmin[:, 0:1] + offs[None, :, 0]                # (N, 8)
    cy8 = cmin[:, 1:2] + offs[None, :, 1]
    cz8 = cmin[:, 2:3] + offs[None, :, 2]
    covered = ((cx8 <= cmax[:, 0:1]) & (cy8 <= cmax[:, 1:2])
               & (cz8 <= cmax[:, 2:3]))
    key8 = (cx8 * grid_dim + cy8) * grid_dim + cz8
    key8 = jnp.where(covered & in_grid[:, None], key8, sentinel)  # (N, 8)

    # 2. hash the cell space down to O(bodies) buckets: a dense
    # grid_dim^3-cell table (64^3 cells = 67 MB) costs init/reshape
    # traffic every step while being ~99% empty. Bucket
    # collisions between occupied cells only ADD candidates (killed by the
    # AABB/home-cell filters below); colliding cells share the bucket's
    # slot capacity — the same fixed-capacity drop contract as everywhere
    # else. Small grids index directly (no collisions at all). Hashing
    # also shrinks the sort key, keeping the fast packed single-operand
    # sort path at every grid size.
    h_target = 1 << max(int(np.ceil(np.log2(max(4 * n, 1024)))), 1)
    if n_cells <= h_target:
        n_buckets = n_cells
        sentinel_bucket = sentinel
        hkey8 = key8
    else:
        n_buckets = h_target + 1
        sentinel_bucket = h_target
        hmul = jnp.uint32(2654435761)
        h = (key8.astype(jnp.uint32) * hmul) >> jnp.uint32(12)
        hkey8 = jnp.where(key8 >= sentinel, sentinel_bucket,
                          (h & jnp.uint32(h_target - 1)).astype(jnp.int32))

    body_bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    key_bits = max(int(np.ceil(np.log2(n_buckets + 1))), 1)
    body8 = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, 8))
    if key_bits + body_bits <= 31:
        # single packed sort (key<<bits | body): one operand, fastest path
        packed = jnp.sort((hkey8.reshape(-1) << body_bits) | body8.reshape(-1))
        key_sorted = packed >> body_bits
        body_sorted = packed & ((1 << body_bits) - 1)    # (8N,)
    else:
        # huge body counts: int32 pack overflows; variadic sort fallback
        # (wrapped-negative keys would be silently dropped by the scatter,
        # killing collisions for half the grid)
        key_sorted, body_sorted = jax.lax.sort(
            (hkey8.reshape(-1), body8.reshape(-1)), num_keys=1)

    # 3. dense (bucket, slot, 3) int32 table via three SCALAR scatters:
    # [id | layer<<17 | active<<20], [qmin xyz, 10 bits each],
    # [qmax xyz]. The quantized box rides IN the entry, so the filters
    # below need NO per-candidate fetch (no row gather of each
    # candidate's f32 AABB: N*8C rows). Slot within
    # a bucket's run comes from run-position arithmetic (cummax of
    # run-start indices); entries beyond cand_per_cell drop.
    m = key_sorted.shape[0]
    idxs = jnp.arange(m, dtype=jnp.int32)
    run_start = jnp.concatenate(
        [jnp.ones((1,), bool), key_sorted[1:] != key_sorted[:-1]])
    seg_start = jax.lax.cummax(jnp.where(run_start, idxs, 0))
    slot = idxs - seg_start                              # (8N,)
    c_per = cand_per_cell

    assert n <= (1 << 17), "packed broadphase entry caps at 131072 bodies"
    packed_all = (jnp.arange(n, dtype=jnp.int32)
                  | (layer << 17) | (active.astype(jnp.int32) << 20))
    pack3 = lambda v: (v[:, 0] << 20) | (v[:, 1] << 10) | v[:, 2]
    qmin_all = pack3(qmin)
    qmax_all = pack3(qmax)
    entry3 = jnp.stack([packed_all, qmin_all, qmax_all], -1)  # (N, 3)
    ent_sorted = entry3[body_sorted]                 # one 3-wide row gather
    # PLANE-MAJOR bucket rows: [ids(c_per) | qmins(c_per) |
    # qmaxs(c_per)] so the post-gather planes slice out as contiguous
    # (N, 8, c_per) blocks and every downstream filter runs on 2-D
    # (N, 8C) int planes instead of (N, 8C, 3) shapes with a 3-wide
    # minor axis.
    base = jnp.where((slot < c_per) & (key_sorted < sentinel_bucket),
                     key_sorted * (3 * c_per) + slot, n_buckets * 3 * c_per)
    # ONE flat scalar scatter for all three planes (instead of a row
    # scatter per entry)
    flat_pos = jnp.concatenate([base, base + c_per, base + 2 * c_per])
    flat_val = ent_sorted.T.reshape(-1)              # plane-major, matches
    cell_tab = jnp.full((n_buckets * c_per * 3 + 3,), -1, jnp.int32).at[
        flat_pos].set(flat_val, mode="drop")[:-3].reshape(
        n_buckets, 3 * c_per)

    # 4. each body row-gathers its own 8 cells' entry lists (N*8 narrow
    # rows); every filter below is dense int math on 2-D (N, 8C) planes
    scan_key = jnp.where(covered, key8, sentinel)        # (N, 8) true keys
    scan_bucket = jnp.where(covered, hkey8, sentinel_bucket)
    raw = cell_tab[scan_bucket]                          # (N, 8, 3C)
    meta = raw[:, :, 0:c_per].reshape(n, 8 * c_per)      # (N, 8C)
    qmin_pk = raw[:, :, c_per:2 * c_per].reshape(n, 8 * c_per)
    qmax_pk = raw[:, :, 2 * c_per:3 * c_per].reshape(n, 8 * c_per)
    cand_valid = meta >= 0
    # no `where` guards on the unpacked fields: invalid (-1) entries decode
    # to garbage (id 0x1FFFF, layer 7) but cand_valid gates `valid` below
    # and layer 7 has no accept bit — two fewer (N, 8C) selects per step
    cand = meta & 0x1FFFF                                # (N, 8C)
    jlayer = (meta >> 17) & 7
    j_active = cand_valid & (((meta >> 20) & 1) == 1)
    k8c = cand.shape[1]

    # 4. pair filters, all dense per-axis math on (N, 8C) planes
    accept_bits = jnp.sum(
        layer_table[layer].astype(jnp.int32)
        * (1 << jnp.arange(layer_table.shape[0], dtype=jnp.int32))[None, :],
        axis=-1)                                          # int bitmask per body

    i_idx = jnp.arange(n, dtype=jnp.int32)[:, None]
    valid = cand_valid & (cand != i_idx)
    valid &= active[:, None] & j_active
    valid &= dynamic[:, None]
    # layer filter from the precomputed accept bitmask (no table gather)
    valid &= ((accept_bits[:, None] >> jlayer) & 1) == 1
    # quantized-box overlap per axis (a conservative superset of the true
    # AABB test; near-misses within one quant step reach narrowphase,
    # which rejects them on true geometry), and home-cell dedup ON THE
    # QUANTIZED BOXES: the pair counts only in the cell holding the
    # component-wise max of the two quantized minima. Both rows compute
    # it from the same quantized ints, so the rule is exactly symmetric;
    # for q-overlapping pairs the point lies in the q-intersection, hence
    # inside both bodies' scan windows. Also kills candidates injected by
    # a hash-bucket collision (their home cell is never the scanned cell).
    home_key = jnp.zeros_like(cand)
    for axis, shift in ((0, 20), (1, 10), (2, 0)):
        jq_min = (qmin_pk >> shift) & 0x3FF              # (N, 8C)
        jq_max = (qmax_pk >> shift) & 0x3FF
        iq_min = qmin[:, axis:axis + 1]                  # (N, 1)
        iq_max = qmax[:, axis:axis + 1]
        valid &= (iq_min <= jq_max) & (jq_min <= iq_max)
        home_ax = jnp.minimum(jnp.maximum(iq_min, jq_min) // spc,
                              grid_dim - 1)
        home_key = home_key * grid_dim + home_ax
    scanned = jnp.repeat(scan_key, c_per, axis=1)        # (N, 8C)
    valid &= home_key == scanned

    # 5. compact to the per-body budget (stable ascending-id order — the
    # same order in both rows of a pair)
    rank_key = jnp.where(
        valid, k8c - jnp.arange(k8c, dtype=jnp.int32)[None, :], 0)
    _, sel = jax.lax.top_k(rank_key, max_candidates)      # (N, K)
    # dense one-hot compaction (see core/math3d.py gather notes)
    grid_idx = m3.gather_scalars(cand.astype(jnp.float32), sel).astype(jnp.int32)
    grid_valid = m3.gather_scalars(valid.astype(jnp.float32), sel) > 0.5

    # 6. global bodies: first `max_globals` by index, tested against everyone
    gscore = jnp.where(is_global & active, 1, 0)
    _, gidx = jax.lax.top_k(gscore, max_globals)          # (G,)
    gvalid = (is_global & active)[gidx]                   # (G,)
    gidx_b = jnp.broadcast_to(gidx[None, :], (n, max_globals))
    gvalid_b = (
        gvalid[None, :]
        & active[:, None]
        & dynamic[:, None]
        & ~is_global[:, None]
        & layer_table[layer[:, None], layer[gidx_b]]
    )

    # globals FIRST: contact compaction keeps the first valid slots, and
    # dropping a ground-plane contact in a dense pile means tunneling
    cand_idx = jnp.concatenate([gidx_b, grid_idx], axis=1)
    valid = jnp.concatenate([gvalid_b, grid_valid], axis=1)
    return cand_idx.astype(jnp.int32), valid
