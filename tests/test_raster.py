import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.render import mesh as rmesh
from garden_tpu.render import raster
from garden_tpu.systems.camera import view_matrix


W, H, TILE = 128, 128, 64


def _full_screen_tri():
    """One big CCW triangle facing the camera, at z_view = -2 (w=2)."""
    # clip-space positions (x, y, z, w); reverse-Z depth z/w = 0.5
    clip = jnp.array([
        [-3.0, -1.0, 1.0, 2.0],
        [3.0, -1.0, 1.0, 2.0],
        [0.0, 3.0, 1.0, 2.0],
    ], jnp.float32)
    idx = jnp.array([[0, 1, 2]], jnp.int32)
    valid = jnp.array([True])
    return clip, idx, valid


def test_single_triangle_coverage_and_depth():
    clip, idx, valid = _full_screen_tri()
    vis, setup = raster.render_pass(clip, idx, valid, W, H, TILE, 64)
    tri_id = np.asarray(vis["tri_id"])
    depth = np.asarray(vis["depth"])
    # center covered with depth 0.5; corners outside
    assert tri_id[H // 2, W // 2] == 0
    assert abs(depth[H // 2, W // 2] - 0.5) < 1e-5
    assert tri_id[0, 0] == -1 and tri_id[0, W - 1] == -1
    # barycentrics sum to 1 where covered
    b0 = np.asarray(vis["b0"])[H // 2, W // 2]
    b1 = np.asarray(vis["b1"])[H // 2, W // 2]
    assert 0.0 <= b0 <= 1.0 and 0.0 <= b1 <= 1.0


def test_depth_test_nearer_wins():
    # same triangle twice, second at nearer depth (reverse-Z: bigger z/w)
    clip = jnp.array([
        [-3.0, -1.0, 1.0, 2.0], [3.0, -1.0, 1.0, 2.0], [0.0, 3.0, 1.0, 2.0],
        [-3.0, -1.0, 1.6, 2.0], [3.0, -1.0, 1.6, 2.0], [0.0, 3.0, 1.6, 2.0],
    ], jnp.float32)
    idx = jnp.array([[0, 1, 2], [3, 4, 5]], jnp.int32)
    valid = jnp.array([True, True])
    vis, _ = raster.render_pass(clip, idx, valid, W, H, TILE, 64)
    assert np.asarray(vis["tri_id"])[H // 2, W // 2] == 1
    assert abs(np.asarray(vis["depth"])[H // 2, W // 2] - 0.8) < 1e-5


def test_backface_culled():
    clip, idx, valid = _full_screen_tri()
    idx_flipped = idx[:, ::-1]
    vis, _ = raster.render_pass(clip, idx_flipped, valid, W, H, TILE, 64)
    assert np.asarray(vis["tri_id"]).max() == -1


def test_cube_scene_renders():
    scene = rmesh.SceneBuffers(max_vertices=256, max_triangles=256,
                               max_instances=4)
    mat = scene.add_material(rmesh.Material(base_color=(1.0, 0.2, 0.2)))
    inst = scene.add_instance(rmesh.cube(0.5), material=mat)
    dev = scene.device_arrays()

    eye = jnp.array([0.0, 0.5, 2.5])
    view = m3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(1.0, W / H, 0.1)
    inst_mats = jnp.broadcast_to(jnp.eye(4), (4, 4, 4))

    world_pos, _ = rmesh.transform_vertices(dev, inst_mats)
    clip = m3.apply_mat4_h(m3.matmul(proj, view), world_pos)
    vis, setup = raster.render_pass(clip, dev["indices"], dev["tri_valid"],
                                    W, H, TILE, 64)
    tri_id = np.asarray(vis["tri_id"])
    # cube covers the center, not the border
    assert tri_id[H // 2, W // 2] >= 0
    assert tri_id[2, 2] == -1
    cover = (tri_id >= 0).mean()
    assert 0.02 < cover < 0.5, cover
    # depth of the front face: view z = 2.0 -> reverse-Z near/|z| = 0.05
    d = np.asarray(vis["depth"])[H // 2, W // 2]
    assert abs(d - 0.1 / 2.0) < 5e-3, d


def test_entry_config_tpu_tile_legality():
    """The driver entry() and every quality preset must use raster tile
    layouts that lower through Triton: power-of-two block dimensions, so
    power-of-two tile widths and heights, main pass and shadow atlas."""
    from garden_tpu.core.config import QUALITY_PRESETS, RenderConfig
    from garden_tpu.render.raster import tile_layout_ok

    import sys
    sys.path.insert(0, ".")
    import __graft_entry__ as ge
    # the flagship's render config (host-side build at a tiny body count)
    cfg = ge._build_scene(n_bodies=8, width=1920, height=1080,
                          grid_dim=8).renderer.config
    assert tile_layout_ok(cfg.tile_size, cfg.tile_h), "entry() main tiles"
    assert tile_layout_ok(128, cfg.shadow.atlas_tile_h), "entry() atlas"
    assert tile_layout_ok(RenderConfig().tile_size, RenderConfig().tile_h)
    for name, over in QUALITY_PRESETS.items():
        cfg = RenderConfig(**over)
        assert tile_layout_ok(cfg.tile_size, cfg.tile_h), name
        assert tile_layout_ok(128, cfg.shadow.atlas_tile_h), name
    # and the checker rejects layouts Triton cannot block
    assert not tile_layout_ok(96)
    assert not tile_layout_ok(128, 24)
    assert tile_layout_ok(128, 16)


def test_overflow_drops_farthest_with_priority():
    """Tile-capacity overflow drop policy: with a front-to-back priority the
    kept subset is exactly the nearest triangles (round-1 dropped by index
    order, cutting arbitrary chunks out of dense meshes)."""
    T = 40
    rng = np.random.default_rng(0)
    z = np.linspace(0.1, 0.9, T).astype(np.float32)  # reverse-z: 0.9 nearest
    cx = rng.uniform(10, 100, T).astype(np.float32)
    cy = rng.uniform(10, 100, T).astype(np.float32)
    setup = {
        # corner-major (3, T) planes (raster.setup_triangles_planes)
        "sx": jnp.asarray(np.stack([cx, cx + 3, cx], 0)),
        "sy": jnp.asarray(np.stack([cy, cy, cy + 3], 0)),
        "z": jnp.asarray(np.stack([z, z, z], 0)),
        "inv_w": jnp.ones((3, T), jnp.float32),
        "inv_area": jnp.ones((T,), jnp.float32),
        "xmin": jnp.asarray(cx), "xmax": jnp.asarray(cx + 3),
        "ymin": jnp.asarray(cy), "ymax": jnp.asarray(cy + 3),
        "valid": jnp.ones((T,), bool),
    }
    zkey = jnp.max(setup["z"], 0)
    order = jnp.argsort(-zkey)
    prio = jnp.zeros((T,), jnp.int32).at[order].set(
        jnp.arange(T, dtype=jnp.int32))
    tiles, counts, big = raster.bin_triangles(setup, 128, 128, 128,
                                              max_per_tile=8, max_big=4,
                                              priority=prio)
    kept = sorted(int(x) for x in np.asarray(tiles[0]) if x >= 0)
    assert int(counts[0]) == 8
    assert int(np.asarray(big).max()) == -1  # 3px triangles are never big
    assert kept == sorted(range(T - 8, T))  # exactly the nearest 8


def test_rectangular_tiles_match_square():
    """tile_h (short-wide raster tiles) must be pixel-exact vs the
    square-tile path across visibility, depth-only, and sorted-blend
    rasters on a multi-triangle scene."""
    rng = np.random.default_rng(7)
    n = 40
    # random small CCW triangles in clip space, w=2, varied depth
    base = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    d1 = rng.uniform(0.05, 0.4, (n, 2)).astype(np.float32)
    rot = np.stack([-d1[:, 1], d1[:, 0]], -1)
    p0, p1, p2 = base, base + d1, base + rot
    zz = rng.uniform(0.2, 1.6, (n, 1)).astype(np.float32)
    verts = []
    for p in (p0, p1, p2):
        verts.append(np.concatenate(
            [p * 2.0, zz, np.full((n, 1), 2.0, np.float32)], -1))
    clip = jnp.asarray(np.stack(verts, 1).reshape(n * 3, 4))
    idx = jnp.arange(n * 3, dtype=jnp.int32).reshape(n, 3)
    valid = jnp.ones((n,), bool)

    setup = raster.setup_triangles(clip, idx, valid, W, H)
    sq_tiles, sq_counts, sq_big = raster.bin_triangles(setup, W, H, TILE, 64)
    sq = raster.rasterize_visibility(setup, sq_tiles, sq_counts, sq_big,
                                     W, H, TILE)
    rc_tiles, rc_counts, rc_big = raster.bin_triangles(setup, W, H, TILE, 64,
                                                       tile_h=16, foot_y=8)
    rc = raster.rasterize_visibility(setup, rc_tiles, rc_counts, rc_big,
                                     W, H, TILE, tile_h=16)
    for k in ("depth", "tri_id", "b0", "b1"):
        np.testing.assert_array_equal(np.asarray(sq[k]), np.asarray(rc[k]),
                                      err_msg=k)

    d_sq = raster.rasterize_depth(setup, sq_tiles, sq_counts, sq_big,
                                  W, H, TILE)
    d_rc = raster.rasterize_depth(setup, rc_tiles, rc_counts, rc_big,
                                  W, H, TILE, tile_h=16)
    np.testing.assert_array_equal(np.asarray(d_sq), np.asarray(d_rc))

    rgba = jnp.asarray(
        rng.uniform(0.2, 0.8, (n, 4)).astype(np.float32))
    hdr0 = jnp.zeros((H, W, 3), jnp.float32)
    zeros = jnp.zeros((H, W), jnp.float32)
    b_sq = raster.rasterize_sorted_blend(setup, rgba, sq_tiles, sq_counts,
                                         sq_big, zeros, hdr0, W, H, TILE)
    b_rc = raster.rasterize_sorted_blend(setup, rgba, rc_tiles, rc_counts,
                                         rc_big, zeros, hdr0, W, H, TILE,
                                         tile_h=16)
    np.testing.assert_allclose(np.asarray(b_sq), np.asarray(b_rc), atol=1e-6)


def test_overflow_drops_farthest_with_bucket_priority():
    """bucket_priority (coarse in-sort ordering): tile-capacity overflow
    keeps the nearest depth buckets — the argsort-free variant of the
    front-to-back drop policy used by the opaque main pass."""
    T = 40
    rng = np.random.default_rng(1)
    z = np.linspace(0.1, 0.9, T).astype(np.float32)
    cx = rng.uniform(10, 100, T).astype(np.float32)
    cy = rng.uniform(10, 100, T).astype(np.float32)
    setup = {
        # corner-major (3, T) planes (raster.setup_triangles_planes)
        "sx": jnp.asarray(np.stack([cx, cx + 3, cx], 0)),
        "sy": jnp.asarray(np.stack([cy, cy, cy + 3], 0)),
        "z": jnp.asarray(np.stack([z, z, z], 0)),
        "inv_w": jnp.ones((3, T), jnp.float32),
        "inv_area": jnp.ones((T,), jnp.float32),
        "xmin": jnp.asarray(cx), "xmax": jnp.asarray(cx + 3),
        "ymin": jnp.asarray(cy), "ymax": jnp.asarray(cy + 3),
        "valid": jnp.ones((T,), bool),
    }
    # 16 buckets over [0.1, 0.9]; nearest (max reverse-Z) = bucket 0
    bucket = 15 - np.clip(((z - 0.1) / 0.8 * 16).astype(np.int32), 0, 15)
    tiles, counts, big = raster.bin_triangles(
        setup, 128, 128, 128, max_per_tile=8, max_big=4,
        bucket_priority=jnp.asarray(bucket))
    kept = sorted(int(x) for x in np.asarray(tiles[0]) if x >= 0)
    assert int(counts[0]) == 8
    # the 8 kept triangles must all be nearer than every dropped one,
    # up to one bucket's quantization (0.8 / 16 = 0.05 in z)
    dropped = sorted(set(range(T)) - set(kept))
    assert z[kept].min() >= z[dropped].max() - 0.0501, (kept[:3], dropped[-3:])


def test_corner_binning_matches_slot_binning_depth():
    """bin_triangles_corner (one sorted entry per caster + 4-run list
    assembly) must produce pixel-identical depth vs the slot-copy
    bin_triangles on a mixed small/big scene, in the
    cascade-atlas form (short-wide tiles, corner lists)."""
    rng = np.random.default_rng(23)
    w, h, tile, th = 512, 256, 128, 16
    n_small, n_big = 160, 5
    cx = rng.uniform(0, 500, n_small).astype(np.float32)
    cy = rng.uniform(0, 250, n_small).astype(np.float32)
    sz = rng.uniform(3, 30, n_small).astype(np.float32)
    bx = rng.uniform(0, 300, n_big).astype(np.float32)
    by = rng.uniform(0, 150, n_big).astype(np.float32)
    bs = rng.uniform(100, 400, n_big).astype(np.float32)
    px = np.concatenate([cx, bx])
    py = np.concatenate([cy, by])
    ps = np.concatenate([sz, bs])
    t = n_small + n_big
    z = rng.uniform(0.1, 0.9, t).astype(np.float32)
    sx = np.stack([px, px + ps, px], 0)
    sy = np.stack([py, py, py + ps], 0)
    valid = np.ones((t,), bool)
    valid[::17] = False          # some culled casters in the stream
    setup = {
        "sx": jnp.asarray(sx), "sy": jnp.asarray(sy),
        "z": jnp.asarray(np.stack([z, z, z], 0)),
        "inv_area": jnp.asarray(1.0 / (ps * ps)),
        "xmin": jnp.asarray(sx.min(0)), "xmax": jnp.asarray(sx.max(0)),
        "ymin": jnp.asarray(sy.min(0)), "ymax": jnp.asarray(sy.max(0)),
        "valid": jnp.asarray(valid),
    }
    tiles, counts, big = raster.bin_triangles(
        setup, w, h, tile, 64, max_big=16, foot=2, tile_h=th, foot_y=2)
    ref = raster.rasterize_depth(setup, tiles, counts, big, w, h, tile,
                                 tile_h=th)
    ctiles, ccounts, cbig = raster.bin_triangles_corner(
        setup, w, h, tile, 64, max_big=16, tile_h=th)
    np.testing.assert_array_equal(np.asarray(cbig), np.asarray(big))
    out = raster.rasterize_depth(setup, ctiles, ccounts, cbig, w, h, tile,
                                 tile_h=th)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))
    # per-tile candidate SETS match exactly (not just the rendered image)
    ts = np.sort(np.asarray(tiles), axis=1)
    cs = np.sort(np.asarray(ctiles), axis=1)
    np.testing.assert_array_equal(ts, cs)
