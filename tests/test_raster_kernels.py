"""The raster kernels against their plain references, on the CPU.

The visibility and depth kernels are Triton-route Pallas kernels; here they
run in the Pallas interpreter and are compared with the plain-XLA
references in raster.py (every slot of every tile, no early exit). The
ordered blend and OIT rasters are plain XLA; they are compared with
numpy loops over each tile's list.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from garden_tpu.render import oit, raster


def _scene(rng, n_small, n_big, w, h, big_z=None):
    """Screen-space setup of random front-facing triangles: small ones
    that bin per tile and big ones that ride the shared big list."""
    cx = np.concatenate([rng.uniform(-4, w, n_small),
                         rng.uniform(-20, w / 2, n_big)])
    cy = np.concatenate([rng.uniform(-4, h, n_small),
                         rng.uniform(-20, h / 2, n_big)])
    size = np.concatenate([rng.uniform(3, 14, n_small),
                           rng.uniform(1.5, 3.0, n_big) * max(w, h)])
    t = n_small + n_big
    z = rng.uniform(0.1, 0.9, (3, t))
    if big_z is not None:
        z[:, n_small:] = big_z
    # negative screen area = front-facing (setup_triangles_planes)
    sx = np.stack([cx, cx, cx + size])
    sy = np.stack([cy, cy + size, cy])
    setup = raster.setup_triangles_planes(
        jnp.asarray(sx / w * 2 - 1, jnp.float32),
        jnp.asarray(1 - sy / h * 2, jnp.float32),
        jnp.asarray(z, jnp.float32), jnp.ones((3, t), jnp.float32),
        jnp.ones((t,), bool), w, h)
    return setup


def _blend_reference(setup, rgba, tiles, counts, big, opaque, hdr,
                     w, h, tile, th):
    sx, sy = np.asarray(setup["sx"]), np.asarray(setup["sy"])
    z, inv_area = np.asarray(setup["z"]), np.asarray(setup["inv_area"])
    rgba = np.asarray(rgba)
    out = np.array(hdr, np.float32)
    tiles_x = -(-w // tile)
    for k, (row, cnt) in enumerate(zip(np.asarray(tiles), np.asarray(counts))):
        ty, tx = divmod(k, tiles_x)
        ys = np.arange(ty * th, min((ty + 1) * th, h))
        xs = np.arange(tx * tile, min((tx + 1) * tile, w))
        py, px = np.meshgrid(ys + 0.5, xs + 0.5, indexing="ij")
        for i in [int(b) for b in np.asarray(big) if b >= 0] + \
                [int(i) for i in row[:cnt] if i >= 0]:
            x0, x1, x2 = sx[:, i]
            y0, y1, y2 = sy[:, i]
            e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1)
            e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2)
            e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0)
            b0, b1 = e0 * inv_area[i], e1 * inv_area[i]
            zp = b0 * z[0, i] + b1 * z[1, i] + (1 - b0 - b1) * z[2, i]
            hit = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)
                   & (zp >= opaque[np.ix_(ys, xs)]) & (zp <= 1.0))
            a = np.where(hit, rgba[i, 3], 0.0)[..., None]
            blk = out[np.ix_(ys, xs)]
            out[np.ix_(ys, xs)] = blk * (1 - a) + rgba[i, :3] * a
    return out


def _oit_reference(setup, rgba, tiles, counts, opaque, w, h, tile, th):
    sx, sy = np.asarray(setup["sx"]), np.asarray(setup["sy"])
    z, inv_area = np.asarray(setup["z"]), np.asarray(setup["inv_area"])
    rgba = np.asarray(rgba)
    acc = np.zeros((h, w, 4), np.float32)
    reveal = np.ones((h, w), np.float32)
    tiles_x = -(-w // tile)
    for k, (row, cnt) in enumerate(zip(np.asarray(tiles), np.asarray(counts))):
        ty, tx = divmod(k, tiles_x)
        ys = np.arange(ty * th, min((ty + 1) * th, h))
        xs = np.arange(tx * tile, min((tx + 1) * tile, w))
        py, px = np.meshgrid(ys + 0.5, xs + 0.5, indexing="ij")
        for i in [int(i) for i in row[:cnt] if i >= 0]:
            x0, x1, x2 = sx[:, i]
            y0, y1, y2 = sy[:, i]
            e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1)
            e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2)
            e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0)
            zp = (e0 * z[0, i] + e1 * z[1, i] + e2 * z[2, i]) * inv_area[i]
            vis = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)
                   & (zp >= opaque[np.ix_(ys, xs)]) & (zp <= 1.0))
            wv = np.where(vis, np.clip(zp * zp * 10 + 0.01, 0.01, 30.0)
                          * rgba[i, 3], 0.0)
            acc[np.ix_(ys, xs)] += np.concatenate(
                [rgba[i, :3], [1.0]])[None, None] * wv[..., None]
            reveal[np.ix_(ys, xs)] *= np.where(vis, 1 - rgba[i, 3], 1.0)
    return acc, reveal


# Edge values are a*px + b*py + c, sums of terms up to ~1e4 at these frame
# sizes that cancel to a few hundred; the interpreter and XLA may round
# (or contract into FMAs) differently, about 1e-3 in e, which is ~1e-5 in
# a barycentric after the division by the triangle's doubled area and up
# to that again in depth (the test's triangles span 0.8 in z). The winning
# triangle itself must match wherever it beats the runner-up by > 1e-6.
TOL = 1e-5

# (name, frame (w, h), tile, tile_h, small, big, options)
CASES = [
    ("visibility-square", (128, 128), 64, None, 60, 3, {}),
    ("visibility-short-wide", (128, 128), 64, 16, 60, 3, {}),
    ("visibility-not-tile-multiple", (100, 70), 32, 16, 50, 2, {}),
    ("depth", (128, 96), 64, 16, 70, 3, {}),
    ("depth-atlas-guard", (128, 64), 64, 16, 70, 3, {"atlas": True}),
    ("depth-early-z", (128, 64), 64, 16, 70, 2, {"early_z": True}),
    ("sorted-blend", (96, 64), 32, 16, 40, 2, {}),
    ("oit", (96, 64), 32, 32, 40, 2, {}),
]


@pytest.mark.parametrize("name,frame,tile,tile_h,n_small,n_big,opt", CASES,
                         ids=[c[0] for c in CASES])
def test_raster_matches_plain_reference(name, frame, tile, tile_h, n_small,
                                        n_big, opt):
    w, h = frame
    th = tile_h or tile
    rng = np.random.default_rng(len(name))
    setup = _scene(rng, n_small, n_big, w, h,
                   big_z=0.95 if opt.get("early_z") else None)
    kind = name.split("-")[0]

    if kind == "visibility":
        tiles, counts, big = raster.bin_triangles(
            setup, w, h, tile, 32, max_big=8, tile_h=tile_h,
            foot_y=max(2, 2 * tile // th))
        vis = raster.rasterize_visibility(setup, tiles, counts, big,
                                          w, h, tile, tile_h=tile_h)
        ref = raster.rasterize_visibility_reference(
            setup, tiles, counts, big, w, h, tile, tile_h=tile_h)
        assert vis["depth"].shape == (h, w)
        assert int((np.asarray(ref["tri_id"]) >= 0).sum()) > w * h // 4
        clear = np.asarray(ref["margin"]) > 1e-6
        np.testing.assert_array_equal(np.asarray(vis["tri_id"])[clear],
                                      np.asarray(ref["tri_id"])[clear])
        for k in ("depth", "b0", "b1"):
            np.testing.assert_allclose(np.asarray(vis[k])[clear],
                                       np.asarray(ref[k])[clear],
                                       atol=TOL, err_msg=k)
    elif kind == "depth":
        kw = {}
        if opt.get("atlas"):
            kw = dict(atlas_bounds=((0, 64, 0, 64), (64, 128, 0, 64)),
                      tri_atlas=jnp.asarray(
                          np.arange(n_small + n_big) % 2, jnp.int32))
        if opt.get("early_z"):
            # front-to-back bins: the near big casters cover every tile
            # first, so each sub-block stops after its first slot group
            zmax = jnp.max(setup["z"], axis=0)
            order = jnp.argsort(-zmax)
            prio = jnp.zeros_like(order).at[order].set(
                jnp.arange(order.shape[0]))
            tiles, counts, big = raster.bin_triangles(
                setup, w, h, tile, 64, max_big=8, priority=prio, foot=2,
                tile_h=th, foot_y=2)
            assert int(np.asarray(big >= 0).sum()) == n_big
        else:
            tiles, counts, big = raster.bin_triangles_corner(
                setup, w, h, tile, 64, max_big=8, tile_h=th)
        depth = raster.rasterize_depth(setup, tiles, counts, big, w, h,
                                       tile, tile_h=th, **kw)
        ref = raster.rasterize_depth_reference(setup, tiles, counts, big,
                                               w, h, tile, tile_h=th, **kw)
        assert depth.shape == (h, w)
        assert float(jnp.mean(ref > 0)) > 0.2
        np.testing.assert_allclose(np.asarray(depth), np.asarray(ref),
                                   atol=TOL)
    elif kind == "sorted":
        zc = jnp.mean(setup["z"], axis=0)
        order = jnp.argsort(zc)
        prio = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
        tiles, counts, big = raster.bin_triangles(
            setup, w, h, tile, 32, max_big=8, priority=prio, tile_h=th,
            foot_y=4)
        rgba = jnp.asarray(rng.uniform(0.2, 0.8, (n_small + n_big, 4)),
                           jnp.float32)
        opaque = rng.uniform(0.0, 0.3, (h, w)).astype(np.float32)
        hdr = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        out = raster.rasterize_sorted_blend(
            setup, rgba, tiles, counts, big, jnp.asarray(opaque),
            jnp.asarray(hdr), w, h, tile, tile_h=th)
        ref = _blend_reference(setup, rgba, tiles, counts, big, opaque,
                               hdr, w, h, tile, th)
        assert not np.allclose(ref, hdr)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)
    else:
        tiles, counts, big = raster.bin_triangles(
            setup, w, h, tile, 32, max_big=8, tile_h=th)
        tiles, counts = raster.merge_big_list(tiles, counts, big)
        rgba = jnp.asarray(rng.uniform(0.2, 0.8, (n_small + n_big, 4)),
                           jnp.float32)
        opaque = rng.uniform(0.0, 0.3, (h, w)).astype(np.float32)
        acc, reveal = oit.rasterize_oit(setup, rgba, tiles, counts,
                                        jnp.asarray(opaque), w, h, tile,
                                        tile_h=th)
        acc_ref, reveal_ref = _oit_reference(setup, rgba, tiles, counts,
                                             opaque, w, h, tile, th)
        assert (reveal_ref < 1).mean() > 0.2
        np.testing.assert_allclose(np.asarray(acc), acc_ref, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(reveal), reveal_ref,
                                   atol=1e-6)


def test_interpret_mode_on_cpu():
    assert jax.default_backend() == "cpu"
    assert raster._interpret() is True


def test_interpret_raises_on_unknown_backend(monkeypatch):
    """A backend with no Pallas route is an error: no kernel quietly runs
    in the interpreter on an accelerator."""
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no Pallas raster route"):
        raster._interpret()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert raster._interpret() is False
