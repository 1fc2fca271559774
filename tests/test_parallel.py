import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from garden_tpu.core.config import PhysicsConfig
from garden_tpu.parallel.worlds import WorldBatch
from garden_tpu.physics import world as pw
from garden_tpu.utils import checkpoint


def build_state():
    cfg = PhysicsConfig(max_bodies=16, grid_dim=8)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    w.add_body(w.shapes.sphere(0.5), position=(0, 3, 0))
    # pruned narrowphase kernels: the all-types step is ~700x slower to
    # EXECUTE on the CPU test host (mesh/heightfield table scans per pair)
    return w.device_state(), cfg, w.shapes.present_types()


def test_world_batch_over_8_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 cpu devices"
    state, cfg, types = build_state()
    wb = WorldBatch(lambda s: pw.step(s, cfg, 1.0 / 60.0, types), n_worlds=8)

    def vary(s, i):
        b = s["bodies"]
        pos = b["pos"].at[1, 1].add(0.1 * i.astype(jnp.float32))
        return dict(s, bodies=dict(b, pos=pos))

    batched = wb.replicate(state, vary_fn=vary)
    for _ in range(30):
        batched = wb.step(batched)

    ys = np.asarray(batched["bodies"]["pos"][:, 1, 1])
    # worlds decorrelated: started at different heights -> different ys
    assert len(np.unique(ys.round(4))) > 4
    # all fell
    assert (ys < 3.8).all()
    # per-world extraction works
    w0 = wb.world(batched, 0)
    assert w0["bodies"]["pos"].shape == (16, 3)
    # metric reduction over the mesh
    mean_y = wb.reduce(batched, lambda s: s["bodies"]["pos"][1, 1])
    assert abs(float(mean_y) - ys.mean()) < 1e-5


def test_checkpoint_roundtrip(tmp_path):
    state, cfg, types = build_state()
    stepped = jax.jit(lambda s: pw.step(s, cfg, 1.0 / 60.0, types))(state)
    path = str(tmp_path / "snap.npz")
    checkpoint.save(path, stepped)
    restored = checkpoint.load(path, stepped)
    # bitwise identical resume
    for a, b in zip(jax.tree_util.tree_leaves(stepped),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # continuing from the restored state matches continuing from the original
    n1 = jax.jit(lambda s: pw.step(s, cfg, 1.0 / 60.0, types))(stepped)
    n2 = jax.jit(lambda s: pw.step(s, cfg, 1.0 / 60.0, types))(restored)
    np.testing.assert_array_equal(np.asarray(n1["bodies"]["pos"]),
                                  np.asarray(n2["bodies"]["pos"]))


def test_dryrun_multichip_under_time_budget():
    """Regression net for the round-3 MULTICHIP rc=124 timeout: the driver's
    dryrun must finish quickly on the 8-device CPU mesh. The round-3 failure
    was full-size 2048^2 shadow cascades leaking into the tiny-shape dryrun
    (interpret-mode Pallas x 8 devices -> >570 s)."""
    import time

    import __graft_entry__ as graft

    t0 = time.monotonic()
    graft.dryrun_multichip(8)
    elapsed = time.monotonic() - t0
    assert elapsed < 120.0, (
        f"dryrun_multichip(8) took {elapsed:.0f}s — the driver runs this "
        "with a hard timeout; keep the dryrun config tiny")


@pytest.mark.slow
def test_multihost_dcn_smoke():
    """Two-process jax.distributed smoke (SURVEY 5.8 multi-host DCN path):
    a world batch sharded across two 'hosts' over a localhost coordinator,
    stepped and psum-reduced. Each process runs in a subprocess since
    jax.distributed can only initialize once per process."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, worker, str(i), coord],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i}: OK" in out, out


def test_split_frame_rendering_matches_single_device():
    """Split-frame rendering (parallel/frame_tiles.py): 4 bands over the
    8-device mesh stitch into the single-renderer image away from band
    seams (screen-space effects get guard rows; exact equality holds for
    the purely per-pixel interior)."""
    import dataclasses

    from garden_tpu.core import math3d as m3
    from garden_tpu.core.config import RenderConfig
    from garden_tpu.parallel.frame_tiles import FrameTiles
    from garden_tpu.render import mesh as rmesh
    from garden_tpu.render.deferred import DeferredRenderer
    from garden_tpu.systems.camera import common_constants

    cfg = RenderConfig(width=128, height=64, tile_size=128, tile_h=8,
                       max_vertices=2048, max_triangles=2048,
                       max_instances=8, use_bloom=False, use_fxaa=False,
                       use_auto_exposure=False, use_hbao=False,
                       use_shadows=True, use_clouds=False)
    scene = rmesh.SceneBuffers(2048, 2048, 8)
    red = scene.add_material(rmesh.Material(base_color=(0.9, 0.1, 0.1)))
    grey = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5),
                                             roughness=0.9))
    scene.add_instance(rmesh.cube(0.5), material=red)
    scene.add_instance(rmesh.plane_grid(20.0, 4), material=grey)

    eye = jnp.array([0.0, 1.5, 4.0])
    view = m3.look_at(eye, jnp.array([0.0, 0.5, 0.0]),
                      jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(1.0, cfg.width / cfg.height, 0.1)
    constants = common_constants(eye, view, proj,
                                 jnp.array([0.3, -0.8, -0.4]),
                                 (cfg.width, cfg.height), 0.0, 1.0 / 60.0)
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][1, 3] = 0.5
    mats = jnp.asarray(mats)

    ref_r = DeferredRenderer(cfg, scene)
    ref = np.asarray(ref_r.render(ref_r.device_scene(), mats, constants,
                                  ref_r.initial_frame_state())["image"])

    ft = FrameTiles(cfg, scene, n_bands=4, overlap=8)
    img, state = ft.render(ft.renderer.device_scene(), mats, constants,
                           ft.initial_state())
    img = np.asarray(img)
    assert img.shape == ref.shape

    # interior rows (2px off each seam): the band crops re-derive pixel
    # coordinates through a remapped projection, so allow 1-LSB wobble
    band_h = cfg.height // 4
    seam = {r for b in range(1, 4) for r in
            range(b * band_h - 2, b * band_h + 2)}
    rows = [r for r in range(cfg.height) if r not in seam]
    diff = np.abs(img[rows].astype(int) - ref[rows].astype(int))
    assert np.percentile(diff, 99) <= 2, float(np.percentile(diff, 99))
    assert diff.mean() < 0.5, diff.mean()

    # a second frame with the reduced (shared) exposure state runs clean
    img2, _ = ft.render(ft.renderer.device_scene(), mats, constants, state)
    assert np.isfinite(np.asarray(state["avg_luminance"])).all()
