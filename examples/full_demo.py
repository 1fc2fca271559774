"""Flagship demo: procedural terrain + falling bodies + deferred-PBR frames.

The BASELINE.json config-5 workload in miniature: FastNoise-style worldgen,
physics simulation, and the full render stack in one jitted loop, dumping
frames + G-buffer debug views.

Usage: PYTHONPATH=. python examples/full_demo.py [out_dir] [--cpu] [--frames N]
"""

import os
import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.core.config import PhysicsConfig, RenderConfig
from garden_tpu.ops import noise
from garden_tpu.physics import world as pw
from garden_tpu.render import mesh as rmesh
from garden_tpu.render.deferred import DeferredRenderer
from garden_tpu.systems.camera import common_constants
from garden_tpu.utils.compile_cache import enable_compile_cache
from garden_tpu.utils.debug_view import dump_gbuffer, dump_physics_top_view


def main():
    enable_compile_cache()
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    out_dir = args[0] if args else "demo_frames"
    frames = 24
    if "--frames" in sys.argv:
        frames = int(sys.argv[sys.argv.index("--frames") + 1])
    os.makedirs(out_dir, exist_ok=True)

    # worldgen: noise heightfield terrain (config 2)
    hm = np.asarray(noise.terrain_heightmap(24, world_scale=0.08,
                                            height_scale=2.0))
    terrain = rmesh.heightfield(hm, cell=1.5)

    pcfg = PhysicsConfig(max_bodies=128, grid_dim=32, cell_size=2.0)
    w = pw.PhysicsWorld(pcfg)
    # bodies collide with the ACTUAL terrain heightfield (HeightFieldShape
    # analog) — the same grid the renderer draws
    w.add_body(w.shapes.heightfield(hm, cell=1.5), motion=pw.STATIC)
    box = w.shapes.box((0.4, 0.4, 0.4))
    sph = w.shapes.sphere(0.4)
    rng = np.random.default_rng(3)
    n_dyn = 60
    for i in range(n_dyn):
        w.add_body(box if i % 2 == 0 else sph,
                   position=(rng.uniform(-6, 6), 4.0 + i * 0.7,
                             rng.uniform(-6, 6)),
                   friction=0.5, restitution=0.2)

    rcfg = RenderConfig(width=640, height=384, tile_size=128,
                        max_triangles=8192, max_vertices=8192,
                        max_tris_per_tile=256, max_instances=n_dyn + 2,
                        use_clouds=True)
    scene = rmesh.SceneBuffers(rcfg.max_vertices, rcfg.max_triangles,
                               rcfg.max_instances)
    ground_mat = scene.add_material(rmesh.Material(base_color=(0.35, 0.4, 0.3),
                                                   roughness=0.9))
    mats_ids = [
        scene.add_material(rmesh.Material(base_color=(0.8, 0.2, 0.15), roughness=0.4)),
        scene.add_material(rmesh.Material(base_color=(0.9, 0.7, 0.3),
                                          metallic=1.0, roughness=0.35)),
        scene.add_material(rmesh.Material(base_color=(0.2, 0.4, 0.8), roughness=0.5)),
    ]
    scene.add_instance(terrain, material=ground_mat)
    for i in range(n_dyn):
        m = mats_ids[i % 3]
        scene.add_instance(rmesh.cube(0.4) if i % 2 == 0 else rmesh.uv_sphere(0.4, 8, 12),
                           material=m)
    renderer = DeferredRenderer(rcfg, scene)
    dev_scene = renderer.device_scene()

    eye = jnp.array([0.0, 7.0, 16.0])
    view = m3.look_at(eye, jnp.array([0.0, 1.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(1.0, rcfg.width / rcfg.height, 0.1)

    types = w.shapes.present_types()

    def frame(phys, fstate, t):
        for _ in range(2):  # 2 physics substeps per frame
            phys = pw.step(phys, pcfg, 1.0 / 60.0, types)
        pos, quat = phys["bodies"]["pos"], phys["bodies"]["quat"]
        inst = m3.compose_trs(pos[: n_dyn + 2], quat[: n_dyn + 2],
                              jnp.ones((n_dyn + 2, 3)))
        inst = inst.at[0].set(jnp.eye(4))  # slot 0 unused (plane body)
        # instance i+1 renders body i+1; instance 0 is the terrain
        inst_render = jnp.concatenate([jnp.eye(4)[None], inst[1:]], axis=0)
        constants = common_constants(eye, view, proj,
                                     jnp.array([0.4, -0.7, -0.5]),
                                     (rcfg.width, rcfg.height), t, 1.0 / 30.0)
        out = renderer.render(dev_scene, inst_render, constants, fstate)
        return phys, out

    framef = jax.jit(frame)
    phys = w.device_state()
    fstate = renderer.initial_frame_state()
    import time
    t0 = time.perf_counter()
    for i in range(frames):
        phys, out = framef(phys, fstate, jnp.float32(i / 30.0))
        fstate = out["frame_state"]
        img = np.asarray(out["image"])
        try:
            from PIL import Image
            Image.fromarray(img).save(os.path.join(out_dir, f"frame_{i:03d}.png"))
        except ImportError:
            pass
    jax.block_until_ready(out["image"])
    dt = time.perf_counter() - t0
    print(f"{frames} frames in {dt:.1f}s ({frames/dt:.1f} fps incl host IO)")
    out_np = jax.tree_util.tree_map(np.asarray, out)
    phys_np = jax.tree_util.tree_map(np.asarray, phys)
    dump_gbuffer(out_np, out_dir, "debug")
    dump_physics_top_view(phys_np, os.path.join(out_dir, "physics_top.png"))
    if "--debug" in sys.argv:
        # full editor-parity observability sheet (utils/debug_view.py):
        # G-buffer contact sheet, draw/contact counters, per-pass stats
        from garden_tpu.utils.debug_view import dump_debug_sheet
        report = dump_debug_sheet(out_np, phys_np, None, out_dir)
        print("debug stats:", report)
    print(f"wrote {out_dir}/")


if __name__ == "__main__":
    main()
