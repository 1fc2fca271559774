#!/usr/bin/env python3
"""On-card smoke test of the combined physics + 1080p deferred-PBR tick.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs of one host: the sharded paths

One process drives the card(s). Phases run in order and any failure exits
non-zero; the last line of standard output is one JSON object, printed
only when every phase passed. Every number is printed beside the card's
name and power limit.

One card:
1. device: JAX must report a GPU (there is no CPU fallback).
2. kernels: the Triton visibility and depth kernels against their plain
   XLA references (raster.*_reference) at flagship shapes — the 1080p main
   pass on 128x32 tiles and the 2048/1024/1024 cascade atlas on 128x16
   tiles — each with its time beside XLA's time for the plain version,
   and the G-buffer planes shaded from each.
3. physics: every golden scene through simulate(), its analytic checks
   and the committed curves (tests/golden).
4. main path: jit(entry()) for several ticks carrying the state (compile
   seconds, steady-state ms per tick, peak device bytes), a non-trivial
   image, and the README quick start.

Four cards (--four), and nothing else: a WorldBatch of 64 small worlds at
1080p sharded over the cards against the same worlds stepped one at a time
on card 0, and split-frame rendering in 4 bands against the single-card
frame.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CARD = ""   # nvidia-smi's "name, power.limit", set by check_device


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def check_device(n_cards: int):
    """Phase 1: require the GPU backend; print the card."""
    global CARD
    import jax

    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU — JAX backend is {backend!r}",
              file=sys.stderr)
        sys.exit(2)
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = smi.stdout.strip().splitlines()
    CARD = cards[0].strip()
    for line in cards:
        print(line.strip(), flush=True)
    log(f"device: {devices[0].device_kind}, {len(devices)} visible, "
        f"backend {backend}, jax {jax.__version__}")
    return devices


def timed(fn, *args, reps: int = 10):
    """(median ms over `reps` calls after a warm-up call, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def check(ok: bool, what: str, failures: list) -> None:
    log(f"{'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


# -- phase 2: kernels against the plain references ---------------------------

def _edge_ambiguous(records, ids, px, py, ulps: float = 8.0):
    """Per pixel: whether the centre (px, py) lies within `ulps` float32
    ulps of an edge of triangle ids[i] — the edge equation a*px + b*py + c
    is a cancelling sum of terms up to ~6e4 at 1080p, so there the kernel
    and XLA may round (or contract into FMAs) to opposite signs."""
    d = records[np.clip(ids, 0, records.shape[0] - 1)].astype(np.float64)
    e0 = d[:, 0] * px + d[:, 3] * py + d[:, 6]
    e1 = d[:, 1] * px + d[:, 4] * py + d[:, 7]
    e2 = d[:, 9] - e0 - e1
    term = np.max(np.abs(np.stack([
        d[:, 0] * px, d[:, 3] * py, d[:, 6], d[:, 1] * px, d[:, 4] * py,
        d[:, 7], d[:, 9]])), axis=0)
    tol = ulps * np.spacing(term.astype(np.float32)).astype(np.float64)
    return (np.min(np.abs(np.stack([e0, e1, e2])), axis=0) <= tol) & (ids >= 0)


def phase_kernels(scene):
    """Kernels vs plain references at flagship shapes. Tolerances:
    - tri_id: equal wherever the reference's winner beats every other
      slot by > 1e-6 in depth, except at pixel centres within 8 float32
      ulps of an edge of either winner (see _edge_ambiguous);
    - depth, b0, b1: absolute 1e-6 where the ids agree and the winner is
      clear (depth varies slowly over the pile's small far triangles);
    - G-buffer planes shaded from each visibility buffer: relative 1e-5
      (|a - b| <= 1e-5 * max(1, |b|)) where the ids agree;
    - cascade atlas depth: absolute 1e-6, except at texels within 8 ulps
      of a caster edge, which may be covered by one and not the other.
    Returns (failures, jitted opaque-pass and visibility functions)."""
    import jax

    from garden_tpu.render import csm, gbuffer, raster

    failures = []
    r = scene.renderer
    cfg = r.config
    w, h = r.frame_size()
    th = cfg.tile_h or cfg.tile_size
    keys = ("setup", "tile_tris", "counts", "big_list", "records", "pos_pl")

    @jax.jit
    def main_inputs(bodies):
        op = r.opaque_pass(scene.dev_scene, scene.inst_mats(bodies),
                           scene.constants, scene.state["frame"])
        return {k: op[k] for k in keys}

    vis_k = jax.jit(lambda s, t, c, b: raster.rasterize_visibility(
        s, t, c, b, w, h, cfg.tile_size, tile_h=th))
    vis_r = jax.jit(lambda s, t, c, b: raster.rasterize_visibility_reference(
        s, t, c, b, w, h, cfg.tile_size, tile_h=th))

    @jax.jit
    def shade(vis, setup, records):
        with jax.default_matmul_precision("highest"):
            return gbuffer.shade_gbuffer(vis, setup, scene.dev_scene, None,
                                         None, constants=scene.constants,
                                         records=records)

    op = jax.block_until_ready(main_inputs(scene.state["physics"]["bodies"]))
    args = (op["setup"], op["tile_tris"], op["counts"], op["big_list"])
    t_k, vk = timed(vis_k, *args)
    t_r, vr = timed(vis_r, *args)
    log(f"visibility kernel {w}x{h} tiles {cfg.tile_size}x{th}: "
        f"{t_k:.3f} ms (Triton) vs {t_r:.3f} ms (XLA plain reference)")
    vk = jax.tree_util.tree_map(np.asarray, vk)
    vr = jax.tree_util.tree_map(np.asarray, vr)
    records = np.asarray(raster._pack_edge_records(op["setup"]))
    clear = vr["margin"] > 1e-6
    differ = clear & (vk["tri_id"] != vr["tri_id"])
    ys, xs = np.nonzero(differ)
    px, py = xs + 0.5, ys + 0.5
    amb = (_edge_ambiguous(records, vk["tri_id"][ys, xs], px, py)
           | _edge_ambiguous(records, vr["tri_id"][ys, xs], px, py))
    covered = float(np.mean(vr["tri_id"] >= 0))
    log(f"visibility: {covered:.4f} of pixels covered, "
        f"{int(differ.sum())} clear-winner tri_id mismatches, "
        f"{int(amb.sum())} of them at edge-ambiguous centres")
    check(bool(np.all(amb)), "visibility tri_id (edge rule)", failures)
    same = clear & (vk["tri_id"] == vr["tri_id"])
    for k in ("depth", "b0", "b1"):
        err = float(np.max(np.abs(vk[k] - vr[k])[same], initial=0.0))
        check(err <= 1e-6, f"visibility {k}: max abs err {err:.3g} "
              f"(tol 1e-6)", failures)

    gk = jax.tree_util.tree_map(np.asarray, shade(vk, op["setup"],
                                                  op["records"]))
    gr = jax.tree_util.tree_map(np.asarray, shade(vr, op["setup"],
                                                  op["records"]))
    both = vk["tri_id"] == vr["tri_id"]
    for k in ("normal", "uv", "base_color", "metallic", "roughness",
              "emissive", "position"):
        a, b = gk[k][both], gr[k][both]
        err = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                           initial=0.0))
        check(err <= 1e-5, f"G-buffer {k}: max rel err {err:.3g} "
              f"(tol 1e-5)", failures)

    # cascade atlas (the flagship shadow pass)
    scfg = cfg.shadow
    static = {}

    @jax.jit
    def atlas_inputs(pos_pl):
        c = scene.constants
        near = 0.1
        light = csm.fit_cascades(c["inv_view_proj"], c["light_dir"], near,
                                 csm.cascade_splits(scfg, near), near)
        ai = csm.atlas_depth_inputs(csm.light_planes(pos_pl, light),
                                    scene.dev_scene["tri_valid"], light,
                                    scfg)
        static.update({k: v for k, v in ai.items()
                       if isinstance(v, (int, tuple))})
        return {k: v for k, v in ai.items() if k not in static}

    ai = jax.block_until_ready(atlas_inputs(op["pos_pl"]))
    dk = jax.jit(lambda a: raster.rasterize_depth(**a, **static))
    dr = jax.jit(lambda a: raster.rasterize_depth_reference(**a, **static))
    t_k, ak = timed(dk, ai)
    t_r, ar = timed(dr, ai)
    aw, ah = static["width"], static["height"]
    log(f"depth kernel atlas {aw}x{ah} tiles 128x{static['tile_h']}: "
        f"{t_k:.3f} ms (Triton) vs {t_r:.3f} ms (XLA plain reference)")
    ak, ar = np.asarray(ak), np.asarray(ar)
    bad = np.abs(ak - ar) > 1e-6
    ys, xs = np.nonzero(bad)
    arec = np.asarray(raster._pack_edge_records(ai["setup"],
                                                ai["tri_atlas"]))
    # a texel differs legitimately only if some caster edge passes within
    # rounding of its centre: test every live caster of its tile's list
    amb = np.zeros(len(ys), bool)
    if len(ys):
        tiles_x = -(-aw // 128)
        tt = np.asarray(ai["tile_tris"])
        big = np.asarray(ai["big_list"])
        tidx = (ys // static["tile_h"]) * tiles_x + xs // 128
        for j, (y, x, t) in enumerate(zip(ys, xs, tidx)):
            ids = np.concatenate([big[big >= 0], tt[t][tt[t] >= 0]])
            n = len(ids)
            amb[j] = bool(np.any(_edge_ambiguous(
                arec, ids, np.full(n, x + 0.5), np.full(n, y + 0.5))))
    log(f"atlas: {float(np.mean(ar > 0)):.4f} of texels covered, "
        f"{int(bad.sum())} texels differ by > 1e-6, "
        f"{int(amb.sum())} of them at edge-ambiguous centres")
    check(bool(np.all(amb)), "atlas depth (edge rule)", failures)
    return failures, main_inputs, vis_k


# -- phase 3: physics goldens --------------------------------------------------

def _repo_tests_package():
    """Bind `tests` to this checkout's tests/ (a namespace package), which
    an installed package of the same name would otherwise shadow."""
    import importlib.machinery
    import importlib.util

    spec = importlib.machinery.PathFinder.find_spec("tests", [ROOT])
    sys.modules["tests"] = importlib.util.module_from_spec(spec)


def phase_physics():
    _repo_tests_package()
    from tests.golden import scenes
    from tests.golden import test_golden as tg

    failures = []
    t0 = time.perf_counter()
    curves = {name: scenes.simulate(name) for name in scenes.SCENES}
    log(f"golden scenes simulated in {time.perf_counter() - t0:.1f} s")
    for name, c in curves.items():
        gold = np.load(os.path.join(tg.DATA, f"{name}.npz"))
        dev = max(float(np.max(np.abs(c[k] - gold[k]))) for k in gold)
        log(f"golden {name}: max |curve - committed| = {dev:.3g} "
            f"(tol {tg.GPU_ATOL.get(name, tg.GOLDEN_ATOL)})")
    for fn_name in sorted(n for n in dir(tg) if n.startswith("test_")):
        try:
            getattr(tg, fn_name)(curves)
            check(True, f"golden {fn_name}", failures)
        except AssertionError as e:
            check(False, f"golden {fn_name}: {str(e).splitlines()[:3]}",
                  failures)
    return failures


# -- phase 4: the main path ------------------------------------------------------

def phase_main(scene, main_inputs, vis_k, entry, ticks: int = 6):
    import jax
    import jax.numpy as jnp

    failures = []
    fn, args = entry()
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    log(f"entry() compile: {time.perf_counter() - t0:.1f} s")
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f"entry() memory: temp {mem.temp_size_in_bytes} B, "
            f"arguments {mem.argument_size_in_bytes} B, "
            f"outputs {mem.output_size_in_bytes} B")
    state = args[0]
    times = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        state, image = compiled(state)
        jax.block_until_ready((state, image))
        times.append((time.perf_counter() - t0) * 1e3)
    steady = times[1:]
    stats = jax.devices()[0].memory_stats() or {}
    log(f"entry() tick: first {times[0]:.2f} ms, steady median "
        f"{float(np.median(steady)):.2f} ms, min {min(steady):.2f} ms, "
        f"max {max(steady):.2f} ms over {len(steady)} ticks")
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    pos = np.asarray(state["physics"]["bodies"]["pos"])
    img = np.asarray(image).astype(np.float32)
    check(bool(np.isfinite(pos).all()), "body positions finite", failures)
    w, h = scene.renderer.frame_size()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()),
          f"image {img.shape} finite", failures)
    var = float(img.var())
    check(var > 25.0, f"image variance {var:.1f} (floor 25)", failures)
    op = main_inputs(state["physics"]["bodies"])
    vis = vis_k(op["setup"], op["tile_tris"], op["counts"], op["big_list"])
    pile = float(jnp.mean(vis["tri_id"] >= scene.n_ground_tris))
    check(pile > 0.01, f"pile covers {pile:.4f} of the frame after "
          f"{ticks} ticks (floor 0.01)", failures)

    # README quick start
    from garden_tpu.core.config import EngineConfig
    from garden_tpu.engine import Engine
    from garden_tpu.systems.physics import PhysicsSystem
    from garden_tpu.systems.transform import TransformSystem

    t0 = time.perf_counter()
    eng = Engine(EngineConfig())
    eng.create_system(TransformSystem())
    phys = eng.create_system(PhysicsSystem())
    eng.initialize()
    ground = eng.world.create_entity()
    eng.world.add_component(ground, "transform")
    phys.add_rigidbody(ground, phys.physics.shapes.plane((0, 1, 0)),
                       motion=0)
    qs = eng.run_ticks(eng.device_state(), 60, 1 / 60)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(qs)]
    finite = all(np.isfinite(x).all() for x in leaves
                 if np.issubdtype(x.dtype, np.floating))
    check(finite, f"README quick start: 60 ticks in "
          f"{time.perf_counter() - t0:.1f} s, state finite", failures)
    return failures


# -- four cards ------------------------------------------------------------------

def _image_close(img, ref, seams=(), what="", failures=None):
    """The split-frame rule of tests/test_parallel.py: away from band
    seams, 99% of channel values within 2 levels and a mean below 0.5."""
    rows = [y for y in range(ref.shape[0]) if y not in set(seams)]
    diff = np.abs(img[rows].astype(int) - ref[rows].astype(int))
    p99, mean = float(np.percentile(diff, 99)), float(diff.mean())
    check(p99 <= 2 and mean < 0.5, f"{what}: p99 {p99:.0f} levels, mean "
          f"{mean:.4f}", failures)


def phase_four(devices, width=1920, height=1080, n_worlds=64,
               frame_bodies=10240, overrides=None):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from garden_tpu.parallel.frame_tiles import FrameTiles
    from garden_tpu.parallel.worlds import WorldBatch

    failures = []
    devices = devices[:4]

    # small worlds (the dryrun_multichip shape) rendering at full size
    small = ge._build_scene(n_bodies=32, width=width, height=height,
                            grid_dim=8, cfg_overrides=overrides)
    wb = WorldBatch(small.step, n_worlds, devices=devices)

    def vary(s, i):
        b = s["physics"]["bodies"]
        pos = b["pos"].at[1:, 1].add(0.05 * i.astype(jnp.float32))
        return dict(s, physics=dict(s["physics"], bodies=dict(b, pos=pos)))

    batched = wb.replicate(small.state, vary_fn=vary)
    worlds = [jax.tree_util.tree_map(lambda x: np.asarray(x[i]), batched)
              for i in range(n_worlds)]
    t0 = time.perf_counter()
    out_state, images = jax.block_until_ready(wb.step(batched))
    log(f"world batch: {n_worlds} worlds over {len(devices)} cards, first "
        f"step {time.perf_counter() - t0:.1f} s")
    pos = out_state["physics"]["bodies"]["pos"]
    shard_devs = {s.device for s in pos.addressable_shards}
    check(shard_devs == set(devices) and all(
        s.data.shape[0] == n_worlds // 4 for s in pos.addressable_shards),
        f"world batch sharded {n_worlds // 4} worlds on each of "
        f"{len(shard_devs)} distinct cards", failures)
    one = jax.jit(small.step)
    pos_h, img_h = np.asarray(pos), np.asarray(images)
    worst_pos, worst = 0.0, (0.0, 0.0)
    for i, wstate in enumerate(worlds):
        s1, im1 = one(jax.device_put(wstate, devices[0]))
        worst_pos = max(worst_pos, float(np.max(np.abs(
            np.asarray(s1["physics"]["bodies"]["pos"]) - pos_h[i]))))
        d = np.abs(np.asarray(im1).astype(int) - img_h[i].astype(int))
        worst = max(worst, (float(np.percentile(d, 99)), float(d.mean())))
    check(worst_pos <= 1e-4, f"world batch vs one at a time on card 0: "
          f"max |pos diff| {worst_pos:.3g} (tol 1e-4)", failures)
    check(worst[0] <= 2 and worst[1] < 0.5, f"world batch images vs card 0: "
          f"worst p99 {worst[0]:.0f} levels, worst mean {worst[1]:.4f}",
          failures)

    # split-frame rendering: 4 bands of the flagship frame, with the
    # effects whose reach crosses band seams off (bloom, auto exposure,
    # HBAO, FXAA: the tests/test_parallel.py configuration), so the bands
    # must stitch into the single-card frame
    flag = ge._build_scene(n_bodies=frame_bodies, width=width,
                           height=height, grid_dim=64,
                           cfg_overrides=dict(
                               overrides or {}, use_bloom=False,
                               use_auto_exposure=False, use_hbao=False,
                               use_fxaa=False))
    r = flag.renderer
    mats = flag.inst_mats(flag.state["physics"]["bodies"])
    ft = FrameTiles(r.config, r.scene_host, n_bands=4, overlap=16,
                    devices=devices)
    t0 = time.perf_counter()
    img, fstate = ft.render(ft.renderer.device_scene(), mats,
                            flag.constants, ft.initial_state())
    img = np.asarray(jax.block_until_ready(img))
    log(f"split frame: 4 bands over {len(devices)} cards, first frame "
        f"{time.perf_counter() - t0:.1f} s")
    lum = fstate["avg_luminance"]
    check(len({s.device for s in lum.addressable_shards}) == 4,
          "split-frame state sharded over 4 distinct cards", failures)
    single = jax.jit(lambda m: r.render(flag.dev_scene, m, flag.constants,
                                        r.initial_frame_state())["image"])
    ref = np.asarray(single(jax.device_put(mats, devices[0])))
    band_h = height // 4
    seams = [y for b in range(1, 4) for y in range(b * band_h - 2,
                                                    b * band_h + 2)]
    _image_close(img, ref, seams, "split frame vs single-card frame",
                 failures)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    devices = check_device(4 if args.four else 1)
    from garden_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if args.four:
        failures = phase_four(devices)
    else:
        import __graft_entry__ as ge

        scene = ge._build_scene(n_bodies=10240, width=1920, height=1080,
                                grid_dim=64)
        failures, main_inputs, vis_k = phase_kernels(scene)
        failures += phase_physics()
        failures += phase_main(scene, main_inputs, vis_k, ge.entry)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
