"""Headline benchmark on one GPU: the north-star combined step — 10K rigid
bodies stepped at 60 Hz + a 1080p all-on deferred-PBR frame in one jitted
function (BASELINE.md rebuild targets) — and the physics step alone.

    python bench.py

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}
with the device it ran on. Baseline: 60 Hz (the reference's frame-rate and
fixed-step defaults, graphics.hpp:136 / physics.hpp:796). Times are host
wall clock around ticks that end in block_until_ready; device busy time
comes from a profiler trace of a separate short window. There is no CPU
fallback: without a GPU the script exits non-zero.
"""

import json
import subprocess
import sys
import tempfile
import time

import jax
import numpy as np

from garden_tpu.core.config import PhysicsConfig
from garden_tpu.physics import world as pw
from garden_tpu.utils.compile_cache import enable_compile_cache
from garden_tpu.utils.profiler import device_trace_summary

BASELINE_HZ = 60.0


def build_world(n: int = 10240) -> tuple:
    # ONE north-star physics workload: identical contact budget and solver
    # iterations to __graft_entry__._build. 7 grid candidates + 1 global
    # (the ground plane) = K=8 pairs total: the active budget covers every
    # candidate, so collide takes the compaction-free path (world.collide
    # notes)
    cfg = PhysicsConfig(max_bodies=n, grid_dim=64, cell_size=2.0,
                        max_contacts_per_body=7, solver_iterations=8,
                        max_globals=1, max_active_contacts=16)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0.0, 1.0, 0.0), 0.0), motion=pw.STATIC)
    box = w.shapes.box((0.45, 0.45, 0.45))
    sph = w.shapes.sphere(0.45)
    count = 0
    side = 22
    for ix in range(side):
        for iz in range(side):
            for iy in range(side):
                if count >= n - 1:
                    break
                w.add_body(box if count % 2 == 0 else sph,
                           position=(ix * 1.05 - side / 2, 0.5 + iy * 1.05,
                                     iz * 1.05 - side / 2),
                           friction=0.5)
                count += 1
    return w, cfg, count


def measure(step, state, ticks: int = 20, traced: int = 4):
    """(median wall ms per tick, device busy ms per tick, final state) of
    `step` (state -> state or (state, output)) after one compiling call."""
    def run(s):
        out = step(s)
        return out[0] if isinstance(out, tuple) else out, out

    state, out = run(state)
    jax.block_until_ready(out)
    times = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        state, out = run(state)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(traced):
            state, out = run(state)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        busy = sum(device_trace_summary(d)["busy_ns"].values())
    return float(np.median(times)), busy / 1e6 / traced, state


def main() -> None:
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    w, cfg, count = build_world()
    types = w.shapes.present_types()
    phys = jax.jit(lambda s: pw.step(s, cfg, 1.0 / 60.0, types),
                   donate_argnums=0)
    phys_ms, phys_busy, state = measure(phys, w.device_state())
    assert np.isfinite(np.asarray(state["bodies"]["pos"])).all()
    del state

    import __graft_entry__ as ge
    step, fstate = ge._build(n_bodies=10240, width=1920, height=1080,
                             grid_dim=64)
    frame_ms, frame_busy, fstate = measure(
        jax.jit(step, donate_argnums=0), fstate)
    assert np.isfinite(np.asarray(fstate["physics"]["bodies"]["pos"])).all()

    d = jax.devices()
    print(json.dumps({
        "metric": "1080p deferred-PBR combined step (10240 bodies), 1 GPU",
        "value": round(1000.0 / frame_ms, 2),
        "unit": "fps (wall clock)",
        "vs_baseline": round(1000.0 / frame_ms / BASELINE_HZ, 3),
        "frame_ms": round(frame_ms, 3),
        "frame_device_busy_ms": round(frame_busy, 3),
        "physics_steps_per_sec": round(1000.0 / phys_ms, 2),
        "physics_ms": round(phys_ms, 3),
        "physics_device_busy_ms": round(phys_busy, 3),
        "physics_bodies": count,
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d)},
        "card": card,
    }))


if __name__ == "__main__":
    main()
