"""Per-op device time of the flagship combined tick on one GPU.

    python tools/trace_frame.py [--physics] [--top 30]

Runs the combined step (or, with --physics, the physics step alone) with
the state carried across ticks, traces a short window with jax.profiler,
and prints the device ops ranked by total time, the device busy time and
its share of the traced window. The trace stays in chiprun_out/trace_frame
(or chiprun_out/trace_physics). Exits non-zero without a GPU.
"""

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--physics", action="store_true")
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit(f"trace_frame needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")

    import __graft_entry__ as ge
    from garden_tpu.physics import world as pw
    from garden_tpu.utils.compile_cache import enable_compile_cache
    from garden_tpu.utils.profiler import device_trace_summary

    enable_compile_cache()
    b = ge._build_scene(n_bodies=10240, width=1920, height=1080,
                        grid_dim=64)
    if args.physics:
        fn = jax.jit(lambda s: pw.step(s, b.pcfg, 1.0 / 60.0, b.types))
        state = b.state["physics"]
        tick = lambda s: (fn(s),) * 2
    else:
        fn = jax.jit(b.step)
        state = b.state
        tick = fn
    state, out = tick(state)
    jax.block_until_ready(out)

    out_dir = os.path.join(ge.__file__.rsplit(os.sep, 1)[0], "chiprun_out",
                           "trace_physics" if args.physics else "trace_frame")
    shutil.rmtree(out_dir, ignore_errors=True)
    jax.profiler.start_trace(out_dir)
    for _ in range(args.ticks):
        state, out = tick(state)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()

    summary = device_trace_summary(out_dir)
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])
    print(f"{'op':<64s} {'n':>5s} {'ms/tick':>9s}")
    for name, (ns, n) in ops[:args.top]:
        print(f"{name[:64]:<64s} {n:>5d} {ns / 1e6 / args.ticks:>9.3f}")
    for plane, busy in summary["busy_ns"].items():
        span = summary["span_ns"][plane]
        print(f"{plane}: busy {busy / 1e6 / args.ticks:.3f} ms/tick, "
              f"{busy / span:.3f} of the traced window")


if __name__ == "__main__":
    main()
