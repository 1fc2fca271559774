"""Frame profiling.

Rebuild of the reference's observability stack (SURVEY.md section 5.1):
Tracy CPU zones (SET_CPU_ZONE_SCOPED, profiler.hpp:18-24), GPU debug labels
and frame timestamps (vulkan/command-buffer.cpp:419-431). Equivalents here:
`zone()` wraps jax.named_scope (shows up in xplane traces) + wall timing;
`FrameProfiler` records per-pass block_until_ready deltas and frame marks;
`trace()` wraps jax.profiler trace capture, and `device_trace_summary()`
reduces a captured trace to per-op device time and device busy time.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import jax


@contextlib.contextmanager
def zone(name: str) -> Iterator[None]:
    """Named scope: appears in XLA/xplane traces (SET_CPU_ZONE_SCOPED)."""
    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (Tracy capture analog)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _union_ns(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_trace_summary(trace_dir: str) -> Dict[str, Any]:
    """Reduce the newest jax.profiler trace under `trace_dir` with
    jax.profiler.ProfileData alone. Device planes (`/device:...`) hold one
    line per stream whose events are the kernels XLA and Pallas launched.
    Returns {"ops": {name: (total_ns, count)}, "busy_ns": {plane: union of
    its kernel intervals}, "span_ns": {plane: first start to last end}}."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    busy, span = {}, {}
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        spans = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                ops[ev.name][0] += ev.duration_ns
                ops[ev.name][1] += 1
                spans.append((ev.start_ns, ev.end_ns))
        if spans:
            busy[plane.name] = _union_ns(spans)
            span[plane.name] = (max(e for _, e in spans)
                                - min(s for s, _ in spans))
    return {"ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "busy_ns": busy, "span_ns": span}


class FrameProfiler:
    """Wall-clock pass timings with running averages (editor stats analog:
    lastFps + per-pass GPU time, editor.hpp:69)."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.averages: Dict[str, float] = defaultdict(float)
        self._start: Dict[str, float] = {}
        self._frame_start: Optional[float] = None
        self.frame_ms = 0.0
        self.fps = 0.0

    @contextlib.contextmanager
    def pass_timer(self, name: str, result=None) -> Iterator[None]:
        """Time a pass; pass the output array to block on for device time."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        dt = (time.perf_counter() - t0) * 1000.0
        old = self.averages[name]
        self.averages[name] = old * self.smoothing + dt * (1 - self.smoothing) \
            if old else dt

    def frame_mark(self) -> None:
        """Call once per frame (Tracy FrameMark, graphics.cpp:455-457)."""
        now = time.perf_counter()
        if self._frame_start is not None:
            dt = (now - self._frame_start) * 1000.0
            self.frame_ms = self.frame_ms * self.smoothing + dt * (1 - self.smoothing) \
                if self.frame_ms else dt
            self.fps = 1000.0 / max(self.frame_ms, 1e-6)
        self._frame_start = now

    def report(self) -> str:
        lines = [f"frame: {self.frame_ms:.2f} ms ({self.fps:.1f} fps)"]
        for name, ms in sorted(self.averages.items()):
            lines.append(f"  {name}: {ms:.2f} ms")
        return "\n".join(lines)
