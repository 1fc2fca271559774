"""Engine: composes systems into one jitted per-tick step + host loop.

Rebuild of the reference's application spine: GARDEN_DECLARE_MAIN
(include/garden/main.hpp:41-65), Manager::update's ordered
Input -> Update -> Output event chain (docs/ECS/Systems.md), and the
headless LoopSystem tick loop with delta-time tracking and max tick rate
(include/garden/system/loop.hpp:57, source/system/loop.cpp:53-96).

Device mapping: every event subscriber is a pure `(state, ctx) -> state`
function, so running Input/Update/Output in order inside `jax.jit` yields a
single compiled step for the whole frame. The host loop only feeds wall-time
deltas and (optionally) sleeps to the tick-rate cap; signal handlers stop the
loop cleanly (loop.cpp:30-51).
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

from garden_tpu.core import log
from garden_tpu.core.config import EngineConfig
from garden_tpu.core.ecs import World


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self.world = World(capacity=self.config.capacity)
        self._step = None
        self._running = False
        self._extra_state: Dict[str, Callable[[], Any]] = {}

    # -- composition ---------------------------------------------------------

    def create_system(self, system, name: Optional[str] = None):
        return self.world.create_system(system, name)

    def register_state(self, key: str, provider: Callable[[], Any]) -> None:
        """Register an extra state subtree (e.g. 'physics', 'frame')."""
        self._extra_state[key] = provider

    def initialize(self) -> None:
        self.world.initialize()
        # physics system auto-registers its state subtree
        phys = self.world.systems.get("PhysicsSystem")
        if phys is not None and "physics" not in self._extra_state:
            self.register_state("physics", phys.device_state)

    # -- state ----------------------------------------------------------------

    def device_state(self) -> Dict[str, Any]:
        state = self.world.device_state()
        for key, provider in self._extra_state.items():
            state[key] = provider()
        state["tick"] = jnp.int32(0)
        state["time"] = jnp.float32(0.0)
        return state

    # -- the jitted step -------------------------------------------------------

    def build_step(self, donate: bool = True) -> Callable:
        """Compile Input -> Update -> Output into one step function."""
        events = self.world.events

        def step(state: Dict[str, Any], delta_time) -> Dict[str, Any]:
            ctx = {
                "delta_time": jnp.asarray(delta_time, jnp.float32),
                "time": state["time"],
                "tick": state["tick"],
            }
            for event in ("Input", "Update", "Output"):
                state = events.run(event, state, ctx)
            return dict(
                state,
                tick=state["tick"] + 1,
                time=state["time"] + ctx["delta_time"],
            )

        self._step = jax.jit(step, donate_argnums=(0,) if donate else ())
        return self._step

    # -- host loop (LoopSystem analog) -----------------------------------------

    def enter_loop(self, state: Dict[str, Any], max_ticks: Optional[int] = None,
                   tick_rate: Optional[int] = None) -> Dict[str, Any]:
        """Run the tick loop at a capped rate until stopped (loop.cpp:53-96)."""
        if self._step is None:
            self.build_step()
        tick_rate = tick_rate or self.config.max_tick_rate
        min_dt = 1.0 / tick_rate if tick_rate > 0 else 0.0
        self._running = True

        def stop(sig, frame):
            self._running = False

        old_handlers = {}
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                old_handlers[sig] = signal.signal(sig, stop)
            except ValueError:  # not on main thread
                pass

        try:
            last = time.monotonic()
            ticks = 0
            while self._running and (max_ticks is None or ticks < max_ticks):
                now = time.monotonic()
                delta = now - last
                if delta < min_dt:
                    time.sleep(min_dt - delta)
                    now = time.monotonic()
                    delta = now - last
                last = now
                state = self._step(state, delta)
                ticks += 1
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return state

    def run_ticks(self, state: Dict[str, Any], n: int, dt: float) -> Dict[str, Any]:
        """Run n ticks with a fixed delta (deterministic/headless testing)."""
        if self._step is None:
            self.build_step()
        for _ in range(n):
            state = self._step(state, dt)
        return state
