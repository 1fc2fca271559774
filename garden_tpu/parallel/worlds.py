"""Many-world simulation batched across devices.

The reference is a single-node, single-GPU engine; its only distribution is
TCP/UDP game networking (SURVEY.md sections 2.11/5.8). The scaling axis
here is a leading world-batch dimension: per-device batching via vmap,
cross-device scaling via shard_map over a flat mesh (every card reaches
every other alike) — steady-state simulation is embarrassingly parallel,
so collectives only appear in metric reduction (a mean over worlds) and
optional frame gathers. The step runs under shard_map, so each device
steps only its own worlds: XLA's partitioner cannot split the raster's
Pallas calls, and would otherwise gather the whole batch onto every
device.

Usage:
    wb = WorldBatch(step_fn, n_worlds, devices=jax.devices())
    batched = wb.replicate(state)            # or stack different states
    batched = wb.step(batched)               # jit(shard_map(vmap(step)))
    stats = wb.reduce(batched, fn)           # cross-world reduction
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

State = Any


class WorldBatch:
    def __init__(self, step_fn: Callable, n_worlds: int,
                 devices: Optional[Sequence] = None,
                 axis_name: str = "worlds"):
        devices = list(devices if devices is not None else jax.devices())
        if n_worlds % len(devices) != 0:
            # shrink to the largest divisor so each device gets equal worlds
            while n_worlds % len(devices) != 0:
                devices.pop()
        self.n_worlds = n_worlds
        self.axis_name = axis_name
        self.mesh = Mesh(np.array(devices), axis_names=(axis_name,))
        self.sharding = NamedSharding(self.mesh, P(axis_name))
        self.replicated = NamedSharding(self.mesh, P())
        self._step = jax.jit(
            jax.shard_map(jax.vmap(step_fn), mesh=self.mesh,
                          in_specs=(P(axis_name),), out_specs=P(axis_name),
                          check_vma=False),
            donate_argnums=0,
        )

    def replicate(self, state: State, vary_fn: Optional[Callable] = None) -> State:
        """Broadcast one world state to the batch; `vary_fn(state, index)`
        (vmapped) can decorrelate worlds (e.g. nudge positions by RNG)."""
        batched = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(
                x, (self.n_worlds,) + jnp.shape(x)).copy(),
            state,
        )
        if vary_fn is not None:
            batched = jax.vmap(vary_fn)(
                batched, jnp.arange(self.n_worlds))
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, self.sharding), batched
        )

    def stack(self, states: List[State]) -> State:
        batched = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *states
        )
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, self.sharding), batched
        )

    def step(self, batched: State) -> State:
        return self._step(batched)

    def reduce(self, batched: State, fn: Callable, reducer: str = "mean") -> Any:
        """Cross-world metric reduction (one all-reduce over the mesh)."""
        vals = jax.jit(jax.vmap(fn))(batched)
        red = {"mean": jnp.mean, "sum": jnp.sum, "max": jnp.max,
               "min": jnp.min}[reducer]
        return jax.tree_util.tree_map(lambda v: red(v, axis=0), vals)

    def world(self, batched: State, index: int) -> State:
        """Extract one world's state to the host."""
        return jax.tree_util.tree_map(lambda x: np.asarray(x[index]), batched)
