"""Physics world: body store, the fixed step, and the tick accumulator.

Rebuild of PhysicsSystem (reference: include/garden/system/physics.hpp:667,
source/system/physics.cpp). Maps:

- Jolt body pool + RigidbodyComponent (physics.hpp:362) -> fixed-capacity
  SoA body arrays (capacity contract mirrors maxRigidbodyCount,
  physics.hpp:679-685).
- collision layers NonMoving/Moving/Sensor/HqDebris/LqDebris and their
  broadphase mapping (physics.hpp:194-225) -> int layer ids + a boolean
  collision-filter table.
- `PhysicsSystem::simulate`'s fixed-rate accumulator with interpolation and
  cascade-lag clamping (physics.cpp:1154-1222) -> `simulate()` below; the
  previous pose is kept for render interpolation (physics.cpp:1108-1144).
- Jolt's Update (broadphase/narrowphase/solve/integrate) -> `step()`:
  vectorized stages from broadphase.py/narrowphase.py/solver.py plus
  semi-implicit Euler integration.

The whole body state is a pytree; `step` is pure and jit/vmap/shard-friendly
(a leading world-batch axis batches many independent worlds per chip).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3
from garden_tpu.core.config import PhysicsConfig
from garden_tpu.physics import broadphase, narrowphase, solver
from garden_tpu.physics import shapes as sh

Array = jnp.ndarray

# motion types (physics.hpp:43-49)
STATIC = 0
KINEMATIC = 1
DYNAMIC = 2

# collision layers (physics.hpp:194-225)
LAYER_NON_MOVING = 0
LAYER_MOVING = 1
LAYER_SENSOR = 2
LAYER_HQ_DEBRIS = 3
LAYER_LQ_DEBRIS = 4
NUM_LAYERS = 5

# grid-bypassing big-body slots default (configurable via
# PhysicsConfig.max_globals; kept for back-compat imports)
MAX_GLOBALS = 8


def default_layer_table() -> np.ndarray:
    """Which layers collide (mirrors ObjectLayerPairFilter in the reference:
    non-moving collides with moving-ish layers, sensors only with moving)."""
    t = np.zeros((NUM_LAYERS, NUM_LAYERS), dtype=bool)

    def allow(a, b):
        t[a, b] = True
        t[b, a] = True

    allow(LAYER_NON_MOVING, LAYER_MOVING)
    allow(LAYER_NON_MOVING, LAYER_HQ_DEBRIS)
    allow(LAYER_NON_MOVING, LAYER_LQ_DEBRIS)
    allow(LAYER_MOVING, LAYER_MOVING)
    allow(LAYER_MOVING, LAYER_HQ_DEBRIS)
    allow(LAYER_MOVING, LAYER_SENSOR)
    allow(LAYER_HQ_DEBRIS, LAYER_HQ_DEBRIS)
    return t


class PhysicsWorld:
    """Host-side builder for a physics state pytree (the Jolt world analog)."""

    def __init__(self, config: PhysicsConfig, shape_table: Optional[sh.ShapeTable] = None):
        self.config = config
        self.shapes = shape_table or sh.ShapeTable()
        n = config.max_bodies
        self._b: Dict[str, np.ndarray] = {
            "has": np.zeros((n,), bool),
            "shape": np.zeros((n,), np.int32),
            "motion": np.zeros((n,), np.int32),
            "pos": np.zeros((n, 3), np.float32),
            "quat": np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1)),
            "linvel": np.zeros((n, 3), np.float32),
            "angvel": np.zeros((n, 3), np.float32),
            "inv_mass": np.zeros((n,), np.float32),
            "inv_inertia": np.zeros((n, 3), np.float32),
            "friction": np.full((n,), 0.5, np.float32),
            "restitution": np.zeros((n,), np.float32),
            "layer": np.zeros((n,), np.int32),
            "is_sensor": np.zeros((n,), bool),
            "is_global": np.zeros((n,), bool),
            "linear_factor": np.ones((n, 3), np.float32),
            "angular_factor": np.ones((n, 3), np.float32),
            "entity": np.full((n,), -1, np.int32),  # ECS backref
            # per-body ground-support slope threshold (cos of max slope;
            # CharacterVirtual's maxSlopeAngle, character.hpp:56-64)
            "ground_cos": np.full((n,), 0.7071, np.float32),
        }
        self._count = 0

    def add_body(
        self,
        shape: int,
        position=(0.0, 0.0, 0.0),
        rotation=(0.0, 0.0, 0.0, 1.0),
        motion: int = DYNAMIC,
        linvel=(0.0, 0.0, 0.0),
        angvel=(0.0, 0.0, 0.0),
        friction: float = 0.5,
        restitution: float = 0.0,
        layer: Optional[int] = None,
        is_sensor: bool = False,
        mass_override: Optional[float] = None,
        linear_factor=(1.0, 1.0, 1.0),
        angular_factor=(1.0, 1.0, 1.0),
        entity: int = -1,
        ground_cos: float = 0.7071,
    ) -> int:
        if self._count >= self.config.max_bodies:
            raise RuntimeError("body capacity exhausted")
        i = self._count
        self._count += 1
        b = self._b
        b["has"][i] = True
        b["shape"][i] = shape
        b["motion"][i] = motion
        b["pos"][i] = position
        b["quat"][i] = rotation
        b["linvel"][i] = linvel
        b["angvel"][i] = angvel
        b["friction"][i] = friction
        b["restitution"][i] = restitution
        b["is_sensor"][i] = is_sensor
        b["entity"][i] = entity
        b["linear_factor"][i] = linear_factor
        b["angular_factor"][i] = angular_factor
        b["ground_cos"][i] = ground_cos
        stype = int(self.shapes.types[shape])
        if layer is None:
            layer = LAYER_MOVING if motion == DYNAMIC else LAYER_NON_MOVING
            if is_sensor:
                layer = LAYER_SENSOR
        b["layer"][i] = layer
        b["is_global"][i] = stype in (sh.PLANE, sh.HEIGHTFIELD, sh.MESH)
        if motion == DYNAMIC and stype == sh.MESH:
            # Jolt MeshShape is static-only too (physics.hpp:103-153)
            raise ValueError("mesh-shaped bodies must be STATIC/KINEMATIC")
        if motion == DYNAMIC:
            # host-side numpy: 10K add_body calls must not dispatch device ops
            mass, inertia = self.shapes.body_mass_properties(shape)
            if mass_override is not None:
                inertia = inertia * (mass_override / mass)
                mass = mass_override
            b["inv_mass"][i] = 1.0 / mass
            b["inv_inertia"][i] = 1.0 / np.maximum(inertia, 1e-12)
        return i

    def device_state(self) -> Dict[str, Any]:
        bodies = {k: jnp.asarray(v) for k, v in self._b.items()}
        bodies["sleep_timer"] = jnp.zeros((self.config.max_bodies,), jnp.float32)
        bodies["sleeping"] = jnp.zeros((self.config.max_bodies,), bool)
        n = self.config.max_bodies
        k = self.config.max_contacts_per_body + self.config.max_globals
        ca = (n, min(active_pair_budget(self.config), k)
              * narrowphase.MAX_POINTS)
        return {
            "bodies": bodies,
            # independent copies: donation requires unaliased buffers
            "prev_pos": jnp.array(self._b["pos"]),
            "prev_quat": jnp.array(self._b["quat"]),
            "shapes": self.shapes.device_arrays(),
            "layer_table": jnp.asarray(default_layer_table()),
            # persistent contact impulses for warm starting, stored in the
            # COMPACTED layout; `key` = partner*4 + manifold-point index is
            # each slot's pair identity, re-matched each step by a dense
            # (s x s) comparison so stale impulses never misfire onto a
            # different contact (slot churn during impacts otherwise
            # injects momentum -> popcorn)
            "warm": {
                "n": jnp.zeros(ca, jnp.float32),
                "t1": jnp.zeros(ca, jnp.float32),
                "t2": jnp.zeros(ca, jnp.float32),
                # PAIR-level identity: one key per kept pair (the partner
                # id); points transfer positionally (see step warm_match)
                "key": jnp.full((n, ca[1] // narrowphase.MAX_POINTS), -1,
                                jnp.int32),
            },
            "accum": jnp.float32(0.0),
            "lag_time": jnp.float32(0.0),
            "time": jnp.float32(0.0),
            # per-body ground-support flag (character controllers,
            # body-event detection)
            "grounded": jnp.zeros((n,), bool),
            # per-slot touching partners (contact events); compacted width
            "touching": jnp.full(ca, -1, jnp.int32),
        }


# ---------------------------------------------------------------------------
# The fixed step (pure function of state)
# ---------------------------------------------------------------------------


def collide(state: Dict[str, Any], config: PhysicsConfig,
            present_types: Any = None) -> Dict[str, Array]:
    """Broadphase + narrowphase -> compacted per-body contact rows.

    `present_types`: static frozenset from ShapeTable.present_types() for
    trace-time narrowphase kernel pruning."""
    b = state["bodies"]
    shapes_t = state["shapes"]
    stype = shapes_t["type"][b["shape"]]
    params = shapes_t["params"][b["shape"]]

    # speculative margin scales with speed (Jolt's velocity-based
    # speculative contact distance): fast bodies see their contacts one
    # step early, so the solver can land them exactly instead of tunneling
    scope = jax.named_scope
    h = 1.0 / config.simulation_rate
    speed = jnp.linalg.norm(b["linvel"], axis=-1)
    margin = config.speculative_margin + speed * h * 1.1
    hull_ext = shapes_t["hull_ext"][params[:, 0].astype(jnp.int32)
                                    % shapes_t["hull_ext"].shape[0]]
    comp_ext = shapes_t["comp_ext"][params[:, 0].astype(jnp.int32)
                                    % shapes_t["comp_ext"].shape[0]]
    aabb_min, aabb_max = broadphase.body_aabbs(
        b["pos"], b["quat"], stype, params, margin=0.0,
        hull_ext=hull_ext, comp_ext=comp_ext,
    )
    # The grid inserts each AABB into at most 2x2x2 cells, so the expanded
    # span must stay <= 2*cell_size per axis or candidate pairs are silently
    # lost (the home cell of an overlap can fall outside the insertion
    # block). Clamp the speculative margin to guarantee the invariant —
    # implied speed limit: v_max ~= (2*cell_size - shape_span)/2 / (1.1*h),
    # e.g. ~49 m/s for a 0.9-unit box in 2.0-unit cells at 60 Hz (the floor
    # keeps at least the configured baseline margin). STATIC/KINEMATIC
    # bodies whose span still exceeds 2 cells (large level geometry) fall
    # back to the grid-bypassing global list; dynamic bodies must be sized
    # under 2*cell_size (the global list is one-sided and would break the
    # solver's symmetric row layout).
    span = jnp.max(aabb_max - aabb_min, axis=-1)
    # quantization inflation: the broadphase rounds AABBs outward to a
    # 10-bit grid (broadphase step 1), adding up to one step per side
    qstep = config.cell_size * config.grid_dim / 1024.0
    margin = jnp.minimum(
        margin,
        jnp.maximum((2.0 * config.cell_size - span) * 0.5 - qstep - 1e-3,
                    config.speculative_margin))
    is_global = b["is_global"] | (
        (span + 2.0 * margin + 2.0 * qstep > 2.0 * config.cell_size)
        & (b["motion"] != DYNAMIC))
    aabb_min = aabb_min - margin[:, None]
    aabb_max = aabb_max + margin[:, None]
    dynamic = b["motion"] == DYNAMIC
    with scope("broadphase"):
        cand_idx, cand_valid = broadphase.find_candidates(
            b["pos"], aabb_min, aabb_max,
            active=b["has"], dynamic=dynamic,
            layer=b["layer"], layer_table=state["layer_table"],
            is_global=is_global,
            cell_size=config.cell_size,
            grid_dim=config.grid_dim,
            cand_per_cell=config.max_bodies_per_cell,
            max_candidates=config.max_contacts_per_body,
            max_globals=config.max_globals,
        )
    n, k = cand_idx.shape
    pair_i = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, k)).reshape(-1)
    pair_j = cand_idx.reshape(-1)
    pair_valid = cand_valid.reshape(-1)

    # per-body margin rides the narrowphase's packed record (one gather
    # instead of two extra 245K-element gathers here)
    with scope("narrowphase"):
        man = narrowphase.generate_contacts(
            b["pos"], b["quat"], stype, params,
            pair_i, pair_j, pair_valid,
            margin=margin,
            present_types=present_types,
            tables=shapes_t,
            row_major_k=k,
        )
    # re-orient: manifold normals point A->B in canonical (type-sorted)
    # order; the row layout wants row-body -> partner
    flip = (man["a"] != pair_i)[:, None, None]
    normal = jnp.where(flip, -man["normal"], man["normal"])

    # PAIR-level compaction into (N, K_act) pairs x MAX_POINTS points:
    # all slots of one pair share the partner, so the solver's
    # per-iteration partner gathers shrink to (N, K_act) ROWS (gathers
    # price per row; a slot-level compaction would fetch the same
    # partner row once per manifold point — 2x the rows),
    # and a kept pair always keeps its WHOLE manifold (slot-level budgets
    # could truncate a 4-point resting manifold mid-way, which torques the
    # box). top_k keeps the first `active_pair_budget` touching pairs per
    # row in stable order (globals first — broadphase emits them first).
    # All per-pair fields pack into ONE (N, K, 8*mp + 1) record so the
    # compaction is a single one-hot contraction at HIGHEST precision
    # (separate per-field contractions lower to many small reductions).
    mp = narrowphase.MAX_POINTS
    pair_ok = jnp.any(man["valid"].reshape(n, k, mp), axis=-1)  # (N, K)
    k_act = min(active_pair_budget(config), k)
    s_act = k_act * mp
    if k_act >= k:
        # FREE path: when the active budget covers every candidate pair,
        # the candidate layout IS the solver layout — (n*k, mp, ...) ->
        # (n, k*mp, ...) merges leading dims (a bitcast, no relayout), so
        # the whole pack+top_k+one-hot compaction stage drops out
        # (its packed-record concats/tiles of 4-wide columns are a
        # relayout per operand).
        # The north-star configs (bench.py / __graft_entry__) size
        # max_active_contacts to take this path: strictly better manifold
        # retention (nothing is ever dropped) AND faster.
        s_all = k * mp
        return {
            "point": man["point"].reshape(n, s_all, 3),
            "normal": normal.reshape(n, s_all, 3),
            "pen": man["pen"].reshape(n, s_all),
            "valid": man["valid"].reshape(n, s_all),
            "pair_partner": cand_idx,              # (N, K)
            "partner": jnp.broadcast_to(
                cand_idx[:, :, None], (n, k, mp)).reshape(n, s_all),
        }
    with scope("contact_compact"):
        rank = jnp.where(pair_ok,
                         k - jnp.arange(k, dtype=jnp.int32)[None, :], 0)
        _, sel = jax.lax.top_k(rank, k_act)                # (N, K_act)
        packed = jnp.concatenate(
            [man["point"].reshape(n, k, mp * 3),
             normal.reshape(n, k, mp * 3),
             man["pen"].reshape(n, k, mp),
             man["valid"].reshape(n, k, mp).astype(jnp.float32),
             cand_idx.astype(jnp.float32)[..., None]], axis=-1)
        cpk = m3.gather_rows(packed, sel)              # (N, K_act, 8mp+1)
    pair_partner = cpk[..., 8 * mp].astype(jnp.int32)  # (N, K_act)
    compact = {
        "point": cpk[..., 0:3 * mp].reshape(n, s_act, 3),
        "normal": cpk[..., 3 * mp:6 * mp].reshape(n, s_act, 3),
        "pen": cpk[..., 6 * mp:7 * mp].reshape(n, s_act),
        "valid": cpk[..., 7 * mp:8 * mp].reshape(n, s_act) > 0.5,
        # pair-level partner for row gathers + slot-level view for dense
        # per-point consumers (grounded/touching/tests)
        "pair_partner": pair_partner,
        "partner": jnp.broadcast_to(
            pair_partner[:, :, None], (n, k_act, mp)).reshape(n, s_act),
    }
    return compact


def active_pair_budget(config: PhysicsConfig) -> int:
    """Active contact-PAIR budget per body row: `max_active_contacts` is
    the historical point-slot budget; a resting manifold holds up to
    MAX_POINTS points, so half that count in whole pairs covers the same
    piles with better manifold completeness (see collide)."""
    return max(config.max_active_contacts // 2, 1)


def step(state: Dict[str, Any], config: PhysicsConfig,
         dt: Optional[float] = None,
         present_types: Any = None) -> Dict[str, Any]:
    """One fixed physics step (the Jolt PhysicsSystem::Update analog)."""
    if dt is None:
        dt = 1.0 / config.simulation_rate
    b = state["bodies"]
    dynamic = (b["motion"] == DYNAMIC) & b["has"]

    # gravity (applied before the solve, as Jolt does); locked DOFs
    # (AllowedDOF, physics.hpp:54-65) zero their velocity components
    gravity = jnp.asarray(config.gravity, jnp.float32)
    linvel = b["linvel"] + jnp.where(
        dynamic[:, None], gravity * dt * b["linear_factor"], 0.0
    )
    linvel = jnp.where(dynamic[:, None], linvel * b["linear_factor"], linvel)
    angvel = jnp.where(
        dynamic[:, None], b["angvel"] * b["angular_factor"], b["angvel"]
    )
    b = dict(b, linvel=linvel, angvel=angvel)
    state = dict(state, bodies=b)

    with jax.named_scope("collide"):
        contacts = collide(state, config, present_types)
    # warm starting: impulses persist in the COMPACTED layout, identified by
    # key = partner*4 + manifold-point index. Matching old slots to new is a
    # dense (s_act x s_act) comparison + one one-hot contraction — no
    # gathers, no full-layout scatter.
    mp = narrowphase.MAX_POINTS
    with jax.named_scope("warm_match"):
        # PAIR-level matching: a row's partner is unique per pair (the
        # broadphase home-cell rule dedups pairs), so the pair identity is
        # just the partner id and the mp manifold points transfer
        # POSITIONALLY (tie-stable manifolds keep point order stable
        # across steps, narrowphase._top4_sorted). The former slot-level
        # key compare built an (N, s_act, s_act) match against
        # (N, s_act, 3) impulses; pair-level shrinks the dense compare
        # 16x and the contraction 4x.
        n_b, k_act_w = contacts["pair_partner"].shape
        pair_ok_any = jnp.any(
            contacts["valid"].reshape(n_b, k_act_w, mp), axis=-1)
        new_key = jnp.where(pair_ok_any, contacts["pair_partner"], -1)
        old_key = state["warm"]["key"]                    # (N, K_act)
        match = ((new_key[:, :, None] == old_key[:, None, :])
                 & (new_key >= 0)[:, :, None]).astype(jnp.float32)
        wpack = jnp.stack([state["warm"]["n"], state["warm"]["t1"],
                           state["warm"]["t2"]],
                          axis=-1)                        # (N, s_act, 3)
        wpack = wpack.reshape(n_b, k_act_w, mp * 3)       # pair-major rows
        wc = m3.einsum("nso,nod->nsd", match, wpack)      # (N, K_act, 3mp)
        wc = wc.reshape(n_b, k_act_w * mp, 3)
        warm_compact = {"n": wc[..., 0], "t1": wc[..., 1], "t2": wc[..., 2]}
    # With the split-impulse position solve active, velocity-level
    # Baumgarte must be OFF for contacts: running both double-corrects
    # penetration and pumps a standing limit cycle into resting stacks
    # (golden stack5 breathed at sigma 2.3 cm forever with 0.2; settles to
    # sigma 0 without — tests/golden/README.md). Jolt likewise zeroes the
    # contact velocity bias and leaves depenetration to its position
    # solver. The config value remains the fallback when the position
    # solve is disabled.
    vel_baumgarte = 0.0 if config.position_iterations > 0 else config.baumgarte
    with jax.named_scope("solve_velocity"):
        linvel, angvel, warm_c = solver.solve_velocity(
            b, contacts, dt,
            iterations=config.solver_iterations,
            baumgarte=vel_baumgarte,
            slop=config.penetration_slop,
            warm=warm_compact,
            gravity=jnp.asarray(config.gravity, jnp.float32),
        )
    warm = {
        "n": jnp.where(contacts["valid"], warm_c["n"], 0.0),
        "t1": jnp.where(contacts["valid"], warm_c["t1"], 0.0),
        "t2": jnp.where(contacts["valid"], warm_c["t2"], 0.0),
        "key": new_key,
    }

    # joint constraints (Fixed/Point, physics.hpp:368-373)
    if "constraints" in state:
        from garden_tpu.physics import constraints as con
        b2 = dict(b, linvel=linvel, angvel=angvel)
        linvel, angvel = con.solve_constraints(
            b2, state["constraints"], dt,
            iterations=config.solver_iterations // 2 + 1,
            baumgarte=config.baumgarte,
        )

    # integrate (semi-implicit Euler; kinematic bodies keep prescribed vel)
    with jax.named_scope("integrate"):
        moving = ((b["motion"] == DYNAMIC) | (b["motion"] == KINEMATIC)) & b["has"]
        pos = b["pos"] + jnp.where(moving[:, None], linvel * dt, 0.0)
        quat = jnp.where(
            moving[:, None],
            m3.quat_integrate(b["quat"], angvel, dt),
            b["quat"],
        )

    # positional penetration correction (split impulse), with collide-time
    # penetrations adjusted by the integration displacement along the normal
    if config.position_iterations > 0:
        with jax.named_scope("solve_position"):
            pos = solver.solve_position(
                pos, b, contacts, contacts["pen"],
                iterations=config.position_iterations,
                slop=config.penetration_slop,
                init_disp=pos - b["pos"],
            )
        if "constraints" in state:
            from garden_tpu.physics import constraints as con
            pos = con.project_positions(
                pos, dict(b, quat=quat), state["constraints"],
                iterations=config.position_iterations,
            )
    with jax.named_scope("sleep_misc"):
        b = dict(
            b,
            pos=pos,
            quat=quat,
            linvel=jnp.where(dynamic[:, None], linvel, b["linvel"]),
            angvel=jnp.where(dynamic[:, None], angvel, b["angvel"]),
        )
        # sleeping (physics.hpp allowSleeping analog): bodies below the
        # motion threshold for sleep_time freeze; contact with a moving
        # partner wakes
        if config.sleep_enabled:
            speed2 = (jnp.sum(b["linvel"] ** 2, -1)
                      + jnp.sum(b["angvel"] ** 2, -1))
            slow = speed2 < 0.003
            timer = jnp.where(slow, b["sleep_timer"] + dt, 0.0)
            sleeping = timer > 0.5
            # sleeping bodies hold pose exactly
            keep = (sleeping & b["sleeping"])[:, None]
            pos = jnp.where(keep, state["bodies"]["pos"], pos)
            quat = jnp.where(keep, state["bodies"]["quat"], quat)
            b = dict(b, sleep_timer=timer, sleeping=sleeping,
                     linvel=jnp.where(sleeping[:, None], 0.0, b["linvel"]),
                     angvel=jnp.where(sleeping[:, None], 0.0, b["angvel"]))
            b = dict(b, pos=pos, quat=quat)

        # ground support: any contact whose normal (row->partner) points
        # down within the body's slope limit (default ~45 degrees;
        # characters override via max_slope_cos)
        grounded = jnp.any(
            contacts["valid"]
            & (contacts["normal"][..., 1] < -b["ground_cos"][:, None]),
            axis=1,
        )
        # touching-partner summary for host-side contact events
        # (body listeners "Entered/Exited", physics.cpp:1043-1105)
        touching = jnp.where(contacts["valid"] & (contacts["pen"] > 0.0),
                             contacts["partner"], -1)
    return dict(state, bodies=b, warm=warm, grounded=grounded,
                touching=touching, time=state["time"] + dt)


def simulate(state: Dict[str, Any], config: PhysicsConfig, delta_time: Array,
             max_steps_per_tick: int = 4,
             present_types: Any = None) -> Dict[str, Any]:
    """Fixed-rate accumulator stepping with cascade-lag recovery.

    Mirrors PhysicsSystem::simulate (physics.cpp:1154-1222): accumulate
    delta_time; run floor(accum/h) fixed steps (statically bounded by
    max_steps_per_tick); if the sim stays more than one step behind for
    longer than cascadeLagThreshold seconds, clamp to one step to break the
    death spiral. Keeps prev pose for interpolation.
    """
    h = 1.0 / config.simulation_rate
    accum = state["accum"] + delta_time
    nsteps = jnp.floor(accum / h).astype(jnp.int32)

    # cascade-lag recovery (physics.cpp:1172-1184)
    lagging = nsteps > 1
    lag_time = jnp.where(lagging, state["lag_time"] + delta_time, 0.0)
    clamp = lag_time > config.cascade_lag_threshold
    nsteps = jnp.where(clamp, jnp.minimum(nsteps, 1), nsteps)
    nsteps = jnp.minimum(nsteps, max_steps_per_tick)
    accum = jnp.where(clamp, jnp.minimum(accum, h), accum)

    prev_pos = jnp.where(
        (nsteps > 0), state["bodies"]["pos"], state["prev_pos"]
    )
    prev_quat = jnp.where((nsteps > 0), state["bodies"]["quat"], state["prev_quat"])

    def body(i, st):
        did = i < nsteps
        stepped = step(st, config, h, present_types)
        return jax.tree_util.tree_map(
            lambda new, old: jnp.where(did, new, old), stepped, st
        )

    state = dict(state, prev_pos=prev_pos, prev_quat=prev_quat,
                 lag_time=lag_time)
    state = jax.lax.fori_loop(0, max_steps_per_tick, body, state)
    return dict(state, accum=accum - nsteps.astype(jnp.float32) * h)


def interpolated_pose(state: Dict[str, Any], config: PhysicsConfig
                      ) -> Tuple[Array, Array]:
    """Render pose between fixed steps (physics.cpp:1108-1144 analog)."""
    h = 1.0 / config.simulation_rate
    alpha = jnp.clip(state["accum"] / h, 0.0, 1.0)
    pos = m3.lerp(state["prev_pos"], state["bodies"]["pos"], alpha)
    quat = m3.quat_slerp(state["prev_quat"], state["bodies"]["quat"], alpha)
    return pos, quat
