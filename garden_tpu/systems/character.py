"""Character controller.

Rebuild of CharacterSystem/CharacterComponent (include/garden/system/
character.hpp:50, source/system/character.cpp:265-272: a
JPH::CharacterVirtual with ExtendedUpdate — stick-to-floor + walk-stairs).
Formulation: the character is a capsule rigidbody with locked rotation
(angular_factor = 0, the AllowedDOF trick) driven by velocity control; the
ground state comes from the body's contact normals each step (grounded =
any supporting contact whose normal is within max_slope of up), which is
how CharacterVirtual classifies its ground.

ExtendedUpdate's two swept-shape behaviors are reproduced with sphere casts
(physics/queries.cast_sphere):
- walk-stairs: when grounded, moving, and blocked at foot level but clear at
  step height, the body is lifted by step_height so the solver lands it on
  the step (Jolt's up -> forward -> down sub-steps collapsed to the lift;
  the regular contact solve provides forward+down).
- stick-to-floor: when recently grounded, not jumping, and the ground is
  within stick_distance below the foot, downward velocity is added to close
  the gap within one step (keeps characters glued on downslopes).
"""

from __future__ import annotations

from typing import Any, Dict

import jax

import jax.numpy as jnp

from garden_tpu.core import math3d as m3
from garden_tpu.core.ecs import ComponentDef, Field, System
from garden_tpu.physics import world as pw

Array = jnp.ndarray

CHARACTER = ComponentDef(
    "character",
    {
        "body": Field((), jnp.int32, -1),
        "desired_vel": Field((3,), jnp.float32, 0.0),
        "jump_impulse": Field((), jnp.float32, 0.0),
        "grounded": Field((), jnp.bool_, False),
        "max_slope_cos": Field((), jnp.float32, 0.7071),  # 45 degrees
        "control_accel": Field((), jnp.float32, 30.0),
        # capsule dimensions (cached for the cast probes)
        "radius": Field((), jnp.float32, 0.3),
        "half_height": Field((), jnp.float32, 0.6),
        # ExtendedUpdate settings (character.hpp:56-64)
        "step_height": Field((), jnp.float32, 0.4),     # walk-stairs
        "stick_distance": Field((), jnp.float32, 0.3),  # stick-to-floor
    },
)


class CharacterSystem(System):
    component = CHARACTER

    def attach(self, world) -> None:
        super().attach(world)
        # runs just before PhysicsSystem (priority 10) applies simulate
        world.events.subscribe("Update", self.update, priority=9.0)

    def add_character(self, entity: int, radius: float = 0.3,
                      half_height: float = 0.6, mass: float = 70.0,
                      step_height: float = 0.4,
                      stick_distance: float = 0.3) -> int:
        phys = self.world.systems["PhysicsSystem"]
        shape = phys.physics.shapes.capsule(radius, half_height)
        body = phys.add_rigidbody(
            entity, shape, friction=0.2, mass_override=mass,
            angular_factor=(0.0, 0.0, 0.0),  # upright lock
        )
        self.world.add_component(entity, "character", body=body,
                                 radius=radius, half_height=half_height,
                                 step_height=step_height,
                                 stick_distance=stick_distance)
        return body

    def update(self, state: Dict[str, Any], ctx: Dict[str, Any]) -> Dict[str, Any]:
        comp = state["components"].get("character")
        if comp is None:
            return state
        phys = state["physics"]
        bodies = phys["bodies"]
        dt = ctx["delta_time"]

        body = jnp.maximum(comp["body"], 0)
        active = comp["has"] & (comp["body"] >= 0)

        # ground state computed by the physics step from contact normals
        # (CharacterVirtual ground classification analog, world.step)
        grounded = phys["grounded"][body] & active

        # velocity control: steer horizontal velocity toward desired
        linvel = bodies["linvel"]
        v = linvel[body]
        desired = comp["desired_vel"]
        accel = comp["control_accel"] * dt
        dvx = jnp.clip(desired[:, 0] - v[:, 0], -accel, accel)
        dvz = jnp.clip(desired[:, 2] - v[:, 2], -accel, accel)
        jump = jnp.where(grounded & (comp["jump_impulse"] > 0.0),
                         comp["jump_impulse"], 0.0)
        new_v = v + jnp.stack([dvx, jump, dvz], axis=-1) * jnp.where(
            active[:, None], 1.0, 0.0)

        capacity = linvel.shape[0]
        target = jnp.where(active, body, capacity)

        # -- walk-stairs (ExtendedUpdate's stair sub-step) -----------------
        # blocked at foot level but clear at step height -> lift the body by
        # step_height; the contact solve provides the forward+down motion
        from garden_tpu.physics import queries as pq
        pos = bodies["pos"]
        p = pos[body]
        speed = jnp.sqrt(desired[:, 0] ** 2 + desired[:, 2] ** 2)
        moving = speed > 0.05
        dirn = jnp.stack([desired[:, 0], jnp.zeros_like(speed),
                          desired[:, 2]], -1) / jnp.maximum(speed, 1e-6)[:, None]
        # actual progress along the desired direction is far below desired
        v_along = v[:, 0] * dirn[:, 0] + v[:, 2] * dirn[:, 2]
        blocked = grounded & moving & (v_along < 0.5 * speed)
        foot = p - jnp.stack([jnp.zeros_like(speed), comp["half_height"],
                              jnp.zeros_like(speed)], -1)
        probe_dist = comp["radius"] + jnp.maximum(speed, 1.0) * dt * 2.0

        def probe(origin, d, r, dist, excl):
            hit = pq.cast_sphere(phys, origin, d, r, max_distance=dist,
                                 exclude_body=excl)
            return hit.hit, hit.distance

        up = jnp.array([0.0, 1.0, 0.0])
        low_hit, _ = jax.vmap(probe, in_axes=(0, 0, 0, 0, 0))(
            foot, dirn, comp["radius"] * 0.9, probe_dist, comp["body"])
        high_hit, _ = jax.vmap(probe, in_axes=(0, 0, 0, 0, 0))(
            foot + up * comp["step_height"][:, None], dirn,
            comp["radius"] * 0.9, probe_dist, comp["body"])
        climb = active & blocked & low_hit & ~high_hit
        lift = jnp.where(climb, comp["step_height"], 0.0)

        # -- stick-to-floor -------------------------------------------------
        # recently grounded, not rising: if the floor is within
        # stick_distance below the foot, add downward velocity to reach it
        falling = active & comp["grounded"] & ~grounded & (new_v[:, 1] <= 0.0)
        down_hit, down_d = jax.vmap(probe, in_axes=(0, 0, 0, 0, 0))(
            foot, jnp.broadcast_to(-up, foot.shape), comp["radius"] * 0.9,
            comp["stick_distance"] + comp["radius"], comp["body"])
        stick = falling & down_hit
        stick_v = jnp.where(stick, -down_d / jnp.maximum(dt, 1e-4), 0.0)
        stick_v = jnp.maximum(stick_v, -3.0)  # bounded snap speed
        new_v = new_v.at[:, 1].add(jnp.where(stick, stick_v, 0.0))

        linvel = linvel.at[target].set(new_v, mode="drop")
        pos = pos.at[target, 1].add(lift, mode="drop")

        # sync the per-character slope limit into the body's ground
        # threshold so serialized max_slope_cos values take effect
        ground_cos = bodies["ground_cos"].at[target].set(
            comp["max_slope_cos"], mode="drop")

        bodies = dict(bodies, linvel=linvel, pos=pos, ground_cos=ground_cos)
        comp = dict(comp, grounded=grounded,
                    jump_impulse=jnp.where(grounded, 0.0, comp["jump_impulse"]))
        return dict(
            state,
            physics=dict(phys, bodies=bodies),
            components=dict(state["components"], character=comp),
        )
