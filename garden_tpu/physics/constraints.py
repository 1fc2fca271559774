"""Body-to-body constraints: Fixed and Point joints.

Rebuild of RigidbodyComponent constraints (include/garden/system/physics.
hpp:368-373: Fixed/Point constraints to other entities, created via Jolt's
constraint system and resolved post-deserialize by UID). Formulation here:
fixed-capacity constraint arrays solved with the same mass-split Jacobi
velocity iterations + positional projection as contacts.

- POINT: pins an anchor point (given in each body's local frame) together —
  a ball-socket joint, 3 velocity constraints.
- FIXED: point + relative-orientation lock (adds 3 angular constraints).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3

Array = jnp.ndarray

POINT = 0
FIXED = 1


class ConstraintTable:
    """Host-side builder for the constraint arrays."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self.kind = np.zeros((capacity,), np.int32)
        self.body_a = np.full((capacity,), -1, np.int32)
        self.body_b = np.full((capacity,), -1, np.int32)
        self.anchor_a = np.zeros((capacity, 3), np.float32)
        self.anchor_b = np.zeros((capacity, 3), np.float32)
        self.rel_quat = np.tile(np.array([0, 0, 0, 1], np.float32),
                                (capacity, 1))
        self.active = np.zeros((capacity,), bool)
        self._count = 0

    def add(self, kind: int, body_a: int, body_b: int,
            anchor_a=(0.0, 0.0, 0.0), anchor_b=(0.0, 0.0, 0.0),
            rel_quat=(0.0, 0.0, 0.0, 1.0)) -> int:
        if self._count >= self.capacity:
            raise RuntimeError("constraint capacity exhausted")
        i = self._count
        self._count += 1
        self.kind[i] = kind
        self.body_a[i] = body_a
        self.body_b[i] = body_b
        self.anchor_a[i] = anchor_a
        self.anchor_b[i] = anchor_b
        self.rel_quat[i] = rel_quat
        self.active[i] = True
        return i

    def point(self, body_a: int, body_b: int, world_point,
              pos_a, quat_a, pos_b, quat_b) -> int:
        """Point constraint at a world-space anchor (Jolt convention)."""
        wp = np.asarray(world_point, np.float32)
        la = np.asarray(m3.quat_rotate(m3.quat_conj(jnp.asarray(quat_a)),
                                       jnp.asarray(wp - pos_a)))
        lb = np.asarray(m3.quat_rotate(m3.quat_conj(jnp.asarray(quat_b)),
                                       jnp.asarray(wp - pos_b)))
        return self.add(POINT, body_a, body_b, la, lb)

    def device_arrays(self) -> Dict[str, Array]:
        return {
            "kind": jnp.asarray(self.kind),
            "body_a": jnp.asarray(self.body_a),
            "body_b": jnp.asarray(self.body_b),
            "anchor_a": jnp.asarray(self.anchor_a),
            "anchor_b": jnp.asarray(self.anchor_b),
            "rel_quat": jnp.asarray(self.rel_quat),
            "active": jnp.asarray(self.active),
        }


def solve_constraints(
    bodies: Dict[str, Array],
    cons: Dict[str, Array],
    dt: float,
    iterations: int = 8,
    baumgarte: float = 0.2,
) -> Tuple[Array, Array]:
    """Velocity-level constraint solve; returns (linvel, angvel).

    Point: J v = relative anchor velocity -> impulse along all 3 axes.
    Fixed: additionally drives relative angular velocity (+ orientation
    drift bias) to zero. Jacobi with per-constraint diagonal effective mass;
    constraint counts are small (<= capacity), so scatter cost is negligible
    — impulses apply via segment-sum over the two body columns.
    """
    n_bodies = bodies["pos"].shape[0]
    a = jnp.maximum(cons["body_a"], 0)
    b = jnp.maximum(cons["body_b"], 0)
    active = cons["active"] & (cons["body_a"] >= 0) & (cons["body_b"] >= 0)
    is_fixed = cons["kind"] == FIXED

    inv_mass = bodies["inv_mass"]
    r = m3.quat_to_mat3(bodies["quat"])
    inv_inertia_w = m3.einsum("nij,nj,nkj->nik", r, bodies["inv_inertia"], r)

    ra = m3.quat_rotate(bodies["quat"][a], cons["anchor_a"])
    rb = m3.quat_rotate(bodies["quat"][b], cons["anchor_b"])
    pa = bodies["pos"][a] + ra
    pb = bodies["pos"][b] + rb

    # positional drift bias (Baumgarte)
    bias = (baumgarte / dt) * (pb - pa)

    # orientation drift for FIXED: relative quat error -> angular bias
    q_err = m3.quat_mul(bodies["quat"][b],
                        m3.quat_conj(m3.quat_mul(bodies["quat"][a],
                                                 cons["rel_quat"])))
    ang_bias = (2.0 * baumgarte / dt) * q_err[..., :3] * jnp.sign(
        q_err[..., 3:4])

    # FULL 3x3 effective-mass matrix per constraint (Jolt's point-
    # constraint formulation): K = (1/ma + 1/mb) I - [ra]x Ia^-1 [ra]x -
    # [rb]x Ib^-1 [rb]x, impulse = K^-1 c_vel. A diagonal approximation
    # here converges too slowly for swinging joints — measured 17% energy
    # loss per quarter-period on the golden pendulum at 10 iterations vs
    # <2% with the exact solve (tests/golden/README.md contract).
    eye = jnp.eye(3, dtype=jnp.float32)

    def skew(v):
        zero = jnp.zeros_like(v[..., 0])
        return jnp.stack([
            jnp.stack([zero, -v[..., 2], v[..., 1]], -1),
            jnp.stack([v[..., 2], zero, -v[..., 0]], -1),
            jnp.stack([-v[..., 1], v[..., 0], zero], -1),
        ], -2)

    ra_x = skew(ra)
    rb_x = skew(rb)
    k_mat = (
        (inv_mass[a] + inv_mass[b])[..., None, None] * eye
        - m3.einsum("cij,cjk,ckl->cil", ra_x, inv_inertia_w[a], ra_x)
        - m3.einsum("cij,cjk,ckl->cil", rb_x, inv_inertia_w[b], rb_x)
    )
    # inactive rows get identity so the solve stays well-posed
    k_mat = jnp.where(active[..., None, None], k_mat, eye)
    k_inv = jnp.linalg.inv(k_mat + 1e-9 * eye)
    k_ang = jnp.maximum(
        jnp.trace(inv_inertia_w[a], axis1=-2, axis2=-1)
        + jnp.trace(inv_inertia_w[b], axis1=-2, axis2=-1), 1e-9)[..., None]

    linvel, angvel = bodies["linvel"], bodies["angvel"]
    for _ in range(iterations):
        va = linvel[a] + jnp.cross(angvel[a], ra)
        vb = linvel[b] + jnp.cross(angvel[b], rb)
        c_vel = (vb - va) + bias
        imp = jnp.where(active[..., None],
                        m3.einsum("cij,cj->ci", k_inv, c_vel), 0.0)

        dlin = (
            jax.ops.segment_sum(imp * inv_mass[a][:, None], a, num_segments=n_bodies)
            - jax.ops.segment_sum(imp * inv_mass[b][:, None], b, num_segments=n_bodies)
        )
        ta = jax.ops.segment_sum(jnp.cross(ra, imp), a, num_segments=n_bodies)
        tb = jax.ops.segment_sum(jnp.cross(rb, -imp), b, num_segments=n_bodies)
        linvel = linvel + dlin * bodies["linear_factor"]
        angvel = angvel + m3.einsum("nij,nj->ni", inv_inertia_w, ta + tb) \
            * bodies["angular_factor"]

        # angular lock for FIXED
        w_err = (angvel[b] - angvel[a]) + ang_bias
        ang_imp = jnp.where((active & is_fixed)[..., None], w_err / k_ang, 0.0)
        taa = jax.ops.segment_sum(ang_imp, a, num_segments=n_bodies)
        tbb = jax.ops.segment_sum(-ang_imp, b, num_segments=n_bodies)
        angvel = angvel + m3.einsum("nij,nj->ni", inv_inertia_w, taa + tbb) \
            * bodies["angular_factor"]

    return linvel, angvel


def project_positions(
    pos: Array,
    bodies: Dict[str, Array],
    cons: Dict[str, Array],
    iterations: int = 2,
    beta: float = 0.8,
) -> Array:
    """Positional anchor projection (the constraint analog of the contact
    split-impulse pass): directly removes residual anchor separation that
    velocity-level Baumgarte leaves behind."""
    n_bodies = pos.shape[0]
    a = jnp.maximum(cons["body_a"], 0)
    b = jnp.maximum(cons["body_b"], 0)
    active = cons["active"] & (cons["body_a"] >= 0) & (cons["body_b"] >= 0)
    inv_mass = bodies["inv_mass"]
    ra = m3.quat_rotate(bodies["quat"][a], cons["anchor_a"])
    rb = m3.quat_rotate(bodies["quat"][b], cons["anchor_b"])
    k = jnp.maximum(inv_mass[a] + inv_mass[b], 1e-9)[..., None]
    for _ in range(iterations):
        err = (pos[b] + rb) - (pos[a] + ra)
        corr = jnp.where(active[..., None], beta * err / k, 0.0)
        pos = pos + jax.ops.segment_sum(
            corr * inv_mass[a][:, None], a, num_segments=n_bodies)
        pos = pos - jax.ops.segment_sum(
            corr * inv_mass[b][:, None], b, num_segments=n_bodies)
    return pos
