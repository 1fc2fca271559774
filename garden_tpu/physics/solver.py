"""Contact constraint solver: scatter-free symmetric Jacobi impulses.

Rebuild of Jolt's sequential-impulse velocity solver as stepped by the
reference (source/system/physics.cpp:1186-1193). Two data-parallel design
decisions replace the sequential island sweep:

1. **Jacobi with mass splitting** (Tonge et al., 2012): every contact is
   solved in parallel each iteration; each body's inverse mass in the
   constraint preconditioner is scaled by its contact count, which makes the
   parallel update non-overshooting. Warm starting across steps (persistent
   per-slot accumulated impulses) provides the convergence stacks need.

2. **Symmetric row layout — no scatters.** Contacts live in a fixed
   (bodies, K, points) layout where each body's row holds *all* its
   contacts: a touching pair (i, j) appears twice, once in row i (normal
   pointing i->j) and once, mirrored, in row j. The impulse magnitudes
   computed in the two rows are bit-identical by symmetry, so applying
   impulses is a pure per-row reduction (sum over the row's slots) — there
   is no segment_sum / scatter anywhere, only partner-velocity gathers.
   Row reductions are dense elementwise work; scatters collide on shared
   bodies. The 2x redundant arithmetic costs less than the scatters it
   removes.

Features mirrored from the Jolt path: accumulated-impulse clamping, Baumgarte
positional bias with penetration slop, restitution with a bounce threshold,
Coulomb friction on two tangents bounded by the accumulated normal impulse,
sensor contacts excluded from response (physics.hpp:362), per-body
linear/angular DOF factors (physics.hpp:54-65 AllowedDOF incl. Plane2D).

Contact layout (S = K * MAX_POINTS slots per body):
- `partner` int32[N, S]: the other body (gather index)
- `point`   f32[N, S, 3], `normal` f32[N, S, 3] (row body -> partner)
- `pen`     f32[N, S], `valid` bool[N, S]
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from garden_tpu.core import math3d as m3

Array = jnp.ndarray


def _orthonormal_tangents(n: Array) -> Tuple[Array, Array]:
    """Two unit tangents perpendicular to n (batched, branch-free).

    Chosen so that mirrored normals give mirrored frames: t1(-n) = -t1(n),
    t2(-n) = t2(n) — required for row-symmetric friction impulses."""
    helper = jnp.where(
        (jnp.abs(n[..., 0]) > 0.9)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), n.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), n.shape),
    )
    t1 = m3.normalize(jnp.cross(n, helper))
    t2 = jnp.cross(n, t1)
    return t1, t2


def solve_velocity(
    bodies: Dict[str, Array],
    contacts: Dict[str, Array],
    dt: float,
    *,
    iterations: int,
    baumgarte: float,
    slop: float,
    restitution_threshold: float = 0.5,
    warm: Optional[Dict[str, Array]] = None,
    gravity: Optional[Array] = None,
) -> Tuple[Array, Array, Dict[str, Array]]:
    """Solve contact constraints; returns (linvel, angvel, warm impulses).

    `warm` carries the previous step's accumulated impulses in the same
    (N, S) slot layout; for resting configurations the slots are stable
    across steps, giving the warm-starting effect stacks need (Jolt
    warm-starts the same way).

    When `contacts` carries a pair-level "pair_partner" (N, K) with
    S = K * points (world.collide's layout), every partner gather runs at
    (N, K) rows and broadcasts to the point slots — gathers price per
    row, and the slots of one pair share the partner, so this halves the
    solver loop's gather traffic."""
    point = contacts["point"]              # (N, S, 3)
    normal = contacts["normal"]
    pen = contacts["pen"]
    s_slots = point.shape[1]
    partner = contacts.get("pair_partner")
    if partner is None:
        partner = contacts["partner"]      # (N, S) slot-level fallback
    p_rep = s_slots // partner.shape[1]

    def expand(x: Array) -> Array:
        """(N, K, ...) per-pair -> (N, S, ...) per-slot (pure broadcast)."""
        if p_rep == 1:
            return x
        n_, k_ = x.shape[:2]
        return jnp.broadcast_to(
            x[:, :, None], (n_, k_, p_rep) + x.shape[2:]
        ).reshape((n_, k_ * p_rep) + x.shape[2:])

    is_sensor = bodies["is_sensor"]
    responsive = contacts["valid"] & ~(
        is_sensor[:, None] | expand(is_sensor[partner])
    )
    resp_f = responsive.astype(jnp.float32)

    inv_mass = bodies["inv_mass"]          # (N,)
    # world-space inverse inertia: R diag(I^-1) R^T, once per step
    r = m3.quat_to_mat3(bodies["quat"])
    inv_inertia_w = m3.einsum("nij,nj,nkj->nik", r, bodies["inv_inertia"], r)

    # mass splitting: per-body contact count (each pair counted once per row)
    count = jnp.sum(resp_f, axis=1)
    split = jnp.maximum(count, 1.0)

    pos = bodies["pos"]

    # ALL static partner attributes AND the pre-solve partner velocities
    # fetched with ONE packed row gather (gathers price per row; a
    # separate velocity-table fetch for the restitution reference velocity
    # would be a second one): [pos3 | inv_mass | split |
    # inertia_w9 | ang_factor3 | friction | restitution | linvel3 |
    # angvel3] = 25 columns
    body_tab = jnp.concatenate(
        [pos, inv_mass[:, None], split[:, None],
         inv_inertia_w.reshape(-1, 9), bodies["angular_factor"],
         bodies["friction"][:, None], bodies["restitution"][:, None],
         bodies["linvel"], bodies["angvel"]],
        axis=1)                             # (N, 25)
    # NOTE: the whole-record expand stays (materialized once): with
    # per-field lazy expands the many broadcast consumers each re-read the
    # (N, K, 25) gather output instead of one shared expansion
    par_tab = expand(body_tab[partner])     # (N, S, 25) the one gather
    pos_p = par_tab[..., 0:3]
    inv_mass_p = par_tab[..., 3]
    split_p = par_tab[..., 4]
    inertia_par = par_tab[..., 5:14].reshape(par_tab.shape[:-1] + (3, 3))
    angf_par = par_tab[..., 14:17]
    friction_p = par_tab[..., 17]
    restitution_p = par_tab[..., 18]
    linvel_p0 = par_tab[..., 19:22]
    angvel_p0 = par_tab[..., 22:25]

    r_own = point - pos[:, None, :]
    r_par = point - pos_p

    lin_factor = bodies["linear_factor"]
    ang_factor = bodies["angular_factor"]
    inertia_own = inv_inertia_w[:, None]   # (N, 1, 3, 3) broadcast over slots
    angf_own = ang_factor[:, None, :]

    def matvec3(m, v):
        """Unrolled batched 3x3 matvec: the einsum form lowers to a
        3-wide batched dot_general that forces layout copies on the
        (N, S, 3, 3) operands (the same pathology as the render-side
        einsums, see math3d one-hot notes)."""
        return jnp.stack(
            [m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
             + m[..., i, 2] * v[..., 2] for i in range(3)], axis=-1)

    def k_for(axis: Array) -> Array:
        """Effective mass denominator along a unit axis (with splitting)."""
        rx_o = jnp.cross(r_own, axis)
        rx_p = jnp.cross(r_par, axis)
        xo = rx_o * angf_own
        xp = rx_p * angf_par
        ang_o = matvec3(inertia_own, xo)
        ang_p = matvec3(inertia_par, xp)
        k = (
            inv_mass[:, None] * split[:, None]
            + inv_mass_p * split_p
            + m3.dot(xo, ang_o) * split[:, None]
            + m3.dot(xp, ang_p) * split_p
        )
        return jnp.maximum(k, 1e-9)

    t1, t2 = _orthonormal_tangents(normal)
    k_n = k_for(normal)
    k_t1 = k_for(t1)
    k_t2 = k_for(t2)

    friction = jnp.sqrt(bodies["friction"][:, None] * friction_p)
    restitution = jnp.maximum(bodies["restitution"][:, None], restitution_p)

    def rel_vel(linvel: Array, angvel: Array) -> Array:
        """Velocity of partner contact point relative to own (N, S, 3).

        Partner velocities are fetched with ONE gather from a fused (N, 8)
        table (linvel | angvel | pad): gathers price by row count, so one
        8-wide gather beats two 3-wide gathers."""
        vel_tab = jnp.concatenate(
            [linvel, angvel, jnp.zeros((linvel.shape[0], 2), linvel.dtype)],
            axis=1,
        )
        par = expand(vel_tab[partner])              # (N, S, 8)
        v_own = linvel[:, None, :] + jnp.cross(angvel[:, None, :], r_own)
        v_par = par[..., 0:3] + jnp.cross(par[..., 3:6], r_par)
        return v_par - v_own

    # pre-solve approach speed from the packed fetch (no extra gather)
    v_own0 = bodies["linvel"][:, None, :] + jnp.cross(
        bodies["angvel"][:, None, :], r_own)
    v_par0 = linvel_p0 + jnp.cross(angvel_p0, r_par)
    vn0 = m3.dot(v_par0 - v_own0, normal)
    bounce = jnp.where(vn0 < -restitution_threshold, -restitution * vn0, 0.0)
    if gravity is not None:
        # Speculative-restitution energy correction. A speculative contact
        # (pen < 0) solves the bounce a distance d = -pen BEFORE the
        # surface: the body departs from height d instead of falling to the
        # surface first, so the naive e*vn0 rebound inflates the apex by
        # d*(1-e^2) (Jolt documents this as a known speculative-contact
        # inaccuracy, physics.hpp:874-881 margin semantics). Energy
        # accounting gives the departure speed that lands the TRUE apex:
        #   u^2 = e^2*vn0^2 + 2*g_n*pen*(1-e^2),  g_n = dot(g, n)
        # (signed pen also covers the penetrating frame, where the body
        # over-accelerated past the surface). Clamped at the naive value so
        # the correction only ever removes the spurious energy.
        g_n = m3.dot(jnp.broadcast_to(gravity, normal.shape), normal)
        e2 = restitution * restitution
        u2 = e2 * vn0 * vn0 + 2.0 * g_n * pen * (1.0 - e2)
        bounce_c = jnp.sqrt(jnp.maximum(u2, 0.0))
        bounce = jnp.where(bounce > 0.0, jnp.minimum(bounce, bounce_c), 0.0)
    # penetration recovery velocity, capped (Jolt caps recovery speed so
    # deep impact-frame penetrations don't launch bodies)
    bias = jnp.minimum((baumgarte / dt) * jnp.maximum(pen - slop, 0.0), 2.0)
    # speculative contacts (pen < 0): allow closing exactly to touching
    # (target approach speed = pen/dt < 0) — unless the material bounces,
    # in which case restitution applies from the pre-solve approach speed.
    # The Jolt speculative-margin semantics (physics.hpp:874-881).
    target_vn = jnp.where(
        pen > 0.0,
        jnp.maximum(bounce, bias),
        jnp.where(bounce > 0.0, bounce, pen / dt),
    )

    def apply(linvel, angvel, impulse):
        """Row-reduce impulses (N, S, 3) applied at the contact points.

        Impulse convention: `impulse` is what the row body RECEIVES
        (own side gets -impulse in the A->B pair convention, so callers
        pass lambda * n with n pointing row->partner and we negate here)."""
        dlin = -jnp.sum(impulse, axis=1) * inv_mass[:, None] * lin_factor
        torque = -jnp.sum(jnp.cross(r_own, impulse), axis=1)
        dang = matvec3(inv_inertia_w, torque) * ang_factor
        return linvel + dlin, angvel + dang

    def iteration(_, carry):
        linvel, angvel, acc_n, acc_t1, acc_t2 = carry

        # ONE partner gather per iteration: the friction pass reuses this
        # velocity snapshot, corrected by the own body's normal-impulse
        # delta (computable densely, no gather). The partner side of that
        # delta is half an iteration stale — Jacobi-consistent, and
        # indistinguishable on stack settling (tests/golden) while removing
        # half the solver loop's gather traffic.
        v = rel_vel(linvel, angvel)
        vn = m3.dot(v, normal)

        dlam = (target_vn - vn) / k_n
        new_acc = jnp.maximum(acc_n + dlam, 0.0)
        dlam = jnp.where(responsive, new_acc - acc_n, 0.0)
        acc_n = jnp.where(responsive, new_acc, acc_n)
        imp_n = dlam[..., None] * normal
        linvel2, angvel2 = apply(linvel, angvel, imp_n)

        # own-body velocity delta at each contact point (dense)
        dlin = linvel2 - linvel
        dang = angvel2 - angvel
        dv_own = dlin[:, None, :] + jnp.cross(dang[:, None, :], r_own)
        v = v - dv_own            # partner side stale by half an iteration
        linvel, angvel = linvel2, angvel2

        max_f = friction * acc_n
        dt1 = -m3.dot(v, t1) / k_t1
        new_t1 = jnp.clip(acc_t1 + dt1, -max_f, max_f)
        dt1 = jnp.where(responsive, new_t1 - acc_t1, 0.0)
        acc_t1 = jnp.where(responsive, new_t1, acc_t1)
        dt2 = -m3.dot(v, t2) / k_t2
        new_t2 = jnp.clip(acc_t2 + dt2, -max_f, max_f)
        dt2 = jnp.where(responsive, new_t2 - acc_t2, 0.0)
        acc_t2 = jnp.where(responsive, new_t2, acc_t2)
        linvel, angvel = apply(
            linvel, angvel, dt1[..., None] * t1 + dt2[..., None] * t2
        )

        return linvel, angvel, acc_n, acc_t1, acc_t2

    zeros = jnp.zeros_like(pen)
    linvel0, angvel0 = bodies["linvel"], bodies["angvel"]
    if warm is not None:
        acc_n0 = jnp.where(responsive, warm["n"], 0.0)
        acc_t10 = jnp.where(responsive, warm["t1"], 0.0)
        acc_t20 = jnp.where(responsive, warm["t2"], 0.0)
        linvel0, angvel0 = apply(
            linvel0, angvel0,
            acc_n0[..., None] * normal + acc_t10[..., None] * t1
            + acc_t20[..., None] * t2,
        )
    else:
        acc_n0 = acc_t10 = acc_t20 = zeros

    # fori_loop, not Python-unrolled: unrolling multiplies compile time
    # by the iteration count
    linvel, angvel, acc_n, acc_t1, acc_t2 = jax.lax.fori_loop(
        0, iterations, iteration,
        (linvel0, angvel0, acc_n0, acc_t10, acc_t20),
    )
    return linvel, angvel, {"n": acc_n, "t1": acc_t1, "t2": acc_t2}


def solve_position(
    pos: Array,
    bodies: Dict[str, Array],
    contacts: Dict[str, Array],
    pen: Array,
    *,
    iterations: int,
    slop: float,
    beta: float = 0.8,
    init_disp: Optional[Array] = None,
) -> Array:
    """Positional (split-impulse) penetration correction, row-reduced.

    Linear-only Jacobi projection with mass splitting; velocities untouched.
    `pen` (N, S) is the penetration measured at collide time; `init_disp`
    (N, 3) is displacement already applied since then (the integration
    step) — folding it into the per-iteration relative-displacement gather
    saves a separate (N, S, 3) partner gather for the initial adjustment."""
    normal = contacts["normal"]
    s_slots = normal.shape[1]
    partner = contacts.get("pair_partner")
    if partner is None:
        partner = contacts["partner"]
    p_rep = s_slots // partner.shape[1]

    def expand(x: Array) -> Array:
        if p_rep == 1:
            return x
        n_, k_ = x.shape[:2]
        return jnp.broadcast_to(
            x[:, :, None], (n_, k_, p_rep) + x.shape[2:]
        ).reshape((n_, k_ * p_rep) + x.shape[2:])

    is_sensor = bodies["is_sensor"]
    responsive = contacts["valid"] & ~(
        is_sensor[:, None] | expand(is_sensor[partner]))
    inv_mass = bodies["inv_mass"]

    count = jnp.sum(responsive.astype(jnp.float32), axis=1)
    split = jnp.maximum(count, 1.0)
    # only the product inv_mass*split of the partner is needed, and it
    # rides in the same 4-wide row as the displacement — ONE row gather
    # per iteration total
    prod = inv_mass * split
    lin_factor = bodies["linear_factor"]

    # total displacement since collide time (integration + corrections)
    dtot = (init_disp if init_disp is not None
            else jnp.zeros_like(pos))
    k = None
    for _ in range(iterations):  # unrolled (see solve_velocity note)
        tab = jnp.concatenate([dtot, prod[:, None]], axis=1)   # (N, 4)
        par = expand(tab[partner])                             # ONE gather
        if k is None:
            k = jnp.maximum(prod[:, None] + par[..., 3], 1e-9)
        # remaining penetration = collide-time pen minus relative
        # separation the displacements have produced along the normal
        rel = m3.dot(par[..., 0:3] - dtot[:, None, :], normal)
        sep = pen - rel
        # cap positional pushout per iteration: impact-frame penetrations
        # resolve over a few steps instead of teleporting
        lam = jnp.where(
            responsive,
            jnp.minimum(beta * jnp.maximum(sep - slop, 0.0), 0.1) / k, 0.0)
        # own body moves along -normal (away from partner)
        dpos = -jnp.sum(lam[..., None] * normal, axis=1) * inv_mass[:, None] * lin_factor
        pos = pos + dpos
        dtot = dtot + dpos
    return pos
