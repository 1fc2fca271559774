"""Batched 3D math: quaternions, matrices, AABBs, frustums.

Accelerator equivalent of the reference's SIMD math library (cfnptr/math:
f32x4, f32x4x4, quat, Aabb, Frustum — used throughout e.g.
include/garden/system/render/mesh.hpp:22). Everything here is plain jnp over
a trailing component axis so it vmaps/batches freely; there are no scalar
fast paths — batch is the fast path on the accelerator.

Conventions:
- Quaternions are (x, y, z, w), Hamilton product, unit-normalized.
- Matrices are row-major jnp arrays; points are row vectors transformed as
  (M @ p) with p column semantics: we use `apply_mat4(m, p)` helpers instead
  of relying on an order convention at call sites.
- Clip space is right-handed, reverse-Z (1 near, 0 far) to match the
  reference renderer (garden uses reverse-Z: CameraComponent::calcProjection,
  include/garden/system/camera.hpp:102).
"""

from __future__ import annotations

import math as _pymath

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Vector helpers
# ---------------------------------------------------------------------------


# Explicit f32 precision for small-matrix ops: a float32 matmul on the GPU
# may run in TF32 (~3 decimal digits) by default, which is far too coarse
# for transform chains and physics. HIGHEST forces full float32.
HIGHEST = jax.lax.Precision.HIGHEST


def einsum(subscripts, *ops):
    return jnp.einsum(subscripts, *ops, precision=HIGHEST)


def matmul(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    return v * jax.lax.rsqrt(jnp.maximum(dot(v, v), eps))[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def lerp(a: jnp.ndarray, b: jnp.ndarray, t) -> jnp.ndarray:
    return a + (b - a) * t


def saturate(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(x, 0.0, 1.0)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    return v - 2.0 * dot(v, n)[..., None] * n


# ---------------------------------------------------------------------------
# Dense one-hot selects over a SMALL trailing k, used throughout the physics
# narrowphase/solver: a masked reduction or one-hot contraction instead of
# take_along_axis. Contractions run at HIGHEST precision so values pass
# through exactly (no TF32 rounding), and an index outside [0, k) selects 0.
# ---------------------------------------------------------------------------


def onehot(idx: jnp.ndarray, k: int) -> jnp.ndarray:
    """(..., k) float32 one-hot of integer indices."""
    return (idx[..., None] == jnp.arange(k, dtype=idx.dtype)).astype(jnp.float32)


def select_scalar(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """x[..., idx] for small trailing k: (..., k), (...,) -> (...,)."""
    return jnp.sum(x * onehot(idx, x.shape[-1]), axis=-1)


def select_row(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """x[..., idx, :] for small k: (..., k, d), (...,) -> (..., d)."""
    return einsum("...k,...kd->...d", onehot(idx, x.shape[-2]), x)


def gather_rows(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """x[..., idx, :] batched for small source k: (..., k, d), (..., s) ->
    (..., s, d) as a dense one-hot contraction."""
    return einsum("...sk,...kd->...sd", onehot(idx, x.shape[-2]), x)


def gather_scalars(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """x[..., idx] batched for small source k: (..., k), (..., s) ->
    (..., s) as a dense one-hot contraction."""
    return einsum("...sk,...k->...s", onehot(idx, x.shape[-1]), x)


def scatter_rows_add(values: jnp.ndarray, idx: jnp.ndarray, k: int) -> jnp.ndarray:
    """Inverse of gather_scalars: place (..., s) values at positions
    (..., s) in a zeroed (..., k) row (dense one-hot transpose)."""
    return einsum("...sk,...s->...k", onehot(idx, k), values)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

# numpy, not jnp: module import must not initialize the device backend
QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_identity(shape=()) -> jnp.ndarray:
    return jnp.broadcast_to(QUAT_IDENTITY, tuple(shape) + (4,))


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    ax, ay, az, aw = jnp.moveaxis(a, -1, 0)
    bx, by, bz, bw = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    return q * jax.lax.rsqrt(jnp.maximum(jnp.sum(q * q, axis=-1), eps))[..., None]


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v by unit quaternions q.  v' = v + 2*cross(q.xyz, cross(q.xyz, v) + q.w*v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def quat_from_axis_angle(axis: jnp.ndarray, angle) -> jnp.ndarray:
    angle = jnp.asarray(angle)
    half = 0.5 * angle
    s = jnp.sin(half)[..., None]
    return jnp.concatenate(
        [normalize(axis) * s, jnp.cos(half)[..., None]], axis=-1
    )


def quat_from_euler(euler: jnp.ndarray) -> jnp.ndarray:
    """XYZ-intrinsic Euler angles (radians) -> quaternion."""
    hx, hy, hz = 0.5 * euler[..., 0], 0.5 * euler[..., 1], 0.5 * euler[..., 2]
    cx, sx = jnp.cos(hx), jnp.sin(hx)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    cz, sz = jnp.cos(hz), jnp.sin(hz)
    return jnp.stack(
        [
            sx * cy * cz + cx * sy * sz,
            cx * sy * cz - sx * cy * sz,
            cx * cy * sz + sx * sy * cz,
            cx * cy * cz - sx * sy * sz,
        ],
        axis=-1,
    )


def quat_to_mat3(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_slerp(a: jnp.ndarray, b: jnp.ndarray, t) -> jnp.ndarray:
    """Spherical lerp with nlerp fallback for nearly-parallel quaternions.

    Mirrors the animation interpolation path (reference:
    source/system/animation.cpp keyframe slerp).
    """
    t = jnp.asarray(t)
    cos_half = jnp.sum(a * b, axis=-1)
    b = jnp.where(cos_half[..., None] < 0.0, -b, b)
    cos_half = jnp.abs(cos_half)
    cos_half = jnp.clip(cos_half, -1.0, 1.0)
    half = jnp.arccos(cos_half)
    sin_half = jnp.sqrt(jnp.maximum(1.0 - cos_half * cos_half, 0.0))
    near = sin_half < 1e-4
    safe_sin = jnp.where(near, 1.0, sin_half)
    wa = jnp.where(near, 1.0 - t, jnp.sin((1.0 - t) * half) / safe_sin)
    wb = jnp.where(near, t, jnp.sin(t * half) / safe_sin)
    return quat_normalize(wa[..., None] * a + wb[..., None] * b)


def quat_integrate(q: jnp.ndarray, omega: jnp.ndarray, dt) -> jnp.ndarray:
    """Integrate orientation by angular velocity omega (rad/s) over dt.

    Semi-implicit Euler step on the quaternion: q' = normalize(q + dt/2 * (0,w)*q)
    — the same first-order update Jolt uses inside its integrator.
    """
    zeros = jnp.zeros_like(omega[..., :1])
    wq = jnp.concatenate([omega, zeros], axis=-1)
    dq = quat_mul(wq, q) * (0.5 * dt)
    return quat_normalize(q + dq)


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------


def mat4_identity(shape=()) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), tuple(shape) + (4, 4))


def compose_trs(position: jnp.ndarray, rotation: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """Translation/rotation(quat)/scale -> (..., 4, 4) model matrix."""
    r = quat_to_mat3(rotation) * scale[..., None, :]
    top = jnp.concatenate([r, position[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=r.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def apply_mat4(m: jnp.ndarray, p: jnp.ndarray, w: float = 1.0) -> jnp.ndarray:
    """Transform 3D points/directions by 4x4 matrices -> 3D (no divide).

    Single-matrix calls unroll to a per-column fma chain: the einsum form
    lowers to a dot_general that forces component-minor layouts on the
    (big-batch) point arrays plus layout copies."""
    if m.ndim == 2:
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return jnp.stack(
            [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] * w
             for i in range(3)], axis=-1)
    return (
        einsum("...ij,...j->...i", m[..., :3, :3], p)
        + m[..., :3, 3] * w
    )


def apply_mat4_h(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Transform 3D points -> homogeneous 4D clip coordinates.

    Single-matrix calls unroll (see apply_mat4)."""
    if m.ndim == 2:
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return jnp.stack(
            [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]
             for i in range(4)], axis=-1)
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    return einsum("...ij,...j->...i", m, ph)


def look_at(eye: jnp.ndarray, target: jnp.ndarray, up: jnp.ndarray) -> jnp.ndarray:
    """Right-handed view matrix (camera looks down -Z in view space)."""
    f = normalize(target - eye)
    s = normalize(jnp.cross(f, up))
    u = jnp.cross(s, f)
    rot = jnp.stack([s, u, -f], axis=-2)  # (...,3,3)
    trans = -einsum("...ij,...j->...i", rot, eye)
    top = jnp.concatenate([rot, trans[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def perspective_reverse_z(fov_y: float, aspect: float, near: float) -> jnp.ndarray:
    """Infinite-far reverse-Z perspective projection (depth 1 at near, 0 at inf).

    Matches the reference camera's reverse-Z convention
    (include/garden/system/camera.hpp:102 calcProjection).
    """
    f = 1.0 / _pymath.tan(0.5 * fov_y)
    m = jnp.zeros((4, 4), dtype=jnp.float32)
    m = m.at[0, 0].set(f / aspect)
    m = m.at[1, 1].set(f)
    # z' = near / -z_view  ->  depth near/|z|: 1 at z=-near, ->0 at infinity
    m = m.at[2, 3].set(near)
    m = m.at[3, 2].set(-1.0)
    return m


def orthographic(left, right, bottom, top, near, far, reverse_z: bool = True) -> jnp.ndarray:
    """Orthographic projection. With reverse_z, depth is 1 at near, 0 at far."""
    m = jnp.zeros((4, 4), dtype=jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    if reverse_z:
        m = m.at[2, 2].set(1.0 / (far - near))
        m = m.at[2, 3].set(far / (far - near))
    else:
        m = m.at[2, 2].set(-1.0 / (far - near))
        m = m.at[2, 3].set(-near / (far - near))
    m = m.at[3, 3].set(1.0)
    return m


def mat4_inverse(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.inv(m)


# ---------------------------------------------------------------------------
# AABBs
# ---------------------------------------------------------------------------


def aabb_union(min_a, max_a, min_b, max_b):
    return jnp.minimum(min_a, min_b), jnp.maximum(max_a, max_b)


def aabb_overlap(min_a, max_a, min_b, max_b) -> jnp.ndarray:
    """Batched AABB-AABB overlap test -> bool."""
    return jnp.all((min_a <= max_b) & (min_b <= max_a), axis=-1)


def aabb_transform(aabb_min, aabb_max, position, rotation):
    """Rotate+translate an AABB, returning the enclosing AABB.

    Uses the |R| trick: extent' = |R| @ extent (reference: math Aabb used by
    the frustum culling path, mesh.cpp:444-509).
    """
    center = 0.5 * (aabb_min + aabb_max)
    extent = 0.5 * (aabb_max - aabb_min)
    r = quat_to_mat3(rotation)
    new_center = quat_rotate(rotation, center) + position
    new_extent = einsum("...ij,...j->...i", jnp.abs(r), extent)
    return new_center - new_extent, new_center + new_extent


# ---------------------------------------------------------------------------
# Frustum
# ---------------------------------------------------------------------------


def frustum_planes(view_proj: jnp.ndarray) -> jnp.ndarray:
    """Extract 6 clip planes (a,b,c,d with ax+by+cz+d >= 0 inside) from a
    view-projection matrix (Gribb-Hartmann). Returns (..., 6, 4).

    With reverse-Z infinite projections the far plane is degenerate (all
    zeros); `aabb_outside_frustum` treats all-zero planes as always-inside.
    """
    r0, r1, r2, r3 = (view_proj[..., 0, :], view_proj[..., 1, :],
                      view_proj[..., 2, :], view_proj[..., 3, :])
    planes = jnp.stack(
        [
            r3 + r0,  # left
            r3 - r0,  # right
            r3 + r1,  # bottom
            r3 - r1,  # top
            r2,       # near for reverse-Z (0 <= z')
            r3 - r2,  # far  for reverse-Z (z' <= w)
        ],
        axis=-2,
    )
    n = planes[..., :3]
    scale = jax.lax.rsqrt(jnp.maximum(jnp.sum(n * n, axis=-1), 1e-20))
    return planes * scale[..., None]


def aabb_outside_frustum(planes: jnp.ndarray, aabb_min: jnp.ndarray, aabb_max: jnp.ndarray) -> jnp.ndarray:
    """True where the AABB is fully outside any frustum plane.

    Batched over leading axes of aabb_min/max; planes is (6, 4). The
    positive-vertex test: pick the AABB corner farthest along the plane
    normal; if even it is behind the plane, the box is out. (Batched analog of
    math::isBehindFrustum used by mesh culling, mesh.cpp:444-509.)
    """
    center = 0.5 * (aabb_min + aabb_max)
    extent = 0.5 * (aabb_max - aabb_min)
    n = planes[..., :3]  # (6,3)
    d = planes[..., 3]  # (6,)
    dist = (
        einsum("...i,pi->...p", center, n)
        + einsum("...i,pi->...p", extent, jnp.abs(n))
        + d
    )
    degenerate = jnp.all(planes == 0.0, axis=-1)  # (6,)
    outside_plane = (dist < 0.0) & ~degenerate
    return jnp.any(outside_plane, axis=-1)


# ---------------------------------------------------------------------------
# Color
# ---------------------------------------------------------------------------


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )
