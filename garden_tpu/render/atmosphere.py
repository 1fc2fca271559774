"""Physically-based sky / atmosphere.

Rebuild of AtmosphereRenderSystem (include/garden/system/render/atmosphere.
hpp:42, source/system/render/atmosphere.cpp:40-135 — a Hillaire-style sky:
transmittance LUT 256x64, multi-scatter LUT 32^2, sky-view LUT, SH ambient
generation via sh-generate.comp; LUT sizes in shaders/atmosphere/
constants.h:22-26).

Device twist: texture LUT lookups are per-pixel gathers, so the *frame
path* evaluates transmittance analytically with a
Chapman-function approximation — pure dense math per pixel — while the
reference's LUTs are still available (`transmittance_lut`) for tests and
offline use. Ambient diffuse comes from an order-2 spherical-harmonics
projection of the sky (the sh-generate/sh-reduce compute pair), and ambient
specular from evaluating the sky in the reflection direction with a
roughness-driven blend to the SH irradiance.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3

Array = jnp.ndarray

# Earth-like atmosphere (Hillaire 2020 / the reference's constants)
R_GROUND = 6360.0      # km
R_TOP = 6460.0         # km
H_RAYLEIGH = 8.0       # km scale height
H_MIE = 1.2
BETA_RAYLEIGH = np.array([5.802e-3, 13.558e-3, 33.1e-3])   # 1/km
BETA_MIE_SCAT = 3.996e-3
BETA_MIE_ABS = 4.4e-3
BETA_OZONE = np.array([0.650e-3, 1.881e-3, 0.085e-3])
MIE_G = 0.8

SUN_INTENSITY = 16.0


def _chapman(x: Array, cos_chi: Array) -> Array:
    """Chapman grazing-incidence function approximation (Schueler 2012):
    relative airmass along a ray leaving altitude x (in scale heights above
    planet center units) at zenith cosine cos_chi."""
    c = jnp.sqrt(x * (2.0 * jnp.pi))
    upper = c / (c * cos_chi + 1.0)
    # for downward rays, use symmetry: ch(-mu) = 2*exp(x - x*sin) * ch0 - ch(mu)
    sin_chi = jnp.sqrt(jnp.maximum(1.0 - cos_chi * cos_chi, 0.0))
    x_horizon = x * sin_chi
    ch0 = jnp.sqrt(x_horizon * (2.0 * jnp.pi)) * 0.5 + 1.0
    lower = 2.0 * jnp.exp(x - x_horizon) * ch0 - c / (c * (-cos_chi) + 1.0)
    return jnp.where(cos_chi >= 0.0, upper, lower)


def _optical_depth_to_space(height_km: Array, cos_zenith: Array,
                            scale_height: float) -> Array:
    """Airmass integral from a point at `height_km` above ground to space.
    Clamped: the Chapman lower branch overflows for deeply-downward rays,
    and inf optical depth turns into NaN through downstream products;
    e^-100 is already exactly 0 in f32."""
    x = (R_GROUND + height_km) / scale_height
    od = scale_height * jnp.exp(-height_km / scale_height) * _chapman(x, cos_zenith)
    return jnp.minimum(od, 1e4)


def sun_transmittance(height_km: Array, cos_zenith: Array) -> Array:
    """Transmittance toward the sun (..., 3) — the transmittance-LUT value,
    computed analytically."""
    od_r = _optical_depth_to_space(height_km, cos_zenith, H_RAYLEIGH)
    od_m = _optical_depth_to_space(height_km, cos_zenith, H_MIE)
    tau = (
        od_r[..., None] * jnp.asarray(BETA_RAYLEIGH)
        + od_m[..., None] * (BETA_MIE_SCAT + BETA_MIE_ABS)
        + od_r[..., None] * jnp.asarray(BETA_OZONE) * 0.1
    )
    # below-horizon rays hit the ground: fully extinct
    sin_h = R_GROUND / (R_GROUND + jnp.maximum(height_km, 0.0))
    horizon_mu = -jnp.sqrt(jnp.maximum(1.0 - sin_h * sin_h, 0.0))
    blocked = cos_zenith < horizon_mu
    return jnp.where(blocked[..., None], 0.0, jnp.exp(-tau))


def transmittance_lut(size: Tuple[int, int] = (64, 256)) -> Array:
    """The reference's 256x64 transmittance LUT (constants.h:22), rows =
    altitude [0, 100km], cols = sun zenith cosine [-0.2, 1]."""
    hgrid = jnp.linspace(0.0, R_TOP - R_GROUND, size[0])
    mugrid = jnp.linspace(-0.2, 1.0, size[1])
    h, mu = jnp.meshgrid(hgrid, mugrid, indexing="ij")
    return sun_transmittance(h, mu)


def multi_scatter_lut(size: int = 32, dirs: int = 64) -> Array:
    """The reference's 32x32 multiple-scattering LUT (constants.h:23):
    rows = altitude [0, atmosphere top], cols = sun zenith cosine [-1, 1];
    value = isotropic multi-scatter transfer Psi_ms (Hillaire 2020 eq. 10).

    Second-order estimate: integrate single scattering + transfer over a
    sphere of directions, then apply the geometric-series closure
    Psi = L_2nd / (1 - f_ms). Offline/parity use — the frame path's dense
    analytic floor approximates this LUT's effect without per-pixel gathers.
    """
    h_grid = jnp.linspace(0.0, R_TOP - R_GROUND, size)
    mu_grid = jnp.linspace(-1.0, 1.0, size)
    h, mu = jnp.meshgrid(h_grid, mu_grid, indexing="ij")

    sph = jnp.asarray(_fibonacci_sphere(dirs))            # (D, 3)
    sun = jnp.stack([jnp.sqrt(jnp.clip(1 - mu ** 2, 0, 1)),
                     mu, jnp.zeros_like(mu)], axis=-1)    # (S, S, 3)

    beta_r = jnp.asarray(BETA_RAYLEIGH, jnp.float32)
    beta_m = jnp.float32(BETA_MIE_SCAT)

    l2 = jnp.zeros(h.shape + (3,), jnp.float32)
    fms = jnp.zeros(h.shape, jnp.float32)
    for d in range(dirs):
        v = sph[d]
        cos_sun = jnp.sum(sun * v, axis=-1)
        # march a short ray from altitude h along v (8 steps, flat layers)
        t_max = 40.0
        dt = t_max / 8
        tau = jnp.zeros(h.shape + (3,), jnp.float32)
        for i in range(8):
            y = jnp.maximum(h + v[1] * (i + 0.5) * dt, 0.0)
            dens_r = jnp.exp(-y / H_RAYLEIGH)
            dens_m = jnp.exp(-y / H_MIE)
            t_sun = sun_transmittance(y, mu)
            scat = (beta_r * dens_r[..., None] * _phase_rayleigh(cos_sun)[..., None]
                    + beta_m * dens_m[..., None] * _phase_mie(cos_sun)[..., None])
            t_view = jnp.exp(-tau)
            l2 = l2 + scat * t_sun * t_view * dt / dirs
            # transfer factor: scattered-again fraction (isotropic phase)
            fms = fms + (beta_r.mean() * dens_r + beta_m * dens_m) \
                * jnp.exp(-tau.mean(-1)) * dt / dirs
            tau = tau + (beta_r * dens_r[..., None]
                         + (BETA_MIE_SCAT + BETA_MIE_ABS) * dens_m[..., None]) * dt
    psi = l2 / jnp.maximum(1.0 - jnp.clip(fms, 0.0, 0.99), 1e-3)[..., None]
    # isolated grazing-angle cells can overflow through the Chapman branch;
    # zero them (they sit below the horizon where the LUT is unused)
    return jnp.nan_to_num(psi, nan=0.0, posinf=0.0)


def _phase_rayleigh(cos_t: Array) -> Array:
    return 3.0 / (16.0 * jnp.pi) * (1.0 + cos_t * cos_t)


def _phase_mie(cos_t: Array, g: float = MIE_G) -> Array:
    gg = g * g
    return (3.0 / (8.0 * jnp.pi)) * ((1.0 - gg) * (1.0 + cos_t * cos_t)) / (
        (2.0 + gg) * jnp.power(jnp.maximum(1.0 + gg - 2.0 * g * cos_t, 1e-6), 1.5)
    )


def sky_radiance(view_dir: Array, sun_dir_to_light: Array,
                 camera_height_km: float = 0.2, steps: int = 12) -> Array:
    """Single-scattered sky radiance along view rays (..., 3).

    Dense-math raymarch: `steps` samples along the ray, analytic sun
    transmittance at each — no LUT gathers (see module docstring). Includes
    a multi-scatter ambient floor (the 32^2 multi-scatter LUT's role).
    """
    v = m3.normalize(view_dir)
    l = m3.normalize(sun_dir_to_light)
    mu_v = v[..., 1]

    # ray length through the atmosphere (flat-ish approximation near ground,
    # sphere-exact at the horizon via the chapman airmass in transmittance)
    h0 = camera_height_km
    r0 = R_GROUND + h0
    b = r0 * mu_v
    disc_top = b * b + (R_TOP * R_TOP - r0 * r0)
    t_top = -b + jnp.sqrt(jnp.maximum(disc_top, 0.0))
    disc_g = b * b + (R_GROUND * R_GROUND - r0 * r0)
    hits_ground = (mu_v < 0.0) & (disc_g > 0.0)
    t_ground = -b - jnp.sqrt(jnp.maximum(disc_g, 0.0))
    t_max = jnp.where(hits_ground, jnp.maximum(t_ground, 0.0), t_top)
    t_max = jnp.clip(t_max, 0.0, 400.0)

    cos_sun = m3.dot(v, l)
    ph_r = _phase_rayleigh(cos_sun)[..., None]
    ph_m = _phase_mie(cos_sun)[..., None]
    mu_sun = l[..., 1]

    beta_r = jnp.asarray(BETA_RAYLEIGH, jnp.float32)
    beta_m = jnp.float32(BETA_MIE_SCAT)

    lum = jnp.zeros(v.shape[:-1] + (3,), jnp.float32)
    tau_acc = jnp.zeros(v.shape[:-1] + (3,), jnp.float32)
    dt = t_max / steps
    for i in range(steps):
        t = (i + 0.5) * dt
        # altitude along the ray on the curved earth
        y = jnp.sqrt(r0 * r0 + t * t + 2.0 * r0 * t * mu_v) - R_GROUND
        y = jnp.maximum(y, 0.0)
        dens_r = jnp.exp(-y / H_RAYLEIGH)[..., None]
        dens_m = jnp.exp(-y / H_MIE)[..., None]
        step_tau = (beta_r * dens_r + (BETA_MIE_SCAT + BETA_MIE_ABS) * dens_m) * dt[..., None]
        t_view = jnp.exp(-(tau_acc + 0.5 * step_tau))
        t_sun = sun_transmittance(y, jnp.broadcast_to(mu_sun, y.shape))
        scat = (beta_r * dens_r * ph_r + beta_m * dens_m * ph_m)
        lum = lum + SUN_INTENSITY * scat * t_sun * t_view * dt[..., None]
        tau_acc = tau_acc + step_tau

    # multi-scatter ambient floor (stands in for the 32^2 MS LUT)
    ms = 0.075 * jnp.asarray([0.35, 0.45, 0.7]) * jnp.clip(mu_sun, 0.0, 1.0)
    lum = lum + ms * (1.0 - jnp.exp(-tau_acc))

    # ground albedo for rays that hit the earth
    ground_col = jnp.asarray([0.3, 0.25, 0.2]) * (
        SUN_INTENSITY / jnp.pi
    ) * jnp.clip(mu_sun, 0.0, 1.0) * sun_transmittance(
        jnp.zeros_like(mu_v), jnp.broadcast_to(mu_sun, mu_v.shape))
    lum = jnp.where(hits_ground[..., None],
                    ground_col * jnp.exp(-tau_acc) + lum, lum)

    # sun disk
    sun_vis = (~hits_ground) & (cos_sun > 0.99955)
    sun_t = sun_transmittance(jnp.full_like(mu_v, h0),
                              jnp.broadcast_to(mu_sun, mu_v.shape))
    lum = jnp.where(sun_vis[..., None], SUN_INTENSITY * 80.0 * sun_t + lum, lum)
    return lum


def aerial_perspective(
    view_depth_km: Array,      # (...,) distance camera -> surface, km
    view_dir: Array,           # (..., 3)
    sun_dir_to_light: Array,
    camera_height_km: float = 0.2,
) -> Tuple[Array, Array]:
    """Aerial perspective for geometry: (transmittance (...,3), in-scatter
    (...,3)) along the view ray up to the surface — the camera-volume froxel
    LUT's role (32^3 at shaders/atmosphere/constants.h:25, applied to
    geometry in the reference's sky pass), computed as dense per-pixel
    analytic single scattering (4 steps; no froxel gathers)."""
    v = m3.normalize(view_dir)
    l = m3.normalize(sun_dir_to_light)
    mu_v = v[..., 1]
    mu_sun = l[..., 1]
    cos_sun = m3.dot(v, l)
    ph_r = _phase_rayleigh(cos_sun)[..., None]
    ph_m = _phase_mie(cos_sun)[..., None]
    beta_r = jnp.asarray(BETA_RAYLEIGH, jnp.float32)
    beta_m = jnp.float32(BETA_MIE_SCAT)

    steps = 4
    dt = view_depth_km / steps
    lum = jnp.zeros(v.shape[:-1] + (3,), jnp.float32)
    tau = jnp.zeros(v.shape[:-1] + (3,), jnp.float32)
    for i in range(steps):
        t = (i + 0.5) * dt
        y = jnp.maximum(camera_height_km + t * mu_v, 0.0)
        dens_r = jnp.exp(-y / H_RAYLEIGH)[..., None]
        dens_m = jnp.exp(-y / H_MIE)[..., None]
        step_tau = (beta_r * dens_r
                    + (BETA_MIE_SCAT + BETA_MIE_ABS) * dens_m) * dt[..., None]
        t_view = jnp.exp(-(tau + 0.5 * step_tau))
        t_sun = sun_transmittance(y, jnp.broadcast_to(mu_sun, y.shape))
        scat = beta_r * dens_r * ph_r + beta_m * dens_m * ph_m
        lum = lum + SUN_INTENSITY * scat * t_sun * t_view * dt[..., None]
        tau = tau + step_tau
    return jnp.exp(-tau), lum


# -- spherical harmonics ambient (sh-generate.comp / sh-reduce analog) -------


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                     np.sin(phi) * np.sin(theta)], axis=-1).astype(np.float32)


_SH_DIRS = _fibonacci_sphere(128)


def _sh_basis(d: Array) -> Array:
    """Order-2 real SH basis (..., 9)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return jnp.stack([
        jnp.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], axis=-1)


def sky_sh(sun_dir_to_light: Array, camera_height_km: float = 0.2) -> Array:
    """Project the sky into order-2 SH -> (9, 3) radiance coefficients
    (the shCoeffs buffer, pbr-lighting.hpp:65)."""
    dirs = jnp.asarray(_SH_DIRS)
    rad = sky_radiance(dirs, sun_dir_to_light, camera_height_km, steps=8)
    basis = _sh_basis(dirs)                    # (S, 9)
    return m3.einsum("sb,sc->bc", basis, rad) * (4.0 * jnp.pi / dirs.shape[0])


def sh_irradiance(normal: Array, sh: Array) -> Array:
    """Diffuse irradiance from SH coefficients (..., 3) — the ibl.gsl
    convolution with the clamped-cosine kernel.

    Evaluated as an UNROLLED 9-term fma chain on (..., 1) x (3,) factors:
    the einsum formulation materialized a full-res (H, W, 9) basis stack
    for the dot_general plus a layout copy; the unrolled form fuses into
    one elementwise pass."""
    a = (3.141593, 2.094395, 2.094395, 2.094395,
         0.785398, 0.785398, 0.785398, 0.785398, 0.785398)
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    terms = (
        jnp.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    )
    out = jnp.zeros(normal.shape[:-1] + (3,), normal.dtype)
    for i in range(9):
        out = out + (terms[i] * a[i])[..., None] * sh[i]
    return jnp.maximum(out / jnp.pi, 0.0)
