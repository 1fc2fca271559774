"""Image-based lighting: prefiltered specular environment + DFG term.

Rebuild of PbrLightingSystem's IBL path (include/garden/system/render/
pbr-lighting.hpp:65 — DFG LUT + shCoeffs + specular cubemap computed by
shaders/pbr-lighting/ibl-specular.comp from a source environment map).

Device shape:
- The specular environment is a lat-long (equirect) mip chain prefiltered
  with roughness-matched blurs (the ibl-specular.comp GGX-importance-sample
  analog, collapsed to separable blurs per mip — dense ops, no RNG).
- The DFG (environment BRDF) term uses Lazarov's analytic fit instead of the
  reference's 2D LUT: two fused polynomials per pixel instead of a
  per-pixel LUT gather.
- Diffuse irradiance stays spherical-harmonics (render/atmosphere.sky_sh /
  sh_irradiance), matching the reference's shCoeffs path.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import jax
import jax.numpy as jnp

from garden_tpu.core import math3d as m3

Array = jnp.ndarray


def dfg_approx(nov: Array, roughness: Array) -> Tuple[Array, Array]:
    """Analytic environment-BRDF (scale, bias) for F0 — Lazarov 2013 fit of
    the Karis split-sum DFG LUT (the dfgLUT at pbr-lighting.hpp:65)."""
    # unrolled per-coefficient planes (the [..., None] broadcast against
    # the (4,) constants materialized a channel-minor (H, W, 4) buffer)
    r0 = roughness * -1.0 + 1.0
    r1 = roughness * -0.0275 + 0.0425
    r2 = roughness * -0.572 + 1.04
    r3 = roughness * 0.022 - 0.04
    a004 = jnp.minimum(r0 * r0, jnp.exp2(-9.28 * nov)) * r0 + r1
    scale = -1.04 * a004 + r2
    bias = 1.04 * a004 + r3
    return scale, bias


def specular_env_brdf(f0: Array, nov: Array, roughness: Array) -> Array:
    """Split-sum: env_sample * (f0 * scale + bias)."""
    scale, bias = dfg_approx(nov, roughness)
    return f0 * scale[..., None] + bias[..., None]


def _blur2d(img: Array, radius: int) -> Array:
    """Separable box blur with horizontal wrap (lat-long continuity)."""
    if radius <= 0:
        return img
    n = 2 * radius + 1
    acc = jnp.zeros_like(img)
    for d in range(-radius, radius + 1):
        acc = acc + jnp.roll(img, d, axis=1)          # wrap in longitude
    img = acc / n
    acc = jnp.zeros_like(img)
    h = img.shape[0]
    for d in range(-radius, radius + 1):
        idx = jnp.clip(jnp.arange(h) + d, 0, h - 1)   # clamp in latitude
        acc = acc + img[idx]
    return acc / n


def prefilter_latlong(env: Array, mip_count: int = 5) -> List[Array]:
    """Roughness-prefiltered lat-long mip chain (ibl-specular.comp analog):
    mip k targets roughness k/(mips-1) via progressively wider blurs +
    downsampling. env: (H, W, 3) with W = 2H."""
    mips = [env]
    cur = env
    for k in range(1, mip_count):
        h = max(cur.shape[0] // 2, 4)
        w = max(cur.shape[1] // 2, 8)
        cur = jax.image.resize(cur, (h, w, 3), "linear")
        # blur radius grows with target roughness (GGX lobe widening)
        cur = _blur2d(cur, radius=1 + k)
        mips.append(cur)
    return mips


def _latlong_uv(dirs: Array) -> Tuple[Array, Array]:
    """Direction -> lat-long (u in [0,1) longitude, v in [0,1] latitude)."""
    d = m3.normalize(dirs)
    u = (jnp.arctan2(d[..., 2], d[..., 0]) / (2.0 * math.pi)) % 1.0
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def sample_prefiltered(mips: List[Array], dirs: Array,
                       roughness: Array) -> Array:
    """Sample the prefiltered chain at the reflection direction with a
    roughness-selected mip (nearest mip, nearest texel: one gather per mip
    level touched — gathers are the scarce resource)."""
    n = len(mips)
    level = jnp.clip(roughness, 0.0, 1.0) * (n - 1)
    lo = jnp.floor(level).astype(jnp.int32)
    frac = level - lo
    u, v = _latlong_uv(dirs)

    def fetch(mip: Array) -> Array:
        h, w = mip.shape[0], mip.shape[1]
        x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
        y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
        return mip.reshape(-1, 3)[y * w + x]

    out = jnp.zeros(dirs.shape[:-1] + (3,), jnp.float32)
    for k in range(n):
        val = fetch(mips[k])
        w_k = jnp.where(lo == k, 1.0 - frac,
                        jnp.where(lo == k - 1, frac, 0.0))
        out = out + val * w_k[..., None]
    return out


def latlong_sh(env: Array) -> Array:
    """Project a lat-long environment map into order-2 SH -> (9, 3)
    radiance coefficients (the sh-generate/sh-reduce compute pair applied to
    a static skybox, atmosphere.cpp:40-135 / skybox.hpp:48)."""
    h, w = env.shape[0], env.shape[1]
    theta = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * math.pi
    phi = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 * math.pi
    th, ph = jnp.meshgrid(theta, phi, indexing="ij")
    dirs = jnp.stack([jnp.sin(th) * jnp.cos(ph), jnp.cos(th),
                      jnp.sin(th) * jnp.sin(ph)], axis=-1)
    from garden_tpu.render.atmosphere import _sh_basis
    basis = _sh_basis(dirs)                                 # (h, w, 9)
    d_omega = (math.pi / h) * (2.0 * math.pi / w) * jnp.sin(th)
    return m3.einsum("hwb,hwc->bc", basis * d_omega[..., None], env)


def sky_prefiltered(sun_dir_to_light: Array, height: int = 32,
                    mip_count: int = 5) -> List[Array]:
    """Prefiltered chain of the procedural sky (AtmosphereRenderSystem's
    dynamic-skybox -> ibl-specular path, atmosphere.cpp:40-135): render the
    sky into a small lat-long map once per frame, then prefilter."""
    from garden_tpu.render import atmosphere as atm
    h, w = height, height * 2
    v = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * math.pi
    u = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w * 2.0 * math.pi
    theta, phi = jnp.meshgrid(v, u, indexing="ij")
    dirs = jnp.stack([jnp.sin(theta) * jnp.cos(phi), jnp.cos(theta),
                      jnp.sin(theta) * jnp.sin(phi)], axis=-1)
    env = atm.sky_radiance(dirs, sun_dir_to_light, steps=8)
    return prefilter_latlong(env, mip_count)
