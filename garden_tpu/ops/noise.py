"""Procedural noise kernels: gradient (Perlin) noise + fractal combinators.

Rebuild of the FastNoise2 integration (re-exported at
include/garden/noise.hpp:20 for application worldgen; also the prebaked 3D
noise textures the volumetric clouds use, source/system/render/clouds.cpp:
117-269). FastNoise2 is a SIMD node-graph noise library; the equivalent
here is a set of vectorized jnp kernels — hash-based gradient noise (no
permutation tables: an integer avalanche hash computes gradients on the
fly, which vectorizes perfectly) plus fBm / ridged / turbulence
fractal combinators and domain warping.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

Array = jnp.ndarray

_PRIME_X = 501125321
_PRIME_Y = 1136930381
_PRIME_Z = 1720413743


def _hash(ix: Array, iy: Array, iz: Array = None, seed: int = 0) -> Array:
    """Integer avalanche hash (xxhash-style mixing) -> uint32."""
    h = jnp.uint32((seed * 0x9E3779B9 + 0x85EBCA6B) & 0xFFFFFFFF)
    h = h ^ (ix.astype(jnp.uint32) * jnp.uint32(_PRIME_X))
    h = h ^ (iy.astype(jnp.uint32) * jnp.uint32(_PRIME_Y))
    if iz is not None:
        h = h ^ (iz.astype(jnp.uint32) * jnp.uint32(_PRIME_Z))
    h = h * jnp.uint32(0x27D4EB2F)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x85EBCA77)
    h = h ^ (h >> 13)
    return h


def _grad2(h: Array, fx: Array, fy: Array) -> Array:
    """Gradient dot product from 8 fixed 2D directions."""
    g = (h >> 3) % 8
    gx = jnp.where(g < 4, jnp.where(g % 2 == 0, 1.0, -1.0),
                   jnp.where(g % 2 == 0, 0.70710678, -0.70710678))
    gy = jnp.where(g < 4, jnp.where(g < 2, 1.0, -1.0),
                   jnp.where(g < 6, 0.70710678, -0.70710678))
    return gx * fx + gy * fy


def _grad3(h: Array, fx: Array, fy: Array, fz: Array) -> Array:
    """Gradient dot product from the 12 edge directions of a cube."""
    g = (h >> 3) % 12
    u = jnp.where(g < 8, fx, fy)
    v = jnp.where(g < 4, fy, jnp.where((g == 12) | (g == 14), fx, fz))
    su = jnp.where((g & 1) == 0, u, -u)
    sv = jnp.where((g & 2) == 0, v, -v)
    return su + sv


def _fade(t: Array) -> Array:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin2(x: Array, y: Array, seed: int = 0) -> Array:
    """2D gradient noise in ~[-1, 1]."""
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = x - ix
    fy = y - iy
    u = _fade(fx)
    v = _fade(fy)

    def corner(ox, oy):
        h = _hash(ix + ox, iy + oy, seed=seed)
        return _grad2(h, fx - ox, fy - oy)

    n00 = corner(0, 0)
    n10 = corner(1, 0)
    n01 = corner(0, 1)
    n11 = corner(1, 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return (nx0 + v * (nx1 - nx0)) * 1.4142135


def perlin3(x: Array, y: Array, z: Array, seed: int = 0) -> Array:
    """3D gradient noise in ~[-1, 1]."""
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    iz = jnp.floor(z).astype(jnp.int32)
    fx = x - ix
    fy = y - iy
    fz = z - iz
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def corner(ox, oy, oz):
        h = _hash(ix + ox, iy + oy, iz + oz, seed=seed)
        return _grad3(h, fx - ox, fy - oy, fz - oz)

    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return (nxy0 + w * (nxy1 - nxy0)) * 1.1547


def value2(x: Array, y: Array, seed: int = 0) -> Array:
    """2D value noise in [-1, 1]."""
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    fx = _fade(x - ix)
    fy = _fade(y - iy)

    def corner(ox, oy):
        h = _hash(ix + ox, iy + oy, seed=seed)
        return h.astype(jnp.float32) / jnp.float32(2 ** 31) - 1.0

    n00, n10 = corner(0, 0), corner(1, 0)
    n01, n11 = corner(0, 1), corner(1, 1)
    nx0 = n00 + fx * (n10 - n00)
    nx1 = n01 + fx * (n11 - n01)
    return nx0 + fy * (nx1 - nx0)


def worley3(x: Array, y: Array, z: Array, seed: int = 0) -> Array:
    """3D Worley (cellular) noise: distance to the nearest jittered feature
    point over the 27 neighboring cells, in [0, 1] (0 at feature points).
    The Perlin-Worley cloud-base ingredient (FastNoise2 CellularDistance
    analog used by the reference's prebaked cloud noise, clouds.cpp:117)."""
    ix = jnp.floor(x)
    iy = jnp.floor(y)
    iz = jnp.floor(z)
    fx = x - ix
    fy = y - iy
    fz = z - iz
    best = jnp.full(jnp.shape(x), 8.0, jnp.float32)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                cx = ix + ox
                cy = iy + oy
                cz = iz + oz
                h = _hash(cx.astype(jnp.int32), cy.astype(jnp.int32),
                          cz.astype(jnp.int32), seed)
                jx = (h & 0x3FF).astype(jnp.float32) / 1023.0
                jy = ((h >> 10) & 0x3FF).astype(jnp.float32) / 1023.0
                jz = ((h >> 20) & 0x3FF).astype(jnp.float32) / 1023.0
                dx = ox + jx - fx
                dy = oy + jy - fy
                dz = oz + jz - fz
                best = jnp.minimum(best, dx * dx + dy * dy + dz * dz)
    return jnp.minimum(jnp.sqrt(best), 1.0)


def perlin_worley3(x: Array, y: Array, z: Array, seed: int = 0) -> Array:
    """The HZD cloud-base noise: Perlin remapped by inverted Worley, giving
    billowy connected shapes (clouds.cpp prebaked base texture analog)."""
    p = perlin3(x, y, z, seed=seed) * 0.5 + 0.5
    w = 1.0 - worley3(x, y, z, seed=seed + 31)
    # remap perlin into the worley envelope
    return jnp.clip((p - (1.0 - w)) / jnp.maximum(w, 1e-3), 0.0, 1.0)


def fbm(noise_fn: Callable, *coords: Array, octaves: int = 5,
        lacunarity: float = 2.0, gain: float = 0.5, seed: int = 0) -> Array:
    """Fractal Brownian motion over any base noise (FastNoise2 Fractal node)."""
    amp = 1.0
    freq = 1.0
    total = jnp.zeros_like(coords[0])
    norm = 0.0
    for o in range(octaves):
        total = total + amp * noise_fn(*[c * freq for c in coords],
                                       seed=seed + o)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def ridged(noise_fn: Callable, *coords: Array, octaves: int = 5,
           lacunarity: float = 2.0, gain: float = 0.5, seed: int = 0) -> Array:
    """Ridged multifractal (FastNoise2 FractalRidged node)."""
    amp = 1.0
    freq = 1.0
    total = jnp.zeros_like(coords[0])
    norm = 0.0
    for o in range(octaves):
        n = 1.0 - jnp.abs(noise_fn(*[c * freq for c in coords], seed=seed + o))
        total = total + amp * (n * 2.0 - 1.0)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def turbulence(noise_fn: Callable, *coords: Array, octaves: int = 4,
               seed: int = 0) -> Array:
    """Sum of |noise| octaves in [0, 1]."""
    amp = 1.0
    freq = 1.0
    total = jnp.zeros_like(coords[0])
    norm = 0.0
    for o in range(octaves):
        total = total + amp * jnp.abs(noise_fn(*[c * freq for c in coords],
                                               seed=seed + o))
        norm += amp
        amp *= 0.5
        freq *= 2.0
    return total / norm


def domain_warp2(x: Array, y: Array, strength: float = 1.0,
                 seed: int = 0) -> tuple:
    """Domain warping (FastNoise2 DomainWarp node)."""
    wx = perlin2(x, y, seed=seed + 101) * strength
    wy = perlin2(x, y, seed=seed + 313) * strength
    return x + wx, y + wy


def terrain_heightmap(size: int, world_scale: float = 0.02,
                      height_scale: float = 8.0, seed: int = 0) -> Array:
    """Procedural terrain heights (size, size) — the worldgen config-2 path
    (FastNoise2 heightfield -> static-body upload, BASELINE.json)."""
    xs = jnp.arange(size, dtype=jnp.float32)
    gy, gx = jnp.meshgrid(xs, xs, indexing="ij")
    x, y = domain_warp2(gx * world_scale, gy * world_scale, 0.6, seed)
    base = fbm(perlin2, x, y, octaves=6, seed=seed)
    ridge = ridged(perlin2, x * 0.5, y * 0.5, octaves=4, seed=seed + 7)
    return (base * 0.7 + ridge * 0.3) * height_scale
