"""Pad-once shifted-image reads for dense screen-space passes.

Every screen-space pass in this engine (HBAO horizon marches, FXAA edge
end-search, SMAA run lengths, PCF taps, separable blurs, bilateral
upsamples) reads fixed-offset shifted copies of an image with edge-clamp
semantics. The naive form — `jnp.pad(x, ..., mode="edge")` per tap — is
what the reference's texture units do for free, but here each edge-pad
lowers to a chain of slice+concatenate HLO ops, and a 40-tap pass turns
into ~1400 traced primitives.

`Shifter` pads ONCE to the maximum tap radius and serves every tap as a
single static slice of the shared padded buffer. Slices fuse into their
elementwise consumers, so an N-tap pass costs one pad + N fused loads —
the memory-access shape a GPU's clamped texture sampler gives the
reference shaders (e.g. shaders/fxaa.frag, hbao.frag taps).
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


class Shifter:
    """Edge-clamped shifted reads of a 2D(+channels) image.

    `Shifter(img, ry, rx)(dy, dx)[y, x] == img[clamp(y + dy), clamp(x + dx)]`
    for any |dy| <= ry, |dx| <= rx. Pads once at construction; each call
    is one slice.
    """

    def __init__(self, img: Array, ry: int, rx: int):
        self.h, self.w = img.shape[0], img.shape[1]
        self.ry, self.rx = int(ry), int(rx)
        if self.ry == 0 and self.rx == 0:
            self.p = img
        else:
            pads = ((self.ry, self.ry), (self.rx, self.rx)) + \
                ((0, 0),) * (img.ndim - 2)
            self.p = jnp.pad(img, pads, mode="edge")

    def __call__(self, dy: int, dx: int) -> Array:
        dy, dx = int(dy), int(dx)
        assert abs(dy) <= self.ry and abs(dx) <= self.rx, \
            f"tap ({dy},{dx}) outside padded radius ({self.ry},{self.rx})"
        return self.p[self.ry + dy:self.ry + dy + self.h,
                      self.rx + dx:self.rx + dx + self.w]
