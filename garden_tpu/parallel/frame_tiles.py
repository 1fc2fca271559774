"""Split-frame rendering: one frame's pixels sharded across devices.

The reference is a single-GPU engine; this is the multi-device analog of
multi-GPU split-frame rendering (SFR): the screen splits into horizontal
bands, each device renders its band through an ASYMMETRIC crop of the
projection matrix under shard_map (the raster's Pallas calls are not
split by XLA's partitioner), and the image concatenates over the mesh.
Complements the
many-world data parallelism of `parallel/worlds.py` (SURVEY.md section
2.11): worlds scale throughput, frame tiles scale a single frame's
latency.

Design notes (the SFR trade-offs, stated up front):
- Geometry work (vertex transform, triangle setup, shadow-cascade raster)
  replicates per band — only per-PIXEL work (raster coverage, G-buffer
  shading, lighting, post) scales. The flagship 1080p frame is ~75%
  per-pixel work, so 4 bands cut frame latency roughly in half.
- Screen-space effects (FXAA, HBAO, SSR, bloom) read neighbor pixels:
  each band renders `overlap` extra guard rows on both sides and crops
  them from the output, so effect kernels see their halo. Effects with a
  reach beyond the overlap (a long SSR march crossing a band) fall back
  to their miss path at the seam.
- Auto exposure is temporal: every band tone-maps the CURRENT frame with
  the shared luminance carried in the frame state, and the per-band
  averages reduce to one global value for the NEXT frame (a cross-device
  mean XLA lowers to one all-reduce) — bands never diverge in
  exposure, matching the adaptation semantics of tonemap.adapt_exposure.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from garden_tpu.core import math3d as m3

Array = jnp.ndarray


def crop_projection(view_proj: Array, y0_ndc: float, y1_ndc: float) -> Array:
    """Asymmetric vertical crop of a (view-)projection matrix: remaps NDC
    y in [y0, y1] onto the full [-1, 1] clip range (clip-space w rides in
    row 3, so the remap is a row operation — valid for perspective and
    ortho alike)."""
    scale = 2.0 / (y1_ndc - y0_ndc)
    off = -(y0_ndc + y1_ndc) / (y1_ndc - y0_ndc)
    m = view_proj
    return m.at[1].set(m[1] * scale + m[3] * off)


def band_constants(constants: Dict[str, Array], band: int, n_bands: int,
                   overlap_ndc: float) -> Dict[str, Array]:
    """Per-band camera constants: view_proj cropped to the band's rows
    (plus guard overlap), inv_view_proj re-inverted to match (position
    reconstruction and view rays consume it). The shadow cascades keep
    fitting the FULL frustum (shadow_inv_view_proj), so every band
    rasterizes the same shadow atlas as the unsplit frame and shadow
    edges stay continuous across seams."""
    # screen y is top-down, NDC y is bottom-up: band 0 (top rows) is the
    # HIGHEST NDC slice
    y1 = 1.0 - 2.0 * band / n_bands + overlap_ndc
    y0 = 1.0 - 2.0 * (band + 1) / n_bands - overlap_ndc
    vp = crop_projection(constants["view_proj"], y0, y1)
    out = dict(constants)
    out["view_proj"] = vp
    out["inv_view_proj"] = m3.mat4_inverse(vp)
    out["shadow_inv_view_proj"] = constants.get(
        "shadow_inv_view_proj", constants["inv_view_proj"])
    return out


class FrameTiles:
    """Render one frame as `n_bands` horizontal bands over a device mesh.

    make_renderer(band_cfg) -> DeferredRenderer must build the renderer
    from the provided per-band RenderConfig (height = full height /
    n_bands + 2 * overlap). The full-frame config comes in as `config`.

    Usage:
        ft = FrameTiles(cfg, scene, n_bands=8, overlap=16)
        state = ft.initial_state()
        image, state = ft.render(dev_scene, inst_mats, constants, state)
    """

    def __init__(self, config, scene, n_bands: int, overlap: int = 16,
                 devices: Optional[Sequence] = None):
        import dataclasses

        from garden_tpu.render.deferred import DeferredRenderer

        devices = list(devices if devices is not None else jax.devices())
        if n_bands > len(devices):
            raise ValueError(f"{n_bands} bands > {len(devices)} devices")
        if config.height % n_bands:
            raise ValueError("height must divide into bands")
        th = config.tile_h or config.tile_size
        band_h = config.height // n_bands
        # guard rows pad to whole raster tile rows, so band seams fall on
        # tile boundaries
        overlap = -(-overlap // th) * th
        self.n_bands = n_bands
        self.overlap = overlap
        self.band_h = band_h
        self.full_h = config.height
        self.config = dataclasses.replace(
            config, height=band_h + 2 * overlap)
        self.renderer = DeferredRenderer(self.config, scene)
        self.mesh = Mesh(np.array(devices[:n_bands]), axis_names=("bands",))
        self.sharding = NamedSharding(self.mesh, P("bands"))
        self._step = None

    def initial_state(self) -> Dict[str, Array]:
        one = self.renderer.initial_frame_state()
        batched = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(
                x, (self.n_bands,) + jnp.shape(x)).copy(), one)
        return jax.device_put(batched, self.sharding)

    def render(self, scene: Dict[str, Array], inst_matrices: Array,
               constants: Dict[str, Array], frame_state: Dict[str, Array]):
        """Returns (image (H, W, 3) uint8, next frame_state)."""
        if self._step is None:
            ov_ndc = 2.0 * self.overlap / self.full_h
            n = self.n_bands

            def one_band(band, fstate, scn, mats, consts):
                c = band_constants(consts, band, n, ov_ndc)
                out = self.renderer.render(scn, mats, c, fstate)
                return out["image"], out["frame_state"]

            # each device renders its own band(s)
            local = jax.shard_map(
                jax.vmap(one_band, in_axes=(0, 0, None, None, None)),
                mesh=self.mesh,
                in_specs=(P("bands"), P("bands"), P(), P(), P()),
                out_specs=(P("bands"), P("bands")), check_vma=False)

            def step(scn, mats, consts, fstate):
                bands = jnp.arange(n, dtype=jnp.int32)
                imgs, nstate = local(bands, fstate, scn, mats, consts)
                # crop guard rows, stitch bands into the full frame
                image = imgs[:, self.overlap:self.overlap + self.band_h]
                image = image.reshape(self.full_h, image.shape[2], 3)
                # one global exposure for the next frame
                nstate = dict(
                    nstate,
                    avg_luminance=jnp.broadcast_to(
                        jnp.mean(nstate["avg_luminance"]), (n,)))
                return image, nstate

            self._step = jax.jit(
                step,
                in_shardings=(None, None, None, self.sharding),
                out_shardings=(None, self.sharding),
            )
        return self._step(scene, inst_matrices, constants, frame_state)
