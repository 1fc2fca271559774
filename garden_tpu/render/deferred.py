"""Deferred renderer: the static pass schedule.

Rebuild of DeferredRenderSystem's event chain (source/system/render/
deferred.cpp:441-777): PreDeferredRender (culling + shadows) -> G-buffer ->
HdrRender (PBR lighting) -> LdrRender (bloom, auto exposure, tone map) ->
AA. The event chain is already a static schedule in disguise; here it is
literally a function composing pass functions, all inside one jit.
Framebuffers are entries of the returned frame dict; pass-enable flags are
static config (recompile on change), exactly like the reference's pipeline
variants (SURVEY.md section 7 'Branchy pass-enable flags').
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from garden_tpu.core import math3d as m3
from garden_tpu.core.config import RenderConfig
from garden_tpu.render import bloom as bloom_mod
from garden_tpu.render import csm as csm_mod
from garden_tpu.render import fxaa as fxaa_mod
from garden_tpu.render import hiz as hiz_mod
from garden_tpu.render import oit as oit_mod
from garden_tpu.render import sprites as sprites_mod
from garden_tpu.render import gbuffer, hbao, lighting, mesh, raster, tonemap

Array = jnp.ndarray


class DeferredRenderer:
    """Owns static scene buffers + config; `render` is a pure function of
    (instance matrices, constants, frame state)."""

    def __init__(self, config: RenderConfig, scene: mesh.SceneBuffers):
        self.config = config
        self.scene_host = scene
        # trace-time pass gating on scene content (the reference's anyOIT /
        # anyRefraction / anyTranslucent flags, deferred.hpp:122-123): an
        # OIT pass over a scene with no translucent triangles costs a full
        # bin+raster for nothing
        self.any_translucent = bool(scene.tri_translucent_mask().any())
        self.any_sorted = bool(scene.tri_sorted_mask().any())
        self.any_refract = bool(scene.tri_refract_mask().any())

    def device_scene(self) -> Dict[str, Array]:
        return self.scene_host.device_arrays()

    def initial_frame_state(self) -> Dict[str, Array]:
        state = {"avg_luminance": jnp.float32(0.18)}
        w, h = self.frame_size()
        if self.config.use_occlusion_culling or self.config.use_velocity:
            # previous frame's depth (Hi-Z source / disocclusion reference;
            # empty depth = nothing occludes, everything disoccluded)
            state["prev_depth"] = jnp.zeros((h, w), jnp.float32)
        if self.config.use_velocity:
            state["prev_view_proj"] = jnp.eye(4, dtype=jnp.float32)
        if self.config.use_ssr or self.config.use_ssgi:
            # SSR/SSGI trace against the previous frame's lit HDR (the
            # reflection/GI-buffer temporal flow, render/ssr.py + ssgi.py);
            # black start = no reflections/bounce on frame 0
            state["prev_hdr"] = jnp.zeros((h, w, 3), jnp.float32)
            state.setdefault("prev_view_proj", jnp.eye(4, dtype=jnp.float32))
        return state

    # -- culling (PreDeferredRender: mesh.cpp:331-553 fan-out analog) --------

    def cull_instances(self, scene: Dict[str, Array], inst_matrices: Array,
                       constants: Dict[str, Array]) -> Array:
        """Frustum-cull instances -> per-triangle validity mask."""
        corners = jnp.stack([
            jnp.stack([
                jnp.where(
                    jnp.array([bool(k & 1), bool(k & 2), bool(k & 4)]),
                    scene["inst_aabb_max"], scene["inst_aabb_min"]
                )[..., i] for i in range(3)
            ], axis=-1) for k in range(8)
        ], axis=-2)  # (I, 8, 3)
        wc = m3.einsum("iab,ikb->ika", inst_matrices[:, :3, :3], corners) \
            + inst_matrices[:, None, :3, 3]
        wmin = jnp.min(wc, axis=1)
        wmax = jnp.max(wc, axis=1)
        planes = m3.frustum_planes(constants["view_proj"])
        outside = m3.aabb_outside_frustum(planes, wmin, wmax)
        visible = scene["inst_valid"] & ~outside
        t_total = int(scene["tri_instance"].shape[0])
        if self.scene_host.any_lods:
            # LOD selection by camera distance (model.hpp:27-38): level =
            # number of switch distances exceeded; triangles of other levels
            # mask out (all levels stay resident — static shapes)
            center = inst_matrices[:, :3, 3]
            dist = m3.length(center - constants["camera_pos"])
            level = jnp.sum(dist[:, None] > scene["inst_lod_dist"],
                            axis=-1).astype(jnp.int32)
        # instance->triangle expansion: dense blocked broadcast when
        # the scene is blocked (mesh.expand_instance_to_tris), else gather
        vis_t = mesh.expand_instance_to_tris(
            visible, self.scene_host.tri_instance, t_total, fill=False)
        if vis_t is None:
            ti = jnp.maximum(scene["tri_instance"], 0)
            vis_t = visible[ti] & (scene["tri_instance"] >= 0)
            if self.scene_host.any_lods:
                vis_t = vis_t & (scene["tri_lod"] == level[ti])
        elif self.scene_host.any_lods:
            lvl_t = mesh.expand_instance_to_tris(
                level, self.scene_host.tri_instance, t_total, fill=-1)
            vis_t = vis_t & (scene["tri_lod"] == lvl_t)
        return scene["tri_valid"] & vis_t

    # -- the frame ------------------------------------------------------------

    def frame_size(self):
        """(w, h) of the 3D passes: the display size times render_scale
        (the DLSS/upscaling hook, graphics.hpp:139), whole tiles."""
        cfg = self.config
        if cfg.render_scale != 1.0:
            return tuple(
                max(int(n * cfg.render_scale) // cfg.tile_size, 1)
                * cfg.tile_size for n in (cfg.width, cfg.height))
        return cfg.width, cfg.height

    @staticmethod
    def pass_setup(pos_pl, constants, mask, w, h):
        """Screen setup of one raster pass from the shared world-space
        corner planes (main, OIT/sorted/refraction/trans-depth): unrolled
        clip transform on (3, T) planes (math3d.apply_mat4 notes)."""
        px, py, pz = pos_pl
        m = constants["view_proj"]
        comps = [m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]
                 for i in range(4)]
        return raster.setup_triangles_planes(*comps, mask, w, h)

    def opaque_pass(
        self,
        scene: Dict[str, Array],
        inst_matrices: Array,
        constants: Dict[str, Array],
        frame_state: Dict[str, Array],
        prev_inst_matrices: Optional[Array] = None,
    ) -> Dict[str, Any]:
        """The opaque main pass up to the raster: transform, culling,
        setup, binning and the per-triangle shading records. Returns the
        raster inputs (setup, tile_tris, counts, big_list) with what the
        later passes share."""
        cfg = self.config
        w, h = self.frame_size()
        scope = jax.named_scope
        # PreDeferredRender: per-TRIANGLE world transform + frustum cull.
        # The raster pipeline consumes only triangle-level data, so the
        # vertex pool never materializes; the transform runs on
        # per-component (3, T) planes (mesh.transform_triangle_planes) so
        # T stays the minor dim end-to-end
        with scope("xform_cull"):
            pos_pl, nrm_pl = mesh.transform_triangle_planes(
                scene, inst_matrices,
                tri_instance_np=self.scene_host.tri_instance)
            tri_valid = self.cull_instances(scene, inst_matrices, constants)

        # Hi-Z occlusion culling against the PREVIOUS frame's depth pyramid
        # (HizRenderSystem's consumer role, hiz.cpp:104-173; one-frame-stale
        # reprojection-free variant)
        if cfg.use_occlusion_culling:
            corners = jnp.stack([
                jnp.stack([
                    jnp.where(jnp.array([bool(k & 1), bool(k & 2), bool(k & 4)]),
                              scene["inst_aabb_max"], scene["inst_aabb_min"]
                              )[..., i] for i in range(3)
                ], axis=-1) for k in range(8)
            ], axis=-2)
            wc = m3.einsum("iab,ikb->ika", inst_matrices[:, :3, :3], corners) \
                + inst_matrices[:, None, :3, 3]
            wmin = jnp.min(wc, axis=1)
            wmax = jnp.max(wc, axis=1)
            pyramid = hiz_mod.build_pyramid(frame_state["prev_depth"])
            occluded = hiz_mod.occlusion_cull(
                wmin, wmax, constants["view_proj"], pyramid, w, h)
            ti = scene["tri_instance"]
            tri_valid = tri_valid & ~occluded[jnp.maximum(ti, 0)]

        # G-buffer raster (visibility buffer); non-opaque render types go to
        # their own passes (OIT / sorted translucent / refracted,
        # mesh.hpp:30-40)
        translucent = scene["tri_translucent"]
        nonopaque = translucent | scene["tri_sorted"] | scene["tri_refract"]
        t_cnt = pos_pl[0].shape[1]
        with scope("setup"):
            setup = self.pass_setup(pos_pl, constants, tri_valid & ~nonopaque,
                                    w, h)
        # front-to-back binning priority: when a tile overflows its budget,
        # the FARTHEST triangles drop instead of arbitrary ones (round-1
        # dropped by index order, which cut the tops off densely-tessellated
        # meshes — the opaque front-to-back sort of mesh.hpp:196). The
        # policy is a drop HEURISTIC, so a 16-bucket quantized depth key
        # rides inside the binning sort for free (the exact argsort +
        # inverse-permutation scatter + per-tile remap gather are not)
        with scope("prio_ftb"):
            zt = jnp.max(setup["z"], axis=0)
            zlo = jnp.min(jnp.where(setup["valid"], zt, jnp.inf))
            zhi = jnp.max(jnp.where(setup["valid"], zt, -jnp.inf))
            # normalize over the visible range: raw reverse-Z clusters
            # near 0 at distance (z = near/dist)
            zn = (zt - zlo) / jnp.maximum(zhi - zlo, 1e-12)
            # reverse-Z: near = large z = LOW bucket (sorts first)
            prio_ftb = 15 - jnp.clip((zn * 16.0).astype(jnp.int32), 0, 15)
        # rectangular raster tiles (see raster.tile_layout_ok): tile_h<tile
        # fits small triangles; per-tile capacity and the y-footprint
        # scale to keep coverage/overflow behavior equal
        th = cfg.tile_h or cfg.tile_size
        cap_scale = max(th / cfg.tile_size, 0.25)
        cap_main = max(64, int(cfg.max_tris_per_tile * cap_scale) // 16 * 16)
        cap_half = max(32, cap_main // 2)
        fy = cfg.foot_y or max(2, min(8, (2 * cfg.tile_size) // th))

        with scope("bin_main"):
            # foot=2: a 2x(fy) footprint covers triangles up to 256px each
            # axis; larger ones ride the big list. Quarters the pair
            # emission + packed sort vs foot=4
            tiles_m, counts_m, big_m = raster.bin_triangles(
                setup, w, h, cfg.tile_size, max(32, cap_main - 32),
                max_big=32,
                bucket_priority=prio_ftb, foot=2, tile_h=th, foot_y=fy)

        # velocity inputs: previous-frame corner screen positions ride in
        # the shading record (deferred.cpp:463-489 velocity pass analog)
        prev_screen_tri = None
        if cfg.use_velocity:
            prev_inst = (prev_inst_matrices if prev_inst_matrices is not None
                         else inst_matrices)
            prev_vp = frame_state.get("prev_view_proj", constants["view_proj"])
            prev_tri, _ = mesh.transform_triangles(
                scene, prev_inst,
                tri_instance_np=self.scene_host.tri_instance)
            pclip = m3.apply_mat4_h(prev_vp, prev_tri.reshape(t_cnt * 3, 3))
            pw_safe = jnp.maximum(pclip[..., 3:4], 1e-6)
            pndc = pclip[..., :3] / pw_safe
            prev_screen_tri = jnp.stack(
                [(pndc[..., 0] * 0.5 + 0.5) * w,
                 (0.5 - pndc[..., 1] * 0.5) * h],
                axis=-1).reshape(t_cnt, 3, 2)
        with scope("pack_records"):
            nx, ny, nz = nrm_pl
            tri_nrm = jnp.stack(
                [nx[0], ny[0], nz[0], nx[1], ny[1], nz[1],
                 nx[2], ny[2], nz[2]], axis=-1).reshape(t_cnt, 3, 3)
            records = gbuffer.pack_triangle_records(
                scene, tri_normals=tri_nrm,
                prev_screen_tri=prev_screen_tri,
                inv_w=setup["inv_w"],
                tri_instance_np=self.scene_host.tri_instance)
        return dict(w=w, h=h, tile_h=th, foot_y=fy, cap_half=cap_half,
                    pos_pl=pos_pl, nrm_pl=nrm_pl, tri_valid=tri_valid,
                    translucent=translucent, nonopaque=nonopaque,
                    setup=setup, tile_tris=tiles_m, counts=counts_m,
                    big_list=big_m, records=records)

    def render(
        self,
        scene: Dict[str, Array],
        inst_matrices: Array,          # (I, 4, 4)
        constants: Dict[str, Array],
        frame_state: Dict[str, Array],
        ui_atlas: Optional[Array] = None,
        ui_sprites: Optional[Dict[str, Array]] = None,
        prev_inst_matrices: Optional[Array] = None,
        environment: Optional[Array] = None,
    ) -> Dict[str, Array]:
        """environment: optional (He, 2He, 3) lat-long radiance map — the
        static-skybox path (SkyboxRenderSystem, skybox.hpp:48): background,
        SH diffuse ambient and prefiltered specular come from the map
        instead of the procedural atmosphere."""
        cfg = self.config
        scale = cfg.render_scale
        scope = jax.named_scope
        op = self.opaque_pass(scene, inst_matrices, constants, frame_state,
                              prev_inst_matrices)
        w, h, th, fy = op["w"], op["h"], op["tile_h"], op["foot_y"]
        cap_half = op["cap_half"]
        pos_pl, tri_valid = op["pos_pl"], op["tri_valid"]
        translucent, nonopaque = op["translucent"], op["nonopaque"]
        setup, records = op["setup"], op["records"]
        tiles_m, counts_m, big_m = op["tile_tris"], op["counts"], op["big_list"]
        pass_setup = lambda mask: self.pass_setup(pos_pl, constants, mask,
                                                  w, h)

        # visibility raster (Triton kernel), then the G-buffer from one
        # per-pixel record gather + interpolation fusion in XLA
        with scope("raster"):
            vis = raster.rasterize_visibility(
                setup, tiles_m, counts_m, big_m, w, h, cfg.tile_size,
                tile_h=th)
        with scope("gbuffer"):
            g = gbuffer.shade_gbuffer(
                vis, setup, scene, None, None,
                constants=constants, records=records,
                with_velocity=cfg.use_velocity,
                textures=scene.get("textures")
                if self.scene_host.any_textured else None)

        # disocclusion mask (deferred.cpp:491-526): pixels whose reprojected
        # previous-frame depth disagrees with the current surface (newly
        # revealed geometry, for temporal effects). Needs occlusion culling's
        # prev_depth plane; resolved at quarter density (gather cost).
        disocclusion = None
        if cfg.use_velocity and "prev_depth" in frame_state:
            step_d = 2
            vel_d = g["velocity"][::step_d, ::step_d]
            depth_d = vis["depth"][::step_d, ::step_d]
            hd, wd = depth_d.shape
            py = (jnp.arange(hd, dtype=jnp.float32)[:, None] + 0.5) * step_d \
                - vel_d[..., 1]
            px = (jnp.arange(wd, dtype=jnp.float32)[None, :] + 0.5) * step_d \
                - vel_d[..., 0]
            prev_d = frame_state["prev_depth"]
            ph, pw_ = prev_d.shape
            iy = jnp.clip(py.astype(jnp.int32), 0, ph - 1)
            ix = jnp.clip(px.astype(jnp.int32), 0, pw_ - 1)
            sampled = prev_d[iy, ix]
            # reverse-Z: large relative change = disoccluded
            rel = jnp.abs(sampled - depth_d) / jnp.maximum(depth_d, 1e-6)
            dis = (rel > 0.1) | (px < 0) | (px >= pw_) | (py < 0) | (py >= ph)
            import jax as _jax
            disocclusion = _jax.image.resize(
                dis.astype(jnp.float32), vis["depth"].shape, "nearest")

        # shadows (CSM cascades; casters cull per cascade viewport in
        # csm._setup_cascades — the mesh.cpp:795-847 per-cascade frustum
        # cull analog)
        shadow = None
        if cfg.use_shadows:
            scfg = cfg.shadow
            near = 0.1
            splits = csm_mod.cascade_splits(scfg, near)
            # cascades fit the camera frustum; a split-frame band passes
            # the full frame's (parallel/frame_tiles.band_constants)
            light = csm_mod.fit_cascades(
                constants.get("shadow_inv_view_proj",
                              constants["inv_view_proj"]),
                constants["light_dir"], near, splits, near)
            # translucent casters render into the per-cascade sRGB
            # translucent map (csm.hpp:56-64) when the scene has any
            tri_trans = None
            tri_tint = None
            if self.any_translucent or self.any_sorted or self.any_refract:
                tri_trans = nonopaque
                mat_id_s = scene["inst_material"][
                    jnp.maximum(scene["tri_instance"], 0)]
                mat_s = scene["materials"][mat_id_s]
                tri_tint = jnp.concatenate(
                    [mat_s[:, 0:3], mat_s[:, 9:10]], axis=-1)
            with scope("csm_render"):
                depth_atlas, trans_atlas = csm_mod.render_cascades(
                    None, scene["indices"], scene["tri_valid"],
                    light, scfg, pos_planes=pos_pl,
                    tri_translucent=tri_trans, tri_tint=tri_tint,
                )
            with scope("csm_resolve"):
                view_depth = m3.length(
                    g["position"] - constants["camera_pos"])
                shadow = csm_mod.resolve_shadow(
                    g["position"], g["normal"], view_depth, depth_atlas,
                    trans_atlas, light, scfg, splits,
                    constants["light_dir"],
                )
                shadow = jnp.where(g["visible"][..., None], shadow, 1.0)

        # HBAO into the lighting AO term (hbao.cpp analog)
        ao = None
        if cfg.use_hbao:
            with scope("hbao"):
                ao = hbao.compute_hbao(g["position"], g["normal"],
                                       g["visible"],
                                       constants["camera_pos"],
                                       half_res=True)

        # screen-space reflections (the PbrLighting reflection buffer,
        # pbr-lighting.hpp:92): quarter-res march against the current
        # depth, hit color from the PREVIOUS frame's HDR (render/ssr.py)
        ssr_rgb = ssr_conf = None
        if cfg.use_ssr and "prev_hdr" in frame_state:
            from garden_tpu.render import ssr as ssr_mod
            with scope("ssr"):
                ssr_rgb, ssr_conf = ssr_mod.trace(
                    g, vis["depth"], frame_state["prev_hdr"],
                    frame_state.get("prev_view_proj",
                                    constants["view_proj"]),
                    constants, cfg.ssr)
                ssr_conf = jnp.where(g["visible"], ssr_conf, 0.0)

        # screen-space GI (the PbrLighting GI buffer, pbr-lighting.hpp:92):
        # one-bounce diffuse irradiance gathered half-res from the previous
        # frame's lit HDR, fed into lighting.resolve(gi=...)
        gi = None
        if cfg.use_ssgi and "prev_hdr" in frame_state:
            from garden_tpu.render import ssgi as ssgi_mod
            with scope("ssgi"):
                gi = ssgi_mod.compute_ssgi(
                    g["position"], g["normal"], g["visible"], vis["depth"],
                    frame_state["prev_hdr"],
                    frame_state.get("prev_view_proj",
                                    constants["view_proj"]),
                    intensity=cfg.ssgi_intensity)

        # HdrRender: PBR lighting resolve + sky.
        # With atmosphere on: physical sky raymarch for background pixels,
        # SH irradiance for diffuse ambient, reflected-ray sky for specular
        # ambient (AtmosphereRenderSystem + PbrLighting SH path)
        if environment is not None:
            from garden_tpu.render import ibl
            rays = lighting.view_rays(g, constants)
            chain = ibl.prefilter_latlong(environment)
            sky = ibl.sample_prefiltered(chain[:1], rays,
                                         jnp.zeros(rays.shape[:-1]))
            sh = ibl.latlong_sh(environment)
            refl = m3.reflect(-jnp.broadcast_to(
                m3.normalize(constants["camera_pos"] - g["position"]),
                g["normal"].shape), g["normal"])
            spec_amb = ibl.sample_prefiltered(chain, refl, g["roughness"])
            hdr = lighting.resolve(
                g, constants, shadow=shadow, ao=ao,
                ambient_sh=sh, sky=sky, specular_ambient=spec_amb,
                reflection=ssr_rgb, reflection_conf=ssr_conf, gi=gi,
            )
        elif cfg.use_atmosphere:
            from garden_tpu.render import atmosphere as atm
            from garden_tpu.ops.blur import decimate2x, upsample2x_to
            to_light = -constants["light_dir"]
            sky_scope = jax.named_scope("sky_ambient")
            sky_scope.__enter__()
            rays = lighting.view_rays(g, constants)
            # the sky and cloud raymarches are smooth: march at half res
            # and tent-upsample the composited result (~4x cheaper; the
            # 10-step 3D-noise cloud march is heavier still)
            rays_h = decimate2x(rays)
            sky_h = atm.sky_radiance(rays_h, to_light)
            if cfg.use_clouds:
                from garden_tpu.render import clouds as clouds_mod
                crgb, calpha = clouds_mod.render_clouds(
                    rays_h, to_light, time=constants["time"])
                sky_h = clouds_mod.composite_clouds(sky_h, crgb, calpha)
            sky = upsample2x_to(sky_h, h, w)
            if cfg.use_clouds and shadow is not None:
                from garden_tpu.render import clouds as clouds_mod
                # cloud shadow pass: attenuate sunlight on geometry by
                # the cloud layer's transmittance (clouds.cpp shadows) —
                # the transmittance field is km-scale-smooth, half res
                cshadow = upsample2x_to(
                    clouds_mod.cloud_shadow(
                        decimate2x(g["position"]), to_light,
                        time=constants["time"])[..., None], h, w)[..., 0]
                shadow = shadow * jnp.where(
                    g["visible"], cshadow, 1.0)[..., None]
            sh = atm.sky_sh(to_light)
            refl = m3.reflect(-jnp.broadcast_to(
                m3.normalize(constants["camera_pos"] - g["position"]),
                g["normal"].shape), g["normal"])
            # roughness-prefiltered environment approximation: sharp sky
            # sample for mirrors, SH irradiance (fully-blurred sky) for
            # rough — the ibl-specular mip-chain behavior without per-pixel
            # mip gathers; weighted by the split-sum DFG in lighting.resolve.
            # Both terms evaluate at HALF RES and tent-upsample (like the
            # sky background): the ambient-specular field is smooth in the
            # reflection direction, and the full-res 4-step raymarch was
            # a per-pixel cost with no visible benefit
            refl_h = decimate2x(refl)
            spec_sharp = atm.sky_radiance(refl_h, to_light, steps=4)
            spec_rough = atm.sh_irradiance(refl_h, sh)
            r_h = jnp.clip(decimate2x(g["roughness"]), 0.0, 1.0)[..., None]
            spec_amb = upsample2x_to(
                spec_sharp * (1.0 - r_h) + spec_rough * r_h, h, w)
            sky_scope.__exit__(None, None, None)
            with scope("lighting"):
                hdr = lighting.resolve(
                g, constants, shadow=shadow, ao=ao,
                    ambient_sh=sh, sky=sky, specular_ambient=spec_amb,
                    reflection=ssr_rgb, reflection_conf=ssr_conf, gi=gi,
                )
            # aerial perspective on geometry (the 32^3 camera-volume froxel
            # LUT's role, constants.h:25): distance fog with in-scatter
            if cfg.use_aerial_perspective:
                with scope("aerial"):
                    vd_km = m3.length(
                        g["position"] - constants["camera_pos"]) \
                        * (cfg.aerial_km_per_unit)
                    trans, inscatter = atm.aerial_perspective(
                        vd_km, rays, to_light)
                    fogged = hdr * trans + inscatter
                    hdr = jnp.where(g["visible"][..., None], fogged, hdr)
        else:
            hdr = lighting.resolve(g, constants, shadow=shadow, ao=ao,
                                   reflection=ssr_rgb,
                                   reflection_conf=ssr_conf, gi=gi)

        # OIT pass: translucent triangles accumulate over the opaque HDR
        # (OitRenderSystem composite, oit.hpp:38); skipped entirely when the
        # scene has no translucent content (anyOIT, deferred.hpp:122-123)
        if cfg.use_oit and self.any_translucent:
            tsetup = pass_setup(tri_valid & translucent)
            ttiles, tcounts, tbig = raster.bin_triangles(
                tsetup, w, h, cfg.tile_size, cfg.max_tris_per_tile // 2,
                tile_h=th, foot_y=fy)
            # OIT loops one flat per-tile list (order-independent)
            ttiles, tcounts = raster.merge_big_list(ttiles, tcounts, tbig)
            mat_id = scene["inst_material"][
                jnp.maximum(scene["tri_instance"], 0)]
            mat = scene["materials"][mat_id]
            # simple translucent shading: tinted ambient + emissive
            tri_colors = jnp.concatenate(
                [mat[:, 0:3] * 0.8 + mat[:, 5:8], mat[:, 9:10]], axis=-1)
            accum, reveal = oit_mod.rasterize_oit(
                tsetup, tri_colors, ttiles, tcounts, vis["depth"],
                w, h, cfg.tile_size, tile_h=th)
            hdr = oit_mod.composite(hdr, accum, reveal)

        # refraction pass (deferred.cpp:584-604): refracted surfaces sample
        # a GGX-blurred copy of the opaque HDR with a normal-driven offset
        if self.any_refract:
            from garden_tpu.ops import blur as blur_mod
            rsetup = pass_setup(tri_valid & scene["tri_refract"])
            rtiles, rcounts, rbig = raster.bin_triangles(
                rsetup, w, h, cfg.tile_size, cap_half, tile_h=th, foot_y=fy)
            rvis = raster.rasterize_visibility(rsetup, rtiles, rcounts,
                                               rbig, w, h, cfg.tile_size,
                                               tile_h=th)
            rg = gbuffer.shade_gbuffer(rvis, rsetup, scene, None, None,
                                       records=records,
                                       constants=constants)
            covered = rvis["tri_id"] >= 0
            # blurred HDR by surface roughness (the GGX blur chain)
            chain = blur_mod.ggx_blur_chain(hdr, levels=3)
            lvl = jnp.clip(rg["roughness"] * 2.0, 0.0, 2.0)
            # normal-driven screen offset (refraction displacement)
            strength = 48.0
            ox = rg["normal"][..., 0] * strength
            oy = -rg["normal"][..., 1] * strength
            yy = jnp.clip((jnp.arange(h)[:, None] + oy).astype(jnp.int32),
                          0, h - 1)
            xx = jnp.clip((jnp.arange(w)[None, :] + ox).astype(jnp.int32),
                          0, w - 1)
            flat = (yy * w + xx).reshape(-1)
            samples = []
            for c_img in chain:
                up = c_img if c_img.shape[:2] == (h, w) else \
                    jax.image.resize(c_img, (h, w, 3), "linear")
                samples.append(up.reshape(-1, 3)[flat].reshape(h, w, 3))
            refr = samples[0]
            for k in range(1, len(samples)):
                wk = jnp.clip(1.0 - jnp.abs(lvl - k), 0.0, 1.0)[..., None]
                refr = jnp.where(lvl[..., None] > k - 1,
                                 samples[k] * wk + refr * (1.0 - wk), refr)
            tint = rg["base_color"]
            hdr = jnp.where(covered[..., None], refr * tint, hdr)

        # sorted translucent pass (the Translucent render type): distance-
        # sorted back-to-front alpha blend over the HDR (mesh.hpp:196-204)
        if self.any_sorted:
            ssetup = pass_setup(tri_valid & scene["tri_sorted"])
            # back-to-front: ascending reverse-Z (far first) by centroid
            zc = jnp.mean(ssetup["z"], axis=0)
            zkey = jnp.where(ssetup["valid"], zc, 2.0)
            order = jnp.argsort(zkey)
            t_n = zkey.shape[0]
            prio = jnp.zeros((t_n,), jnp.int32).at[order].set(
                jnp.arange(t_n, dtype=jnp.int32))
            stiles, scounts, sbig = raster.bin_triangles(
                ssetup, w, h, cfg.tile_size, cap_half,
                priority=prio, tile_h=th, foot_y=fy)
            mat_id = scene["inst_material"][
                jnp.maximum(scene["tri_instance"], 0)]
            smat = scene["materials"][mat_id]
            srgba = jnp.concatenate(
                [smat[:, 0:3] * 0.8 + smat[:, 5:8], smat[:, 9:10]], axis=-1)
            hdr = raster.rasterize_sorted_blend(
                ssetup, srgba, stiles, scounts, sbig, vis["depth"], hdr,
                w, h, cfg.tile_size, tile_h=th)

        # translucent depth pass (TransDepth render type): nearest
        # non-opaque surface depth for downstream effects
        trans_depth = None
        if cfg.use_trans_depth and (self.any_translucent or self.any_sorted
                                    or self.any_refract):
            dsetup = pass_setup(tri_valid & nonopaque)
            dtiles, dcounts, dbig = raster.bin_triangles(
                dsetup, w, h, cfg.tile_size, cap_half, tile_h=th, foot_y=fy)
            trans_depth = raster.rasterize_depth(
                dsetup, dtiles, dcounts, dbig, w, h, cfg.tile_size,
                tile_h=th)

        # snapshot the lit scene radiance for next frame's SSR fetch
        # (pre-bloom: bloom glow must not feed back into reflections)
        ssr_prev_hdr = hdr if (cfg.use_ssr or cfg.use_ssgi) else None

        # LdrRender in bf16 (post_bf16): halves the post chain's HBM
        # traffic; the SSR history stays f32 (snapshotted above) and
        # to_uint8 re-quantizes at the end anyway
        if cfg.post_bf16:
            hdr = hdr.astype(jnp.bfloat16)

        # LdrRender: bloom -> auto exposure -> tone map
        if cfg.use_bloom:
            with scope("bloom"):
                hdr = bloom_mod.apply_bloom(hdr, cfg.bloom_mip_count)

        with scope("tonemap"):
            if cfg.use_auto_exposure:
                hist = tonemap.luminance_histogram(
                    hdr, cfg.exposure_histogram_bins)
                target = tonemap.average_luminance_from_histogram(hist)
                avg_lum = tonemap.adapt_exposure(
                    frame_state["avg_luminance"], target,
                    constants["delta_time"]
                )
            else:
                avg_lum = frame_state["avg_luminance"]
            exposure = tonemap.exposure_from_luminance(
                avg_lum, compensation=cfg.exposure_compensation
            )
            ldr = tonemap.tone_map(hdr, exposure, mode=cfg.tone_mapper)

            # upscale to display resolution (DlssRenderSystem's role)
            if scale != 1.0:
                ldr = jax.image.resize(ldr, (cfg.height, cfg.width, 3),
                                       "linear")

        # AA on the LDR buffer (fxaa.hpp:37 / smaa.hpp:37), display res
        if cfg.use_fxaa:
            with scope("aa"):
                if getattr(cfg, "aa_mode", "fxaa") == "smaa":
                    from garden_tpu.render import smaa as smaa_mod
                    ldr = smaa_mod.apply_smaa(ldr)
                else:
                    ldr = fxaa_mod.apply_fxaa(ldr)

        # UI pass after LdrRender (deferred.cpp:723-775): sprites + text
        if ui_atlas is not None and ui_sprites is not None:
            ldr = sprites_mod.composite_sprites(ldr, ui_atlas, ui_sprites)

        new_frame_state = {"avg_luminance": avg_lum}
        if cfg.use_occlusion_culling or cfg.use_velocity:
            new_frame_state["prev_depth"] = vis["depth"]
        if cfg.use_velocity or cfg.use_ssr or cfg.use_ssgi:
            new_frame_state["prev_view_proj"] = constants["view_proj"]
        if cfg.use_ssr or cfg.use_ssgi:
            new_frame_state["prev_hdr"] = ssr_prev_hdr

        return {
            "image": tonemap.to_uint8(ldr),
            "hdr": hdr,
            "depth": vis["depth"],
            "tri_id": vis["tri_id"],
            "gbuffer": g,
            "shadow": shadow,
            "ao": ao,
            "velocity": g.get("velocity"),
            "disocclusion": disocclusion,
            "trans_depth": trans_depth,
            "frame_state": new_frame_state,
        }
