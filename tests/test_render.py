import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from garden_tpu.core import math3d as m3
from garden_tpu.core.config import RenderConfig
from garden_tpu.render import mesh as rmesh
from garden_tpu.render import tonemap
from garden_tpu.render.deferred import DeferredRenderer
from garden_tpu.systems.camera import common_constants


def small_config():
    return RenderConfig(width=160, height=96, tile_size=32,
                        max_triangles=2048, max_vertices=2048,
                        max_tris_per_tile=128, max_instances=8,
                        use_fxaa=False, use_bloom=False)


def build_scene():
    scene = rmesh.SceneBuffers(2048, 2048, 8)
    red = scene.add_material(rmesh.Material(base_color=(0.9, 0.1, 0.1)))
    grey = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5),
                                             roughness=0.9))
    glow = scene.add_material(rmesh.Material(base_color=(0.1, 0.1, 0.1),
                                             emissive=(4.0, 3.0, 0.5)))
    scene.add_instance(rmesh.cube(0.5), material=red)
    scene.add_instance(rmesh.plane_grid(20.0, 8), material=grey)
    scene.add_instance(rmesh.uv_sphere(0.4, 8, 12), material=glow)
    return scene


def make_constants(cfg):
    eye = jnp.array([0.0, 1.5, 4.0])
    view = m3.look_at(eye, jnp.array([0.0, 0.5, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(1.0, cfg.width / cfg.height, 0.1)
    return common_constants(eye, view, proj, jnp.array([0.3, -0.8, -0.4]),
                            (cfg.width, cfg.height), 0.0, 1.0 / 60.0)


def test_deferred_frame_end_to_end():
    cfg = small_config()
    scene = build_scene()
    renderer = DeferredRenderer(cfg, scene)
    dev = renderer.device_scene()
    constants = make_constants(cfg)

    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][1, 3] = 0.5          # cube sits on the ground
    mats[2][:3, 3] = [1.5, 0.4, 0.0]  # emissive sphere to the right

    out = renderer.render(dev, jnp.asarray(mats), constants,
                          renderer.initial_frame_state())
    img = np.asarray(out["image"])
    assert img.shape == (cfg.height, cfg.width, 3) and img.dtype == np.uint8

    h, w = cfg.height, cfg.width
    center = img[h // 2, w // 2].astype(int)
    sky = img[2, w // 2].astype(int)
    # cube is red-ish: r channel dominates
    assert center[0] > center[2] + 10, center
    # sky is blue-ish and bright
    assert sky[2] > sky[0], sky
    # some pixels covered by geometry
    covered = np.asarray(out["tri_id"]) >= 0
    assert 0.2 < covered.mean() <= 1.0
    # depth: ground closer at the bottom of the frame than cube center? just sanity
    assert np.isfinite(np.asarray(out["hdr"])).all()
    # exposure state updated
    assert float(out["frame_state"]["avg_luminance"]) > 0


def test_tonemap_curves():
    x = jnp.linspace(0.0, 8.0, 64)
    for curve in (tonemap.aces, tonemap.uchimura):
        y = np.asarray(curve(x))
        assert (np.diff(y) >= -1e-4).all()     # monotone
        assert y.min() >= 0.0 and y.max() <= 1.0
    assert float(tonemap.aces(jnp.float32(0.0))) == 0.0


def test_histogram_and_adaptation():
    hdr = jnp.ones((32, 32, 3)) * 0.5
    hist = tonemap.luminance_histogram(hdr, 64)
    # histogram meters an 8x-downsampled luminance plane
    assert float(jnp.sum(hist)) == (32 // 8) * (32 // 8)
    avg = tonemap.average_luminance_from_histogram(hist)
    assert 0.3 < float(avg) < 0.8
    # adaptation moves toward the target
    a = tonemap.adapt_exposure(jnp.float32(0.1), jnp.float32(0.5), jnp.float32(0.1))
    assert 0.1 < float(a) < 0.5


def test_velocity_and_disocclusion():
    """Velocity plane: moving instance produces screen-space motion vectors
    (deferred.cpp:463-489); static pixels have ~zero velocity; disocclusion
    marks newly revealed regions (deferred.cpp:491-526)."""
    cfg = dataclasses.replace(small_config(), use_velocity=True,
                              use_shadows=False, use_hbao=False,
                              use_atmosphere=False, use_oit=False,
                              use_auto_exposure=False)
    scene = build_scene()
    renderer = DeferredRenderer(cfg, scene)
    dev = renderer.device_scene()
    constants = make_constants(cfg)

    mats0 = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats0[0][1, 3] = 0.5
    mats1 = mats0.copy()
    mats1[0][0, 3] = 0.4   # cube moved +x between frames

    fs = renderer.initial_frame_state()
    out0 = renderer.render(dev, jnp.asarray(mats0), constants, fs)
    out1 = renderer.render(dev, jnp.asarray(mats1), constants,
                           out0["frame_state"],
                           prev_inst_matrices=jnp.asarray(mats0))
    vel = np.asarray(out1["velocity"])
    assert vel.shape == (cfg.height, cfg.width, 2)
    g = out1["gbuffer"]
    inst = np.asarray(g["instance"])
    cube_px = inst == 0
    ground_px = inst == 1
    assert cube_px.sum() > 20
    # cube moved +x in world -> positive screen-x velocity on its pixels
    assert vel[..., 0][cube_px].mean() > 1.0, vel[..., 0][cube_px].mean()
    # static ground pixels: ~zero velocity
    assert abs(vel[..., 0][ground_px]).mean() < 0.1
    # disocclusion present and marks some pixels near the cube's old spot
    dis = np.asarray(out1["disocclusion"])
    assert dis.shape == (cfg.height, cfg.width)
    assert dis.max() == 1.0


def test_textured_cube_base_color():
    """Base-color texture sampling: a checkerboard-textured cube shows both
    checker colors in the rendered G-buffer (ResourceSystem image loads ->
    base-color target, resource.cpp / deferred.hpp:20)."""
    cfg = dataclasses.replace(small_config(), use_shadows=False,
                              use_hbao=False, use_atmosphere=False,
                              use_oit=False, use_auto_exposure=False)
    scene = rmesh.SceneBuffers(2048, 2048, 8, max_textures=2, texture_size=64)
    # checkerboard: red/green 8x8 blocks
    check = np.zeros((64, 64, 4), np.float32)
    check[..., 3] = 1.0
    cells = (np.add.outer(np.arange(64) // 8, np.arange(64) // 8) % 2).astype(bool)
    check[cells, 0] = 1.0
    check[~cells, 1] = 1.0
    tex = scene.add_texture(check)
    mat = scene.add_material(rmesh.Material(base_color=(1.0, 1.0, 1.0),
                                            base_texture=tex))
    scene.add_instance(rmesh.cube(0.5), material=mat)
    renderer = DeferredRenderer(cfg, scene)
    dev = renderer.device_scene()
    constants = make_constants(cfg)
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][1, 3] = 0.5
    out = renderer.render(dev, jnp.asarray(mats), constants,
                          renderer.initial_frame_state())
    g = out["gbuffer"]
    bc = np.asarray(g["base_color"])
    vis = np.asarray(g["visible"])
    assert vis.sum() > 50
    reds = (bc[..., 0] > 0.5) & (bc[..., 1] < 0.3) & vis
    greens = (bc[..., 1] > 0.5) & (bc[..., 0] < 0.3) & vis
    assert reds.sum() > 10 and greens.sum() > 10, (reds.sum(), greens.sum())


def test_ibl_dfg_and_prefilter():
    """DFG analytic fit is monotone/positive; prefiltered chain blurs: the
    roughest mip approaches the mean radiance (ibl-specular.comp analog)."""
    from garden_tpu.render import ibl
    nov = jnp.linspace(0.01, 1.0, 8)
    for r in (0.05, 0.5, 0.95):
        s, b = ibl.dfg_approx(nov, jnp.full((8,), r))
        total = np.asarray(s + b)
        assert (total >= 0).all() and (total <= 1.2).all(), (r, total)
    # energy ordering: rougher surfaces get less fresnel-boosted env
    s_smooth, b_smooth = ibl.dfg_approx(jnp.array([0.5]), jnp.array([0.1]))
    s_rough, b_rough = ibl.dfg_approx(jnp.array([0.5]), jnp.array([0.9]))
    assert float((s_smooth + b_smooth)[0]) > float((s_rough + b_rough)[0])

    # prefilter: a single bright texel spreads out over mips
    env = np.zeros((16, 32, 3), np.float32)
    env[8, 16] = 100.0
    mips = ibl.prefilter_latlong(jnp.asarray(env), mip_count=4)
    peak0 = float(jnp.max(mips[0]))
    peak3 = float(jnp.max(mips[-1]))
    assert peak3 < peak0 * 0.2, (peak0, peak3)
    # sampling: mirror roughness hits the bright spot, rough misses-but-sees
    dirs = jnp.array([[0.0, 0.0, 0.0]]) + jnp.array(
        [[np.sin(np.pi * 8.5 / 16) * np.cos(2 * np.pi * 16.5 / 32),
          np.cos(np.pi * 8.5 / 16),
          np.sin(np.pi * 8.5 / 16) * np.sin(2 * np.pi * 16.5 / 32)]])
    sharp = ibl.sample_prefiltered(mips, dirs, jnp.array([0.0]))
    rough = ibl.sample_prefiltered(mips, dirs, jnp.array([1.0]))
    assert float(sharp.max()) > float(rough.max()) > 0.0


def test_sorted_translucent_pass():
    """Back-to-front sorted translucency (Translucent render type,
    mesh.hpp:30-40, 196-204): two stacked translucent quads in front of a
    bright opaque wall blend in depth order."""
    cfg = dataclasses.replace(small_config(), use_shadows=False,
                              use_hbao=False, use_atmosphere=False,
                              use_oit=False, use_auto_exposure=False)
    scene = rmesh.SceneBuffers(2048, 2048, 8)
    wall = scene.add_material(rmesh.Material(base_color=(0.1, 0.1, 0.1),
                                             emissive=(1.0, 1.0, 1.0)))
    red = scene.add_material(rmesh.Material(base_color=(1.0, 0.0, 0.0),
                                            alpha=0.5, blend_mode="sorted"))
    blue = scene.add_material(rmesh.Material(base_color=(0.0, 0.0, 1.0),
                                             alpha=0.5, blend_mode="sorted"))
    scene.add_instance(rmesh.cube(1.0), material=wall)
    scene.add_instance(rmesh.cube(0.4), material=red)
    scene.add_instance(rmesh.cube(0.4), material=blue)
    renderer = DeferredRenderer(cfg, scene)
    assert renderer.any_sorted
    dev = renderer.device_scene()
    constants = make_constants(cfg)
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][:3, 3] = [0.0, 0.5, -2.0]   # wall behind
    mats[1][:3, 3] = [0.0, 0.6, 0.0]    # red mid
    mats[2][:3, 3] = [0.0, 0.6, 1.2]    # blue nearest the camera
    out = renderer.render(dev, jnp.asarray(mats), constants,
                          renderer.initial_frame_state())
    hdr = np.asarray(out["hdr"])
    h, w = cfg.height, cfg.width
    c = hdr[h // 2 - 8, w // 2]
    # both translucent layers contribute: red and blue tint over the wall
    assert c[2] > 0.1, c    # blue layer visible (drawn last, nearest)
    assert c[0] > 0.05, c   # red shows through the blue's 0.5 alpha
    assert np.isfinite(hdr).all()


def test_refraction_and_trans_depth():
    """Refraction pass (deferred.cpp:584-604) covers its pixels with a
    blurred-HDR sample; TransDepth pass reports the non-opaque surface
    depth nearer than the opaque background."""
    cfg = dataclasses.replace(small_config(), use_shadows=False,
                              use_hbao=False, use_atmosphere=False,
                              use_oit=False, use_auto_exposure=False,
                              use_trans_depth=True)
    scene = rmesh.SceneBuffers(2048, 2048, 8)
    grey = scene.add_material(rmesh.Material(base_color=(0.5, 0.5, 0.5)))
    glass = scene.add_material(rmesh.Material(base_color=(0.9, 1.0, 0.9),
                                              roughness=0.1,
                                              blend_mode="refract"))
    scene.add_instance(rmesh.plane_grid(20.0, 8), material=grey)
    scene.add_instance(rmesh.cube(0.5), material=glass)
    renderer = DeferredRenderer(cfg, scene)
    assert renderer.any_refract
    dev = renderer.device_scene()
    constants = make_constants(cfg)
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[1][1, 3] = 0.5
    out = renderer.render(dev, jnp.asarray(mats), constants,
                          renderer.initial_frame_state())
    g = out["gbuffer"]
    # the glass cube is NOT in the opaque G-buffer
    inst = np.asarray(g["instance"])
    assert (inst == 1).sum() == 0
    assert np.isfinite(np.asarray(out["hdr"])).all()
    # trans-depth: nearer (reverse-Z larger) than the opaque depth where
    # the cube sits
    td = np.asarray(out["trans_depth"])
    od = np.asarray(out["depth"])
    covered = td > 0
    assert covered.sum() > 50
    assert (td[covered] >= od[covered] - 1e-6).mean() > 0.9


def test_lod_chain_selection():
    """LOD chain: the near level renders when close, the far level when
    distant (ModelRenderSystem LOD buffers, model.hpp:27-38)."""
    cfg = dataclasses.replace(small_config(), use_shadows=False,
                              use_hbao=False, use_atmosphere=False,
                              use_oit=False, use_auto_exposure=False)
    scene = rmesh.SceneBuffers(4096, 4096, 8)
    mat = scene.add_material(rmesh.Material(base_color=(0.8, 0.2, 0.2)))
    hi = rmesh.uv_sphere(0.6, 16, 32)    # 1024 tris
    lo = rmesh.uv_sphere(0.6, 4, 8)      # 64 tris
    scene.add_instance_lods([hi, lo], distances=[10.0], material=mat)
    renderer = DeferredRenderer(cfg, scene)
    dev = renderer.device_scene()
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][1, 3] = 0.5

    def count_tris(eye_z):
        eye = jnp.array([0.0, 1.0, eye_z])
        view = m3.look_at(eye, jnp.array([0.0, 0.5, 0.0]),
                          jnp.array([0.0, 1.0, 0.0]))
        proj = m3.perspective_reverse_z(1.0, cfg.width / cfg.height, 0.1)
        constants = common_constants(eye, view, proj,
                                     jnp.array([0.3, -0.8, -0.4]),
                                     (cfg.width, cfg.height), 0.0, 1 / 60)
        tv = renderer.cull_instances(dev, jnp.asarray(mats), constants)
        lods = np.asarray(dev["tri_lod"])[np.asarray(tv)]
        return set(lods.tolist())

    assert count_tris(4.0) == {0}      # near: high-detail level only
    assert count_tris(30.0) == {1}     # far: low-detail level only


def test_static_environment_skybox():
    """Static lat-long environment (SkyboxRenderSystem, skybox.hpp:48):
    background samples the map; ambient derives from its SH."""
    cfg = dataclasses.replace(small_config(), use_shadows=False,
                              use_hbao=False, use_oit=False,
                              use_auto_exposure=False)
    scene = build_scene()
    renderer = DeferredRenderer(cfg, scene)
    dev = renderer.device_scene()
    constants = make_constants(cfg)
    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[0][1, 3] = 0.5
    # magenta upper hemisphere, dark lower
    env = np.zeros((16, 32, 3), np.float32)
    env[:8] = (2.0, 0.2, 2.0)
    env[8:] = (0.05, 0.05, 0.05)
    out = renderer.render(dev, jnp.asarray(mats), constants,
                          renderer.initial_frame_state(),
                          environment=jnp.asarray(env))
    hdr = np.asarray(out["hdr"])
    vis = np.asarray(out["gbuffer"]["visible"])
    # sky pixels (top rows) carry the magenta environment
    sky_px = hdr[2, cfg.width // 2]
    assert sky_px[0] > 1.0 and sky_px[2] > 1.0 and sky_px[1] < 0.8, sky_px
    # lit geometry picks up magenta-tinted ambient
    assert np.isfinite(hdr).all()


def test_multi_scatter_lut():
    """32x32 multi-scatter LUT (constants.h:23): finite, non-negative,
    brighter for overhead sun than below-horizon sun."""
    from garden_tpu.render import atmosphere as atm
    lut = np.asarray(atm.multi_scatter_lut(size=16, dirs=16))
    assert lut.shape == (16, 16, 3)
    assert np.isfinite(lut).all() and (lut >= 0).all()
    ground = lut[0]  # altitude 0 row; cols = sun cos from -1 to 1
    assert ground[-1].mean() > ground[0].mean()  # overhead sun > below horizon


def test_aerial_perspective():
    """Distance fog: far surfaces lose contrast toward the sky in-scatter
    (camera-volume froxel role, constants.h:25)."""
    from garden_tpu.render import atmosphere as atm
    v = jnp.array([[0.0, 0.0, -1.0]])
    sun = jnp.array([0.3, 0.8, 0.2])
    t_near, s_near = atm.aerial_perspective(jnp.array([0.1]), v, sun)
    t_far, s_far = atm.aerial_perspective(jnp.array([50.0]), v, sun)
    assert float(t_far.mean()) < float(t_near.mean())   # more extinction
    assert float(s_far.mean()) > float(s_near.mean())   # more in-scatter
    assert np.isfinite(np.asarray(t_far)).all()
    assert (np.asarray(t_near) <= 1.0 + 1e-5).all()


def test_aerial_perspective_matches_froxel_integration():
    """Parity evidence for replacing the reference's 32^3 camera-volume
    froxel LUT (shaders/atmosphere/constants.h:25) with 4-step analytic
    aerial perspective: against a 64-step numerical integration of the
    same single-scattering model (what the froxel volume tabulates), the
    4-step version stays within a few percent over the 0-60 km depth
    range the volume covers."""
    import jax.numpy as jnp
    import numpy as np

    from garden_tpu.core import math3d as m3
    from garden_tpu.render import atmosphere as atm

    sun = m3.normalize(jnp.array([0.3, 0.8, 0.2]))
    # grid of view directions x depths
    dirs = m3.normalize(jnp.array([
        [1.0, 0.0, 0.0], [0.7, 0.2, 0.0], [0.7, -0.05, 0.1],
        [0.0, 0.3, 1.0], [-0.5, 0.1, 0.5],
    ]))
    depths = jnp.array([0.5, 2.0, 10.0, 30.0, 60.0])

    def reference_integration(depth_km, view_dir, steps=64):
        """Fine Riemann quadrature of the same model — the froxel-volume
        ground truth (each froxel slice stores exactly this integral)."""
        v = m3.normalize(view_dir)
        mu_v = v[..., 1]
        cos_sun = m3.dot(v, sun)
        ph_r = atm._phase_rayleigh(cos_sun)[..., None]
        ph_m = atm._phase_mie(cos_sun)[..., None]
        beta_r = jnp.asarray(atm.BETA_RAYLEIGH, jnp.float32)
        dt = depth_km / steps
        lum = jnp.zeros(v.shape[:-1] + (3,), jnp.float32)
        tau = jnp.zeros(v.shape[:-1] + (3,), jnp.float32)
        for i in range(steps):
            t = (i + 0.5) * dt
            y = jnp.maximum(0.2 + t * mu_v, 0.0)
            dens_r = jnp.exp(-y / atm.H_RAYLEIGH)[..., None]
            dens_m = jnp.exp(-y / atm.H_MIE)[..., None]
            step_tau = (beta_r * dens_r + (atm.BETA_MIE_SCAT + atm.BETA_MIE_ABS)
                        * dens_m) * dt[..., None]
            t_view = jnp.exp(-(tau + 0.5 * step_tau))
            t_sun = atm.sun_transmittance(y, jnp.broadcast_to(sun[1], y.shape))
            scat = (beta_r * dens_r * ph_r
                    + atm.BETA_MIE_SCAT * dens_m * ph_m)
            lum = lum + atm.SUN_INTENSITY * scat * t_sun * t_view * dt[..., None]
            tau = tau + step_tau
        return jnp.exp(-tau), lum

    for d in depths:
        dd = jnp.full((dirs.shape[0],), d)
        t4, s4 = atm.aerial_perspective(dd, dirs, sun)
        t64, s64 = reference_integration(dd, dirs)
        np.testing.assert_allclose(np.asarray(t4), np.asarray(t64),
                                   rtol=0.05, atol=5e-3)
        # in-scatter: relative to the sky's magnitude at that depth
        ref_mag = float(jnp.max(jnp.abs(s64))) + 1e-6
        assert float(jnp.max(jnp.abs(s4 - s64))) / ref_mag < 0.08


def test_translucent_casters_tint_shadows():
    """CSM translucent map (csm.hpp:56-64): a translucent red panel must
    cast a red-tinted shadow on the ground (round-2 gap: depth-only maps
    meant translucent casters shadowed nothing)."""
    import jax.numpy as jnp
    import numpy as np

    from garden_tpu.core import math3d as m3
    from garden_tpu.core.config import RenderConfig, ShadowConfig
    from garden_tpu.render import mesh as rmesh
    from garden_tpu.render.deferred import DeferredRenderer
    from garden_tpu.systems.camera import common_constants

    rcfg = RenderConfig(width=128, height=128, tile_size=128,
                        max_vertices=512, max_triangles=512, max_instances=8,
                        use_clouds=False, use_oit=True,
                        shadow=ShadowConfig(map_size=128, cascade_count=2,
                                            distance=40.0))
    sc = rmesh.SceneBuffers(512, 512, 8)
    gm = sc.add_material(rmesh.Material(base_color=(0.6, 0.6, 0.6)))
    rm = sc.add_material(rmesh.Material(base_color=(1.0, 0.1, 0.1),
                                        alpha=0.6))
    sc.add_instance(rmesh.plane_grid(20.0, 2), material=gm)
    sc.add_instance(rmesh.cube(1.5), material=rm)
    ren = DeferredRenderer(rcfg, sc)
    scene = ren.device_scene()
    eye = jnp.array([0.0, 6.0, 10.0])
    view = m3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    proj = m3.perspective_reverse_z(1.0, 1.0, 0.1)
    constants = common_constants(eye, view, proj,
                                 jnp.array([0.0, -1.0, 0.01]),
                                 (128, 128), 0.0, 1 / 60)
    inst = jnp.broadcast_to(jnp.eye(4), (8, 4, 4))
    inst = inst.at[1].set(m3.compose_trs(
        jnp.array([[0.0, 3.0, 0.0]]), jnp.array([[0.0, 0, 0, 1.0]]),
        jnp.ones((1, 3)))[0])
    out = ren.render(scene, inst, constants, ren.initial_frame_state())
    sh = np.asarray(out["shadow"])
    assert sh.shape[-1] == 3
    tinted = (sh[..., 0] > sh[..., 1] + 0.05).sum()
    assert tinted > 50, f"no red-tinted shadow pixels ({tinted})"
    assert np.isfinite(np.asarray(out["image"]).astype(np.float32)).all()


def test_smaa_smooths_staircase():
    """SMAA 1x (smaa.hpp:37 parity): a hard staircase edge gains
    intermediate coverage values; flat regions stay untouched."""
    import jax.numpy as jnp
    import numpy as np

    from garden_tpu.render import smaa

    img = np.zeros((32, 32, 3), np.float32)
    for y in range(32):
        img[y, : min(2 + y // 2, 32)] = 1.0
    out = np.asarray(smaa.apply_smaa(jnp.asarray(img)))
    mids = ((out > 0.05) & (out < 0.95)).sum()
    assert mids > 20, mids
    flat = jnp.ones((16, 16, 3)) * 0.5
    np.testing.assert_allclose(np.asarray(smaa.apply_smaa(flat)), 0.5,
                               atol=1e-6)


@pytest.mark.slow
def test_render_scale_preset_similarity():
    """The documented 60fps fallback: rendering at
    render_scale=0.5 and upsampling must stay close to the full-res frame
    (quantified: mean |diff| < 8/255 over the image, structure preserved)."""
    import jax.numpy as jnp
    import numpy as np

    from garden_tpu.core import math3d as m3
    from garden_tpu.core.config import RenderConfig, ShadowConfig
    from garden_tpu.render import mesh as rmesh
    from garden_tpu.render.deferred import DeferredRenderer
    from garden_tpu.systems.camera import common_constants

    def build(scale):
        rcfg = RenderConfig(width=256, height=256, tile_size=128,
                            max_vertices=512, max_triangles=512,
                            max_instances=4, render_scale=scale,
                            use_clouds=False, use_fxaa=False,
                            shadow=ShadowConfig(map_size=128,
                                                cascade_count=2,
                                                distance=40.0))
        sc = rmesh.SceneBuffers(512, 512, 4)
        gm = sc.add_material(rmesh.Material(base_color=(0.6, 0.6, 0.6)))
        bm = sc.add_material(rmesh.Material(base_color=(0.8, 0.2, 0.2)))
        sc.add_instance(rmesh.plane_grid(20.0, 2), material=gm)
        sc.add_instance(rmesh.cube(1.0), material=bm)
        ren = DeferredRenderer(rcfg, sc)
        scene = ren.device_scene()
        eye = jnp.array([0.0, 4.0, 8.0])
        view = m3.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        proj = m3.perspective_reverse_z(1.0, 1.0, 0.1)
        constants = common_constants(eye, view, proj,
                                     jnp.array([0.3, -0.8, 0.2]),
                                     (256, 256), 0.0, 1 / 60)
        inst = jnp.broadcast_to(jnp.eye(4), (4, 4, 4))
        inst = inst.at[1].set(m3.compose_trs(
            jnp.array([[0.0, 1.0, 0.0]]), jnp.array([[0.0, 0, 0, 1.0]]),
            jnp.ones((1, 3)))[0])
        out = ren.render(scene, inst, constants, ren.initial_frame_state())
        return np.asarray(out["image"]).astype(np.float32)

    full = build(1.0)
    half = build(0.5)
    assert half.shape == full.shape
    mad = np.abs(full - half).mean()
    assert mad < 8.0, f"render_scale=0.5 diverges: mean|diff|={mad:.2f}"
    # the red cube survives the downscale (structure, not just brightness)
    red_full = (full[..., 0] > full[..., 1] + 20).sum()
    red_half = (half[..., 0] > half[..., 1] + 20).sum()
    assert red_half > 0.5 * red_full


def test_quality_presets_reference_parity():
    """The default + high/ultra shadow configs match the reference's CSM
    defaults (csm.hpp:43,56-64: 3 cascades x 2048^2, full-res resolve)."""
    from garden_tpu.core.config import RenderConfig, render_quality

    default = RenderConfig().shadow
    assert (default.map_size, default.cascade_count,
            default.resolve_step) == (2048, 3, 1)
    for q in ("high", "ultra"):
        s = render_quality(q).shadow
        assert s.map_size == 2048 and s.resolve_step == 1, (q, s)
    # perf presets decimate EXPLICITLY (opt-in, not silent defaults)
    assert render_quality("medium").shadow.resolve_step == 2


def test_ssr_glossy_floor_reflects_emissive():
    """SSR (the PbrLighting reflection-buffer path, pbr-lighting.hpp:92):
    a mirror-like floor under a bright emissive block must pick up its
    reflection on frame 2 (SSR traces against the previous frame's HDR),
    brightening the floor region below the block vs the same scene with
    SSR disabled."""
    import dataclasses as _dc

    from garden_tpu.core.config import SSRConfig

    scene = rmesh.SceneBuffers(2048, 2048, 8)
    mirror = scene.add_material(rmesh.Material(
        base_color=(0.9, 0.9, 0.9), metallic=1.0, roughness=0.05))
    glow = scene.add_material(rmesh.Material(
        base_color=(0.05, 0.05, 0.05), emissive=(30.0, 24.0, 6.0)))
    scene.add_instance(rmesh.plane_grid(20.0, 8), material=mirror)
    scene.add_instance(rmesh.cube(0.6), material=glow)

    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    mats[1][:3, 3] = [0.0, 0.9, 0.0]     # block floats above the floor
    mats = jnp.asarray(mats)

    def run(use_ssr):
        cfg = _dc.replace(
            small_config(), use_ssr=use_ssr,
            ssr=SSRConfig(trace_step=2, steps=24, max_distance=12.0,
                          thickness=0.25))
        ren = DeferredRenderer(cfg, scene)
        dev = ren.device_scene()
        constants = make_constants(cfg)
        state = ren.initial_frame_state()
        for _ in range(2):                # frame 1 fills prev_hdr
            out = ren.render(dev, mats, constants, state)
            state = out["frame_state"]
        return np.asarray(out["hdr"]), out

    hdr_on, out_on = run(True)
    hdr_off, _ = run(False)
    assert np.isfinite(hdr_on).all()
    # floor strip just below the block's screen footprint: reflections of
    # the emissive block land here (camera looks slightly down, mirror
    # floor -> reflection appears below the object)
    h, w = hdr_on.shape[:2]
    strip_on = hdr_on[int(h * 0.62):int(h * 0.95),
                      int(w * 0.30):int(w * 0.70)]
    strip_off = hdr_off[int(h * 0.62):int(h * 0.95),
                        int(w * 0.30):int(w * 0.70)]
    gain = float(strip_on.mean() - strip_off.mean())
    assert gain > 0.05, (
        f"SSR added no radiance to the mirror floor (gain={gain:.4f})")


def test_fxaa311_beats_lowpass_on_shallow_staircase():
    """FXAA 3.11 (shaders/fxaa.frag): the edge-end search must resolve a
    SHALLOW staircase (8-px step runs — invisible to any 3x3 stencil)
    toward the supersampled ground truth at least 2x better than a 3x3
    lowpass, while leaving flat regions untouched."""
    from garden_tpu.render import fxaa as fxaa_mod

    h, w, ss_f = 64, 64, 8
    # half-plane below the line y = x/8 + 16, rendered hard and at 8x
    yy, xx = np.mgrid[0:h * ss_f, 0:w * ss_f].astype(np.float32) / ss_f
    cov_hi = (yy > xx / 8.0 + 16.0).astype(np.float32)
    truth = cov_hi.reshape(h, ss_f, w, ss_f).mean(axis=(1, 3))
    aliased = (np.mgrid[0:h, 0:w][0] + 0.5
               > (np.mgrid[0:h, 0:w][1] + 0.5) / 8.0 + 16.0
               ).astype(np.float32)
    img = np.repeat(aliased[..., None], 3, axis=-1)

    out = np.asarray(fxaa_mod.apply_fxaa(jnp.asarray(img)))[..., 0]

    k = np.array([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]]) / 16.0
    lp = np.zeros_like(aliased)
    pad = np.pad(aliased, 1, mode="edge")
    for dy in range(3):
        for dx in range(3):
            lp += k[dy, dx] * pad[dy:dy + h, dx:dx + w]

    band = np.abs(np.mgrid[0:h, 0:w][0] - (np.mgrid[0:h, 0:w][1] / 8.0
                                           + 16.0)) < 3.0
    err_fxaa = np.abs(out - truth)[band].mean()
    err_lp = np.abs(lp - truth)[band].mean()
    err_in = np.abs(aliased - truth)[band].mean()
    assert err_fxaa < 0.5 * err_lp, (err_fxaa, err_lp)
    assert err_fxaa < 0.6 * err_in, (err_fxaa, err_in)
    # flat interior (>4 px from the edge) must be bit-exact
    flat = ~(np.abs(np.mgrid[0:h, 0:w][0]
                    - (np.mgrid[0:h, 0:w][1] / 8.0 + 16.0)) < 4.0)
    assert np.abs(out - aliased)[flat].max() < 1e-5


def test_hbao_horizon_line_sampling():
    """HBAO (hbao.hpp:39): per-direction horizon MAX, not a tap sum.
    (a) a wall darkens the ground at its base and not the open field;
    (b) horizon property: sampling the same ridge at 5 radii occludes no
    more than the single highest sample (a sum formulation fails this)."""
    from garden_tpu.render import hbao as H

    h, w = 64, 64
    # ground plane y=0 on a 0.1 m/px grid; wall at x-index >= 48, 1 m tall
    xs = (np.arange(w) * 0.1)[None, :].repeat(h, 0)
    zs = (np.arange(h) * 0.1)[:, None].repeat(w, 1)
    pos = np.stack([xs, np.zeros((h, w)), zs], -1).astype(np.float32)
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[..., 1] = 1.0
    pos[:, 48:, 1] = 1.0     # plateau = wall top (height discontinuity)
    vis = np.ones((h, w), bool)

    ao = np.asarray(H.compute_hbao(jnp.asarray(pos), jnp.asarray(nrm),
                                   jnp.asarray(vis), jnp.zeros(3),
                                   radius=2.5))
    base = ao[32, 44:48].mean()        # ground at the wall's base
    open_field = ao[32, 8:24].mean()   # far from the wall
    assert base < open_field - 0.1, (base, open_field)
    assert open_field > 0.95, open_field

    # (b) horizon property: a near ridge sets the horizon; additional
    # LOWER-ANGLE geometry behind it must not add occlusion (a per-tap sum
    # formulation stacks it, a horizon max does not)
    pos2 = np.stack([xs, np.zeros((h, w)), zs], -1).astype(np.float32)
    pos2[37:41, :, 1] = 0.35      # ridge band ~0.5-0.8 u south of probe
    ao_one = np.asarray(H.compute_hbao(
        jnp.asarray(pos2), jnp.asarray(nrm), jnp.asarray(vis),
        jnp.zeros(3), radius=2.5))[32, 32]
    pos3 = pos2.copy()
    pos3[42:49, :, 1] = 0.35      # farther ridges: same height, LOWER angle
    ao_many = np.asarray(H.compute_hbao(
        jnp.asarray(pos3), jnp.asarray(nrm), jnp.asarray(vis),
        jnp.zeros(3), radius=2.5))[32, 32]
    assert ao_one < 0.98, ao_one          # the near ridge does occlude
    assert abs(ao_many - ao_one) < 0.02, (ao_many, ao_one)


def test_ssgi_emissive_wall_bounce():
    """SSGI (the PbrLighting GI-buffer producer, pbr-lighting.hpp:92 /
    pbr-lighting.cpp:473-494): a bright emissive wall standing on a diffuse
    floor must BOUNCE light onto the floor beside it on frame 2 (GI gathers
    from the previous frame's lit HDR), brightening that region vs the same
    scene with GI disabled — and the bounce must carry the wall's hue."""
    import dataclasses as _dc

    scene = rmesh.SceneBuffers(2048, 2048, 8)
    diffuse = scene.add_material(rmesh.Material(
        base_color=(0.8, 0.8, 0.8), roughness=0.9))
    glow = scene.add_material(rmesh.Material(
        base_color=(0.05, 0.05, 0.05), emissive=(40.0, 8.0, 4.0)))
    scene.add_instance(rmesh.plane_grid(20.0, 8), material=diffuse)
    scene.add_instance(rmesh.cube(0.5), material=glow)

    mats = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    # tall thin emissive wall standing on the floor, left of center
    mats[1][:3, :3] = np.diag([0.2, 3.0, 3.0])
    mats[1][:3, 3] = [-1.2, 1.5, 0.0]
    mats = jnp.asarray(mats)

    def run(use_ssgi):
        cfg = _dc.replace(small_config(), use_ssgi=use_ssgi,
                          ssgi_intensity=1.0)
        ren = DeferredRenderer(cfg, scene)
        dev = ren.device_scene()
        constants = make_constants(cfg)
        state = ren.initial_frame_state()
        for _ in range(2):                # frame 1 fills prev_hdr
            out = ren.render(dev, mats, constants, state)
            state = out["frame_state"]
        return np.asarray(out["hdr"], np.float32)

    hdr_on = run(True)
    hdr_off = run(False)
    assert np.isfinite(hdr_on).all()
    # floor strip adjacent to the wall's base: one-bounce light lands here
    h, w = hdr_on.shape[:2]
    strip_on = hdr_on[int(h * 0.55):int(h * 0.95), int(w * 0.15):int(w * 0.55)]
    strip_off = hdr_off[int(h * 0.55):int(h * 0.95), int(w * 0.15):int(w * 0.55)]
    gain = strip_on.mean(axis=(0, 1)) - strip_off.mean(axis=(0, 1))
    assert gain[0] > 0.02, f"SSGI added no bounce radiance (gain={gain})"
    # hue check: the wall is red-dominant, so must be the bounce
    assert gain[0] > 2.0 * max(float(gain[2]), 1e-6), gain


def test_smaa_diagonal_beats_fxaa_on_45deg_staircase():
    """SMAA diagonal patterns (smaa.hpp:37 diag search / diag AreaTex):
    on a perfect 45-degree staircase the revectorized line x = y + 1/2
    covers the inside boundary pixel by 7/8 and the outside one by 1/8 —
    SMAA's diagonal handling must land measurably closer to that
    analytically antialiased line than FXAA."""
    from garden_tpu.render import fxaa, smaa

    n = 48
    img = np.zeros((n, n, 3), np.float32)
    ideal = np.zeros((n, n, 3), np.float32)
    for y in range(n):
        img[y, : y + 1] = 1.0            # 45-deg staircase: x <= y filled
        ideal[y, : y + 1] = 1.0
        ideal[y, y] = 0.875              # exact coverage of x <= y + 1/2
        if y + 1 < n:
            ideal[y, y + 1] = 0.125
    smaa_out = np.asarray(smaa.apply_smaa(jnp.asarray(img)))
    fxaa_out = np.asarray(fxaa.apply_fxaa(jnp.asarray(img)))
    band = np.zeros((n, n), bool)        # score only near the edge
    for y in range(2, n - 2):
        band[y, max(y - 2, 0):min(y + 3, n)] = True
    smaa_err = float(np.abs(smaa_out - ideal)[band].mean())
    fxaa_err = float(np.abs(fxaa_out - ideal)[band].mean())
    assert smaa_err < 0.8 * fxaa_err, (smaa_err, fxaa_err)
    # and SMAA must actually act: inside silhouette pixels land at 7/8
    diag_vals = smaa_out[np.arange(4, n - 4), np.arange(4, n - 4), 0]
    assert np.all(np.abs(diag_vals - 0.875) < 0.05), diag_vals[:8]
