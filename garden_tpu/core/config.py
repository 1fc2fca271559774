"""Engine configuration tree.

Replaces the reference's four config tiers (SURVEY.md section 5.6): CMake
feature defines, per-system Options structs, runtime SettingsSystem JSON, and
shader pipelineState blocks — with one dataclass tree. All fields here are
*static* (trace-time Python): changing one recompiles the step, exactly like
the reference's spec constants / pipeline variants. Dynamic per-frame values
(time, camera pose, exposure) live in the frame state instead.

Persisted as JSON via `to_json`/`from_json` to keep parity with
SettingsSystem (reference: source/system/settings.cpp:20-40).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Capacities/rates mirror Jolt defaults in the reference
    (include/garden/system/physics.hpp:679-685, 796-797)."""

    max_bodies: int = 4096
    max_contacts_per_body: int = 16
    # contact slots kept per body after narrowphase compaction: the solver
    # iterates over this much smaller layout (HBM-traffic bound)
    max_active_contacts: int = 16
    simulation_rate: int = 60           # fixed-step Hz
    collision_steps: int = 1
    solver_iterations: int = 10         # velocity solver iterations
    position_iterations: int = 2
    baumgarte: float = 0.2
    speculative_margin: float = 0.08    # speculative contact distance
    penetration_slop: float = 0.005
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    cell_size: float = 2.0              # broadphase uniform-grid cell edge
    grid_dim: int = 64                  # cells per axis
    max_bodies_per_cell: int = 8
    # grid-bypassing big bodies (planes/heightfields) tested against every
    # body; each slot costs a narrowphase pair per body, so keep it at the
    # actual global-body count of the scene
    max_globals: int = 4
    cascade_lag_threshold: float = 0.5  # seconds of sustained lag before clamping
    sleep_enabled: bool = False


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Cascaded shadow maps (reference: render/csm.hpp:43-90)."""

    cascade_count: int = 3
    map_size: int = 2048                # reference default (csm.hpp:43)
    # per-cascade map resolutions. None = uniform `map_size` for every
    # cascade (the reference's layout, csm.hpp:43). Far cascades cover a
    # larger world span but are viewed at proportionally larger distance,
    # so e.g. (2048, 1024, 1024) keeps screen-space texel density roughly
    # constant across splits at ~half the raster cost.
    cascade_sizes: Optional[Tuple[int, ...]] = None
    distance: float = 100.0
    split_ratios: Tuple[float, float] = (0.1, 0.25)
    bias_constant: float = 0.0012
    bias_normal: float = 0.05
    pcf_radius: int = 1
    # cascade-atlas raster tile height (None = square 128): short-wide
    # tiles fit small far-cascade casters; a power of two (see
    # raster.tile_layout_ok)
    atlas_tile_h: Optional[int] = None
    # atlas binning y-footprint in tiles (None = auto: keep ~256px span).
    # Scenes whose casters concentrate in FAR cascades (small light-space
    # triangles) can use 2 — triangles taller than foot_y*atlas_tile_h px
    # ride the shared big list (raster.bin_triangles)
    atlas_foot_y: Optional[int] = None
    # shadow-factor resolve decimation: the per-pixel shadow-map lookup is a
    # random gather; resolving every Nth pixel and
    # bilinearly upsampling the factor costs ~1px of edge softness that the
    # PCF smoothing blurs anyway. 1 = full-resolution resolve (the
    # reference-parity default); must be a power of two (each halving is one
    # 2x decimation level).
    resolve_step: int = 1

    def __post_init__(self):
        s = self.resolve_step
        if s < 1 or (s & (s - 1)) != 0:
            raise ValueError(
                f"resolve_step must be a power of two >= 1, got {s}")
        if self.cascade_sizes is not None:
            if len(self.cascade_sizes) != self.cascade_count:
                raise ValueError(
                    f"cascade_sizes has {len(self.cascade_sizes)} entries "
                    f"for {self.cascade_count} cascades")
            if self.cascade_sizes[0] != max(self.cascade_sizes):
                raise ValueError(
                    "cascade_sizes[0] (the near cascade) must be the "
                    "largest — it sets the atlas height")


@dataclasses.dataclass(frozen=True)
class SSRConfig:
    """Screen-space reflections (the PbrLighting reflection-buffer path,
    pbr-lighting.hpp:92 / render/ssr.py)."""

    # march resolution divisor (power of two): rays trace on a
    # (H/step, W/step) grid and upsample depth-guided
    trace_step: int = 4
    steps: int = 16                     # march samples per ray
    max_distance: float = 40.0          # world-space ray length
    first_step: float = 0.02            # first sample at this fraction
    # hit acceptance band as a fraction of the stored reverse-Z depth
    thickness: float = 0.08
    # roughness above this falls back fully to prefiltered IBL
    max_roughness: float = 0.6

    def __post_init__(self):
        s = self.trace_step
        if s < 1 or (s & (s - 1)) != 0:
            raise ValueError(
                f"trace_step must be a power of two >= 1, got {s}")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Deferred pipeline options (reference: deferred.hpp:63-70 Options,
    graphics.hpp quality levels, tone-mapping.hpp:36-44)."""

    width: int = 1920
    height: int = 1080
    tile_size: int = 128                # raster tile WIDTH; a power of two
    # raster tile HEIGHT (None = square). Short-wide tiles suit small
    # triangles (a ~20px triangle covers <3% of a 128x128 tile but 4x that
    # of a 32x128 one); a power of two (raster.tile_layout_ok)
    tile_h: Optional[int] = None
    # main-pass binning y-footprint in tiles (None = auto: keep ~256px
    # span). Scenes of small on-screen triangles can use 2 — pair
    # emission and the binning sort shrink proportionally; triangles
    # taller than foot_y*tile_h px ride the shared big list
    foot_y: Optional[int] = None
    max_triangles: int = 65536
    max_tris_per_tile: int = 512
    max_instances: int = 1024
    max_vertices: int = 65536
    use_shadows: bool = True
    use_hbao: bool = True
    use_bloom: bool = True
    use_auto_exposure: bool = True
    use_fxaa: bool = True
    # AA selector (the reference ships FXAA and SMAA; fxaa.hpp:37,
    # smaa.hpp:37): "fxaa" | "smaa" | "none"; use_fxaa=False also disables
    aa_mode: str = "fxaa"
    use_atmosphere: bool = True
    use_clouds: bool = False
    # aerial perspective (distance fog + in-scatter) on geometry — the
    # reference's 32^3 camera-volume froxel LUT role (constants.h:25)
    use_aerial_perspective: bool = True
    aerial_km_per_unit: float = 0.001   # world units -> km for fog density
    use_oit: bool = True
    # translucent-depth plane for effects that need the nearest non-opaque
    # surface (the TransDepth pass, deferred.cpp TransDepthRender)
    use_trans_depth: bool = False
    # Hi-Z occlusion culling against the previous frame's depth pyramid
    use_occlusion_culling: bool = False
    # internal render scale (the DLSS/upscaling hook, graphics.hpp:139
    # useUpscaling/scaledFrameSize): <1 renders smaller and upsamples
    render_scale: float = 1.0
    use_velocity: bool = False
    bloom_mip_count: int = 5
    exposure_histogram_bins: int = 256  # reference: auto-exposure.hpp:65
    tone_mapper: str = "aces"           # "aces" | "uchimura"
    # LdrRender (bloom/exposure/tonemap/AA) in bfloat16: the post chain is
    # HBM-bandwidth-bound and the reference's HDR render targets are
    # 16-bit floats too (B10G11R11/RGBA16F); ~0.4% relative quantization,
    # under one LDR level
    post_bf16: bool = True
    exposure_compensation: float = 0.0
    shadow: ShadowConfig = dataclasses.field(default_factory=ShadowConfig)
    # screen-space reflections (reflection buffer of PbrLighting,
    # pbr-lighting.hpp:92); traces against the previous frame's HDR
    use_ssr: bool = False
    ssr: SSRConfig = dataclasses.field(default_factory=SSRConfig)
    # screen-space GI (the PbrLighting GI buffer, pbr-lighting.hpp:92 /
    # pbr-lighting.cpp:473-494): one-bounce diffuse irradiance from the
    # previous frame's lit HDR (render/ssgi.py)
    use_ssgi: bool = False
    ssgi_intensity: float = 1.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    capacity: int = 4096                # entity capacity
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    max_tick_rate: int = 60             # loop.hpp:57
    world_batch: int = 1                # leading batch axis for multi-world


# quality presets (GraphicsQuality PotatoPC..Ultra, graphics.hpp:53-56)
QUALITY_PRESETS = {
    "potato": dict(use_shadows=False, use_hbao=False, use_bloom=False,
                   use_atmosphere=False, use_fxaa=False, use_oit=False,
                   render_scale=0.5),
    "low": dict(use_hbao=False, use_bloom=False, render_scale=0.75,
                shadow=ShadowConfig(map_size=512, cascade_count=2,
                                    resolve_step=2)),
    "medium": dict(shadow=ShadowConfig(map_size=1024, resolve_step=2)),
    "high": dict(shadow=ShadowConfig(map_size=2048)),  # reference parity
    "ultra": dict(use_clouds=True, use_ssr=True, use_ssgi=True,
                  shadow=ShadowConfig(map_size=2048, pcf_radius=2)),
}


def render_quality(quality: str = "medium", **overrides) -> "RenderConfig":
    """RenderConfig from a quality preset name."""
    kw = dict(QUALITY_PRESETS[quality])
    kw.update(overrides)
    return RenderConfig(**kw)


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _from_dict(cls: type, data: Dict[str, Any]) -> Any:
    # resolve string annotations (PEP 563) to real types
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            v = _from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def to_json(cfg: EngineConfig) -> str:
    return json.dumps(_to_dict(cfg), indent=2)


def from_json(text: str, cls: type = EngineConfig) -> EngineConfig:
    return _from_dict(cls, json.loads(text))
