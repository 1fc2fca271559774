"""Triangle mesh assets and the per-frame scene buffer.

Rebuild of the reference's model/mesh layer: vertex+index buffers produced by
modelc (include/garden/graphics/modelc.hpp:27), ModelRenderSystem LOD buffers
(include/garden/system/render/model.hpp:27-46) and the per-frame instance
buffers MeshRenderSystem bakes (mesh.cpp:331-553). Meshes are host-built
numpy arrays; a `SceneBuffers` packs every registered mesh into one
fixed-capacity vertex/index pool (the analog of bindless vertex pulling)
and instances reference (mesh id, material id, transform).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from garden_tpu.core import math3d as m3

Array = jnp.ndarray

MAX_LODS = 4


@dataclasses.dataclass
class Mesh:
    """Host-side triangle mesh: positions (V,3), normals (V,3), uvs (V,2),
    triangle indices (T,3)."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def triangle_count(self) -> int:
        return self.indices.shape[0]


def cube(half: float = 0.5) -> Mesh:
    """Unit cube with per-face normals (24 verts, 12 tris)."""
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),   # +z
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),  # -z
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),   # +x
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),   # -x
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),   # +y
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),   # -y
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, u, v in faces:
        n, u, v = np.array(n, np.float32), np.array(u, np.float32), np.array(v, np.float32)
        base = len(pos)
        for su, sv, tu, tv in ((-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1), (-1, 1, 0, 1)):
            pos.append((n + u * su + v * sv) * half)
            nrm.append(n)
            uv.append((tu, tv))
        idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return Mesh(np.array(pos, np.float32), np.array(nrm, np.float32),
                np.array(uv, np.float32), np.array(idx, np.int32))


def uv_sphere(radius: float = 0.5, rings: int = 12, segments: int = 24) -> Mesh:
    pos, nrm, uv, idx = [], [], [], []
    for r in range(rings + 1):
        phi = math.pi * r / rings
        for s in range(segments + 1):
            theta = 2.0 * math.pi * s / segments
            n = (math.sin(phi) * math.cos(theta),
                 math.cos(phi),
                 math.sin(phi) * math.sin(theta))
            pos.append(np.array(n) * radius)
            nrm.append(n)
            uv.append((s / segments, r / rings))
    cols = segments + 1
    for r in range(rings):
        for s in range(segments):
            a = r * cols + s
            b = a + cols
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
    return Mesh(np.array(pos, np.float32), np.array(nrm, np.float32),
                np.array(uv, np.float32), np.array(idx, np.int32))


def plane_grid(size: float = 10.0, divisions: int = 8, y: float = 0.0) -> Mesh:
    """Subdivided ground plane (finely divided so screen-tile binning keeps
    per-triangle footprints bounded)."""
    pos, nrm, uv, idx = [], [], [], []
    n = divisions + 1
    for iz in range(n):
        for ix in range(n):
            x = (ix / divisions - 0.5) * size
            z = (iz / divisions - 0.5) * size
            pos.append((x, y, z))
            nrm.append((0.0, 1.0, 0.0))
            uv.append((ix / divisions, iz / divisions))
    for iz in range(divisions):
        for ix in range(divisions):
            a = iz * n + ix
            b = a + n
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
    return Mesh(np.array(pos, np.float32), np.array(nrm, np.float32),
                np.array(uv, np.float32), np.array(idx, np.int32))


def heightfield(heights: np.ndarray, cell: float = 1.0) -> Mesh:
    """Terrain mesh from an (H, W) height grid (worldgen config 2)."""
    h, w = heights.shape
    xs = (np.arange(w) - (w - 1) / 2.0) * cell
    zs = (np.arange(h) - (h - 1) / 2.0) * cell
    px, pz = np.meshgrid(xs, zs)
    pos = np.stack([px, heights, pz], axis=-1).reshape(-1, 3).astype(np.float32)
    # normals via central differences
    gx = np.gradient(heights, cell, axis=1)
    gz = np.gradient(heights, cell, axis=0)
    nrm = np.stack([-gx, np.ones_like(heights), -gz], axis=-1)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).reshape(-1, 3).astype(np.float32)
    uv = np.stack(np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h)),
                  axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    for iz in range(h - 1):
        for ix in range(w - 1):
            a = iz * w + ix
            b = a + w
            idx += [(a, b, a + 1), (a + 1, b, b + 1)]
    return Mesh(pos, nrm, uv, np.array(idx, np.int32))


@dataclasses.dataclass(frozen=True)
class Material:
    """PBR material (the reference's G-buffer material model,
    deferred.hpp:20-26: base color, metallic/roughness/AO, emissive).
    base_texture indexes the scene's texture array (-1 = flat color), the
    base-color sampling path of the sprite/model pipelines
    (resource.cpp image loads -> deferred.hpp:20 base-color target)."""

    base_color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    metallic: float = 0.0
    roughness: float = 0.5
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    reflectance: float = 0.5
    alpha: float = 1.0  # < 1 routes the instance through a transparency pass
    base_texture: int = -1
    # transparency routing (the render types of mesh.hpp:30-40:
    # Opaque / OIT / Translucent(sorted) / Refracted):
    # "opaque" with alpha < 1 defaults to the OIT pass; "sorted" uses the
    # back-to-front alpha-blended pass; "refract" samples the blurred HDR
    blend_mode: str = "opaque"


class SceneBuffers:
    """Packs meshes + materials into fixed-capacity device pools and bakes
    per-frame instance data (the MeshRenderSystem combined-buffer analog)."""

    def __init__(self, max_vertices: int, max_triangles: int,
                 max_instances: int, max_materials: int = 64,
                 texture_size: int = 256, max_textures: int = 0):
        self.max_vertices = max_vertices
        self.max_triangles = max_triangles
        self.max_instances = max_instances
        self.positions = np.zeros((max_vertices, 3), np.float32)
        self.normals = np.zeros((max_vertices, 3), np.float32)
        self.uvs = np.zeros((max_vertices, 2), np.float32)
        self.indices = np.zeros((max_triangles, 3), np.int32)
        self.tri_valid = np.zeros((max_triangles,), bool)
        # material rows: [base3, metallic, roughness, emissive3, reflectance,
        # alpha, base_texture, blend_mode]
        self.materials = np.zeros((max_materials, 12), np.float32)
        self.materials[:, 10] = -1.0
        # texture array (bindless-texture analog): fixed-size RGBA slots
        self.texture_size = texture_size
        self.textures = np.zeros((max_textures, texture_size, texture_size, 4),
                                 np.float32)
        self._tex = 0
        self._mesh_ranges: List[Tuple[int, int, int, int]] = []  # v0, nv, t0, nt
        self._v = 0
        self._t = 0
        self._m = 0
        # instances
        self.inst_mesh = np.full((max_instances,), -1, np.int32)
        self.inst_material = np.zeros((max_instances,), np.int32)
        self.inst_entity = np.full((max_instances,), -1, np.int32)
        self._i = 0
        # per-triangle instance id (static topology: triangles belong to
        # instances, re-baked when instances change)
        self.tri_instance = np.full((max_triangles,), -1, np.int32)
        self.vert_instance = np.full((max_vertices,), -1, np.int32)
        # per-instance local AABBs for frustum/occlusion culling
        self.inst_aabb_min = np.zeros((max_instances, 3), np.float32)
        self.inst_aabb_max = np.zeros((max_instances, 3), np.float32)
        # LOD chain (ModelRenderSystem LOD buffers, model.hpp:27-38): every
        # level's triangles live in the pool tagged with a level id; the
        # frame selects one level per instance by camera distance — static
        # shapes, no topology swaps (the static-shape take on LOD buffer
        # switching)
        self.tri_lod = np.zeros((max_triangles,), np.int8)
        self.inst_lod_dist = np.full((max_instances, MAX_LODS - 1), np.inf,
                                     np.float32)

    def add_mesh(self, mesh: Mesh) -> int:
        v0, t0 = self._v, self._t
        nv, nt = mesh.vertex_count, mesh.triangle_count
        if v0 + nv > self.max_vertices or t0 + nt > self.max_triangles:
            raise RuntimeError("scene buffer capacity exhausted")
        self._mesh_ranges.append((v0, nv, t0, nt))
        return len(self._mesh_ranges) - 1

    def _mesh_store(self, mesh_id: int) -> Tuple[int, int, int, int]:
        return self._mesh_ranges[mesh_id]

    def add_material(self, mat: Material) -> int:
        m = self._m
        self.materials[m, 0:3] = mat.base_color
        self.materials[m, 3] = mat.metallic
        self.materials[m, 4] = mat.roughness
        self.materials[m, 5:8] = mat.emissive
        self.materials[m, 8] = mat.reflectance
        self.materials[m, 9] = mat.alpha
        self.materials[m, 10] = mat.base_texture
        self.materials[m, 11] = {"opaque": 0, "oit": 1, "sorted": 2,
                                 "refract": 3}[mat.blend_mode]
        self._m += 1
        return m

    def add_texture(self, image: np.ndarray) -> int:
        """Register an RGBA image into the texture array (resized to the
        fixed slot size). Returns the texture index for Material.base_texture."""
        if self._tex >= self.textures.shape[0]:
            raise RuntimeError("texture capacity exhausted")
        s = self.texture_size
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3 + [np.ones_like(img)], axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.ones(img.shape[:2] + (1,), np.float32)], axis=-1)
        if img.shape[:2] != (s, s):
            from garden_tpu.assets.images import resize_image
            img = resize_image(img, (s, s))
        t = self._tex
        self._tex += 1
        self.textures[t] = img
        return t

    @property
    def any_textured(self) -> bool:
        return bool((self.materials[: self._m, 10] >= 0).any())

    def add_instance(self, mesh: Mesh, mesh_id_hint: Optional[int] = None,
                     material: int = 0, entity: int = -1) -> int:
        """Instantiate a mesh: copies its geometry into the pool bound to
        this instance slot (simple but static-shape-friendly; shared-topology
        instancing arrives with the culling/compaction pass)."""
        if self._i >= self.max_instances:
            raise RuntimeError("instance capacity exhausted")
        inst = self._i
        self._i += 1
        v0, t0 = self._v, self._t
        nv, nt = mesh.vertex_count, mesh.triangle_count
        if v0 + nv > self.max_vertices or t0 + nt > self.max_triangles:
            raise RuntimeError("scene buffer capacity exhausted")
        self.positions[v0:v0 + nv] = mesh.positions
        self.normals[v0:v0 + nv] = mesh.normals
        self.uvs[v0:v0 + nv] = mesh.uvs
        self.indices[t0:t0 + nt] = mesh.indices + v0
        self.tri_valid[t0:t0 + nt] = True
        self.tri_instance[t0:t0 + nt] = inst
        self.vert_instance[v0:v0 + nv] = inst
        self._v = v0 + nv
        self._t = t0 + nt
        self.inst_material[inst] = material
        self.inst_entity[inst] = entity
        self.inst_aabb_min[inst] = mesh.positions.min(axis=0)
        self.inst_aabb_max[inst] = mesh.positions.max(axis=0)
        return inst

    def _tri_mode_mask(self, want_modes, need_alpha: bool):
        import numpy as _np
        mat = self.materials[self.inst_material]
        sel = _np.isin(mat[:, 11].astype(_np.int32), want_modes)
        if need_alpha:
            sel &= mat[:, 9] < 1.0
        ti = _np.maximum(self.tri_instance, 0)
        return sel[ti] & (self.tri_instance >= 0)

    def add_instance_lods(self, meshes: List[Mesh], distances: List[float],
                          material: int = 0, entity: int = -1) -> int:
        """Instance with a LOD chain: meshes[k] renders when the camera is
        closer than distances[k] (ascending; the last level covers the rest).
        All levels' geometry is resident; selection is a per-frame mask
        (model.hpp:27-38 LOD buffers)."""
        if not 1 <= len(meshes) <= MAX_LODS:
            raise ValueError(f"1..{MAX_LODS} LOD levels supported")
        if len(distances) != len(meshes) - 1:
            raise ValueError("need len(meshes)-1 switch distances")
        inst = self.add_instance(meshes[0], material=material, entity=entity)
        for k, mesh in enumerate(meshes[1:], start=1):
            v0, t0 = self._v, self._t
            nv, nt = mesh.vertex_count, mesh.triangle_count
            if v0 + nv > self.max_vertices or t0 + nt > self.max_triangles:
                raise RuntimeError("scene buffer capacity exhausted")
            self.positions[v0:v0 + nv] = mesh.positions
            self.normals[v0:v0 + nv] = mesh.normals
            self.uvs[v0:v0 + nv] = mesh.uvs
            self.indices[t0:t0 + nt] = mesh.indices + v0
            self.tri_valid[t0:t0 + nt] = True
            self.tri_instance[t0:t0 + nt] = inst
            self.vert_instance[v0:v0 + nv] = inst
            self.tri_lod[t0:t0 + nt] = k
            self._v = v0 + nv
            self._t = t0 + nt
            self.inst_aabb_min[inst] = np.minimum(self.inst_aabb_min[inst],
                                                  mesh.positions.min(axis=0))
            self.inst_aabb_max[inst] = np.maximum(self.inst_aabb_max[inst],
                                                  mesh.positions.max(axis=0))
        self.inst_lod_dist[inst, :len(distances)] = distances
        return inst

    def tri_translucent_mask(self):
        """Triangles routed through OIT: mode 'oit', or 'opaque' materials
        with alpha < 1 (back-compat default)."""
        import numpy as _np
        mat = self.materials[self.inst_material]
        mode = mat[:, 11].astype(_np.int32)
        sel = (mode == 1) | ((mode == 0) & (mat[:, 9] < 1.0))
        ti = _np.maximum(self.tri_instance, 0)
        return sel[ti] & (self.tri_instance >= 0)

    def tri_sorted_mask(self):
        """Triangles in the sorted back-to-front translucent pass."""
        return self._tri_mode_mask([2], need_alpha=False)

    def tri_refract_mask(self):
        """Triangles in the refraction pass (deferred.cpp:584-604)."""
        return self._tri_mode_mask([3], need_alpha=False)

    def device_arrays(self) -> Dict[str, Array]:
        return {
            "positions": jnp.asarray(self.positions),
            "normals": jnp.asarray(self.normals),
            "uvs": jnp.asarray(self.uvs),
            "indices": jnp.asarray(self.indices),
            "tri_valid": jnp.asarray(self.tri_valid),
            "tri_translucent": jnp.asarray(self.tri_translucent_mask()),
            "tri_sorted": jnp.asarray(self.tri_sorted_mask()),
            "tri_refract": jnp.asarray(self.tri_refract_mask()),
            "tri_instance": jnp.asarray(self.tri_instance),
            "vert_instance": jnp.asarray(self.vert_instance),
            "inst_material": jnp.asarray(self.inst_material),
            "inst_entity": jnp.asarray(self.inst_entity),
            "inst_aabb_min": jnp.asarray(self.inst_aabb_min),
            "inst_aabb_max": jnp.asarray(self.inst_aabb_max),
            "inst_valid": jnp.asarray(np.arange(self.max_instances) < self._i),
            "materials": jnp.asarray(self.materials),
            "textures": jnp.asarray(self.textures),
            "tri_lod": jnp.asarray(self.tri_lod.astype(np.int32)),
            # static per-triangle uvs (precomputed: saves a (T,3) row gather
            # per frame in the shading-record pack)
            "tri_uvs": jnp.asarray(self.uvs[self.indices]),
            # static per-triangle LOCAL geometry: transform_triangles reads
            # these densely and gathers only the (T,) instance matrices —
            # replacing the per-frame vertex-pool transform plus TWO (T,3)
            # corner row gathers (world_pos[indices], world_nrm[indices]
            # = ~740K gather rows/frame at the flagship scene)
            "tri_pos_local": jnp.asarray(self.positions[self.indices]),
            "tri_nrm_local": jnp.asarray(self.normals[self.indices]),
            # transposed (comp, corner, T) copies for the corner-plane
            # pipeline (transform_triangle_planes): T rides the minor
            # dim, so every per-corner fma is dense
            "tri_pos_local_t": jnp.asarray(
                np.transpose(self.positions[self.indices], (2, 1, 0))),
            "tri_nrm_local_t": jnp.asarray(
                np.transpose(self.normals[self.indices], (2, 1, 0))),
            "inst_lod_dist": jnp.asarray(self.inst_lod_dist),
        }

    @property
    def any_lods(self) -> bool:
        return bool((self.tri_lod != 0).any())


def _blocked_segments(tri_instance_np: "np.ndarray"):
    """Trace-time RLE of tri_instance into (tri0, inst0, n_inst,
    tris_per_inst) segments: runs of consecutive instances with equal
    triangle counts, covering a contiguous valid prefix. Returns None when
    the pattern isn't blocked (fall back to the gather). Typical scenes
    (one mesh replicated per body + a few singletons) compress to a
    handful of segments, letting the per-triangle matrix fetch lower to
    broadcast+reshape instead of a (T,) row gather."""
    ti = np.asarray(tri_instance_np)
    valid = ti >= 0
    n_valid = len(ti) if valid.all() else int(np.argmin(valid))
    if n_valid == 0:
        return None
    prefix = ti[:n_valid]
    if (ti[n_valid:] >= 0).any():
        return None                       # valid tris not a prefix
    # instance ids must be non-decreasing and consecutive
    uniq, starts, counts = np.unique(prefix, return_index=True,
                                     return_counts=True)
    if (np.diff(prefix) < 0).any():
        return None
    if uniq[0] != 0 or (np.diff(uniq) != 1).any():
        return None
    segs = []
    s = 0
    while s < len(uniq):
        e = s + 1
        while e < len(uniq) and counts[e] == counts[s]:
            e += 1
        segs.append((int(starts[s]), int(uniq[s]), int(e - s),
                     int(counts[s])))
        s = e
    return segs if len(segs) <= 16 else None


def expand_instance_to_tris(values: Array, tri_instance_np: "np.ndarray",
                            t_total: int, fill=0) -> Optional[Array]:
    """Expand per-instance values (I, ...) to per-triangle (T, ...) via the
    blocked-segment broadcast (see _blocked_segments) — the dense
    replacement for a `values[tri_instance]` gather. Returns None when
    the scene isn't
    blocked (caller falls back to the gather)."""
    segs = _blocked_segments(tri_instance_np)
    if segs is None:
        return None
    parts = []
    for (tri0, inst0, n_inst, nt) in segs:
        seg = values[inst0:inst0 + n_inst]
        parts.append(jnp.broadcast_to(
            seg[:, None], (n_inst, nt) + seg.shape[1:]
        ).reshape((n_inst * nt,) + seg.shape[1:]))
    covered = sum(ni * nt for (_, _, ni, nt) in segs)
    if covered < t_total:
        parts.append(jnp.full((t_total - covered,) + values.shape[1:],
                              fill, values.dtype))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def transform_triangle_planes(scene: Dict[str, Array],
                              inst_matrices: Array,
                              tri_instance_np: "np.ndarray" = None,
                              ) -> Tuple[Tuple[Array, Array, Array],
                                         Tuple[Array, Array, Array]]:
    """Per-triangle world corners/normals as PER-COMPONENT (3, T) planes.

    The corner-plane twin of transform_triangles: every output keeps T in
    the minor dim (corner-major rows), so the whole transform is dense fma
    work over contiguous triangle rows, instead of a (T, 3, 3) formulation
    with a 3-wide minor dim. Returns ((px, py, pz), (nx, ny, nz)), each (3, T): plane k
    holds corner k's component for every triangle. Instance matrices
    arrive via blocked broadcast segments when the scene is blocked
    (_blocked_segments), else one transposed row gather."""
    ti = jnp.maximum(scene["tri_instance"], 0)
    t_total = int(ti.shape[0])
    # (12, I): rows 0-2 = matrix col 0 (x basis), 3-5 = col 1, 6-8 = col 2,
    # 9-11 = translation — component King of cN at row 3N + King
    packed_t = jnp.concatenate(
        [jnp.transpose(inst_matrices[:, :3, 0]),
         jnp.transpose(inst_matrices[:, :3, 1]),
         jnp.transpose(inst_matrices[:, :3, 2]),
         jnp.transpose(inst_matrices[:, :3, 3])], axis=0)
    segs = (_blocked_segments(tri_instance_np)
            if tri_instance_np is not None else None)
    if segs is not None:
        parts = []
        for (tri0, inst0, n_inst, nt) in segs:
            seg = packed_t[:, inst0:inst0 + n_inst]       # (12, ni)
            parts.append(jnp.broadcast_to(
                seg[:, :, None], (12, n_inst, nt)).reshape(12, n_inst * nt))
        covered = sum(ni * nt for (_, _, ni, nt) in segs)
        if covered < t_total:
            parts.append(jnp.zeros((12, t_total - covered), packed_t.dtype))
        rows_t = (jnp.concatenate(parts, axis=1)
                  if len(parts) > 1 else parts[0])        # (12, T)
    else:
        rows_t = packed_t[:, ti]                          # column gather
    lp = scene["tri_pos_local_t"]                         # (3comp, 3crn, T)
    ln = scene["tri_nrm_local_t"]
    r = lambda j: rows_t[j][None, :]                      # (1, T)
    pos = tuple(
        r(0 + k) * lp[0] + r(3 + k) * lp[1] + r(6 + k) * lp[2] + r(9 + k)
        for k in range(3))                                # 3 x (3, T)
    nr = tuple(
        r(0 + k) * ln[0] + r(3 + k) * ln[1] + r(6 + k) * ln[2]
        for k in range(3))
    inv_len = jax.lax.rsqrt(jnp.maximum(
        nr[0] * nr[0] + nr[1] * nr[1] + nr[2] * nr[2], 1e-12))
    nrm = tuple(c * inv_len for c in nr)
    return pos, nrm


def transform_triangles(scene: Dict[str, Array],
                        inst_matrices: Array,
                        tri_instance_np: "np.ndarray" = None,
                        ) -> Tuple[Array, Array]:
    """Per-TRIANGLE world-space corners and normals, bypassing the vertex
    pool: ONE (T,) row gather of packed instance matrices + dense math on
    the static `tri_pos_local`/`tri_nrm_local` arrays. Returns
    (tri_world (T, 3, 3), tri_nrm (T, 3, 3)). Use for pipelines that only
    consume triangle-level data (the fused-raster deferred path): it
    replaces transform_vertices' vertex transform plus the two
    `x[indices]` corner gathers (gathers price per row; corners are 3
    rows/triangle).

    tri_instance_np: optional HOST copy of scene["tri_instance"] — when
    the scene's triangles are contiguous uniform blocks per instance
    (_blocked_segments), even that one gather collapses to trace-time
    broadcast+reshape segments (pure layout, fuses into the fma chain)."""
    ti = jnp.maximum(scene["tri_instance"], 0)
    packed = jnp.concatenate(
        [inst_matrices[:, :3, 0], inst_matrices[:, :3, 1],
         inst_matrices[:, :3, 2], inst_matrices[:, :3, 3]], axis=-1)
    t_total = int(ti.shape[0])
    segs = (_blocked_segments(tri_instance_np)
            if tri_instance_np is not None else None)
    if segs is not None:
        parts = []
        for (tri0, inst0, n_inst, nt) in segs:
            seg = packed[inst0:inst0 + n_inst]           # (ni, 12)
            parts.append(jnp.broadcast_to(
                seg[:, None, :], (n_inst, nt, 12)).reshape(n_inst * nt, 12))
        covered = sum(ni * nt for (_, _, ni, nt) in segs)
        if covered < t_total:                            # invalid tail
            parts.append(jnp.zeros((t_total - covered, 12), packed.dtype))
        rows = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    else:
        rows = packed[ti]                    # (T, 12) the one gather
    c0 = rows[:, None, 0:3]                  # (T, 1, 3)
    c1 = rows[:, None, 3:6]
    c2 = rows[:, None, 6:9]
    tr = rows[:, None, 9:12]
    p = scene["tri_pos_local"]               # (T, 3, 3) static
    n = scene["tri_nrm_local"]
    pos = c0 * p[..., 0:1] + c1 * p[..., 1:2] + c2 * p[..., 2:3] + tr
    nrm = m3.normalize(c0 * n[..., 0:1] + c1 * n[..., 1:2] + c2 * n[..., 2:3])
    return pos, nrm


def transform_vertices(scene: Dict[str, Array], inst_matrices: Array) -> Tuple[Array, Array]:
    """Apply per-instance model matrices to the vertex pool.

    inst_matrices: (I, 4, 4). Returns (world positions (V,3), world normals
    (V,3)). The per-thread model-matrix bake of mesh.cpp:444-509 becomes one
    gather + batched transform.
    """
    vi = jnp.maximum(scene["vert_instance"], 0)
    # pack the matrices as contiguous 12-float rows FIRST (I is small), so
    # the per-vertex gather is one contiguous row and the column slices
    # don't force layout copies; the explicit column arithmetic keeps the
    # work elementwise (a batched 3x3 dot_general is low-intensity)
    packed = jnp.concatenate(
        [inst_matrices[:, :3, 0], inst_matrices[:, :3, 1],
         inst_matrices[:, :3, 2], inst_matrices[:, :3, 3]], axis=-1)  # (I,12)
    rows = packed[vi]                        # (V, 12) the one gather
    c0 = rows[:, 0:3]
    c1 = rows[:, 3:6]
    c2 = rows[:, 6:9]
    tr = rows[:, 9:12]
    p = scene["positions"]
    n = scene["normals"]
    pos = c0 * p[:, 0:1] + c1 * p[:, 1:2] + c2 * p[:, 2:3] + tr
    # normals: inverse-transpose; assume uniform-ish scale (use rotation part
    # normalized per-vertex)
    nrm = m3.normalize(c0 * n[:, 0:1] + c1 * n[:, 1:2] + c2 * n[:, 2:3])
    return pos, nrm
