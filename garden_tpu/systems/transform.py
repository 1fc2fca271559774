"""Transform hierarchy: position/rotation/scale with parent links.

Data-parallel rebuild of TransformSystem (reference:
include/garden/system/transform.hpp:455, source/system/transform.cpp). The
reference stores a SIMD-packed TRS per entity plus parent/children pointers
and walks the tree per query (`calcModel`, active-flag cascade
transform.hpp:110-130). Here the whole hierarchy lives in SoA arrays and the
per-frame bake is one vectorized pointer-jumping pass:

    world[i] = world[parent[i]] @ world[i];  parent[i] = parent[parent[i]]

which resolves any tree of depth <= 2^K in K iterations — no pointer chasing,
no recursion, O(N log depth) total dense work.

Marker components DoNotDestroy/DoNotDuplicate/DoNotSerialize
(transform.hpp:513) are represented as boolean fields on the transform store.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from garden_tpu.core import math3d as m3
from garden_tpu.core.ecs import ComponentDef, Field, System

Array = jnp.ndarray

# Maximum supported hierarchy depth = 2**JUMP_ITERS.
JUMP_ITERS = 5  # depth 32

TRANSFORM = ComponentDef(
    "transform",
    {
        "position": Field((3,), jnp.float32, 0.0),
        "rotation": Field((4,), jnp.float32, (0.0, 0.0, 0.0, 1.0)),
        "scale": Field((3,), jnp.float32, 1.0),
        "parent": Field((), jnp.int32, -1),
        "active": Field((), jnp.bool_, True),
        "static": Field((), jnp.bool_, False),
        # marker flags (reference: DoNotDestroySystem etc., transform.hpp:513)
        "do_not_destroy": Field((), jnp.bool_, False),
        "do_not_duplicate": Field((), jnp.bool_, False),
        "do_not_serialize": Field((), jnp.bool_, False),
    },
)


def bake_world_matrices(store: Dict[str, Array]) -> Array:
    """Compose local TRS with ancestors -> (N, 4, 4) world matrices.

    Replaces the reference's per-entity `calcModel` walks (used by the
    model-matrix bake in mesh culling, mesh.cpp:444-509) with log-depth
    pointer jumping.
    """
    local = m3.compose_trs(store["position"], store["rotation"], store["scale"])
    eye = jnp.eye(4, dtype=local.dtype)
    world = jnp.where(store["has"][:, None, None], local, eye)
    parent = jnp.where(store["has"], store["parent"], -1)
    for _ in range(JUMP_ITERS):
        has_parent = parent >= 0
        safe = jnp.maximum(parent, 0)
        parent_mat = jnp.where(has_parent[:, None, None], world[safe], eye)
        world = m3.matmul(parent_mat, world)
        parent = jnp.where(has_parent, parent[safe], -1)
    return world


def bake_world_active(store: Dict[str, Array]) -> Array:
    """Cascade active flags down the tree (transform.hpp:110-130) -> bool[N]."""
    active = store["active"] & store["has"]
    parent = jnp.where(store["has"], store["parent"], -1)
    for _ in range(JUMP_ITERS):
        has_parent = parent >= 0
        safe = jnp.maximum(parent, 0)
        active = active & jnp.where(has_parent, active[safe], True)
        parent = jnp.where(has_parent, parent[safe], -1)
    return active


def world_positions(world_mats: Array) -> Array:
    return world_mats[..., :3, 3]


class TransformSystem(System):
    component = TRANSFORM

    def attach(self, world) -> None:
        super().attach(world)

    # Host-side convenience used by scene code.
    def set_parent(self, entity: int, parent: int) -> None:
        self.world.set_component(entity, "transform", parent=parent)
