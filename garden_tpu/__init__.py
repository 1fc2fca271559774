"""garden-tpu: a JAX-native game/simulation engine for one or more GPUs.

A from-scratch rebuild of the capabilities of the Garden C++/Vulkan engine
(reference: cfnptr/garden) designed accelerator-first:

- ECS component stores are fixed-capacity structure-of-arrays device buffers
  (reference: ecsm LinearPool, see SURVEY.md section 2.1).
- Rigid-body physics (broadphase, narrowphase contacts, impulse solve,
  semi-implicit integration) is vectorized XLA/Pallas over body/contact tiles
  (reference: Jolt via source/system/physics.cpp).
- The Vulkan render graph becomes a software pipeline: tiled triangle
  rasterization to a visibility buffer, deferred G-buffer shading, PBR
  lighting, CSM, HBAO, bloom, auto-exposure, tone mapping, FXAA, atmosphere
  (reference: source/system/render/*).
- The whole frame is one jitted step function; worlds batch across devices
  via shard_map (reference has no multi-device analog).
"""

__version__ = "0.1.0"

from garden_tpu.core import math3d  # noqa: F401
