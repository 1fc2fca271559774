"""Rigid-body physics, vectorized over fixed-capacity body/contact arrays.

Data-parallel rebuild of the reference's PhysicsSystem-over-Jolt (reference:
include/garden/system/physics.hpp:667, source/system/physics.cpp:906-1222).
The Jolt pipeline — broadphase pair sweep, narrowphase contact generation,
island build + sequential-impulse solve, semi-implicit Euler integration, all
fanned out on a JobSystemThreadPool — becomes a chain of vectorized XLA
stages over struct-of-arrays state:

- broadphase: uniform spatial hash grid, sorted cell keys, 27-neighborhood
  candidate gather with a fixed per-body candidate budget (the analog of
  Jolt's maxBodyPairCount, physics.hpp:680).
- narrowphase: batched analytic contact kernels (sphere/box/capsule/plane)
  emitting fixed-size manifolds with validity masks.
- solver: mass-splitting Jacobi impulse iterations (data-parallel stand-in
  for sequential impulses; islands are implicit — every contact is solved
  every iteration, masked).
- integration: semi-implicit Euler + first-order quaternion update.

Everything is static-shaped: capacity overflow drops candidates exactly like
Jolt's fixed pair/contact budgets do.
"""

from garden_tpu.physics import shapes  # noqa: F401
