"""Deferred PBR rendering as a software pipeline of device kernels.

Accelerator rebuild of the reference's render stack (layer 2+4: the Vulkan
GAPI under include/garden/graphics/ and the render systems under
include/garden/system/render/, orchestrated by DeferredRenderSystem's event
chain deferred.cpp:441-777). JAX cannot reach the GPU's hardware
rasterizer, so the pipeline is a software one:

1. vertex transform + triangle setup (XLA)
2. sort-based screen-tile binning with fixed per-tile budgets
3. a Pallas (Triton) visibility-buffer raster kernel over screen tiles
   (tri id + perspective-correct barycentrics + reverse-Z depth)
4. deferred G-buffer shading: gather-by-triangle-id (XLA)
5. PBR lighting resolve, CSM shadows, HBAO, sky (XLA elementwise; fused)
6. post stack: bloom, auto-exposure histogram, tone map, FXAA

Command buffers, barriers, descriptor sets and framebuffer objects have no
analog: XLA's dependency order replaces the entire command/barrier machinery
(SURVEY.md section 2.3); "framebuffers" are named arrays in
the frame-state pytree.
"""
