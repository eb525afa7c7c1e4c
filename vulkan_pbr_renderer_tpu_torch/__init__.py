"""vulkan_pbr_renderer_tpu_torch — the PyTorch + CUDA port of the renderer.

The JAX package `vulkan_pbr_renderer_tpu` stays the reference; this package
mirrors its layout and function names so each counterpart is easy to find:

  utils/   math, noise, color, image metrics + PNG IO
  gpu/     texture sampling (the Vulkan-sampler replacement)
  raster/  triangle setup, tile binning, the folded-tile visibility kernel
           (csrc/vis_folded.cu on the GPU, its plain PyTorch version on the CPU)
  shade/   BRDF, shadows, G-buffer, lighting, TAA, bloom
  bake/    one-time IBL precompute
  assets/  scene container, numpy builders of the procedural scenes, the
           TGA / HDR / DDS / glTF / FBX loaders
  app/     renderer orchestration, the headless CLI, the FPS camera, the
           browser preview and hot reload of shade/

It imports torch and numpy and never jax.  Importing it sets the f32
precision flags (device.py).
"""

from . import device  # noqa: F401  (sets the f32 precision flags)

__version__ = "0.1.0"
