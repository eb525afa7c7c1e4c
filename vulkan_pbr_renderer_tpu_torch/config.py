"""Renderer configuration for the port.

The fields, names and defaults are those of vulkan_pbr_renderer_tpu/config.py
for every field the port reads: the frame with GI off, both GI modes
(`gi_mode="fast"`: fog march + bounded linear screen trace; "reference": the
full hybrid screen/voxel march), both raster kernels and K1's hierarchical-z
option, both light-shaft modes and the lightgrid debug view.  Values the
port does not implement are rejected at construction instead of being
ignored; the TPU A/B knobs the port does not carry over (ROADMAP) accept
only their default.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

_NOT_PORTED = "not yet ported, see ROADMAP"
_NOT_CARRIED = "a TPU A/B option the port does not carry over, see ROADMAP"

@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- framebuffer ------------------------------------------------------
    width: int = 1920
    height: int = 1080

    # --- camera (main.cpp:83-87) -----------------------------------------
    fov_y_deg: float = 75.0
    z_near: float = 0.02
    z_far: float = 10000.0

    # --- sun + shadow map (render.cpp:677, 959-971) -----------------------
    shadow_map_size: int = 2048
    sun_half_size: float = 40.0            # ortho extent, world units
    sun_color: Tuple[float, float, float] = (1.0, 0.9, 0.7)
    sun_emission_scale: float = 25.0       # lighting_pass.glsl:616
    voxelize_sun_emission_scale: float = 5.0  # lightgrid_voxelize.glsl:102
    shadow_normal_offset: float = 0.1      # lighting_pass.glsl:596
    pcf_mode: str = "split4x4"
    world_bounds: float = 99.0             # sky fallback bound (lighting_pass.glsl:708)

    # --- lightgrid GI (render.cpp:7,678; lightgrid_sweep.glsl) ------------
    lightgrid_size: int = 128
    lightgrid_extent: float = 40.0         # world units; scale = 1/extent
    skylight: Tuple[float, float, float] = (1.0, 1.2, 2.0)  # lightgrid_sweep.glsl:23
    sweep_move_ratio: float = 0.5          # lightgrid_sweep.glsl:32
    sweep_blend: float = 0.35              # lightgrid_sweep.glsl:70
    gi_diffuse_steps: int = 12             # reference march (glsl:685)
    gi_specular_steps: int = 16            # glsl:701
    gi_diffuse_step_scale: float = 1.0
    gi_specular_step_scale: float = 2.0
    gi_screen_trace_steps: int = 24        # reference screen-trace bound
    gi_mode: str = "fast"                  # "fast" | "reference"
    gi_temporal_reference: bool = False    # the interleave in reference mode
    gi_reference_depth_div: int = 1        # reference trace depth [::k, ::k]
    gi_diffuse_foggyness: float = 0.5
    gi_specular_foggyness_is_roughness: bool = True
    gi_diffuse_ss_intensity: float = 0.75
    gi_specular_ss_intensity: float = 0.9
    gi_res_divisor: int = 2                # GI at 1/k resolution, upsampled
    gi_res_divisor_diffuse: int = 0        # 0 = gi_res_divisor
    gi_temporal_div: int = 2               # 2 = half the GI lanes per frame
                                           # into FrameState.gi_cache
    gi_temporal_pattern: str = "checker"   # "columns" | "checker"
    gi_temporal_noise: str = "cycle"       # "frame" | "cycle" (frame_idx | 1)
    gi_temporal_sweep: str = "frame"       # sweep axis per frame | per cycle
    gi_noise_offset: int = 0               # GI noise frame offset (measurement)
    gi_fast_skip_steps: int = 4            # blockage skip (glsl:280-288)
    gi_fast_open_thresh: float = 0.3
    gi_fast_screen_probe: bool = True      # the screen term on/off
    gi_fast_march: bool = True             # only True is ported
    gi_fast_fog_march: bool = True         # only True is ported
    gi_fast_screen_mode: str = "trace"     # only "trace" is ported
    gi_trace_steps: int = 12               # screen trace round-1 steps
    gi_trace_rounds: int = 2               # translucent crossings boosted past
    gi_trace_steps2: int = 6               # steps per re-armed round
    gi_trace_solid_taps: int = 1           # 1, 2 or 3 solidity taps
    gi_trace_depth_div: int = 2            # trace depth table at 1/k res
    gi_trace_depth_mode: str = "plain"     # "plain" [::k,::k] | "min" k x k min
    gi_trace_impl: str = "v2"              # only "v2" is ported
    gi_fast_fog_trilinear: bool = True     # fog march: trilinear u8 pack
                                           # (False = nearest f16 grid)
    gi_fast_jitter_scale: float = 2.0      # march-start jitter in march steps
    gi_fast_hit_steps: int = 12            # diffuse fog-march steps
    gi_fast_hit_step_scale: float = 0.5
    gi_fast_hit_steps_spec: int = 16       # specular fog-march steps
    gi_fast_hit_step_scale_spec: float = 1.0
    voxelize_samples: int = 0              # voxelize sample-stream capacity;
                                           # 0 = 1<<20, Renderer sizes it

    # --- light shafts (lighting_pass.glsl:622-651) ------------------------
    shaft_res_divisor: int = 4
    light_shaft_intensity: float = 0.001
    light_shaft_steps: int = 16
    light_shaft_mode: str = "polar"
    shaft_polar_thetas: int = 4096

    # --- post stack -------------------------------------------------------
    bloom_pass_count: int = 6              # render.h:2
    bloom_strength: float = 0.06           # bloom_upsample.glsl:37
    taa_blend: float = 0.05                # taa_resolve.glsl:246
    taa_catmull_history: bool = True       # 16-tap luma Catmull-Rom; False = bilinear
    taa_full_rgb_catmull: bool = False     # full-RGB Catmull instead of the YCoCg split
    taa_velocity_rejection: float = 1000.0  # taa_resolve.glsl:263
    exposure: float = 2.0                  # final_post_process.glsl:32
    emissive_scale: float = 10.0           # lighting_pass.glsl:440

    # --- IBL bake (render.cpp:794-796, gen_*.glsl) ------------------------
    prefiltered_env_size: int = 256
    prefiltered_env_min_size: int = 16     # render.cpp:564-579
    prefilter_samples: int = 8192          # gen_prefiltered_env_map.glsl:120
    brdf_lut_size: int = 256
    brdf_lut_samples: int = 4096           # gen_brdf_integration_map.glsl:142

    # --- alpha test + material (geometry_pass.glsl:259) -------------------
    alpha_test_threshold: float = 0.3
    f0_dielectric: float = 0.04            # lighting_pass.glsl:657
    material_filter: str = "stochastic"    # 'stochastic' | 'trilinear' | 'nearest'

    # --- rasterizer -------------------------------------------------------
    raster_kernel: str = "folded"          # "folded" (K1) | "rowblock" (K2)
    folded_tile: int = 32                  # pixel tile of the folded kernel
    tile_h: int = 32                       # rowblock pixel tile
    tile_w: int = 128
    tile_capacity: int = 4096              # rowblock: max pairs per tile
    tri_chunk: int = 128                   # pair-buffer block size
    raster_hiz: bool = False               # folded kernel: z-sorted segments
                                           # + per-block early exit
    pair_capacity_factor: int = 3          # binning pair buffer = factor * tris

    # --- pass toggles -----------------------------------------------------
    enable_shadows: bool = True
    enable_gi: bool = True
    enable_light_shafts: bool = True
    enable_taa: bool = True
    enable_bloom: bool = True
    enable_ibl: bool = True
    visualize_lightgrid: bool = False

    def __post_init__(self):
        if self.pcf_mode != "split4x4":
            raise ValueError(f"pcf_mode={self.pcf_mode!r}: {_NOT_CARRIED}")
        if self.folded_tile != 32:
            raise ValueError(
                f"folded_tile={self.folded_tile}: the CUDA kernel is built for "
                f"32x32 tiles; other sizes are {_NOT_PORTED}")
        if self.raster_kernel == "rowblock" and (
                (self.tile_h, self.tile_w) != (32, 128)
                or self.tile_capacity % self.tri_chunk):
            raise ValueError(
                f"rowblock tile {self.tile_h}x{self.tile_w}, capacity "
                f"{self.tile_capacity}: the CUDA kernel is built for 32x128 "
                f"tiles and a capacity that is a multiple of tri_chunk; other "
                f"values are {_NOT_PORTED}")
        if self.raster_hiz and self.raster_kernel == "folded" and self.tri_chunk != 128:
            raise ValueError(
                f"raster_hiz with tri_chunk={self.tri_chunk}: the CUDA kernel keeps "
                f"its early-exit bound per 128-row block; other sizes are "
                f"{_NOT_PORTED}")
        carried = {
            "gi_fast_march": (self.gi_fast_march, True),
            "gi_fast_fog_march": (self.gi_fast_fog_march, True),
            "gi_fast_screen_mode": (self.gi_fast_screen_mode, "trace"),
            "gi_trace_impl": (self.gi_trace_impl, "v2"),
        }
        for name, (value, only) in carried.items():
            if value != only:
                raise ValueError(f"{name}={value!r}: {_NOT_CARRIED}")
        choices = {
            "raster_kernel": (self.raster_kernel, ("folded", "rowblock")),
            "light_shaft_mode": (self.light_shaft_mode, ("polar", "march")),
            "material_filter": (self.material_filter,
                                ("stochastic", "trilinear", "nearest")),
            "gi_mode": (self.gi_mode, ("fast", "reference")),
            "gi_temporal_pattern": (self.gi_temporal_pattern, ("columns", "checker")),
            "gi_temporal_noise": (self.gi_temporal_noise, ("frame", "cycle")),
            "gi_temporal_sweep": (self.gi_temporal_sweep, ("frame", "cycle")),
            "gi_trace_depth_mode": (self.gi_trace_depth_mode, ("plain", "min")),
        }
        for name, (value, allowed) in choices.items():
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}")

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def lightgrid_scale(self) -> float:
        return 1.0 / self.lightgrid_extent

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Deepest 32x128 segment of the SunTemple stand-in on the chip_smoke path,
# rounded up to a multiple of 1024 (PERF.md section 4 gives the measurement).
TILE_CAPACITY_SUNTEMPLE = 24576

# The bench's frame (bench.py:50): the JAX defaults, GI on, folded raster.
SUNTEMPLE_1080P = RenderConfig(width=1920, height=1088)
# The same frame through the rowblock kernel K2.  tile_capacity is the
# smallest multiple of 1024 at or above the deepest 32x128 segment of the
# SunTemple stand-in over camera_path(i/7), i < 8, and both chip_smoke sun
# angles (measured with this package's binning; PERF.md section 4).
SUNTEMPLE_1080P_ROWBLOCK = SUNTEMPLE_1080P.replace(raster_kernel="rowblock",
                                                   tile_capacity=TILE_CAPACITY_SUNTEMPLE)
# The no-GI frame of the first slice.
SUNTEMPLE_1080P_NO_GI = RenderConfig(width=1920, height=1088, enable_gi=False)
# The bench's reference leg (bench.py:177): the exact reference GI march.
SUNTEMPLE_1080P_REFERENCE = SUNTEMPLE_1080P.replace(gi_mode="reference")
# The affordable reference-GI product mode, field for field the JAX preset
# (config.py:511-513) at its own 1920x1080: the interleave and the
# subsampled trace depth table applied to the reference march.
REFERENCE_PRODUCT = RenderConfig(gi_mode="reference", gi_temporal_reference=True,
                                 gi_reference_depth_div=2)
# The bench's frame through K1's hierarchical-z variant.
SUNTEMPLE_1080P_HIZ = SUNTEMPLE_1080P.replace(raster_hiz=True)
