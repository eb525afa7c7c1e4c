#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. card: torch / CUDA versions and the card's name and power limit;
  2. build: compile the port's CUDA kernels from csrc/ (build/torch_kernels/),
     one nvcc per source, all started together;
  3. each visibility kernel against its plain PyTorch version on the card:
     ids exactly equal, depth within atol=1e-6 (K2 and the hiz kernel:
     exactly equal), on random triangle sets (the three of
     tests/test_raster_pallas.py; for K1 also a one-tile stack of 4P
     triangles and a one-tile set whose exact ties fall 2P rows apart, in
     different pieces of its work list, P its piece length; for the
     rowblock kernel K2 a set whose segments overflow tile_capacity and the
     same two one-tile sets for its own P on a 32x128 tile; for the hiz
     kernel duplicated triangles, one-tile sets where its per-slot tie
     rule differs from "smallest id" (ties 128, 256 and 384 rows apart, in
     one slot), and deep stacks that it leaves early) and on every tile of
     the real camera and sun passes; kernel times (median and min of 5
     rounds of 20 launches) and plain times at both pass shapes beside
     each kernel's bound (the larger of its
     evaluations' flops over the f32 peak and its bytes over the HBM rate),
     each kernel's P and work items per pass, and for the hiz kernel the
     rows it walked beside the serial walk's, the pixels that took its tie
     re-resolve, K1's time on the same passes and the pixels whose ids
     differ from K1's; K1's and K2's work lists, which their libraries build
     on the card in the launch, equal to folded_work_list /
     rowblock_work_list exactly on every set and real pass (K2's at its
     capacity, cut or not), and K1's and K2's times as called (list build
     and raster) and on the device alone;
  3b. the fast-GI ray kernel gi_fast_ray (csrc/gi_fast_ray.cu) against
     gi.fast_ray_resolve_plain on the card: seed-made lanes
     (tests/test_torch_gi_ray_inputs.py, a 16^3 grid) of both rays at
     16,384 lanes with every trace outcome (lanes outside the grid, off screen, out of
     budget, resolved, translucent crossings that re-arm), and the nearest
     march, no screen term and 3 solidity taps at 4,096 lanes; then, in path
     A, both rays' real lanes of a steady frame captured from
     Renderer.render at full width: statuses that differ (at most 1e-4 of
     the lanes), rgb max abs err where they agree (at most 1e-5), the
     kernel's time (median and min of 5 x 20 launches, as the wrapper's
     calls come and with the launches queued behind a device sleep, the
     device's time alone), the plain
     version's, and the bound (the steps these lanes take, from the plain
     version's masks, at GI_FLOPS each over the f32 peak, or every input
     byte once over the HBM rate), the SIMT efficiency of the lanes taken
     in rows of 32 and in the kernel's warp tiles (gi.simt_efficiency, from
     the plain version's per-lane step counts), the kernel's registers and
     its resident blocks per SM;
  3c. the binning kernels (csrc/binning.cu, through binning.bin_triangles;
     run once the scene of phase 4 is built) against
     binning.bin_triangles_plain on the card, every field bit for bit
     (starts, pair_data, chunk_minz, total_pairs, max_segment): the triangle
     sets above in slim13, slim13 with z_order and wide16 on 32x128 tiles,
     each whole, in a band, with an overflowing pair capacity and in a band
     with no pair, plus a one-tile run of 30,000 pairs, a set whose
     triangles share one zq and a 2304^2 screen of 5,184 tiles; each whole
     case again with the sort's long paths forced (sort_keys 32: the radix
     sort; radix_keys 40 besides: the merge in global memory); then
     frame 0's real camera and sun passes of paths A (slim13), B (wide16)
     and D (z_order) and a band of each camera pass; per real pass its
     longest segment and the tiles on the long path, the wrapper's time
     (median and min of 5 x 20 calls), its device time alone (hold), each
     stage alone (setup + cumsum, count, scan, scatter, the short sort, the
     long sort, pack: the rows live and dead and chunk_minz), the two sorts
     at sort_keys 256, 1024 and 4096, the plain
     version's time, and the bound (the setup fields read and the outputs
     written once, over the HBM rate), and the largest absolute difference
     over every case;
  3d. the post stack's kernels (csrc/post.cu: taa_resolve,
     bloom_down_chain, bloom_down_level, bloom_up_chain, bloom_up_level)
     against their plain versions (phase_post): TAA bit for bit at
     1920x1088 and 160x96 in the three history modes, whole, over row
     windows at the frame's edges and through the halo API, and with
     velocities of sigma 0.2 uv and a third of the frame off screen (whole
     and from an odd row); bloom chains
     level by level on the plain version's inputs, bit for bit at 2:1
     (1920x1088, 64x64 down to 1x1) and within 1e-5 at odd sizes
     (1920x1080, 240x135, 96x54, where the plain version's einsum sums in
     its own order), the bf16 atlas the down launches write, the fused
     final level, row windows, a source band and the tonemap alone; the
     one-launch down chain against the plain chain (bits while the chain is
     2:1, 1e-5 from an odd level on), its atlas and zero rows, and against
     the per-level launches (bits); the one-launch up chain with the
     tonemap, whole and over two row windows of its last level, against
     the plain chain (bits where every level is exactly 2x, 1e-5 where one
     takes the linear resize) and against the per-level launches (bits);
     then, in path A, the same on the real post inputs of a steady frame
     (phase_post_real) with each kernel's time (median and min of 5 x 20
     launches as called, and the device's time alone; each chain both as
     one launch and as per-level launches), the plain version's, the byte
     and flop bound, the library yardsticks (bloom_down: a replicate pad +
     depthwise conv2d chain; bloom_up: per level a bilinear interpolate, a
     replicate pad and a dilated depthwise conv2d, then the add and the
     tonemap, with its max abs diff from the plain chain), the down chain
     kernel's registers and resident blocks, and the up chain kernel's
     tile, registers, local and shared memory, resident blocks and ptxas
     spills;
  3e. the G-buffer and lighting kernels (csrc/gbuffer.cu: gbuffer_kernel;
     csrc/lighting.cu: gi_inputs_kernel, shafts_polar_kernel (one launch:
     the profile's bands, then the pixels), shade_kernel) against their
     plain versions (phase_shade), on the seed-made frames of
     tests/test_torch_shade_inputs.py (every material filter at 1920x1088,
     160x96, 7x143, 1x1 and an odd band; the GI lanes
     in both interleave patterns and parities, every lane, a separate
     diffuse divisor; the shafts at divisors 4 and 1; the shade with GI on,
     without shadows, the static IBL and neither, whole, in a band, ragged,
     and with its grids 0-3 exact 2x steps below the pixels), every output
     bit for bit (SHADE_ATOL 0);
     then, in path A, the same on a steady frame's real inputs captured from
     Renderer.render (phase_shade_real) with each kernel's time (median and
     min of 5 x 20 calls as called, and the device's time alone), the plain
     version's, and the bound (bytes: each input once, the distinct
     triangles, atlas rows and sun-map texels read, each output once; flops
     SHADE_FLOPS per output), and path A's frames 0-1 through the kernels
     against the same frames through their plain versions on the card
     (phase_plain_frame: max abs diff of the final image), and the tiled
     G-buffer's and the tiled shade's tile, registers, local memory, shared
     memory, resident blocks and ptxas spills, and the shafts kernel's
     registers, local and shared memory, resident blocks and spills; the
     GI lanes go through their cached plan (gi_modes._LanePlan), and two
     calls of one shape return outputs that share no storage;
  3f. the lightgrid sweep (csrc/sweep.cu: sweep_ring_kernel for lines of
     32-256 voxels, each line in a warp's registers, groups of 8 lines
     through a ring of cp.async stages; lightgrid_sweep_kernel for the
     other lengths; the swept grid and its u8 table in one launch, through
     gi.sweep_lightgrid_u8) against the plain chain on the card
     (gi.sweep_lightgrid + gi.quantize_grid_u8), grid and table bit for bit
     (phase_sweep): seeded grids on every axis (the JAX tests' (32,4,4,4)
     grid, 16^3, a 7x9x5 grid of odd lengths whose table rows take word
     stores, a 520-voxel line in dynamic shared memory, 128^3) with no,
     ~30% and every voxel occupied, a line too long for shared memory
     refused (ValueError); then, in path A, frame 1's real 128^3 grid
     captured from Renderer.render on each axis (phase_sweep_real) with the
     time as called and the device's alone, the plain chain's, the byte
     bound (the grid read, the grid and the table written) and the kernel's
     registers, spills, resident blocks and shared bytes;
  3g. triangle transform + setup (csrc/setup.cu: setup_kernel, through
     setup.transform_and_setup) against the plain composition
     setup_triangles(transform_to_clip(...)) on the card, all eight
     TriSetup fields bit for bit (floats as int32 views): the seeded sets
     of tests/test_torch_setup_inputs.py in every cull mode, with and
     without the jitter, dense and through the strided tri_attr view; then
     path A's frame-0 camera pass (back cull, jitter) and sun pass (cull
     none) on the 638,700 triangles, with the kernel's time as called and
     on the device alone, the plain chain's times and device events, and
     the byte bound;
  3h. voxelize (csrc/voxelize.cu): the frame's pass, voxelize_pass_kernel
     (the plan's u32 words scatter-maxed, then decoded and zeroed again,
     in one cooperative launch, through gi.voxelize_lightgrid), against
     the plain chain
     (decode_voxel_grid_plain of voxelize_scene_plain), the decoded grid
     bit for bit; and the row-sharded frame's route (voxelize_kernel after
     a memset in one C call, then decode_voxel_kernel, through
     gi.voxelize_scene and gi.decode_voxel_grid), the packed words and the
     decoded grid bit for bit: the seeded sets of tests/test_torch_voxelize_inputs.py
     (large planes, one-sample and zero-area triangles, samples outside the
     grid, emissive materials, sun texels past the map's edges, a cut stream,
     a lod between levels), whole, in 2, 4 and 8 shards (slices that start
     inside a run, the shards' max equal to the whole), with the emission by
     value, a long stream and a 128^3 grid, random words through the decode,
     and refusals (the pass on every set, the one-sample set with no
     search, a long stream, 128^3, a cut one-sample stream); then path A's
     frame-0 and sun-move frame inputs captured from Renderer.render:
     samples, occupied voxels, bits, the pass's and each int64 kernel's
     time as called and on the device alone (median and min of 5 x 20),
     the int64 route's (its two kernels), the plain chain's times and
     device events, each one's own events, the byte bounds (each
     triangle's offset and row, the distinct atlas rows and sun texels
     read; the pass's decoded grid written, the int64 route's words
     written, read by the decode, and its grid written), ptxas registers
     and spills, and the pass's resident blocks;
  3i. the reference GI's ray kernel gi_reference_ray
     (csrc/gi_reference_ray.cu: skip, screen trace, resolve and voxel march
     per lane, through gi.reference_ray_resolve) against
     gi.reference_ray_resolve_plain on the card (phase_reference_random):
     the seeded sets of tests/test_torch_reference_ray_inputs.py (every
     status, translucent crossings, lanes that open no voxel, scalar and
     per-lane foggyness, a 7-step trace, a denser grid) and a 24^3 grid with
     a full-resolution trace table; then, in paths C and C-product, the
     rays' real lanes of a steady frame captured from Renderer.render
     (phase_reference_real: C's diffuse and specular rays, C-product's
     diffuse ray): statuses that differ (at most 1e-4 of the lanes), rgb
     max abs err where they agree (at most 1e-5) and whether every case is
     bit-equal, the kernel's time as called and the device's alone (median
     and min of 5 x 20 launches), the plain version's, the bound (REF_FLOPS
     at the plain version's per-lane counts of the steps and taps the
     function needs and the levels' decode once over the f32 peak, or
     every input byte once over the HBM rate), the per-phase SIMT
     efficiency (gi.reference_simt: the first design and the kernel),
     registers, local memory, shared bytes, ptxas spills and resident
     blocks;
  3j. the fast GI's probe and hi-z screen terms and its economy mode
     (csrc/gi_screen_ray.cu: gi_screen_ray through gi.screen_ray_resolve,
     gi_probe_ray through gi.probe_ray_resolve) against
     gi.screen_ray_resolve_plain on the card, statuses and rgb bit for bit
     (phase_screen_random): the seeded sets of
     tests/test_torch_gi_screen_inputs.py, every knob branch (the probes'
     spacings, jitter, solidity taps, overshoot, to_stop, dist_mip, one
     point, no edge fallback, the nearest fog march; the hi-z term with and
     without its solidity tap; the economy mode's samples, march_to_hit,
     k-point and one-point probe, no screen term); then, in paths E, F and
     G, both rays' real lanes of a steady frame captured from
     Renderer.render (phase_screen_real): bits, the kernel's time as
     called and the device's alone (median and min of 5 x 20 launches),
     the plain version's, the bound (SCREEN_FLOPS at the plain version's
     per-lane step counts over the f32 peak, or every input byte once over
     the HBM rate), the SIMT efficiency of the steps in the kernel's warp
     tiles, registers, local memory and resident blocks;
  4. the paths, each on the 638,700-triangle SunTemple stand-in with a
     2048^2 shadow map, through Renderer.render, the sun moving on frame 5,
     every launch count set to 0 just before the path and read just after:
       A  SUNTEMPLE_1080P (GI on, fast mode, folded kernel K1), 3 frames;
       B  SUNTEMPLE_1080P_ROWBLOCK (GI on, rowblock kernel K2), 3 frames;
       no-GI  SUNTEMPLE_1080P_NO_GI (K1), 3 frames;
       C  SUNTEMPLE_1080P_REFERENCE (reference GI, K1), 8 frames;
       C-product  REFERENCE_PRODUCT (reference GI, interleaved, half-res
          trace depth; K1) at its own 1920x1080, 8 frames;
       D  SUNTEMPLE_1080P_HIZ (GI on, K1's hierarchical-z variant), 8 frames;
       E  SUNTEMPLE_1080P_ECONOMY (the economy mode with the probe, K1), 3
          frames;
       F  SUNTEMPLE_1080P_GI_HIZ (the hi-z screen term, K1), 3 frames;
       G  SUNTEMPLE_1080P_GI_PROBES (the probes screen term, K1), 3 frames;
       A, E, F and G also give the device events and device ms of one more
       steady frame (pass_profile.device_events);
     checking the images, the lightgrid, when voxelize ran, the overflow
     counters and each kernel's launch count (setup: one per raster pass,
     on every counted run, the app surface and the sharded ranks too,
     whatever the raster backend; gi_fast_ray: 2 per frame on
     the fast-GI paths A, B and D, none on no-GI, C, C-product, E, F and G;
     gi_screen_ray: 2 per frame on F and G, gi_probe_ray on E, none
     elsewhere;
     gi_reference_ray: 2 per frame on C and C-product, none elsewhere; binning:
     one per raster pass, as the path's visibility kernel; per frame 1
     taa_resolve, 1 bloom_down_chain and 1 bloom_up_chain launch on every
     counted run and the app surface's, 6 bloom_down_level launches in
     place of the down chain in the sharded ranks (and their 1
     bloom_up_chain launch over the rank's rows); per frame 1
     gbuffer launch, and per lit frame 1 shade, 1 shafts_polar and, with GI
     on, 1 gi_inputs launch, and with GI on 1 sweep launch a frame (the
     lightgrid view too), on every counted run too; with GI on 1 voxelize
     and 1 decode_voxel launch a frame that voxelizes: frame 0 and the sun's
     move); frame 0's
     camera pass through K1 and K2 (ids that differ); the fast frame against the reference frame
     (SSIM after the same settled frames at two camera points and one sun,
     and their mean beside the JAX package's gate; report only); then small
     160x96 frames rendered on the card against the same frames through the
     plain CPU path (SSIM): GI off, fast GI through K1 and K2, reference GI,
     REFERENCE_PRODUCT's knobs, the hiz kernel, the marched light shafts,
     the lightgrid view, the economy mode (probes; hiz), the hi-z and the
     probes screen terms, the wave-9 march (eager on the card: no kernel)
     under the trace and the probes, and bloom off (its card frames a counted run: 1 TAA
     and 1 bloom_up_level tonemap launch a frame);
  5. the app surface, every launch count set to 0 just before each run and
     read just after:
       headless, full width: app.headless.main in-process, suntemple at
          detail 4.5 (638,700 triangles), 1920x1088, 4 frames, --bench, PNGs
          into a temporary directory: 5 setup, 5 K1 and 5 binning launches (4
          camera passes + 1 sun pass) and 8 gi_fast_ray launches, each PNG within
          1/255 of the same frame through Renderer.render; K1 against its
          plain version on every tile of the run's first camera pass and its
          sun pass; the split of a frame into render, fetch and PNG encode;
       headless, the other scenes at the CLI's default 960x544, 2 frames
          each: triangle and cube (brute-force raster, no K1 or binning
          launch), spheres (3 K1 and 3 binning launches; 3 setup and 4
          gi_fast_ray launches each; which input it had, the resource mount's textures
          or flat factors; K1 against its plain version on every tile of
          both passes at that shape); `python3 -m ...app.headless --scene
          cube` as a subprocess;
       preview: a PreviewSession over a real Renderer (suntemple, detail
          1.0, 640x384), served on port 0; input posted over HTTP, three
          ticks (the third in the lightgrid view), the frame and the stats
          fetched over HTTP; 4 setup, 4 K1, 4 binning and 4 gi_fast_ray launches; K1
          against its plain version on every tile of both passes from the
          session's starting camera; the split of a tick;
       bake_irradiance at its defaults on the card against the CPU
          (atol 1e-4), init_devices, and the native BC decoder built with
          g++ against the numpy decode;
  6. the row-sharded frame (parallel/sharding.py):
       row bands: K1, K1-hiz and K2 on frame 0's camera pass at 1920x1088 in
          2 bands of 544 rows and the 2048^2 sun pass in 4 bands of 512, each
          band with its y_origin: depth and ids equal to the same rows of the
          kernel's whole pass bit for bit, ids equal to the plain version's;
       sharded, through parallel.launch (nccl with a card per rank, else
          gloo; the backend and the card count printed), every launch count
          set to 0 in each rank just before its frames and read just after
          (gi_fast_ray: 2 per frame in every rank; binning once per band
          pass, as the rank's visibility kernel):
          (a) SUNTEMPLE_1080P through K1, dp=1 x sp=2, 4 frames along
          camera_path with the sun moving on frame 3, against render_frame at
          the sharded frame's divisor-1 config in this process: the image
          within 2e-4 away from the sky (the sharded frame shades the sky at
          full resolution), the voxelize frames' sun map and lightgrid equal,
          the last state within tests/test_parallel.py's bounds, and the
          steady ms per frame of both (ranks sharing one card gather through
          host memory: not a scaling figure); (b) dp=2 x sp=2 at 160x128
          through K1-hiz, the two slices' images different; (c) dp=1 x sp=2
          at 160x128 through K2; (d) dp=1 x sp=2 at 160x128 with the hi-z
          screen term (path F's mode: gi_screen_ray, 2 a frame in each rank,
          the hi-z atlas built from the gathered full depth);
  7. the summary lines; the last line is the JSON status object.
"""

from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SCENE_DETAIL, TEXTURE_SIZE, N_TRIS = 4.5, 256, 638_700
N_FRAMES, SUN, SUN_MOVED, SUN_MOVE_FRAME = 8, (50.0, 30.0), (55.0, 30.0), 5
N_FRAMES_SHORT = 3          # paths A, B and no-GI, measured in earlier slices
KERNELS = ("vis_folded", "vis_folded_hiz", "vis_rowblock", "gi_fast_ray", "binning", "post",
           "gbuffer", "lighting", "sweep", "setup", "voxelize", "gi_reference_ray",
           "gi_screen_ray")
KERNEL_REPS, KERNEL_ROUNDS = 20, 5   # launches per timing, timings per kernel
# cuda_ms(hold=True): the device sleep that the timed launches queue behind,
# ~11 ms at the H100's 1.755 GHz boost clock, longer than the host takes to
# enqueue KERNEL_REPS launches of any wrapper here
HOLD_CYCLES = 20_000_000
DEPTH_ATOL = 1e-6
# fast vs reference frame: bench.py's settle (48 frames at camera_path(0.3),
# sun (35, 80)) and its SSIM over the final sRGB images
SSIM_POINT, SSIM_SUN, SSIM_SETTLE_FRAMES = 0.3, (35.0, 80.0), 48
# the JAX package's fidelity gate (docs/VISUAL_PARITY.md): the mean SSIM over
# these two camera points stays at or above the floor; reported, not enforced
SSIM_POINTS, SSIM_GATE_FLOOR = (0.3, 0.7), 0.9686
# the headless CLI's full-width run and the sun it renders under by default
HEADLESS_SIZE, HEADLESS_FRAMES, HEADLESS_SUN = (1920, 1088), 4, (35.0, 80.0)
CLI_DEFAULT_SIZE = (960, 544)
PREVIEW_SIZE, PREVIEW_TEXTURE = (640, 384), 128
IRRADIANCE_ATOL = 1e-4
# phase 6: the row bands of each kernel's real passes; the sharded frame's
# runs (frames, the frame the sun moves on), the bound its image keeps to the
# single-process frame away from the sky (tests/test_parallel.py:80), and the
# small runs' size
CAMERA_BANDS, SUN_BANDS = 2, 4
SHARDED_FRAMES, SHARDED_SUN_MOVE, SHARDED_ATOL, SKY_MARGIN = 4, 3, 2e-4, 16
SMALL_SHARDED = (160, 128)
# the bound of a visibility kernel: one evaluation per (pixel, pair row it
# walks) of three edge values (2 multiplies + 2 adds each) and their sum; the
# depth and divide on the few covered evaluations are left out.  Peaks of
# one H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores, HBM3.
FLOPS_PER_EVAL, PEAK_F32, PEAK_HBM = 14, 67e12, 3.35e12
# the fast-GI ray kernel against its plain version: statuses that may differ
# (a share of the lanes) and the rgb tolerance where they agree.  The kernel
# mirrors the plain version's order on the card, down to the order in which
# torch.linalg.vector_norm sums its squares; a PyTorch build that sums them
# otherwise moves the fallback's rgb by an ulp (up to ~8e-6 at the
# lightgrid's largest radiance)
GI_STATUS_SHARE, GI_RGB_ATOL = 1e-4, 1e-5
# its flops per lane and per step, counted from its arithmetic: the lane's
# set-up, tone and trace set-up; a skip step (3 adds, an alpha-only
# trilinear fetch); a march step (3 adds, a fetch decoding 8 corners x 4
# channels, the fog sum); a trace step (projection, depth fetch, crossing
# test); a crossing's solidity set-up (two transforms) and each alpha tap;
# the fallback (normalize, fetch, tone); the resolve (two bilinear bf16
# pyramid levels and the mip lerp)
GI_FLOPS = dict(lane=90, skip=50, march=241, trace=41, crossing=64, taps=58, fallback=263,
                resolve=80)
# phase 3i: the reference GI's ray kernel, held to its plain version with
# gi_fast_ray's tolerances; its flops per lane and per step or fetch,
# counted from csrc/gi_reference_ray.cu's arithmetic.  A trilinear fetch of
# the u8 table costs 18 for its index math, 29 for its alpha (8 corner
# scales and the 21 of the 8-corner lerp) and 87 for its rgb (3 channels of
# 8 level lookups in the block's decode table and the lerp's 21): the
# kernel decodes a u8 level into shared memory once, not per corner.  The
# lane's set-up (the open point's view transform, the trace direction, its
# length and first step); a skip step (3 adds, the uvw, an alpha fetch, the
# test); a trace step (the position, the projection and its divides, the
# off-screen test, the growth, the nearest depth fetch, the unprojection and
# its divides, the two squared norms that order the norms, without their
# square roots); a crossing's two transforms and the boost; each alpha tap
# the crossing's outcome needs ("taps": the third only where the first two
# leave it open; its point, the fetch, the sum); the fallback (its point, the
# uvw, an rgb fetch, the tone); the resolve (two bilinear bf16 pyramid
# levels and the mip lerp); the open sample of a lane that marches (the
# uvw, an rgb fetch, the march's set-up, the mean and the tone); a march
# step (3 adds, the uvw, an alpha and an rgb fetch, the test, the fog sum);
# and once a call the 256 levels' decode, s * s / max(1 - s * s, 1/256)
REF_FLOPS = dict(lane=55, skip=57, trace=91, crossing=56, taps=58, fallback=137, resolve=80,
                 seed=141, march=152)
REF_DECODE_FLOPS = 256 * 5
# phase 3j: the fast GI's probe and hi-z screen terms and its economy mode
# (csrc/gi_screen_ray.cu: gi_screen_ray, gi_probe_ray), held to their plain
# version bit for bit; their flops per lane and per step, counted from the
# kernels' arithmetic with gi_reference_ray's fetch costs (index math 18,
# alpha 29, rgb 87): the lane's set-up, mean and tone; a skip step (3 adds,
# the uvw, an alpha fetch, the test); a fog-march step (3 adds, the uvw, an
# alpha and an rgb fetch, the test, the fog sum); a quadrature sample (its
# point, an alpha and an rgb fetch, the openness and the sums); a
# march_to_hit step (3 adds of a scaled step, the uvw, an alpha fetch); a
# probe point (its fraction and point, the projection's two transform rows
# and three divides, the on-screen test, the uv, the nearest depth and the
# test); a solidity tap (its point, the uvw, an alpha fetch, the sum) and a
# tested point's surface projection ("tap_point"); the hi-z term's set-up
# (two projections, the clip, the end points, the walk's set-up, the end
# point's test) and a round of its walk (the cell, its exits, the fetch,
# four view-space depths, the level and t); the overshoot; the fallback
# (normalize, point, rgb fetch, tone); the resolve (the uv, four f16 texels
# a channel, the bilinear lerp, the level of dist_mip)
SCREEN_FLOPS = dict(lane=40, skip=57, march=152, sample=160, hit=60, probe=60, taps=66,
                    tap_point=34, hiz_lane=110, hiz=50, overshoot=30, fallback=137, resolve=55)
SCREEN_KERNELS = ("gi_screen_ray", "gi_probe_ray")
# the post kernels against their plain versions: TAA and the 2:1 bloom levels
# follow the plain version's order (bits, or this bound where an op rounds
# otherwise); the linear resize of an odd-size level sums its bands in
# another order than the plain version's einsum; the bf16 atlas within one
# bf16 step there
POST_EXACT_ATOL, POST_ODD_ATOL, POST_ATLAS_RTOL = 2e-6, 1e-5, 2.0 ** -7
# their flops per output texel, counted from csrc/post.cu's arithmetic: TAA
# in the YCoCg mode (the 3x3 source and moments 135, their finish 30, the
# 16-tap luma 128, chroma and velocity 56, weights, clip and blend ~70); a
# 2:1 down texel (13 box means of 4 texels x 3 channels and their weighted
# sum); a 2x up texel (9 taps of the 2x bilinear and their sum); the
# tonemap of a final texel (exposure, ACES, pow)
POST_FLOPS = dict(taa=420, down=234, up=300, tonemap=90)
# phase_post's seeded sets: TAA frames, and bloom chains ((h, w),
# passes): 2:1 at 1920x1088 and down to 1x1, odd sizes at 1920x1080 (135 ->
# 67 -> 33 -> 16), 240x135 and 96x54
POST_TAA_SIZES = ((1088, 1920), (96, 160))
# phase 3e: the G-buffer and lighting kernels' wrappers (counters), and the
# bound each output is held to against its plain version: bits (the kernels
# mirror PyTorch's arithmetic on the card, csrc/shade_common.cuh; measured
# bit-equal on the H100 on every seeded set and on path A's real inputs);
# their flops per output (a pixel, a lane, a profile sample),
# counted from the kernels' arithmetic: the G-buffer's barycentrics,
# unprojection, derivatives, lod, a 12-channel bilinear fetch, TBN and
# velocity; a GI lane's two unprojections, three noises, three normalizes,
# two crosses, the trig of the cosine sample and the specular ray; a
# profile sample's sin / cos and bilinear sample; a shaft pixel's
# unprojection, transform, norms and atan2 (plus 6 per profile bin); a
# shaded pixel's unprojection, noises, PCF, Cook-Torrance, split-sum, the
# upsampled grids and emissive
SHADE_KERNELS = ("gbuffer", "gi_inputs", "shafts_polar", "shade")
SLICE_KERNELS = SHADE_KERNELS + ("sweep", "voxelize_lightgrid", "voxelize", "decode_voxel")
# the shade's configurations on the seeded sets: GI on, GI on without
# shadows, the static IBL, neither (no LUT)
SHADE_CASES = (("gi", {}, True), ("gi_no_shadows", dict(enable_shadows=False), True),
               ("ibl", dict(enable_gi=False), False),
               ("no_ibl", dict(enable_gi=False, enable_ibl=False), False))
SHADE_ATOL = 0.0
SHADE_FLOPS = dict(gbuffer=420, gi_inputs=260, shafts_profile=70, shafts_pixel=110, shade=480)
# path A's frame through the kernels against the same frame through their
# plain versions on the card (final sRGB image)
PLAIN_FRAME_ATOL = 1e-3
# phase 3f: the sweep's seeded grids ([D,H,W] per axis; the first follows
# the axis) and their occupied shares; its flops a voxel, counted from
# csrc/sweep.cu's arithmetic: two scans of ~1.93 combines a voxel (247 at
# n = 128) of 7 flops, two L = A*sky + B (6 each), the forward fold (9),
# the blend (9) and the quantize (per channel an add, a divide, a sqrt, a
# multiply and a round; 1 for alpha)
SWEEP_SHAPES = ((32, 4, 4), (16, 16, 16), (7, 9, 5))
SWEEP_OCCUPIED = (0.0, 0.3, 1.0)
SWEEP_FLOPS = 76
# phase 3g: the setup kernel's flops a triangle, counted from csrc/setup.cu's
# arithmetic: three vertices' transform (28), jitter (4) and pixel
# coordinates (6), nine cofactors (27), det (5), the flip (10), c_w (6), c_z
# (18), z_vert (5), the projected bounds (6) and the three edges' crossings
# (27), the rounding and clamps of the bbox (8)
SETUP_FLOPS = 218
# phase 3h: voxelize's flops a sample, counted from csrc/voxelize.cu's
# arithmetic: the R2 point (6), position and uv (20), the texel's
# coordinates and 24 dequant products and 6 bilinear channels (84), the sun
# transform (21), its uv, reference and window (21), four u16 roundings and
# the compare's blend (17), N.L and the radiance (14), the word (the luma
# key 9, three levels 15) and the voxel (12); the decode's a voxel (3
# channels of a product, a square, a subtract, a max, a divide, alpha)
VOXEL_FLOPS, DECODE_FLOPS = 219, 19
POST_CHAINS = (((1088, 1920), 6), ((64, 64), 6), ((1080, 1920), 6), ((135, 240), 4),
               ((54, 96), 3))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=KERNEL_REPS, rounds=KERNEL_ROUNDS, hold=False):
    """(min, median) over `rounds` timings of the mean device ms of fn()
    over `reps` back-to-back runs, after one warm-up run.  Where the host
    takes longer to enqueue fn() than the device to run it, this times the
    host.  With hold, each timing's runs queue behind a device sleep of
    HOLD_CYCLES (torch.cuda._sleep) and the events time the device alone."""
    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return min(times), float(np.median(times))


# ---------------------------------------------------------------------------
# phase 1 + 2


def phase_card():
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(f"card: {nvidia_smi()}", flush=True)


BUILD_LOGS = {}   # kernel source -> what nvcc and ptxas printed when phase_build built it


def _ptxas_entry(log, fn):
    """{registers, stack, spill_stores, spill_loads} that ptxas printed for
    the kernel whose mangled name holds fn (None where the log lacks it)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fn in line:
            text = " ".join(lines[i + 1:i + 4])
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", text)
            r = re.search(r"Used (\d+) registers", text)
            if m and r:
                return dict(registers=int(r.group(1)), stack=int(m.group(1)),
                            spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
    return None


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(cuda_build.build, KERNELS))
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (path, seconds, log) in zip(KERNELS, built):
        BUILD_LOGS[name] = log
        print(f"build: {name} -> {path.name} in {seconds:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        cuda_build.load_library(name)


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).repeat(3, 1)
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


def _crossing_tris(n, seed):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-2, 2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32).repeat(3, 1)
    w = rng.uniform(-0.5, 1.5, (n, 3, 1)).astype(np.float32)
    return np.concatenate([verts * np.abs(w), z * np.abs(w), w], -1)


def _dup_tris(n, seed, copies=3):
    """n random triangles, each `copies` times under shuffled ids: exact
    depth ties."""
    base = _random_tris(n, seed)
    perm = np.random.default_rng(seed + 1).permutation(n * copies)
    return np.concatenate([base] * copies)[perm]


def _stack_tris(n, seed):
    """Screen-covering triangles at random depths: deep segments that the
    hiz walk leaves after their first block."""
    rng = np.random.default_rng(seed)
    verts = np.array([(-3.0, -3.0), (5.0, -3.0), (-3.0, 5.0)]) + rng.uniform(-0.2, 0.2, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


def _slot_tie_tris(apart=128):
    """tests/test_torch_hiz.py::_slot_tie_tris: one 32x32 tile where two
    coplanar triangles tie exactly `apart` rows apart (a multiple of 128:
    one slot), so the first processed (id `apart`) keeps the tie where
    "smallest id" picks 0."""
    def tri(xy, z):
        xy = np.asarray(xy, np.float32)
        return np.concatenate([xy, np.asarray(z, np.float32)[:, None],
                               np.ones((3, 1), np.float32)], -1)

    def plane(xy):
        return 0.5 + 0.125 * np.asarray(xy, np.float32)[:, 0]

    a_xy = [(-1.25, -1.25), (3.0, -1.25), (-1.25, 3.0)]
    b_xy = [(-0.5, -0.5), (0.75, -0.5), (-0.5, 0.75)]
    fill = []
    for k in range(apart - 1):
        x0, y0 = 0.75 + 0.0625 * (k % 4), 0.75 + 0.0625 * (k // 4 % 4)
        fill.append(tri([(x0, y0), (x0 + 0.0625, y0), (x0, y0 + 0.0625)],
                        np.full(3, 0.36 + 0.064 * k / apart)))
    return np.stack([tri(b_xy, plane(b_xy))] + fill + [tri(a_xy, plane(a_xy))])


def _bound(evals, nbytes, flops_per=FLOPS_PER_EVAL):
    """(ms, "operations" or "bytes"): the least time of the work on the card."""
    ops_ms = evals * flops_per / PEAK_F32 * 1e3
    bytes_ms = nbytes / PEAK_HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _k1_work(bins, rows=None):
    """(evaluations, bytes) of K1 (or of K1-hiz, which walks `rows` rows):
    each walked 13-float row on the tile's 1024 pixels; rows and starts read
    once, depth and id written once."""
    n_tiles = bins.starts.shape[0] - 1
    rows = int(bins.starts[-1]) if rows is None else rows
    return rows * 1024, rows * 13 * 4 + (n_tiles + 1) * 4 + n_tiles * 1024 * 8


def _k2_work(bins, capacity, chunk):
    """(evaluations, bytes) of K2: each pair row inside the tile's capacity
    window, on the 8x128-pixel row blocks of its bbox rows."""
    st = bins.starts.to(torch.int64)
    n_tiles = st.shape[0] - 1
    lens = st[1:] - st[:-1]
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=st.device), lens)
    row = torch.arange(int(st[-1]), device=st.device)
    end = torch.minimum(st[1:], (st[:-1] // chunk + capacity // chunk) * chunk)
    walked = row < end[tile]
    data = bins.pair_data.reshape(-1, 16)[:row.shape[0]]
    y0 = ((tile // bins.tiles_x) * 32).to(torch.float32)
    rb0 = torch.clamp(torch.floor((data[:, 13] - y0) / 8.0), min=0)
    rb1 = torch.clamp(torch.floor((data[:, 14] - 1.0 - y0) / 8.0), max=3)
    blocks = torch.clamp(rb1 - rb0 + 1, min=0) * walked
    n_walked = int(walked.sum())
    return (int(blocks.sum()) * 8 * 128,
            n_walked * 16 * 4 + (n_tiles + 1) * 4 + n_tiles * 32 * 128 * 8)


def _compare(d_k, i_k, d_p, i_p, what, atol=DEPTH_ATOL):
    """ids exactly equal, depth within atol; returns max |depth diff|."""
    d_k, i_k, d_p, i_p = (t.cpu().numpy() for t in (d_k, i_k, d_p, i_p))
    bad = int((i_k != i_p).sum())
    check(bad == 0, f"{what}: {bad} ids differ from the plain version")
    check((np.isinf(d_k) == np.isinf(d_p)).all(), f"{what}: coverage differs")
    fin = np.isfinite(d_k)
    err = float(np.abs(d_k[fin] - d_p[fin]).max()) if fin.any() else 0.0
    check(err <= atol, f"{what}: depth error {err} > {atol}")
    return err


def _check_card_list(kernel, bins, what, capacity=None, chunk=None):
    """The work list that K1's (kernel "vis_folded") or K2's ("vis_rowblock",
    at tile_capacity `capacity` in chunks of `chunk`) library built on the
    card in its launch, against folded_work_list / rowblock_work_list
    exactly, the (-1, 0, 0, 0) tail included; the launch's ids and depths
    equal the wrapper's.  Returns the number of live entries."""
    from vulkan_pbr_renderer_tpu_torch.raster import visibility, visibility_v2

    if kernel == "vis_folded":
        lib = visibility_v2._library()
        d, i, items = visibility_v2.run_vis_folded(lib, bins.starts, bins.pair_data,
                                                   bins.tiles_x)
        want = visibility_v2.folded_work_list(bins.starts, lib.vis_folded_piece_rows(),
                                              items.shape[0])
        d_w, i_w = visibility_v2.vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x)
    else:
        lib = visibility._library()
        d, i, items = visibility.run_vis_rowblock(lib, bins.starts, bins.pair_data,
                                                  bins.tiles_x, capacity, chunk)
        want = visibility.rowblock_work_list(bins.starts, capacity, chunk,
                                             lib.vis_rowblock_piece_rows(), items.shape[0])
        d_w, i_w = visibility.vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x,
                                                 capacity, chunk)
    check(tuple(items.shape) == tuple(want.shape) and bool((items == want).all()),
          f"{kernel} {what}: the work list built on the card differs from the plain list "
          f"({int((items != want).any(1).sum())} of {items.shape[0]} entries)")
    _compare(d, i, d_w, i_w, f"{kernel} {what}: the launch against the wrapper", atol=0.0)
    return int((want[:, 0] >= 0).sum())


def phase_kernel_random(dev):
    """The three triangle sets of tests/test_raster_pallas.py, a one-tile
    stack of 4P screen-covering triangles (4 pieces of K1's work list) and a
    one-tile set whose triangle k + 2P repeats triangle k, so exact depth
    ties fall in different pieces and the smaller id must win."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility_v2, xla_raster

    piece_rows = visibility_v2._library().vis_folded_piece_rows()
    ties = _stack_tris(2 * piece_rows, 4)
    cases = [("random600_seed11", _random_tris(600, 11), 128, 96),
             ("crossing40_seed21", _crossing_tris(40, 21), 160, 96),
             ("random300_seed1", _random_tris(300, 1), 256, 160),
             (f"stack{4 * piece_rows}_seed3", _stack_tris(4 * piece_rows, 3), 32, 32),
             (f"piece_ties{4 * piece_rows}_seed4", np.concatenate([ties, ties]), 32, 32)]
    err = 0.0
    for name, clip, w, h in cases:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        bins = binning.bin_triangles(s, w, h, 32, pair_capacity=8 * clip.shape[0])
        if name.startswith(("stack", "piece_ties")):
            check(int(bins.starts[-1]) == clip.shape[0],
                  f"{name}: {int(bins.starts[-1])} pairs, expected one per triangle")
        d_k, i_k = visibility_v2.vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x)
        d_p, i_p = visibility_v2.vis_folded_plain(bins.starts, bins.pair_data, bins.tiles_x)
        err = max(err, _compare(d_k, i_k, d_p, i_p, f"{name} (segment plain)"))
        _check_card_list("vis_folded", bins, name)
        d_b, i_b = xla_raster.rasterize_vis(s, w, h)
        d_u = visibility_v2.unfold_tiles(d_k, bins.tiles_y, bins.tiles_x, h, w)
        i_u = visibility_v2.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
        err = max(err, _compare(d_u, i_u, d_b, i_b, f"{name} (whole-screen plain)"))
        if name.startswith("piece_ties"):
            check(bool((i_k < 2 * piece_rows).all()), f"{name}: a tie kept the larger id")
        print(f"kernel vs plain: {name} {w}x{h} ok", flush=True)
    return err


def _check_hiz_items(items, bins, piece_rows, piece_major, what):
    """The work list that the hiz kernel built on the card against
    visibility_v2.aligned_work_list: the same entries (in tile-major order
    the same list; in piece-major order grouped by piece index, any order
    inside a group).  Returns the number of live entries."""
    from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as v2

    want = v2.aligned_work_list(bins.starts, piece_rows, items.shape[0], piece_major)
    check(tuple(items.shape) == tuple(want.shape), f"{what}: work list shape {items.shape}")
    if piece_major:
        st = bins.starts.to(torch.int64)

        def level(it):   # the piece's index in its tile; surplus entries last
            t = it[:, 0].to(torch.int64).clamp(min=0)
            lev = it[:, 1].to(torch.int64) // piece_rows - st[t] // piece_rows
            return torch.where(it[:, 0] >= 0, lev, 1 << 40)

        lev = level(items)
        check(bool((lev[1:] >= lev[:-1]).all()), f"{what}: work list not in piece-major order")
        key = lev * (st.shape[0] + 1) + items[:, 0]
        items = items[torch.argsort(key, stable=True)]
    check(bool((items == want).all()), f"{what}: the kernel's work list differs from "
          "aligned_work_list")
    return int((want[:, 0] >= 0).sum())


def phase_hiz_random(dev):
    """K1-hiz on z-ordered bins: the heavy-overdraw set of
    tests/test_raster_pallas.py:82-97 (its default 4 pairs per triangle),
    duplicated triangles, the crossing set, the slot-tie tile with its ties
    128, 256 and 384 rows apart (the later row holds the smaller id), the
    deep stack and a one-tile stack of 4P + 90 rows, P the kernel's piece
    length, that must leave blocks unwalked when one block walks the list
    serially (across a full grid the skip depends on timing).  Ids and depths exactly equal
    to the plain version; ids equal to the whole-screen brute force except on
    the slot-tie tiles, where the per-slot rule keeps the other id on the
    tied pixels, which all take the kernel's tie re-resolve."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility_v2, xla_raster

    lib = visibility_v2._hiz_library()
    piece_rows = lib.vis_folded_hiz_piece_rows()
    deep = 4 * piece_rows + 90
    cases = [("random600_seed11", _random_tris(600, 11), 128, 96, 4),
             ("dup200x3_seed7", _dup_tris(200, 7), 128, 96, 8),
             ("crossing40_seed21", _crossing_tris(40, 21), 160, 96, 8),
             ("slot_ties", _slot_tie_tris(), 32, 32, 4),
             ("slot_ties_256_apart", _slot_tie_tris(256), 32, 32, 4),
             ("slot_ties_384_apart", _slot_tie_tris(384), 32, 32, 4),
             ("stack600_seed5", _stack_tris(600, 5), 64, 64, 4),
             (f"deep_stack{deep}_seed9", _stack_tris(deep, 9), 32, 32, 2)]
    err = 0.0
    for name, clip, w, h, capf in cases:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        bins = binning.bin_triangles(s, w, h, 32, capf * clip.shape[0], 128, z_order=True)
        d_k, i_k = visibility_v2.vis_folded_hiz_tiles(bins.starts, bins.pair_data,
                                                      bins.chunk_minz, bins.tiles_x)
        d_p, i_p, walked_p = visibility_v2.vis_folded_hiz_plain(
            bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x, rows_walked=True)
        err = max(err, _compare(d_k, i_k, d_p, i_p, f"hiz {name} (segment plain)", atol=0.0))
        for piece_major in (True, False):
            d_k, i_k, stats, items = visibility_v2.run_vis_folded_hiz(
                lib, bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x, piece_major)
            _compare(d_k, i_k, d_p, i_p, f"hiz {name}, piece_major={piece_major}", atol=0.0)
            _check_hiz_items(items, bins, piece_rows, piece_major, f"hiz {name}")
        walked, marked = (int(x) for x in stats)
        total = int(bins.starts[-1])
        _, i_b = xla_raster.rasterize_vis(s, w, h)
        i_u = visibility_v2.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
        differ = int((i_u != i_b).sum())
        if name.startswith("slot_ties"):
            check(differ > 100, f"hiz {name}: {differ} ids differ from smallest-id, "
                  "expected the tied pixels (> 100)")
            check(marked >= differ, f"hiz {name}: {marked} pixels re-resolved, {differ} tied")
        else:
            check(differ == 0, f"hiz {name}: {differ} ids differ from the brute force")
        if name.startswith("deep_stack"):
            check(total == deep, f"hiz {name}: {total} pairs, expected one per triangle")
            d_s, i_s, stats, _ = visibility_v2.run_vis_folded_hiz(
                lib, bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x, max_blocks=1)
            _compare(d_s, i_s, d_p, i_p, f"hiz {name} (one block, serial)", atol=0.0)
            serial = int(stats[0])
            check(serial < total, f"hiz {name}: one block walked all {total} rows, no block "
                  "was skipped")
            print(f"  {name}: one block walks {serial} of {total} rows", flush=True)
        print(f"hiz kernel vs plain: {name} {w}x{h} ok (ids differing from the brute "
              f"force: {differ}; rows walked {walked} of {total}, serial walk "
              f"{int(walked_p.sum())}; pixels re-resolved {marked})", flush=True)
    return err


def phase_rowblock_random(dev):
    """K2 on the three triangle sets of tests/test_raster_pallas.py, on a
    set whose segments overflow tile_capacity (the capacity cut in force),
    and on one 32x128 tile: a stack of 4P screen-covering triangles (4
    pieces of K2's work list) and a set whose triangle k + 2P repeats
    triangle k, so exact depth ties fall in different pieces and the earlier
    pair must win."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility, xla_raster

    piece_rows = visibility._library().vis_rowblock_piece_rows()
    ties = _stack_tris(2 * piece_rows, 4)
    cases = [("random600_seed11", _random_tris(600, 11), 128, 96, 4096, 128),
             ("crossing40_seed21", _crossing_tris(40, 21), 160, 96, 4096, 128),
             ("random300_seed1", _random_tris(300, 1), 256, 160, 4096, 128),
             ("random300_seed1_cap64", _random_tris(300, 1), 256, 160, 64, 16),
             (f"stack{4 * piece_rows}_seed3", _stack_tris(4 * piece_rows, 3), 128, 32,
              4096, 128),
             (f"piece_ties{4 * piece_rows}_seed4", np.concatenate([ties, ties]), 128, 32,
              4096, 128)]
    err = 0.0
    for name, clip, w, h, cap, chunk in cases:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        bins = binning.bin_triangles(s, w, h, 32, 8 * clip.shape[0], chunk, fmt="wide16",
                                     tile_w=128)
        if name.startswith(("stack", "piece_ties")):
            check(int(bins.starts[-1]) == clip.shape[0] == 4 * piece_rows,
                  f"rowblock {name}: {int(bins.starts[-1])} pairs, expected one per triangle")
        d_k, i_k = visibility.vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x,
                                                 cap, chunk)
        d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x,
                                                 cap, chunk)
        err = max(err, _compare(d_k, i_k, d_p, i_p, f"rowblock {name} (segment plain)",
                                atol=0.0))
        _check_card_list("vis_rowblock", bins, name, cap, chunk)
        if name.startswith("piece_ties"):
            check(bool((i_k >= 0).all() and (i_k < 2 * piece_rows).all()),
                  f"rowblock {name}: a tie kept the later pair")
        max_seg = int(bins.max_segment)
        if max_seg <= cap:
            d_b, i_b = xla_raster.rasterize_vis(s, w, h)
            d_u = visibility.unfold_tiles(d_k, bins.tiles_y, bins.tiles_x, h, w)
            i_u = visibility.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
            err = max(err, _compare(d_u, i_u, d_b, i_b,
                                    f"rowblock {name} (whole-screen plain)"))
        else:
            print(f"  {name}: deepest segment {max_seg} > tile_capacity {cap}, "
                  "the capacity cut is in force", flush=True)
        print(f"rowblock kernel vs plain: {name} {w}x{h} ok", flush=True)
    return err


# the TriSetup fields the binning kernels read, each once per triangle
BIN_SETUP_FIELDS = ("adj", "z_vert", "c_z", "bbox", "z_mode", "valid")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bins_equal(got, want, what):
    """Every field of two TileBins bit for bit; returns the largest absolute
    difference over pair_data, chunk_minz, starts, max_segment and
    total_pairs (0 where the bits agree, NaN and inf included)."""
    check((got.tiles_x, got.tiles_y) == (want.tiles_x, want.tiles_y), f"{what}: tile grid")
    err = 0.0
    for f in ("pair_data", "starts", "chunk_minz", "max_segment", "total_pairs"):
        a, b = getattr(got, f), getattr(want, f)
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {f} is {a.dtype} {tuple(a.shape)}, plain {b.dtype} {tuple(b.shape)}")
        same = _bits(a) == _bits(b)
        diff = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
        diff = torch.where(same, 0.0, diff)
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        check(bool(same.all()), f"{what}: {f} differs from the plain version "
                                f"(max abs difference {err})")
    return err


def _bin_kwargs(cfg, cap):
    """bin_triangles' arguments for a raster pass of cfg (_pass_bins)."""
    if cfg.raster_kernel == "rowblock":
        return dict(tile=cfg.tile_h, pair_capacity=cap, chunk=cfg.tri_chunk, fmt="wide16",
                    tile_w=cfg.tile_w)
    return dict(tile=32, pair_capacity=cap, chunk=cfg.tri_chunk, z_order=cfg.raster_hiz)


def _bin_work_bytes(s, bins):
    """The bytes binning must move: each TriSetup field it reads (its
    inputs) read once, each output (the pair rows, starts, chunk_minz and
    the two i32 totals) written once.  The kernels' per-row (tile, slot,
    key) and 32-bit keys are intermediates of the implementation and lie
    outside it."""
    inputs = sum(getattr(s, f).numel() * getattr(s, f).element_size()
                 for f in BIN_SETUP_FIELDS)
    outputs = sum(t.numel() * t.element_size() for t in (
        bins.pair_data, bins.starts, bins.chunk_minz, bins.max_segment, bins.total_pairs))
    return inputs + outputs


def _flat_z(clip, z=0.5):
    """The same triangles with every vertex at one depth: every zq equal."""
    clip = clip.copy()
    clip[..., 2] = z * clip[..., 3]
    return clip


def _tiny_tris(n, seed, spread=0.9, size=0.02):
    """n small triangles (vertices within +-size of centres within +-spread):
    on a one-tile screen, one run of n pairs."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-spread, spread, (n, 1, 2))
    verts = center + rng.uniform(-size, size, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


# the binning stages timed alone (binning.STAGES), and the shared-memory
# sort lengths the sort stage is timed at on each real pass
BIN_STAGES = ("setup", "count", "scan", "scatter", "short_sort", "long_sort", "pack")
BIN_SORT_KEYS = (256, 1024, 4096)


def phase_binning(scene):
    """The binning kernels (csrc/binning.cu, through binning.bin_triangles)
    against binning.bin_triangles_plain on the card, every field bit for
    bit: the triangle sets of phase 3, a one-tile run of 30,000 pairs
    (longer than binning.SORT_KEYS), a set whose triangles share one zq and
    a 2304^2 screen (5,184 tiles) in slim13, slim13 with z_order and wide16
    on 32x128 tiles in chunks of 16, each whole, in a band of its lower
    half, with a pair capacity of n/4 (overflowing where the set has more
    pairs) and in a band below the screen (no pair); each whole case again
    with the sort's long paths forced (sort_keys 32, then radix_keys 40
    besides); then frame 0's real
    camera and sun passes of paths A (slim13), B (wide16, 32x128) and D
    (z_order), and the lower band of each camera pass.  On each real pass
    its longest segment and the tiles that took the long path, the
    wrapper's time as it is called (median and min of 5 x 20 calls), the
    same calls queued behind a device sleep (the device's time), each stage
    alone on the device (binning.STAGES), the sort stage at other
    shared-memory lengths, the plain version's time, and the bound
    (_bin_work_bytes over the HBM rate)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import (frame_inputs, init_frame_state,
                                                            make_camera)
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.config import (SUNTEMPLE_1080P, SUNTEMPLE_1080P_HIZ,
                                                      SUNTEMPLE_1080P_ROWBLOCK)
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup

    dev = "cuda"
    variants = (("slim13", dict()), ("slim13 z_order", dict(z_order=True)),
                ("wide16 32x128", dict(fmt="wide16", tile_w=128, chunk=16)))
    sets = [("random600_seed11", _random_tris(600, 11), 128, 96),
            ("crossing40_seed21", _crossing_tris(40, 21), 160, 96),
            ("random300_seed1", _random_tris(300, 1), 256, 160),
            ("stack512_seed3", _stack_tris(512, 3), 32, 32),
            ("tiny30000_seed13", _tiny_tris(30000, 13), 32, 32),
            ("equal_zq600_seed11", _flat_z(_random_tris(600, 11)), 128, 96),
            ("random3000_seed16_5184_tiles", _tiny_tris(3000, 16, 0.95, 0.03), 2304, 2304)]
    n_cases = n_overflow = n_long = n_merge = 0
    n_forced = {"radix": 0, "merge": 0}
    err = 0.0
    for name, clip, w, h in sets:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        n = clip.shape[0]
        for vname, kw in variants:
            for cname, rows, y0, cap in (("whole", h, 0, 8 * n),
                                         ("band", h - h // 2, h // 2, 8 * n),
                                         ("overflow", h, 0, n // 4), ("no pair", 32, h, 8 * n)):
                args = dict(kw, pair_capacity=cap, y_origin=y0)
                got = binning.bin_triangles(s, w, rows, **args)
                what = f"binning {name} {vname} {cname}"
                want = binning.bin_triangles_plain(s, w, rows, **args)
                err = max(err, _bins_equal(got, want, what))
                total = int(got.total_pairs)
                rows_cap = got.pair_data.shape[0] * got.pair_data.shape[1]
                check(total > 0 if cname == "whole" else total == 0 or cname != "no pair",
                      f"{what}: {total} pairs")
                n_overflow += total > rows_cap
                n_long += binning.long_path_tiles(got) > 0
                n_merge += binning.long_path_tiles(got, binning.RADIX_KEYS) > 0
                n_cases += 1
                if cname != "whole":
                    continue
                for forced, radix_keys in (("radix", binning.RADIX_KEYS), ("merge", 40)):
                    plan = binning._plan(s, w, rows, sort_keys=32, radix_keys=radix_keys,
                                         **args)
                    binning._launch(plan)
                    err = max(err, _bins_equal(plan.bins, want, f"{what}, {forced} forced"))
                    n_forced[forced] += binning.long_path_tiles(plan.bins, radix_keys if
                                                                forced == "merge" else 32) > 0
    check(n_overflow >= 8, f"binning: only {n_overflow} seeded cases overflow")
    check(n_long >= 3 and n_merge >= 3 and min(n_forced.values()) >= 8,
          f"binning: the long sort ran in {n_long} cases, its merge in {n_merge}, "
          f"forced {n_forced}")
    print(f"binning vs plain: {n_cases} seeded cases bit for bit ({n_overflow} overflowing, "
          f"{len(sets) * len(variants)} with no pair, {n_long} through the long sort, "
          f"{n_merge} through its merge); {len(sets) * len(variants)} whole cases again with "
          f"the long sort forced (sort_keys 32; {n_forced['radix']} took it) and with its "
          f"merge forced (radix_keys 40 besides; {n_forced['merge']} took it)", flush=True)

    cam = make_camera(*suntemple.camera_path(0.0), SUNTEMPLE_1080P, device=dev)
    out = {}
    for path, cfg in (("A", SUNTEMPLE_1080P), ("B", SUNTEMPLE_1080P_ROWBLOCK),
                      ("D", SUNTEMPLE_1080P_HIZ)):
        fi = frame_inputs(init_frame_state(cfg, dev), cam, SUN, cfg)
        tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
        sm = cfg.shadow_map_size
        kw = _bin_kwargs(cfg, cfg.pair_capacity_factor * scene.num_tris)
        passes = {"camera": (setup.setup_triangles(setup.transform_to_clip(
                      tri_pos, cam.clip_from_world, fi.jitter), cfg.width, cfg.height,
                      cull="back"), cfg.width, cfg.height),
                  "sun": (setup.setup_triangles(setup.transform_to_clip(
                      tri_pos, fi.sun_from_world), sm, sm, cull="none"), sm, sm)}
        for pname, (s, w, h) in passes.items():
            got = binning.bin_triangles(s, w, h, **kw)
            want = binning.bin_triangles_plain(s, w, h, **kw)
            err = max(err, _bins_equal(got, want, f"binning path {path} {pname} pass"))
            if pname == "camera":
                band = dict(kw, y_origin=h // 2)
                err = max(err, _bins_equal(binning.bin_triangles(s, w, h // 2, **band),
                                           binning.bin_triangles_plain(s, w, h // 2, **band),
                                           f"binning path {path} camera band y0={h // 2}"))
            ms_min, ms = cuda_ms(lambda: binning.bin_triangles(s, w, h, **kw))
            dev_min, dev_ms = cuda_ms(lambda: binning.bin_triangles(s, w, h, **kw), hold=True)
            plain_ms = cuda_ms(lambda: binning.bin_triangles_plain(s, w, h, **kw), reps=5,
                               rounds=3)[1]
            plan = binning._plan(s, w, h, **kw)
            binning._launch(plan)
            stages = {}
            for stage in BIN_STAGES:   # in order: each reads what the ones before wrote
                stages[stage] = cuda_ms(
                    lambda: binning._launch(plan, binning.STAGES[stage]), hold=True)[1]
            sort_at = {}
            for keys in BIN_SORT_KEYS:
                other = binning._plan(s, w, h, sort_keys=keys, **kw)
                binning._launch(other)
                err = max(err, _bins_equal(other.bins, want,
                                           f"binning path {path} {pname}, sort_keys {keys}"))
                sort_at[keys] = (cuda_ms(lambda: binning._launch(
                    other, binning.STAGES["short_sort"] | binning.STAGES["long_sort"]),
                    hold=True)[1], binning.long_path_tiles(got, keys))
            err = max(err, _bins_equal(plan.bins, want,
                                       f"binning path {path} {pname}, after the stage timings"))
            nbytes = _bin_work_bytes(s, got)
            bound_ms, bound_by = _bound(0, nbytes)
            st = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                      plain_ms=plain_ms, stage_ms=stages,
                      sort_ms_by_sort_keys={k: v[0] for k, v in sort_at.items()},
                      long_path_tiles=binning.long_path_tiles(got),
                      merge_tiles=binning.long_path_tiles(got, binning.RADIX_KEYS),
                      max_segment=int(got.max_segment), bound_ms=bound_ms, bound_by=bound_by,
                      bytes=nbytes, pairs=int(got.total_pairs), rows=plan.cap,
                      tiles=plan.n_tiles, fmt=kw.get("fmt", "slim13"),
                      z_order=kw.get("z_order", False))
            out[f"{path} {pname}"] = st
            print(f"binning vs plain: path {path} {pname} pass {w}x{h} ({st['fmt']}"
                  f"{', z_order' if st['z_order'] else ''}) bit for bit"
                  f"{' (and its lower band)' if pname == 'camera' else ''}; {st['pairs']} pairs "
                  f"in {plan.cap} rows, {plan.n_tiles} tiles, longest segment "
                  f"{st['max_segment']}, {st['long_path_tiles']} tiles on the long sort "
                  f"(sort_keys {binning.SORT_KEYS}), {st['merge_tiles']} merged (radix_keys "
                  f"{binning.RADIX_KEYS}); kernels {ms:.3f} ms median, "
                  f"{ms_min:.3f} min of {KERNEL_ROUNDS} x {KERNEL_REPS} calls; device "
                  f"{dev_ms:.3f} ms ({dev_min:.3f} min); plain {plain_ms:.3f} ms; bound "
                  f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
                  f"{100 * bound_ms / dev_ms:.1f}% of the bound on the device", flush=True)
            print("  stages alone on the device (ms): " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()) + f"; sum {sum(stages.values()):.4f}",
                flush=True)
            print("  sort stage by sort_keys: " + ", ".join(
                f"{k}: {v[0]:.4f} ms ({v[1]} long tiles)" for k, v in sort_at.items()),
                flush=True)
            del plan, other
        torch.cuda.empty_cache()
    print(f"binning vs plain: max abs difference {err} over every case", flush=True)
    return out, n_cases, err


def _pass_bins(scene, mat, size, cull, cfg, jitter=None):
    """Bins of one real raster pass in the format of cfg.raster_kernel."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup

    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    s = setup.setup_triangles(setup.transform_to_clip(tri_pos, mat, jitter),
                              size[0], size[1], cull=cull)
    return binning.bin_triangles(s, size[0], size[1],
                                 **_bin_kwargs(cfg, cfg.pair_capacity_factor * scene.num_tris))


def _real_passes(renderer, cam, sun_angle, cfg):
    """Frame 0's camera and sun pass bins in the format of cfg."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import frame_inputs

    scene = renderer.scene
    fi = frame_inputs(renderer.state, cam, sun_angle, renderer.cfg)
    return {
        "camera": _pass_bins(scene, cam.clip_from_world, (cfg.width, cfg.height), "back",
                             cfg, fi.jitter),
        "sun": _pass_bins(scene, fi.sun_from_world, (cfg.shadow_map_size,) * 2, "none", cfg),
    }


def phase_kernel_real(renderer, cam, sun_angle):
    """The real camera and sun passes through the kernel of
    renderer.cfg.raster_kernel (K1 or K2) against its plain version on every
    tile (K2: depth exactly equal too), and the kernel's time against the
    plain version's and its bound at both shapes, with its piece length P
    and work items."""
    from vulkan_pbr_renderer_tpu_torch.raster import visibility, visibility_v2

    cfg = renderer.cfg
    folded = cfg.raster_kernel != "rowblock"
    if not folded:
        def kernel(b):
            return visibility.vis_rowblock_tiles(b.starts, b.pair_data, b.tiles_x,
                                                 cfg.tile_capacity, cfg.tri_chunk)

        def plain(b):
            return visibility.vis_rowblock_plain(b.starts, b.pair_data, b.tiles_x,
                                                 cfg.tile_capacity, cfg.tri_chunk)
    else:
        def kernel(b):
            return visibility_v2.vis_folded_tiles(b.starts, b.pair_data, b.tiles_x)

        def plain(b):
            return visibility_v2.vis_folded_plain(b.starts, b.pair_data, b.tiles_x)
    passes = _real_passes(renderer, cam, sun_angle, cfg)
    out, err = {}, 0.0
    for name, bins in passes.items():
        seg = (bins.starts[1:] - bins.starts[:-1]).cpu().numpy()
        d_k, i_k = kernel(bins)
        d_p, i_p = plain(bins)
        if folded:
            err = max(err, _compare(d_k, i_k, d_p, i_p, f"folded {name} pass, every tile"))
            _check_card_list("vis_folded", bins, f"{name} pass")
            piece_rows = visibility_v2._library().vis_folded_piece_rows()
            walked = seg
            evals, nbytes = _k1_work(bins)
        else:
            err = max(err, _compare(d_k, i_k, d_p, i_p, f"rowblock {name} pass, every tile",
                                    atol=0.0))
            _check_card_list("vis_rowblock", bins, f"{name} pass", cfg.tile_capacity,
                             cfg.tri_chunk)
            piece_rows = visibility._library().vis_rowblock_piece_rows()
            lo, hi = visibility.capacity_ranges(bins.starts, cfg.tile_capacity, cfg.tri_chunk)
            walked = torch.clamp(hi - lo, min=0).cpu().numpy()
            evals, nbytes = _k2_work(bins, cfg.tile_capacity, cfg.tri_chunk)
        items = int(np.maximum(1, -(-walked // piece_rows)).sum())
        ms_min, ms = cuda_ms(lambda: kernel(bins))
        dev_min, dev_ms = cuda_ms(lambda: kernel(bins), hold=True)
        plain_ms = cuda_ms(lambda: plain(bins), reps=2, rounds=1)[0]
        bound_ms, bound_by = _bound(evals, nbytes)
        out[name] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                         plain_ms=plain_ms, tiles=int(seg.size),
                         pairs=int(bins.total_pairs), max_segment=int(seg.max()),
                         bound_ms=bound_ms, bound_by=bound_by, evaluations=evals,
                         piece_rows=piece_rows, work_items=items)
        print(f"{cfg.raster_kernel} kernel vs plain: {name} pass all {seg.size} tiles ok; "
              f"{int(bins.total_pairs)} pairs, deepest segment {int(seg.max())}; {items} work "
              f"items of at most P={piece_rows} rows, the list built on the card equal to the "
              f"plain list; {evals} evaluations; kernel as called (list build + raster) "
              f"{ms:.3f} ms median, {ms_min:.3f} min of {KERNEL_ROUNDS} x {KERNEL_REPS} calls, "
              f"device {dev_ms:.3f} ms ({dev_min:.3f} min); plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of the bound", flush=True)
    return out, err


def phase_hiz_real(renderer, cam, sun_angle):
    """K1-hiz on frame 0's real camera and sun passes: every tile against
    the plain version (ids and depths exact); its piece length, work items,
    the rows it walked beside the serial walk's and the pixels that took
    the tie re-resolve; the times of K1-hiz, of K1 on the same pass's
    id-ordered bins and of the plain version; and the pixels of both whole
    passes whose ids differ between K1-hiz and K1, split into exact depth
    ties (where the two tie rules may pick different ids) and the rest."""
    from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as v2

    cfg = renderer.cfg
    zpasses = _real_passes(renderer, cam, sun_angle, cfg)
    ipasses = _real_passes(renderer, cam, sun_angle, cfg.replace(raster_hiz=False))
    lib = v2._hiz_library()
    piece_rows = lib.vis_folded_hiz_piece_rows()

    def hiz(b):
        return v2.vis_folded_hiz_tiles(b.starts, b.pair_data, b.chunk_minz, b.tiles_x)

    def plain(b, rows_walked=False):
        return v2.vis_folded_hiz_plain(b.starts, b.pair_data, b.chunk_minz, b.tiles_x,
                                       group=64, rows_walked=rows_walked)

    def k1(b):
        return v2.vis_folded_tiles(b.starts, b.pair_data, b.tiles_x)

    out, err = {}, 0.0
    for name, zb in zpasses.items():
        ib = ipasses[name]
        check(bool((zb.starts == ib.starts).all()), f"hiz {name} pass: segments differ")
        seg = (zb.starts[1:] - zb.starts[:-1]).cpu().numpy()
        d_h, i_h = hiz(zb)
        d_p, i_p, walked = plain(zb, rows_walked=True)
        err = max(err, _compare(d_h, i_h, d_p, i_p, f"hiz {name} pass, every tile", atol=0.0))
        # the bound counts the rows of the serial walk, whatever this kernel walks
        evals, nbytes = _k1_work(zb, int(walked.sum()))
        nbytes += zb.chunk_minz.numel() * 4
        bound_ms, bound_by = _bound(evals, nbytes)
        _, _, stats, work_list = v2.run_vis_folded_hiz(lib, zb.starts, zb.pair_data,
                                                       zb.chunk_minz, zb.tiles_x)
        items = _check_hiz_items(work_list, zb, piece_rows, True, f"hiz {name} pass")
        kernel_walked, marked = (int(x) for x in stats)
        d_1, i_1 = k1(ib)
        differ = i_h != i_1
        ties = int((differ & (d_h == d_1)).sum())
        n_diff = int(differ.sum())
        check(n_diff == ties, f"hiz {name} pass: {n_diff - ties} ids differ from K1 outside "
              "exact depth ties")
        ms_min, ms = cuda_ms(lambda: hiz(zb))
        k1_min, k1_ms = cuda_ms(lambda: k1(ib))
        plain_ms = cuda_ms(lambda: plain(zb), reps=3, rounds=1)[0]
        out[name] = dict(ms=ms, ms_min=ms_min, k1_ms=k1_ms, k1_ms_min=k1_min,
                         plain_ms=plain_ms, tiles=int(seg.size),
                         pairs=int(zb.total_pairs), max_segment=int(seg.max()),
                         id_diff=n_diff, id_diff_ties=ties,
                         covered=int((i_1 >= 0).sum()), bound_ms=bound_ms,
                         bound_by=bound_by, evaluations=evals, rows_walked=kernel_walked,
                         rows_walked_serial=int(walked.sum()), marked_pixels=marked,
                         piece_rows=piece_rows, work_items=items)
        print(f"hiz kernel vs plain: {name} pass all {seg.size} tiles ok; "
              f"{int(zb.total_pairs)} pairs, deepest segment {int(seg.max())}; {items} work "
              f"items of at most P={piece_rows} rows; K1-hiz walked {kernel_walked} rows, the "
              f"serial walk {int(walked.sum())}; {marked} pixels took the tie re-resolve; "
              f"bound {bound_ms:.4f} ms ({bound_by}); K1-hiz {ms:.3f} ms median, {ms_min:.3f} "
              f"min, K1 {k1_ms:.3f} median, {k1_min:.3f} min of {KERNEL_ROUNDS} x "
              f"{KERNEL_REPS} launches, plain {plain_ms:.3f} ms; {100 * bound_ms / ms:.1f}% of "
              f"the bound; ids differ from K1 on {n_diff} of {int((i_1 >= 0).sum())} covered "
              f"pixels ({ties} at exact depth ties)", flush=True)
    return out, err


# ---------------------------------------------------------------------------
# phase 3b: the fast-GI ray kernel against its plain version


def _ray_inputs():
    """tests/test_torch_gi_ray_inputs.py: seed-made lanes of one fast-GI ray."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_gi_ray_inputs

    return test_torch_gi_ray_inputs


def _gi_work(args, work):
    """(flops, bytes) of one fast_ray_resolve call: the steps these lanes
    take (`work`, the plain version's live-lane counts) at GI_FLOPS each;
    each input byte read once (the tables, the matrices, the lanes) and rgb
    and status written once."""
    table, fgrid, trace_tbl, atlas, *mats, cam, pw, rd, pv, noise, fog, rp = args
    n = pw.numel() // 3
    tensors = [table, fgrid, *mats, cam, pw, rd, pv, noise, fog]
    if rp.screen:
        tensors += [trace_tbl, atlas]
    nbytes = sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t)) + 16 * n
    taps = 3 if rp.solid_taps >= 3 else rp.solid_taps
    work = dict(work, crossing=work.get("taps", 0) // taps, lane=n)
    return sum(GI_FLOPS[k] * v for k, v in work.items()), nbytes


def _gi_check(args, what):
    """The kernel against the plain version on the card: statuses that
    differ (at most GI_STATUS_SHARE of the lanes), rgb within GI_RGB_ATOL
    where they agree.  Returns stats with the plain version's work counts."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    rgb_k, st_k = gi.fast_ray_resolve(*args)
    lane_work = {}
    rgb_p, st_p = gi.fast_ray_resolve_plain(*args, work=lane_work)
    torch.cuda.synchronize()
    n = st_k.numel()
    same = st_k == st_p
    mismatch = n - int(same.sum())
    err = float((rgb_k - rgb_p).abs().amax(-1)[same].max()) if bool(same.any()) else 0.0
    check(bool(torch.isfinite(rgb_k).all()), f"gi_fast_ray {what}: non-finite rgb")
    check(mismatch <= GI_STATUS_SHARE * n, f"gi_fast_ray {what}: {mismatch} of {n} statuses "
          "differ from the plain version")
    check(err <= GI_RGB_ATOL, f"gi_fast_ray {what}: rgb error {err} > {GI_RGB_ATOL}")
    statuses = {int(k): int(v) for k, v in zip(*torch.unique(st_k, return_counts=True))}
    work = {k: int(v.sum()) for k, v in lane_work.items()}
    return dict(lanes=n, status_mismatch=mismatch, max_abs_err=err, statuses=statuses, work=work,
                lane_work=lane_work)


def phase_gi_random(dev):
    """gi_fast_ray against fast_ray_resolve_plain on seed-made lanes
    (tests/test_torch_gi_ray_inputs.py, a 16^3 grid): both rays at 16,384
    lanes, where every trace outcome occurs (lanes outside the grid, off screen, out of
    budget, resolved, and translucent crossings that re-arm), and the
    nearest march, no screen term and 3 solidity taps at 4,096.  Returns
    (max rgb error, statuses that differ, lanes)."""
    inputs = _ray_inputs()
    err, mismatch, lanes = 0.0, 0, 0
    cases = [("diffuse", 16384, False, {}), ("specular", 16384, True, {}),
             ("nearest march", 4096, True, dict(gi_fast_fog_trilinear=False)),
             ("no screen term", 4096, False, dict(gi_fast_screen_probe=False)),
             ("3 solidity taps", 4096, True, dict(gi_trace_solid_taps=3))]
    for i, (name, n, spec, changes) in enumerate(cases):
        arrays, scalars = inputs.random_rays(40 + i, n=n)
        st = _gi_check(inputs.ray_call_args(arrays, scalars, dev, spec=spec, **changes),
                       f"random {name}")
        del st["lane_work"]
        screen = changes.get("gi_fast_screen_probe", True)
        check(set(st["statuses"]) == ({1, 2, 3} if screen else {2}),
              f"gi_fast_ray random {name}: statuses {st['statuses']}")
        if screen:   # crossings beyond the resolved ones are translucent: they re-armed
            taps = 3 if changes.get("gi_trace_solid_taps", 1) >= 3 else 1
            rearmed = st["work"]["taps"] // taps - st["statuses"][3]
            check(rearmed > 0, f"gi_fast_ray random {name}: no crossing re-armed")
        err, mismatch, lanes = max(err, st["max_abs_err"]), mismatch + st["status_mismatch"], \
            lanes + st["lanes"]
        print(f"gi_fast_ray vs plain: random {name}, {n} lanes: statuses {st['statuses']}, "
              f"{st['status_mismatch']} differ; rgb max abs err {st['max_abs_err']:.3e}; "
              f"steps {st['work']}", flush=True)
    return err, mismatch, lanes


def capture_gi_calls(renderer, cams):
    """The arguments of both gi.fast_ray_resolve calls (diffuse, specular)
    of one steady frame (frame 1, sun unchanged) of renderer's path,
    captured from Renderer.render.  The renderer's temporal state is reset
    afterwards."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import init_frame_state
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls, kernel = [], gi.fast_ray_resolve

    @functools.wraps(kernel)    # carries the launch counter, which the wrapper counts on
    def record(*args):
        calls.append(args)
        return kernel(*args)

    renderer.render(cams[0], SUN)
    gi.fast_ray_resolve = record
    try:
        renderer.render(cams[1], SUN)
    finally:
        gi.fast_ray_resolve = kernel
        kernel.launches = record.launches
    renderer.state = init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    check(len(calls) == 2, f"gi_fast_ray real lanes: {len(calls)} calls in a frame, expected 2")
    return calls


def gi_simt(lane_work, lane_shape):
    """SIMT efficiency (gi.simt_efficiency) of the lanes taken in rows of
    32 and in the kernel's warp tiles: {"rows": x, "tiles": y, "tile_h": h}."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    rows, width = gi.lane_grid(lane_shape)
    tile_h = gi.lane_tile_h(rows)
    return {"rows": gi.simt_efficiency(lane_work, gi.lane_tiles(rows, width, 1)),
            "tiles": gi.simt_efficiency(lane_work, gi.lane_tiles(rows, width, tile_h)),
            "tile_h": tile_h}


def phase_gi_real(renderer, cams):
    """Both rays' real lanes of one steady frame of renderer's path
    (capture_gi_calls, full width): the kernel against the plain version,
    its time (median and min of KERNEL_ROUNDS x KERNEL_REPS launches), the
    plain version's, the bound, the SIMT efficiency of the lanes in rows and
    in the kernel's tiles, and the kernel's registers and resident blocks."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls = capture_gi_calls(renderer, cams)
    regs, blocks, threads = gi.ray_kernel_occupancy()
    out = {}
    for ray, args in zip(("diffuse", "specular"), calls):
        st = _gi_check(args, f"real {ray} lanes")
        simt = gi_simt(st.pop("lane_work"), args[8].shape[:-1])
        flops, nbytes = _gi_work(args, st["work"])
        bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
        ms_min, ms = cuda_ms(lambda: gi.fast_ray_resolve(*args))
        dev_min, dev_ms = cuda_ms(lambda: gi.fast_ray_resolve(*args), hold=True)
        plain_ms = cuda_ms(lambda: gi.fast_ray_resolve_plain(*args), reps=2, rounds=1)[0]
        out[ray] = dict(st, ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, flops=flops, bytes=nbytes,
                        lane_shape=list(args[8].shape[:-1]), simt=simt, registers=regs,
                        blocks_per_sm=blocks, threads=threads)
        print(f"gi_fast_ray vs plain: real {ray} lanes of path frame 1, {st['lanes']} lanes "
              f"{list(args[8].shape[:-1])}: statuses {st['statuses']}, {st['status_mismatch']} "
              f"differ; rgb max abs err {st['max_abs_err']:.3e}; steps {st['work']}; kernel "
              f"{ms:.4f} ms median, {ms_min:.4f} min of {KERNEL_ROUNDS} x {KERNEL_REPS} "
              f"launches (device alone {dev_ms:.4f} median, {dev_min:.4f} min); plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound "
              f"({100 * bound_ms / dev_ms:.1f}% of the device time); SIMT efficiency "
              f"{simt['rows']:.3f} in rows of 32, {simt['tiles']:.3f} in {simt['tile_h']}-row "
              f"tiles; {regs} registers, "
              f"{blocks} blocks of {threads} threads resident per SM; card {nvidia_smi()}",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3i: the reference GI's ray kernel against its plain version


def _reference_inputs():
    """tests/test_torch_reference_ray_inputs.py: seed-made lanes of one
    reference-GI ray."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_reference_ray_inputs

    return test_torch_reference_ray_inputs


def _ref_work(args, work):
    """(flops, bytes) of one reference_ray_resolve call: the steps and
    fetches these lanes need (`work`, the plain version's per-lane counts)
    at REF_FLOPS each, and the levels' decode once; each input byte read
    once (the table, the trace depth, the pyramid, the matrices, the lanes)
    and rgb and status written once."""
    *tensors, fog, _ = args
    n = args[9].numel() // 3
    nbytes = sum(t.numel() * t.element_size() for t in tensors + [fog] if torch.is_tensor(t))
    return (REF_DECODE_FLOPS + REF_FLOPS["lane"] * n
            + sum(REF_FLOPS[k] * v for k, v in work.items()), nbytes + 16 * n)


def _ref_check(args, what):
    """gi_reference_ray against reference_ray_resolve_plain on the card:
    statuses that differ (at most GI_STATUS_SHARE of the lanes), rgb within
    GI_RGB_ATOL where they agree.  Returns stats with the plain version's
    work counts (summed over the lanes)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    rgb_k, st_k = gi.reference_ray_resolve(*args)
    lane_work = {}
    rgb_p, st_p = gi.reference_ray_resolve_plain(*args, work=lane_work)
    torch.cuda.synchronize()
    n = st_k.numel()
    same = st_k == st_p
    mismatch = n - int(same.sum())
    err = float((rgb_k - rgb_p).abs().amax(-1)[same].max()) if bool(same.any()) else 0.0
    bits = mismatch == 0 and torch.equal(rgb_k.view(torch.int32), rgb_p.view(torch.int32))
    check(bool(torch.isfinite(rgb_k).all()), f"gi_reference_ray {what}: non-finite rgb")
    check(mismatch <= GI_STATUS_SHARE * n, f"gi_reference_ray {what}: {mismatch} of {n} "
          "statuses differ from the plain version")
    check(err <= GI_RGB_ATOL, f"gi_reference_ray {what}: rgb error {err} > {GI_RGB_ATOL}")
    statuses = {int(k): int(v) for k, v in zip(*torch.unique(st_k, return_counts=True))}
    work = {k: int(v.sum()) for k, v in lane_work.items()}
    return dict(lanes=n, status_mismatch=mismatch, max_abs_err=err, bit_equal=bits,
                statuses=statuses, work=work, lane_work=lane_work)


def ref_simt(lane_work, lane_shape):
    """Per-phase SIMT efficiency (gi.reference_simt) of reference lanes:
    the first design ("tile": each lane in its warp tile, three taps a
    crossing) and the kernel ("queue": its march queue and the taps the
    outcome needs)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    rows, width = gi.lane_grid(lane_shape)
    tiles = gi.lane_tiles(rows, width, gi.lane_tile_h(rows))
    return {"tile": gi.reference_simt(lane_work, tiles),
            "queue": gi.reference_simt(lane_work, tiles, queue=True)}


def phase_reference_random(dev):
    """gi_reference_ray against reference_ray_resolve_plain on the seeded
    sets of tests/test_torch_reference_ray_inputs.py (every status,
    translucent crossings, lanes that open no voxel, scalar and per-lane
    foggyness, a 7-step trace, a denser grid) and on a 24^3 grid with a
    full-resolution trace table.  Returns (max rgb error, statuses that
    differ, lanes, every case bit-equal)."""
    inputs = _reference_inputs()
    cases = [(name, inputs.set_call_args(name, dev)) for name, *_ in inputs.SETS]
    arrays, scalars = inputs.reference_rays(65, n=1001, d=24, th=96, tw=128)
    cases.append(("24^3 grid", inputs.reference_call_args(arrays, scalars, dev, spec=True)))
    err, mismatch, lanes, bits = 0.0, 0, 0, True
    for name, args in cases:
        st = _ref_check(args, f"random {name}")
        st.pop("lane_work")
        check(set(st["statuses"]) == {1, 2, 3},
              f"gi_reference_ray random {name}: statuses {st['statuses']}")
        err, mismatch = max(err, st["max_abs_err"]), mismatch + st["status_mismatch"]
        lanes, bits = lanes + st["lanes"], bits and st["bit_equal"]
        print(f"gi_reference_ray vs plain: random {name}, {st['lanes']} lanes: statuses "
              f"{st['statuses']}, {st['status_mismatch']} differ; rgb max abs err "
              f"{st['max_abs_err']:.3e}; bit-equal {st['bit_equal']}; steps {st['work']}",
              flush=True)
    return err, mismatch, lanes, bits


def capture_reference_calls(renderer, cams):
    """The arguments of both gi.reference_ray_resolve calls (diffuse,
    specular) of one steady frame (frame 1, sun unchanged) of renderer's
    path, captured from Renderer.render.  The renderer's temporal state is
    reset afterwards."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import init_frame_state
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls, kernel = [], gi.reference_ray_resolve

    @functools.wraps(kernel)    # carries the launch counter, which the wrapper counts on
    def record(*args):
        calls.append(args)
        return kernel(*args)

    renderer.render(cams[0], SUN)
    gi.reference_ray_resolve = record
    try:
        renderer.render(cams[1], SUN)
    finally:
        gi.reference_ray_resolve = kernel
        kernel.launches = record.launches
    renderer.state = init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    check(len(calls) == 2, f"gi_reference_ray real lanes: {len(calls)} calls in a frame, "
          "expected 2")
    return calls


def phase_reference_real(renderer, cams, name, rays=("diffuse", "specular")):
    """The reference rays' real lanes of one steady frame of renderer's path
    (capture_reference_calls, full width), the rays named: the kernel
    against the plain version, its time as called and the device's alone
    (median and min of KERNEL_ROUNDS x KERNEL_REPS launches), the plain
    version's, the bound, and the kernel's registers, local memory, ptxas
    spills and resident blocks."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls = dict(zip(("diffuse", "specular"), capture_reference_calls(renderer, cams)))
    occ = gi.reference_ray_occupancy(table_shape=calls["diffuse"][0].shape)
    check(occ["threads"] == 32 * gi.REF_BLOCK_TILES, f"gi_reference_ray: {occ['threads']} "
          f"threads a block, gi.reference_simt models {gi.REF_BLOCK_TILES} warp tiles")
    # the kernel's instances: the 128^3 table's and any other size's
    ptxas = {k: _ptxas_entry(BUILD_LOGS.get("gi_reference_ray", ""),
                             f"gi_reference_ray_kernelILi128ELi{g}E")
             for k, g in (("cube128", 128), ("any", 0))}
    out = {}
    for ray in rays:
        args = calls[ray]
        st = _ref_check(args, f"path {name} real {ray} lanes")
        simt = ref_simt(st.pop("lane_work"), args[9].shape[:-1])
        flops, nbytes = _ref_work(args, st["work"])
        bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
        ms_min, ms = cuda_ms(lambda: gi.reference_ray_resolve(*args))
        dev_min, dev_ms = cuda_ms(lambda: gi.reference_ray_resolve(*args), hold=True)
        plain_ms = cuda_ms(lambda: gi.reference_ray_resolve_plain(*args), reps=2, rounds=1)[0]
        shape = list(args[9].shape[:-1])
        out[ray] = dict(st, ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                        bytes=nbytes, lane_shape=shape, trace_depth=list(args[1].shape),
                        occupancy=occ, ptxas=ptxas, simt=simt)
        print(f"gi_reference_ray vs plain: path {name} frame 1, real {ray} lanes, {st['lanes']} "
              f"lanes {shape}, trace depth {list(args[1].shape)}: statuses {st['statuses']}, "
              f"{st['status_mismatch']} differ; rgb max abs err {st['max_abs_err']:.3e}; "
              f"bit-equal {st['bit_equal']}; steps {st['work']}; kernel {ms:.4f} ms median, "
              f"{ms_min:.4f} min of {KERNEL_ROUNDS} x {KERNEL_REPS} launches (device alone "
              f"{dev_ms:.4f} median, {dev_min:.4f} min); plain {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
              f"{100 * bound_ms / ms:.1f}% of the bound ({100 * bound_ms / dev_ms:.1f}% of the "
              f"device time); SIMT efficiency by phase "
              + "; ".join(f"{m}: " + ", ".join(f"{k} {v:.3f}" for k, v in simt[m].items())
                          for m in simt)
              + f"; {occ['registers']} registers, {occ['local_bytes']} B local, "
              f"ptxas {ptxas}, {occ['blocks_per_sm']} blocks of {occ['threads']} threads "
              f"resident per SM, {occ['shared_bytes']} B shared a block; card {nvidia_smi()}",
              flush=True)
    return out


def reference_launches(cfg, frames):
    """gi_reference_ray's launches over `frames` frames of cfg: one per ray,
    2 per frame, where the frame shades with the reference GI (not the fast
    GI, GI off or the lightgrid view)."""
    ref = cfg.enable_gi and cfg.gi_mode == "reference" and not cfg.visualize_lightgrid
    return 2 * frames if ref else 0


def _reference_entry(ref_random, paths):
    """The kernels line's gi_reference_ray entry: the diffuse ray's real
    lanes of path C (its specular ray and C-product's diffuse ray beside
    them), errors over every set checked, launches of every counted run."""
    err, mismatch, lanes, bits = ref_random
    c, sp, cp = (paths["C"]["reference_real"]["diffuse"], paths["C"]["reference_real"]["specular"],
                 paths["C-product"]["reference_real"]["diffuse"])
    for st in (c, sp, cp):
        err, mismatch, lanes = (max(err, st["max_abs_err"]), mismatch + st["status_mismatch"],
                                lanes + st["lanes"])
        bits = bits and st["bit_equal"]
    entry = {
        "name": "gi_reference_ray", "route": "cuda",
        "source": "vulkan_pbr_renderer_tpu_torch/csrc/gi_reference_ray.cu",
        "replaces": "vulkan_pbr_renderer_tpu/shade/gi.py:1520",
        "note": "not a Pallas kernel: the reference GI's hybrid march, XLA (fori_loop at "
                "gi.py:1672)",
        "wrapper": "reference_ray_resolve",
        "launches": paths["C"]["ref_launches"], "max_abs_err": err,
        "status_mismatch": mismatch, "lanes_checked": lanes, "bit_equal": bits,
        "ms": c["ms"], "ms_min": c["ms_min"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "share_of_bound": c["bound_ms"] / c["ms"], "library_ms": None,
        "device_ms": c["device_ms"], "device_ms_min": c["device_ms_min"],
        "device_share_of_bound": c["bound_ms"] / c["device_ms"],
        "shape": f"path C frame 1, diffuse ray, {c['lanes']} lanes {c['lane_shape']}",
        "path": "C", "flops": c["flops"], "bytes": c["bytes"], "steps": c["work"],
        "statuses": c["statuses"], "occupancy": c["occupancy"], "ptxas": c["ptxas"],
        "simt": {k: v["simt"] for k, v in (("C diffuse", c), ("C specular", sp),
                                             ("C-product diffuse", cp))},
        "launches_by_path": {k: v["ref_launches"] for k, v in paths.items()}}
    for prefix, st in (("specular_", sp), ("c_product_", cp)):
        entry.update({prefix + k: st[k] for k in (
            "ms", "ms_min", "device_ms", "device_ms_min", "plain_ms", "bound_ms", "bound_by",
            "flops", "bytes", "statuses", "lane_shape", "max_abs_err", "status_mismatch")})
        entry[prefix + "device_share_of_bound"] = st["bound_ms"] / st["device_ms"]
    return entry


# ---------------------------------------------------------------------------
# phase 3j: the fast GI's probe and hi-z screen terms and its economy mode


def _screen_inputs():
    """tests/test_torch_gi_screen_inputs.py: seed-made lanes of the screen
    kernels and the wrappers' calls."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_gi_screen_inputs

    return test_torch_gi_screen_inputs


def _screen_kernel(rp):
    return "gi_probe_ray" if rp.kind == "fast" else "gi_screen_ray"


def _screen_work(args, work):
    """(flops, bytes) of one screen kernel call (screen_ray_resolve_plain's
    arguments): the steps these lanes take (`work`, the plain version's
    per-lane counts) at SCREEN_FLOPS each; each input byte that the kernel
    can read counted once, and rgb and status written once.  Read whole:
    the table, the f16 grid, the probe depth, the matrices and the lanes.
    Of the hi-z atlas only the texels of levels 0..HIZ_MAX_LEVEL (the walk
    clamps its cells to a level's size, so never the unused rows); of the
    bf16 pyramid only the probe level's texels, or every level's with
    dist_mip > 0 (the per-lane level)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    table, fgrid, depth, atlas, cfw, wfc, vfw, cam, pw, rd, noise, fog, rp = args
    n = pw.numel() // 3
    tensors = [table, fgrid, cfw, wfc, vfw, cam, pw, rd, noise, fog]
    nbytes = sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t)) + 16 * n
    if rp.term == "hiz":
        nbytes += depth.element_size() * sum(
            max(rp.hiz_h >> lv, 1) * max(rp.hiz_w >> lv, 1)
            for lv in range(gi.HIZ_MAX_LEVEL + 1))
    elif rp.term is not None:
        nbytes += depth.numel() * depth.element_size()
    if rp.term is not None:
        levels = range(rp.prev_levels) if rp.dist_mip > 0.0 else (rp.probe_level,)
        nbytes += 3 * atlas.element_size() * sum(
            max(rp.prev_h >> lv, 1) * max(rp.prev_w >> lv, 1) for lv in levels)
    flops = SCREEN_FLOPS["lane"] * n + sum(SCREEN_FLOPS[k] * v for k, v in work.items())
    if rp.term == "hiz":
        flops += SCREEN_FLOPS["hiz_lane"] * n
    if rp.term == "probes" and rp.overshoot > 0.0:
        flops += SCREEN_FLOPS["overshoot"] * n
    if rp.term == "probes" and rp.solid_taps:
        flops += SCREEN_FLOPS["tap_point"] * (work.get("taps", 0) // rp.solid_taps)
    return flops, nbytes


def _screen_check(args, what):
    """A screen kernel (by rp.kind) against screen_ray_resolve_plain on the
    card: statuses equal and rgb bit for bit.  Returns stats with the plain
    version's work counts (summed, and per lane in lane_work)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    name = _screen_kernel(args[-1])
    rgb_k, st_k = _screen_inputs().wrapper_call(args)
    lane_work = {}
    rgb_p, st_p = gi.screen_ray_resolve_plain(*args, work=lane_work)
    torch.cuda.synchronize()
    n = st_k.numel()
    mismatch = int((st_k != st_p).sum())
    same = st_k == st_p
    err = float((rgb_k - rgb_p).abs().amax(-1)[same].max()) if bool(same.any()) else 0.0
    bits = mismatch == 0 and torch.equal(rgb_k.view(torch.int32), rgb_p.view(torch.int32))
    check(bool(torch.isfinite(rgb_k).all()), f"{name} {what}: non-finite rgb")
    check(bits, f"{name} {what}: not bit-equal to the plain version ({mismatch} of {n} "
          f"statuses differ, rgb max abs err {err})")
    statuses = {int(k): int(v) for k, v in zip(*torch.unique(st_k, return_counts=True))}
    work = {k: int(v.sum()) for k, v in lane_work.items()}
    return dict(lanes=n, status_mismatch=mismatch, max_abs_err=err, bit_equal=bits,
                statuses=statuses, work=work, lane_work=lane_work)


def phase_screen_random(dev):
    """gi_screen_ray and gi_probe_ray against screen_ray_resolve_plain on
    the seeded sets of tests/test_torch_gi_screen_inputs.py (every knob of
    the probes term: spacings, jitter, solidity taps, overshoot, to_stop,
    dist_mip, one point, the edge fallback off, the nearest march; the hi-z
    term with and without its solidity tap; the economy mode's quadrature,
    march_to_hit, its k-point and one-point probe and no screen term), bit
    for bit.  Returns {kernel: (max rgb error, statuses that differ, lanes,
    every case bit-equal)}."""
    inputs = _screen_inputs()
    out = {k: (0.0, 0, 0, True) for k in SCREEN_KERNELS}
    for name, *_ in inputs.SETS:
        args = inputs.set_call_args(name, dev)
        st = _screen_check(args, f"random {name}")
        st.pop("lane_work")
        rp = args[-1]
        want = {2} | ({3} if rp.term else set()) | ({1} if rp.term == "probes"
                                                    and rp.edge_fallback else set())
        check(set(st["statuses"]) == want, f"{_screen_kernel(rp)} random {name}: statuses "
              f"{st['statuses']}, expected {sorted(want)}")
        k = _screen_kernel(rp)
        e, m, lanes, bits = out[k]
        out[k] = (max(e, st["max_abs_err"]), m + st["status_mismatch"], lanes + st["lanes"],
                  bits and st["bit_equal"])
        print(f"{k} vs plain: random {name}, {st['lanes']} lanes: statuses {st['statuses']}; "
              f"bit-equal {st['bit_equal']}; steps {st['work']}", flush=True)
    return out


def capture_screen_calls(renderer, cams):
    """The arguments (screen_ray_resolve_plain's) of both calls (diffuse,
    specular) of gi.screen_ray_resolve or gi.probe_ray_resolve of one
    steady frame (frame 1, sun unchanged) of renderer's path, captured from
    Renderer.render.  The renderer's temporal state is reset afterwards."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import init_frame_state
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls = []
    wrappers = {"screen_ray_resolve": gi.screen_ray_resolve,
                "probe_ray_resolve": gi.probe_ray_resolve}

    def recorder(name, kernel):
        @functools.wraps(kernel)    # carries the launch counter
        def record(*args):
            if name == "probe_ray_resolve":
                table, depth, atlas, cfw, pw, rd, rp = args
                calls.append((table, None, depth, atlas, cfw, None, None, None, pw, rd, None,
                              None, rp))
            else:
                calls.append(args)
            return kernel(*args)
        return record

    renderer.render(cams[0], SUN)
    records = {k: recorder(k, fn) for k, fn in wrappers.items()}
    for k, fn in records.items():
        setattr(gi, k, fn)
    try:
        renderer.render(cams[1], SUN)
    finally:
        for k, fn in wrappers.items():
            setattr(gi, k, fn)
            fn.launches = records[k].launches
    renderer.state = init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    check(len(calls) == 2, f"screen kernels' real lanes: {len(calls)} calls in a frame, "
          "expected 2")
    return calls


def phase_screen_real(renderer, cams, name):
    """Both rays' real lanes of one steady frame of renderer's path
    (capture_screen_calls, full width): the kernel against the plain
    version bit for bit, its time as called and the device's alone (median
    and min of KERNEL_ROUNDS x KERNEL_REPS launches), the plain version's,
    the bound (SCREEN_FLOPS of the steps these lanes take, or every input
    byte once), the SIMT efficiency of the lanes' steps in the kernel's
    warp tiles, and the kernel's registers, local memory and resident
    blocks."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls = capture_screen_calls(renderer, cams)
    out = {}
    for ray, args in zip(("diffuse", "specular"), calls):
        rp = args[-1]
        kernel = _screen_kernel(rp)
        occ = gi.screen_ray_occupancy("probe" if rp.kind == "fast" else rp.term)
        st = _screen_check(args, f"path {name} real {ray} lanes")
        lane_work = st.pop("lane_work")
        shape = list(args[8].shape[:-1])
        rows, width = gi.lane_grid(tuple(shape))
        tiles = gi.lane_tiles(rows, width, gi.lane_tile_h(rows))
        # each kind of step as its loop runs, a warp to its longest lane
        done = issued = 0
        for counts in lane_work.values():
            if torch.is_tensor(counts):
                d, i = gi._issued(counts, tiles)
                done, issued = done + d, issued + i
        simt = done / issued if issued else 1.0
        flops, nbytes = _screen_work(args, st["work"])
        bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
        call = _screen_inputs().wrapper_call
        ms_min, ms = cuda_ms(lambda: call(args))
        dev_min, dev_ms = cuda_ms(lambda: call(args), hold=True)
        plain_ms = cuda_ms(lambda: gi.screen_ray_resolve_plain(*args), reps=2, rounds=1)[0]
        out[ray] = dict(st, kernel=kernel, ms=ms, ms_min=ms_min, device_ms=dev_ms,
                        device_ms_min=dev_min, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, flops=flops, bytes=nbytes, lane_shape=shape,
                        depth=list(args[2].shape), term=rp.term, occupancy=occ, simt=simt)
        print(f"{kernel} vs plain: path {name} frame 1, real {ray} lanes ({rp.kind} march, "
              f"term {rp.term}), {st['lanes']} lanes {shape}, depth {list(args[2].shape)}: "
              f"statuses {st['statuses']}; bit-equal {st['bit_equal']}; steps {st['work']}; "
              f"kernel {ms:.4f} ms median, {ms_min:.4f} min of {KERNEL_ROUNDS} x {KERNEL_REPS} "
              f"launches (device alone {dev_ms:.4f} median, {dev_min:.4f} min); plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound as called "
              f"({100 * bound_ms / dev_ms:.1f}% of the device time); SIMT efficiency of the "
              f"steps {simt:.3f}; {occ['registers']} registers, {occ['local_bytes']} B local, "
              f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads resident per SM; "
              f"card {nvidia_smi()}", flush=True)
    return out


def _screen_entries(screen_random, paths, sharded):
    """The kernels line's gi_screen_ray entry (path F's hi-z diffuse ray,
    its specular ray and path G's probes rays beside them) and gi_probe_ray
    entry (path E's diffuse ray, its specular ray beside it): errors over
    every set checked, launches of every counted run."""
    entries = []
    for kernel, main, others, source_lines in (
            ("gi_screen_ray", ("F", "diffuse"), (("F", "specular"), ("G", "diffuse"),
                                                 ("G", "specular")),
             ("vulkan_pbr_renderer_tpu/shade/gi.py:1391", "vulkan_pbr_renderer_tpu/shade/gi.py:806",
              "vulkan_pbr_renderer_tpu/shade/gi.py:1258", "vulkan_pbr_renderer_tpu/shade/gi.py:398")),
            ("gi_probe_ray", ("E", "diffuse"), (("E", "specular"),),
             ("vulkan_pbr_renderer_tpu/shade/gi.py:648", "vulkan_pbr_renderer_tpu/shade/gi.py:778",
              "vulkan_pbr_renderer_tpu/shade/gi.py:806", "vulkan_pbr_renderer_tpu/shade/gi.py:1470"))):
        err, mismatch, lanes, bits = screen_random[kernel]
        m = paths[main[0]]["screen_real"][main[1]]
        rest = {f"{p} {r}": paths[p]["screen_real"][r] for p, r in others}
        for st in [m, *rest.values()]:
            err, mismatch, lanes = (max(err, st["max_abs_err"]), mismatch + st["status_mismatch"],
                                    lanes + st["lanes"])
            bits = bits and st["bit_equal"]
        entry = {
            "name": kernel, "route": "cuda",
            "source": "vulkan_pbr_renderer_tpu_torch/csrc/gi_screen_ray.cu",
            "replaces": source_lines[0], "replaces_also": list(source_lines[1:]),
            "note": "not a Pallas kernel: " + (
                "the fast GI's fog march with the hi-z (gi.py:1391) or probes (gi.py:806) "
                "screen term, XLA (gi_modes.py:292-354)" if kernel == "gi_screen_ray" else
                "the economy mode's ray, XLA (gi_modes.py:403)"),
            "wrapper": "screen_ray_resolve" if kernel == "gi_screen_ray" else "probe_ray_resolve",
            "launches": paths[main[0]]["screen_launches"][kernel], "max_abs_err": err,
            "status_mismatch": mismatch, "lanes_checked": lanes, "bit_equal": bits,
            "ms": m["ms"], "ms_min": m["ms_min"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "share_of_bound": m["bound_ms"] / m["ms"], "library_ms": None,
            "device_ms": m["device_ms"], "device_ms_min": m["device_ms_min"],
            "device_share_of_bound": m["bound_ms"] / m["device_ms"],
            "shape": f"path {main[0]} frame 1, {main[1]} ray (term {m['term']}), {m['lanes']} "
                     f"lanes {m['lane_shape']}",
            "path": main[0], "flops": m["flops"], "bytes": m["bytes"], "steps": m["work"],
            "statuses": m["statuses"], "occupancy": m["occupancy"], "simt": m["simt"],
            "launches_by_path": {k: v["screen_launches"][kernel] for k, v in paths.items()},
            "launches_sharded": {k: v["screen_launches"][kernel] for k, v in sharded.items()}}
        for tag, st in rest.items():
            prefix = tag.replace(" ", "_") + "_"
            entry.update({prefix + k: st[k] for k in (
                "ms", "ms_min", "device_ms", "device_ms_min", "plain_ms", "bound_ms", "bound_by",
                "flops", "bytes", "statuses", "lane_shape", "term", "simt")})
            entry[prefix + "device_share_of_bound"] = st["bound_ms"] / st["device_ms"]
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# phase 3d: the post stack's kernels (csrc/post.cu)


def post_launches(cfg, frames, sharded=False):
    """The post stack's launches over `frames` frames of cfg: per frame one
    TAA launch, one launch of the whole down chain (the row-sharded frame:
    bloom_pass_count per-level down launches instead) and one launch of the
    whole up chain, whose last level tonemaps (the row-sharded frame's too,
    over its rows); bloom off, one tonemap launch of the per-level up
    kernel instead."""
    passes = cfg.bloom_pass_count if cfg.enable_bloom else 0
    return {"taa_resolve": frames if cfg.enable_taa else 0,
            "bloom_down_chain": 0 if sharded else frames * (passes > 0),
            "bloom_down_level": frames * passes if sharded else 0,
            "bloom_up_chain": frames * (passes > 0),
            "bloom_up_level": frames * (passes == 0)}


def _post_err(got, want, what, atol):
    """Max abs difference of a kernel's result from its plain version's,
    held to atol; (err, bit_equal), bit_equal None where the case is held to
    POST_ODD_ATOL (an odd-size level)."""
    check(tuple(got.shape) == tuple(want.shape), f"{what}: shape {tuple(got.shape)}, "
          f"expected {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    check(err <= atol, f"{what}: max abs err {err} > {atol}")
    same = bool(torch.equal(got, want))
    return err, (same if atol < POST_ODD_ATOL else None)


def _atlas_err(got, want, what, exact=True):
    """The bf16 atlas a chain's down launches wrote against
    pack_mip_atlas(plain levels).to(bfloat16): equal, or within one bf16
    step where an odd-size level's f32 texel rounds the other way."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= POST_ATLAS_RTOL * want.float().abs() + POST_ODD_ATOL).all())
    check(ok, f"{what}: atlas off by {float(d.max())}")
    return float(d.max()), (bool(torch.equal(got.view(torch.int16), want.view(torch.int16)))
                            if exact else None)


def _post_taa_args(mode):
    return dict(catmull_history=mode != "bilinear", full_rgb_catmull=mode == "full_rgb")


def _taa_case(ins, mode, what, window=None, halo_rows=None):
    """taa_resolve on the card against taa_resolve_plain: whole, a row
    window, or the halo API on a band.  Returns (err, bit_equal)."""
    from vulkan_pbr_renderer_tpu_torch.gpu import sampling
    from vulkan_pbr_renderer_tpu_torch.shade import taa

    kw = _post_taa_args(mode)
    if window is not None:
        kw.update(row_begin=window[0], row_count=window[1])
        want = taa.taa_resolve_plain(*[sampling.edge_rows(t, window[0], window[1], 1, 1)
                                       for t in ins[:3]], *ins[3:], halo=1,
                                     row_offset=window[0], full_height=ins[0].shape[0],
                                     **_post_taa_args(mode))
        got = taa.taa_resolve(*ins, **kw)
    elif halo_rows is not None:
        y0, rows = halo_rows
        band = [sampling.edge_rows(t, y0, rows, 1, 1) for t in ins[:3]] + list(ins[3:])
        hk = dict(kw, halo=1, row_offset=y0, full_height=ins[0].shape[0])
        got, want = taa.taa_resolve(*band, **hk), taa.taa_resolve_plain(*band, **hk)
    else:
        got, want = taa.taa_resolve(*ins, **kw), taa.taa_resolve_plain(*ins, **kw)
    return _post_err(got, want, f"taa_resolve {what}", POST_EXACT_ATOL)


def _down_plain_chain(hdr, passes):
    from vulkan_pbr_renderer_tpu_torch.shade import bloom

    sizes = bloom.chain_sizes(hdr.shape[0], hdr.shape[1], passes)
    downs, cur = [], hdr
    for i in range(1, passes + 1):
        cur = bloom.bloom_down_level_plain(cur, *sizes[i], i == 1)
        downs.append(cur)
    return downs


def _up_levels(deepest, h, w, passes, strength, base, exposure, rows):
    """The up chain as per-level bloom_up_level launches."""
    from vulkan_pbr_renderer_tpu_torch.shade import bloom

    sizes = bloom.chain_sizes(h, w, passes)
    cur = deepest
    for i in range(passes - 1, 0, -1):
        cur = bloom.bloom_up_level(cur, *sizes[i], 1.0)
    return bloom.bloom_up_level(cur, h, w, strength, base=base, exposure=exposure, rows=rows)


def _bloom_case(hdr, passes, what, exposure=1.0):
    """One chain on the card against the plain versions, level by level on
    the plain version's inputs (bits at 2:1, POST_ODD_ATOL at odd sizes),
    the atlas the down launches wrote, and the fused final level; the
    one-launch down chain against the plain chain (bits while the chain is
    2:1, POST_ODD_ATOL from its first odd level on), its atlas, and against
    per-level launches on its own levels (bits); the one-launch up chain
    from the plain chain's deepest level, whole and over two row windows of
    its last level (one starting on an odd row), against the plain chain
    (bits where every level is exactly 2x, POST_ODD_ATOL where one takes the
    linear resize) and against per-level launches (bits).  Returns
    {(kernel): (err, bit_equal)}."""
    from vulkan_pbr_renderer_tpu_torch.gpu import sampling
    from vulkan_pbr_renderer_tpu_torch.shade import bloom

    h, w = hdr.shape[:2]
    sizes = bloom.chain_sizes(h, w, passes)
    plain = _down_plain_chain(hdr, passes)
    atlas, offs = bloom.new_atlas(h, w, passes, hdr.device)
    errs = {"down": [], "up": []}
    for i in range(1, passes + 1):
        src = hdr if i == 1 else plain[i - 2].contiguous()   # an einsum's output is not
        got = bloom.bloom_down_level(src, *sizes[i], i == 1, atlas=atlas, atlas_col=offs[i - 1])
        exact = tuple(src.shape[:2]) == (2 * sizes[i][0], 2 * sizes[i][1])
        errs["down"].append(_post_err(got, plain[i - 1], f"bloom_down {what} level {i} "
                                      f"{tuple(src.shape[:2])}->{sizes[i]}",
                                      POST_EXACT_ATOL if exact else POST_ODD_ATOL))
    chain_exact = all(sizes[i - 1] == (2 * sizes[i][0], 2 * sizes[i][1])
                      for i in range(1, passes + 1))
    errs["atlas"] = _atlas_err(atlas, sampling.pack_mip_atlas(plain).to(torch.bfloat16),
                               f"bloom_down {what}", chain_exact)
    chain_atlas, level_atlas = torch.full_like(atlas, 7.0), torch.full_like(atlas, 7.0)
    chain = bloom.bloom_down_chain(hdr, passes, chain_atlas, offs)
    errs["chain"], exact, cur = [], True, hdr
    for i in range(1, passes + 1):
        exact = exact and sizes[i - 1] == (2 * sizes[i][0], 2 * sizes[i][1])
        errs["chain"].append(_post_err(chain[i - 1], plain[i - 1],
                                       f"bloom_down_chain {what} level {i}",
                                       0.0 if exact else POST_ODD_ATOL))
        cur = bloom.bloom_down_level(cur, *sizes[i], i == 1, atlas=level_atlas,
                                     atlas_col=offs[i - 1])
        check(torch.equal(chain[i - 1], cur),
              f"bloom_down_chain {what} level {i}: not the per-level launches' bits")
    errs["chain_atlas"] = _atlas_err(chain_atlas,
                                     sampling.pack_mip_atlas(plain).to(torch.bfloat16),
                                     f"bloom_down_chain {what}", chain_exact)
    check(torch.equal(chain_atlas.view(torch.int16), level_atlas.view(torch.int16)),
          f"bloom_down_chain {what}: atlas not the per-level launches' bits")
    if chain_exact:
        check(errs["chain_atlas"][1], f"bloom_down_chain {what}: atlas not bit-equal")
    cur = plain[-1].contiguous()
    for i in range(passes - 1, -1, -1):
        final = i == 0
        kw = dict(base=hdr, exposure=exposure) if final else {}
        factor = 0.06 if final else 1.0
        got = bloom.bloom_up_level(cur, *sizes[i], factor, **kw)
        want = bloom.bloom_up_level_plain(cur, *sizes[i], factor, **kw)
        exact = sizes[i] == (2 * cur.shape[0], 2 * cur.shape[1])
        errs["up"].append(_post_err(got, want, f"bloom_up {what} level {i} "
                                    f"{tuple(cur.shape[:2])}->{sizes[i]}"
                                    f"{' + tonemap' if final else ''}",
                                    POST_EXACT_ATOL if exact else POST_ODD_ATOL))
        cur = bloom.bloom_up_level_plain(cur, *sizes[i], 1.0).contiguous()
    up_exact = all(sizes[i] == (2 * sizes[i + 1][0], 2 * sizes[i + 1][1])
                   for i in range(passes))
    errs["up_chain"] = []
    for win in (None, (0, h // 2), (h // 3 | 1, h // 3)):
        rb, rc = win if win is not None else (0, h)
        args = (plain[-1].contiguous(), h, w, passes, 0.06, hdr[rb:rb + rc], exposure, win)
        got = bloom.bloom_up_chain(*args)
        errs["up_chain"].append(_post_err(got, bloom.bloom_up_chain_plain(*args),
                                          f"bloom_up_chain {what} rows {win}",
                                          0.0 if up_exact else POST_ODD_ATOL))
        check(torch.equal(got, _up_levels(*args)),
              f"bloom_up_chain {what} rows {win}: not the per-level launches' bits")
    return errs


def _fold(errs):
    """(max err, every bit-held case bit-equal)."""
    return max(e for e, _ in errs), all(s for _, s in errs if s is not None)


def phase_post(dev):
    """The post kernels against their plain versions on the card, on
    seed-made inputs: TAA at 1920x1088 in the three history modes (whole,
    row windows at the frame's top, middle and bottom edges, the halo API)
    and at 160x96; bloom chains at 2:1 (1920x1088, 6 passes; 64x64 down to
    1x1, 6 passes) and with odd sizes (1920x1080, 6 passes; 240x135, 4;
    96x54, 3), the down and up levels one launch each and each chain as one
    launch (_bloom_case); level 1 and the final level over row windows; a
    level that writes its source's atlas band; bloom off (the tonemap
    alone).  Returns {kernel: (max abs err, bit_equal at 2:1 and TAA)}."""
    from vulkan_pbr_renderer_tpu_torch.shade import bloom

    rng = np.random.default_rng(13)
    out = {"taa_resolve": [], "bloom_down": [], "bloom_down_level": [], "bloom_up": [],
           "bloom_up_level": []}
    for (h, w) in POST_TAA_SIZES:
        ins = [torch.from_numpy(a).to(dev) for a in (
            rng.uniform(0, 4, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32),
            rng.normal(0, 0.01, (h, w, 2)).astype(np.float32),
            rng.normal(0, 0.01, (h, w, 2)).astype(np.float32),
            rng.uniform(0, 4, (h, w, 3)).astype(np.float32))]
        for mode in ("ycocg", "full_rgb", "bilinear"):
            cases = [_taa_case(ins, mode, f"{w}x{h} {mode}")]
            for win in ((0, h // 4), (h // 4, h // 2), (h - h // 4, h // 4)):
                cases.append(_taa_case(ins, mode, f"{w}x{h} {mode} rows {win}", window=win))
            cases.append(_taa_case(ins, mode, f"{w}x{h} {mode} halo band",
                                   halo_rows=(h // 2, h // 4)))
            # far reprojections (sigma 0.2 uv) and a third of the frame off
            # screen
            far = list(ins)
            far[2] = torch.from_numpy(rng.normal(0, 0.2, (h, w, 2)).astype(np.float32)).to(dev)
            far[2][:, : w // 3, 0] = 1.5
            cases.append(_taa_case(far, mode, f"{w}x{h} {mode} sigma 0.2, off screen"))
            cases.append(_taa_case(far, mode, f"{w}x{h} {mode} sigma 0.2, off screen, rows",
                                   window=(h // 3 | 1, h // 3)))
            out["taa_resolve"] += cases
            print(f"post vs plain: taa_resolve {w}x{h} {mode}: whole, 3 row windows, halo band, "
                  f"far and off-screen reprojection (whole, an odd row window): max abs err "
                  f"{_fold(cases)[0]:.3e}, bit-equal {_fold(cases)[1]}", flush=True)
    for (h, w), passes in POST_CHAINS:
        hdr = torch.from_numpy(rng.uniform(0, 3, (h, w, 3)).astype(np.float32)).to(dev)
        errs = _bloom_case(hdr, passes, f"{w}x{h}/{passes}")
        out["bloom_down_level"] += errs["down"] + [errs["atlas"]]
        out["bloom_down"] += errs["chain"] + [errs["chain_atlas"]]
        out["bloom_up_level"] += errs["up"]
        out["bloom_up"] += errs["up_chain"]
        print(f"post vs plain: bloom {w}x{h}, {passes} passes: down levels max abs err "
              f"{_fold(errs['down'])[0]:.3e} (bit-equal {_fold(errs['down'])[1]}), atlas "
              f"{errs['atlas'][0]:.3e} (bit-equal {errs['atlas'][1]}); down chain (one launch) "
              f"{_fold(errs['chain'])[0]:.3e} (bit-equal {_fold(errs['chain'])[1]}), atlas "
              f"{errs['chain_atlas'][0]:.3e} (bit-equal {errs['chain_atlas'][1]}), equal to the "
              f"level launches; up levels max abs err "
              f"{_fold(errs['up'])[0]:.3e} (bit-equal {_fold(errs['up'])[1]}); up chain (one "
              f"launch; whole, 2 row windows) {_fold(errs['up_chain'])[0]:.3e} (bit-equal "
              f"{_fold(errs['up_chain'])[1]}), equal to the level launches", flush=True)
    # row windows (the sharded frame's), a source band, bloom off
    h, w = POST_TAA_SIZES[0]
    hdr = torch.from_numpy(rng.uniform(0, 3, (h, w, 3)).astype(np.float32)).to(dev)
    sizes = bloom.chain_sizes(h, w, 2)
    d1 = bloom.bloom_down_level_plain(hdr, *sizes[1], True)
    for win in ((0, h // 4), (h // 4, h // 4)):
        out["bloom_down_level"].append(_post_err(
            bloom.bloom_down_level(hdr, *sizes[1], True, rows=win),
            bloom.bloom_down_level_plain(hdr, *sizes[1], True, rows=win),
            f"bloom_down level 1 rows {win}", POST_EXACT_ATOL))
    for win in ((0, h // 2), (h // 2, h // 2)):
        base = hdr[win[0]:win[0] + win[1]]
        kw = dict(base=base, exposure=1.0, rows=win)
        out["bloom_up_level"].append(_post_err(bloom.bloom_up_level(d1, h, w, 0.06, **kw),
                                               bloom.bloom_up_level_plain(d1, h, w, 0.06, **kw),
                                               f"bloom_up final rows {win}", POST_EXACT_ATOL))
    out["bloom_up_level"].append(_post_err(
        bloom.bloom_up_level(None, h, w, base=hdr, exposure=1.2),
        bloom.bloom_up_level_plain(None, h, w, base=hdr, exposure=1.2),
        "bloom_up tonemap only (bloom off)", POST_EXACT_ATOL))
    atlas_k, offs = bloom.new_atlas(h, w, 2, dev)
    atlas_p = atlas_k.clone()
    bloom.bloom_down_level(d1, *sizes[2], atlas=atlas_k, atlas_col=offs[1], src_atlas_col=offs[0])
    bloom.bloom_down_level_plain(d1, *sizes[2], atlas=atlas_p, atlas_col=offs[1],
                                 src_atlas_col=offs[0])
    out["bloom_down_level"].append(_atlas_err(atlas_k, atlas_p, "bloom_down source band"))
    torch.cuda.synchronize()
    res = {k: _fold(v) for k, v in out.items()}
    print(f"post vs plain: windows, source band, bloom off ok; seeded max abs err "
          f"{ {k: f'{v[0]:.3e}' for k, v in res.items()} }, bit-equal at 2:1 and TAA "
          f"{ {k: v[1] for k, v in res.items()} }", flush=True)
    return res


def capture_post_call(renderer, cams):
    """post_stack's inputs in one steady frame (frame 1, sun unchanged) of
    renderer's path, captured from Renderer.render: (hdr, depth, velocity,
    velocity_prev, history).  The renderer's temporal state is reset
    afterwards."""
    from vulkan_pbr_renderer_tpu_torch.app import renderer as rmod

    calls, post = [], rmod.post_stack

    def record(hdr, depth, velocity, state, cfg):
        calls.append((hdr, depth, velocity, state.velocity_prev,
                      hdr if state.frame_idx == 0 else state.taa_history))
        return post(hdr, depth, velocity, state, cfg)

    renderer.render(cams[0], SUN)
    rmod.post_stack = record
    try:
        renderer.render(cams[1], SUN)
    finally:
        rmod.post_stack = post
    renderer.state = rmod.init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    check(len(calls) == 1, f"post real inputs: {len(calls)} calls in a frame, expected 1")
    return calls[0]


def _library_down(x, dst_h, dst_w, weight):
    """The library call beside bloom_down (timed, used nowhere in the port):
    a replicate pad and a 6x6 stride-2 depthwise F.conv2d, the 13-tap filter
    at exact 2:1 (borders clamp at full resolution, not at half)."""
    import torch.nn.functional as F

    xin = x.permute(2, 0, 1)[None]
    return F.conv2d(F.pad(xin, (2, 2, 2, 2), mode="replicate"), weight, stride=2, groups=3)


def _down_filter(dev):
    """The 13 taps as one 6x6 filter over source texels [2i-2, 2i+4)."""
    taps = [(0, 0, 0.125)] + [(dx, dy, 0.03125) for dx in (-2, 2) for dy in (-2, 2)] + [
        (0, -2, 0.0625), (-2, 0, 0.0625), (2, 0, 0.0625), (0, 2, 0.0625)] + [
        (dx, dy, 0.125) for dx in (-1, 1) for dy in (-1, 1)]
    f = np.zeros((6, 6), np.float32)
    for dx, dy, wt in taps:
        f[dy + 2:dy + 4, dx + 2:dx + 4] += 0.25 * wt
    return torch.from_numpy(np.repeat(f[None, None], 3, 0)).to(dev)


def _library_up(deepest, sizes, strength, base, exposure, weights):
    """The library chain beside bloom_up (timed, used nowhere in the port):
    per level a bilinear F.interpolate (scale 2 where the level is exactly
    2x, else to its size), a replicate pad of 3 and a depthwise 3x3
    F.conv2d with dilation 3 and the tent weights x factor / 16 (weights:
    (intermediate, last)); then base + the last level and the tonemap."""
    import torch.nn.functional as F

    from vulkan_pbr_renderer_tpu_torch.utils import color as colorlib

    x = deepest.permute(2, 0, 1)[None]
    for i in range(len(sizes) - 2, -1, -1):
        sh, sw = x.shape[-2:]
        if sizes[i] == (2 * sh, 2 * sw):
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        else:
            x = F.interpolate(x, size=sizes[i], mode="bilinear", align_corners=False)
        x = F.conv2d(F.pad(x, (3, 3, 3, 3), mode="replicate"), weights[i == 0], dilation=3,
                     groups=3)
    return colorlib.gamma_encode(colorlib.aces_approx(exposure * (base + x[0].permute(1, 2, 0))))


def _tent_filter(factor, dev):
    """The 9 tent taps x factor / 16 as one 3x3 depthwise filter."""
    t = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]).astype(np.float32) * np.float32(factor / 16.0)
    return torch.from_numpy(np.repeat(t[None, None], 3, 0)).to(dev)


def phase_post_real(hdr, depth, velocity, velocity_prev, history, cfg):
    """The post kernels on path A's real post inputs (one steady frame at
    full width): against their plain versions, each kernel's time (median
    and min of KERNEL_ROUNDS x KERNEL_REPS launches as the wrapper's calls
    come, and the device's time alone behind a device sleep), the plain
    version's, the bound from this run's bytes and operations, and the
    library chains' (bloom_down: pad + conv2d; bloom_up: interpolate, pad
    and dilated conv2d, the add and the tonemap, and its max abs diff from
    the plain chain).  The bloom rows time a frame's chain: one launch
    (bloom_down, bloom_up) or bloom_pass_count per-level launches
    (bloom_down_level, bloom_up_level)."""
    from vulkan_pbr_renderer_tpu_torch.gpu import sampling
    from vulkan_pbr_renderer_tpu_torch.shade import bloom, taa

    h, w = hdr.shape[:2]
    passes = cfg.bloom_pass_count
    sizes = bloom.chain_sizes(h, w, passes)
    ins = (hdr, depth, velocity, velocity_prev, history)
    kw = dict(blend=cfg.taa_blend, velocity_rejection=cfg.taa_velocity_rejection,
              catmull_history=cfg.taa_catmull_history, full_rgb_catmull=cfg.taa_full_rgb_catmull)
    taa_k = taa.taa_resolve(*ins, **kw)
    taa_p = taa.taa_resolve_plain(*ins, **kw)
    taa_err = _post_err(taa_k, taa_p, "taa_resolve real", POST_EXACT_ATOL)
    errs = _bloom_case(taa_p, passes, "real", exposure=cfg.exposure)
    atlas, offs = bloom.new_atlas(h, w, passes, hdr.device)
    downs = bloom.bloom_down_chain(taa_p, passes, atlas, offs)

    def down_chain():
        bloom.bloom_down_chain(taa_p, passes, atlas, offs)

    def down_levels():   # the same chain as per-level launches (the row-sharded frame's)
        cur = taa_p
        for i in range(1, passes + 1):
            cur = bloom.bloom_down_level(cur, *sizes[i], i == 1, atlas=atlas,
                                         atlas_col=offs[i - 1])

    def down_plain():
        sampling.pack_mip_atlas(_down_plain_chain(taa_p, passes)).to(torch.bfloat16)

    up_args = (downs[-1], h, w, passes, cfg.bloom_strength, taa_p, cfg.exposure)

    def up_chain():
        bloom.bloom_up_chain(*up_args)

    def up_levels():   # the same chain as per-level launches
        _up_levels(*up_args, None)

    def up_plain():
        return bloom.bloom_up_chain_plain(*up_args)

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    tents = (_tent_filter(1.0, hdr.device), _tent_filter(cfg.bloom_strength, hdr.device))

    def up_library():
        return _library_up(downs[-1], sizes, cfg.bloom_strength, taa_p, cfg.exposure, tents)

    up_library_diff = float((up_library() - up_plain()).abs().max())

    weight = _down_filter(hdr.device)
    lib_in = [taa_p] + downs[:-1]

    def down_library():
        for i in range(1, passes + 1):
            _library_down(lib_in[i - 1], *sizes[i], weight)

    # bytes: each input read once, each output written once; operations:
    # POST_FLOPS per output texel (csrc/post.cu's arithmetic).  The
    # per-level launches must write and read back every level between; a
    # chain reads its input and writes its outputs only (the down chain's
    # levels and atlas bands; the up chain's image, from the deepest level
    # and base), its levels between being its own scratch.
    px = h * w
    level_px = [a * b for a, b in sizes]
    n_taa = sum(t.numel() * t.element_size() for t in ins) + 12 * px
    n_atlas = sum(6 * atlas.shape[0] * sizes[i][1] for i in range(1, passes + 1))
    n_down = sum(12 * level_px[i - 1] + 12 * level_px[i] for i in range(1, passes + 1)) + n_atlas
    n_down_chain = 12 * px + sum(12 * n for n in level_px[1:]) + n_atlas
    n_up = sum(12 * level_px[i + 1] + 12 * level_px[i] for i in range(passes)) + 12 * px
    n_up_chain = 12 * level_px[passes] + 24 * px
    work = {"taa_resolve": (px * POST_FLOPS["taa"], n_taa, lambda: taa.taa_resolve(*ins, **kw),
                            lambda: taa.taa_resolve_plain(*ins, **kw), None),
            "bloom_down": (sum(level_px[1:]) * POST_FLOPS["down"], n_down_chain, down_chain,
                           down_plain, down_library),
            "bloom_down_level": (sum(level_px[1:]) * POST_FLOPS["down"], n_down, down_levels,
                                 down_plain, down_library),
            "bloom_up": (sum(level_px[:-1]) * POST_FLOPS["up"] + px * POST_FLOPS["tonemap"],
                         n_up_chain, up_chain, up_plain, up_library),
            "bloom_up_level": (sum(level_px[:-1]) * POST_FLOPS["up"]
                               + px * POST_FLOPS["tonemap"], n_up, up_levels, up_plain,
                               up_library)}
    seeded = {"taa_resolve": taa_err, "bloom_down": _fold(errs["chain"] + [errs["chain_atlas"]]),
              "bloom_down_level": _fold(errs["down"] + [errs["atlas"]]),
              "bloom_up": _fold(errs["up_chain"]), "bloom_up_level": _fold(errs["up"])}
    regs, blocks, threads = bloom.chain_occupancy()
    up_occ = bloom.up_chain_occupancy()
    up_ptxas = _ptxas_entry(BUILD_LOGS.get("post", ""), "bloom_up_chain_kernel")
    out = {}
    for name, (flops, nbytes, fn, plain, library) in work.items():
        bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
        ms_min, ms = cuda_ms(fn)
        dev_min, dev_ms = cuda_ms(fn, hold=True)
        plain_ms = cuda_ms(plain, reps=2, rounds=3)[1]
        lib_ms = cuda_ms(library)[1] if library is not None else None
        err, same = seeded[name]
        out[name] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                         bytes=nbytes, library_ms=lib_ms, max_abs_err=err, bit_equal=same)
        if name == "bloom_down":
            out[name].update(registers=regs, blocks_per_sm=blocks, threads=threads)
        if name == "bloom_up":
            out[name].update(occupancy=up_occ, ptxas=up_ptxas,
                             library_max_abs_diff=up_library_diff)
        launches = {"taa_resolve": "", "bloom_down": ", 1 launch",
                    "bloom_up": ", 1 launch"}.get(name, f", {passes} launches")
        occ = (f"; {regs} registers, {blocks} blocks of {threads} threads resident per SM"
               if name == "bloom_down" else
               f"; {up_occ['tile_w']}x{up_occ['tile_h']} tiles, {up_occ['registers']} "
               f"registers, {up_occ['local_bytes']} B local memory, {up_occ['shared_bytes']} B "
               f"shared, {up_occ['blocks_per_sm']} blocks of {up_occ['threads']} threads "
               f"resident per SM, ptxas {up_ptxas}; the library chain's max abs diff from the "
               f"plain chain {up_library_diff:.3e}" if name == "bloom_up" else "")
        print(f"post vs plain: real {name} (path frame 1, {w}x{h}{launches}): max abs err "
              f"{err:.3e}, bit-equal {same}; kernel {ms:.4f} ms median, {ms_min:.4f} min of "
              f"{KERNEL_ROUNDS} x {KERNEL_REPS} (device alone {dev_ms:.4f} median, "
              f"{dev_min:.4f} min); plain {plain_ms:.3f} ms; library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
              f"{100 * bound_ms / ms:.1f}% of the bound ({100 * bound_ms / dev_ms:.1f}% of the "
              f"device time){occ}; card {nvidia_smi()}", flush=True)
    return out


def _post_entries(post_random, post_real, paths, sharded, app, bloom_off):
    """The kernels line's five post entries: path A's real inputs, errors
    over every case, launches of every counted run.  The per-level down
    kernel is the row-sharded frame's (its launches: the 1920x1088 sharded
    run's ranks) and the per-level up kernel the bloom-off tonemap's (its
    launches: the counted 160x96 bloom-off frames, bloom_off); path A takes
    the two one-launch chains."""
    replaces = {"taa_resolve": ("vulkan_pbr_renderer_tpu/shade/taa.py:32", "taa_resolve"),
                "bloom_down": ("vulkan_pbr_renderer_tpu/shade/bloom.py:65", "bloom_down_chain"),
                "bloom_down_level": ("vulkan_pbr_renderer_tpu/shade/bloom.py:65",
                                     "bloom_down_level"),
                "bloom_up": ("vulkan_pbr_renderer_tpu/shade/bloom.py:101", "bloom_up_chain"),
                "bloom_up_level": ("vulkan_pbr_renderer_tpu/shade/bloom.py:101",
                                   "bloom_up_level")}
    shapes = {"taa_resolve": "", "bloom_down": ", a frame's chain of 6 levels in 1 launch",
              "bloom_down_level": ", a frame's chain of 6 launches",
              "bloom_up": ", a frame's chain of 6 levels and the tonemap in 1 launch",
              "bloom_up_level": ", a frame's chain of 6 launches (on the paths: the bloom-off "
                                "tonemap, 1 launch a frame)"}
    paths_of = {"bloom_down_level": ("sharded 1920x1088 K1",
                                     sharded["vis_folded"]["post_launches"]),
                "bloom_up_level": ("small 160x96 bloom off", bloom_off)}
    entries = []
    for name, (where, wrapper) in replaces.items():
        r = post_real[name]
        err = max(r["max_abs_err"], post_random[name][0])
        path, counted = paths_of.get(name, ("A", paths["A"]["post_launches"]))
        entry = {
            "name": name, "route": "cuda", "source": "vulkan_pbr_renderer_tpu_torch/csrc/post.cu",
            "replaces": where, "wrapper": wrapper,
            "note": "not a Pallas kernel: the JAX package's post stack is XLA "
                    "(app/renderer.py:229 post_stack)",
            "launches": counted[wrapper], "max_abs_err": err,
            "bit_equal": r["bit_equal"] and post_random[name][1],
            "ms": r["ms"], "ms_min": r["ms_min"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "share_of_bound": r["bound_ms"] / r["ms"], "device_ms": r["device_ms"],
            "device_ms_min": r["device_ms_min"],
            "device_share_of_bound": r["bound_ms"] / r["device_ms"], "bytes": r["bytes"],
            "flops": r["flops"], "path": path,
            "shape": "path A frame 1, 1920x1088" + shapes[name],
            "launches_by_path": {k: v["post_launches"][wrapper] for k, v in paths.items()},
            "launches_sharded": {k: v["post_launches"][wrapper] for k, v in sharded.items()},
            "launches_headless": app["headless"]["post_launches"][wrapper],
            "launches_headless_scenes": {k: v["post_launches"][wrapper]
                                         for k, v in app["headless_scenes"].items()},
            "launches_preview": app["preview"]["post_launches"][wrapper],
            "launches_bloom_off": bloom_off[wrapper]}
        if name == "bloom_down":
            entry.update({k: r[k] for k in ("registers", "blocks_per_sm", "threads")})
        if name == "bloom_up":
            entry.update({k: r[k] for k in ("occupancy", "ptxas", "library_max_abs_diff")})
        if name.startswith("bloom_up"):
            entry["replaces_also"] = "vulkan_pbr_renderer_tpu/utils/color.py:14,21"
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# phase 3e: the G-buffer and lighting kernels (csrc/gbuffer.cu, csrc/lighting.cu)


def slice_launches(cfg, frames, view_frames=0, sun_passes=1, sharded=False):
    """The G-buffer and lighting kernels' launches over `frames` frames of
    cfg, view_frames of them in the lightgrid view, sun_passes of them
    frames that draw the sun map (frame 0 and each move of the sun):
    gbuffer_kernel once a frame; in a lit frame shade_kernel once,
    gi_inputs_kernel once per GI grid with GI on (twice with a separate
    diffuse divisor in the fast march mode) and the polar shafts' one launch with the
    polar shafts on; with GI on the sweep once a frame, lit or not, and
    once a sun pass the voxelize pass (voxelize_lightgrid) in one process,
    or voxelize_scene and its decode in a rank of the row-sharded frame."""
    lit = 0 if cfg.visualize_lightgrid else frames - view_frames
    kg = cfg.gi_res_divisor
    march = cfg.gi_mode == "fast" and cfg.gi_fast_march
    grids = 1 + (march and (cfg.gi_res_divisor_diffuse or kg) != kg) if cfg.enable_gi else 0
    polar = cfg.enable_light_shafts and cfg.enable_shadows and cfg.light_shaft_mode == "polar"
    return {"gbuffer": frames, "gi_inputs": lit * grids, "shafts_polar": lit * polar,
            "shade": lit, "sweep": frames * cfg.enable_gi,
            "voxelize_lightgrid": sun_passes * cfg.enable_gi * (not sharded),
            "voxelize": sun_passes * cfg.enable_gi * sharded,
            "decode_voxel": sun_passes * cfg.enable_gi * sharded}


def _slice_counts(launches):
    return {k: launches[k] for k in SLICE_KERNELS}


def _shade_inputs():
    """tests/test_torch_shade_inputs.py: seed-made G-buffer and lighting inputs."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_shade_inputs

    return test_torch_shade_inputs


def _shade_err(got, want, what):
    """(max abs err, bit_equal) of a kernel's outputs (a tensor or a
    NamedTuple of them) against its plain version's; bool and depth fields
    held to equality, the rest to SHADE_ATOL."""
    pairs = ([(n, getattr(got, n), getattr(want, n)) for n in got._fields]
             if isinstance(got, tuple) else [("out", got, want)])
    err, same = 0.0, True
    for name, a, b in pairs:
        if a is None and b is None:
            continue
        check(tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype,
              f"{what} {name}: {tuple(a.shape)} {a.dtype}, expected {tuple(b.shape)} {b.dtype}")
        if a.dtype == torch.bool or name == "depth":
            check(bool(torch.equal(a, b)), f"{what} {name}: not equal")
            continue
        check(bool(torch.isfinite(a).all()), f"{what} {name}: non-finite values")
        e = float((a - b).abs().max()) if a.numel() else 0.0
        check(e <= SHADE_ATOL, f"{what} {name}: max abs err {e} > {SHADE_ATOL}")
        err, same = max(err, e), same and bool(torch.equal(a, b))
    return err, same


def phase_shade(dev):
    """The four kernels against their plain versions on the card, on the
    seed-made frames of tests/test_torch_shade_inputs.py: the G-buffer in
    every material filter at 1920x1088, 160x96, 7x143, 1x1, 50x37 (rows off
    the 16-byte lines, not tile multiples) and two odd bands;
    the GI lane inputs in both interleave patterns and parities, every lane
    and a separate diffuse divisor (specular off), whole and in a band; the
    polar shafts at divisors 4 and 1, whole and in a band; the shade with GI
    on, GI on without shadows, the static IBL and neither, at 160x96, in a
    band (the full-resolution sky), at 7x143 (a grid that takes _up's
    resize before the launch) and 1x1; and the tiled shade at 96x64,
    72x44 and a band of 64x96 at row 21, with its GI grids and shafts 0-3
    exact 2x steps below the pixels (kg, ks in 1, 2, 4, 8).  Returns
    {kernel: (max abs err, bit_equal)}."""
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb
    from vulkan_pbr_renderer_tpu_torch.shade import gi_modes, lighting, shadow

    si = _shade_inputs()
    scene = si.shade_scene(dev)
    static = gb.gbuffer_static(scene)
    out = {k: [] for k in SHADE_KERNELS}
    for h, w, band in ((1088, 1920, None), (96, 160, None), (7, 143, None), (1, 1, None),
                       (48, 64, (13, 21)), (37, 50, None), (40, 70, (11, 17))):
        kw, _, _ = si.gbuffer_inputs(scene, h, w, band=band, device=dev)
        for mf in ("stochastic", "trilinear", "nearest"):
            args = (kw["setup"], kw["depth"], kw["tri_id"], kw["clip_from_world"],
                    kw["old_clip_from_world"], 0.3)
            got = gb.gbuffer_pass(scene, *args, world_from_clip=kw["world_from_clip"],
                                  jitter=kw["jitter"], material_filter=mf,
                                  frame_idx_mod_59=kw["frame_idx_mod_59"],
                                  row_offset=kw["row_offset"], full_size=kw["full_size"],
                                  static=static)
            want = gb.gbuffer_pass_plain(scene, static, *args, kw["world_from_clip"],
                                         kw["jitter"], mf, kw["frame_idx_mod_59"],
                                         kw["row_offset"], kw["full_size"])
            out["gbuffer"].append(_shade_err(got, want, f"gbuffer {w}x{h} band {band} {mf}"))
    for h, w, band in ((96, 160, None), (96, 160, (24, 48)), (7, 143, None), (1, 1, None),
                       (48, 64, (13, 21))):
        g, glob, tables, kw = si.lighting_inputs(scene, h, w, band=band, device=dev)
        rows = g.depth.shape[0]
        for k, pattern, parity, spec in ((2, "columns", 0, True), (2, "columns", 1, True),
                                         (2, "checker", 0, True), (2, "checker", 1, True),
                                         (1, None, 0, True), (4, None, 0, False)):
            if pattern is not None and (-(-w // k) % 2 or -(-rows // k) % 2):
                continue
            args = (g.normal, g.orm, g.depth, glob.world_from_clip, glob.view_from_clip,
                    glob.camera_pos, k, 7.0, kw["row_offset"], h, pattern, parity, spec)
            first, again = gi_modes.gi_lane_inputs(*args), gi_modes.gi_lane_inputs(*args)
            what = f"gi_inputs {w}x{h} band {band} k{k} {pattern} {parity}"
            check(first.pw.untyped_storage().data_ptr()
                  != again.pw.untyped_storage().data_ptr(),
                  f"{what}: two calls share their outputs' storage")
            out["gi_inputs"].append(_shade_err(first, gi_modes.gi_lane_inputs_plain(*args),
                                               what))
            out["gi_inputs"].append(_shade_err(again, first, f"{what} (again)"))
        em = lighting.sun_emission(si.frame_config(h, w))
        for k in (4, 1):
            args = (tables["sun_depth"], glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
                    glob.world_from_clip, glob.view_from_clip, k, 3.0)
            skw = dict(max_steps=12, n_theta=4096, n_r=12, row_offset=kw["row_offset"],
                       full_height=h)
            out["shafts_polar"].append(_shade_err(
                shadow.shafts_polar(*args, em, **skw),
                shadow.shafts_polar_plain(*args, torch.as_tensor(em, device=dev), **skw),
                f"shafts {w}x{h} band {band} k{k}"))
        for name, changes, gi_on in SHADE_CASES:
            cfg = si.frame_config(h, w, **changes)
            args = (g, glob, cfg, tables["sun_u16"] if cfg.enable_shadows else None,
                    tables["lut16"], tables["env"],
                    tables["shafts"] if cfg.enable_shadows else None,
                    tables["ambient"] if gi_on else None, tables["spec"] if gi_on else None,
                    kw["row_offset"], h)
            out["shade"].append(_shade_err(lighting.shade(*args), lighting.shade_plain(*args),
                                           f"shade {w}x{h} band {band} {name}"))
    # the tiled shade on frames that are not tile multiples, in bands, with
    # its grids 0-3 exact 2x steps below the pixels (or upsampled first)
    for (h, w, band), (kg, ks) in itertools.product(
            ((64, 96, None), (44, 72, None), (64, 96, (21, 27))),
            ((1, 1), (4, 2), (8, 8), (2, 8))):
        g, glob, tables, kw = si.lighting_inputs(scene, h, w, band=band, device=dev, kg=kg, ks=ks)
        for name, changes, gi_on in SHADE_CASES:
            cfg = si.frame_config(h, w, **changes)
            args = (g, glob, cfg, tables["sun_u16"] if cfg.enable_shadows else None,
                    tables["lut16"], tables["env"],
                    tables["shafts"] if cfg.enable_shadows else None,
                    tables["ambient"] if gi_on else None, tables["spec"] if gi_on else None,
                    kw["row_offset"], h)
            out["shade"].append(_shade_err(lighting.shade(*args), lighting.shade_plain(*args),
                                           f"shade {w}x{h} band {band} kg {kg} ks {ks} {name}"))
    torch.cuda.synchronize()
    res = {k: _fold(v) for k, v in out.items()}
    print(f"shade vs plain: seeded sets ok; max abs err "
          f"{ {k: f'{v[0]:.3e}' for k, v in res.items()} }, bit-equal "
          f"{ {k: v[1] for k, v in res.items()} }", flush=True)
    return res


def capture_slice_calls(renderer, cams):
    """The five wrappers' arguments in one steady frame (frame 1, sun
    unchanged) of renderer's path, captured from Renderer.render: {kernel:
    (args, kwargs)} of the frame's one call each (gi_inputs: the traced
    grid's; sweep: frame 1's grid before its sweep).  The renderer's
    temporal state is reset afterwards."""
    from vulkan_pbr_renderer_tpu_torch.app import renderer as rmod
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb
    from vulkan_pbr_renderer_tpu_torch.shade import gi, gi_modes, lighting, shadow

    sites = {"gbuffer": (gb, "gbuffer_pass"), "gi_inputs": (gi_modes, "gi_lane_inputs"),
             "shafts_polar": (shadow, "shafts_polar"), "shade": (lighting, "shade"),
             "sweep": (gi, "sweep_lightgrid_u8")}
    calls = {k: [] for k in sites}
    originals = {k: getattr(mod, fn) for k, (mod, fn) in sites.items()}

    def recorder(name):
        def record(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        # the wrapper counts its launches on the name it is called by
        record.launches = originals[name].launches
        return record

    renderer.render(cams[0], SUN)
    for name, (mod, fn) in sites.items():
        setattr(mod, fn, recorder(name))
    try:
        renderer.render(cams[1], SUN)
    finally:
        for name, (mod, fn) in sites.items():
            originals[name].launches = getattr(mod, fn).launches
            setattr(mod, fn, originals[name])
    renderer.state = rmod.init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    for name, c in calls.items():
        check(len(c) == 1, f"slice real inputs: {name} called {len(c)} times in a frame")
    return {k: v[0] for k, v in calls.items()}


def _pcf_texels(g, glob, sun_u16, cfg):
    """The distinct sun-map texels the frame's PCF windows read (the 4x4
    window at each covered pixel's base texel), from shade_plain's index
    arithmetic."""
    from vulkan_pbr_renderer_tpu_torch.shade import lighting
    from vulkan_pbr_renderer_tpu_torch.utils import math3d as m3
    from vulkan_pbr_renderer_tpu_torch.utils import noise as noiselib

    h, w = g.depth.shape
    s = sun_u16.shape[0]
    pw, _ = lighting.reconstruct_positions(g.depth, glob.world_from_clip, glob.view_from_clip)
    px, py = lighting._pixel_grid(h, w, 1, g.depth.device)
    n1 = noiselib.frame_noise(px, py, glob.frame_idx_mod_59)
    n2 = noiselib.frame_noise(px, py, glob.frame_idx_mod_59, offset=(90.0, 20.0))
    sp = m3.transform_points(glob.sun_from_world, pw + g.normal * cfg.shadow_normal_offset)
    uv = sp[..., :2] * 0.5 + 0.5 + 2.0 * torch.stack([n2 - 0.5, n1 - 0.5], -1) * (1.0 / s)
    p = uv * s - 0.5
    bx = torch.clamp(torch.floor(p[..., 0]).to(torch.int64) - 1, 0, s - 4)[g.coverage]
    by = torch.clamp(torch.floor(p[..., 1]).to(torch.int64) - 1, 0, s - 4)[g.coverage]
    texels = torch.cat([((by + i) * s + bx + j) for i in range(4) for j in range(4)])
    return int(torch.unique(texels).numel())


def _profile_texels(sun_depth, sun_from_world, camera_pos, n_theta, n_r):
    """The distinct sun-map texels the polar profile's bilinear samples read."""
    from vulkan_pbr_renderer_tpu_torch.utils import math3d as m3

    s = sun_depth.shape[0]
    dev = sun_depth.device
    cs = m3.transform_points(sun_from_world, camera_pos)[..., :3]
    theta = (torch.arange(n_theta, dtype=torch.float32, device=dev) + 0.5) * (
        2.0 * np.pi / n_theta)
    rho = (torch.arange(n_r, dtype=torch.float32, device=dev) + 1.5) * (1.0 / 16.0)
    pxy = cs[:2] + torch.stack([torch.cos(theta), torch.sin(theta)], -1)[:, None] * rho[:, None]
    x = (pxy * 0.5 + 0.5) * s - 0.5
    x0 = torch.floor(x).to(torch.int64)
    ids = [torch.clamp(x0[..., 1] + dy, 0, s - 1) * s + torch.clamp(x0[..., 0] + dx, 0, s - 1)
           for dy in (0, 1) for dx in (0, 1)]
    return int(torch.unique(torch.cat([i.reshape(-1) for i in ids])).numel())


def _lane_sector_bytes(call, lanes):
    """The bytes the lane kernel moves counted in 32-byte sectors: the
    sectors of normal, orm (its roughness) and depth that its lanes' pixels
    touch, and its outputs written whole."""
    import inspect

    from vulkan_pbr_renderer_tpu_torch.shade import gi_modes

    b = inspect.signature(gi_modes.gi_lane_inputs).bind(*call[0], **call[1])
    b.apply_defaults()
    a = b.arguments
    k, pattern, parity, w = a["k"], a["pattern"], a["parity"], a["depth"].shape[1]
    rows, lc = lanes.n3.shape
    dev = lanes.n3.device
    i = torch.arange(rows, device=dev)[:, None]
    j = torch.arange(lc, device=dev)[None, :]
    col = j if pattern is None else 2 * j + torch.where(
        (i % 2 == 0) | (pattern == "columns"), parity, 1 - parity)
    px = ((i * k) * w + col * k).reshape(-1)
    sectors = sum(int(torch.unique(t).numel()) for t in (
        torch.cat([(12 * px) // 32, (12 * px + 11) // 32]), (12 * px + 4) // 32, (4 * px) // 32))
    return 32 * sectors + sum(t.numel() * 4 for t in lanes if t is not None)


def _steps(grid, g):
    """The exact 2x steps shade_kernel takes from a grid to the G-buffer's
    size (None: none given, or upsampled before the launch)."""
    from vulkan_pbr_renderer_tpu_torch.shade import lighting

    return None if grid is None else lighting._up_steps(grid, *g.depth.shape)


def phase_shade_real(calls, cfg):
    """The four kernels on path A's real inputs (one steady frame at full
    width), each against its plain version, with its time (median and min
    of KERNEL_ROUNDS x KERNEL_REPS calls as the wrapper's calls come, and
    the device's time alone behind a device sleep), the plain version's, and
    the bound from this run's bytes (each input read once, the triangle
    rows, atlas rows and sun-map texels counted once per distinct one read,
    each output written once) and operations (SHADE_FLOPS per output)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb
    from vulkan_pbr_renderer_tpu_torch.shade import gi_modes, lighting, shadow

    a, k = calls["gbuffer"]
    scene, s, depth, tri = a[0], a[1], a[2], a[3]
    static = k["static"]
    plain_args = (scene, static, s, depth, tri, a[4], a[5], a[6], k["world_from_clip"],
                  k["jitter"], k["material_filter"], k["frame_idx_mod_59"])
    work = {}
    g_plain = gb.gbuffer_pass_plain(*plain_args, work=work)
    cov = tri >= 0
    n_tris = int(torch.unique(tri[cov]).numel())
    n_rows = int(torch.unique(torch.cat([r[cov] for r in work["atlas_rows"]])).numel())
    h, w = depth.shape
    px = h * w
    gb_bytes = 8 * px + n_tris * (36 + 12 + 64) + n_rows * 48 + px * (4 * 12 + 4 + 8 + 1)

    la, lk = calls["gi_inputs"]
    lanes = gi_modes.gi_lane_inputs(*la, **lk)
    n_lanes = lanes.n3.numel()
    gi_bytes = n_lanes * (12 + 4 + 4) + sum(t.numel() * 4 for t in lanes if t is not None)
    gi_sector_bytes = _lane_sector_bytes(calls["gi_inputs"], lanes)

    sa, sk = calls["shafts_polar"]
    n_theta, n_r = sk["n_theta"], sk["n_r"]
    shafts = shadow.shafts_polar(*sa, **sk)
    sh_px = shafts.shape[0] * shafts.shape[1]
    prof_texels = _profile_texels(sa[0], sa[1], sa[2], n_theta, n_r)
    sh_bytes = prof_texels * 4 + 2 * n_theta * n_r * 2 + sh_px * (12 + 4 + 12)

    ca = calls["shade"][0]
    g, glob, scfg, sun_u16, lut16, env = ca[:6]
    grids = [t for t in ca[6:9] if t is not None]
    pcf_texels = _pcf_texels(g, glob, sun_u16, scfg)
    sd_bytes = (px * (12 * 3 + 8 + 4 + 1 + 12) + sum(t.numel() * 4 for t in grids)
                + lut16.numel() * 2 + pcf_texels * 2)

    em = torch.as_tensor(sa[9], device=depth.device)
    work_items = {
        "gbuffer": (px * SHADE_FLOPS["gbuffer"], gb_bytes,
                    lambda: gb.gbuffer_pass(*a, **k), lambda: gb.gbuffer_pass_plain(*plain_args)),
        "gi_inputs": (n_lanes * SHADE_FLOPS["gi_inputs"], gi_bytes,
                      lambda: gi_modes.gi_lane_inputs(*la, **lk),
                      lambda: gi_modes.gi_lane_inputs_plain(*la, **lk)),
        "shafts_polar": (n_theta * n_r * SHADE_FLOPS["shafts_profile"]
                         + sh_px * (SHADE_FLOPS["shafts_pixel"] + 6 * n_r), sh_bytes,
                         lambda: shadow.shafts_polar(*sa, **sk),
                         lambda: shadow.shafts_polar_plain(*sa[:9], em, *sa[10:], **sk)),
        "shade": (px * SHADE_FLOPS["shade"], sd_bytes, lambda: lighting.shade(*ca),
                  lambda: lighting.shade_plain(*ca))}
    errs = {"gbuffer": _shade_err(gb.gbuffer_pass(*a, **k), g_plain, "gbuffer real"),
            "gi_inputs": _shade_err(lanes, gi_modes.gi_lane_inputs_plain(*la, **lk),
                                    "gi_inputs real"),
            "shafts_polar": _shade_err(
                shafts, shadow.shafts_polar_plain(*sa[:9], em, *sa[10:], **sk), "shafts real"),
            "shade": _shade_err(lighting.shade(*ca), lighting.shade_plain(*ca), "shade real")}
    out = {}
    for name, (flops, nbytes, fn, plain) in work_items.items():
        bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
        ms_min, ms = cuda_ms(fn)
        dev_min, dev_ms = cuda_ms(fn, hold=True)
        plain_ms = cuda_ms(plain, reps=2, rounds=3)[1]
        err, same = errs[name]
        out[name] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                         bytes=nbytes, max_abs_err=err, bit_equal=same)
        print(f"shade vs plain: real {name} (path A frame 1): max abs err {err:.3e}, bit-equal "
              f"{same}; kernel {ms:.4f} ms median, {ms_min:.4f} min of {KERNEL_ROUNDS} x "
              f"{KERNEL_REPS} (device alone {dev_ms:.4f} median, {dev_min:.4f} min); plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP), {100 * bound_ms / ms:.1f}% of the bound "
              f"({100 * bound_ms / dev_ms:.1f}% of the device time); card {nvidia_smi()}",
              flush=True)
    out["gi_inputs"]["sector_bytes"] = gi_sector_bytes
    print(f"gi_inputs: {gi_sector_bytes / 1e6:.2f} MB moved in 32-byte sectors (the G-buffer "
          f"sectors its lanes touch, the outputs whole) beside the bound's {gi_bytes / 1e6:.2f} "
          f"MB: {gi_sector_bytes / PEAK_HBM * 1e3:.4f} ms at the HBM rate", flush=True)
    gi_occ = _lane_occupancy()
    gi_ptxas = _ptxas_entry(BUILD_LOGS.get("lighting", ""), "gi_inputs_kernel")
    out["gi_inputs"].update(occupancy=gi_occ, ptxas=gi_ptxas)
    print(f"gi_inputs kernel: {gi_occ['registers']} registers, {gi_occ['local_bytes']} B local "
          f"memory a thread, {gi_occ['blocks_per_sm']} blocks of 256 threads resident per SM; "
          f"ptxas {gi_ptxas}; card {nvidia_smi()}", flush=True)
    out["work"] = dict(pixels=px, distinct_triangles=n_tris, distinct_atlas_rows=n_rows,
                       lanes=n_lanes, shaft_pixels=sh_px, profile_texels=prof_texels,
                       pcf_texels=pcf_texels)
    print(f"shade real work: {out['work']}", flush=True)
    gb_occ = gb.gbuffer_occupancy()
    gb_ptxas = _ptxas_entry(BUILD_LOGS.get("gbuffer", ""), "gbuffer_kernel")
    out["gbuffer"].update(occupancy=gb_occ, ptxas=gb_ptxas)
    print(f"gbuffer kernel: {gb_occ['tile_w']}x{gb_occ['tile_h']} pixel tiles, "
          f"{gb_occ['registers']} registers, {gb_occ['local_bytes']} B local memory a thread, "
          f"{gb_occ['shared_bytes']} B shared a block, {gb_occ['blocks_per_sm']} blocks of 256 "
          f"threads resident per SM; ptxas {gb_ptxas}; card {nvidia_smi()}", flush=True)
    sh_occ = shadow.shafts_occupancy()
    sh_ptxas = _ptxas_entry(BUILD_LOGS.get("lighting", ""), "shafts_polar_kernel")
    out["shafts_polar"].update(occupancy=sh_occ, ptxas=sh_ptxas)
    print(f"shafts kernel: one launch, {sh_occ['registers']} registers, "
          f"{sh_occ['local_bytes']} B local memory a thread, "
          f"{sh_occ['shared_bytes']} B shared a block, {sh_occ['blocks_per_sm']} blocks of 256 "
          f"threads resident per SM; ptxas {sh_ptxas}; card {nvidia_smi()}", flush=True)
    occ = lighting.shade_occupancy()
    ptxas = _ptxas_entry(BUILD_LOGS.get("lighting", ""), "shade_kernel")
    out["shade"].update(occupancy=occ, ptxas=ptxas, sh_steps=_steps(ca[6], g),
                        g_steps=_steps(ca[7], g))
    print(f"shade kernel: {occ['tile_w']}x{occ['tile_h']} pixel tiles, {occ['registers']} "
          f"registers, {occ['local_bytes']} B local memory a thread, {occ['shared_bytes']} B "
          f"shared a block, {occ['blocks_per_sm']} blocks of 256 threads resident per SM; "
          f"ptxas {ptxas}; path A's grids: shafts {out['shade']['sh_steps']}, GI "
          f"{out['shade']['g_steps']} exact 2x steps below the pixels; card {nvidia_smi()}",
          flush=True)
    return out


def _lane_occupancy():
    """{registers, local_bytes, shared_bytes, blocks_per_sm} of the built GI
    lane kernel (csrc/lighting.cu gi_inputs_kernel)."""
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
    from vulkan_pbr_renderer_tpu_torch.shade import shadow

    return cuda_build.query_ints(shadow.library(), "gi_inputs_occupancy", (
        "registers", "local_bytes", "shared_bytes", "blocks_per_sm"))


def phase_plain_frame(renderer, cams):
    """Path A's frames 0-1 at full width through the kernels, then the same
    frames from a fresh state with the four wrappers swapped for their plain
    versions on the card: the max abs difference of the final images and of
    the HDR lighting."""
    from vulkan_pbr_renderer_tpu_torch.app import renderer as rmod
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb
    from vulkan_pbr_renderer_tpu_torch.shade import gi_modes, lighting, shadow

    def plain_gbuffer(scene, setup, depth, tri_id, cfw, old, thr=0.3, world_from_clip=None,
                      jitter=None, material_filter="nearest", frame_idx_mod_59=None,
                      row_offset=0, full_size=None, static=None):
        return gb.gbuffer_pass_plain(scene, static, setup, depth, tri_id, cfw, old, thr,
                                     world_from_clip, jitter, material_filter, frame_idx_mod_59,
                                     row_offset, full_size)

    def plain_shafts(*args, **kw):
        return shadow.shafts_polar_plain(*args[:9], torch.as_tensor(
            args[9], device=args[3].device), *args[10:], **kw)

    def frames():
        renderer.state = rmod.init_frame_state(renderer.cfg, renderer.device)
        imgs = [renderer.render(cam, SUN) for cam in cams[:2]]
        return imgs[-1], renderer.state.taa_history.clone()

    kernel_img, kernel_hdr = frames()
    swaps = {(gb, "gbuffer_pass"): plain_gbuffer,
             (gi_modes, "gi_lane_inputs"): gi_modes.gi_lane_inputs_plain,
             (shadow, "shafts_polar"): plain_shafts, (lighting, "shade"): lighting.shade_plain}
    originals = {key: getattr(*key) for key in swaps}
    for (mod, fn), repl in swaps.items():
        setattr(mod, fn, repl)
    try:
        plain_img, plain_hdr = frames()
    finally:
        for (mod, fn), orig in originals.items():
            setattr(mod, fn, orig)
    renderer.state = rmod.init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    d_img = float((kernel_img - plain_img).abs().max())
    d_hdr = float((kernel_hdr - plain_hdr).abs().max())
    check(d_img <= PLAIN_FRAME_ATOL, f"path A frame 1: kernels vs plain versions on the card, "
          f"max abs diff {d_img} > {PLAIN_FRAME_ATOL}")
    print(f"path A 1920x1088 frame 1 through the slice's kernels vs their plain versions on the "
          f"card: final image max abs diff {d_img:.3e}, TAA output {d_hdr:.3e}", flush=True)
    return dict(image_max_abs_diff=d_img, taa_max_abs_diff=d_hdr)


def _shade_entries(shade_random, shade_real, plain_frame, paths, sharded, app):
    """The kernels line's four G-buffer and lighting entries: path A's real
    inputs, errors over every case, launches of every counted run."""
    replaces = {
        "gbuffer": ("vulkan_pbr_renderer_tpu/shade/gbuffer.py:123", "gbuffer.cu",
                    "gbuffer_pass", "G-buffer, XLA (gbuffer_pass)"),
        "gi_inputs": ("vulkan_pbr_renderer_tpu/shade/gi_modes.py:520", "lighting.cu",
                      "gi_lane_inputs", "the GI lanes' inputs, XLA (gi_pass + lighting.py:175 "
                      "sub_inputs)"),
        "shafts_polar": ("vulkan_pbr_renderer_tpu/shade/shadow.py:84", "lighting.cu",
                         "shafts_polar", "the polar shafts, XLA (light_shafts_polar)"),
        "shade": ("vulkan_pbr_renderer_tpu/shade/lighting.py:107", "lighting.cu", "shade",
                  "the lighting pass but its GI rays, XLA (lighting_pass)")}
    entries = []
    for name, (where, src, wrapper, what) in replaces.items():
        r = shade_real[name]
        err = max(r["max_abs_err"], shade_random[name][0])
        entries.append({
            "name": name, "route": "cuda",
            "source": f"vulkan_pbr_renderer_tpu_torch/csrc/{src}", "replaces": where,
            "wrapper": wrapper, "note": f"not a Pallas kernel: {what}",
            "launches": paths["A"]["slice_launches"][name], "max_abs_err": err,
            "bit_equal": r["bit_equal"] and shade_random[name][1],
            "ms": r["ms"], "ms_min": r["ms_min"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "share_of_bound": r["bound_ms"] / r["ms"], "device_ms": r["device_ms"],
            "device_ms_min": r["device_ms_min"],
            "device_share_of_bound": r["bound_ms"] / r["device_ms"], "bytes": r["bytes"],
            "flops": r["flops"], "path": "A", "shape": "path A frame 1, 1920x1088"
            + (", one launch (the profile's bands, then the pixels)"
               if name == "shafts_polar" else ""),
            "work": shade_real["work"], "path_a_frame_vs_plain": plain_frame,
            "launches_by_path": {k: v["slice_launches"][name] for k, v in paths.items()},
            "launches_sharded": {k: v["slice_launches"][name] for k, v in sharded.items()},
            "launches_headless": app["headless"]["slice_launches"][name],
            "launches_headless_scenes": {k: v["slice_launches"][name]
                                         for k, v in app["headless_scenes"].items()},
            "launches_preview": app["preview"]["slice_launches"][name]})
        if name == "shade":
            entries[-1].update({k: r[k] for k in ("occupancy", "ptxas", "sh_steps",
                                                  "g_steps")})
        if name in ("gbuffer", "shafts_polar", "gi_inputs"):
            entries[-1].update({k: r[k] for k in ("occupancy", "ptxas")})
        if name == "gi_inputs":
            entries[-1]["sector_bytes"] = r["sector_bytes"]
    return entries


# ---------------------------------------------------------------------------
# phase 3f: the lightgrid sweep (csrc/sweep.cu)


def _sweep_case(grid, axis, what, *params):
    """The kernel's (grid, table) against the plain chain's on the card, bit
    for bit, one launch a call (params: skylight, move_ratio, blend, or the
    defaults): (max abs err of the grid, bit-equal)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    before = gi.sweep_lightgrid_u8.launches
    out, table = gi.sweep_lightgrid_u8(grid, axis, *params)
    check(gi.sweep_lightgrid_u8.launches == before + 1, f"sweep {what}: not one launch")
    want = gi.sweep_lightgrid(grid, axis, *params)
    want_table = gi.quantize_grid_u8(want)
    torch.cuda.synchronize()
    check(out.shape == want.shape and table.shape == want_table.shape
          and table.dtype == torch.uint8, f"sweep {what}: shapes {out.shape} {table.shape}")
    check(bool(torch.isfinite(out).all()), f"sweep {what}: non-finite values")
    err = float((out - want).abs().max())
    same = torch.equal(out.view(torch.int32), want.view(torch.int32))
    check(same, f"sweep {what}: grid max abs err {err}, not the plain version's bits")
    levels = (table.int() - want_table.int()).abs()
    check(torch.equal(table, want_table),
          f"sweep {what}: {int((levels > 0).sum())} table levels differ (by up to "
          f"{int(levels.max())})")
    return err, same


def phase_sweep(dev):
    """The sweep's two kernels (sweep_ring_kernel on 16-, 32- and 128-voxel
    lines, lightgrid_sweep_kernel on 9, 7, 5, 4 and 520) against the plain
    chain on the card, grid and table bit for bit, on seeded grids
    (31 of them): SWEEP_SHAPES on every axis with
    SWEEP_OCCUPIED of the voxels occupied, a 520-voxel line (dynamic shared
    memory past 48 KB) and 128^3 at 30%; a line too long for a block's
    shared memory raises ValueError and launches nothing.  Returns (max abs
    err, bit_equal)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    rng = np.random.default_rng(18)
    errs = []
    for axis in (0, 1, 2):
        for shape in SWEEP_SHAPES:
            shape = shape if shape[0] != 32 else tuple(np.roll((32, 4, 4), axis))
            for occ in SWEEP_OCCUPIED:
                g = rng.uniform(0, 3, shape + (4,)).astype(np.float32)
                g[..., 3] = rng.random(shape) < occ
                errs.append(_sweep_case(torch.from_numpy(g).to(dev), axis,
                                        f"{shape} axis {axis} occupied {occ}"))
        g = torch.rand((128, 128, 128, 4), generator=torch.Generator().manual_seed(axis)) * 3
        g[..., 3] = (g[..., 3] < 0.9).float()
        errs.append(_sweep_case(g.to(dev), axis, f"128^3 axis {axis}"))
    g = rng.uniform(0, 3, (520, 3, 8, 4)).astype(np.float32)
    g[..., 3] = rng.random((520, 3, 8)) < 0.3
    errs.append(_sweep_case(torch.from_numpy(g).to(dev), 0, "520x3x8 axis 0"))
    before = gi.sweep_lightgrid_u8.launches
    try:
        gi.sweep_lightgrid_u8(torch.zeros((1000, 2, 8, 4), device=dev), 0)
        check(False, "sweep: a 1000-voxel line was not refused")
    except ValueError as e:
        check("shared memory" in str(e), f"sweep: refused with {e}")
    check(gi.sweep_lightgrid_u8.launches == before, "sweep: a refused call launched")
    res = _fold(errs)
    print(f"sweep vs plain chain: {len(errs)} seeded grids, grid and table bit-equal; max abs "
          f"err {res[0]:.3e}", flush=True)
    return res


def phase_sweep_real(call):
    """The sweep on path A's frame-1 grid (128^3 x 4, captured from
    Renderer.render) on each axis: bits against the plain chain, the time
    as called and the device's alone (median and min of KERNEL_ROUNDS x
    KERNEL_REPS), the plain chain's, the byte bound (the grid read, the
    grid and the table written once) and the flop bound (SWEEP_FLOPS a
    voxel); the kernel's registers, spills and resident blocks."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    (grid, frame_axis, *rest), kw = call
    check(not kw, f"sweep real: keyword arguments {kw}")
    voxels = grid.numel() // 4
    nbytes = voxels * (16 + 16 + 4)
    flops = voxels * SWEEP_FLOPS
    bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
    out = {"frame_axis": frame_axis, "voxels": voxels, "bytes": nbytes, "flops": flops,
           "bound_ms": bound_ms, "bound_by": bound_by, "axes": {}}
    for axis in (0, 1, 2):
        err, same = _sweep_case(grid, axis, f"path A frame 1 axis {axis}", *rest)
        ms_min, ms = cuda_ms(lambda: gi.sweep_lightgrid_u8(grid, axis, *rest))
        dev_min, dev_ms = cuda_ms(lambda: gi.sweep_lightgrid_u8(grid, axis, *rest), hold=True)
        plain_ms = cuda_ms(lambda: gi.quantize_grid_u8(gi.sweep_lightgrid(grid, axis, *rest)),
                           reps=2, rounds=3)[1]
        out["axes"][axis] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                                 plain_ms=plain_ms, max_abs_err=err, bit_equal=same)
        print(f"sweep vs plain chain: real path A frame 1 grid {tuple(grid.shape)} axis {axis}: "
              f"bit-equal {same}; kernel {ms:.4f} ms median, {ms_min:.4f} min of "
              f"{KERNEL_ROUNDS} x {KERNEL_REPS} (device alone {dev_ms:.4f} median, {dev_min:.4f} "
              f"min); plain chain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), {100 * bound_ms / ms:.1f}% of "
              f"the bound ({100 * bound_ms / dev_ms:.1f}% of the device time); card "
              f"{nvidia_smi()}", flush=True)
    n = grid.shape[0]
    occ = gi.sweep_occupancy(n)
    # the ring kernel's instance for K voxels a lane
    name = (f"sweep_ring_kernelILi{occ['lane_voxels']}E" if occ["kernel"] == "ring"
            else "lightgrid_sweep_kernel")
    ptxas = _ptxas_entry(BUILD_LOGS.get("sweep", ""), name)
    out.update(occupancy=occ, ptxas=ptxas)
    print(f"sweep kernel ({occ['kernel']}, {n}-voxel lines): {occ['lines_per_block']} lines a "
          f"block, {occ['registers']} registers, {occ['local_bytes']} B local memory a thread, "
          f"{occ['shared_bytes']} B shared a block, {occ['blocks_per_sm']} blocks of "
          f"{occ['threads']} threads resident per SM; ptxas {ptxas}; card {nvidia_smi()}",
          flush=True)
    return out


def _sweep_entry(sweep_random, real, paths, sharded, app):
    """The kernels line's sweep entry: path A's frame-1 grid on the frame's
    own axis, the other axes beside it, launches of every counted run."""
    a = real["axes"][real["frame_axis"]]
    err = max([sweep_random[0]] + [v["max_abs_err"] for v in real["axes"].values()])
    return {
        "name": "sweep", "route": "cuda",
        "source": "vulkan_pbr_renderer_tpu_torch/csrc/sweep.cu",
        "replaces": "vulkan_pbr_renderer_tpu/shade/gi.py:68",
        "replaces_also": "vulkan_pbr_renderer_tpu/shade/gi_modes.py:247",
        "wrapper": "sweep_lightgrid_u8",
        "note": "not a Pallas kernel: the lightgrid sweep, XLA (associative_scan), and the "
                "fast GI's u8 table (pack_grid_u8's levels)",
        "launches": paths["A"]["slice_launches"]["sweep"], "max_abs_err": err,
        "bit_equal": sweep_random[1] and all(v["bit_equal"] for v in real["axes"].values()),
        "ms": a["ms"], "ms_min": a["ms_min"], "plain_ms": a["plain_ms"],
        "bound_ms": real["bound_ms"], "bound_by": real["bound_by"], "library_ms": None,
        "share_of_bound": real["bound_ms"] / a["ms"], "device_ms": a["device_ms"],
        "device_ms_min": a["device_ms_min"],
        "device_share_of_bound": real["bound_ms"] / a["device_ms"], "bytes": real["bytes"],
        "flops": real["flops"], "path": "A",
        "shape": f"path A frame 1, 128^3 x 4 grid, axis {real['frame_axis']}",
        "axes": real["axes"], "occupancy": real["occupancy"], "ptxas": real["ptxas"],
        "launches_by_path": {k: v["slice_launches"]["sweep"] for k, v in paths.items()},
        "launches_sharded": {k: v["slice_launches"]["sweep"] for k, v in sharded.items()},
        "launches_headless": app["headless"]["slice_launches"]["sweep"],
        "launches_headless_scenes": {k: v["slice_launches"]["sweep"]
                                     for k, v in app["headless_scenes"].items()},
        "launches_preview": app["preview"]["slice_launches"]["sweep"]}


# ---------------------------------------------------------------------------
# phase 3g: triangle transform + setup (csrc/setup.cu)


def _setup_inputs():
    """tests/test_torch_setup_inputs.py: seed-made triangle sets of the setup kernel."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_setup_inputs

    return test_torch_setup_inputs


def _setup_plain(tri_pos, mat, w, h, cull, jitter):
    """The setup kernel's plain version: transform_to_clip, then setup_triangles."""
    from vulkan_pbr_renderer_tpu_torch.raster import setup

    return setup.setup_triangles(setup.transform_to_clip(tri_pos, mat, jitter), w, h, cull)


def _setup_equal(got, want, what):
    """Every TriSetup field of the kernel against the plain composition's
    bit for bit (floats as int32 views: signed zeros count), each
    contiguous, of the plain dtype and shape; returns the largest absolute
    difference (0 where the bits agree)."""
    err = 0.0
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        check(a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous(),
              f"{what}: {f} is {a.dtype} {tuple(a.shape)}, plain {b.dtype} {tuple(b.shape)}")
        same = _bits(a) == _bits(b)
        diff = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
        diff = torch.where(same, 0.0, diff)
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        check(bool(same.all()), f"{what}: {f} differs from the plain composition at "
                                f"{int((~same).sum())} values (max abs difference {err})")
    return err


def phase_setup(dev):
    """transform_and_setup's kernel (csrc/setup.cu) against the plain
    composition setup_triangles(transform_to_clip(...)) on the card, every
    field bit for bit, on the seeded sets of tests/test_torch_setup_inputs.py
    (a perspective camera's triangles in front of, behind and across the
    near plane at two viewports; hand-placed edge cases: |w| < 1e-6, w = 0,
    w = 1e-6, det == 0, off screen, both windings; one triangle; none) in
    every cull mode, with and without the jitter, dense and through the
    renderer's strided tri_attr view; one launch a call (none for no
    triangle).  Returns (cases, max abs err)."""
    from vulkan_pbr_renderer_tpu_torch.raster import setup

    inputs = _setup_inputs()
    jit = torch.from_numpy(inputs.JITTER).to(dev)
    n_cases, err = 0, 0.0
    for name, make in inputs.SETS.items():
        pos, mat, w, h = make()
        m = torch.from_numpy(mat).to(dev)
        layouts = {"dense": torch.from_numpy(pos).to(dev),
                   "tri_attr view": torch.from_numpy(inputs.tri_attr_view(pos)).to(dev)[
                       :, :9].reshape(-1, 3, 3)}
        for layout, tri_pos in layouts.items():
            for cull in setup.CULL_MODES:
                for j in (None, jit):
                    what = (f"setup {name} ({pos.shape[0]} triangles) {layout} cull={cull}"
                            f"{' jitter' if j is not None else ''}")
                    before = setup.transform_and_setup.launches
                    got = setup.transform_and_setup(tri_pos, m, w, h, cull=cull, jitter=j)
                    check(setup.transform_and_setup.launches == before + (pos.shape[0] > 0),
                          f"{what}: launches")
                    err = max(err, _setup_equal(got, _setup_plain(tri_pos, m, w, h, cull, j),
                                                what))
                    n_cases += 1
    print(f"setup vs plain: {n_cases} seeded cases bit for bit ({len(inputs.SETS)} sets x "
          f"dense / strided x 3 cull modes x jitter or not); max abs difference {err}",
          flush=True)
    return n_cases, err


def phase_setup_real(scene):
    """The setup kernel on path A's frame-0 camera pass (back cull, the
    frame's jitter) and sun pass (cull none) over the 638,700 triangles,
    through the renderer's strided tri_attr view: every field bit for bit
    against the plain composition; the kernel's time as called and on the
    device alone (median and min of 5 x 20 calls), the plain chain's time
    (as called and on the device) and its device events per call, the
    kernel's own events, and the byte bound (each input read once, each
    output written once)."""
    from pass_profile import device_events
    from vulkan_pbr_renderer_tpu_torch.app.renderer import (frame_inputs, init_frame_state,
                                                            make_camera)
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P as cfg
    from vulkan_pbr_renderer_tpu_torch.raster import setup

    cam = make_camera(*suntemple.camera_path(0.0), cfg, device="cuda")
    fi = frame_inputs(init_frame_state(cfg, "cuda"), cam, SUN, cfg)
    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    sm = cfg.shadow_map_size
    out, err = {}, 0.0
    for pname, mat, w, h, cull, jit in (
            ("camera", cam.clip_from_world, cfg.width, cfg.height, "back", fi.jitter),
            ("sun", fi.sun_from_world, sm, sm, "none", None)):
        def kernel():
            return setup.transform_and_setup(tri_pos, mat, w, h, cull=cull, jitter=jit)

        def plain():
            return _setup_plain(tri_pos, mat, w, h, cull, jit)

        got = kernel()
        err = max(err, _setup_equal(got, plain(), f"setup path A {pname} pass"))
        ms_min, ms = cuda_ms(kernel)
        dev_min, dev_ms = cuda_ms(kernel, hold=True)
        plain_ms = cuda_ms(plain, reps=5, rounds=3)[1]
        plain_dev_ms = cuda_ms(plain, reps=5, rounds=3, hold=True)[1]
        plain_events, plain_prof_ms = device_events(plain)
        events, _ = device_events(kernel)
        n = tri_pos.shape[0]
        nbytes = (n * 9 * 4 + mat.numel() * 4 + (jit.numel() * 4 if jit is not None else 0)
                  + sum(t.numel() * t.element_size() for t in got))
        bound_ms, bound_by = _bound(n, nbytes, SETUP_FLOPS)
        out[pname] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                          plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                          plain_events=plain_events, plain_profiled_ms=plain_prof_ms,
                          events=events, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                          flops=n * SETUP_FLOPS, triangles=n, valid=int(got.valid.sum()),
                          shape=f"{w}x{h} cull={cull}")
        print(f"setup vs plain: path A {pname} pass {w}x{h} cull={cull}"
              f"{', jitter' if jit is not None else ''}: {n} triangles ({out[pname]['valid']} "
              f"valid) bit for bit; kernel {events} device event(s), as called {ms:.4f} ms "
              f"median ({ms_min:.4f} min), device {dev_ms:.4f} ({dev_min:.4f}); plain chain "
              f"{plain_events} device events, as called {plain_ms:.3f} ms, device "
              f"{plain_dev_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
              f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / dev_ms:.1f}% of the bound on the device",
              flush=True)
    ptxas = _ptxas_entry(BUILD_LOGS.get("setup", ""), "setup_kernel")
    print(f"setup kernel: ptxas {ptxas}", flush=True)
    out["ptxas"] = ptxas
    return out, err


def _setup_entry(setup_random, setup_real, paths, sharded, app):
    """The kernels line's setup entry: path A's camera pass, its sun pass
    beside it, launches of every counted run."""
    n_cases, err = setup_random
    stats, err_real = setup_real
    cam, sun = stats["camera"], stats["sun"]
    return {
        "name": "setup", "route": "cuda",
        "source": "vulkan_pbr_renderer_tpu_torch/csrc/setup.cu",
        "replaces": "vulkan_pbr_renderer_tpu/raster/setup.py:65",
        "replaces_also": "vulkan_pbr_renderer_tpu/raster/setup.py:171",
        "note": "not a Pallas kernel: the JAX package transforms and sets up the triangles "
                "in XLA (transform_to_clip, setup_triangles) outside any kernel",
        "launches": paths["A"]["setup_launches"], "max_abs_err": max(err, err_real),
        "seeded_cases": n_cases,
        "ms": cam["ms"], "ms_min": cam["ms_min"], "plain_ms": cam["plain_ms"],
        "bound_ms": cam["bound_ms"], "bound_by": cam["bound_by"], "library_ms": None,
        "share_of_bound": cam["bound_ms"] / cam["ms"], "device_ms": cam["device_ms"],
        "device_ms_min": cam["device_ms_min"],
        "device_share_of_bound": cam["bound_ms"] / cam["device_ms"],
        "plain_device_ms": cam["plain_device_ms"], "plain_events": cam["plain_events"],
        "events": cam["events"], "bytes": cam["bytes"], "flops": cam["flops"],
        "shape": f"path A camera pass, {cam['triangles']} triangles, {cam['shape']}",
        "path": "A", "sun_pass": sun, "ptxas": stats["ptxas"],
        "launches_by_path": {k: v["setup_launches"] for k, v in paths.items()},
        "launches_sharded": {k: v["setup_launches"] for k, v in sharded.items()},
        "launches_headless": app["headless"]["setup_launches"],
        "launches_headless_scenes": {k: v["setup_launches"]
                                     for k, v in app["headless_scenes"].items()},
        "launches_preview": app["preview"]["setup_launches"]}


# ---------------------------------------------------------------------------
# phase 3h: voxelize (csrc/voxelize.cu)


def _voxel_inputs():
    """tests/test_torch_voxelize_inputs.py: seed-made voxelize sets."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_voxelize_inputs

    return test_torch_voxelize_inputs


def _voxel_case(name, dev):
    """A seeded set on dev: (scene, the arguments after it, keywords)."""
    import types

    from vulkan_pbr_renderer_tpu_torch.shade import shadow

    vin = _voxel_inputs()
    s = vin.SETS[name]()
    packed, scale = vin.atlas()
    scene = types.SimpleNamespace(
        tri_attr=torch.from_numpy(s["tri_attr"]).to(dev),
        mat_id=torch.from_numpy(s["mat_id"]).to(dev),
        tex_packed=torch.from_numpy(packed).to(dev), tex_scale=torch.from_numpy(scale).to(dev))
    m, d = shadow.sun_matrices(*s["sun"])
    args = (vin.GRID, vin.SCALE, torch.from_numpy(vin.sun_depth()).to(dev), m.to(dev),
            d.to(dev), torch.from_numpy(vin.EMISSION).to(dev))
    return scene, args, dict(total_samples=vin.TOTAL, texture_lod=s["texture_lod"])


def _voxel_same(scene, args, kw, what):
    """The two kernels (one launch each) against the plain chain on the
    card: the words and the decoded grid bit for bit.  Returns (the
    decoded grids' max abs difference, the kernel's words)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    before = (gi.voxelize_scene.launches, gi.decode_voxel_grid.launches)
    words = gi.voxelize_scene(scene, *args, **kw)
    grid = gi.decode_voxel_grid(words)
    check((gi.voxelize_scene.launches, gi.decode_voxel_grid.launches)
          == (before[0] + 1, before[1] + 1), f"{what}: not one launch of each kernel")
    want = gi.voxelize_scene_plain(scene, *args, **{k: v for k, v in kw.items() if k != "plan"})
    want_grid = gi.decode_voxel_grid_plain(want)
    torch.cuda.synchronize()
    check(words.dtype == torch.int64 and words.shape == want.shape
          and grid.shape == want_grid.shape, f"{what}: shapes {words.shape} {grid.shape}")
    check(bool(torch.isfinite(grid).all()), f"{what}: non-finite values")
    err = float((grid - want_grid).abs().max())
    check(torch.equal(words, want), f"{what}: {int((words != want).sum())} words differ")
    check(torch.equal(grid.view(torch.int32), want_grid.view(torch.int32)),
          f"{what}: decoded grid not the plain version's bits (max abs err {err})")
    return err, words


def _pass_same(scene, args, kw, what):
    """voxelize_pass_kernel (one launch of voxelize_lightgrid, no launch of
    the int64 route) against the plain chain on the card: the decoded grid
    bit for bit.  Returns (the max abs difference, the grid)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    counters = (gi.voxelize_lightgrid, gi.voxelize_scene, gi.decode_voxel_grid)
    before = [f.launches for f in counters]
    grid = gi.voxelize_lightgrid(scene, *args, **kw)
    check([f.launches - b for f, b in zip(counters, before)] == [1, 0, 0],
          f"{what}: not one launch of the pass alone")
    plain_kw = {k: v for k, v in kw.items() if k != "plan"}
    want = gi.decode_voxel_grid_plain(gi.voxelize_scene_plain(scene, *args, **plain_kw))
    torch.cuda.synchronize()
    check(grid.shape == want.shape and grid.dtype == torch.float32,
          f"{what}: shape {grid.shape} {grid.dtype}")
    check(bool(torch.isfinite(grid).all()), f"{what}: non-finite values")
    err = float((grid - want).abs().max())
    differ = int((grid != want).any(-1).sum())
    check(torch.equal(grid.view(torch.int32), want.view(torch.int32)),
          f"{what}: the pass's grid not the plain chain's bits ({differ} voxels differ, max "
          f"abs err {err})")
    return err, grid


def phase_voxelize(dev):
    """The frame's pass (voxelize_pass_kernel, one launch of
    voxelize_lightgrid) against the plain chain on the card, the decoded
    grid bit for bit, on the seeded sets of tests/test_torch_voxelize_inputs.py
    (the one-sample set without a search), with the plan passed in and the
    emission by value, a 65,536-sample stream, a 128^3 grid and a
    one-sample stream cut below its triangles and the planes set in a
    stream of exactly its triangle count (the search route); the
    sharded frame's route (voxelize_kernel and decode_voxel_kernel) words
    and grid bit for bit, one launch each a call, on the same sets: each
    whole and with the emission by value; planes, cut and outside in 2, 4
    and 8 shards (slices that start inside a run), the shards' max equal
    to the whole; the long stream and 128^3; random words through the
    decode; refusals (an atlas off its 16-byte line, a strided sun map,
    material ids past the layers, a plan of another scene) that launch
    nothing.  Returns (cases, max abs err)."""
    import types

    from vulkan_pbr_renderer_tpu_torch.shade import gi

    vin = _voxel_inputs()
    n_cases, err, carried, one_sample = 0, 0.0, 0, []
    for name in vin.NAMES:
        scene, args, kw = _voxel_case(name, dev)
        plan = gi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TOTAL)
        if plan.one_sample:
            one_sample.append(name)
        e, grid = _pass_same(scene, args, {**kw, "plan": plan}, f"voxelize pass {name}")
        by_value = args[:5] + (tuple(vin.EMISSION.tolist()),)
        e2, grid2 = _pass_same(scene, by_value, kw, f"voxelize pass {name} by value")
        check(torch.equal(grid, grid2), f"voxelize pass {name}: the emission by value differs")
        e3, whole = _voxel_same(scene, args, {**kw, "plan": plan}, f"voxelize {name}")
        err, n_cases = max(err, e, e2, e3), n_cases + 3
        check(torch.equal(gi.voxelize_scene(scene, *by_value, **kw), whole),
              f"voxelize {name}: the emission by value gives another grid")
        check(torch.equal(gi.decode_voxel_grid(whole), grid),
              f"voxelize {name}: the int64 route's grid is not the pass's")
        if name not in ("planes", "cut", "outside"):
            continue
        starts = set(plan.offsets.tolist())
        for shards in (2, 4, 8):
            parts = []
            for i in range(shards):
                e, p = _voxel_same(scene, args, {**kw, "shard_idx": i, "shard_count": shards,
                                                 "plan": plan},
                                   f"voxelize {name} shard {i} of {shards}")
                err, n_cases = max(err, e), n_cases + 1
                parts.append(p)
                start = i * vin.TOTAL // shards
                carried += start < plan.n_total and start not in starts
            check(torch.equal(torch.stack(parts).amax(0), whole),
                  f"voxelize {name}: the max of {shards} shards is not the whole grid")
    check(carried > 0, "voxelize: no shard started inside a run")
    check(one_sample == ["one_sample"], f"voxelize: one-sample plans {one_sample}")
    scene, args, kw = _voxel_case("planes", dev)
    for what, a, k in (("a 65,536-sample stream", args, {**kw, "total_samples": 1 << 16}),
                       ("a 128^3 grid", (128,) + args[1:], kw)):
        e, _ = _voxel_same(scene, a, k, f"voxelize {what}")
        e2, _ = _pass_same(scene, a, k, f"voxelize pass {what}")
        err, n_cases = max(err, e, e2), n_cases + 2
    one, one_args, one_kw = _voxel_case("one_sample", dev)
    cut = {**one_kw, "total_samples": vin.TRIS - 7}
    check(not gi._VoxelPlan(one, vin.GRID, vin.SCALE, 4.0, vin.TRIS - 7).one_sample,
          "voxelize: a cut one-sample stream kept the one-sample flag")
    e, _ = _pass_same(one, one_args, cut, "voxelize pass, a cut one-sample stream")
    err, n_cases = max(err, e), n_cases + 1
    # multi-sample triangles in a stream of exactly their count: the search route
    exact = {**kw, "total_samples": vin.TRIS}
    check(not gi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TRIS).one_sample,
          "voxelize: planes in a stream of its triangle count kept the one-sample flag")
    e, _ = _pass_same(scene, args, exact, "voxelize pass, planes in T samples")
    e2, _ = _voxel_same(scene, args, exact, "voxelize, planes in T samples")
    err, n_cases = max(err, e, e2), n_cases + 2
    words = torch.from_numpy(np.random.default_rng(20).integers(
        0, 1 << 32, (33, 17, 9), dtype=np.int64)).to(dev)
    words[0, 0, :5] = 0
    check(torch.equal(gi.decode_voxel_grid(words).view(torch.int32),
                      gi.decode_voxel_grid_plain(words).view(torch.int32)),
          "decode_voxel: random words not the plain version's bits")
    counters = (gi.voxelize_lightgrid, gi.voxelize_scene, gi.decode_voxel_grid)
    before = [f.launches for f in counters]
    raw = torch.empty(scene.tex_packed.numel() + 8, dtype=torch.uint8, device=dev)
    plan = gi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TOTAL)
    fewer = types.SimpleNamespace(**{**vars(scene), "tri_attr": scene.tri_attr[:-1],
                                     "mat_id": scene.mat_id[:-1]})
    for fn in (gi.voxelize_scene, gi.voxelize_lightgrid):
        for sc, a, k, match in (
                (types.SimpleNamespace(**{**vars(scene),
                                          "tex_packed": raw[8:].view(scene.tex_packed.shape)}),
                 args, kw, "16-byte"),
                (scene, args[:2] + (args[2].t(),) + args[3:], kw, "contiguous"),
                (types.SimpleNamespace(**{**vars(scene), "mat_id": scene.mat_id + vin.LAYERS}),
                 args, kw, "layers"),
                (fewer, args, {**kw, "plan": plan}, "plan was made")):
            try:
                fn(sc, *a, **k)
                check(False, f"{fn.__name__}: a call that should raise ({match}) did not")
            except ValueError as e:
                check(match in str(e), f"{fn.__name__}: refused with {e}")
    check([f.launches for f in counters] == before, "voxelize: a refused call launched")
    print(f"voxelize vs plain chain: {n_cases} seeded cases ({len(vin.NAMES)} sets through the "
          f"pass (twice) and the int64 route, 3 in 2 / 4 / 8 shards, {carried} slices starting "
          f"inside a run, a long stream, 128^3, a cut one-sample stream, planes in T samples), "
          f"decoded grids (and the int64 words) bit for bit; random words decoded bit for bit; "
          f"max abs err {err}",
          flush=True)
    return n_cases, err


def capture_voxelize_calls(renderer, cfg):
    """voxelize_lightgrid's arguments on path A's frame 0 (camera_path(0),
    sun SUN) and on the frame that moves the sun (camera_path(SUN_MOVE_FRAME
    / 7), SUN_MOVED), captured from Renderer.render from a fresh state (the
    state's plan among the keywords); the renderer's state is reset
    afterwards.  {frame: (args, kwargs)}."""
    from vulkan_pbr_renderer_tpu_torch.app import renderer as rmod
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    calls, original = [], gi.voxelize_lightgrid

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    # the wrapper counts its launches on the name it is called by
    record.launches = original.launches
    renderer.state = rmod.init_frame_state(renderer.cfg, renderer.device)
    gi.voxelize_lightgrid = record
    try:
        for i, sun in ((0, SUN), (SUN_MOVE_FRAME, SUN_MOVED)):
            renderer.render(rmod.make_camera(*suntemple.camera_path(i / (N_FRAMES - 1)), cfg,
                                             device="cuda"), sun)
    finally:
        original.launches = gi.voxelize_lightgrid.launches
        gi.voxelize_lightgrid = original
    renderer.state = rmod.init_frame_state(renderer.cfg, renderer.device)
    torch.cuda.synchronize()
    check(len(calls) == 2, f"voxelize real inputs: {len(calls)} calls in 2 sun passes")
    check(calls[0][1].get("plan") is not None and calls[0][1]["plan"] is calls[1][1]["plan"],
          "voxelize real inputs: the two sun passes did not pass the state's one plan")
    return {0: calls[0], SUN_MOVE_FRAME: calls[1]}


def _voxel_bytes(plan, work, scene, sun_depth, grid_size):
    """(the inputs' bytes, the word grid's, the decoded grid's): each input
    read once and each output written once.  The inputs: the offset (4 B)
    and the plain row (packrow's 19 halves, 38 B; the plan pads it to 40
    for 8-byte loads, which the bound does not count) of each triangle with
    a sample in the stream, the distinct atlas rows (48 B) and sun texels
    (4 B; the 2x2 windows) the samples below the total read, the matrices,
    scales and the sun's direction.  The int64 route writes the 8-byte
    words and its decode reads them and writes the f32 grid (16 B a voxel);
    the one-launch pass writes only the f32 grid (its u32 words stay in
    L2)."""
    live = work["in_range"]
    tris = int((plan.offsets < plan.n_total).sum())
    atlas_rows = int(torch.unique(work["atlas_rows"][live]).numel())
    s = sun_depth.shape[0]
    base = work["sun_texels"][live]
    iy, ix = base // s, base % s
    texels = torch.cat([torch.clamp(iy + dy, max=s - 1) * s + torch.clamp(ix + dx, max=s - 1)
                        for dy in (0, 1) for dx in (0, 1)])
    sun_texels = int(torch.unique(texels).numel())
    voxels = grid_size ** 3
    inputs = tris * (4 + 2 * 19) + atlas_rows * 48 + sun_texels * 4 + (
        scene.tex_scale.numel() * 4 + 16 * 4 + 2 * 3 * 4)
    return inputs, voxels * 8, voxels * 16, dict(triangles=tris, atlas_rows=atlas_rows,
                                                 sun_texels=sun_texels)


def phase_voxelize_real(calls):
    """The pass and the int64 route on path A's frame-0 and sun-move
    voxelize inputs (1,048,576-sample stream capped to the scene's, the
    2048^2 sun map, 128^3, the state's plan): bits against the plain chain,
    samples and occupied voxels; the pass's time (voxelize_lightgrid, one
    launch) and the int64 route's (each kernel and both) as called and on
    the device alone (median and min of KERNEL_ROUNDS x KERNEL_REPS) with
    their device events, the plain chain's times and device events, the
    byte and flop bounds; ptxas registers and spills, the pass's resident
    blocks."""
    from pass_profile import device_events
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    out = {}
    for frame, (args, kw) in calls.items():
        scene, grid_size, scale, sun_depth = args[:4]
        plan = kw["plan"]
        plain_kw = {k: v for k, v in kw.items() if k != "plan"}
        work = {}
        err, grid = _pass_same(scene, args[1:], kw, f"voxelize pass path A frame {frame}")
        e2, words = _voxel_same(scene, args[1:], kw, f"voxelize path A frame {frame}")
        err = max(err, e2)
        gi.voxelize_scene_plain(*args, **plain_kw, work=work)
        in_bytes, word_bytes, grid_bytes, counts = _voxel_bytes(plan, work, scene, sun_depth,
                                                                grid_size)
        samples, voxels = plan.n_total, grid_size ** 3
        occupied = int((words != 0).sum())

        def lightgrid():
            return gi.voxelize_lightgrid(*args, **kw)

        def vox():
            return gi.voxelize_scene(*args, **kw)

        def dec():
            return gi.decode_voxel_grid(words)

        def both():
            return gi.decode_voxel_grid(gi.voxelize_scene(*args, **kw))

        def plain():
            return gi.decode_voxel_grid_plain(gi.voxelize_scene_plain(*args, **plain_kw))

        st = {}
        for name, fn, nbytes, flops in (
                ("lightgrid", lightgrid, in_bytes + grid_bytes,
                 samples * VOXEL_FLOPS + voxels * DECODE_FLOPS),
                ("voxelize", vox, in_bytes + word_bytes, samples * VOXEL_FLOPS),
                ("decode", dec, word_bytes + grid_bytes, voxels * DECODE_FLOPS),
                ("pass", both, in_bytes + 2 * word_bytes + grid_bytes,
                 samples * VOXEL_FLOPS + voxels * DECODE_FLOPS)):
            ms_min, ms = cuda_ms(fn)
            dev_min, dev_ms = cuda_ms(fn, hold=True)
            bound_ms, bound_by = _bound(flops, nbytes, flops_per=1)
            events, prof_ms = device_events(fn)
            st[name] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min,
                            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                            events=events, profiled_ms=prof_ms)
        plain_parts = {
            "voxelize": lambda: gi.voxelize_scene_plain(*args, **plain_kw),
            "decode": lambda: gi.decode_voxel_grid_plain(words), "pass": plain}
        for name, fn in plain_parts.items():
            st[name]["plain_ms"] = cuda_ms(fn, reps=2, rounds=3)[1]
            st[name]["plain_device_ms"] = cuda_ms(fn, reps=2, rounds=3, hold=True)[1]
            st[name]["plain_events"], st[name]["plain_profiled_ms"] = device_events(fn)
        for key in ("plain_ms", "plain_device_ms", "plain_events", "plain_profiled_ms"):
            st["lightgrid"][key] = st["pass"][key]
        out[frame] = dict(st, samples=samples, occupied=occupied, max_abs_err=err,
                          bit_equal=True, one_sample=plan.one_sample, **counts)
        p, r = st["lightgrid"], st["pass"]
        print(f"voxelize vs plain chain: path A frame {frame} ({samples} samples, "
              f"{counts['triangles']} triangles, one-sample stream {plan.one_sample}, "
              f"{occupied} occupied voxels of {voxels}): grid bit for bit; the pass "
              f"(voxelize_lightgrid) {p['events']} device event(s), as called {p['ms']:.4f} ms "
              f"median ({p['ms_min']:.4f} min), device {p['device_ms']:.4f} "
              f"({p['device_ms_min']:.4f}); the int64 route (memset + 2 kernels) {r['events']} "
              f"device events, as called {r['ms']:.4f} ms, device {r['device_ms']:.4f}; plain "
              f"chain {p['plain_events']} device events, as called {p['plain_ms']:.3f} ms, "
              f"device {p['plain_device_ms']:.3f} ms; the pass's bound {p['bound_ms']:.4f} ms "
              f"({p['bound_by']}, {p['bytes'] / 1e6:.2f} MB: {counts['atlas_rows']} atlas "
              f"rows, {counts['sun_texels']} sun texels, the f32 grid), "
              f"{100 * p['bound_ms'] / p['device_ms']:.1f}% of it on the device (the int64 "
              f"route's bound {r['bound_ms']:.4f} ms, {r['bytes'] / 1e6:.2f} MB, "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f}%); card {nvidia_smi()}", flush=True)
        for name in ("voxelize", "decode"):
            k = st[name]
            print(f"  {name} kernel (int64 route): {k['events']} device event(s), as called "
                  f"{k['ms']:.4f} ms ({k['ms_min']:.4f} min), device {k['device_ms']:.4f} "
                  f"({k['device_ms_min']:.4f}); plain {k['plain_ms']:.3f} ms as called, "
                  f"{k['plain_events']} device events; bound {k['bound_ms']:.4f} ms "
                  f"({k['bound_by']}, {k['bytes'] / 1e6:.2f} MB, {k['flops'] / 1e9:.3f} GFLOP), "
                  f"{100 * k['bound_ms'] / k['device_ms']:.1f}% of the bound on the device",
                  flush=True)
    log = BUILD_LOGS.get("voxelize", "")
    out["ptxas"] = {"lightgrid": _ptxas_entry(log, "voxelize_pass_kernel"),
                    "voxelize": _ptxas_entry(log, "voxelize_kernel"),
                    "decode": _ptxas_entry(log, "decode_voxel_kernel")}
    out["occupancy"] = cuda_build.query_ints(gi._voxel_library(), "voxelize_pass_occupancy",
                                             ("registers", "local_bytes", "blocks_per_sm"))
    print(f"voxelize kernels: ptxas {out['ptxas']}; the pass's kernel {out['occupancy']}",
          flush=True)
    return out


def _voxel_entries(voxel_random, real, paths, sharded, app):
    """The kernels line's voxelize_lightgrid entry (the frame's pass; path
    A's frame-0 inputs, the sun-move frame's beside them, launches of every
    counted run) and the row-sharded frame's voxelize and decode_voxel
    entries (the same inputs; launches of the sharded K1 run)."""
    n_cases, err = voxel_random
    f0, f5 = real[0], real[SUN_MOVE_FRAME]
    err = max(err, f0["max_abs_err"], f5["max_abs_err"])
    entries = []
    for name, key, replaces, kernel in (
            ("voxelize_lightgrid", "lightgrid", "vulkan_pbr_renderer_tpu/shade/gi.py:120",
             "voxelize_pass_kernel"),
            ("voxelize", "voxelize", "vulkan_pbr_renderer_tpu/shade/gi.py:120",
             "voxelize_kernel"),
            ("decode_voxel", "decode", "vulkan_pbr_renderer_tpu/shade/gi.py:309",
             "decode_voxel_kernel")):
        k = f0[key]
        on_a = name == "voxelize_lightgrid"
        entries.append({
            "name": name, "route": "cuda",
            "source": "vulkan_pbr_renderer_tpu_torch/csrc/voxelize.cu",
            "replaces": replaces, "kernel": kernel,
            "note": "not a Pallas kernel: the JAX package voxelizes and decodes in XLA "
                    "(scatter + cummax fills, gathers, a window pack, a scatter-max) outside "
                    "any kernel" + ("" if on_a else "; the row-sharded frame's route (int64 "
                                    "words, max-combined over the ranks before the decode)"),
            "launches": (paths["A"]["slice_launches"][name] if on_a
                         else sharded["vis_folded"]["slice_launches"][name]),
            "max_abs_err": err, "bit_equal": True, "seeded_cases": n_cases,
            "ms": k["ms"], "ms_min": k["ms_min"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
            "share_of_bound": k["bound_ms"] / k["ms"], "device_ms": k["device_ms"],
            "device_ms_min": k["device_ms_min"],
            "device_share_of_bound": k["bound_ms"] / k["device_ms"],
            "plain_device_ms": k["plain_device_ms"], "plain_events": k["plain_events"],
            "events": k["events"], "bytes": k["bytes"], "flops": k["flops"],
            "shape": f"path A frame 0, {f0['samples']} samples, 128^3 grid",
            "path": "A" if on_a else "sharded (K1, 2 ranks)", "int64_pass": f0["pass"],
            "sun_move_frame": f5[key], "sun_move_frame_int64_pass": f5["pass"],
            "samples": f0["samples"], "one_sample": f0["one_sample"],
            "occupied": [f0["occupied"], f5["occupied"]],
            "ptxas": real["ptxas"][key],
            "launches_by_path": {p: v["slice_launches"][name] for p, v in paths.items()},
            "launches_sharded": {p: v["slice_launches"][name] for p, v in sharded.items()},
            "launches_headless": app["headless"]["slice_launches"][name],
            "launches_headless_scenes": {p: v["slice_launches"][name]
                                         for p, v in app["headless_scenes"].items()},
            "launches_preview": app["preview"]["slice_launches"][name]})
        if on_a:
            entries[-1]["occupancy"] = real["occupancy"]
    return entries


# ---------------------------------------------------------------------------
# phase 4: the main path


def phase_small_frame_vs_cpu():
    """160x96 plane + cube frames through the kernels on the card against the
    same frames through the plain path on the CPU: GI off (K1); fast GI
    (lightgrid 16) through K1 and through K2; reference GI; the
    REFERENCE_PRODUCT knobs (interleave, half-res trace depth); K1-hiz; the
    marched light shafts; the lightgrid view; the economy mode with the
    probes and the hiz screen mode; the hi-z and the probes screen terms;
    the wave-9 march (no kernel: eager on the card) under the trace and the
    probes; bloom off, whose card frames
    are a counted run of the post stack (every launch count set to 0 just
    before them and read just after: per frame 1 TAA and 1 tonemap launch
    of the per-level up kernel, no chain).  Returns ({variant: SSIM}, the
    bloom-off run's post launches)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import procedural
    from vulkan_pbr_renderer_tpu_torch.assets.scene import MaterialDesc, build_scene
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
    from vulkan_pbr_renderer_tpu_torch.utils.image import ssim

    base = RenderConfig(width=160, height=96, shadow_map_size=128, prefiltered_env_size=16,
                        prefiltered_env_min_size=8, prefilter_samples=256, brdf_lut_size=16,
                        brdf_lut_samples=256, bloom_pass_count=3, light_shaft_steps=4,
                        lightgrid_size=16, lightgrid_extent=10.0)
    scene = build_scene([procedural.make_plane((0, 0, 0), (12, 12), 2, 0),
                         procedural.make_cube((0, 0, 1.0), (2, 2, 2), 0)],
                        [MaterialDesc(orm_factor=(1.0, 0.5, 0.0))], texture_size=16,
                        device="cpu")
    cam = make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), base, device="cpu")
    variants = [("GI off, folded", base.replace(enable_gi=False)),
                ("GI on, folded", base),
                ("GI on, rowblock", base.replace(raster_kernel="rowblock")),
                ("reference GI", base.replace(gi_mode="reference")),
                ("reference product knobs", base.replace(
                    gi_mode="reference", gi_temporal_reference=True, gi_reference_depth_div=2)),
                ("GI on, hiz", base.replace(raster_hiz=True)),
                ("shaft march", base.replace(light_shaft_mode="march")),
                ("lightgrid view", base.replace(visualize_lightgrid=True)),
                ("bloom off", base.replace(enable_bloom=False)),
                ("economy mode, probes", base.replace(gi_fast_march=False,
                                                      gi_fast_screen_mode="probes")),
                ("economy mode, hiz", base.replace(gi_fast_march=False,
                                                   gi_fast_screen_mode="hiz")),
                ("hi-z screen term", base.replace(gi_fast_screen_mode="hiz")),
                ("probes screen term", base.replace(gi_fast_screen_mode="probes")),
                ("wave-9 march, trace", base.replace(gi_fast_fog_march=False)),
                ("wave-9 march, probes", base.replace(gi_fast_fog_march=False,
                                                      gi_fast_screen_mode="probes"))]
    out, bloom_off = {}, None
    for name, cfg in variants:
        imgs = {}
        for dev in ("cpu", "cuda"):
            # 14 triangles: "auto" would take the brute-force raster
            r = Renderer(cfg, scene, device=dev, raster_backend="pallas")
            counters = _zero_launches() if dev == "cuda" and not cfg.enable_bloom else None
            for i in range(3):
                img = r.render(cam, sun_angle=(40.0, 120.0 if i < 2 else 125.0))
            if counters is not None:
                torch.cuda.synchronize()
                bloom_off = _post_counts({k: fn.launches for k, fn in counters.items()})
                check(bloom_off == post_launches(cfg, 3), f"small frame ({name}): post "
                      f"launches {bloom_off}, expected {post_launches(cfg, 3)}")
                print(f"small frame 160x96 ({name}): post launches {bloom_off}", flush=True)
            imgs[dev] = img.cpu().numpy()
        s = ssim(imgs["cuda"], imgs["cpu"])
        check(s >= 0.995, f"small frame ({name}): card vs CPU SSIM {s} < 0.995")
        print(f"small frame 160x96 ({name}): card vs CPU plain path SSIM {s:.6f}",
              flush=True)
        out[name] = s
    return out, bloom_off


def _check_images(imgs, cfg, what):
    for i, img in enumerate(imgs):
        check(tuple(img.shape) == (cfg.height, cfg.width, 3), f"{what} frame {i} shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{what} frame {i} has non-finite values")
        lo, hi, sd = float(img.min()), float(img.max()), float(img.std())
        check(0.0 <= lo and hi <= 1.0, f"{what} frame {i} outside [0,1]: [{lo}, {hi}]")
        check(sd > 1e-3, f"{what} frame {i} is constant (std {sd})")


def _launch_counters():
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility, visibility_v2
    from vulkan_pbr_renderer_tpu_torch.shade import bloom, gi, gi_modes, lighting, shadow, taa
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb

    return {"setup": setup.transform_and_setup, "gbuffer": gb.gbuffer_pass, "gi_inputs": gi_modes.gi_lane_inputs,
            "shafts_polar": shadow.shafts_polar, "shade": lighting.shade,
            "sweep": gi.sweep_lightgrid_u8, "voxelize_lightgrid": gi.voxelize_lightgrid,
            "voxelize": gi.voxelize_scene, "decode_voxel": gi.decode_voxel_grid,
            "vis_folded": visibility_v2.vis_folded_tiles,
            "vis_folded_hiz": visibility_v2.vis_folded_hiz_tiles,
            "vis_rowblock": visibility.vis_rowblock_tiles,
            "gi_fast_ray": gi.fast_ray_resolve,
            "gi_reference_ray": gi.reference_ray_resolve,
            "gi_screen_ray": gi.screen_ray_resolve,
            "gi_probe_ray": gi.probe_ray_resolve,
            "binning": binning.bin_triangles,
            "taa_resolve": taa.taa_resolve,
            "bloom_down_chain": bloom.bloom_down_chain,
            "bloom_down_level": bloom.bloom_down_level,
            "bloom_up_chain": bloom.bloom_up_chain,
            "bloom_up_level": bloom.bloom_up_level}


def _fast_march(cfg):
    """The fog march of the fast GI shades cfg's frames (not the economy
    mode, the wave-9 march, the reference GI, GI off or the lightgrid
    view)."""
    return (cfg.enable_gi and cfg.gi_mode == "fast" and not cfg.visualize_lightgrid
            and cfg.gi_fast_march and cfg.gi_fast_fog_march)


def gi_launches(cfg, frames):
    """gi_fast_ray's launches over `frames` frames of cfg: one per ray, 2
    per frame, where the frame shades with the fast GI's fog march and the
    linear screen trace or no screen term."""
    trace = not cfg.gi_fast_screen_probe or cfg.gi_fast_screen_mode == "trace"
    return 2 * frames if _fast_march(cfg) and trace else 0


def screen_launches(cfg, frames):
    """gi_screen_ray's and gi_probe_ray's launches over `frames` frames of
    cfg: one per ray, 2 per frame, where the frame shades with the fog
    march and the probes or hiz screen term (gi_screen_ray) or in the
    economy mode (gi_probe_ray); none in the wave-9 march, which has no
    kernel."""
    screen = cfg.gi_fast_screen_probe and cfg.gi_fast_screen_mode != "trace"
    economy = (cfg.enable_gi and cfg.gi_mode == "fast" and not cfg.visualize_lightgrid
               and not cfg.gi_fast_march)
    return {"gi_screen_ray": 2 * frames if _fast_march(cfg) and screen else 0,
            "gi_probe_ray": 2 * frames if economy else 0}


def _zero_launches():
    counters = _launch_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _post_counts(launches):
    return {k: launches[k] for k in ("taa_resolve", "bloom_down_chain", "bloom_down_level",
                                     "bloom_up_chain", "bloom_up_level")}


def _read_launches(counters, want, what):
    """The launch counts since _zero_launches, each held against `want`
    (kernel name -> count; a kernel not named must not have launched)."""
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        check(n == want.get(k, 0), f"{what}: {k} launched {n} times, expected {want.get(k, 0)}")
    return launches


def run_path(name, cfg, scene, n_frames, real_check=None, gi_real=False, post_real=False,
             shade_real=False, ref_rays=(), screen_real=False, frame_events=False):
    """Drive one path through Renderer.render with every launch count set to
    0 just before it and read just after.  With real_check (phase_kernel_real
    or phase_hiz_real), first hold the path's kernel against its plain
    version on frame 0's real passes; with gi_real, gi_fast_ray on both
    rays' real lanes of frame 1 (phase_gi_real); with post_real, the post
    kernels on frame 1's post inputs (phase_post_real; all before the
    counted run); with shade_real, the G-buffer and lighting kernels on
    frame 1's inputs (phase_shade_real) and the path's frame through their
    plain versions (phase_plain_frame); with ref_rays (names of the
    reference GI's rays), gi_reference_ray on those rays' real lanes of
    frame 1 (phase_reference_real, in stats["reference_real"]); with
    screen_real, gi_screen_ray or gi_probe_ray on both rays' real lanes of
    frame 1 (phase_screen_real, in stats["screen_real"]); with
    frame_events, the device events and device ms of one more steady frame
    after the counted run (pass_profile.device_events).  Returns
    (stats, real-pass kernel stats or None, GI stats or None, post stats or
    None, slice stats or None)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.shade import gi_modes

    t0 = time.perf_counter()
    r = Renderer(cfg, scene, device="cuda")
    check(r.raster_backend == "pallas", f"path {name}: raster_backend {r.raster_backend}")
    torch.cuda.synchronize()
    print(f"path {name}: renderer + IBL bake on the card {time.perf_counter() - t0:.1f} s",
          flush=True)
    cams = [make_camera(*suntemple.camera_path(i / (N_FRAMES - 1)), cfg, device="cuda")
            for i in range(n_frames)]
    suns = [SUN_MOVED if i >= SUN_MOVE_FRAME else SUN for i in range(n_frames)]
    real = real_check(r, cams[0], SUN) if real_check is not None else None
    gi_stats = phase_gi_real(r, cams) if gi_real else None
    ref_stats = phase_reference_real(r, cams, name, ref_rays) if ref_rays else None
    screen_stats = phase_screen_real(r, cams, name) if screen_real else None
    post_stats = phase_post_real(*capture_post_call(r, cams), cfg) if post_real else None
    shade_stats = None
    if shade_real:
        calls = capture_slice_calls(r, cams)
        shade_stats = phase_shade_real(calls, cfg)
        shade_stats["sweep"] = phase_sweep_real(calls["sweep"])
        shade_stats["voxelize"] = phase_voxelize_real(capture_voxelize_calls(r, cfg))
        shade_stats["plain_frame"] = phase_plain_frame(r, cams)

    counters = _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_frames + 1)]
    imgs, voxelized, grid_sums = [], [], []
    events[0].record()
    for i in range(n_frames):
        before = r.state.voxelize_count
        imgs.append(r.render(cams[i], suns[i]))
        events[i + 1].record()
        voxelized.append(r.state.voxelize_count - before)
        grid_sums.append(r.state.lightgrid.abs().sum())
    # camera pass every frame + sun pass on frame 0 and when the sun moved
    sun_passes = sum(1 for i in range(n_frames) if i == 0 or suns[i] != suns[i - 1])
    expected = n_frames + sun_passes
    used = ("vis_rowblock" if cfg.raster_kernel == "rowblock"
            else "vis_folded_hiz" if cfg.raster_hiz else "vis_folded")
    # every raster pass sets up and bins its triangles once
    launches = _read_launches(counters, {used: expected, "binning": expected, "setup": expected,
                                         "gi_fast_ray": gi_launches(cfg, n_frames),
                                         "gi_reference_ray": reference_launches(cfg, n_frames),
                                         **screen_launches(cfg, n_frames),
                                         **post_launches(cfg, n_frames),
                                         **slice_launches(cfg, n_frames, sun_passes=sun_passes)},
                              f"path {name}")
    frame_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_frames)]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_images(imgs, cfg, f"path {name}")
    if cfg.enable_gi:
        want_vox = [1 if i == 0 or suns[i] != suns[i - 1] else 0 for i in range(n_frames)]
        check(voxelized == want_vox, f"path {name}: voxelize ran {voxelized}, expected {want_vox}")
        check(all(float(g) > 0.0 for g in grid_sums), f"path {name}: lightgrid is zero")
    ok, msg = r.check_overflow()
    check(ok, f"path {name}: {msg}")
    events = event_ms = None
    if frame_events:
        from pass_profile import device_events

        events, event_ms = device_events(lambda: r.render(cams[-1], suns[-1]))
        print(f"path {name}: one steady frame under torch.profiler: {events} device events, "
              f"{event_ms:.4f} device ms; card {nvidia_smi()}", flush=True)
    interleaved = ", interleaved" if gi_modes.gi_temporal_active(cfg) else ""
    gi_desc = f"on ({cfg.gi_mode}{interleaved})" if cfg.enable_gi else "off"
    print(f"path {name}: {n_frames} frames {cfg.width}x{cfg.height}, shadow "
          f"{cfg.shadow_map_size}^2, GI {gi_desc}, raster {cfg.raster_kernel}"
          f"{' hiz' if cfg.raster_hiz else ''}; launches {launches}; voxelize on frames "
          f"{[i for i, v in enumerate(voxelized) if v]}; {msg}", flush=True)
    print(f"path {name}: frame ms (CUDA events): " + " ".join(f"{t:.2f}" for t in frame_ms),
          flush=True)
    steady = [t for i, t in enumerate(frame_ms) if i > 0 and suns[i] == suns[i - 1]]
    med = float(np.median(steady))
    print(f"path {name}: steady frames (no sun redraw) median {med:.2f} ms; peak memory "
          f"{peak_gib:.2f} GiB; card {nvidia_smi()}", flush=True)
    return dict(launches=launches[used], gi_launches=launches["gi_fast_ray"],
                ref_launches=launches["gi_reference_ray"], reference_real=ref_stats,
                screen_launches={k: launches[k] for k in SCREEN_KERNELS},
                screen_real=screen_stats, frame_events=events, frame_device_ms=event_ms,
                binning_launches=launches["binning"], setup_launches=launches["setup"],
                post_launches=_post_counts(launches), slice_launches=_slice_counts(launches),
                frame_ms=frame_ms, steady_median_ms=med, peak_gib=peak_gib, kernel=used,
                shape=(cfg.height, cfg.width)), real, gi_stats, post_stats, shade_stats


def phase_k1_k2_ids(scene, cfg_a, cfg_b):
    """Frame 0's camera pass through K1 and K2 (outside the counted paths):
    the number of pixels whose ids differ.  Both keep the nearest depth and,
    on equal depths, the smallest id; they differ where K2's row-block cull
    skips a far sliver whose edges cover a pixel outside its bbox rows (12
    pixels on the SunTemple stand-in since the port began, PERF.md)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import _rasterize, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.utils import noise

    cam = make_camera(*suntemple.camera_path(0.0), cfg_a, device="cuda")
    jitter = torch.as_tensor(noise.taa_jitter(0, cfg_a.width, cfg_a.height), device="cuda")
    _, d_a, i_a, _ = _rasterize(scene, cam.clip_from_world, cfg_a.width, cfg_a.height, cfg_a,
                                jitter=jitter, backend="pallas")
    _, d_b, i_b, _ = _rasterize(scene, cam.clip_from_world, cfg_b.width, cfg_b.height, cfg_b,
                                jitter=jitter, backend="pallas")
    diff = int((i_a != i_b).sum())
    covered = int((i_a >= 0).sum())
    print(f"frame 0 camera pass: {diff} of {covered} covered pixels have ids that differ "
          "between K2 and K1", flush=True)
    return diff


def phase_fast_vs_reference(scene):
    """bench.py's fidelity number: the fast frame against the reference frame
    at full resolution, each GI mode from its own config, at each camera
    point of SSIM_POINTS after SSIM_SETTLE_FRAMES frames from a fresh
    temporal state (the camera nudged by 1e-6 every N_FRAMES frames, as
    bench.py's scans are) under sun SSIM_SUN; SSIM over the final sRGB
    images.  Both SSIMs and their mean are printed beside the JAX gate's
    floor: a mean below it is reported, not failed.  Also the mean frame ms
    of each mode over its last N_FRAMES frames at SSIM_POINT."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P, SUNTEMPLE_1080P_REFERENCE
    from vulkan_pbr_renderer_tpu_torch.utils.image import ssim

    imgs, ms = {}, {}
    for mode, cfg in (("fast", SUNTEMPLE_1080P), ("reference", SUNTEMPLE_1080P_REFERENCE)):
        r = Renderer(cfg, scene, device="cuda")
        for point in SSIM_POINTS:
            r.state = None          # each point settles from a fresh temporal state
            cams = [make_camera(*suntemple.camera_path(point + k * 1e-6), cfg, device="cuda")
                    for k in range(SSIM_SETTLE_FRAMES // N_FRAMES)]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for i in range(SSIM_SETTLE_FRAMES):
                if i == SSIM_SETTLE_FRAMES - N_FRAMES:
                    start.record()
                img = r.render(cams[i // N_FRAMES], SSIM_SUN)
            end.record()
            torch.cuda.synchronize()
            if point == SSIM_POINT:
                ms[mode] = start.elapsed_time(end) / N_FRAMES
            _check_images([img], cfg, f"fast vs reference ({mode}, point {point})")
            imgs[mode, point] = img.cpu().numpy()
        del r
        torch.cuda.empty_cache()
    by_point = {}
    for point in SSIM_POINTS:
        s = ssim(imgs["fast", point], imgs["reference", point])
        check(0.0 < s <= 1.0, f"fast vs reference SSIM {s} at point {point}")
        by_point[point] = s
        print(f"fast vs reference GI: SSIM {s:.6f} at 1920x1088 after {SSIM_SETTLE_FRAMES} "
              f"settled frames (camera_path({point}), sun {SSIM_SUN})", flush=True)
    mean = float(np.mean(list(by_point.values())))
    print(f"fast vs reference GI: mean SSIM {mean:.6f} over camera points {SSIM_POINTS}, "
          f"{'at or above' if mean >= SSIM_GATE_FLOOR else 'BELOW'} the JAX gate's floor "
          f"{SSIM_GATE_FLOOR} (report only); last {N_FRAMES} frames at camera_path({SSIM_POINT}) "
          f"{ms['fast']:.2f} ms fast, {ms['reference']:.2f} ms reference", flush=True)
    return dict(ssim=by_point[SSIM_POINT], ssim_by_point={str(k): v for k, v in by_point.items()},
                ssim_mean=mean, gate_floor=SSIM_GATE_FLOOR, settle_frames=SSIM_SETTLE_FRAMES,
                fast_ms=ms["fast"], reference_ms=ms["reference"])


def phase_paths():
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import (REFERENCE_PRODUCT, SUNTEMPLE_1080P,
                                                      SUNTEMPLE_1080P_ECONOMY,
                                                      SUNTEMPLE_1080P_GI_HIZ,
                                                      SUNTEMPLE_1080P_GI_PROBES,
                                                      SUNTEMPLE_1080P_HIZ, SUNTEMPLE_1080P_NO_GI,
                                                      SUNTEMPLE_1080P_REFERENCE,
                                                      SUNTEMPLE_1080P_ROWBLOCK)

    t0 = time.perf_counter()
    scene = build_scene(suntemple.build_parts(SCENE_DETAIL), suntemple.materials(),
                        texture_size=TEXTURE_SIZE, device="cuda")
    print(f"scene: {scene.num_tris} triangles, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(scene.num_tris == N_TRIS, f"expected {N_TRIS} triangles, got {scene.num_tris}")

    paths, real = {}, {"binning": phase_binning(scene), "setup": phase_setup_real(scene)}
    for name, cfg, n, real_check in (
            ("A", SUNTEMPLE_1080P, N_FRAMES_SHORT, phase_kernel_real),
            ("B", SUNTEMPLE_1080P_ROWBLOCK, N_FRAMES_SHORT, phase_kernel_real),
            ("no-GI", SUNTEMPLE_1080P_NO_GI, N_FRAMES_SHORT, None),
            ("C", SUNTEMPLE_1080P_REFERENCE, N_FRAMES, None),
            ("C-product", REFERENCE_PRODUCT, N_FRAMES, None),
            ("D", SUNTEMPLE_1080P_HIZ, N_FRAMES, phase_hiz_real),
            ("E", SUNTEMPLE_1080P_ECONOMY, N_FRAMES_SHORT, None),
            ("F", SUNTEMPLE_1080P_GI_HIZ, N_FRAMES_SHORT, None),
            ("G", SUNTEMPLE_1080P_GI_PROBES, N_FRAMES_SHORT, None)):
        stats, kernel_real, gi_stats, post_stats, shade_stats = run_path(
            name, cfg, scene, n, real_check, gi_real=name == "A", post_real=name == "A",
            shade_real=name == "A", ref_rays={"C": ("diffuse", "specular"),
                                              "C-product": ("diffuse",)}.get(name, ()),
            screen_real=name in ("E", "F", "G"), frame_events=name in ("A", "E", "F", "G"))
        paths[name] = stats
        if kernel_real is not None:
            real[stats["kernel"]] = kernel_real
        if gi_stats is not None:
            real["gi_fast_ray"] = gi_stats
        if post_stats is not None:
            real["post"] = post_stats
        if shade_stats is not None:
            real["shade"] = shade_stats
        torch.cuda.empty_cache()
    check(paths["C-product"]["shape"] == (1080, 1920), "C-product is not 1920x1080")
    diff = phase_k1_k2_ids(scene, SUNTEMPLE_1080P, SUNTEMPLE_1080P_ROWBLOCK)
    fidelity = phase_fast_vs_reference(scene)
    return scene, paths, real, diff, fidelity


# ---------------------------------------------------------------------------
# phase 5: the app surface


def _run_cli(argv, what):
    """app.headless.main(argv) in this process; its printed lines, echoed."""
    from vulkan_pbr_renderer_tpu_torch.app import headless

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        headless.main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"{what}: {line}", flush=True)
    check(not any(line.startswith("WARNING") for line in lines), f"{what}: the CLI warned")
    return lines


def _frame_ms_lines(lines):
    return [float(line.split()[2]) for line in lines if line.startswith("frame ")]


def _read_frames(out_dir, n, size):
    """The CLI's PNGs as uint8 arrays, in frame order."""
    from vulkan_pbr_renderer_tpu_torch.utils.image import read_png

    names = sorted(os.listdir(out_dir))
    check(names == [f"frame_{i:04d}.png" for i in range(n)], f"{out_dir}: files {names}")
    frames = [read_png(os.path.join(out_dir, name)) for name in names]
    for i, f in enumerate(frames):
        check(f.shape == (size[1], size[0], 3) and f.dtype == np.uint8,
              f"{out_dir}: frame {i} shape {f.shape} {f.dtype}")
    return frames


def phase_headless_full(tmp):
    """The CLI at full width, its frames against Renderer.render's, and where
    a frame's time goes (render to a synchronize, copy to the host, PNG
    encode: host clock, one process)."""
    from vulkan_pbr_renderer_tpu_torch.app import headless
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
    from vulkan_pbr_renderer_tpu_torch.utils.image import encode_png

    w, h = HEADLESS_SIZE
    out_dir = os.path.join(tmp, "headless_full")
    counters = _zero_launches()
    lines = _run_cli(["--scene", "suntemple", "--detail", str(SCENE_DETAIL), "--width", str(w),
                      "--height", str(h), "--frames", str(HEADLESS_FRAMES), "--texture-size",
                      str(TEXTURE_SIZE), "--bench", "--out", out_dir], "headless 1920x1088")
    launches = _read_launches(counters, {"vis_folded": HEADLESS_FRAMES + 1,
                                         "binning": HEADLESS_FRAMES + 1,
                                         "setup": HEADLESS_FRAMES + 1, "gi_fast_ray":
                                         gi_launches(RenderConfig(), HEADLESS_FRAMES),
                                         **post_launches(RenderConfig(), HEADLESS_FRAMES),
                                         **slice_launches(RenderConfig(), HEADLESS_FRAMES)},
                              "headless 1920x1088")
    check(lines[0] == f"scene suntemple: {N_TRIS} tris", f"headless: first line {lines[0]!r}")
    frame_ms = _frame_ms_lines(lines)
    check(len(frame_ms) == HEADLESS_FRAMES, f"headless: {len(frame_ms)} frame lines")
    bench = json.loads(lines[-1])
    check(bench["metric"] == f"suntemple_{w}x{h}_frame_ms_p50" and bench["unit"] == "ms"
          and bench["value"] > 0, f"headless: bench line {bench}")
    frames = _read_frames(out_dir, HEADLESS_FRAMES, HEADLESS_SIZE)

    cfg = RenderConfig(width=w, height=h)
    scene = headless.build_scene_by_name("suntemple", SCENE_DETAIL, TEXTURE_SIZE, device="cuda")
    r = Renderer(cfg, scene, device="cuda", raster_backend="auto")
    check(r.raster_backend == "pallas", f"headless: raster_backend {r.raster_backend}")
    # K1 against its plain version on every tile of the CLI's first camera
    # pass and of its sun pass at --sun's default (before the frames: the
    # jitter is frame 0's)
    _, kernel_err = phase_kernel_real(
        r, headless.camera_for("suntemple", 0.0, cfg, device="cuda"), HEADLESS_SUN)
    worst, split = 0, []
    for i, png in enumerate(frames):
        cam = headless.camera_for("suntemple", i / (HEADLESS_FRAMES - 1), cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render(cam, sun_angle=HEADLESS_SUN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = img.cpu().numpy()
        t2 = time.perf_counter()
        data = encode_png(host)
        t3 = time.perf_counter()
        split.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, len(data)))
        _check_images([img], cfg, f"headless direct frame {i}")
        check(float(png.std()) > 1.0, f"headless: PNG frame {i} is constant")
        want = (np.clip(host, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        diff = np.abs(png.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, int(diff.max()))
        check(diff.max() <= 1, f"headless: PNG frame {i} differs from Renderer.render's by "
              f"{int(diff.max())}/255 ({int((diff > 1).sum())} values above 1/255)")
        print(f"headless 1920x1088: frame {i} PNG vs Renderer.render: max {int(diff.max())}/255, "
              f"{int((diff > 0).sum())} of {diff.size} values differ", flush=True)
    steady = split[1:]
    med = [float(np.median([s[k] for s in steady])) for k in range(3)]
    print(f"headless 1920x1088: CLI frame ms {' '.join(f'{t:.1f}' for t in frame_ms)}; --bench "
          f"p50 {bench['value']} ms; launches {launches}; direct frames 1-{HEADLESS_FRAMES - 1} "
          f"median ms: render {med[0]:.2f}, fetch {med[1]:.2f}, PNG encode {med[2]:.2f} "
          f"({split[-1][3]} bytes); card {nvidia_smi()}", flush=True)
    del r, scene
    torch.cuda.empty_cache()
    return dict(launches=launches["vis_folded"], gi_launches=launches["gi_fast_ray"],
                binning_launches=launches["binning"], setup_launches=launches["setup"],
                post_launches=_post_counts(launches), slice_launches=_slice_counts(launches),
                frame_ms=frame_ms,
                bench_p50_ms=bench["value"],
                png_max_diff_255=worst, render_ms=med[0], fetch_ms=med[1], png_encode_ms=med[2],
                kernel_max_abs_err=kernel_err)


def _spheres_kernel_check(cfg):
    """Which input the spheres run had (the MetalRoughSpheres textures of the
    reference's resource mount, or flat factors without it), and K1 against
    its plain version on every tile of that run's first camera pass and of
    its sun pass: fewer work items than the kernel has persistent blocks."""
    from vulkan_pbr_renderer_tpu_torch.app import headless
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer

    mount = os.path.exists(os.path.join(headless.RESOURCE_DIR, "MetalRoughSpheres_Albedo.tga"))
    scene = headless.build_scene_by_name("spheres", device="cuda")
    res_dir, headless.RESOURCE_DIR = headless.RESOURCE_DIR, os.path.join(os.sep, "nonexistent")
    try:
        flat_scene = headless.build_scene_by_name("spheres", device="cuda")
    finally:
        headless.RESOURCE_DIR = res_dir
    flat = torch.equal(scene.tex_packed, flat_scene.tex_packed)
    check(flat == (not mount), f"headless spheres: resource mount present {mount}, but the "
          f"scene's textures equal the flat-factor ones: {flat}")
    print(f"headless spheres: input {'flat factors (no resource mount)' if flat else 'textured'}"
          f" ({res_dir})", flush=True)
    r = Renderer(cfg, scene, device="cuda", raster_backend="auto")
    check(r.raster_backend == "pallas", f"headless spheres: raster_backend {r.raster_backend}")
    stats, err = phase_kernel_real(r, headless.camera_for("spheres", 0.0, cfg, device="cuda"),
                                   HEADLESS_SUN)
    return dict(input="flat" if flat else "textured", kernel_max_abs_err=err,
                work_items={k: v["work_items"] for k, v in stats.items()},
                kernel_ms={k: v["ms"] for k, v in stats.items()})


def phase_headless_scenes(tmp):
    """triangle, cube and spheres through the CLI at its default size, then
    the module entry point as a subprocess."""
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=CLI_DEFAULT_SIZE[0], height=CLI_DEFAULT_SIZE[1])
    out = {}
    # 2 camera passes + the first frame's sun pass, each set up once (the
    # brute-force raster's scenes too)
    gi = {"gi_fast_ray": gi_launches(cfg, 2), "setup": 3, **post_launches(cfg, 2),
          **slice_launches(cfg, 2)}
    for name, want in (("triangle", gi), ("cube", gi),
                       ("spheres", {"vis_folded": 3, "binning": 3, **gi})):
        out_dir = os.path.join(tmp, f"headless_{name}")
        counters = _zero_launches()
        lines = _run_cli(["--scene", name, "--frames", "2", "--out", out_dir],
                         f"headless {name}")
        launches = _read_launches(counters, want, f"headless {name}")
        frames = _read_frames(out_dir, 2, CLI_DEFAULT_SIZE)
        _check_images([torch.from_numpy(f.astype(np.float32) / 255.0) for f in frames], cfg,
                      f"headless {name}")
        out[name] = dict(launches=launches["vis_folded"], gi_launches=launches["gi_fast_ray"],
                         binning_launches=launches["binning"], setup_launches=launches["setup"],
                         post_launches=_post_counts(launches),
                         slice_launches=_slice_counts(launches), frame_ms=_frame_ms_lines(lines),
                         tris=int(lines[0].split()[2]))
        print(f"headless {name}: {out[name]['tris']} triangles, 2 frames "
              f"{cfg.width}x{cfg.height} ok; launches {launches}; card {nvidia_smi()}",
              flush=True)
    check(out["spheres"]["tris"] > 4096 >= out["cube"]["tris"], "headless: scene sizes")
    out["spheres"].update(_spheres_kernel_check(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "vulkan_pbr_renderer_tpu_torch.app.headless", "--scene", "cube",
         "--frames", "2"], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"python -m ...app.headless exited {proc.returncode}:\n"
          f"{proc.stdout}{proc.stderr}")
    sub_lines = proc.stdout.strip().splitlines()
    check(sub_lines[0] == "scene cube: 14 tris" and len(_frame_ms_lines(sub_lines)) == 2,
          f"python -m ...app.headless printed {sub_lines}")
    print("headless subprocess (python -m ...app.headless --scene cube --frames 2): exit 0; "
          + "; ".join(sub_lines), flush=True)
    return out


def phase_preview():
    """A PreviewSession over a real Renderer on the card, driven over HTTP."""
    import urllib.request

    from vulkan_pbr_renderer_tpu_torch.app import headless, preview
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
    from vulkan_pbr_renderer_tpu_torch.device import init_devices
    from vulkan_pbr_renderer_tpu_torch.utils import image as imglib

    dev = init_devices()
    check(dev.type == "cuda", f"init_devices returned {dev}")
    cfg = RenderConfig(width=PREVIEW_SIZE[0], height=PREVIEW_SIZE[1])
    scene = headless.build_scene_by_name("suntemple", detail=1.0, texture_size=PREVIEW_TEXTURE,
                                         device=dev)
    r = Renderer(cfg, scene, device=dev, raster_backend="auto")
    check(r.raster_backend == "pallas", f"preview: raster_backend {r.raster_backend}")
    step = preview.renderer_step(r)
    session = preview.PreviewSession(step, cfg, device=dev)
    server = preview.serve(session, port=0, run_loop=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(events):
        req = urllib.request.Request(f"{base}/input", data=json.dumps(events).encode(),
                                     method="POST")
        check(urllib.request.urlopen(req, timeout=30).status == 200, "preview: POST /input")

    try:
        check(b"frame.png" in urllib.request.urlopen(f"{base}/", timeout=30).read(),
              "preview: the page does not name frame.png")
        pos0, yaw0 = session.camera.pos.copy(), session.camera.yaw
        # K1 against its plain version on every tile of both passes, from the
        # session's starting camera
        kstats, kernel_err = phase_kernel_real(r, session.camera.matrices(cfg, device=dev),
                                               session.sun_angle)
        counters = _zero_launches()
        post([["press", "KeyW"], ["press", "MouseRight"], ["mouse", 40, 10]])
        session.tick()
        time.sleep(0.02)        # the camera's step is as long as the tick took
        session.tick()
        post([["press", "KeyG"]])
        session.tick()
        # 3 camera passes + the sun pass of the first frame; the GI rays of
        # the 2 frames before the lightgrid view
        launches = _read_launches(counters, {"vis_folded": 4, "binning": 4, "setup": 4,
                                             "gi_fast_ray": gi_launches(cfg, 2),
                                             **post_launches(cfg, 3),
                                             **slice_launches(cfg, 3, view_frames=1)},
                              "preview")
        check(session.camera.pos[1] > pos0[1] and session.camera.yaw != yaw0,
              f"preview: the camera did not move ({session.camera.pos}, yaw {session.camera.yaw})")
        check(session.visualize_lightgrid and session.frame_count == 3
              and r.state.frame_idx == 3, "preview: the lightgrid view is not on after KeyG")
        resp = urllib.request.urlopen(f"{base}/frame.png", timeout=30)
        data = resp.read()
        jpeg = data[:2] == b"\xff\xd8"
        check(jpeg or data[:8] == b"\x89PNG\r\n\x1a\n", "preview: /frame.png is no image")
        check(resp.headers["Content-Type"] == ("image/jpeg" if jpeg else "image/png"),
              f"preview: mime {resp.headers['Content-Type']}")
        stats = urllib.request.urlopen(f"{base}/stats", timeout=30).read().decode()
        check("frame 3" in stats and "[lightgrid]" in stats, f"preview: stats {stats!r}")
        print(f"preview {cfg.width}x{cfg.height}: {scene.num_tris} triangles; 3 ticks over HTTP "
              f"ok; launches {launches}; /frame.png {len(data)} bytes "
              f"{'JPEG' if jpeg else 'PNG'}; stats: {stats}", flush=True)

        # steady ticks in the normal view, then the split of a tick
        post([["press", "KeyG"]])
        tick_ms = []
        for _ in range(6):
            session.tick()
            tick_ms.append(session.frame_ms)
        check(not session.visualize_lightgrid, "preview: the lightgrid view stayed on")
        split = []
        for _ in range(5):
            cam = session.camera.matrices(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = step(cam, session.sun_angle, False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = img.cpu().numpy()
            t2 = time.perf_counter()
            imglib.encode_jpeg(host)
            t3 = time.perf_counter()
            imglib.encode_png(host)
            t4 = time.perf_counter()
            split.append([(b - a) * 1e3 for a, b in ((t0, t1), (t1, t2), (t2, t3), (t3, t4))])
        _check_images([img], cfg, "preview")
        med = [float(np.median([s[k] for s in split])) for k in range(4)]
        tick = float(np.median(tick_ms[1:]))
        print(f"preview {cfg.width}x{cfg.height}: tick frame_ms "
              f"{' '.join(f'{t:.1f}' for t in tick_ms)} (median of the last 5 {tick:.2f}); split, "
              f"median of 5: render {med[0]:.2f} ms, fetch {med[1]:.2f}, stream encode "
              f"({'JPEG' if jpeg else 'PNG'}) {med[2]:.2f} = {100 * med[2] / tick:.1f}% of a "
              f"tick, stdlib PNG encode {med[3]:.2f}; card {nvidia_smi()}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
    del r, scene
    torch.cuda.empty_cache()
    return dict(launches=launches["vis_folded"], gi_launches=launches["gi_fast_ray"],
                binning_launches=launches["binning"], setup_launches=launches["setup"],
                post_launches=_post_counts(launches), slice_launches=_slice_counts(launches),
                tick_ms=tick, render_ms=med[0],
                fetch_ms=med[1], stream_encode_ms=med[2], stream_is_jpeg=jpeg,
                png_encode_ms=med[3], kernel_max_abs_err=kernel_err,
                work_items={k: v["work_items"] for k, v in kstats.items()},
                kernel_ms={k: v["ms"] for k, v in kstats.items()})


def phase_bake_and_loaders():
    """bake_irradiance at its defaults on the card against the CPU, and the
    native BC decoder (built with g++ from native/bcdec.cpp) against numpy."""
    from vulkan_pbr_renderer_tpu_torch.assets import dds, native_bcdec, procedural
    from vulkan_pbr_renderer_tpu_torch.bake import ibl
    from vulkan_pbr_renderer_tpu_torch.gpu import sampling

    env = torch.from_numpy(procedural.make_sky_cubemap(128))
    atlas = sampling.build_cube_mip_atlas(env)
    t0 = time.perf_counter()
    card = ibl.bake_irradiance(atlas, 128)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check(card.device.type == "cuda" and tuple(card.shape) == (6, 32, 32, 3),
          f"bake_irradiance: {card.shape} on {card.device}")
    cpu = ibl.bake_irradiance(atlas, 128, device="cpu")
    err = float((card.cpu() - cpu).abs().max())
    check(bool(torch.isfinite(card).all()) and float(card.min()) > 0.0,
          "bake_irradiance: not finite and positive")
    check(err <= IRRADIANCE_ATOL, f"bake_irradiance: card vs CPU {err} > {IRRADIANCE_ATOL}")
    print(f"bake_irradiance 32^2 x 1024 samples: card vs CPU max abs diff {err:.3e} "
          f"(atol {IRRADIANCE_ATOL}); first call on the card {(t1 - t0) * 1e3:.1f} ms", flush=True)
    raw = np.random.default_rng(0).integers(0, 256, 8 * 6 * 16, dtype=np.uint8).tobytes()
    native = "not built (no g++): numpy decode in use"
    for fmt, ref in (("BC1", dds.decode_bc1), ("BC3", dds.decode_bc3), ("BC5", dds.decode_bc5)):
        got = native_bcdec.decode(fmt, raw, 32, 24)
        if got is not None:
            bc_err = float(np.abs(got - ref(raw, 32, 24)).max())
            check(bc_err <= 1e-6, f"native {fmt} decode differs from numpy by {bc_err}")
            native = "built, BC1/BC3/BC5 equal to the numpy decode within 1e-6"
    print(f"native BC decoder: {native}", flush=True)
    return dict(irradiance_max_abs_err=err)


# ---------------------------------------------------------------------------
# phase 6: row bands and the row-sharded frame


def _band_kernels(cfg, cap):
    """Per kernel: (bins of a band, kernel on the bins, plain version on the
    bins, unfold to rows).  K2 walks SUNTEMPLE_1080P_ROWBLOCK's capacity."""
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P_ROWBLOCK
    from vulkan_pbr_renderer_tpu_torch.raster import binning, visibility
    from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as v2

    chunk, tcap = cfg.tri_chunk, SUNTEMPLE_1080P_ROWBLOCK.tile_capacity
    return {
        "vis_folded": (
            lambda s, w, rows, y0: binning.bin_triangles(s, w, rows, 32, cap, chunk, y_origin=y0),
            lambda b, y0: v2.vis_folded_tiles(b.starts, b.pair_data, b.tiles_x, y0),
            lambda b, y0: v2.vis_folded_plain(b.starts, b.pair_data, b.tiles_x, y_origin=y0),
            v2.unfold_tiles),
        "vis_folded_hiz": (
            lambda s, w, rows, y0: binning.bin_triangles(s, w, rows, 32, cap, chunk,
                                                         z_order=True, y_origin=y0),
            lambda b, y0: v2.vis_folded_hiz_tiles(b.starts, b.pair_data, b.chunk_minz,
                                                  b.tiles_x, y0),
            lambda b, y0: v2.vis_folded_hiz_plain(b.starts, b.pair_data, b.chunk_minz,
                                                  b.tiles_x, group=64, y_origin=y0),
            v2.unfold_tiles),
        "vis_rowblock": (
            lambda s, w, rows, y0: binning.bin_triangles(s, w, rows, 32, cap, chunk,
                                                         fmt="wide16", tile_w=128, y_origin=y0),
            lambda b, y0: visibility.vis_rowblock_tiles(b.starts, b.pair_data, b.tiles_x, tcap,
                                                        chunk, y0),
            lambda b, y0: visibility.vis_rowblock_plain(b.starts, b.pair_data, b.tiles_x, tcap,
                                                        chunk, y_origin=y0),
            visibility.unfold_tiles)}


def phase_row_bands(scene, dev="cuda"):
    """Each kernel on row bands of frame 0's real passes at SUNTEMPLE_1080P,
    each band with its y_origin, as the row-sharded frame calls them: the
    camera pass in CAMERA_BANDS bands of 544 rows, the 2048^2 sun pass in
    SUN_BANDS bands of 512.  Each band's depth and ids equal the same rows
    of the kernel's whole pass bit for bit, and its ids equal the plain
    version's on the band (depth exactly for K1-hiz and K2, within
    DEPTH_ATOL for K1).  Returns kernel -> (bands, max |depth diff|)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import (frame_inputs, init_frame_state,
                                                            make_camera)
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P as cfg
    from vulkan_pbr_renderer_tpu_torch.raster import setup

    cam = make_camera(*suntemple.camera_path(0.0), cfg, device=dev)
    fi = frame_inputs(init_frame_state(cfg, dev), cam, SUN, cfg)
    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    sm = cfg.shadow_map_size
    passes = {
        "camera": (setup.setup_triangles(setup.transform_to_clip(tri_pos, cam.clip_from_world,
                                                                 fi.jitter),
                                         cfg.width, cfg.height, cull="back"),
                   cfg.width, cfg.height, CAMERA_BANDS),
        "sun": (setup.setup_triangles(setup.transform_to_clip(tri_pos, fi.sun_from_world),
                                      sm, sm, cull="none"), sm, sm, SUN_BANDS)}
    out = {}
    for name, (bins_of, kernel, plain, unfold) in _band_kernels(
            cfg, cfg.pair_capacity_factor * scene.num_tris).items():
        err, n_bands = 0.0, 0
        for pname, (s, w, h, n) in passes.items():
            full = bins_of(s, w, h, 0)
            d_f, i_f = (unfold(a, full.tiles_y, full.tiles_x, h, w) for a in kernel(full, 0))
            rows = h // n
            for y0 in range(0, h, rows):
                b = bins_of(s, w, rows, y0)
                d_k, i_k = kernel(b, y0)
                d_p, i_p = plain(b, y0)
                atol = DEPTH_ATOL if name == "vis_folded" else 0.0
                err = max(err, _compare(d_k, i_k, d_p, i_p,
                                        f"{name} {pname} band y0={y0} (plain)", atol))
                d_b, i_b = (unfold(a, b.tiles_y, b.tiles_x, rows, w) for a in (d_k, i_k))
                err = max(err, _compare(d_b, i_b, d_f[y0:y0 + rows], i_f[y0:y0 + rows],
                                        f"{name} {pname} band y0={y0} (whole pass)", 0.0))
                n_bands += 1
            print(f"row bands: {name} {pname} pass {w}x{h} in {n} bands of {rows} rows: equal "
                  f"to the whole pass bit for bit, ids equal to the plain version", flush=True)
        out[name] = (n_bands, err)
        print(f"row bands: {name}: {n_bands} bands, max abs err {err}", flush=True)
    return out


def _sky_margin(scene, cam, frame_idx, cfg):
    """Pixels at most SKY_MARGIN from the sky (no coverage, or beyond the
    world bounds) in frame `frame_idx` of `cam`: the sharded frame shades the
    sky at full resolution, the single-device frame at half
    (lighting.py:305-318), and TAA and bloom spread the difference a few
    pixels."""
    from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer, lighting

    state = tr.init_frame_state(cfg, cam.position.device)
    state.frame_idx = frame_idx
    fi = tr.frame_inputs(state, cam, SUN, cfg)
    s, depth, tri, _ = tr._rasterize(scene, cam.clip_from_world, cfg.width, cfg.height, cfg,
                                     jitter=fi.jitter, backend="pallas")
    g = gbuffer.gbuffer_pass(scene, s, torch.where(torch.isinf(depth), 1.0, depth), tri,
                             cam.clip_from_world, cam.clip_from_world, cfg.alpha_test_threshold,
                             world_from_clip=cam.world_from_clip, jitter=fi.jitter,
                             material_filter=cfg.material_filter,
                             frame_idx_mod_59=float(frame_idx % 59))
    pw, _ = lighting.reconstruct_positions(g.depth, cam.world_from_clip, cam.view_from_clip)
    sky = ~g.coverage | (pw.abs() > cfg.world_bounds).any(-1)
    k = 2 * SKY_MARGIN + 1
    near = torch.nn.functional.max_pool2d(sky[None, None].float(), k, 1, SKY_MARGIN)[0, 0] > 0
    return near.cpu().numpy(), float(sky.float().mean())


def _state_numpy(state):
    """The state's leaves as numpy; the voxelize plan (a per-scene cache of
    tensors, not a frame's state) stays behind."""
    return {k: v.float().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in vars(state).items() if k != "voxel_plan"}


def _sharded_rank(job):
    """One rank of a sharded run (parallel.launch): its dp slice's frames
    through sharding.sharded_frame_fn, the launch counts set to 0 just
    before and read just after, host ms per frame (synchronised).  Rank sp 0
    of each slice also returns each frame's image and the state after it."""
    import torch.distributed as dist

    from vulkan_pbr_renderer_tpu_torch import convert
    from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
    from vulkan_pbr_renderer_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(dp=job["dp"], device=job["device"])
    scene = convert.scene_from_numpy(job["scene"], device=mesh.device)
    pre, lut = convert.bakes_from_numpy(*job["bakes"], device=mesh.device)
    cfg = sharding.sharded_config(scene, job["cfg"])
    step = sharding.sharded_frame_fn(scene, job["cfg"], mesh, "pallas")
    state = tr.init_frame_state(cfg, mesh.device)
    cams = [tr.make_camera(*pose, cfg, device=mesh.device) for pose in job["poses"][mesh.dp_idx]]
    counters = _zero_launches()
    frames, ms = [], []
    for i, cam in enumerate(cams):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = step(state, cam, job["suns"][i], pre, lut)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if mesh.sp_idx == 0:
            frames.append((img.cpu().numpy(), _state_numpy(state)))
    launches = {k: fn.launches for k, fn in counters.items()}
    return dict(rank=dist.get_rank(), dp_idx=mesh.dp_idx, sp_idx=mesh.sp_idx,
                backend=mesh.backend, device=str(mesh.device), frames=frames, ms=ms,
                launches=launches)


def _check_state(what, got, want, far):
    """The sharded frame's state after a frame against render_frame's from
    the same state: the sun map and the lightgrid equal, the overflow a
    band's pair count, the other leaves within tests/test_parallel.py's
    bounds (rtol = atol = 1e-3; the bf16 pyramid rtol one bf16 ulp, 2^-7):
    the per-pixel ones away from the sky (`far`), the pyramid on its
    level-1 pixels away from the sky (its deeper levels blur the whole
    frame, sky included)."""
    for name, b in want.items():
        a = got[name]
        if name in ("sun_depth", "lightgrid"):
            check(np.array_equal(a, b), f"{what}: {name} differs")
        elif name == "raster_overflow":
            check(a[0] == b[0] and 0 < a[1] <= b[1], f"{what}: overflow {a} vs {b}")
        elif isinstance(b, np.ndarray):
            if name in ("taa_history", "velocity_prev"):
                a, b = a[far], b[far]
            elif name == "prev_pyramid":
                level1 = (slice(None), slice(0, far.shape[1] // 2))
                a, b = a[level1][far[::2, ::2]], b[level1][far[::2, ::2]]
            rt = 2 ** -7 if name == "prev_pyramid" else 1e-3
            bad = ~np.isclose(a, b, rtol=rt, atol=1e-3)
            check(not bad.any(), f"{what}: state leaf {name} differs at {int(bad.sum())} "
                  f"values (max {float(np.abs(a - b).max())})")
        else:
            check(a == b, f"{what}: state {name} {a} vs {b}")


def _run_sharded(what, scene, cfg, dp, sp, poses, suns, used, dev):
    """One sharded run through parallel.launch (nccl with a card per rank,
    else gloo), each frame held to render_frame at the sharded frame's
    config from the same state (the sharded run's state before that frame:
    the frames differ only where the sky is, which the sharded frame shades
    at full resolution, and the carried TAA history and bloom pyramid would
    take that difference into the next frames): the image within
    SHARDED_ATOL at least SKY_MARGIN from the sky, the state after it as
    _check_state says; the kernel `used` launched once per camera band and
    per sun band, the others not at all.  Returns stats."""
    from vulkan_pbr_renderer_tpu_torch import convert
    from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
    from vulkan_pbr_renderer_tpu_torch.assets import procedural
    from vulkan_pbr_renderer_tpu_torch.bake import ibl
    from vulkan_pbr_renderer_tpu_torch.gpu import sampling
    from vulkan_pbr_renderer_tpu_torch.parallel import sharding

    world = dp * sp
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    env = torch.from_numpy(procedural.make_sky_cubemap(128)).to(dev)
    raw = ibl.bake_prefiltered_env(sampling.build_cube_mip_atlas(env), 128,
                                   cfg.prefiltered_env_size, cfg.prefiltered_env_min_size,
                                   cfg.prefilter_samples)
    lut = ibl.bake_brdf_lut(cfg.brdf_lut_size, cfg.brdf_lut_samples, device=dev)
    pre = sampling.pack_cube_mip_atlas_window(raw, cfg.prefiltered_env_size)
    job = dict(dp=dp, cfg=cfg, device=None if dev == "cuda" else dev, poses=poses, suns=suns,
               bakes=(raw.cpu().numpy(), lut.cpu().numpy()),
               scene={k: v.cpu().numpy() for k, v in scene._asdict().items()})
    t0 = time.perf_counter()
    ranks = sharding.launch(_sharded_rank, world, backend, job)
    launch_s = time.perf_counter() - t0
    scfg = sharding.sharded_config(scene, cfg)
    n_frames = len(suns)
    sun_passes = sum(1 for i in range(n_frames) if i == 0 or suns[i] != suns[i - 1])
    # a kernel launches on the card; on the CPU its plain version runs.  Each
    # rank shades its band: the GI rays launch in every rank, and every band
    # pass sets up and bins its triangles once
    want = {used: n_frames + sun_passes, "binning": n_frames + sun_passes,
            "setup": n_frames + sun_passes,
            "gi_fast_ray": gi_launches(scfg, n_frames),
            "gi_reference_ray": reference_launches(scfg, n_frames),
            **screen_launches(scfg, n_frames),
            **post_launches(scfg, n_frames, sharded=True),
            **slice_launches(scfg, n_frames, sun_passes=sun_passes, sharded=True)}
    for r in ranks:
        for k, n in r["launches"].items():
            w = want.get(k, 0) if dev == "cuda" else 0
            check(n == w, f"sharded {what}: rank {r['rank']} launched {k} {n} times, "
                  f"expected {w}")
    out = dict(backend=backend, cards=torch.cuda.device_count(), world=world, dp=dp, sp=sp,
               launches=sum(r["launches"][used] for r in ranks),
               gi_launches=sum(r["launches"]["gi_fast_ray"] for r in ranks),
               screen_launches={k: sum(r["launches"][k] for r in ranks)
                                for k in SCREEN_KERNELS},
               binning_launches=sum(r["launches"]["binning"] for r in ranks),
               setup_launches=sum(r["launches"]["setup"] for r in ranks),
               post_launches={k: sum(r["launches"][k] for r in ranks)
                              for k in post_launches(scfg, 0)},
               slice_launches={k: sum(r["launches"][k] for r in ranks)
                               for k in SLICE_KERNELS}, max_abs_err=0.0,
               sharded_ms=[], single_ms=[])
    leads = [next(r for r in ranks if r["dp_idx"] == d and r["sp_idx"] == 0) for d in range(dp)]
    for d, lead in enumerate(leads):
        state, ms = tr.init_frame_state(scfg, dev), []
        for i, (img, after) in enumerate(lead["frames"]):
            tag = f"sharded {what}: slice {d} frame {i}"
            check(img.shape == (cfg.height, cfg.width, 3) and np.isfinite(img).all(),
                  f"{tag}: shape {img.shape} or not finite")
            cam = tr.make_camera(*poses[d][i], scfg, device=dev)
            near_sky, sky_frac = _sky_margin(scene, cam, i, scfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = tr.render_frame(scene, state, cam, suns[i], pre, lut, scfg, "pallas")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            diff = np.abs(img - ref.cpu().numpy()).max(-1)
            err = float(diff[~near_sky].max()) if (~near_sky).any() else 0.0
            check(err <= SHARDED_ATOL, f"{tag}: differs from the single-process frame by {err} "
                  f"> {SHARDED_ATOL} away from the sky")
            _check_state(tag, after, _state_numpy(state), ~near_sky)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            print(f"{tag}: max abs diff {err:.3e} at least {SKY_MARGIN} px from the sky "
                  f"({100 * float((~near_sky).mean()):.1f}% of the pixels), {float(diff.max()):.3e}"
                  f" over all (sky {100 * sky_frac:.1f}%: shaded at full resolution in the sharded "
                  "frame, at half in one process, lighting.py:305-318); state after it ok",
                  flush=True)
            # the next frame starts, in both, from the sharded run's state
            state = convert.state_from_numpy(after, device=dev)
            state.voxelize_count = after["voxelize_count"]
        out["sharded_ms"].append(lead["ms"])
        out["single_ms"].append(ms)
    if dp > 1:
        gap = float(np.abs(leads[0]["frames"][-1][0] - leads[1]["frames"][-1][0]).mean())
        check(gap > 1e-4, f"sharded {what}: the dp slices' images do not differ ({gap})")
        print(f"sharded {what}: the dp slices' last images differ by {gap:.4f} on average",
              flush=True)
    print(f"sharded {what}: dp={dp} x sp={sp} on {torch.cuda.device_count()} card(s) through "
          f"{backend} ({ranks[0]['device']} for every rank); {out['launches']} {used} and "
          f"{out['gi_launches']} gi_fast_ray launches over the ranks; launch {launch_s:.1f} s; max abs err "
          f"{out['max_abs_err']:.3e} away from the sky", flush=True)
    return out


def phase_sharded(scene, dev="cuda"):
    """The row-sharded frame (parallel.sharding) through parallel.launch:
    (a) SUNTEMPLE_1080P through K1, dp=1 x sp=2, SHARDED_FRAMES frames along
    camera_path with the sun moving on frame SHARDED_SUN_MOVE, and its steady
    ms per frame beside the single-process frame's; (b) dp=2 x sp=2 at
    160x128 through K1-hiz (two cameras: the slices differ); (c) dp=1 x sp=2
    at 160x128 through K2; (d) dp=1 x sp=2 at 160x128 with the hi-z screen
    term (path F's mode, gi_screen_ray in each rank).  With one card the ranks share it and gather
    through gloo: the times measure arithmetic and host copies, not scaling."""
    from vulkan_pbr_renderer_tpu_torch.assets import procedural, suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import MaterialDesc, build_scene
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig, SUNTEMPLE_1080P

    n = SHARDED_FRAMES
    suns = [SUN_MOVED if i >= SHARDED_SUN_MOVE else SUN for i in range(n)]
    poses = [[tuple(tuple(float(x) for x in p) for p in suntemple.camera_path(i / (n - 1)))
              for i in range(n)]]
    full = _run_sharded(f"{SUNTEMPLE_1080P.width}x{SUNTEMPLE_1080P.height} K1", scene,
                        SUNTEMPLE_1080P, 1, 2, poses, suns, "vis_folded", dev)
    steady = [float(np.median(m[1:SHARDED_SUN_MOVE])) for m in (full["sharded_ms"][0],
                                                                  full["single_ms"][0])]
    full.update(steady_ms=steady[0], single_steady_ms=steady[1])
    print(f"sharded {SUNTEMPLE_1080P.width}x{SUNTEMPLE_1080P.height} K1: steady ms per frame (frames 1-{SHARDED_SUN_MOVE - 1}, host "
          f"clock, synchronised): sharded {steady[0]:.2f} (2 ranks sharing one card, gathers "
          f"through {full['backend']}: arithmetic, not scaling), single process {steady[1]:.2f}; "
          f"all frames sharded {' '.join(f'{t:.1f}' for t in full['sharded_ms'][0])}, single "
          f"{' '.join(f'{t:.1f}' for t in full['single_ms'][0])}; card {nvidia_smi()}", flush=True)

    small = RenderConfig(width=SMALL_SHARDED[0], height=SMALL_SHARDED[1], shadow_map_size=128,
                         prefiltered_env_size=16, prefiltered_env_min_size=8,
                         prefilter_samples=256, brdf_lut_size=16, brdf_lut_samples=256,
                         bloom_pass_count=3, light_shaft_steps=4, lightgrid_size=16,
                         lightgrid_extent=10.0)
    plane_cube = build_scene([procedural.make_plane((0, 0, 0), (12, 12), 2, 0),
                              procedural.make_cube((0, 0, 1.0), (2, 2, 2), 0)],
                             [MaterialDesc(orm_factor=(1.0, 0.5, 0.0))], texture_size=16,
                             device=dev)
    # looking down onto the plane and the cube: little or no background
    cams = [((0.0, -1.2, 4.0), (0.0, 0.3, 0.0)), ((0.5, -1.5, 5.0), (0.0, 0.0, 0.5))]
    small_suns = [(40.0, 120.0), (45.0, 120.0)]
    hiz = _run_sharded("160x128 K1-hiz", plane_cube, small.replace(raster_hiz=True), 2, 2,
                       [[c] * 2 for c in cams], small_suns, "vis_folded_hiz", dev)
    rowblock = _run_sharded("160x128 K2", plane_cube, small.replace(raster_kernel="rowblock"),
                            1, 2, [[cams[0]] * 2], small_suns, "vis_rowblock", dev)
    # path F's mode: the hi-z screen term over the gathered full depth
    hiz_term = _run_sharded("160x128 hi-z screen term", plane_cube,
                            small.replace(gi_fast_screen_mode="hiz"), 1, 2, [[cams[0]] * 2],
                            small_suns, "vis_folded", dev)
    check(hiz_term["screen_launches"]["gi_screen_ray"] == 2 * 2 * 2,
          f"sharded hi-z screen term: {hiz_term['screen_launches']} screen kernel launches")
    return {"vis_folded": full, "vis_folded_hiz": hiz, "vis_rowblock": rowblock,
            "gi_screen_ray": hiz_term}


def phase_app():
    with tempfile.TemporaryDirectory() as tmp:
        out = dict(headless=phase_headless_full(tmp), headless_scenes=phase_headless_scenes(tmp))
    out["preview"] = phase_preview()
    out.update(phase_bake_and_loaders())
    return out


def _gi_entry(gi_random, gi_real, paths, sharded, app):
    """The kernels line's gi_fast_ray entry: the diffuse ray's real lanes of
    path A (the specular ray's beside them), errors over every set checked,
    launches of every counted run."""
    err, mismatch, lanes = gi_random
    d, sp = gi_real["diffuse"], gi_real["specular"]
    for st in (d, sp):
        err, mismatch, lanes = (max(err, st["max_abs_err"]), mismatch + st["status_mismatch"],
                                lanes + st["lanes"])
    entry = {
        "name": "gi_fast_ray", "route": "cuda",
        "source": "vulkan_pbr_renderer_tpu_torch/csrc/gi_fast_ray.cu",
        "replaces": "vulkan_pbr_renderer_tpu/shade/gi.py:398",
        "replaces_also": "vulkan_pbr_renderer_tpu/shade/gi.py:915",
        "launches": paths["A"]["gi_launches"], "max_abs_err": err,
        "status_mismatch": mismatch, "lanes_checked": lanes,
        "ms": d["ms"], "ms_min": d["ms_min"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "share_of_bound": d["bound_ms"] / d["ms"], "library_ms": None,
        "device_ms": d["device_ms"], "device_ms_min": d["device_ms_min"],
        "device_share_of_bound": d["bound_ms"] / d["device_ms"],
        "shape": f"path A frame 1, diffuse ray, {d['lanes']} lanes {d['lane_shape']}",
        "path": "A", "flops": d["flops"], "bytes": d["bytes"], "steps": d["work"],
        "simt_efficiency": d["simt"], "specular_simt_efficiency": sp["simt"],
        "registers": d["registers"], "blocks_per_sm": d["blocks_per_sm"],
        "threads": d["threads"],
        "launches_by_path": {k: v["gi_launches"] for k, v in paths.items()},
        "launches_sharded": {k: v["gi_launches"] for k, v in sharded.items()},
        "launches_headless": app["headless"]["gi_launches"],
        "launches_headless_scenes": {k: v["gi_launches"]
                                     for k, v in app["headless_scenes"].items()},
        "launches_preview": app["preview"]["gi_launches"]}
    entry.update({f"specular_{k}": sp[k] for k in ("ms", "ms_min", "device_ms",
                                                     "device_ms_min", "plain_ms", "bound_ms",
                                                     "bound_by", "flops", "bytes")})
    entry["specular_share_of_bound"] = sp["bound_ms"] / sp["ms"]
    return entry


def _binning_entry(binning_stats, paths, sharded, app):
    """The kernels line's binning entry: path A's camera pass, the other
    real passes beside it, launches of every counted run."""
    passes, n_cases, err = binning_stats
    a = passes["A camera"]
    return {
        "name": "binning", "route": "cuda",
        "source": "vulkan_pbr_renderer_tpu_torch/csrc/binning.cu",
        "replaces": "vulkan_pbr_renderer_tpu/raster/binning.py:104",
        "note": "not a Pallas kernel: the JAX package bins with XLA (scatter + cummax fills, "
                "a sort, searchsorted and a row gather) outside any kernel",
        "launches": paths["A"]["binning_launches"], "max_abs_err": err,
        "ms": a["ms"], "ms_min": a["ms_min"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": None,
        "share_of_bound": a["bound_ms"] / a["ms"], "device_ms": a["device_ms"],
        "device_ms_min": a["device_ms_min"],
        "device_share_of_bound": a["bound_ms"] / a["device_ms"],
        "stage_ms": a["stage_ms"], "long_path_tiles": a["long_path_tiles"],
        "max_segment": a["max_segment"], "keys_in_bound": False, "bytes": a["bytes"],
        "shape": f"path A camera pass 1920x1088, {a['pairs']} pairs in {a['rows']} rows",
        "path": "A", "seeded_cases": n_cases, "passes": passes,
        "launches_by_path": {k: v["binning_launches"] for k, v in paths.items()},
        "launches_sharded": {k: v["binning_launches"] for k, v in sharded.items()},
        "launches_headless": app["headless"]["binning_launches"],
        "launches_headless_spheres": app["headless_scenes"]["spheres"]["binning_launches"],
        "launches_preview": app["preview"]["binning_launches"]}


def main():
    phase_card()
    phase_build()
    err = {"vis_folded": phase_kernel_random("cuda"),
           "vis_folded_hiz": phase_hiz_random("cuda"),
           "vis_rowblock": phase_rowblock_random("cuda")}
    gi_random = phase_gi_random("cuda")
    ref_random = phase_reference_random("cuda")
    screen_random = phase_screen_random("cuda")
    post_random = phase_post("cuda")
    shade_random = phase_shade("cuda")
    sweep_random = phase_sweep("cuda")
    setup_random = phase_setup("cuda")
    voxel_random = phase_voxelize("cuda")
    scene, paths, real, id_diff, fidelity = phase_paths()
    bands = phase_row_bands(scene)
    sharded = phase_sharded(scene)
    del scene
    torch.cuda.empty_cache()
    ssim, bloom_off = phase_small_frame_vs_cpu()
    app = phase_app()
    sources = {"vis_folded": ("vulkan_pbr_renderer_tpu_torch/csrc/vis_folded.cu",
                              "vulkan_pbr_renderer_tpu/raster/visibility_v2.py:55", "A"),
               "vis_folded_hiz": ("vulkan_pbr_renderer_tpu_torch/csrc/vis_folded_hiz.cu",
                                  "vulkan_pbr_renderer_tpu/raster/visibility_v2.py:128", "D"),
               "vis_rowblock": ("vulkan_pbr_renderer_tpu_torch/csrc/vis_rowblock.cu",
                                "vulkan_pbr_renderer_tpu/raster/visibility.py:42", "B")}
    kernels = []
    for name, (source, replaces, path) in sources.items():
        stats, err_real = real[name]
        cam_t, sun_t = stats["camera"], stats["sun"]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[path]["launches"], "max_abs_err": max(err[name], err_real),
            "ms": cam_t["ms"], "ms_min": cam_t["ms_min"], "plain_ms": cam_t["plain_ms"],
            "bound_ms": cam_t["bound_ms"], "bound_by": cam_t["bound_by"], "library_ms": None,
            "shape": "camera pass 1920x1088", "path": path,
            "sun_pass_ms": sun_t["ms"], "sun_pass_ms_min": sun_t["ms_min"],
            "sun_pass_plain_ms": sun_t["plain_ms"],
            "share_of_bound": cam_t["bound_ms"] / cam_t["ms"],
            "sun_pass_share_of_bound": sun_t["bound_ms"] / sun_t["ms"],
            "device_ms": cam_t.get("device_ms"), "sun_pass_device_ms": sun_t.get("device_ms"),
            "piece_rows": cam_t["piece_rows"], "work_items": cam_t["work_items"],
            "sun_pass_work_items": sun_t["work_items"],
            "sun_pass_bound_ms": sun_t["bound_ms"], "sun_pass_bound_by": sun_t["bound_by"],
            "bands": bands[name][0], "bands_max_abs_err": bands[name][1],
            "launches_sharded": sharded[name]["launches"],
            "sharded_max_abs_err": sharded[name]["max_abs_err"]}
        if name != "vis_folded_hiz":
            entry["work_list"] = ("built on the card in the wrapper's one C call "
                                  "(csrc/work_list.cuh, one block before the raster kernel), "
                                  "held to " + ("folded_work_list" if name == "vis_folded" else
                                                "rowblock_work_list") + " exactly; ms as called "
                                  "include it")
        entry["max_abs_err"] = max(entry["max_abs_err"], bands[name][1])
        if name == "vis_folded":     # K1 also carries the app surface's paths
            entry["max_abs_err"] = max(
                entry["max_abs_err"], app["headless"]["kernel_max_abs_err"],
                app["headless_scenes"]["spheres"]["kernel_max_abs_err"],
                app["preview"]["kernel_max_abs_err"])
            entry.update(launches_headless=app["headless"]["launches"],
                         launches_headless_spheres=app["headless_scenes"]["spheres"]["launches"],
                         launches_preview=app["preview"]["launches"])
        if name == "vis_folded_hiz":
            entry.update(k1_ms=cam_t["k1_ms"], sun_pass_k1_ms=sun_t["k1_ms"],
                         k1_ms_min=cam_t["k1_ms_min"], sun_pass_k1_ms_min=sun_t["k1_ms_min"],
                         rows_walked=cam_t["rows_walked"],
                         rows_walked_serial=cam_t["rows_walked_serial"],
                         sun_pass_rows_walked=sun_t["rows_walked"],
                         sun_pass_rows_walked_serial=sun_t["rows_walked_serial"],
                         marked_pixels=cam_t["marked_pixels"] + sun_t["marked_pixels"],
                         id_diff_vs_k1=cam_t["id_diff"] + sun_t["id_diff"],
                         id_diff_vs_k1_at_ties=cam_t["id_diff_ties"] + sun_t["id_diff_ties"])
        kernels.append(entry)
    kernels.append(_gi_entry(gi_random, real["gi_fast_ray"], paths, sharded, app))
    kernels.append(_reference_entry(ref_random, paths))
    kernels += _screen_entries(screen_random, paths, sharded)
    kernels.append(_binning_entry(real["binning"], paths, sharded, app))
    kernels += _post_entries(post_random, real["post"], paths, sharded, app, bloom_off)
    kernels += _shade_entries(shade_random, real["shade"], real["shade"]["plain_frame"], paths,
                              sharded, app)
    kernels.append(_sweep_entry(sweep_random, real["shade"]["sweep"], paths, sharded, app))
    kernels.append(_setup_entry(setup_random, real["setup"], paths, sharded, app))
    kernels += _voxel_entries(voxel_random, real["shade"]["voxelize"], paths, sharded, app)
    print(json.dumps({"kernels": kernels, "paths": {
        k: {"steady_median_ms": v["steady_median_ms"], "peak_gib": v["peak_gib"],
            "gi_launches": v["gi_launches"], "ref_launches": v["ref_launches"],
            "screen_launches": v["screen_launches"], "frame_events": v["frame_events"],
            "frame_device_ms": v["frame_device_ms"]}
        for k, v in paths.items()}, "k1_k2_id_diff_frame0": id_diff,
        "fast_vs_reference": fidelity, "small_frame_ssim": ssim, "app": app,
        "sharded": {k: {f: v[f] for f in ("backend", "cards", "dp", "sp", "launches",
                                          "gi_launches", "screen_launches", "post_launches",
                                          "max_abs_err")}
                    for k, v in sharded.items()},
        "sharded_steady_ms": sharded["vis_folded"]["steady_ms"],
        "single_process_steady_ms": sharded["vis_folded"]["single_steady_ms"]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
