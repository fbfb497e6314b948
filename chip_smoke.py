"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths driven: the flagship frame at msaa=1 (shadow K1, character
K2, ground PCF K3), the same frame through the exact scan raster
(`raster_mode="scan"`: shadow and character KS, ground K3), the frame the reference app renders, at msaa=4 with
the windowed shadow map (shadow K6, character K4, ground K3), the textured
rows of `bench.py` (the 2-part procedural textures at 1920x1080 msaa=1
and at 1280x720 msaa=4, the 16-part realistic set with 6 mip levels and
the resident mini-atlas at 1920x1080: K1, K2 or K4, K3 and the albedo
pass), the full look (the textured msaa=4 + window frame at 1920x1080
with the skybox from a 512^2 cubemap, edge outlines, material 1
double-sided and the MMD toon ramps and sphere maps: K6, K4 with both
windings, K2 at 0 attributes on the edge hull, K3), and the crowd: 64
instances of the flagship character stepped and rendered by one batched
program (`parallel.mesh.crowd_step_fn`: shadow maps K5c, ground K3 over
the batch of maps, characters K5a at msaa=1 or K5b at msaa=4), textured
in the light crowd, which also runs the full look (K5b with both
windings, K5a at 1 attribute on the edge hull). The content paths run the
content rig (`content_rig`: the flagship character with its forearm,
thigh and shin BDEF2 vertices made SDEF, a UV morph on part 0 and a
material morph on part 1, written and read back as PMX) on
`content_motion` with `sdef_true` and `apply_extended_morphs` on: the
textured msaa=4 + window frame at 1920x1080 (K6, K4, K3) and the light
crowd at msaa=4 (K5c, K5b, K3). The CLI path runs `app.cli.main` on the
written sample character with VMD camera and light tracks at 1920x1080
(K1, K2, K3 at msaa=1; K1, K4, K3 at msaa=4), perspective and
orthographic frames.

Phases (each prints its own line; any failure raises and exits nonzero):

1. device: the CUDA device and nvidia-smi's name and power limit; no CUDA
   device is a failure.
2. build: compile the kernels of `simple_mmd_renderer_tpu_torch/csrc/` with
   nvcc (sm_90a, one process per source, all at once) and print the build
   seconds.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the very arguments the main path passed it in frame 1 of its scene
   (recorded around `Scene.step_and_render`), and K1/K2/K4 on a dense tile
   (more entries than a block takes at once, all at one depth). Depth,
   triangle ids, barycentrics and per-sample depths must be bit-exact,
   attributes within 1e-6; K6's pasted map must equal K1's over the same
   bins and boxes. K1, K6, K2, K4, K5a, K5b and K5c get the entries' pixel
   boxes the frame passed them (asserted); their plain versions take none
   and evaluate every entry over its whole tile, and K1's, K2's, K4's and
   K5c's dense tiles run with boxes and without. Prints mismatch counts,
   the record's time of every kernel and of every call `check_calls` holds
   (CUDA events, back to back: `back_to_back_runs`, 6 means of 20 launches
   of the wrapper on the call's arguments while a sleep kernel holds the
   stream, least and median; the plain versions by the same timer) and
   each kernel's bound (for the seven kernels with boxes by two rules:
   each entry over its tile's columns, as for the kernels without boxes,
   and over its exact box, the rule their record carries). Host-paced
   times (`host_paced_ms`) are kept only for a wrapper's cost to the frame
   (the scan raster's wrapper) and the seek's replay.
   The crowd kernels K5c, K5a and K5b are held the same way on the
   arguments of frame 1 of the 64-instance crowd, K3 on its [64,256,256]
   batch of shadow maps, and one instance's planes must equal the
   single-instance kernel's on that instance's own bins with the same
   boxes (K5c vs K1, K5a vs K2, K5b vs K4). K2 and K4 also run at A = 5
   (the UVs as attributes 3-4: `albedo_window=False`) on the textured
   paths' frame-1 arguments, and K5a and K5b on the textured light
   crowd's, every plane bit-exact, the attributes within 1e-6. On the
   full-look and content paths every call of every kernel in frame 1 is
   held so (`check_calls`), with the windings of the rasters' bins: the
   edge hull's front faces only, the character's both in some tile.
4. compiled: the step of every path (pose + physics + deform: the CCD
   loop's fixed, masked iteration count, `Scene.step_pose(...,
   capturable=True)`) captured as one CUDA graph (`Scene.captured_step`)
   and replayed (`Scene.jit_step(render=False)`), capture and replays
   under `torch.cuda.set_sync_debug_mode("error")`; the replays must equal
   the eager step (early exit) bit for bit, every state leaf, pose field,
   position and normal, over 4 frames of the flagship msaa=1 path and of
   the dense crowd (whose msaa=1 and msaa=4 paths share one graph: the
   step reads no render setting) and 2 frames of the msaa=4 + window
   flagship, of the content path and of the light crowds. Prints the
   capture's seconds, the eager step's and the replay's ms/frame, and the
   CCD iterations the eager step ran per IK group against the fixed
   count, and that a replay launches 7 stamp kernels (the stage clock's,
   `csrc/stamp.cu`) and one CCD kernel an IK group (`ccd_kernel` in the
   device trace of one replay; `ops.ccd.launches` two a group over the
   capture). The CCD kernel on the msaa=4 + window flagship's, the content
   path's and the dense crowd's IK groups (`check_ccd`): bit for bit
   against the plain loop, one launch a dispatcher call, back to back
   beside its bound (a launch's own cost plus the serial path timed by the
   kernel's own clocks). On the msaa=4 + window flagship's step, the bake's
   (`check_stamp`): the stamps counted on the clock and in the device
   trace of a replay, each posing pass's CCD (run, useful) in 4 replays'
   ring rows against torch.sum of the flags the graph wrote, the stamps in
   order, and the stamp kernel back to back with and without flags. The
   content step is also replayed with `sdef_true` off (its own
   graph) in turns with it on (`sdef_step_times`: ms/frame of each, the
   SDEF vertex count; the two must differ at the SDEF vertices only), as
   is the content crowd's. Then under torch.profiler one eager frame of
   the flagship msaa=1 path, one compiled frame of it (`rollout` of one
   frame: the state copied in and out), one of the dense crowd at msaa=1
   (`crowd_step_fn`) and one of the content path: host launch calls and
   device kernels a frame.
5. flagship: the sample character at density 2.0, shadow 2048^2, physics
   on, on every path (ORDER): 3 warm-up frames each, then 20 timed frames
   of each through the compiled `Scene.rollout` (a replay and the eager
   render a frame), in turns (segments of 10 frames, the order reversed
   halfway, so that drift over the call falls on all paths alike), and
   among them one eager segment of 5 frames of msaa=1
   (`Scene.step_and_render`) for comparison; every kernel's launch counter
   reset just before each segment and read just after. The frames must be
   finite, the checksums must advance, the path's kernels must each launch
   as often a frame as the path says (`path_kernels`: the edge hull adds
   a K2) and every other kernel never, and the character must cover a
   plausible share of the frame. Prints ms/frame and fps, the full look's
   beside the textured msaa=4 and the untextured msaa=4 frames of the
   call, the content frame's beside the untextured msaa=4 frame's. The
   16-part path is built first, alone: its host packing seconds, its
   atlas and its device memory (allocated before and after, the peak over
   a frame); the full look's equirect is written as .hdr and read back,
   its cubemap built on the card (seconds, MB). Then the passes
   (`pass_scope`) of PROFILED under torch.profiler over the renders of 3
   compiled frames: the albedo of each textured path, the skybox, edges
   and mmd of the full look, the morph consumers (`morphs`) of the
   content path, each pass's host and device ms a frame, its byte bound
   and its operators by device time.
6. scan: the exact scan raster (`raster_mode="scan"`, KSb's tile bins and
   KS's walk over them: `check_scan`). KS against its plain version bit
   for bit on the frame-1 calls of the 256x192 scan frame (density 0.5,
   shadow 256^2, edge outlines on: the shadow map, the edge hull, the
   character), on the character from the hull's buffer and on two
   instances, and KSb's words against `scan_bins_plain`'s on the same
   calls; each flagship path's big-triangle
   counts on frame 1 (`binning_stats`: the triangles its tiled rasters
   merge through KS); the seven golden configurations of
   tests/test_golden_frames.py (192x144) on the card against the CPU
   (the whole-frame tolerance of the parity phase; KS and K3 launch
   counts); the 1080p scan frame (density 2.0, shadow 2048^2, msaa=1, the
   msaa=1 flagship's scene with raster_mode="scan"): the wrapper on its
   frame-1 shadow and character calls, back to back and host-paced (its
   cost to the frame), beside KS's bound (`scan_bound`), then KSb and KS
   alone at every coarse tile of SCAN_SWEEP (`scan_parts`: words and
   planes bit for bit, both back to back, KSb beside its own bound; the
   record's at the default tile), the plain version once on the character
   (bits and time),
   4-frame segments through the compiled rollout in turns with
   the tiled msaa=1 flagship (scan, tiled, tiled, scan; the scan
   segments' counters: KSb and KS twice and K3 once a frame, nothing
   else), and
   the scan frame against the tiled frame of the same state. The tiled
   paths' segments (flagship, crowd, CLI) print KS's launches: their
   big-triangle merges.
7. crowd: 64 instances (`crowd_init(scene, 64)`, clocks 7 frames apart)
   of the density-2.0 character with `sample_motion(120, fps_keys=5)` at
   256x144, shadow 256^2, physics on, through `crowd_step_fn` (a replay of
   the crowd's compiled step and the eager fused render a crowd frame): 3
   warm-up frames, then 8 timed frames at msaa=1 and 8 at msaa=4 in turns
   (segments of 4), the counters checked per segment as above; then the
   density-0.5 crowd at msaa=4. The frames must be finite [64,144,256,3],
   their checksums must advance, and instance 0 must differ from instance
   1. Prints ms per crowd frame and instance-frames per second. The
   light crowd samples the 2-part textures, and runs again with the full
   look at msaa=4 (one more K5a a frame) and as the content crowd at
   msaa=4 (each instance's own UV offsets and part colours), the three
   timed in turns (LIGHT_ORDER) and compared.
   Then the readers: the sample character written as PMD bytes
   (`pmd_bytes`) and read back by the port's `parse_pmd` renders on the
   card as on the CPU, and a VPD pose (VPD_POSE, `parse_vpd`) held by the
   sample character, physics off, gives the same frame at two times.
8. parity: a small scene rendered on the card and on the CPU (plain
   versions) must agree (fewer than 2e-3 of pixels off by more than 0.02,
   mean absolute difference below 1/255), at msaa=1 and at msaa=4 with the
   windowed shadow map, textured (16 parts with mips and the resident
   mini-atlas at msaa=1; the UVs through K4 at msaa=4), with the full
   look at 64x48 at msaa=1 and 4, and the content rig at msaa=4; and a
   crowd of 4 at msaa=1 and at msaa=4, untextured, textured, with the
   full look and of the content rig.

9. cli: the command-line renderer (`app.cli`, `check_cli`) on the sample
   character at density 2.0 written as PMX (`cli_files`) and a VMD of the
   sample motion's bone keys with a camera track (an orbit, a fov change,
   frames 4-6 orthographic) and a turning light (`cli_vmd`), with
   --use-camera --use-light at 1920x1080, shadow 2048^2: the seek captured
   once as a CUDA graph against the eager seek, bit for bit (capture
   seconds, replay and eager ms); the tracks' sampling, the frame config
   and build_matrices under sync debug mode "error"; every kernel call of
   frame 1 (perspective) and of frame 5 (orthographic) against its plain
   version; `cli.main` for CLI_FRAMES frames at msaa=1 with PNGs, a
   checkpoint and a trace, again without output, and at msaa=4 (K1, K4,
   K3: the CLI has no shadow_window flag), each printing the CLI's own
   "frames in s -> fps" line beside nvidia-smi's name and power limit,
   every launch counter reset just before the run and read just after;
   CLI_RESUME_AT frames, --save-state, then --resume for the rest equal to
   the uninterrupted run bit for bit (PNGs and state); the PNGs decoded
   (`png_pixels`) equal to the frames' uint8 arrays; the trace's pass
   labels; and card-vs-CPU frames (256x192 and an orthographic frame;
   a crowd of 4 with the camera track, rendered instance by instance).
10. mesh: the multi-device entry points of `parallel.mesh` (`check_mesh`)
   on the reference dry run's three configurations at the widths above,
   over meshes that repeat the one card (`make_mesh(["cuda:0"] * n)`: the
   shards and bands run one after another on it; with more than one card
   also `make_mesh()` over all of them). The msaa=1 flagship at 1920x1080
   in 3 row bands of 360 (`frame_jit`: the downsampled lit map with its
   halo rows) and the msaa=4 + shadow_window flagship in 4 bands of 270
   (the exact lookup: 270 % 4 != 0): every band's frame-1 kernel calls
   against their plain versions (`check_calls`), the gathered frame
   against the unbanded frame of the same state (the whole-frame
   tolerance; the same lookup) and state' against the unbanded step's
   (bit for bit); the dense crowd of 64 in 4 shards of 16 (`shard_crowd`,
   `crowd_jit`) at msaa=1 and 4: every shard's frame-1 kernel calls, the
   gathered images against `crowd_step_fn` over the 64 on one device (the
   whole-frame tolerance, state leaves within 1e-4); the scan crowd of 8
   (density 0.25, 32x32, shadow 32, 2 solver iterations, the per-instance
   fallback on KS) in 4 shards likewise; each split path and its
   one-device path timed in turns (4-frame segments, launch counters
   reset and checked per segment). Then the native PMX parser
   (`native.get_lib()` built and loaded; the content rig and the
   density-2.0 sample character, written by `write_pmx`, parse to equal
   arrays through it and through the Python loop, with each route's
   seconds).

The line before the last is the kernels' JSON record (`launches`: every
kernel's launches summed over the timed compiled segments of every main
path, the scan frame's included, over the CLI's runs and over the mesh
phase's timed segments (split and one-device), each counted from 0 just
before its segment or run; KS's and KSb's also the tiled paths'
merges); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from simple_mmd_renderer_tpu_torch.app.sample import (realistic_texture_sizes,
                                                      sample_equirect,
                                                      sample_mmd_maps,
                                                      sample_textures)
from simple_mmd_renderer_tpu_torch.core.scene import build_sample_scene
from simple_mmd_renderer_tpu_torch.parallel.mesh import (crowd_init,
                                                         crowd_step_fn)

WIDTH, HEIGHT, SHADOW, DENSITY = 1920, 1080, 2048, 2.0
WARMUP, FRAMES = 3, 20
MSAA_PATH = dict(msaa=4, shadow_window=True)
# the textures of `bench.py`'s textured rows: the 2-part set, and the
# realistic 16-part set with 6 mip levels and the resident mini-atlas
TEX2 = (1024, 256)
TEX16 = dict(textures=realistic_texture_sizes(16), n_parts=16,
             texture_mips=6, texture_resident=1)
# the flagship paths (the sample character at DENSITY, shadow SHADOW,
# WIDTH x HEIGHT unless named): untextured at msaa=1 and at msaa=4 +
# shadow_window, and the textured rows of `bench.py`
M1, M4 = "msaa=1", "msaa=4 + shadow_window"
T1, T4 = "textured", "textured + msaa=4, 1280x720"
T16 = "textured 16 parts, resident mips"
# the full look: the textured msaa=4 + shadow_window frame at WIDTH x HEIGHT
# with the skybox (a LOOK_CUBE^2 cubemap from a seeded LOOK_HDR equirect
# written and read back as .hdr), edge outlines, material 1 double-sided
# and the MMD toon ramps and sphere maps (SPH on part 0, SPA on part 1,
# LOOK_SPHERE^2 each)
FULL = "full look"
LOOK_HDR, LOOK_CUBE, LOOK_SPHERE, LOOK_RAMP = (1024, 2048), 512, 256, 32
# the content path: the textured msaa=4 + shadow_window frame at WIDTH x
# HEIGHT of the content rig (`content_rig`: SDEF vertices, a UV and a
# material morph, through write_pmx and parse_pmx) on `content_motion`, with
# `sdef_true` and `apply_extended_morphs` on
CONTENT = "content (SDEF + morphs)"
# the timed flagship segments (path, compiled?), in turns: FRAMES per path
# compiled, and one eager segment of msaa=1 among them for comparison
ORDER = ((M1, True), (M4, True), (T1, True), (T4, True), (T16, True),
         (FULL, True), (CONTENT, True), (M1, False), (CONTENT, True),
         (FULL, True), (T16, True), (T4, True), (T1, True), (M4, True),
         (M1, True))
SEGMENT = FRAMES // 2
EAGER_SEGMENT = SEGMENT // 2     # the eager segment's frames
# the compiled phase's frames: replays held bit-equal to the eager step
COMPILED_FRAMES, COMPILED_FRAMES_SHORT = 4, 2

# cycles of the sleep kernel that holds the stream while the host queues a
# back-to-back run (`primed_ms`), about 10 ms on an H100
PRIME_CYCLES = 20_000_000

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# fp32 operations/s outside the tensor cores, the type these kernels use
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# fp32 operations per evaluation of a binned entry at a pixel it can cover
# (`bin_work`), the per-entry and per-column terms left out (a lower bound):
# K1/K6: dy; w1, w2, zp (a multiply and an add each); w1 + w2; four tests
# (w1, w2, w1 + w2, zp >= 0); one min
OPS_DEPTH = 13
# K2: K1's, plus the zp <= 1 test and the tie test
OPS_RASTER = 15
# K4: the centre planes (7), per sample three offsets, w1s + w2s, four tests
# and a min (4 x 9), the centre's cover (4), the biased depth (3), the tie
OPS_RASTER_MS = 51
# K2/K4 once per pixel from the winner: dx, dy, b1, b2 (8), the 1/w plane
# (4), and per attribute its plane and a division (5)
OPS_WINNER, OPS_PER_ATTR = 12, 5
# K3 per texel: the reference-depth plane (4), nine tests, eight adds, the
# 1/9 scale and the clamp (3)
OPS_PCF = 24

# the content rig's extended morphs (`content_rig`) and the motion keys
# that drive them (`content_motion`)
CONTENT_UV, CONTENT_MATERIAL = "UVスクロール", "色変化"

KERNELS = ("K1", "K2", "K3", "K4", "K6", "K5a", "K5b", "K5c")
# the kernels of the record: the TPU kernels' ports and KS, the scan
# raster's body (no TPU kernel: the reference's scan is an XLA lax.scan),
# which the tiled paths' big-triangle merges also launch, with KSb, its bin
# pass (one launch before each of KS's)
RECORDED = KERNELS + ("KS", "KSb")
ROW_LANES = 11   # lanes of a setup row that visibility reads (lanes 0-10)

# the crowd: instances, frame, shadow map, motion length; timed frames per
# path and per segment (in turns, as the flagship)
CROWD_N, CROWD_W, CROWD_H, CROWD_SHADOW, CROWD_MOTION = 64, 256, 144, 256, 120
CROWD_FRAMES, CROWD_SEGMENT = 8, 4
CROWD_LABEL = {False: "msaa=1", True: "msaa=4"}
CROWD_ORDER = (False, True, True, False)     # the segments' paths (msaa?)
# the light crowd's paths at msaa=4 (textured, full look, content), timed in
# turns
TEX = "textured"
LIGHT_ORDER = (TEX, FULL, CONTENT, CONTENT, FULL, TEX)


T_START = time.perf_counter()

# every kernel's launches on the main paths: the sum over every timed
# compiled flagship segment and every timed crowd segment, each counted
# from 0 just before the segment and read just after (the record's
# `launches`)
MAIN_LAUNCHES = dict.fromkeys(RECORDED, 0)

# the scan phase (`check_scan`): the small scan frame whose frame-1 calls
# of KS are held against the plain version (width, height, shadow, at
# density 0.5, with the edge outlines); the 1080p scan frame's timed
# segments of SCAN_SEGMENT frames in turns with the tiled msaa=1 flagship
# (SCAN_ORDER: scan?); the golden frames' configurations (GOLDEN, as
# tests/test_golden_frames.py builds them) card against CPU
SCAN_SMALL = (256, 192, 256)
SCAN_SEGMENT = 4
SCAN_ORDER = (True, False, False, True)
GOLDEN = ("flat", "textured", "msaa4", "toon_sph", "edges", "double_sided",
          "skybox")
GOLDEN_SIZE = (192, 144)
# the coarse tiles of KS's bins swept at the 1080p scan frame's calls
SCAN_SWEEP = (16, 32, 64, 128)
# KS's fp32 operations per (triangle, pixel of its box): three edge
# functions (two differences, two products and their difference: 15),
# their scaling by 1 / area (3), zp (three products, two sums: 5) and six
# tests (b0, b1, b2 >= 0; zp <= depth, zp >= 0, zp <= 1)
OPS_SCAN = 29


def content_rig(density=DENSITY, n_parts=2):
    """The sample character with the content the flagship rig lacks, sent
    through the PMX bytes path (the port's `write_pmx`, then its
    `parse_pmx`) -> (PmxModel, SDEF vertex count):

    - SDEF: every BDEF2 vertex blended between a bone and that bone's own
      child (the forearms: elbow and wrist; the thighs: hip and knee; the
      shins: knee and ankle) becomes SDEF, with C = R0 = R1 at the joint
      the two bones share (the child's rest position);
    - a UV morph (CONTENT_UV) that moves part 0's vertices by (0.25,
      0.125);
    - a material morph (CONTENT_MATERIAL) on part 1 with a multiply entry
      (diffuse (0.4, 0.7, 1.0)) and an additive one (diffuse (0.1, 0.0,
      0.2))."""
    from simple_mmd_renderer_tpu_torch.app.sample import sample_character
    from simple_mmd_renderer_tpu_torch.formats import pmx as P
    from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx

    pm = sample_character(density=density, n_parts=n_parts)
    parent = np.array([b.parent for b in pm.bones])
    b0, b1 = pm.skin_bones[:, 0], pm.skin_bones[:, 1]
    sdef = (pm.skin_type == P.BDEF2) & (b1 >= 0) & (parent[b1] == b0)
    joint = np.stack([b.position for b in pm.bones])[b1[sdef]]
    pm.skin_type[sdef] = P.SDEF
    pm.sdef_c[sdef] = pm.sdef_r0[sdef] = pm.sdef_r1[sdef] = joint

    part0 = pm.materials[0]
    verts = np.unique(pm.triangles[part0.base_shift:part0.base_shift
                                   + part0.n_triangles]).astype(np.int32)
    uv = np.zeros((len(verts), 4), np.float32)
    uv[:, :2] = (0.25, 0.125)
    mul, add = np.ones(28, np.float32), np.zeros(28, np.float32)
    mul[0:3], add[0:3] = (0.4, 0.7, 1.0), (0.1, 0.0, 0.2)
    pm.morphs += [
        P.Morph(CONTENT_UV, "uv scroll", 4, P.MORPH_UV,
                uv_vertex_indices=verts, uv_offsets=uv),
        P.Morph(CONTENT_MATERIAL, "tint", 4, P.MORPH_MATERIAL,
                material_indices=np.array([1, 1], np.int32),
                material_methods=np.array([0, 1], np.uint8),
                material_payload=np.stack([mul, add]))]
    return P.parse_pmx(write_pmx(pm)), int(sdef.sum())


def content_motion(n_frames=240, fps_keys=5):
    """`sample_motion(n_frames, fps_keys)` with the content rig's two
    extended morphs keyed every `fps_keys` frames, each rising from 0 to 1
    and back within the motion (sin^2: the UV morph once, the material
    morph twice), through the port's `write_vmd` and `parse_vmd`."""
    from simple_mmd_renderer_tpu_torch.app.sample import sample_motion
    from simple_mmd_renderer_tpu_torch.formats.vmd import parse_vmd
    from simple_mmd_renderer_tpu_torch.formats.writers import write_vmd

    motion = sample_motion(n_frames, fps_keys=fps_keys)
    keys = []
    for f in range(0, n_frames + 1, fps_keys):
        phase = np.pi * f / n_frames
        keys += [(CONTENT_UV, f, float(np.sin(phase) ** 2)),
                 (CONTENT_MATERIAL, f, float(np.sin(2 * phase) ** 2))]
    motion.morph_tracks.update(parse_vmd(write_vmd("content", [],
                                                   keys)).morph_tracks)
    return motion


# the CLI phase's camera track: an orbit (yaw -0.6 -> 0.8 rad), a fov
# change (30 -> 45 degrees) and a "perspective off" range (frames 4-6)
CLI_CAMERA = [dict(frame=f, focal_length=-30.0 - f, position=(0.0, 11.0, 0.0),
                   rotation=(0.1, -0.6 + 0.1167 * f, 0.0),
                   fov=30.0 + 1.25 * f, orthographic=4 <= f <= 6)
              for f in (0, 3, 4, 6, 7, 12)]
# its light track: the light turns from front-left to back-right and warms
CLI_LIGHT = [dict(frame=0, color=(1.0, 1.0, 1.0), direction=(-0.5, -1.0, 0.3)),
             dict(frame=8, color=(1.0, 0.8, 0.6), direction=(0.2, -1.0, 0.0)),
             dict(frame=16, color=(0.9, 0.6, 0.4),
                  direction=(0.6, -0.8, -0.4))]


def cli_vmd(n_frames=240, fps_keys=5) -> bytes:
    """VMD bytes of `sample_motion(n_frames, fps_keys)`'s bone keys (their
    Bezier bytes as written), the camera track CLI_CAMERA and the light
    track CLI_LIGHT, through the port's `write_vmd`."""
    from simple_mmd_renderer_tpu_torch.app.sample import sample_motion
    from simple_mmd_renderer_tpu_torch.formats.writers import write_vmd

    motion = sample_motion(n_frames, fps_keys=fps_keys)
    keys = []
    for name, t in motion.bone_tracks.items():
        interp = np.rint(np.concatenate([t.c0, t.c1], -1) * 127)
        keys += [(name, int(f), t.translations[k], t.rotations[k],
                  interp[k].astype(np.int8))
                 for k, f in enumerate(t.frames)]
    return write_vmd("cli", keys, camera_keys=CLI_CAMERA,
                     light_keys=CLI_LIGHT)


def cli_files(directory, density=DENSITY) -> tuple[str, str]:
    """The CLI phase's inputs written into `directory`: the sample
    character at `density` as PMX (`write_pmx`) and `cli_vmd()` ->
    (pmx path, vmd path)."""
    from simple_mmd_renderer_tpu_torch.app.sample import sample_character
    from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx

    pmx = os.path.join(directory, f"sample_{density}.pmx")
    vmd = os.path.join(directory, "dance.vmd")
    with open(pmx, "wb") as f:
        f.write(write_pmx(sample_character(density=density)))
    with open(vmd, "wb") as f:
        f.write(cli_vmd())
    return pmx, vmd


def pmd_bytes(pm) -> bytes:
    """A PMD 1.0 file of a BDEF1/BDEF2-skinned PmxModel (e.g.
    `sample_character`), laid out as the PMD reader takes it: the
    vertices' first two bones and weight (as a byte / 100), the index list
    (uint16), each material (its diffuse, shininess, specular, ambient, no
    texture, an edge flag from MAT_DRAW_EDGE), the bones with their PMD
    types (IK 2, append-rotate with a ratio 9 and its ratio x100, movable
    1, others 0), an IK block per IK bone (the angle / 4, as the reader
    scales it by 4), the vertex morphs as face morphs over a "base" list of
    every vertex they move, an English block, the toon table, and the
    rigid bodies (positions relative to their bone) and joints. Bone and
    group morphs have no PMD form and are left out."""
    import struct

    from simple_mmd_renderer_tpu_torch.formats import pmx as P
    from simple_mmd_renderer_tpu_torch.utils.io import encode_shift_jis

    out = bytearray()
    w = out.extend
    w(b"Pmd" + struct.pack("<f", 1.0))
    w(encode_shift_jis(pm.name, 20) + encode_shift_jis(pm.description, 256))
    w(struct.pack("<I", len(pm.positions)))
    bones2 = np.maximum(pm.skin_bones[:, :2], 0)
    weight = np.where(pm.skin_type == P.BDEF1, 100,
                      np.rint(pm.skin_weights[:, 0] * 100)).astype(np.uint8)
    for i in range(len(pm.positions)):
        w(struct.pack("<8fhhBB", *pm.positions[i], *pm.normals[i],
                      *pm.uvs[i], *bones2[i], weight[i],
                      int(pm.edge_scale[i] == 0)))
    w(struct.pack("<I", pm.triangles.size))
    w(pm.triangles.astype("<u2").tobytes())
    w(struct.pack("<I", len(pm.materials)))
    for m in pm.materials:
        w(struct.pack("<4ff3f3fbBI", *m.diffuse, m.shininess, *m.specular,
                      *m.ambient, -1, int(bool(m.draw_flags
                                               & P.MAT_DRAW_EDGE)),
                      3 * m.n_triangles))
        w(encode_shift_jis("", 20))
    w(struct.pack("<H", len(pm.bones)))
    iks = []
    for i, b in enumerate(pm.bones):
        child, ik_number = -1, 0
        if b.has(P.BONE_HAS_IK):
            btype = 2
            iks.append(i)
        elif b.has(P.BONE_APPEND_ROTATE):
            btype, child = 9, b.append_parent
            ik_number = int(round(b.append_ratio * 100))
        else:
            btype = 1 if b.has(P.BONE_MOVABLE) else 0
        w(encode_shift_jis(b.name, 20))
        w(struct.pack("<hhBh3f", b.parent, child, btype, ik_number,
                      *b.position))
    w(struct.pack("<H", len(iks)))
    for i in iks:
        b = pm.bones[i]
        w(struct.pack("<hhBHf", i, b.ik_target, len(b.ik_links), b.ik_loop,
                      b.ik_angle / 4))
        w(struct.pack(f"<{len(b.ik_links)}H", *(l.bone for l in b.ik_links)))
    faces = [m for m in pm.morphs if m.type == P.MORPH_VERTEX]
    base = np.unique(np.concatenate([m.vertex_indices for m in faces])) \
        if faces else np.zeros(0, np.int64)
    w(struct.pack("<H", len(faces) + 1 if faces else 0))
    if faces:
        w(encode_shift_jis("base", 20) + struct.pack("<IB", len(base), 0))
        for v in base:
            w(struct.pack("<I3f", int(v), *pm.positions[v]))
    for m in faces:
        w(encode_shift_jis(m.name, 20))
        w(struct.pack("<IB", len(m.vertex_indices), max(m.category, 1)))
        for v, off in zip(np.searchsorted(base, m.vertex_indices),
                          m.vertex_offsets):
            w(struct.pack("<I3f", int(v), *off))
    w(struct.pack("<BBI", 0, 0, 0))             # display lists
    w(struct.pack("<B", 1) + encode_shift_jis(pm.name_en, 20)
      + encode_shift_jis(pm.description_en, 256))
    for b in pm.bones:
        w(encode_shift_jis(b.name_en, 20))
    for m in faces:
        w(encode_shift_jis(m.name_en, 20))
    for k in range(10):
        w(encode_shift_jis(f"toon{k + 1:02d}.bmp", 100))
    w(struct.pack("<I", len(pm.rigid_bodies)))
    for rb in pm.rigid_bodies:
        rel = rb.position - pm.bones[rb.bone].position
        w(encode_shift_jis(rb.name, 20))
        w(struct.pack("<HBHB14fB", rb.bone, rb.group, rb.mask, rb.shape,
                      *rb.dimensions, *rel, *rb.rotation, rb.mass,
                      rb.linear_damping, rb.angular_damping, rb.restitution,
                      rb.friction, rb.type))
    w(struct.pack("<I", len(pm.constraints)))
    for c in pm.constraints:
        w(encode_shift_jis(c.name, 20) + struct.pack("<II", c.body_a,
                                                     c.body_b))
        w(struct.pack("<24f", *c.position, *c.rotation, *c.pos_lo,
                      *c.pos_hi, *c.rot_lo, *c.rot_hi, *c.spring_translate,
                      *c.spring_rotate))
    return bytes(out)


def log(msg: str) -> None:
    """A line of output behind the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def smi_name_power() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + res.stderr.strip())
    return res.stdout.strip().splitlines()[0]


def host_paced_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls (after one warm-up), at
    the host's pace: a call's cost to the frame, the wrapper's Python
    included where the device waits for it. Not the kernels' record
    (`back_to_back_runs`)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def primed_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches run back to back
    (after one warm-up): a sleep kernel holds the stream while the host
    queues them, so that a kernel shorter than its wrapper's Python is not
    timed at the host's pace (`host_paced_ms`). The kernels' record and
    the plain versions' times use it."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PRIME_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def back_to_back_runs(fn) -> list[float]:
    """6 `primed_ms` means of 20 launches, least first: the kernels'
    record's timer (its `ms` is the least)."""
    return sorted(primed_ms(fn, 20) for _ in range(6))


def back_to_back(fn, runs=None) -> str:
    """The least and the median of 6 `primed_ms` means of 20 launches (or
    of `runs`, as back_to_back_runs gives them)."""
    runs = runs or back_to_back_runs(fn)
    return f"least {runs[0]:.4f}, median {runs[len(runs) // 2]:.4f} ms"


def pcf_line(label, runs, bnd) -> str:
    """K3's time back to back (`back_to_back_runs`) beside its bound; a
    card / bound under 1 means the maps stayed in the 50 MB L2 cache
    between the launches (the bound counts them read from device
    memory)."""
    ratio = runs[0] / bnd[0]
    note = (" (under 1: the maps stay in the L2 cache from one launch to the "
            "next)" if ratio < 1 else "")
    return (f"kernels: {label} back to back {back_to_back(None, runs)}; bound "
            f"{bnd[0]:.5f} ms ({bnd[1]}), card / bound {ratio:.2f}{note}")


def pcf_bound(args, lit, planes=1) -> tuple[float, str]:
    """K3's bound on `args` (the maps, z0, zc, zr): the maps read once, the
    lit maps written once and `planes` rows of (z0, zc, zr) read (1 for a
    shared plane, one a map for per-map planes); OPS_PCF a texel."""
    return bound(4 * (args[0].numel() + lit.numel()) + 12 * planes,
                 lit.numel() * OPS_PCF)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of the bytes
    over the memory rate and the operations over the fp32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bin_work(rows, starts, counts, width, height, tile_h, lanes,
             sample_dy=(0.0,), boxes=None):
    """(bytes read, entry-pixel evaluations) of a per-tile loop, from this
    run's bins: each real entry's first `lanes` lanes once, starts and
    counts; and each entry evaluated only over the pixels of its tile that
    it can cover, the rows holding a sample point (row + 0.5 + dy) inside
    the entry's y-range (setup lanes 11-12), each over the tile's columns in
    the frame (the rows carry no x-range). With the entries' pixel `boxes`
    (K1, K2, K4, K6 and the crowd's K5a, K5b, K5c) the columns are those of
    the exact box (the stored one less its margin; an entry given the whole
    range counts its tile's columns) inside the tile and the frame: the
    least work, neither the margin nor the kernel's split into small and
    wide boxes. The boxes are
    an aid of the kernel, not an input the function needs: their bytes are
    not counted."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    idx, tile = tr._tile_entries(starts, counts)
    n_bytes = 4 * (idx.numel() * lanes + 2 * counts.shape[0] + 1)
    tile = tile % tr._grid(width, height, tile_h)[2]   # a crowd's global tile
    tiles_x = -(-width // tr.TILE_W)
    row0 = (tile // tiles_x) * tile_h
    lo = torch.maximum(torch.ceil(rows[idx, 11] - 0.5 - max(sample_dy)).long(),
                       row0)
    hi = torch.minimum(torch.floor(rows[idx, 12] - 0.5 - min(sample_dy)).long(),
                       torch.clamp(row0 + tile_h, max=height) - 1)
    col0 = (tile % tiles_x) * tr.TILE_W
    cols = torch.clamp(width - col0, max=tr.TILE_W)
    if boxes is not None:
        first = torch.maximum(boxes[idx, 0].long() + tr.BOX_MARGIN, col0)
        last = torch.minimum(boxes[idx, 2].long() - tr.BOX_MARGIN,
                             col0 + cols - 1)
        cols = (last - first + 1).clamp(min=0)
    return n_bytes, int(((hi - lo + 1).clamp(min=0) * cols).sum())


def winning_entries(tri) -> int:
    """Distinct entries that win some pixel of a raster kernel's triangle
    plane tri [..., pad_h, pad_w] (-1: no winner). An entry is one triangle
    in one tile of one instance, and ids are unique within a tile."""
    from simple_mmd_renderer_tpu_torch.ops.tiled_raster import TILE_H, TILE_W

    h, w = tri.shape[-2:]
    dev = tri.device
    tile = ((torch.arange(h, device=dev) // TILE_H)[:, None] * (w // TILE_W)
            + (torch.arange(w, device=dev) // TILE_W)[None, :])
    n_inst = tri[..., 0, 0].numel()
    inst = torch.arange(n_inst, device=dev).reshape(tri.shape[:-2] + (1, 1))
    gtile = inst * (tile.numel() // (TILE_H * TILE_W)) + tile
    won = tri >= 0
    key = gtile.expand_as(tri)[won] * (int(tri.max()) + 1) + tri[won].long()
    return int(torch.unique(key).numel())


def raster_bound(args, out, ops_per_eval, sample_dy=(0.0,), boxes=None):
    """Bound of K2/K4 on their arguments (rows, starts, counts, width,
    height, n_attrs): of the bins, each entry's visibility lanes (0-10) and
    the winners' payload (the 1/w plane and the attributes' planes: lanes
    BASE_WIDTH on) once per distinct winning entry; every output plane out.
    With `boxes`, each entry charged over its exact box (`bin_work`)."""
    from simple_mmd_renderer_tpu_torch.ops.tiled_raster import TILE_H

    n_attrs = args[5]
    n_bytes, evals = bin_work(*args[:5], TILE_H, ROW_LANES, sample_dy, boxes)
    if n_attrs:
        n_bytes += 4 * (3 + 3 * n_attrs) * winning_entries(out[1])
    n_bytes += sum(t.numel() * t.element_size() for t in out)
    pixels = out[0].numel()
    n_ops = (evals * ops_per_eval
             + pixels * (OPS_WINNER + OPS_PER_ATTR * n_attrs))
    return bound(n_bytes, n_ops)


def log_rules(key, rows_rule, box_rule, ms, starts, counts, boxes,
              tail=""):
    """Print a kernel's bound by the rows rule beside the box rule."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    idx, _ = tr._tile_entries(starts, counts)
    whole = int((boxes[idx, 2] == torch.iinfo(boxes.dtype).max).sum())
    log(f"kernels: {key} bound by the rows rule {rows_rule[0]:.5f} ms "
        f"({rows_rule[1]}; card / bound {ms / rows_rule[0]:.1f}), by the box "
        f"rule {box_rule[0]:.5f} ms ({box_rule[1]}; card / bound "
        f"{ms / box_rule[0]:.1f}); {whole} of {idx.numel()} entries carry "
        f"the whole range as their box{tail}")


def boxed_bound(key, args, boxes, out, ms):
    """The bound of K2, K4, K5a or K5b with each entry charged over its
    exact box (the rule its record carries), printed beside the rule of the
    kernels without boxes (the tile's columns over the entry's rows)."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    if key in ("K4", "K5b"):
        ops, dy = OPS_RASTER_MS, (0.0,) + tuple(oy for _, oy
                                              in tr.MSAA4_OFFSETS)
    else:
        ops, dy = OPS_RASTER, (0.0,)
    rows_rule = raster_bound(args, out, ops, dy)
    box_rule = raster_bound(args, out, ops, dy, boxes)
    log_rules(key, rows_rule, box_rule, ms, args[1], args[2], boxes,
              f", {winning_entries(out[1])} win some pixel")
    return box_rule


def depth_bound(key, bins, tile_h, boxes, out_bytes, ms):
    """The bound of K1, K6 or K5c on their bins (rows, starts, counts,
    width, height; K5c's over the global tiles of its instances): each real
    entry's lanes 0-10, starts and counts, and `out_bytes` (the map or
    maps, K6's window) moved; OPS_DEPTH for each pixel an
    entry can cover, over its exact box (the rule the record carries),
    printed beside the rows rule (its rows over its tile's columns)."""
    rules = []
    for bx in (None, boxes):
        n_bytes, evals = bin_work(*bins, tile_h, ROW_LANES, boxes=bx)
        rules.append(bound(n_bytes + out_bytes, evals * OPS_DEPTH))
    log_rules(key, *rules, ms, bins[1], bins[2], boxes)
    return rules[1]


def kernel_bound(key, args, out) -> tuple[float, str]:
    """The bound of kernel `key`'s call on `args` (as its wrapper takes
    them) that returned `out`, by the rule its record carries: K1, K6 and
    K5c by `bin_work` over the entries' exact boxes, their map (K6: and its
    window) written; K2, K4, K5a and K5b by `raster_bound` with the boxes;
    K3 by `pcf_bound`, one plane row for a shared plane, one a map for
    per-map planes."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    if key == "K3":
        return pcf_bound(args, out, 1 if np.ndim(args[1]) == 0
                         else args[0].shape[0])
    if key == "K1":
        bins, tile_h, boxes, window = args[:5], tr.TILE_H, args[5], 0
    elif key == "K6":
        bins, tile_h, boxes = args[:3] + args[4:6], args[6], args[7]
        window = args[3].numel()
    elif key == "K5c":     # args[3]: the instance count
        bins, tile_h, boxes, window = (args[:3] + args[4:6], tr.TILE_H,
                                       args[6], 0)
    else:
        multi = key in ("K5a", "K5b")
        bins, boxes = ((args[:3] + args[4:7], args[7]) if multi
                       else (args[:6], args[6]))
        if key in ("K4", "K5b"):
            return raster_bound(bins, out, OPS_RASTER_MS, (0.0,) + tuple(
                oy for _, oy in tr.MSAA4_OFFSETS), boxes)
        return raster_bound(bins, out, OPS_RASTER, boxes=boxes)
    n_bytes, evals = bin_work(*bins, tile_h, ROW_LANES, boxes=boxes)
    return bound(n_bytes + 4 * (out.numel() + window), evals * OPS_DEPTH)


def record(results, key, name, source, line, err, runs, plain, bnd):
    """The record line of kernel `key` from its back-to-back `runs`
    (`back_to_back_runs`: its `ms` is the least); `line` is the file:line
    it replaces in the reference package (KS: the reference scan raster's
    lax.scan)."""
    results[key] = dict(
        name=name, route="cuda",
        source=f"simple_mmd_renderer_tpu_torch/csrc/{source}",
        replaces=f"simple_mmd_renderer_tpu/{line}",
        max_abs_err=err, ms=runs[0], plain_ms=plain, bound_ms=bnd[0],
        bound_by=bnd[1],
        # no single PyTorch call computes a binned tile raster or a
        # per-texel-reference PCF
        library_ms=None, median_ms=runs[len(runs) // 2])
    log(f"kernels: {key} record: back to back {back_to_back(None, runs)}, "
        f"bound {bnd[0]:.5f} ms ({bnd[1]}), card / bound "
        f"{runs[0] / bnd[0]:.2f}, plain {plain:.4f} ms")


def reset_counters():
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    shadow_pcf.launches = 0
    tr.depth_launches = tr.raster_launches = 0
    tr.raster_ms_launches = tr.depth_win_launches = 0
    tr.raster_multi_launches = tr.raster_ms_multi_launches = 0
    tr.depth_multi_launches = tr.scan_launches = tr.scan_bin_launches = 0


def read_counters() -> dict:
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    return {"K1": tr.depth_launches, "K2": tr.raster_launches,
            "K3": shadow_pcf.launches, "K4": tr.raster_ms_launches,
            "K6": tr.depth_win_launches, "K5a": tr.raster_multi_launches,
            "K5b": tr.raster_ms_multi_launches,
            "K5c": tr.depth_multi_launches}


def scan_counts() -> dict:
    """KS's and KSb's launches since the last reset."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    return {"KS": tr.scan_launches, "KSb": tr.scan_bin_launches}


def merge_launches(label, frames, rasters) -> int:
    """KS's launches since the last reset, on a tiled path: the
    big-triangle merges, one a raster whose frame has a triangle over more
    tiles than its binning's e_max (at most `rasters` a frame), each after
    one launch of KSb."""
    counts = scan_counts()
    n = counts["KS"]
    log(f"{label}: KS (big-triangle merges) launched {n} times in {frames} "
        f"frames, KSb {counts['KSb']}")
    if n > frames * rasters:
        raise AssertionError(f"{label}: more merges than rasters")
    if counts["KSb"] != n:
        raise AssertionError(f"{label}: KSb and KS launched {counts}")
    return n


def add_merges(n: int) -> None:
    """Counts `n` merges (a KSb and a KS launch each) to the record."""
    MAIN_LAUNCHES["KS"] += n
    MAIN_LAUNCHES["KSb"] += n


def path_kernels(cfg) -> dict:
    """{kernel: launches} of a single frame of render config `cfg` (the
    shadow window applies to maps of at least 1024^2; the edge outlines
    add one launch of K2 at 0 attributes, beside K2 or K4)."""
    out = {"K6" if cfg.shadow_window and cfg.shadow_map_size >= 1024
           else "K1": 1, "K4" if cfg.msaa >= 4 else "K2": 1, "K3": 1}
    if cfg.show_edges:
        out["K2"] = out.get("K2", 0) + 1
    return out


def crowd_kernels(msaa: bool, edges: bool = False) -> dict:
    """{kernel: launches} of a crowd frame (the edge outlines add one launch
    of K5a at 1 attribute, beside K5a or K5b)."""
    out = {"K5c": 1, "K5b" if msaa else "K5a": 1, "K3": 1}
    if edges:
        out["K5a"] = out.get("K5a", 0) + 1
    return out


def capture_frame(step, state, expect):
    """One frame through `step` (`Scene.step_and_render`, or a crowd's
    step function), recording the arguments and result of every call of
    every kernel wrapper: -> (state', image, {"K1"|...|"K5c": [(args,
    result), ...] in call order}). The frame must call each wrapper as
    many times as `expect` ({kernel: calls}) says, and no other."""
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    seen = {}
    wrapped = [(tr, "depth_tiles", "K1"), (tr, "raster_tiles", "K2"),
               (shadow_pcf, "pcf_lit_map", "K3"),
               (tr, "raster_tiles_ms", "K4"), (tr, "depth_tiles_win", "K6"),
               (tr, "raster_tiles_multi", "K5a"),
               (tr, "raster_tiles_ms_multi", "K5b"),
               (tr, "depth_tiles_multi", "K5c")]
    originals = [getattr(mod, name) for mod, name, _ in wrapped]

    def spy(fn, key):
        def call(*args, **kw):
            out = fn(*args, **kw)
            seen.setdefault(key, []).append((args, out))
            return out
        return call

    try:
        for (mod, name, key), fn in zip(wrapped, originals):
            setattr(mod, name, spy(fn, key))
        state, image = step(state)
    finally:
        for (mod, name, _), fn in zip(wrapped, originals):
            setattr(mod, name, fn)
    calls = {k: len(v) for k, v in seen.items()}
    if calls != dict(expect):
        raise AssertionError(f"the frame called {calls}, expected "
                             f"{dict(expect)}")
    return state, image, seen


def dense_bins(device, n=2000, sample_extent=0.0):
    """A 128x64 target (two tiles) holding n small triangles at one depth:
    each tile gets several shared-memory chunks of entries, and every
    overlap is a z-tie. -> (rows, starts, counts, pixel boxes)."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
    from simple_mmd_renderer_tpu_torch.render import raster

    rng = np.random.default_rng(0)
    v0 = rng.uniform(-0.9, 0.9, (n, 2)) * np.array([0.9, 0.4]) - [0.0, 0.5]
    d1 = rng.uniform(-0.08, 0.08, (n, 2))
    d2 = rng.uniform(-0.08, 0.08, (n, 2))
    verts = np.stack([v0, v0 + d1, v0 + d2], 1).reshape(-1, 2)
    clip = np.concatenate([verts, np.full((3 * n, 1), 0.5),
                           np.ones((3 * n, 1))], -1).astype(np.float32)
    clip = torch.as_tensor(clip, device=device)
    tris = torch.arange(3 * n, dtype=torch.int32, device=device).reshape(n, 3)
    attrs = torch.as_tensor(rng.normal(size=(3 * n, 3)).astype(np.float32),
                            device=device)
    s = raster.setup(clip, tris, 128, 64, raster.CULL_NONE,
                     sample_extent=sample_extent)
    s["tris_v"] = tris
    rows = tr._setup_rows(s, torch.arange(n, device=device), attrs)
    bins = tr._bin(s, rows, 128, 64, 2, False,
                   boxes=tr._pixel_boxes(s, sample_extent))
    return bins[:3] + bins[4:]


def mismatches(got, want, seen=None) -> int:
    """Elements that differ from the plain version (and from what the main
    path computed, where given)."""
    n = int((got != want).sum())
    return n if seen is None else n + int((got != seen).sum())


def check_kernels(scene, state, results):
    """K1, K2, K3 on the msaa=1 flagship's frame-1 arguments."""
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    _, _, seen = capture_frame(scene.step_and_render, state,
                               path_kernels(scene.config.render))  # frame 1
    (k1_args, k1_out), = seen["K1"]
    (k2_args, k2_out), = seen["K2"]
    (k3_args, k3_out), = seen["K3"]
    if len(k1_args) != 6 or k1_args[5] is None:
        raise AssertionError("the frame passed K1 no pixel boxes")
    if len(k2_args) != 7 or k2_args[6] is None:
        raise AssertionError("the frame passed K2 no pixel boxes")
    c1, c2 = k1_args[2], k2_args[2]
    log(f"kernels: frame-1 bins (msaa=1): shadow {int(c1.sum())} entries in "
        f"{c1.shape[0]} tiles (max {int(c1.max())}), character "
        f"{int(c2.sum())} entries in {c2.shape[0]} tiles (max "
        f"{int(c2.max())})")

    # K1 at bench shapes, with the frame's boxes; the plain version is brute
    # force
    got = tr.depth_tiles(*k1_args)
    want = tr.depth_tiles_plain(*k1_args[:5])
    k1_bad = mismatches(got, want, k1_out)
    k1_err = float((got - want).abs().max())
    k1_runs = back_to_back_runs(lambda: tr.depth_tiles(*k1_args))
    k1_plain = primed_ms(lambda: tr.depth_tiles_plain(*k1_args[:5]), 3)
    log(f"kernels: K1 depth_tiles {tuple(got.shape)}: mismatches {k1_bad}, "
        f"back to back {back_to_back(None, k1_runs)} vs plain "
        f"{k1_plain:.4f} ms")
    k1_bound = depth_bound("K1", k1_args[:5], tr.TILE_H, k1_args[5],
                           4 * got.numel(), k1_runs[0])

    # K3 at bench shapes, on the frame's shadow map
    lit = shadow_pcf.pcf_lit_map(*k3_args)
    lit_plain = shadow_pcf.pcf_lit_map_plain(*k3_args)
    k3_bad = mismatches(lit, lit_plain, k3_out)
    k3_err = float((lit - lit_plain).abs().max())
    k3_plain = primed_ms(lambda: shadow_pcf.pcf_lit_map_plain(*k3_args), 5)
    k3_bound = pcf_bound(k3_args, lit)
    k3_runs = back_to_back_runs(lambda: shadow_pcf.pcf_lit_map(*k3_args))
    log(f"kernels: K3 pcf_lit_map {tuple(lit.shape)}: mismatches {k3_bad}, "
        f"plain {k3_plain:.4f} ms")
    log(pcf_line(f"K3 pcf_lit_map {tuple(lit.shape)}", k3_runs, k3_bound))

    # K2 at bench shapes (A = 3: normals)
    k2 = tr.raster_tiles(*k2_args)
    k2p = tr.raster_tiles_plain(*k2_args[:6])          # brute force
    k2_bad = [mismatches(a, b, c) for a, b, c in zip(k2[:4], k2p[:4],
                                                      k2_out[:4])]
    k2_attr_err = float((k2[4] - k2p[4]).abs().max())
    k2_err = max(k2_attr_err, max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(k2[:4], k2p[:4])))
    k2_runs = back_to_back_runs(lambda: tr.raster_tiles(*k2_args))
    k2_plain = primed_ms(lambda: tr.raster_tiles_plain(*k2_args[:6]), 3)
    log(f"kernels: K2 raster_tiles {tuple(k2[0].shape)}, {k2_args[5]} "
        f"attributes: depth/tri/b1/b2 mismatches {k2_bad}, attr max err "
        f"{k2_attr_err:.3g}, back to back {back_to_back(None, k2_runs)} vs "
        f"plain {k2_plain:.4f} ms")
    k2_bound = boxed_bound("K2", k2_args[:6], k2_args[6], k2, k2_runs[0])

    # dense tile: more entries than a block takes at once, all at one depth
    # (K1 and K2 with their boxes: small ones, a thread each; and with none,
    # so that every entry is a wide one over its whole tile)
    rd, sd, cd, bd = dense_bins(c1.device)
    ddp = tr.depth_tiles_plain(rd, sd, cd, 128, 64)
    kdp = tr.raster_tiles_plain(rd, sd, cd, 128, 64, 3)
    dense_bad, dense_attr = [], 0.0
    for boxes in (bd, None):
        dense_bad.append(mismatches(tr.depth_tiles(rd, sd, cd, 128, 64,
                                                   boxes), ddp))
        kd = tr.raster_tiles(rd, sd, cd, 128, 64, 3, boxes)
        dense_bad += [mismatches(a, b) for a, b in zip(kd[:4], kdp[:4])]
        dense_attr = max(dense_attr, float((kd[4] - kdp[4]).abs().max()))
    log(f"kernels: dense tile ({int(cd.max())} entries in one tile): K1 and "
        f"K2 with boxes, then without, mismatches {dense_bad}, attr max err "
        f"{dense_attr:.3g}")

    if k1_bad or k3_bad or any(k2_bad) or any(dense_bad):
        raise AssertionError("a kernel disagrees with its plain version")
    if not (k2_attr_err <= 1e-6 and dense_attr <= 1e-6):
        raise AssertionError("K2 attributes beyond 1e-6 of the plain version")

    record(results, "K1", "K1 depth_tiles (shadow depth)", "tiled_raster.cu",
           "ops/tiled_raster.py:1139", k1_err, k1_runs, k1_plain, k1_bound)
    record(results, "K2", "K2 raster_tiles (character visibility + "
           "attributes)", "tiled_raster.cu", "ops/tiled_raster.py:430",
           k2_err, k2_runs, k2_plain, k2_bound)
    record(results, "K3", "K3 pcf_lit_map (ground 3x3 PCF)", "shadow_pcf.cu",
           "ops/shadow_pcf.py:37", k3_err, k3_runs, k3_plain, k3_bound)


def check_kernels_msaa(scene, state, results):
    """K4 and K6 on the msaa=4 + shadow_window flagship's frame-1
    arguments."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    _, _, seen = capture_frame(scene.step_and_render, state,
                               path_kernels(scene.config.render))  # frame 1
    (k6_args, k6_out), = seen["K6"]
    (k4_args, k4_out), = seen["K4"]
    if len(k6_args) != 8 or k6_args[7] is None:
        raise AssertionError("the frame passed K6 no pixel boxes")
    if len(k4_args) != 7 or k4_args[6] is None:
        raise AssertionError("the frame passed K4 no pixel boxes")
    rows6, starts6, counts6, window = k6_args[:4]
    width6, height6, tile_h6, boxes6 = k6_args[4:]
    c4 = k4_args[2]
    log(f"kernels: frame-1 bins (msaa=4, shadow window): shadow "
        f"{int(counts6.sum())} entries in {counts6.shape[0]} tiles of "
        f"{k6_args[6]} rows (max {int(counts6.max())}), window (row, col, "
        f"rows, cols) {window.tolist()}; character {int(c4.sum())} entries "
        f"in {c4.shape[0]} tiles (max {int(c4.max())})")

    # K6 at bench shapes with the frame's boxes (the plain version brute
    # force), and K1 over the same bins and boxes (32-row tiles)
    if tile_h6 != tr.TILE_H:
        raise AssertionError(f"K6 ran on {tile_h6}-row tiles, K1 takes "
                             f"{tr.TILE_H}")
    got = tr.depth_tiles_win(*k6_args)
    want = tr.depth_tiles_win_plain(*k6_args[:7])
    k6_bad = mismatches(got, want, k6_out)
    k6_err = float((got - want).abs().max())
    bins6 = (rows6, starts6, counts6, width6, height6)
    k6_vs_k1 = mismatches(got, tr.depth_tiles(*bins6, boxes6))
    k6_runs = back_to_back_runs(lambda: tr.depth_tiles_win(*k6_args))
    k6_plain = primed_ms(lambda: tr.depth_tiles_win_plain(*k6_args[:7]), 3)
    log(f"kernels: K6 depth_tiles_win {tuple(got.shape)}: mismatches "
        f"{k6_bad}, vs K1 on the same bins and boxes {k6_vs_k1}, back to "
        f"back {back_to_back(None, k6_runs)} vs plain {k6_plain:.4f} ms")
    # K6's wrapper fills the map with 1.0, then the kernel writes the
    # window's tiles; K1 on the same bins writes every tile itself
    fill_b2b = back_to_back(lambda: torch.ones_like(got))
    k1_b2b = back_to_back(lambda: tr.depth_tiles(*bins6, boxes6))
    log(f"kernels: K6's fill alone back to back {fill_b2b}; K1 on the same "
        f"bins and boxes {k1_b2b}")
    k6_bound = depth_bound("K6", bins6, tile_h6, boxes6,
                           4 * (window.numel() + got.numel()), k6_runs[0])

    # K4 at bench shapes (A = 3: normals)
    k4 = tr.raster_tiles_ms(*k4_args)
    k4p = tr.raster_tiles_ms_plain(*k4_args[:6])       # brute force
    exact = (0, 1, 2, 3, 5)      # depth, tri, b1, b2, sdepth
    k4_bad = [mismatches(k4[i], k4p[i], k4_out[i]) for i in exact]
    k4_attr_err = float((k4[4] - k4p[4]).abs().max())
    k4_err = max(k4_attr_err, max(float((k4[i].float()
                                         - k4p[i].float()).abs().max())
                                  for i in exact))
    k4_runs = back_to_back_runs(lambda: tr.raster_tiles_ms(*k4_args))
    k4_plain = primed_ms(lambda: tr.raster_tiles_ms_plain(*k4_args[:6]), 3)
    edge = float(((k4[1] >= 0) & ~(k4[5] < 1.0).all(0)).float().mean())
    log(f"kernels: K4 raster_tiles_ms {tuple(k4[0].shape)}, {k4_args[5]} "
        f"attributes: depth/tri/b1/b2/sdepth mismatches {k4_bad}, attr max "
        f"err {k4_attr_err:.3g}, back to back {back_to_back(None, k4_runs)} "
        f"vs plain {k4_plain:.4f} ms; {100 * edge:.3f}% of pixels won with "
        f"some sample uncovered")
    k4_bound = boxed_bound("K4", k4_args[:6], k4_args[6], k4, k4_runs[0])

    # dense tile for K4, binned with the MSAA sample-point cull
    # (with its boxes: small ones, a thread each; and with none, so that
    # every entry is a wide one over its whole tile)
    rd, sd, cd, bd = dense_bins(c4.device, sample_extent=tr.MSAA4_EXTENT)
    kdp = tr.raster_tiles_ms_plain(rd, sd, cd, 128, 64, 3)
    dense_bad, dense_attr = [], 0.0
    for boxes in (bd, None):
        kd = tr.raster_tiles_ms(rd, sd, cd, 128, 64, 3, boxes)
        dense_bad += [mismatches(kd[i], kdp[i]) for i in exact]
        dense_attr = max(dense_attr, float((kd[4] - kdp[4]).abs().max()))
    log(f"kernels: dense tile ({int(cd.max())} entries in one tile): K4 "
        f"with and without boxes, mismatches {dense_bad}, attr max err "
        f"{dense_attr:.3g}")

    if k6_bad or k6_vs_k1 or any(k4_bad) or any(dense_bad):
        raise AssertionError("a kernel disagrees with its plain version")
    if not (k4_attr_err <= 1e-6 and dense_attr <= 1e-6):
        raise AssertionError("K4 attributes beyond 1e-6 of the plain version")

    record(results, "K4", "K4 raster_tiles_ms (4x MSAA visibility + "
           "attributes + per-sample depth)", "tiled_raster.cu",
           "ops/tiled_raster.py:660", k4_err, k4_runs, k4_plain, k4_bound)
    record(results, "K6", "K6 depth_tiles_win (shadow depth over the "
           "casters' tile window)", "tiled_raster.cu",
           "ops/tiled_raster.py:1156", k6_err, k6_runs, k6_plain, k6_bound)


def eager_steps(scene, state, n: int):
    """n frames of the eager step (`Scene.step_pose`) from `state` -> (the
    frames' outputs, ms/frame, the CCD iterations each IK group ran in each
    frame: [(loop, chains, iterations), ...] a frame). The iterations are
    those with a chain still active, as the plain loop's early exit runs
    them, counted from the solve's flags (each group is solved with a
    flag buffer, which leaves its bits as they are)."""
    from simple_mmd_renderer_tpu_torch.core import pose as pose_mod

    solve = pose_mod._solve_ik_group
    groups = []

    def solve_spy(static, pose, seg, *args):
        g = seg.links.shape[0]
        flags = torch.zeros(seg.loop * g, dtype=torch.bool,
                            device=pose.world.device)
        out = solve(static, pose, seg, *args[:4], True, flags)
        groups[-1].append((seg.loop, g, flags.view(seg.loop, g).any(1)))
        return out

    frames = []
    pose_mod._solve_ik_group = solve_spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            groups.append([])
            frames.append(scene.step_pose(state))
            state = frames[-1][0]
        torch.cuda.synchronize()
    finally:
        pose_mod._solve_ik_group = solve
    ms = 1000.0 * (time.perf_counter() - t0) / n
    return frames, ms, [[(loop, g, int(run.sum())) for loop, g, run in frame]
                        for frame in groups]


def check_compiled(label, scene, state, n: int) -> None:
    """The path's step captured (`Scene.captured_step`: the warm-up and the
    capture run under the sync debug mode "error") and replayed n times
    under that mode; each replay must equal the eager step's frame bit for
    bit. Prints the capture's seconds, both steps' ms/frame and the eager
    CCD iterations. The CCD solve's kernel (`csrc/ccd.cu`) on this path:
    `ops.ccd.launches` over the capture must be two a group (the warm-up's
    and the captured one), none where the graph already existed, and the
    device trace of one replay must hold one `ccd_kernel` a group."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.ops import ccd
    from simple_mmd_renderer_tpu_torch.utils.graph import (shape_key,
                                                           sync_errors,
                                                           tree_leaves)

    eager, eager_ms, iters = eager_steps(scene, state, n)
    groups = len(iters[0])
    shared = shape_key(state) in scene._graphs
    ccd.launches = 0
    t0 = time.perf_counter()
    scene.captured_step(state)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captured = ccd.launches
    step = scene.jit_step(render=False)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    with sync_errors():
        s = state
        for want in eager:
            got = step(s)
            for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
                bad += (a != b).sum()
            s = got[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_errors():
        for _ in range(n):
            s = step(s)[0]
    torch.cuda.synchronize()
    replay_ms = 1000.0 * (time.perf_counter() - t0) / n
    bad = int(bad)
    stamps = scene.captured_step(state).clock.stamps
    if stamps != STAMPS:
        raise AssertionError(f"the compiled step ({label}) launches {stamps}"
                             f" stamps a replay, expected {STAMPS}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(s)
        torch.cuda.synchronize()
    traced = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "ccd_kernel" in e.name)
    log(f"compiled ({label}): the CCD kernel launched {captured} times "
        f"over the capture, {traced} ccd_kernel in the device trace of one "
        f"replay; {groups} IK groups a step")
    if traced != groups or captured != (0 if shared else 2 * groups):
        raise AssertionError(f"the compiled step ({label}) does not launch "
                             "the CCD kernel once an IK group")
    same = all(frame == iters[0] for frame in iters)
    log(f"compiled ({label}): capture {capture_s:.3f} s"
        f"{' (the graph already existed)' if shared else ''}; {n} replays "
        f"vs {n} eager steps: mismatches {bad} over "
        f"{len(tree_leaves(eager[0]))} leaves a frame; step {eager_ms:.3f} "
        f"ms/frame eager, {replay_ms:.3f} ms/frame replayed; eager CCD "
        f"(loop, chains, iterations run) per group and frame "
        f"{iters[0] if same else iters}{' in every frame' if same else ''}")
    if bad:
        raise AssertionError(f"the compiled step ({label}) differs from the "
                             "eager step")


# stamp kernels a replay of a compiled step launches (`csrc/stamp.cu`): one
# at its start and one at the end of each of its six stages
STAMPS = 7


def check_stamp(label, scene, state, n: int) -> None:
    """The stage clock's stamp kernel (`csrc/stamp.cu`,
    `utils/profiling.StepClock`) in the path's compiled step, the bake's
    `Scene.jit_step(render=False)`: the stamps a replay launches, on the
    clock's counter (`StepClock.stamps`) and in the device trace of one
    replay (kernels named `stamp_kernel`); over n replays, each posing
    pass's (run, useful) in the replay's ring row against the flags the
    graph wrote (`StepClock.actives`) counted by torch.sum, and the row's
    stamps in order; then the kernel back to back with the first pass's
    flags and with none, beside its byte bound."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.utils import profiling

    step = scene.captured_step(state)
    clock = step.clock
    if clock.stamps != STAMPS:
        raise AssertionError(f"stamp ({label}): {clock.stamps} stamps a "
                             f"replay, expected {STAMPS}")
    step.load(state)
    bad, counts = 0, {}
    for _ in range(n):
        ordinal = clock.replays
        step.replay()
        torch.cuda.synchronize()
        row = clock.ring[ordinal % clock.rows].tolist()
        stamps = [row[0]] + [row[c] for _, c in clock.stages]
        bad += any(b < a for a, b in zip(stamps, stamps[1:])) or not row[0]
        for p, col in clock.ccd.items():
            flags = clock.actives[p]
            want = (flags.numel(), int(torch.sum(flags)))
            counts[p] = (row[col], row[col + 1])
            bad += counts[p] != want
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.replay()
        torch.cuda.synchronize()
    traced = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "stamp_kernel" in e.name)
    log(f"stamp ({label}): {clock.stamps} stamps a replay, {traced} "
        f"stamp_kernel in the device trace of one; {n} replays: ring rows "
        f"against torch.sum of the graph's CCD flags and stamps in order, "
        f"mismatches {bad}; (run, useful) per posing pass {counts}")
    if bad or traced != STAMPS or set(clock.ccd) != set(
            profiling.CCD_PASSES):
        raise AssertionError(f"the stage clock ({label}) is wrong")

    spare = profiling.StepClock("cuda")
    flags = clock.actives["pre_physics"]
    spare._stamp(0, advance=True)
    with_flags = back_to_back_runs(lambda: spare._stamp(1, flags, 2))
    alone = back_to_back_runs(lambda: spare._stamp(1))
    # the flags and the counter read, the stamp and the pair written
    bnd = bound(flags.numel() + 8 + 3 * 8, 0)
    log(f"stamp ({label}): back to back with {flags.numel()} flags "
        f"{back_to_back(None, with_flags)}, without "
        f"{back_to_back(None, alone)}; bound {bnd[0] * 1e6:.3f} ns "
        f"({bnd[1]}), "
        f"card / bound {with_flags[0] / bnd[0]:.0f}: a launch's own cost")


# the pose fields the CCD solve writes
CCD_FIELDS = ("world", "total_rot", "total_trans", "pre_ik_rot", "ik_rot")


def ccd_serial(static, fields, seg, inputs):
    """One launch of the CCD solve with its block's clocks (`ops.ccd.launch`
    with `clocks`: %globaltimer and clock64 at the block's start, after the
    pre-loop FK and at its end) -> (ms from start to end, ms of the pre-loop
    FK, the SM's cycles a ns over the launch): the chain's serial path as
    the kernel runs it."""
    from simple_mmd_renderer_tpu_torch.ops import ccd

    clocks = torch.zeros(6, dtype=torch.int64, device="cuda")
    ccd.launch(static, fields, seg, inputs, clocks=clocks)
    t = clocks.tolist()
    ns = t[4] - t[0]
    return ns / 1e6, (t[2] - t[0]) / 1e6, (t[5] - t[1]) / ns


def check_ccd(label, scene, state) -> float:
    """The CCD solve (`csrc/ccd.cu`) on the path's IK groups: the inputs
    of each group from one eager capturable step, solved by the kernel and
    by the plain loop (`pose.solve_ik_group_plain`): the pose fields it
    writes and the CCD flags bit for bit, each dispatcher call one launch
    of the kernel (`ops.ccd.launches`); then the kernel back to back on
    them (`ops.ccd.launch`, in place) beside its bound: the launch's own
    cost (the stamp kernel's without flags, back to back in this run) plus
    the chain's serial path timed by the kernel's own clocks
    (`ccd_serial`); and the plain loop's time at the host's pace (its
    ~20,000 launches a group). Its launches a replay: one a group of each
    posing pass. -> the groups' least back-to-back ms summed."""
    from simple_mmd_renderer_tpu_torch.core import pose as pose_mod
    from simple_mmd_renderer_tpu_torch.ops import ccd
    from simple_mmd_renderer_tpu_torch.utils import profiling

    solve, calls = pose_mod._solve_ik_group, []

    def spy(static, pose, seg, *args):
        calls.append((static, pose, seg, args[:4]))
        return solve(static, pose, seg, *args)

    pose_mod._solve_ik_group = spy
    try:
        scene.step_pose(state, capturable=True)
    finally:
        pose_mod._solve_ik_group = solve
    spare = profiling.StepClock("cuda")
    spare._stamp(0, advance=True)
    launch_ms = back_to_back_runs(lambda: spare._stamp(1))[0]
    bad_all, total = 0, 0.0
    for static, p, seg, ins in calls:
        g, n = seg.links.shape[0], seg.loop * seg.links.shape[0]
        flags_plain = torch.zeros(n, dtype=torch.bool, device="cuda")
        flags = torch.ones(n, dtype=torch.bool, device="cuda")
        want = pose_mod.solve_ik_group_plain(static, p, seg, *ins, True,
                                             flags_plain)
        before = ccd.launches
        got = solve(static, p, seg, *ins, True, flags)
        launched = ccd.launches - before
        bad = {f: int((getattr(got, f).view(torch.int32)
                       != getattr(want, f).view(torch.int32)).sum())
               for f in CCD_FIELDS}
        bad["flags"] = int((flags != flags_plain).sum())
        bad["launches"] = abs(launched - 1)
        bad_all += sum(bad.values())
        fields = [getattr(got, f).clone() for f in CCD_FIELDS]
        inputs = [t.contiguous() for t in ins]
        runs = back_to_back_runs(lambda: ccd.launch(static, fields, seg,
                                                    inputs))
        plain_ms = host_paced_ms(lambda: pose_mod.solve_ik_group_plain(
            static, p, seg, *ins, True, flags_plain), 2)
        serial_ms, pre_ms, ghz = ccd_serial(static, fields, seg, inputs)
        bnd = launch_ms + serial_ms
        total += runs[0]
        log(f"ccd ({label}): {g} chains x {seg.n_links} links, loop "
            f"{seg.loop}, fix {seg.fix_types}, orders "
            f"{ccd.orders(p.world.device, g).tolist()}: kernel vs plain "
            f"loop mismatches {bad}; active {int(flags_plain.sum())} of {n} "
            f"chain-iterations; back to back {back_to_back(None, runs)}; "
            f"bound {bnd:.4f} ms (launch {launch_ms:.4f} + serial path "
            f"{serial_ms:.4f} by the kernel's clocks: pre-loop FK "
            f"{pre_ms:.4f}, {(serial_ms - pre_ms) / seg.loop * 1e3:.3f} us "
            f"an iteration, SM at {ghz:.3f} GHz), card / bound "
            f"{runs[0] / bnd:.2f}; the plain loop "
            f"{plain_ms:.3f} ms host-paced")
    log(f"ccd ({label}): {len(calls)} launches a replay (one a group), "
        f"{total:.4f} ms back to back in all")
    if bad_all or not calls:
        raise AssertionError(f"the CCD solve ({label}) differs from the "
                             "plain loop")
    return total


# the order of the SDEF-on (True) and SDEF-off step segments
SDEF_ORDER = (True, False, False, True) * 2


def sdef_step_times(label, scene, state, n=EAGER_SEGMENT):
    """A content scene's replayed step (pose + physics + deform; a single
    or a crowd state) with `sdef_true` on and with it off (a copy of the
    scene with its own graph), each warmed up, then segments of n replays
    in turns (SDEF_ORDER) from `state`: prints both ms/frame (the median
    of the segments, and each), their difference and the SDEF vertex
    count. The two
    steps' vertices must differ, and only at the SDEF vertices."""
    off = copy.copy(scene)
    off.config = dataclasses.replace(scene.config, sdef_true=False)
    off._graphs = {}
    steps = {True: scene.jit_step(render=False, donate=False),
             False: off.jit_step(render=False, donate=False)}
    pos = {on: steps[on](state)[2] for on in steps}     # captures both
    moved = (pos[True] - pos[False]).abs().amax(-1)
    idx = scene.rig.sdef_idx
    if not (bool((moved[..., idx] > 0).any())
            and not bool(moved.index_fill(-1, idx, 0).any())):
        raise AssertionError("sdef_true moved no SDEF vertex, or moved "
                             "another")
    for on in steps:                    # warm-up
        s = state
        for _ in range(n):
            s = steps[on](s)[0]
    times = {True: [], False: []}
    for on in SDEF_ORDER:
        s = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            s = steps[on](s)[0]
        torch.cuda.synchronize()
        times[on].append(1000.0 * (time.perf_counter() - t0) / n)
    on, off_ms = (float(np.median(times[k])) for k in (True, False))
    each = (f" in each of {state.time.numel()} instances" if state.time.dim()
            else "")
    log(f"sdef ({label}): the replayed step with sdef_true {on:.3f} "
        f"ms/frame, the median of segments "
        f"{', '.join(f'{t:.3f}' for t in times[True])}; off {off_ms:.3f} "
        f"({', '.join(f'{t:.3f}' for t in times[False])}): "
        f"{on - off_ms:+.3f} ms for "
        f"{scene.rig.n_sdef} SDEF vertices of {scene.rig.n_vertices}{each}; "
        f"the largest SDEF move {float(moved.max()):.4f} MMD units")


def launch_profile(label, frames, state, n: int):
    """`frames` (state -> state' after n frames) under torch.profiler ->
    state'; prints the host launch calls and device kernels a frame."""
    from torch.profiler import ProfilerActivity, profile

    from simple_mmd_renderer_tpu_torch.utils.profiling import launch_counts

    torch.cuda.synchronize()
    # the CUDA activity alone records the runtime's launch calls and the
    # device's kernels, without the operators' host events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state = frames(state)
        torch.cuda.synchronize()
    host, kernels, busy_us = launch_counts(prof.events())
    calls = ", ".join(f"{k} {v / n:g}" for k, v in host.items())
    log(f"launches ({label}): per frame over {n}, host launch calls "
        f"{sum(host.values()) / n:g} ({calls}), device kernels "
        f"{kernels / n:g}, device busy {busy_us / 1000 / n:.3f} ms")
    return state


def time_segment(paths, name, compiled: bool, note=""):
    """SEGMENT frames of flagship path `name` through the compiled
    `Scene.rollout`, or EAGER_SEGMENT eagerly (`Scene.step_and_render`),
    every launch counter reset just before and read just after: -> (ms/frame,
    counts). The frames must be finite and advance, and the path's kernels
    must each launch once a frame and every other kernel never."""
    path = paths[name]
    scene, state = path["scene"], path["state"]
    label = name + ("" if compiled else ", eager") + note
    frames = SEGMENT if compiled else EAGER_SEGMENT
    reset_counters()
    t0 = time.perf_counter()
    if compiled:
        state, sums = scene.rollout(state, frames)
    else:
        sums = []
        for _ in range(frames):
            state, image = scene.step_and_render(state)
            sums.append(image.mean())
        sums = torch.stack(sums)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters()
    merges = merge_launches(f"flagship ({label})", frames,
                            3 if scene.config.render.show_edges else 2)
    path["state"] = state
    if compiled:
        for k, n in counts.items():
            MAIN_LAUNCHES[k] += n
        add_merges(merges)

    sums = sums.cpu().numpy()
    ms = 1000.0 * dt / frames
    log(f"flagship ({label}): segment of {frames} frames, {ms:.3f} "
        f"ms/frame; launches {counts}; checksums "
        f"{sums.min():.5f}..{sums.max():.5f}")
    if not np.isfinite(sums).all():
        raise AssertionError("non-finite frames")
    if not (np.abs(np.diff(sums)) > 0).any():
        raise AssertionError("frames did not advance")
    mine = path_kernels(scene.config.render)
    for k, n in counts.items():
        want = frames * mine.get(k, 0)
        if n != want:
            raise AssertionError(f"{k} launched {n} times in {frames} "
                                 f"frames ({label}), expected {want}")
    return ms, counts


def run_flagships(paths):
    """Every path warmed up, then timed in turns (ORDER), so that drift
    over the call falls on all alike; then each path's next frame is
    checked for shape, finite values and character coverage."""
    for path in paths.values():
        path["state"], _ = path["scene"].rollout(path["state"], WARMUP)
    torch.cuda.synchronize()

    seg_ms = {key: [] for key in ORDER}
    launches = {name: dict.fromkeys(KERNELS, 0) for name in paths}
    for name, compiled in ORDER:
        ms, counts = time_segment(paths, name, compiled)
        seg_ms[name, compiled].append(ms)
        if compiled:            # the main path's launches
            for k, n in counts.items():
                launches[name][k] += n

    eager = seg_ms[M1, False]
    log(f"flagship ({M1}, eager): {EAGER_SEGMENT} frames: "
        f"{sum(eager) / len(eager):.3f} ms/frame")
    mean_ms = {name: sum(seg_ms[name, True]) / len(seg_ms[name, True])
               for name in paths}
    log(f"flagship ({FULL}): {mean_ms[FULL]:.3f} ms/frame; in the same "
        f"call {T4} {mean_ms[T4]:.3f} ({mean_ms[FULL] - mean_ms[T4]:+.3f}), "
        f"{M4} {mean_ms[M4]:.3f} ({mean_ms[FULL] - mean_ms[M4]:+.3f})")
    log(f"flagship ({CONTENT}): {mean_ms[CONTENT]:.3f} ms/frame; in the "
        f"same call {M4} {mean_ms[M4]:.3f} "
        f"({mean_ms[CONTENT] - mean_ms[M4]:+.3f})")
    for name, path in paths.items():
        scene = path["scene"]
        cfg = scene.config.render
        mine = path_kernels(cfg)
        ms = mean_ms[name]
        log(f"flagship ({name}, compiled): {FRAMES} frames at "
            f"{cfg.width}x{cfg.height}, shadow {SHADOW}: {ms:.3f} ms/frame, "
            f"{1000.0 / ms:.3f} fps (segments "
            f"{', '.join(f'{t:.3f}' for t in seg_ms[name, True])}); "
            f"launches {launches[name]}")

        # the next frame's image and character coverage (the share of the
        # frame where K2 found a triangle; at msaa=4 where K4 covered any
        # sample)
        _, image, seen = capture_frame(scene.step_and_render, path["state"],
                                       mine)
        h, w = cfg.height, cfg.width
        # (the character's raster is the frame's last raster call; the
        # edge hull's K2 runs before it)
        if cfg.msaa >= 4:
            sdepth = seen["K4"][-1][1][5][:, :h, :w]
            cover = float((sdepth < 1.0).any(0).float().mean())
        else:
            tri = seen["K2"][-1][1][1][:h, :w]
            cover = float((tri >= 0).float().mean())
        log(f"flagship ({name}): image {tuple(image.shape)}, finite "
            f"{bool(torch.isfinite(image).all())}, character covers "
            f"{100 * cover:.2f}% of the frame")
        if tuple(image.shape) != (h, w, 3) or \
                not bool(torch.isfinite(image).all()):
            raise AssertionError("bad frame")
        if not 0.01 < cover < 0.6:
            raise AssertionError(f"implausible character coverage "
                                 f"{cover:.4f}")


def pass_bytes(label, name, scene) -> int:
    """The bytes a render pass must move a frame, each input read once and
    each output written once (its byte bound's numerator):

    - albedo: every pixel's triangle id (4 B) and barycentrics (8 B) read,
      its 48-byte row and 16-byte texel gathered, its albedo (12 B)
      written; on the resident path each part's slot copied (read and
      written);
    - skybox: a 12-byte cubemap texel gathered and 12 B written a pixel;
    - edges: the vertices' positions, normals (12 B each) and edge
      magnitudes (4 B) read, the hull's triangles (3 int32) and parts
      (4 B) read, a mask byte and a 12-byte colour written a pixel;
    - mmd: every pixel's triangle id (4 B), normal and albedo (12 B each)
      read, a toon-ramp row (12 B) and a sphere texel (16 B: its packed
      2x2 neighbourhood) gathered, the albedo and the SPA addend (12 B
      each) written."""
    from simple_mmd_renderer_tpu_torch.render import pipeline

    cfg = scene.config.render
    px = cfg.width * cfg.height
    if label == "albedo":
        n_bytes = px * (4 + 8 + 48 + 16 + 12)
        if name == T16:
            atlas = scene.packed_atlas()
            slot = pipeline.resident_slot_size(atlas.sizes.shape[0])
            n_bytes += 2 * atlas.sizes.shape[0] * slot * slot * 16
        return n_bytes
    if label == "skybox":
        return px * (12 + 12)
    if label == "edges":
        return (scene.rig.n_vertices * (12 + 12 + 4)
                + scene.rig.n_edge_tris * (12 + 4) + px * (1 + 12))
    if label == "mmd":
        return px * (4 + 12 + 12 + 12 + 16 + 12 + 12)
    if label == "morphs":
        rig = scene.rig
        # the UV offsets: each entry's vertex, rate and offset read, the
        # offsets written and added to the UVs (both read, the sum
        # written); the part colour: each pixel's triangle id and albedo
        # read, its part's mul and add gathered, the albedo written
        return (rig.um_morph.shape[0] * (8 + 4 + 8)
                + rig.n_vertices * (8 + 8 + 8 + 8)
                + px * (4 + 12 + 12 + 12 + 12))
    raise ValueError(label)


# the profiled passes of each path
PROFILED = ((T1, ("albedo",)), (T4, ("albedo",)), (T16, ("albedo",)),
            (FULL, ("albedo", "skybox", "edges", "mmd")),
            (CONTENT, ("morphs", "albedo")))


def pass_profile(paths, n=3):
    """The `pass_scope` passes of PROFILED over the renders of n compiled
    frames of each path under torch.profiler (CPU and CUDA activities; the
    n steps replayed before the window, their outputs copied): each pass's
    host ms and the device ms of the operators' kernels launched inside
    it, a frame, beside its byte bound (`pass_bytes`), and its operators
    by device time. The hand kernels (K2 of the edge hull) launch outside
    PyTorch's operators and are not in a pass's device time."""
    from torch.profiler import ProfilerActivity, profile

    for name, labels in PROFILED:
        path = paths[name]
        scene = path["scene"]
        step = scene.jit_step(render=False, donate=False)
        frames, state = [], path["state"]
        for _ in range(n):
            frames.append(step(state))
            state = frames[-1][0]
        path["state"] = state
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for state, pose, positions, normals in frames:
                scene._render(state.time, pose, positions, normals, None,
                              None)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        events = prof.events()
        for label in labels:
            rows = [e for e in averages if e.key == label]
            if not rows:
                raise AssertionError(f"no {label} pass in the profile of "
                                     f"{name}")
            e = max(rows, key=lambda r: r.cpu_time_total)
            ops = pass_ops(events, label)
            n_bytes = pass_bytes(label, name, scene)
            bnd = bound(n_bytes, 0)
            extra = ""
            if label == "albedo":
                atlas = scene.packed_atlas()
                extra = (f"atlas {tuple(atlas.data.shape)} "
                         f"{atlas.data.dtype}, "
                         f"{atlas.data.numel() * 4 / 1e6:.1f} MB; ")
            log(f"{label} ({name}): host {e.cpu_time_total / 1000 / n:.3f} "
                f"ms/frame, device {e.device_time_total / 1000 / n:.4f} "
                f"ms/frame over {n} compiled frames; bound {bnd[0]:.4f} ms "
                f"({n_bytes / 1e6:.1f} MB a frame); {extra}"
                f"{sum(k for k, _ in ops.values()) / n:g} ops with device "
                f"time a frame, by device time: " + ", ".join(
                    f"{op} {us / 1000 / n:.3f} ms ({k / n:g})"
                    for op, (k, us) in sorted(ops.items(),
                                              key=lambda kv: -kv[1][1])[:8]))


def pass_ops(events, label) -> dict:
    """{op name: (calls, device us)} of the operators inside the profile's
    `label` ranges that ran device work of their own."""
    from torch.autograd import DeviceType

    def inside(e):
        p = e.cpu_parent
        while p is not None:
            if p.name == label:
                return True
            p = p.cpu_parent
        return False

    ops = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        us = e.self_device_time_total
        if us and inside(e):
            k, t = ops.get(e.name, (0, 0.0))
            ops[e.name] = (k + 1, t + us)
    return ops


def with_render(scene, **render):
    """A shallow copy of `scene` (same device tables) whose render config
    differs in `render`."""
    other = copy.copy(scene)
    other.config = copy.copy(scene.config)
    other.config.render = dataclasses.replace(scene.config.render, **render)
    return other


def with_textures(scene, sizes, **render):
    """`with_render`'s copy of `scene` (the same step graph) that samples
    the procedural textures of edges `sizes` (one per material part)."""
    other = with_render(scene, **render)
    other.part_textures = sample_textures(sizes)
    return other


def windings(rows, starts, counts) -> tuple[int, int, int]:
    """(entries of negative and of positive signed area, tiles holding
    both) of a raster's bins. A setup row's barycentric slopes give the
    sign: w1x * w2y - w1y * w2x = 1 / area2 (screen y down: the
    back-culled character keeps area2 < 0, the front-culled edge hull
    area2 > 0, a double-sided part both)."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    idx, tile = tr._tile_entries(starts, counts)
    r = rows[idx]
    pos = (r[:, 2] * r[:, 5] - r[:, 3] * r[:, 4]) > 0
    n = counts.shape[0]
    n_pos = torch.bincount(tile[pos], minlength=n)
    n_neg = torch.bincount(tile[~pos], minlength=n)
    return (int((~pos).sum()), int(pos.sum()),
            int(((n_pos > 0) & (n_neg > 0)).sum()))


def _kernel_table():
    """{kernel: (wrapper, plain version, arguments the plain version
    takes, index of the attribute planes in the result or None)}."""
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    return {
        "K1": (tr.depth_tiles, tr.depth_tiles_plain, 5, None),
        "K2": (tr.raster_tiles, tr.raster_tiles_plain, 6, 4),
        "K3": (shadow_pcf.pcf_lit_map, shadow_pcf.pcf_lit_map_plain, 4,
               None),
        "K4": (tr.raster_tiles_ms, tr.raster_tiles_ms_plain, 6, 4),
        "K6": (tr.depth_tiles_win, tr.depth_tiles_win_plain, 7, None),
        "K5a": (tr.raster_tiles_multi, tr.raster_tiles_multi_plain, 7, 4),
        "K5b": (tr.raster_tiles_ms_multi, tr.raster_tiles_ms_multi_plain, 7,
                4),
        "K5c": (tr.depth_tiles_multi, tr.depth_tiles_multi_plain, 6, None),
    }


def check_calls(label, step, state, expect, nocull=False, attrs=None):
    """Every call of every kernel in frame 1 of `step` from `state` (whose
    kernels are `expect`, {kernel: calls}) against its plain version on
    the call's own arguments: every plane bit-exact and equal to what the
    frame computed, the attributes within 1e-6; each call's time as the
    record takes it (`back_to_back_runs`: the wrapper's own launches on the
    call's arguments) beside its bound (`kernel_bound`). For the raster
    kernels the
    bins' windings are printed: the edge hull's rasters (K2 at A = 0, K5a
    at A = 1) must hold front faces only (culled the other way), and with
    `nocull` the character's raster (K4 or K5b here) must hold both
    windings in some tile. `attrs` ({kernel: A}) names the attribute count
    a kernel's last call (the character's raster) must have."""
    table = _kernel_table()
    _, _, seen = capture_frame(step, state, expect)
    failed = []
    for key, calls in seen.items():
        fn, plain, n_args, attr_at = table[key]
        for i, (args, out) in enumerate(calls):
            got = fn(*args)
            want = plain(*args[:n_args])
            got, want, out = ((x,) if isinstance(x, torch.Tensor) else x
                              for x in (got, want, out))
            bad = [mismatches(a, b, c) for j, (a, b, c)
                   in enumerate(zip(got, want, out)) if j != attr_at]
            attr_err = (0.0 if attr_at is None else
                        float((got[attr_at] - want[attr_at]).abs().max()))
            runs = back_to_back_runs(lambda: fn(*args))
            bnd = kernel_bound(key, args, got[0] if len(got) == 1 else got)
            line = (f"kernels: {key} ({label}, call {i + 1} of "
                    f"{len(calls)}) {tuple(got[0].shape)}: mismatches "
                    f"{bad}, back to back {back_to_back(None, runs)}, bound "
                    f"{bnd[0]:.5f} ms ({bnd[1]}), card / bound "
                    f"{runs[0] / bnd[0]:.2f}")
            if attr_at is not None:
                n_attrs = args[n_args - 1]
                neg, pos, mixed = windings(*args[:3])
                line += (f", {n_attrs} attributes (max err {attr_err:.3g}); "
                         f"{int(args[2].sum())} entries: {neg} of negative "
                         f"area, {pos} of positive, {mixed} tiles hold "
                         f"both")
                hull = n_attrs == (1 if key == "K5a" else 0)
                if hull and neg:
                    failed.append(f"{key} call {i + 1}: the edge hull "
                                  "holds back faces")
                if nocull and key in ("K4", "K5b") and not mixed:
                    failed.append(f"{key}: no tile holds both windings")
            log(line)
            if any(bad) or attr_err > 1e-6:
                failed.append(f"{key} call {i + 1} disagrees with its plain "
                              "version")
    for key, n_attrs in (attrs or {}).items():
        args = seen[key][-1][0]
        if args[table[key][2] - 1] != n_attrs:
            failed.append(f"{key} ran with {args[table[key][2] - 1]} "
                          f"attributes, expected {n_attrs}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))


def build_crowd(density, label, textures=None, msaas=(False, True),
                content=False, **look):
    """(scene, {msaa?: (step function, crowd state)}) of CROWD_N instances
    of the sample character at `density` (with `content`, the content rig
    on its motion, `build_content`), with the procedural textures of
    edges `textures` if given and build_sample_scene's `look` options
    (the skybox, edges, double-sided parts, MMD maps): one scene's tables
    (and compiled step), a render config for each of `msaas`."""
    t0 = time.perf_counter()
    build = (functools.partial(build_content, None) if content
             else build_sample_scene)
    scene = build(density, CROWD_W, CROWD_H, CROWD_SHADOW,
                  n_frames=CROWD_MOTION, fps_keys=5, device="cuda",
                  textures=textures, **look)
    crowd = {msaa: (crowd_step_fn(with_render(scene, msaa=4 if msaa else 1)),
                    crowd_init(scene, CROWD_N)) for msaa in msaas}
    state = next(iter(crowd.values()))[1]
    rig = scene.rig
    log(f"scene ({label}): {CROWD_N} instances of {rig.n_vertices} verts, "
        f"{rig.triangles.shape[0]} tris ({CROWD_N * rig.triangles.shape[0]} "
        f"per frame), {rig.n_bones} bones, {scene.phys.n_bodies} bodies, "
        f"{scene.phys.n_joints} joints; textures {textures}; clocks "
        f"{float(state.time[1] * scene.config.fps):.1f} frames apart; "
        f"{look_label(scene)}"
        f"{f'{rig.n_sdef} SDEF vertices; ' if rig.n_sdef else ''}built in "
        f"{time.perf_counter() - t0:.2f} s")
    return scene, crowd


def instance_bins(starts, counts, i, n_tiles):
    """Instance i's own (starts, counts) cut out of a crowd's global
    ones."""
    sl = slice(i * n_tiles, (i + 1) * n_tiles)
    return (torch.cat([starts[sl], starts[sl][-1:] + counts[sl][-1:]]),
            counts[sl].contiguous())


def check_pcf_per_map(args, shared_bound) -> int:
    """K3 on the crowd's maps with a plane each (per-map planes, the
    counterpart of the reference's vmap over batched planes: z0 spread
    over +-0.125 around the frame's own plane, the slopes scaled by up to
    +-32 %, and the last map's z0 above every depth, so that it is unlit),
    held bit-exact against the plain version and each map against its own
    launch with its plane as scalars, timed back to back in turns with the
    frame's shared plane. -> mismatches."""
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf

    maps, z0, zc, zr = args
    n = maps.shape[0]
    k = torch.arange(n, dtype=torch.float32, device=maps.device)
    shift = torch.where(k == n - 1, 2.0 - z0, (k - n / 2) * (0.25 / n))
    planes = (z0 + shift, zc * (1.0 + (k - n / 2) * (0.64 / n)),
              zr * (1.0 - (k - n / 2) * (0.64 / n)))
    lit = shadow_pcf.pcf_lit_map(maps, *planes)
    bad = mismatches(lit, shadow_pcf.pcf_lit_map_plain(maps, *planes))
    alone = sum(mismatches(lit[i], shadow_pcf.pcf_lit_map(
        maps[i], *(float(p[i]) for p in planes))) for i in (0, n // 2, n - 1))
    shared = shadow_pcf.pcf_lit_map(*args)
    differ = int((lit != shared).sum())
    per_map_bound = pcf_bound(args, lit, n)
    runs = {"shared": [], "per-map": []}
    for name in ("shared", "per-map", "per-map", "shared"):
        call = ((lambda: shadow_pcf.pcf_lit_map(*args)) if name == "shared"
                else (lambda: shadow_pcf.pcf_lit_map(maps, *planes)))
        runs[name] += back_to_back_runs(call)
    shared_runs, per_map_runs = sorted(runs["shared"]), sorted(
        runs["per-map"])
    log(f"kernels: K3 pcf_lit_map on the crowd's maps {tuple(lit.shape)} "
        f"with {n} per-map planes: mismatches {bad}, maps 0, {n // 2}, "
        f"{n - 1} against their own launches {alone}, {differ} texels "
        f"differ from the shared plane's; back to back in turns (12 means "
        f"of 20 launches each): shared least {shared_runs[0]:.4f}, median "
        f"{shared_runs[6]:.4f} ms (bound {shared_bound[0]:.5f}), per-map "
        f"least {per_map_runs[0]:.4f}, median {per_map_runs[6]:.4f} ms "
        f"(bound {per_map_bound[0]:.5f})")
    if not differ:
        raise AssertionError("K3's per-map planes changed no texel")
    return bad + alone


def check_depth_nocull(scene, state):
    """K1 through `rasterize_depth_tiled(..., nocull=)` on the flagship's
    2048^2 shadow map: the casters of a frame of the full look (whose
    shadow pass is K6's), with its double-sided mask, culled as the shadow
    pass culls. K1's call held bit-exact against its plain version; its
    entries against those of the same raster without the mask."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
    from simple_mmd_renderer_tpu_torch.render import pipeline, raster

    seen = {}
    real_pass, real_k1 = pipeline.shadow_pass, tr.depth_tiles

    def spy_pass(*args, **kw):
        seen.setdefault("pass", args[:4])
        return real_pass(*args, **kw)

    def spy_k1(*args, **kw):
        seen.setdefault("K1", []).append(args)
        return real_k1(*args, **kw)

    try:
        pipeline.shadow_pass = spy_pass
        scene.step_and_render(state)
    finally:
        pipeline.shadow_pass = real_pass
    verts_m, tris, light_mvp, size = seen["pass"]
    mask = scene.rig.nocull_tris
    clip = raster.transform_clip(verts_m, light_mvp)
    e_max = pipeline._tiled_e_max(size, size)
    try:
        tr.depth_tiles = spy_k1
        maps = [tr.rasterize_depth_tiled(clip, tris, size, size,
                                         raster.CULL_FRONT, e_max=e_max,
                                         nocull=nc) for nc in (mask, None)]
    finally:
        tr.depth_tiles = real_k1
    args = seen["K1"][0]           # with the mask; [1] without it
    entries = [int(a[2].sum()) for a in seen["K1"]]
    got = tr.depth_tiles(*args)
    want = tr.depth_tiles_plain(*args[:5])
    bad = mismatches(got, want)
    runs = back_to_back_runs(lambda: tr.depth_tiles(*args))
    bnd = kernel_bound("K1", args, got)
    differ = int((maps[0] != maps[1]).sum())
    log(f"kernels: K1 depth_tiles with nocull ({int(mask.sum())} double-"
        f"sided of {mask.shape[0]} triangles, {FULL}, {size}^2): "
        f"mismatches {bad}, {entries[0]} entries with the mask, "
        f"{entries[1]} without, {differ} texels differ; back to back "
        f"{back_to_back(None, runs)}, bound {bnd[0]:.5f} ms ({bnd[1]}), "
        f"card / bound {runs[0] / bnd[0]:.2f}")
    if bad or entries[0] <= entries[1] or not differ:
        raise AssertionError("K1 with nocull disagrees with its plain "
                             "version or the mask changed nothing")


def check_kernels_crowd(crowd, results):
    """K5c, K5a and K5b on the arguments of frame 1 of the dense crowd (K5a
    from the msaa=1 step, K5b from the msaa=4 step), K3 on its batch of
    shadow maps, and the fold of one instance onto K1, K2 and K4."""
    from simple_mmd_renderer_tpu_torch.ops import shadow_pcf
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    seen = {}
    for msaa in (False, True):
        step, state = crowd[msaa]
        _, _, got = capture_frame(step, state, crowd_kernels(msaa))
        seen.update({k: v for k, v in got.items() if k not in seen})
    (c_args, c_out), = seen["K5c"]
    (a_args, a_out), = seen["K5a"]
    (b_args, b_out), = seen["K5b"]
    (k3_args, k3_out), = seen["K3"]
    n_inst, w, h = a_args[3:6]
    n_tiles = tr._grid(w, h)[2]
    s_tiles = tr._grid(*c_args[4:6])[2]
    cc, ca, cb = c_args[2], a_args[2], b_args[2]
    log(f"kernels: crowd frame-1 bins ({n_inst} instances): shadow "
        f"{int(cc.sum())} entries in {cc.shape[0]} tiles (max "
        f"{int(cc.max())}), character {int(ca.sum())} entries in "
        f"{ca.shape[0]} tiles (max {int(ca.max())}) at msaa=1, "
        f"{int(cb.sum())} (max {int(cb.max())}) at msaa=4")
    mid = n_inst // 2       # the instance whose fold is checked

    # K5c on all instances' shadow bins, with the frame's boxes; the plain
    # version is brute force
    if len(c_args) != 7 or c_args[6] is None:
        raise AssertionError("the crowd frame passed K5c no pixel boxes")
    c_boxes = c_args[6]
    got = tr.depth_tiles_multi(*c_args)
    want = tr.depth_tiles_multi_plain(*c_args[:6])
    c_bad = mismatches(got, want, c_out)
    c_err = float((got - want).abs().max())
    # one instance's map against K1 on its own bins with the same boxes
    c_fold = mismatches(got[mid], tr.depth_tiles(
        c_args[0], *instance_bins(c_args[1], cc, mid, s_tiles), *c_args[4:6],
        c_boxes))
    c_runs = back_to_back_runs(lambda: tr.depth_tiles_multi(*c_args))
    c_plain = primed_ms(lambda: tr.depth_tiles_multi_plain(*c_args[:6]), 3)
    log(f"kernels: K5c depth_tiles_multi {tuple(got.shape)}: mismatches "
        f"{c_bad}, instance {mid} vs K1 on its own bins with the same boxes "
        f"{c_fold}, back to back {back_to_back(None, c_runs)} vs plain "
        f"{c_plain:.4f} ms")
    c_bins = c_args[:3] + c_args[4:6]
    c_bound = depth_bound("K5c", c_bins, tr.TILE_H, c_boxes, 4 * got.numel(),
                          c_runs[0])

    # K5c on a dense crowd of two instances, each the dense tile's bins,
    # with boxes (small ones, a thread each) and without (every entry wide,
    # over its whole tile)
    rd, sd, cd, bd = dense_bins(cc.device)
    n = int(sd[-1])
    rd2, bd2 = torch.cat([rd[:n], rd[:n]]), torch.cat([bd[:n], bd[:n]])
    sd2, cd2 = torch.cat([sd[:-1], sd + n]), torch.cat([cd, cd])
    want = tr.depth_tiles_multi_plain(rd2, sd2, cd2, 2, 128, 64)
    c_dense = [mismatches(tr.depth_tiles_multi(rd2, sd2, cd2, 2, 128, 64,
                                               bx), want)
               for bx in (bd2, None)]
    log(f"kernels: dense tile ({int(cd.max())} entries in one tile, two "
        f"instances): K5c with and without boxes, mismatches {c_dense}")

    # K3 on the crowd's batch of shadow maps
    lit = shadow_pcf.pcf_lit_map(*k3_args)
    lit_plain = shadow_pcf.pcf_lit_map_plain(*k3_args)
    k3_bad = mismatches(lit, lit_plain, k3_out)
    k3_plain = primed_ms(lambda: shadow_pcf.pcf_lit_map_plain(*k3_args), 5)
    k3_bound = pcf_bound(k3_args, lit)
    log(f"kernels: K3 pcf_lit_map on the crowd's maps {tuple(lit.shape)}: "
        f"mismatches {k3_bad}, plain {k3_plain:.4f} ms")
    log(pcf_line(f"K3 pcf_lit_map on the crowd's maps {tuple(lit.shape)}",
                 back_to_back_runs(
                     lambda: shadow_pcf.pcf_lit_map(*k3_args)), k3_bound))
    k3_bad += check_pcf_per_map(k3_args, k3_bound)

    # K5a and K5b on all instances' character bins (A = 3: normals)
    for key, args in (("K5a", a_args), ("K5b", b_args)):
        if len(args) != 8 or args[7] is None:
            raise AssertionError(f"the crowd frame passed {key} no pixel "
                                 "boxes")
    rec = {}
    for key, args, out, fn, plain, single in (
            ("K5a", a_args, a_out, tr.raster_tiles_multi,
             tr.raster_tiles_multi_plain, tr.raster_tiles),
            ("K5b", b_args, b_out, tr.raster_tiles_ms_multi,
             tr.raster_tiles_ms_multi_plain, tr.raster_tiles_ms)):
        k = fn(*args)
        kp = plain(*args[:7])               # brute force, without the boxes
        exact = [i for i in range(len(k)) if i != 4]    # all but attr
        bad = [mismatches(k[i], kp[i], out[i]) for i in exact]
        attr_err = float((k[4] - kp[4]).abs().max())
        err = max(attr_err, max(float((k[i].float() - kp[i].float())
                                      .abs().max()) for i in exact))
        one = single(args[0], *instance_bins(args[1], args[2], mid, n_tiles),
                     *args[4:])
        fold = sum(mismatches(a[mid], b) for a, b in zip(k, one))
        runs = back_to_back_runs(lambda: fn(*args))
        plain_t = primed_ms(lambda: plain(*args[:7]), 3)
        log(f"kernels: {key} {fn.__name__} {tuple(k[0].shape)}, {args[6]} "
            f"attributes: depth/tri/b1/b2{'/sdepth' if len(k) > 5 else ''} "
            f"mismatches {bad}, attr max err {attr_err:.3g}, instance {mid} "
            f"vs {single.__name__} on its own bins (with the same boxes) "
            f"{fold}, back to back {back_to_back(None, runs)} vs plain "
            f"{plain_t:.4f} ms")
        bnd = boxed_bound(key, args[:3] + args[4:7], args[7], k, runs[0])
        rec[key] = (bad, attr_err, fold, err, runs, plain_t, bnd)

    if c_bad or c_fold or any(c_dense) or k3_bad or any(
            any(r[0]) or r[2] for r in rec.values()):
        raise AssertionError("a crowd kernel disagrees with its plain "
                             "version or with the single-instance kernel")
    if not all(r[1] <= 1e-6 for r in rec.values()):
        raise AssertionError("crowd attributes beyond 1e-6 of the plain "
                             "version")
    record(results, "K5a", "K5a raster_tiles_multi (crowd visibility + "
           "attributes)", "tiled_raster.cu", "ops/tiled_raster.py:1772",
           *rec["K5a"][3:])
    record(results, "K5b", "K5b raster_tiles_ms_multi (crowd 4x MSAA "
           "visibility + attributes + per-sample depth)", "tiled_raster.cu",
           "ops/tiled_raster.py:1952", *rec["K5b"][3:])
    record(results, "K5c", "K5c depth_tiles_multi (crowd shadow depth)",
           "tiled_raster.cu", "ops/tiled_raster.py:2072", c_err, c_runs,
           c_plain, c_bound)


def crowd_frames(step, state, n: int):
    """n crowd frames of `step` (a `crowd_step_fn`) -> state'."""
    for _ in range(n):
        state, _ = step(state)
    return state


def time_crowd_segment(step, state, msaa: bool, label: str,
                       edges: bool = False):
    """CROWD_SEGMENT crowd frames, every launch counter reset just before
    and read just after: -> (state', ms per crowd frame, counts, last
    images)."""
    reset_counters()
    sums = []
    t0 = time.perf_counter()
    for _ in range(CROWD_SEGMENT):
        state, images = step(state)
        sums.append(images.mean())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters()
    for k, n in counts.items():
        MAIN_LAUNCHES[k] += n
    add_merges(merge_launches(f"crowd ({label}, {CROWD_LABEL[msaa]})",
                              CROWD_SEGMENT, 3 if edges else 2))
    sums = torch.stack(sums).cpu().numpy()
    ms = 1000.0 * dt / CROWD_SEGMENT
    log(f"crowd ({label}, {CROWD_LABEL[msaa]}): segment of {CROWD_SEGMENT} "
        f"frames, {ms:.3f} ms per crowd frame; launches {counts}; checksums "
        f"{sums.min():.5f}..{sums.max():.5f}")
    if not np.isfinite(sums).all():
        raise AssertionError("non-finite crowd frames")
    if not (np.abs(np.diff(sums)) > 0).any():
        raise AssertionError("crowd frames did not advance")
    mine = crowd_kernels(msaa, edges)
    for k, n in counts.items():
        want = CROWD_SEGMENT * mine.get(k, 0)
        if n != want:
            raise AssertionError(f"{k} launched {n} times in "
                                 f"{CROWD_SEGMENT} crowd frames ({label}, "
                                 f"{CROWD_LABEL[msaa]}), expected {want}")
    return state, ms, counts, images


def run_crowd(paths, order):
    """Crowd paths {key: (label, step function, state, msaa?, edges?)}
    warmed up, then timed in turns (`order`: keys, CROWD_SEGMENT frames a
    segment), so that drift over the call falls on all alike; each path's
    last frames checked for shape, finite values and instances that
    differ. `edges`: the scene draws the edge outlines (one more K5a a
    frame). -> {key: ms per crowd frame}."""
    states = {}
    for key, (_, step, state, _, _) in paths.items():
        for _ in range(WARMUP):
            state, _ = step(state)
        states[key] = state
    torch.cuda.synchronize()

    seg_ms = {key: [] for key in paths}
    launches = {key: dict.fromkeys(KERNELS, 0) for key in paths}
    images = {}
    for key in order:
        label, step, _, msaa, edges = paths[key]
        states[key], ms, counts, images[key] = time_crowd_segment(
            step, states[key], msaa, label, edges)
        seg_ms[key].append(ms)
        for k, n in counts.items():
            launches[key][k] += n

    mean_ms = {}
    for key, (label, _, _, msaa, _) in paths.items():
        ms = mean_ms[key] = sum(seg_ms[key]) / len(seg_ms[key])
        img = images[key]
        apart = float((img[0] - img[1]).abs().max())
        log(f"crowd ({label}, {CROWD_LABEL[msaa]}): "
            f"{CROWD_SEGMENT * len(seg_ms[key])} frames of {CROWD_N} "
            f"instances at {CROWD_W}x{CROWD_H}, shadow {CROWD_SHADOW}: "
            f"{ms:.3f} ms per crowd frame, {1000.0 * CROWD_N / ms:.3f} "
            f"instance-frames/s (segments "
            f"{', '.join(f'{t:.3f}' for t in seg_ms[key])}); launches "
            f"{launches[key]}; images {tuple(img.shape)}, finite "
            f"{bool(torch.isfinite(img).all())}, instance 0 vs 1 max "
            f"difference {apart:.3f}")
        if tuple(img.shape) != (CROWD_N, CROWD_H, CROWD_W, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError("bad crowd frames")
        if not apart > 0.05:
            raise AssertionError("instances 0 and 1 render the same frame")
    return mean_ms


def check_parity_crowd(msaa: bool, textures=None, label="", **look):
    """A crowd of 4 (density 0.25; with the procedural textures of edges
    `textures` if given, and build_sample_scene's `look` options, named by
    `label`) on the card vs the same crowd on the CPU, frame 2."""
    imgs = []
    for dev in ("cuda", "cpu"):
        scene = build_sample_scene(0.25, CROWD_W, CROWD_H, CROWD_SHADOW, dev,
                                   n_frames=60, fps_keys=10,
                                   solver_iterations=4,
                                   msaa=4 if msaa else 1, textures=textures,
                                   **look)
        step, state = crowd_step_fn(scene), crowd_init(scene, 4)
        reset_counters()
        for _ in range(2):
            state, images = step(state)
        imgs.append(images.cpu().numpy())
        counts = read_counters()
        mine = crowd_kernels(msaa, scene.config.render.show_edges)
        if any(counts[k] != (2 * n if dev == "cuda" else 0)
               for k, n in mine.items()):
            raise AssertionError(f"crowd parity on {dev}: launches {counts}")
    d = np.abs(imgs[0] - imgs[1])
    frac = max(float((d[i] > 0.02).mean()) for i in range(4))
    mad = max(float(d[i].mean()) for i in range(4))
    log(f"parity (crowd of 4, {CROWD_LABEL[msaa]}"
        f"{f', textures {textures}' if textures else ''}{label}): "
        f"{CROWD_W}x{CROWD_H} frame 2, shadow {CROWD_SHADOW}, card vs CPU, "
        f"worst instance: |d|>0.02 fraction {frac:.3g}, mean abs diff "
        f"{mad:.3g}")
    if not (frac < 2e-3 and mad < 1 / 255):
        raise AssertionError("card and CPU crowd frames disagree")


def check_parity(msaa: bool, size=(256, 192), label="", shadow=None,
                 **scene_kw):
    """Small scene on the card vs the same scene on the CPU. At msaa=4 the
    shadow map is 1024^2 (the least size the window applies to) unless
    `shadow` is given, with the window only from 1024^2 on. `scene_kw`
    passes build_sample_scene's texture and look settings (named in the
    line by `label`, or printed)."""
    if shadow is None:
        shadow = 1024 if msaa else 256
    extra = dict(msaa=4, shadow_window=shadow >= 1024) if msaa else {}
    imgs = []
    for dev in ("cuda", "cpu"):
        scene = build_sample_scene(0.5, *size, shadow, dev, n_frames=90,
                                   fps_keys=10, solver_iterations=4, **extra,
                                   **scene_kw)
        state = scene.init_state()
        reset_counters()
        for _ in range(2):
            state, image = scene.step_and_render(state)
        imgs.append(image.cpu().numpy())
        counts = read_counters()
        if any(counts[k] != (2 * n if dev == "cuda" else 0)
               for k, n in path_kernels(scene.config.render).items()):
            raise AssertionError(f"parity on {dev}: launches {counts}")
    d = np.abs(imgs[0] - imgs[1])
    frac, mad = float((d > 0.02).mean()), float(d.mean())
    window = ", shadow window" if extra.get("shadow_window") else ""
    log(f"parity ({'msaa=4' + window if msaa else 'msaa=1'}"
        f"{label or (f', {scene_kw}' if scene_kw else '')}): "
        f"{size[0]}x{size[1]} frame 2, shadow {shadow}, card vs CPU: "
        f"|d|>0.02 fraction {frac:.3g}, mean abs diff {mad:.3g}")
    if not (frac < 2e-3 and mad < 1 / 255):
        raise AssertionError("card and CPU frames disagree")


def look_label(scene) -> str:
    """', '-separated names of the look options a scene draws ('' for
    none), ending in '; ' when there are any."""
    cfg = scene.config.render
    on = [name for name, used in (
        ("skybox", cfg.show_skybox and scene.cubemap is not None),
        ("edges", cfg.show_edges), ("double-sided", cfg.double_sided),
        ("MMD maps", scene.mmd_maps is not None)) if used]
    return f"look {', '.join(on)}; " if on else ""


def full_look_inputs(cube_size=LOOK_CUBE, hdr_size=LOOK_HDR,
                     sphere=LOOK_SPHERE, device="cuda", quiet=False):
    """The full look's inputs: (cubemap [6,S,S,3] on `device` from a seeded
    equirect written with `write_hdr` (flat RGBE) into build/ and read back
    with `load_hdr`, the MMD maps: `default_toon_ramp(LOOK_RAMP)` per part,
    SPH on part 0, SPA on part 1, sphere^2 each). Prints the HDR's and the
    cubemap's seconds and the cubemap's MB unless `quiet`."""
    from simple_mmd_renderer_tpu_torch.formats.hdr import load_hdr, write_hdr
    from simple_mmd_renderer_tpu_torch.render.ibl import equirect_to_cubemap

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"smoke_env_{hdr_size[0]}x{hdr_size[1]}.hdr")
    t0 = time.perf_counter()
    write_hdr(path, sample_equirect(*hdr_size, seed=1))
    t1 = time.perf_counter()
    equirect = torch.as_tensor(load_hdr(path), device=device)
    t2 = time.perf_counter()
    cube = equirect_to_cubemap(equirect, cube_size)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if not quiet:
        # the build again, timed alone on the card (the first call also
        # pays the operators' first launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        again = equirect_to_cubemap(equirect, cube_size)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(again, cube):
            raise AssertionError("the cubemap build is not deterministic")
        log(f"look: equirect {hdr_size[0]}x{hdr_size[1]} written as .hdr in "
            f"{t1 - t0:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB), read "
            f"back in {t2 - t1:.2f} s; cubemap {tuple(cube.shape)} "
            f"({cube.numel() * 4 / 1e6:.1f} MB) built on the card in "
            f"{t3 - t2:.3f} s (first call), {start.elapsed_time(end):.3f} ms "
            f"(second, CUDA events)")
    return cube, sample_mmd_maps(2, sphere, LOOK_RAMP)


def look_kw(cube, mmd) -> dict:
    """build_sample_scene's options for the full look."""
    return dict(cubemap=cube, show_edges=True, double_sided_parts=(1,),
                mmd_maps=mmd)


def build_content(label, density, *args, n_frames=240, fps_keys=5,
                  device="cuda", **kw):
    """A scene of the content rig at `density` (`content_rig`, through the
    PMX bytes) on `content_motion(n_frames, fps_keys)` with `sdef_true` and
    the extended morphs on; `args` and `kw` as build_sample_scene takes
    them. Prints the rig's SDEF vertices and morph tables unless `label`
    is None."""
    t0 = time.perf_counter()
    pm, n_sdef = content_rig(density)
    t1 = time.perf_counter()
    scene = build_sample_scene(density, *args, device, pmx=pm,
                               vmd=content_motion(n_frames, fps_keys),
                               sdef_true=True, extended_morphs=True, **kw)
    rig = scene.rig
    if rig.n_sdef != n_sdef or not (rig.um_morph.shape[0]
                                    and rig.mm_morph.shape[0]):
        raise AssertionError("the content rig lost its SDEF vertices or its "
                             "morphs on the way through the PMX bytes")
    if label is not None:
        log(f"scene ({label}): {rig.n_vertices} verts, "
            f"{rig.triangles.shape[0]} tris, {n_sdef} SDEF vertices, "
            f"{rig.um_morph.shape[0]} UV-morph entries, "
            f"{rig.mm_morph.shape[0]} material-morph entries; the rig "
            f"written and read as PMX in {t1 - t0:.2f} s, the scene built in "
            f"{time.perf_counter() - t1:.2f} s")
    return scene


def build_paths() -> dict:
    """The flagship paths {name: {"scene", "state"}}: M1 and M4 built by
    build_sample_scene, T1 and T4 copies of M1's scene (the same step
    graph) with the 2-part textures, T16 built with the 16-part textures,
    its mips and resident mini-atlas; prints the 16-part path's host
    packing time, its atlas and its device memory."""
    paths = {}
    for name, extra in ((M1, {}), (M4, MSAA_PATH)):
        t0 = time.perf_counter()
        scene = build_sample_scene(DENSITY, WIDTH, HEIGHT, SHADOW, "cuda",
                                   **extra)
        paths[name] = {"scene": scene}
        rig = scene.rig
        log(f"scene ({name}): "
            f"{rig.positions.shape[0]} verts, {rig.triangles.shape[0]} "
            f"tris, {rig.n_bones} bones, {scene.phys.n_bodies} bodies, "
            f"{scene.phys.n_joints} joints; built in "
            f"{time.perf_counter() - t0:.2f} s")
    paths[T1] = {"scene": with_textures(paths[M1]["scene"], TEX2)}
    paths[T4] = {"scene": with_textures(paths[M1]["scene"], TEX2, msaa=4,
                                        width=1280, height=720)}
    for name in (T1, T4):
        t0 = time.perf_counter()
        atlas = paths[name]["scene"].packed_atlas()
        torch.cuda.synchronize()
        log(f"scene ({name}): textures {TEX2}, atlas "
            f"{tuple(atlas.data.shape)} {atlas.data.dtype} packed in "
            f"{time.perf_counter() - t0:.2f} s")

    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scene = build_sample_scene(DENSITY, WIDTH, HEIGHT, SHADOW, "cuda",
                               **TEX16)
    t1 = time.perf_counter()
    atlas = scene.packed_atlas()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mem1 = torch.cuda.memory_allocated()
    peaks, before = [], []
    state = scene.init_state()
    for _ in range(2):          # the first frame captures the step's graph
        before.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        state, _ = scene.rollout(state, 1)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    paths[T16] = {"scene": scene}
    log(f"scene ({T16}): textures {TEX16['textures']}, built in "
        f"{t1 - t0:.2f} s, atlas {tuple(atlas.data.shape)} "
        f"{atlas.data.dtype} ({atlas.n_mips} levels) packed in {t2 - t1:.2f} "
        f"s, {atlas.data.numel() * 4 / 1e6:.1f} MB; device memory allocated "
        f"{mem0 / 1e9:.3f} GB before the scene, {mem1 / 1e9:.3f} GB after it "
        f"and its atlas; peak {peaks[0] / 1e9:.3f} GB over its first frame "
        f"(the step's capture included), {peaks[1] / 1e9:.3f} GB over the "
        f"next, {(peaks[1] - mem1) / 1e9:.3f} GB above the scene's own, "
        f"{(peaks[1] - before[1]) / 1e9:.3f} GB above what was allocated "
        f"before that frame (the frame's temporaries; the step's graph "
        f"holds {(before[1] - mem1) / 1e9:.3f} GB)")
    t0 = time.perf_counter()
    scene = build_sample_scene(DENSITY, WIDTH, HEIGHT, SHADOW, "cuda",
                               textures=TEX2, **MSAA_PATH,
                               **look_kw(*full_look_inputs()))
    paths[FULL] = {"scene": scene}
    log(f"scene ({FULL}): textures {TEX2}, msaa=4 + shadow_window, "
        f"{look_label(scene)}{scene.rig.n_edge_tris} edge triangles, "
        f"{int(scene.rig.nocull_tris.sum())} double-sided; built in "
        f"{time.perf_counter() - t0:.2f} s")
    paths[CONTENT] = {"scene": build_content(
        CONTENT, DENSITY, WIDTH, HEIGHT, SHADOW, textures=TEX2,
        **MSAA_PATH)}
    for path in paths.values():
        path["state"] = path["scene"].init_state()
    return paths


VPD_POSE = """Vocaloid Pose Data file

sample_character.osm;
3;

Bone0{左腕
  0.000000,0.000000,0.000000;
  0.000000,0.000000,0.382683,0.923880;
}

Bone1{右ひじ
  0.000000,0.000000,0.000000;
  0.000000,-0.258819,0.000000,0.965926;
}

Bone2{センター
  0.000000,0.500000,0.000000;
  0.000000,0.000000,0.000000,1.000000;
}

Morph0{まばたき
  0.500000;
}
"""


def capture_scan(step, state):
    """One frame through `step`, recording every call of the scan raster
    (`ops.tiled_raster.scan_raster`: KS on the card) with its result ->
    (state', image, [((width, height, setup, vis), VisBuffer), ...])."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    calls = []
    fn = tr.scan_raster

    def spy(width, height, s, vis=None):
        out = fn(width, height, s, vis)
        calls.append(((width, height, s, vis), out))
        return out

    tr.scan_raster = spy
    try:
        state, image = step(state)
    finally:
        tr.scan_raster = fn
    return state, image, calls


def scan_bad(got, want) -> int:
    """Elements of two visibility buffers that differ."""
    return sum(int((a != b).sum()) for a, b in zip(
        (got.depth, got.tri, got.bary), (want.depth, want.tri, want.bary)))


def scan_bound(width, height, s):
    """KS's bound on a setup: the bytes of its setup table (16 f32 a
    triangle) and of the output planes (depth, triangle, two barycentrics:
    16 bytes a pixel), and OPS_SCAN operations for each valid triangle over
    the pixels of its exact box inside the frame (the box rule; a
    triangle whose box is the whole range counts the whole frame) ->
    (bound, evaluations)."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    box = tr._pixel_boxes(s, 0.0).long()
    c0 = torch.clamp(box[..., 0] + tr.BOX_MARGIN, min=0)
    r0 = torch.clamp(box[..., 1] + tr.BOX_MARGIN, min=0)
    c1 = torch.clamp(box[..., 2] - tr.BOX_MARGIN, max=width - 1)
    r1 = torch.clamp(box[..., 3] - tr.BOX_MARGIN, max=height - 1)
    pixels = (c1 - c0 + 1).clamp(min=0) * (r1 - r0 + 1).clamp(min=0)
    evals = int((pixels * s["valid"]).sum())
    n_inst = s["valid"][..., 0].numel()
    n_bytes = 4 * 16 * s["valid"].numel() + 16 * width * height * n_inst
    return bound(n_bytes, evals * OPS_SCAN), evals


def bins_bad(width, height, s, tile=None):
    """KSb against scan_bins_plain on a setup's table at `tile` (default:
    the launch's own, `scan_tile`) -> (mismatched words, table, KSb's
    bins)."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    n = s["xy"].shape[-3]
    table = tr._scan_table(s).reshape(-1, n, 16).contiguous()
    if tile is None:
        tile = tr.scan_tile(table.shape[0], n, width, height)
    bins = tr.scan_bins(table, width, height, tile)
    want = tr.scan_bins_plain(table, width, height, tile)
    return int((bins != want).sum()), table, bins


def scan_parts(label, args, out, bnd) -> dict:
    """KSb and KS alone on a 1080p scan call (`args`, whose result the
    frame gave as `out`), at every tile of SCAN_SWEEP: KSb's words against
    scan_bins_plain's and KS's planes over them against `out`, both bit
    for bit; each kernel back to back (`back_to_back_runs`, the record's
    timer), beside KSb's byte bound (the words written, the table's valid
    and box columns read) and KS's (`bnd`) -> the record's numbers at
    SCAN_TILE: {"KS": runs, "KSb": runs, "KSb plain": ms, "KSb err": max
    word difference, "KSb bound": bound}."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
    from simple_mmd_renderer_tpu_torch.render import raster

    width, height, s = args[:3]
    res = {}
    for tile in SCAN_SWEEP:
        n_bad, table, bins = bins_bad(width, height, s, tile)
        planes = tr._scan_start(args[3], (), width, height, table.device)
        tr.scan_walk(table, bins, tile, *planes)
        n_bad += scan_bad(raster.VisBuffer(*planes), out)

        def ksb(table=table, tile=tile):
            return tr.scan_bins(table, width, height, tile)

        def ks(table=table, bins=bins, tile=tile, planes=planes):
            tr.scan_walk(table, bins, tile, *planes)
        ksb_runs, ks_runs = back_to_back_runs(ksb), back_to_back_runs(ks)
        ksb_bnd = bound(4 * bins.numel() + 4 * 5 * table.shape[:2].numel(),
                        0)
        log(f"scan: sweep {label} tile {tile} ({bins.shape[1]} tiles, bins "
            f"{4 * bins.numel() / 1e6:.3f} MB): KSb back to back "
            f"{back_to_back(ksb, ksb_runs)} (bound {ksb_bnd[0]:.5f} ms, "
            f"{ksb_bnd[1]}), KS {back_to_back(ks, ks_runs)} (bound "
            f"{bnd[0]:.5f} ms), together least "
            f"{ksb_runs[0] + ks_runs[0]:.4f} ms; mismatches {n_bad}")
        if n_bad:
            raise AssertionError(f"scan: KSb or KS disagrees at tile {tile}")
        if tile == tr.SCAN_TILE:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = tr.scan_bins_plain(table, width, height, tile)
            end.record()
            torch.cuda.synchronize()
            res = {"KS": ks_runs, "KSb": ksb_runs,
                   "KSb plain": start.elapsed_time(end),
                   "KSb err": float((ksb().long() - want.long()).abs().max()),
                   "KSb bound": ksb_bnd}
            log(f"scan: {label} at tile {tile} (the record's), back to back: "
                f"card / bound KSb {ksb_runs[0] / ksb_bnd[0]:.2f}, KS "
                f"{ks_runs[0] / bnd[0]:.2f}; KSb's plain version once "
                f"{res['KSb plain']:.3f} ms")
    return res


def golden_frame(name, device):
    """tests/test_golden_frames.py's configuration `name` (the sample
    character at density 0.5, rest pose, 192x144, shadow 128^2, its
    camera, textures, MMD maps and equirect built as there) rendered by the
    port with the scan raster on `device`."""
    from simple_mmd_renderer_tpu_torch.config import RenderConfig
    from simple_mmd_renderer_tpu_torch.core.model import (ModelTables,
                                                          build_model)
    from simple_mmd_renderer_tpu_torch.app.sample import sample_character
    from simple_mmd_renderer_tpu_torch.render import ibl
    from simple_mmd_renderer_tpu_torch.render.pipeline import render_frame

    static = build_model(sample_character(density=0.5))
    cfg = dict(width=GOLDEN_SIZE[0], height=GOLDEN_SIZE[1],
               shadow_map_size=128, show_skybox=False, raster_mode="scan",
               camera_pos=np.array([0.0, 1.2, -2.6], np.float32),
               camera_target=np.array([0.0, 0.9, 0.0], np.float32))
    kw = {}
    if name in ("textured", "toon_sph"):
        kw["part_textures"] = sample_textures((128, 64))
    if name == "toon_sph":
        pn = len(static.part_base)
        ramps = np.ones((pn, 16, 3), np.float32)
        ramps[:] = np.linspace(1.0, 0.55, 16, dtype=np.float32)[None, :, None]
        ys = np.linspace(0.6, 1.0, 32, dtype=np.float32)
        sph = np.broadcast_to(ys[:, None, None], (32, 32, 3)).copy()
        modes = np.zeros(pn, np.int32)
        modes[0] = 1
        kw["mmd_maps"] = ([sph] * pn, modes, ramps)
    if name == "msaa4":
        cfg["msaa"] = 4
    if name == "edges":
        cfg["show_edges"] = True
    if name == "double_sided":
        cfg["double_sided"] = True
        static.nocull_tris[: len(static.nocull_tris) // 2] = True
    if name == "skybox":
        eq = np.zeros((16, 32, 3), np.float32)
        eq[:, :, 0] = np.linspace(0.1, 1.2, 32, dtype=np.float32)[None, :]
        eq[:, :, 1] = np.linspace(1.0, 0.1, 16, dtype=np.float32)[:, None]
        eq[:, :, 2] = 0.4
        cfg["show_skybox"] = True
        kw["cubemap"] = ibl.equirect_to_cubemap(torch.as_tensor(eq), 32,
                                                device=device)
    return render_frame(
        ModelTables(static, device),
        torch.as_tensor(np.asarray(static.positions, np.float32),
                        device=device),
        torch.as_tensor(np.asarray(static.normals, np.float32),
                        device=device), RenderConfig(**cfg), **kw)


def big_triangles(name, scene):
    """The big-triangle counts of flagship path `name` on frame 1
    (`binning_stats` of the shadow and character rasters at the path's
    e_max; the character's at the pixel centre, also under 4x MSAA): the
    triangles a tiled frame merges through KS."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr
    from simple_mmd_renderer_tpu_torch.render import pipeline, raster

    cfg = scene.config.render
    _, _, pos, _ = scene.jit_step(render=False, donate=False)(
        scene.init_state())
    verts = pos * cfg.mmd_to_meter
    tris = scene.rig.triangles.flip(-1)
    mats = pipeline.build_matrices(cfg, aspect=cfg.width / cfg.height,
                                   device=pos.device)
    size = cfg.shadow_map_size
    shadow = tr.binning_stats(raster.transform_clip(verts, mats["light_mvp"]),
                              tris, size, size, raster.CULL_FRONT,
                              pipeline._tiled_e_max(size, size))
    char = tr.binning_stats(raster.transform_clip(verts, mats["mvp"]), tris,
                            cfg.width, cfg.height, raster.CULL_BACK,
                            pipeline._tiled_e_max(cfg.width, cfg.height))
    log(f"scan: {name} frame 1 (binning_stats): big triangles shadow "
        f"{shadow['n_big']}, character {char['n_big']} (merged through KS "
        f"when above 0; fullest tile {shadow['max_tile_entries']} / "
        f"{char['max_tile_entries']} entries)")


def check_scan(paths, results):
    """The scan raster (`raster_mode="scan"`, KS): the small scan frame's
    frame-1 calls (shadow, edge hull, character), the character from the
    hull's buffer and two instances, against the plain version bit for
    bit; every flagship path's big-triangle counts; the golden
    configurations card against CPU; the 1080p scan frame: KS on its
    frame-1 calls timed (back to back, and host-paced: the wrapper's cost
    to the frame) beside its bound,
    the plain version once on the character (bits and time), SCAN_SEGMENT
    frames through the compiled rollout in turns with the tiled msaa=1
    flagship (counters reset before each scan segment and read after),
    and the scan frame against the tiled frame of the same state."""
    from simple_mmd_renderer_tpu_torch.ops import tiled_raster as tr

    t_phase = time.perf_counter()
    w, h, shadow = SCAN_SMALL
    small = with_render(build_sample_scene(0.5, w, h, shadow, "cuda",
                                           show_edges=True),
                        raster_mode="scan")
    _, _, calls = capture_scan(small.step_and_render, small.init_state())
    if [c[0][:2] for c in calls] != [(shadow, shadow), (w, h), (w, h)]:
        raise AssertionError(f"scan: frame-1 calls "
                             f"{[c[0][:2] for c in calls]}")
    bad = {}
    for label, (args, out) in zip(("shadow", "edge hull", "character"),
                                  calls):
        got = tr.scan_raster(*args)
        bad[label] = (scan_bad(got, tr.scan_raster_plain(*args))
                      + scan_bad(got, out))
    args = calls[2][0][:3] + (calls[1][1],)
    bad["character from the hull's buffer"] = scan_bad(
        tr.scan_raster(*args), tr.scan_raster_plain(*args))
    s = calls[2][0][2]
    shift = torch.tensor([3.5, -2.25], device=s["xy"].device)
    pair = {k: torch.stack([s[k], s[k] + shift if k == "xy" else s[k]])
            for k in ("xy", "z", "area2", "valid")}
    got = tr.scan_raster(w, h, pair)
    bad["two instances"] = scan_bad(got, tr.scan_raster_plain(w, h, pair))
    log(f"scan: KS on the {w}x{h} scan frame's frame-1 calls (shadow "
        f"{shadow}^2, {s['xy'].shape[0]} triangles, edge hull "
        f"{calls[1][0][2]['xy'].shape[0]}) against the plain version: "
        f"mismatches {bad}")
    if any(bad.values()) or torch.equal(got.tri[0], got.tri[1]):
        raise AssertionError("scan: KS disagrees with its plain version")
    bad = {label: bins_bad(*args[:3])[0] for label, (args, _) in zip(
        ("shadow", "edge hull", "character"), calls)}
    bad["two instances"] = bins_bad(w, h, pair)[0]
    log(f"scan: KSb on the same calls against scan_bins_plain (tile "
        f"{tr.SCAN_TILE}): mismatched words {bad}")
    if any(bad.values()):
        raise AssertionError("scan: KSb disagrees with its plain version")

    for name, path in paths.items():
        big_triangles(name, path["scene"])

    for name in GOLDEN:
        reset_counters()
        card = golden_frame(name, "cuda")
        counts = dict(read_counters(), **scan_counts())
        want = dict.fromkeys(RECORDED, 0)
        rasters = 3 if name == "edges" else 2
        want.update(K3=1, KS=rasters, KSb=rasters)
        d = np.abs(card.cpu().numpy() - golden_frame(name, "cpu").numpy())
        frac, mad = float((d > 0.02).mean()), float(d.mean())
        log(f"scan: golden configuration {name} ({GOLDEN_SIZE[0]}x"
            f"{GOLDEN_SIZE[1]}), card vs CPU: |d|>0.02 fraction {frac:.3g}, "
            f"mean abs diff {mad:.3g}, max {float(d.max()):.3g}; launches "
            f"{counts}")
        if counts != want:
            raise AssertionError(f"scan: {name} launched {counts}")
        if not (frac < 2e-3 and mad < 1 / 255):
            raise AssertionError(f"scan: {name}: card and CPU disagree")

    tiled = paths[M1]
    scene = with_render(tiled["scene"], raster_mode="scan")
    state, _ = scene.rollout(scene.init_state(), 1)
    _, _, calls = capture_scan(scene.step_and_render, state)
    if [c[0][:2] for c in calls] != [(SHADOW, SHADOW), (WIDTH, HEIGHT)]:
        raise AssertionError(f"scan: 1080p calls {[c[0][:2] for c in calls]}")
    for label, (args, out) in zip(("shadow", "character"), calls):
        def fn(args=args):
            return tr.scan_raster(*args)
        host = host_paced_ms(fn, 10)
        # 10 calls a mean: the wrapper's ~55 eager operators must be queued
        # before the sleep kernel ends
        runs = sorted(primed_ms(fn, 10) for _ in range(6))
        bnd, evals = scan_bound(*args[:3])
        n = args[2]["xy"].shape[0]
        log(f"scan: KS {label} {args[0]}x{args[1]}, {n} triangles "
            f"({int(args[2]['valid'].sum())} valid, {evals} triangle-pixel "
            f"evaluations by the box rule): the wrapper (table, KSb, KS) "
            f"back to back (means of 10 calls) {back_to_back(None, runs)}, "
            f"host-paced (the "
            f"wrapper's cost to the frame) {host:.4f} ms; KS's bound "
            f"{bnd[0]:.5f} ms ({bnd[1]}), wrapper back to back / bound "
            f"{runs[0] / bnd[0]:.1f}; covers "
            f"{100 * float((out.tri >= 0).float().mean()):.2f}% of the map")
        parts = scan_parts(label, args, out, bnd)
        if label == "character":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = tr.scan_raster_plain(*args)
            end.record()
            torch.cuda.synchronize()
            plain_t = start.elapsed_time(end)
            got = fn()
            n_bad = scan_bad(got, plain) + scan_bad(got, out)
            err = float((got.depth - plain.depth).abs().max())
            log(f"scan: the plain version once on the 1080p character: "
                f"{plain_t:.1f} ms, mismatches {n_bad}")
            if n_bad:
                raise AssertionError("scan: KS disagrees at 1080p")
            record(results, "KS", "KS scan_raster (the exact scan raster: "
                   "the scan frame's shadow, edge hull and character; the "
                   "tiled paths' big-triangle merges), the walk over KSb's "
                   "bins", "scan_raster.cu", "render/raster.py:111", err,
                   parts["KS"], plain_t, bnd)
            record(results, "KSb", "KSb scan_bins (the scan raster's tile "
                   "bins: a bit per triangle and coarse tile its pixel box "
                   "meets)", "scan_raster.cu", "render/raster.py:111",
                   parts["KSb err"], parts["KSb"], parts["KSb plain"],
                   parts["KSb bound"])

    seg = {True: [], False: []}
    for is_scan in SCAN_ORDER:
        sc, st = (scene, state) if is_scan else (tiled["scene"],
                                                 tiled["state"])
        reset_counters()
        t0 = time.perf_counter()
        st, sums = sc.rollout(st, SCAN_SEGMENT)
        torch.cuda.synchronize()
        seg[is_scan].append(1000.0 * (time.perf_counter() - t0)
                            / SCAN_SEGMENT)
        counts = dict(read_counters(), **scan_counts())
        sums = sums.cpu().numpy()
        if not (np.isfinite(sums).all() and (np.diff(sums) != 0).any()):
            raise AssertionError("scan: frames not finite or not advancing")
        if is_scan:
            state = st
            want = dict.fromkeys(RECORDED, 0)
            want.update(K3=SCAN_SEGMENT, KS=2 * SCAN_SEGMENT,
                        KSb=2 * SCAN_SEGMENT)
            if counts != want:
                raise AssertionError(f"scan: 1080p launches {counts}")
            for k, n in counts.items():
                MAIN_LAUNCHES[k] += n
        else:
            tiled["state"] = st
        log(f"scan: 1080p {'scan' if is_scan else 'tiled'} msaa=1 segment "
            f"of {SCAN_SEGMENT} frames (compiled rollout): "
            f"{seg[is_scan][-1]:.3f} ms/frame; launches {counts}")
    scan_ms, tiled_ms = (sum(seg[k]) / len(seg[k]) for k in (True, False))
    log(f"scan: 1080p msaa=1, shadow {SHADOW}: scan {scan_ms:.3f} ms/frame, "
        f"tiled {tiled_ms:.3f} ({scan_ms - tiled_ms:+.3f}) in the same call")

    frames = [with_render(scene, raster_mode=m).jit_step(donate=False)(
        state)[1] for m in ("scan", "auto")]
    d = (frames[0] - frames[1]).abs()
    frac, mad = float((d > 0.02).float().mean()), float(d.mean())
    log(f"scan: 1080p scan frame vs tiled frame of the same state: "
        f"|d|>0.02 fraction {frac:.3g}, mean abs diff {mad:.3g}")
    if not (frac < 2e-3 and mad < 1 / 255):
        raise AssertionError("scan: the scan and tiled frames disagree")
    log(f"scan: phase took {time.perf_counter() - t_phase:.1f} s")


def check_pmd_vpd():
    """The PMD and VPD readers on the card: the sample character at density
    0.5 written as PMD (`pmd_bytes`) and read back by the port's
    `parse_pmd`, 2 frames on the card against the CPU's (`check_parity`);
    and VPD_POSE read by `parse_vpd`, held by the sample character (density
    2.0, 640x360, shadow 1024^2, physics off): the frames at 1/30 s and
    3/30 s must be equal bit for bit."""
    from simple_mmd_renderer_tpu_torch.app.sample import sample_character
    from simple_mmd_renderer_tpu_torch.formats.pmd import parse_pmd
    from simple_mmd_renderer_tpu_torch.formats.vpd import parse_vpd

    t0 = time.perf_counter()
    data = pmd_bytes(sample_character(density=0.5))
    pm = parse_pmd(data)
    log(f"pmd: the sample character (density 0.5) as {len(data)} PMD bytes, "
        f"read back in {time.perf_counter() - t0:.2f} s: "
        f"{len(pm.positions)} verts, {len(pm.bones)} bones, "
        f"{len(pm.morphs)} morphs, {len(pm.rigid_bodies)} bodies")
    check_parity(False, label=", PMD sample character", pmx=pm)
    pose = parse_vpd(VPD_POSE.encode("cp932"), name="pose.vpd")
    scene = build_sample_scene(DENSITY, 640, 360, 1024, "cuda", vmd=pose)
    scene.config.physics.enabled = False
    state = scene.init_state()
    frames = []
    for _ in range(3):
        state, image = scene.step_and_render(state)
        frames.append(image)
    same = torch.equal(frames[0], frames[2])
    log(f"vpd: {len(pose.bone_tracks)} bones and {len(pose.morph_tracks)} "
        f"morph held by the sample character at 640x360, physics off: "
        f"frames 1 and 3 equal {same}, image mean "
        f"{float(frames[0].mean()):.4f}")
    if not same or not bool(torch.isfinite(frames[0]).all()):
        raise AssertionError("the VPD pose does not hold")


CLI_FRAMES, CLI_RESUME_AT = 8, 3


def cli_run(argv) -> list[str]:
    """`app.cli.main(argv)` on the card with its output kept -> its
    lines (it must return 0)."""
    from simple_mmd_renderer_tpu_torch.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}: {buf.getvalue()}")
    return buf.getvalue().splitlines()


def png_pixels(path) -> np.ndarray:
    """The [H,W,3] uint8 pixels of an 8-bit RGB PNG whose rows all use
    filter 0 (what `utils/png.encode_png` writes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise AssertionError(f"{path}: not 8-bit RGB")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def sim_leaves(state) -> list:
    return [state.time] + [getattr(state.physics, f.name)
                           for f in dataclasses.fields(state.physics)]


def check_cli_seek(scene):
    """The captured seek (its capture seconds, the scene's first seek, and
    replay ms) against the eager one (ms), bit for bit at three times; a
    seek after playback equals a seek from a fresh state bit for bit."""
    fresh = scene.init_state()
    t0 = time.perf_counter()
    scene.seek(fresh, 0.5)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay = host_paced_ms(lambda: scene.seek(fresh, 0.5), 10)
    t0 = time.perf_counter()
    for _ in range(2):
        scene.seek(fresh, 0.5, compiled=False)
    torch.cuda.synchronize()
    eager = 500.0 * (time.perf_counter() - t0)
    bad = 0
    for t in (0.1, 0.5, 2.0):
        got, want = scene.seek(fresh, t), scene.seek(fresh, t, compiled=False)
        bad += sum(mismatches(a, b) for a, b in zip(sim_leaves(got),
                                                    sim_leaves(want)))
    step = scene.jit_step(render=False, donate=False)
    s = fresh
    for _ in range(3):
        s = step(s)[0]
    scrub = sum(mismatches(a, b) for a, b in zip(
        sim_leaves(scene.seek(s, 0.5)), sim_leaves(scene.seek(fresh, 0.5))))
    log(f"cli: seek captured in {capture_s:.3f} s, replay {replay:.3f} ms "
        f"(CUDA events, with the fill and the copies out), eager "
        f"{eager:.3f} ms (host clock); captured vs eager mismatches {bad}, "
        f"after playback vs fresh {scrub}")
    if bad or scrub:
        raise AssertionError("the captured seek disagrees")


def check_cli_sync(scene):
    """The tracks' sampling, the frame config and build_matrices with the
    tensor ortho flag under sync debug mode "error"."""
    from simple_mmd_renderer_tpu_torch.render import camera_anim, pipeline
    from simple_mmd_renderer_tpu_torch.utils.graph import sync_errors

    state = scene.seek(scene.init_state(), 4 / 30)
    dev = torch.device("cuda")
    with sync_errors():
        frame = state.time * scene.config.fps
        camera_anim.sample_camera(scene.camera, frame)
        camera_anim.sample_light(scene.light, frame)
        cfg = scene.frame_config(state.time)
        pipeline.build_matrices(cfg, device=dev)
    if not (isinstance(cfg.camera_orthographic, torch.Tensor)
            and bool(cfg.camera_orthographic)):
        raise AssertionError("frame 4 is not orthographic")
    log("cli: sample_camera, sample_light, frame_config and build_matrices "
        "(tensor ortho flag) ran under sync debug mode \"error\"")


def cli_parity(tmp, density, size, crowd=0):
    """The CLI's Scene of `cli_files(tmp, density)` at `size` on the card
    and on the CPU: 2 frames (a crowd of `crowd` with the camera track:
    the per-instance fallback), then an orthographic frame (seek to 4/30
    s) of the single scene, each within the image tolerance."""
    from simple_mmd_renderer_tpu_torch.app import cli

    pmx, vmd = cli_files(tmp, density)
    args = cli.parse_args([pmx, vmd, "--use-camera", "--use-light",
                           "--width", str(size[0]), "--height", str(size[1]),
                           "--shadow-size", "256"])
    imgs = {}
    for dev in ("cuda", "cpu"):
        scene = cli.build_scene(args, torch.device(dev))
        scene.config.physics.solver_iterations = 4
        if crowd:
            step, state = crowd_step_fn(scene), crowd_init(scene, crowd)
        else:
            step, state = scene.step_and_render, scene.init_state()
        reset_counters()
        for _ in range(2):
            state, image = step(state)
        counts = read_counters()
        frames = [image.cpu().numpy()]
        if not crowd:
            frames.append(step(scene.seek(state, 4 / 30))[1].cpu().numpy())
        want = {k: (2 * max(crowd, 1) if dev == "cuda" else 0) * n
                for k, n in path_kernels(scene.config.render).items()}
        if any(counts[k] != n for k, n in want.items()):
            raise AssertionError(f"cli parity on {dev}: launches {counts}")
        imgs[dev] = frames
    for i, (a, b) in enumerate(zip(imgs["cuda"], imgs["cpu"])):
        d = np.abs(a - b)
        frac, mad = float((d > 0.02).mean()), float(d.mean())
        what = (f"crowd of {crowd}, frame 2" if crowd else
                ("frame 2" if i == 0 else "orthographic frame 5"))
        log(f"parity (cli: camera and light tracks, {what}): "
            f"{size[0]}x{size[1]}, density {density}, card vs CPU: "
            f"|d|>0.02 fraction {frac:.3g}, mean abs diff {mad:.3g}")
        if not (frac < 2e-3 and mad < 1 / 255):
            raise AssertionError("card and CPU CLI frames disagree")


def check_cli(smi: str):
    """The command-line renderer (`app.cli`) at the flagship's widths: the
    sample character at density 2.0 written as PMX and `cli_vmd()` (bone
    keys, an orbiting camera with a fov change and an orthographic range,
    a turning light), with --use-camera --use-light at 1920x1080, shadow
    2048^2. The seek captured vs eager; the sampling under sync debug mode
    "error"; every kernel call of a perspective frame 1 and of an
    orthographic frame against its plain version (`check_calls`);
    CLI_FRAMES frames at msaa=1 with PNGs, a checkpoint and a trace (then
    again without output, timed) and at msaa=4, every launch counter reset
    just before each run and read just after; the PNGs decoded equal to
    the frames' uint8 arrays; CLI_RESUME_AT frames, --save-state, then
    --resume for the rest, equal to the run of CLI_FRAMES bit for bit;
    the trace holds the pass labels; small frames card vs CPU."""
    from simple_mmd_renderer_tpu_torch.app import cli
    from simple_mmd_renderer_tpu_torch.utils.profiling import (PASSES,
                                                               TRACE_FILE)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pmx, vmd = cli_files(tmp)
        base = [pmx, vmd, "--use-camera", "--use-light", "--width",
                str(WIDTH), "--height", str(HEIGHT), "--shadow-size",
                str(SHADOW)]
        scene = cli.build_scene(cli.parse_args(base), torch.device("cuda"))
        expect = path_kernels(scene.config.render)
        state0 = scene.init_state()
        check_cli_seek(scene)
        check_cli_sync(scene)
        for label, state in (("perspective frame 1", state0),
                             ("orthographic frame 5",
                              scene.seek(state0, 4 / 30))):
            ortho = scene.frame_config(
                state.time + float(np.float32(1 / 30))).camera_orthographic
            if bool(ortho) != label.startswith("ortho"):
                raise AssertionError(f"{label}: orthographic {bool(ortho)}")
            check_calls(f"cli, {label}", scene.step_and_render, state,
                        expect)

        runs = (("msaa=1, PNGs + checkpoint + trace", "a",
                 ["--out", f"{tmp}/a", "--save-state", f"{tmp}/a.npz",
                  "--trace", f"{tmp}/trace"]),
                ("msaa=1, no output", "m1", []),
                ("msaa=4, no output", "m4", ["--msaa", "4"]))
        for label, key, extra in runs:
            cfg = dataclasses.replace(scene.config.render,
                                      msaa=4 if key == "m4" else 1)
            reset_counters()
            lines = cli_run(base + ["--frames", str(CLI_FRAMES)] + extra)
            counts = read_counters()
            for k, n in counts.items():
                MAIN_LAUNCHES[k] += n
            add_merges(merge_launches(f"cli ({label})", CLI_FRAMES, 2))
            want = {k: CLI_FRAMES * path_kernels(cfg).get(k, 0)
                    for k in KERNELS}
            fps = next(line for line in lines if " frames in " in line)
            log(f"cli ({label}): {fps}; launches {counts}; nvidia-smi: "
                f"{smi}")
            if counts != want:
                raise AssertionError(f"cli ({label}) launched {counts}, "
                                     f"expected {want}")
        cli_run(base + ["--frames", str(CLI_RESUME_AT), "--out", f"{tmp}/b",
                        "--save-state", f"{tmp}/b.npz"])
        cli_run(base + ["--frames", str(CLI_FRAMES - CLI_RESUME_AT), "--out",
                        f"{tmp}/c", "--resume", f"{tmp}/b.npz",
                        "--save-state", f"{tmp}/c.npz"])
        png_bad = sum(
            not np.array_equal(
                png_pixels(f"{tmp}/c/frame_{i:05d}.png"),
                png_pixels(f"{tmp}/a/frame_{i + CLI_RESUME_AT:05d}.png"))
            for i in range(CLI_FRAMES - CLI_RESUME_AT))
        a, c = np.load(f"{tmp}/a.npz"), np.load(f"{tmp}/c.npz")
        state_bad = [k for k in a.files if not np.array_equal(a[k], c[k])]
        log(f"cli: {CLI_RESUME_AT} frames + --resume for "
            f"{CLI_FRAMES - CLI_RESUME_AT} against {CLI_FRAMES} in one run: "
            f"{png_bad} PNGs differ, state leaves differing {state_bad}")
        if png_bad or state_bad or a.files != c.files:
            raise AssertionError("the resumed run differs")

        step, s = scene.jit_step(), scene.init_state()
        decoded_bad = 0
        for i in range(CLI_FRAMES):
            s, image = step(s)
            pixels = (image.cpu().numpy() * 255).astype(np.uint8)
            decoded_bad += not np.array_equal(
                png_pixels(f"{tmp}/a/frame_{i:05d}.png"), pixels)
        with open(os.path.join(tmp, "trace", TRACE_FILE)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        labels = sorted(n for n in PASSES if n in names)
        log(f"cli: {CLI_FRAMES} PNGs decoded, {decoded_bad} unequal to the "
            f"frames' uint8 arrays; trace {TRACE_FILE} holds the labels "
            f"{labels}")
        if decoded_bad or not {"shadow", "ground", "character",
                               "shade"} <= set(labels):
            raise AssertionError("the PNGs or the trace are wrong")
        del scene, step, s, image
        cli_parity(tmp, 0.5, (256, 192))
        cli_parity(tmp, 0.25, (CROWD_W, CROWD_H), crowd=4)
    log(f"cli: phase took {time.perf_counter() - t_phase:.1f} s")


# the mesh phase (`check_mesh`), the reference dry run's three
# configurations at the flagship's widths on a mesh that repeats the one
# card (`make_mesh(["cuda:0"] * n)`): the 1080p flagship frames split into
# BANDS[path] row bands (the msaa=1 frame's 360-row bands keep the
# downsampled lit map with its halo rows, the msaa=4 + window frame's
# 270-row bands, which the downsample factor 4 does not divide, take the
# exact lookup), the dense crowd of CROWD_N over MESH_SHARDS shards at
# msaa=1 and 4, and the scan crowd (SCAN_CROWD: density, width, height,
# shadow, solver iterations; 2 instances a shard, the per-instance
# fallback); MESH_SEGMENT frames a segment, split and one-device in turns
# (MESH_ORDER: split?)
BANDS = {M1: 3, M4: 4}
MESH_SHARDS, MESH_SEGMENT = 4, 4
MESH_ORDER = (True, False, False, True)
SCAN_CROWD = (0.25, 32, 32, 32, 2)


def mesh_label(mesh) -> str:
    names = [str(d) for d in mesh.devices]
    if len(set(names)) == 1:
        return f"['{names[0]}'] * {len(names)}"
    return str(names)


def checksum(image) -> torch.Tensor:
    """The mean of an image, or of a Sharded one's equal-sized shards."""
    from simple_mmd_renderer_tpu_torch.parallel.mesh import Sharded

    if isinstance(image, Sharded):
        return torch.stack([x.mean().to(image.devices[0])
                            for x in image.shards]).mean()
    return image.mean()


def mesh_turns(label, steps, expect) -> dict:
    """`steps` {split?: (step, state)}: the mesh's step and the one-device
    step, MESH_SEGMENT frames a segment in turns (MESH_ORDER), every launch
    counter reset just before each segment and read just after; each
    kernel must launch `expect[split?][kernel]` times a frame (KS, where
    `expect` does not name it, only in big-triangle merges). -> {split?:
    ms per frame}."""
    states = {split: st for split, (_, st) in steps.items()}
    seg_ms = {split: [] for split in steps}
    for split in MESH_ORDER:
        step = steps[split][0]
        state, sums = states[split], []
        reset_counters()
        t0 = time.perf_counter()
        for _ in range(MESH_SEGMENT):
            state, image = step(state)
            sums.append(checksum(image))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        states[split] = state
        counts = read_counters()
        name = f"{label}, {'split' if split else 'one device'}"
        want = dict(expect[split])
        if "KS" in want:
            counts.update(scan_counts())
        else:
            rasters = sum(v for k, v in want.items() if k != "K3")
            add_merges(merge_launches(name, MESH_SEGMENT, rasters))
        for k, n in counts.items():
            MAIN_LAUNCHES[k] += n
        ms = 1000.0 * dt / MESH_SEGMENT
        seg_ms[split].append(ms)
        sums = torch.stack(sums).cpu().numpy()
        log(f"{name}: segment of {MESH_SEGMENT} frames, {ms:.3f} ms/frame; "
            f"launches {counts}; checksums {sums.min():.5f}..{sums.max():.5f}")
        if not np.isfinite(sums).all() or not (np.abs(np.diff(sums)) > 0).any():
            raise AssertionError(f"{name}: frames non-finite or not advancing")
        for k, n in counts.items():
            if n != MESH_SEGMENT * want.get(k, 0):
                raise AssertionError(f"{name}: {k} launched {n} times in "
                                     f"{MESH_SEGMENT} frames, expected "
                                     f"{MESH_SEGMENT * want.get(k, 0)}")
    return {split: sum(v) / len(v) for split, v in seg_ms.items()}


def frame_gap(got, want) -> tuple[float, float]:
    """(share of the pixels off by more than 0.02, mean absolute
    difference), of the worst instance for [I, H, W, 3] frames."""
    d = (got - want).abs()
    if d.dim() == 3:
        d = d[None]
    return (max(float((x > 0.02).float().mean()) for x in d),
            max(float(x.mean()) for x in d))


def mesh_bands(name, scene, mesh):
    """The flagship path `name` (its scene) split into len(mesh) row
    bands by `frame_jit`: every band's kernel calls of frame 1 against
    their plain versions (`check_calls`); the gathered frame against the
    unbanded frame of the same state (the same lookup: the exact one where
    the bands take it) and state' against the unbanded step's; then banded
    and unbanded frames timed in turns."""
    from simple_mmd_renderer_tpu_torch.parallel.mesh import frame_jit

    n = len(mesh)
    cfg = scene.config.render
    label = (f"mesh: {name}, {n} bands of {HEIGHT // n} rows over "
             f"{mesh_label(mesh)}")
    exact = (HEIGHT // n) % cfg.shadow_lookup_downsample != 0
    step = frame_jit(scene, mesh)
    state0 = scene.init_state()
    one = scene.jit_step(donate=False)
    expect = {k: n * v for k, v in path_kernels(cfg).items()}
    check_calls(f"{label}, frame 1", step, state0, expect)
    state_b, image_b = step(state0)
    same = (with_render(scene, shadow_lookup_downsample=1) if exact
            else scene)
    state_1, image_1 = same.jit_step(donate=False)(state0)
    frac, mad = frame_gap(image_b.gather(), image_1)
    state_bad = [i for i, (a, b) in enumerate(zip(sim_leaves(state_b),
                                                  sim_leaves(state_1)))
                 if not torch.equal(a, b)]
    note = ""
    if exact:
        f2, m2 = frame_gap(image_b.gather(), one(state0)[1])
        note = (f" (the bands' exact lookup; against the unbanded frame "
                f"with the downsampled lookup: |d|>0.02 fraction {f2:.3g}, "
                f"mean {m2:.3g})")
    log(f"{label}: the gathered frame {tuple(image_b.gather().shape)} "
        f"against the unbanded frame of the same state{note}: |d|>0.02 "
        f"fraction {frac:.3g}, mean abs diff {mad:.3g}; state' leaves "
        f"unequal to the unbanded step's: {state_bad}")
    if not (frac <= 2e-3 and mad < 1 / 255) or state_bad:
        raise AssertionError(f"{label}: the banded frame disagrees")
    ms = mesh_turns(label, {True: (step, state_b), False: (one, state_1)},
                    {True: expect, False: path_kernels(cfg)})
    log(f"{label}: {ms[True]:.3f} ms per banded frame against "
        f"{ms[False]:.3f} ms unbanded, in turns ({ms[True] - ms[False]:+.3f}"
        f"); the bands share one card and render one after another, so no "
        f"gain is expected")


def ik_driven_bodies(scene) -> np.ndarray:
    """[R] bool: the kinematic bodies on a bone that an IK chain moves (a
    link or target of an IK program, or a bone below one)."""
    static, ps = scene.rig.host, scene.phys.host
    seeds = set()
    for seg in static.pre_segments + static.post_segments:
        for ik in seg.iks:
            seeds |= set(ik.links.tolist()) | {ik.target}

    def driven(b):
        while b >= 0:
            if b in seeds:
                return True
            b = int(static.bone_parent[b])
        return False

    return np.array([bool(ps.kinematic[i]) and bool(ps.has_bone[i])
                     and driven(int(ps.bone[i])) for i in range(ps.n_bodies)])


def shard_split_check(label, scene, mesh, step, whole, state0):
    """One frame of the sharded step `step` from `state0` (a crowd state):
    each shard's images and state equal bit for bit to `whole`
    (`crowd_step_fn`) on that shard's instances alone (the same batch:
    shards that share a graph must not overwrite each other's outputs);
    the gathered images against `whole` over every instance at once (the
    whole-frame tolerance), the clocks equal and the bodies' positions
    within 2e-2, the posing tolerance: a product batched over fewer
    instances may block its sums differently (another cuBLAS kernel), and
    the CCD steps amplify a last-bit change (PARITY D1). Prints the
    largest difference of every leaf, on the IK-driven kinematic bodies
    and on the others. -> (sharded state', images)."""
    from simple_mmd_renderer_tpu_torch.parallel.mesh import shard_crowd
    from simple_mmd_renderer_tpu_torch.utils.graph import tree_map

    sharded0 = shard_crowd(state0, mesh)
    state_s, images_s = step(sharded0)
    alone_bad = 0
    for shard0, shard, images in zip(sharded0.shards, state_s.shards,
                                     images_s.shards):
        alone_state, alone = whole(tree_map(torch.clone, shard0))
        alone_bad += int(not torch.equal(images, alone)) + sum(
            not torch.equal(a, b) for a, b in zip(sim_leaves(shard),
                                                  sim_leaves(alone_state)))
    state_1, images_1 = whole(state0)
    frac, mad = frame_gap(images_s.gather(), images_1)
    ik = torch.as_tensor(ik_driven_bodies(scene))
    got, want = state_s.gather(), state_1
    gaps = {}
    for name in ("pos", "quat", "vel", "omega"):
        d = (getattr(got.physics, name) - getattr(want.physics, name)).abs()
        gaps[name] = (float(d[:, ik].max()) if bool(ik.any()) else 0.0,
                      float(d[:, ~ik].max()))
    time_equal = torch.equal(got.time, want.time)
    log(f"{label}: every shard equal to crowd_step_fn on its own "
        f"{state_s.shards[0].time.shape[0]} instances (tensors unequal: "
        f"{alone_bad}); the gathered images {tuple(images_s.gather().shape)}"
        f" against crowd_step_fn over all {got.time.shape[0]} on one "
        f"device, worst instance: |d|>0.02 fraction {frac:.3g}, mean abs "
        f"diff {mad:.3g}; clocks equal {time_equal}; bodies' largest "
        f"difference (IK-driven kinematic, other): "
        + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in gaps.items()))
    if alone_bad or not time_equal or not (frac <= 2e-3 and mad < 1 / 255) \
            or max(gaps["pos"]) > 2e-2:
        raise AssertionError(f"{label}: the sharded crowd disagrees")
    return state_s, images_s, state_1


def mesh_crowd(scene, mesh, msaa: bool):
    """The dense crowd (`scene`: CROWD_N instances' scene) sharded over the
    mesh by `crowd_jit`: every shard's kernel calls of frame 1 against
    their plain versions, the shards against `crowd_step_fn`
    (`shard_split_check`), then sharded and unsharded crowd frames timed
    in turns."""
    from simple_mmd_renderer_tpu_torch.parallel.mesh import (crowd_jit,
                                                             shard_crowd)

    n = len(mesh)
    label = (f"mesh: crowd-dense {CROWD_LABEL[msaa]}, {n} shards of "
             f"{CROWD_N // n} over {mesh_label(mesh)}")
    scene = with_render(scene, msaa=4 if msaa else 1)
    step, whole = crowd_jit(scene, mesh), crowd_step_fn(scene)
    state0 = crowd_init(scene, CROWD_N)
    expect = {k: n * v for k, v in crowd_kernels(msaa).items()}
    check_calls(f"{label}, frame 1", step, shard_crowd(state0, mesh), expect)
    state_s, _, state_1 = shard_split_check(label, scene, mesh, step, whole,
                                            state0)
    ms = mesh_turns(label, {True: (step, state_s), False: (whole, state_1)},
                    {True: expect, False: crowd_kernels(msaa)})
    log(f"{label}: {ms[True]:.3f} ms per sharded crowd frame against "
        f"{ms[False]:.3f} ms unsharded, in turns ({ms[True] - ms[False]:+.3f}"
        f"); the shards share one card and run one after another, so no "
        f"gain is expected")


def mesh_scan_crowd(mesh):
    """The reference dry run's scan crowd (SCAN_CROWD, 2 instances a
    shard: the per-instance fallback, KS for each instance's shadow map
    and character) sharded by `crowd_jit`, held against `crowd_step_fn`
    (`shard_split_check`), then timed in turns."""
    from simple_mmd_renderer_tpu_torch.parallel.mesh import crowd_jit

    density, w, h, shadow, iters = SCAN_CROWD
    n, n_inst = len(mesh), 2 * len(mesh)
    label = (f"mesh: scan crowd of {n_inst} (density {density}, {w}x{h}, "
             f"shadow {shadow}), {n} shards over {mesh_label(mesh)}")
    scene = with_render(build_sample_scene(
        density, w, h, shadow, "cuda", n_frames=90, fps_keys=10,
        solver_iterations=iters), raster_mode="scan")
    step, whole = crowd_jit(scene, mesh), crowd_step_fn(scene)
    state_s, _, state_1 = shard_split_check(label, scene, mesh, step, whole,
                                            crowd_init(scene, n_inst))
    per = {"K3": 1, "KS": 2, "KSb": 2}
    ms = mesh_turns(label, {True: (step, state_s), False: (whole, state_1)},
                    {split: {k: n_inst * v for k, v in per.items()}
                     for split in (True, False)})
    log(f"{label}: {ms[True]:.3f} ms per sharded crowd frame against "
        f"{ms[False]:.3f} ms unsharded, in turns")


def check_native():
    """The PMX reader's native vertex parser (`native.get_lib`): built and
    loaded here (the card's machine has g++: nvcc needs a host compiler);
    the content rig and the density-2.0 sample character, written by
    `write_pmx`, parse to equal arrays through it and through the Python
    loop; the parse seconds of each route."""
    from simple_mmd_renderer_tpu_torch import native
    from simple_mmd_renderer_tpu_torch.app.sample import sample_character
    from simple_mmd_renderer_tpu_torch.formats import pmx as P
    from simple_mmd_renderer_tpu_torch.formats.writers import write_pmx

    if native.get_lib() is None:
        raise AssertionError("native: no host compiler, the parser is not "
                             "built")
    log(f"native: {native.library_path()} loaded (g++ builds it at a "
        f"checkout's first PMX parse)")
    fields = ("positions", "normals", "uvs", "extra_uvs", "skin_type",
              "skin_bones", "skin_weights", "sdef_c", "sdef_r0", "sdef_r1",
              "edge_scale", "triangles")
    get_lib = native.get_lib
    for label, pm in (("content rig", content_rig(DENSITY)[0]),
                      (f"sample character, density {DENSITY}",
                       sample_character(density=DENSITY))):
        data = write_pmx(pm)
        t0 = time.perf_counter()
        fast = P.parse_pmx(data)
        t1 = time.perf_counter()
        native.get_lib = lambda: None
        try:
            slow = P.parse_pmx(data)
        finally:
            native.get_lib = get_lib
        t2 = time.perf_counter()
        bad = [f for f in fields if not np.array_equal(getattr(fast, f),
                                                       getattr(slow, f))]
        log(f"native: {label} ({len(data)} bytes, {len(fast.positions)} "
            f"vertices, skin types {np.bincount(fast.skin_type).tolist()}): "
            f"native parse {t1 - t0:.4f} s, Python loop {t2 - t1:.4f} s; "
            f"fields differing {bad}")
        if bad:
            raise AssertionError(f"native: {label}: the routes disagree")


def check_mesh():
    """The multi-device entry points (`parallel.mesh`) on this machine's
    cards: the mesh that repeats cuda:0 (shards and bands run in turn on
    it), and with more than one card also `make_mesh()` over all of them
    (the band and shard counts its size divides); then the native PMX
    parser."""
    from simple_mmd_renderer_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    runs = [({name: make_mesh(["cuda:0"] * n) for name, n in BANDS.items()},
             make_mesh(["cuda:0"] * MESH_SHARDS))]
    if count > 1:
        real = make_mesh()
        runs.append(({name: real for name in BANDS if HEIGHT % count == 0},
                     real if CROWD_N % count == 0 else None))
    log(f"mesh: {count} CUDA device(s); running the mesh that repeats "
        f"cuda:0" + (" and make_mesh() over all of them" if count > 1 else
                     " (no second card: make_mesh() over separate cards "
                     "is not run)"))
    for bands, shards in runs:
        for name, mesh in bands.items():
            scene = build_sample_scene(DENSITY, WIDTH, HEIGHT, SHADOW,
                                       "cuda", **({} if name == M1
                                                  else MSAA_PATH))
            mesh_bands(name, scene, mesh)
            del scene
        if shards is not None:
            scene = build_sample_scene(DENSITY, CROWD_W, CROWD_H,
                                       CROWD_SHADOW, "cuda",
                                       n_frames=CROWD_MOTION, fps_keys=5)
            for msaa in (False, True):
                mesh_crowd(scene, shards, msaa)
            del scene
            mesh_scan_crowd(shards)
    check_native()
    log(f"mesh: phase took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from simple_mmd_renderer_tpu_torch.ops import _build

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_name_power()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"device: nvidia-smi: {smi}")

    t0 = time.perf_counter()
    libs = _build.build()
    _build.lib()
    log(f"build: {', '.join(p.name for p in libs)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    paths = build_paths()
    dense_scene, dense = build_crowd(DENSITY, "crowd-dense")

    results: dict = {}
    check_kernels(paths[M1]["scene"], paths[M1]["state"], results)
    check_kernels_msaa(paths[M4]["scene"], paths[M4]["state"], results)
    for name, key in ((T1, "K2"), (T4, "K4")):
        scene = with_render(paths[name]["scene"], albedo_window=False)
        check_calls(f"{name}, albedo_window=False", scene.step_and_render,
                    paths[name]["state"], path_kernels(scene.config.render),
                    attrs={key: 5})
    scene = paths[FULL]["scene"]
    check_calls(FULL, scene.step_and_render, paths[FULL]["state"],
                path_kernels(scene.config.render), nocull=True)
    check_depth_nocull(scene, paths[FULL]["state"])
    scene = paths[CONTENT]["scene"]
    check_calls(CONTENT, scene.step_and_render, paths[CONTENT]["state"],
                path_kernels(scene.config.render))
    check_compiled("flagship msaa=1", paths[M1]["scene"], paths[M1]["state"],
                   COMPILED_FRAMES)
    check_compiled("flagship msaa=4 + shadow_window", paths[M4]["scene"],
                   paths[M4]["state"], COMPILED_FRAMES_SHORT)
    check_stamp("flagship msaa=4 + shadow_window", paths[M4]["scene"],
                paths[M4]["state"], COMPILED_FRAMES)
    check_ccd("flagship msaa=4 + shadow_window", paths[M4]["scene"],
              paths[M4]["state"])
    check_compiled(CONTENT, paths[CONTENT]["scene"], paths[CONTENT]["state"],
                   COMPILED_FRAMES_SHORT)
    check_ccd(CONTENT, paths[CONTENT]["scene"], paths[CONTENT]["state"])
    sdef_step_times(CONTENT, paths[CONTENT]["scene"], paths[CONTENT]["state"])
    check_compiled("crowd-dense, both paths", dense_scene, dense[False][1],
                   COMPILED_FRAMES)
    check_ccd("crowd-dense", dense_scene, dense[False][1])
    check_kernels_crowd(dense, results)

    # a frame of each kind (the compiled paths share their step's graph
    # layout: the msaa=4 flagship's and the light crowd's are these)
    scene, state = paths[M1]["scene"], paths[M1]["state"]
    launch_profile("flagship msaa=1, eager",
                   lambda s: scene.step_and_render(s)[0], state, 1)
    launch_profile("flagship msaa=1, compiled",
                   lambda s: scene.rollout(s, 1)[0], state, 1)
    launch_profile("crowd-dense msaa=1, compiled",
                   lambda s: crowd_frames(dense[False][0], s, 1),
                   dense[False][1], 1)
    scene = paths[CONTENT]["scene"]
    launch_profile(f"{CONTENT}, compiled", lambda s: scene.rollout(s, 1)[0],
                   paths[CONTENT]["state"], 1)

    run_flagships(paths)
    pass_profile(paths)
    check_scan(paths, results)
    run_crowd({msaa: ("crowd-dense", *dense[msaa], msaa, False)
               for msaa in (False, True)}, CROWD_ORDER)
    look = look_kw(paths[FULL]["scene"].cubemap,
                   paths[FULL]["scene"].mmd_maps)
    del dense, dense_scene, paths
    bench_scene, bench = build_crowd(0.5, "crowd-bench", TEX2)
    for msaa, key in ((False, "K5a"), (True, "K5b")):
        step, state = bench[msaa]
        check_calls(f"textured crowd-bench, {CROWD_LABEL[msaa]}", step,
                    state, crowd_kernels(msaa), attrs={key: 5})
    check_compiled("crowd-bench", bench_scene, bench[True][1],
                   COMPILED_FRAMES_SHORT)
    light = {TEX: ("crowd-bench", *bench[True], True, False)}
    _, bench = build_crowd(0.5, f"crowd-bench, {FULL}", TEX2, msaas=(True,),
                           **look)
    step, state = bench[True]
    check_calls(f"crowd-bench, {FULL}", step, state,
                crowd_kernels(True, edges=True), nocull=True)
    light[FULL] = (f"crowd-bench, {FULL}", step, state, True, True)
    label = f"crowd-bench, {CONTENT}"
    content_scene, bench = build_crowd(0.5, label, TEX2, msaas=(True,),
                                       content=True)
    step, state = bench[True]
    check_calls(label, step, state, crowd_kernels(True))
    check_compiled(label, content_scene, state, COMPILED_FRAMES_SHORT)
    sdef_step_times(label, content_scene, state)
    light[CONTENT] = (label, step, state, True, False)
    ms = run_crowd(light, LIGHT_ORDER)
    log(f"crowd-bench in turns: textured {ms[TEX]:.3f} ms per crowd frame, "
        f"{FULL} {ms[FULL]:.3f} ({ms[FULL] - ms[TEX]:+.3f}), {CONTENT} "
        f"{ms[CONTENT]:.3f} ({ms[CONTENT] - ms[TEX]:+.3f})")
    del bench, bench_scene, content_scene, light, look
    check_pmd_vpd()
    small = look_kw(*full_look_inputs(16, (32, 64), 32, quiet=True))
    check_parity(msaa=False)
    check_parity(msaa=True)
    check_parity(False, textures=(64, 32, 16, 8) * 4, n_parts=16,
                 texture_mips=4)
    check_parity(True, textures=(64, 16), albedo_window=False)
    check_parity_crowd(msaa=False)
    check_parity_crowd(msaa=True)
    check_parity_crowd(False, (64, 16))
    check_parity_crowd(True, (64, 16))
    for msaa in (False, True):
        check_parity(msaa, (64, 48), f", textures (64, 16), {FULL}", 256,
                     textures=(64, 16), **small)
        check_parity_crowd(msaa, (64, 16), f", {FULL}", **small)
    # the content rig on a 12-frame motion, so that both morphs are well
    # above 0 at frame 2
    content = dict(vmd=content_motion(12, 2), sdef_true=True,
                   extended_morphs=True, textures=(64, 16))
    check_parity(True, label=f", textures (64, 16), {CONTENT}",
                 pmx=content_rig(0.5)[0], **content)
    check_parity_crowd(True, label=f", {CONTENT}", pmx=content_rig(0.25)[0],
                       **content)
    check_cli(smi)
    check_mesh()
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    for name in RECORDED:
        if not MAIN_LAUNCHES[name]:
            raise AssertionError(f"{name} never launched on the main paths")
        results[name]["launches"] = MAIN_LAUNCHES[name]
    log(f"launches on the main paths (every timed segment): {MAIN_LAUNCHES}")
    for name in RECORDED:
        r = results[name]
        log(f"record: {name} back to back least {r['ms']:.4f}, median "
            f"{r['median_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); card / bound {r['ms'] / r['bound_ms']:.2f}; "
            f"plain {r['plain_ms']:.4f} ms; launches {r['launches']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: results[name][k] for k in keys} for name in RECORDED]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
