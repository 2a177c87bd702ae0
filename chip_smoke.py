#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the repository root with no arguments: `python3 chip_smoke.py`. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from `rpt_tpu_torch/csrc` with nvcc, one process
   per source, all at once, and prints each build's ptxas report and
   (`[sass]`) the instructions of each threefry kernel; then
   `[random]` holds the threefry kernel against its plain version in every
   mode, the 64-bit ones (float64 uniform, int64 randint at spans from 1
   to 2^64 - 1) too, at the main path's shapes and ragged ones, and times
   it beside its bound (and, with RPT_COMPARE, in turns with the named
   trees' kernels); `[gather]`
   times torch's row gather at a few row widths; `[dtype]` renders one
   scene in float32, float64 and float32 again, each type through a graph
   of its own, the two float32 renders bit for bit; `[hdri]` holds the
   HDRI lookup of 800x600 directions on a 1024x2048 procedural sky (the
   quad form) on the card against the CPU, in both types, and times its
   three layouts in turns (the port's 13-float quad rows, the reference's
   12-float rows, four gathers of the map), which must read the same values
   bit for bit; `[mono_light]` renders the monomial light's scene on the
   CPU and on the card with one seed and compares them as phase c does;
   `[scatter]` holds the scatter kernel (`csrc/scatter.cu`) against its
   plain version (`ops.scatter.scatter_plain`) on the same draws, at every
   depth of one eager sample of `pegasus_trefoil` (1.44 M lanes, float32
   and float64) and of `wine_glass_trefoil` (2.07 M lanes, float32): wi,
   w, ok and the weight's divisor bit for bit; at depth 1 the wrapper's
   autograd path (material columns that require grad) against the plain
   version, values and gradient bit for bit, in one counted launch; and
   times the kernel per launch at depths 0 and 1 beside the plain version
   and its bound;
3. for each workload, at 960x540 unless said otherwise, in the wavefront
   order the renderer picks by default (morton-sorted from depth 1 where a
   wide kernel walks):
   - `dragon`, the baked-mesh path: a 120k-triangle trefoil, 2 bounces,
     through the two bvh8 kernels;
   - `dragon871k`: the same scene at the real dragon's 871,022 triangles
     (`bench.py:74`), through the two bvh8 kernels; a refused wide pack
     fails the run (it would otherwise fall back to bvh2 with a warning);
   - `lego`, the instanced path: the 768-instance brick city, 5 bounces,
     through the two tlas8 kernels;
   - `lego_toy`, the OBJ+MTL path of a small baked mesh: the toy brick
     plane (108 triangles, 4 materials), 5 bounces, through the two bvh2
     kernels;
   - `dragon_binary`: `dragon` compiled with RPT_BVH_KERNEL=binary
     (`scene._BVH_KERNEL`), through the two bvh2 kernels;
   - `lego_binary`: `lego` compiled with RPT_BVH_KERNEL=binary, through
     the two tlas2 kernels;
   - `cornell`, the Cornell box: analytic primitives and small meshes, no
     traversal kernel (phases b, f, g and h do not apply);
   - the float64 workloads, `dragon_f64`, `lego_f64`, `lego_toy_f64`,
     `lego_binary_f64`, `cornell_f64` and `dragon_binary_f64`: their
     float32 twins' scenes, size and bounces rendered with
     `Renderer(dtype=torch.float64)`, through the float64 kernels (bvh8,
     tlas8, bvh2, tlas2, bvh2 on the 120k-triangle trefoil; none on
     `cornell_f64`) and the 64-bit draws; phases a-h as above (h over each
     named tree's float64 pack of the same scene), the
     main path checked to launch no kernel or draw of the other type, its
     Mrays/s beside its float32 twin's in turns, and each kernel's ms per
     launch beside its float32 twin's on the same wavefronts, in turns;
   - `monomial_glass` and its float64 twin `monomial_glass_f64`, the HDRI
     and monomial path at `examples/monomial_glass.py`'s 800x600 and 1
     bounce: a metallic monomial surface, a cube, two spheres and a plane
     under a 1024x2048 procedural sky (a 25.2 MB map and a 109 MB quad
     table on the card), one point light; no traversal kernel, so phases
     a, c, `[graph]`, d and e, where `[profile]` adds the share of a
     replay's device time that the monomial root finds take, read from
     the profiled replay's trace;
   - `pegasus_trefoil` and `wine_glass_trefoil`, the reference's two
     heaviest bench rows (`bench.py:85-86`) at their full sizes, bounces
     and shadow rays, the 120k-triangle trefoil in their meshes' place (the
     meshes are assets): `pegasus` 1200x1200, 8 bounces, an ice mesh under
     a procedural sky, EV -1.5, and no light, so no shadow ray and no
     any-hit launch on its path (the any hit is held and timed on its
     camera wavefront); `wine_glass` 1920x1080, 6 bounces, a clear mesh
     under one sphere light, 2.07 M rays a wavefront; both through the
     two bvh8 kernels, morton-sorted;
   - `fractal_spheres`, `examples/fractal_spheres.py` at its 800x600, 0
     bounces, 1 spp: 937 spheres through the chunked sphere test, no
     traversal pack (phases a, c, `[graph]`, d and e);
   - `compound`, `examples/compound.py` at its 1024x1024 and 5 bounces,
     1 spp: five cubes (three mirrored) under three sphere lights, no
     traversal pack (phases a, c, `[graph]`, d and e);
   - `fractal_teapots_trefoil`, `bench.py`'s `fractal_teapots` row at its
     800x600 and 0 bounces: 937 instances of the trefoil cut to the
     teapot's 2,256 triangles, through the two tlas8 kernels;
   a. compiles the scene and prints its sizes;
   b. holds each of the path's kernels against its plain torch version on
      the workload's own rays: the camera rays and every wavefront of an
      eager 1-spp render (a graph replay calls no wrapper to record);
   c. renders a small image on the CPU and on the card with the same seed
      and compares them;
   `[graph]`: a render through the captured CUDA graph against the same
      render run eagerly, and two chunks (`start_iter`) against one call,
      `sum` and `sum_sq` bit for bit; the capture's seconds, its memory
      pool, and the launches of one replay and of one eager pass, which
      must be the same;
   d. drives the main path, `Renderer.render_buffer` at full size (one
      graph replay per sample), with every kernel's launch count set to 0
      just before and read just after (the kernels count their own
      launches on the card, replays included), checks the image and the
      counts, and prints Mrays/s, beside the eager pass's in turns, and
      the peak of allocated memory during it;
   e. profiles one sample through the entry point, one replay of the
      cached graph alone and one eager sample (device-busy share, idle
      share, kernels launched, the traversal and threefry kernels' shares),
      and holds the profiler's count of the kernels one replay ran against
      the card's own count (the profiler may lose a few records, never add
      one);
   f. times each of the path's kernels per launch, launched from Python
      and inside a CUDA graph, beside its plain version and its bound (the
      operations its own plain walk counts, each at the card's rate for
      the type it runs in);
   on `dragon_binary` and `lego_binary`, also:
   g. `[binary_vs_wide]`: the binary kernels against the wide kernels of
      the same trees on every wavefront, and both timed in turns;
   on every workload with a traversal pack, float32 or float64, also:
   h. `[before_after]`: the same kernels of other trees of the repository
      (`RPT_COMPARE=label=dir,...`, e.g. a `git archive` of the parent
      commit), timed in turns with this tree's on the same wavefronts;
      skipped when no tree is named;
   on `dragon`, `dragon_f64`, `lego`, `lego_f64`, `lego_toy`,
   `lego_toy_f64`, `lego_binary`, `lego_binary_f64` and
   `dragon_binary_f64`, also:
   `[occupancy]`: each of the four kernels of the workload's family
      (bvh8, tlas8, bvh2 or tlas2; float32 and float64, closest and any hit) at
      the launch its wrappers make for the scene's stack depth: registers
      and local (spill) bytes a thread, blocks, warps and shared stack
      bytes resident per SM; of this tree and of each tree named in
      RPT_COMPARE (by its ptxas log and the occupancy rule where it has no
      query);
   on `dragon`, `lego` and `dragon871k` (whose default wavefront order is
   morton, `integrator._auto_compact`), also:
   i. `[compact]`: the four wavefront orders (RPT_COMPACT 0, 1, octant,
      morton) in turns through the graphed loop, each render bit for bit
      against the masked one, with Mrays/s, device-busy and wall ms per
      replay, kernels per sample, capture seconds, pool and the sort's own
      ms per call; then the wide kernels' ms per launch on the masked
      render's depth >= 1 rays as they come and morton-sorted;
4. `[grad]`, the differentiable path (`rpt_tpu_torch.grad`,
   `make_diff_render`), eager, each sample under activation checkpointing:
   - at 64x48, card against CPU: the material gradient of the
     5,000-triangle trefoil through the bvh8 kernels (the plain walks on
     the CPU), and `cornell`'s camera gradient (eye, direction, fov; no
     BVH); a camera gradient through the trefoil's BVH must raise;
   - `dragon` (2 bounces, through the bvh8 kernels) and `lego` (5 bounces,
     through the tlas8 kernels) at 960x540: the gradient of mean(image)
     with respect to five material leaves. One forward and backward step
     at spp 2 is the gradient's main path: every launch count set to 0 just
     before and read just after, each walk kernel launched twice per
     sample and path vertex (the backward recomputes the forward). Printed:
     ms per sample of the forward with autograd off and on and of the
     backward, Mrays/s of the step (median and range of GRAD_TURNS; the
     host sets it) and of the profiled step's device-busy time (stable),
     peak MiB at spp 1 and 2, launches per
     sample, the gradient through the kernels against the plain walks' on
     the card under deterministic algorithms (bit for bit, else within
     GRAD_PLAIN_RTOL of the largest |g|), and one profiled step's idle
     share and the walks' share of its device time;
   - the other walks (GRAD_FAMILIES): bvh2 (`dragon`) and tlas2 (`lego`)
     compiled with RPT_BVH_KERNEL=binary, bvh8 and tlas8 in float64: one
     step at 320x180 through the kernels against the plain walks on the
     card (bit for bit, each walk launched twice per sample and vertex, in
     its type's slot), and at 32x24 on the 5,000-triangle trefoil or the
     96-instance city, the card against the CPU; no timing;
5. `[ode]`: one frame of `examples/marbles.py`'s physics (25 marbles,
   1/16 s at 1/10000: 624 RK4 steps and a remainder) on the card, through
   the captured step replayed per step against the eager loop, bit for
   bit, and against the CPU within the CPU tests' bar, on the example's
   initial state and on a packed state in contact; ms per step graphed
   and eager, kernels and device time of one step, the capture's seconds;
6. `[dynamic]`, the animation path (`Renderer(dynamic=True)`): two cells
   of 8 frames, `dragon_orbit` (the dragon at 960x540, 2 bounces, spp 2,
   its large sphere light circling the 120k-triangle trefoil; through the
   bvh8 kernels) and `marbles` (800x600, 9 bounces, spp 2 of the
   example's 2000, depth of field; the state advanced a frame on the card
   by the graphed RK4 between frames). Each frame runs through the
   dynamic path and the static one in turns: bit for bit, with equal
   launch counts per pass (a frame that captures runs one eager warm-up
   pass more; the dynamic loop's counts are its main path, counted from 0
   per frame); the dynamic loop must capture once. Printed per way: seconds
   per frame and frames per second, split into compile, lookup (the
   dynamic path's refill: MiB and ms), capture and replays. A ninth frame
   of another topology (a trefoil of 100,000 triangles, a 26th marble)
   must make a second entry and capture, bit for bit with its static
   render; and three small cells (64x48, 2 bounces, spp 2, 4 frames) of the
   other walks: `orbit_bvh2` (the 5,000-triangle trefoil under the orbiting
   light, RPT_BVH_KERNEL=binary), `city_tlas2` (the 96-instance brick city,
   every instance moved a frame, binary) and `orbit_bvh8_f64` (the trefoil
   through bvh8 in float64), each with its topology change;
7. `[examples]`: every module of `rpt_tpu_torch.examples` through its
   `main([...])` on the card, at its script's default size and bounces
   with 1 spp (`simple_video` and `marbles`: 2 frames), the asset examples
   on stand-in files written to a temporary directory
   (`examples._stand_ins`); per example one line: the PNG's shape, the
   traversal pack the rule gave it (which must be EXAMPLE_PACKS'), the
   kernels it launched (counted from 0; every kernel of its path and no
   other), the seconds and Mrays/s of `main` (compile, capture and PNG
   included) and of a second render through the same renderer, and its
   card render against the CPU's at 64x48 (0.99 of the pixels, the mean to
   1e-3);
8. `[sharded]`, the sharded render (`rpt_tpu_torch.parallel`): `dragon`
   at 960x540, 2 bounces, spp 4, through `render_distributed` on meshes of
   1, 2, 4 and 7 shards of the one card (7 pads 518,400 pixels by 6), each
   shard a CUDA graph of its own walking its slice with the bvh8 kernels:
   every mesh graphed against its shards run eagerly, bit for bit, and
   counted on the card from 0 (3 closest and 6 any-hit walks per shard
   and sample); every bvh8 wavefront of one eager sample of the last shard
   of the 4- and 7-shard meshes (129,600 and 74,058 rays, neither a whole
   number of blocks; the 7th holds the 6 pad rays) against the plain walk,
   bit for bit; `make_sharded_many_fn` in two chunks against one call and
   `render_pass_sharded` against one sample of it, bit for bit; Mrays/s of
   each mesh in turns with `render_buffer` (median of 3), and one sample
   of each profiled (device-busy ms, idle share, kernels); the
   reference's shard form of the jitter (a draw in [-1, 1) times 1/dim)
   against the draw in [-1/dim, 1/dim) that every pass takes, bit for bit,
   and the extra multiply it would cost; each shard's graph pool; a 64x48
   4-shard render on the card against the CPU;
9. `[multihost]`: two processes of this script (`--multihost-worker`),
   each with 2 shards on the one card, joined over gloo, render the
   4-shard frame with `render_multihost`: both hold the same frame, bit
   for bit the in-process 4-shard render; the all-gather's ms and its
   share of the call;
10. `[sharded_grad]`: `make_sharded_diff_fn` on 4 shards: one forward and
   backward step and one SGD step on `dragon` at 960x540 (timed, walks
   counted per shard, a finite loss), and at 64x48 on the 5,000-triangle
   trefoil the card's gradient against the CPU's within `[grad]`'s bar;
11. `[multihost_grad]`: two processes of this script (`--multihost-worker
   ... grad`), each with 2 shards on the one card, joined over gloo, take
   `[sharded_grad]`'s step over the 4-shard global mesh: both processes'
   loss, gradients and new leaves bit for bit the same, the gradients
   within 1e-6 of max|g| per leaf of `[sharded_grad]`'s in-process step,
   3 closest and 6 any-hit walks per shard counted on the card, and
   `render_pass_sharded` and `make_sharded_many_fn` in two chunks over the
   global mesh bit for bit the in-process 4-shard calls; forward and
   backward ms, each collective's ms timed apart after a barrier and its
   share of the step, the peak MiB;
12. prints one JSON line `{"kernels": [...]}` with one row for each of the
   eight traversal kernels, the threefry kernel and the scatter kernel
   (the scatter kernel's launches from `pegasus_trefoil`'s main path, and
   per sample of each workload's; with their launches
   per differentiated sample and per sample of the dynamic loop, where a
   `[grad]` or `[dynamic]` check runs them; the bvh8 rows also per shard
   and sample of the sharded render; the launches of each example that
   ran it), then one for each
   float64 instantiation (`<kernel>_f64`, `threefry_f64` for the
   64-bit modes, `scatter_f64` from the first float64 workload's main
   path), then the last line `{"ok": true, "device": {...}}`.

A failed phase prints FAIL and exits nonzero with no result. It imports
nothing of JAX or of the JAX package. `python3 chip_smoke.py --workloads
random,lego_toy_f64,...` runs the build, `[ties]` / `[edge]` and the named
workloads alone (`random`: `[sass]` and `[random]`, where the threefry
kernel of every tree in RPT_COMPARE is held against this tree's, bit for
bit, and timed with it in turns; a name of GRAD_FAMILIES or DYNAMIC_CELLS:
that `[grad]` or `[dynamic]` check alone; `examples`: `[examples]`). `python3 chip_smoke.py --multicard`,
on a host with several cards, runs the build and `multicard_phase` alone. `python3 chip_smoke.py
--multihost-worker <rank> <nproc> <port> <dir> <backend> <devices> <mode>`
is one process of a multi-process render (`render`) or gradient step
(`grad`); the script starts them itself.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

WIDTH, HEIGHT = 960, 540
SMALL_W, SMALL_H = 64, 48
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3 rate.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# FP64 outside the tensor cores (H100 SXM data sheet).
PEAK_F64_OPS = 34e12
# 32-bit integer operations per second: 64 INT32 lanes per SM (Hopper
# architecture white paper) x 132 SMs x the 1.98 GHz boost clock.
PEAK_INT32_OPS = 64 * 132 * 1.98e9
PARITY_MIN = 0.9999
T_MIN_WALK = 1e-3  # the t_min of walk_cases_phase
T_TOL = 2e-5

# The scatter kernel (no TPU kernel stands behind it: XLA fuses the shading
# math). A lane reads its normal, wo and color (3 reals each), four material
# columns and five draws, and writes wi and w (3 reals each): 24 reals, and
# the bytes of found and ok.
SCATTER = dict(source="rpt_tpu_torch/csrc/scatter.cu", reals_per_lane=24, bool_bytes=2)
# The wavefronts `[scatter]` holds the kernel to: (workload, type).
SCATTER_CASES = (("pegasus_trefoil", "float32"), ("pegasus_trefoil", "float64"), ("wine_glass_trefoil", "float32"))

# Per kernel: its source, the TPU kernel it replaces, and the bytes per ray
# it must read and write.
KERNELS = {
    "bvh8_closest": dict(source="rpt_tpu_torch/csrc/bvh8.cu",
                         replaces="rpt_tpu/ops/bvh8_pallas.py:368", in_bytes=24 + 1, out_bytes=8),
    "bvh8_occluded": dict(source="rpt_tpu_torch/csrc/bvh8.cu",
                          replaces="rpt_tpu/ops/bvh8_pallas.py:368", in_bytes=24 + 1 + 4, out_bytes=1),
    "tlas8_closest": dict(source="rpt_tpu_torch/csrc/tlas8.cu",
                          replaces="rpt_tpu/ops/tlas8_pallas.py:330", in_bytes=24 + 1, out_bytes=12),
    "tlas8_occluded": dict(source="rpt_tpu_torch/csrc/tlas8.cu",
                           replaces="rpt_tpu/ops/tlas8_pallas.py:330", in_bytes=24 + 1 + 4, out_bytes=1),
    "bvh2_closest": dict(source="rpt_tpu_torch/csrc/bvh2.cu",
                         replaces="rpt_tpu/ops/bvh_pallas.py:324", in_bytes=24 + 1, out_bytes=8),
    "bvh2_occluded": dict(source="rpt_tpu_torch/csrc/bvh2.cu",
                          replaces="rpt_tpu/ops/bvh_pallas.py:466", in_bytes=24 + 1 + 4, out_bytes=1),
    "tlas2_closest": dict(source="rpt_tpu_torch/csrc/tlas2.cu",
                          replaces="rpt_tpu/ops/tlas_pallas.py:165", in_bytes=24 + 1, out_bytes=12),
    "tlas2_occluded": dict(source="rpt_tpu_torch/csrc/tlas2.cu",
                           replaces="rpt_tpu/ops/tlas_pallas.py:370", in_bytes=24 + 1 + 4, out_bytes=1),
}
# The float64 instantiation of each: the same source and TPU kernel; rays
# of 6 doubles in, a double t (and ids) out.
KERNELS_F64 = {
    f"{name}_f64": dict(spec, in_bytes=48 + 1 + (8 if name.endswith("occluded") else 0),
                        out_bytes=spec["out_bytes"] + (4 if name.endswith("closest") else 0))
    for name, spec in KERNELS.items()
}
# name -> scene, RPT_BVH_KERNEL for its compile, bounces, samples of the main
# path, shadow rays per path vertex (one per light), its kernel family, and
# (float64 workloads) the render's real type and the float32 workload it
# twins.
WORKLOADS = {
    "dragon": dict(scene="dragon", bvh_kernel="wide", bounces=2, spp=4, shadow=2, family="bvh8"),
    "dragon871k": dict(scene="dragon871k", bvh_kernel="wide", bounces=2, spp=2, shadow=2, family="bvh8"),
    "lego": dict(scene="lego", bvh_kernel="wide", bounces=5, spp=2, shadow=2, family="tlas8"),
    "lego_toy": dict(scene="lego_toy", bvh_kernel="wide", bounces=5, spp=4, shadow=1, family="bvh2"),
    "dragon_binary": dict(scene="dragon", bvh_kernel="binary", bounces=2, spp=2, shadow=2, family="bvh2"),
    "lego_binary": dict(scene="lego", bvh_kernel="binary", bounces=5, spp=2, shadow=2, family="tlas2"),
    "cornell": dict(scene="cornell", bvh_kernel="wide", bounces=2, spp=4, shadow=1, family=None),
    "dragon_f64": dict(scene="dragon", bvh_kernel="wide", bounces=2, spp=2, shadow=2, family="bvh8",
                       dtype="float64", twin="dragon"),
    "lego_f64": dict(scene="lego", bvh_kernel="wide", bounces=5, spp=2, shadow=2, family="tlas8", dtype="float64",
                     twin="lego"),
    "lego_toy_f64": dict(scene="lego_toy", bvh_kernel="wide", bounces=5, spp=2, shadow=1, family="bvh2",
                         dtype="float64", twin="lego_toy"),
    "lego_binary_f64": dict(scene="lego", bvh_kernel="binary", bounces=5, spp=2, shadow=2, family="tlas2",
                            dtype="float64", twin="lego_binary"),
    # The reference's dragon under binary kernels, rendered under x64: the
    # float64 bvh2 pair on a 120k-triangle tree (spp cut to 1 to keep the
    # script's time).
    "dragon_binary_f64": dict(scene="dragon", bvh_kernel="binary", bounces=2, spp=1, shadow=2, family="bvh2",
                              dtype="float64", twin="dragon_binary"),
    "cornell_f64": dict(scene="cornell", bvh_kernel="wide", bounces=2, spp=2, shadow=1, family=None, dtype="float64",
                        twin="cornell"),
    # The HDRI and monomial path at its source's size (`examples/monomial_glass.py`:
    # 800x600, 1 bounce, one point light; its 100 spp cut to 4 and 2).
    "monomial_glass": dict(scene="monomial_glass", bvh_kernel="wide", bounces=1, spp=4, shadow=1, family=None,
                           size=(800, 600)),
    "monomial_glass_f64": dict(scene="monomial_glass", bvh_kernel="wide", bounces=1, spp=2, shadow=1, family=None,
                               size=(800, 600), dtype="float64", twin="monomial_glass"),
    # The reference's two heaviest bench rows (`bench.py:85-86`) at their
    # full sizes and bounces, the trefoil in their meshes' place (assets):
    # `pegasus` environment-lit (a 256x512 procedural sky, EV -1.5) with no
    # light, so no shadow ray and no any-hit launch on its path; 8 bounces
    # through a dielectric mesh. `wine_glass` a clear mesh under one sphere
    # light, 1920x1080, 6 bounces: 2.07 M rays a wavefront.
    "pegasus_trefoil": dict(scene="pegasus_trefoil", bvh_kernel="wide", bounces=8, spp=2, shadow=0, family="bvh8",
                            size=(1200, 1200), ev=-1.5),
    "wine_glass_trefoil": dict(scene="wine_glass_trefoil", bvh_kernel="wide", bounces=6, spp=1, shadow=1,
                               family="bvh8", size=(1920, 1080)),
    # `examples/fractal_spheres.py` at its 800x600, 0 bounces, 1 spp: 937
    # spheres through the chunked sphere test (`scene._maybe_chunked`, four
    # chunks of up to 256), no traversal pack; a directional and a point
    # light, each a shadow query per vertex. Its card image is held to the
    # CPU's on `cpu_share` of the pixels, not 0.99 (measured 0.985 at
    # 64x48): the card's camera rays lie an ulp from the CPU's on 0.71 of
    # the rays (cot(fov / 2) is the same on both; the likely cause is
    # `torch.rsqrt` in `normalize`, which CUDA does not round correctly),
    # and on a sphere of radius 0.0256 an ulp can change the hit; the CPU's
    # rays traced on both devices hit and shade alike on every ray
    # (`same_rays_phase`, which fails below 0.99).
    "fractal_spheres": dict(scene="fractal_spheres", bvh_kernel="wide", bounces=0, spp=1, shadow=2, family=None,
                            size=(800, 600), cpu_share=0.97),
    # `examples/compound.py` at its 1024x1024 and 5 bounces (spp 1 of its
    # 50): five cubes, three of them mirrored, under three sphere lights;
    # no traversal kernel.
    "compound": dict(scene="compound", bvh_kernel="wide", bounces=5, spp=1, shadow=3, family=None,
                     size=(1024, 1024)),
    # `bench.py:65`'s `fractal_teapots` row at its 800x600 and 0 bounces
    # (a directional and a point light): 937 instances of one mesh, the
    # trefoil cut to the teapot's 2,256 triangles (the teapot is an asset),
    # through the two-level pack the reference's rule gives it (tlas8).
    "fractal_teapots_trefoil": dict(scene="fractal_teapots_trefoil", bvh_kernel="wide", bounces=0, spp=4, shadow=2,
                                    family="tlas8", size=(800, 600)),
}
# `[examples]`: every module of `rpt_tpu_torch.examples` through its `main`
# on the card, at its script's default size and bounces with `--spp 1`
# (the videos, which write frames into `--outdir`, with VIDEO_FLAGS), the
# asset examples on the stand-in files of `examples._stand_ins` (the
# trefoil at the teapot's 2,256 triangles and at 120,000, the toy plane, a
# procedural sky); each one's launches counted from 0, the traversal pack
# the rule gave it (EXAMPLE_PACKS, else none), its kernels against their
# plain versions on its camera wavefront at its own size
# (`kernel_gate`), and the card against the CPU at SMALL_W x SMALL_H
# with the example's own settings, at 0.99 of the pixels unless its
# workload's `cpu_share` says otherwise (then `same_rays_phase` shows the
# cause).
VIDEO_FLAGS = {"simple_video": ["--frames", "2", "--spp", "1"], "marbles": ["--frames", "2"]}
EXAMPLE_PACKS = {"teapot": "bvh2", "cylinder": "bvh2", "rustacean": "bvh2", "lego": "bvh2", "dragon": "bvh8",
                 "pegasus": "bvh8", "wine_glass": "bvh8", "metal": "tlas8", "fractal_teapots": "tlas8"}
# `[hdri]`: the map's height (a 1024x2048 map, the shape of the reference
# examples' 2k maps and exactly `_QUAD_MAX_TEXELS`, so the quad form) and
# the tolerance of card against CPU. In float32 the texel coordinate x (up
# to w - 1 = 2047) carries an ulp of 1.2e-4 texels, and the card's atan2,
# acos and division round apart from the CPU's by a few ulps, so a lookup
# may move by HDRI_ULPS ulps of x (and of y) times the largest contrast
# between neighbouring texels around the quad it reads (`hdri_slack`); the
# float64 lookup is held to HDRI_RTOL / HDRI_ATOL alone.
HDRI_HEIGHT = 1024
HDRI_RTOL, HDRI_ATOL = 1e-5, 1e-6
HDRI_ULPS = 4
# `[compact]`: the workloads whose wavefront orders are compared, each
# order's RPT_COMPACT value, and the samples of each timed turn.
COMPACT_WORKLOADS = ("dragon", "lego", "dragon871k")
COMPACT_ENV = {False: "0", True: "1", "octant": "octant", "morton": "morton"}
COMPACT_SAMPLES = 4
# `[occupancy]`: the workloads that print their kernels' occupancy.
OCCUPANCY_WORKLOADS = ("dragon", "dragon_f64", "lego", "lego_f64", "lego_toy", "lego_toy_f64", "lego_binary",
                       "lego_binary_f64", "dragon_binary_f64")
# The threefry kernel's row: its source, its modes (keys, bits, uniform,
# randint), and what one element of each mode needs (csrc/threefry.cu's
# note counts it): 32-bit integer operations, 72 per hash (one three-way xor
# for the third key word, one add of the key into x2, 20 steps of add,
# rotate and xor, five key injections of one add into x1 and one
# three-input add into x2), then bits: an xor; uniform: an xor, a shift and an or;
# randint: two hashes, two xors, three remainders (one operation each,
# though the card has no instruction for one), a multiply and two adds, and
# once per launch the two hashes of its key split. Float32 operations:
# uniform's subtract, fma (two, as the card's peak counts it) and max.
# Bytes: the output written, and the tensor key read.
THREEFRY = dict(source="rpt_tpu_torch/csrc/threefry.cu", modes=("keys", "bits", "uniform", "randint"),
                int_ops={0: 72, 1: 73, 2: 75, 3: 2 * 72 + 2 + 3 + 1 + 2}, int_ops_per_launch={3: 2 * 72},
                f32_ops={0: 0, 1: 0, 2: 4, 3: 0}, out_bytes={0: 16, 1: 8, 2: 4, 3: 4}, key_bytes=16)
# The 64-bit modes (counted by `random._threefry64`), modes 4 and 5 of the
# kernel: the float64 uniform takes the hash, the 64-bit word (a shift and
# an or), its mantissa (a shift and an or) and four float64 operations
# (subtract, fma as two, max); the int64 randint two hashes, the 64-bit words
# (two shifts, two ors), three 64-bit remainders (one operation each, though
# the card has none), a multiply and two adds, and once per launch the two
# hashes of its key split.
THREEFRY64 = dict(modes=("uniform64", "randint64"), int_ops={4: 72 + 4, 5: 2 * 72 + 4 + 3 + 1 + 2},
                  int_ops_per_launch={5: 2 * 72}, f64_ops={4: 4, 5: 0}, out_bytes={4: 8, 5: 8})
ALL_MODES = THREEFRY["modes"] + THREEFRY64["modes"]
# `[random]`: bounds of the int64 randint held against its plain version,
# whose spans are 1, 2, 3, 6, 7, 120000, 2^32 - 1, 2^32, 2^32 + 1, 2^40 + 3,
# 2^63 - 1, 2^63 and 2^64 - 1.
RANDINT64_BOUNDS = ((4, 5), (5, 7), (-1, 2), (0, 6), (0, 7), (0, 120_000), (0, 2**32 - 1), (-2**31, 2**31),
                    (0, 2**32 + 1), (0, 2**40 + 3), (0, 2**63 - 1), (-2**62, 2**62), (-2**63, 2**63 - 1))
# `[random]` before / after: each mode, its arguments and its size, timed
# in turns with the trees of RPT_COMPARE.
THREEFRY_TURNS = (("keys", 1, {}), ("bits", None, {}), ("uniform", None, dict(lo=0.0, span=1.0)),
                  ("randint", None, dict(minval=0, maxval=6)), ("uniform64", None, dict(lo=0.0, span=1.0)),
                  ("randint64", None, dict(minval=0, maxval=6)))
# `[grad]`: the differentiable path (`rpt_tpu_torch.grad`) at the main
# path's size, per workload its bounces, the samples of its counted step,
# the walk family on its path and its shadow rays per path vertex; the
# material leaves differentiated; the card's gradient against the plain
# walks' on the card (the walks agree bit for bit, so bit for bit is
# expected under deterministic algorithms; else this share of the largest
# |g|), and against the CPU's at a small size (phase c's rtol, of the
# largest |g|).
GRAD_WORKLOADS = {
    "dragon": dict(bounces=2, spp=2, family="bvh8", shadow=2),
    "lego": dict(bounces=5, spp=2, family="tlas8", shadow=2),
}
# The material gradient through the other walks: the binary ones (compiled
# under RPT_BVH_KERNEL=binary) and the wide ones in float64. Each takes one
# step at GRAD_FAMILY_SIZE, 1 spp, GRAD_FAMILY_BOUNCES (the card tests'
# depth: each walk runs twice per vertex, and `lego`'s 5 would more than
# double the plain walks' share of the script's time), on the full scene,
# through the kernels and through the plain walks on the card (bit for bit
# under deterministic algorithms, or within GRAD_PLAIN_RTOL), its walks
# counted; and one at GRAD_FAMILY_SMALL (spp 1) on the 5,000-triangle
# trefoil or the 96-instance city, the card against the CPU within
# GRAD_CPU_RTOL (a third of `grad_small_phase`'s pixels and half its
# samples: the CPU's steps held the script's time). No timing turns.
GRAD_FAMILIES = {
    "dragon_bvh2": dict(scene="dragon", bvh_kernel="binary", family="bvh2", shadow=2),
    "lego_tlas2": dict(scene="lego", bvh_kernel="binary", family="tlas2", shadow=2),
    "dragon_bvh8_f64": dict(scene="dragon", bvh_kernel="wide", family="bvh8", shadow=2, dtype="float64"),
    "lego_tlas8_f64": dict(scene="lego", bvh_kernel="wide", family="tlas8", shadow=2, dtype="float64"),
}
GRAD_FAMILY_SIZE = (320, 180)
GRAD_FAMILY_SMALL = (32, 24)
GRAD_FAMILY_BOUNCES = 2
GRAD_FIELDS = ("color", "index", "roughness", "metallic", "emittance")
GRAD_TURNS = 5  # timed steps (and forwards without autograd); the median and the range are printed
GRAD_PLAIN_RTOL = 1e-5
GRAD_CPU_RTOL = 1e-3
# `[ode]`: one frame of `examples/marbles.py` (1/16 s at 1/10000: 624
# steps and a remainder) for 25 marbles of radius 0.15, and the bar of the
# card against the CPU: the CPU tests' bar of the port against the
# reference (`tests/test_torch_ode.py` TRAJ_ATOL).
ODE_FRAME, ODE_STEP = 1.0 / 16.0, 1.0 / 10000.0
ODE_CPU_ATOL = 1e-6
# `[dynamic]`: animation cells, each DYNAMIC_FRAMES frames through the
# dynamic path and the static path in turns, then one frame of another
# topology.
DYNAMIC_CELLS = {
    "dragon_orbit": dict(size=(WIDTH, HEIGHT), bounces=2, spp=2, family="bvh8", shadow=2),
    "marbles": dict(size=(800, 600), bounces=9, spp=2, family=None),
    # The other walks at a small size, 4 frames each: the 5,000-triangle
    # trefoil under the orbiting light through bvh2 (RPT_BVH_KERNEL=binary)
    # and through bvh8 in float64 (the wide threshold lowered below its
    # rows), and the 96-instance brick city, every instance moved by one
    # offset a frame (the TLAS keeps its shape), through tlas2.
    "orbit_bvh2": dict(size=(SMALL_W, SMALL_H), bounces=2, spp=2, family="bvh2", shadow=2, frames=4,
                       bvh_kernel="binary"),
    "city_tlas2": dict(size=(SMALL_W, SMALL_H), bounces=2, spp=2, family="tlas2", shadow=2, frames=4,
                       bvh_kernel="binary"),
    "orbit_bvh8_f64": dict(size=(SMALL_W, SMALL_H), bounces=2, spp=2, family="bvh8", shadow=2, frames=4,
                           dtype="float64", wide_min=4096),
}
DYNAMIC_FRAMES = 8
# `[sharded]`: the sharded render (`rpt_tpu_torch.parallel`) of `dragon`
# at the main path's size, bounces and samples, its pixels split over
# meshes of SHARDED_MESHES shards of the one card (7 pads 518,400 pixels
# by 6), each timed in SHARDED_TURNS turns beside `render_buffer`;
# `[multihost]`: MULTIHOST_PROCS processes of MULTIHOST_SHARDS shards each
# on the card over gloo (NCCL puts no two processes on one card);
# `[sharded_grad]`: the sharded material gradient on SHARDED_GRAD_SHARDS.
SHARDED = dict(workload="dragon", bounces=2, spp=4, shadow=2, family="bvh8")
SHARDED_MESHES = (1, 2, 4, 7)
SHARDED_TURNS = 3
MULTIHOST_PROCS, MULTIHOST_SHARDS = 2, 2
MULTIHOST_TIMEOUT = 300
# `[multihost_grad]`: the processes' gradient against the in-process one,
# over max|g| per leaf: the processes add their parts in rank order, the
# in-process step its shards in autograd's order.
MULTIHOST_GRAD_RTOL = 1e-6
SHARDED_GRAD_SHARDS = 4


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, inputs, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of one call, on CUDA events, over `reps` passes
    through `inputs` (after one warm-up pass unless the caller made one)."""
    import torch

    if warmup:
        for args in inputs:
            fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in inputs:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


def time_graph_ms(fn, inputs, reps: int) -> float:
    """Device milliseconds of one call: `reps` passes through `inputs`
    captured as one CUDA graph (after an eager warm-up pass) and replayed
    between CUDA events, so the host's launch cost is left out."""
    import torch

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for args in inputs:
                fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


def record_wavefronts(names, render):
    """Run `render()` and return the rays it handed the counted wrappers of
    the kernels `names` (`<family>_closest`, `<family>_occluded`), as they
    reach the dispatch of `ops/walk.py`: {name: [(o, d, t_min[, t_max],
    active), ...]}."""
    from rpt_tpu_torch.ops import walk

    rec = {name: [] for name in names}
    closest_hit, occluded = walk.closest_hit, walk.occluded

    def closest_rec(wrapper, geometry, pack, o, d, t_min, active=None):
        rec.get(f"{pack.library}_closest", []).append((o, d, t_min, active))
        return closest_hit(wrapper, geometry, pack, o, d, t_min, active)

    def occluded_rec(wrapper, pack, o, d, t_min, t_max, active=None):
        rec.get(f"{pack.library}_occluded", []).append((o, d, t_min, t_max, active))
        return occluded(wrapper, pack, o, d, t_min, t_max, active)

    walk.closest_hit, walk.occluded = closest_rec, occluded_rec
    try:
        render()
    finally:
        walk.closest_hit, walk.occluded = closest_hit, occluded
    return rec


def replay_fn(renderer):
    """One sample through the renderer's cached graph alone: the replay,
    without the entry point's per-call host work (the compile cache's
    digest, the buffer)."""
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.renderer import make_render_many_fn

    sd, t_min, ev_scale = renderer._pass_args()
    fn = make_render_many_fn(sd, renderer.width, renderer.height, renderer.max_bounces)
    key = renderer.base_key()
    return lambda: fn(renderer.camera, key, 0, 1, t_min, ev_scale)


def profile_sample(render, kernel_tag, mode: str, workload: str, unprofiled=None):
    """Where one main-path sample spends the card's time, run as `mode`
    says (through the graph or eagerly): device-busy share of the profiled
    window, idle share, kernels launched, the share of device time of the
    kernels whose name holds `kernel_tag` (none when None), and the
    heaviest kernels. Reads CUDA kernel events from torch.profiler; prints
    'not measured' if it records none. With `unprofiled`, also the wall
    milliseconds of one call of it timed without the profiler (the mean of
    8, after one), and the idle share against that wall. Returns how many
    times the profiler saw each counted kernel run ({name: n} as the
    `kernels` line names them; threefry all modes), or None if it saw no
    kernel."""
    extra = {}
    if unprofiled is not None:
        extra["unprofiled_ms"] = wall_ms(unprofiled)

    wall_us, busy, kernels = profiled(render)
    if not kernels:
        say("profile", workload=workload, mode=mode,
            device_time="not measured (the profiler recorded no CUDA kernels)")
        return None
    by_name = device_us_by_name(kernels)
    total = sum(by_name.values())
    gemv_us = sum(v for k, v in by_name.items() if "gemv" in k.lower())
    threefry_us = sum(v for k, v in by_name.items() if "threefry" in k)
    shares = {}
    if kernel_tag is not None:
        shares[f"{kernel_tag}_share_of_device_time"] = f"{sum(v for k, v in by_name.items() if kernel_tag in k) / total:.3f}"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if extra:
        extra = dict(unprofiled_ms=f"{extra['unprofiled_ms']:.3f}",
                     idle_share_unprofiled=f"{max(0.0, 1.0 - busy / 1e3 / extra['unprofiled_ms']):.3f}")
    say("profile", workload=workload, mode=mode, window_ms=f"{wall_us / 1e3:.2f}", device_busy_ms=f"{busy / 1e3:.2f}",
        idle_share=f"{1.0 - busy / wall_us:.3f}", kernel_launches=len(kernels), gemv_ms=f"{gemv_us / 1e3:.3f}",
        threefry_share_of_device_time=f"{threefry_us / total:.3f}", **shares, **extra)
    for name, us in top:
        say("profile", workload=workload, mode=mode, kernel=json.dumps(name), device_ms=f"{us / 1e3:.3f}",
            share=f"{us / total:.3f}")
    seen = {}
    for e in kernels:
        name = counted_kernel(e.name)
        if name is not None:
            seen[name] = seen.get(name, 0) + 1
    return seen


def wall_ms(fn, reps: int = 8) -> float:
    """Mean wall milliseconds of one call of `fn` without the profiler,
    over `reps` calls after one, ending in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profiled(fn):
    """(wall us, device-busy us, CUDA kernel events) of one call of `fn`
    under torch.profiler, ending in a synchronize; busy is the union of the
    kernels' spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall_us, busy, kernels


def device_us_by_name(kernels) -> dict:
    """{short kernel name: device microseconds} of profiler kernel events."""
    by_name = {}
    for e in kernels:
        # "void (anonymous namespace)::tlas8_walk<false>(float4 const*, ...)" -> "tlas8_walk<false>"
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0][-60:]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return by_name


def counted_kernel(symbol: str):
    """The launch counter's name of a profiled kernel of csrc/: "threefry"
    for the threefry kernel's 32-bit modes, "threefry64" for its 64-bit ones
    (modes 4 and 5), `<family>_closest` / `_occluded` for either real type
    of a walk (`<family>_walk<kOccl, ...>`, `<family>_walk_f64<kOccl>`, or
    `..., double>`; a wrapper counts both types), "scatter" for the scatter
    kernel of either type, or None."""
    if "scatter_kernel<" in symbol:
        return "scatter"
    if "threefry_kernel<" in symbol:
        mode = "".join(c for c in symbol.split("threefry_kernel<", 1)[1].split(">", 1)[0] if c.isdigit())
        return "threefry64" if mode in ("4", "5") else "threefry"
    for family in ("bvh8", "tlas8", "bvh2", "tlas2"):
        for tag in (f"{family}_walk<", f"{family}_walk_f64<"):
            if tag in symbol:
                occl = symbol.split(tag, 1)[1].startswith("true")
                return f"{family}_occluded" if occl else f"{family}_closest"
    return None


def active_share(o, active) -> str:
    """The share of a wavefront's rays that are still walking."""
    return "1.0000000" if active is None else f"{active.float().mean().item():.7f}"


def plain_pass(plain, args, run):
    """`plain(*args)`; with `run` ({"stats": {}, "ms": []}), the plain walk
    also counts its box and triangle tests into run["stats"] and its
    milliseconds on CUDA events go to run["ms"] (phase f reads both, so the
    walk runs once per wavefront)."""
    import torch

    if run is None:
        return plain(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = plain(*args, stats=run["stats"])
    end.record()
    torch.cuda.synchronize()
    run["ms"].append(start.elapsed_time(end))
    return out


def check_closest(name, rays, kern, plain, mat_of, o, d, t_min, active, run=None) -> float:
    """Kernel vs plain closest hit; returns the largest |t| difference.
    `mat_of(outputs, hit mask)` gives the material ids of the hits; an
    instance id, where the kernel returns one, must agree too, and every
    output must be equal bit for bit. `run`: see `plain_pass`."""
    import torch

    out_k = kern(o, d, t_min, active)
    out_p = plain_pass(plain, (o, d, t_min, active), run)
    torch.cuda.synchronize()
    t_k, t_p = out_k[0], out_p[0]
    hit_k, hit_p = t_k < 1e38, t_p < 1e38
    agree = (hit_k == hit_p).float().mean().item()
    both = hit_k & hit_p
    err = (t_k[both] - t_p[both]).abs().max().item() if bool(both.any()) else 0.0
    t_ok = bool(torch.allclose(t_k[both], t_p[both], rtol=T_TOL, atol=T_TOL))
    mat_ok = bool((mat_of(out_k, both) == mat_of(out_p, both)).all())
    inst_ok = len(out_k) < 3 or bool((out_k[2][both] == out_p[2][both]).all())
    bit_equal = all(torch.equal(x, y) for x, y in zip(out_k, out_p))
    say("parity", kernel=name, rays=rays, n=o.shape[0], active_share=active_share(o, active), hits=int(hit_p.sum()),
        mask_agree=f"{agree:.7f}", max_abs_t_err=err, mat_ok=mat_ok, bit_equal=bit_equal,
        **({} if len(out_k) < 3 else {"inst_ok": inst_ok}))
    if agree < PARITY_MIN or not t_ok or not mat_ok or not inst_ok or not bit_equal:
        fail(f"{name} kernel disagrees with its plain version on {rays}")
    return err


def check_occluded(name, rays, kern, plain, closest_plain, o, d, t_min, t_max, active, run=None) -> float:
    """Kernel vs plain any-hit; the kernel vs the closest-hit rule (a hit
    with t <= t_max), and what the wrapper makes of its answer
    (`finish_occluded`) vs the rule t <= t_max; returns
    the share of rays where kernel and plain version disagree, which must
    be none. `run`: see `plain_pass`."""
    import torch

    from rpt_tpu_torch.ops.walk import finish_occluded

    occ_k = kern(o, d, t_min, t_max, active)
    occ_p = plain_pass(plain, (o, d, t_min, t_max, active), run)
    t_p = closest_plain(o, d, t_min, active)[0]
    torch.cuda.synchronize()
    # t_p is 3e38 on a miss. The kernel answers whether a hit lies within
    # t_max: for a directional light's t_max of +inf, a hit at any distance.
    # The wrapper (`finish_occluded`) also counts a ray with t_max = +inf
    # as occluded (inf <= inf, as the reference) whatever the walk found.
    rule = (t_p < 1e38) & (t_p <= t_max)
    finished = t_p <= t_max
    if active is not None:
        rule, finished = rule & active, finished & active
    disagree = (occ_k != occ_p).float().mean().item()
    agree_rule = (occ_k == rule).float().mean().item()
    agree_finished = (finish_occluded(occ_k, t_max, active) == finished).float().mean().item()
    say("parity", kernel=name, rays=rays, n=o.shape[0], active_share=active_share(o, active), occluded=int(occ_p.sum()),
        agree_plain=f"{1.0 - disagree:.7f}", agree_closest_rule=f"{agree_rule:.7f}",
        agree_finished_rule=f"{agree_finished:.7f}")
    if agree_rule < PARITY_MIN or agree_finished < PARITY_MIN or disagree > 0.0:
        fail(f"{name} kernel disagrees on {rays}")
    return disagree


def run_workload(workload: str, card: str):
    """Phases a-h of one workload, compiled under its RPT_BVH_KERNEL choice
    (restored after); returns its traversal kernels' rows of the `kernels`
    line, its threefry launches per main-path sample, its main path's
    threefry launches by mode and its main path's launches by counter."""
    t0 = time.perf_counter()
    try:
        with kernel_choice(WORKLOADS[workload]["bvh_kernel"]):
            return _run_workload(workload, card)
    finally:
        say("workload", name=workload, phase_seconds=f"{time.perf_counter() - t0:.1f}")


def fresh(renderer):
    from rpt_tpu_torch import Buffer

    return Buffer.new(renderer.width, renderer.height, device=renderer.device, dtype=renderer.dtype)


def named_counts(counters: dict) -> dict:
    """{name: launches} of the counted wrappers `counters` ({name:
    wrapper}), as the devices counted them since the last reset."""
    from rpt_tpu_torch import kernels

    counts = kernels.launch_counts()
    return {name: counts[fn] for name, fn in counters.items()}


def graph_phase(workload: str, renderer, spp: int, card: str, counters: dict) -> dict:
    """`[graph]`: `spp` samples through the captured graph against the same
    samples run eagerly, and in two chunks against one call, `sum` and
    `sum_sq` bit for bit; prints the capture's seconds and memory pool.
    One eager pass and one replay are each counted on the device, from 0:
    they must launch the same kernels as often. Returns those launches."""
    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch.renderer import make_render_many_fn

    graphed = renderer.sample_into(fresh(renderer), spp)  # captures the graph
    kernels.reset_launch_counts()
    eager = renderer._sample_into_eager(fresh(renderer), 1)
    eager_launches = named_counts(counters)
    eager = renderer._sample_into_eager(eager, spp - 1, start_iter=1)
    kernels.reset_launch_counts()
    first = renderer.sample_into(fresh(renderer), 1)
    per_replay = named_counts(counters)
    chunked = renderer.sample_into(first, spp - 1, start_iter=1)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(getattr(graphed, name), getattr(other, name)))
            for name, other in (("sum", eager), ("sum_sq", eager))}
    chunk_same = bool(torch.equal(graphed.sum, chunked.sum) and torch.equal(graphed.sum_sq, chunked.sum_sq))
    sd, t_min, _ = renderer._pass_args()
    cap = make_render_many_fn(sd, renderer.width, renderer.height, renderer.max_bounces).capture(t_min)
    say("graph", workload=workload, size=f"{renderer.width}x{renderer.height}", spp=spp,
        sum_bit_equal=same["sum"], sum_sq_bit_equal=same["sum_sq"], chunked_bit_equal=chunk_same,
        max_abs_sum_diff=float((graphed.sum - eager.sum).abs().max()), capture_seconds=f"{cap.seconds:.3f}",
        pool_mib=f"{cap.pool_bytes / 2**20:.1f}", launches_per_replay=json.dumps(per_replay),
        launches_per_eager_pass=json.dumps(eager_launches),
        reserved_mib=f"{torch.cuda.memory_reserved() / 2**20:.1f}", card=json.dumps(card))
    if not (same["sum"] and same["sum_sq"] and chunk_same):
        fail(f"the graphed {workload} render differs from the eager one or from itself in chunks")
    if per_replay != eager_launches or per_replay["threefry"] <= 0:
        fail(f"one {workload} replay launched {per_replay}, one eager pass {eager_launches}")
    return per_replay


def counted_wrappers() -> dict:
    """{name: wrapper} of every counted kernel: the threefry draws (32- and
    64-bit modes), the scatter step and each walk family's closest and any
    hit."""
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.ops import scatter

    counters = {"threefry": rnd._threefry, "threefry64": rnd._threefry64, "scatter": scatter.scatter}
    for fam in ("bvh8", "tlas8", "bvh2", "tlas2"):
        mod = family_module(fam)
        counters[f"{fam}_closest"] = getattr(mod, f"{fam}_closest_hit")
        counters[f"{fam}_occluded"] = getattr(mod, f"{fam}_occluded")
    return counters


def _run_workload(workload: str, card: str):
    import numpy as np
    import torch

    from rpt_tpu_torch import Renderer, integrator, kernels
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.scenes import scene_and_camera

    spec_w = WORKLOADS[workload]
    bounces, spp, shadow, family = spec_w["bounces"], spec_w["spp"], spec_w["shadow"], spec_w["family"]
    dtype = getattr(torch, spec_w.get("dtype", "float32"))
    counters = counted_wrappers()
    # The table's two lane counts (the shadow wavefront's) are no launches.
    lanes = {integrator.shadow_lanes, integrator.shadow_live_lanes}
    if set(counters.values()) | lanes != set(kernels.launch_counts()):
        fail("the counted wrappers are not the ones this script reads")

    # a. Compile, under the workload's kernel choice.
    t0 = time.perf_counter()
    scene, camera, eps = scene_and_camera(spec_w["scene"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sd = scene.compile(dtype, device=DEVICE)
    seconds = time.perf_counter() - t0
    for w in caught:
        say("compile", workload=workload, warning=json.dumps(str(w.message)))
        if "falling back" in str(w.message):
            fail(f"{workload}'s wide pack was refused: {w.message}")
    width, height = spec_w.get("size", (WIDTH, HEIGHT))
    ev = spec_w.get("ev", 0.0)
    renderer = Renderer(scene, camera, width=width, height=height, exposure_value=ev, max_bounces=bounces,
                        num_samples=1, epsilon=eps, device=DEVICE, dtype=dtype)
    if sd.dtype != dtype:
        fail(f"{workload} compiled in {sd.dtype}, not {dtype}")
    rows = []
    if family is None:
        say("compile", workload=workload, spheres=0 if sd.spheres is None else sd.spheres.inv_tf.shape[0],
            cubes=0 if sd.cubes is None else sd.cubes.inv_tf.shape[0],
            monomials=0 if sd.monomials is None else sd.monomials.height.shape[0],
            triangles=0 if sd.triangles is None else sd.triangles.verts.shape[0],
            packs=[pack.library for pack in sd.packs], lights=len(sd.lights),
            hdri="none" if sd.env_hdri is None else "x".join(map(str, sd.env_hdri.shape)),
            quad_mb="none" if sd.env_quad is None else f"{sd.env_quad.numel() * 4 / 1e6:.1f}",
            dtype=str(sd.dtype), seconds=f"{seconds:.2f}")
        if sd.packs:
            fail(f"{workload} compiled with a traversal pack")
    else:
        err, rec, runs = kernel_phases(workload, family, sd, renderer, camera, seconds, card)

    # c. The port on the CPU against the port on the card, same seed.
    small = {}
    for dev in ("cpu", DEVICE):
        r = Renderer(scene, camera, width=SMALL_W, height=SMALL_H, exposure_value=ev, max_bounces=bounces,
                     num_samples=1, epsilon=eps, device=dev, dtype=dtype)
        small[dev] = r.render_buffer().mean_image().cpu().numpy()
    a, b = small["cpu"], small[DEVICE]
    close = np.isclose(b, a, rtol=1e-3, atol=1e-4).all(-1).mean()
    mean_rel = abs(float(b.mean()) - float(a.mean())) / max(abs(float(a.mean())), 1e-12)
    bar = spec_w.get("cpu_share", 0.99)
    say("cpu_vs_card", workload=workload, size=f"{SMALL_W}x{SMALL_H}", pixels_close=f"{close:.5f}", bar=bar,
        mean_rel=f"{mean_rel:.3e}")
    if not (np.isfinite(b).all() and close >= bar and mean_rel <= 1e-3):
        fail(f"the CPU and card renders of {workload} disagree")
    if "cpu_share" in spec_w:
        same_rays_phase(workload, scene, camera, eps, bounces, dtype)

    # The graph against the eager pass (this also captures the main path's graph).
    per_replay = graph_phase(workload, renderer, 2, card, counters)

    # d. The main path at full size: a warm-up sample, then every counter
    # to 0, drive, read (the kernels count their launches on the card).
    renderer.render_buffer()
    torch.cuda.synchronize()
    renderer.num_samples = spp
    before_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    buf = renderer.render_buffer()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = named_counts(counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    peak_reserved_mib = torch.cuda.max_memory_reserved() / 2**20
    by_slot = kernels.launch_counts(by_slot=True)
    threefry_by_mode = dict(zip(ALL_MODES, by_slot[rnd._threefry] + by_slot[rnd._threefry64]))
    img = buf.mean_image()
    rays = (bounces + 1) * (1 + shadow) * width * height * spp
    # The same samples eagerly and through the graph again, in turns.
    turns = {"graph": [dt], "eager": []}
    for mode in ("eager", "eager", "graph"):
        t0 = time.perf_counter()
        if mode == "graph":
            renderer.render_buffer()
        else:
            renderer._sample_into_eager(fresh(renderer), spp)
        torch.cuda.synchronize()
        turns[mode].append(time.perf_counter() - t0)
    mrays = {m: rays / (sum(v) / len(v)) / 1e6 for m, v in turns.items()}
    say("main_path", workload=workload, size=f"{width}x{height}", bounces=bounces, spp=spp, seconds=f"{dt:.4f}",
        mrays_per_s=f"{rays / dt / 1e6:.3f}", peak_mib=f"{peak_mib:.1f}", allocated_before_mib=f"{before_mib:.1f}",
        peak_reserved_mib=f"{peak_reserved_mib:.1f}", image_mean=f"{float(img.mean()):.6f}",
        launches=json.dumps(launches), threefry_launches_by_mode=json.dumps(threefry_by_mode), card=json.dumps(card))
    say("main_path", workload=workload, mode="turns graph, eager, eager, graph",
        graph_seconds=json.dumps([round(t, 5) for t in turns["graph"]]),
        eager_seconds=json.dumps([round(t, 5) for t in turns["eager"]]),
        graph_mrays_per_s=f"{mrays['graph']:.3f}", eager_mrays_per_s=f"{mrays['eager']:.3f}",
        graph_over_eager=f"{mrays['graph'] / mrays['eager']:.3f}", card=json.dumps(card))
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        fail(f"the {workload} main-path image is not finite or is black")
    # One replay per sample, each launching what one eager pass launched.
    want = {name: 0 for name in counters}
    want["threefry"] = per_replay["threefry"] * spp
    want["threefry64"] = per_replay["threefry64"] * spp
    # The scatter kernel once a depth below max_bounces.
    want["scatter"] = bounces * spp
    if family is not None:
        want[f"{family}_closest"] = (bounces + 1) * spp
        want[f"{family}_occluded"] = shadow * (bounces + 1) * spp
    if launches != want or want["threefry"] <= 0:
        fail(f"the {workload} main path launched {launches}, not {want}")
    # A float32 render launches only float32 kernels and draws, a float64
    # one only float64 kernels and 64-bit draws (its keys stay 32-bit): no
    # kernel of the other type stands in.
    slot = 0 if dtype == torch.float32 else 1
    other = {name: by_slot[fn][1 - slot] for name, fn in counters.items()
             if name.endswith(("closest", "occluded")) or name == "scatter"}
    draws = dict(uniform=threefry_by_mode["uniform"], randint=threefry_by_mode["randint"],
                 uniform64=threefry_by_mode["uniform64"], randint64=threefry_by_mode["randint64"])
    wrong_draws = draws["uniform64"] + draws["randint64"] if slot == 0 else draws["uniform"] + draws["randint"]
    if any(other.values()) or wrong_draws or (draws["uniform64"] if slot else draws["uniform"]) <= 0:
        fail(f"the {workload} ({dtype}) main path launched kernels of the other type: {other}, draws {draws}")
    if slot:
        f64_vs_f32_mrays(workload, scene, camera, eps, renderer, rays, card)
    renderer.num_samples = 1
    tag = None if family is None else family + "_walk"
    profile_sample(renderer.render_buffer, tag, "graph", workload)
    replay_one = replay_fn(renderer)
    seen = profile_sample(replay_one, tag, "graph_replay", workload, unprofiled=replay_one)
    # The profiler's own count of the kernels one replay ran, by name: a
    # witness that can lose records (CUPTI drops a few of a replay's
    # thousands in some runs), never gain them. So it must not exceed the
    # card's count, and must see every kernel the card counted.
    if seen is not None:
        missed = sum(per_replay.values()) - sum(seen.values())
        say("profile", workload=workload, mode="graph_replay", counted_kernels_seen=json.dumps(seen),
            counted_on_device=json.dumps(per_replay), profiler_missed=missed)
        if any(n > per_replay[name] for name, n in seen.items()) or \
                any(n and not seen.get(name) for name, n in per_replay.items()):
            fail(f"the profiler saw one {workload} replay run {seen}, the device counted {per_replay}")
    profile_sample(lambda: renderer._sample_into_eager(fresh(renderer), 1), tag, "eager", workload)
    if sd.monomials is not None:
        monomial_share(workload, renderer, card)
    if family is not None:
        rows = timing_phase(workload, family, sd, rec, runs, err, launches, spp, card, scene)
    if workload in COMPACT_WORKLOADS:
        by_kernel = compact_phase(workload, family, renderer, card, counters)
        for row in rows:
            row.update(by_kernel[row["name"]])
    return rows, launches["threefry"] / spp, threefry_by_mode, launches


def same_rays_phase(workload, scene, camera, eps, bounces, dtype) -> None:
    """`[cpu_vs_card]` of a workload whose card image is held to a lower
    share (`cpu_share`): where the two devices part. The camera rays of one
    small pass made on each (the share bit for bit, the largest difference
    of a direction, and cot(fov / 2), the one transcendental in them); then
    the CPU's rays on both devices: depth-0 hit masks, materials and `t`,
    and each ray's radiance at the workload's bounces, which must agree to
    the port's bar on at least 0.99 of the rays."""
    import numpy as np
    import torch

    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.integrator import trace_paths
    from rpt_tpu_torch.renderer import camera_rays_tiled, pixel_ndc_tiled
    from rpt_tpu_torch.utils.vmath import real_value

    key = rnd.fold_in(rnd.PRNGKey(0, x64=dtype == torch.float64), 0)
    rays, cot = {}, {}
    for dev in ("cpu", DEVICE):
        cam = camera.to(dev)
        o, d, _ = camera_rays_tiled(cam, key, pixel_ndc_tiled(SMALL_W, SMALL_H, dev, dtype))
        rays[dev] = (o.cpu(), d.cpu())
        cot[dev] = float((1.0 / torch.tan(cam.fov / 2.0)).cpu())
    (o, d), d_card = rays["cpu"], rays[DEVICE][1]
    t_min = real_value(eps, dtype)
    hits, radiance = {}, {}
    for dev in ("cpu", DEVICE):
        sd = scene.compile(dtype, device=dev)
        h = sd.intersect(o.to(dev), d.to(dev), t_min)
        hits[dev] = (h.t.cpu(), h.mat_id.cpu())
        radiance[dev] = trace_paths(sd, o.to(dev), d.to(dev), rnd.PRNGKey(3), bounces, t_min).cpu().numpy()
    (t_c, m_c), (t_d, m_d) = hits["cpu"], hits[DEVICE]
    hit_c, hit_d = torch.isfinite(t_c), torch.isfinite(t_d)
    both = hit_c & hit_d
    rays_close = np.isclose(radiance[DEVICE], radiance["cpu"], rtol=1e-3, atol=1e-4).all(-1).mean()
    say("cpu_vs_card", workload=workload, rays=o.shape[0],
        camera_dirs_bit_equal=f"{bool(torch.equal(rays['cpu'][0], rays[DEVICE][0]))}/"
                              f"{(d_card == d).all(-1).float().mean().item():.5f}",
        camera_dir_max_abs_diff=f"{(d_card - d).abs().max().item():.3e}",
        cot_half_fov_cpu=repr(cot["cpu"]), cot_half_fov_card=repr(cot[DEVICE]),
        same_rays_hit_mask_agree=f"{(hit_c == hit_d).float().mean().item():.5f}",
        same_rays_mat_agree=f"{(m_c[both] == m_d[both]).float().mean().item():.5f}",
        same_rays_t_bit_equal=f"{(t_c[both] == t_d[both]).float().mean().item():.5f}",
        same_rays_radiance_close=f"{rays_close:.5f}")
    if rays_close < 0.99:
        fail(f"the CPU and the card trace the same {workload} rays apart")


def kernel_phases(workload, family, sd, renderer, camera, seconds, card):
    """Phases a (sizes), b (parity on every wavefront of an eager 1-spp
    render), g and h of a workload with a traversal pack; returns (the
    largest errors, the recorded wavefronts, each kernel's plain walk on
    them: its counts and milliseconds, `plain_pass`)."""
    import torch

    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.renderer import camera_rays_tiled, pixel_ndc_tiled
    from rpt_tpu_torch.utils.vmath import real_value

    closest, occluded = f"{family}_closest", f"{family}_occluded"
    bounces, shadow = WORKLOADS[workload]["bounces"], WORKLOADS[workload]["shadow"]
    mod = family_module(family)
    plain = {closest: getattr(mod, f"{family}_closest_plain"), occluded: getattr(mod, f"{family}_occluded_plain")}
    pack = pack_of(sd, family)
    if pack is None:
        fail(f"{workload} compiled without a {family} pack")
    sizes = dict(nodes=pack.num_nodes, **{k: getattr(pack, k) for k in ("stack_need", "group_depth", "stack_depth",
                                                                        "node_bytes") if hasattr(pack, k)},
                 materials=sd.materials.color.shape[0], pack_bytes=pack.nbytes, pack_mb=f"{pack.nbytes / 2**20:.3f}",
                 dtype=str(pack.tris.dtype), seconds=f"{seconds:.2f}")
    mat_of = material_of(family, sd, pack)
    if family in ("bvh8", "bvh2"):
        bvh = sd.bvh
        say("compile", workload=workload, tri_rows=bvh.num_tris, binary_nodes=bvh.num_nodes, **sizes)
    else:
        im = sd.instanced
        say("compile", workload=workload, instances=im.inst_inv.shape[0],
            unique_meshes=len(set(im.inst_root.tolist())), unique_tris=im.verts.shape[0],
            tlas_nodes=im.t_min.shape[0], blas_nodes=im.b_min.shape[0], tri_rows=pack.tris.shape[0], **sizes)

    def bound(name):
        return kernel_of(mod, name, pack)

    def bound_plain(name):
        return lambda *a, **kw: plain[name](pack, *a, **kw)

    # b. Kernel parity at main-path size: the camera rays, then every
    # wavefront of an eager 1-spp render (a graph replay calls no Python
    # wrapper to record). Every kernel runs its plain walk's float
    # operations in its order: it must equal it bit for bit.
    t_min = real_value(renderer.epsilon, sd.dtype)
    x64 = str(sd.dtype) == "torch.float64"
    o, d, _ = camera_rays_tiled(camera.to(DEVICE), rnd.fold_in(rnd.PRNGKey(0, x64=x64), 0),
                                pixel_ndc_tiled(renderer.width, renderer.height, DEVICE, sd.dtype))
    check_closest(closest, "camera", bound(closest), bound_plain(closest), mat_of, o, d, t_min, None)
    rec = record_wavefronts((closest, occluded), lambda: renderer._sample_into_eager(fresh(renderer), 1))
    n_closest, n_occluded = len(rec[closest]), len(rec[occluded])
    if n_closest != bounces + 1 or n_occluded != shadow * (bounces + 1):
        fail(f"a 1-spp {workload} render made {n_closest} closest-hit and {n_occluded} any-hit calls")
    err = {closest: 0.0, occluded: 0.0}
    runs = {closest: {"stats": {}, "ms": []}, occluded: {"stats": {}, "ms": []}}
    for depth, args in enumerate(rec[closest]):
        err[closest] = max(err[closest], check_closest(closest, f"depth{depth}", bound(closest), bound_plain(closest),
                                                       mat_of, *args, run=runs[closest]))
    for j, args in enumerate(rec[occluded]):
        err[occluded] = max(err[occluded], check_occluded(occluded, f"shadow{j}", bound(occluded), bound_plain(occluded),
                                                          bound_plain(closest), *args, run=runs[occluded]))
    if shadow == 0:
        # No light casts a shadow ray, so the any hit is held (and timed)
        # on the camera wavefront, at kernel_gate's t_max: the plain
        # closest t (1e3 on a miss), halved on every other ray.
        t_p = plain[closest](pack, o, d, t_min, None)[0]
        t_max = torch.where(t_p < 1e38, t_p, torch.full_like(t_p, 1e3))
        t_max[1::2] *= 0.5
        rec[occluded] = [(o, d, t_min, t_max, None)]
        err[occluded] = check_occluded(occluded, "camera", bound(occluded), bound_plain(occluded),
                                       bound_plain(closest), *rec[occluded][0], run=runs[occluded])
    if workload in ("dragon_binary", "lego_binary"):
        binary_vs_wide(family, sd, pack, rec, mat_of, card)
    before_after(family, mod, sd.bvh if family in ("bvh8", "bvh2") else sd.instanced, pack, rec, mat_of, card)
    if workload in OCCUPANCY_WORKLOADS:
        occupancy_phase(workload, family, pack.group_depth if family in ("bvh8", "tlas8") else pack.stack_depth, card)
    return err, rec, runs


def family_module(family):
    from rpt_tpu_torch.ops import bvh2, bvh8, tlas2, tlas8

    return {"bvh8": bvh8, "tlas8": tlas8, "bvh2": bvh2, "tlas2": tlas2}[family]


def pack_of(sd, family):
    """The compiled scene's pack of `family`, or None."""
    return next((pack for pack in sd.packs if pack.library == family), None)


def kernel_of(mod, name, pack):
    """The kernel `name` (`<family>_closest` or `_occluded`) over `pack`,
    called with the rays as the wrappers take them, (o, d, t_min[, t_max],
    active), in the tree whose `ops.<family>` is `mod`: its `walk.launch`,
    or in a tree from before `ops/walk.py` its `<name>_kernel`. These
    launches are comparisons: they pass no launch counter."""
    old = getattr(mod, f"{name}_kernel", None)
    if old is not None:
        return lambda *a: old(pack, *a)
    launch = importlib.import_module(f"{mod.__package__}.walk").launch
    if name.endswith("_closest"):
        return lambda o, d, t_min, active=None: launch(pack, o, d, t_min, active=active)
    return lambda o, d, t_min, t_max, active=None: launch(pack, o, d, t_min, t_max, active)


def material_of(family, sd, pack):
    """`mat_of(outputs, hit mask)`: the material ids of a closest-hit walk's hits."""
    if family in ("bvh8", "bvh2"):
        bvh = sd.bvh
        return lambda out, hit: bvh.mat_id[out[1].long().clamp(0, bvh.num_tris - 1)][hit]
    im = sd.instanced
    return lambda out, hit: im.inst_mat[out[2].long().clamp(0, im.inst_mat.shape[0] - 1)][hit]


def timing_phase(workload, family, sd, rec, runs, err, launches, spp, card, scene) -> list:
    """f. Each kernel at the main path's shapes (the wavefronts of b): time
    per launch, the plain version's time and counts (phase b's pass over
    the same wavefronts, `runs`), and the bound. A float64
    workload's rows are its kernels' float64 instantiations (`<name>_f64`,
    their triangle tests and instance entries bound by FP64), each also
    timed against its float32 twin on the same wavefronts rounded to
    float32, over the float32 pack of the same scene, in turns (f32, f64,
    f64, f32) inside CUDA graphs."""
    import torch

    mod = family_module(family)
    pack = pack_of(sd, family)
    f64 = pack.tris.dtype == torch.float64
    rows = []
    for kind in ("closest", "occluded"):
        name = f"{family}_{kind}"
        spec = KERNELS_F64[f"{name}_f64"] if f64 else KERNELS[name]
        args = rec[name]
        kern, plain = kernel_of(mod, name, pack), getattr(mod, f"{name}_plain")
        ms = time_ms(kern, args, reps=10)
        graph_ms = time_graph_ms(kern, args, reps=10)
        # Phase b's pass of the plain version over these wavefronts, timed,
        # with its box and triangle tests counted.
        stats = runs[name]["stats"]
        plain_ms = sum(runs[name]["ms"]) / len(runs[name]["ms"])
        # Box tests at the float rate (bound_ms), triangle tests and
        # instance entries at the rate of the walk's type.
        t_bytes, t_ops = bound_ms(spec, pack, args, stats, PEAK_F64_OPS if f64 else PEAK_F32_OPS)
        rows.append({
            "name": f"{name}_f64" if f64 else name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name], "max_abs_err": err[name], "ms": ms,
            "graph_ms": graph_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "workload": workload, "dtype": str(pack.tris.dtype).removeprefix("torch."),
            "launches_per_sample": launches[name] / spp,
            "box_tests_per_launch": stats["box_tests"] / len(args),
            "tri_tests_per_launch": stats["tri_tests"] / len(args),
            "inst_entries_per_launch": stats.get("inst_entries", 0) / len(args),
        })
        rows[-1].update({k: getattr(pack, k) for k in ("group_depth", "stack_depth", "node_bytes") if hasattr(pack, k)})
        rows[-1].update({f"walk_{k}": v for k, v in stats.items() if k.startswith("max_")})
        rows[-1]["pack_mb"] = pack.nbytes / 2**20
        extra = {}
        if f64:
            pack32 = pack_of(scene.compile(torch.float32, device=DEVICE), family)
            args32 = [tuple(a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args_)
                      for args_ in args]
            turns = {"f32": [], "f64": []}
            for label in ("f32", "f64", "f64", "f32"):
                p, a = (pack32, args32) if label == "f32" else (pack, args)
                turns[label].append(time_graph_ms(kernel_of(mod, name, p), a, reps=10))
            f32_ms, f64_ms = (sum(turns[k]) / 2 for k in ("f32", "f64"))
            stats32 = {}
            for a in args32:
                plain(pack32, *a, stats=stats32)
            bound32 = max(bound_ms(KERNELS[name], pack32, args32, stats32, PEAK_F32_OPS))
            rows[-1].update(f32_graph_ms=f32_ms, f64_graph_ms_in_turns=f64_ms, f64_over_f32=f64_ms / f32_ms,
                            f32_bound_ms=bound32, f32_pack_mb=pack32.nbytes / 2**20)
            extra = dict(f32_graph_ms=f"{f32_ms:.4f}", f64_graph_ms_in_turns=f"{f64_ms:.4f}",
                         f64_over_f32=f"{f64_ms / f32_ms:.3f}", f32_bound_ms=f"{bound32:.5f}",
                         turns_ms=json.dumps({k: [round(t, 5) for t in v] for k, v in turns.items()}))
        say("timing", workload=workload, kernel=rows[-1]["name"], ms=f"{ms:.4f}", graph_ms=f"{graph_ms:.4f}",
            plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{rows[-1]['bound_ms']:.5f}", bound_by=rows[-1]["bound_by"],
            box_tests_per_launch=f"{rows[-1]['box_tests_per_launch']:.0f}",
            tri_tests_per_launch=f"{rows[-1]['tri_tests_per_launch']:.0f}", **extra, card=json.dumps(card))
    return rows


def f64_vs_f32_mrays(workload, scene, camera, eps, renderer, rays, card) -> None:
    """`[main_path]` of a float64 workload, float64 against float32:
    Mrays/s of the same samples through each type's graph, in turns (f32,
    f64, f64, f32), the float32 renderer a twin of the float64 one."""
    import torch

    from rpt_tpu_torch import Renderer

    r32 = Renderer(scene, camera, width=renderer.width, height=renderer.height, max_bounces=renderer.max_bounces,
                   num_samples=renderer.num_samples, epsilon=eps, device=DEVICE)
    r32.render_buffer()  # compiles the float32 scene and captures its graph
    renderer.render_buffer()
    torch.cuda.synchronize()
    seconds = {"f32": [], "f64": []}
    for label in ("f32", "f64", "f64", "f32"):
        r = r32 if label == "f32" else renderer
        t0 = time.perf_counter()
        r.render_buffer()
        torch.cuda.synchronize()
        seconds[label].append(time.perf_counter() - t0)
    mrays = {k: rays / (sum(v) / len(v)) / 1e6 for k, v in seconds.items()}
    say("main_path", workload=workload, mode="turns f32, f64, f64, f32", spp=renderer.num_samples,
        f32_mrays_per_s=f"{mrays['f32']:.3f}", f64_mrays_per_s=f"{mrays['f64']:.3f}",
        f64_over_f32=f"{mrays['f64'] / mrays['f32']:.3f}",
        seconds=json.dumps({k: [round(t, 5) for t in v] for k, v in seconds.items()}), card=json.dumps(card))


class NoWalk:
    """A compiled scene's box with an intersect and an occluded that walk
    nothing: the integrator's sorted paths around it cost what the sort
    costs (its keys, permutation, inverse and gathers)."""

    def __init__(self, sd):
        self.bvh, self.instanced, self.device = sd.bvh, sd.instanced, sd.device

    def intersect(self, o, d, t_min, active=None):
        import torch

        from rpt_tpu_torch.ops.intersect import Hit

        return Hit(t=o[:, 0] + 0.0, normal=d + 0.0, mat_id=torch.zeros(o.shape[0], dtype=torch.int32, device=o.device))

    def occluded(self, o, d, t_min, t_max, active=None):
        return active.clone()


def compact_phase(workload, family, renderer, card, counters) -> dict:
    """`[compact]`: the wavefront orders in turns through the graphed loop,
    RPT_COMPACT set to each (the order is part of the pass's cache key, so
    each gets its own graph). For each order: the render bit for bit against
    the masked one (2 spp), its capture seconds and pool, the kernels of one
    replay counted on the card (the csrc kernels) and by the profiler (all),
    its device-busy ms and unprofiled wall ms, Mrays/s (COMPACT_SAMPLES
    replays, two turns: the orders forward, then back), and the sort's own
    device ms per call around a walk that does nothing (closest-hit and
    shadow paths). Then each kernel of `family` on the masked render's
    depth >= 1 wavefronts, as they come and morton-sorted, in turns, with
    the sorted answers checked against the permuted masked ones. Returns
    {kernel: {masked/morton ms per launch}} for the `kernels` line."""
    import torch

    from rpt_tpu_torch import integrator, kernels
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.integrator import COMPACT_MODES
    from rpt_tpu_torch.renderer import make_render_many_fn

    bounces, shadow = WORKLOADS[workload]["bounces"], WORKLOADS[workload]["shadow"]
    sd, t_min, ev_scale = renderer._pass_args()
    w, h = renderer.width, renderer.height
    key = rnd.PRNGKey(renderer.seed)
    rays = (bounces + 1) * (1 + shadow) * w * h
    closest, occluded = f"{family}_closest", f"{family}_occluded"
    saved = os.environ.get("RPT_COMPACT")

    def use(mode):
        os.environ["RPT_COMPACT"] = COMPACT_ENV[mode]
        fn = make_render_many_fn(sd, w, h, bounces)
        if fn.compact != mode:
            fail(f"RPT_COMPACT={COMPACT_ENV[mode]} made a {fn.compact!r} pass")
        return fn

    try:
        # The masked render's depth >= 1 wavefronts, from an eager pass.
        use(False)
        rec = record_wavefronts((closest, occluded), lambda: renderer._sample_into_eager(fresh(renderer), 1))
        deep = {closest: rec[closest][1:], occluded: rec[occluded][shadow:]}
        c_args, s_args = deep[closest][0], deep[occluded][0]  # depth 1: (o, d, t_min[, t_max], active)
        nowalk = NoWalk(sd)

        def sort_closest(o, d, a, mode):
            return integrator._intersect(nowalk, o, d, t_min, a, mode)

        def sort_shadow(o, d, t_max, a, mode):
            return integrator._shadow_visible(nowalk, o, d, t_max, t_min, a, mode)

        masked = masked_counted = None
        per_mode = {}
        for mode in COMPACT_MODES:
            fn = use(mode)
            buf = renderer.sample_into(fresh(renderer), 2)  # captures this order's graph
            torch.cuda.synchronize()
            same = masked is None or bool(torch.equal(buf.sum, masked.sum) and torch.equal(buf.sum_sq, masked.sum_sq))
            cap = fn.capture(t_min)

            def replay(fn=fn):
                fn(renderer.camera, key, 0, 1, t_min, ev_scale)

            kernels.reset_launch_counts()
            replay()
            counted = named_counts(counters)
            if masked is None:
                masked, masked_counted = buf, counted
            unprofiled = wall_ms(replay)
            _, busy_us, events = profiled(replay)
            closest_ms = time_graph_ms(sort_closest, [(c_args[0], c_args[1], c_args[-1], mode)], reps=20)
            shadow_ms = time_graph_ms(sort_shadow, [(s_args[0], s_args[1], s_args[3], s_args[4], mode)], reps=20)
            per_mode[mode] = dict(bit_equal_to_masked=same, capture_seconds=f"{cap.seconds:.3f}",
                                  pool_mib=f"{cap.pool_bytes / 2**20:.1f}",
                                  counted_kernels_per_sample=sum(counted.values()),
                                  profiler_kernels_per_sample=len(events),
                                  device_busy_ms=f"{busy_us / 1e3:.3f}" if events else "not measured",
                                  unprofiled_ms=f"{unprofiled:.3f}", sort_closest_ms=f"{closest_ms:.4f}",
                                  sort_shadow_ms=f"{shadow_ms:.4f}")
            if not same:
                fail(f"the {workload} render under RPT_COMPACT={COMPACT_ENV[mode]} differs from the masked render")
            if counted != masked_counted:
                fail(f"one {workload} replay under RPT_COMPACT={COMPACT_ENV[mode]} launched {counted}, "
                     f"the masked one {masked_counted}")
        # Where a morton sort round's device time goes, on each path.
        rounds = {"closest": lambda: sort_closest(c_args[0], c_args[1], c_args[-1], "morton"),
                  "shadow": lambda: sort_shadow(s_args[0], s_args[1], s_args[3], s_args[4], "morton")}
        for path, fn in rounds.items():
            _, busy_us, events = profiled(fn)
            by_name = device_us_by_name(events)
            heaviest = {k: round(v / 1e3, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}
            say("compact", workload=workload, mode="morton", path=path, sort_round_kernels=len(events),
                sort_round_busy_ms=f"{busy_us / 1e3:.4f}", heaviest=json.dumps(heaviest))
        # Mrays/s in turns: the orders forward, then back.
        seconds = {mode: [] for mode in COMPACT_MODES}
        for mode in list(COMPACT_MODES) + list(COMPACT_MODES)[::-1]:
            fn = use(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(renderer.camera, key, 0, COMPACT_SAMPLES, t_min, ev_scale)
            torch.cuda.synchronize()
            seconds[mode].append(time.perf_counter() - t0)
        for mode in COMPACT_MODES:
            mean = sum(seconds[mode]) / len(seconds[mode])
            say("compact", workload=workload, mode=COMPACT_ENV[mode], **per_mode[mode],
                mrays_per_s=f"{rays * COMPACT_SAMPLES / mean / 1e6:.3f}",
                turns_seconds=json.dumps([round(t, 5) for t in seconds[mode]]), card=json.dumps(card))

        # The walks on the depth >= 1 rays, as they come and morton-sorted.
        mod = family_module(family)
        pack = pack_of(sd, family)
        lo, hi = integrator._scene_box(sd)
        by_kernel = {}
        for name, waves in deep.items():
            kern = kernel_of(mod, name, pack)
            sorted_waves = []
            for o, d, tm, *rest, active in waves:
                perm, _ = integrator._morton_perm(o, d, active, lo, hi)
                cols = integrator._gather_packed(perm, (o, d, *rest, active))
                sorted_waves.append((cols[0], cols[1], tm, *cols[2:]))
                out_m, out_s = kern(o, d, tm, *rest, active), kern(*sorted_waves[-1])
                out_m = out_m if isinstance(out_m, tuple) else (out_m,)
                out_s = out_s if isinstance(out_s, tuple) else (out_s,)
                if not all(torch.equal(x[perm], y) for x, y in zip(out_m, out_s)):
                    fail(f"{name} answers the morton-sorted {workload} rays otherwise than the same rays unsorted")

            turns = [("masked", waves), ("morton", sorted_waves), ("morton", sorted_waves), ("masked", waves)]
            ms = {"masked": [], "morton": []}
            for label, args in turns:
                ms[label].append(time_graph_ms(kern, args, reps=10))
            masked_ms, morton_ms = (sum(ms[k]) / 2 for k in ("masked", "morton"))
            share = sum(float(a[-1].float().mean()) for a in waves) / len(waves)
            say("compact", workload=workload, kernel=name, wavefronts=len(waves), active_share=f"{share:.4f}",
                masked_ms=f"{masked_ms:.4f}", morton_ms=f"{morton_ms:.4f}",
                morton_over_masked=f"{morton_ms / masked_ms:.3f}",
                turns_ms=json.dumps({k: [round(t, 5) for t in v] for k, v in ms.items()}), card=json.dumps(card))
            by_kernel[name] = {"depth1plus_masked_ms": masked_ms, "depth1plus_morton_ms": morton_ms,
                               "depth1plus_active_share": share}
        return by_kernel
    finally:
        if saved is None:
            os.environ.pop("RPT_COMPACT", None)
        else:
            os.environ["RPT_COMPACT"] = saved


def gather_phase(card: str) -> None:
    """`[gather]`: device ms of one row gather `x[perm]` of WIDTH x HEIGHT
    rows of float32 at a few row widths (the sorts' packed gathers are such
    gathers), each inside a CUDA graph."""
    import torch

    n = WIDTH * HEIGHT
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    ms = {}
    for w in (3, 4, 7, 8, 9, 12):
        x = torch.randn((n, w), generator=torch.Generator().manual_seed(w)).to(DEVICE)
        ms[w] = time_graph_ms(lambda x, p: x[p], [(x, perm)], reps=20)
    say("gather", rows=n, ms_by_width=json.dumps({w: round(v, 5) for w, v in ms.items()}), card=json.dumps(card))


def trace_events(fn) -> list:
    """The Chrome-trace events of one call of `fn` under torch.profiler
    (CPU and CUDA), ending in a synchronize."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_events(events) -> list:
    """The device's work (kernels, copies, fills) among trace events, in the
    order it ran."""
    return sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda e: float(e["ts"]))


def find_run(names: list, run: list, start: int) -> int:
    """The first index >= start at which `run` occurs in `names`, or -1."""
    for i in range(start, len(names) - len(run) + 1):
        if names[i] == run[0] and names[i:i + len(run)] == run:
            return i
    return -1


MONOMIAL_MARK = "intersect_monomials"


def monomial_share(workload: str, renderer, card: str) -> None:
    """`[profile]`, mode `monomial`: the share of one replay's device time
    that the monomial root finds take, and their kernels in it, both read
    from the profiled replay's own trace. A graph replay runs no host code,
    so its trace names no call: an eager pass is profiled first with every
    `intersect_monomials` call marked (`record_function`), which gives each
    call's kernels in launch order; the replay runs the same launches in the
    same order, so each call is the first run of the replay's kernels, after
    the previous call's, whose names are the call's, one for one. The
    profiler can lose a record of a replay, so a call not found has the
    replay profiled again (three times at most)."""
    import torch

    from rpt_tpu_torch.ops import intersect as ops_intersect

    orig = ops_intersect.intersect_monomials

    def marked(*args, **kwargs):
        with torch.profiler.record_function(MONOMIAL_MARK):
            return orig(*args, **kwargs)

    ops_intersect.intersect_monomials = marked
    try:
        eager = trace_events(lambda: renderer._sample_into_eager(fresh(renderer), 1))
    finally:
        ops_intersect.intersect_monomials = orig
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in eager
             if e.get("cat") == "user_annotation" and e.get("name") == MONOMIAL_MARK]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in eager
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    calls = [[] for _ in spans]
    for k in device_events(eager):
        t = launched.get(k.get("args", {}).get("correlation"))
        for i, (a, b) in enumerate(spans):
            if t is not None and a <= t <= b:
                calls[i].append(k["name"])
    if not calls or not min(map(len, calls)):
        say("profile", workload=workload, mode="monomial",
            device_time="not measured (the eager trace marked no monomial call's kernels)")
        fail(f"the profiler named no monomial call's kernels in an eager {workload} pass")
    replay_one = replay_fn(renderer)
    for attempt in range(1, 4):
        kernels = device_events(trace_events(replay_one))
        names = [k["name"] for k in kernels]
        found, pos = [], 0
        for run in calls:
            i = find_run(names, run, pos)
            if i < 0:
                break
            found.append((i, i + len(run)))
            pos = i + len(run)
        if len(found) == len(calls):
            break
    else:
        say("profile", workload=workload, mode="monomial", eager_kernels_per_call=json.dumps(list(map(len, calls))),
            replay_kernels=len(names), calls_found=len(found),
            device_time="not measured (a call's span was not found in three replay traces)")
        fail(f"the monomial calls' kernels were not found in a profiled {workload} replay")
    dur = [float(k["dur"]) for k in kernels]
    mono_us = sum(sum(dur[i:j]) for i, j in found)
    total_us = sum(dur)
    busy_us, end = 0.0, float("-inf")
    for k in kernels:
        s, e = float(k["ts"]), float(k["ts"]) + float(k["dur"])
        if e > end:
            busy_us += e - max(s, end)
            end = e
    say("profile", workload=workload, mode="monomial", calls_per_sample=len(calls),
        kernels_per_call=json.dumps(list(map(len, calls))), monomial_kernels_in_replay=sum(j - i for i, j in found),
        replay_kernels=len(kernels), replay_traces=attempt, monomial_device_ms=f"{mono_us / 1e3:.3f}",
        replay_device_ms=f"{total_us / 1e3:.3f}", replay_device_busy_ms=f"{busy_us / 1e3:.3f}",
        monomial_share_of_replay_device_time=f"{mono_us / total_us:.3f}", card=json.dumps(card))


def hdri_slack(img, dirs):
    """Per direction and channel, the float32 lookup's slack: HDRI_ULPS ulps
    of w - 1 times the largest contrast in x, plus as many of h - 1 times
    the largest in y, between neighbouring texels (x wrapped, y clamped) of
    the 4x4 texels around the quad the direction reads: that quad, and
    those an ulp of the coordinate can move the card's lookup into."""
    import numpy as np
    import torch

    h, w = img.shape[:2]
    rows = np.arange(h)
    contrast = {"x": np.abs(np.roll(img, -1, axis=1) - img), "y": np.abs(img[np.minimum(rows + 1, h - 1)] - img)}
    around = {}
    for axis, c in contrast.items():
        around[axis] = np.zeros_like(c)
        for dy in (-1, 0, 1, 2):
            r = c[np.clip(rows + dy, 0, h - 1)]
            for dx in (-1, 0, 1, 2):
                np.maximum(around[axis], np.roll(r, -dx, axis=1), out=around[axis])
    d = dirs.double().numpy()
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    x = (np.arctan2(d[:, 2], d[:, 0]) + np.pi) / (2 * np.pi) * (w - 1)
    y = np.arccos(np.clip(d[:, 1], -1.0, 1.0)) / np.pi * (h - 1)
    x0, y0 = np.clip(x.astype(np.int64), 0, w - 1), np.clip(y.astype(np.int64), 0, h - 1)
    slack = HDRI_ULPS * (float(np.spacing(np.float32(w - 1))) * around["x"][y0, x0]
                         + float(np.spacing(np.float32(h - 1))) * around["y"][y0, x0])
    return torch.from_numpy(slack.astype(np.float64))


def hdri_phase(card: str) -> None:
    """`[hdri]`: the HDRI lookup of 800x600 directions (random ones, and
    `monomial_glass`'s camera rays) on a 1024x2048 procedural sky, in float32
    and float64: the card against the CPU (rtol HDRI_RTOL, atol HDRI_ATOL,
    and in float32 `hdri_slack`), then device ms per call inside a CUDA
    graph, in turns (forward, then back), of the three layouts: the port's
    13-float quad rows, the reference's 12-float rows and the four gathers
    of the map; the three must read the same values, bit for bit.
    `bound_ms` is the bytes one lookup must move (the directions read, four
    texels gathered, the colors written) over the card's memory rate."""
    import torch

    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.environment import Environment, lookup
    from rpt_tpu_torch.renderer import camera_rays_tiled, pixel_ndc_tiled
    from rpt_tpu_torch.scenes import monomial_glass_camera, procedural_sky

    t0 = time.perf_counter()
    env = Environment.from_hdri(procedural_sky(HDRI_HEIGHT))
    bake_s = time.perf_counter() - t0
    if env.hdri_quad is None:
        fail(f"a {HDRI_HEIGHT}x{2 * HDRI_HEIGHT} map took the 4-gather form")
    w, h = WORKLOADS["monomial_glass"]["size"]
    n = w * h
    random_dirs = torch.randn((n, 3), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    _, camera_dirs, _ = camera_rays_tiled(monomial_glass_camera(), rnd.fold_in(rnd.PRNGKey(0), 0),
                                          pixel_ndc_tiled(w, h, "cpu"))
    for dtype in (torch.float32, torch.float64):
        color, hdri, quad = env.tensors(DEVICE, dtype)
        layouts = {"quad13": quad, "quad12": quad[:, :12].contiguous(), "gather4": None}
        real = 4 if dtype == torch.float32 else 8
        # The directions read, four texels of 3 float32 gathered, the colors
        # written (the quad13 row's zero is padding, not needed).
        bound = n * (2 * 3 * real + 4 * 12) / PEAK_BYTES * 1e3
        for label, dirs in (("random", random_dirs), ("camera", camera_dirs)):
            d_cpu = dirs.to(dtype)
            want = env.get_color(d_cpu)
            d = d_cpu.to(DEVICE)
            got = {name: lookup(d, color, hdri, q) for name, q in layouts.items()}
            torch.cuda.synchronize()
            same = all(torch.equal(got["quad13"], g) for g in got.values())
            diff = (got["quad13"].cpu() - want).abs().double()
            err = float(diff.max())
            slack = hdri_slack(env.hdri, d_cpu) if dtype == torch.float32 else torch.zeros_like(diff)
            bar = HDRI_ATOL + slack + HDRI_RTOL * want.abs().double()
            close = bool((diff <= bar).all())
            strict = float((diff <= HDRI_ATOL + HDRI_RTOL * want.abs()).float().mean())
            turns = {name: [] for name in layouts}
            for name in [*layouts, *reversed(layouts)]:
                turns[name].append(time_graph_ms(lambda q=layouts[name]: lookup(d, color, hdri, q), [()], reps=20))
            ms = {name: sum(v) / len(v) for name, v in turns.items()}
            say("hdri", map=f"{HDRI_HEIGHT}x{2 * HDRI_HEIGHT}", quad_mb=f"{quad.numel() * 4 / 1e6:.1f}",
                bake_seconds=f"{bake_s:.3f}", dtype=str(dtype).removeprefix("torch."), dirs=label, n=n,
                max_abs_err_vs_cpu=err, ulp_slack_max=f"{float(slack.max()):.3e}",
                ulp_slack_median=f"{float(slack.median()):.3e}", worst_err_over_bar=f"{float((diff / bar).max()):.4f}",
                card_matches_cpu=close,
                share_within_rtol_atol_alone=f"{strict:.6f}", layouts_bit_equal=same,
                ms=json.dumps({k: round(v, 5) for k, v in ms.items()}),
                bound_ms=f"{bound:.5f}",
                quad12_over_quad13=f"{ms['quad12'] / ms['quad13']:.3f}",
                gather4_over_quad13=f"{ms['gather4'] / ms['quad13']:.3f}",
                turns_ms=json.dumps({k: [round(t, 5) for t in v] for k, v in turns.items()}), card=json.dumps(card))
            if not (close and same):
                fail(f"the {dtype} HDRI lookup on the card disagrees with the CPU or across layouts")


def mono_light_phase(card: str) -> None:
    """`[mono_light]`: the monomial light's scene (`tests/test_monomial_light.py`)
    at SMALL_W x SMALL_H, 0 bounces, rendered on the CPU and on the card
    with the same seed and compared as phase c compares."""
    import numpy as np

    from rpt_tpu_torch import Renderer
    from rpt_tpu_torch.lights import MonomialLightData
    from rpt_tpu_torch.scenes import build_monomial_light_scene, monomial_light_camera

    scene, camera = build_monomial_light_scene(), monomial_light_camera()
    small = {}
    for dev in ("cpu", DEVICE):
        r = Renderer(scene, camera, width=SMALL_W, height=SMALL_H, max_bounces=0, num_samples=1, seed=5,
                     device=dev)
        if not isinstance(r.scene_data().lights[0], MonomialLightData):
            fail("the monomial light compiled to another light")
        small[dev] = r.render_buffer().mean_image().cpu().numpy()
    a, b = small["cpu"], small[DEVICE]
    close = np.isclose(b, a, rtol=1e-3, atol=1e-4).all(-1).mean()
    mean_rel = abs(float(b.mean()) - float(a.mean())) / max(abs(float(a.mean())), 1e-12)
    say("mono_light", size=f"{SMALL_W}x{SMALL_H}", pixels_close=f"{close:.5f}", mean_rel=f"{mean_rel:.3e}",
        image_mean=f"{float(b.mean()):.6f}", card=json.dumps(card))
    if not (np.isfinite(b).all() and close >= 0.99 and mean_rel <= 1e-3 and float(b.mean()) > 1e-3):
        fail("the CPU and card renders of the monomial light's scene disagree, or it is dark")


def same_bits(a, b) -> bool:
    """a and b hold the same bits (a float's NaN included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def record_scatter(renderer) -> list:
    """One eager sample of `renderer`: the inputs (key, mat, n, wo, found) it
    handed the scatter step at each depth, in order."""
    import torch

    from rpt_tpu_torch import integrator

    seen, scatter = [], integrator.scatter

    def recording(*args):
        seen.append(args)
        return scatter(*args)

    integrator.scatter = recording
    try:
        renderer._sample_into_eager(fresh(renderer), 1)
        torch.cuda.synchronize()
    finally:
        integrator.scatter = scatter
    return seen


def scatter_autograd_check(label, wave, dtype) -> None:
    """The wrapper's autograd path on one wavefront: material columns that
    require grad, so the kernel samples (with the weight's divisor) and torch
    rebuilds the weight. Values and gradient bit for bit the plain
    version's, in one counted launch. The leaves are the gathered columns
    (no gather's backward, whose atomics would reorder sums)."""
    import dataclasses

    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch.materials import sample_draws
    from rpt_tpu_torch.ops import scatter as sc

    key, mat, n, wo, found = wave
    slot = 0 if dtype == torch.float32 else 1
    weights = torch.tensor([0.3, 0.5, 0.7], dtype=dtype, device=n.device)
    out = {}
    for way in ("kernel", "plain"):
        cols = {f.name: getattr(mat, f.name).detach().clone().requires_grad_() for f in dataclasses.fields(mat)}
        leaves = type(mat)(**cols)
        before = kernels.launch_counts(by_slot=True)[sc.scatter][slot]
        if way == "kernel":
            got = sc.scatter(key, leaves, n, wo, found)
        else:
            got = sc.scatter_plain(sample_draws(key, (n.shape[0],), n.device, dtype), leaves, n, wo, found)
        grads = torch.autograd.grad((got[1] * weights).sum(), list(cols.values()), allow_unused=True)
        torch.cuda.synchronize()
        out[way] = (got, dict(zip(cols, grads)), kernels.launch_counts(by_slot=True)[sc.scatter][slot] - before)
    (got, g_kern, launches), (want, g_plain, _) = out["kernel"], out["plain"]
    values = all(same_bits(g.detach(), w.detach()) for g, w in zip(got, want))
    grads = all((g_kern[f] is None) == (g_plain[f] is None) and (g_kern[f] is None or same_bits(g_kern[f], g_plain[f]))
                for f in g_plain)
    nonzero = [f for f, g in g_kern.items() if g is not None and float(g.abs().max()) > 0.0]
    say("scatter", case=label, path="autograd (material columns require grad)", values_bit_equal=values,
        grads_bit_equal=grads, grads_nonzero=",".join(nonzero), launches=launches)
    if not (values and grads and nonzero and launches == 1):
        fail(f"[scatter] {label}: the autograd path's values ({values}) or gradient ({grads}) differ from the plain "
             f"version's, every gradient is zero ({not nonzero}) or it launched {launches}, not 1")


def scatter_phase(card: str) -> dict:
    """`[scatter]` (see the module docstring). Returns the kernel's rows of
    the `kernels` line by name (`scatter`, `scatter_f64`), their launches
    left to the main path."""
    import torch

    from rpt_tpu_torch import Renderer
    from rpt_tpu_torch.materials import sample_draws, sample_f_drawn
    from rpt_tpu_torch.ops import scatter as sc
    from rpt_tpu_torch.scenes import scene_and_camera

    rows = {}
    for workload, type_name in SCATTER_CASES:
        t0 = time.perf_counter()
        spec, dtype = WORKLOADS[workload], getattr(torch, type_name)
        width, height = spec["size"]
        with kernel_choice(spec["bvh_kernel"]):
            scene, camera, eps = scene_and_camera(spec["scene"])
            r = Renderer(scene, camera, width=width, height=height, exposure_value=spec.get("ev", 0.0),
                         max_bounces=spec["bounces"], num_samples=1, epsilon=eps, device=DEVICE, dtype=dtype)
            waves = record_scatter(r)
        label = f"{workload} {type_name}"
        if len(waves) != spec["bounces"]:
            fail(f"[scatter] one {label} sample scattered {len(waves)} times, not {spec['bounces']}")
        by_depth = []
        for depth, (key, mat, n, wo, found) in enumerate(waves):
            draws = sample_draws(key, (n.shape[0],), n.device, dtype)
            want = sc.scatter_plain(draws, mat, n, wo, found)
            _, pdf, valid = sample_f_drawn(draws, mat, n, wo)
            pdf_safe = torch.where(want[2], pdf, torch.ones_like(pdf))
            got = sc.scatter_kernel(draws, mat, n, wo, found, with_pdf=True)
            alone = sc.scatter_kernel(draws, mat, n, wo, found)
            torch.cuda.synchronize()
            diff = {name: not same_bits(g, w) for name, g, w in zip(("wi", "w", "ok", "pdf_safe"), got,
                                                                     (*want, pdf_safe))}
            diff["without_pdf"] = not all(same_bits(a, g) for a, g in zip(alone, got))
            by_depth.append(dict(lanes=n.shape[0], found=float(found.float().mean()),
                                 ok=float(want[2].float().mean()), tir=int((found & ~valid).sum()),
                                 normal_stride=n.stride(0)))
            say("scatter", case=label, depth=depth, **by_depth[-1], bit_equal=not any(diff.values()))
            if any(diff.values()):
                fail(f"[scatter] {label} depth {depth}: the kernel differs from the plain version in "
                     f"{[k for k, v in diff.items() if v]}")
        scatter_autograd_check(label + " depth 1", waves[1], dtype)

        # ms per launch at depths 0 and 1 (the camera's wavefront and a
        # morton-sorted one), beside the plain version and the bound.
        timed = {}
        for depth in (0, 1):
            key, mat, n, wo, found = waves[depth]
            args = [(sample_draws(key, (n.shape[0],), n.device, dtype), mat, n, wo, found)]
            bound = n.shape[0] * (SCATTER["reals_per_lane"] * n.element_size() + SCATTER["bool_bytes"]) \
                / PEAK_BYTES * 1e3
            timed[depth] = dict(ms=time_ms(sc.scatter_kernel, args, reps=100),
                                graph_ms=time_graph_ms(sc.scatter_kernel, args, reps=50),
                                plain_ms=time_ms(sc.scatter_plain, args, reps=5), bound_ms=bound)
            say("scatter", case=label, depth=depth, lanes=n.shape[0],
                **{k: f"{v:.5f}" for k, v in timed[depth].items()},
                graph_over_bound=f"{timed[depth]['graph_ms'] / bound:.2f}", card=json.dumps(card))
        name = "scatter" if dtype == torch.float32 else "scatter_f64"
        row = {"name": name, "route": "cuda", "source": SCATTER["source"], "replaces": None, "launches": None,
               "max_abs_err": 0.0, **timed[1], "bound_by": "bytes", "library_ms": None, "workload": workload,
               "dtype": type_name, "shape": [waves[1][2].shape[0]], "depth": 1, "depth0": timed[0],
               "checked_depths": len(waves), "by_depth": by_depth}
        if name in rows:
            rows[name].setdefault("other_workloads", []).append(row)
        else:
            rows[name] = row
        del waves
        torch.cuda.empty_cache()
        say("scatter", case=label, phase_seconds=f"{time.perf_counter() - t0:.1f}")
    return rows


def random_phase(card: str) -> dict:
    """`[random]`: the threefry kernel against its plain version, bit for
    bit, in every mode (a host key and a tensor key; keys also from a device
    counter), at the main path's shapes (518,400 and 2 x 518,400) and
    ragged ones; then ms per launch of each mode at 518,400 beside the
    plain version's and the bound. Returns the kernel's row: `ms` and the
    bound of uniform at 518,400, the main path's commonest bulk draw, and
    each mode's beside them (keys at 1 element, as split and fold_in
    draw them)."""
    import numpy as np
    import torch

    from rpt_tpu_torch import random as rnd

    npix = WIDTH * HEIGHT
    host = rnd.fold_in(rnd.PRNGKey(5), 3)
    dev = rnd.to_device(host, DEVICE)
    counter = torch.tensor([123456], dtype=torch.int64, device=DEVICE)
    dim = float(max(WIDTH, HEIGHT))
    params = {
        "keys": (rnd.KEYS, {}),
        "bits": (rnd.BITS, {}),
        "uniform": (rnd.UNIFORM, dict(lo=0.0, span=1.0)),
        "uniform_jitter": (rnd.UNIFORM, dict(lo=float(np.float32(-1.0 / dim)),
                                            span=float(np.float32(1.0 / dim) - np.float32(-1.0 / dim)))),
        "uniform_beckmann": (rnd.UNIFORM, dict(lo=float(np.float32(1e-7)),
                                              span=float(np.float32(1.0) - np.float32(1e-7)))),
        "uniform_2pi": (rnd.UNIFORM, dict(lo=0.0, span=float(np.float32(2.0 * np.pi)))),
        "randint_6": (rnd.RANDINT, rnd._randint_params(0, 6)),
        "randint_wide": (rnd.RANDINT, rnd._randint_params(-100, 2**31 - 1)),
    }
    checked = 0
    for label, (mode, kw) in params.items():
        for n in (1, 7, 1000, npix + 3, npix, 2 * npix):
            if mode == rnd.KEYS and n > 1000:
                continue
            for key_name, key in (("host", host), ("tensor", dev)):
                for ctr in ((None, counter) if mode == rnd.KEYS else (None,)):
                    k = rnd.threefry_kernel(mode, key, n, DEVICE, counter=ctr, **kw)
                    p = rnd.threefry_plain(mode, key, n, DEVICE, counter=ctr, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(k, p):
                        bad = int((k != p).sum())
                        fail(f"threefry {label} n={n} {key_name} key: {bad} elements differ from the plain version")
                    checked += 1
    say("random", checked=checked, modes=",".join(params), sizes=f"1,7,1000,{npix + 3},{npix},{2 * npix}",
        bit_equal=True)
    # The wrappers on tensor keys, as the pass calls them.
    sub = rnd.split(dev, 3)
    want = rnd.threefry_plain(rnd.KEYS, dev, 3, DEVICE)
    if not torch.equal(sub, want) or not torch.equal(rnd.fold_in(dev, counter[0]),
                                                     rnd.threefry_plain(rnd.KEYS, dev, 1, DEVICE, counter=counter)[0]):
        fail("split / fold_in of a tensor key differ from the plain version")
    by_mode = {}
    for label in ("keys", "bits", "uniform", "randint_6"):
        mode, kw = params[label]
        n = 1 if mode == rnd.KEYS else npix
        launch = [(mode, dev, n, DEVICE)]
        ms = time_ms(lambda *a: rnd.threefry_kernel(*a, **kw), launch, reps=200)
        graph_ms = time_graph_ms(lambda *a: rnd.threefry_kernel(*a, **kw), launch, reps=200)
        plain_ms = time_ms(lambda *a: rnd.threefry_plain(*a, **kw), launch, reps=5)
        plain_graph_ms = time_graph_ms(lambda *a: rnd.threefry_plain(*a, **kw), launch, reps=5)
        bound, bound_by = threefry_bound_ms(mode, n)
        by_mode[THREEFRY["modes"][mode]] = dict(n=n, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                                                plain_graph_ms=plain_graph_ms, bound_ms=bound, bound_by=bound_by)
        say("random", mode=label, n=n, ms=f"{ms:.5f}", graph_ms=f"{graph_ms:.5f}", plain_ms=f"{plain_ms:.4f}",
            plain_graph_ms=f"{plain_graph_ms:.4f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            graph_over_bound=f"{graph_ms / bound:.3f}", card=json.dumps(card))
    u = by_mode["uniform"]
    row = {"name": "threefry", "route": "cuda", "source": THREEFRY["source"], "replaces": None,
           "launches": None, "max_abs_err": 0.0, "ms": u["ms"], "graph_ms": u["graph_ms"], "plain_ms": u["plain_ms"],
           "plain_graph_ms": u["plain_graph_ms"], "bound_ms": u["bound_ms"], "bound_by": u["bound_by"],
           "library_ms": None, "shape": [npix], "mode": "uniform", "by_mode": by_mode}
    return row, random64_phase(card, host, dev, npix, dim, by_mode)


def random64_phase(card: str, host, dev, npix: int, dim: float, by_mode32: dict) -> dict:
    """`[random]` of the 64-bit modes (`random._threefry64`): the float64
    uniform (at the float64 render's jitter, Beckmann and 2 pi ranges too)
    and the int64 randint, against their plain versions bit for bit (the
    plain float64 uniform emulates the kernel's one-rounding multiply-add),
    at the main path's shapes and ragged ones, host and tensor keys; then ms
    per launch at 518,400 beside the plain version's, the bound and the
    32-bit twin's graph ms. Returns the `threefry_f64` row (its uniform's
    numbers, both modes under "by_mode")."""
    import torch

    from rpt_tpu_torch import random as rnd

    params = {
        "uniform64": (rnd.UNIFORM64, dict(lo=0.0, span=1.0)),
        "uniform64_jitter": (rnd.UNIFORM64, dict(lo=-1.0 / dim, span=1.0 / dim - (-1.0 / dim))),
        "uniform64_beckmann": (rnd.UNIFORM64, dict(lo=1e-7, span=1.0 - 1e-7)),
        "uniform64_2pi": (rnd.UNIFORM64, dict(lo=0.0, span=2.0 * 3.141592653589793)),
        "randint64_6": (rnd.RANDINT64, rnd._randint_params(0, 6, 64)),
        "randint64_tris": (rnd.RANDINT64, rnd._randint_params(0, 120_000, 64)),
    }
    # The int64 randint at every kind of span its reciprocal takes (1,
    # powers of two, odd and even spans around 2^32 and 2^63, 2^64 - 1).
    for lo, hi in RANDINT64_BOUNDS:
        params[f"randint64_span_{(hi - lo) % 2**64}"] = (rnd.RANDINT64, rnd._randint_params(lo, hi, 64))
    checked = 0
    for label, (mode, kw) in params.items():
        for n in (1, 7, 1000, npix + 3, npix, 2 * npix):
            for key_name, key in (("host", host), ("tensor", dev)):
                k = rnd.threefry_kernel(mode, key, n, DEVICE, **kw)
                p = rnd.threefry_plain(mode, key, n, DEVICE, **kw)
                torch.cuda.synchronize()
                if not torch.equal(k, p):
                    fail(f"threefry {label} n={n} {key_name} key: {int((k != p).sum())} elements differ "
                         "from the plain version")
                checked += 1
    say("random", checked=checked, modes=",".join(params), sizes=f"1,7,1000,{npix + 3},{npix},{2 * npix}",
        bit_equal=True)
    by_mode = {}
    for label, twin in (("uniform64", "uniform"), ("randint64_6", "randint")):
        mode, kw = params[label]
        launch = [(mode, dev, npix, DEVICE)]
        ms = time_ms(lambda *a: rnd.threefry_kernel(*a, **kw), launch, reps=200)
        graph_ms = time_graph_ms(lambda *a: rnd.threefry_kernel(*a, **kw), launch, reps=200)
        plain_ms = time_ms(lambda *a: rnd.threefry_plain(*a, **kw), launch, reps=5)
        plain_graph_ms = time_graph_ms(lambda *a: rnd.threefry_plain(*a, **kw), launch, reps=5)
        bound, bound_by = threefry_bound_ms(mode, npix)
        by_mode[ALL_MODES[mode]] = dict(n=npix, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                                        plain_graph_ms=plain_graph_ms, bound_ms=bound, bound_by=bound_by,
                                        twin_graph_ms=by_mode32[twin]["graph_ms"])
        say("random", mode=label, n=npix, ms=f"{ms:.5f}", graph_ms=f"{graph_ms:.5f}", plain_ms=f"{plain_ms:.4f}",
            plain_graph_ms=f"{plain_graph_ms:.4f}", bound_ms=f"{bound:.5f}", bound_by=bound_by,
            graph_over_bound=f"{graph_ms / bound:.3f}", twin=twin,
            over_twin=f"{graph_ms / by_mode32[twin]['graph_ms']:.3f}", card=json.dumps(card))
    random_before_after(card, dev, npix)
    u = by_mode["uniform64"]
    return {"name": "threefry_f64", "route": "cuda", "source": THREEFRY["source"], "replaces": None,
            "launches": None, "max_abs_err": 0.0, "ms": u["ms"], "graph_ms": u["graph_ms"], "plain_ms": u["plain_ms"],
            "plain_graph_ms": u["plain_graph_ms"], "bound_ms": u["bound_ms"], "bound_by": u["bound_by"],
            "library_ms": None, "shape": [npix], "mode": "uniform64", "by_mode": by_mode}


def random_before_after(card: str, dev, npix: int) -> None:
    """`[random]` before / after: the threefry kernel of each tree named in
    RPT_COMPARE against this tree's, in every mode at the main path's size
    (keys at 1 element) under a tensor key: bit for bit, and graph ms per
    launch in turns (trees, this, this, trees reversed). Skipped when no
    tree is named."""
    import torch

    from rpt_tpu_torch import random as rnd

    trees = compare_trees()
    if not trees:
        say("random", before_after="skipped: RPT_COMPARE names no tree")
        return
    mods = {"this": rnd}
    for label, root in trees:
        mods[label] = importlib.import_module(f"{load_tree(label, root)}.random")
    labels = [label for label, _ in trees]
    for name, n, kw in THREEFRY_TURNS:
        mode = ALL_MODES.index(name)
        n = n or npix
        if "maxval" in kw:
            kw = rnd._randint_params(kw["minval"], kw["maxval"], 64 if name == "randint64" else 32)
        runs = {label: (lambda *a, m=m: m.threefry_kernel(*a, **kw)) for label, m in mods.items()}
        want = runs["this"](mode, dev, n, DEVICE)
        same = {}
        for label in labels:
            got = runs[label](mode, dev, n, DEVICE)
            torch.cuda.synchronize()
            same[label] = bool(torch.equal(got, want))
        times = {label: [] for label in mods}
        for label in labels + ["this", "this"] + labels[::-1]:
            times[label].append(time_graph_ms(runs[label], [(mode, dev, n, DEVICE)], reps=200))
        ms = {label: sum(v) / len(v) for label, v in times.items()}
        say("random", before_after=name, n=n, **{f"{label}_bit_equal": same[label] for label in labels},
            **{f"{label}_graph_ms": f"{ms[label]:.5f}" for label in ms},
            **{f"{label}_graph_turns_ms": json.dumps([round(t, 6) for t in times[label]]) for label in ms},
            **{f"{label}_over_this": f"{ms[label] / ms['this']:.3f}" for label in labels}, card=json.dumps(card))
        if not all(same.values()):
            fail(f"the threefry {name} kernels of {[k for k, v in same.items() if not v]} and this tree differ")


def walk_cases_phase(card: str) -> None:
    """`[ties]` and `[edge]`: every walk kernel, float32 and float64, against
    its plain walk on the scenes of tests/walk_scenes.py where the walks'
    edge cases show (the card tests' `_walk_scene`): on ties (two leaves,
    or two instances of the same or a wider mesh, at one t) each
    closest-hit kernel equals its plain walk bit for bit; on `edge_scene`
    (flat leaves, hits at a leaf's face) so does each closest hit, and each
    any hit at t_max = the closest hit's t answers `closest.t <= t_max` and
    equals its plain walk. Any mismatch fails the run."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import walk_scenes

    def scene(family, name, dtype):
        tree, o, d = walk_scenes.walk_scene(family, name, dtype)
        mod = family_module(family)
        return mod, getattr(mod, f"pack_{family}")(tree, device=DEVICE), o.to(DEVICE), d.to(DEVICE)

    cases = [("bvh8", "twin_leaves"), ("bvh2", "twin_leaves"), ("tlas8", "same_mesh"), ("tlas8", "wider_mesh"),
             ("tlas2", "same_mesh"), ("tlas2", "wider_mesh"), ("bvh8", "edge"), ("bvh2", "edge"), ("tlas8", "edge"),
             ("tlas2", "edge")]
    for dtype in (torch.float32, torch.float64):
        for family, name in cases:
            mod, pack, o, d = scene(family, name, dtype)
            out_k = kernel_of(mod, f"{family}_closest", pack)(o, d, T_MIN_WALK)
            out_p = getattr(mod, f"{family}_closest_plain")(pack, o, d, T_MIN_WALK)
            torch.cuda.synchronize()
            same = all(torch.equal(k, p) for k, p in zip(out_k, out_p))
            hit = out_p[0] < 1e38
            line = dict(family=family, scene=name, dtype=str(dtype).replace("torch.", ""), rays=o.shape[0],
                        hits=int(hit.sum()), closest_bit_equal=same)
            ok = same and int(hit.sum()) > 100
            if name == "edge":
                t_max = torch.where(hit, out_p[0], torch.full_like(out_p[0], 12.0))
                occ_k = kernel_of(mod, f"{family}_occluded", pack)(o, d, T_MIN_WALK, t_max)
                occ_p = getattr(mod, f"{family}_occluded_plain")(pack, o, d, T_MIN_WALK, t_max)
                torch.cuda.synchronize()
                line.update(any_hit_bit_equal=bool(torch.equal(occ_k, occ_p)),
                            missed_at_t_max_eq_t=int((hit & ~occ_k).sum()), false_hits=int((occ_k & ~hit).sum()))
                ok = ok and torch.equal(occ_k, occ_p) and torch.equal(occ_k, hit)
            say("edge" if name == "edge" else "ties", **line, card=json.dumps(card))
            if not ok:
                fail(f"the {family} kernels disagree with their plain walks or miss a hit on {name} ({dtype})")


def sass_phase(lib: str) -> None:
    """`[sass]`: the instructions of each threefry kernel of the built
    library by opcode (`cuobjdump -sass`), the check on THREEFRY's counts:
    the integer ones (whose adds ptxas emits partly as IMAD, on the FMA
    pipe), the float ones, and the rest. Prints 'not measured' without
    cuobjdump."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        say("sass", threefry="not measured (no cuobjdump)")
        return
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        say("sass", threefry=f"not measured (cuobjdump failed: {out.stderr.strip()[:200]})")
        return
    integer = ("IADD3", "LOP3", "SHF", "IMAD", "ISETP", "LEA", "VIADD", "SEL", "IABS", "I2F", "F2I")
    for block in out.stdout.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        ops = {}
        for line in body.splitlines():
            words = line.split("*/", 1)[-1].replace(";", " ").split()
            if not line.strip().startswith("/*") or not words:
                continue
            op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            op = op.split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        mode = ALL_MODES[int(name.split("threefry_kernelILi", 1)[1][0])] if "threefry_kernelILi" in name \
            else name.strip()
        say("sass", kernel=f"threefry<{mode}>", integer=sum(n for o, n in ops.items() if o in integer),
            f32=sum(n for o, n in ops.items() if o in ("FADD", "FFMA", "FMUL", "FMNMX")),
            f64=sum(n for o, n in ops.items() if o in ("DADD", "DFMA", "DMUL", "DSETP")), total=sum(ops.values()),
            opcodes=json.dumps(dict(sorted(ops.items(), key=lambda kv: -kv[1]))))


def threefry_bound_ms(mode: int, n: int):
    """(ms, "bytes" or "operations"): the least time of one threefry launch
    of `mode` over n elements under a tensor key, the largest of its bytes
    over the memory rate, its 32-bit integer operations over the INT32 rate
    and its float operations over the f32 (the 64-bit modes: f64) rate (the
    pipes run side by side)."""
    spec = THREEFRY64 if mode >= len(THREEFRY["modes"]) else THREEFRY
    t_bytes = (n * spec["out_bytes"][mode] + THREEFRY["key_bytes"]) / PEAK_BYTES * 1e3
    int_ops = n * spec["int_ops"][mode] + spec["int_ops_per_launch"].get(mode, 0)
    float_ops = n * spec["f64_ops"][mode] / PEAK_F64_OPS if spec is THREEFRY64 else \
        n * spec["f32_ops"][mode] / PEAK_F32_OPS
    t_ops = max(int_ops / PEAK_INT32_OPS, float_ops) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_ms(spec, pack, args, stats, peak_ops=PEAK_F32_OPS):
    """(bytes bound, operations bound) in ms per launch over the wavefronts
    `args`: each ray's inputs and outputs once and the whole pack once, over
    the memory rate; the box tests x 25, triangle tests x 48 and instance
    entries x 39 the kernel's own plain walk counted on the same rays, each
    over the card's rate for the type it runs in: triangle tests and
    instance entries over `peak_ops` (the walk's real type, f32 or f64),
    box tests over the float rate (every walk tests its boxes in float, a
    float64 walk against a float copy of the ray), the two times summed."""
    from rpt_tpu_torch.ops import bvh8, tlas8

    n_rays = sum(a[0].shape[0] for a in args)
    bytes_per = n_rays * (spec["in_bytes"] + spec["out_bytes"]) / len(args) + pack.nbytes
    box_ops = stats["box_tests"] * bvh8.BOX_TEST_OPS
    ops = stats["tri_tests"] * bvh8.TRI_TEST_OPS + stats.get("inst_entries", 0) * tlas8.INST_ENTRY_OPS
    t_ops = (box_ops / PEAK_F32_OPS + ops / peak_ops) / len(args)
    return bytes_per / PEAK_BYTES * 1e3, t_ops * 1e3


def compare_hits(out_a, out_b, mat_of) -> dict:
    """Two closest-hit walks' outputs on the same rays: the share of rays
    whose hit mask agrees, the hits, the largest |t| difference where both
    hit and whether it is within T_TOL, and the rays where both hit but the
    material or (two-level outputs) the instance differs."""
    import torch

    t_a, t_b = out_a[0], out_b[0]
    hit_a, hit_b = t_a < 1e38, t_b < 1e38
    both = hit_a & hit_b
    differ = mat_of(out_a, both) != mat_of(out_b, both)
    if len(out_a) > 2:
        differ = differ | (out_a[2][both] != out_b[2][both])
    return dict(mask_agree=(hit_a == hit_b).float().mean().item(), hits=int(hit_b.sum()),
                max_abs_t_err=(t_a[both] - t_b[both]).abs().max().item() if bool(both.any()) else 0.0,
                t_ok=bool(torch.allclose(t_a[both], t_b[both], rtol=T_TOL, atol=T_TOL)), differ=int(differ.sum()))


def summed(cs: list) -> dict:
    """`compare_hits` over several wavefronts as one: the lowest mask
    agreement, the largest t error, t within T_TOL on each, hits and
    differing rays summed."""
    return dict(mask_agree=min(c["mask_agree"] for c in cs), hits=sum(c["hits"] for c in cs),
                max_abs_t_err=max(c["max_abs_t_err"] for c in cs), t_ok=all(c["t_ok"] for c in cs),
                differ=sum(c["differ"] for c in cs))


def within_bars(c: dict, differ_share: float) -> bool:
    """Two walks of the same trees agree (`compare_hits`): hit mask on
    PARITY_MIN of the rays, t to T_TOL, and material and instance on all but
    `differ_share` of the hits (two-level: near-ties at coincident faces,
    where f32 box entries decide which face a walk reaches first), on one
    wavefront or on a workload's wavefronts `summed`."""
    return c["mask_agree"] >= PARITY_MIN and c["t_ok"] and c["differ"] <= differ_share * c["hits"]


def binary_vs_wide(family, sd, pack2, rec, mat_of, card):
    """dragon_binary (bvh2 against bvh8) and lego_binary (tlas2 against
    tlas8): the binary kernels against the wide kernels of the same trees on
    every recorded wavefront (`within_bars` over the workload's wavefronts,
    with no material differing on the dragon and under 1e-4 of the hits on
    the city; the any hit on PARITY_MIN of the rays of each), and both kernels' ms per launch, in turns, with their box and
    triangle tests side by side. These launches are comparisons, not the
    main path: they go around the counted wrappers."""
    import torch

    from rpt_tpu_torch.ops import bvh2, bvh8, tlas2, tlas8

    wide = {"bvh2": "bvh8", "tlas2": "tlas8"}[family]
    mod2, mod8 = {"bvh2": (bvh2, bvh8), "tlas2": (tlas2, tlas8)}[family]
    pack8 = bvh8.pack_bvh8(sd.bvh, device=DEVICE) if wide == "bvh8" else tlas8.pack_tlas8(sd.instanced, device=DEVICE)
    cs = []
    for j, args in enumerate(rec[f"{family}_closest"]):
        cs.append(compare_hits(kernel_of(mod2, f"{family}_closest", pack2)(*args),
                               kernel_of(mod8, f"{wide}_closest", pack8)(*args), mat_of))
        say("parity", kernel=f"{family}_closest vs {wide}_closest", rays=f"depth{j}", n=args[0].shape[0], **cs[-1])
    total = summed(cs)
    say("binary_vs_wide", family=family, kind="closest", rays="all depths", **total)
    if not within_bars(total, 0.0 if family == "bvh2" else 1e-4):
        fail("the binary and wide closest-hit kernels disagree")
    for j, args in enumerate(rec[f"{family}_occluded"]):
        occ2 = kernel_of(mod2, f"{family}_occluded", pack2)(*args)
        occ8 = kernel_of(mod8, f"{wide}_occluded", pack8)(*args)
        agree = (occ2 == occ8).float().mean().item()
        say("parity", kernel=f"{family}_occluded vs {wide}_occluded", rays=f"shadow{j}", n=args[0].shape[0],
            agree=f"{agree:.7f}")
        if agree < PARITY_MIN:
            fail(f"the binary and wide any-hit kernels disagree on shadow{j}")
    for kind in ("closest", "occluded"):
        args = rec[f"{family}_{kind}"]
        k2, k8 = kernel_of(mod2, f"{family}_{kind}", pack2), kernel_of(mod8, f"{wide}_{kind}", pack8)
        p2, p8 = getattr(mod2, f"{family}_{kind}_plain"), getattr(mod8, f"{wide}_{kind}_plain")
        # In turns on one card: binary, wide, wide, binary.
        ms2 = time_ms(k2, args, reps=5)
        ms8 = time_ms(k8, args, reps=5)
        ms8 = 0.5 * (ms8 + time_ms(k8, args, reps=5, warmup=False))
        ms2 = 0.5 * (ms2 + time_ms(k2, args, reps=5, warmup=False))
        s2, s8 = {}, {}
        for a in args:
            p2(pack2, *a, stats=s2)
            p8(pack8, *a, stats=s8)
        torch.cuda.synchronize()
        n = len(args)
        say("binary_vs_wide", family=family, kind=kind, binary_ms=f"{ms2:.4f}", wide_ms=f"{ms8:.4f}",
            ratio=f"{ms2 / ms8:.3f}", binary_box_tests=f"{s2['box_tests'] / n:.0f}",
            wide_box_tests=f"{s8['box_tests'] / n:.0f}", binary_tri_tests=f"{s2['tri_tests'] / n:.0f}",
            wide_tri_tests=f"{s8['tri_tests'] / n:.0f}", card=json.dumps(card))


def load_tree(label: str, root: str):
    """The `rpt_tpu_torch` package of another tree of the repository (e.g. a
    `git archive` of the parent commit), imported once as its own package
    `rpt_tpu_torch_<label>`, with its CUDA kernels built from its own
    sources into its own `_build/`. Prints the build's ptxas lines of the
    kernels `before_after` times."""
    name = f"rpt_tpu_torch_{label}"
    if name in sys.modules:
        return name
    pkg = os.path.join(os.path.abspath(root), "rpt_tpu_torch")
    if not os.path.isfile(os.path.join(pkg, "__init__.py")):
        fail(f"RPT_COMPARE names {root}, which holds no rpt_tpu_torch package")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    info = importlib.import_module(f"{name}.kernels").build(force=True)
    TREE_BUILDS[label] = info
    for source in ("bvh8", "tlas8", "bvh2", "tlas2"):
        for line in info[source]["log"].splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "stack frame")):
                say("ptxas", source=f"{label}:{source}", line=json.dumps(line.strip()))
    return name


TREE_BUILDS = {}  # label -> that tree's `kernels.build()` result (its ptxas logs)


def ptxas_kernels(log: str) -> dict:
    """{mangled entry function: (registers, spill store bytes)} of a ptxas log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0]
        elif name is not None:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            if regs:
                out[name][0] = int(regs.group(1))
            if spill:
                out[name][1] = int(spill.group(1))
    return {k: tuple(v) for k, v in out.items()}


def rule_occupancy(regs: int, smem: int, block: int = 128) -> tuple:
    """(blocks, warps) per SM of an H100 for a kernel of `regs` registers
    and `smem` bytes of dynamic shared memory a block, by the occupancy
    rule: 65,536 registers a SM allocated per warp in 256s (8 a thread),
    228 KB of shared memory with 1 KB reserved a block, at most 64 warps
    and 32 blocks."""
    warps_per_block = (block + 31) // 32
    by_regs = 65536 // (((regs + 7) // 8) * 8 * 32 * warps_per_block) if regs else 32
    by_smem = (228 * 1024) // (smem + 1024)
    blocks = min(by_regs, by_smem, 64 // warps_per_block, 32)
    return blocks, blocks * warps_per_block


def compare_trees() -> list:
    """[(label, dir)] of the trees named in RPT_COMPARE (`label=dir,...`)."""
    return [item.split("=", 1) for item in os.environ.get("RPT_COMPARE", "").split(",") if item]


def occupancy_query(mod, family):
    """The occupancy query of `family`'s kernels, (depth, occluded, dtype)
    -> dict, in the tree whose `ops.<family>` is `mod`: `walk.occupancy` of
    its pack type, or in a tree from before `ops/walk.py` its
    `<family>_occupancy`; None in a tree without either."""
    old = getattr(mod, f"{family}_occupancy", None)
    if old is not None:
        return old
    try:
        walk = importlib.import_module(f"{mod.__package__}.walk")
    except ModuleNotFoundError:
        return None
    layout = getattr(mod, f"{family.capitalize()}Pack")
    return lambda depth, occluded, dtype: walk.occupancy(layout, depth, occluded, dtype)


def occupancy_phase(workload: str, family: str, depth: int, card: str) -> None:
    """`[occupancy]`: each of the four kernels of `family` (bvh8, tlas8 or
    tlas2) at the launch `ops/walk.launch` makes for a pack of stack depth
    `depth` (`occupancy_query`), of this tree and of each tree named in
    RPT_COMPARE (a tree without the query by its ptxas log and the rule)."""
    import torch

    from rpt_tpu_torch.ops import walk

    mods = {"this": family_module(family)}
    for label, root in compare_trees():
        mods[label] = importlib.import_module(f"{load_tree(label, root)}.ops.{family}")
    for label, mod in mods.items():
        query = occupancy_query(mod, family)
        if query is None:
            # A tree without the query (the parent of the bvh2 one): its
            # ptxas registers and spill, blocks and warps by the rule, for
            # the kernels of the wrappers' launch.
            if family in ("bvh2", "tlas2"):
                block, smem, on_global = walk.launch_plan(depth)
            else:
                block, smem, on_global = 128, 128 * depth * 4, False
            for entry, (regs, spill) in ptxas_kernels(TREE_BUILDS.get(label, {}).get(family, {}).get("log", "")).items():
                # The query, the stack and the real type from the mangled
                # name: bool template arguments (kOccl, then the pair walks'
                # kGlobalStack), and `_f64` in the name (bvh8, tlas8, tlas2)
                # or the type argument `f` / `d` (bvh2, tlas2's float walk).
                kind = re.search(rf"{family}_walk(_f64)?ILb([01])E(?:Lb([01])E)?([fd])?", entry)
                if kind is None or (kind.group(3) or "0") != str(int(on_global)):
                    continue
                f64 = kind.group(1) is not None or kind.group(4) == "d"
                blocks, warps = rule_occupancy(regs, smem, block)
                say("occupancy", workload=workload, tree=label,
                    kernel=f"{family}_{'occluded' if kind.group(2) == '1' else 'closest'}{'_f64' if f64 else ''}",
                    stack_depth=depth, block=block, smem_bytes=smem, registers=regs, spill_store_bytes=spill,
                    blocks_per_sm=blocks, warps_per_sm=warps, smem_per_sm=blocks * smem, read_from="ptxas and the rule",
                    card=json.dumps(card))
            continue
        for dtype in (torch.float32, torch.float64):
            for kind in ("closest", "occluded"):
                occ = query(depth, kind == "occluded", dtype)
                say("occupancy", workload=workload, tree=label,
                    kernel=f"{family}_{kind}" + ("_f64" if dtype == torch.float64 else ""), stack_depth=depth,
                    **occ, card=json.dumps(card))


def before_after(family, mod, tree, pack, rec, mat_of, card):
    """Every workload with a traversal pack: dragon (bvh8), lego (tlas8),
    lego_toy and dragon_binary (bvh2), lego_binary (tlas2), and their
    float64 twins (each tree's float64 pack of the same scene);
    self-contained (a later PR may delete it whole): the `family` kernels of the trees named in
    RPT_COMPARE (`label=dir,...`), each with its own pack of the same
    scene, against this tree's, on the recorded wavefronts, timed in turns
    (trees, this, this, trees reversed; 30 passes through the wavefronts
    each; then in turns again inside CUDA graphs) on one card, with each
    pack's node bytes, size and stack depth,
    and each tree's box and triangle tests per launch. Each tree's answers
    are compared with this tree's: bit for bit, and (`compare_hits`) the
    hit mask, t and the rays whose material or instance differs; those must
    stay within `within_bars` (a tree may walk in another order and break
    near-ties otherwise). These launches go around the counted wrappers."""
    import torch

    trees = compare_trees()
    if not trees:
        say("before_after", family=family, skipped="RPT_COMPARE names no tree")
        return
    mods = {"this": mod}
    packs = {"this": pack}
    for label, root in trees:
        mods[label] = importlib.import_module(f"{load_tree(label, root)}.ops.{family}")
        packs[label] = getattr(mods[label], f"pack_{family}")(tree, device=DEVICE)
    labels = [label for label, _ in trees]
    turns = labels + ["this", "this"] + labels[::-1]
    for label, p in packs.items():
        say("before_after", family=family, tree=label, node_bytes=getattr(p, "node_bytes", "not carried"),
            pack_mb=f"{p.nbytes / 2**20:.3f}",
            **{k: getattr(p, k) for k in ("group_depth", "stack_depth", "stack_need") if hasattr(p, k)})

    def kernel(label, kind):
        return kernel_of(mods[label], f"{family}_{kind}", packs[label])

    for kind in ("closest", "occluded"):
        args = rec[f"{family}_{kind}"]
        ref = [kernel("this", kind)(*a) for a in args]
        for label in labels:
            out = [kernel(label, kind)(*a) for a in args]
            same = all(all(map(torch.equal, o, r)) if kind == "closest" else torch.equal(o, r) for o, r in zip(out, ref))
            if kind == "closest":
                agree = summed([compare_hits(o, r, mat_of) for o, r in zip(out, ref)])
                ok = within_bars(agree, 1e-4)
            else:
                n_differ = sum(int((o != r).sum()) for o, r in zip(out, ref))
                n_rays = sum(r.numel() for r in ref)
                agree = dict(agree=f"{1.0 - n_differ / n_rays:.7f}", differ=n_differ)
                ok = n_differ <= (1.0 - PARITY_MIN) * n_rays
            say("before_after", family=family, kind=kind, tree=label, bit_equal_to_this=same, **agree)
            if not ok:
                fail(f"the {family} {kind} kernels of {label} and this tree disagree")
        times = {label: [] for label in turns}
        for label in turns:
            times[label].append(time_ms(kernel(label, kind), args, reps=30))
        ms = {label: sum(v) / len(v) for label, v in times.items()}
        say("before_after", family=family, kind=kind, launches=len(args),
            **{f"{label}_ms": f"{ms[label]:.4f}" for label in ms},
            **{f"{label}_turns_ms": json.dumps([round(t, 5) for t in times[label]]) for label in ms},
            **{f"{label}_over_this": f"{ms[label] / ms['this']:.3f}" for label in labels}, card=json.dumps(card))
        # The same turns inside CUDA graphs: the device's time per launch,
        # without the host's cost of a launch from Python.
        gtimes = {label: [] for label in turns}
        for label in turns:
            gtimes[label].append(time_graph_ms(kernel(label, kind), args, reps=10))
        gms = {label: sum(v) / len(v) for label, v in gtimes.items()}
        say("before_after", family=family, kind=kind, timed="in a graph",
            **{f"{label}_graph_ms": f"{gms[label]:.4f}" for label in gms},
            **{f"{label}_graph_turns_ms": json.dumps([round(t, 5) for t in gtimes[label]]) for label in gms},
            **{f"{label}_graph_over_this": f"{gms[label] / gms['this']:.3f}" for label in labels},
            card=json.dumps(card))
        # Each tree's box and triangle tests per launch, counted by its own
        # plain walk on the same rays.
        tests = {}
        for label in mods:
            stats = {}
            for a in args:
                getattr(mods[label], f"{family}_{kind}_plain")(packs[label], *a, stats=stats)
            tests[f"{label}_box_tests"] = f"{stats['box_tests'] / len(args):.0f}"
            tests[f"{label}_tri_tests"] = f"{stats['tri_tests'] / len(args):.0f}"
        say("before_after", family=family, kind=kind, **tests)


def dtype_phase(card: str) -> None:
    """`[dtype]`: one scene (`cornell`) rendered in float32, then float64,
    then float32 again, at a size no workload takes: each type captures a
    graph of its own, once; the second float32 render replays the first
    one's graph and equals it bit for bit; the float64 sums are float64."""
    import torch

    from rpt_tpu_torch import Renderer
    from rpt_tpu_torch.renderer import make_render_many_fn
    from rpt_tpu_torch.scenes import scene_and_camera

    scene, camera, eps = scene_and_camera("cornell")
    w, h, bounces = 320, 180, 2
    r32, r64 = (Renderer(scene, camera, width=w, height=h, max_bounces=bounces, num_samples=2, epsilon=eps,
                         device=DEVICE, dtype=dt) for dt in (torch.float32, torch.float64))
    first = r32.render_buffer()
    fn32 = make_render_many_fn(r32.scene_data(), w, h, bounces)
    graph32 = fn32.capture(eps).graph
    wide = r64.render_buffer()
    fn64 = make_render_many_fn(r64.scene_data(), w, h, bounces)
    again = r32.render_buffer()
    torch.cuda.synchronize()
    same = bool(torch.equal(first.sum, again.sum) and torch.equal(first.sum_sq, again.sum_sq))
    replayed = make_render_many_fn(r32.scene_data(), w, h, bounces) is fn32 and fn32.capture(eps).graph is graph32
    say("dtype", scene="cornell", size=f"{w}x{h}", order="f32, f64, f32", f32_captures=len(fn32.captures),
        f64_captures=len(fn64.captures), separate_graphs=fn32 is not fn64, f32_graph_replayed=replayed,
        f32_renders_bit_equal=same, f64_sum_dtype=str(wide.sum.dtype),
        f64_mean_over_f32_mean=f"{float(wide.sum.mean()) / float(first.sum.mean()):.5f}", card=json.dumps(card))
    if not (same and replayed and fn32 is not fn64 and len(fn32.captures) == 1 and len(fn64.captures) == 1
            and wide.sum.dtype == torch.float64 and bool(torch.isfinite(wide.sum).all())):
        fail("float32 and float64 renders of one scene do not keep to graphs of their own")


@contextlib.contextmanager
def plain_walks():
    """The walks' wrappers launch nothing and run their plain walks on the
    card instead (the yardstick of a gradient through the kernels)."""
    from rpt_tpu_torch.ops import walk

    def plain(pack, o, d, t_min, t_max=None, active=None, launches=None):
        return pack.plain(o, d, t_min, t_max, active)

    saved, walk.launch = walk.launch, plain
    try:
        yield
    finally:
        walk.launch = saved


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (the gather's backward, a
    scatter-add, without atomics in run-dependent order), their warnings
    silenced."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def grad_step(fn, mats0):
    """One forward and backward step of mean(image) over fresh material
    leaves: (image, {leaf: gradient}, forward seconds, backward seconds),
    each span ending in a synchronize."""
    import dataclasses

    import torch

    from rpt_tpu_torch.materials import MaterialTable

    leaves = {f.name: getattr(mats0, f.name).detach().clone().requires_grad_(f.name in GRAD_FIELDS)
              for f in dataclasses.fields(MaterialTable)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = fn(MaterialTable(**leaves))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img.mean().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {f: leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f]) for f in GRAD_FIELDS}
    return img.detach(), grads, t1 - t0, t2 - t1


def grad_error(got: dict, want: dict) -> tuple:
    """(largest |got - want| over the leaves, each over its leaf's largest
    |want|; whether every leaf is bit for bit; whether all are finite)."""
    import torch

    err = 0.0
    for f, w in want.items():
        w, g = w.detach().double().cpu(), got[f].detach().double().cpu()
        err = max(err, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    bit = all(torch.equal(got[f].cpu(), want[f].cpu()) for f in want)
    finite = all(bool(torch.isfinite(v).all()) for v in [*got.values(), *want.values()])
    return err, bit, finite


def grad_workload(name: str, card: str, counters: dict) -> dict:
    """`[grad]` of one workload at 960x540: a warm-up step; the forward
    with autograd off; the gradient's main path, one counted forward and
    backward step (every launch count set to 0 just before and read just
    after; the backward recomputes each sample, so each kernel launches
    twice per sample and path vertex); peak memory at spp 1 and 2; the
    gradient through the kernels against the plain walks' on the card; one
    profiled step. Returns the launches per sample by kernel."""
    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch.grad import make_diff_render
    from rpt_tpu_torch.scenes import scene_and_camera

    spec = GRAD_WORKLOADS[name]
    family, bounces, spp, shadow = spec["family"], spec["bounces"], spec["spp"], spec["shadow"]
    scene, camera, eps = scene_and_camera(name)
    fn, mats0 = make_diff_render(scene, camera, WIDTH, HEIGHT, max_bounces=bounces, spp=spp, epsilon=eps,
                                 device=DEVICE)
    fn1, _ = make_diff_render(scene, camera, WIDTH, HEIGHT, max_bounces=bounces, spp=1, epsilon=eps, device=DEVICE)
    if pack_of(scene.compile(device=DEVICE), family) is None:
        fail(f"[grad] {name} compiled without a {family} pack")
    grad_step(fn, mats0)  # warm-up
    fwd_off = []
    for _ in range(GRAD_TURNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fn(mats0)
        torch.cuda.synchronize()
        fwd_off.append(time.perf_counter() - t0)

    # The gradient's main path. Peaks are read absolute and above what
    # was allocated before the step (earlier phases' graphs and scenes).
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    img, grads, fwd_on, bwd = grad_step(fn, mats0)
    launches = named_counts(counters)
    peak = {spp: torch.cuda.max_memory_allocated()}
    steps = [(fwd_on, bwd)] + [grad_step(fn, mats0)[2:] for _ in range(GRAD_TURNS - 1)]
    fwd_on, bwd = statistics.median(f for f, _ in steps), statistics.median(b for _, b in steps)
    step = statistics.median(f + b for f, b in steps)
    want = {n: 0 for n in counters}
    want[f"{family}_closest"] = 2 * (bounces + 1) * spp
    want[f"{family}_occluded"] = 2 * shadow * (bounces + 1) * spp
    want["scatter"] = 2 * bounces * spp
    walks = {n: c for n, c in launches.items() if not n.startswith("threefry")}
    if walks != {n: c for n, c in want.items() if not n.startswith("threefry")} or launches["threefry"] <= 0:
        fail(f"[grad] the {name} step launched {launches}, not the walks {want}")
    if not bool(torch.isfinite(img).all()) or any(not bool(torch.isfinite(g).all()) for g in grads.values()):
        fail(f"[grad] the {name} image or gradient is not finite")
    if not any(float(g.abs().max()) > 0.0 for g in grads.values()):
        fail(f"[grad] every {name} gradient is zero")
    torch.cuda.reset_peak_memory_stats()
    grad_step(fn1, mats0)
    peak[1] = torch.cuda.max_memory_allocated()

    # Through the kernels and through the plain walks on the card, and the
    # kernels once more, under deterministic algorithms.
    with deterministic():
        _, g_kern, _, _ = grad_step(fn, mats0)
        _, g_again, _, _ = grad_step(fn, mats0)
        with plain_walks():
            _, g_plain, _, _ = grad_step(fn, mats0)
    err, bit, finite = grad_error(g_kern, g_plain)
    again_bit = grad_error(g_again, g_kern)[1]
    close = grad_error(grads, g_kern)[0]

    wall_us, busy, events = profiled(lambda: grad_step(fn1, mats0))
    by_name = device_us_by_name(events) if events else {}
    total = sum(by_name.values())
    walk_us = sum(v for k, v in by_name.items() if f"{family}_walk" in k)
    rays = (bounces + 1) * (1 + shadow) * WIDTH * HEIGHT * spp
    per_sample = {n: launches[n] / spp for n in counters}
    # The step's wall rate rides on the host (launch-bound); the profiled
    # spp-1 step's device-busy time is the stable number beside it.
    busy_rate = dict(step_device_busy_ms_spp1=f"{busy / 1e3:.2f}",
                     mrays_per_s_device_busy=f"{rays / spp / (busy / 1e6) / 1e6:.3f}") if events else \
        dict(step_device_busy_ms_spp1="not measured (the profiler recorded no CUDA kernels)")
    say("grad", workload=name, size=f"{WIDTH}x{HEIGHT}", bounces=bounces, spp=spp, leaves=",".join(GRAD_FIELDS),
        turns=GRAD_TURNS, forward_ms_per_sample_grad_off=f"{statistics.median(fwd_off) * 1e3 / spp:.2f}",
        forward_ms_per_sample_grad_on=f"{fwd_on * 1e3 / spp:.2f}",
        backward_ms_per_sample=f"{bwd * 1e3 / spp:.2f}", step_seconds=f"{step:.4f}",
        step_seconds_each=json.dumps([round(f + b, 4) for f, b in steps]),
        mrays_per_s_step=f"{rays / step / 1e6:.3f}",
        mrays_per_s_step_range=f"{rays / max(f + b for f, b in steps) / 1e6:.3f}-"
                               f"{rays / min(f + b for f, b in steps) / 1e6:.3f}",
        **busy_rate, allocated_before_mib=f"{before / 2**20:.1f}",
        **{f"peak_mib_spp{k}": f"{v / 2**20:.1f}" for k, v in sorted(peak.items())},
        **{f"step_peak_mib_spp{k}": f"{(v - before) / 2**20:.1f}" for k, v in sorted(peak.items())},
        launches=json.dumps(launches),
        launches_per_sample=json.dumps(per_sample), image_mean=f"{float(img.mean()):.6f}", card=json.dumps(card))
    say("grad", workload=name, kernels_vs_plain_walks_max_rel_err=f"{err:.3e}", bit_equal=bit,
        deterministic=True, kernels_run_twice_bit_equal=again_bit, nondeterministic_vs_deterministic=f"{close:.3e}",
        grad_abs_max=json.dumps({f: float(g.abs().max()) for f, g in g_kern.items()}))
    if events:
        say("grad", workload=name, profiled="one step at spp 1", window_ms=f"{wall_us / 1e3:.2f}",
            device_busy_ms=f"{busy / 1e3:.2f}", idle_share=f"{1.0 - busy / wall_us:.3f}", kernel_launches=len(events),
            **{f"{family}_share_of_device_time": f"{walk_us / total:.3f}"}, card=json.dumps(card))
        for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            say("grad", workload=name, profiled="one step at spp 1", kernel=json.dumps(k), device_ms=f"{us / 1e3:.3f}",
                share=f"{us / total:.3f}")
    else:
        say("grad", workload=name, device_time="not measured (the profiler recorded no CUDA kernels)")
    if not finite or not (bit or err <= GRAD_PLAIN_RTOL):
        fail(f"[grad] the {name} gradient through the {family} kernels differs from the plain walks': {err:.3e}")
    return {f"{family}_{kind}": per_sample[f"{family}_{kind}"] for kind in ("closest", "occluded")} | \
        {"scatter": per_sample["scatter"]}


def grad_small_phase(card: str) -> None:
    """`[grad]` at a small size, the card against the CPU: the material
    gradient of the 5,000-triangle trefoil (64x48, 2 bounces, spp 2)
    through the bvh8 kernels (the wide threshold lowered below its rows)
    against the plain walks on the CPU; the camera gradient (eye,
    direction, fov) of `cornell`, which has no BVH; and a camera gradient
    through the trefoil's BVH, which must raise."""
    import dataclasses

    import rpt_tpu_torch.scene as scene_mod
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.grad import make_diff_render, render_with_camera
    from rpt_tpu_torch.scenes import build_dragon_scene, dragon_camera, scene_and_camera

    saved = scene_mod.WIDE_KERNEL_MIN_TRIS
    scene_mod.WIDE_KERNEL_MIN_TRIS = 4096
    try:
        scene, camera = build_dragon_scene(segments=125, sides=20), dragon_camera()
        grads = {}
        for dev in ("cpu", DEVICE):
            fn, mats0 = make_diff_render(scene, camera, SMALL_W, SMALL_H, max_bounces=2, spp=2, device=dev)
            if pack_of(scene.compile(device=dev), "bvh8") is None:
                fail("[grad] the small trefoil compiled without a bvh8 pack")
            grads[dev] = grad_step(fn, mats0)[1]
        err, _, finite = grad_error(grads[DEVICE], grads["cpu"])
        say("grad", workload="trefoil_5k", size=f"{SMALL_W}x{SMALL_H}", bounces=2, spp=2, walk="bvh8",
            card_vs_cpu_max_rel_err=f"{err:.3e}", bar=GRAD_CPU_RTOL, finite=finite)
        if not finite or err > GRAD_CPU_RTOL:
            fail(f"[grad] the small trefoil's gradient on the card differs from the CPU's: {err:.3e}")

        eye = camera.eye.detach().clone().requires_grad_()
        try:
            render_with_camera(dataclasses.replace(camera, eye=eye), scene.compile(device=DEVICE), rnd.PRNGKey(0),
                               SMALL_W, SMALL_H, 0, 1e-3, 1.0)
        except ValueError as e:
            say("grad", workload="trefoil_5k", camera_gradient_through_bvh="raises", error=json.dumps(str(e)[:80]))
        else:
            fail("[grad] a camera gradient through the trefoil's BVH did not raise")
    finally:
        scene_mod.WIDE_KERNEL_MIN_TRIS = saved

    scene, camera, eps = scene_and_camera("cornell")
    grads = {}
    for dev in ("cpu", DEVICE):
        sd = scene.compile(device=dev)
        leaves = {f: getattr(camera, f).detach().clone().requires_grad_() for f in ("eye", "direction", "fov")}
        img = render_with_camera(dataclasses.replace(camera, **leaves), sd, rnd.PRNGKey(0), SMALL_W, SMALL_H, 2, eps,
                                 1.0)
        img.mean().backward()
        grads[dev] = {f: v.grad for f, v in leaves.items()}
    err, _, finite = grad_error(grads[DEVICE], grads["cpu"])
    say("grad", workload="cornell", size=f"{SMALL_W}x{SMALL_H}", bounces=2, spp=1, leaves="eye,direction,fov",
        card_vs_cpu_max_rel_err=f"{err:.3e}", bar=GRAD_CPU_RTOL, finite=finite,
        eye_grad=json.dumps([float(v) for v in grads[DEVICE]["eye"]]), card=json.dumps(card))
    if not finite or err > GRAD_CPU_RTOL:
        fail(f"[grad] cornell's camera gradient on the card differs from the CPU's: {err:.3e}")


@contextlib.contextmanager
def kernel_choice(bvh_kernel: str, wide_min=None):
    """Scenes compile under RPT_BVH_KERNEL=`bvh_kernel` (and, if given,
    `WIDE_KERNEL_MIN_TRIS`), restored after."""
    import rpt_tpu_torch.scene as scene_mod

    saved = scene_mod._BVH_KERNEL, scene_mod.WIDE_KERNEL_MIN_TRIS
    scene_mod._BVH_KERNEL = bvh_kernel
    if wide_min is not None:
        scene_mod.WIDE_KERNEL_MIN_TRIS = wide_min
    try:
        yield
    finally:
        scene_mod._BVH_KERNEL, scene_mod.WIDE_KERNEL_MIN_TRIS = saved


def grad_family(name: str, card: str, counters: dict) -> dict:
    """`[grad]` of one entry of GRAD_FAMILIES (see there). Returns the
    walks' launches per differentiated sample by kernel row name."""
    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch.grad import make_diff_render
    from rpt_tpu_torch.scenes import build_brick_city, build_dragon_scene, dragon_camera, lego_camera, scene_and_camera

    spec = GRAD_FAMILIES[name]
    family, bounces, shadow = spec["family"], GRAD_FAMILY_BOUNCES, spec["shadow"]
    dtype = getattr(torch, spec.get("dtype", "float32"))
    slot = 0 if dtype == torch.float32 else 1
    w, h = GRAD_FAMILY_SIZE
    t0 = time.perf_counter()
    with kernel_choice(spec["bvh_kernel"]):
        scene, camera, eps = scene_and_camera(spec["scene"])
        if pack_of(scene.compile(dtype, device=DEVICE), family) is None:
            fail(f"[grad] {name} compiled without a {family} pack")
        fn, mats0 = make_diff_render(scene, camera, w, h, max_bounces=bounces, spp=1, epsilon=eps, device=DEVICE,
                                     dtype=dtype)
        with deterministic():
            kernels.reset_launch_counts()
            img, g_kern, _, _ = grad_step(fn, mats0)
            launches = named_counts(counters)
            by_slot = kernels.launch_counts(by_slot=True)
            with plain_walks():
                _, g_plain, _, _ = grad_step(fn, mats0)
    err, bit, finite = grad_error(g_kern, g_plain)
    want = {n: 0 for n in counters if not n.startswith("threefry")}
    want[f"{family}_closest"] = 2 * (bounces + 1)
    want[f"{family}_occluded"] = 2 * shadow * (bounces + 1)
    want["scatter"] = 2 * bounces
    walks = {n: c for n, c in launches.items() if not n.startswith("threefry")}
    in_slot = {n: by_slot[counters[n]][slot] for n in want}
    if walks != want or in_slot != want:
        fail(f"[grad] the {name} step launched {launches} ({in_slot} of {dtype}), not the walks {want}")
    if not finite or not bool(torch.isfinite(img).all()) or not any(float(g.abs().max()) > 0 for g in g_kern.values()):
        fail(f"[grad] the {name} image or gradient is not finite, or every gradient is zero")
    if not (bit or err <= GRAD_PLAIN_RTOL):
        fail(f"[grad] the {name} gradient through the {family} kernels differs from the plain walks': {err:.3e}")

    # The card against the CPU on a small scene of the same kernel choice.
    small = {}
    with kernel_choice(spec["bvh_kernel"], wide_min=4096):
        if spec["scene"] == "dragon":
            s_scene, s_camera = build_dragon_scene(segments=125, sides=20), dragon_camera()
        else:
            s_scene, s_camera = build_brick_city(n_instances=96), lego_camera()
        for dev in ("cpu", DEVICE):
            if pack_of(s_scene.compile(dtype, device=dev), family) is None:
                fail(f"[grad] {name}'s small scene compiled without a {family} pack")
            fn_s, m_s = make_diff_render(s_scene, s_camera, *GRAD_FAMILY_SMALL, max_bounces=bounces, spp=1,
                                         device=dev, dtype=dtype)
            small[dev] = grad_step(fn_s, m_s)[1]
    cpu_err, _, cpu_finite = grad_error(small[DEVICE], small["cpu"])
    say("grad", workload=name, walk=family, dtype=str(dtype).removeprefix("torch."), size=f"{w}x{h}",
        bounces=bounces, spp=1, kernels_vs_plain_walks_max_rel_err=f"{err:.3e}", bit_equal=bit, deterministic=True,
        launches=json.dumps(launches), image_mean=f"{float(img.mean()):.6f}",
        small_card_vs_cpu_max_rel_err=f"{cpu_err:.3e}", small_size="x".join(map(str, GRAD_FAMILY_SMALL)),
        bar=GRAD_CPU_RTOL,
        phase_seconds=f"{time.perf_counter() - t0:.1f}", card=json.dumps(card))
    if not cpu_finite or cpu_err > GRAD_CPU_RTOL:
        fail(f"[grad] the small {name} gradient on the card differs from the CPU's: {cpu_err:.3e}")
    suffix = "_f64" if slot else ""
    return {f"{family}_{kind}{suffix}": want[f"{family}_{kind}"] for kind in ("closest", "occluded")} | \
        {f"scatter{suffix}": want["scatter"]}


def grad_phase(card: str) -> dict:
    """`[grad]`: the small checks, then each workload of GRAD_WORKLOADS and
    each entry of GRAD_FAMILIES. Returns {kernel row name: (workload,
    launches per differentiated sample)}."""
    counters = counted_wrappers()
    grad_small_phase(card)
    out = {}
    for name in GRAD_WORKLOADS:
        for kernel, n in grad_workload(name, card, counters).items():
            out[kernel] = (name, n)
    for name in GRAD_FAMILIES:
        for kernel, n in grad_family(name, card, counters).items():
            out[kernel] = (name, n)
    return out


def ode_phase(card: str) -> None:
    """`[ode]`: one frame of the marbles' RK4 (ODE_FRAME at ODE_STEP) on the
    card, graphed (one captured step replayed) against eager, bit for bit,
    and against the CPU within ODE_CPU_ATOL, on the example's initial state
    and on a packed state in contact; ms per step each way, kernels and
    device time of one step, the capture's seconds."""
    import numpy as np
    import torch

    from rpt_tpu_torch.ode import MarblesSystem, ParticleState
    from rpt_tpu_torch.scenes import MARBLE_RADIUS, marbles_initial_state

    system = MarblesSystem(MARBLE_RADIUS)
    packed = np.random.RandomState(42).randn(25, 3) * 0.3 + np.array([0.0, 2.0, 0.0])
    states = {"initial": marbles_initial_state(device=DEVICE), "packed": ParticleState.create(packed, device=DEVICE)}
    n_steps = int(np.floor(ODE_FRAME / ODE_STEP - 1e-12))
    for name, state in states.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed = system.rk4_integrate(state, ODE_FRAME, ODE_STEP)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eager = system._rk4_eager(state, ODE_FRAME, ODE_STEP)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cpu = system.rk4_integrate(ParticleState.create(state.pos.cpu(), state.vel.cpu(), device="cpu"), ODE_FRAME,
                                   ODE_STEP)
        bit = bool(torch.equal(graphed.pos, eager.pos) and torch.equal(graphed.vel, eager.vel))
        err = max(float((getattr(graphed, f).cpu().double() - getattr(cpu, f).double()).abs().max())
                  for f in ("pos", "vel"))
        finite = bool(torch.isfinite(graphed.pos).all() and torch.isfinite(graphed.vel).all())
        say("ode", state=name, marbles=state.pos.shape[0], steps=n_steps + 1, graphed_vs_eager_bit_equal=bit,
            card_vs_cpu_max_abs=f"{err:.3e}", bar=ODE_CPU_ATOL, frame_seconds_graphed=f"{t1 - t0:.4f}",
            frame_seconds_eager=f"{t2 - t1:.4f}", finite=finite)
        if not (bit and finite and err <= ODE_CPU_ATOL):
            fail(f"[ode] the {name} frame: graphed == eager {bit}, card against CPU {err:.3e}")

    graph = system._rk4_graph(25, ODE_STEP, DEVICE)
    state = states["packed"]
    replay_ms = time_ms(lambda: graph(state, 100), [()], reps=3) / 100
    eager_ms = time_ms(lambda: system.rk4_step(state, ODE_STEP), [()], reps=50)
    wall_step_ms = wall_ms(lambda: graph(state, 100), reps=3) / 100
    wall_eager_ms = wall_ms(lambda: system.rk4_step(state, ODE_STEP), reps=50)
    _, busy_us, events = profiled(lambda: system.rk4_step(state, ODE_STEP))
    # On CUDA events: a replay's device time; for the eager step, the pace
    # at which the host enqueues it (the card idles between its kernels).
    say("ode", ms_per_step_graphed=f"{wall_step_ms:.4f}", ms_per_step_eager=f"{wall_eager_ms:.4f}",
        event_ms_per_step_graphed=f"{replay_ms:.4f}", event_ms_per_step_eager=f"{eager_ms:.4f}",
        kernels_per_step=len(events) if events else "not measured (the profiler recorded no CUDA kernels)",
        device_busy_ms_per_step=f"{busy_us / 1e3:.4f}" if events else "not measured",
        capture_seconds=f"{graph.capture.seconds:.3f}", pool_mib=f"{graph.capture.pool_bytes / 2**20:.1f}",
        card=json.dumps(card))


@contextlib.contextmanager
def timed_lookup(module, name: str, rec: dict):
    """Time `module.name` (a pass lookup: the cache, and the dynamic path's
    refill), each call ending in a synchronize; `rec` gets the seconds and
    the function it returned."""
    import torch

    orig = getattr(module, name)

    def wrapped(*args):
        t0 = time.perf_counter()
        fn = orig(*args)
        torch.cuda.synchronize()
        rec.update(seconds=time.perf_counter() - t0, fn=fn)
        return fn

    setattr(module, name, wrapped)
    try:
        yield rec
    finally:
        setattr(module, name, orig)


def dynamic_frame(cell: str, way: str, scene, camera, eps: float, seed: int, counters: dict):
    """One frame of a `[dynamic]` cell through the entry point, dynamic or
    static: (buffer, split in seconds, launches counted from 0). A frame
    that captures also runs the capture's eager warm-up pass, so it
    launches `split["passes"]` = spp + captures passes' kernels."""
    import torch

    from rpt_tpu_torch import Renderer, kernels
    from rpt_tpu_torch import renderer as renderer_mod

    spec = DYNAMIC_CELLS[cell]
    (w, h), dynamic = spec["size"], way == "dynamic"
    dtype = getattr(torch, spec.get("dtype", "float32"))
    r = Renderer(scene, camera, width=w, height=h, max_bounces=spec["bounces"], num_samples=spec["spp"],
                 epsilon=eps, seed=seed, dtype=dtype, dynamic=dynamic, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = scene.compile(dtype, device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = renderer_mod._DYNAMIC_CACHE if dynamic else renderer_mod._MANY_CACHE
    caps = cache.captures()
    kernels.reset_launch_counts()
    rec = {}
    with timed_lookup(renderer_mod, "dynamic_render_many_fn" if dynamic else "make_render_many_fn", rec):
        buf = r.render_buffer(scene_data=sd)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = named_counts(counters)
    captured = cache.captures() - caps
    capture = rec["fn"].capture(r.epsilon).seconds if captured else 0.0
    split = dict(compile=t1 - t0, lookup=rec["seconds"], capture=capture,
                 replays=t2 - t1 - rec["seconds"] - capture, total=t2 - t0, captures=captured,
                 passes=spec["spp"] + captured)
    if dynamic:
        split["refill_bytes"] = sum(t.numel() * t.element_size() for t in renderer_mod._tensor_leaves(sd))
    return buf, split, launches


def moved_city(city, offset: float):
    """A copy of a brick city's scene with every instance moved by `offset`
    in x; the plane and the lights stay."""
    from rpt_tpu_torch import Object, Scene, Transformed

    scene = Scene()
    for obj in city.objects:
        shape = obj.shape.translate([offset, 0.0, 0.0]) if isinstance(obj.shape, Transformed) else obj.shape
        scene.add(Object(shape, obj.mat))
    for light in city.lights:
        scene.add(light)
    return scene


def dynamic_cell(cell: str, card: str, counters: dict) -> dict:
    """`[dynamic]` of one cell, under its kernel choice: its frames
    (DYNAMIC_FRAMES unless it says), each through the dynamic path and the
    static one in turns, bit for bit with equal launch counts; the dynamic
    loop must capture once; then a frame of another topology, which must
    make a second entry and capture. Returns the dynamic loop's launches."""
    spec = DYNAMIC_CELLS[cell]
    with kernel_choice(spec.get("bvh_kernel", "wide"), spec.get("wide_min")):
        return _dynamic_cell(cell, card, counters)


def _dynamic_cell(cell: str, card: str, counters: dict) -> dict:
    import torch

    from rpt_tpu_torch import renderer as renderer_mod
    from rpt_tpu_torch.ode import MarblesSystem, ParticleState
    from rpt_tpu_torch.renderer import DEFAULT_EPSILON, SceneCache
    from rpt_tpu_torch.scenes import (MARBLE_RADIUS, build_brick_city, build_dragon_orbit_scene, build_marbles_scene,
                                      dragon_camera, lego_camera, marbles_camera, marbles_initial_state,
                                      trefoil_mesh)

    spec = DYNAMIC_CELLS[cell]
    frames = spec.get("frames", DYNAMIC_FRAMES)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    renderer_mod._MANY_CACHE = SceneCache()  # earlier phases' graphs and pools go
    torch.cuda.empty_cache()
    entries0, caps0 = len(renderer_mod._DYNAMIC_CACHE), renderer_mod._DYNAMIC_CACHE.captures()
    physics = []
    if cell == "dragon_orbit" or cell.startswith("orbit_"):
        knot = {} if cell == "dragon_orbit" else dict(segments=125, sides=20)
        mesh, camera, eps = trefoil_mesh(**knot), dragon_camera(), 1e-3

        def scene_of(i):
            return build_dragon_orbit_scene(i, frames, mesh)
    elif cell.startswith("city_"):
        city, camera, eps = build_brick_city(n_instances=96), lego_camera(), 1e-3

        def scene_of(i):
            return moved_city(city, 0.5 * i)
    else:
        camera, eps, system = marbles_camera(), DEFAULT_EPSILON, MarblesSystem(MARBLE_RADIUS)
        states = [marbles_initial_state(device=DEVICE)]
        for _ in range(frames - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states.append(system.rk4_integrate(states[-1], ODE_FRAME, ODE_STEP))
            torch.cuda.synchronize()
            physics.append(time.perf_counter() - t0)

        def scene_of(i):
            return build_marbles_scene(states[i], test_mode=False)

    def same_per_pass(a, b) -> bool:
        (_, sa, la), (_, sb, lb) = a, b
        return all(la[n] * sb["passes"] == lb[n] * sa["passes"] for n in la)

    splits = {"dynamic": [], "static": []}
    total, passes = {n: 0 for n in counters}, 0
    if spec["family"] and pack_of(scene_of(0).compile(dtype, device=DEVICE), spec["family"]) is None:
        fail(f"[dynamic] {cell} compiled without a {spec['family']} pack")
    for i in range(frames):
        ways = ("dynamic", "static") if i % 2 == 0 else ("static", "dynamic")
        out = {}
        for way in ways:
            out[way] = dynamic_frame(cell, way, scene_of(i), camera, eps, i, counters)
            splits[way].append(out[way][1])
        (dyn, split, launches), stat = out["dynamic"], out["static"][0]
        passes += split["passes"]
        for n, c in launches.items():
            total[n] += c
        same = bool(torch.equal(dyn.sum, stat.sum) and torch.equal(dyn.sum_sq, stat.sum_sq))
        if not same or not same_per_pass(out["dynamic"], out["static"]):
            fail(f"[dynamic] {cell} frame {i}: dynamic == static {same}, launches {launches} in "
                 f"{split['passes']} passes, static {out['static'][2]} in {out['static'][1]['passes']}")
        if not bool(torch.isfinite(dyn.sum).all()):
            fail(f"[dynamic] {cell} frame {i} is not finite")
    entries, caps = len(renderer_mod._DYNAMIC_CACHE) - entries0, renderer_mod._DYNAMIC_CACHE.captures() - caps0
    per_sample = {n: c / passes for n, c in total.items()}
    walks = {n: c for n, c in per_sample.items() if not n.startswith("threefry")}
    want = {n: 0 for n in walks}
    want["scatter"] = spec["bounces"]
    if spec["family"]:
        want[f"{spec['family']}_closest"] = spec["bounces"] + 1
        want[f"{spec['family']}_occluded"] = spec["shadow"] * (spec["bounces"] + 1)
    if entries != 1 or caps != 1 or walks != want or per_sample["threefry"] <= 0:
        fail(f"[dynamic] {cell}: {entries} entries, {caps} captures, launches per sample {per_sample}, not {want}")

    def mean(way, k):
        vals = [sp[k] for sp in splits[way]]
        return sum(vals) / len(vals)

    for way in ("dynamic", "static"):
        n = len(splits[way])
        say("dynamic", cell=cell, way=way, frames=n, size="x".join(map(str, spec["size"])), bounces=spec["bounces"],
            spp=spec["spp"], seconds_per_frame=f"{mean(way, 'total'):.4f}", fps=f"{1.0 / mean(way, 'total'):.3f}",
            compile_s=f"{mean(way, 'compile'):.4f}", lookup_s=f"{mean(way, 'lookup'):.4f}",
            capture_s_total=f"{sum(sp['capture'] for sp in splits[way]):.3f}",
            captures=sum(sp["captures"] for sp in splits[way]), replays_s=f"{mean(way, 'replays'):.4f}",
            **({"refill_bytes": splits[way][0]["refill_bytes"],
                "refill_ms_after_first": f"{1e3 * sum(sp['lookup'] for sp in splits[way][1:]) / max(n - 1, 1):.3f}"}
               if way == "dynamic" else {}),
            frame_seconds=json.dumps([round(sp["total"], 4) for sp in splits[way]]), card=json.dumps(card))
    say("dynamic", cell=cell, bit_equal_frames=frames, dtype=str(dtype).removeprefix("torch."), entries=entries,
        captures=caps,
        launches=json.dumps(total), passes=passes, launches_per_sample=json.dumps(per_sample),
        **({"physics_seconds_per_frame": f"{sum(physics) / len(physics):.4f}"} if physics else {}))

    # A frame of another topology: a trefoil of another size, half the
    # city, one more marble.
    if cell == "dragon_orbit":
        scene = build_dragon_orbit_scene(frames, frames, trefoil_mesh(segments=500, sides=100))
        change = "trefoil 100,000 triangles"
    elif cell.startswith("orbit_"):
        scene = build_dragon_orbit_scene(frames, frames, trefoil_mesh(segments=110, sides=20))
        change = "trefoil 4,400 triangles"
    elif cell.startswith("city_"):
        scene = build_brick_city(n_instances=48)
        change = "48 instances"
    else:
        last = states[-1]
        extra = ParticleState(torch.cat([last.pos, torch.tensor([[0.0, 3.0, 0.0]], device=DEVICE)]),
                              torch.cat([last.vel, torch.zeros(1, 3, device=DEVICE)]))
        scene = build_marbles_scene(extra, test_mode=False)
        change = "26 marbles"
    new_dyn = dynamic_frame(cell, "dynamic", scene, camera, eps, frames, counters)
    new_static = dynamic_frame(cell, "static", scene, camera, eps, frames, counters)
    (dyn, split, _), stat = new_dyn, new_static[0]
    same = bool(torch.equal(dyn.sum, stat.sum) and torch.equal(dyn.sum_sq, stat.sum_sq))
    entries2 = len(renderer_mod._DYNAMIC_CACHE) - entries0
    caps2 = renderer_mod._DYNAMIC_CACHE.captures() - caps0
    say("dynamic", cell=cell, topology_change=json.dumps(change),
        bit_equal=same, entries=entries2, captures=caps2, launches_per_pass_equal=same_per_pass(new_dyn, new_static),
        capture_s=f"{split['capture']:.3f}")
    if not same or entries2 != 2 or caps2 != 2 or not same_per_pass(new_dyn, new_static):
        fail(f"[dynamic] {cell}'s topology change: bit for bit {same}, {entries2} entries, {caps2} captures")
    return per_sample


def dynamic_phase(card: str) -> dict:
    """`[dynamic]`: each cell of DYNAMIC_CELLS. Returns {kernel name:
    (cell, launches per sample pass of the dynamic loop)} of the walks on
    it."""
    counters = counted_wrappers()
    out = {}
    for cell, spec in DYNAMIC_CELLS.items():
        t0 = time.perf_counter()
        per_sample = dynamic_cell(cell, card, counters)
        say("dynamic", cell=cell, phase_seconds=f"{time.perf_counter() - t0:.1f}")
        suffix = "_f64" if spec.get("dtype") == "float64" else ""
        out["scatter" + suffix] = (cell, per_sample["scatter"])
        if spec["family"]:
            for kind in ("closest", "occluded"):
                name = f"{spec['family']}_{kind}"
                out[name + suffix] = (cell, per_sample[name])
    return out


def png_size(path: str) -> tuple:
    """(height, width) from a PNG file's IHDR chunk."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path} is not a PNG")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def kernel_gate(renderer, label: str) -> str:
    """Every kernel of a renderer's path against its plain version on the
    camera wavefront of sample 0, bit for bit: the threefry draw of the
    pixel jitter, and the closest and any hit of each of the scene's packs
    (the any hit at t_max the plain closest t, 1e3 on a miss, halved on
    every other ray). Fails the run on a difference; returns what it
    checked."""
    import numpy as np
    import torch

    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.ops import walk
    from rpt_tpu_torch.renderer import camera_rays_tiled, pixel_ndc_tiled

    sd, t_min, _ = renderer._pass_args()
    ndc = pixel_ndc_tiled(renderer.width, renderer.height, sd.device)
    key = rnd.split(rnd.fold_in(rnd.PRNGKey(renderer.seed), 0), 3)[0]
    n = 2 * ndc[0].shape[0]
    dim = ndc[2]
    kw = dict(lo=float(np.float32(-1.0 / dim)), span=float(np.float32(1.0 / dim) - np.float32(-1.0 / dim)))
    if not torch.equal(rnd.threefry_kernel(rnd.UNIFORM, key, n, sd.device, **kw),
                       rnd.threefry_plain(rnd.UNIFORM, key, n, sd.device, **kw)):
        fail(f"{label}: the threefry kernel differs from its plain version")
    checked = ["threefry"]
    o, d, _ = camera_rays_tiled(renderer.camera.to(sd.device), rnd.fold_in(rnd.PRNGKey(renderer.seed), 0), ndc)
    for pack in sd.packs:
        out_k, out_p = walk.launch(pack, o, d, t_min), pack.plain(o, d, t_min)
        if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
            fail(f"{label}: the {pack.library} closest-hit kernel differs from its plain walk")
        t_p = out_p[0]
        t_max = torch.where(t_p < 1e38, t_p, torch.full_like(t_p, 1e3))
        t_max[1::2] *= 0.5
        if not torch.equal(walk.launch(pack, o, d, t_min, t_max), pack.plain(o, d, t_min, t_max)):
            fail(f"{label}: the {pack.library} any-hit kernel differs from its plain walk")
        checked += [f"{pack.library}_closest", f"{pack.library}_occluded"]
    return "bit_equal: " + ",".join(checked)


def example_run(name: str, flags: list, workdir: str, card: str, counters: dict) -> dict:
    """One example module through its `main` on the card (`[examples]`);
    returns {kernel name: launches} of the run."""
    import numpy as np
    import torch

    from rpt_tpu_torch import Renderer, kernels
    from rpt_tpu_torch import renderer as renderer_mod
    from rpt_tpu_torch.lights import AmbientLightData
    from rpt_tpu_torch.renderer import SceneCache

    mod = importlib.import_module(f"rpt_tpu_torch.examples.{name}")
    made = []

    class Recording(mod.Renderer):
        """The module's Renderer, keeping each instance the example makes."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    # Earlier examples' graphs and pools go.
    renderer_mod._MANY_CACHE, renderer_mod._DYNAMIC_CACHE = SceneCache(), SceneCache()
    torch.cuda.empty_cache()
    video = name in VIDEO_FLAGS
    out = os.path.join(workdir, name if video else f"{name}.png")
    argv = [*flags, "--outdir" if video else "--out", out]
    base, mod.Renderer = mod.Renderer, Recording
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        img = mod.main(argv)
        torch.cuda.synchronize()
    finally:
        mod.Renderer = base
    seconds = time.perf_counter() - t0
    launches = named_counts(counters)
    r = made[-1]
    if video:
        out = os.path.join(out, f"image_{len(made) - 1}.png")
    png = png_size(out)
    sd = r.scene_data()
    packs = [pack.library for pack in sd.packs]
    shadow = sum(not isinstance(light, AmbientLightData) for light in sd.lights)
    frames = len(made)
    rays = (r.max_bounces + 1) * (1 + shadow) * r.width * r.height * r.num_samples * frames
    # The same render again through the entry point, its graph captured.
    t1 = time.perf_counter()
    r.render()
    warm = time.perf_counter() - t1
    # Its kernels against their plain versions at its own size.
    gate = kernel_gate(r, name)

    # The card against the CPU, the example's own settings at a small size.
    small = {}
    for dev in ("cpu", DEVICE):
        s = Renderer(r.scene, r.camera, width=SMALL_W, height=SMALL_H, exposure_value=r.exposure_value,
                     filter=r.filter, max_bounces=r.max_bounces, num_samples=1, epsilon=r.epsilon, seed=r.seed,
                     device=dev)
        small[dev] = s.render_buffer().mean_image(r.filter).cpu().numpy()
    a, b = small["cpu"], small[DEVICE]
    close = np.isclose(b, a, rtol=1e-3, atol=1e-4).all(-1).mean()
    mean_rel = abs(float(b.mean()) - float(a.mean())) / max(abs(float(a.mean())), 1e-12)
    bar = WORKLOADS.get(name, {}).get("cpu_share", 0.99)
    ran = {k: n for k, n in launches.items() if n}
    say("examples", example=name, argv=json.dumps(" ".join(flags)), png=f"{png[0]}x{png[1]}x3",
        size=f"{r.width}x{r.height}", bounces=r.max_bounces, spp=r.num_samples, frames=frames, shadow=shadow,
        packs=",".join(packs) or "none", launches=json.dumps(ran), seconds=f"{seconds:.3f}",
        mrays_per_s=f"{rays / seconds / 1e6:.3f}", warm_seconds=f"{warm:.4f}",
        warm_mrays_per_s=f"{rays / frames / warm / 1e6:.3f}", kernel_gate=json.dumps(gate),
        gate_rays=r.width * r.height, cpu_vs_card=f"{close:.5f}", bar=bar,
        mean_rel=f"{mean_rel:.3e}", card=json.dumps(card))
    if png != tuple(img.shape[:2]) or png != (r.height, r.width) or img.shape[2] != 3 or not img.any():
        fail(f"{name} wrote a {png} PNG of a {img.shape} image for a {r.width}x{r.height} render")
    if packs != ([EXAMPLE_PACKS[name]] if name in EXAMPLE_PACKS else []):
        fail(f"{name} compiled with the packs {packs}, not {EXAMPLE_PACKS.get(name)}")
    # Every kernel of the example's path ran, no other did.
    path = {"threefry"} | {f"{f}_closest" for f in packs} | ({f"{f}_occluded" for f in packs} if shadow else set()) | \
        ({"scatter"} if r.max_bounces else set())
    if set(ran) != path:
        fail(f"{name} launched {ran}; its path is {sorted(path)}")
    if not (np.isfinite(b).all() and close >= bar and mean_rel <= 1e-3):
        fail(f"the CPU and card renders of {name} disagree")
    if bar < 0.99:
        same_rays_phase(name, r.scene, r.camera, r.epsilon, r.max_bounces, torch.float32)
    return launches


def examples_phase(card: str) -> dict:
    """`[examples]`: every example module through its `main` on the card,
    from a temporary directory that holds the stand-in files and the PNGs.
    Returns {kernel name: {example: launches}}."""
    from rpt_tpu_torch.examples import _stand_ins

    t0 = time.perf_counter()
    counters = counted_wrappers()
    workdir = tempfile.mkdtemp(prefix="rpt_examples_")
    cwd = os.getcwd()
    out = {}
    try:
        assets = _stand_ins.write_stand_ins(workdir)
        say("examples", stand_ins_seconds=f"{time.perf_counter() - t0:.2f}")
        names = sorted(f[:-3] for f in os.listdir(os.path.dirname(_stand_ins.__file__))
                       if f.endswith(".py") and not f.startswith("_"))
        if len(names) != 19:
            fail(f"rpt_tpu_torch/examples has {len(names)} example modules, not 19")
        os.chdir(workdir)  # a video's ffmpeg writes beside it
        for name in names:
            argv = [*assets.get(name, []), *VIDEO_FLAGS.get(name, ["--spp", "1"])]
            for kernel, n in example_run(name, argv, workdir, card, counters).items():
                if n:
                    out.setdefault(kernel, {})[name] = n
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    say("examples", phase_seconds=f"{time.perf_counter() - t0:.1f}", card=json.dumps(card))
    return out


def sharded_renderer(spp: int, size=None, device=None):
    """The `[sharded]` workload's renderer (`dragon`, 2 bounces), at the
    main path's size and on the card unless told otherwise."""
    from rpt_tpu_torch import Renderer
    from rpt_tpu_torch.scenes import scene_and_camera

    scene, camera, eps = scene_and_camera(SHARDED["workload"])
    (w, h) = size or (WIDTH, HEIGHT)
    return Renderer(scene, camera, width=w, height=h, max_bounces=SHARDED["bounces"], num_samples=spp,
                    epsilon=eps, device=device or DEVICE)


def shard_parity(sd, camera, key, t_min, ev, counts) -> None:
    """Every bvh8 wavefront of one eager sample of the last shard of a mesh
    of each of `counts` shards on the card, against the plain walk, bit for
    bit (`check_closest`, `check_occluded`): the shards' own lengths, pad
    rays included, which end in a partial block."""
    from rpt_tpu_torch.integrator import _auto_compact
    from rpt_tpu_torch.parallel import sharding

    family, bounces, shadow = SHARDED["family"], SHARDED["bounces"], SHARDED["shadow"]
    closest, occluded = f"{family}_closest", f"{family}_occluded"
    mod, pack = family_module(family), pack_of(sd, family)
    mat_of = material_of(family, sd, pack)
    kern = {name: kernel_of(mod, name, pack) for name in (closest, occluded)}
    plain = {name: (lambda *a, f=getattr(mod, f"{name}_plain"): f(pack, *a)) for name in (closest, occluded)}
    for n in counts:
        mesh = sharding.RayMesh(devices=(DEVICE,) * n, local=(n - 1,))
        passes = sharding._ShardedPasses(sd, WIDTH, HEIGHT, bounces, mesh, _auto_compact(sd), eager=True)
        rec = record_wavefronts((closest, occluded), lambda: passes.local_sums(camera, key, 0, 1, t_min, ev))
        m = passes.shards[0].inputs.ss.shape[0]
        if len(rec[closest]) != bounces + 1 or len(rec[occluded]) != shadow * (bounces + 1) or \
                any(args[0].shape[0] != m for v in rec.values() for args in v):
            fail(f"[sharded] shard {n - 1} of {n} made {len(rec[closest])} closest-hit and "
                 f"{len(rec[occluded])} any-hit calls, or not of its {m} rays")
        for depth, args in enumerate(rec[closest]):
            check_closest(closest, f"shard{n - 1}of{n}_depth{depth}", kern[closest], plain[closest], mat_of, *args)
        for j, args in enumerate(rec[occluded]):
            check_occluded(occluded, f"shard{n - 1}of{n}_shadow{j}", kern[occluded], plain[occluded],
                           plain[closest], *args)
        say("sharded", shard_parity=f"{n - 1} of {n}", rays=m, partial_block_rays=m % 128,
            pad=m * n - WIDTH * HEIGHT, wavefronts=len(rec[closest]) + len(rec[occluded]), bit_equal=True)


def sharded_phase(card: str) -> dict:
    """`[sharded]` (see the module docstring). Returns the bvh8 walks'
    launches per shard and sample."""
    import numpy as np
    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.parallel import make_ray_mesh, make_sharded_many_fn, render_distributed, render_pass_sharded
    from rpt_tpu_torch.parallel import sharding
    from rpt_tpu_torch.renderer import pixel_ndc_tiled

    t_phase = time.perf_counter()
    counters = counted_wrappers()
    bounces, spp, shadow, family = SHARDED["bounces"], SHARDED["spp"], SHARDED["shadow"], SHARDED["family"]
    r = sharded_renderer(spp)
    sd, t_min, ev = r._pass_args()
    if pack_of(sd, family) is None:
        fail(f"[sharded] {SHARDED['workload']} compiled without a {family} pack")
    base = r.base_key()
    meshes = {n: make_ray_mesh(n, device=DEVICE) for n in SHARDED_MESHES}
    rays = (bounces + 1) * (1 + shadow) * WIDTH * HEIGHT * spp
    per_shard = {}
    for n, mesh in meshes.items():
        t0 = time.perf_counter()
        graphed = render_distributed(r, mesh)  # captures every shard's graph
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        eager = sharding._eager_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, mesh)(r.camera, base, 0, spp, t_min, ev)
        fn = make_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, mesh)
        # The main path of this slice: every count to 0, drive, read.
        kernels.reset_launch_counts()
        again = render_distributed(r, mesh)
        launches = named_counts(counters)
        bit = bool(torch.equal(graphed.sum, eager[0]) and torch.equal(graphed.sum_sq, eager[1]))
        again_bit = bool(torch.equal(graphed.sum, again.sum) and torch.equal(graphed.sum_sq, again.sum_sq))
        caps = [p.captures[t_min] for p in fn.shards]
        m = fn.shards[0].inputs.ss.shape[0]
        per_shard[n] = {k: launches[k] / (n * spp) for k in (f"{family}_closest", f"{family}_occluded")}
        img = graphed.mean_image()
        say("sharded", workload=SHARDED["workload"], size=f"{WIDTH}x{HEIGHT}", bounces=bounces, spp=spp, shards=n,
            pixels_per_shard=m, pad=m * n - WIDTH * HEIGHT, graphed_vs_eager_bit_equal=bit,
            again_bit_equal=again_bit, first_call_seconds=f"{first_s:.3f}",
            capture_seconds=json.dumps([round(c.seconds, 3) for c in caps]),
            pool_mib_per_shard=json.dumps([round(c.pool_bytes / 2**20, 1) for c in caps]),
            launches=json.dumps(launches), launches_per_shard_sample=json.dumps(per_shard[n]),
            image_mean=f"{float(img.mean()):.6f}", card=json.dumps(card))
        want = {name: 0 for name in counters}
        per_pass = (bounces + 1) * n * spp
        want.update({f"{family}_closest": per_pass, f"{family}_occluded": shadow * per_pass,
                     "scatter": bounces * n * spp, "threefry": launches["threefry"]})
        if not (bit and again_bit) or launches != want or launches["threefry"] <= 0:
            fail(f"[sharded] the {n}-shard render differs from its eager shards ({bit}, {again_bit}) or launched "
                 f"{launches}, not {want}")
        if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
            fail(f"[sharded] the {n}-shard image is not finite or is black")

    # Both sides of the checks above replay the same kernels: hold them
    # against the plain walk on the shards' own wavefronts.
    shard_parity(sd, r.camera, base, t_min, ev, (4, 7))

    # Chunks and one pass, on 4 shards.
    mesh4 = meshes[4]
    fn4 = make_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, mesh4)
    whole = fn4(r.camera, base, 0, spp, t_min, ev)
    chunked = fn4(r.camera, base, 2, spp - 2, t_min, ev, into=fn4(r.camera, base, 0, 2, t_min, ev))
    chunk_bit = bool(torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1]))
    one = render_pass_sharded(sd, r.camera, rnd.fold_in(base, 0), WIDTH, HEIGHT, bounces, t_min, ev, mesh4)
    pass_bit = bool(torch.equal(one, fn4(r.camera, base, 0, 1, t_min, ev)[0]))
    say("sharded", shards=4, chunks_2_plus_2_vs_one_call_bit_equal=chunk_bit,
        render_pass_sharded_vs_one_sample_bit_equal=pass_bit)
    if not (chunk_bit and pass_bit):
        fail("[sharded] chunks or one sharded pass differ from one call")

    # Mrays/s in turns: render_buffer and every mesh, the order reversed
    # every other turn.
    calls = {"render_buffer": r.render_buffer, **{f"{n}_shards": (lambda m=mesh: render_distributed(r, m))
                                                 for n, mesh in meshes.items()}}
    r.render_buffer()  # captures the single-device graph
    seconds = {name: [] for name in calls}
    for turn in range(SHARDED_TURNS):
        for name in (list(calls) if turn % 2 == 0 else list(calls)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
    mrays = {name: rays / statistics.median(v) / 1e6 for name, v in seconds.items()}
    for name, v in seconds.items():
        say("sharded", call=name, turns=SHARDED_TURNS, seconds=json.dumps([round(t, 5) for t in v]),
            mrays_per_s=f"{mrays[name]:.3f}", over_render_buffer=f"{mrays[name] / mrays['render_buffer']:.4f}",
            card=json.dumps(card))

    # One sample of each through its cached graphs alone, profiled: the
    # card's busy time, its idle share and the kernels a sample runs.
    one_sample = {"render_buffer": replay_fn(r), **{
        f"{n}_shards": (lambda f=make_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, mesh):
                        f(r.camera, base, 0, 1, t_min, ev)) for n, mesh in meshes.items()}}
    for name, f in one_sample.items():
        wall_us, busy, events = profiled(f)
        if not events:
            say("sharded", call=name, profiled="one sample",
                device_time="not measured (the profiler recorded no CUDA kernels)")
            continue
        by_name = device_us_by_name(events)
        walk = sum(v for k, v in by_name.items() if f"{family}_walk" in k) / sum(by_name.values())
        say("sharded", call=name, profiled="one sample", window_ms=f"{wall_us / 1e3:.2f}",
            device_busy_ms=f"{busy / 1e3:.2f}", idle_share=f"{1.0 - busy / wall_us:.3f}", kernel_launches=len(events),
            **{f"{family}_share_of_device_time": f"{walk:.3f}"}, card=json.dumps(card))

    # The reference's shard form of the jitter (drawn in [-1, 1), times
    # 1/dim) against the draw in [-1/dim, 1/dim) that every pass takes
    # (`renderer.jittered_ndc`), on the same key and pixels, and what its
    # extra multiply would cost in a graph.
    key = rnd.to_device(rnd.fold_in(base, 0), DEVICE)
    dim = pixel_ndc_tiled(WIDTH, HEIGHT, DEVICE)[2]
    single = lambda: rnd.uniform(key, (2, WIDTH * HEIGHT), minval=-1.0 / dim, maxval=1.0 / dim)  # noqa: E731
    scale = float(np.float32(1.0 / dim))
    shard = lambda: rnd.uniform(key, (2, WIDTH * HEIGHT), minval=-1.0, maxval=1.0) * scale  # noqa: E731
    same = bool(torch.equal(single(), shard()))
    ms = {name: (time_ms(f, [()], 50), time_graph_ms(f, [()], 50))
          for name, f in (("single", single), ("shard", shard))}
    say("sharded", jitter="uniform(-1/dim, 1/dim) vs uniform(-1, 1) * f32(1/dim)", n=2 * WIDTH * HEIGHT,
        bit_equal=same, single_ms=f"{ms['single'][0]:.5f}", single_graph_ms=f"{ms['single'][1]:.5f}",
        shard_ms=f"{ms['shard'][0]:.5f}", shard_graph_ms=f"{ms['shard'][1]:.5f}",
        extra_multiply_graph_ms=f"{ms['shard'][1] - ms['single'][1]:.5f}", card=json.dumps(card))
    if not same:
        fail("[sharded] the reference's shard form of the jitter differs from the draw every pass takes")

    # The card against the CPU on a small 4-shard render.
    small = {}
    for dev in ("cpu", DEVICE):
        rs = sharded_renderer(1, size=(SMALL_W, SMALL_H), device=dev)
        small[dev] = render_distributed(rs, make_ray_mesh(4, device=dev)).mean_image().cpu().numpy()
    a, b = small["cpu"], small[DEVICE]
    close = float(np.isclose(b, a, rtol=1e-3, atol=1e-4).all(-1).mean())
    mean_rel = abs(float(b.mean()) - float(a.mean())) / max(abs(float(a.mean())), 1e-12)
    say("sharded", cpu_vs_card=f"{SMALL_W}x{SMALL_H}", shards=4, pixels_close=f"{close:.5f}",
        mean_rel=f"{mean_rel:.3e}")
    if not (np.isfinite(b).all() and close >= 0.99 and mean_rel <= 1e-3):
        fail("[sharded] the CPU and card 4-shard renders disagree")
    say("sharded", phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))
    if any(v != per_shard[SHARDED_MESHES[0]] for v in per_shard.values()):
        fail(f"[sharded] launches per shard and sample differ between meshes: {per_shard}")
    return per_shard[SHARDED_MESHES[0]]


@contextlib.contextmanager
def timed_collectives(spans: list):
    """Inside: every collective of `rpt_tpu_torch.parallel.collective`
    timed apart, after a barrier, so each span times the transfer and not
    the wait for the other processes' work; (label, ms) appended to
    `spans`: `check` (the call's agreement check), `frame` (a frame or a
    sum gathered), `grad` (a gradient's parts gathered)."""
    import torch
    import torch.distributed as dist

    from rpt_tpu_torch.parallel import collective

    plain = collective.all_gather, collective.check_same

    def timed(label, fn, *args):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        spans.append((label, (time.perf_counter() - t) * 1e3))
        return out

    collective.all_gather = lambda x: timed("frame" if x.dim() > 1 else "grad", plain[0], x)
    collective.check_same = lambda what, value: timed("check", plain[1], what, value)
    try:
        yield
    finally:
        collective.all_gather, collective.check_same = plain


def multihost_worker(rank: int, nproc: int, port: str, outdir: str, backend: str, devices: str,
                     mode: str) -> None:
    """One process of a multi-process run: joins the others over `backend`
    with the shards `devices` names (comma-separated), runs `mode`'s work
    (`render`: `multihost_render`; `grad`: `multihost_grad`) over the
    global mesh, saves its tensors to `<dir>/frame_<rank>.npz` and prints
    one JSON line."""
    import numpy as np
    import torch.distributed as dist

    from rpt_tpu_torch.parallel import init_multihost, is_multihost, make_global_ray_mesh

    init_multihost(f"localhost:{port}", nproc, rank, local_device_ids=devices.split(","), backend=backend)
    if not is_multihost():
        fail("[multihost] the process did not join")
    mesh = make_global_ray_mesh()
    report, arrays = {"render": multihost_render, "grad": multihost_grad}[mode](mesh)
    np.savez(os.path.join(outdir, f"frame_{rank}.npz"), **arrays)
    dist.destroy_process_group()
    print(json.dumps(dict(rank=rank, shards=list(mesh.local), devices=[str(mesh.devices[k]) for k in mesh.local],
                          mesh_size=mesh.size, **report)), flush=True)


def multihost_render(mesh) -> tuple:
    """`[multihost]`'s work in one process: the sharded frame rendered
    three times (the first captures; the second timed whole; the third
    with the all-gathers timed apart). (report, {sum, sum_sq})."""
    import torch

    from rpt_tpu_torch.parallel import render_multihost

    r = sharded_renderer(SHARDED["spp"])
    buf = render_multihost(r, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = render_multihost(r, mesh)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    spans = []
    with timed_collectives(spans):
        again = render_multihost(r, mesh)
    gathers = [ms for _, ms in spans]
    same = all(torch.equal(buf.sum, b.sum) and torch.equal(buf.sum_sq, b.sum_sq) for b in (timed, again))
    return (dict(call_ms=call_ms, gather_ms=sum(gathers), gathers_ms=gathers, calls_bit_equal=same),
            dict(sum=buf.sum.cpu().numpy(), sum_sq=buf.sum_sq.cpu().numpy()))


def sharded_grad_step(fn, r, sd, t_min, ev) -> tuple:
    """`[sharded_grad]`'s step of `fn` (`make_sharded_diff_fn` of `r`'s
    scene) over fresh leaves, GRAD_FIELDS requiring grad: forward,
    mean(image^2), backward, an SGD step with lr 1e-2. (loss, {leaf:
    gradient}, {leaf: new value}, forward s, backward and SGD s), each span
    ending in a synchronize."""
    import dataclasses

    import torch

    from rpt_tpu_torch.materials import MaterialTable

    leaves = {f.name: getattr(sd.materials, f.name).detach().clone().requires_grad_(f.name in GRAD_FIELDS)
              for f in dataclasses.fields(MaterialTable)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = fn(MaterialTable(**leaves), r.camera, r.base_key(), t_min, ev)
    loss = torch.mean(img ** 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    grads = {f: leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f]) for f in GRAD_FIELDS}
    with torch.no_grad():
        new = {f: leaves[f] - 1e-2 * grads[f] for f in GRAD_FIELDS}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return loss.detach(), grads, new, t1 - t0, t2 - t1


def multihost_grad(mesh) -> tuple:
    """`[multihost_grad]`'s work in one process: `[sharded_grad]`'s step
    over the global mesh (a warm-up; one counted from 0, with the peak
    memory; one with the collectives timed apart), then `render_pass_sharded`
    and `make_sharded_many_fn` in two chunks over it. (report, {loss,
    grad/<leaf>, new/<leaf>, pass_frame, chunks_sum, chunks_sum_sq})."""
    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.parallel import make_sharded_diff_fn, make_sharded_many_fn, render_pass_sharded

    counters = counted_wrappers()
    family = SHARDED["family"]
    r = sharded_renderer(1)
    sd, t_min, ev = r._pass_args()
    fn = make_sharded_diff_fn(sd, WIDTH, HEIGHT, SHARDED["bounces"], mesh)
    sharded_grad_step(fn, r, sd, t_min, ev)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss, grads, new, fwd, bwd = sharded_grad_step(fn, r, sd, t_min, ev)
    launches = named_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    spans = []
    with timed_collectives(spans):
        timed = sharded_grad_step(fn, r, sd, t_min, ev)
    half = SHARDED["spp"] // 2
    frame = render_pass_sharded(sd, r.camera, rnd.fold_in(r.base_key(), 0), WIDTH, HEIGHT, SHARDED["bounces"],
                                t_min, ev, mesh)
    many = make_sharded_many_fn(sd, WIDTH, HEIGHT, SHARDED["bounces"], mesh)
    chunks = many(r.camera, r.base_key(), half, SHARDED["spp"] - half, t_min, ev,
                  into=many(r.camera, r.base_key(), 0, half, t_min, ev))
    arrays = dict(loss=loss.cpu().numpy(), pass_frame=frame.cpu().numpy(), chunks_sum=chunks[0].cpu().numpy(),
                  chunks_sum_sq=chunks[1].cpu().numpy(),
                  **{f"grad/{f}": g.cpu().numpy() for f, g in grads.items()},
                  **{f"new/{f}": v.cpu().numpy() for f, v in new.items()})
    report = dict(forward_ms=fwd * 1e3, backward_ms=bwd * 1e3, timed_step_ms=(timed[3] + timed[4]) * 1e3,
                  collectives_ms=spans, peak_mib=peak / 2**20,
                  launches_per_shard={k: launches[k] / len(mesh.local)
                                      for k in (f"{family}_closest", f"{family}_occluded")})
    return report, arrays


def run_workers(nproc: int, backend: str, devices_of, mode: str = "render") -> tuple:
    """Start `nproc` processes of this script as `multihost_worker`s of
    `mode`, rank i with the shards `devices_of(i)`, wait for them (each
    under MULTIHOST_TIMEOUT) and return (their JSON reports, their saved
    arrays)."""
    import socket
    import tempfile

    import numpy as np

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".multihost-") as outdir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-worker", str(rank),
                                   str(nproc), str(port), outdir, backend, ",".join(devices_of(rank)), mode],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(nproc)]
        try:
            outs = [p.communicate(timeout=MULTIHOST_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"[multihost] worker {rank} ({mode}) exited {p.returncode}:\n{out[-4000:]}")
        reports = [json.loads(out.strip().splitlines()[-1]) for out in outs]
        saved = []
        for rank in range(nproc):
            with np.load(os.path.join(outdir, f"frame_{rank}.npz")) as f:
                saved.append({k: f[k] for k in f.files})
    return reports, saved


def frames_equal(frames: list, buf) -> tuple:
    """(every process's frame is the first's, the first is `buf`'s), bit
    for bit."""
    import numpy as np

    same = all(np.array_equal(f[k], frames[0][k]) for f in frames[1:] for k in ("sum", "sum_sq"))
    return same, bool(np.array_equal(buf.sum.cpu().numpy(), frames[0]["sum"]) and
                      np.array_equal(buf.sum_sq.cpu().numpy(), frames[0]["sum_sq"]))


def multihost_phase(card: str) -> None:
    """`[multihost]` (see the module docstring): the workers' frames
    against each other and against the in-process render on a mesh of as
    many shards."""
    from rpt_tpu_torch.parallel import make_ray_mesh, render_distributed

    t_phase = time.perf_counter()
    reports, frames = run_workers(MULTIHOST_PROCS, "gloo", lambda rank: [DEVICE] * MULTIHOST_SHARDS)
    r = sharded_renderer(SHARDED["spp"])
    same, vs_single = frames_equal(
        frames, render_distributed(r, make_ray_mesh(MULTIHOST_PROCS * MULTIHOST_SHARDS, device=DEVICE)))
    for rep in reports:
        say("multihost", rank=rep["rank"], shards=json.dumps(rep["shards"]), mesh_size=rep["mesh_size"],
            backend="gloo", call_ms=f"{rep['call_ms']:.2f}", all_gather_ms=f"{rep['gather_ms']:.2f}",
            all_gathers_ms=json.dumps([round(g, 3) for g in rep["gathers_ms"]]),
            gather_share_of_call=f"{rep['gather_ms'] / rep['call_ms']:.3f}", calls_bit_equal=rep["calls_bit_equal"],
            card=json.dumps(card))
    say("multihost", processes=MULTIHOST_PROCS, shards_each=MULTIHOST_SHARDS, frames_bit_equal=same,
        vs_in_process_4_shards_bit_equal=vs_single, phase_seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=json.dumps(card))
    if not (same and vs_single and all(rep["calls_bit_equal"] for rep in reports)):
        fail("[multihost] the processes' frames differ from each other or from the in-process render")


def sharded_grad_phase(card: str) -> tuple:
    """`[sharded_grad]` (see the module docstring). Returns the bvh8
    walks' launches per shard of the step, and the step's gradient."""
    import dataclasses

    import torch

    import rpt_tpu_torch.scene as scene_mod
    from rpt_tpu_torch import kernels
    from rpt_tpu_torch.materials import MaterialTable
    from rpt_tpu_torch.parallel import make_ray_mesh, make_sharded_diff_fn
    from rpt_tpu_torch.scenes import build_dragon_scene, dragon_camera

    t_phase = time.perf_counter()
    counters = counted_wrappers()
    bounces, family, n = SHARDED["bounces"], SHARDED["family"], SHARDED_GRAD_SHARDS
    r = sharded_renderer(1)
    sd, t_min, ev = r._pass_args()
    fn = make_sharded_diff_fn(sd, WIDTH, HEIGHT, bounces, make_ray_mesh(n, device=DEVICE))
    key = r.base_key()

    def step():
        return sharded_grad_step(fn, r, sd, t_min, ev)

    step()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss, grads, new, fwd, bwd = step()
    launches = named_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    turns = [step()[3:] for _ in range(2)]
    rays = (bounces + 1) * (1 + SHARDED["shadow"]) * WIDTH * HEIGHT
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v).all()) for v in [*grads.values(), *new.values()])
    per_shard = {k: launches[k] / n for k in (f"{family}_closest", f"{family}_occluded")}
    steps = [fwd + bwd] + [f + b for f, b in turns]
    say("sharded_grad", workload=SHARDED["workload"], size=f"{WIDTH}x{HEIGHT}", bounces=bounces, shards=n,
        leaves=",".join(GRAD_FIELDS), loss=f"{float(loss):.6e}", finite=finite, forward_ms=f"{fwd * 1e3:.2f}",
        backward_and_sgd_ms=f"{bwd * 1e3:.2f}", step_seconds_each=json.dumps([round(t, 4) for t in steps]),
        mrays_per_s_step=f"{rays / statistics.median(steps) / 1e6:.3f}", peak_mib=f"{peak / 2**20:.1f}",
        launches=json.dumps(launches), launches_per_shard=json.dumps(per_shard), card=json.dumps(card))
    want = {f"{family}_closest": bounces + 1, f"{family}_occluded": SHARDED["shadow"] * (bounces + 1)}
    if not finite or per_shard != want:
        fail(f"[sharded_grad] the step is not finite ({finite}) or launched {per_shard} per shard, not {want}")

    # The card's gradient against the CPU's at a small size, on the 5k
    # trefoil through the bvh8 walks (the wide threshold lowered).
    saved = scene_mod.WIDE_KERNEL_MIN_TRIS
    scene_mod.WIDE_KERNEL_MIN_TRIS = 4096
    try:
        scene, camera = build_dragon_scene(segments=125, sides=20), dragon_camera()
        small = {}
        for dev in ("cpu", DEVICE):
            sd_small = scene.compile(device=dev)
            if pack_of(sd_small, "bvh8") is None:
                fail("[sharded_grad] the small trefoil compiled without a bvh8 pack")
            fn_small = make_sharded_diff_fn(sd_small, SMALL_W, SMALL_H, bounces, make_ray_mesh(n, device=dev))
            leaves = {f.name: getattr(sd_small.materials, f.name).detach().clone().requires_grad_(f.name in GRAD_FIELDS)
                      for f in dataclasses.fields(MaterialTable)}
            fn_small(MaterialTable(**leaves), camera, key, t_min, ev).mean().backward()
            small[dev] = {f: leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f])
                          for f in GRAD_FIELDS}
    finally:
        scene_mod.WIDE_KERNEL_MIN_TRIS = saved
    err, _, finite = grad_error(small[DEVICE], small["cpu"])
    say("sharded_grad", workload="trefoil_5k", size=f"{SMALL_W}x{SMALL_H}", bounces=bounces, shards=n,
        card_vs_cpu_max_rel_err=f"{err:.3e}", bar=GRAD_CPU_RTOL, finite=finite,
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))
    if not finite or err > GRAD_CPU_RTOL:
        fail(f"[sharded_grad] the small trefoil's sharded gradient on the card differs from the CPU's: {err:.3e}")
    return per_shard, grads


def multihost_grad_check(phase: str, reports: list, saved: list, grads: dict, mesh) -> dict:
    """The multi-process step's checks: every process's loss, gradients
    and new leaves bit for bit the first's; the gradients within
    MULTIHOST_GRAD_RTOL of max|g| per leaf of `grads`, the in-process step
    on a mesh of as many shards; the bvh8 walks' launches per shard as
    `[sharded_grad]` counts them; `render_pass_sharded` and
    `make_sharded_many_fn` in two chunks bit for bit the in-process calls
    on `mesh`. Fails with FAIL unless all hold; returns the figures."""
    import numpy as np
    import torch

    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.parallel import make_sharded_many_fn, render_pass_sharded

    bounces, family = SHARDED["bounces"], SHARDED["family"]
    keys = ["loss", *(f"{kind}/{f}" for kind in ("grad", "new") for f in GRAD_FIELDS)]
    processes_equal = all(np.array_equal(a[k], saved[0][k]) for a in saved[1:] for k in keys)
    err, _, finite = grad_error({f: torch.from_numpy(saved[0][f"grad/{f}"]) for f in GRAD_FIELDS}, grads)
    r = sharded_renderer(SHARDED["spp"])
    sd, t_min, ev = r._pass_args()
    frame = render_pass_sharded(sd, r.camera, rnd.fold_in(r.base_key(), 0), WIDTH, HEIGHT, bounces, t_min, ev, mesh)
    whole = make_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, mesh)(r.camera, r.base_key(), 0, SHARDED["spp"],
                                                                  t_min, ev)
    renders_equal = all(np.array_equal(a["pass_frame"], frame.cpu().numpy()) and
                        np.array_equal(a["chunks_sum"], whole[0].cpu().numpy()) and
                        np.array_equal(a["chunks_sum_sq"], whole[1].cpu().numpy()) for a in saved)
    want = {f"{family}_closest": bounces + 1, f"{family}_occluded": SHARDED["shadow"] * (bounces + 1)}
    launches_right = all(rep["launches_per_shard"] == want for rep in reports)
    out = dict(processes_bit_equal=processes_equal, vs_in_process_max_rel_err=f"{err:.3e}",
               bar=MULTIHOST_GRAD_RTOL, finite=finite, renders_vs_in_process_bit_equal=renders_equal,
               launches_per_shard=json.dumps([rep["launches_per_shard"] for rep in reports]))
    if not (processes_equal and finite and err <= MULTIHOST_GRAD_RTOL and renders_equal and launches_right):
        fail(f"[{phase}] the multi-process step or renders failed a check: {out}; bvh8 launches per shard "
             f"should be {want}")
    return out


def multihost_grad_phase(card: str, grads: dict) -> None:
    """`[multihost_grad]` (see the module docstring): two processes of 2
    shards each on the card, over gloo, take `[sharded_grad]`'s step over
    the 4-shard global mesh; held against each other and against
    `grads`, the in-process 4-shard step's gradient."""
    from rpt_tpu_torch.parallel import make_ray_mesh

    t_phase = time.perf_counter()
    reports, saved = run_workers(MULTIHOST_PROCS, "gloo", lambda rank: [DEVICE] * MULTIHOST_SHARDS, mode="grad")
    for rep in reports:
        step_ms = rep["forward_ms"] + rep["backward_ms"]
        by = {}
        for label, ms in rep["collectives_ms"]:
            by.setdefault(label, []).append(round(ms, 3))
        say("multihost_grad", rank=rep["rank"], shards=json.dumps(rep["shards"]), mesh_size=rep["mesh_size"],
            backend="gloo", workload=SHARDED["workload"], size=f"{WIDTH}x{HEIGHT}", bounces=SHARDED["bounces"],
            forward_ms=f"{rep['forward_ms']:.2f}", backward_and_sgd_ms=f"{rep['backward_ms']:.2f}",
            collectives_ms=json.dumps(by),
            collectives_share_of_step=json.dumps({k: round(sum(v) / step_ms, 4) for k, v in by.items()}),
            timed_step_ms=f"{rep['timed_step_ms']:.2f}", peak_mib=f"{rep['peak_mib']:.1f}", card=json.dumps(card))
    figures = multihost_grad_check("multihost_grad", reports, saved, grads,
                                   make_ray_mesh(MULTIHOST_PROCS * MULTIHOST_SHARDS, device=DEVICE))
    say("multihost_grad", processes=MULTIHOST_PROCS, shards_each=MULTIHOST_SHARDS, **figures,
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))


def multicard_phase(card: str) -> None:
    """`[multicard]`, run by `python3 chip_smoke.py --multicard` on a host
    with several cards (never by the default run): the sharded paths with
    one shard per card, held bit for bit against the same shards on one
    card. `render_distributed` over every card, graphed against eager and
    against the one-card mesh, counted per shard; a bvh8 launch whose group
    stack takes more than 48 KB of shared memory on every card in turn,
    against the plain walk; the sharded gradient against the one-card
    mesh's; `render_multihost` from one process per
    card over NCCL against the in-process render; `[sharded_grad]`'s step
    from one NCCL process per card (`multihost_grad`) against the
    in-process step over the cards, held as `[multihost_grad]` holds its
    step. Correctness first: only the processes' step and collective ms
    are printed."""
    import dataclasses

    import torch

    from rpt_tpu_torch import kernels
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.ops import bvh8, walk
    from rpt_tpu_torch.parallel import make_ray_mesh, make_sharded_diff_fn, render_distributed, sharding
    from rpt_tpu_torch.renderer import camera_rays_tiled, pixel_ndc_tiled

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    if n < 2:
        fail(f"[multicard] needs several cards, and {n} is visible")
    counters = counted_wrappers()
    bounces, spp, family = SHARDED["bounces"], SHARDED["spp"], SHARDED["family"]
    r = sharded_renderer(spp)
    sd, t_min, ev = r._pass_args()
    cards, one = make_ray_mesh(n), make_ray_mesh(n, device=DEVICE)
    on_one = render_distributed(r, one)
    on_cards = render_distributed(r, cards)  # captures a graph on every card
    eager = sharding._eager_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, cards)(r.camera, r.base_key(), 0, spp,
                                                                               t_min, ev)
    kernels.reset_launch_counts()
    again = render_distributed(r, cards)
    launches = named_counts(counters)
    fn = sharding.make_sharded_many_fn(sd, WIDTH, HEIGHT, bounces, cards)
    bits = dict(cards_vs_one_card=bool(torch.equal(on_cards.sum, on_one.sum) and
                                       torch.equal(on_cards.sum_sq, on_one.sum_sq)),
                graphed_vs_eager=bool(torch.equal(on_cards.sum, eager[0]) and torch.equal(on_cards.sum_sq, eager[1])),
                again=bool(torch.equal(on_cards.sum, again.sum) and torch.equal(on_cards.sum_sq, again.sum_sq)))
    per_shard = {k: launches[k] / (n * spp) for k in (f"{family}_closest", f"{family}_occluded")}
    say("multicard", cards=n, shard_devices=json.dumps([str(p.device) for p in fn.shards]),
        scene_devices=json.dumps(sorted({str(p.sd.device) for p in fn.shards})),
        **{f"{k}_bit_equal": v for k, v in bits.items()}, launches_per_shard_sample=json.dumps(per_shard),
        sums_on=str(on_cards.sum.device), card=json.dumps(card))
    if not all(bits.values()) or per_shard != {f"{family}_closest": bounces + 1,
                                               f"{family}_occluded": SHARDED["shadow"] * (bounces + 1)}:
        fail(f"[multicard] the render over {n} cards differs ({bits}) or launched {per_shard} per shard")

    # The walk kernels raise their shared-memory limit once per card: a
    # group stack over 48 KB (a pack's depth raised to 100 levels) on every
    # card in turn, each against the plain walk there, on 63x47 rays (a
    # partial last block).
    deep = []
    for i in range(n):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            pack = dataclasses.replace(pack_of(sharding._scene_on(sd, dev), "bvh8"), group_depth=100)
            o, d, _ = camera_rays_tiled(r.camera.to(dev), rnd.PRNGKey(i),
                                        pixel_ndc_tiled(SMALL_W - 1, SMALL_H - 1, dev))
            t_k, id_k = walk.launch(pack, o, d, t_min)
            t_p, id_p = bvh8.bvh8_closest_plain(pack, o, d, t_min)
            deep.append(bool(torch.equal(t_k, t_p) and torch.equal(id_k, id_p)))
    say("multicard", deep_group_stack_bytes=100 * 4 * 128, rays=(SMALL_W - 1) * (SMALL_H - 1),
        kernel_vs_plain_bit_equal_per_card=json.dumps(deep))
    if not all(deep):
        fail(f"[multicard] a deep-stack bvh8 launch differs from the plain walk on a card: {deep}")

    grads = {}
    for name, mesh in (("cards", cards), ("one_card", one)):
        diff = make_sharded_diff_fn(sd, SMALL_W, SMALL_H, bounces, mesh)
        leaves = {f: getattr(sd.materials, f).detach().clone().requires_grad_() for f in GRAD_FIELDS}
        mats = dataclasses.replace(sd.materials, **leaves)
        diff(mats, r.camera, r.base_key(), t_min, ev).mean().backward()
        grads[name] = {f: leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f])
                       for f in GRAD_FIELDS}
    err, bit, finite = grad_error(grads["cards"], grads["one_card"])
    say("multicard", sharded_grad=f"{SMALL_W}x{SMALL_H}", cards=n, vs_one_card_max_rel_err=f"{err:.3e}",
        bit_equal=bit, finite=finite, bar=GRAD_PLAIN_RTOL)
    if not finite or err > GRAD_PLAIN_RTOL:
        fail(f"[multicard] the sharded gradient over {n} cards differs from one card's: {err:.3e}")

    reports, frames = run_workers(n, "nccl", lambda rank: [f"cuda:{rank}"])
    same, vs_single = frames_equal(frames, on_cards)
    say("multicard", processes=n, backend="nccl", devices=json.dumps([rep["devices"] for rep in reports]),
        frames_bit_equal=same, vs_in_process_bit_equal=vs_single,
        calls_bit_equal=all(rep["calls_bit_equal"] for rep in reports),
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))
    if not (same and vs_single and all(rep["calls_bit_equal"] for rep in reports)):
        fail("[multicard] the NCCL processes' frames differ from each other or from the in-process render")

    # `[sharded_grad]`'s step from one NCCL process per card, against the
    # in-process step with one shard per card.
    r1 = sharded_renderer(1)
    sd1, t_min1, ev1 = r1._pass_args()
    grads = sharded_grad_step(make_sharded_diff_fn(sd1, WIDTH, HEIGHT, bounces, cards), r1, sd1, t_min1, ev1)[1]
    reports, saved = run_workers(n, "nccl", lambda rank: [f"cuda:{rank}"], mode="grad")
    for rep in reports:
        say("multicard", grad_rank=rep["rank"], devices=json.dumps(rep["devices"]), backend="nccl",
            forward_ms=f"{rep['forward_ms']:.2f}", backward_and_sgd_ms=f"{rep['backward_ms']:.2f}",
            collectives_ms=json.dumps([(label, round(ms, 3)) for label, ms in rep["collectives_ms"]]),
            peak_mib=f"{rep['peak_mib']:.1f}", card=json.dumps(card))
    say("multicard", grad_processes=n, backend="nccl",
        **multihost_grad_check("multicard", reports, saved, grads, cards),
        phase_seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))


def main():
    started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "rpt_tpu_torch", "__init__.py")):
        fail("rpt_tpu_torch/ is not beside chip_smoke.py; run it from the repository")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    if sys.argv[1:2] == ["--multihost-worker"]:
        rank, nproc, port, outdir, backend, devices, mode = sys.argv[2:9]
        multihost_worker(int(rank), int(nproc), port, outdir, backend, devices, mode)
        return
    multicard = sys.argv[1:2] == ["--multicard"]

    # 1. The card.
    card = card_line()
    print(card, flush=True)
    say("card", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    from rpt_tpu_torch import kernels

    # 2. Build every kernel from the checkout's sources, all at once.
    t0 = time.perf_counter()
    info = kernels.build(force=True)
    for name in kernels.sources():
        kernels.load_library(name)
    say("build", sources=",".join(f"rpt_tpu_torch/csrc/{n}.cu" for n in info), wall_seconds=f"{time.perf_counter() - t0:.2f}",
        flags=json.dumps(" ".join(kernels.NVCC_FLAGS)))
    for name, res in info.items():
        say("build", source=f"rpt_tpu_torch/csrc/{name}.cu", seconds=f"{res['seconds']:.2f}")
        for line in res["log"].splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "stack frame")):
                say("ptxas", source=name, line=json.dumps(line.strip()))

    if multicard:
        multicard_phase(card)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    # Every walk kernel at ties and at t_max = t, against its plain walk.
    walk_cases_phase(card)
    if sys.argv[1:2] == ["--workloads"]:
        # Part of the run, to measure a design (e.g. RPT_COMPARE variants on
        # one workload): the named workloads' phases alone.
        counters = counted_wrappers()
        for workload in sys.argv[2].split(","):
            if workload == "random":
                sass_phase(kernels._lib_path("threefry"))
                random_phase(card)
            elif workload in GRAD_FAMILIES:
                grad_family(workload, card, counters)
            elif workload in DYNAMIC_CELLS:
                dynamic_cell(workload, card, counters)
            elif workload == "examples":
                examples_phase(card)
            else:
                run_workload(workload, card)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    # The threefry kernels' instructions, and the PRNG kernel at the main path's shapes.
    sass_phase(kernels._lib_path("threefry"))
    threefry_row, threefry64_row = random_phase(card)
    gather_phase(card)
    dtype_phase(card)
    hdri_phase(card)
    mono_light_phase(card)
    scatter_rows = scatter_phase(card)

    # 3. Each workload's path. One row per kernel: a kernel on several
    # paths (bvh2 on lego_toy and dragon_binary) keeps its first path's row
    # and carries the later paths' rows under "other_workloads".
    rows, threefry_per_sample, threefry_by_mode, main_launches = {}, {}, {}, {}
    for workload in WORKLOADS:
        workload_rows, threefry_per_sample[workload], threefry_by_mode[workload], main_launches[workload] = \
            run_workload(workload, card)
        for row in workload_rows:
            if row["name"] in rows:
                rows[row["name"]].setdefault("other_workloads", []).append(row)
            else:
                rows[row["name"]] = row
    if sorted(rows) != sorted([*KERNELS, *KERNELS_F64]):
        fail(f"the workloads ran {sorted(rows)}, not every kernel of {sorted([*KERNELS, *KERNELS_F64])}")
    # The threefry kernel runs on every workload: its launches are the first
    # workload's main path, by mode beside them, and each workload's per
    # sample.
    first = next(iter(WORKLOADS))
    threefry_row.update(launches=int(threefry_per_sample[first] * WORKLOADS[first]["spp"]), workload=first,
                        launches_by_mode=threefry_by_mode[first], launches_per_sample=threefry_per_sample,
                        launches_by_mode_per_workload=threefry_by_mode)
    rows["threefry"] = threefry_row
    # Its 64-bit modes run on the float64 workloads: the first one's main
    # path, and each one's per sample.
    first64 = next(w for w, spec in WORKLOADS.items() if spec.get("dtype") == "float64")
    modes64 = {w: {m: threefry_by_mode[w][m] for m in THREEFRY64["modes"]} for w in WORKLOADS}
    threefry64_row.update(launches=sum(modes64[first64].values()), workload=first64,
                          launches_by_mode=modes64[first64],
                          launches_per_sample={w: sum(modes64[w].values()) / WORKLOADS[w]["spp"] for w in WORKLOADS})
    rows["threefry_f64"] = threefry64_row
    # The scatter kernel runs on every workload with bounces: its launches
    # are the main path's of the workload its row was timed on (of the first
    # float64 one for its float64 row), and each workload's per sample.
    for name, row in scatter_rows.items():
        f64 = name.endswith("_f64")
        of_type = [w for w, spec in WORKLOADS.items() if (spec.get("dtype") == "float64") == f64]
        source = row["workload"] if not f64 else of_type[0]
        row.update(launches=main_launches[source]["scatter"], launches_workload=source,
                   launches_per_sample={w: main_launches[w]["scatter"] / WORKLOADS[w]["spp"] for w in of_type})
        rows[name] = row
    # The differentiable path: launches per differentiated sample (the
    # backward's recompute included) of each kernel on it.
    for kernel, (workload, n) in grad_phase(card).items():
        rows[kernel].update(grad_workload=workload, grad_launches_per_sample=n)
    # Animation: the RK4 frame, then the dynamic path's cells.
    t0 = time.perf_counter()
    ode_phase(card)
    say("ode", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    for kernel, (cell, n) in dynamic_phase(card).items():
        rows[kernel].update(dynamic_workload=cell, dynamic_launches_per_sample=n)
    # The example programs through their entry points.
    for kernel, by_example in examples_phase(card).items():
        if kernel in rows:
            rows[kernel].update(examples_launches=by_example)
    # Multi-device: the sharded render, several processes, the sharded gradient.
    t0 = time.perf_counter()
    for kernel, n in sharded_phase(card).items():
        rows[kernel].update(sharded_workload=SHARDED["workload"], sharded_launches_per_shard_sample=n)
    multihost_phase(card)
    per_shard, grads = sharded_grad_phase(card)
    for kernel, n in per_shard.items():
        rows[kernel].update(sharded_grad_launches_per_shard=n)
    multihost_grad_phase(card, grads)
    say("parallel", phase_seconds=f"{time.perf_counter() - t0:.1f}", card=json.dumps(card))
    say("done", seconds=f"{time.perf_counter() - started:.1f}", card=json.dumps(card))

    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
