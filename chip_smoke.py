"""GPU smoke run of the PyTorch port (computational_ray_tracer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; imports nothing of JAX. Every render() and canonical_render() on
the card below runs its first pass eagerly and replays one captured CUDA
graph for the others (integrator.pass_graph; phase 23 holds it to the eager
loop), so phases 4, 7, 10-12 and 17a time the captured render. Phases, each
printed on its own line; any failed check raises, so the script exits
non-zero:

0. refuse to run without a card; print the card's name and power limit;
1. build (or load) the kernel library from csrc/ with nvcc, one process per
   source, all started together;
25. (run right after 1) the sampler kernel (ops/rng_kernel.py) against
   its plain version (ops/rng.py on the same CUDA tensors), bitwise, on a
   0-d device index and a Python int, each under the int seed and under a
   0-d device seed (rng_kernel.seed_word), at the cells' draws: 262,144 lanes
   Sobol' spp 32, 250,000 lanes stratified 10 x 10 and 2,304 lanes Sobol'
   spp 8, each 1D and 2D; each timed as replays of a CUDA graph of 20
   launches (the plain draw: of 4), with its bound from the kernel's
   integer operations (SAMPLER_OPS at INT32_OPS_PER_S) or its bytes;
   then its launches a pass or a step, replays included: 20 a Cornell
   pass, 3 a canonical pass, 120 a config 5 step;
2. the brute-force mesh kernel (closest hit) vs its plain PyTorch version
   on the card, on (a) the 512x512 Cornell camera wavefront and (b) a
   seeded 4,096-triangle soup x 262,144 rays with a finite t_max and a 50%
   triangle mask: bitwise agreement, outputs and the three per-ray
   counters; the kernel alone (no wrapper-side fill) timed as replays of a
   CUDA graph of 20 launches, its bound from its own counters;
3. the 128x128 golden Cornell render through the port's render(), against
   tests/golden/config2_cornell_path_128.npy at atol 2e-3*max;
4. the Cornell headline: Cornell box + sphere, 512x512, spp 32, path/MIS
   depth 4, through render(); image checks, seconds per pass and rays/s,
   with the launch counts of both brute-force modes in that run; then (4b)
   the inputs of the 8 brute-force launches of one full-wavefront pass
   (closest and any hit, depths 0-3), each held to the plain version
   bitwise (closest hit: all four outputs; any hit: every bit; the three
   counters), timed as in phase 2 and bounded by its own counters;
5. the octree kernel on the mesh bench scene (entry.mesh327k_setup:
   327,680 triangles, leaf cap 192): set-up times, tree shape and memory;
   (a) closest hit vs the plain traversal on the 512x512 camera wavefront,
   (b) vs the brute-force kernel on the same rays, (c) any hit vs the plain
   traversal on the packet-ordered shadow wavefront of one direct pass,
   (d) closest hit vs the brute-force kernel on the 872,320-triangle
   dragon stand-in (leaf cap 160);
6. golden configuration 3 (textured uv sphere in an octree, direct) at
   128x128 through render(), against tests/golden/
   config3_mesh_octree_textured_128.npy at atol 2e-3*max, with both kernel
   modes launched;
7. the mesh headline: entry.mesh327k_setup(512, spp 4) through render();
   image checks, seconds per pass and rays/s (2 rays per sample), with the
   launch counts of each kernel mode in that run;
8. the flagship (entry.flagship_setup on phase 5's scene: textured,
   thin lens, stratified 2x2, path/MIS depth 4): one 512x512 pass through
   render_pass_compact (alive rays only from depth 1) against the
   full-wavefront render_pass that render() runs, at rtol 1e-4 / atol
   1e-5, with the alive counts per depth, capturing the interpolation
   kernel's inputs of that pass;
9. the interpolation kernel vs its plain version on the card, bitwise, on
   (a) the flagship pass's spectral-cache call (C = 5), (b) its sensor
   call (C = 3), (c) a seeded 471 x 128 table at 2^21 rows with w exactly
   0 and 1 on some rows, (d) phase 21's shape (a (471, 3) sensor table
   at 2,048 visible wavelengths); both times, the bound, and the time of
   torch.nn.functional.grid_sample on the same inputs (the yardstick;
   the port never calls it); (9b) the interpolation kernel's backward (the
   table gradient) vs its plain backward, within 2e-5 of the sum of
   |terms| each cell gathers, and run twice to the same bits, on the
   flagship cache (C = 5), the seeded 471 x 128 input, (e) 2^21 x 16 rows
   all on table row 235 (the worst skew) and (f) 65,537 x 13 rows with i0
   at 0, at K-2 and outside the table and w at 0 and 1, with seeded
   gradients, and (in phase 14) on the config 5 cache (C = 13) and the
   Cornell headline cache (C = 16, 2^21 rows) with the gradients their
   backward passes carried; each timed as replays of a CUDA graph, with
   its byte bound, the plain backward's time, grid_sample's backward
   (aten.grid_sampler_2d_backward) as the yardstick and the kernel's
   launch plan (blocks an SM, rows a chunk, clusters); at f and at the
   config 5 cache one launch captured in a CUDA graph and replayed twice
   must give the eager launch's bits (each launch leaves its ticket
   counters at 0);
10. the flagship render: render() over spp 4 after one warm-up pass;
   seconds per pass, rays/s (1 + (D-1) + D rays per sample), launches of
   the interpolation kernel and both octree modes, image checks (finite,
   mean inside a band from a CPU render); then (10b) the inputs of the 8
   octree launches of one full-wavefront pass (closest and any hit,
   depths 0-3), each launch timed, bounded by its own counters and held
   to the plain traversal (hits_agree for closest hit, equality for any
   hit; a seeded subset where all rays would exceed PLAIN_BUDGET_S), and
   the depth-1 closest-hit wavefront timed in raster and in packet order;
11. deep512 (entry.deep512_setup on phase 5's scene, path/MIS depth 8):
   one warm-up pass, then three passes at spp 4; seconds
   per pass, rays/s at 16 rays per sample, launches; then one compacted
   pass against the full wavefront as in phase 8, with its alive counts;
12. the canonical frame (entry.canonical_scene on phase 5's dragon
   stand-in: x5, cap 40, backface culling): set-up times and tree shape;
   the 64x64 spp 4 render against tests/golden/canonical_64.npy at
   atol 2e-3*max; the 500x500 spp 100 frame, seconds per pass and rays/s
   (1 ray per sample); (12b) the octree kernel on the camera wavefront of
   one pass, as in 10b;
14. training at full width, BASELINE config 5 (entry.config5_setup: the
   Cornell box, 48x48, Sobol spp 8, path/MIS depth 3) with every leaf of
   inverse.albedo_and_emission_params: (a) one value and gradient on the
   card against the same on the CPU (the plain versions), every gradient
   finite, the emission gradient nonzero, each leaf within GRAD_REL of
   max|g|; (b) TRAIN_STEPS Adam steps from the start scene through
   inverse.optimize (on the card step 0 eagerly, then replays of one
   captured step, a graphs.CapturedGraph; phase 24 holds it to the eager
   loop), with every launch count at 0 just before and read just after
   (the training path's run): s/step, the loss at step 0 and after the
   last step (it must fall), launches per step, the first CPU_LOSSES
   losses against the CPU's (inverse.DeviceAdam on both); (c) one
   gradient of the Cornell headline pass (512x512, path/MIS depth 4, the
   metal sphere): forward and backward seconds and peak
   memory, every gradient finite, its interpolation backward launch
   captured for 9b; (d) bench.py's bench_grad_check: the albedo gradient
   of a 32x32 Sobol spp 2 path depth 2 pass of the 1,280-triangle mesh
   (cap 16) through the octree kernel against the one through the plain
   traversal;
15. golden configuration 1 (a sphere under a point light, direct) through
   render() against tests/golden/config1_sphere_direct.npy at atol
   2e-3*max; one 128x128 Cornell + sphere pass each of the simple and
   walk integrators, uniform hero wavelengths, the firefly clamp and a
   named sensor on the card against the same pass on the CPU, at atol
   2e-3*max, with the kernels' launches;
16. the sharded paths at full width (parallel/sharding.py): (a) the
   Cornell headline (512x512, spp 32, path/MIS depth 4, brute kernel) at
   world size 1 over NCCL: one sharded render step captured alone
   (integrator.capture_sums: its capture seconds, spp - 1 replays
   timed), then render_distributed (the first step eager, every later
   one a replay of one captured step) and its eager steps
   (make_sharded_render) in the turns SHARD_TURNS, every count at 0
   before each run and read after: the films bitwise equal, the launches
   equal (each captured step a replay's), s/pass of each run; the film
   held to phase 4's (rtol 1e-5 / atol 2e-6; bitwise equality reported);
   (b) the same with two ranks on the one card over gloo with CUDA
   tensors (NCCL takes one rank a device; gloo's collectives cannot be
   captured, so every step runs eagerly), layouts (dp, sp) = (2, 1) and
   (1, 2), each rank's kernel launches counted and its scene's bits
   hashed; (c) config 5's sharded train step (48x48, depth 3, every leaf
   of inverse.albedo_and_emission_params): the gradient averaged over the
   ranks against the unsharded port's over the same samples on the card
   (rtol 1e-3, atol 1e-6 of max|g| per leaf), then at world size 1
   SHARD_GRAPH_STEPS steps at samples 0, 1, ... with make_train_step's
   default optimizer (inverse.DeviceAdam, lr 2e-2) through its step
   (warm-up on a side stream, capture, replays of one
   sharding.train_graph) and through its eager route in the turns
   SHARD_TURNS (losses and final parameters bitwise, launches equal, the
   loss trending down; a train_graph captured alone for its seconds),
   and at world size 2 ((2, 1), (1, 2); gloo, eager) 5 steps with the
   default optimizer on fixed samples (the loss must fall); each step's
   route, s/step, every rank's launches (the interp backward included);
17. the new render options on the card: (a) the Cornell headline at 512x512
   with the sobol_global sampler (m = 9) through render(), s/pass, and
   its sample values for dims 0-12 (and the 2D filter and lens draws) of
   samples 0 and 31 over all 262,144 pixels equal to the CPU's bit for
   bit; (b) one 128x128 Cornell pass with sobol_global and one with the
   Lanczos filter against the same pass on the CPU at atol 2e-3*max, on
   every pixel but those whose camera ray meets a triangle edge within
   1e-5 (barycentric; counted); (c) entry.shapes_setup's sphere, cylinder
   and disk under the orthographic, pinhole and thin-lens cameras at
   128x128, each pass against the CPU's at atol 2e-3*max;
18. the raytracer app at its full width (apps.raytracer.main: the Cornell
   box and a mirror sphere, 256x256, Sobol spp 64, path/MIS depth 5, the
   brute-force mesh): the brute kernel launched in both modes and the
   interpolation kernel, final.png read back without PIL equal to
   to_uint8 of the resolved film.npz and through image_checks, 64 pass
   records in metrics.jsonl, s/pass and rays/s as RenderMeter logs them;
   then a second out-dir rendered to 32 passes, checkpointed through
   RenderCheckpointer and resumed by main() to 64: its film.npz equal to
   the straight run's bit for bit;
19. the shape_test app at 128x128 on the card and on the CPU: equal hit
   fractions and brute-force triangle-test totals, the normals and uvs
   of every scene within 1e-5 off the grazing hits (|cos| < 0.2, counted),
   octree_matches_brute on both, the octree
   and brute kernels launched (the octree's test total is the kernel's on
   the card and the plain traversal's on the CPU; both printed);
20. scenes as data: the 327,680-triangle displaced icosphere written with
   save_obj and the ~870k-triangle dragon stand-in with save_ply (binary),
   each read back by the native and the Python loaders (equal arrays,
   equal to the generator's triangles); MeshCache.load of the PLY equal
   to MeshData.build of the generator's arrays; a JSON scene file naming
   the OBJ (octree on) through load_scene_file, rendered 4 passes at
   512x512, path/MIS depth 4, with both octree modes and the
   interpolation kernel launched, against the same mesh built in memory
   (2e-3*max; bitwise equality reported); load, octree-build and pass
   times. The scene file is loaded twice with the octree cache in a
   temporary directory: cold (one build, stored) and warm (read back, no
   build); the two trees and their packed tables bitwise equal, one
   pass of each scene bitwise equal with both octree modes launched, both
   load times printed;
21. the eight validation apps (spectrum_color, filter_film_test,
   sampler_test, montecarlo_test, polygon_app, crossbridge, ode_app,
   plotter_demo) at their defaults on the card, each into a temporary
   directory, then on the CPU: every deterministic report entry of the card
   held to the CPU's (the known colour answers, the filter integrals, the
   sensor swatches, the ODE errors and the orders they bound, the
   triangulation, ears and coverage, the crossbridge attachment counts
   exactly), each solver's 128-step ODE trajectory at rtol 1e-5 / atol
   1e-6, every statistical
   entry of each side to its own bound (the Monte Carlo estimates within
   their Chebyshev bounds, each filter's mean weight within 3 sigma of its
   integral, the crossbridge steady state within 3 sigma of f/(f+g)), the
   deterministic plots' data equal, every PNG decoded through
   utils/image.py with its JSON sidecar; the interpolation kernel must
   launch (the sensor swatches of filter_film_test: a (471, 3) sensor
   table at 256 x 8 wavelengths), and each of its card launches is then
   held bitwise to the plain version on the very tensors it took; each
   app's card and CPU seconds;
22. the reference's call forms on the card: alive_fractions of the Cornell
   headline (512x512, path/MIS depth 4; both brute-force modes and the
   interpolation kernel launched) and its effective rays/s from phase 4's
   s/pass (1 + the alive fractions of depths 1..D-1 + those of depths
   0..D-1 rays a sample, as bench.py counts them); li_path,
   li_simple_path and li_random_walk bitwise _path_scan's output in their
   modes; sample_light and env_radiance with the wavelengths alone
   bitwise the spectral cache's route; alive_fractions of the mesh
   headline (both octree modes launched); every launch of these counted
   runs held to its kernel's plain version as in phases 4b, 10b and 21;
   then alive_fractions on the card within ALIVE_RAYS rays a depth of the
   CPU's at API_CPU_RES (Cornell in the path, simple and walk modes, the
   mesh headline);
23. (run after 12, while its scenes live) the captured pass: on the Cornell
   headline (chunk 32, as phase 4), the mesh headline, the flagship, the
   canonical frame (500x500, spp 100: the stratified walk) and the
   sobol_global headline (17a), render() / canonical_render(), which
   replay one captured CUDA graph (integrator.pass_graph) for every pass
   after the first, against the eager loop of render_pass /
   canonical_pass over the same Python indices (integrator.accumulate
   without capture): the films bitwise equal and every kernel's launch
   count equal; on the four render() scenes, the pass render() keeps
   across calls (integrator.KeptPass), each call's route read from the
   crt.graph.* counters (kept_routes) and its film and launches held to
   the eager loop's: a new seed replays the kept graph (sobol_global,
   whose seed is in the key, captures anew), a resumed render(film=,
   passes=) replays it for both halves, so does a call after the camera's
   frame cache is cleared and the allocator churned, and a new camera or
   a rebound scene tensor captures anew; the calls that miss, timed: MISS_CALLS
   render() calls of MISS_PASSES passes, each with a camera moved anew,
   against as many calls of render()'s route before it kept a pass
   (accumulate with capture and no KeptPass: the graph released in the
   call), in turns (capture, render, render, capture), each side's median
   s/call (miss_s_per_call); then one pass_graph captured
   alone (its seconds, the memory its pool reserved, its launches a
   replay) and GRAPH_TURN_PASSES eager passes against as many replays,
   timed in turns (eager, graph, graph, eager, twice), each side's median
   s/pass; on the canonical
   frame also the pass's three stratified draws alone, replayed from a
   CUDA graph (draws_ms);
24. (run after 14b) the captured train step at full width: config 5 with
   every leaf of inverse.albedo_and_emission_params; (a) one eager step of
   the card's form (inverse.make_step with DeviceAdam) with every kernel
   launch recorded, then each held to its plain version (the brute-force
   kernel's two modes and the interpolation kernel bitwise, the backward
   within BWD_REL of the sum of |terms|); one step graph captured alone
   (its seconds, the memory its pool reserved, its launches a replay);
   then TRAIN_STEPS steps through inverse.optimize (step 0 eagerly, step
   1 captured, every later step a replay) and through the eager loop with
   DeviceAdam, in the turns TRAIN_GRAPH_TURNS, every launch count at 0
   before each run and read after it: the losses and the final parameters
   of every run bitwise equal, the launches of both routes equal (each
   step a replay's), the loss falling; s/step of each run (steady: the
   eager loop from step 1, the replays from step 2) and the medians;
26. (four cards only: ``tools/smoke_phases.py 26``) render_distributed's
   kept step graph across frames: four ranks over NCCL, each on its own
   card, on a (2, 2) mesh (KEPT_LAYOUT, the cell ``cornell.sharded4``'s),
   the Cornell headline; a warm-up frame at KEPT_WARMUP_SPP passes, then
   a frame at each of KEPT_SEEDS (the first captures anew, as its spp
   differs; the others replay the kept graph) and each again as
   make_sharded_render's eager steps, every launch count at 0 before each
   run and read after: every film bitwise the eager steps' and rank 0's,
   the launches equal, the first film unchanged by the later frames; the
   hit share, each frame's seconds on each route, rank 0's peak memory,
   and each rank's seconds in destroy_process_group, called with its
   scene and kept graph alive (within KEPT_TIMEOUT_S);
13. (printed after 22) a JSON line of the kernels, with a row for each
   brute-force mode, each launch of 4b, each launch of 10b and 12b, the
   interpolation kernel, each case of its backward (9b) and each of
   phase 25's sampler draws; the rows of
   both brute-force modes, both octree modes and the interpolation
   kernel also carry their launches in phases 16 (the world-size-1 runs
   of 16a and 16c), 18-22 and 24, the backward's config 5 row its
   launches in 16 and 24 (launches_by_phase)
   (CUDA-event medians: of 5 for
   the kernels, of 3 for the plain versions and the brute kernel at full
   mesh size, one run of the plain traversal in 10b and 12b; the brute
   kernel in 2 and 4b, the octree kernel in 10b and 12b, the interpolation
   kernel, its plain version and grid_sample timed as replays of a CUDA
   graph of 20 launches; errors; launches; the bound: the least time the
   card could take for the same work, from the counted fp32 operations at
   67 TFLOP/s and the bytes at 3.35 TB/s), then the JSON result line.
"""

import contextlib
import dataclasses
import hashlib
import importlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from computational_ray_tracer_tpu_torch import convert, entry
from computational_ray_tracer_tpu_torch.apps import filter_film_test
from computational_ray_tracer_tpu_torch.apps import raytracer as rt_app
from computational_ray_tracer_tpu_torch.apps import shape_test as st_app
from computational_ray_tracer_tpu_torch.kernels import build
from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models import inverse as inv
from computational_ray_tracer_tpu_torch.models import lights as lgt
from computational_ray_tracer_tpu_torch.models import scene as scene_mod
from computational_ray_tracer_tpu_torch.ops import camera as cam
from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import octree as octmod
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.ops import rng
from computational_ray_tracer_tpu_torch.ops import rng_kernel as rk
from computational_ray_tracer_tpu_torch.ops import sensor as sen
from computational_ray_tracer_tpu_torch.ops import spectrum as spec
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import triangle as trimod
from computational_ray_tracer_tpu_torch.parallel import sharding as par
from computational_ray_tracer_tpu_torch.utils import (
    asset_cache, checkpoint, config as cfgmod, image, mesh_gen, metrics,
    obj_loader, ply_loader)

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "computational_ray_tracer_tpu_torch/csrc/"
HEADLINE_RES, HEADLINE_SPP = 512, 32
MESH_SPP = 4
# Image mean band of the mesh headline: a CPU render of the same scene at
# 48x48, spp 2 (the plain traversal) has mean 0.3875; +-20%.
MESH_MEAN_BAND = (0.31, 0.47)
# Image mean band of the flagship: a CPU render of the same scene at 48x48,
# spp 4 (the plain kernels) has mean 0.4874; +-20%.
FLAGSHIP_MEAN_BAND = (0.39, 0.585)
DEEP_SPP = 4                # deep512's timed passes, as bench.py's
CANONICAL_RES, CANONICAL_SPP = 500, 100
PLAIN_BUDGET_S = 60.0       # the plain traversal runs on all rays if
PLAIN_SUBSET = 65536        # a subset of this size predicts it fits
FP32_FLOPS = 67e12          # H100 SXM, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# 25: 64 int32 lanes an SM a clock, 132 SMs at 1.98 GHz (the clock of
# FP32_FLOPS)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 25: the cells' draws (case, lanes, kind, spp, xs, ys, sample index): the
# Cornell frame, the canonical frame and a config 5 pass
SAMPLER_SHAPES = (
    ("cornell_sobol32", 512 * 512, "sobol", 32, 1, 1, 7),
    ("canonical_stratified10x10", 500 * 500, "stratified", 100, 10, 10, 37),
    ("config5_sobol8", 48 * 48, "sobol", 8, 1, 1, 3))
# 25: the sampler kernel's 32-bit integer operations, as csrc/sampler.cu
# spells them, with the fewest instructions each needs: a hash word
# (multiply, XOR, three shift-XORs, two multiplies), a scramble (three
# rounds of ten and a mask), the permutation's keys, add and modulo, a
# Sobol' dimension (three a bit: shift-AND, negate-AND, XOR), the Owen
# scramble, the float conversion and scale; a lane's index, loads and
# store. The walk's further scrambles are not counted: where strata walk
# the bound is low.
SAMPLER_OPS = {"hash": 10, "scramble": 31, "permute": 24, "sobol": 96,
               "owen": 11, "float": 3, "lane": 6, "divmod": 20}
# 9b: the backward kernel and its plain version sum the same float32 terms
# in different orders (the plain index_add_ on the card in atomic order);
# the expected rounding error of a sum of m terms is about sqrt(m)/3 units
# of 2^-24 of the sum of their |values|, 2e-6 at the ~9,000 terms a cell
# of a 471-row table gathers from 2^21 rows.
BWD_REL = 2e-5
# 14a: the card's gradient against the CPU's, per leaf, as a share of the
# CPU's max|g|: the two renders agree to 2e-3*max (the golden tolerance).
GRAD_REL = 2e-3
TRAIN_STEPS = 20            # 14b and each turn of 24 (PERF.md section 5)
TRAIN_GRAPH_TURNS = ("graph", "eager", "graph")   # 24: one eager run ~18 s
CPU_LOSSES = 3              # 14b: the first losses checked on the CPU too
# 14b: the card's first losses against the CPU's: the renders agree to
# 2e-3*max and Adam's first updates are +-lr on every element, also where
# |g| is at the level of the card/CPU difference and its sign may differ.
LOSS_RTOL = 5e-3
OPTION_RES = 128
BACKWARD_REPLACES = (
    "computational_ray_tracer_tpu/ops/pallas_interp.py:36 (its gradient: "
    "the table gradient of the reference's differentiable default route, "
    "ops/spectrum.py:186-214)")
RENDER_OPTIONS = {
    "simple": {"integrator": "simple"},
    "walk": {"integrator": "walk"},
    "uniform_lambda": {"lambda_mode": "uniform"},
    "clamp": {"clamp": 0.05},
    "named_sensor": {"sensor_name": "canon_eos_5d"},
}
# 16: the sharded film against phase 4's (the CPU tests' tolerance), the
# sharded gradient against the unsharded one (rtol, and atol as a share of
# the leaf's max|g|), the train steps.
FILM_RTOL, FILM_ATOL = 1e-5, 2e-6
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL_SHARE = 1e-3, 1e-6
SHARD_STEPS = 5
SHARD_GRAPH_STEPS = 20      # 16c (1, 1): steps a turn, captured or eager
SHARD_TURNS = ("graph", "eager", "graph")   # 16a and 16c (1, 1)
TWO_RANK_LAYOUTS = ((2, 1), (1, 2))
RANKS_TIMEOUT_S = 300       # 16b's deadline (their time: PERF.md section 5)
# 26: the benchmark's cell cornell.sharded4 (a (2, 2) mesh, a warm-up
# frame at 4 passes), then three frames' sampler seeds.
KEPT_LAYOUT, KEPT_WARMUP_SPP = (2, 2), 4
KEPT_SEEDS = (11, (1 << 31) + 7, (1 << 32) + 5)
KEPT_TIMEOUT_S = 180        # 26's deadline: a teardown that waits fails
# 17: the sobol_global sample values checked bit for bit, and the new
# options and cameras of the 128x128 card-vs-CPU passes.
GRAPH_TURN_PASSES = 8       # 23: passes a turn, eager or replayed
MISS_CALLS = 3              # 23: render() calls a turn, each a new camera
MISS_PASSES = 2             # 23: passes a call that misses (eager, replay)
GLOBAL_DIMS = range(13)
GLOBAL_SAMPLES = (0, 31)
NEW_OPTIONS = {
    "sobol_global": {"sampler": integ.SamplerConfig(kind="sobol_global",
                                                    spp=1)},
    "lanczos": {"filter_name": "lanczos"},
}
NEW_CAMERAS = ("orthographic", "pinhole", "thinlens")
EDGE_BARY = 1e-5
# 19: the card's normals and uvs against the CPU's, on the hits whose
# camera ray meets the surface at |cos| >= GRAZING_COS: nearer the
# silhouette a one-ulp change of the ray moves the normal of the sphere by
# up to 6e-5 on the CPU (4.7e-6 at two ulps from |cos| 0.2 on).
SHAPE_ATOL = 1e-5
GRAZING_COS = 0.2
# 20: the JSON scene's mesh (the displaced icosphere) and its lighting, as
# entry.mesh327k_setup's; the film against the in-memory mesh's.
SCENE_FILE_SPEC = {
    "render": {"integrator": "path", "max_depth": 4,
               "sampler": {"kind": "sobol"}},
    "camera": {"kind": "perspective", "position": [0, 0.5, -3.4],
               "look_at": [0, 0, 0], "fov_y": 40.0},
    "materials": [{"kind": "diffuse", "albedo_rgb": [0.75, 0.71, 0.62]}],
    "lights": [{"kind": "distant", "direction": [-0.4, -1.0, 0.5],
                "rgb": [1.0, 1.0, 1.0], "scale": 4.0},
               {"kind": "ambient", "spd_named": "stdillum-D65",
                "scale": 0.15}],
}

# 22: alive_fractions on the card against the CPU port's at a reduced size
# (the rays apart at each depth: a camera ray that meets an edge or a
# grazing bounce may go either way on the two devices).
API_CPU_RES = {"cornell": 64, "mesh": 48}
ALIVE_RAYS = 2
ALIVE_MODES = ("path", "simple", "walk")

# 21: the validation apps, card against CPU. Entries the apps round to 4
# decimals may round 1e-4 apart from values within APP_ATOL.
VALIDATION_APPS = ("spectrum_color", "filter_film_test", "sampler_test",
                   "montecarlo_test", "polygon_app", "crossbridge", "ode_app",
                   "plotter_demo")
APP_RTOL, APP_ATOL = 1e-5, 1e-6
ROUNDED_ATOL = 1e-4 + 1e-6
# the plots whose data are the same on every device (no random draws)
DETERMINISTIC_PLOTS = {
    "sampler_test": ("points_independent.png", "points_stratified.png",
                     "points_sobol_owen.png"),
    "plotter_demo": ("plotter_demo.png",),
    "polygon_app": ("polygon.png",),
}
# the plots whose series are held at APP_RTOL / APP_ATOL between devices
# (the ODE trajectories: float32 steps whose sin may differ by an ulp)
CLOSE_PLOTS = {"ode_app": ("ode.png",)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=5, warm=True):
    """Warm once (unless the caller just ran ``fn``), then the median of
    ``reps`` CUDA-event timings."""
    if warm:
        fn()
        torch.cuda.synchronize()
    return statistics.median(timed(fn)[1] for _ in range(reps))


def per_launch_ms(fn, reps=5, inner=20):
    """Median over ``reps`` of the CUDA-event time of one replay of a CUDA
    graph of ``inner`` calls, per call (for kernels of tens of
    microseconds, whose eager launches would measure the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(timed(graph.replay)[1] / inner
                             for _ in range(reps))


def ptxas_report(log):
    """What nvcc's ``-Xptxas -v`` says of each kernel in ``log``: its
    (mangled) name, then its stack frame and spills, then its registers and
    shared memory."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            out.append(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            out.append(line.replace("ptxas info    : ", "").strip())
    return out


def timed(fn):
    """(fn(), its CUDA-event milliseconds), one run."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def bound(flops, nbytes):
    """The least time (ms) the card could take: the larger of the fp32
    operations over the fp32 peak and the bytes over the memory rate."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def brute_bound(t_max, counts, f, mask, out_bytes):
    """Bound of a brute-force launch from its own per-ray counters
    ``counts`` = (tests, passed, ranged): mik.EDGE_FLOPS per pair tested
    that fails the edge-sign test, RANGE_FLOPS per pair past it that fails
    the range test, PAIR_FLOPS per pair past both (live rays only; any hit
    up to its first hit); o and d read for the live rays (t_max > 0), t_max
    and ``out_bytes`` of outputs for every ray, the triangles (36 bytes
    each) and the mask once."""
    n, live = t_max.numel(), int((t_max > 0).sum())
    tests, passed, ranged = (int(c.sum()) for c in counts)
    flops = ((tests - passed) * mik.EDGE_FLOPS
             + (passed - ranged) * mik.RANGE_FLOPS + ranged * mik.PAIR_FLOPS)
    return bound(flops, 24 * live + (4 + out_bytes) * n + 36 * f
                 + (0 if mask is None else f))


@contextlib.contextmanager
def wrapped(module, name, before=None, after=None):
    """Replace module.name for the block: ``before(*args)`` sees every
    call's arguments and ``after(seconds)`` its host time to a sync."""
    fn = getattr(module, name)

    def call(*args, **kw):
        if before is not None:
            before(*args)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        if after is not None:
            after(time.perf_counter() - t0)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def compare(name, o, d, t_max, mesh, mask):
    """Phase 2: the closest-hit wrapper the scene calls launches the kernel
    on card tensors, then mesh_launch_row holds it to the plain version,
    times it and bounds it."""
    launches0 = mik.LAUNCHES
    mik.mesh_intersect(o, d, t_max, mesh, mask)
    torch.cuda.synchronize()
    assert mik.LAUNCHES == launches0 + 1, f"{name}: the kernel did not launch"
    row = mesh_launch_row(name, "closest", (o, d, t_max), mesh, mask)
    row["triangles"] = mesh.n_triangles
    print("phase2", json.dumps(row), flush=True)
    return row


def soup(n_tris, n_rays, seed, device):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (n_tris, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e1, base + e2])
    idx = np.stack([np.arange(n_tris) + k * n_tris for k in range(3)], 1)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, device=device)
    return trimod.MeshData.build(pos, idx, device=device), t(o), t(d)


def image_checks(img):
    h, w, _ = img.shape
    rows = slice(int(0.35 * h), int(0.65 * h))
    left = img[rows, int(0.02 * w):int(0.12 * w)].reshape(-1, 3).mean(0)
    right = img[rows, int(0.88 * w):int(0.98 * w)].reshape(-1, 3).mean(0)
    mean = float(img.mean())
    assert np.isfinite(img).all(), "non-finite pixels"
    assert 0.05 < mean < 0.9, f"image mean {mean}"
    assert left[0] > left[1] and left[0] > left[2], f"left wall {left}"
    assert right[1] > right[0] and right[1] > right[2], f"right wall {right}"
    return mean, left.tolist(), right.tolist()


def golden_check(phase, setup, golden_name):
    """Render ``setup`` through render() and hold it to a golden."""
    g_scene, g_camera, g_cfg = setup
    film, sensor = integ.render(g_scene, g_camera, g_cfg,
                                chunk=g_cfg.sampler.spp)
    img = film.resolve(sensor, to_srgb=False, clip=False).cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  golden_name + ".npy"))
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    g_err = float(np.abs(img - golden).max())
    assert np.isfinite(img).all() and g_err <= atol, \
        f"{phase}: golden max |diff| {g_err} > atol {atol}"
    return {"golden": golden_name, "max_abs_diff": g_err, "atol": atol}


def hits_agree(name, k, r):
    """Closest hits k vs reference r, (t, idx, b1, b2) each: hit masks equal
    on >= 99.99% of rays; where both hit, t within rtol 1e-5 and, where the
    ids agree, b1/b2 within atol 1e-5 (tests/test_pallas_octree.py:40-48);
    ids equal on >= 99.9% of those rays, and an id mismatch only at a tie
    (the two triangles' t within rtol 1e-5, checked with every t)."""
    hk, hr = torch.isfinite(k[0]), torch.isfinite(r[0])
    both = hk & hr
    agree = (hk == hr).float().mean().item() if hk.numel() else 1.0
    same = both & (k[1] == r[1])
    same_id = (same.sum() / both.sum()).item() if both.any() else 1.0
    t_abs = (k[0][both] - r[0][both]).abs()
    t_err = t_abs / r[0][both].abs().clamp(min=1e-30)
    b_err = max([(a[same] - b[same]).abs().max().item() if same.any()
                 else 0.0 for a, b in zip(k[2:4], r[2:4])])
    row = {"case": name, "rays": k[0].numel(),
           "hit_frac": hr.float().mean().item() if hr.numel() else 0.0,
           "hit_agree": agree, "same_id": same_id,
           "id_mismatches": int((both & ~same).sum()),
           "t_rel_err_max": t_err.max().item() if both.any() else 0.0,
           "t_abs_err_max": t_abs.max().item() if both.any() else 0.0,
           "b_abs_err_max": b_err,
           "bitwise": all(torch.equal(a, b) for a, b in zip(k, r))}
    assert agree >= 0.9999, f"{name}: hit masks agree on {agree}"
    assert row["t_rel_err_max"] <= 1e-5, f"{name}: t {row['t_rel_err_max']}"
    assert b_err <= 1e-5, f"{name}: barycentrics {b_err}"
    assert same_id >= 0.999, f"{name}: same triangle on {same_id}"
    return row


def counters(tests, pops):
    return {"tri_tests_mean": tests.float().mean().item(),
            "tri_tests_max": int(tests.max()),
            "node_pops_mean": pops.float().mean().item(),
            "node_pops_max": int(pops.max())}


def octree_bound(packed, t_max, tests, pops, out_words):
    """Bound of one traversal launch from its own counters: the slab
    tests' fp32 operations and mik.EDGE_FLOPS per triangle test, what every
    test needs (the counters do not separate the few tests past the
    edge-sign test, which need up to PAIR_FLOPS); t_max read and
    ``out_words`` 4-byte
    outputs written for every ray, o and d read for the live rays (t_max >
    0) only, and the three tree tables once, or, where it is less (a sparse
    wavefront), one sibling-group row per counted pop and one triangle slot
    per counted test."""
    n, live = t_max.numel(), int((t_max > 0).sum())
    flops = (int(tests.sum()) * mik.EDGE_FLOPS
             + int(pops.sum()) * 8 * okern.SLAB_FLOPS)
    touched = 4 * (int(pops.sum()) * 8 * okern.NODE_LANES
                   + int(tests.sum()) * okern.TRI_LANES)
    return bound(flops, 4 * n * (1 + out_words) + 4 * 6 * live
                 + min(packed.nbytes(), touched))


def plain_traverse(packed, o, d, t_max):
    return octmod.octree_traverse(o, d, t_max, packed.tree, packed.tri_verts,
                                  packed.tri_mask, pops=True)


def plain_ray_set(packed, o, d, t_max):
    """The rays the plain traversal is held to: all of them if a seeded
    subset of PLAIN_SUBSET predicts they take at most PLAIN_BUDGET_S, else
    that subset. Returns (label, (o, d, t_max), the subset's ms)."""
    n = o.shape[0]
    gen = torch.Generator().manual_seed(0)
    sub = torch.sort(torch.randperm(n, generator=gen)[:PLAIN_SUBSET]).values
    sub = sub.to(o.device)
    _, sub_ms = timed(lambda: plain_traverse(packed, o[sub], d[sub],
                                             t_max[sub]))
    if n <= PLAIN_SUBSET or sub_ms * 1e-3 * n / PLAIN_SUBSET <= PLAIN_BUDGET_S:
        return "all", (o, d, t_max), sub_ms
    return (f"seeded subset of {PLAIN_SUBSET}", (o[sub], d[sub], t_max[sub]),
            sub_ms)


def brute_launch_bound(o, d, t_max, mesh):
    """The bound (ms) of one closest-hit brute-force launch, from the
    kernel's counters, and its pairs past the sign test and past the range
    test per ray (a yardstick for the octree kernel's tests past the sign
    test on the same rays, which its counters do not separate)."""
    counts = mik.mesh_intersect(o, d, t_max, mesh, stats=True)[5:]
    n = t_max.numel()
    return {"brute_bound_ms": brute_bound(t_max, counts, mesh.n_triangles,
                                          None, 16)[0],
            "brute_passed_per_ray": counts[1].sum().item() / n,
            "brute_ranged_per_ray": counts[2].sum().item() / n}


def octree_phase(dev):
    """Phase 5 on the mesh bench scene; returns (scene, camera, cfg, rows)
    with the kernel rows of the closest-hit and any-hit modes."""
    times = {}
    torch.cuda.reset_peak_memory_stats()
    keep = lambda key: lambda s: times.__setitem__(key, s)
    t0 = time.perf_counter()
    with wrapped(octmod, "build_octree", after=keep("build_octree_s")), \
            wrapped(okern, "pack_from_numpy", after=keep("pack_upload_s")):
        scene, camera, cfg = entry.mesh327k_setup(HEADLINE_RES, MESH_SPP,
                                                  device=dev)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t0
    packed = scene.packed_octree
    print("phase5_setup", json.dumps({
        **times, "octree": scene.octree.info(), "depth": packed.depth,
        "triangles": scene.mesh.n_triangles, "cap": packed.cap,
        "leaf_table_mb": packed.leaf_verts.numel() * 4 / 1e6,
        "node_table_mb": packed.nodes.numel() * 4 / 1e6,
        "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 1e6}),
        flush=True)

    # (a) closest hit vs the plain traversal on the camera wavefront
    _, _, _, o, d = integ.camera_wavefront(camera, cfg, integ.make_filter(cfg),
                                           0, dev)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    t_inf = torch.full((n,), float("inf"), device=dev)
    plain = lambda oo, dd, tt: plain_traverse(packed, oo, dd, tt)
    kern = lambda: okern.octree_intersect(o, d, t_inf, packed)
    k = kern()
    rays, ray_set, sub_ms = plain_ray_set(packed, o, d, t_inf)
    k_set = lambda: okern.octree_intersect(*ray_set, packed)
    ms = median_ms(k_set)
    p = plain(*ray_set)
    plain_ms = median_ms(lambda: plain(*ray_set), 3, warm=False)
    row_a = hits_agree("a_closest_vs_plain", k_set(), p[:4])
    _, _, _, _, tests, pops = okern.octree_intersect(*ray_set, packed,
                                                     stats=True)
    bound_ms, bound_by = octree_bound(packed, ray_set[2], tests, pops, 4)
    row_a.update(plain_rays=rays, ms=ms, plain_ms=plain_ms,
                 plain_subset_ms=sub_ms, bound_ms=bound_ms,
                 bound_by=bound_by, **counters(tests, pops))
    print("phase5a", json.dumps(row_a), flush=True)

    # (b) closest hit vs the brute-force kernel, full wavefront
    brute = lambda: mik.mesh_intersect(o, d, t_inf, scene.mesh)[:4]
    row_b = hits_agree("b_closest_vs_brute_kernel", k, brute())
    row_b.update(ms=median_ms(kern), brute_kernel_ms=median_ms(brute, 3),
                 pairs=n * scene.mesh.n_triangles,
                 **brute_launch_bound(o, d, t_inf, scene.mesh))
    print("phase5b", json.dumps(row_b), flush=True)

    # (c) any hit vs plain on the sorted shadow wavefront of a direct pass
    shadow = []
    with wrapped(okern, "octree_anyhit",
                 before=lambda *a: shadow.append([x.clone() for x in a[:3]])):
        integ.render_pass(scene, camera, cfg, integ.make_filter(cfg),
                          sen.PixelSensor.create(), 0)
    assert len(shadow) == 1, f"{len(shadow)} any-hit calls in a direct pass"
    so, sd, st = shadow[0]
    kern_any = lambda: okern.octree_anyhit(so, sd, st, packed)
    h_k = kern_any()
    h_p = plain(so, sd, st)[1] >= 0
    plain_any_ms = median_ms(lambda: plain(so, sd, st), 3, warm=False)
    assert torch.equal(h_k, h_p), \
        f"c: any hit differs on {int((h_k != h_p).sum())} rays"
    _, tests, pops = okern.octree_anyhit(so, sd, st, packed, stats=True)
    bound_any, bound_any_by = octree_bound(packed, st, tests, pops, 1)
    row_c = {"case": "c_anyhit_vs_plain", "rays": st.numel(),
             "alive_frac": (st > 0).float().mean().item(),
             "occluded_frac": h_k.float().mean().item(), "equal": True,
             "ms": median_ms(kern_any), "plain_ms": plain_any_ms,
             "bound_ms": bound_any, "bound_by": bound_any_by,
             **counters(tests, pops)}
    print("phase5c", json.dumps(row_c), flush=True)

    # (d) the irregular reference-scale mesh vs the brute-force kernel
    t0 = time.perf_counter()
    v, f, uv = mesh_gen.dragon_stand_in()
    gen_s = time.perf_counter() - t0
    dmesh = trimod.MeshData.build(v, f, uvs=uv, device=dev)
    t0 = time.perf_counter()
    dtree = octmod.build_host_octree(v, f, 160)
    build_s = time.perf_counter() - t0
    dpacked = okern.pack_from_numpy(dtree, dmesh)
    dcam = cam.PerspectiveCamera.create((0, 12, -52), (HEADLINE_RES,) * 2,
                                        fov_y=45.0, look_at=(0, -1, 0))
    _, _, _, do, dd = integ.camera_wavefront(dcam, cfg, integ.make_filter(cfg),
                                             0, dev)
    do, dd = do.contiguous(), dd.contiguous()
    kern_d = lambda: okern.octree_intersect(do, dd, t_inf, dpacked)
    dbrute = lambda: mik.mesh_intersect(do, dd, t_inf, dmesh)[:4]
    row_d = hits_agree("d_dragon_closest_vs_brute_kernel", kern_d(),
                       dbrute())
    _, _, _, _, tests, pops = okern.octree_intersect(do, dd, t_inf, dpacked,
                                                     stats=True)
    bound_d, bound_d_by = octree_bound(dpacked, t_inf, tests, pops, 4)
    row_d.update(triangles=dmesh.n_triangles, octree=dtree.info(),
                 depth=dpacked.depth, generate_s=gen_s, build_octree_s=build_s,
                 leaf_table_mb=dpacked.leaf_verts.numel() * 4 / 1e6,
                 ms=median_ms(kern_d), brute_kernel_ms=median_ms(dbrute, 3),
                 bound_ms=bound_d, bound_by=bound_d_by,
                 **brute_launch_bound(do, dd, t_inf, dmesh),
                 max_memory_allocated_mb=torch.cuda.max_memory_allocated()
                 / 1e6, **counters(tests, pops))
    print("phase5d", json.dumps(row_d), flush=True)
    del dpacked, dmesh
    return scene, camera, cfg, row_a, row_c, (v, f, uv)


def capture_launches(fn, module, modes):
    """Run ``fn()`` and return the inputs of every call it makes of the
    kernel wrappers ``modes`` names (wrapper name -> mode) in ``module``:
    a list of (mode, (o, d, t_max) flattened and cloned, the wrapper's
    other positional arguments...)."""
    calls = []
    keep = lambda mode: lambda o, d, t_max, *rest: calls.append(
        (mode, (o.reshape(-1, 3).clone(), d.reshape(-1, 3).clone(),
                t_max.reshape(-1).clone()), *rest))
    with contextlib.ExitStack() as stack:
        for name, mode in modes.items():
            stack.enter_context(wrapped(module, name, before=keep(mode)))
        fn()
    return calls


def capture_octree_launches(fn):
    """The octree kernel's calls: (mode, rays, packed)."""
    return capture_launches(fn, okern, {"octree_intersect": "closest",
                                        "octree_anyhit": "anyhit"})


def capture_mesh_launches(fn):
    """The brute-force kernel's calls: (mode, rays, mesh, tri_mask)."""
    return capture_launches(fn, mik, {"mesh_intersect": "closest",
                                      "mesh_anyhit": "anyhit"})


def mesh_launch_row(name, mode, rays, mesh, mask):
    """The brute-force kernel on one captured launch, through its wrapper:
    held to the plain version bitwise (closest hit: all four outputs; any
    hit: every bit) and on the three counters, bounded by its own counters,
    and timed alone (mik._launch, without the wrapper's count fill) as
    replays of a CUDA graph of 20 launches."""
    o, d, t = rays
    anyhit = mode == "anyhit"
    wrapper = mik.mesh_anyhit if anyhit else mik.mesh_intersect
    plain_fn = mik.mesh_anyhit_plain if anyhit else mik.mesh_intersect_plain
    plain = lambda: plain_fn(o, d, t, mesh.tri_verts, mask)
    k = wrapper(o, d, t, mesh, mask)
    p = plain_fn(o, d, t, mesh.tri_verts, mask, stats=True)
    torch.cuda.synchronize()
    if anyhit:
        assert torch.equal(k, p[0]), \
            f"{name}: any hit differs on {int((k != p[0]).sum())} rays"
        row = {"case": name, "occluded_frac": k.float().mean().item()}
    else:
        assert all(torch.equal(a, b) for a, b in zip(k[:4], p[:4])), \
            f"{name}: closest hit differs on {int((k[1] != p[1]).sum())} ids"
        row = {"case": name, "hit_frac": torch.isfinite(k[0]).float()
               .mean().item()}
    counts = wrapper(o, d, t, mesh, mask, stats=True)[-3:]
    assert all(torch.equal(a, b) for a, b in zip(counts, p[-3:])), \
        f"{name}: the kernel's counters differ from the plain count"
    bound_ms, bound_by = brute_bound(t, counts, mesh.n_triangles, mask,
                                     1 if anyhit else 16)
    ms = per_launch_ms(lambda: mik._launch(anyhit, o, d, t, mesh.tri_verts,
                                           mask, False))
    live = int((t > 0).sum())
    per_live = lambda c: c.sum().item() / max(live, 1)
    row.update(mode=mode, rays=t.numel(), alive=live,
               bitwise=True, max_abs_err=0.0,
               tests_per_live_ray=per_live(counts[0]),
               passed_per_live_ray=per_live(counts[1]),
               ranged_per_live_ray=per_live(counts[2]),
               ms=ms, plain_ms=median_ms(plain, 3), bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms)
    return row


def cornell_launches(scene, camera, cfg, launches):
    """Phase 4b: the brute-force kernel on each of the 8 launches (closest
    and any hit, depths 0-3) of one full-wavefront Cornell pass.
    ``launches``: the kernel's launches per mode in phase 4's render.
    Returns the kernel-line rows."""
    calls = capture_mesh_launches(lambda: integ.render_pass(
        scene, camera, cfg, integ.make_filter(cfg), sen.PixelSensor.create(),
        0))
    depth = cfg.max_depth
    modes = [m for m, *_ in calls]
    assert modes == ["closest", "anyhit"] * depth, modes
    rows = []
    for j, (mode, rays, mesh, mask) in enumerate(calls):
        row = mesh_launch_row(f"cornell_{mode}_d{j // 2}", mode, rays, mesh,
                              mask)
        assert launches[mode] % depth == 0, launches
        row["launches"] = launches[mode] // depth
        print("phase4b", json.dumps(row), flush=True)
        rows.append(row)
    print("phase4b_sum", json.dumps({
        "ms": sum(r["ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows)}), flush=True)
    return rows


def octree_launch_row(name, packed, mode, rays):
    """The octree kernel on one captured launch, through its wrapper: its
    time, its bound from its own counters, and its agreement with the plain
    traversal on all rays or the seeded subset plain_ray_set picks: any
    hit exactly; closest hit by hits_agree over the live rays (t_max > 0,
    so that the dead ones of a sparse wavefront do not dilute it) and
    exactly on the dead ones."""
    o, d, t = (x.contiguous() for x in rays)
    anyhit = mode == "anyhit"
    wrapper = okern.octree_anyhit if anyhit else okern.octree_intersect
    label, ray_set, sub_ms = plain_ray_set(packed, o, d, t)
    p, plain_ms = timed(lambda: plain_traverse(packed, *ray_set))
    k = wrapper(*ray_set, packed)
    if anyhit:
        assert torch.equal(k, p[1] >= 0), \
            f"{name}: any hit differs on {int((k != (p[1] >= 0)).sum())} rays"
        row = {"case": name, "equal": True,
               "occluded_frac": (p[1] >= 0).float().mean().item()}
        err = 0.0
    else:
        live = ray_set[2] > 0
        row = hits_agree(name, [x[live] for x in k], [x[live] for x in p[:4]])
        assert all(torch.equal(a[~live], b[~live])
                   for a, b in zip(k, p[:4])), \
            f"{name}: a dead ray's output differs"
        row.update(live_rays_checked=row.pop("rays"),
                   bitwise=all(torch.equal(a, b) for a, b in zip(k, p[:4])))
        err = max(row["t_abs_err_max"], row["b_abs_err_max"])
    stats = wrapper(o, d, t, packed, stats=True)
    tests, pops = stats[-2:]
    bound_ms, bound_by = octree_bound(packed, t, tests, pops,
                                      1 if anyhit else 4)
    # A CUDA graph of the wrapper's launches: on the sparse bounce
    # wavefronts the kernels take about 0.1 ms, and eager launches would
    # add the host's time between them.
    ms = per_launch_ms(lambda: wrapper(o, d, t, packed))
    row.update(rays=t.numel(), mode=mode, alive=int((t > 0).sum()),
               plain_rays=label,
               plain_subset_ms=sub_ms, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms, max_abs_err=err,
               **counters(tests, pops))
    return row


def flagship_bounces(f_scene, f_camera, f_cfg, launches):
    """Phase 10b: the octree kernel on each of the 8 launches (closest and
    any hit, depths 0-3) of one full-wavefront flagship pass, then the
    depth-1 closest-hit wavefront in packet order as well as raster order.
    ``launches``: the kernel's launches per mode in phase 10's render.
    Returns the kernel-line rows."""
    calls = capture_octree_launches(lambda: integ.render_pass(
        f_scene, f_camera, f_cfg, integ.make_filter(f_cfg),
        sen.PixelSensor.create(), 0))
    depth = f_cfg.max_depth
    modes = [m for m, *_ in calls]
    assert modes == ["closest", "anyhit"] * depth, modes
    packed = f_scene.packed_octree
    rows = []
    for j, (mode, rays, _) in enumerate(calls):
        row = octree_launch_row(f"flagship_{mode}_d{j // 2}", packed, mode,
                                rays)
        assert launches[mode] % depth == 0, launches
        row["launches"] = launches[mode] // depth
        print("phase10b", json.dumps(row), flush=True)
        rows.append(row)
    # The depth-1 bounce rays in raster order (as the scene traces them)
    # and in the shadow rays' (octant, Morton) packet order.
    o, d, t = (x.contiguous() for x in calls[2][1])
    order = scene_mod._packet_order(o, d, t > 0.0)
    so, sd, st = o[order], d[order], t[order]
    k_raster = okern.octree_intersect(o, d, t, f_scene.packed_octree)
    k_sorted = okern.octree_intersect(so, sd, st, f_scene.packed_octree)
    unsorted = [torch.empty_like(x) for x in k_sorted]
    for u, x in zip(unsorted, k_sorted):
        u[order] = x
    assert all(torch.equal(a, b) for a, b in zip(unsorted, k_raster)), \
        "depth 1: packet order changed a closest hit"

    def sort_and_gather():
        i = scene_mod._packet_order(o, d, t > 0.0)
        return o[i], d[i], t[i]

    sort_ms = median_ms(sort_and_gather)
    print("phase10b_order", json.dumps({
        "case": "flagship_closest_d1", "alive": int((t > 0).sum()),
        "raster_ms": median_ms(lambda: okern.octree_intersect(
            o, d, t, f_scene.packed_octree)),
        "packet_ms": median_ms(lambda: okern.octree_intersect(
            so, sd, st, f_scene.packed_octree)),
        "sort_and_gather_ms": sort_ms, "same_hits": True}), flush=True)
    return rows


def interp_bound(n, k, c):
    """Bound of one interpolation launch: i0 and w (8 bytes a row), the
    (n, c) output and the table once; ik.ELEMENT_FLOPS per output."""
    return bound(n * c * ik.ELEMENT_FLOPS, 8 * n + 4 * n * c + 4 * k * c)


def lerp_grid(i0, w, k):
    """grid_sample's grid for the lerp of row i0 + w of a table as a
    (1, C, 1, K) image, align_corners=True: x = i0 + w mapped to [-1, 1]."""
    x = (i0.to(torch.float32) + w) * (2.0 / (k - 1)) - 1.0
    return torch.stack([x, torch.zeros_like(x)], -1).reshape(1, 1, -1, 2)


def sensor_rows(n, device):
    """(i0, w) of phase 21's sensor lookups: n / 8 stratified u through the
    visible-wavelength sampler (filter_film_test's swatches: n = 2,048)."""
    u = torch.linspace(0.001, 0.999, n // 8, device=device)
    i0, w, _ = spec._dense_idx_frac(spec.sample_visible_wavelengths(u).lam)
    return i0.reshape(-1).to(torch.int32), w.reshape(-1).contiguous()


def interp_case(name, tables, i0, w):
    """The interpolation kernel (through its wrapper) vs its plain version
    on the same card tensors: raises unless bitwise equal. Times both and
    grid_sample computing the same lerp: the table as a (1, C, 1, K) image
    sampled at x = i0 + w with align_corners=True."""
    k, c = tables.shape
    n = i0.shape[0]
    launches0 = ik.LAUNCHES
    out = ik.dense_interp(tables, i0, w)
    plain = ik.dense_interp_plain(tables, i0, w)
    torch.cuda.synchronize()
    assert ik.LAUNCHES == launches0 + 1, f"{name}: the kernel did not launch"
    bitwise = torch.equal(out, plain)
    err = (out - plain).abs().max().item()
    assert bitwise, f"{name}: interpolation kernel differs by {err}"
    img = tables.T.contiguous().reshape(1, c, 1, k)
    grid = lerp_grid(i0, w, k)
    lib = lambda: F.grid_sample(img, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
    lib_err = (lib()[0, :, 0].T - out).abs().max().item()
    bound_ms, bound_by = interp_bound(n, k, c)
    row = {"case": name, "rows": n, "k": k, "c": c, "bitwise": bitwise,
           "max_abs_err": err,
           "w_exact_0_1": int(((w == 0) | (w == 1)).sum()),
           "ms": per_launch_ms(lambda: ik.dense_interp(tables, i0, w)),
           "plain_ms": per_launch_ms(
               lambda: ik.dense_interp_plain(tables, i0, w)),
           "library_ms": per_launch_ms(lib),
           "library_max_abs_diff": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by}
    row["share_of_bound"] = bound_ms / row["ms"]
    print("phase9", json.dumps(row), flush=True)
    return row


def interp_backward_case(name, g, i0, w, k):
    """Phase 9b: the backward kernel (through its wrapper) vs the plain
    backward on the same tensors, within BWD_REL of the sum of |terms| a
    cell gathers; run twice, to the same bits (it sums in a fixed order).
    Times both and grid_sample's input gradient for the same lerp
    (phase 9's call, differentiated)."""
    n, c = g.shape
    launches0 = ik.LAUNCHES_BACKWARD
    out = ik.dense_interp_backward(g, i0, w, k)
    again = ik.dense_interp_backward(g, i0, w, k)
    plain = ik.dense_interp_backward_plain(g, i0, w, k)
    torch.cuda.synchronize()
    assert ik.LAUNCHES_BACKWARD == launches0 + (2 if g.is_cuda else 0), \
        f"{name}: the backward kernel did not launch"
    scale = ik.dense_interp_backward_plain(g.abs().double(), i0, w.double(),
                                           k)
    err = (out.double() - plain.double()).abs()
    assert bool((err <= BWD_REL * scale).all()), \
        f"{name}: backward differs by {float((err / scale).max())} of the sum"
    run_to_run = torch.equal(out, again)
    assert run_to_run, f"{name}: two runs of the backward kernel differ"
    img = torch.zeros((1, c, 1, k), device=g.device)
    grid = lerp_grid(i0.clamp(0, k - 2), w, k)   # the kernel's clamp
    grad_out = g.T.contiguous().reshape(1, c, 1, n)
    lib = lambda: torch.ops.aten.grid_sampler_2d_backward(
        grad_out, img, grid, 0, 0, True, [True, False])[0]
    lib_err = (lib()[0, :, 0].T - out).abs().max().item()
    bound_ms, bound_by = bound(n * c * ik.BACKWARD_ELEMENT_FLOPS,
                               4 * n * c + 8 * n + 4 * k * c)
    row = {"case": name, "rows": n, "k": k, "c": c,
           "max_abs_err": err.max().item(),
           "max_err_share_of_sum": float((err / scale.clamp(
               min=1e-300)).max()), "tolerance_share": BWD_REL,
           "run_to_run_bitwise": run_to_run,
           "ms": per_launch_ms(lambda: ik.dense_interp_backward(g, i0, w, k)),
           "plain_ms": per_launch_ms(
               lambda: ik.dense_interp_backward_plain(g, i0, w, k)),
           "library_ms": per_launch_ms(lib),
           "library_max_abs_diff": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by}
    row["share_of_bound"] = bound_ms / row["ms"]
    if g.is_cuda:
        row["plan"] = ik.backward_plan(k, c, n)
        row["warps_an_sm"] = (row["plan"]["blocks_an_sm"]
                              * row["plan"]["threads_a_block"] // 32)
    print("phase9b", json.dumps(row), flush=True)
    return row


def edge_rows(n, c, k, seed, device):
    """Phase 9b's case f: seeded (g, i0, w) of n rows whose i0 are at 0 (a
    quarter), at k-2 (a quarter) and outside [0, k-2] (every 7th row,
    clamped by the kernel), the rest uniform, and w exactly 0 or 1 on every
    5th row."""
    rng = np.random.default_rng(seed)
    i0 = rng.integers(0, k - 1, n).astype(np.int32)
    i0[: n // 4] = 0
    i0[n // 4: n // 2] = k - 2
    i0[::7] = np.where(np.arange(0, n, 7) % 2 == 0, -3, k + 2)
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[::5] = (np.arange(0, n, 5) // 5 % 2).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return seeded_gradient(n, c, seed, device), t(i0), t(w), k


def backward_graph_check(name, g, i0, w, k):
    """One backward launch captured in a CUDA graph and replayed twice:
    each replay, and an eager launch after them, gives the eager launch's
    bits (the launch's last cluster sets its ticket counters back to 0)."""
    eager = ik.dense_interp_backward(g, i0, w, k)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ik.dense_interp_backward(g, i0, w, k)
    same = []
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(captured, eager))
    same.append(torch.equal(ik.dense_interp_backward(g, i0, w, k), eager))
    assert all(same), f"{name}: graph replays differ from the eager launch"
    print("phase9b_graph", json.dumps({
        "case": name, "rows": g.shape[0], "c": g.shape[1],
        "plan": ik.backward_plan(k, g.shape[1], g.shape[0]),
        "replays_equal_eager": same[:2], "eager_after_equal": same[2]}),
        flush=True)


def seeded_gradient(n, c, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, c), generator=gen, device=device)


def keep_backward(calls):
    """A ``before`` hook for ik.dense_interp_backward: keeps the first
    call's (g, i0, w, k), cloned."""
    def before(g, i0, w, k):
        if not calls:
            calls.append((g.contiguous().clone(), i0.clone(), w.clone(), k))
    return before


def compact_vs_full(phase, scene, camera, cfg, sample_idx):
    """One render_pass_compact pass against the full-wavefront render_pass
    on the card at rtol 1e-4 / atol 1e-5 (tests/test_compaction.py);
    returns (the interpolation kernel's (tables, i0, w) in the compacted
    pass, the first call of each width; the row to print)."""
    flt = integ.make_filter(cfg)
    sensor = sen.PixelSensor.create()
    calls = {}

    def keep(tables, i0, w):
        if tables.shape[1] not in calls:
            calls[tables.shape[1]] = (tables.clone(), i0.clone(), w.clone())

    counts = []
    with wrapped(ik, "dense_interp", before=keep):
        rgb_c, wt_c = integ.render_pass_compact(scene, camera, cfg, flt,
                                                sensor, sample_idx, counts)
    rgb_f, wt_f = integ.render_pass(scene, camera, cfg, flt, sensor,
                                    sample_idx)
    torch.testing.assert_close(wt_c, wt_f, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(rgb_c, rgb_f, rtol=1e-4, atol=1e-5)
    n = cfg.resolution[0] * cfg.resolution[1]
    assert counts[0] == n and min(counts) < n, \
        f"{phase}: alive counts {counts}"
    return calls, {
        "res": cfg.resolution[0], "depth": cfg.max_depth,
        "alive_counts": counts,
        "compact_vs_full_max_abs_diff": (rgb_c - rgb_f).abs().max().item(),
        "rtol": 1e-4, "atol": 1e-5, "image_max": rgb_f.max().item()}


def zero_counts():
    """Every kernel's launch count to 0."""
    graphs.add_launch_counts({k: -n for k, n in read_counts().items()})


read_counts = graphs.launch_counts


def timed_render(phase, scene, camera, cfg, rays_per_sample, card, film=None,
                 warm=True):
    """One warm-up pass (unless ``film`` resumes a render), then render()
    with every launch count at 0; returns (film, sensor, row)."""
    if warm:
        integ.render(scene, camera, cfg, passes=1)
    torch.cuda.synchronize()
    zero_counts()
    start = 0 if film is None else film.spp_done
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, film=film)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    passes = film.spp_done - start
    launches = {"interp": ik.LAUNCHES, "closest": okern.LAUNCHES_CLOSEST,
                "anyhit": okern.LAUNCHES_ANYHIT}
    assert min(launches.values()) > 0, f"{phase} launched {launches}"
    w, h = cfg.resolution
    row = {"res": w, "depth": cfg.max_depth, "passes": passes,
           "s_per_pass": dt / passes,
           "rays_per_s": w * h * rays_per_sample * passes / dt,
           "launches": launches, "card": card}
    return film, sensor, row


def canonical_phase(dragon, dev, card):
    """Phase 12; returns the kernel-line row of the octree kernel on the
    500x500 camera wavefront (12b) and the canonical scene."""
    times = {}
    keep = lambda key: lambda s: times.__setitem__(key, s)
    t0 = time.perf_counter()
    with wrapped(octmod, "build_octree", after=keep("build_octree_s")), \
            wrapped(okern, "pack_from_numpy", after=keep("pack_upload_s")):
        c_scene = entry.canonical_scene(40, mesh=dragon, device=dev)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t0
    packed = c_scene.packed_octree
    print("phase12_setup", json.dumps({
        **times, "octree": c_scene.octree.info(), "depth": packed.depth,
        "triangles": c_scene.mesh.n_triangles,
        "kept_by_backface_cull": int(c_scene.tri_mask.sum()),
        "leaf_table_mb": packed.leaf_verts.numel() * 4 / 1e6}), flush=True)

    zero_counts()
    img64, _ = entry.canonical_render(64, 4, scene=c_scene)
    img64 = img64.cpu().numpy()
    golden = np.load(os.path.join(ROOT, "tests", "golden",
                                  "canonical_64.npy"))
    atol = 2e-3 * max(float(golden.max()), 1e-3)
    g_err = float(np.abs(img64 - golden).max())
    assert np.isfinite(img64).all() and g_err <= atol, \
        f"canonical golden max |diff| {g_err} > atol {atol}"
    assert ik.LAUNCHES > 0 and okern.LAUNCHES_CLOSEST > 0
    print("phase12_golden", json.dumps({
        "golden": "canonical_64", "max_abs_diff": g_err, "atol": atol,
        "launches_interp": ik.LAUNCHES,
        "launches_closest": okern.LAUNCHES_CLOSEST}), flush=True)

    camera, cfg = entry.canonical_view(CANONICAL_RES, CANONICAL_SPP)
    entry.canonical_pass(c_scene, camera, cfg, sen.PixelSensor.create(), 0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    img, _ = entry.canonical_render(CANONICAL_RES, CANONICAL_SPP,
                                    scene=c_scene)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"interp": ik.LAUNCHES, "closest": okern.LAUNCHES_CLOSEST,
                "anyhit": okern.LAUNCHES_ANYHIT}
    assert launches["interp"] > 0 and launches["closest"] > 0, launches
    img = img.cpu().numpy()
    mean = float(img.mean())
    assert np.isfinite(img).all() and mean > 0.01, f"canonical mean {mean}"
    print("phase12", json.dumps({
        "res": CANONICAL_RES, "spp": CANONICAL_SPP,
        "s_per_pass": dt / CANONICAL_SPP,
        "rays_per_s": CANONICAL_RES ** 2 * CANONICAL_SPP / dt,
        "launches": launches, "image_mean": mean, "card": card}), flush=True)

    # 12b: the octree kernel on the 500x500 camera wavefront of one pass
    calls = capture_octree_launches(lambda: entry.canonical_pass(
        c_scene, camera, cfg, sen.PixelSensor.create(), 0))
    assert [m for m, *_ in calls] == ["closest"], [m for m, *_ in calls]
    row = octree_launch_row("canonical_closest", packed, "closest",
                            calls[0][1])
    row["launches"] = launches["closest"]
    print("phase12b", json.dumps(row), flush=True)
    return row, c_scene


def draws_ms(cfg, dev):
    """Milliseconds of one pass's three stratified draws (the lambda,
    filter and lens draws of every pixel, on a device index: three
    sampler kernel launches), replayed from a CUDA graph: what the draws
    cost a captured pass."""
    s, (w, h) = cfg.sampler, cfg.resolution
    pixel = torch.arange(w * h, device=dev)
    idx = torch.zeros((), dtype=torch.int64, device=dev)
    return per_launch_ms(lambda: [
        s.get_1d(pixel, idx, integ.DIM_LAMBDA),
        s.get_2d(pixel, idx, integ.DIM_FILTER),
        s.get_2d(pixel, idx, integ.DIM_LENS)], inner=1)


def eager_film(scene, camera, cfg, chunk, film=None, stop=None):
    """(film, launches) of render()'s eager loop (accumulate without
    capture) from ``film`` (None: a new one) to ``stop`` (None: spp)."""
    flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
    film = film or filmmod.Film.create(cfg.resolution, scene.device)
    zero_counts()
    with torch.no_grad():
        film = integ.accumulate(
            lambda i: integ.render_pass(scene, camera, cfg, flt, sensor, i),
            film, stop or cfg.sampler.spp, chunk)
    return film, read_counts()


def kept_film(scene, camera, cfg, chunk, film=None, passes=None):
    """(film, launches, route) of one render() call; the route from the
    crt.graph.* counters of its frame: "kept" (replayed the kept graph),
    "captured" or "eager"."""
    metrics.reset()
    zero_counts()
    with torch.no_grad():
        film, _ = integ.render(scene, camera, cfg, film=film, passes=passes,
                               chunk=chunk)
    got = metrics.counters()
    route = ("kept" if got.get("crt.graph.kept") else "captured"
             if got.get("crt.graph.captured") else "eager")
    return film, read_counts(), route


def same_film(a, b):
    return (torch.equal(a.rgb_sum, b.rgb_sum)
            and torch.equal(a.weight_sum, b.weight_sum)
            and a.spp_done == b.spp_done)


def kept_case(name, setup, dev, chunk):
    """Phase 23's checks of the pass render() keeps across calls (see the
    module docstring), on a scene that render() has just captured for:
    each call's route, film and launches against the eager loop's.
    Returns {check: route} and, under "miss_s_per_call", miss_turns'."""
    scene, camera, cfg = setup
    spp = cfg.sampler.spp
    reseeded = dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler, seed=(1 << 31) + 77))
    new_seed = ("captured" if cfg.sampler.kind == "sobol_global"
                else "kept")
    routes = {}

    def check(what, route, got, want):
        routes[what] = got[2]
        assert got[2] == route, f"23 {name} {what}: route {got[2]}"
        assert same_film(got[0], want[0]), \
            f"23 {name} {what}: the film differs from the eager loop's"
        assert got[1] == want[1], f"23 {name} {what}: launches {got[1]}"

    check("new_seed", new_seed, kept_film(scene, camera, reseeded, chunk),
          eager_film(scene, camera, reseeded, chunk))
    half = kept_film(scene, camera, reseeded, chunk, passes=spp // 2)
    check("resume_first", "kept", half,
          eager_film(scene, camera, reseeded, chunk, stop=spp // 2))
    check("resume_rest", "kept",
          kept_film(scene, camera, reseeded, chunk, film=half[0]),
          eager_film(scene, camera, reseeded, chunk,
                     film=eager_film(scene, camera, reseeded, chunk,
                                     stop=spp // 2)[0]))
    # the camera's frame cache cleared and the allocator churned between
    # calls: the kept pass holds what its replays read
    cam._frame.cache_clear()
    churn = [torch.empty(1 << k, device=dev) for k in range(10, 28)]
    del churn
    torch.cuda.empty_cache()
    check("frame_cache_cleared", "kept",
          kept_film(scene, camera, reseeded, chunk),
          eager_film(scene, camera, reseeded, chunk))
    moved = dataclasses.replace(camera, position=tuple(
        float(x) + 0.01 for x in camera.position))
    check("new_camera", "captured", kept_film(scene, moved, reseeded, chunk),
          eager_film(scene, moved, reseeded, chunk))
    scene.materials.albedo_coeffs = scene.materials.albedo_coeffs.clone()
    check("rebound_tensor", "captured",
          kept_film(scene, moved, reseeded, chunk),
          eager_film(scene, moved, reseeded, chunk))
    routes["miss_s_per_call"] = miss_turns(name, scene, moved, reseeded,
                                           chunk)
    return routes


def miss_turns(name, scene, camera, cfg, chunk):
    """Phase 23's timing of the calls that miss the kept pass: per side,
    the seconds of each of MISS_CALLS calls of MISS_PASSES passes, each on
    a camera moved anew, in turns; "render" is render() (each call a new
    key: eager pass, capture kept, the old graph released), "capture" the
    route before render() kept a pass (accumulate with capture and no
    KeptPass, the graph released in the call)."""
    moves = iter(range(1, 1000))
    turns = {"capture": [], "render": []}

    def call(side):
        moved = dataclasses.replace(camera, position=tuple(
            float(x) + 1e-3 * next(moves) for x in camera.position))
        film = filmmod.Film.create(cfg.resolution, scene.device)
        metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "render":
            integ.render(scene, moved, cfg, film=film, passes=MISS_PASSES,
                         chunk=chunk)
        else:
            flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
            integ.accumulate(
                lambda i: integ.render_pass(scene, moved, cfg, flt, sensor,
                                            i),
                film, MISS_PASSES, chunk, capture=True)
        torch.cuda.synchronize()
        turns[side].append(time.perf_counter() - t0)
        assert metrics.counters().get("crt.graph.captured") == 1, \
            f"23 {name} miss {side}: {metrics.counters()}"

    with torch.no_grad():
        for side in ("capture", "render", "render", "capture"):
            for _ in range(MISS_CALLS):
                call(side)
    return {side: {"s": t, "median_s": statistics.median(t)}
            for side, t in turns.items()}


def graph_case(name, setup, dev, card, chunk=1, canonical=False):
    """One scene of phase 23 (see the module docstring)."""
    scene, camera, cfg = setup
    res, spp = cfg.resolution, cfg.sampler.spp
    if canonical:
        sensor = sen.PixelSensor.create()
        pass_fn = lambda i: entry.canonical_pass(scene, camera, cfg, sensor,
                                                 i)
        captured = lambda: entry.canonical_render(res[0], spp,
                                                  scene=scene)[1]
    else:
        flt, sensor = integ.make_filter(cfg), integ.make_sensor(cfg)
        pass_fn = lambda i: integ.render_pass(scene, camera, cfg, flt,
                                              sensor, i)
        captured = lambda: integ.render(scene, camera, cfg, chunk=chunk)[0]
    renders = {True: captured, False: lambda: integ.accumulate(
        pass_fn, filmmod.Film.create(res, dev), spp, chunk)}
    films, counts, render_s = {}, {}, {}
    for graph in (False, True):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            films[graph] = renders[graph]()
        torch.cuda.synchronize()
        render_s[graph] = (time.perf_counter() - t0) / spp
        counts[graph] = read_counts()
    assert torch.equal(films[True].rgb_sum, films[False].rgb_sum) and \
        torch.equal(films[True].weight_sum, films[False].weight_sum), \
        f"{name}: the captured film differs from the eager film"
    assert counts[True] == counts[False], f"{name}: launches {counts}"
    assert films[True].spp_done == spp
    del films
    kept = None if canonical else kept_case(name, setup, dev, chunk)

    n = min(GRAPH_TURN_PASSES, spp)
    with torch.no_grad():
        pass_fn(0)    # its constants, as render()'s first pass
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        pg = integ.pass_graph(pass_fn, 0, res, dev)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        pool_mb = (torch.cuda.memory_reserved(dev) - reserved0) / 1e6
        turns = {"eager": [], "graph": []}
        for side in ("eager", "graph", "graph", "eager") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "eager":
                integ.accumulate(pass_fn, filmmod.Film.create(res, dev), n,
                                 chunk=n)
            else:
                pg.set_index(0)
                integ.replay_sums(pg, n)
            torch.cuda.synchronize()
            turns[side].append((time.perf_counter() - t0) / n)
        draws = draws_ms(cfg, dev) if canonical else None
    launches = pg.launches
    del pg
    torch.cuda.empty_cache()
    eager_s = statistics.median(turns["eager"])
    graph_s = statistics.median(turns["graph"])
    row = {"case": name, "res": res[0], "spp": spp, "chunk": chunk,
           "films_bitwise": True, "launches": counts[True],
           "render_s_per_pass_eager": render_s[False],
           "render_s_per_pass_graph": render_s[True],
           "turn_passes": n, "eager_s_per_pass": turns["eager"],
           "graph_s_per_pass": turns["graph"],
           "eager_median_s": eager_s, "graph_median_s": graph_s,
           "eager_over_graph": eager_s / graph_s, "capture_s": capture_s,
           "pool_mb": pool_mb, "launches_per_replay": launches,
           "draws_ms": draws, "kept_routes": kept, "card": card}
    print("phase23", json.dumps(row), flush=True)


def graph_phase(dev, card, mesh_setup=None, c_scene=None):
    """Phase 23; ``mesh_setup`` (phase 5's mesh headline) and ``c_scene``
    (phase 12's canonical scene) are built here when not given."""
    t_phase = time.perf_counter()
    mesh_setup = mesh_setup or entry.mesh327k_setup(HEADLINE_RES, MESH_SPP,
                                                    device=dev)
    if c_scene is None:
        c_scene = entry.canonical_scene(40, device=dev)
    cornell = entry.cornell_setup(HEADLINE_RES, HEADLINE_SPP, dev)
    global_cfg = dataclasses.replace(cornell[2], sampler=integ.SamplerConfig(
        kind="sobol_global", spp=HEADLINE_SPP))
    graph_case("cornell_headline", cornell, dev, card, chunk=HEADLINE_SPP)
    graph_case("mesh_headline", mesh_setup, dev, card)
    graph_case("flagship", entry.flagship_setup(
        HEADLINE_RES, MESH_SPP, scene=mesh_setup[0], device=dev), dev, card)
    graph_case("canonical", (c_scene,) + entry.canonical_view(
        CANONICAL_RES, CANONICAL_SPP), dev, card, canonical=True)
    graph_case("sobol_global_headline", cornell[:2] + (global_cfg,), dev,
               card, chunk=HEADLINE_SPP)
    print("phase23_s", json.dumps({"seconds": time.perf_counter() - t_phase}),
          flush=True)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def value_and_grad(loss_fn, params, scene):
    loss = loss_fn(params, scene)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def grads_close(got, ref, rel):
    """Each leaf of ``got`` finite and within ``rel`` of max|ref| of
    ``ref``; returns the share per leaf."""
    out = {}
    for key, r in ref.items():
        g = got[key].cpu()
        assert bool(torch.isfinite(g).all()), f"{key}: a gradient is not finite"
        scale = float(r.abs().max())
        out[key] = float((g - r).abs().max()) / max(scale, 1e-30)
        assert out[key] <= rel, f"{key}: gradients differ by {out[key]} of max"
    return out


def config5_phase(dev, card, scale="full", steps=TRAIN_STEPS):
    """Phases 14a and 14b (config 5 at ``scale``); returns (14b's launches,
    the first interpolation backward call of 14a's gradient, 14b's median
    seconds per step)."""
    start, camera, cfg, lr, target_img, ei = config5_start(dev, scale)
    loss_fn = inv.make_loss_fn(camera, cfg, ei, target_img)
    params = inv.leaf_params(ei[0](start))
    calls = []
    t0 = time.perf_counter()
    with wrapped(ik, "dense_interp_backward", before=keep_backward(calls)):
        loss, grads = value_and_grad(loss_fn, params, start)
    sync(dev)
    card_s = time.perf_counter() - t0
    _, c_start, c_camera, c_cfg, _, _ = entry.config5_setup(scale, "cpu")
    c_ei = inv.albedo_and_emission_params(c_start)
    c_loss_fn = inv.make_loss_fn(c_camera, c_cfg, c_ei, target_img.cpu())
    t0 = time.perf_counter()
    c_loss, c_grads = value_and_grad(c_loss_fn, convert.params_from_numpy(
        {k: v.detach().cpu().numpy() for k, v in params.items()}, "cpu"),
        c_start)
    cpu_s = time.perf_counter() - t0
    share = grads_close(grads, c_grads, GRAD_REL)
    emission_max = float(grads["emission"].abs().max())
    assert emission_max > 0.0, "the card's emission gradient is zero"
    cuda = torch.device(dev).type == "cuda"
    assert not cuda or calls, "no interpolation backward launch"
    print("phase14a", json.dumps({
        "res": cfg.resolution[0], "spp": cfg.sampler.spp,
        "depth": cfg.max_depth, "loss": loss, "cpu_loss": c_loss,
        "grad_max_abs": {k: float(v.abs().max()) for k, v in grads.items()},
        "grad_diff_share_of_max": share, "tolerance_share": GRAD_REL,
        "all_finite": True, "card_s": card_s, "cpu_s": cpu_s}), flush=True)

    times = []
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    _, params, history = inv.optimize(
        start, camera, cfg, ei, target_img, steps=steps, lr=lr,
        callback=lambda *a: times.append(time.perf_counter()))
    sync(dev)
    train_s = time.perf_counter() - t0
    launches = read_counts()
    with torch.no_grad():
        loss_n = float(loss_fn(params, start))
    assert loss_n < history[0], f"loss {history[0]} -> {loss_n}"
    assert not cuda or min(launches["brute_closest"],
                                launches["brute_anyhit"], launches["interp"],
                                launches["interp_backward"]) > 0, launches
    _, _, c_history = inv.optimize(c_start, c_camera, c_cfg, c_ei,
                                   target_img.cpu(), steps=CPU_LOSSES, lr=lr)
    loss_rel = [abs(a - b) / b for a, b in zip(history, c_history)]
    assert max(loss_rel) <= LOSS_RTOL, f"card/CPU losses differ by {loss_rel}"
    steps_s = [b - a for a, b in zip([t0] + times, times)]
    print("phase14b", json.dumps({
        "steps": steps, "lr": lr, "seconds": train_s,
        "s_per_step_median": statistics.median(steps_s),
        "s_first_step": steps_s[0], "loss_step0": history[0],
        "loss_after_last_step": loss_n, "losses": history,
        "cpu_losses": c_history, "loss_rel_diff": loss_rel,
        "loss_rtol": LOSS_RTOL,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "card": card}), flush=True)
    return launches, calls[0] if calls else None, statistics.median(steps_s)


def config5_start(dev, scale="full"):
    """(start scene, camera, cfg, lr, target image, every leaf of
    inverse.albedo_and_emission_params) of config 5 at ``scale``."""
    _, start, camera, cfg, lr, _ = entry.config5_setup(scale, dev)
    return (start, camera, cfg, lr, config5_target(dev, scale),
            inv.albedo_and_emission_params(start))


def step_launch_checks(dev, scale="full"):
    """24a: every kernel launch of one eager training step of the card's
    form (inverse.make_step with DeviceAdam) recorded, then (the counts
    read) each held to its plain version: the brute-force kernel (both
    modes) and the interpolation kernel bitwise, each backward launch
    within BWD_REL of the sum of |terms| a cell gathers. Returns {kernel:
    {"launches": checked, "max_abs_err": ...}}."""
    start, camera, cfg, lr, target_img, ei = config5_start(dev, scale)
    params = inv.leaf_params(ei[0](start))
    step = inv.make_step(camera, cfg, ei, target_img, params, start,
                         inv.DeviceAdam(list(params.values()), lr))
    backward = []
    keep = lambda g, i0, w, k: backward.append(
        (g.contiguous().clone(), i0.clone(), w.clone(), k))
    with wrapped(ik, "dense_interp_backward", before=keep):
        _, calls = capture_all(step)
    sync(dev)
    held = held_to_plain(calls)
    err = 0.0
    for g, i0, w, k in backward:
        got = ik.dense_interp_backward(g, i0, w, k)
        plain = ik.dense_interp_backward_plain(g, i0, w, k)
        terms = ik.dense_interp_backward_plain(g.abs().double(), i0,
                                               w.double(), k)
        diff = (got.double() - plain.double()).abs()
        assert bool((diff <= BWD_REL * terms).all()), \
            f"24a: backward differs by {float((diff / terms).max())}"
        err = max(err, diff.max().item())
    if backward:
        held["dense_interp_backward"] = {"launches": len(backward),
                                         "max_abs_err": err}
    assert torch.device(dev).type != "cuda" or set(held) == {
        "mesh_intersect", "mesh_anyhit", "dense_interp",
        "dense_interp_backward"}, held
    return held


def train_graph_phase(dev, card, steps=TRAIN_STEPS):
    """Phase 24 (see the module docstring); returns the launches of its
    captured runs."""
    t_phase = time.perf_counter()
    held = step_launch_checks(dev)
    start, camera, cfg, lr, target_img, ei = config5_start(dev)

    # a step graph alone: its capture seconds and the memory its pool holds
    params = inv.leaf_params(ei[0](start))
    opt = inv.DeviceAdam(list(params.values()), lr)
    step = inv.make_step(camera, cfg, ei, target_img, params, start, opt)
    graphs.on_side_stream(step)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    opt.zero_grad()
    t0 = time.perf_counter()
    graph = graphs.CapturedGraph(step)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_mb = (torch.cuda.memory_reserved(dev) - reserved0) / 1e6
    launches_per_replay = graph.launches
    del graph, step, opt, params
    torch.cuda.empty_cache()

    runs = {"graph": lambda tick: inv.optimize(
                start, camera, cfg, ei, target_img, steps=steps, lr=lr,
                callback=tick),
            "eager": lambda tick: inv._optimize(
                start, camera, cfg, ei, target_img, steps, lr, tick)}
    ref, turns, counts = None, {"graph": [], "eager": []}, {}
    for side in TRAIN_GRAPH_TURNS:
        times = []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        _, params, history = runs[side](
            lambda *a: times.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts.setdefault(side, read_counts())
        assert read_counts() == counts[side], f"24: {side} launches differ"
        turns[side].append([b - a for a, b in zip([t0] + times, times)])
        ref = ref or (params, history)
        assert history == ref[1], f"24: the {side} losses differ"
        assert all(torch.equal(params[k], ref[0][k]) for k in params), \
            f"24: the {side} parameters differ"
    history = ref[1]
    assert counts["graph"] == counts["eager"], counts
    assert history[-1] < history[0], f"24: loss {history[0]} -> {history[-1]}"
    assert min(counts["graph"][k] for k in (
        "brute_closest", "brute_anyhit", "interp", "interp_backward")) > 0, \
        counts["graph"]
    assert all(n == launches_per_replay[k] * steps
               for k, n in counts["graph"].items()), launches_per_replay
    # steady s/step: the eager loop from step 1, the replays from step 2
    # (step 0 runs eagerly, step 1 is the capture and its first replay)
    skip = {"graph": 2, "eager": 1}
    steady = {side: [statistics.median(run[skip[side]:]) for run in runs_s]
              for side, runs_s in turns.items()}
    median = {side: statistics.median(s for run in runs_s
                                      for s in run[skip[side]:])
              for side, runs_s in turns.items()}
    print("phase24", json.dumps({
        "res": cfg.resolution[0], "spp": cfg.sampler.spp,
        "depth": cfg.max_depth, "lr": lr, "steps": steps,
        "turns": list(TRAIN_GRAPH_TURNS), "losses_bitwise": True,
        "params_bitwise": True, "losses": history,
        "launches_per_step": {k: v / steps
                              for k, v in counts["graph"].items()},
        "launches_per_replay": launches_per_replay,
        "held_to_plain": held, "capture_s": capture_s, "pool_mb": pool_mb,
        "s_per_step": steady,
        "s_step0": {side: [run[0] for run in runs_s]
                    for side, runs_s in turns.items()},
        "s_step1": {side: [run[1] for run in runs_s]
                    for side, runs_s in turns.items()},
        "graph_median_s_per_step": median["graph"],
        "eager_median_s_per_step": median["eager"],
        "eager_over_graph": median["eager"] / median["graph"],
        "phase_s": time.perf_counter() - t_phase, "card": card}),
        flush=True)
    return counts["graph"]


def headline_grad_phase(dev, card, res=HEADLINE_RES):
    """Phase 14c: one gradient of a Cornell headline pass; returns the
    pass's interpolation backward call."""
    scene, camera, cfg = entry.cornell_setup(res, HEADLINE_SPP, dev)
    render_image, _ = inv.make_render_fn(camera, cfg, spp=1)
    extract, insert = inv.albedo_and_emission_params(scene)
    params = inv.leaf_params(extract(scene))
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    calls = []
    zero_counts()
    with wrapped(ik, "dense_interp_backward", before=keep_backward(calls)):
        t0 = time.perf_counter()
        loss = torch.mean(render_image(insert(scene, params)) ** 2)
        sync(dev)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(params.values()))
        sync(dev)
        t2 = time.perf_counter()
    launches = read_counts()
    for key, g in zip(params, grads):
        assert bool(torch.isfinite(g).all()), f"14c: {key} gradient not finite"
    assert float(grads[2].abs().max()) > 0, "14c: emission gradient is zero"
    assert not cuda or launches["interp_backward"] == 1, launches
    print("phase14c", json.dumps({
        "res": res, "depth": cfg.max_depth, "loss": float(loss.detach()),
        "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 1e6
        if cuda else None,
        "grad_max_abs": {k: float(g.abs().max())
                         for k, g in zip(params, grads)},
        "launches": launches, "card": card}), flush=True)
    return calls[0] if calls else None


@contextlib.contextmanager
def plain_octree():
    """The octree wrappers run the plain traversal on any device (the
    scene's calls only; nothing launches)."""
    def closest(o, d, t_max, packed, stats=False):
        return octmod.octree_traverse(o, d, t_max, packed.tree,
                                      packed.tri_verts, packed.tri_mask)[:4]

    def anyhit(o, d, t_max, packed, stats=False):
        return closest(o, d, t_max, packed)[1] >= 0

    saved = okern.octree_intersect, okern.octree_anyhit
    okern.octree_intersect, okern.octree_anyhit = closest, anyhit
    try:
        yield
    finally:
        okern.octree_intersect, okern.octree_anyhit = saved


def octree_grad_phase(dev):
    """Phase 14d, bench.py's bench_grad_check: d mean(rgb) / d albedo of one
    32x32 Sobol spp 2, path depth 2 pass of the 1,280-triangle displaced
    icosphere (cap 16), through the octree kernel and through the plain
    traversal."""
    scene, _, _ = entry.mesh327k_setup(32, 2, subdiv=3, cap=16, device=dev)
    camera = cam.PerspectiveCamera.create((0, 0.5, -3.4), (32, 32),
                                          fov_y=40.0, look_at=(0, 0, 0))
    cfg = integ.RenderConfig(
        resolution=(32, 32), sampler=integ.SamplerConfig(kind="sobol", spp=2),
        integrator="path", max_depth=2)

    def grad():
        coeffs = scene.materials.albedo_coeffs.clone().requires_grad_(True)
        s = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo_coeffs=coeffs))
        rgb, _ = integ.render_pass(s, camera, cfg, integ.make_filter(cfg),
                                   integ.make_sensor(cfg), 0)
        return torch.autograd.grad(rgb.mean(), [coeffs])[0]

    zero_counts()
    g_kernel = grad()
    kernel_launches = read_counts()
    with plain_octree():
        g_plain = grad()
    octree = lambda counts: (counts["octree_closest"], counts["octree_anyhit"])
    assert torch.device(dev).type != "cuda" or min(octree(
        kernel_launches)) > 0, kernel_launches
    assert octree(read_counts()) == octree(kernel_launches), \
        "the plain traversal's run launched the octree kernel"
    scale = float(g_plain.abs().max())
    rel = float((g_kernel - g_plain).abs().max()) / scale
    assert scale > 0 and rel <= 1e-3, f"14d: gradients differ by {rel}"
    print("phase14d", json.dumps({
        "triangles": scene.mesh.n_triangles, "grad_linf_plain": scale,
        "grad_max_rel_diff": rel, "gate": 1e-3,
        "bitwise": torch.equal(g_kernel, g_plain),
        "launches": kernel_launches}), flush=True)


def options_phase(dev, res=OPTION_RES):
    """Phase 15: golden configuration 1, then one pass of each of
    RENDER_OPTIONS on ``dev`` against the CPU."""
    zero_counts()
    row = golden_check("phase15", entry.golden1_sphere_direct(dev),
                       "config1_sphere_direct")
    print("phase15_golden", json.dumps({**row, "launches": read_counts()}),
          flush=True)
    scene, camera, cfg = entry.cornell_setup(res, 1, dev)
    c_scene, c_camera, _ = entry.cornell_setup(res, 1, "cpu")
    for name, change in RENDER_OPTIONS.items():
        o_cfg = dataclasses.replace(cfg, **change)
        zero_counts()
        rgb = integ.render_pass(scene, camera, o_cfg, integ.make_filter(
            o_cfg), integ.make_sensor(o_cfg), 0)[0]
        sync(dev)
        launches = read_counts()
        ref = integ.render_pass(c_scene, c_camera, o_cfg, integ.make_filter(
            o_cfg), integ.make_sensor(o_cfg), 0)[0]
        rgb = rgb.cpu()
        atol = 2e-3 * max(float(ref.max()), 1e-3)
        err = float((rgb - ref).abs().max())
        assert bool(torch.isfinite(rgb).all()) and err <= atol, \
            f"phase15 {name}: max |diff| {err} > atol {atol}"
        assert torch.device(dev).type != "cuda" or (
            launches["brute_closest"] > 0 and launches["interp"] > 0
            and (launches["brute_anyhit"] > 0) == (name != "walk")), launches
        print("phase15", json.dumps({
            "case": name, "res": res, "max_abs_diff_vs_cpu": err,
            "atol": atol, "image_max": float(ref.max()),
            "launches": launches}), flush=True)


def close_films(got, ref):
    """(max |diff| of the weighted sums, bitwise) of two films; raises
    beyond FILM_RTOL / FILM_ATOL."""
    for a, b in ((got.rgb_sum, ref.rgb_sum), (got.weight_sum,
                                              ref.weight_sum)):
        a = a.cpu()
        b = b.cpu()
        excess = ((a - b).abs() - FILM_RTOL * b.abs()).max().item()
        assert excess <= FILM_ATOL, f"films differ by {excess} past rtol"
    assert got.spp_done == ref.spp_done, (got.spp_done, ref.spp_done)
    return ((got.rgb_sum.cpu() - ref.rgb_sum.cpu()).abs().max().item(),
            torch.equal(got.rgb_sum.cpu(), ref.rgb_sum.cpu())
            and torch.equal(got.weight_sum.cpu(), ref.weight_sum.cpu()))


def counted_run(fn, dev):
    """(fn(), its seconds, the launches it made), every count at 0 just
    before it and read just after."""
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0, read_counts()


def sharded_headline(scene, camera, cfg, mesh, dev):
    """16b: one warm-up step, then render_distributed (eager on gloo) with
    every count at 0 just before and read just after: (film, s/pass,
    launches)."""
    step, _ = par.make_sharded_render(scene, camera, cfg, mesh)
    step(scene, filmmod.Film.create(cfg.resolution, device=dev), 0)
    (film, _), dt, launches = counted_run(
        lambda: par.render_distributed(scene, camera, cfg, mesh), dev)
    path = ("brute_closest", "brute_anyhit", "interp")
    assert torch.device(dev).type != "cuda" or min(
        launches[k] for k in path) > 0, launches
    return film, dt / cfg.sampler.spp, launches


def eager_sharded_render(scene, camera, cfg, mesh):
    """render_distributed's steps as eager calls of make_sharded_render's
    step: the bits its captured route must give."""
    step, _ = par.make_sharded_render(scene, camera, cfg, mesh)
    film = filmmod.Film.create(cfg.resolution, device=scene.device)
    for base in range(0, cfg.sampler.spp, mesh.size(1)):
        film = step(scene, film, base)
    return film


def sharded_render_turns(scene, camera, cfg, mesh, dev):
    """16a's routes on ``mesh``: one step graph captured alone after
    an eager step (its capture seconds, its launches a replay, spp - 1
    replays timed), then render_distributed (captured where
    par.captures(mesh)) and its eager steps in the turns SHARD_TURNS,
    every count at 0 before each run and read after: every film bitwise
    equal, the launches of both routes equal and, captured, each step a
    replay's. Returns (film, row)."""
    spp = cfg.sampler.spp
    captured = par.captures(mesh)
    capture_s = replay_s = per_replay = None
    if captured:
        sums = par._sharded_sums(camera, cfg, mesh, integ.make_filter(cfg),
                                 integ.make_sensor(cfg))
        sums(scene, 0)
        sync(dev)
        t0 = time.perf_counter()
        graph = integ.capture_sums(lambda idx: sums(scene, idx), 1, 1,
                                   cfg.resolution, dev, kept=True)
        sync(dev)
        capture_s = time.perf_counter() - t0
        _, replay_s, _ = counted_run(
            lambda: integ.replay_sums(graph, spp - 1), dev)
        per_replay = graph.launches
        del graph
    runs = {"graph": lambda: par.render_distributed(scene, camera, cfg,
                                                    mesh)[0],
            "eager": lambda: eager_sharded_render(scene, camera, cfg, mesh)}
    film, turns, counts = None, {"graph": [], "eager": []}, {}
    for side in SHARD_TURNS:
        got, dt, launches = counted_run(runs[side], dev)
        turns[side].append(dt / spp)
        counts.setdefault(side, launches)
        assert launches == counts[side], f"16a: {side} launches differ"
        film = got if film is None else film
        assert (torch.equal(got.rgb_sum, film.rgb_sum)
                and torch.equal(got.weight_sum, film.weight_sum)
                and got.spp_done == film.spp_done), \
            f"16a: the {side} film differs"
    assert counts["graph"] == counts["eager"], counts
    assert not captured or all(n == per_replay[k] * spp for k, n in
                               counts["graph"].items()), per_replay
    assert torch.device(dev).type != "cuda" or min(
        counts["graph"][k] for k in ("brute_closest", "brute_anyhit",
                                     "interp")) > 0, counts["graph"]
    return film, {
        "route": "captured" if captured else "eager",
        "turns": list(SHARD_TURNS), "films_bitwise": True,
        "s_per_pass": turns,
        "replayed_s_per_pass": replay_s and replay_s / (spp - 1),
        "capture_s": capture_s,
        "launches_per_pass": {k: n / spp for k, n in counts["graph"].items()},
        "launches": counts["graph"]}


def film_digest(film):
    """SHA-256 of a film's sums, bit for bit."""
    h = hashlib.sha256()
    for t in (film.rgb_sum, film.weight_sum):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def kept_sharded_rank(rank, world, address, tmp):
    """A rank of phase 26: joins the NCCL group of ``world`` ranks (one
    card each) at ``address``, renders the Cornell headline through
    render_distributed on the KEPT_LAYOUT mesh (a warm-up frame at
    KEPT_WARMUP_SPP, then a frame at each of KEPT_SEEDS) and each of those
    frames again as make_sharded_render's eager steps, every launch count
    at 0 before each run and read after; writes its results to
    tmp/rank<rank>.pt, then leaves the group as the benchmark's rank 0
    does, the scene still alive (the kept graph holds NCCL kernels)."""
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    par.init_distributed(address, world, rank)
    mesh = par.make_mesh(*KEPT_LAYOUT)
    scene, camera, cfg = entry.cornell_setup(HEADLINE_RES, HEADLINE_SPP, dev)
    with_seed = lambda seed, spp=HEADLINE_SPP: dataclasses.replace(
        cfg, sampler=dataclasses.replace(cfg.sampler, seed=seed, spp=spp))
    par.render_distributed(scene, camera, with_seed(1, KEPT_WARMUP_SPP), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"frames": []}
    first = None
    for seed in KEPT_SEEDS:
        metrics.reset()
        (film, _), dt, launches = counted_run(
            lambda: par.render_distributed(scene, camera, with_seed(seed),
                                           mesh), dev)
        graph = {k: metrics.counters().get("crt.graph." + k, 0)
                 for k in ("kept", "captured")}
        want, dt_eager, eager_launches = counted_run(
            lambda: eager_sharded_render(scene, camera, with_seed(seed),
                                         mesh), dev)
        first = first or (film, film_digest(film))
        out["frames"].append({
            "seed": seed, "s": dt, "eager_s": dt_eager, **graph,
            "bitwise": (torch.equal(film.rgb_sum, want.rgb_sum)
                        and torch.equal(film.weight_sum, want.weight_sum)
                        and film.spp_done == want.spp_done),
            "launches_equal": launches == eager_launches,
            "launches": launches, "digest": film_digest(film)})
    out["first_film_kept"] = film_digest(first[0]) == first[1]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    t0 = time.perf_counter()
    torch.distributed.destroy_process_group()
    out["destroy_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def kept_sharded_phase(card, world=4):
    """Phase 26 (see the module docstring): ``world`` ranks on as many
    cards."""
    t_phase = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{sk.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(kept_sharded_rank, (world, address, tmp), world,
                    KEPT_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    frames = [r["frames"] for r in ranks]
    for r, rank_frames in enumerate(frames):
        for f, f0 in zip(rank_frames, frames[0]):
            assert f["bitwise"] and f["launches_equal"], \
                f"26: rank {r} seed {f['seed']} differs from the eager steps"
            assert f["digest"] == f0["digest"], \
                f"26: rank {r}'s film differs from rank 0's"
        assert [(f["kept"], f["captured"]) for f in rank_frames] == \
            [(0, 1)] + [(1, 0)] * (len(KEPT_SEEDS) - 1), rank_frames
        assert ranks[r]["first_film_kept"], f"26: rank {r}'s first film moved"
    kept = sum(f["kept"] for f in frames[0])
    print("phase26", json.dumps({
        "world": world, "layout": KEPT_LAYOUT, "res": HEADLINE_RES,
        "spp": HEADLINE_SPP, "warmup_spp": KEPT_WARMUP_SPP,
        "seeds": KEPT_SEEDS, "films_bitwise": True, "ranks_equal": True,
        "hit_share": kept / len(frames[0]),
        "frame_s": [[f["s"] for f in fr] for fr in frames],
        "eager_frame_s": [[f["eager_s"] for f in fr] for fr in frames],
        "launches": frames[0][-1]["launches"],
        "rank0_peak_bytes": ranks[0]["peak_bytes"],
        "destroy_s": [r["destroy_s"] for r in ranks],
        "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)


def config5_target(dev, scale):
    """Config 5's target image on ``dev`` (cfg.sampler.spp passes)."""
    target, _, camera, cfg, _, _ = entry.config5_setup(scale, dev)
    render_image, _ = inv.make_render_fn(camera, cfg)
    with torch.no_grad():
        return render_image(target)


def sharded_grads(dev, scale, mesh, target_img):
    """Config 5's gradient averaged over the ranks at sample 0, every leaf
    of albedo_and_emission_params (SGD at lr 0 leaves it in .grad; its
    step runs eagerly)."""
    _, start, camera, cfg, _, _ = entry.config5_setup(scale, dev)
    ei = inv.albedo_and_emission_params(start)
    step, init, _ = par.make_train_step(
        start, camera, cfg, mesh, ei,
        optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.0))
    params = inv.leaf_params(ei[0](start))
    step(params, init(params), start, target_img, 0)
    assert step.route == "eager", step.route
    return {k: p.grad.cpu() for k, p in params.items()}


def config5_sharded(dev, scale, mesh, target_img, steps=SHARD_STEPS):
    """16c on gloo: the averaged gradient (sharded_grads), then ``steps``
    + 1 steps with make_train_step's default optimizer (DeviceAdam, lr
    2e-2) on the same samples (the last step's loss is the loss after
    ``steps`` updates), every one eager, with every count at 0 just before
    and read just after; s/step is the median of the steps after the
    first."""
    grads = sharded_grads(dev, scale, mesh, target_img)
    _, start, camera, cfg, _, _ = entry.config5_setup(scale, dev)
    ei = inv.albedo_and_emission_params(start)
    step, init, _ = par.make_train_step(start, camera, cfg, mesh, ei)
    params = inv.leaf_params(ei[0](start))
    opt = init(params)
    losses, times, routes = [], [], []
    sync(dev)
    zero_counts()
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, start, target_img, 0)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        routes.append(step.route)
    launches = read_counts()
    assert losses[-1] < losses[0], f"sharded loss {losses[0]} -> {losses[-1]}"
    cuda = torch.device(dev).type == "cuda"
    assert not cuda or min(launches[k] for k in (
        "brute_closest", "brute_anyhit", "interp", "interp_backward")) > 0, \
        launches
    return {"grads": grads, "losses": losses, "routes": routes,
            "optimizer": type(opt).__name__,
            "s_per_step_median": statistics.median(times[1:]),
            "launches": launches}


def sharded_step_turns(dev, scale, mesh, target_img, steps=SHARD_GRAPH_STEPS):
    """16c at world size 1: the averaged gradient (sharded_grads), one
    train_graph captured alone after an eager step on a side stream
    (its capture seconds), then ``steps`` steps at samples 0 ..
    ``steps`` - 1 with the default optimizer (DeviceAdam, lr 2e-2) through
    train_step (captured where par.captures(mesh): warm-up, capture,
    replays) and through train_step.eager, in the turns SHARD_TURNS, every
    count at 0 before each run and read after: the losses and the final
    parameters of every run bitwise equal, the launches of both routes
    equal (captured: each step a replay's), the loss trending down (the
    mean of the last 3 below that of the first 3, the reference test's
    gate on varying samples); s/step (steady: eager from step 1, replays
    from step 2)."""
    grads = sharded_grads(dev, scale, mesh, target_img)
    _, start, camera, cfg, _, _ = entry.config5_setup(scale, dev)
    ei = inv.albedo_and_emission_params(start)
    captured = par.captures(mesh)
    capture_s = per_replay = None
    if captured:
        step, init, _ = par.make_train_step(start, camera, cfg, mesh, ei)
        params = inv.leaf_params(ei[0](start))
        opt = init(params)
        graphs.on_side_stream(lambda: step.eager(params, opt, start,
                                                 target_img, 0))
        sync(dev)
        t0 = time.perf_counter()
        graph = par.train_graph(step.eager, params, opt, start, target_img)
        sync(dev)
        capture_s = time.perf_counter() - t0
        per_replay = graph.launches
        del graph, step, opt, params

    def run(side):
        step, init, _ = par.make_train_step(start, camera, cfg, mesh, ei)
        call = step if side == "graph" else (
            lambda *a: a[:2] + (step.eager(*a),))
        params = inv.leaf_params(ei[0](start))
        opt = init(params)
        losses, routes, times = [], [], []
        for i in range(steps):
            t0 = time.perf_counter()
            params, opt, loss = call(params, opt, start, target_img, i)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            routes.append(step.route if side == "graph" else "eager")
        return params, losses, routes, times

    ref, turns, counts, routes = None, {"graph": [], "eager": []}, {}, {}
    for side in SHARD_TURNS:
        (params, losses, routes[side], times), _, launches = counted_run(
            lambda: run(side), dev)
        counts.setdefault(side, launches)
        assert launches == counts[side], f"16c: {side} launches differ"
        turns[side].append(times)
        ref = ref or (params, losses)
        assert losses == ref[1], f"16c: the {side} losses differ"
        assert all(torch.equal(params[k], ref[0][k]) for k in params), \
            f"16c: the {side} parameters differ"
    losses = ref[1]
    assert counts["graph"] == counts["eager"], counts
    assert torch.device(dev).type != "cuda" or min(
        counts["graph"][k] for k in ("brute_closest", "brute_anyhit",
                                     "interp", "interp_backward")) > 0, \
        counts["graph"]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert not captured or all(n == per_replay[k] * steps
                               for k, n in counts["graph"].items()), \
        per_replay
    skip = {"graph": 2 if captured else 1, "eager": 1}
    median = {side: statistics.median(s for run in runs_s
                                      for s in run[skip[side]:])
              for side, runs_s in turns.items()}
    return {"grads": grads, "losses": losses, "routes": routes["graph"],
            "optimizer": "DeviceAdam", "turns": list(SHARD_TURNS),
            "losses_bitwise": True, "params_bitwise": True,
            "capture_s": capture_s, "s_per_step": turns,
            "s_per_step_median": median["graph"],
            "eager_s_per_step_median": median["eager"],
            "launches": counts["graph"]}


def unsharded_grads(dev, scale, target_img, n_sp):
    """The unsharded port's gradient of the config 5 loss over samples
    0..n_sp-1 (the samples a sharded step at sample 0 renders)."""
    _, start, camera, cfg, _, _ = entry.config5_setup(scale, dev)
    extract, insert = inv.albedo_and_emission_params(start)
    render_image, _ = inv.make_render_fn(camera, cfg, spp=n_sp)
    params = inv.leaf_params(extract(start))
    loss = torch.mean((render_image(insert(start, params)) - target_img)
                      ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {k: g.cpu() for k, g in zip(params, grads)}


def sharded_grads_close(got, ref):
    """Max |diff| / max|ref| per leaf; raises past SHARD_GRAD_RTOL with an
    atol of SHARD_GRAD_ATOL_SHARE of the leaf's max|ref|."""
    out = {}
    for key, r in ref.items():
        g = got[key]
        scale = float(r.abs().max())
        assert bool(torch.isfinite(g).all()), key
        torch.testing.assert_close(g, r, rtol=SHARD_GRAD_RTOL,
                                   atol=SHARD_GRAD_ATOL_SHARE * scale)
        out[key] = float((g - r).abs().max()) / max(scale, 1e-30)
    return out


def spawn_ranks(fn, args, nprocs, timeout_s=RANKS_TIMEOUT_S):
    """Run fn(rank, *args) in ``nprocs`` spawned processes; raises if one
    fails, and kills them all and raises if they take over
    ``timeout_s``."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{nprocs} ranks ran past {timeout_s} s")


def sharded_rank(rank, world, tmp, dev_type, res, spp, scale):
    """A rank of phase 16b/16c: joins the gloo group of ``world`` ranks
    over a file store in ``tmp``, renders the Cornell headline at each of
    TWO_RANK_LAYOUTS and runs config 5's sharded steps, and writes its
    results to tmp/rank<rank>.pt."""
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else "cpu"
    if dev_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_library()
    par.init_distributed("file://" + os.path.join(tmp, "store"), world,
                         rank, device_type=dev_type, backend="gloo")
    scene, camera, cfg = entry.cornell_setup(res, spp, dev)
    target_img = torch.load(os.path.join(tmp, "target.pt")).to(dev)
    out = {"digest": par.scene_digest(scene)}
    for layout in TWO_RANK_LAYOUTS:
        mesh = par.make_mesh(*layout, device_type=dev_type)
        film, s_pass, launches = sharded_headline(scene, camera, cfg, mesh,
                                                  dev)
        out[layout] = {"s_per_pass": s_pass, "launches": launches,
                       "route": "captured" if par.captures(mesh) else "eager",
                       "film": filmmod.Film(film.rgb_sum.cpu(),
                                            film.weight_sum.cpu(),
                                            film.spp_done),
                       "train": config5_sharded(dev, scale, mesh,
                                                target_img)}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def sharded_phase(dev, card, ref_film, ref_s_pass, train_s_step,
                  res=HEADLINE_RES, spp=HEADLINE_SPP, scale="full"):
    """Phase 16 (see the module docstring); ``ref_film`` is phase 4's.
    Returns the launches of its world-size-1 runs through the entry points
    (16a's render_distributed and 16c's train steps, first turn)."""
    dev_type = torch.device(dev).type
    scene, camera, cfg = entry.cornell_setup(res, spp, dev)
    mesh = par.make_mesh(1, 1, device_type=dev_type)
    backend = torch.distributed.get_backend()
    film, row = sharded_render_turns(scene, camera, cfg, mesh, dev)
    diff, bitwise = close_films(film, ref_film)
    print("phase16a", json.dumps({
        "world": 1, "backend": backend, "res": res, "spp": spp,
        "depth": cfg.max_depth, **row,
        "render_s_per_pass_phase4": ref_s_pass,
        "max_abs_diff_vs_render": diff, "bitwise": bitwise,
        "rtol": FILM_RTOL, "atol": FILM_ATOL, "card": card}), flush=True)
    del scene, film

    target_img = config5_target(dev, scale)
    refs = {n_sp: unsharded_grads(dev, scale, target_img, n_sp)
            for n_sp in (1, 2)}
    rows = [((1, 1), [sharded_step_turns(dev, scale, mesh, target_img)])]
    launches = {k: n + rows[0][1][0]["launches"][k]
                for k, n in row["launches"].items()}
    torch.distributed.destroy_process_group()

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(target_img.cpu(), os.path.join(tmp, "target.pt"))
        spawn_ranks(sharded_rank, (2, tmp, dev_type, res, spp, scale), 2)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    assert ranks[0]["digest"] == ranks[1]["digest"], "ranks' scenes differ"
    for layout in TWO_RANK_LAYOUTS:
        diffs = [close_films(r[layout]["film"], ref_film) for r in ranks]
        print("phase16b", json.dumps({
            "world": 2, "backend": "gloo", "layout": layout, "res": res,
            "spp": spp, "route": [r[layout]["route"] for r in ranks],
            "s_per_pass": [r[layout]["s_per_pass"] for r in ranks],
            "max_abs_diff_vs_render": max(d[0] for d in diffs),
            "bitwise": all(d[1] for d in diffs),
            "launches": [r[layout]["launches"] for r in ranks],
            "scene_digests_equal": True, "card": card}), flush=True)
        rows.append((layout, [r[layout]["train"] for r in ranks]))
    for layout, trains in rows:
        n_sp = layout[1]
        share = [sharded_grads_close(t["grads"], refs[n_sp]) for t in trains]
        print("phase16c", json.dumps({
            "world": layout[0] * layout[1], "layout": layout,
            "backend": "gloo" if layout in TWO_RANK_LAYOUTS else backend,
            "grad_diff_share_of_max": share,
            "rtol": SHARD_GRAD_RTOL, "atol_share": SHARD_GRAD_ATOL_SHARE,
            **{k: [t[k] for t in trains] for k in (
                "optimizer", "routes", "losses", "s_per_step_median",
                "launches")},
            **{k: v for k, v in trains[0].items() if k in (
                "turns", "losses_bitwise", "params_bitwise", "capture_s",
                "s_per_step", "eager_s_per_step_median")},
            "passes_per_step_per_rank": 1,
            "phase14b_s_per_step_8_passes": train_s_step,
            "card": card}), flush=True)
    return launches


def edge_pixels(scene, camera, cfg, sample_idx):
    """(H, W) mask of the pixels whose camera ray hits the mesh within
    EDGE_BARY (barycentric) of a triangle edge, where which triangle is hit
    turns on the last bit of t (sobol_global's diagonal pixels meet the
    Cornell box's edges)."""
    _, _, _, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(cfg), sample_idx, scene.device)
    _, kind, _, b1, b2, _ = scene_mod.scene_intersect_t(
        scene, o, d, torch.full_like(o[:, 0], float("inf")))
    b = torch.stack([1.0 - b1 - b2, b1, b2], -1).amin(-1)
    w, h = cfg.resolution
    return ((kind == scene_mod.TYPE_MESH) & (b < EDGE_BARY)).reshape(h, w)


def pass_vs_cpu(phase, case, setup, cpu_setup, dev, mask_edges=False):
    """One render_pass of ``setup`` on ``dev`` against the same pass of
    ``cpu_setup`` on the CPU at atol 2e-3*max (with ``mask_edges``, on
    the pixels edge_pixels leaves); prints the row."""
    (scene, camera, cfg), (c_scene, c_camera, c_cfg) = setup, cpu_setup
    zero_counts()
    rgb = integ.render_pass(scene, camera, cfg, integ.make_filter(cfg),
                            integ.make_sensor(cfg), 0)[0]
    sync(dev)
    launches = read_counts()
    ref = integ.render_pass(c_scene, c_camera, c_cfg, integ.make_filter(
        c_cfg), integ.make_sensor(c_cfg), 0)[0]
    rgb = rgb.cpu()
    keep = torch.ones(ref.shape[:2], dtype=torch.bool)
    if mask_edges:
        keep = ~edge_pixels(c_scene, c_camera, c_cfg, 0)
    atol = 2e-3 * max(float(ref.max()), 1e-3)
    diff = (rgb - ref).abs().amax(-1)
    err = float(diff[keep].max())
    assert bool(torch.isfinite(rgb).all()) and err <= atol, \
        f"{phase} {case}: max |diff| {err} > atol {atol}"
    assert torch.device(dev).type != "cuda" or launches["interp"] > 0, \
        launches
    print(phase, json.dumps({
        "case": case, "res": cfg.resolution[0], "max_abs_diff_vs_cpu": err,
        "atol": atol, "image_max": float(ref.max()),
        "edge_pixels_left_out": int((~keep).sum()),
        "max_abs_diff_on_edge_pixels": float(diff[~keep].max())
        if (~keep).any() else None, "launches": launches}), flush=True)


def options_card_phase(dev, card, res=HEADLINE_RES, spp=HEADLINE_SPP,
                       small=OPTION_RES):
    """Phase 17 (see the module docstring)."""
    scene, camera, cfg = entry.cornell_setup(res, spp, dev)
    cfg = dataclasses.replace(cfg, sampler=integ.SamplerConfig(
        kind="sobol_global", spp=spp))
    integ.render(scene, camera, cfg, passes=1)
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, chunk=spp)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = read_counts()
    assert torch.device(dev).type != "cuda" or min(
        launches["brute_closest"], launches["brute_anyhit"],
        launches["interp"]) > 0, launches
    img = film.resolve(sensor).cpu().numpy()
    mean, _, _ = image_checks(img)
    s = cfg.sampler
    pixel = torch.arange(res * res, device=dev)
    draws = 0
    for sample in GLOBAL_SAMPLES:
        for dim in GLOBAL_DIMS:
            got = s.get_1d(pixel, sample, dim).cpu()
            assert torch.equal(got, s.get_1d(pixel.cpu(), sample, dim)), \
                f"sobol_global sample {sample} dim {dim} differs"
            draws += 1
        for dim in (integ.DIM_FILTER, integ.DIM_LENS):
            got = s.get_2d(pixel, sample, dim).cpu()
            assert torch.equal(got, s.get_2d(pixel.cpu(), sample, dim)), \
                f"sobol_global 2D sample {sample} dim {dim} differs"
            draws += 1
    print("phase17a", json.dumps({
        "res": res, "spp": spp, "m": s.m, "s_per_pass": dt / spp,
        "launches": launches, "image_mean": mean,
        "draws_bitwise_vs_cpu": draws, "dims": list(GLOBAL_DIMS),
        "samples": list(GLOBAL_SAMPLES), "pixels": res * res,
        "card": card}), flush=True)
    del scene, film

    setup = entry.cornell_setup(small, 1, dev)
    cpu_setup = entry.cornell_setup(small, 1, "cpu")
    for name, change in NEW_OPTIONS.items():
        with_option = lambda su: su[:2] + (dataclasses.replace(su[2],
                                                               **change),)
        pass_vs_cpu("phase17b", name, with_option(setup),
                    with_option(cpu_setup), dev, mask_edges=True)
    for kind in ("sphere", "cylinder", "disk"):
        for camera_kind in NEW_CAMERAS:
            pass_vs_cpu("phase17c", f"{kind}_{camera_kind}",
                        entry.shapes_setup(kind, camera_kind, small, dev),
                        entry.shapes_setup(kind, camera_kind, small, "cpu"),
                        dev)


def film_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in ("rgb_sum", "weight_sum", "spp_done")}


def raytracer_phase(dev, card, spp=None, res=None):
    """Phase 18 (see the module docstring); ``spp`` and ``res`` cut it
    down for the CPU tests (None: the app's 64 and 256x256)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        straight, resumed = (os.path.join(tmp, k) for k in ("a", "b"))
        zero_counts()
        t0 = time.perf_counter()
        rt_app.main(outdir=straight, spp=spp, resolution=res, device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        launches = read_counts()
        assert torch.device(dev).type != "cuda" or min(
            launches["brute_closest"], launches["brute_anyhit"],
            launches["interp"]) > 0, f"phase18 launched {launches}"
        scene, camera, cfg = rt_app.setup(spp, res, dev)
        passes = cfg.sampler.spp
        film, _ = checkpoint.load_film(os.path.join(straight, "film.npz"),
                                       dev)
        want = image.to_uint8(film.resolve(integ.make_sensor(cfg)))
        png = os.path.join(straight, "final.png")
        with open(png, "rb") as fh:
            assert np.array_equal(image.decode_png(fh.read()), want), \
                "phase18: final.png differs from the resolved film"
        img = image.read_image(png)
        assert np.array_equal(img, want.astype(np.float32) / 255.0)
        mean, left, right = image_checks(img)
        with open(os.path.join(straight, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        assert [r["event"] for r in records] == ["pass"] * passes, \
            f"phase18: {len(records)} metrics records for {passes} passes"
        pngs = sorted(f for f in os.listdir(straight)
                      if f.startswith("progress_"))

        film, _ = integ.render(scene, camera, cfg, passes=passes // 2)
        ck = checkpoint.RenderCheckpointer(resumed, every=passes // 2)
        assert ck.maybe_save(film), \
            "phase18: the half-way film was not checkpointed"
        del scene, film
        t1 = time.perf_counter()
        rt_app.main(outdir=resumed, spp=spp, resolution=res, device=dev)
        sync(dev)
        resume_s = time.perf_counter() - t1
        a = film_arrays(os.path.join(straight, "film.npz"))
        b = film_arrays(os.path.join(resumed, "film.npz"))
        assert int(b["spp_done"]) == passes and all(
            np.array_equal(a[k], b[k]) for k in a), \
            "phase18: the resumed film differs from the straight one"
    seconds = [r["seconds"] for r in records]
    print("phase18", json.dumps({
        "res": cfg.resolution[0], "spp": passes, "depth": cfg.max_depth,
        "app_s": dt, "s_per_pass_median": statistics.median(seconds),
        "s_per_pass_mean": sum(seconds) / passes,
        "rays_per_s_median": statistics.median(
            r["rays_per_sec"] for r in records),
        "launches": launches, "image_mean": mean, "left_wall": left,
        "right_wall": right, "progress_pngs": len(pngs),
        "resumed_from": passes // 2, "resume_app_s": resume_s,
        "resumed_film_bitwise": True,
        "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return launches


def shape_phase(dev, card, res=128):
    """Phase 19 (see the module docstring)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        t0 = time.perf_counter()
        rep = st_app.main(os.path.join(tmp, "card"), res, dev)
        sync(dev)
        dt = time.perf_counter() - t0
        launches = read_counts()
        t0 = time.perf_counter()
        ref = st_app.main(os.path.join(tmp, "cpu"), res, "cpu")
        cpu_s = time.perf_counter() - t0
    assert torch.device(dev).type != "cuda" or min(
        launches["octree_closest"], launches["brute_closest"]) > 0, \
        f"phase19 launched {launches}"
    assert rep["octree_matches_brute"] and ref["octree_matches_brute"]
    errs = {}
    rays = [st_app.camera_rays(res, x) for x in (dev, "cpu")]
    for (name, scene), c_scene in zip(st_app.shape_scenes(dev).items(),
                                      st_app.shape_scenes("cpu").values()):
        assert rep[name]["hit_fraction"] == ref[name]["hit_fraction"], name
        if name != "mesh_octree":
            assert (rep[name]["triangle_tests_total"]
                    == ref[name]["triangle_tests_total"]), name
        got = [x.cpu() for x in st_app.shade(scene, *rays[0])[:3]]
        want = st_app.shade(c_scene, *rays[1])[:3]
        diff = torch.maximum((got[0] - want[0]).abs().amax(-1),
                             (got[1] - want[1]).abs().amax(-1))
        cos = ((2.0 * want[0] - 1.0) * rays[1][1]).sum(-1).abs()
        both = got[2] & want[2]
        keep = both & (cos >= GRAZING_COS)
        errs[name] = {
            "max_abs_diff": float(diff[keep].max()) if keep.any() else 0.0,
            "grazing_left_out": int((both & ~keep).sum()),
            "max_abs_diff_grazing": float(diff[both & ~keep].max())
            if (both & ~keep).any() else None,
            "hit_mask_mismatches": int((got[2] != want[2]).sum())}
        assert errs[name]["max_abs_diff"] <= SHAPE_ATOL, \
            f"phase19 {name}: {errs[name]}"
    print("phase19", json.dumps({
        "res": res, "hit_fraction": {k: v["hit_fraction"] for k, v in
                                     rep.items() if isinstance(v, dict)},
        "triangle_tests_total_card": {
            k: v["triangle_tests_total"] for k, v in rep.items()
            if isinstance(v, dict)},
        "octree_tests_total_cpu": ref["mesh_octree"]["triangle_tests_total"],
        "octree_speedup_tests_card": rep["octree_speedup_tests"],
        "octree_speedup_tests_cpu": ref["octree_speedup_tests"],
        "octree": rep["mesh_octree"]["octree"],
        "normals_uv_vs_cpu": errs, "atol": SHAPE_ATOL,
        "grazing_cos": GRAZING_COS,
        "launches": launches, "app_s": dt, "cpu_app_s": cpu_s,
        "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return launches


def _equal_arrays(a, b):
    return all((x is None and y is None) or (
        x is not None and y is not None and x.dtype == y.dtype
        and np.array_equal(x, y)) for x, y in zip(a, b))


def scene_file_phase(dev, card, subdiv=7, dragon_tris=870_000, res=512,
                     passes=4):
    """Phase 20 (see the module docstring); the arguments cut it down for
    the CPU tests."""
    t_phase = time.perf_counter()
    times = {}
    clock = lambda key, fn: clock_into(times, key, dev, fn)

    with tempfile.TemporaryDirectory() as tmp:
        obj, ply = os.path.join(tmp, "mesh.obj"), os.path.join(tmp, "d.ply")
        v, f, _ = clock("icosphere_s",
                        lambda: mesh_gen.displaced_icosphere(subdiv))
        clock("save_obj_s", lambda: obj_loader.save_obj(obj, v, f))
        nat = clock("load_obj_native_s", lambda: obj_loader.load_obj(obj))
        py = clock("load_obj_python_s",
                   lambda: obj_loader.load_obj(obj, native=False))
        assert _equal_arrays(nat, py), "phase20: the OBJ loaders differ"
        assert np.array_equal(nat[0][nat[1]], v[f]) and nat[2] is None, \
            "phase20: the OBJ's triangles differ from the generator's"

        dv, df, duv = clock("dragon_s",
                            lambda: mesh_gen.dragon_stand_in(dragon_tris))
        clock("save_ply_s", lambda: ply_loader.save_ply(ply, dv, df,
                                                        uvs=duv))
        nat = clock("load_ply_native_s", lambda: ply_loader.load_ply(ply))
        py = clock("load_ply_python_s",
                   lambda: ply_loader.load_ply(ply, native=False))
        assert _equal_arrays(nat, py), "phase20: the PLY loaders differ"
        assert _equal_arrays(nat, (dv, df, None, duv)), \
            "phase20: the PLY differs from the generator's arrays"
        obj_loader.MeshCache.clear()
        cached = clock("mesh_cache_ply_s", lambda: obj_loader.MeshCache.load(
            "dragon", ply, device=dev))
        built = trimod.MeshData.build(dv, df, uvs=duv, device=dev)
        assert all(torch.equal(getattr(cached, k), getattr(built, k))
                   for k in ("positions", "normals", "uvs", "tangents",
                             "bitangents", "indices")), \
            "phase20: MeshCache's MeshData differs from MeshData.build's"
        obj_loader.MeshCache.clear()
        del cached, built, nat, py

        spec = json.loads(json.dumps(SCENE_FILE_SPEC))
        spec["render"]["resolution"] = [res, res]
        spec["render"]["sampler"]["spp"] = passes
        spec["shapes"] = [{"kind": "mesh_obj", "path": obj, "material": 0}]
        path = os.path.join(tmp, "scene.json")
        with open(path, "w") as fh:
            json.dump(spec, fh)
        scene, warm, camera, cfg, cache = cached_loads(path, dev, times)
    assert scene.packed_octree is not None
    zero_counts()
    one_pass = lambda s: integ.render_pass(s, camera, cfg,
                                           integ.make_filter(cfg),
                                           sen.PixelSensor.create(), 0)
    cold_pass, warm_pass = one_pass(scene), one_pass(warm)
    cache["pass_launches"] = read_counts()
    assert all(torch.equal(a, b) for a, b in zip(cold_pass, warm_pass)), \
        "phase20: the cached tree's pass differs from the built tree's"
    assert torch.device(dev).type != "cuda" or min(
        cache["pass_launches"]["octree_closest"],
        cache["pass_launches"]["octree_anyhit"]) >= 2, cache
    cache["passes_bitwise"] = True
    del warm, cold_pass, warm_pass
    zero_counts()
    film, sensor = clock("render_s", lambda: integ.render(scene, camera,
                                                          cfg))
    launches = read_counts()
    assert torch.device(dev).type != "cuda" or min(
        launches["octree_closest"], launches["octree_anyhit"],
        launches["interp"]) > 0, f"phase20 launched {launches}"
    mem = scene_mod.Scene.build(
        spec["materials"], spec["lights"], use_octree=True, device=dev,
        mesh=(trimod.MeshData.build(v, f, device=dev),
              np.zeros(len(f), np.int64)))
    ref, _ = integ.render(mem, camera, cfg)
    got = film.rgb_sum / film.weight_sum[..., None].clamp(min=1e-12)
    want = ref.rgb_sum / ref.weight_sum[..., None].clamp(min=1e-12)
    atol = 2e-3 * max(float(want.max()), 1e-3)
    err = float((got - want).abs().max())
    img = film.resolve(sensor).cpu().numpy()
    assert np.isfinite(img).all() and err <= atol, \
        f"phase20: the file scene differs from the in-memory one: {err}"
    print("phase20", json.dumps({
        "triangles": len(f), "dragon_triangles": len(df), "res": res,
        "passes": passes, "depth": cfg.max_depth, **times,
        "octree_cache": cache,
        "s_per_pass": times["render_s"] / passes,
        "octree": scene.octree.info(), "launches": launches,
        "max_abs_diff_vs_in_memory": err, "atol": atol,
        "bitwise_vs_in_memory": bool(
            torch.equal(film.rgb_sum, ref.rgb_sum)
            and torch.equal(film.weight_sum, ref.weight_sum)),
        "image_mean": float(img.mean()),
        "phase_s": time.perf_counter() - t_phase, "card": card}), flush=True)
    return launches


def cached_loads(path, dev, times):
    """Phase 20's two loads of the scene file with the octree cache in a
    temporary directory: a cold load that builds and stores the tree, then
    a warm one that reads it (no build). Both trees equal, array for array
    and in the packed tables. Returns (cold scene, warm scene, camera,
    cfg, a row of the builds and the cache's files)."""
    builds = []

    def load(key, build_key):
        with wrapped(octmod, "build_host_octree", after=lambda s:
                     times.__setitem__(build_key, s)):
            return clock_into(times, key, dev,
                              lambda: cfgmod.load_scene_file(path, dev))

    keep = asset_cache._CACHE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        asset_cache._CACHE_DIR = tmp
        try:
            with wrapped(octmod, "_split_oversized_leaves",
                         before=lambda *a: builds.append(1)):
                scene, camera, cfg = load("load_scene_file_s",
                                          "build_octree_s")
                cold_builds = len(builds)
                warm, _, _ = load("load_scene_file_warm_s",
                                  "build_octree_warm_s")
            files = sorted(os.listdir(tmp))
        finally:
            asset_cache._CACHE_DIR = keep
    assert cold_builds == 1 and len(builds) == 1, \
        f"phase20: {len(builds)} builds for a cold and a warm load"
    assert len(files) == 1 and files[0].startswith("torch_octree_"), files
    fields = lambda s: [getattr(s.octree, k) for k in octmod.TREE_FIELDS]
    assert _equal_arrays(fields(scene), fields(warm)), \
        "phase20: the cached tree differs from the built one"
    assert all(torch.equal(getattr(scene.packed_octree, k),
                           getattr(warm.packed_octree, k))
               for k in ("nodes", "leaf_verts", "row_tri")), \
        "phase20: the cached tree packs differently"
    return scene, warm, camera, cfg, {
        "builds_cold": cold_builds, "builds_warm": len(builds) - cold_builds,
        "files": files, "trees_bitwise": True}


def clock_into(times, key, dev, fn):
    """fn()'s output, its host seconds to a sync written to times[key]."""
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    times[key] = time.perf_counter() - t0
    return out


def _close(got, want, rtol, atol, what):
    """max |got - want|, after holding it to atol + rtol |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(
        np.abs(got - want) <= atol + rtol * np.abs(want)), \
        f"{what}: {got.tolist()} vs {want.tolist()}"
    return float(np.abs(got - want).max()) if got.size else 0.0


def _keys(report, prefix=""):
    if not isinstance(report, dict):
        return [prefix]
    return sorted(k for key, v in report.items()
                  for k in _keys(v, f"{prefix}{key}."))


def app_report_diffs(name, got, want):
    """The deterministic entries of app ``name``'s report ``got`` held to
    ``want`` (another device's run, or the reference app's): {entry: max
    |diff|}. The reports must have the same keys."""
    if not isinstance(want, dict):
        return {}
    assert _keys(got) == _keys(want), f"{name}: {_keys(got)} vs {_keys(want)}"
    d = {}

    def hold(key, g, w, rtol, atol):
        d[key] = _close(g, w, rtol, atol, f"{name} {key}")

    if name == "spectrum_color":
        for k in ("d65_expected", "expected_whitepoint_Y"):
            hold(k, got[k], want[k], 0, 0)
        for k in ("d65_chromaticity", "srgb_white_to_xyz", "srgb_to_p3"):
            hold(k, got[k], want[k], 0, ROUNDED_ATOL)
        hold("p3_round_trip_err", got["p3_round_trip_err"],
             want["p3_round_trip_err"], 0, APP_ATOL)
    elif name == "filter_film_test":
        for k, v in got.items():
            if k.startswith("sensor_"):
                for s in ("white_swatch", "red_swatch"):
                    hold(f"{k}.{s}", v[s], want[k][s], 0, ROUNDED_ATOL)
            else:
                hold(f"{k}.integral", v["integral"], want[k]["integral"],
                     APP_RTOL, APP_ATOL)
    elif name == "montecarlo_test":
        hold("analytic", got["analytic"], want["analytic"], 0, 0)
    elif name in ("polygon_app", "crossbridge"):
        for k in got:
            tol = (APP_RTOL, APP_ATOL) if k == "mean_force_tail" else (0, 0)
            hold(k, got[k], want[k], *tol)
    elif name == "ode_app":
        for k, v in got.items():
            e = np.asarray(want[k]["errors"])
            hold(f"{k}.errors", v["errors"], e, APP_RTOL, APP_ATOL)
            # the order log2(e0/e1) within what the errors' tolerance
            # allows (in float32 RK4's errors are rounding noise)
            de = APP_ATOL + APP_RTOL * e[:2]
            if np.all(de < e[:2]):
                hold(f"{k}.order", v["order"], want[k]["order"], 0,
                     float(np.sum(de / (e[:2] - de))) / math.log(2.0))
            else:
                # the errors are within their own tolerance of 0 (RK4's
                # are float32 rounding), so they bound no order: printed,
                # not held (phase 21 holds the trajectories instead)
                d[f"{k}.order_not_held"] = abs(v["order"] - want[k]["order"])
    return d


def app_report_bounds(name, report, n_samples=None, device="cpu"):
    """Each statistical entry of app ``name``'s report within its own
    bound; ``n_samples`` is filter_film_test's n. Returns {entry:
    (deviation, bound)}."""
    out = {}

    def within(key, dev, bnd):
        out[key] = (float(dev), float(bnd))
        assert abs(dev) <= bnd, f"{name} {key}: |{dev}| > {bnd}"

    if name == "montecarlo_test":
        a = report["analytic"]
        u, imp = report["uniform"], report["importance_linear"]
        within("uniform", u["estimate"] - a, u["chebyshev_95"])
        within("importance_linear", imp["estimate"] - a,
               math.sqrt(imp["variance"] / 0.05))
    elif name == "filter_film_test":
        for k in filter_film_test.FILTER_NAMES:
            w = filter_film_test.filter_samples(k, n_samples, device)[1]
            sigma = float(w.double().std()) / math.sqrt(w.numel())
            r = report[k]
            within(k, r["mc_integral"] - r["integral"],
                   3.0 * sigma + APP_RTOL * abs(r["integral"]))
    elif name == "crossbridge":
        p = report["steady_state_fraction"]
        within("simulated_final_fraction",
               report["simulated_final_fraction"] - p,
               3.0 * math.sqrt(p * (1 - p) / report["n_bridges"]))
    return out


def app_plots(outdir):
    """{png name: sidecar} of an app's output directory, each PNG decoded
    through utils/image.py to its sidecar's size."""
    out = {}
    for f in sorted(os.listdir(outdir)):
        if f.endswith(".png"):
            with open(os.path.join(outdir, f), "rb") as fh:
                img = image.decode_png(fh.read())
            with open(os.path.join(outdir, f + ".json")) as fh:
                out[f] = json.load(fh)
            assert list(img.shape) == out[f]["size"][::-1] + [3], f
    return out


def plot_series_diffs(name, png, got, want):
    """Each series of the sidecar ``got`` held to ``want``'s (same kind and
    label, x and y at APP_RTOL / APP_ATOL): {png.label: max |diff|}."""
    gs, ws = got["series"], want["series"]
    assert [(s["kind"], s["label"]) for s in gs] == \
        [(s["kind"], s["label"]) for s in ws], f"{name} {png}"
    return {f"{png}.{g['label']}": max(
        _close(g[k], w[k], APP_RTOL, APP_ATOL, f"{name} {png} {k}")
        for k in ("x", "y")) for g, w in zip(gs, ws)}


def interp_launch_checks(calls):
    """The interpolation kernel against its plain version on the very
    (tables, i0, w) of each recorded launch, bitwise as phase 9 holds it
    (these comparison launches are made after the counts are read)."""
    err, peak, shapes = 0.0, 0.0, set()
    for tables, i0, w in calls:
        out = ik.dense_interp(tables, i0, w)
        plain = ik.dense_interp_plain(tables, i0, w)
        e = (out - plain).abs().max().item()
        assert torch.equal(out, plain), \
            f"phase21: the interpolation kernel differs by {e}"
        err, peak = max(err, e), max(peak, plain.abs().max().item())
        shapes.add((*tables.shape, i0.shape[0]))
    return {"calls": len(calls), "bitwise": True,
            "k_c_rows": [list(s) for s in sorted(shapes)],
            "max_abs_err": err, "max_abs_value": peak}


def apps_phase(dev, card, sizes=None):
    """Phase 21 (see the module docstring); ``sizes`` ({app: keyword
    arguments}) cuts the apps down for the CPU tests (None: defaults)."""
    sizes = sizes or {}
    t_phase = time.perf_counter()
    seconds, reports, plots, interp_calls = {}, {}, {}, []

    def keep(tables, i0, w):
        interp_calls.append((tables.clone(), i0.clone(), w.clone()))

    with tempfile.TemporaryDirectory() as tmp:
        for side, device in (("card", dev), ("cpu", "cpu")):
            if side == "card":
                zero_counts()
            with (wrapped(ik, "dense_interp", before=keep) if side == "card"
                  else contextlib.nullcontext()):
                for name in VALIDATION_APPS:
                    mod = importlib.import_module(
                        f"computational_ray_tracer_tpu_torch.apps.{name}")
                    out = os.path.join(tmp, side, name)
                    t0 = time.perf_counter()
                    reports[side, name] = mod.main(out, device=device,
                                                   **sizes.get(name, {}))
                    sync(device)
                    seconds[f"{name}_{side}_s"] = time.perf_counter() - t0
                    plots[side, name] = app_plots(out)
            if side == "card":
                launches = read_counts()
    assert torch.device(dev).type != "cuda" or (
        launches["interp"] > 0 and len(interp_calls) == launches["interp"]), \
        f"phase21 launched {launches}, recorded {len(interp_calls)}"
    interp_check = interp_launch_checks(interp_calls)
    n_filter = sizes.get("filter_film_test", {}).get("n", 60_000)
    diffs, bounds = {}, {}
    for name in VALIDATION_APPS:
        card_plots, cpu_plots = plots["card", name], plots["cpu", name]
        assert sorted(card_plots) == sorted(cpu_plots), name
        for png in DETERMINISTIC_PLOTS.get(name, ()):
            assert card_plots[png] == cpu_plots[png], f"{name} {png}"
        diffs[name] = app_report_diffs(name, reports["card", name],
                                       reports["cpu", name])
        for png in CLOSE_PLOTS.get(name, ()):
            diffs[name].update(plot_series_diffs(name, png, card_plots[png],
                                                 cpu_plots[png]))
        for side, device in (("card", dev), ("cpu", "cpu")):
            b = app_report_bounds(name, reports[side, name], n_filter, device)
            if b:
                bounds[f"{name}_{side}"] = b
    # the attachment counts, step by step
    attach = [plots[side, "crossbridge"]["crossbridge_attach.png"]
              ["series"][0]["y"] for side in ("card", "cpu")]
    assert attach[0] == attach[1], "phase21: the attachment counts differ"
    print("phase21", json.dumps({
        "apps": list(VALIDATION_APPS), "sizes": sizes or "defaults",
        "seconds": seconds, "launches": launches,
        "interp_launches": launches["interp"],
        "interp_held_to_plain": interp_check,
        "card_vs_cpu_abs_diff": {k: v for k, v in diffs.items() if v},
        "statistical": bounds, "crossbridge_steps": len(attach[0]),
        "pngs_a_side": sum(len(plots["card", n]) for n in VALIDATION_APPS),
        "phase_s": time.perf_counter() - t_phase, "card": card}),
        flush=True)
    return launches


def held_to_plain(calls):
    """Each captured launch of phases 22 and 24a against its kernel's
    plain version, as phases 4b, 10b and 21 hold them (after the counts
    are read): the brute kernel and the interpolation kernel bitwise, the
    octree kernel's any hit exactly and its closest hit by hits_agree over
    the live rays.
    Returns {kernel: {"launches": checked, "max_abs_err": ...}}."""
    out = {}

    def note(name, err):
        row = out.setdefault(name, {"launches": 0, "max_abs_err": 0.0})
        row["launches"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)

    for kind, call in calls:
        if kind == "interp":
            note("dense_interp", interp_launch_checks([call])["max_abs_err"])
            continue
        mode, rays, *rest = call
        if kind == "brute":
            row = mesh_launch_row("phase22_brute_" + mode, mode, rays, *rest)
            name = "mesh_intersect" if mode == "closest" else "mesh_anyhit"
        else:
            row = octree_launch_row("phase22_octree_" + mode, rest[0], mode,
                                    rays)
            name = "octree_" + mode
        note(name, row["max_abs_err"])
    return out


def capture_all(fn):
    """Run ``fn()`` and return its output and the inputs of every kernel
    launch it makes: [(kind, call)] with kind "brute", "octree" or
    "interp"."""
    interp, box = [], {}
    with wrapped(ik, "dense_interp", before=lambda *a: interp.append(
            tuple(x.clone() for x in a))):
        brute = capture_mesh_launches(lambda: box.update(
            octree=capture_octree_launches(lambda: box.update(out=fn()))))
    return box["out"], ([("brute", c) for c in brute]
                        + [("octree", c) for c in box["octree"]]
                        + [("interp", c) for c in interp])


def alive_vs_cpu(name, setup, dev, modes):
    """alive_fractions on the card and on the CPU at a reduced size, within
    ALIVE_RAYS rays a depth; returns the rays apart for each mode."""
    apart = {}
    scenes = {d: setup(d) for d in (dev, "cpu")}
    for mode in modes:
        fr = {d: integ.alive_fractions(sc, cam_, dataclasses.replace(
            cfg, integrator=mode)).cpu() for d, (sc, cam_, cfg)
            in scenes.items()}
        w, h = scenes["cpu"][2].resolution
        rays = ((fr[dev] - fr["cpu"]).abs() * w * h).tolist()
        assert max(rays) <= ALIVE_RAYS, \
            f"phase22 {name} {mode}: {rays} rays apart a depth"
        apart[mode] = rays
    return apart


def api_phase(dev, card, headline_s_pass, res=HEADLINE_RES,
              spp=HEADLINE_SPP, cpu_res=None, subdiv=7):
    """Phase 22 (see the module docstring); the arguments cut it down for
    the CPU tests. Returns the launches of its counted runs."""
    t_phase = time.perf_counter()
    cpu_res = cpu_res or API_CPU_RES
    launches, calls, row = {}, [], {"res": res}
    card_run = torch.device(dev).type == "cuda"

    def counted(key, fn):
        zero_counts()
        out, c = capture_all(fn)
        sync(dev)
        n = read_counts()
        row[key + "_launches"] = n
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        calls.extend(c)
        return out

    # (a) the Cornell headline's fractions and its effective rays/s
    scene, camera, cfg = entry.cornell_setup(res, spp, dev)
    fr = counted("cornell", lambda: integ.alive_fractions(scene, camera,
                                                          cfg)).cpu()
    depth = cfg.max_depth
    eff = 1.0 + float(fr[1:depth].sum()) + float(fr[:depth].sum())
    n = row["cornell_launches"]
    assert not card_run or min(n["brute_closest"], n["brute_anyhit"],
                               n["interp"]) > 0, n
    row.update(cornell_alive_fractions=fr.tolist(),
               effective_rays_per_sample=eff,
               nominal_rays_per_sample=1 + (depth - 1) + depth,
               s_per_pass=headline_s_pass,
               effective_rays_per_s=res * res * eff / headline_s_pass)
    # (b) the li_* integrators: _path_scan's bits in their modes
    pixel, wl, _, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(cfg), 0, dev)
    for name, mode in (("li_path", "mis"), ("li_simple_path", "simple"),
                       ("li_random_walk", "walk")):
        L, wl_out = getattr(integ, name)(scene, o, d, wl, pixel, 0, cfg)
        ref = integ._path_scan(scene, o, d, wl, pixel, 0, cfg, mode)
        assert torch.equal(L, ref[0]) and torch.equal(wl_out.pdf,
                                                      ref[1].pdf), name
    row["li_bitwise"] = True
    # (c) sample_light and env_radiance with lam: the cache's bits
    lights, lam = scene.lights, wl.lam
    gen = torch.Generator(device=dev).manual_seed(0)
    p, nrm = (torch.rand(o.shape, device=dev, generator=gen) * 2 - 1
              for _ in range(2))
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    u = torch.rand(o.shape[:-1] + (3,), device=dev, generator=gen)
    args = (lights, p, nrm, lam, u[..., 0], u[..., 1:], scene.world_radius())
    got = counted("sample_light", lambda: lgt.sample_light(*args))
    cache = integ._spectral_cache(scene, lam)[..., :lights.n_lights]
    want = lgt.sample_light(*args, spd_vals=cache)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), \
        "phase22: sample_light with lam differs from the spectral cache's"
    assert torch.equal(lgt.env_radiance(lights, lam)[0],
                       lgt.env_radiance(lights, lam, cache)[0])
    assert not card_run or row["sample_light_launches"]["interp"] > 0
    row["sample_light_bitwise"] = True
    del scene, o, d, p, nrm, u, got, want, cache
    # (d) the mesh headline's fractions (the octree kernel)
    m_scene, m_camera, m_cfg = entry.mesh327k_setup(res, MESH_SPP, subdiv,
                                                    device=dev)
    m_fr = counted("mesh", lambda: integ.alive_fractions(m_scene, m_camera,
                                                         m_cfg)).cpu()
    n = row["mesh_launches"]
    assert not card_run or min(n["octree_closest"], n["octree_anyhit"]) > 0, n
    row["mesh_alive_fractions"] = m_fr.tolist()
    del m_scene
    # (e) every launch held to its plain version, then the CPU's fractions
    row["held_to_plain"] = held_to_plain(calls)
    del calls
    row["cornell_rays_apart_vs_cpu"] = alive_vs_cpu(
        "cornell", lambda d: entry.cornell_setup(cpu_res["cornell"], 1, d),
        dev, ALIVE_MODES)
    row["mesh_rays_apart_vs_cpu"] = alive_vs_cpu(
        "mesh", lambda d: entry.mesh327k_setup(cpu_res["mesh"], 1, subdiv,
                                               device=d), dev, ("direct",))
    row.update(phase_s=time.perf_counter() - t_phase, card=card)
    print("phase22", json.dumps(row), flush=True)
    return launches


def sampler_lane_ops(kind, two_d):
    """The sampler kernel's integer operations a lane (SAMPLER_OPS), the
    seed's hash included (every lane takes it)."""
    o, draws = SAMPLER_OPS, 1 + two_d
    if kind == "independent":
        return o["lane"] + 3 * o["hash"] + draws * (o["hash"] + o["float"])
    walk = o["scramble"] + o["permute"]
    if kind == "stratified":
        return (o["lane"] + 4 * o["hash"] + walk + two_d * o["divmod"]
                + 2 * o["hash"] + draws * (o["hash"] + 2 * o["float"]))
    return (o["lane"] + 4 * o["hash"] + walk + two_d * o["hash"]
            + draws * (o["sobol"] + o["owen"] + o["float"]))


def sampler_case(case, lanes, kind, spp, xs, ys, sample, dev):
    """Phase 25's rows for one of the cells' draws: the kernel's 1D and 2D
    draws against the plain version, bitwise, on a device index and an
    int; each timed as replays of a CUDA graph, with its bound."""
    pixel = torch.arange(lanes, dtype=torch.int64, device=dev)
    idx = torch.tensor(sample, dtype=torch.int64, device=dev)
    seed_dev = torch.tensor(rk.seed_word(11), dtype=torch.int64, device=dev)
    rows = []
    for two_d, dim in ((False, integ.DIM_LAMBDA), (True, integ.DIM_FILTER)):
        if two_d:
            draw = lambda fn, s, seed=11: fn[1](kind, seed, pixel, s, dim,
                                                spp, xs, ys)
        else:
            draw = lambda fn, s, seed=11: fn[0](kind, seed, pixel, s, dim,
                                                spp)
        kernel, plain = (rk.draw_1d, rk.draw_2d), (rk.plain_1d, rk.plain_2d)
        want = draw(plain, idx)
        for s, seed in ((idx, 11), (sample, 11), (idx, seed_dev),
                        (sample, seed_dev)):
            assert torch.equal(draw(kernel, s, seed), want), \
                f"25 {case} {'2d' if two_d else '1d'}: kernel != plain"
        ms = per_launch_ms(lambda: draw(kernel, idx))
        plain_ms = per_launch_ms(lambda: draw(plain, idx), inner=4)
        ops = sampler_lane_ops(kind, two_d)
        b_ms, b_by = max((lanes * ops / INT32_OPS_PER_S * 1e3, "int32 ops"),
                         (lanes * (8 + 4 * (1 + two_d)) / HBM_BYTES_PER_S
                          * 1e3, "bytes"))
        rows.append({"case": case, "draw": "2d" if two_d else "1d",
                     "kind": kind, "lanes": lanes, "spp": spp,
                     "grid": [xs, ys], "bitwise": True,
                     "device_seed_bitwise": True, "ms": ms,
                     "plain_ms": plain_ms, "plain_over_kernel": plain_ms / ms,
                     "ops_per_lane": ops, "bound_ms": b_ms, "bound_by": b_by,
                     "share": b_ms / ms, "max_abs_err": 0.0})
    return rows


def sampler_frames(dev):
    """The sampler kernel's launches a pass or a step of the cells' three
    routes, replays included: a Cornell frame (512x512, spp 32), a
    canonical frame (500x500, spp 100, on a small stand-in mesh) and four
    config 5 steps."""
    per = {}
    scene, camera, cfg = entry.cornell_setup(HEADLINE_RES, HEADLINE_SPP, dev)
    integ.render(scene, camera, cfg, passes=1)
    zero_counts()
    integ.render(scene, camera, cfg)
    per["cornell_pass"] = read_counts()["sampler"] / HEADLINE_SPP
    c_scene = entry.canonical_scene(
        mesh=mesh_gen.dragon_stand_in(target_tris=2000), device=dev)
    zero_counts()
    entry.canonical_render(CANONICAL_RES, CANONICAL_SPP, scene=c_scene)
    per["canonical_pass"] = read_counts()["sampler"] / CANONICAL_SPP
    start, camera, cfg, lr, target_img, ei = config5_start(dev)
    zero_counts()
    inv.optimize(start, camera, cfg, ei, target_img, steps=4, lr=lr)
    per["config5_step"] = read_counts()["sampler"] / 4
    sync(dev)
    assert per == {"cornell_pass": 20, "canonical_pass": 3,
                   "config5_step": 120}, per
    return per


def sampler_phase(dev, card):
    """Phase 25 (see the module docstring); returns its rows."""
    rows = []
    for shape in SAMPLER_SHAPES:
        rows += sampler_case(*shape, dev)
    for row in rows:
        print("phase25", json.dumps({**row, "card": card}), flush=True)
    print("phase25_launches", json.dumps(sampler_frames(dev)), flush=True)
    return rows


def main():
    t_start = time.perf_counter()
    # phase 0
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this is a GPU run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print("phase0", json.dumps({"device": kind, "torch": torch.__version__,
                                "cuda": torch.version.cuda}), flush=True)

    # phase 1
    t0 = time.perf_counter()
    build.load_library()
    print("phase1", json.dumps({
        "load_s": time.perf_counter() - t0, "nvcc_s": build.build_seconds,
        "ptxas": ptxas_report(build.build_log)}), flush=True)
    # phase 25: the sampler kernel against its plain version
    sampler_rows = sampler_phase(dev, card)

    # phase 2
    scene, camera, cfg = entry.cornell_setup(HEADLINE_RES, HEADLINE_SPP, dev)
    _, _, _, o, d = integ.camera_wavefront(
        camera, cfg, integ.make_filter(cfg), 0, dev)
    t_inf = torch.full((o.shape[0],), float("inf"), device=dev)
    rows = [compare("cornell_camera", o.contiguous(), d.contiguous(), t_inf,
                    scene.mesh, None)]
    mesh_s, o_s, d_s = soup(4096, 262144, 0, dev)
    mask = torch.as_tensor(np.arange(4096) % 2 == 0, device=dev)
    rows.append(compare("soup_4096_tmax_mask", o_s, d_s,
                        torch.full((262144,), 1.5, device=dev), mesh_s, mask))

    # phase 3
    launches0 = mik.LAUNCHES
    row = golden_check("phase3", entry.golden2_cornell_path(128, 4, dev),
                       "config2_cornell_path_128")
    assert mik.LAUNCHES > launches0, "golden render did not launch the kernel"
    print("phase3", json.dumps({**row, "launches": mik.LAUNCHES - launches0}),
          flush=True)

    # phase 4: one warm-up pass, then the timed Cornell headline render
    integ.render(scene, camera, cfg, passes=1)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    film, sensor = integ.render(scene, camera, cfg, chunk=HEADLINE_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"closest": mik.LAUNCHES, "anyhit": mik.LAUNCHES_ANYHIT}
    c_interp = ik.LAUNCHES
    assert min(launches.values()) > 0 and c_interp > 0, \
        f"the headline render launched the kernels {launches}, {c_interp}"
    img = film.resolve(sensor).cpu().numpy()
    mean, left, right = image_checks(img)
    depth = cfg.max_depth
    rays = HEADLINE_RES * HEADLINE_RES * HEADLINE_SPP * (1 + (depth - 1)
                                                         + depth)
    print("phase4", json.dumps({
        "res": HEADLINE_RES, "spp": HEADLINE_SPP, "depth": depth,
        "s_per_pass": dt / HEADLINE_SPP, "rays_per_s": rays / dt,
        "launches": launches, "launches_interp": c_interp,
        "image_mean": mean, "left_wall": left,
        "right_wall": right, "card": card}), flush=True)
    cornell_rows = cornell_launches(scene, camera, cfg, launches)
    headline_film = filmmod.Film(film.rgb_sum.cpu(), film.weight_sum.cpu(),
                                 film.spp_done)
    headline_s_pass = dt / HEADLINE_SPP
    del scene, film, mesh_s, o_s, d_s

    # phase 5
    m_scene, m_camera, m_cfg, row_closest, row_any, dragon = octree_phase(
        dev)

    # phase 6
    before = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
    row = golden_check("phase6",
                       entry.golden3_mesh_octree_textured(128, 2, dev),
                       "config3_mesh_octree_textured_128")
    modes = (okern.LAUNCHES_CLOSEST - before[0],
             okern.LAUNCHES_ANYHIT - before[1])
    assert min(modes) > 0, f"golden 3 launched the modes {modes} times"
    print("phase6", json.dumps({**row, "launches_closest": modes[0],
                                "launches_anyhit": modes[1]}), flush=True)

    # phase 7: one warm-up pass, then the timed mesh headline render
    integ.render(m_scene, m_camera, m_cfg, passes=1)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    film, sensor = integ.render(m_scene, m_camera, m_cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m_launches = (okern.LAUNCHES_CLOSEST, okern.LAUNCHES_ANYHIT)
    m_interp = ik.LAUNCHES
    assert min(m_launches) > 0 and m_interp > 0, \
        f"mesh headline launched {m_launches}, interp {m_interp}"
    img = film.resolve(sensor).cpu().numpy()
    h, w, _ = img.shape
    centre = img[int(0.45 * h):int(0.55 * h), int(0.45 * w):int(0.55 * w)]
    m_mean = float(img.mean())
    assert np.isfinite(img).all(), "non-finite pixels"
    covered = float((centre.max(-1) > 0).mean())
    assert covered > 0.99, f"the mesh covers {covered} of the centre"
    assert img[:8, :8].max() == 0.0, "a corner that misses the mesh is lit"
    assert MESH_MEAN_BAND[0] < m_mean < MESH_MEAN_BAND[1], \
        f"mesh image mean {m_mean} outside {MESH_MEAN_BAND}"
    print("phase7", json.dumps({
        "res": HEADLINE_RES, "spp": MESH_SPP,
        "s_per_pass": dt / MESH_SPP,
        "rays_per_s": HEADLINE_RES * HEADLINE_RES * 2 * MESH_SPP / dt,
        "launches_closest": m_launches[0], "launches_anyhit": m_launches[1],
        "launches_interp": m_interp,
        "image_mean": m_mean, "centre_mean": float(centre.mean()),
        "card": card}), flush=True)

    # phase 8: the flagship's compacted pass vs its full wavefront
    f_scene, f_camera, f_cfg = entry.flagship_setup(
        HEADLINE_RES, MESH_SPP, scene=m_scene, device=dev)
    calls, row = compact_vs_full("phase8", f_scene, f_camera, f_cfg, 0)
    assert sorted(calls) == [3, 5], f"interp calls of widths {sorted(calls)}"
    print("phase8", json.dumps(row), flush=True)

    # phase 9: the interpolation kernel at its three shapes
    gen = np.random.default_rng(0)
    n_stress = 1 << 21
    w_stress = gen.uniform(0, 1, n_stress).astype(np.float32)
    w_stress[:1000] = 0.0
    w_stress[1000:2000] = 1.0
    t = lambda a: torch.as_tensor(a, device=dev)
    interp_rows = [
        interp_case("a_flagship_spectral_cache", *calls[5]),
        interp_case("b_flagship_sensor", *calls[3]),
        interp_case("c_seeded_471x128", t(gen.normal(size=(471, 128)).astype(
            np.float32)), t(gen.integers(0, 470, n_stress).astype(np.int32)),
            t(w_stress)),
        interp_case("d_phase21_sensor", t(gen.uniform(0, 1, (471, 3)).astype(
            np.float32)), *sensor_rows(2048, dev))]
    # phase 9b: the backward kernel on the flagship cache and the stress
    # input (the config 5 and Cornell caches follow in phase 14)
    tables, i0, w = calls[5]
    backward_rows = [interp_backward_case(
        "a_flagship_cache", seeded_gradient(i0.shape[0], 5, 1, dev), i0, w,
        tables.shape[0])]
    i0_s, w_s = t(gen.integers(0, 470, n_stress).astype(np.int32)), \
        t(w_stress)
    backward_rows.append(interp_backward_case(
        "c_seeded_471x128", seeded_gradient(n_stress, 128, 2, dev), i0_s, w_s,
        471))
    backward_rows.append(interp_backward_case(
        "e_one_table_row", seeded_gradient(n_stress, 16, 3, dev),
        torch.full_like(i0_s, 235), w_s, 471))
    f_rows = edge_rows(65537, 13, 471, 4, dev)
    backward_rows.append(interp_backward_case("f_edges", *f_rows))
    backward_graph_check("f_edges", *f_rows)
    del calls, i0_s, w_s, f_rows

    # phase 10: the flagship render
    film, sensor, row = timed_render("phase10", f_scene, f_camera, f_cfg,
                                     1 + (f_cfg.max_depth - 1)
                                     + f_cfg.max_depth, card)
    f_launches = row["launches"]
    img = film.resolve(sensor).cpu().numpy()
    f_mean = float(img.mean())
    assert np.isfinite(img).all(), "non-finite flagship pixels"
    assert FLAGSHIP_MEAN_BAND[0] < f_mean < FLAGSHIP_MEAN_BAND[1], \
        f"flagship image mean {f_mean} outside {FLAGSHIP_MEAN_BAND}"
    print("phase10", json.dumps({**row, "spp": f_cfg.sampler.spp,
                                 "image_mean": f_mean}), flush=True)
    bounce_rows = flagship_bounces(f_scene, f_camera, f_cfg, f_launches)
    del f_scene, film

    # phase 11: deep512, one warm-up pass at spp 2, then passes 1-3 of 4
    d_scene, d_camera, d_cfg = entry.deep512_setup(scene=m_scene, device=dev)
    film, _ = integ.render(d_scene, d_camera, d_cfg, passes=1)
    d_cfg = dataclasses.replace(d_cfg, sampler=dataclasses.replace(
        d_cfg.sampler, spp=DEEP_SPP))
    film, sensor, row = timed_render("phase11", d_scene, d_camera, d_cfg,
                                     16, card, film=film, warm=False)
    img = film.resolve(sensor).cpu().numpy()
    assert np.isfinite(img).all(), "non-finite deep512 pixels"
    _, c_row = compact_vs_full("phase11", d_scene, d_camera, d_cfg, 0)
    print("phase11", json.dumps({**row, "image_mean": float(img.mean()),
                                 "compacted_pass": c_row}), flush=True)
    del d_scene, film

    # phase 12: the canonical frame
    canonical_row, c_scene = canonical_phase(dragon, dev, card)
    del dragon
    # phase 23: the captured pass, on the scenes of phases 4-12
    graph_phase(dev, card, (m_scene, m_camera, m_cfg), c_scene)
    del m_scene, c_scene

    # phase 14: training at full width
    train_launches, c5_call, train_s_step = config5_phase(dev, card)
    backward_rows.append(interp_backward_case("d_config5_cache", *c5_call))
    backward_graph_check("d_config5_cache", *c5_call)
    backward_rows[-1]["launches"] = train_launches["interp_backward"]
    # phase 24: config 5's captured train step against its eager loop
    train_graph_launches = train_graph_phase(dev, card)
    headline_call = headline_grad_phase(dev, card)
    backward_rows.insert(1, interp_backward_case("b_cornell_headline_cache",
                                                 *headline_call))
    backward_rows[1]["launches"] = 1
    octree_grad_phase(dev)

    # phase 15: golden configuration 1 and the other integrator options
    options_phase(dev)

    # phase 16: the sharded paths; phase 17: the new options
    sharded_launches = sharded_phase(dev, card, headline_film,
                                     headline_s_pass, train_s_step)
    options_card_phase(dev, card)

    # phases 18-21: the apps and scenes as data, each with its launches
    app_launches = {"16": sharded_launches,
                    "18": raytracer_phase(dev, card),
                    "19": shape_phase(dev, card),
                    "20": scene_file_phase(dev, card),
                    "21": apps_phase(dev, card)}
    # phase 22: the reference's call forms on the card
    app_launches["22"] = api_phase(dev, card, headline_s_pass)
    app_launches["24"] = train_graph_launches
    by_phase = lambda key: {"launches_by_phase": {
        p: n[key] for p, n in app_launches.items() if n[key]}}

    # phase 13
    print("smoke", json.dumps({"seconds": time.perf_counter() - t_start}),
          flush=True)
    cam_row = rows[0]
    kernel = lambda name, src, replaces, n, r, err: {
        "name": name, "route": "cuda", "source": PKG + src,
        "replaces": replaces, "launches": n, "max_abs_err": err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
    octree_src = "computational_ray_tracer_tpu/ops/pallas_octree.py:242"
    brute_src = "computational_ray_tracer_tpu/ops/pallas_intersect.py:72"
    print(json.dumps({"kernels": [
        {**kernel("mesh_intersect", "mesh_intersect.cu", brute_src,
                  launches["closest"], cam_row,
                  max(r["max_abs_err"] for r in rows + cornell_rows)),
         **by_phase("brute_closest")},
        {**kernel("mesh_anyhit", "mesh_intersect.cu", brute_src,
                  launches["anyhit"], cornell_rows[1], 0.0),
         **by_phase("brute_anyhit")}] + [
            kernel(f"mesh_{r['case']}", "mesh_intersect.cu", brute_src,
                   r["launches"], r, r["max_abs_err"])
            for r in cornell_rows] + [
        {**kernel("octree_closest", "octree_traverse.cu", octree_src,
                  m_launches[0], row_closest,
                  max(row_closest["t_abs_err_max"],
                      row_closest["b_abs_err_max"])),
         **by_phase("octree_closest")},
        {**kernel("octree_anyhit", "octree_traverse.cu", octree_src,
                  m_launches[1], row_any, 0.0),
         **by_phase("octree_anyhit")},
        {**kernel("dense_interp", "dense_interp.cu",
                  "computational_ray_tracer_tpu/ops/pallas_interp.py:36",
                  f_launches["interp"], interp_rows[0],
                  max(r["max_abs_err"] for r in interp_rows)),
         "library_ms": interp_rows[0]["library_ms"],
         **by_phase("interp")}] + [
        {**kernel("dense_interp_backward" + ("" if r is backward_rows[-1]
                                             else "_" + r["case"]),
                  "dense_interp.cu", BACKWARD_REPLACES,
                  r.get("launches", 0), r, r["max_abs_err"]),
         "library_ms": r["library_ms"],
         **(by_phase("interp_backward") if r is backward_rows[-1] else {})}
        for r in [backward_rows[-1]] + backward_rows[:-1]] + [
            kernel(f"octree_{r['case']}", "octree_traverse.cu", octree_src,
                   r["launches"], r, r["max_abs_err"])
            for r in bounce_rows + [canonical_row]] + [
            kernel(f"sampler_{r['case']}_{r['draw']}", "sampler.cu", None,
                   None, r, 0.0) for r in sampler_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
