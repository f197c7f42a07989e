"""GPU smoke test of the PyTorch / CUDA port: every ported path and kernel.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and skipped):

1. card and build: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the CUDA kernels built with nvcc from ``csrc/`` (one
   nvcc per source, all at once);
2. B1 (``mega_super``) vs its plain PyTorch version on the same inputs, on
   the card, held to the common-random-number contract of
   ``tools/validate_crn_frame.py`` (utils/crn.py: per-pixel difference on
   the display scale, p99.5 < 1e-5 and a razor-edge tie fraction (> 1e-4)
   < 0.6%);
3. B4 (``mega_vlp``) vs its plain version under the same contract, and
   with its per-warp triangle cull against its cull-free instantiation bit
   for bit: the GPU tests' cases, and the bench tables at 512x512, samples
   0-1 of 256 - the demo scene's emitted 1024-row table, the dense-VLP
   scene's (478 of 1024 rows live) and the 4096-row Metropolis table,
   dense and grid; then each table's render pass (512x512x256, the VLP
   main paths' launch) timed with and without the cull, and its work
   tally (``vlp_stats``: lit hits, casts, tested pairs, gathered terms,
   the clock64 split of the cycles) with the bound over the pairs the
   culled warps test and the terms the lit samples gather (the kernels
   line's), and the yardstick's bound (every ray and cast against every
   triangle, a term for every sample) beside it;
4. B6 (``gather_vlp``) vs its plain version on 512x512 random shading points
   against 64, 1024 and 4096 VLPs (rtol = atol = 1e-5), through the
   live-first table and from the raw table;
5. the super main path: ``api.render("super")`` on ``demo_scene()`` at
   1024x1024 with 1024 spp; the film is checked, quantised and written as a
   PAM file, and Mpaths/s is timed with CUDA events over 3 runs;
5b. the light pass's kernels (``light_pass``: L1, the emission; L2a,
   the Metropolis seed paths; L2b, the chain and its emission; one warp a
   trace, the full scan below 2,048 triangles, the culled walk over
   the block tables from there) against their plain versions
   (``plain=True`` on the card), bit for bit, on ``demo_scene()`` and
   ``dense_vlp_scene()`` at 512 work items / chains a light and 8 rounds,
   under the default quirks and under REFERENCE_LMEM (the reused light
   direction, negative t) with verify_eps 0, and on a 1,800-triangle
   sheet (read in place, below the walk) under the default quirks at 64
   a light and 2 rounds (its plain version takes ~2 min at 512 x 8); a
   window of each against the same rows of the full run.  A difference
   prints every differing row or chain with its light, slot and draw
   site, and the first round at which the first differing chain of light
   0 differs.  The kernels'
   tables, read back to the host, against the port's NumPy oracles
   (``models/oracle_{bpt,mlt}.py``) on both scenes, under the default and
   the reference quirks and in a window (the cases of
   ``tests/test_torch_gpu.py::hold_light_pass_to_oracles``).  On the
   20,736-triangle sheet (the culled walk), L1 and L2a + L2b against the
   plain light pass (whose traces of >= 2,048 triangles take B7's matmul
   form): the live mask and rtol = atol = 1e-5 on all but 1% of the rows
   and chains, each differing one printed; and every trace of one light
   pass, logged by the counting launch, against the kernel's full-scan
   instantiation: equal in (t, triangle index).  On the demo, the 1,800
   and the 20,736 sheets each kernel's work tally (traces, rows tested,
   node and sub-block box tests, ordered-update candidates, the clock64
   split of the floor / square / sphere stages, the triangle stage and
   the rest), and its time (CUDA events, warm, 3 runs) with its device
   time a launch (torch.profiler), beside its plain version (not on the
   1,800 sheet), the yardstick's bound over the traces it makes (every
   triangle of each) and the bound restated over the design's own work
   (the rows it tests and its box tests; on the walk, their bytes, each
   table at most once).  The parent commit's kernels are timed against
   these in turns by ``tools/ab_trees.py --set light_pass``, not here;
6. the VLP main paths: ``api.render`` at 512x512 with 256 spp -
   bidirectional, metropolis and metropolis_vlpgrid on ``demo_scene()``,
   bidirectional on ``dense_vlp_scene()`` - each timed over 3 runs after a
   warm-up, each render launching exactly L1 (bidirectional) or L2a and
   L2b (metropolis*) and B4 once; its light pass and render pass timed
   apart, the light pass's table bit-equal to its plain version's, and
   the light pass's launches and device-busy share read from a profile;
   the grid render builds only the grid's frame (B4 bins each VLP
   itself): a profiled render launches L2a, L2b and B4 and no item-list
   build, and its film equals the render pass's over the full grid;
7. the tier-1 VLP route, which B4's gate keeps for more than 8 lights
   and max_bounces < 1: bidirectional on a 9-light copy of
   ``large_mesh_scene()`` at 256x256x4 runs the plain wavefront on the
   card, whose traces are B7 and whose gather is B6 (counted: L1, B7 and
   B6, not B4); its film is held to the contract against its plain
   version (scan gather, B7's plain version), and B6 at the render's shape
   (each call's 65,536 points against the render's live-first table,
   recorded) against its plain version (rtol = atol = 1e-5), timed there:
   the kernel's device time from a torch.profiler trace (the kernels
   line's) and the wrapper's with CUDA events.  REFERENCE_LMEM is inside
   B4's gate: a demo render launches L1 and B4, its film the REFERENCE
   render's bit for bit;
8. B2/B3 (``mega_blocked``) vs B1 and vs its plain version: forced onto
   B1's cases and the demo scene (max abs against B1's film), on an
   1,800-triangle ripple sheet against the plain scan, and against the
   tier-1 plain film (whose traces are B7's plain version) on the 20,736
   sheet at 512x512x4, the 262,144 sheet at 512x512, sample 0 of 4, and
   the 1,048,576 sheet on the top, middle and bottom 16 rows of 512x512,
   samples 0-1 of 4, all under the contract (and max abs 2e-5 where no
   pixel ties); on each sheet at 512x512x4 the kernel's device time (a
   torch.profiler trace) and event time and its work tally
   (``blocked_stats``: walks, those that enter the grid, cells, empty
   cells and pairs a walk, the pairs the warps pay, and the clock64
   split of the walks' cycles), with the bound over the walk's own work
   (the kernels line's: its lanes' pairs, a visited cell each, the walks'
   set-up), over the pairs its warps pay, and beside them the block
   tree's own-need bound the grid replaced;
8b. B4's walk route (``mega_vlp`` past 512 triangles, over the exact
   grid) vs its plain version under the contract: the 1,800 and
   20,736 sheets at 512x512, samples 0-1 of 4, and the 262,144 sheet on
   rows 248-279, each with the emitted (dense) and the Metropolis (grid)
   table, the reference quirks too on the 20,736 sheet; ``force_walk``
   against the shared-memory route on the bench tables (max abs 2e-5
   where no pixel ties), and the two routes timed in turns (shared, walk,
   walk, shared) at the main paths' 512x512x256; the walk at 256x256x16
   on the 20,736 sheet, the large-mesh VLP paths' launch, held against
   its plain film under the contract and timed beside it, its tally
   (tested pairs, its own need, node / block / sub-block box tests, the
   clock64 split) and the bound over its own need and gathered terms (the
   kernels line's ``mega_vlp_walk``), over its tested pairs and the
   yardstick;
9. B7 (``tri_closest``) vs its plain version on the 512x512 primary rays
   of the large-mesh scene x 20,736 triangles, and on the inputs of every
   B7 call of phase 7's tier-1 render (camera and shadow rays): hit/miss
   and index agreement >= 99.9%, ``t`` at rtol 2e-4 where both take the
   same triangle;
10. the large-mesh main paths through ``api.render``: trianglegrid on
   ``large_mesh_scene()`` at 512x512x64 (``accel="auto"``: B2/B3), super
   on it and on the 262,144-triangle sheet at 512x512x4, bidirectional,
   metropolis and metropolis_vlpgrid on it at 256x256x16 (each render
   exactly L1, or L2a and L2b, and B4's walk), each timed over 3 runs;
10b. the DDA route (kernels B11 and B11w, ``mega_grid``): trianglegrid
   ``accel="dda"`` at 512x512x64 on the 20,736 sheet and the demo torus
   (B11 once a render, nothing else), timed over 3 runs with the split of
   host preparation, grid build and kernel, its tally (walks, cells,
   pairs) and bound, and the counting launch's read-out (its film
   bit-equal to the kernel's): warp-paid cell steps and SIMT efficiency
   of camera and shadow walks, the warp steps a per-lane schedule across
   walks would pay, empty cells, pair rounds and pair SIMT efficiency,
   and the clock64 split of the warps' cycles (``grid_split``); each
   frame's samples 0-7 held under the contract to
   the tier-1 DDA wavefront, whose every walk is B11w, and the
   ``accel="auto"`` film printed beside it (not held: where the
   reference's break rule ends a walk before its hit, the DDA's film is
   not the brute-force one); on rows 248-255 of the sheet the plain DDA
   film (every walk recorded) against B11 and B2/B3 under the contract,
   the B11w wavefront's band bit-equal to it, and B11w on every recorded
   walk bit-equal to the plain walk; B11w on the sheet's 512x512 camera
   rays against the plain walk, bit for bit, timed (events, and device
   time a call) with its tally and read-out; the tier-1 DDA route (a
   9-light copy at 256x256x4: B11w only, two launches a sample) against
   the tier-1 super film (B7) under the contract, and B11w on its first
   shadow call's recorded inputs (589,824 rays, light-major), timed with
   its tally and read-out;
11. B5 (``mega_simple``) vs its plain version under the simple family's
   contract (utils/crn.py ``SIMPLE``: p95 < 1e-5, ties on < 2%, and max
   abs 2e-5 where no pixel ties): the GPU tests' cases at 5, 0 and 1
   bounces, and the simple main path's full frame (1024x1024, samples 0-1
   of 256), each also bit for bit; its tie pixels' band is rendered again
   at max_bounces 1..5 by both, and the first bounce at which they differ
   is printed as a histogram; the bound counts the live rays of each
   bounce (every sphere a trace: the yardstick), and is restated beside it
   over the sphere tests that the kernel's cull lets through for each ray;
   the kernel is timed at max_bounces 5 and 1;
12. the simple main path: ``api.render("simple")`` at 1024x1024 with 256
   spp (bench.py's simple row), timed over 3 runs after a warm-up, its
   film written as a PAM file;
13. the nodof main path: ``api.render("nodof")`` on ``demo_scene()`` at
   512x512 with an 8x8 sample grid (B1 once a render), timed the same
   way, and held against the tier-1 sample buffer of the same render
   (16.7 M rays, reduced on the card): <= 1 uint8 step, >= 99% exact;
14. B8-loops (``diag_loops``): the 13 arms of ``tools/diag_loops.py``
   against their plain versions at 1/100 of the JAX tool's trip counts
   (bit-equal; both timed there, the ``kernels`` line's row: device time,
   events beside), then the tool's run at its own counts (ns an
   iteration), and each arm's device time there against its restated
   bound;
15. B8-prim (``diag_takelist``): the four arms of
   ``tools/diag_primitives.py`` at 128 blocks x 200 repetitions (ns a
   block), each bit-equal to its plain version, the take-list's count the
   64 flagged blocks, each arm's device time a launch;
16. B8-dda (``diag_dda``, closest and occlusion): ``tools/diag_dda.py`` at
   512x512 on the demo scene and the 5k and 20,736-triangle sheets - the
   cell-list walk, the Morton take-list twin, the shadow arm of each, the
   dense scan and the per-lane DDA (B11w) - every kernel call then held against
   its plain version (bit-equal maps), and cell == Morton == dense; on the
   20k sheet's cell lists (the closest call and each light's occlusion
   call) the counting launches' tally (``ops/diag_dda.py::STAT_NAMES``:
   the rows a tile lists - minimum, mean, maximum - pairs tested and
   needed, rows staged and stages, the clock64 split of list loads and
   copy issue, copy waits, barriers and row tests), the device time a
   call with the tiles ranked and in index order, and the kernels'
   resident blocks an SM;
17. CLI: ``super``, ``bidirectional`` and ``metropolis_vlpgrid`` at 256x256
   with 4 spp on a scene written to text files, ``trianglegrid`` on the
   large-mesh scene's files, ``nodof`` on the demo files and ``simple`` /
   ``simplecpu`` at 64x64 with 2 spp; each must exit 0 and write a valid
   PAM;
18. utilities (checkpoint, stage report, oracles): ``super`` at 1024x1024
   with 1024 spp through ``utils/checkpoint.py::render_resumable`` in 4
   windows of 256 (B1 at spp_offset 0, 256, 512, 768), cut after the
   second window and resumed from its file, against the one-shot
   ``api.render("super")`` under the contract, with the windows' time
   beside the one-shot's; the CLI's ``metropolis_vlpgrid 512 512 512 8
   3.0 --spp 256 --profile-stages --dynamic-grid-res``, which must report
   the reference's 7 stages in order (each stage's ms printed), and in
   process the staged film (VLPs, box and grid built in earlier stages,
   then B4) against ``render_metropolis(dynamic_grid_res=True)``, bit for
   bit (the contract only where the light pass is not deterministic run
   to run), its light pass one launch each of L2a and L2b; B1 and B4 at 64x64x4 on the content band (rows 372+) against
   ``oracle_super`` and ``oracle_bpt.render_with_vlps`` (the demo's
   emitted table) under ``tests/test_crn.py``'s contract (``utils/crn.py``
   ``ORACLE``: p98 < 1e-5, ties under 2%); the CLI's ``super 256 256 --spp
   8`` with ``--checkpoint --spp-per-step 2`` twice (the same image) and
   unchecked with ``PT_DEVICE=0`` and no ``--device`` (``Using device:
   cuda:0``, within one uint8 step);
19. sharded renders (``parallel/mesh.py`` through
   ``tools/validate_sharded.py``, each group of ranks spawned as child
   processes with a timeout): one rank in an NCCL group renders super
   1024x1024x1024 (B1, a one-rank all-reduce) bit for bit against
   ``api.render("super")``, both timed over 3 warm renders; 2 ranks on
   cuda:0 in a gloo group (NCCL refuses two ranks on one GPU; gloo
   stages through the host) render super 1024x1024x1024, trianglegrid on
   the 20,736 sheet at 512x512x64 (B2/B3) and simple 1024x1024x256 (B5)
   in spp windows, under the contract against the unsharded films;
   bidirectional 512x512x256 (B4) with its light pass windowed (the
   gathered table bit for bit ``emit_vlps``'s, the film the replicated
   light pass's), metropolis_vlpgrid 256x256x64 (the chain-window table
   bit for bit ``mlt_vlps``'s) and nodof 512x512 in row bands (bit for
   bit); 4 ranks on a 2 x 2 rows x spp mesh render super and
   bidirectional at 512x512x64 against the 1-D spp-sharded films; the
   CLI under torchrun with ``--shard 1`` (NCCL; with ``--checkpoint``)
   against ``api.render``, ``--shard 2`` without torchrun (exit 1); and
   the native PAM writer (utils/native.py, g++) byte for byte the NumPy
   one's.  Every rank of a check must launch its kernel (and a VLP
   render's ranks their light pass's kernels).

Every path phase (5, 6, 7, 10, 10b, 12, 13) and each diagnostic's run (14-16)
sets all launch counts to 0 just before it and reads them just after; the
counts in the ``kernels`` line come from those runs, from phase 18's
staged render (the light pass's) and from phase 19's sharded renders,
counted in each rank around each render and summed over the ranks.  Each kernel's
``bound_ms`` is the least time the card could take for the same work: the
larger of its bytes (inputs read once, output written once) over 3.35 TB/s
and its operations over 3.345e13 FP32 ops/s (132 SMs x 128 lanes x 1.98
GHz, one multiply or add an instruction: the kernels build with
--fmad=false), counting the (ray, triangle) pairs this run's data needs
(B4, on either route: the pairs its culled warps test and the terms its
lit samples gather, from its counting launch; B11 and B11w: the pairs
their walks test, 46 operations each in the division form, the cells
they visit and the walks' set-up, from the counting launch, and the
grid's tables read once; B6: the live rows; L1 and L2: the
traces they make, from a counting launch, each over the floor, every
square, sphere and triangle: the yardstick; phase 5b prints beside it
the bound over the rows the warps test and their box tests); for the
loop and primitive arms, each one dependent chain, the chain's FP32
operations x 4 cycles over the SM clock, plus for the loop arms the links
of ``LOOP_LINK_CYCLES`` (``bound_by`` ``"operations"``: a chain of them;
the FP32 chain alone is printed beside it as the yardstick).  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit, the line before that each
kernel's launches, error, times and bound.  The script imports no JAX.  It exits non-zero, printing no result, without a
GPU or without the package beside it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

W = H = 1024          # the super main path: bench.py's headline super row
SPP = 1024
VW = VH = 512         # the VLP main paths: bench.py:95-101
VSPP = 256
TIMED_RUNS = 3
PKG = "opencl_montecarlo_path_tracing_tpu_torch"

LW = LH = 512          # the large-mesh main paths: bench.py:92-104, 112-163
LSPP_GRID = 64         # trianglegrid row
LSPP = 4               # super_largemesh / super_stream rows
BW = BH = 256          # the VLP family on the large mesh
BSPP = 16
TIER1_SPP = 4          # phase 7's tier-1 render (256x256) of 9 lights

# the card's ceilings for bound_ms (H100 SXM data sheet; FP32 without FMA
# contraction: each multiply and add is one instruction per lane)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9
PAIR_OPS = 48         # multiplies + adds of one division-free M-T pair test
B7_PAIR_OPS = 113     # 4 x 13-term dot products + the epilogue
GATHER_PAIR_OPS = 20  # one (point, VLP) gather term
# B5's FP32 operations, counted from csrc/mega_simple.cu (compares, int
# and threefry work not counted): a sample's camera ray; a trace's floor
# test and each sphere test; a sphere normal's renormalisation; a hit's
# point, light direction and lamb; the floor's, a mirror's and the sky's
# shading
CAMERA_OPS = 50
FLOOR_OPS = 2
SPHERE_OPS = 19
RENORM_OPS = 10
HIT_OPS = 25
FLOOR_SHADE_OPS = 13
MIRROR_OPS = 30
SKY_OPS = 12
# the light pass's traces (kernels L1, L2): a square test's FP32
# operations (its plane distance, hit point and two |.| compares)
SQUARE_OPS = 9
LIGHT_KERNELS = ("light_emit", "light_mlt_seed", "light_mlt_chain")
LIGHT_WINDOW = 128, 200  # phase 5b's windows: first item / chain, count
SHEET_DIFFER = 0.01      # phase 5b's sheet: rows / chains beyond rtol 1e-5
BAND_MESH = 30, 30       # phase 5b's 1,800-triangle sheet (513-2,047)
BAND_CHECK = 64, 2       # its check against the plain light pass: work
#                          items / chains a light, rounds (the plain
#                          version scans 1,800 rows with ~20 launches a
#                          row at every stage: ~2 min at 512 x 8)
# a box test of the light pass's culled walk (pt_device.cuh::box_closest):
# the slab's 6 differences, 6 products and 6 min / max, 4 min / max across
# the axes, and the prune's max and 2 products
BOX_OPS = 25

# B11's and B11w's FP32 operations, counted from csrc/pt_device.cuh: a
# division-form Moller-Trumbore pair (mt_div: d x e2 9, det 5, the
# reciprocal 1, o - v0 3, u 6, the q vector 9, v 6, u + v 1, rd 6); a
# visited cell's step (the crossing's add); a walk's slab test (3
# reciprocals, 6 differences, 6 products, 10 min / max) and, where the ray
# enters the grid, its set-up (the entry point 6, the cell indices 6, the
# crossing steps 6, the first crossings 9)
DIV_PAIR_OPS = 46
DDA_SPP = 8            # B11's full frames against the DDA wavefront: the
#                        first 8 samples of the main path's 64
CELL_OPS = 1
WALK_OPS = 25
ENTER_OPS = 27

SW = SH = 1024         # the simple main path: bench.py:92-94
SSPP = 256
NW = NH = 512          # the nodof main path: bench.py:138-146
NSG = 8

# the B8 diagnostics: tools/diag_dda_pallas.py's size and scenes (the 20k
# sheet is the large-mesh rows' 20,736 triangles); the loop and primitive
# arms are one dependent chain each, so their bound is its latency: the
# chain's FP32 operations x 4 cycles (the dependent-issue latency of an
# FP32 add, multiply or max that microbenchmark studies report for Volta
# through Hopper, e.g. Jia et al. 2018, "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking") / the SM clock (clocks.max.sm)
DIAG_SIZE = 512
DIAG_SCENES = ("demo", "5k", "20k")
FP32_CHAIN_CYCLES = 4
# FP32 operations a loop iteration's chain holds: one multiply and one add
# a step; the broadcast an add; a reduce its tree depth (the full reduce
# log2(1,024) = 10, the lane reduce log2(128) = 7, the sub reduce log2(8) =
# 3) plus a multiply and an add; the copy and scalar arms one add
LOOP_CHAIN_OPS = {"bcast": 1, "reduce_full": 12, "reduce_lane": 9,
                  "reduce_sub": 5, "copy": 1, "scalar": 1}
# The restated B8-loops bound adds, to that chain, each link that is not an
# FP32 operation but that the arm's definition puts on the chain in every
# design, at a latency a published microbenchmark study measured (Jia,
# Maggioni, Staiger, Scarpazza 2018, "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking", on a Tesla V100; Hopper's are not
# lower there, so the bound can only err low).  A link with no published
# latency counts 0.
# - reduce_full: the tile's max feeds the next update.  A design that keeps
#   the tile in one warp issues >= 3 x 32 FP32 operations a lane an
#   iteration (a multiply, an add and a max an element), more than the
#   chain's 48 cycles plus any exchange below; every other design passes
#   the warps' maxima through shared memory: one shared-memory load, 19
#   cycles on the V100 (the study's shared-memory latency).
# - reduce_lane: a row of 128 fits one warp, whose exchange is a shuffle;
#   no published shuffle latency is used here, so 0.  reduce_sub: a column
#   of 8 fits one thread, no exchange, 0.
# - copy: each iteration copies its slice from device memory and reads it
#   before the next copy overwrites it, so one round trip an iteration lies
#   on the chain, at least an L2 hit (the 128 KB table stays in L2; a copy
#   served from L1 would reuse an earlier iteration's data): 193 cycles on
#   the V100 (the study's L2 hit latency).  The read of the slice counts 0
#   (a design may copy into registers).
# - bcast's conversion of i and scalar's store do not feed the chain: 0.
# - Every rolled arm's loop branch: its compare's predicate and the branch
#   lie on each iteration's path, but no published study gives their
#   latency, so 0 (PERF.md, open questions).
# B8-prim keeps its bound, the adds alone: its votes, flag reads, list
# builds and loop branches depend on the block index and the tile, never
# on the accumulator, so a design can overlap them with the adds.
SHARED_LOAD_CYCLES = 19
L2_HIT_CYCLES = 193
LOOP_LINK_CYCLES = {"reduce_full": SHARED_LOAD_CYCLES,
                    "copy": L2_HIT_CYCLES}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, runs: int, warm_up: bool = True) -> float:
    """Mean ms per call of ``fn`` over ``runs`` calls, CUDA events, after
    one warm-up call (skipped when the caller has just run the same code)."""
    import torch
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def timed_call(fn):
    """(fn(), its ms on CUDA events) for one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def reset_counts():
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_dda, diag_loops, diag_takelist, gather_vlp, grid, light_pass,
        mega_simple, mega_super, mega_vlp, tri_closest)
    mega_super.LAUNCHES = mega_super.BLOCKED_LAUNCHES = 0
    mega_vlp.LAUNCHES = gather_vlp.LAUNCHES = tri_closest.LAUNCHES = 0
    mega_simple.LAUNCHES = 0
    diag_dda.CLOSEST_LAUNCHES = diag_dda.OCC_LAUNCHES = 0
    diag_takelist.LAUNCHES = diag_loops.LAUNCHES = 0
    light_pass.EMIT_LAUNCHES = light_pass.SEED_LAUNCHES = 0
    light_pass.CHAIN_LAUNCHES = 0
    grid.MEGA_LAUNCHES = grid.WALK_LAUNCHES = 0


def read_counts() -> dict:
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_dda, diag_loops, diag_takelist, gather_vlp, grid, light_pass,
        mega_simple, mega_super, mega_vlp, tri_closest)
    return {"mega_super": mega_super.LAUNCHES,
            "mega_blocked": mega_super.BLOCKED_LAUNCHES,
            "mega_vlp": mega_vlp.LAUNCHES, "gather_vlp": gather_vlp.LAUNCHES,
            "tri_closest": tri_closest.LAUNCHES,
            "mega_simple": mega_simple.LAUNCHES,
            "diag_dda_closest": diag_dda.CLOSEST_LAUNCHES,
            "diag_dda_occ": diag_dda.OCC_LAUNCHES,
            "diag_takelist": diag_takelist.LAUNCHES,
            "diag_loops": diag_loops.LAUNCHES,
            "light_emit": light_pass.EMIT_LAUNCHES,
            "light_mlt_seed": light_pass.SEED_LAUNCHES,
            "light_mlt_chain": light_pass.CHAIN_LAUNCHES,
            "mega_grid": grid.MEGA_LAUNCHES, "grid_walk": grid.WALK_LAUNCHES}


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the byte time and the operation
    time on the card's ceilings."""
    t_ops = ops / FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def shading_counts(key, scn, w, h, spp, spp_total):
    """(lit, casts) over samples 0..spp-1 of a w x h super film: primary
    hits the shading lights (floor, diffuse), and the (hit, light) pairs
    whose shadow ray the shading uses (front-facing lights) - the plain
    tier-1 trace on the card, the data behind B1's bound."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        trace_ray)
    ii, jj = C.pixel_grid(w, h, device="cuda")
    pix = (jj * w + ii).to(torch.int64)
    cam = make_camera(z_sign=-1.0)
    lit_n = cast_n = 0
    for s in range(spp):
        ray_id = (pix * spp_total + s) & 0xFFFFFFFF
        r = R.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
        o, d = primary_rays(cam, ii, jj, *r)
        tr = trace_ray(o, d, scn, sphere_material=3, plain=True)
        lit = (tr.material == 1) | (tr.material == 3)
        x = o + d * tr.t[..., None]
        for i in range(int(scn.lights.shape[0])):
            u1, u2 = R.rand2(key, ray_id, C.SITE_LIGHT0 + i)
            lp = torch.as_tensor(scn.lights[i, :3], device="cuda")
            ldir = C.normalize(
                lp + torch.stack([u1, u2, torch.zeros_like(u1)], -1) - x)
            cast_n += int((lit & (C.dot(ldir, tr.normal) >= 0)).sum())
        lit_n += int(lit.sum())
    return lit_n, cast_n


def gpu_tests():
    """tests/test_torch_gpu.py, loaded by path (an installed package may
    also be named "tests"); it imports no JAX."""
    spec = importlib.util.spec_from_file_location(
        "_torch_gpu_cases", os.path.join(ROOT, "tests", "test_torch_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_crn(name, a, b, spp, failed, atol=None, contract=None) -> float:
    """Print the contract's statistics of two films; returns the max abs
    film difference and records a violation in ``failed``.  With ``atol``,
    a pair with no tie pixel must also agree to ``atol``.  ``contract``
    defaults to the super/VLP families' (utils/crn.py ``SUPER``)."""
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import (
        SUPER, crn_ok)
    contract = SUPER if contract is None else contract
    a = a.cpu().numpy()
    b = b.cpu().numpy()
    if a.shape != b.shape or not np.isfinite(a).all():
        raise RuntimeError(f"{name}: bad kernel film {a.shape}")
    ok, st = crn_ok(a, b, spp, contract)
    if atol is not None and st["tie_frac"] == 0.0:
        ok = ok and st["max_abs"] <= atol
    qname = f"p{contract.quantile * 100:g}"
    print(f"  {name}: max {st['max']:.3e} {qname} {st['q']:.3e} "
          f"ties {st['tie_frac'] * 100:.3f}% max_abs_film "
          f"{st['max_abs']:.3e} {'ok' if ok else 'VIOLATION'}")
    if not ok:
        failed.append(name)
    return st["max_abs"]


def phase_card_and_build(card: str):
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.utils import build
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    info = build.build()
    build.load()
    print(f"build: {info.seconds:.1f} s ({os.path.relpath(info.path, ROOT)})")
    for line in info.log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_super_kernel_vs_plain(gt) -> float:
    """B1 on the GPU tests' cases plus the demo scene and the main path's
    film shape; returns the largest abs film error."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    print("B1 mega_super vs plain:")
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gt.QUIRKS[q])
             for name, make_scene, seed, shape, kw, q in gt.CASES]
    demo = prep_scene(demo_scene()[0])
    cases += [
        ("demo scene 256x256x4", demo, 0, (256, 256, 4), {}, DEFAULT),
        ("demo scene 1024x1024, samples 0-1 of 1024", demo, 0,
         (W, H, 2), dict(spp_total=SPP), DEFAULT),
    ]
    worst, failed = 0.0, []
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", **kw)
        b = M.film_super_mega_plain(key, scn, w, h, spp, quirks=quirks,
                                    device="cuda", **kw)
        worst = max(worst, check_crn(name, a, b, spp, failed))
    if failed:
        raise RuntimeError(f"B1 kernel vs plain contract violated: {failed}")
    return worst


def vlp_bench_tables():
    """The VLP main paths' tables on the card: (name, scene arrays, vlps,
    grid or None)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, dense_vlp_scene)
    key = make_key(0)
    demo = prep_scene(demo_scene()[0])
    dense = prep_scene(dense_vlp_scene())
    mlt = mlt_vlps(key, demo, 512, 8, device="cuda")
    grid = V.build_vlp_grid(mlt, V.vlp_grid_static_res(int(mlt.shape[0])))
    return [
        ("demo emitted 1024 rows", demo,
         V.emit_vlps(key, demo, 512, device="cuda"), None),
        ("dense_vlp_scene emitted 1024 rows", dense,
         V.emit_vlps(key, dense, 512, device="cuda"), None),
        ("demo Metropolis 4096 rows", demo, mlt, None),
        ("demo Metropolis 4096 rows, grid", demo, mlt, grid),
    ]


def live_overflow(vlps, grid) -> int:
    """The most live VLPs any cell of ``grid`` overlaps (the tier-1 gather
    keeps 62 a cell, the kernel's masked scan all of them)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    live = vlps[vlps[:, 3] > 0]
    amin, amax = V.vlp_aabbs(live)
    g = G.build_grid_cellscan(amin, amax, grid.vmin, grid.cell_size,
                              grid.res, cap=int(live.shape[0]) + 1)
    return int(torch.max(g.counts)) if g.counts.numel() else 0


def vlp_split(st: dict) -> str:
    """B4's counting launch as shares of its clock64 cycles."""
    parts = ("cam_tri", "cam_rest", "shadow_tri", "shadow_rest", "gather",
             "stage")
    rest = st["kernel"] - sum(st[k] for k in parts)
    return ", ".join(f"{k} {100 * st[k] / st['kernel']:.1f}%"
                     for k in parts) + \
        f", threefry/camera/shading {100 * rest / st['kernel']:.1f}%"


def phase_vlp_kernel_vs_plain(gt, tables, card: str) -> dict:
    """B4 on the GPU tests' cases and the bench tables: against its plain
    version (512x512, samples 0-1 of 256), and with its triangle cull
    against the cull-free instantiation (bit for bit); then each table's
    render pass (512x512x256) timed with and without the cull, and its
    work tally.  Returns the kernels line's row: the demo table's render
    pass, its bound from the tally's lit hits and casts."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.grid import (
        MAX_NELS_PER_CELL)
    print("B4 mega_vlp vs plain, and culled vs cull-free (bit for bit):")
    worst, failed = 0.0, []

    def both(name, key, scn, vlps, w, h, spp, grid, kw):
        nonlocal worst
        a = M.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                            device="cuda", **kw)
        b = M.film_vlp_mega_plain(key, scn, vlps, w, h, spp, grid=grid,
                                  device="cuda", **kw)
        worst = max(worst, check_crn(name, a, b, spp, failed))
        c = M.film_vlp_mega(key, scn, vlps, w, h, spp, grid=grid,
                            device="cuda", cull=False, **kw)
        if not torch.equal(a, c):
            print(f"  {name}: culled != cull-free, max abs "
                  f"{float((a - c).abs().max()):.3e} VIOLATION")
            failed.append(f"{name} (cull)")

    for name in gt.VLP_CASES:
        scn, key, vlps, grid, (w, h, spp), kw = gt.vlp_case_inputs(name,
                                                                   "cuda")
        both(name, key, scn, vlps, w, h, spp, grid, kw)
    key = make_key(0)
    for name, scn, vlps, grid in tables:
        n_live = int((vlps[:, 3] > 0).sum())
        if grid is not None:
            over = live_overflow(vlps, grid)
            print(f"  {name}: grid {grid.res}, at most {over} live VLPs in "
                  f"a cell (tier-1 cap {MAX_NELS_PER_CELL}); dead VLPs' far "
                  "boxes fill the corner cell, beyond n_live")
            if over > MAX_NELS_PER_CELL:
                raise RuntimeError(f"{name}: a cell overflows with live VLPs;"
                                   " kernel and plain would differ there")
        both(f"{name} ({n_live} live), {VW}x{VH} samples 0-1 of {VSPP}", key,
             scn, vlps, VW, VH, 2, grid, dict(spp_total=VSPP))
    if failed:
        raise RuntimeError(f"B4 kernel vs plain or cull violated: {failed}")

    # the render pass of each table: times, chunks, the work tally
    print(f"B4 render pass {VW}x{VH}x{VSPP} (the VLP main paths' launch):")
    R = VW * VH * VSPP
    row = {}
    for name, scn, vlps, grid in tables:
        n_live = int((vlps[:, 3] > 0).sum())
        nt = int(scn.tri_v0.shape[0])
        stride = M.DENSE_STRIDE if grid is None else M.GRID_STRIDE
        chunk = M.VLP_SMEM_BYTES // (4 * stride)
        ms = {c: time_ms(lambda: M.film_vlp_mega(
            key, scn, vlps, VW, VH, VSPP, grid=grid, device="cuda",
            cull=c), TIMED_RUNS) for c in (True, False)}
        st = {c: M.vlp_stats(key, scn, vlps, VW, VH, VSPP, grid=grid,
                             cull=c) for c in (False, True)}
        on, off = st[True], st[False]
        nl = int(scn.lights.shape[0])
        # the yardstick: every camera ray and every cast scans the mesh, a
        # gather term for every sample and live VLP; restated over the
        # pairs the culled warps test and the terms the lit samples gather
        yard_ops = (R + on["lit"] * nl) * nt * PAIR_OPS + \
            R * n_live * GATHER_PAIR_OPS
        own_ops = on["tested"] * PAIR_OPS + on["gather_pairs"] * \
            GATHER_PAIR_OPS
        nbytes = vlps.shape[0] * 4 * stride + nt * 48 + VW * VH * 12
        b_ms, b_by = bound(yard_ops, nbytes)
        r_ms, r_by = bound(own_ops, nbytes)
        # chunks staged every sample (0: the live rows are staged once a
        # launch), here and with the parent design's 256-row chunks
        chunks = [0 if n_live <= c else -(-n_live // c) for c in (chunk, 256)]
        print(f"  {name}: {n_live} live of {int(vlps.shape[0])}, chunks "
              f"staged a sample {chunks[0]} (256-row chunks: {chunks[1]}); "
              f"kernel {ms[True]:.3f} ms, cull-free {ms[False]:.3f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}, yardstick), restated "
              f"{r_ms:.4f} ms ({r_by}, tested pairs and gathered terms) "
              f"({card})")
        print(f"    lit {on['lit']}, casts {on['casts']} ({on['casts_tri']}"
              f" reach the triangles), gather terms {on['gather_pairs']}, "
              f"tested pairs {on['tested']} (cull-free {off['tested']}, "
              f"yardstick {(R + on['lit'] * nl) * nt})")
        for c, t in ((False, off), (True, on)):
            print(f"    split {'culled' if c else 'cull-free'}: "
                  f"{vlp_split(t)}")
        if not row:
            # the kernels line carries the bound over the work this
            # design does; the yardstick stays beside it, printed
            row = {"ms": ms[True], "bound_ms": r_ms, "bound_by": r_by,
                   "yard_ms": b_ms}
    _, scn, vlps, _ = tables[0]
    small_ms = time_ms(lambda: M.film_vlp_mega(
        key, scn, vlps, VW, VH, 2, spp_total=VSPP, device="cuda"), 5)
    plain_ms = time_ms(lambda: M.film_vlp_mega_plain(
        key, scn, vlps, VW, VH, VSPP, device="cuda"), 1, warm_up=False)
    print(f"  {tables[0][0]}: kernel {row['ms']:.3f} ms at {VW}x{VH}x{VSPP} "
          f"({small_ms:.3f} ms at {VW}x{VH}x2), plain PyTorch "
          f"{plain_ms:.1f} ms at {VW}x{VH}x{VSPP}; the kernels line's bound "
          f"{row['bound_ms']:.4f} ms (tested pairs and gathered terms, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of the kernel's time), "
          f"the yardstick's {row['yard_ms']:.4f} ms beside it ({card})")
    return {"max_abs": worst, "ms": row["ms"], "plain_ms": plain_ms,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}


def gather_bound(R: int, V: int, n_live: int) -> str:
    """B6's bound over the live pairs its table holds, beside the
    yardstick over every row (the parent design's work)."""
    live = bound(R * n_live * GATHER_PAIR_OPS, R * 28 + n_live * 32)
    yard = bound(R * V * GATHER_PAIR_OPS, R * 28 + V * 32)
    return (f"bound {live[0]:.4f} ms ({live[1]}; {n_live} live rows), "
            f"yardstick {yard[0]:.4f} ms ({yard[1]}; all {V} rows)")


def phase_gather_kernel_vs_plain(card: str) -> dict:
    """B6 on 512x512 random shading points against 64, 1024 and 4096 VLPs
    (a fifth of them dead), through the live-first table as a render
    passes it, and from the raw table (the wrapper builds it)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
    print("B6 gather_vlp vs plain (the table's shape):")
    rng = np.random.default_rng(11)
    R = VW * VH
    x = rng.normal(5, 3, (R, 3)).astype(np.float32)
    n = rng.normal(0, 1, (R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tx, tn = (torch.from_numpy(a).cuda() for a in (x, n))
    worst_abs = worst_rel = 0.0
    for V in (64, 1024, 4096):
        vlps = rng.normal(5, 3, (V, 4)).astype(np.float32)
        vlps[:, 3] = np.abs(vlps[:, 3])
        vlps[::5, 3] = 0.0
        tv = torch.from_numpy(vlps).cuda()
        table = G.live_table(tv)
        a = G.gather_vlps_mxu(tx, tn, table)
        b = G.gather_vlps_mxu_plain(tx, tn, tv)
        if a.shape != (R,) or not torch.isfinite(a).all():
            raise RuntimeError(f"B6 V={V}: bad output {tuple(a.shape)}")
        d = (a - b).abs()
        max_abs = float(d.max())
        max_rel = float((d / b.abs().clamp_min(1e-30)).max())
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        ok = bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)) and \
            torch.equal(a, G.gather_vlps_mxu(tx, tn, tv))
        k_ms = time_ms(lambda: G.gather_vlps_mxu(tx, tn, table), 10)
        raw_ms = time_ms(lambda: G.gather_vlps_mxu(tx, tn, tv), 10)
        p_ms = time_ms(lambda: G.gather_vlps_mxu_plain(tx, tn, tv), 2)
        print(f"  {R} points x {V} VLPs: max_abs {max_abs:.3e} max_rel "
              f"{max_rel:.3e} "
              f"{'ok' if ok else 'VIOLATION'}; kernel {k_ms:.3f} ms "
              f"({raw_ms:.3f} ms building the table), plain PyTorch "
              f"{p_ms:.1f} ms; {gather_bound(R, V, int(table.n_live))} "
              f"({card})")
        if not ok:
            raise RuntimeError(f"B6 kernel vs plain differ at V={V}")
    return {"max_abs": worst_abs, "max_rel": worst_rel}


def phase_super_main_path(card: str) -> dict:
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.reduce import (
        quantize_film)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import (
        ImgInfo, load_pam, save_pam)

    scene, tag = demo_scene()

    film, ms, counts = timed_renders(lambda: pt.render(
        "super", scene, W, H, spp=SPP, seed=0, device="cuda"))
    if counts["mega_super"] < TIMED_RUNS:
        raise RuntimeError(f"super main path launched B1 "
                           f"{counts['mega_super']} times in {TIMED_RUNS} "
                           "renders")
    f = film.cpu().numpy()
    mean = float(f.mean()) / SPP
    if f.shape != (H, W, 3) or not np.isfinite(f).all() \
            or not 0.5 < mean < 2.0:
        raise RuntimeError(f"bad main-path film: shape {f.shape}, "
                           f"mean/spp {mean}")
    mpaths = W * H * SPP / (ms / 1e3) / 1e6
    print(f"main path: super {W}x{H}x{SPP} on {tag}: {ms:.1f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); film mean/spp {mean:.4f}, "
          f"launches {counts}")

    rgba = quantize_film(film).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.ppm")
        save_pam(out, ImgInfo(width=W, height=H, channels=4, data=rgba))
        img = load_pam(out)
        if (img.width, img.height) != (W, H) or \
                not np.array_equal(img.data, rgba):
            raise RuntimeError("result.ppm does not read back")

    # the kernel and its plain version at the main path's film shape (fewer
    # samples: the plain version runs ~1e4 small launches per sample), and
    # at 256x256x4
    scn = prep_scene(scene)
    key = make_key(0)
    times = {}
    for w, h, spp in ((W, H, 4), (256, 256, 4)):
        k_ms = time_ms(lambda: M.film_super_mega(
            key, scn, w, h, spp, device="cuda"), 5)
        p_ms = time_ms(lambda: M.film_super_mega_plain(
            key, scn, w, h, spp, device="cuda"), 2)
        times[(w, h, spp)] = (k_ms, p_ms)
        print(f"  {w}x{h}x{spp}: kernel {k_ms:.3f} ms, plain PyTorch "
              f"{p_ms:.1f} ms ({card})")
    # work at 1024x1024x4: every primary ray scans the mesh, and every
    # shadow ray the shading uses
    nt = int(scn.tri_v0.shape[0])
    _, casts = shading_counts(key, scn, W, H, 4, 4)
    b_ms, b_by = bound((W * H * 4 + casts) * nt * PAIR_OPS,
                       nt * 48 + W * H * 12)
    print(f"  bound at {W}x{H}x4: {b_ms:.4f} ms ({b_by}; {casts} shadow "
          "rays cast)")
    return {"launches": counts["mega_super"], "ms": times[(W, H, 4)][0],
            "plain_ms": times[(W, H, 4)][1], "render_ms": ms,
            "mpaths": mpaths, "bound_ms": b_ms, "bound_by": b_by}


def device_ms(fn, runs: int, kernel: str, same_work: bool = False):
    """(mean device ms a launch of the CUDA kernels whose name holds
    ``kernel``, over the launches a torch.profiler trace (CUDA activity
    only) of ``runs`` calls of ``fn`` holds, after one warm-up call, or
    None when three traces in turn hold none; the launches traced).  A
    trace taken late in a long process may drop launches; each one it
    holds is a whole launch's device time.  With ``same_work`` (each call
    one launch of the same work) a trace counts only if it holds at most
    ``runs`` launches whose times agree within 25%, and five are tried
    (a trace has read flat16 at half its time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5 if same_work else 3):   # a trace may hold no launch
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if us and (not same_work or (len(us) <= runs
                                     and max(us) <= 1.25 * min(us))):
            return sum(us) / 1e3 / len(us), len(us)
        if us:
            print(f"  ({kernel} trace rejected: {len(us)} launches of "
                  f"{runs}, us {[round(u, 2) for u in us]})")
    return None, 0


def profiled(name, fn):
    """(fn(), a line of its torch.profiler summary: host wall time, device
    kernel time, kernel count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels:
        return out, (f"{name}: {wall_ms:.1f} ms wall; device time not "
                     "measured (the profiler recorded no kernel)")
    return out, (f"{name}: {wall_ms:.1f} ms wall, {len(kernels)} kernels, "
                 f"{dev_ms:.1f} ms device-busy "
                 f"({100 * dev_ms / wall_ms:.2f}%), "
                 f"{1e3 * (wall_ms - dev_ms) / len(kernels):.2f} us of host "
                 "dispatch per kernel")


def light_trace_ops(scn) -> int:
    """FP32 operations of one closest-hit trace of the light pass: the
    floor, every square and sphere, every triangle of the mesh (a
    division-free Moller-Trumbore pair)."""
    return (FLOOR_OPS + SQUARE_OPS * int(scn.square_k.shape[0])
            + SPHERE_OPS * int(scn.sphere_centers.shape[0])
            + PAIR_OPS * int(scn.tri_v0.shape[0]))


def differing_rows(a, b) -> list:
    """Indices of the rows (first axis) where ``a`` and ``b`` differ."""
    import torch
    d = (a != b).reshape(a.shape[0], -1).any(1)
    return torch.nonzero(d).flatten().tolist()


def light_differences(stage, got, want, args) -> tuple[int, float]:
    """Print where the kernel's ``got`` differs from the plain ``want``
    (every differing row or chain, with its light, item or chain, slot and
    draw site); return the count of differing rows and the max abs
    difference (0, 0.0 when bit-equal).
    ``stage``: "L1" (emitted rows), "L2a" ((v, length) seed states) or
    "L2b" (the chain's table); ``args``: the stage's window and sizes."""
    import torch
    if stage == "L2a":
        rows = sorted(set(differing_rows(got[0], want[0]))
                      | set(differing_rows(got[1], want[1])))
        err = float((got[0] - want[0]).abs().max()) if rows else 0.0
    else:
        rows = differing_rows(got, want)
        err = float((got - want).abs().max()) if rows else 0.0
    if not rows:
        return 0, 0.0
    n = args["n"]
    if stage == "L1":
        for i in rows:
            l = i // n
            print(f"    L1 row {i}: light {l}, work item {i % n}, "
                  f"site {64 + (0 if args['reuse'] else l)}: kernel "
                  f"{got[i].tolist()} plain {want[i].tolist()}")
    elif stage == "L2a":
        for i in rows:
            l, c = divmod(i, n)
            slot = next((k for k in range(4)
                         if not torch.equal(got[0][i, k], want[0][i, k])), 4)
            print(f"    L2a chain {c}, light {l}: first slot {slot} "
                  f"(site {192 + 4 * l + min(slot, 3)}), length "
                  f"{int(got[1][i])} / {int(want[1][i])}")
    else:
        chains = sorted({(i // (4 * n), i % n) for i in rows})
        for l, c in chains:
            slot = min((i // n) % 4 for i in rows
                       if i // (4 * n) == l and i % n == c)
            print(f"    L2b chain {c}, light {l}: rows differ from "
                  f"slot {slot}")
        print(f"    L2b: {len(chains)} of {args['nl'] * n} chains differ "
              f"({100 * len(chains) / (args['nl'] * n):.2f}%)")
        # the first round at which the first differing chain of light 0
        # differs (round r of light 0 draws at the same sites in a run of
        # any length; light l's at r + l * rounds)
        first = next((c for l, c in chains if l == 0), None)
        if first is None:
            print("    L2b: no chain of light 0 differs; rounds not "
                  "localised")
        else:
            r_at = args["round_of"](first)
            print(f"    L2b chain {first}, light 0: first differs after "
                  f"round {r_at} (sites {256 + (r_at - 1) * 16} + 0..15)"
                  if r_at else f"    L2b chain {first}, light 0: every "
                  "round prefix equal; the emission differs")
    return len(rows), err


def sheet_differences(stage, got, want, nl, n) -> tuple[int, int, float]:
    """Where the kernel's table ``got`` and the plain ``want`` disagree on
    the sheet: the rows (L1, ``nl * n`` of them) or the chains (L2, ``nl``
    lights x ``n`` chains, each its 4 slots) with an element beyond rtol =
    atol = 1e-5 or a different live flag, each printed; returns their
    count, the count of rows or chains and the max abs difference."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    ok = np.isclose(g, w, rtol=1e-5, atol=1e-5) \
        & ((g[:, 3:] > 0) == (w[:, 3:] > 0))
    if stage == "L1":
        ok = ok.all(1).reshape(nl, n)
    else:
        ok = ok.reshape(nl, 4, n, 4).all(axis=(1, 3))
    unit = "work item" if stage == "L1" else "chain"
    for l, c in np.argwhere(~ok):
        print(f"    {stage} on the sheet: light {l}, {unit} {c}: kernel "
              f"{g.reshape(nl, -1, n, 4)[l, :, c].tolist()} plain "
              f"{w.reshape(nl, -1, n, 4)[l, :, c].tolist()}")
    return int((~ok).sum()), int(ok.size), float(np.abs(g - w).max())


def light_restated_ops(scn, st: dict) -> int:
    """FP32 operations of the light pass's own work, from a counting
    launch's tally: each trace's floor, squares and spheres, the triangle
    rows its lanes test and the box tests of its walk."""
    return ((FLOOR_OPS + SQUARE_OPS * int(scn.square_k.shape[0])
             + SPHERE_OPS * int(scn.sphere_centers.shape[0])) * st["traces"]
            + PAIR_OPS * st["rows"]
            + BOX_OPS * (st["node_tests"] + st["sub_tests"]))


def light_split(st: dict) -> str:
    """A counting launch's tally: the work and the clock64 split."""
    k = max(1, st["kernel_cycles"])
    pre, tri = st["pre_cycles"] / k, st["tri_cycles"] / k
    return (f"{st['traces']} traces, {st['rows']} rows tested "
            f"({st['rows'] / max(1, st['traces']):.1f} a trace), "
            f"{st['node_tests']} node and {st['sub_tests']} sub-block box "
            f"tests, {st['candidates']} candidates; cycles: floor / squares /"
            f" spheres {100 * pre:.1f}%, triangles {100 * tri:.1f}%, RNG and "
            f"chain logic {100 * (1 - pre - tri):.1f}%")


def phase_light_pass(gt, card: str) -> dict:
    """Kernels L1, L2a and L2b (``ops/light_pass.py``) against their plain
    versions (``plain=True`` on the card), bit for bit: on the demo and
    dense-VLP scenes, 512 work items / chains a light and 8 rounds, under
    the default quirks and under REFERENCE_LMEM (negative t accepted,
    the light direction reused) with verify_eps 0 (the reference's exact
    test), and on the 1,800-triangle sheet (past the shared-memory stage,
    below the culled walk) under the default quirks at ``BAND_CHECK``; a
    window of each equal to the same rows of the full run (demo and
    dense).  The tables
    against the NumPy oracles (``gt``: tests/test_torch_gpu.py).  On the
    20,736-triangle sheet (the culled walk) against the plain light pass,
    whose traces take B7's matmul form: <= ``SHEET_DIFFER`` of the rows
    and chains beyond rtol = atol = 1e-5; and every trace of one light
    pass against the full-scan instantiation (``culled=False``), equal in
    (t, triangle index).  Each kernel's work tally (a counting launch) and
    its times (CUDA events, warm, 3 runs) on the demo, the 1,800 sheet
    and the 20,736 sheet, with its device time a launch (torch.profiler),
    the plain version (not on the 1,800 sheet), the yardstick's bound
    (every triangle of each trace) and the bound restated over the
    design's own work.  Returns the kernels line's rows for L1 and for L2
    (L2a + L2b)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        DEFAULT, REFERENCE_LMEM)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as MT)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import light_pass as L
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.mega_super import (
        block_tables, scene_buffer)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, dense_vlp_scene, large_mesh_scene)

    key, n_main, rounds_main = make_key(0), MLT_SEEDS, MLT_ROUNDS
    cuda, plain = dict(device="cuda"), dict(device="cuda", plain=True)
    failed, err = [], {"L1": 0.0, "L2a": 0.0, "L2b": 0.0}
    print("L1 / L2a / L2b vs plain, bit for bit:")
    demo = prep_scene(demo_scene()[0])
    band = prep_scene(large_mesh_scene(*BAND_MESH))
    for sname, scn, quirk_sets, (n, rounds) in (
            ("demo", demo, 2, (n_main, rounds_main)),
            ("dense_vlp_scene", prep_scene(dense_vlp_scene()), 2,
             (n_main, rounds_main)),
            (f"{int(band.tri_v0.shape[0])}-triangle sheet", band, 1,
             BAND_CHECK)):
        nl = int(scn.lights.shape[0])
        full = {}
        for qname, q, eps in (("default", DEFAULT, 1e-3),
                              ("REFERENCE_LMEM, verify_eps 0",
                               REFERENCE_LMEM, 0.0))[:quirk_sets]:
            def round_of(chain):
                """The first r whose r-round prefix of light 0's ``chain``
                differs (its rows: slots 0-3 of a one-chain window)."""
                sd = MT.mlt_seed(key, scn, n, q, chain0=chain, chains=1,
                                 **plain)
                for r in range(1, rounds + 1):
                    kw = dict(chain0=chain, chains=1)
                    if not torch.equal(
                            MT.mlt_mutate_emit(key, scn, n, r, q, eps, sd,
                                               **kw, **cuda)[:4],
                            MT.mlt_mutate_emit(key, scn, n, r, q, eps, sd,
                                               **kw, **plain)[:4]):
                        return r
                return 0
            args = dict(n=n, nl=nl, rounds=rounds,
                        reuse=q.reuse_light_direction, round_of=round_of)
            e = V.emit_vlps(key, scn, n, q, **cuda)
            sk = MT.mlt_seed(key, scn, n, q, **cuda)
            sp = MT.mlt_seed(key, scn, n, q, **plain)
            t = MT.mlt_mutate_emit(key, scn, n, rounds, q, eps, sp, **cuda)
            res = [("L1", e, V.emit_vlps(key, scn, n, q, **plain)),
                   ("L2a", sk, sp),
                   ("L2b", t, MT.mlt_mutate_emit(key, scn, n, rounds, q, eps,
                                                 sp, **plain))]
            line = []
            for stage, got, want in res:
                nd, d = light_differences(stage, got, want, args)
                err[stage] = max(err[stage], d)
                line.append(f"{stage} "
                            + (f"{nd} rows DIFFER" if nd else "bit-equal"))
                if nd:
                    failed.append(f"{sname} {qname} {stage}")
            live = (int((e[:, 3] > 0).sum()), int((t[:, 3] > 0).sum()))
            print(f"  {sname}, {qname} ({n} a light, {rounds} rounds): "
                  f"{', '.join(line)} (live rows: emitted {live[0]} of "
                  f"{e.shape[0]}, Metropolis {live[1]} of {t.shape[0]})")
            full.setdefault("emit", e)
            full.setdefault("mlt", t)
        if scn is band:
            continue
        # windows: the same rows of the full (default) run
        g0, cnt = LIGHT_WINDOW
        rows = torch.from_numpy(np.concatenate(
            [np.arange(g0, g0 + cnt) + n * b for b in range(nl)]))
        ew = V.emit_vlps(key, scn, n, gi0=g0, count=cnt, **cuda)
        rows4 = torch.from_numpy(np.concatenate(
            [np.arange(g0, g0 + cnt) + n * b for b in range(4 * nl)]))
        tw = MT.mlt_vlps(key, scn, n, rounds, chain0=g0, chains=cnt, **cuda)
        ok = (torch.equal(ew, full["emit"][rows]),
              torch.equal(tw, full["mlt"][rows4]))
        print(f"  {sname}, window [{g0}, {g0 + cnt}): emitted rows "
              f"{'equal' if ok[0] else 'DIFFER'}, Metropolis rows "
              f"{'equal' if ok[1] else 'DIFFER'} to the full run's")
        if not all(ok):
            failed.append(f"{sname} window")
    if failed:
        raise RuntimeError(f"light-pass kernels vs plain: {failed}")

    # the kernels' tables against the NumPy oracles (raises on a violation)
    print("L1 / L2 tables vs the NumPy oracles (oracle_bpt, oracle_mlt):")
    for sname in ("demo", "dense"):
        for qname in ("default", "reference"):
            o = gt.hold_light_pass_to_oracles("cuda", sname, qname)
            print(f"  {sname}, {qname}: emitted {o['emit_live']} live rows, "
                  f"max abs {o['emit_max_abs']:.3g}; Metropolis "
                  f"{o['mlt_live']} live rows, chain match "
                  f"{o['chain_match'][0]:.4f} (window "
                  f"{o['chain_match'][1]:.4f})")

    # the 20,736-triangle sheet: the culled walk over the block tables
    n, rounds = n_main, rounds_main
    sheet = prep_scene(large_mesh_scene())
    nl = int(sheet.lights.shape[0])
    if L.triangle_route(sheet) != "walk":
        raise RuntimeError("the 20,736-triangle sheet is not on the walk")
    reset_counts()
    ek = V.emit_vlps(key, sheet, n, **cuda)
    tk = MT.mlt_vlps(key, sheet, n, rounds, **cuda)
    torch.cuda.synchronize()
    c = read_counts()
    ep, p_ms = timed_call(lambda: V.emit_vlps(key, sheet, n, **plain))
    tp, q_ms = timed_call(lambda: MT.mlt_vlps(key, sheet, n, rounds,
                                              **plain))
    print(f"  {int(sheet.tri_v0.shape[0])}-triangle sheet ({n} a light, "
          f"{rounds} rounds), the culled walk vs the plain light pass (B7 "
          f"plain for its triangles; {p_ms / 1e3:.1f} s + "
          f"{q_ms / 1e3:.1f} s): launches {[c[k] for k in LIGHT_KERNELS]}")
    sheet_err = {}
    for stage, got, want in (("L1", ek, ep), ("L2", tk, tp)):
        nd, total, d = sheet_differences(stage, got, want, nl, n)
        sheet_err[stage] = d
        print(f"    {stage}: {nd} of {total} "
              f"{'rows' if stage == 'L1' else 'chains'} differ beyond rtol "
              f"= atol = 1e-5 or in the live mask ({100 * nd / total:.2f}%; "
              f"budget {100 * SHEET_DIFFER:.0f}%), max abs {d:.3g}")
        if nd > SHEET_DIFFER * total:
            failed.append(f"sheet {stage}")
    if [c[k] for k in LIGHT_KERNELS] != [1, 1, 1]:
        failed.append(f"sheet launches {c}")
    # every trace of one light pass: the walk against the full scan
    caps = {"L1": 1, "L2a": 4, "L2b": 4 + 11 * rounds}
    logged = {}
    for culled in (True, False):
        logs = {k: (torch.full((nl * n, cap), -1.0, device="cuda"),
                    torch.full((nl * n, cap), -2, dtype=torch.int32,
                               device="cuda")) for k, cap in caps.items()}
        kw = dict(device="cuda", culled=culled)
        e = L.emit(key, sheet, n, DEFAULT, log=logs["L1"], **kw)
        sd = L.mlt_seed(key, sheet, n, DEFAULT, log=logs["L2a"], **kw)
        t = L.mlt_mutate_emit(key, sheet, n, rounds, DEFAULT, 1e-3, sd,
                              log=logs["L2b"], **kw)
        logged[culled] = (logs, (e, *sd, t))
    line = []
    for k in caps:
        (wt, wi), (ft, fi) = logged[True][0][k], logged[False][0][k]
        traces = int((fi != -2).sum())
        bad = int(((wt != ft) | (wi != fi)).sum())
        line.append(f"{k} {bad} of {traces} traces differ in (t, index) "
                    f"({int((fi >= 0).sum())} triangle hits)")
        if bad:
            failed.append(f"sheet walk vs full scan {k}")
    same = all(torch.equal(a, b) for a, b in zip(logged[True][1],
                                                  logged[False][1]))
    print(f"    the culled walk vs the kernel's full scan: {'; '.join(line)};"
          f" tables {'equal' if same else 'DIFFER'}")
    if not same:
        failed.append("sheet walk vs full scan tables")
    if failed:
        raise RuntimeError(f"light-pass kernels on the sheet: {failed}")

    # work, times and bounds: on the main paths' configuration (demo,
    # default; the kernels line's), on the band and on the sheet
    def timings(scn, plain_runs):
        seed = MT.mlt_seed(key, scn, n, DEFAULT, **cuda)

        def calls(**kw):
            return {
                "L1": lambda: L.emit(key, scn, n, DEFAULT, **kw),
                "L2a": lambda: L.mlt_seed(key, scn, n, DEFAULT, **kw),
                "L2b": lambda: L.mlt_mutate_emit(key, scn, n, rounds,
                                                 DEFAULT, 1e-3, seed, **kw)}
        plain_fns = {
            "L1": lambda: V.emit_vlps(key, scn, n, **plain),
            "L2a": lambda: MT.mlt_seed(key, scn, n, **plain),
            "L2b": lambda: MT.mlt_mutate_emit(key, scn, n, rounds, DEFAULT,
                                              1e-3, seed, **plain)}
        nl = int(scn.lights.shape[0])
        walk = L.triangle_route(scn) == "walk"
        # the yardstick reads every triangle once; the walk reads the
        # scene without triangles and, each at most once, the rows and
        # boxes it tests (a row 64 bytes, a box 32)
        yard_bytes = 4 * scene_buffer(scn, "cuda")[0].numel()

        def own_bytes(t):
            if not walk:
                return yard_bytes
            buf, rows_t, _, subs, nodes = block_tables(scn, "cuda")
            return 4 * buf.numel() + sum(
                min(n_read * per, 4 * tab.numel()) for n_read, per, tab in (
                    (t["rows"], 64, rows_t), (t["sub_tests"], 32, subs),
                    (t["node_tests"], 32, nodes)))
        out_bytes = {"L1": nl * n * 16, "L2a": nl * n * 52,
                     "L2b": nl * n * 52 + 4 * nl * n * 16}
        kernel_names = {"L1": "light_emit_kernel",
                        "L2a": "light_mlt_seed_kernel",
                        "L2b": "light_mlt_chain_kernel"}
        st = {}
        for name in ("L1", "L2a", "L2b"):
            stats = L.new_stats("cuda")
            calls(stats=stats)[name]()
            tally = L.read_stats(stats)
            tr = tally["traces"]
            ms = time_ms(calls()[name], TIMED_RUNS)
            # the kernel's device time a launch (events also hold the
            # wrapper's host time between short launches)
            dev, _ = device_ms(calls()[name], 10, kernel_names[name])
            runs = plain_runs[name]
            p_ms = (time_ms(plain_fns[name], runs, warm_up=runs > 1)
                    if runs else None)
            b_ms, b_by = bound(tr * light_trace_ops(scn),
                               yard_bytes + out_bytes[name])
            r_ms, r_by = bound(light_restated_ops(scn, tally),
                               own_bytes(tally) + out_bytes[name])
            st[name] = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, traces=tr)
            dev_line = ("not measured (the profiler recorded no launch)"
                        if dev is None else f"{dev:.4f} ms")
            plain_line = ("not timed here (BAND_CHECK)" if p_ms is None
                          else f"{p_ms:.1f} ms")
            print(f"  {name}: {ms:.4f} ms (device time a launch: "
                  f"{dev_line}), plain {plain_line}; bound "
                  f"{b_ms:.6f} ms ({b_by}; yardstick: "
                  f"{tr} traces x {light_trace_ops(scn)} operations, "
                  f"{100 * b_ms / ms:.2f}% of the kernel's time), restated "
                  f"over the design's own work {r_ms:.6f} ms ({r_by}, "
                  f"{100 * r_ms / ms:.2f}%)")
            print(f"    {light_split(tally)}")
        return st

    print(f"light pass on the demo scene, {n} a light, {rounds} rounds "
          f"({card}):")
    st = timings(demo, {"L1": 3, "L2a": 3, "L2b": 1})
    for scn, runs in ((band, 0), (sheet, 1)):
        print(f"light pass on the {int(scn.tri_v0.shape[0])}-triangle sheet "
              f"({L.triangle_route(scn)}), {n} a light, {rounds} rounds "
              f"({card}):")
        timings(scn, dict.fromkeys(("L1", "L2a", "L2b"), runs))
    l2 = {k: st["L2a"][k] + st["L2b"][k]
          for k in ("ms", "plain_ms", "bound_ms")}
    return {"emit": dict(st["L1"], max_abs=max(err["L1"], sheet_err["L1"])),
            "mlt": dict(l2, max_abs=max(err["L2a"], err["L2b"],
                                        sheet_err["L2"]),
                        bound_by=st["L2b"]["bound_by"])}


def phase_vlp_main_paths(card: str) -> dict:
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        film_vlp)
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, dense_vlp_scene)

    demo, tag = demo_scene()
    paths = [("bidirectional", demo, tag), ("metropolis", demo, tag),
             ("metropolis_vlpgrid", demo, tag),
             ("bidirectional", dense_vlp_scene(), "dense_vlp_scene")]
    key = make_key(0)
    total = 0
    light = dict.fromkeys(LIGHT_KERNELS, 0)
    for variant, scene, stag in paths:
        film, ms, counts = timed_renders(lambda: pt.render(
            variant, scene, VW, VH, spp=VSPP, seed=0, device="cuda"))
        # a render's passes: L1 (bidirectional) or L2a and L2b, then B4
        want = dict.fromkeys(counts, 0)
        for k in ("mega_vlp",) + (
                ("light_emit",) if variant == "bidirectional"
                else ("light_mlt_seed", "light_mlt_chain")):
            want[k] = TIMED_RUNS
        if counts != want:
            raise RuntimeError(f"{variant} on {stag}: launches {counts} in "
                               f"{TIMED_RUNS} renders (want the light pass's "
                               "kernels and B4 once each, nothing else)")
        total += counts["mega_vlp"]
        for k in LIGHT_KERNELS:
            light[k] += counts[k]
        mpaths = VW * VH * VSPP / (ms / 1e3) / 1e6

        # the same render in its two passes, and the film it must equal
        scn = prep_scene(scene)
        use_grid = variant.endswith("vlpgrid")
        if variant == "bidirectional":
            def light_pass():
                return V.emit_vlps(key, scn, 512, device="cuda"), None
        else:
            def light_pass():
                # B4 reads only the grid's frame: the render builds no more
                vl = mlt_vlps(key, scn, 512, 8, device="cuda")
                grid = (V.vlp_grid_frame(
                    vl, V.vlp_grid_static_res(int(vl.shape[0])))
                    if use_grid else None)
                return vl, grid
        # the light pass's launches and device-busy share, on the pass the
        # check needs
        (vlps, grid), line = profiled("light pass", light_pass)
        print("  " + line)
        light_ms = time_ms(light_pass, TIMED_RUNS, warm_up=False)
        render_ms = time_ms(lambda: film_vlp(
            key, scn, vlps, grid, VW, VH, VSPP, 0, VSPP, DEFAULT,
            device="cuda"), TIMED_RUNS)
        again = film_vlp(key, scn, vlps, grid, VW, VH, VSPP, 0, VSPP,
                         DEFAULT, device="cuda")
        f = film.cpu().numpy()
        if f.shape != (VH, VW, 3) or not np.isfinite(f).all() \
                or not torch.equal(film, again):
            raise RuntimeError(f"{variant} on {stag}: bad main-path film "
                               f"{f.shape}, or not the film of its passes")
        # the kernels' table is the plain light pass's, so the film is
        # film_vlp's on the plain table
        plain = (V.emit_vlps(key, scn, 512, device="cuda", plain=True)
                 if variant == "bidirectional" else
                 mlt_vlps(key, scn, 512, 8, device="cuda", plain=True))
        if not torch.equal(vlps, plain):
            raise RuntimeError(f"{variant} on {stag}: the light pass's "
                               "table differs from its plain version's")
        if use_grid:
            grid_frame_line(variant, scene, scn, key, vlps, film, ms)
        n_live = int((vlps[:, 3] > 0).sum())
        print(f"main path: {variant} {VW}x{VH}x{VSPP} on {stag}: "
              f"{ms:.1f} ms/render, {mpaths:.1f} Mpaths/s ({card}); light "
              f"pass {light_ms:.1f} ms, render pass {render_ms:.2f} ms "
              f"({n_live} live of {int(vlps.shape[0])} VLPs, the table "
              f"bit-equal to the plain light pass's); film mean/spp "
              f"{float(f.mean()) / VSPP:.4f}, launches {counts}")
    return {"launches": total, "light": light}


def grid_frame_line(variant, scene, scn, key, vlps, film, ms):
    """The grid render builds only the grid's frame on B4's route: a
    profiled render launches L2a, L2b and B4 and the frame's few ops, no
    item-list build, and its film is the render pass's over the fully
    built grid, bit for bit; printed beside the 11.4-13.3 ms a render
    measured with the full build (NVIDIA H100 80GB HBM3, 700 W)."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.models.bidirectional import (
        film_vlp)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    builds, real = [], G.build_grid_cellscan
    G.build_grid_cellscan = lambda *a, **k: builds.append(1) or real(*a, **k)
    try:
        reset_counts()
        _, line = profiled("render", lambda: pt.render(
            variant, scene, VW, VH, spp=VSPP, seed=0, device="cuda"))
        counts = read_counts()
    finally:
        G.build_grid_cellscan = real
    full = V.build_vlp_grid(vlps, V.vlp_grid_static_res(int(vlps.shape[0])))
    same = torch.equal(film, film_vlp(key, scn, vlps, full, VW, VH, VSPP, 0,
                                      VSPP, DEFAULT, device="cuda"))
    launched = {k: v for k, v in counts.items() if v}
    print(f"  C1, {variant}: {line}; kernel launches {launched}, grid "
          f"item-list builds {len(builds)}; the film "
          f"{'bit-equal' if same else 'DIFFERS'} to the render pass over "
          f"the full grid; {ms:.1f} ms a render (11.4-13.3 ms with the "
          "full build)")
    if builds or not same or launched != {
            "light_mlt_seed": 1, "light_mlt_chain": 1, "mega_vlp": 1}:
        raise RuntimeError(f"{variant}: the grid render is not the frame's")


def nine_lights(scene):
    """``scene`` with 9 lights (its own, repeated): past B4's gate (8 RNG
    sites a bounce), so a VLP render takes the tier-1 wavefront."""
    n = int(scene.lights.shape[0])
    return dataclasses.replace(
        scene, lights=np.tile(scene.lights, (-(-9 // n), 1))[:9])


def phase_tier1_route(card: str) -> dict:
    """The VLP family's tier-1 route, which B4's gate keeps for more than
    8 lights and max_bounces < 1: bidirectional on a 9-light copy of
    large_mesh_scene() at 256x256x4 launches L1, B7 and B6 and not B4; its
    film against the plain render pass (scan gather, B7's plain version);
    B6 at the render's shape (each call's inputs, recorded) against its
    plain version.  REFERENCE_LMEM is inside B4's gate (no VLP-family
    function reads shadow_carry_t): a demo render launches L1 and B4 once,
    its film the REFERENCE render's bit for bit.  Returns the kernels
    line's row for B6 and the tier-1 render's launches."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        REFERENCE, REFERENCE_LMEM)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    w = h = BW
    spp = TIER1_SPP
    scene = nine_lights(large_mesh_scene())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    film = pt.render("bidirectional", scene, w, h, spp=spp, seed=0,
                     device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    launched = {k: v for k, v in counts.items() if v}
    if set(launched) != {"light_emit", "tri_closest", "gather_vlp"}:
        raise RuntimeError(f"tier-1 route (9 lights): launches {counts}")
    scn = prep_scene(scene)
    key = make_key(0)
    vlps = V.emit_vlps(key, scn, 512, device="cuda")
    want, p_ms = timed_call(lambda: M.film_vlp_mega_plain(
        key, scn, vlps, w, h, spp, device="cuda"))
    failed = []
    check_crn(f"tier-1 bidirectional, 9 lights, {scene.n_triangles} "
              f"triangles, {w}x{h}x{spp} (B7, B6) vs plain ({p_ms / 1e3:.1f}"
              " s)", film, want, spp, failed)
    if failed:
        raise RuntimeError("tier-1 route: film vs plain violated")
    print(f"tier-1 route: {ms:.1f} ms ({card}), launches {launched}")

    demo = demo_scene()[0]
    reset_counts()
    lmem = pt.render("bidirectional", demo, w, h, spp=spp, seed=0,
                     quirks=REFERENCE_LMEM, device="cuda")
    torch.cuda.synchronize()
    lc = {k: v for k, v in read_counts().items() if v}
    same = torch.equal(lmem, pt.render("bidirectional", demo, w, h, spp=spp,
                                       seed=0, quirks=REFERENCE,
                                       device="cuda"))
    print(f"  REFERENCE_LMEM bidirectional {w}x{h}x{spp} on the demo: "
          f"launches {lc}, the film {'bit-equal' if same else 'DIFFERS'} to"
          " REFERENCE's")
    if lc != {"light_emit": 1, "mega_vlp": 1} or not same:
        raise RuntimeError("REFERENCE_LMEM is not B4's REFERENCE film")

    # B6 at the render's shape: the same render with each call's inputs
    # kept (the live-first table is built once a render)
    calls = recorded_b6_calls(lambda: pt.render(
        "bidirectional", scene, w, h, spp=spp, seed=0, device="cuda"))
    row = b6_at_render_shape("B6 at the render's shape", calls, card)
    return dict(row, launches=counts["gather_vlp"],
                tri_closest=counts["tri_closest"],
                light_emit=counts["light_emit"])


def recorded_b6_calls(fn) -> list:
    """Runs ``fn()`` with B6's wrapper wrapped so that each call's inputs
    (x, n, and the table as passed: a render's live-first table) are
    kept; returns them."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
    calls = []
    kernel = G.gather_vlps_mxu

    def recording(x, n, v):
        calls.append((x.clone(), n.clone(), v))
        return kernel(x, n, v)

    G.gather_vlps_mxu = recording
    try:
        fn()
    finally:
        G.gather_vlps_mxu = kernel
    return calls


def b6_at_render_shape(name: str, calls: list, card: str) -> dict:
    """B6 on a render's recorded calls: each against its plain version over
    the raw table (rtol = atol = 1e-5; bit-equality on finite lanes is
    printed), then the first call timed - the kernel's device time from a
    torch.profiler trace (the kernels line's ``ms``) and the wrapper's
    with CUDA events (host dispatch sets it at this shape)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import gather_vlp as G
    worst, bits = 0.0, True
    for x, n, table in calls:
        a, b = G.gather_vlps_mxu(x, n, table), \
            G.gather_vlps_mxu_plain(x, n, table)
        worst = max(worst, float((a - b).abs().max()))
        fin = torch.isfinite(a) & torch.isfinite(b)
        bits = bits and torch.equal(a[fin], b[fin])
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"{name}: kernel vs plain outside rtol = "
                               "atol = 1e-5")
    x, n, table = calls[0]
    R, Vn, n_live = int(x.shape[0]), int(table.tab.shape[0]), \
        int(table.n_live)
    k_ms = time_ms(lambda: G.gather_vlps_mxu(x, n, table), 50)
    d_ms, n_ev = device_ms(lambda: G.gather_vlps_mxu(x, n, table), 50,
                           "gather_vlp_kernel")
    p_ms = time_ms(lambda: G.gather_vlps_mxu_plain(x, n, table), 5)
    line = gather_bound(R, Vn, n_live)
    b_ms, b_by = bound(R * n_live * GATHER_PAIR_OPS, R * 28 + n_live * 32)
    dev = (f"device {d_ms:.5f} ms a launch ({n_ev} of 50 launches "
           "traced)" if d_ms is not None else "device time not measured "
           "(the trace holds no gather_vlp_kernel launch)")
    print(f"  {name}: {len(calls)} calls of {R} points x {Vn} VLPs "
          f"({n_live} live, {100 * n_live / Vn:.1f}%): max_abs {worst:.3e} "
          f"ok, bit-equal on finite lanes {bits}; kernel {dev}, wrapper "
          f"{k_ms:.4f} ms a call (events); plain PyTorch {p_ms:.2f} ms; "
          f"{line} ({card})")
    return {"max_abs": worst, "ms": k_ms if d_ms is None else d_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_blocked_kernel_vs_plain(gt, card: str) -> dict:
    """B2/B3 forced onto B1's cases (against B1's film), on the GPU tests'
    meshes and an 1,800-triangle sheet (against the plain scan), and on
    the 20,736 / 262,144 / 1,048,576-triangle sheets (against the tier-1
    plain film, whose traces are B7's plain version)."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    print("B2/B3 mega_blocked vs B1 and vs plain:")
    worst, failed = 0.0, []
    demo = prep_scene(demo_scene()[0])
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gt.QUIRKS[q]) for name, make_scene, seed, shape, kw, q
             in gt.CASES]
    cases += [
        ("demo scene 256x256x4", demo, 0, (256, 256, 4), {}, DEFAULT),
        ("demo scene 1024x1024, samples 0-1 of 1024", demo, 0, (W, H, 2),
         dict(spp_total=SPP), DEFAULT)]
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", force_blocked=True, **kw)
        b = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", **kw)
        worst = max(worst, check_crn(f"{name}: forced vs B1", a, b, spp,
                                     failed, atol=2e-5))
    sheet = gt.sheet_scene(30, 30)
    cases = [(name, prep_scene(make_scene()), seed, shape, kw,
              gt.QUIRKS[q]) for name, make_scene, seed, shape, kw, q
             in gt.BLOCKED_CASES]
    cases += [("sheet 1800, 512x512 rows 200-263, samples 0-1 of 4",
               prep_scene(sheet), 0, (512, 512, 2),
               dict(spp_total=4, row_offset=200, rows=64), DEFAULT)]
    for name, scn, seed, (w, h, spp), kw, quirks in cases:
        key = make_key(seed)
        a = M.film_super_mega(key, scn, w, h, spp, quirks=quirks,
                              device="cuda", force_blocked=True, **kw)
        b = M.film_super_mega_plain(key, scn, w, h, spp, quirks=quirks,
                                    device="cuda", **kw)
        worst = max(worst, check_crn(f"{name}: vs plain scan", a, b, spp,
                                     failed, atol=2e-5))
    key = make_key(0)
    # against the tier-1 plain film: the 20,736 sheet at the super main
    # path's full shape (the plain film's time too), the 262,144 sheet over
    # the full frame at sample 0, the 1,048,576 sheet on 16-row bands at the
    # frame's top, middle and bottom (the edges graze the sheet)
    checks = [((144, 72), LSPP, ((0, LH),)),
              ((512, 256), 1, ((0, LH),)),
              ((1024, 512), 2, ((0, 16), (248, 16), (LH - 16, 16)))]
    p_ms, row = 0.0, None
    for nm, spp, bands in checks:
        scn = prep_scene(large_mesh_scene(*nm))
        nt = int(scn.tri_v0.shape[0])
        for row_offset, rows in bands:
            band = dict(spp_total=LSPP, row_offset=row_offset, rows=rows)
            a = M.film_super_mega(key, scn, LW, LH, spp, device="cuda",
                                  **band)
            b, ms = timed_call(lambda: M.film_super_mega_plain(
                key, scn, LW, LH, spp, device="cuda", **band))
            if (nm, spp, rows) == ((144, 72), LSPP, LH):
                p_ms = ms
            worst = max(worst, check_crn(
                f"sheet {nt}, {LW}x{LH} rows {row_offset}-"
                f"{row_offset + rows - 1}, samples 0-{spp - 1} of {LSPP}: "
                f"vs tier-1 plain (B7 plain, {ms / 1e3:.1f} s)", a, b, spp,
                failed, atol=2e-5))
        # the kernel at the super rows' shape; the main path's call (the
        # 20,736 sheet) is the kernels line's
        main = nm == (144, 72)
        r = blocked_row(key, scn, card,
                        f", plain PyTorch {p_ms:.1f} ms" if main else "")
        row = r if main else row
    if failed:
        raise RuntimeError(f"B2/B3 kernel contract violated: {failed}")
    return {"max_abs": worst, "plain_ms": p_ms, **row}


#: The block tree's bound over its own need (the pairs of the 32-row
#: sub-blocks each ray's own box test passed) on the 20,736 sheet at
#: 512x512x4, as this script measured it while B2/B3 walked the block
#: tables (PERF.md, B2).
BLOCK_TREE_OWN_NEED_MS = 0.4580


def blocked_row(key, scn, card: str, extra: str = "") -> dict:
    """B2/B3 on ``scn`` at the super rows' shape (512x512x4, tables
    cached): its device time a launch (torch.profiler) and a call's event
    time, its tally (``blocked_stats``), its bounds - over the walk's own
    work (its lanes' pairs, a visited cell each, the walks' set-up; the
    grid's tables and the film each moved once), over the pairs its warps
    pay, and on the 20,736 sheet the block tree's own-need bound beside
    them - printed on one line and its split on another; returns the
    kernels line's fields (ms: the device time where traced)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as X
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    nt = int(scn.tri_v0.shape[0])

    def launch():
        return M.film_super_mega(key, scn, LW, LH, LSPP, device="cuda")
    ev_ms = time_ms(launch, 5)
    d_ms, _ = device_ms(launch, 5, "mega_blocked_kernel", same_work=True)
    k_ms = ev_ms if d_ms is None else d_ms
    st = M.blocked_stats(key, scn, LW, LH, LSPP)
    if not (st["tested"] >= st["pairs"] > 0
            and st["walks"] == LW * LH * LSPP + st["casts_tri"]):
        raise RuntimeError(f"B2/B3 tally inconsistent: {st}")
    xg = X.exact_grid(scn, "cuda")
    nbytes = X.table_bytes(xg) + LW * LH * 12
    walk = (st["cells"] * CELL_OPS + st["walks"] * WALK_OPS
            + st["entered"] * ENTER_OPS)
    b_ms, b_by = bound(st["pairs"] * PAIR_OPS + walk, nbytes)
    t_ms, _ = bound(st["tested"] * PAIR_OPS + walk, nbytes)
    tree = (f", the block tree's own-need bound {BLOCK_TREE_OWN_NEED_MS} ms"
            if nt == 20736 else "")
    print(f"  sheet {nt}, {LW}x{LH}x{LSPP}: kernel {fmt_ms(d_ms)} ms of "
          f"device time a launch, {ev_ms:.3f} ms a call on events{extra}; "
          f"bound {b_ms:.4f} ms ({b_by}; the walk's own work, "
          f"{100 * b_ms / k_ms:.1f}% of the kernel's time), over the pairs "
          f"its warps pay {t_ms:.4f} ms ({100 * t_ms / k_ms:.1f}%){tree}; "
          f"grid {xg.res}, {X.table_bytes(xg) / 1e6:.1f} MB of tables "
          f"({card})")
    kc = max(st["kernel"], 1)
    print(f"    casts {st['casts']} ({st['casts_tri']} walk), "
          f"{st['pairs'] / max(st['walks'], 1) / nt:.2e} of the mesh a walk;"
          f" {walk_split(st)}; the kernel's cycles: camera rest "
          f"{100 * st['cam_rest'] / kc:.1f}%, camera walk "
          f"{100 * st['cam_tri'] / kc:.1f}%, shadow rest "
          f"{100 * st['shadow_rest'] / kc:.1f}%, shadow walks "
          f"{100 * st['shadow_tri'] / kc:.1f}%")
    return {"ms": k_ms, "bound_ms": b_ms, "bound_by": b_by}


#: The block design's bound on B4's walk route over its own need (the
#: pairs of the 32-row sub-blocks each ray's own box test passed) and
#: the gathered terms, on the 20,736 sheet at 256x256x16, as this script
#: measured it while the walk read B2/B3's block tables (PERF.md, B9).
BLOCK_OWN_NEED_MS = 0.3996


def walk_bound(st: dict, R: int, nt: int, nl: int, n_live: int,
               nbytes: float) -> dict:
    """B4's walk route's bounds from its tally over ``R`` samples: over its
    own work (the kernels line's): the pairs its lanes test, a visited
    cell each, the walks' set-up (and more where a walk enters the grid)
    and the terms its lit samples gather, each table read once; over the
    pairs its warps pay (32 a pair iteration: a lane idles while a
    neighbour tests a longer cell); and the yardstick (every camera ray
    and cast against every triangle, a term for every sample and live
    VLP)."""
    gather = st["gather_pairs"] * GATHER_PAIR_OPS
    walk = (st["cells"] * CELL_OPS + st["walks"] * WALK_OPS
            + st["entered"] * ENTER_OPS)
    own = bound(st["pairs"] * PAIR_OPS + walk + gather, nbytes)
    tested = bound(st["tested"] * PAIR_OPS + walk + gather, nbytes)
    yard = bound((R + st["lit"] * nl) * nt * PAIR_OPS
                 + R * n_live * GATHER_PAIR_OPS, nbytes)
    return {"bound_ms": own[0], "bound_by": own[1], "tested_ms": tested[0],
            "yard_ms": yard[0]}


def walk_split(st: dict) -> str:
    """B4's walk route's tally (``vlp_stats``) read: cells, empty cells and
    pairs a walk, pair SIMT efficiency, and the clock64 split of the
    walks' cycles."""
    w = max(st["walks"], 1)
    k = max(sum(st[c] for c in ("clk_setup", "clk_empty", "clk_loads",
                                "clk_pairs", "clk_step")), 1)
    empty = 100 * st["empty"] / max(st["cells"], 1)
    return (f"{st['walks']} walks ({st['entered']} enter the grid): "
            f"{st['cells'] / w:.1f} cells ({empty:.1f}% empty) and "
            f"{st['pairs'] / w:.1f} pairs a walk, pair SIMT "
            f"efficiency {st['pairs'] / max(st['tested'], 1):.3f}; the "
            "walks' cycles: " + ", ".join(
                f"{n} {100 * st[c] / k:.1f}%" for n, c in (
                    ("set-up", "clk_setup"), ("empty steps", "clk_empty"),
                    ("occupied loads", "clk_loads"),
                    ("pairs", "clk_pairs"), ("end tests and steps",
                                             "clk_step"))))


def first_render_tables(scene) -> str:
    """A fresh Scene's host preparation on its first VLP render past
    2,048 triangles: prep_scene, B4's exact grid, and the block tables
    L1 / L2's culled walk reads (ms, host clock between device syncs)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as X
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    out, scn = [], None
    for name, step in (
            ("prep_scene", lambda: prep_scene(dataclasses.replace(scene))),
            ("the exact grid", lambda: X.exact_grid(scn, "cuda")),
            ("the block tables", lambda: M.block_tables(scn, "cuda"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = step()
        torch.cuda.synchronize()
        scn = got if scn is None else scn
        out.append(f"{name} {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return "fresh Scene: " + ", ".join(out)


def phase_vlp_walk_vs_plain(gt, card: str) -> dict:
    """B4's walk route (past 512 triangles, the exact grid's walk) against
    its plain version under the CRN contract: the 1,800-triangle sheet of
    tests/test_torch_gpu.py and the 20,736 sheet at 512x512, samples 0-1
    of 4 (rows 256-511 on the 20,736 sheet, where its DDA's break rule
    ends walks early), the 262,144 sheet on rows 248-279 (its plain film
    is slow), each with the emitted table (dense) and the Metropolis table
    (grid), the default quirks, and the reference quirks on the 20,736
    sheet; the emitted table on the meshes the exact grid exists for - 96
    triangles through one cell (``fan_scene``, rows 192-319), every hit an
    exact tie (``tie_scene``) and rows 248-255 of the 1,048,576 sheet;
    ``force_walk``
    against the shared-memory route on the bench tables (max abs 2e-5
    where no pixel ties), and the two routes timed in turns at
    512x512x256 on those tables; then the walk at the large-mesh VLP
    paths' shape (256x256x16) on the 20,736, 262,144 and 1,048,576
    sheets, timed with its tally and its bounds (the 20,736 sheet's held
    against its plain film under the contract and timed beside it), and
    each sheet's tables on a fresh Scene.  Returns the kernels line's row
    for the walk (the 20,736 sheet's)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import (
        DEFAULT, REFERENCE)
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
        mlt_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as X
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops import vlp as V
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    print("B4 mega_vlp walk route vs plain:")
    key = make_key(0)
    worst, failed = 0.0, []
    both, dense = ("dense", "grid"), ("dense",)
    large = {nm: large_mesh_scene(*nm)
             for nm in ((144, 72), (512, 256), (1024, 512))}
    sheets = [(gt.sheet_scene(30, 30), {}, (DEFAULT,), both),
              (large[144, 72], dict(row_offset=256, rows=256),
               (DEFAULT, REFERENCE), both),
              (large[512, 256], dict(row_offset=248, rows=32), (DEFAULT,),
               both),
              (gt.fan_scene(), dict(row_offset=192, rows=128), (DEFAULT,),
               dense),
              (gt.tie_scene(), {}, (DEFAULT,), dense),
              (large[1024, 512], dict(row_offset=248, rows=8), (DEFAULT,),
               dense)]
    for scene, band, quirk_sets, kinds in sheets:
        scn = prep_scene(scene)
        nt = int(scn.tri_v0.shape[0])
        xg = X.exact_grid(scn, "cuda")
        print(f"  {nt} triangles: grid {xg.res}, {xg.ids.shape[0]} pairs, "
              f"largest cell {int(xg.span[:, 1].max())}, "
              f"{X.table_bytes(xg) / 1e6:.1f} MB of tables")
        emitted = V.emit_vlps(key, scn, 512, device="cuda")
        if "grid" in kinds:
            ml = mlt_vlps(key, scn, 512, 8, device="cuda")
            grid = V.build_vlp_grid(ml, V.vlp_grid_static_res(
                int(ml.shape[0])))
        for tname in kinds:
            vlps, g = (emitted, None) if tname == "dense" else (ml, grid)
            for q in quirk_sets:
                kw = dict(spp_total=4, grid=g, quirks=q, device="cuda",
                          **band)
                a = M.film_vlp_mega(key, scn, vlps, LW, LH, 2, **kw)
                b, p_ms = timed_call(lambda: M.film_vlp_mega_plain(
                    key, scn, vlps, LW, LH, 2, **kw))
                rows = band.get("rows", LH)
                r0 = band.get("row_offset", 0)
                worst = max(worst, check_crn(
                    f"sheet {nt}, {tname} ({int((vlps[:, 3] > 0).sum())} "
                    f"live), {'reference' if q == REFERENCE else 'default'} "
                    f"quirks, {LW}x{LH} rows {r0}-{r0 + rows - 1}, samples "
                    f"0-1 of 4 (plain {p_ms / 1e3:.1f} s)", a, b, 2, failed))
    for name, scn, vlps, grid in vlp_bench_tables():
        kw = dict(spp_total=VSPP, grid=grid, device="cuda")
        a = M.film_vlp_mega(key, scn, vlps, VW, VH, 2, force_walk=True, **kw)
        b = M.film_vlp_mega(key, scn, vlps, VW, VH, 2, **kw)
        worst = max(worst, check_crn(
            f"{name}: force_walk vs shared memory", a, b, 2, failed,
            atol=2e-5))
        # the two routes at the main paths' launch, in turns
        shared = lambda: M.film_vlp_mega(  # noqa: E731
            key, scn, vlps, VW, VH, VSPP, grid=grid, device="cuda")
        walk = lambda: M.film_vlp_mega(  # noqa: E731
            key, scn, vlps, VW, VH, VSPP, grid=grid, force_walk=True,
            device="cuda")
        s1, w1, w2, s2 = (time_ms(f, 5) for f in (shared, walk, walk, shared))
        print(f"  {name} {VW}x{VH}x{VSPP}: shared memory {s1:.3f} / {s2:.3f}"
              f" ms, walk {w1:.3f} / {w2:.3f} ms (turns shared, walk, walk, "
              f"shared), walk / shared {(w1 + w2) / (s1 + s2):.3f} ({card})")
    if failed:
        raise RuntimeError(f"B4 walk route vs plain violated: {failed}")

    # the walk at the large-mesh VLP paths' launch, 256x256x16, on the
    # three sheets; the 20,736 sheet's row is the kernels line's
    row = None
    for scene in large.values():
        scn = prep_scene(scene)
        nt, nl = int(scn.tri_v0.shape[0]), int(scn.lights.shape[0])
        vlps = V.emit_vlps(key, scn, 512, device="cuda")
        n_live = int((vlps[:, 3] > 0).sum())
        film = M.film_vlp_mega(key, scn, vlps, BW, BH, BSPP, device="cuda")
        p_ms = None
        if nt == 20736:
            want, p_ms = timed_call(lambda: M.film_vlp_mega_plain(
                key, scn, vlps, BW, BH, BSPP, device="cuda"))
            worst = max(worst, check_crn(
                f"sheet {nt}, dense ({n_live} live), default quirks, "
                f"{BW}x{BH}x{BSPP} (plain {p_ms / 1e3:.1f} s)", film, want,
                BSPP, failed))
            if failed:
                raise RuntimeError(f"B4 walk route vs plain violated: "
                                   f"{failed}")
        def launch():
            return M.film_vlp_mega(key, scn, vlps, BW, BH, BSPP,
                                   device="cuda")
        ev_ms = time_ms(launch, 10)
        # the kernel's own time: a call's events also hold the wrapper's
        # host work (the VLP table's ~20 torch ops), as long as the launch
        d_ms, _ = device_ms(launch, 10, "mega_vlp_kernel", same_work=True)
        k_ms = ev_ms if d_ms is None else d_ms
        st = M.vlp_stats(key, scn, vlps, BW, BH, BSPP)
        R = BW * BH * BSPP
        xg = X.exact_grid(scn, "cuda")
        b = walk_bound(st, R, nt, nl, n_live,
                       X.table_bytes(xg) + vlps.shape[0] * 32
                       + BW * BH * 12)
        print(f"  sheet {nt}, {BW}x{BH}x{BSPP} ({n_live} live VLPs): kernel "
              f"{fmt_ms(d_ms)} ms of device time a launch, {ev_ms:.4f} ms a "
              "call on events" + (f", plain PyTorch {p_ms:.1f} ms"
                                  if p_ms is not None else "")
              + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}; its own "
              "work and gathered terms, "
              f"{100 * b['bound_ms'] / k_ms:.1f}% of the kernel's time), over"
              f" the pairs its warps pay {b['tested_ms']:.4f} ms "
              f"({100 * b['tested_ms'] / k_ms:.1f}%), yardstick "
              f"{b['yard_ms']:.4f} ms" + (
                  f", the block design's own-need bound {BLOCK_OWN_NEED_MS}"
                  " ms" if nt == 20736 else "") + f" ({card})")
        print(f"    lit {st['lit']}, casts {st['casts']} ({st['casts_tri']} "
              f"reach the triangles), gather terms {st['gather_pairs']}; "
              f"{walk_split(st)}; split {vlp_split(st)}")
        print(f"    {first_render_tables(scene)}")
        if not (st["tested"] >= st["pairs"] > 0 and st["walks"]
                == BW * BH * BSPP + st["casts_tri"]):
            raise RuntimeError(f"B4 walk tally inconsistent: {st}")
        if nt == 20736:
            row = {"max_abs": worst, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    return row


def b7_agreement(name, calls, min_hits: float) -> tuple[float, bool]:
    """B7 against its plain version on each (o, d, scn, quirks) of
    ``calls``: hit/miss agreement >= 99.9%; where both hit, the same
    triangle on >= 99.9% of rays (a razor-edge validity test may flip
    between the two sums, and then the ray's closest hit is another
    triangle at another ``t``); where it is the same, ``t`` within
    :func:`b7_t_bound`; more than ``min_hits`` of the rays hitting (the
    check is not vacuous).  Prints one line, returns (max abs ``t`` error
    on the same triangle, ok)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    n = n_hit = n_both = hit_agree = idx_agree = n_out = 0
    max_abs = max_rel = max_ratio = 0.0
    for o, d, scn, quirks in calls:
        t, i = B7.triangle_closest(o, d, scn, quirks)
        tp, ip = B7.triangle_closest_plain(o, d, scn, quirks)
        hit, hitp = torch.isfinite(t), torch.isfinite(tp)
        both = hit & hitp
        same = both & (i == ip)
        if same.any():
            err = (t[same] - tp[same]).abs().double()
            lim = b7_t_bound(o[same], d[same], scn, ip[same], tp[same])
            n_out += int((err > lim).sum())
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / tp[same].abs()).max()))
            max_ratio = max(max_ratio, float((err / lim).max()))
        n += int(t.numel())
        n_hit += int(hitp.sum())
        n_both += int(both.sum())
        hit_agree += int((hit == hitp).sum())
        idx_agree += int(same.sum())
    agree_hit = hit_agree / max(n, 1)
    agree_idx = idx_agree / max(n_both, 1)
    ok = (n_out == 0 and agree_hit >= 0.999 and agree_idx >= 0.999
          and n_hit / max(n, 1) > min_hits)
    print(f"  {name}: {len(calls)} calls, {n} rays, hits {n_hit / n:.4f}, "
          f"hit agreement {agree_hit:.6f} ({n - hit_agree} rays differ), "
          f"index agreement {agree_idx:.6f} ({n_both - idx_agree} rays), "
          f"t on the same triangle max_abs {max_abs:.3e} max_rel "
          f"{max_rel:.3e}, at most {max_ratio:.3f} of its bound ({n_out} "
          f"over) {'ok' if ok else 'VIOLATION'}")
    return max_abs, ok


def b7_t_bound(o, d, scn, idx, t):
    """The most two FP32 evaluations of B7's ``t`` may differ by, for rays
    (o, d) on triangles ``idx`` at distance ``t``: the kernel and the
    plain version sum the K = 13 products of ``det`` and ``t*det`` in
    different orders, each within gamma_13 * sum|f_k w_k| of the exact
    sum (u = 2^-24 the unit roundoff, gamma_K = K u / (1 - K u)), and
    ``t = (t*det) * (1/det)`` rounds twice on each side:
    2 gamma_13 (S_tdet + |t| S_det) / |det| + 4 u |t|."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    u = 2.0 ** -24
    gamma = 13 * u / (1 - 13 * u)
    f = B7._features(o, d).double()                       # (m, 13)
    w = B7.weights_on(scn, o.device)[idx].double()       # (m, 4, 16)
    det = (f * w[:, 0, :13]).sum(-1).abs()
    s_det = (f.abs() * w[:, 0, :13].abs()).sum(-1)
    s_tdet = (f.abs() * w[:, 3, :13].abs()).sum(-1)
    t = t.double().abs()
    return 2 * gamma * (s_tdet + t * s_det) / det + 4 * u * t


def recorded_b7_calls(fn) -> list:
    """Runs ``fn()`` with B7's wrapper wrapped so that each call's inputs
    (o, d, scn, quirks) are kept; returns them."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    calls = []
    kernel = B7.triangle_closest

    def recording(o, d, scn, quirks):
        calls.append((o.clone(), d.clone(), scn, quirks))
        return kernel(o, d, scn, quirks)

    B7.triangle_closest = recording
    try:
        fn()
    finally:
        B7.triangle_closest = kernel
    return calls


def phase_tri_closest_vs_plain(card: str) -> dict:
    """B7 on the 512x512 primary rays (sample 0) of the large-mesh scene
    x its 20,736 triangles (also timed), and on every trace of phase 7's
    tier-1 render (bidirectional on the 9-light copy at 256x256x4: camera
    and shadow rays; its film is held there)."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.ops import tri_closest as B7
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    print("B7 tri_closest vs plain:")
    scene = large_mesh_scene()
    scn = prep_scene(scene)
    nt = int(scn.tri_v0.shape[0])
    ii, jj = C.pixel_grid(LW, LH, device="cuda")
    ray_id = (ii + jj * LW).to(torch.int64)
    o, d = primary_rays(make_camera(z_sign=-1.0), ii, jj,
                        *R.randn_draws(make_key(0), ray_id, C.SITE_CAMERA, 4))
    R_ = LW * LH
    err, ok = b7_agreement(f"{R_} primary rays x {nt} triangles",
                           [(o, d, scn, DEFAULT)], min_hits=0.5)
    calls = recorded_b7_calls(lambda: pt.render(
        "bidirectional", nine_lights(scene), BW, BH, spp=TIER1_SPP, seed=0,
        device="cuda"))
    sizes = sorted({int(c[0].shape[0]) for c in calls})
    err2, ok2 = b7_agreement(
        f"the traces of tier-1 bidirectional, 9 lights, {BW}x{BH}x"
        f"{TIER1_SPP} (rays a call: {sizes})", calls, min_hits=0.0)
    del calls
    k_ms = time_ms(lambda: B7.triangle_closest(o, d, scn, DEFAULT), 10)
    p_ms = time_ms(lambda: B7.triangle_closest_plain(o, d, scn, DEFAULT), 1,
                   warm_up=False)
    b_ms, b_by = bound(R_ * nt * B7_PAIR_OPS, R_ * 60 + nt * 256)
    print(f"  {R_} rays x {nt} triangles: kernel {k_ms:.3f} ms, plain "
          f"PyTorch {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}) ({card})")
    if not (ok and ok2):
        raise RuntimeError("B7 kernel vs plain outside its tolerance")
    return {"max_abs": max(err, err2), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_large_mesh_main_paths(card: str) -> dict:
    """trianglegrid (auto) and super on the large meshes (B2/B3); the VLP
    family on large_mesh_scene() at 256x256x16, each render exactly its
    light pass's kernels (L1, or L2a and L2b) and B4's walk, nothing
    else."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.ops import exact_grid as X
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene)
    large = large_mesh_scene()
    stream = large_mesh_scene(512, 256)
    mlt = ("light_mlt_seed", "light_mlt_chain", "mega_vlp")
    paths = [("trianglegrid", large, LW, LH, LSPP_GRID, ("mega_blocked",)),
             ("super", large, LW, LH, LSPP, ("mega_blocked",)),
             ("super", stream, LW, LH, LSPP, ("mega_blocked",)),
             ("bidirectional", large, BW, BH, BSPP,
              ("light_emit", "mega_vlp")),
             ("metropolis", large, BW, BH, BSPP, mlt),
             ("metropolis_vlpgrid", large, BW, BH, BSPP, mlt)]
    total = dict.fromkeys(("mega_blocked", "light_emit", "light_mlt_seed",
                           "light_mlt_chain", "mega_vlp"), 0)
    for variant, scene, w, h, spp, want in paths:
        film, ms, counts = timed_renders(lambda: pt.render(
            variant, scene, w, h, spp=spp, seed=0, device="cuda"))
        # B2/B3 once a render; a VLP render each of its kernels once
        if counts != {k: TIMED_RUNS if k in want else 0 for k in counts}:
            raise RuntimeError(f"{variant} on {scene.n_triangles} "
                               f"triangles: launches {counts} in "
                               f"{TIMED_RUNS} renders, want {want} once "
                               "each, nothing else")
        for k in want:
            total[k] += counts[k]
        f = film.cpu().numpy()
        mean = float(f.mean()) / spp
        if f.shape != (h, w, 3) or not np.isfinite(f).all() or mean <= 0:
            raise RuntimeError(f"{variant}: bad main-path film {f.shape}, "
                               f"mean/spp {mean}")
        mpaths = w * h * spp / (ms / 1e3) / 1e6
        print(f"main path: {variant} {w}x{h}x{spp} on {scene.n_triangles} "
              f"triangles: {ms:.1f} ms/render, {mpaths:.1f} Mpaths/s "
              f"({card}); film mean/spp {mean:.4f}, launches {counts}")
        if want == ("mega_blocked",):
            # the render split: the host preparation a Scene gets once, on
            # its first render (prep_scene, the scene without triangles and
            # the exact grid; timed on fresh copies of the Scene), vs the
            # kernel on the prepared scene
            t0 = time.perf_counter()
            for _ in range(TIMED_RUNS):
                scn = prep_scene(dataclasses.replace(scene))
                M.scene_buffer(scn, "cuda", triangles=False)
                X.exact_grid(scn, "cuda")
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_RUNS
            k_ms = time_ms(lambda: M.film_super_mega(
                make_key(0), scn, w, h, spp, device="cuda"), TIMED_RUNS)
            print(f"  split: first-render host preparation {host_ms:.1f} "
                  f"ms, kernel {k_ms:.2f} ms")
    return total


def recorded_walks(fn) -> list:
    """Runs ``fn()`` with the plain walk wrapped so that each call's inputs
    (o, d, t, m, nx, ny, nz, needs, scn, grid, quirks) and outputs are
    kept; returns them."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    calls = []
    walk = G.traverse_triangles

    def recording(o, d, t, m, nx, ny, nz, needs, scn, grid, quirks,
                  plain=False):
        args = tuple(x.clone() for x in (o, d, t, m, nx, ny, nz, needs))
        out = walk(o, d, t, m, nx, ny, nz, needs, scn, grid, quirks, plain)
        calls.append((args + (scn, grid, quirks), out))
        return out

    G.traverse_triangles = recording
    try:
        fn()
    finally:
        G.traverse_triangles = walk
    return calls


def bits_equal(a, b) -> bool:
    """Bit-equal tensors (a float32 tensor's bits, so -0.0 != 0.0)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a, b)


def walk_differences(calls) -> int:
    """B11w on each recorded plain walk's inputs against its outputs:
    the number of calls whose (t, m, nx, ny, nz, needs) differ in a bit."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    bad = 0
    for (*rays, scn, grid, quirks), want in calls:
        got = G.traverse_triangles(*rays, scn, grid, quirks)
        bad += not all(bits_equal(a, b) for a, b in zip(got, want))
    return bad


def walk_tally(rays, tab, want, quirks=None) -> tuple[dict, bool]:
    """B11w's counting launch on ``rays`` (o, d, t, m, nx, ny, nz, needs):
    (its tally, whether its outputs equal ``want`` bit for bit)."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    stats = torch.zeros(len(G.STAT_NAMES), dtype=torch.int64, device="cuda")
    got = G.grid_walk(*rays, tab, quirks or DEFAULT, stats)
    return (dict(zip(G.STAT_NAMES, stats.tolist())),
            all(bits_equal(a, b) for a, b in zip(got, want)))


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def grid_bound(st: dict, table_bytes: int, io_bytes: int):
    """B11 / B11w's bound over this run's tally: the FP32 operations of
    the tested pairs, the visited cells and the walks' set-up; the bytes
    of the grid's tables once and the inputs and outputs."""
    ops = (st["pairs"] * DIV_PAIR_OPS + st["cells"] * CELL_OPS
           + st["walks"] * WALK_OPS + st["entered"] * ENTER_OPS)
    return bound(ops, table_bytes + io_bytes)


def table_bytes(tab) -> int:
    return sum(int(x.numel()) * x.element_size() for x in (
        tab.grid.items, tab.grid.counts, tab.tri, tab.frame))


def grid_split(st: dict) -> list[str]:
    """Lines reading a B11 / B11w counting launch's tally (ops/grid.py::
    STAT_NAMES): the warp-paid cell steps and SIMT efficiency of camera
    and shadow walks, the warp steps a per-lane schedule across samples
    and walks would pay, the empty cells, and the clock64 split of the
    warps' cycles."""
    cam, sh = st["cam_warp_steps"], st["shadow_warp_steps"]
    lines = [
        f"warp steps: camera {cam}, shadow {sh}; SIMT efficiency (lane "
        f"cells / 32 x warp steps) camera "
        f"{st['cam_cells'] / max(1, 32 * cam):.4f}, shadow "
        f"{st['shadow_cells'] / max(1, 32 * sh):.4f}",
        f"per-lane schedule: {st['sched_all']} warp steps, "
        f"{st['sched_all'] / max(1, cam + sh):.4f} of the lockstep's "
        f"(camera walks alone {st['sched_cam'] / max(1, cam):.4f}, shadow "
        f"walks alone {st['sched_shadow'] / max(1, sh):.4f})",
        f"empty cells {st['empty']} of {st['cells']} visited "
        f"({st['empty'] / max(1, st['cells']) * 100:.2f}%); pair "
        f"iterations {st['warp_pair_iters']}, pair SIMT efficiency "
        f"{st['pairs'] / max(1, 32 * st['warp_pair_iters']):.4f}"]
    names = (("camera+pre_tri", "clk_camera"), ("set-up", "clk_setup"),
             ("empty iterations", "clk_empty"),
             ("occupied: loads", "clk_occ_loads"),
             ("occupied: pairs", "clk_pairs"),
             ("occupied: step", "clk_occ_step"),
             ("shadow set-up", "clk_shadow"), ("shading", "clk_shade"))
    k = max(1, st["clk_kernel"])
    lines.append("clock64 split of the warps' cycles: " + ", ".join(
        f"{n} {st[c] / k * 100:.1f}%" for n, c in names)
        + f" (kernel {st['clk_kernel']} warp-cycles)")
    return lines


def phase_grid_dda(card: str) -> dict:
    """The trianglegrid variant's DDA route on the card (kernels B11 and
    B11w): the main paths ``accel="dda"`` at 512x512x64 on the 20,736 sheet
    and the demo torus (B11 once a render, nothing else), timed with the
    split of host preparation, grid build and kernel, each compared with
    the ``accel="auto"`` film (B2/B3, B1; printed: the DDA's break rule
    makes the sheet's differ) and held on samples 0-7 to the tier-1 DDA
    wavefront (every walk B11w) under the contract; B11's tally, bound
    and read-out (``grid_split``), its counting launch's film bit-equal to
    the kernel's; on rows 248-255 of the sheet (sample 0 of 64) the plain
    DDA film (the eager walk, every call recorded) against B11 and B2/B3
    under the contract, the tier-1 wavefront's band with B11w bit-equal to
    it
    and B11w on every recorded walk's inputs bit-equal to its outputs;
    B11w on the sheet's 512x512 camera rays against the plain walk, bit
    for bit, timed (events and device time) with its tally; the tier-1
    DDA route (a 9-light copy at 256x256x4: B11w only, two launches a
    sample) against the tier-1 super film (B7) under the contract, and
    B11w on its first shadow call's recorded inputs, timed and tallied,
    its counting launch bit-equal to the route's walk."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.models.trianglegrid import (
        film_trianglegrid)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import grid as G
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene)
    key = make_key(0)
    large = large_mesh_scene()
    failed = []
    out = {"launches": 0}
    for name, scene in (("sheet", large), ("demo torus", demo_scene()[0])):
        film, ms, counts = timed_renders(lambda: pt.render(
            "trianglegrid", scene, LW, LH, spp=LSPP_GRID, seed=0,
            accel="dda", device="cuda"))
        if not only(counts, "mega_grid"):
            raise RuntimeError(f"trianglegrid accel=dda on {name}: launches "
                               f"{counts} in {TIMED_RUNS} renders, want "
                               "mega_grid once each, nothing else")
        out["launches"] += counts["mega_grid"]
        f = film.cpu().numpy()
        mean = float(f.mean()) / LSPP_GRID
        if f.shape != (LH, LW, 3) or not np.isfinite(f).all() or mean <= 0:
            raise RuntimeError(f"accel=dda: bad film {f.shape}, mean/spp "
                               f"{mean}")
        # against accel="auto" (B2/B3, B1): printed, not held - where the
        # reference's DDA ends a walk before the ray's hit (its break rule,
        # trianglegrid/pathtracer.ocl:195, with the running t at the
        # floor's distance), the DDA route's film is not the brute-force
        # one (tests/test_torch_grid_walk.py::
        # test_break_rule_ends_a_walk_before_its_hit)
        auto = pt.render("trianglegrid", scene, LW, LH, spp=LSPP_GRID,
                         seed=0, device="cuda")
        _, st = crn_ok(f, auto.cpu().numpy(), LSPP_GRID)
        print(f"  B11 vs accel=auto on {name} ({scene.n_triangles} "
              f"triangles), {LW}x{LH}x{LSPP_GRID}: p99.5 {st['q']:.3e}, "
              f"pixels past 1e-4 {st['tie_frac'] * 100:.3f}%, max_abs_film "
              f"{st['max_abs']:.3e} (not held: the DDA's own semantics)")
        # held: the DDA route's film, against the tier-1 DDA wavefront
        # whose every walk is B11w (bit-equal to the plain walk, below)
        scn = prep_scene(scene)
        tab = G.triangle_tables(scn, device="cuda")
        wave = film_trianglegrid(key, scn, tab.grid, LW, LH, DDA_SPP, 0,
                                 LSPP_GRID, DEFAULT, device="cuda")
        mega = G.film_grid_mega(key, scn, tab, LW, LH, DDA_SPP, 0,
                                LSPP_GRID, device="cuda")
        err = check_crn(f"B11 vs the DDA wavefront (B11w walks) on {name}, "
                        f"{LW}x{LH}, samples 0-{DDA_SPP - 1} of {LSPP_GRID}",
                        mega, wave, DDA_SPP, failed)
        # the split: a fresh Scene's preparation, its grid build (the host
        # sizing and the pair build on the card), the kernel alone
        fresh = []
        t0 = time.perf_counter()
        for _ in range(TIMED_RUNS):
            fresh.append(prep_scene(dataclasses.replace(scene)))
        host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_RUNS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for scn in fresh:
            tab = G.triangle_tables(scn, device="cuda")
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3 / TIMED_RUNS
        k_ms = time_ms(lambda: G.film_grid_mega(
            key, scn, tab, LW, LH, LSPP_GRID, device="cuda"), TIMED_RUNS)
        # the counting launch: its tally and split, and its film bit-equal
        # to the timed kernel's (the lockstep walk is the same walk)
        stats = torch.zeros(len(G.STAT_NAMES), dtype=torch.int64,
                            device="cuda")
        counted, c_ms = timed_call(lambda: G.film_grid_mega(
            key, scn, tab, LW, LH, LSPP_GRID, device="cuda", stats=stats))
        st = dict(zip(G.STAT_NAMES, stats.tolist()))
        if not bits_equal(counted, G.film_grid_mega(
                key, scn, tab, LW, LH, LSPP_GRID, device="cuda")):
            failed.append(f"B11's counting launch's film on {name}")
        b_ms, b_by = grid_bound(st, table_bytes(tab), LW * LH * 12)
        mpaths = LW * LH * LSPP_GRID / (ms / 1e3) / 1e6
        print(f"main path: trianglegrid accel=dda {LW}x{LH}x{LSPP_GRID} on "
              f"{name}: {ms:.1f} ms/render, {mpaths:.1f} Mpaths/s ({card}); "
              f"film mean/spp {mean:.4f}, launches {counts}")
        print(f"  split: first-render host preparation {host_ms:.1f} ms, "
              f"grid build {build_ms:.1f} ms (grid {tab.grid.res}, cap "
              f"{tab.grid.items.shape[1]}), kernel {k_ms:.2f} ms")
        print(f"  B11 tally: {st}; {st['pairs'] / max(1, st['walks']):.1f} "
              f"pairs and {st['cells'] / max(1, st['walks']):.1f} cells a "
              f"walk; bound {b_ms:.4f} ms ({b_by}), {b_ms / k_ms * 100:.1f}% "
              f"of the kernel's time; the counting launch {c_ms:.2f} ms")
        for line in grid_split(st):
            print(f"  B11 {name}: {line}")
        if name == "sheet":
            out.update(ms=k_ms, bound_ms=b_ms, bound_by=b_by, max_abs=err,
                       scn=scn, tab=tab)

    # the plain DDA on a band of the sheet: the eager walk, recorded
    scn, tab = out.pop("scn"), out.pop("tab")
    band = dict(row_offset=248, rows=8)
    plain = {}

    def run_plain():
        plain["film"], plain["ms"] = timed_call(lambda: film_trianglegrid(
            key, scn, tab.grid, LW, LH, 1, 0, LSPP_GRID, DEFAULT,
            device="cuda", plain=True, **band))
    calls = recorded_walks(run_plain)
    reset_counts()
    mega_band = G.film_grid_mega(key, scn, tab, LW, LH, 1, 0, LSPP_GRID,
                                 device="cuda", **band)
    wave_band = film_trianglegrid(key, scn, tab.grid, LW, LH, 1, 0,
                                  LSPP_GRID, DEFAULT, device="cuda", **band)
    blocked = M.film_super_mega(key, scn, LW, LH, 1, spp_total=LSPP_GRID,
                                device="cuda", **band)
    torch.cuda.synchronize()
    bc = {k: v for k, v in read_counts().items() if v}
    if bc != {"mega_grid": 1, "grid_walk": 2, "mega_blocked": 1}:
        raise RuntimeError(f"the band's launches {bc}")
    tag = (f"{LW}x{LH} rows 248-255, sample 0 of {LSPP_GRID} (grid "
           f"{tab.grid.res}, cap {tab.grid.items.shape[1]}; plain DDA "
           f"{plain['ms'] / 1e3:.1f} s)")
    out["max_abs"] = max(out["max_abs"], check_crn(
        f"B11 vs the plain DDA, {tag}", mega_band, plain["film"], 1, failed))
    check_crn(f"B2/B3 vs the plain DDA, {tag}", blocked, plain["film"], 1,
              failed)
    bad = walk_differences(calls)
    same = bits_equal(wave_band, plain["film"])
    print(f"  B11w on the band's {len(calls)} recorded plain walks: "
          f"{len(calls) - bad} bit-equal; the tier-1 wavefront's band "
          f"(B11w) {'bit-equal' if same else 'DIFFERS'} to the plain film")
    if bad or not same:
        failed.append("B11w vs the plain walk on the band")
    out["plain_ms"] = plain["ms"]

    # B11w on the sheet's 512x512 camera rays (sample 0 of 64)
    ii, jj = C.pixel_grid(LW, LH, device="cuda")
    ray_id = (jj * LW + ii).to(torch.int64) * LSPP_GRID
    o, d = primary_rays(make_camera(z_sign=-1.0), ii, jj,
                        *R.randn_draws(key, ray_id, C.SITE_CAMERA, 4))
    n = o.shape[0]
    t = torch.full((n,), 1e9, dtype=torch.float32, device="cuda")
    m = torch.zeros(n, dtype=torch.int32, device="cuda")
    z = torch.zeros(n, dtype=torch.float32, device="cuda")
    needs = torch.zeros(n, dtype=torch.bool, device="cuda")
    args = (o, d, t, m, z, z, z, needs)
    w_ms = time_ms(lambda: G.grid_walk(*args, tab, DEFAULT), 10)
    w_dev, _ = device_ms(lambda: G.grid_walk(*args, tab, DEFAULT), 10,
                         "grid_walk_kernel")
    got = G.grid_walk(*args, tab, DEFAULT)
    want, wp_ms = timed_call(lambda: G.traverse_triangles(
        *args, scn, tab.grid, DEFAULT, plain=True))
    same = all(bits_equal(a, b) for a, b in zip(got, want))
    w_err = max_abs(got[0], want[0])
    wst, counted_same = walk_tally(args, tab, got)
    wb_ms, wb_by = grid_bound(wst, table_bytes(tab), n * (24 + 2 * 21))
    print(f"  B11w on the sheet's {n} camera rays: {w_ms:.3f} ms on events, "
          f"device {fmt_ms(w_dev)} ms a call, plain PyTorch {wp_ms:.1f} ms, "
          f"{'bit-equal' if same else 'DIFFERS'}; tally {wst}; bound "
          f"{wb_ms:.4f} ms ({wb_by}) ({card})")
    for line in grid_split(wst):
        print(f"  B11w camera rays: {line}")
    if not same:
        failed.append("B11w vs the plain walk on the camera rays")
    if not counted_same:
        failed.append("B11w's counting launch on the camera rays")

    # the tier-1 DDA route: outside the super kernels' gate, B11w only
    nine = nine_lights(large)
    w, h, spp = BW, BH, TIER1_SPP
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    film = pt.render("trianglegrid", nine, w, h, spp=spp, seed=0,
                     accel="dda", device="cuda")
    torch.cuda.synchronize()
    t_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    # B11w on the route's first shadow call (sample 0: every light's rays
    # in one call, light-major: a warp's 32 rays are 32 pixels of one row
    # and one light), timed and tallied on its recorded inputs
    calls = recorded_walks(lambda: pt.render(
        "trianglegrid", nine, w, h, spp=1, seed=0, accel="dda",
        device="cuda"))
    (*rays, wscn, wgrid, quirks), want = calls[1]
    ntab = G.walk_tables(wscn, wgrid, "cuda")
    s_ms = time_ms(lambda: G.grid_walk(*rays, ntab, quirks), 10)
    s_dev, _ = device_ms(lambda: G.grid_walk(*rays, ntab, quirks), 10,
                         "grid_walk_kernel")
    sst, s_same = walk_tally(rays, ntab, want, quirks)
    print(f"  B11w on the tier-1 route's shadow call ({rays[0].shape[0]} "
          f"rays, {int(nine.lights.shape[0])} lights x {w}x{h}): "
          f"{s_ms:.3f} ms on events, device {fmt_ms(s_dev)} ms a call; "
          f"{'bit-equal' if s_same else 'DIFFERS'} to the route's walk; "
          f"tally {sst} ({card})")
    for line in grid_split(sst):
        print(f"  B11w shadow call: {line}")
    if not s_same:
        failed.append("B11w's counting launch on the tier-1 shadow call")
    launched = {k: v for k, v in counts.items() if v}
    if launched != {"grid_walk": 2 * spp}:
        raise RuntimeError(f"tier-1 DDA route (9 lights): launches {counts}")
    b7 = pt.render("super", nine, w, h, spp=spp, seed=0, device="cuda")
    check_crn(f"tier-1 trianglegrid accel=dda (B11w), 9 lights, {w}x{h}x"
              f"{spp} vs tier-1 super (B7)", film, b7, spp, failed)
    print(f"tier-1 DDA route: {t_ms:.1f} ms ({card}), launches {launched}")
    out["walk"] = {"launches": counts["grid_walk"], "max_abs": w_err,
                   "ms": w_ms, "plain_ms": wp_ms, "bound_ms": wb_ms,
                   "bound_by": wb_by}
    if failed:
        raise RuntimeError(f"the DDA route: {failed}")
    return out


def display_diff(a, b, spp) -> np.ndarray:
    """Per-pixel max-channel difference of two films on the CRN contract's
    display scale (utils/crn.py)."""
    d = np.abs(a.cpu().numpy().astype(np.float64)
               - b.cpu().numpy().astype(np.float64))
    return (d / spp * 64.0 / 255.0).max(axis=-1)


def simple_counts(key, w, h, spp, spp_total, max_bounces=5) -> dict:
    """B5's work over samples 0..spp-1 of a w x h simple film, from the
    plain trace on the card: per bounce the live rays traced, their floor
    and sphere hits, sky misses, the shadow rays cast (lamb >= 0) and the
    sphere tests those make up to their first hit (the floor first, as the
    kernel's any-hit stops); and the sphere tests that the kernel's cull
    lets through for each ray's own test (:func:`SphereCull`), on the
    traces and on the shadow rays."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core import rng as R
    from opencl_montecarlo_path_tracing_tpu_torch.core.camera import (
        make_camera, primary_rays)
    from opencl_montecarlo_path_tracing_tpu_torch.models import common as C
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        simple_arrays)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        trace_ray)
    scn = simple_arrays()
    ii, jj = C.pixel_grid(w, h, device="cuda")
    pix = (jj * w + ii).to(torch.int64)
    cam = make_camera(z_sign=-1.0)
    keys = ("live", "floor", "mirror", "sky", "cast", "shadow_tests",
            "cull_trace_tests", "cull_shadow_tests")
    n = {k: [0] * max_bounces for k in keys}
    eps, big = float(np.float32(0.01)), float(np.float32(1e9))
    cull = SphereCull(scn.sphere_centers)
    for s in range(spp):
        ray_id = (pix * spp_total + s) & 0xFFFFFFFF
        o, d = primary_rays(cam, ii, jj,
                            *R.randn_draws(key, ray_id, C.SITE_CAMERA, 4))
        alive = torch.ones_like(ii, dtype=torch.bool)
        for b in range(max_bounces):
            tr = trace_ray(o, d, scn, sphere_material=2, plain=True)
            n["cull_trace_tests"][b] += cull.trace_tests(o, d, alive)
            m = torch.where(alive, tr.material, -1)
            x = o + d * tr.t[..., None]
            u1, u2 = R.rand2(key, ray_id, C.SITE_LIGHT0
                             + b * C.SITE_STRIDE_BOUNCE)
            ldir = C.normalize(torch.stack(
                [9.0 + u1, 9.0 + u2, torch.full_like(u1, 16.0)], -1) - x)
            hit = (m == 1) | (m == 2)
            cast = hit & (C.dot(ldir, tr.normal) >= 0)
            ox, oy, oz = x.unbind(-1)
            dx, dy, dz = ldir.unbind(-1)
            p = -oz * (1.0 / dz)
            still = cast & ~((p > eps) & (p < big))
            tests = torch.zeros_like(ray_id)
            for cx, cy, cz in scn.sphere_centers:
                tests += still
                px, py, pz = ox - float(cx), oy - float(cy), oz - float(cz)
                bb = px * dx + py * dy + pz * dz
                q = bb * bb - (px * px + py * py + pz * pz - 1.0)
                sr = -bb - torch.sqrt(torch.clamp_min(q, 0.0))
                still = still & ~((q > 0.0) & (sr < big) & (sr > eps))
            for k, v in (("live", alive), ("floor", m == 1),
                         ("mirror", m == 2), ("sky", m == 0),
                         ("cast", cast)):
                n[k][b] += int(v.sum())
            n["shadow_tests"][b] += int(tests.sum())
            n["cull_shadow_tests"][b] += cull.shadow_tests(
                x, ldir, cast & ~((p > eps) & (p < big)))
            bounce = m == 2
            o = torch.where(bounce[..., None], x, o)
            d = torch.where(bounce[..., None], C.reflect(d, tr.normal), d)
            alive = alive & bounce
    return n


class SphereCull:
    """A torch twin, on the card, of B5's per-ray cull
    (``csrc/mega_simple.cu``: ``make_cull``, ``group_need``, over
    ``ops/mega_simple.py::sphere_groups``), counting the sphere tests it
    lets through for each ray's own test - not its warp's."""

    def __init__(self, centers, device="cuda"):
        import torch
        from opencl_montecarlo_path_tracing_tpu_torch.ops.mega_simple import (
            sphere_groups)
        recs = sphere_groups(centers)
        self.first = recs[:, 3].view(np.int32).tolist()
        self.count = recs[:, 7].view(np.int32).tolist()
        self.recs = torch.from_numpy(recs).to(device)
        self.c = torch.from_numpy(np.asarray(centers, np.float32)).to(device)
        lo, hi = self.recs[0, 0:3], self.recs[0, 4:7]
        e = hi - lo
        self.mid = 0.5 * (lo + hi)
        self.half = 0.5 * torch.sqrt(e[0] * e[0] + e[1] * e[1]
                                     + e[2] * e[2]) * 1.001

    def _pad(self, o):
        import torch
        q = o - self.mid
        P = torch.sqrt((q * q).sum(-1)) + self.half
        return (torch.sqrt(1.0 + 2e-6 * (P * P + 1.0)) - 1.0) + 0.01 + 1e-5 * P

    def _need(self, g, o, inv, pad, t):
        import torch
        lo = self.recs[g, 0:3] - pad[..., None]
        hi = self.recs[g, 4:7] + pad[..., None]
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        nan = torch.isnan(t0) | torch.isnan(t1)
        tn = torch.where(nan, -np.inf, torch.minimum(t0, t1)).amax(-1)
        tf = torch.where(nan, np.inf, torch.maximum(t0, t1)).amin(-1)
        return (tf >= tn) & (tf >= 0.0) & (tn.clamp_min(0.0) <= t * 1.001)

    def _roots(self, k, o, d):
        import torch
        p = o - self.c[k]
        b = (p * d).sum(-1)
        q = b * b - ((p * p).sum(-1) - 1.0)
        return q > 0.0, -b - torch.sqrt(q.clamp_min(0.0))

    def trace_tests(self, o, d, active) -> int:
        """Sphere tests of the closest-hit traces of the ``active`` rays,
        the running t seeded by the floor."""
        import torch
        eps, big = float(np.float32(0.01)), float(np.float32(1e9))
        inv, pad = 1.0 / d, self._pad(o)
        p = -o[..., 2] * (1.0 / d[..., 2])
        t = torch.where((p > eps) & (p < big), p, big)
        in_card = active & self._need(0, o, inv, pad, t)
        tests = torch.zeros_like(t, dtype=torch.int64)
        for g in range(1, len(self.count)):
            tests += (in_card & self._need(g, o, inv, pad, t)) * self.count[g]
            for k in range(self.first[g], self.first[g] + self.count[g]):
                q, s = self._roots(k, o, d)
                t = torch.where(q & (s < t) & (s > eps), s, t)
        return int(tests.sum())

    def shadow_tests(self, o, d, open_) -> int:
        """Sphere tests of the uncapped any-hit rays that are ``open_``
        after the floor, each up to its first hit."""
        import torch
        eps, big = float(np.float32(0.01)), float(np.float32(1e9))
        inv, pad = 1.0 / d, self._pad(o)
        open_ = open_ & self._need(0, o, inv, pad, big)
        tests = torch.zeros(open_.shape, dtype=torch.int64, device=o.device)
        for g in range(1, len(self.count)):
            still = open_ & self._need(g, o, inv, pad, big)
            for k in range(self.first[g], self.first[g] + self.count[g]):
                tests += still
                q, s = self._roots(k, o, d)
                hit = still & q & (s < big) & (s > eps)
                open_ = open_ & ~hit
                still = still & ~hit
        return int(tests.sum())


def simple_ops(n: dict, rays: int, ns: int, culled: bool = False) -> int:
    """B5's FP32 operations for the counts of :func:`simple_counts`: every
    sphere for a live ray's trace and the shadow tests in index order (the
    yardstick), or with ``culled`` the sphere tests the cull lets through
    (box tests not counted)."""
    ops = rays * CAMERA_OPS
    for b in range(len(n["live"])):
        hits = n["floor"][b] + n["mirror"][b]
        trace = n["cull_trace_tests"][b] if culled else n["live"][b] * ns
        shadow = n["cull_shadow_tests" if culled else "shadow_tests"][b]
        ops += (n["live"][b] * FLOOR_OPS + trace * SPHERE_OPS
                + n["mirror"][b] * (RENORM_OPS + MIRROR_OPS)
                + hits * HIT_OPS + n["floor"][b] * FLOOR_SHADE_OPS
                + n["sky"][b] * SKY_OPS + n["cast"][b] * FLOOR_OPS
                + shadow * SPHERE_OPS)
    return ops


def phase_simple_kernel_vs_plain(gt, card: str) -> dict:
    """B5 on the GPU tests' cases (at 5, 0 and 1 bounces) and on the simple
    main path's full frame, samples 0-1 of 256; the full frame's tie
    pixels localised by bounce, and the ties against the NumPy oracle; the
    kernel and plain times and the bound at that shape."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.simple import (
        simple_arrays)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import SIMPLE
    print("B5 mega_simple vs plain:")
    # what torch.rsqrt runs on a CUDA tensor, against 1/sqrt, near the
    # squared lengths the sphere normals renormalise (the kernel uses rsqrtf)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = 1.0 + (torch.rand(1 << 20, device="cuda", generator=g) - 0.5) * 1e-3
    same = float((torch.rsqrt(x) == 1.0 / torch.sqrt(x)).float().mean())
    print(f"  torch.rsqrt == 1/sqrt on {same * 100:.3f}% of 2^20 inputs "
          "near 1")
    scn = simple_arrays()
    worst, failed = 0.0, []
    for name, seed, (w, h, spp), kw, q in gt.SIMPLE_CASES:
        for bounces in (5, 0, 1):
            a = M5.film_simple_mega((seed, 0), scn, w, h, spp,
                                    quirks=gt.QUIRKS[q], max_bounces=bounces,
                                    device="cuda", **kw)
            b = M5.film_simple_mega_plain((seed, 0), scn, w, h, spp,
                                          quirks=gt.QUIRKS[q],
                                          max_bounces=bounces,
                                          device="cuda", **kw)
            worst = max(worst, check_crn(
                f"{name}, max_bounces {bounces}", a, b, spp, failed,
                atol=gt.SIMPLE_ATOL, contract=SIMPLE))
            bit_equal(f"{name}, max_bounces {bounces}", a, b, failed)
    key = make_key(0)
    frame = dict(spp_total=SSPP)
    a = M5.film_simple_mega(key, scn, SW, SH, 2, device="cuda", **frame)
    b = M5.film_simple_mega_plain(key, scn, SW, SH, 2, device="cuda", **frame)
    worst = max(worst, check_crn(
        f"{SW}x{SH}, samples 0-1 of {SSPP}", a, b, 2, failed,
        atol=gt.SIMPLE_ATOL, contract=SIMPLE))
    bit_equal(f"{SW}x{SH}, samples 0-1 of {SSPP}", a, b, failed)
    if failed:
        raise RuntimeError(f"B5 kernel vs plain contract violated: {failed}")
    # tie localisation: the band of the tie pixels again at max_bounces
    # 1..5; for each tie pixel, the first bounce count at which the two
    # films differ beyond rounding, and at which they differ by a tie
    ties = np.argwhere(display_diff(a, b, 2) > SIMPLE.tie_thresh)
    if len(ties):
        r0, r1 = int(ties[:, 0].min()), int(ties[:, 0].max()) + 1
        diffs = []
        for bounces in range(1, 6):
            band = dict(frame, row_offset=r0, rows=r1 - r0,
                        max_bounces=bounces)
            diffs.append(display_diff(
                M5.film_simple_mega(key, scn, SW, SH, 2, device="cuda",
                                    **band),
                M5.film_simple_mega_plain(key, scn, SW, SH, 2,
                                          device="cuda", **band), 2))
        beyond, tie = first_difference(
            diffs, [(int(r), int(c)) for r, c in ties], r0)
        print(f"  {len(ties)} tie pixels of the frame; first bounce beyond "
              f"rounding: {beyond}; first bounce at a tie: {tie}")
    else:
        print("  no tie pixel in the full frame")
    oracle_ties(scn)
    k_ms = time_ms(lambda: M5.film_simple_mega(key, scn, SW, SH, 2,
                                               device="cuda", **frame), 10)
    k1_ms = time_ms(lambda: M5.film_simple_mega(
        key, scn, SW, SH, 2, max_bounces=1, device="cuda", **frame), 10)
    p_ms = time_ms(lambda: M5.film_simple_mega_plain(
        key, scn, SW, SH, 2, device="cuda", **frame), 2)
    n = simple_counts(key, SW, SH, 2, SSPP)
    ns = int(scn.sphere_centers.shape[0])
    b_ms, b_by = bound(simple_ops(n, SW * SH * 2, ns), SW * SH * 12 + ns * 12)
    r_ms, _ = bound(simple_ops(n, SW * SH * 2, ns, culled=True),
                    SW * SH * 12 + ns * 12)
    rays = SW * SH * 2
    live = ", ".join(f"{v / rays:.4f}" for v in n["live"])
    print(f"  live fraction at bounces 1-5: {live}; shadow rays cast "
          f"{sum(n['cast']) / rays:.4f} a sample, "
          f"{sum(n['shadow_tests']) / max(sum(n['cast']), 1):.1f} sphere "
          "tests each in index order; after the cull, for each ray's own "
          f"test: {sum(n['cull_trace_tests']) / max(sum(n['live']), 1):.2f} "
          f"a trace (of {ns}), "
          f"{sum(n['cull_shadow_tests']) / max(sum(n['cast']), 1):.2f} a "
          "shadow ray")
    print(f"  {SW}x{SH}x2: kernel {k_ms:.3f} ms (at max_bounces 1: "
          f"{k1_ms:.3f} ms, so bounces 2-5 take "
          f"{100 * (k_ms - k1_ms) / k_ms:.1f}%), plain PyTorch {p_ms:.1f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}; restated over the sphere tests "
          f"the cull lets through {r_ms:.4f} ms, {100 * r_ms / k_ms:.1f}% "
          f"of the kernel's time) ({card})")
    return {"max_abs": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def bit_equal(name, a, b, failed):
    """B5 and its plain version run the same float operations in the same
    order, none contracted: their films must be equal bit for bit."""
    import torch
    if not torch.equal(a, b):
        print(f"  {name}: NOT bit-equal")
        failed.append(f"{name} (bit-equal)")


def first_difference(diffs, ties, r0) -> tuple[dict, dict]:
    """Histograms over the ``ties`` pixels (rows from ``r0``) of the first
    bounce count at which a film pair differs beyond rounding (1e-5 on the
    display scale) and by a tie (> 1e-4); ``diffs`` holds the pair's
    :func:`display_diff` at bounce counts 1, 2, ..."""
    import collections
    first = ({}, {})
    for bounces, dd in enumerate(diffs, start=1):
        for r, c in ties:
            for k, lim in enumerate((1e-5, 1e-4)):
                if (r, c) not in first[k] and dd[r - r0, c] > lim:
                    first[k][(r, c)] = bounces
    return tuple(dict(sorted(collections.Counter(
        f.get((int(r), int(c)), "none") for r, c in ties).items(), key=str))
        for f in first)


def oracle_ties(scn):
    """B5 against the NumPy oracle (the reference's CPU tracer, on the same
    threefry streams) on the sphere-field band of the 512-wide frame at 2
    spp: the simple family's tie class against its reference, localised
    by re-rendering both at max_bounces (max_depth) 1..5."""
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.oracle import (
        render_oracle)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_simple as M5
    import torch
    key, w, r0, rows, spp = make_key(9), 512, 160, 96, 2
    diffs = []
    for bounces in range(1, 6):
        k = M5.film_simple_mega(key, scn, w, r0 + rows, spp, row_offset=r0,
                                rows=rows, max_bounces=bounces, device="cuda")
        o = torch.from_numpy(render_oracle(w, rows, spp=spp, key=key,
                                           max_depth=bounces, row_offset=r0))
        diffs.append(display_diff(k, o, spp))
        d = diffs[-1]
        print(f"  vs NumPy oracle, {w}x{rows} band rows {r0}-{r0 + rows - 1}"
              f" x{spp}, max_bounces {bounces}: p95 "
              f"{float(np.quantile(d, 0.95)):.3e}, "
              f"{(d > 1e-5).mean() * 100:.3f}% > 1e-5, "
              f"{(d > 1e-4).mean() * 100:.3f}% tie, max {float(d.max()):.3e}")
    ties = [(int(r) + r0, int(c)) for r, c in np.argwhere(diffs[-1] > 1e-4)]
    beyond, tie = first_difference(diffs, ties, r0)
    print(f"  {len(ties)} oracle tie pixels at 5 bounces; first bounce beyond "
          f"rounding: {beyond}; first bounce at a tie: {tie}")
    if float(np.quantile(diffs[-1], 0.95)) >= 1e-5:
        raise RuntimeError("B5 vs the NumPy oracle: p95 past 1e-5 "
                           "(tests/test_crn.py's contract)")


def timed_renders(fn):
    """(last output, ms per call, launch counts) of TIMED_RUNS calls of
    ``fn`` after a warm-up, counts set to 0 just before them."""
    import torch
    fn()
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_RUNS):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    return out, start.elapsed_time(end) / TIMED_RUNS, counts


def only(counts: dict, name: str) -> bool:
    """Whether ``name`` launched once a render and no other kernel did."""
    return counts[name] == TIMED_RUNS and not any(
        v for k, v in counts.items() if k != name)


def phase_simple_main_path(card: str) -> dict:
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.ops.reduce import (
        quantize_film)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import (
        ImgInfo, load_pam, save_pam)
    film, ms, counts = timed_renders(lambda: pt.render(
        "simple", None, SW, SH, spp=SSPP, seed=0, device="cuda"))
    if not only(counts, "mega_simple"):
        raise RuntimeError(f"simple main path: launches {counts} in "
                           f"{TIMED_RUNS} renders (want B5 once each)")
    f = film.cpu().numpy()
    mean = float(f.mean()) / SSPP
    if f.shape != (SH, SW, 3) or not np.isfinite(f).all() \
            or not 0.0 < mean < 50.0:
        raise RuntimeError(f"bad simple film: shape {f.shape}, mean/spp "
                           f"{mean}")
    mpaths = SW * SH * SSPP / (ms / 1e3) / 1e6
    print(f"main path: simple {SW}x{SH}x{SSPP}: {ms:.2f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); film mean/spp {mean:.4f}, "
          f"launches {counts}")
    rgba = quantize_film(film).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.ppm")
        save_pam(out, ImgInfo(width=SW, height=SH, channels=4, data=rgba))
        if not np.array_equal(load_pam(out).data, rgba):
            raise RuntimeError("simple result.ppm does not read back")
    return {"launches": counts["mega_simple"], "render_ms": ms,
            "mpaths": mpaths}


def phase_nodof_main_path(card: str) -> dict:
    """nodof through B1 (once a render), held against the tier-1 sample
    buffer of the same render, reduced on the card."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models.sample_parallel \
        import render_sample_parallel
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene)
    scene, tag = demo_scene()
    spp = NSG * NSG
    img, ms, counts = timed_renders(lambda: pt.render(
        "nodof", scene, NW, NH, spp=spp, seed=0, device="cuda"))
    if not only(counts, "mega_super"):
        raise RuntimeError(f"nodof main path: launches {counts} in "
                           f"{TIMED_RUNS} renders (want B1 once each)")
    mpaths = NW * NH * spp / (ms / 1e3) / 1e6
    torch.cuda.reset_peak_memory_stats()
    (ref, buf), buf_ms = timed_call(lambda: render_sample_parallel(
        make_key(0), scene, NW, NH, NSG, return_samples=True,
        device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if img.shape != (NH, NW, 4) or img.dtype != np.uint8 \
            or tuple(buf.shape) != (NH * NSG, NW * NSG, 3) \
            or not bool(torch.isfinite(buf).all()):
        raise RuntimeError(f"nodof: bad image {img.shape} or buffer "
                           f"{tuple(buf.shape)}")
    d = np.abs(img.astype(np.int32) - ref.cpu().numpy().astype(np.int32))
    exact = float((d == 0).mean())
    ok = int(d.max()) <= 1 and exact >= 0.99
    print(f"main path: nodof {NW}x{NH}x{spp} on {tag}: {ms:.2f} ms/render, "
          f"{mpaths:.1f} Mpaths/s ({card}); launches {counts}")
    print(f"  vs the tier-1 sample buffer ({NH * NSG}x{NW * NSG} rays, "
          f"{buf_ms:.1f} ms, peak {peak:.1f} GiB): max step {int(d.max())},"
          f" {exact * 100:.3f}% exact {'ok' if ok else 'VIOLATION'}")
    if not ok:
        raise RuntimeError("nodof B1 image vs sample-buffer image differ")
    return {"launches": counts["mega_super"], "render_ms": ms,
            "mpaths": mpaths}


def sm_clock_hz(query: str = "clocks.max.sm") -> float:
    """The SM clock nvidia-smi reads: its maximum, or ``clocks.sm`` now."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0]) * 1e6


def latency_bound(chain_ops: float) -> tuple[float, str]:
    """(bound_ms, "operations") of a dependent chain of FP32 operations."""
    return chain_ops * FP32_CHAIN_CYCLES / sm_clock_hz() * 1e3, "operations"


def max_abs(a, b) -> float:
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def loop_chain_ops(arm: str, n1: int, n2: int) -> int:
    """FP32 operations in the dependent chain of one B8-loops call (the
    yardstick bound's count)."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L
    steps = L.STEPS.get(arm)
    if steps:
        return 2 * steps * n1 * max(1, n2)
    return LOOP_CHAIN_OPS[arm] * n1


def loop_bound_cycles(arm: str, n1: int, n2: int) -> int:
    """The restated bound of one B8-loops call, in SM cycles: the FP32
    chain plus the links of LOOP_LINK_CYCLES, one an iteration."""
    return (loop_chain_ops(arm, n1, n2) * FP32_CHAIN_CYCLES
            + LOOP_LINK_CYCLES.get(arm, 0) * n1)


def loop_bounds(counts: dict) -> tuple[dict, float]:
    """({arm: restated bound ms}, yardstick bound ms summed) of the 13 arms
    at ``counts`` ({arm: (n1, n2)}), at the SM's maximum clock."""
    hz = sm_clock_hz()
    per = {a: loop_bound_cycles(a, *counts[a]) / hz * 1e3 for a in counts}
    return per, latency_bound(sum(loop_chain_ops(a, *counts[a])
                                  for a in counts))[0]


def device_or_events(fn, runs: int, kernel: str, events: float) -> float:
    """Device ms a launch of ``kernel`` (device_ms over launches of the
    same work), or ``events`` with a note when no trace holds such."""
    dev, _ = device_ms(fn, runs, kernel, same_work=True)
    if dev is None:
        print(f"  (no trace of agreeing {kernel} launches: events stand in)")
        return events
    return dev


def phase_diag_loops(card: str) -> dict:
    """B8-loops: each of the 13 arms against its plain version at 1/100 of
    the JAX tool's trip counts (a random start and table; bit-equal), both
    timed there (the kernels line's row: the kernel's device time a launch,
    summed over the arms; events beside), the reduce arms on the reduce
    probe (bit-equal, each output showing its group's max), then the
    tool's run at its own counts (ns an iteration), counts set to 0 just
    before it, and each arm's device time there against the restated
    bound."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_loops as L
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_loops as TL)
    print("B8 diag_loops vs plain:")
    rng = np.random.RandomState(7)
    x, acc0 = (torch.from_numpy(rng.rand(8, 128).astype(np.float32))
               .cuda() for _ in range(2))
    table = torch.from_numpy(rng.rand(*L.TABLE_SHAPE).astype(np.float32)
                             ).cuda()
    worst, failed, k_ms, e_ms, p_ms = 0.0, [], 0.0, 0.0, 0.0
    small = {a: (max(1, n1 // 100), n2) for a, (n1, n2) in TL.COUNTS.items()}
    for arm in L.ARMS:
        n1, n2 = small[arm]
        fn = lambda: L.run(arm, x, n1, n2, acc0, table)
        k = fn()
        ev = time_ms(fn, 5)
        e_ms += ev
        k_ms += device_or_events(fn, 5, "loops_", ev)
        p, ms = timed_call(lambda: L.run_plain(arm, x, n1, n2, acc0, table))
        p_ms += ms
        worst = max(worst, max_abs(k, p))
        if not torch.equal(k, p):
            failed.append(arm)
    # the reduce probe: every group's max distinct and shown in every
    # output (tools/diag_loops.py::reduce_probe)
    for arm in TL.REDUCE_AXIS:
        for shift in TL.PROBE_SHIFTS:
            px, pacc = (torch.from_numpy(a).cuda()
                        for a in TL.reduce_probe(shift))
            k = L.run(arm, px, 64, 0, pacc)
            if not torch.equal(k, L.run_plain(arm, px, 64, 0, pacc)) or \
                    not TL.probe_decodes(arm, k.cpu(), px.cpu(), pacc.cpu(),
                                         64):
                failed.append(f"{arm} probe shift {shift}")
    verdict = ("bit-equal, every output names its group's max"
               if not failed else f"FAILED: {failed}")
    print(f"  reduce probe (3 arms x {len(TL.PROBE_SHIFTS)} shifts, 64 "
          f"iterations): {verdict}")
    per, y_ms = loop_bounds(small)
    b_ms = sum(per.values())
    print(f"  13 arms at 1/100 of the tool's counts: kernel {k_ms:.4f} ms "
          f"device ({e_ms:.4f} ms events), plain PyTorch {p_ms:.1f} ms, "
          f"bound {b_ms:.4f} ms restated (yardstick {y_ms:.4f} ms: the FP32 "
          f"chain alone, x {FP32_CHAIN_CYCLES} cycles at "
          f"{sm_clock_hz() / 1e6:.0f} MHz); max abs {worst:.3e}, "
          f"{'bit-equal' if not failed else f'DIFFER: {failed}'} ({card})")
    if failed:
        raise RuntimeError(f"B8-loops kernel vs plain differ: {failed}")
    print("  the tool's run (best of 5, ns an iteration):")
    reset_counts()
    res = TL.run_arms("cuda")
    counts = read_counts()
    now = sm_clock_hz("clocks.sm")
    print(f"  SM clock just after the run: {now / 1e6:.0f} MHz (max "
          f"{sm_clock_hz() / 1e6:.0f})")
    if counts["diag_loops"] != 13 * (1 + TL.REPEATS) or any(
            v for k, v in counts.items() if k != "diag_loops"):
        raise RuntimeError(f"diag_loops run: launches {counts}")
    # the four arms that run the same 25,600-step chain from zero agree
    same = [res[a][0] for a in ("flat1", "chunk32", "chunk128", "nested")]
    if not all(torch.equal(same[0], o) for o in same[1:]) or not all(
            bool(torch.isfinite(o).all()) for o, _, _ in res.values()):
        raise RuntimeError("B8-loops at the tool's counts: the 25,600-step "
                           "chains disagree or an output is not finite")
    per, y_ms = loop_bounds(TL.COUNTS)
    zero = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    ztable = torch.zeros(L.TABLE_SHAPE, dtype=torch.float32, device="cuda")
    hz, dev = sm_clock_hz(), {}
    print("  the tool's counts, device ms a launch against the restated "
          "bound:")
    for arm in L.ARMS:
        n1, n2 = TL.COUNTS[arm]
        dev[arm] = device_or_events(
            lambda: L.run(arm, zero, n1, n2, zero, ztable), 3, "loops_",
            res[arm][1])
        it = TL.iterations(arm, n1, n2)
        print(f"    {arm}: {dev[arm]:.4f} ms, {dev[arm] * 1e-3 * hz / it:.2f} "
              f"cycles an iteration at {hz / 1e6:.0f} MHz; bound "
              f"{per[arm]:.4f} ms, {100 * per[arm] / dev[arm]:.1f}%")
    f_ms, f_bound = sum(dev.values()), sum(per.values())
    print(f"  13 arms at the tool's counts: kernel {f_ms:.3f} ms device "
          f"({sum(ms for _, ms, _ in res.values()):.3f} ms events, best of "
          f"5), bound {f_bound:.4f} ms restated ({100 * f_bound / f_ms:.1f}%;"
          f" yardstick {y_ms:.4f} ms); the 25,600-step chains agree bit for "
          f"bit ({card})")
    return {"launches": counts["diag_loops"], "max_abs": worst, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": "operations"}


def phase_diag_primitives(card: str) -> dict:
    """B8-prim: the tool's run at NB = 128, REPS = 200 (counts set to 0
    just before), each arm then held against its plain version on the same
    inputs: bit-equal, the take-list's count the 64 flagged blocks."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import (
        diag_takelist as P)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        diag_primitives as TP)
    print("B8 diag_takelist (the take-list primitives):")
    reset_counts()
    res = TP.run_arms("cuda", P.NB, P.REPS)
    counts = read_counts()
    if counts["diag_takelist"] != 4 * (1 + TP.REPEATS) or any(
            v for k, v in counts.items() if k != "diag_takelist"):
        raise RuntimeError(f"diag_primitives run: launches {counts}")
    x, flags = TP.inputs("cuda")
    worst, p_ms = 0.0, 0.0
    for arm in P.ARMS:
        (out, cnt), ms = timed_call(lambda: P.run_plain(arm, x, P.NB, P.REPS,
                                                        flags))
        p_ms += ms
        worst = max(worst, max_abs(out, res[arm][0]))
        want = 64 if arm == "takelist" else 0
        if not torch.equal(out, res[arm][0]) \
                or res[arm][1] != int(cnt[0]) or res[arm][1] != want:
            raise RuntimeError(f"B8-prim {arm}: kernel vs plain differ (count "
                               f"{res[arm][1]}, plain {int(cnt[0])}, want "
                               f"{want})")
    e_ms = sum(ms for _, _, ms in res.values())
    k_ms = 0.0
    for arm in P.ARMS:
        ms = device_or_events(lambda: P.run(arm, x, P.NB, P.REPS, flags), 5,
                              "takelist_kernel", res[arm][2])
        print(f"  {arm}: {ms:.4f} ms device a launch, {res[arm][2]:.4f} ms "
              f"events (best of {TP.REPEATS})")
        k_ms += ms
    # chained adds: every block for noop, the 64 flagged ones otherwise;
    # restated, the bound stays the adds (see LOOP_LINK_CYCLES)
    b_ms, b_by = latency_bound(P.REPS * (P.NB + 3 * 64))
    print(f"  4 arms: kernel {k_ms:.4f} ms device ({e_ms:.4f} ms events), "
          f"plain PyTorch {p_ms:.1f} ms (bit-equal; take-list count 64 of "
          f"{P.NB}), bound {b_ms:.4f} ms ({b_by}; restated = yardstick, the "
          f"adds alone) ({card})")
    return {"launches": counts["diag_takelist"], "max_abs": worst,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def listed_pairs(arm) -> tuple[int, int]:
    """((ray, triangle) pairs, distinct rows) of one closest call: every
    ray of a tile against every row its list names."""
    import torch
    llen, ids = arm.lists.llen.long(), arm.lists.ids.long()
    k = torch.arange(ids.shape[1], device=ids.device)[None]
    live = k < llen[:, None]
    rows = torch.where(live, arm.table.count.long()[ids], 0)
    used = torch.unique(ids[live])
    return (int(rows.sum()) * 2048, int(arm.table.count.long()[used].sum()))


def dda_split(st: dict) -> str:
    """A B8-dda tally's clock64 cycles as shares of the kernel's."""
    k = max(1, st["kernel_cycles"])
    return ", ".join(f"{n} {100 * st[f'{n}_cycles'] / k:.1f}%"
                     for n in ("issue", "wait", "barrier", "test"))


def dda_tally(r: dict, card: str) -> None:
    """B8-dda's counting launches on one scene's cell-list calls (the
    closest call and each light's occlusion call): the rows a tile lists
    (minimum, mean, maximum), pairs tested and needed, rows staged, stages
    and the clock64 split, the timed call's device ms (a call is one
    launch) in a torch.profiler trace of 10 calls, with the tiles ranked
    as the tool ranks them and in index order; and the timed kernels'
    resident blocks an SM."""
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
    occ = K.occupancy()
    print("  resident blocks an SM (threads a block): " + ", ".join(
        f"{n} {v['blocks_per_sm']} ({v['threads']})" for n, v in occ.items()))
    arms = [("closest", r["closest"]["cell"], None)] + [
        (f"shadow L{li}", a, a.rays)
        for li, a in enumerate(r["shadow"]["cell"])]
    for name, arm, rays in arms:
        rows = K.tile_rows(arm.lists, arm.table)
        st = (K.closest_stats(arm.lists, arm.table, DIAG_SIZE, DIAG_SIZE)
              if rays is None else K.occluded_stats(arm.lists, arm.table,
                                                    *rays))
        devs = []
        for ls in (arm.lists, arm.lists._replace(order=None)):
            dev, n = device_ms(
                (lambda ls=ls: K.closest(ls, arm.table, DIAG_SIZE, DIAG_SIZE))
                if rays is None else
                (lambda ls=ls: K.occluded(ls, arm.table, *rays)), 10, "dda_")
            devs.append("not measured" if dev is None else f"{dev:.4f} ms")
        print(f"  {r['tag']} cell {name}: rows a tile min {int(rows.min())} "
              f"mean {float(rows.float().mean()):.1f} max {int(rows.max())}; "
              f"pairs tested {st['tested']} needed {st['needed']}, rows "
              f"staged {st['rows_staged']} in {st['stages']} stages; cycles "
              f"{dda_split(st)}; device a call {devs[0]} ranked, {devs[1]} in "
              f"index order ({n} launches traced) ({card})")


def phase_diag_dda(card: str) -> tuple[dict, dict]:
    """B8-dda-closest and B8-dda-occ: the tool's run at 512x512 on the demo
    scene and the 5k and 20k sheets (counts set to 0 just before), then
    every kernel call of it held against its plain version on the same
    inputs (bit-equal maps), cell vs Morton vs dense t maps and cell vs
    Morton occlusion maps bit-equal, and the tables of times."""
    import torch
    from opencl_montecarlo_path_tracing_tpu_torch.ops import diag_dda as K
    from opencl_montecarlo_path_tracing_tpu_torch.tools import diag_dda as TD
    print("B8 diag_dda (the grid cell-walk diagnostic):")
    reset_counts()
    runs = [TD.run_scene(tag, DIAG_SIZE, "cuda") for tag in DIAG_SCENES]
    counts = read_counts()
    n_closest = sum(len(r["closest"]) for r in runs) * (1 + TD.REPEATS)
    n_occ = sum(len(a) for r in runs for a in r["shadow"].values()) * (
        1 + TD.REPEATS)
    # the per-lane DDA arm: B11w (ops/grid.py::traverse_triangles)
    n_walk = sum(r["dda_ms"] is not None for r in runs) * (1 + TD.REPEATS)
    if (counts["diag_dda_closest"], counts["diag_dda_occ"],
            counts["grid_walk"]) != (n_closest, n_occ, n_walk) or any(
            v for k, v in counts.items()
            if k not in ("diag_dda_closest", "diag_dda_occ", "grid_walk")):
        raise RuntimeError(f"diag_dda run: launches {counts}, want "
                           f"{n_closest} closest, {n_occ} occlusion and "
                           f"{n_walk} grid walks")
    worst_c = worst_o = 0.0
    failed = []
    for r in runs:
        tag = r["tag"]
        t_c = r["closest"]["cell"].out[0]
        for name, arm in r["closest"].items():
            t, m = K.closest_plain(arm.lists, arm.table, DIAG_SIZE,
                                   DIAG_SIZE)
            worst_c = max(worst_c, max_abs(arm.out[0], t))
            if not (torch.equal(arm.out[0], t) and torch.equal(arm.out[1], m)):
                failed.append(f"{tag} {name} closest: kernel vs plain")
            if not torch.equal(arm.out[0], t_c):
                failed.append(f"{tag} {name} vs cell t map")
        for name, arms in r["shadow"].items():
            for li, arm in enumerate(arms):
                occ = K.occluded_plain(arm.lists, arm.table, *arm.rays)
                worst_o = max(worst_o, max_abs(arm.out, occ))
                if not torch.equal(arm.out, occ):
                    failed.append(f"{tag} {name} L{li} occ: kernel vs plain")
                if not torch.equal(arm.out, r["shadow"]["cell"][li].out):
                    failed.append(f"{tag} {name} L{li} vs cell occ map")
    print(f"  every call vs plain: t max abs {worst_c:.3e}, occlusion max abs "
          f"{worst_o:.3e}; cell == Morton == dense t maps, cell == Morton "
          f"occlusion maps: {'yes' if not failed else failed}")
    if failed:
        raise RuntimeError(f"B8-dda: {failed}")
    print(f"  {DIAG_SIZE}x{DIAG_SIZE}, best of {TD.REPEATS} warm calls, ms "
          f"({card}):")
    print("  | scene | structure | closest | shadow (2 lights) | total | "
          "lists mean | host lists s |")
    for r in runs:
        hs = r["host_s"]
        for name, arm in r["closest"].items():
            sh = r["shadow"].get(name)
            sh_ms = sum(a.ms for a in sh) if sh else None
            tot = arm.ms + (sh_ms or 0.0)
            lists_s = {"cell": hs["cell_lists"], "morton": hs["morton_lists"]
                       }.get(name)
            print(f"  | {r['tag']} | {name} | {arm.ms:.3f} | "
                  f"{'-' if sh_ms is None else f'{sh_ms:.3f}'} | "
                  f"{tot:.3f} | {float(arm.lists.llen.float().mean()):.1f} | "
                  f"{'-' if lists_s is None else f'{lists_s:.2f}'} |")
        print(f"  {r['tag']}: cell/Morton closest+shadow "
              f"{r['totals']['morton'] / r['totals']['cell']:.2f}x, per-lane "
              f"DDA (B11w) {r['dda_ms']:.1f} ms, host: tables "
              f"{hs['cells'] + hs['morton']:.2f} s, shadow lists "
              f"{hs['shadow_lists']:.2f} s")
    # the rows of the kernels line: the 20k sheet's cell-list calls
    r = runs[-1]
    c_arm, o_arm = r["closest"]["cell"], r["shadow"]["cell"][0]
    _, pc_ms = timed_call(lambda: K.closest_plain(
        c_arm.lists, c_arm.table, DIAG_SIZE, DIAG_SIZE))
    _, po_ms = timed_call(lambda: K.occluded_plain(o_arm.lists, o_arm.table,
                                                   *o_arm.rays))
    npix = DIAG_SIZE * DIAG_SIZE
    pairs, rows = listed_pairs(c_arm)
    bc_ms, bc_by = bound(pairs * PAIR_OPS + npix * CAMERA_OPS,
                         rows * 64 + c_arm.lists.ids.numel() * 4 + npix * 8)
    o_pairs = K.needed_pairs(o_arm.lists, o_arm.table, *o_arm.rays)
    _, o_rows = listed_pairs(o_arm)
    bo_ms, bo_by = bound(o_pairs * PAIR_OPS,
                         o_rows * 64 + o_arm.lists.ids.numel() * 4 + npix * 32)
    print(f"  {r['tag']} cell closest: kernel {c_arm.ms:.3f} ms, plain "
          f"PyTorch {pc_ms:.1f} ms, bound {bc_ms:.4f} ms ({bc_by}; {pairs} listed "
          f"pairs); cell shadow L0: kernel {o_arm.ms:.3f} ms, plain PyTorch "
          f"{po_ms:.1f} ms, bound {bo_ms:.4f} ms ({bo_by}; {o_pairs} needed "
          f"pairs) ({card})")
    dda_tally(r, card)
    closest = {"launches": counts["diag_dda_closest"], "max_abs": worst_c,
               "ms": c_arm.ms, "plain_ms": pc_ms, "bound_ms": bc_ms,
               "bound_by": bc_by}
    occ = {"launches": counts["diag_dda_occ"], "max_abs": worst_o,
           "ms": o_arm.ms, "plain_ms": po_ms, "bound_ms": bo_ms,
           "bound_by": bo_by}
    return closest, occ


def run_cli(args, cwd, env_extra=None, device=True):
    """One CLI run on the card (``--device cuda`` unless ``device`` is
    false); raises unless it exits 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, "-m", PKG, *args,
                        *(["--device", "cuda"] if device else [])],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"CLI {args} exited {r.returncode}:\n{r.stdout}\n"
                           f"{r.stderr}")
    return r


def phase_cli():
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        large_mesh_scene, procedural_super_scene, write_scene_files)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import load_pam
    runs = [["super", "256", "256"],
            ["bidirectional", "256", "256", "512"],
            ["metropolis_vlpgrid", "256", "256", "512", "8", "3.0"],
            ["trianglegrid", "256", "256", "3.0"],
            ["nodof", "256", "256"],
            ["simple", "64", "64", "16", "--spp", "2"],
            ["simplecpu", "64", "64", "--spp", "2"]]
    with tempfile.TemporaryDirectory() as tmp:
        demo_dir = os.path.join(tmp, "demo")
        mesh_dir = os.path.join(tmp, "large_mesh")
        write_scene_files(procedural_super_scene(), demo_dir)
        write_scene_files(large_mesh_scene(), mesh_dir)
        for args in runs:
            out = os.path.join(tmp, f"{args[0]}.ppm")
            scene_dir = mesh_dir if args[0] == "trianglegrid" else demo_dir
            spp = [] if "--spp" in args else ["--spp", "4"]
            r = run_cli([*args, *spp, "--seed", "1", "--scene-dir",
                         scene_dir, "--out", out], tmp, device=False)
            img = load_pam(out)
            size = int(args[1])
            if (img.width, img.height, img.channels) != (size, size, 4):
                raise RuntimeError(f"CLI {args[0]} wrote {img.width}x"
                                   f"{img.height}x{img.channels}")
            stage = [ln for ln in r.stdout.splitlines()
                     if " in " in ln and "GB/s" in ln]
            print(f"cli {args[0]}: ok ({stage[0] if stage else ''})")


class _Cut(Exception):
    """The interruption of phase 18's checkpointed render."""


SEVEN_STAGES = ("light paths random sampling",
                "light paths metropolis sampling",
                "VLPs min/max reduction (compute bounding box)",
                "Read VLPs bounding box", "init VLPs grid", "rendering",
                "read render data")
CKPT_STEP = 256        # phase 18's windows: 4 of the super main path
MLT_SEEDS, MLT_ROUNDS = 512, 8   # the CLI's defaults (the main paths')
ORACLE_SIZE, ORACLE_SPP, ORACLE_ROW = 64, 4, 372


def stage_lines(stdout: str) -> list:
    """(name, ms) of each stage line of a report."""
    out = []
    for ln in stdout.splitlines():
        if " : " in ln and ln.endswith("GB/s"):
            name, rest = ln.split(" : ", 1)
            out.append((name, float(rest.split(" in ")[1].split("ms:")[0])))
    return out


def phase_utilities(card: str) -> dict:
    """(a) super 1024x1024x1024 in 4 checkpointed windows of B1, cut after
    the second and resumed, against the one-shot render; (b) the 7-stage
    metropolis_vlpgrid report at 512x512x256 through the CLI, and the
    staged film against render_metropolis(dynamic_grid_res=True); (c) B1
    and B4 against the NumPy oracles; (d) checkpointed CLI runs and the
    PT_DEVICE selection."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.models import (
        metropolis as MT)
    from opencl_montecarlo_path_tracing_tpu_torch.models.oracle_bpt import (
        render_with_vlps)
    from opencl_montecarlo_path_tracing_tpu_torch.models.oracle_super import (
        render_oracle_super)
    from opencl_montecarlo_path_tracing_tpu_torch.models.super import (
        render_super)
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_super as M
    from opencl_montecarlo_path_tracing_tpu_torch.ops import mega_vlp as M4
    from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import (
        prep_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.ops.vlp import emit_vlps
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, procedural_super_scene, write_scene_files)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import (
        load_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.checkpoint import (
        FilmCheckpoint, render_resumable)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.cli import (
        _staged_vlp_render)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import (
        ORACLE, crn_ok)
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import load_pam
    from opencl_montecarlo_path_tracing_tpu_torch.utils.profiling import (
        StageTimer)

    failed = []
    out = {}
    scene, tag = demo_scene()
    key = make_key(0)
    windows = []

    def window(k, scn, w, h, spp, spp_offset, spp_total):
        windows.append((spp_offset, spp_total))
        return render_super(k, scn, w, h, spp=spp, spp_offset=spp_offset,
                            spp_total=spp_total, device="cuda")

    def cut_after_two(*a, **kw):
        if len(windows) == 2:
            raise _Cut()
        return window(*a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the checkpointed super main path, cut and resumed
        path = os.path.join(tmp, "super.npz")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            render_resumable(cut_after_two, key, scene, W, H, SPP,
                             checkpoint_path=path, spp_per_step=CKPT_STEP,
                             seed=0)
            raise RuntimeError("the checkpointed render was not cut")
        except _Cut:
            pass
        mid = FilmCheckpoint.load(path)
        ck = render_resumable(window, key, scene, W, H, SPP,
                              checkpoint_path=path, spp_per_step=CKPT_STEP,
                              seed=0)
        ck_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        want = [(o, SPP) for o in range(0, SPP, CKPT_STEP)]
        if mid.spp_done != 2 * CKPT_STEP or windows != want \
                or counts["mega_super"] != len(want) or ck.spp_done != SPP:
            raise RuntimeError(f"checkpointed super: cut at {mid.spp_done}, "
                               f"windows {windows}, counts {counts}")
        t0 = time.perf_counter()
        plain_windows = render_resumable(window, key, scene, W, H, SPP,
                                         spp_per_step=CKPT_STEP, seed=0)
        win_ms = (time.perf_counter() - t0) * 1e3
        one, one_ms, one_counts = timed_renders(lambda: pt.render(
            "super", scene, W, H, spp=SPP, seed=0, device="cuda"))
        check_crn(f"checkpointed super {W}x{H}x{SPP} (cut at "
                  f"{mid.spp_done}, resumed) vs one-shot",
                  torch.from_numpy(ck.film), one, SPP, failed)
        if not np.array_equal(ck.film, plain_windows.film):
            failed.append("resumed windows != uncut windows")
        print(f"  super {W}x{H}x{SPP} on {tag}: 4 windows of {CKPT_STEP} "
              f"checkpointed, cut and resumed {ck_ms:.1f} ms in all; the "
              f"same windows without a file {win_ms:.1f} ms; one-shot "
              f"{one_ms:.1f} ms ({card}); launches {counts['mega_super']} "
              f"(windows), {one_counts['mega_super']} ({TIMED_RUNS} one-shot)")
        out.update(ckpt_ms=ck_ms, windows_ms=win_ms, one_shot_ms=one_ms,
                   ckpt_launches=counts["mega_super"])

        # (b) the staged VLP pipeline: the CLI's 7-stage report, and the
        # staged film against the unstaged one, in process
        demo_dir = os.path.join(tmp, "demo")
        write_scene_files(procedural_super_scene(), demo_dir)
        args = ["metropolis_vlpgrid", str(VW), str(VH), str(MLT_SEEDS),
                str(MLT_ROUNDS), "3.0",
                "--spp", str(VSPP), "--seed", "1", "--scene-dir", demo_dir,
                "--profile-stages", "--dynamic-grid-res"]
        r = run_cli(args, tmp)
        st = stage_lines(r.stdout)
        names = tuple(n for n, _ in st[:len(SEVEN_STAGES)])
        if names != SEVEN_STAGES:
            raise RuntimeError(f"--profile-stages reported {names}")
        grid_line = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("VLPs grid size")]
        print(f"  cli metropolis_vlpgrid {VW}x{VH}x{VSPP} --profile-stages "
              f"--dynamic-grid-res ({card}); {grid_line[0]}:")
        for n, ms in st:
            print(f"    {n}: {ms} ms")
        out["stages"] = st

        vscene = load_scene(demo_dir)
        vkey = make_key(1)
        reset_counts()
        staged, staged_vlps = _staged_vlp_render(
            StageTimer("cuda"), vkey, vscene, VW, VH, VSPP, DEFAULT, "mlt",
            torch.device("cuda"), n_seed=MLT_SEEDS, rounds=MLT_ROUNDS,
            use_grid=True, grid_modifier=3.0, dynamic_res=True)
        torch.cuda.synchronize()
        staged_counts = read_counts()
        unstaged = MT.render_metropolis(
            vkey, vscene, VW, VH, spp=VSPP, n_seedpaths=MLT_SEEDS,
            mutation_rounds=MLT_ROUNDS, use_grid=True, grid_modifier=3.0,
            dynamic_grid_res=True, device="cuda")
        # render_metropolis(dynamic_grid_res=True) renders with mlt_vlps
        # on these arguments
        same_tables = torch.equal(staged_vlps, MT.mlt_vlps(
            vkey, prep_scene(vscene), MLT_SEEDS, MLT_ROUNDS, DEFAULT,
            device="cuda"))
        bits = torch.equal(staged, unstaged)
        print(f"  staged vs unstaged metropolis_vlpgrid {VW}x{VH}x{VSPP}: "
              f"VLP tables {'bit-equal' if same_tables else 'DIFFER'}, "
              f"films {'bit-equal' if bits else 'differ'}; B4 launches in "
              f"the staged render {staged_counts['mega_vlp']}")
        print(f"  staged render's light pass: L2a "
              f"{staged_counts['light_mlt_seed']}, L2b "
              f"{staged_counts['light_mlt_chain']} launches")
        if staged_counts["mega_vlp"] != 1:
            failed.append("staged render: B4 not launched once")
        if (staged_counts["light_mlt_seed"], staged_counts["light_mlt_chain"],
                staged_counts["light_emit"]) != (1, 1, 0):
            failed.append("staged render: L2a and L2b not launched once")
        out["light"] = {k: staged_counts[k] for k in LIGHT_KERNELS}
        if not bits:
            # bit-equal tables give bit-equal films (the same functions in
            # the same order); only a light pass that is not deterministic
            # run to run falls back to the CRN contract
            if same_tables:
                failed.append("staged film != unstaged film")
            else:
                check_crn("staged vs unstaged film", staged, unstaged, VSPP,
                          failed)

        # (c) B1 and B4 against the NumPy oracles on the content band
        n, spp, row = ORACLE_SIZE, ORACLE_SPP, ORACLE_ROW
        scn = prep_scene(scene)
        t0 = time.perf_counter()
        b1 = M.film_super_mega(key, scn, n, row + n, spp, 0, spp, DEFAULT,
                               row_offset=row, rows=n, device="cuda")
        orc = render_oracle_super(scene, n, n, spp=spp, key=key,
                                  row_offset=row)
        ok, st1 = crn_ok(b1, orc, spp, ORACLE)
        s1 = time.perf_counter() - t0
        vlps = emit_vlps(key, scn, 512, DEFAULT, device="cuda")
        t0 = time.perf_counter()
        b4 = M4.film_vlp_mega(key, scn, vlps, n, row + n, spp, 0, spp,
                              DEFAULT, row_offset=row, rows=n, device="cuda")
        v = vlps.cpu().numpy()
        orc4 = render_with_vlps(scene, v, n, n, spp=spp, key=key,
                                row_offset=row)
        ok4, st4 = crn_ok(b4, orc4, spp, ORACLE)
        s4 = time.perf_counter() - t0
        gather = float(np.abs(orc4 - render_with_vlps(
            scene, 0 * v, n, n, spp=spp, key=key, row_offset=row)).max())
        for name, good, stats, sec in (
                ("B1 vs oracle_super", ok, st1, s1),
                ("B4 vs oracle_bpt.render_with_vlps", ok4, st4, s4)):
            print(f"  {name} {n}x{n}x{spp} rows {row}+: p98 "
                  f"{stats['q']:.3e} max {stats['max']:.3e} ties "
                  f"{stats['tie_frac'] * 100:.3f}% "
                  f"{'ok' if good else 'VIOLATION'} ({sec:.2f} s)")
            if not good:
                failed.append(name)
        print(f"  B4's table: {int((v[:, 3] > 0).sum())} of {len(v)} rows "
              f"live; the gather moves the oracle's film by up to {gather:.3f}")
        if float(orc.var()) <= 1e-2 or gather <= 1e-3:
            failed.append("oracle band holds no content")
        out.update(oracle_s=(s1, s4))

        # (d) the CLI: checkpointed twice, against an unchecked run picked
        # by PT_DEVICE=0 with no --device
        base = ["super", "256", "256", "--spp", "8", "--seed", "1",
                "--scene-dir", demo_dir]
        r0 = run_cli(base + ["--out", "one.ppm"], tmp, {"PT_DEVICE": "0"},
                     device=False)
        if "Using device: cuda:0" not in r0.stdout:
            failed.append("PT_DEVICE=0 did not select cuda:0")
        ck_args = ["--checkpoint", "cli.npz", "--spp-per-step", "2"]
        r1 = run_cli(base + ck_args + ["--out", "a.ppm"], tmp)
        run_cli(base + ck_args + ["--out", "b.ppm"], tmp)
        one_img, a, b = (load_pam(os.path.join(tmp, f)).data
                         for f in ("one.ppm", "a.ppm", "b.ppm"))
        step = int(np.abs(a.astype(int) - one_img.astype(int)).max())
        if not np.array_equal(a, b) or step > 1 \
                or "(checkpointed, 8 spp)" not in r1.stdout:
            failed.append(f"CLI checkpoint (max step {step})")
        print(f"  cli super 256x256x8 --checkpoint --spp-per-step 2: twice "
              f"{'equal' if np.array_equal(a, b) else 'DIFFERENT'}, max "
              f"{step} uint8 step from the unchecked run; "
              f"{[ln for ln in r0.stdout.splitlines() if 'Using' in ln][0]}")
    if failed:
        raise RuntimeError(f"utilities phase failed: {failed}")
    return out


SHARD_TIMEOUT = 600.0   # a spawned group's limit (a hung rank fails it)
MLT_SHARD = 256, 64     # metropolis_vlpgrid's sharded run: size, spp
SHARD_2D = 512, 64      # the 2 x 2 mesh's runs: size, spp
# the kernel each sharded check must launch on every rank
SHARD_KERNEL = {"super": "mega_super", "trianglegrid": "mega_blocked",
                "simple": "mega_simple", "bidirectional": "mega_vlp",
                "metropolis": "mega_vlp", "nodof": "mega_super"}
# and the light-pass kernels a sharded VLP render's ranks must launch
SHARD_LIGHT = {"bidirectional": ("light_emit",),
               "metropolis": ("light_mlt_seed", "light_mlt_chain")}


def sharded_group(V, world, checks, backend, failed, counts):
    """Run ``checks`` (tools/validate_sharded.py) on ``world`` spawned
    ranks on cuda:0; print rank 0's results, add every rank's launches to
    ``counts`` and record failures (a rank's exception raises)."""
    t0 = time.perf_counter()
    ranks = V.run_ranks(V.run_checks, world, checks, device="cuda",
                        backend=backend, timeout=SHARD_TIMEOUT)
    for i, r in enumerate(ranks[0]):
        want = SHARD_KERNEL[r["name"]]
        launched = [rk[i]["counts"][want] for rk in ranks]
        # the light pass's kernels each rank must launch
        lk = SHARD_LIGHT.get(r["name"], ())
        light = {k: [rk[i]["counts"][k] for rk in ranks] for k in lk}
        for rk in ranks:
            for k, v in rk[i]["counts"].items():
                counts[k] += v
        ok = r["ok"] and all(rk[i]["ok"] for rk in ranks) \
            and min(launched) >= 1 and all(min(v) >= 1 for v in
                                           light.values())
        print(f"  {r['name']} on {r['mesh']} ({backend}, {world} ranks on "
              f"cuda:0): {'ok' if ok else 'FAILED'} - {r['detail']}; "
              f"{want} launches by rank {launched}"
              + "".join(f", {k} {v}" for k, v in light.items())
              + f" ({r['seconds']:.1f} s)")
        if not ok:
            failed.append(f"{r['name']} on {r['mesh']}")
    print(f"  [{world}-rank {backend} group: "
          f"{time.perf_counter() - t0:.1f} s]")
    return ranks


def phase_sharded(card: str) -> dict:
    """(a) NCCL, one rank: super 1024x1024x1024 through
    render_super_sharded bit for bit against api.render("super"), timed
    beside it; (b) gloo, 2 ranks on cuda:0: super, trianglegrid (B2/B3),
    simple (B5), bidirectional (B4; the windowed table and the replicated
    light pass's film bit for bit), metropolis_vlpgrid (its chain-window
    table bit for bit) and nodof bands (bit for bit); (c) gloo, 4 ranks, a
    2 x 2 mesh: super and bidirectional against the 1-D spp-sharded
    films; (d) the CLI under torchrun (--shard 1, NCCL; with
    --checkpoint) and --shard 2 without it; (e) utils/native.py."""
    import torch
    import opencl_montecarlo_path_tracing_tpu_torch as pt
    from opencl_montecarlo_path_tracing_tpu_torch.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu_torch.scene.builtin import (
        demo_scene, large_mesh_scene, procedural_super_scene,
        write_scene_files)
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import (
        load_scene)
    from opencl_montecarlo_path_tracing_tpu_torch.tools import (
        validate_sharded as V)
    from opencl_montecarlo_path_tracing_tpu_torch.utils import native
    from opencl_montecarlo_path_tracing_tpu_torch.utils.pam import (
        ImgInfo, load_pam, save_pam)

    failed = []
    counts = dict.fromkeys(tuple(SHARD_KERNEL.values()) + LIGHT_KERNELS, 0)
    scene, tag = demo_scene()
    key = make_key(0)
    frame = dict(key=key, scene=scene)

    # (a) one rank, NCCL: the identity all-reduce, one window
    [[r]] = sharded_group(V, 1, [("check_super", dict(
        spec=(1,), width=W, height=H, spp=SPP, runs=TIMED_RUNS, **frame))],
        "nccl", failed, counts)
    one = pt.render("super", scene, W, H, spp=SPP, seed=0, device="cuda")
    same = np.array_equal(r["out"], one.cpu().numpy())
    print(f"  super {W}x{H}x{SPP} on {tag}, 1-rank NCCL mesh: film "
          f"{'bit-equal' if same else 'DIFFERS'} to api.render(\"super\"); "
          f"{r['ms']:.1f} ms a render sharded, {r['unsharded_ms']:.1f} ms "
          f"unsharded (warm, {TIMED_RUNS} renders each, {card})")
    if not same:
        failed.append("1-rank NCCL film != api.render film")
    out = {"nccl_ms": r["ms"], "unsharded_ms": r["unsharded_ms"]}

    # (b) two ranks on the one card, gloo staged through the host
    msz, mspp = MLT_SHARD
    two = [("check_super", dict(spec=(2,), width=W, height=H, spp=SPP,
                                runs=TIMED_RUNS, **frame)),
           ("check_trianglegrid", dict(spec=(2,), key=key,
                                       scene=large_mesh_scene(), width=LW,
                                       height=LH, spp=LSPP_GRID)),
           ("check_simple", dict(spec=(2,), key=key, width=SW, height=SH,
                                 spp=SSPP)),
           ("check_bidirectional", dict(spec=(2,), width=VW, height=VH,
                                        spp=VSPP, n_vlp=512, **frame)),
           ("check_metropolis", dict(spec=(2,), width=msz, height=msz,
                                     spp=mspp, n_seedpaths=MLT_SEEDS,
                                     mutation_rounds=MLT_ROUNDS,
                                     use_grid=True, **frame)),
           ("check_nodof", dict(spec=("y", 2), width=NW, height=NH,
                                sample_grid=NSG, **frame))]
    ranks = sharded_group(V, 2, two, "gloo", failed, counts)
    r = ranks[0][0]
    print(f"  super {W}x{H}x{SPP}, 2 gloo ranks on one card: {r['ms']:.1f} "
          f"ms a render (the film staged through the host), "
          f"{r['unsharded_ms']:.1f} ms unsharded (warm, {TIMED_RUNS} "
          f"renders each, {card})")
    out.update(gloo2_ms=r["ms"], gloo2_unsharded_ms=r["unsharded_ms"])
    for r in ranks[0]:
        if r["name"] in ("bidirectional", "metropolis") and \
                not r["windowed"]:
            failed.append(f"{r['name']}: light pass not windowed")

    # (c) four ranks, 2 x 2 rows x spp
    s2, spp2 = SHARD_2D
    four = [("check_super", dict(spec=(2, 2), width=s2, height=s2,
                                 spp=spp2, **frame)),
            ("check_bidirectional", dict(spec=(2, 2), width=s2, height=s2,
                                         spp=spp2, n_vlp=512, **frame))]
    sharded_group(V, 4, four, "gloo", failed, counts)

    with tempfile.TemporaryDirectory() as tmp:
        # (d) the CLI: torchrun, one rank on the card (NCCL)
        demo_dir = os.path.join(tmp, "demo")
        write_scene_files(procedural_super_scene(), demo_dir)
        base = ["super", "256", "256", "--spp", "8", "--seed", "1",
                "--scene-dir", demo_dir]
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        # the plain and the checkpointed run at once (two processes)
        runs = {name: ["--shard", "1", "--out", name, *extra]
                for name, extra in (("s.ppm", []),
                                    ("c.ppm", ["--checkpoint", "ck.npz",
                                               "--spp-per-step", "2"]))}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", PKG, *base, *args], cwd=tmp,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for name, args in runs.items()}
        try:
            logs = {name: p.communicate(timeout=600)[0]
                    for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for name, p in procs.items():
            if p.returncode != 0:
                raise RuntimeError(f"torchrun {runs[name]} exited "
                                   f"{p.returncode}:\n{logs[name]}")
            print(f"  torchrun --nproc-per-node 1 ... super 256 256 --spp 8 "
                  f"{' '.join(runs[name])}: ok")
        print(f"  [the two torchrun CLIs: {time.perf_counter() - t0:.1f} s]")
        want = pt.render("super", load_scene(demo_dir), 256, 256, spp=8,
                         seed=1, as_rgba8=True, device="cuda")
        s_img, c_img = (load_pam(os.path.join(tmp, f)).data
                        for f in ("s.ppm", "c.ppm"))
        step = int(np.abs(c_img.astype(int) - want.astype(int)).max())
        if not np.array_equal(s_img, want) or step > 1:
            failed.append(f"CLI --shard 1 image (checkpointed: {step} "
                          "steps)")
        equal = "equal" if np.array_equal(s_img, want) else "NOT equal"
        print(f"  --shard 1 image {equal} to api.render's; checkpointed "
              f"within {step} uint8 step")
        rr = subprocess.run([sys.executable, "-m", PKG, *base, "--shard",
                             "2", "--out", "x.ppm"], cwd=tmp, env=env,
                            capture_output=True, text=True, timeout=600)
        msg = ("--shard 2 needs 2 ranks; have 1 (launch with torchrun "
               "--nproc-per-node 2)")
        if rr.returncode != 1 or msg not in rr.stderr \
                or os.path.exists(os.path.join(tmp, "x.ppm")):
            failed.append(f"--shard 2 without torchrun: rc {rr.returncode}")
        print(f"  --shard 2 without torchrun: exit {rr.returncode}, "
              f"{rr.stderr.strip().splitlines()[-1]}")

        # (e) the native library: built with g++, the NumPy writer's bytes
        path = native.build()
        img = ImgInfo(width=W, height=H, channels=4,
                      data=pt.render("super", scene, W, H, spp=4, seed=0,
                                     as_rgba8=True, device="cuda"))
        t0 = time.perf_counter()
        save_pam(os.path.join(tmp, "native.ppm"), img)
        t_nat = time.perf_counter() - t0
        os.environ["PT_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            save_pam(os.path.join(tmp, "numpy.ppm"), img)
            t_np = time.perf_counter() - t0
        finally:
            del os.environ["PT_NO_NATIVE"]
        a, b = (open(os.path.join(tmp, f), "rb").read()
                for f in ("native.ppm", "numpy.ppm"))
        if a != b or native.load() is None:
            failed.append("native PAM bytes")
        print(f"  native {os.path.basename(path)}: {W}x{H} PAM "
              f"{'byte-equal' if a == b else 'DIFFERS'} to the NumPy "
              f"writer's ({t_nat * 1e3:.1f} vs {t_np * 1e3:.1f} ms)")
    print(f"  sharded launches (every rank): {counts}")
    if failed:
        raise RuntimeError(f"sharded phase failed: {failed}")
    torch.cuda.synchronize()
    out["counts"] = counts
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[{fn.__name__}: {time.perf_counter() - t:.1f} s]")
        return out

    phase(phase_card_and_build, card)
    gt = gpu_tests()
    b1_err = phase(phase_super_kernel_vs_plain, gt)
    tables = vlp_bench_tables()
    b4 = phase(phase_vlp_kernel_vs_plain, gt, tables, card)
    b6_table = phase(phase_gather_kernel_vs_plain, card)
    mp = phase(phase_super_main_path, card)
    lpk = phase(phase_light_pass, gt, card)
    vp = phase(phase_vlp_main_paths, card)
    b6 = phase(phase_tier1_route, card)
    b23 = phase(phase_blocked_kernel_vs_plain, gt, card)
    b4w = phase(phase_vlp_walk_vs_plain, gt, card)
    b7 = phase(phase_tri_closest_vs_plain, card)
    lp = phase(phase_large_mesh_main_paths, card)
    gd = phase(phase_grid_dda, card)
    b5 = phase(phase_simple_kernel_vs_plain, gt, card)
    sp = phase(phase_simple_main_path, card)
    npth = phase(phase_nodof_main_path, card)
    b8_loops = phase(phase_diag_loops, card)
    b8_prim = phase(phase_diag_primitives, card)
    b8_closest, b8_occ = phase(phase_diag_dda, card)
    phase(phase_cli)
    ut = phase(phase_utilities, card)
    sh = phase(phase_sharded, card)["counts"]
    print(f"smoke: {time.perf_counter() - t0:.1f} s")
    src = f"{PKG}/csrc"
    ref = "opencl_montecarlo_path_tracing_tpu/ops"
    GRID_XLA = ("opencl_montecarlo_path_tracing_tpu/models/trianglegrid.py:"
                f"85-91 / {ref}/grid.py:261 (none: XLA under jax.jit)")

    def row(name, source, replaces, launches, k):
        """``replaces``: the TPU kernel's file (from the repository root)
        and line."""
        return {"name": name, "route": "cuda", "source": f"{src}/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}

    kernels = [
        row("mega_super", "mega_super.cu", f"{ref}/pallas_super.py:2228",
            mp["launches"] + npth["launches"] + sh["mega_super"],
            dict(mp, max_abs=b1_err)),
        row("mega_vlp", "mega_vlp.cu", f"{ref}/pallas_bpt.py:434",
            vp["launches"] + sh["mega_vlp"], b4),
        # the same kernel's walk instantiation, past 512 triangles
        row("mega_vlp_walk", "mega_vlp.cu", f"{ref}/pallas_bpt.py:434",
            lp["mega_vlp"], b4w),
        row("gather_vlp", "gather_vlp.cu", f"{ref}/pallas_vlp.py:111",
            b6["launches"],
            dict(b6, max_abs=max(b6["max_abs"], b6_table["max_abs"]))),
        row("mega_blocked", "mega_blocked.cu", f"{ref}/pallas_super.py:2228",
            lp["mega_blocked"] + sh["mega_blocked"], b23),
        row("tri_closest", "tri_closest.cu", f"{ref}/pallas_tri.py:89",
            b6["tri_closest"], b7),
        row("mega_simple", "mega_simple.cu", f"{ref}/pallas_simple.py:352",
            sp["launches"] + sh["mega_simple"], b5),
        row("diag_dda_closest", "diag_dda.cu", "tools/diag_dda_pallas.py:163",
            b8_closest["launches"], b8_closest),
        row("diag_dda_occ", "diag_dda.cu", "tools/diag_dda_pallas.py:198",
            b8_occ["launches"], b8_occ),
        row("diag_takelist", "diag_takelist.cu",
            "tools/diag_primitives.py:145", b8_prim["launches"], b8_prim),
        row("diag_loops", "diag_loops.cu",
            "tools/diag_loops.py:47, :70, :85, :103, :119, :136",
            b8_loops["launches"], b8_loops),
        # no pl.pallas_call: the JAX package's DDA route and its light pass
        # are XLA under jit
        row("mega_grid", "mega_grid.cu", GRID_XLA, gd["launches"], gd),
        row("grid_walk", "mega_grid.cu", GRID_XLA, gd["walk"]["launches"],
            gd["walk"]),
        row("light_emit", "light_pass.cu",
            f"{ref}/vlp.py:76 (none: XLA under jax.jit)",
            vp["light"]["light_emit"] + b6["light_emit"] + lp["light_emit"]
            + sh["light_emit"],
            lpk["emit"]),
        row("light_mlt", "light_pass.cu",
            "opencl_montecarlo_path_tracing_tpu/models/metropolis.py:234-289"
            " (none: XLA fori_loop under jax.jit)",
            sum(vp["light"][k] + ut["light"][k] + lp[k] + sh[k]
                for k in ("light_mlt_seed", "light_mlt_chain")),
            lpk["mlt"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
