"""Times the design alternatives that kernels B8-prim and B8-loops, the
trianglegrid DDA route's B11 and B11w, and B4's walk route (B9) were
chosen over, on one CUDA GPU.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.diag_variants \
        [--set diag|grid|walk] [--runs 10] [--only NAME ...] [--json PATH]

Each variant is this package with one edit to its set's sources
(``VARIANTS``).  ``--set diag`` (the default), ``csrc/diag_loops.cu`` or
``csrc/diag_takelist.cu``:

``blk32``       the element-wise arms in 32 blocks of 32 threads (kept: 8
                of 128);
``full1``, ``full8``, ``full32``
                the full reduce in one block of 1, 8 or 32 warps, the
                warps' maxima read from shared memory by a max tree (kept:
                4 warps, read as one float4);
``copy_tma``, ``copy_tma16``
                the copy's 16 rows as bulk copies (TMA) onto an mbarrier,
                issued by one thread or a row by each of 16 lanes (kept:
                one warp's cp.async);
``cmp32``       B8-prim's lane predicate as 32 compares a block (kept: one
                compare of the lane's max);
``ahead2``      B8-prim's shared reads (threshold, flag, list entry) two
                iterations ahead (kept: one).

``--set grid``, ``csrc/pt_device.cuh`` or ``csrc/mega_grid.cu``:

``ownpairs``    B11w's lanes each test their own cell's pairs, the warp
                paying its lanes' largest cell (kept: the warp pools its
                lanes' pairs and deals them out 32 a round);
``pool11``, ``pool11lb7``, ``pool11lb8``
                B11 walks the warp's rays in lockstep with the pool too,
                with no minimum of blocks an SM, or held to 7 or 8 (kept:
                each lane walks at its own pace, testing its own pairs);
``poolcam``     B11's camera walks pooled (kept: each lane testing its
                own pairs);
``flatcam``     B11's camera walks one step a cell, the warp's lanes
                stepping together (kept: an inner loop steps over each
                run of empty cells, each lane at its own pace, so that
                the lanes test their occupied cells together; B11's
                shadow walks and B11w step one cell at a time);
``counts``      a cell's occupancy read from its span in device memory
                (kept: its bit in the occupancy bitmap);
``gbits``       B11 reads the bitmap from device memory (kept: staged in
                shared memory up to 16 KiB);
``sbits``       B11w stages the bitmap in shared memory (kept: read from
                device memory);
``lb8``         B11 held to 8 blocks an SM (64 registers; kept: no
                minimum).

``--set walk``, ``csrc/mega_vlp.cu``, ``csrc/pt_device.cuh`` or
``ops/exact_grid.py`` (B4's walk route, through ``ab_trees --set walk``):

``walklb8``, ``walklb10``
                B4 held to 8 or 10 blocks an SM (at most 64 or 51
                registers; kept: no minimum);
``walkflat``    the camera walks one step a cell, the warp's lanes
                stepping together (kept: an inner loop over each run of
                empty cells);
``walkflatsh``  the shadow walks one step a cell (kept: the inner loop);
``walkgv``      the VLP grid's 9 floats read from shared memory on the
                walk route (kept: held in registers);
``walkmod1``, ``walkmod2``, ``walkmod8``, ``walkmod16``
                the grid's resolution heuristic at 1, 2, 8 or 16 cells a
                triangle (kept: ``exact_grid.EXACT_MODIFIER``).

The package is copied into a temporary directory once for each variant
and the edit applied there; an edit whose text is no longer in the source
stops the tool.  Then the kept tree, every variant and the kept tree
again run in turn, each turn one process of ``ab_trees.py --set SET``
(which builds that copy's kernels): ``diag``, both kernels' arms at the
tools' counts, device time a call; ``grid``, B11's renders on events and
B11w's calls in device time.  Every variant's outputs must equal the kept
tree's bit for bit.  Printed: for each variant the times it changes, the
kept tree's (the mean of its two turns), the variant's, and variant /
kept; the command exits 1 if a variant fails to build or run or its
outputs differ (the walk route's films: beyond the CRN contract,
``ab_trees.films_agree``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from .ab_trees import films_agree

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ab_trees.py")
LOOPS, PRIM = "diag_loops.cu", "diag_takelist.cu"
DEVICE, GRID = "pt_device.cuh", "mega_grid.cu"
VLP, EXACT = "mega_vlp.cu", "ops/exact_grid.py"   # a "/": package-relative
FILES = {"diag": (LOOPS, PRIM), "grid": (DEVICE, GRID),
         "walk": (DEVICE, VLP, EXACT)}
#: the set's kernel source, whose ptxas lines are printed
SOURCE = {"grid": GRID, "walk": VLP}
GRID_TIMES = ("B11 sheet 512x512x64", "B11 torus 512x512x64",
              "B11w sheet camera rays 262144 device",
              "B11w tier-1 shadow call 589824 device")
WALK_TIMES = tuple(f"B4 walk sheet {n} 256x256x16 device"
                   for n in (20736, 262144, 1048576))
ELEMENTWISE = ("flat1", "flat4", "flat16", "flat64", "chunk32", "chunk128",
               "nested", "bcast")


def _sub(src: str, old: str, new: str, count: int) -> str:
    """``src`` with ``old`` replaced by ``new``; ``old`` must occur
    ``count`` times."""
    if src.count(old) != count:
        raise RuntimeError(f"edit expects {count} of {old[:60]!r}, found "
                           f"{src.count(old)}")
    return src.replace(old, new)


def blk32(src: dict) -> None:
    s = _sub(src[LOOPS], "const int t = blockIdx.x * kBlock + threadIdx.x;",
             "const int t = blockIdx.x * blockDim.x + threadIdx.x;", 3)
    src[LOOPS] = _sub(s, "<<<kGrid, kBlock, 0, st>>>",
                      "<<<kTile / 32, 32, 0, st>>>", 8)


_FULL_W = """
template <int W>
__global__ void __launch_bounds__(W * 32)
loops_reduce_full_w(const float* __restrict__ x,
                    const float* __restrict__ acc0, int n1,
                    float* __restrict__ out) {
  constexpr int kT = W * 32, kE = kTile / kT;
  __shared__ float part[2][W];
  const int t = threadIdx.x;
  float a[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) a[j] = acc0[j * kT + t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    float w = warp_max(tree_max<kE>(a));
    if (W > 1) {
      float* s = part[i & 1];
      if ((t & 31) == 0) s[t >> 5] = w;
      __syncthreads();
      w = tree_max<W>(s);
    }
    const float d = w * 1e-9f;
#pragma unroll
    for (int j = 0; j < kE; ++j) a[j] = a[j] + d;
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) out[j * kT + t] = a[j] + x[j * kT + t];
}

// a warp a row"""


def full_warps(w: int):
    def edit(src: dict) -> None:
        s = _sub(src[LOOPS], "\n// a warp a row", _FULL_W, 1)
        src[LOOPS] = _sub(
            s, "loops_reduce_full<<<1, kFullWarps * 32, 0, st>>>",
            f"loops_reduce_full_w<{w}><<<1, {w * 32}, 0, st>>>", 1)
    return edit


_COPY_TMA = """__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the slice's 16 rows as bulk copies onto an mbarrier, a row by each of
// the first ISSUERS lanes
template <int ISSUERS>
__global__ void __launch_bounds__(32)
loops_copy_tma(const float* __restrict__ x, const float* __restrict__ table,
               int n1, float* __restrict__ out) {
  __shared__ __align__(128) float slice[kSliceRows * kCols];
  __shared__ __align__(8) unsigned long long bar;
  const int lane = threadIdx.x;
  const unsigned b = smem_u32(&bar);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncwarp();
  float c = 0.0f;
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    const float* src = table + (i % 16) * kCols;
    if (lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(b),
          "r"(kSliceRows * kCols * 4) : "memory");
    if (lane < ISSUERS)
      for (int r = lane; r < kSliceRows; r += ISSUERS)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\\n" ::"r"(smem_u32(slice + r * kCols)),
            "l"(src + r * kTableCols), "r"(kCols * 4), "r"(b) : "memory");
    asm volatile(
        "{\\n.reg .pred p;\\nWAIT:\\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"
        "@!p bra WAIT;\\n}\\n" ::"r"(b), "r"(i & 1) : "memory");
    c = c + *(volatile float*)slice;
    __syncwarp();   // the next copy overwrites the slice
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  }
  for (int j = lane; j < kTile; j += 32) out[j] = x[j] + c;
}

// one block of kTile threads"""


def copy_tma(issuers: int):
    def edit(src: dict) -> None:
        s = _sub(src[LOOPS], "// one block of kTile threads", _COPY_TMA, 1)
        src[LOOPS] = _sub(s, "loops_copy<<<1, 32, 0, st>>>",
                          f"loops_copy_tma<{issuers}><<<1, 32, 0, st>>>", 1)
    return edit


def cmp32(src: dict) -> None:
    s = _sub(src[PRIM], """  float xm = x[lane];
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) xm = fmaxf(xm, x[j * kLanes + lane]);
""", """  float xv[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) xv[j] = x[j * kLanes + lane];
""", 1)
    s = _sub(s, "__global__ void __launch_bounds__(kLanes)\ntakelist_kernel",
             """__device__ __forceinline__ bool any_above(const float* v,
                                          float thr) {
  bool p = false;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) p |= v[j] > thr;
  return p;
}

__global__ void __launch_bounds__(kLanes)
takelist_kernel""", 1)
    n = len(re.findall(r"xm > (vthr\[0\]|thr)", s))
    if n != 4:
        raise RuntimeError(f"edit expects 4 compares of xm, found {n}")
    src[PRIM] = re.sub(r"xm > (vthr\[0\]|thr)", r"any_above(xv, \1)", s)


def ahead2(src: dict) -> None:
    s = _sub(src[PRIM], "[kMaxBlocks + 2]", "[kMaxBlocks + 3]", 3)
    s = _sub(s, "b <= nb + 1", "b <= nb + 2", 2)
    s = _sub(s, """      float thr = vthr[1];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = above;
        above = xm > thr;
        thr = vthr[b + 2];""", """      float thr = vthr[1], thr2 = vthr[2];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = above;
        above = xm > thr;
        thr = thr2;
        thr2 = vthr[b + 3];""", 2)
    s = _sub(s, """      int flag = vflags[1];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = set;
        set = flag != 0;
        flag = vflags[b + 2];""", """      int flag = vflags[1], flag2 = vflags[2];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = set;
        set = flag != 0;
        flag = flag2;
        flag2 = vflags[b + 3];""", 1)
    src[PRIM] = _sub(s, """      unsigned short entry = vlist[1];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const float cur = term;
        term = 1e-6f * (float)entry;
        entry = vlist[i + 2];""", """      unsigned short entry = vlist[1], entry2 = vlist[2];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const float cur = term;
        term = 1e-6f * (float)entry;
        entry = entry2;
        entry2 = vlist[i + 3];""", 1)


def ownpairs(src: dict) -> None:
    src[GRID] = _sub(src[GRID], "grid_walk<false, true, false>(G, keys + "
                     "(threadIdx.x & ~31)", "grid_walk<false, false, false>("
                     "G, keys + (threadIdx.x & ~31)", 1)


_B11_KEYS = """// a warp's 32 slots for the pooled walk
__device__ __forceinline__ unsigned long long* b11_keys() {
  __shared__ unsigned long long keys[kBlock];
  return keys + (threadIdx.x & ~31);
}

template <bool kNest, bool kStats>
__device__ __forceinline__ void b11_closest("""


def pool11(src: dict) -> None:
    s = _sub(src[GRID], "template <bool kNest, bool kStats>\n__device__ "
             "__forceinline__ void b11_closest(", _B11_KEYS, 1)
    s = _sub(s, "  if constexpr (kStats)\n    grid_walk<false, false, kNest>"
             "(G, nullptr,", "  if constexpr (true)\n    grid_walk<false, "
             "true, kNest>(G, b11_keys(),", 1)
    src[GRID] = _sub(s, "  if constexpr (kStats)\n    return grid_walk<true, "
                     "false, false>(G, nullptr,", "  if constexpr (true)\n"
                     "    return grid_walk<true, true, false>(G, b11_keys(),",
                     1)


def pool11_blocks(blocks: int):
    def edit(src: dict) -> None:
        pool11(src)
        min_blocks(blocks)(src)
    return edit


def poolcam(src: dict) -> None:
    s = _sub(src[GRID], "template <bool kNest, bool kStats>\n__device__ "
             "__forceinline__ void b11_closest(", _B11_KEYS, 1)
    src[GRID] = _sub(s, "    b11_closest<true>(G, T, in_film, ox, oy, oz, dx, "
                     "dy, dz, neg_t, h0);", "    grid_walk<false, true, "
                     "false>(G, b11_keys(), in_film, ox, oy, oz, dx, dy, dz, "
                     "neg_t, h0, T);", 1)


def flatcam(src: dict) -> None:
    src[GRID] = _sub(src[GRID], "    b11_closest<true>(", "    b11_closest"
                     "<false>(", 1)


def counts(src: dict) -> None:
    src[DEVICE] = _sub(
        src[DEVICE], "  return (G.occ[c >> 5] >> (c & 31)) & 1u;",
        "  return __ldg(reinterpret_cast<const int*>(G.span + c) + 1) > 0;",
        1)


def gbits(src: dict) -> None:
    src[GRID] = _sub(src[GRID], "ga, smem + ((scene_floats(0, nl, ns, nq) + "
                     "3) & ~3), true);", "ga, smem + ((scene_floats(0, nl, "
                     "ns, nq) + 3) & ~3), false);", 1)


def sbits(src: dict) -> None:
    s = _sub(src[GRID], "load_grid(ga, reinterpret_cast<float*>(smem_grid), "
             "false);", "load_grid(ga, reinterpret_cast<float*>(smem_grid), "
             "true);", 1)
    src[GRID] = _sub(s, "  const size_t smem = sizeof(float) * kFrameFloats;",
                     "  const size_t smem = sizeof(float) * (size_t)("
                     "kFrameFloats + occ_smem_words(ga.words));", 1)


def min_blocks(blocks: int):
    def edit(src: dict) -> None:
        src[GRID] = _sub(src[GRID], "__global__ void __launch_bounds__("
                         "kBlock)\nmega_grid_kernel", "__global__ void "
                         f"__launch_bounds__(kBlock, {blocks})\n"
                         "mega_grid_kernel", 1)
    return edit


def walk_blocks(blocks: int):
    def edit(src: dict) -> None:
        src[VLP] = _sub(src[VLP], "__global__ void __launch_bounds__(kBlock)"
                        "\nmega_vlp_kernel", "__global__ void "
                        f"__launch_bounds__(kBlock, {blocks})\n"
                        "mega_vlp_kernel", 1)
    return edit


def walkflat(src: dict) -> None:
    src[VLP] = _sub(src[VLP], "exact_walk<false, true>(", "exact_walk<false, "
                    "false>(", 1)


def walkflatsh(src: dict) -> None:
    src[VLP] = _sub(src[VLP], "exact_walk<true, true>(", "exact_walk<true, "
                    "false>(", 1)


def walkgv(src: dict) -> None:
    s = _sub(src[VLP], "constexpr int kFrameFloats = 12;",
             "constexpr int kFrameFloats = 24;", 1)
    s = _sub(s, "    B.g.frame = fsm;\n", "    B.g.frame = fsm;\n"
             "    if (threadIdx.x >= 12 && threadIdx.x < 21)\n"
             "      fsm[threadIdx.x] = gridp ? gridp[threadIdx.x - 12] : "
             "0.0f;\n", 1)
    src[VLP] = _sub(s, """  float gv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) gv[i] = grid_mode ? gridp[i] : 0.0f;""",
                    """  float gvr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    gvr[i] = !kWalk && grid_mode ? gridp[i] : 0.0f;
  const float* gv = kWalk ? fsm + 12 : gvr;""", 1)


def walk_modifier(modifier: float):
    def edit(src: dict) -> None:
        src[EXACT] = re.sub(r"\nEXACT_MODIFIER = [0-9.]+\n",
                            f"\nEXACT_MODIFIER = {modifier!r}\n", src[EXACT])
    return edit


#: name: (set, edit of the sources, the times it changes)
VARIANTS = {
    "blk32": ("diag", blk32,
              [f"loops {a} device" for a in ELEMENTWISE]),
    "full1": ("diag", full_warps(1), ["loops reduce_full device"]),
    "full8": ("diag", full_warps(8), ["loops reduce_full device"]),
    "full32": ("diag", full_warps(32), ["loops reduce_full device"]),
    "copy_tma": ("diag", copy_tma(1), ["loops copy device"]),
    "copy_tma16": ("diag", copy_tma(16), ["loops copy device"]),
    "cmp32": ("diag", cmp32, ["prim anycond device",
                              "prim takelist device"]),
    "ahead2": ("diag", ahead2, ["prim anycond device",
                                "prim scalarcond device",
                                "prim takelist device"]),
    "ownpairs": ("grid", ownpairs, GRID_TIMES[2:]),
    "pool11": ("grid", pool11, GRID_TIMES[:2]),
    "pool11lb7": ("grid", pool11_blocks(7), GRID_TIMES[:2]),
    "pool11lb8": ("grid", pool11_blocks(8), GRID_TIMES[:2]),
    "poolcam": ("grid", poolcam, GRID_TIMES[:2]),
    "flatcam": ("grid", flatcam, GRID_TIMES[:2]),
    "counts": ("grid", counts, GRID_TIMES),
    "gbits": ("grid", gbits, GRID_TIMES[:2]),
    "sbits": ("grid", sbits, GRID_TIMES[2:]),
    "lb8": ("grid", min_blocks(8), GRID_TIMES[:2]),
    "walklb8": ("walk", walk_blocks(8), WALK_TIMES),
    "walklb10": ("walk", walk_blocks(10), WALK_TIMES),
    "walkflat": ("walk", walkflat, WALK_TIMES),
    "walkflatsh": ("walk", walkflatsh, WALK_TIMES),
    "walkgv": ("walk", walkgv, WALK_TIMES),
    "walkmod1": ("walk", walk_modifier(1.0), WALK_TIMES),
    "walkmod2": ("walk", walk_modifier(2.0), WALK_TIMES),
    "walkmod8": ("walk", walk_modifier(8.0), WALK_TIMES),
    "walkmod16": ("walk", walk_modifier(16.0), WALK_TIMES),
}


def make_tree(root: str, name: str, edit, files=()) -> str:
    """A copy of the package under ``root/name`` with ``edit`` applied to
    its sources ``files``; returns the tree's root."""
    tree = os.path.join(root, name)
    dst = os.path.join(tree, os.path.basename(_PKG))
    shutil.copytree(_PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    if edit is not None:
        path = {f: os.path.join(dst, f) if "/" in f
                else os.path.join(dst, "csrc", f) for f in files}
        src = {f: open(path[f]).read() for f in files}
        edit(src)
        for f, text in src.items():
            with open(path[f], "w") as fh:
                fh.write(text)
    return tree


def registers(tree: str, source: str) -> list:
    """(kernel, registers, spill store bytes) of each entry function of
    ``source`` in ``tree``'s last build log (ptxas -v)."""
    import glob
    logs = sorted(glob.glob(os.path.join(
        tree, os.path.basename(_PKG), "_build", "build-*.log")),
        key=os.path.getmtime)
    if not logs:
        return []
    text = open(logs[-1]).read()
    part = text.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
    out, name, spill = [], None, 0
    for line in part.splitlines():
        m = re.search(r"Compiling entry function .*?\d([a-z_]+_kernel)"
                      r"I((?:Lb\d)+)", line)
        if m:
            flags = ("true" if b == "1" else "false"
                     for b in re.findall(r"Lb(\d)", m.group(2)))
            name = f"{m.group(1)}<{', '.join(flags)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def turn(tree: str, out: str, runs: int, set_name: str = "diag"):
    """(times, None) of one ``ab_trees --set SET`` turn in ``tree``, or
    (None, the error's last lines)."""
    proc = subprocess.run(
        [sys.executable, _AB, "--set", set_name, "--runs", str(runs),
         "--one", tree, out], cwd=tree, capture_output=True, text=True,
        timeout=900)
    if proc.returncode != 0:
        return None, "\n".join((proc.stdout + proc.stderr).splitlines()[-15:])
    return json.loads(proc.stdout.strip().splitlines()[-1]), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", choices=sorted(FILES), default="diag")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--json", help="write every turn's times here")
    args = ap.parse_args(argv)
    names = args.only or [n for n, v in VARIANTS.items()
                          if v[0] == args.set]
    if any(VARIANTS[n][0] != args.set for n in names):
        ap.error(f"--only names a variant outside --set {args.set}")
    order = ["kept"] + names + ["kept"]
    times, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"kept": make_tree(tmp, "kept", None)}
        for n in names:
            trees[n] = make_tree(tmp, n, VARIANTS[n][1], FILES[args.set])
        films = {}
        for i, name in enumerate(order):
            out = os.path.join(tmp, f"turn{i}.npz")
            t, err = turn(trees[name], out, args.runs, args.set)
            if t is None:
                print(f"{name}: FAILED\n{err}", flush=True)
                failed.append(name)
                continue
            print(f"turn {i} {name}: {json.dumps(t)}", flush=True)
            times.setdefault(name, []).append(t)
            films[name] = films.get(name, out)
        if "kept" not in films:
            return 1
        base = np.load(films["kept"])
        for name in names:
            if name not in films:
                continue
            f = np.load(films[name])
            differ = [k for k in base.files
                      if not films_agree(k, base[k], f[k])[0]]
            if differ:
                print(f"{name}: outputs differ from the kept tree's: "
                      f"{differ}")
                failed.append(name)
        regs = {name: registers(trees[name], SOURCE[args.set])
                for name in trees if args.set in SOURCE}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(times, fh, indent=1)
    kept = times.get("kept", [])
    print(f"ms a call (kept: the mean of {len(kept)} turns; {args.runs} "
          "calls a turn):")
    for name in names:
        if name not in times:
            continue
        for key in VARIANTS[name][2]:
            if any(t.get(key) is None for t in kept + times[name]):
                print(f"  {name} {key}: not measured")
                continue
            k = np.mean([t[key] for t in kept])
            v = times[name][0][key]
            spread = (f" (kept turns {kept[0][key]:.4f} / "
                      f"{kept[-1][key]:.4f})")
            print(f"  {name} {key}: kept {k:.4f}, variant {v:.4f}, "
                  f"variant / kept {v / k:.3f}{spread}")
    for name, found in regs.items():
        print(f"ptxas {name}: " + ", ".join(
            f"{k} {r} registers, {sp} B spills" for k, r, sp in found))
    print(f"failed or differing: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
