"""Times the design alternatives that kernels B8-prim and B8-loops were
chosen over, on one CUDA GPU.

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.diag_variants \
        [--runs 10] [--only NAME ...] [--json PATH]

Each variant is this package with one edit to ``csrc/diag_loops.cu`` or
``csrc/diag_takelist.cu`` (``VARIANTS``):

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

The package is copied into a temporary directory once for each variant
and the edit applied there; an edit whose text is no longer in the source
stops the tool.  Then the kept tree, every variant and the kept tree
again run in turn, each turn one process of ``ab_trees.py --set diag``
(which builds that copy's kernels): both kernels' arms at the tools'
counts, device time a call.  Every variant's outputs must equal the kept
tree's bit for bit.  Printed: for each variant the arms it changes, the
kept tree's device ms (the mean of its two turns), the variant's, and
variant / kept; the command exits 1 if a variant fails to build or run or
its outputs differ.
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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ab_trees.py")
LOOPS, PRIM = "diag_loops.cu", "diag_takelist.cu"
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


#: name: (edit of the sources, the arms it changes)
VARIANTS = {
    "blk32": (blk32, [f"loops {a}" for a in ELEMENTWISE]),
    "full1": (full_warps(1), ["loops reduce_full"]),
    "full8": (full_warps(8), ["loops reduce_full"]),
    "full32": (full_warps(32), ["loops reduce_full"]),
    "copy_tma": (copy_tma(1), ["loops copy"]),
    "copy_tma16": (copy_tma(16), ["loops copy"]),
    "cmp32": (cmp32, ["prim anycond", "prim takelist"]),
    "ahead2": (ahead2, ["prim anycond", "prim scalarcond",
                        "prim takelist"]),
}


def make_tree(root: str, name: str, edit) -> str:
    """A copy of the package under ``root/name`` with ``edit`` applied to
    its diag sources; returns the tree's root."""
    tree = os.path.join(root, name)
    dst = os.path.join(tree, os.path.basename(_PKG))
    shutil.copytree(_PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    if edit is not None:
        csrc = os.path.join(dst, "csrc")
        src = {f: open(os.path.join(csrc, f)).read() for f in (LOOPS, PRIM)}
        edit(src)
        for f, text in src.items():
            with open(os.path.join(csrc, f), "w") as fh:
                fh.write(text)
    return tree


def turn(tree: str, out: str, runs: int):
    """(times, None) of one ``ab_trees --set diag`` turn in ``tree``, or
    (None, the error's last lines)."""
    proc = subprocess.run(
        [sys.executable, _AB, "--set", "diag", "--runs", str(runs), "--one",
         tree, out], cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        return None, "\n".join((proc.stdout + proc.stderr).splitlines()[-15:])
    return json.loads(proc.stdout.strip().splitlines()[-1]), None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--json", help="write every turn's times here")
    args = ap.parse_args(argv)
    names = args.only or list(VARIANTS)
    order = ["kept"] + names + ["kept"]
    times, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"kept": make_tree(tmp, "kept", None)}
        for n in names:
            trees[n] = make_tree(tmp, n, VARIANTS[n][0])
        films = {}
        for i, name in enumerate(order):
            out = os.path.join(tmp, f"turn{i}.npz")
            t, err = turn(trees[name], out, args.runs)
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
                      if not np.array_equal(base[k], f[k])]
            if differ:
                print(f"{name}: outputs differ from the kept tree's: "
                      f"{differ}")
                failed.append(name)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(times, fh, indent=1)
    kept = times.get("kept", [])
    print(f"device ms a call (kept: the mean of {len(kept)} turns; "
          f"{args.runs} calls a turn):")
    for name in names:
        if name not in times:
            continue
        for arm in VARIANTS[name][1]:
            k = np.mean([t[f"{arm} device"] for t in kept])
            v = times[name][0][f"{arm} device"]
            spread = (f" (kept turns {kept[0][f'{arm} device']:.4f} / "
                      f"{kept[-1][f'{arm} device']:.4f})")
            print(f"  {name} {arm}: kept {k:.4f}, variant {v:.4f}, "
                  f"variant / kept {v / k:.3f}{spread}")
    print(f"failed or differing: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
