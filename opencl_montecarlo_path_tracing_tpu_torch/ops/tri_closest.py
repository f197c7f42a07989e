"""Closest triangle per ray in the matmul formulation (kernel B7): wrapper
and plain version.

``triangle_closest(o, d, scn, quirks)`` returns, for (R, 3) ray origins and
directions, the (R,) float32 distance of the closest valid triangle hit
(``inf`` on a miss) and its (R,) int64 index (0 on a miss).  Moller-Trumbore
is written as features (R, 13) x weights (13, 4*Nt) - ``intersect.py::
_ray_features`` and ``_triangle_weights`` - giving det, u*det, v*det and
t*det per pair, then the validity epilogue (``inv = 1/det``, ``u = un*inv``)
and a min/argmin per ray in 512-triangle chunks: the minimum goes to the
first index within a chunk, and a later chunk must be strictly better, so
the result is the lowest index of the smallest distance.

On a CUDA tensor it launches the hand-written kernel ``csrc/tri_closest.cu``,
which replaces the TPU kernel ``opencl_montecarlo_path_tracing_tpu/ops/
pallas_tri.py::triangle_closest`` -> ``_run`` -> ``_kernel``.  The kernel
sums the K=13 products in ascending feature order in plain FP32 (no tensor
cores, no TF32: the expanded weights cancel).

``triangle_closest_plain`` is the same function as chunked float32 matmuls
in PyTorch, on any device, with TF32 switched off while it runs on the
card (``torch.backends.cuda.matmul.allow_tf32 = False``).  The wrapper
takes it only when the tensors lie on the CPU.  The two sum the K terms in
different orders, so ``t`` agrees to the rounding of those cancelling
sums, not bit for bit (tests/test_torch_gpu.py states the tolerance).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quirks import Quirks
from .intersect import SceneArrays, _mxu_valid, _ray_features, derived

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

TRI_CHUNK = 512    # triangles per min/argmin step (ops/pallas_tri.py)
_INF = float("inf")


def _padded_weights(scn: SceneArrays) -> tuple[np.ndarray, int]:
    """(4, 16, ntp) weights: feature dim padded 13 -> 16, triangle count
    padded to a multiple of TRI_CHUNK with zero columns (det == 0 never
    hits) - the JAX package's table, bit for bit."""
    nt = scn.tri_v0.shape[0]
    ntp = max(TRI_CHUNK, -(-nt // TRI_CHUNK) * TRI_CHUNK)
    w = np.zeros((4, 16, ntp), np.float32)
    w13 = scn.tri_w.reshape(13, 4, nt)
    for q in range(4):
        w[q, :13, :nt] = w13[:, q, :]
    return w, ntp


def _features(o, d):
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    return _ray_features(ox, oy, oz, dx, dy, dz).to(torch.float32)


def _clip_index(idx, nt: int):
    return torch.clamp(idx, 0, max(nt - 1, 0))


def triangle_closest_plain(o, d, scn: SceneArrays, quirks: Quirks):
    """Plain PyTorch version of :func:`triangle_closest`, on any device."""
    nt = int(scn.tri_v0.shape[0])
    f = _features(o, d)                                  # (R, 13)
    w = weights_on(scn, f.device)                        # (ntp, 4, 16)
    ntp = int(w.shape[0])
    best_t = torch.full(f.shape[:1], _INF, dtype=torch.float32,
                        device=f.device)
    best_i = torch.zeros(f.shape[:1], dtype=torch.int64, device=f.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for col in range(0, ntp, TRI_CHUNK):
            det, un, vn, tn = (f @ w[col:col + TRI_CHUNK, q, :13].T
                               for q in range(4))
            ok, rd = _mxu_valid(det, un, vn, tn, quirks)  # det 0 on padding
            rd = torch.where(ok, rd, _INF)
            ct, ci = torch.min(rd, dim=-1)     # first index of the minimum
            better = ct < best_t
            best_t = torch.where(better, ct, best_t)
            best_i = torch.where(better, ci + col, best_i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return best_t, _clip_index(best_i, nt)


def triangle_closest(o, d, scn: SceneArrays, quirks: Quirks):
    """(best_t (R,), best_index (R,)) - ``inf`` / a clipped index on a
    miss.  A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes :func:`triangle_closest_plain`."""
    global LAUNCHES
    if o.device.type == "cpu":
        return triangle_closest_plain(o, d, scn, quirks)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    nt = int(scn.tri_v0.shape[0])
    f = _features(o, d).contiguous()
    R = int(f.shape[0])
    w = weights_on(scn, f.device)
    t = torch.empty(R, dtype=torch.float32, device=f.device)
    idx = torch.empty(R, dtype=torch.int32, device=f.device)
    if R == 0:
        return t, idx.to(torch.int64)
    for name, a in (("features", f), ("weights", w), ("t", t)):
        if a.dtype != torch.float32 or not a.is_contiguous() \
                or a.device != f.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {f.device}")
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.tri_closest_launch(
            f.data_ptr(), R, w.data_ptr(), nt,
            int(bool(quirks.accept_negative_t)), t.data_ptr(),
            idx.data_ptr(), stream)
    if err != 0:
        msg = lib.tri_closest_error_string(err).decode()
        raise RuntimeError(
            f"tri_closest launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return t, _clip_index(idx.to(torch.int64), nt)


def weights_on(scn: SceneArrays, device) -> torch.Tensor:
    """:func:`_padded_weights` as an (ntp, 4, 16) float32 tensor on
    ``device``: each triangle's 64 weights contiguous, so the kernel stages
    a chunk with one linear copy.  Built once per prepared scene (a render
    calls B7 once per trace with the same mesh)."""
    def make(scn):
        w_np, _ = _padded_weights(scn)
        return torch.from_numpy(
            np.ascontiguousarray(w_np.transpose(2, 0, 1))).to(device)
    return derived(scn, "tri_closest.weights", device, make)
