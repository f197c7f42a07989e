"""The dense VLP gather kernel (kernel B6): wrapper and plain version.

``gather_vlps_mxu(x, n, vlps)`` returns, for (R, 3) shading points ``x``
with normals ``n``, the (R,) float32 sum over the (V, 4) VLP table of

    a = n.p - n.x,  b = |p|^2 - 2 x.p + |x|^2,  r = 1/sqrt(max(b, 1e-12))
    c = max(a, 0) * min(max(I, 0) * r^3, r)

- the same contract as ``ops/vlp.py::gather_vlps``.  On a CUDA device it
launches the hand-written kernel ``csrc/gather_vlp.cu``, which replaces
the TPU kernel ``opencl_montecarlo_path_tracing_tpu/ops/pallas_vlp.py::
gather_vlps_mxu`` -> ``_kernel`` (two K=16 matrix products there; scalar
FP32 here, since the expansion of b cancels under bf16 or TF32 inputs).

The kernel reads the table live rows first, with the live count on the
device (``ops/vlp.py::live_table``, the layout of B4's dense table): a
dead row (I <= 0) adds exactly +0.0 to a finite sum, so the live rows
alone give the full table's sum bit for bit.  A caller that gathers
against one table many times - the tier-1 render, 16 calls a render -
builds it once and passes it instead of the (V, 4) table.

``gather_vlps_mxu_plain`` is the same formula in elementwise PyTorch,
chunked over V and summed in ascending VLP order; it uses no matrix
product, so no TF32 setting can reach it.  The wrapper takes it only when
the tensors lie on the CPU.
"""

from __future__ import annotations

import torch

from .vlp import LiveTable, live_table

#: Launches of the CUDA kernel since the last reset (the wrapper adds one
#: per launch and nowhere else).
LAUNCHES = 0

_CHUNK = 256     # VLPs per elementwise (points x chunk) pass of the plain form


def _vlp_constants(vlps):
    p = vlps[:, :3].to(torch.float32)
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    p2s = p0 * p0 + p1 * p1 + p2 * p2
    vi = torch.clamp_min(vlps[:, 3].to(torch.float32), 0.0)
    return p0, p1, p2, p2s, vi


def gather_vlps_mxu_plain(x, n, vlps):
    """Plain PyTorch version of :func:`gather_vlps_mxu`, on any device, over
    the (V, 4) table ``vlps`` (or a :class:`LiveTable`'s)."""
    if isinstance(vlps, LiveTable):
        vlps = vlps.vlps
    shape = x.shape[:-1]
    x = x.reshape(-1, 3)
    n = n.reshape(-1, 3)
    xx, xy, xz = (x[:, i:i + 1] for i in range(3))
    nx, ny, nz = (n[:, i:i + 1] for i in range(3))
    ndx = nx * xx + ny * xy + nz * xz
    x2 = xx * xx + xy * xy + xz * xz
    p0, p1, p2, p2s, vi = _vlp_constants(vlps)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for c0 in range(0, vlps.shape[0], _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        a = (nx * p0[sl] + ny * p1[sl] + nz * p2[sl]) - ndx
        b = p2s[sl] - 2.0 * (xx * p0[sl] + xy * p1[sl] + xz * p2[sl]) + x2
        r = 1.0 / torch.sqrt(torch.clamp_min(b, 1e-12))
        c = torch.clamp_min(a, 0.0) * torch.minimum(vi[sl] * (r * r * r), r)
        for j in range(c.shape[1]):
            acc = acc + c[:, j]
    return acc.reshape(shape)


def gather_vlps_mxu(x, n, vlps):
    """Dense VLP gather against the (V, 4) table ``vlps`` or its
    :class:`LiveTable`: one launch of the CUDA kernel for tensors on a CUDA
    device, :func:`gather_vlps_mxu_plain` for tensors on the CPU.  The
    kernel sums each point's live rows in table order, the plain version's
    order, so the two agree bit for bit on finite lanes."""
    global LAUNCHES
    if x.device.type == "cpu":
        return gather_vlps_mxu_plain(x, n, vlps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    shape = x.shape[:-1]
    xf = x.reshape(-1, 3).to(torch.float32).contiguous()
    nf = n.reshape(-1, 3).to(torch.float32).contiguous()
    table = vlps if isinstance(vlps, LiveTable) else live_table(
        vlps.to(x.device))
    R, V = int(xf.shape[0]), int(table.tab.shape[0])
    if R >= 1 << 31 or V >= 1 << 28:
        raise ValueError(f"{R} points x {V} VLPs exceed the kernel's int32 "
                         "indexing")
    out = torch.empty(R, dtype=torch.float32, device=x.device)
    for name, t, dt in (("x", xf, torch.float32), ("n", nf, torch.float32),
                        ("vlp table", table.tab, torch.float32),
                        ("n_live", table.n_live, torch.int32)):
        if t.device != out.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{out.device}")
    if table.tab.shape[1] != 8:
        raise ValueError(f"bad VLP table shape {tuple(table.tab.shape)}")
    from ..utils.build import load
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gather_vlp_launch(xf.data_ptr(), nf.data_ptr(),
                                    table.tab.data_ptr(),
                                    table.n_live.data_ptr(), R, V,
                                    out.data_ptr(), stream)
    if err != 0:
        msg = lib.gather_vlp_error_string(err).decode()
        raise RuntimeError(
            f"gather_vlp launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out.reshape(shape)
