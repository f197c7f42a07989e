"""The benchmark's one command: one run of one cell.

    python3 benchmark/run.py --workload super.frames --seed 7 \\
        --seconds 32 --trace 0

From the root of a checkout that holds the program
(``opencl_montecarlo_path_tracing_tpu_torch``), on a machine with as many
CUDA devices as the cell's ``chips``.  It renders the cell's frames in a
closed loop for ``--seconds``, checks a sample of them against the plain
reference, and prints one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics from a
``torch.profiler`` trace of the window with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number
compared beside its limit, which are also the last lines of standard
error, after a line ``setup_split`` of the seconds that each stage of
the set-up took.  It exits with another code than 0, and prints no
result, when CUDA or the cell's devices are missing, when the program is
not there, or when the run loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Keep the kernel caches a run may write at fixed paths inside the
    checkout, so that only a checkout's first run builds (the program
    builds its CUDA kernels under its package's ``_build/``; these cover
    Triton, torch's extension builds and CUDA's JIT cache)."""
    base = os.path.join(_ROOT, "_bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(base, "nv"))


def _now() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def main(argv=None) -> int:
    marks = {"interpreter": _now()}
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    if ns.seconds <= 0:
        ap.error("--seconds must be positive")
    _caches()
    sys.path.insert(0, _ROOT)

    import torch
    from benchmark.harness import spec
    marks["import_torch"] = _now()

    cell = spec.cell(ns.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"error: {ns.workload} needs {chips} CUDA devices; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import opencl_montecarlo_path_tracing_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 1
    marks["import_program"] = _now()

    from benchmark.harness import loop
    out = loop.run_cell(ns.workload, ns.seed, seconds=ns.seconds,
                        trace_on=bool(ns.trace), marks=marks)
    if out["forbidden"]:
        print("error: JAX or the JAX package was loaded: "
              f"{out['forbidden']}", file=sys.stderr)
        return 3
    print("setup_split " + json.dumps(out["setup_split"]), file=sys.stderr)
    for name, v in out["shown"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(out["result"], check=out["shown"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
