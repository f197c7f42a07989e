"""Builds the CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
under ``_build/`` inside this package; the directory is not committed.
Device code shared between kernels lives in ``csrc/*.cuh`` headers inside
anonymous namespaces, so the objects never collide on a symbol.  The
library's file name carries a hash of the sources and the flags, so a
changed source builds anew and an unchanged one is loaded as it is.  The
C entry points take device pointers and the CUDA stream as ``void*`` and
return ``cudaGetLastError()``.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``--fmad=false`` so that ``a*b+c``
is not contracted to an FMA (the kernels keep the reference's float
operation order), and never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-O3", "--fmad=false", "-std=c++17", "-Xcompiler",
                      "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# C signatures: (restype, argtypes); every pointer and the stream is a
# c_void_p, or ctypes would pass it as a 32-bit int
_SIGNATURES = {
    "mega_super_launch": (_I, [_P, _I, _I, _I, _I, _U, _U, _U, _U, _U,
                               _I, _I, _I, _I, _I, _P, _P]),
    "mega_super_error_string": (ctypes.c_char_p, [_I]),
    "mega_vlp_launch": (_I, [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                             _P, _I, _I, _I, _U, _U, _U, _U, _U, _I, _I,
                             _I, _I, _P, _I, _I, _I, _P, _P, _F, _I, _P,
                             _P, _P]),
    "mega_vlp_error_string": (ctypes.c_char_p, [_I]),
    "gather_vlp_launch": (_I, [_P, _P, _P, _P, _I, _I, _P, _P]),
    "gather_vlp_error_string": (ctypes.c_char_p, [_I]),
    "mega_blocked_launch": (_I, [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _U, _U, _U, _U, _U, _I, _I, _I, _I,
                                 _I, _P, _P, _P]),
    "mega_blocked_error_string": (ctypes.c_char_p, [_I]),
    "tri_closest_launch": (_I, [_P, _I, _P, _I, _I, _P, _P, _P]),
    "tri_closest_error_string": (ctypes.c_char_p, [_I]),
    "mega_simple_launch": (_I, [_P, _I, _P, _I, _U, _U, _U, _U, _U, _I, _I,
                                _I, _I, _I, _P, _P]),
    "mega_simple_error_string": (ctypes.c_char_p, [_I]),
    "diag_dda_closest_launch": (_I, [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P,
                                     _P, _P, _P, _P]),
    "diag_dda_occ_launch": (_I, [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _P, _P, _P, _P]),
    "diag_dda_occupancy": (_I, [_I, _P]),
    "diag_dda_error_string": (ctypes.c_char_p, [_I]),
    "diag_takelist_launch": (_I, [_I, _P, _P, _I, _I, _P, _P, _P]),
    "diag_takelist_error_string": (ctypes.c_char_p, [_I]),
    "diag_loops_launch": (_I, [_I, _P, _P, _P, _I, _I, _P, _P]),
    "diag_loops_error_string": (ctypes.c_char_p, [_I]),
    "light_emit_launch": (_I, [_P, _I, _I, _I, _I, _P, _P, _P, _I, _U, _U,
                               _U, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P,
                               _P, _P, _I, _P]),
    "light_mlt_seed_launch": (_I, [_P, _I, _I, _I, _I, _P, _P, _P, _I, _U,
                                   _U, _U, _I, _I, _F, _F, _F, _F, _P, _P,
                                   _P, _P, _P, _I, _P]),
    "light_mlt_chain_launch": (_I, [_P, _I, _I, _I, _I, _P, _P, _P, _I, _U,
                                    _U, _U, _I, _I, _I, _F, _F, _F, _F, _I,
                                    _F, _F, _P, _P, _P, _P, _P, _P, _I,
                                    _P]),
    "light_pass_error_string": (ctypes.c_char_p, [_I]),
    "mega_grid_launch": (_I, [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                              _U, _U, _U, _U, _U, _I, _I, _I, _I, _I, _P, _P,
                              _P]),
    "grid_walk_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P,
                              _I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P,
                              _P, _P, _P, _I, _I, _P, _P]),
    "mega_grid_error_string": (ctypes.c_char_p, [_I]),
}

_LIB = None   # the loaded library handle


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str        # the shared library
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc's output (ptxas register / spill report)


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fp:
            h.update(fp.read())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` unless a library of the same sources exists:
    one ``nvcc -c`` per source, all running at once, then one link."""
    tag = _digest()
    lib_path = os.path.join(BUILD_DIR, f"libpt_kernels-{tag}.so")
    log_path = os.path.join(BUILD_DIR, f"build-{tag}.log")
    if os.path.isfile(lib_path):
        log = ""
        if os.path.isfile(log_path):
            with open(log_path) as fp:
                log = fp.read()
        return BuildInfo(lib_path, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    t0 = time.perf_counter()
    # build in a private directory, then rename the library: concurrent
    # first uses from several processes never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p)[:-3] + ".o")
                for p in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cu, objs)]
        logs, failed = [], []
        for p, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append(f"== {os.path.basename(p)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(p))
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp_lib,
                               *objs], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
        seconds = time.perf_counter() - t0
        with open(log_path, "w") as fp:
            fp.write(log)
        os.replace(tmp_lib, lib_path)
    return BuildInfo(lib_path, seconds, log)


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use; signatures declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build().path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def dump_sass(out_dir: str) -> None:
    """Build, then write the library's SASS (``cuobjdump -sass``) to
    ``out_dir/kernels.sass`` and nvcc's log (ptxas registers and spills)
    to ``out_dir/build.log``."""
    info = build()
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", info.path], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    for name, text in (("kernels.sass", sass), ("build.log", info.log)):
        with open(os.path.join(out_dir, name), "w") as fp:
            fp.write(text)


if __name__ == "__main__":
    # python -m opencl_montecarlo_path_tracing_tpu_torch.utils.build [DIR]:
    # build, and with DIR write the SASS and the build log there
    import sys
    if len(sys.argv) > 1:
        dump_sass(sys.argv[1])
    else:
        print(build().path)
