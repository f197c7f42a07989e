"""ctypes bindings for the native runtime (``native/pamscene.cpp``).

Port of ``opencl_montecarlo_path_tracing_tpu/utils/native.py``, on the
port's own copy of the source.  The library is built at first use with
``g++ -O2 -fPIC -std=c++17 -shared`` into the package's ``_build/``, its
file name carrying a hash of the source and the flags (as
``utils/build.py`` names the kernels' library), so a changed source
builds anew.  Without a working ``g++`` the loaders return None and the
callers (``scene/formats.py``, ``utils/pam.py``) keep their NumPy paths,
which are the plain versions the library is held to.  ``PT_NO_NATIVE=1``
makes those callers skip the library.  See ``native/pamscene.cpp`` for
the C ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from .build import BUILD_DIR

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "pamscene.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lib = None
_tried = False


def enabled() -> bool:
    """False when ``PT_NO_NATIVE=1`` asks the callers for NumPy."""
    return os.environ.get("PT_NO_NATIVE", "") != "1"


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SOURCE, "rb") as fp:
        h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libpamscene-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless one of the same source exists; returns
    its path.  Raises when ``g++`` is missing or fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build in a private directory, then rename: concurrent first uses
    # never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        subprocess.run([cxx, *CXX_FLAGS, "-o", out, _SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(out, path)
    return path


def load():
    """The loaded library, or None when it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.SubprocessError):
        return None
    lib.pam_write.restype = ctypes.c_int
    lib.pam_write.argtypes = [ctypes.c_char_p] + [ctypes.c_uint32] * 5 + [
        ctypes.c_void_p]
    lib.pam_read.restype = ctypes.c_int
    lib.pam_read.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_uint32)] * 4 + [ctypes.c_void_p,
                                                ctypes.c_uint64]
    lib.scene_parse_bitmap.restype = ctypes.c_int
    lib.scene_parse_bitmap.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int64)]
    lib.scene_parse_triangles.restype = ctypes.c_int
    lib.scene_parse_triangles.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.c_int]
    lib.scene_parse_lights.restype = ctypes.c_int
    lib.scene_parse_lights.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int]
    _lib = lib
    return _lib


def pam_write(path: str, width: int, height: int, channels: int,
              maxval: int, depth: int, data: np.ndarray) -> bool:
    lib = load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data)
    rc = lib.pam_write(path.encode(), width, height, channels, maxval,
                       depth, data.ctypes.data_as(ctypes.c_void_p))
    return rc == 0


def pam_read(path: str):
    """Returns (width, height, channels, maxval, samples ndarray) or None."""
    lib = load()
    if lib is None:
        return None
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    ch = ctypes.c_uint32()
    mv = ctypes.c_uint32()
    if lib.pam_read(path.encode(), w, h, ch, mv, None, 0) != 0:
        return None
    depth = 16 if mv.value > 255 else 8
    mem_ch = ch.value + (1 if ch.value == 3 else 0)
    dtype = np.uint16 if depth == 16 else np.uint8
    buf = np.empty(w.value * h.value * mem_ch, dtype)
    rc = lib.pam_read(path.encode(), w, h, ch, mv,
                      buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
    if rc != 0:
        return None
    return w.value, h.value, ch.value, mv.value, buf


def parse_bitmap(path: str):
    lib = load()
    if lib is None:
        return None
    out = (ctypes.c_int64 * 9)()
    if lib.scene_parse_bitmap(path.encode(), out) != 0:
        return None
    return np.array(out[:], np.int64)


def parse_triangles(path: str, max_triangles: int):
    lib = load()
    if lib is None:
        return None
    buf = np.zeros(max_triangles * 9, np.float32)
    n = lib.scene_parse_triangles(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_triangles)
    if n < 0:
        return None
    return buf[:n * 9].reshape(n, 3, 3)


def parse_lights(path: str, max_lights: int):
    lib = load()
    if lib is None:
        return None
    buf = np.zeros(max_lights * 4, np.float32)
    n = lib.scene_parse_lights(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_lights)
    if n < 0:
        return None
    return buf[:n * 4].reshape(n, 4)
