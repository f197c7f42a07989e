"""Parsers for the reference's text scene formats (SURVEY.md section 2.9).

Port of ``opencl_montecarlo_path_tracing_tpu/scene/formats.py``.  Each
parser takes the native C++ one (utils/native.py) when it builds, unless
``PT_NO_NATIVE=1``; the NumPy code below is the plain version it is held
to.

Formats (reference parsers cited per function):

* spheres.txt / squares.txt - exactly 9 integers, one per line: a 9-row x
  19-bit bitmap. Bit k of row j places a unit sphere at (k, 0, j+4) or a
  2x2 axis-aligned square on plane z = j+4 centred at x=k with |y| < 1.
* triangles.txt - 13 lines per triangle: 3x(x,y,z lines each followed by a
  blank separator), then one more blank line; trailing separators may be
  missing at EOF (the main scene file ends mid-frame and the reference's
  fgets-based parser still yields the final triangle).
* lights.txt - 4 lines per point light: x, y, z, intensity; at most 5
  lights (MAX_LIGHTS, CLSuperPathTracer.c:15).
"""

from __future__ import annotations

import numpy as np

MAX_TRIANGLES = 65536  # trianglegrid variant's cap (.c:15); plain variants use 512
MAX_LIGHTS = 5         # CLSuperPathTracer.c:15


def _atof(line: str) -> float:
    """C atof semantics on decimal forms: parse a leading float, 0.0 on
    failure.  Candidates containing '_' are rejected (Python's float()
    accepts PEP 515 digit separators, C strtod does not); C99 hex floats
    are a non-goal - the reference's files are decimal."""
    s = line.strip()
    if not s:
        return 0.0
    # longest valid prefix
    for end in range(len(s), 0, -1):
        cand = s[:end]
        if "_" in cand:
            continue
        try:
            return float(cand)
        except ValueError:
            continue
    return 0.0


def _atoi(line: str) -> int:
    """C strtoll semantics: leading int, 0 on failure, SATURATING at the
    int64 range on overflow (strtoll sets ERANGE and returns LLONG_MAX /
    LLONG_MIN; Python's unbounded int would overflow the int64 bitmap
    array - found by tests/test_formats_property.py)."""
    s = line.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    v = int(s[:j])
    return max(-(2 ** 63), min(2 ** 63 - 1, v))


def _native():
    from ..utils import native
    return native if native.enabled() else None


def parse_array_file(path: str) -> np.ndarray:
    """9-int bitmap file (parseArrayFromFile, CLSuperPathTracer.c:62-74)."""
    nat = _native()
    if nat is not None:
        got = nat.parse_bitmap(path)
        if got is not None:
            return got
    out = np.zeros(9, np.int64)
    with open(path) as fp:
        lines = fp.readlines()
    for i in range(min(9, len(lines))):
        out[i] = _atoi(lines[i])
    return out


def parse_triangles_file(path: str, max_triangles: int = MAX_TRIANGLES) -> np.ndarray:
    """Triangle list (parseTrianglesFromFile, CLSuperPathTracer.c:77-118).

    Returns (n, 3, 3) float32 vertex array. The reference reads 13 lines per
    triangle (9 coordinate lines + 4 separators); a final frame with all 9
    coordinate lines but missing trailing separators is still accepted.
    """
    nat = _native()
    if nat is not None:
        got = nat.parse_triangles(path, max_triangles)
        if got is not None:
            return got
    with open(path) as fp:
        lines = fp.readlines()
    tris = []
    pos = 0
    n = len(lines)
    while pos < n and len(tris) < max_triangles:
        # 3 vertices of 3 coordinate lines, separated by one blank line each
        coords = []
        p = pos
        ok = True
        for v in range(3):
            if p + 3 > n:
                ok = False
                break
            coords.append([_atof(lines[p]), _atof(lines[p + 1]), _atof(lines[p + 2])])
            p += 3
            if v < 2:
                p += 1  # END_VERTEX separator (may be absent at EOF)
        if not ok:
            break
        tris.append(coords)
        pos = p + 2  # trailing END_VERTEX + END_TRIANGLE separators
    # over-range decimals cast to inf, C strtof's HUGE_VALF - silently
    with np.errstate(over="ignore"):
        return np.asarray(tris, np.float32).reshape(-1, 3, 3)


def parse_lights_file(path: str, max_lights: int = MAX_LIGHTS) -> np.ndarray:
    """Point lights (parseLightsFromFile, CLSuperPathTracer.c:121-139).

    Returns (n, 4) float32: x, y, z, intensity.
    """
    nat = _native()
    if nat is not None:
        got = nat.parse_lights(path, max_lights)
        if got is not None:
            return got
    with open(path) as fp:
        lines = [ln for ln in fp.readlines()]
    out = []
    pos = 0
    while pos + 4 <= len(lines) and len(out) < max_lights:
        out.append([_atof(lines[pos]), _atof(lines[pos + 1]),
                    _atof(lines[pos + 2]), _atof(lines[pos + 3])])
        pos += 4
    with np.errstate(over="ignore"):
        return np.asarray(out, np.float32).reshape(-1, 4)
