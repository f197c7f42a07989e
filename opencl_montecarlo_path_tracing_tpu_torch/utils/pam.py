"""PAM (P7) image IO, byte-compatible with the reference's pamalign.h.

The reference writes files named ``result.ppm`` that are actually PAM (P7)
RGBA images (pamalign.h:131, header write pamalign.h:218-224).  This module
reproduces the exact header bytes and sample order so outputs are
bit-comparable with the committed golden renders
(e.g. the reference's CLSuperPathTracer/result.ppm).

Port of ``opencl_montecarlo_path_tracing_tpu/utils/pam.py``.  The native
C++ reader and writer (utils/native.py) are used when they build, unless
``PT_NO_NATIVE=1``; the NumPy code below is the plain version, which
writes the same bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_TUPLTYPE = {
    1: "GRAYSCALE",
    2: "GRAYSCALE_ALPHA",
    3: "RGB",
    4: "RGB_ALPHA",
}


@dataclasses.dataclass
class ImgInfo:
    """Mirror of pamalign.h's imgInfo (pamalign.h:13-21)."""
    width: int
    height: int
    channels: int = 4
    maxval: int = 255
    depth: int = 8  # bits per value
    data: np.ndarray | None = None  # flat uint8/uint16 sample array


def _header_bytes(img: ImgInfo) -> bytes:
    # Exact field order and formatting of save_pam (pamalign.h:218-224).
    return (
        b"P7\n"
        + b"WIDTH %d\n" % img.width
        + b"HEIGHT %d\n" % img.height
        + b"DEPTH %d\n" % img.channels
        + b"MAXVAL %d\n" % img.maxval
        + b"TUPLTYPE %s\n" % _TUPLTYPE[img.channels].encode()
        + b"ENDHDR\n"
    )


def save_pam(fname: str, img: ImgInfo) -> None:
    """Write a PAM file. ``img.data`` is the flat sample array; 3-channel
    data must already be padded to 4 in memory (pamalign.h:187) - the writer
    skips every 4th sample in that case, matching pamalign.h:226-234."""
    from . import native
    if native.enabled():
        data = np.asarray(img.data)
        data = data.astype(np.uint16 if img.depth == 16 else np.uint8)
        if native.pam_write(fname, img.width, img.height, img.channels,
                            img.maxval, img.depth, data):
            return
    data = np.asarray(img.data)
    if img.depth == 8:
        data = data.astype(np.uint8)
    elif img.depth == 16:
        data = data.astype(">u2")  # big-endian sample order (pamalign.h:156-159)
    else:
        raise ValueError(f"unsupported depth {img.depth}")
    flat = data.reshape(-1)
    if img.channels == 3:
        # in-memory stride is 4; drop the pad channel on disk
        flat = flat.reshape(-1, 4)[:, :3].reshape(-1)
    with open(fname, "wb") as fp:
        fp.write(_header_bytes(img))
        fp.write(flat.tobytes())


def load_pam(fname: str) -> ImgInfo:
    from . import native
    if native.enabled():
        got = native.pam_read(fname)
        if got is not None:
            w, h, ch, mv, samples = got
            mem_ch = ch + (1 if ch == 3 else 0)
            return ImgInfo(width=w, height=h, channels=ch, maxval=mv,
                           depth=16 if mv > 255 else 8,
                           data=samples.reshape(h, w, mem_ch)
                           if mem_ch > 1 else samples.reshape(h, w))
    with open(fname, "rb") as fp:
        raw = fp.read()
    if not raw.startswith(b"P7\n"):
        raise ValueError(f"not a PAM file: {fname}")
    # header is whitespace-separated token lines until ENDHDR (pamalign.h:51-129)
    end = raw.index(b"ENDHDR\n") + len(b"ENDHDR\n")
    fields = {}
    for line in raw[3:end].decode("ascii", "replace").splitlines():
        parts = line.split()
        if len(parts) >= 2:
            fields[parts[0]] = parts[1]
    width = int(fields["WIDTH"])
    height = int(fields["HEIGHT"])
    channels = int(fields["DEPTH"])
    maxval = int(fields["MAXVAL"])
    depth = 16 if maxval > 255 else 8
    body = raw[end:]
    if depth == 8:
        samples = np.frombuffer(body, np.uint8, count=width * height * channels)
    else:
        samples = np.frombuffer(body, ">u2", count=width * height * channels).astype(np.uint16)
    if channels == 3:
        # pad 3 to 4 channels in memory like load_pam (pamalign.h:187)
        padded = np.zeros((width * height, 4), samples.dtype)
        padded[:, :3] = samples.reshape(-1, 3)
        samples = padded.reshape(-1)
        channels_mem = 4
    else:
        channels_mem = channels
    return ImgInfo(width=width, height=height, channels=channels,
                   maxval=maxval, depth=depth,
                   data=samples.reshape(height, width, channels_mem)
                   if channels_mem > 1 else samples.reshape(height, width))


def film_to_rgba16(film, ambient=(13.0, 13.0, 13.0)) -> np.ndarray:
    """Quantise a float film (H, W, 3) to 16-bit RGBA (maxval 65535).

    The reference IO layer round-trips 16-bit PAM (pamalign.h:156-166 read,
    :226-231 write) but its tracers only ever emit 8-bit; this maps the
    same display scale [0, 255] linearly onto [0, 65535], saturating (the
    wrap quirk is an 8-bit convert_uchar4 artefact with no 16-bit
    analogue)."""
    film = np.asarray(film, np.float32) + np.asarray(ambient, np.float32)
    rgb = np.clip(np.round(film * (65535.0 / 255.0)), 0, 65535)
    rgb = rgb.astype(np.uint16)
    h, w, _ = rgb.shape
    out = np.empty((h, w, 4), np.uint16)
    out[..., :3] = rgb
    out[..., 3] = 65535
    return out


def film_to_rgba8(film, ambient=(13.0, 13.0, 13.0), wrap: bool = False) -> np.ndarray:
    """Quantise a float film (H, W, 3) to the reference's RGBA8 layout.

    ``wrap=True`` reproduces the reference's non-saturating convert_uchar4
    (pathtracer.ocl:240); the default saturates.
    Alpha is 255 (pathtracer.ocl:239).
    """
    film = np.asarray(film, np.float32) + np.asarray(ambient, np.float32)
    if wrap:
        rgb = np.trunc(film).astype(np.int64) & 0xFF
        rgb = rgb.astype(np.uint8)
    else:
        rgb = np.clip(np.trunc(film), 0, 255).astype(np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255
    return out
