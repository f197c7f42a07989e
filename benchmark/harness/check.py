"""The comparison that decides ``correct``.

Frames to check are drawn from ``--seed`` while the window runs (a
reservoir sample of the frames before the last, and the last frame), so
a run keeps only the frames it may check.  After the window each checked
frame is compared on a sample of its pixels, drawn from the seed, with
the plain reference (``benchmark/reference/``), which renders those
pixels from the raw scene and the frame's seed, every sample of each:

* ``px_differ_share``: the share of sampled pixels whose RGBA8 value
  differs in any channel from the reference's;
* ``mean_abs_steps``: the mean absolute difference over the sampled RGB
  channels, in steps of the 8-bit scale.

A number is compared when the cell's file gives it a limit; ``correct``
is true when the window rendered frames and every compared number is at
or under its limit.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from benchmark.harness import spec

_TAG = 0xC0FFEE


@dataclasses.dataclass
class Kept:
    index: int
    seed: int
    image: np.ndarray


class Reservoir:
    """``size`` frames drawn uniformly, as they come, from every frame
    but the last, plus the last; a pure function of the seed and the
    number of frames."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = random.Random((int(seed) << 24) ^ _TAG)
        self.items: list = []
        self.last = None
        self.seen = 0

    def offer(self, item) -> None:
        if self.last is not None:
            if self.seen < self.size:
                self.items.append(self.last)
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < self.size:
                    self.items[j] = self.last
            self.seen += 1
        self.last = item

    def kept(self) -> list:
        out = list(self.items) + ([self.last] if self.last is not None
                                  else [])
        return sorted(out, key=lambda k: k.index)


def pixel_sample(seed: int, index: int, width: int, height: int,
                 count: int) -> np.ndarray:
    """The flat pixel indices checked in frame ``index``, drawn from the
    run's seed."""
    g = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                               int(index), _TAG])
    n = width * height
    return np.sort(g.choice(n, size=min(count, n), replace=False))


def reference(cfg: dict):
    """The module of the configuration's plain reference."""
    return spec.plugin("reference", cfg["reference"])


def reference_pixels(cfg: dict, raw_scene: dict, frame_seed: int,
                     pixels: np.ndarray, device, dtype=torch.float32,
                     geometry=None) -> torch.Tensor:
    """The reference's pre-ambient film at ``pixels`` of one frame."""
    ref = reference(cfg)
    g = geometry if geometry is not None else ref.geometry(raw_scene, device,
                                                           dtype)
    return ref.film_pixels(g, frame_seed, pixels, cfg["width"], cfg["spp"],
                           quirks=cfg.get("quirks"))


def numbers(cfg: dict, raw_scene: dict, run_seed: int, kept: list,
            pixels: int, device) -> dict:
    """The compared numbers of the kept frames."""
    ref = reference(cfg)
    g = ref.geometry(raw_scene, device)
    wrap = bool(cfg.get("quirks", {}).get("wrap_uint8", False))
    differ = total = 0
    steps = []
    for k in kept:
        pix = pixel_sample(run_seed, k.index, cfg["width"], cfg["height"],
                           pixels)
        want_film = reference_pixels(cfg, raw_scene, k.seed, pix, device,
                                     geometry=g)
        want = ref.rgba8(want_film, wrap=wrap).astype(np.int64)
        got = np.asarray(k.image).reshape(-1, 4)[pix].astype(np.int64)
        diff = np.abs(got - want)
        differ += int((diff.max(axis=1) > 0).sum())
        total += len(pix)
        steps.append(diff[:, :3].astype(np.float64).reshape(-1))
    out = {"frames_checked": len(kept), "pixels_checked": total}
    if total:
        out["px_differ_share"] = differ / total
        out["mean_abs_steps"] = float(np.concatenate(steps).mean())
    return out


def verdict(values: dict, limits: dict, frames: int) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) of the compared numbers;
    a run that rendered no frame is not correct."""
    shown = {}
    ok = frames > 0
    for name, limit in limits.items():
        v = values.get(name)
        shown[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, shown
