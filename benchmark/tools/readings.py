"""The two readings that a cell's check limits are set between.

    python3 benchmark/tools/readings.py --workload super.frames \\
        --seeds 12 --control-seeds 3 --frames 4 --out readings.json

In one process, at the cell's own size: the program set up once, then for each of ``--seeds`` seeds a
short window of ``--frames`` frames and the run's check of them (the
lower readings); then the control, the reference computed in bfloat16
(the precision below the configuration's float32) put in the program's
place on ``--control-seeds`` other seeds, checked the same way (the upper
readings).  The control renders only the pixels the check reads, which
is all the check can see.  Prints one JSON object and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import check, loop, traffic  # noqa: E402

FIRST_SEED = 3_000_000_019


def program_readings(name, seeds, frames, device_type, overrides=None):
    out = []
    with loop.session(name, device_type, overrides=overrides) as s:
        chk = s.cell.workload["check"]
        stream = traffic.stream(s.cell.traffic, seeds[0])
        for i in range(stream.warmup_frames):
            s.entry.frame(stream.warmup_seed(i))
        for seed in seeds:
            stream = traffic.stream(s.cell.traffic, seed)
            keep = check.Reservoir(int(chk["frames"]) - 1, seed)
            t0 = time.perf_counter()
            times, _ = loop.window(s.entry, stream, frames=frames,
                                   keep=keep)
            vals = check.numbers(s.cfg, s.raw, seed, keep.kept(),
                                 int(chk["pixels"]), s.device)
            out.append({"seed": seed, "values": vals,
                        "frame_ms": times,
                        "seconds": time.perf_counter() - t0})
    return out


def control_readings(name, seeds, frames, device_type, overrides=None):
    """The reference in bfloat16 in the program's place."""
    from benchmark.harness import scenes, spec
    cell = spec.cell(name)
    cfg = dict(cell.config, **(overrides or {}))
    chk = cell.workload["check"]
    raw = scenes.make_scene(cfg["scene"])
    device = torch.device(device_type)
    w, h = cfg["width"], cfg["height"]
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        stream = traffic.stream(cell.traffic, seed)
        keep = check.Reservoir(int(chk["frames"]) - 1, seed)
        for k in range(frames):
            keep.offer(check.Kept(k, stream.request(k)[0], None))
        kept = []
        for k in keep.kept():
            pix = check.pixel_sample(seed, k.index, w, h, int(chk["pixels"]))
            film = check.reference_pixels(cfg, raw, k.seed, pix, device,
                                          dtype=torch.bfloat16).float()
            img = np.zeros((w * h, 4), np.uint8)
            img[pix] = check.reference(cfg).rgba8(film)
            kept.append(check.Kept(k.index, k.seed, img.reshape(h, w, 4)))
        vals = check.numbers(cfg, raw, seed, kept, int(chk["pixels"]),
                             device)
        out.append({"seed": seed, "values": vals,
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    seeds = [FIRST_SEED + 7919 * i for i in range(ns.seeds)]
    cseeds = [FIRST_SEED + 7919 * (ns.seeds + i)
              for i in range(ns.control_seeds)]
    prog = program_readings(ns.workload, seeds, ns.frames, "cuda")
    ctrl = control_readings(ns.workload, cseeds, ns.frames, "cuda")
    keys = sorted({k for r in prog + ctrl for k in r["values"]
                   if k not in ("frames_checked", "pixels_checked")})
    summary = {k: {"program_max": max(r["values"][k] for r in prog),
                   "control_min": min(r["values"][k] for r in ctrl)}
               for k in keys}
    res = {"workload": ns.workload,
           "device": torch.cuda.get_device_name(0), "frames": ns.frames,
           "summary": summary, "program": prog,
           "control": ctrl}
    text = json.dumps(res)
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as fp:
            fp.write(text + "\n")
    print(json.dumps({"workload": ns.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
