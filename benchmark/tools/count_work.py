"""Counts a cell's roofline work with the reference and writes it to
``benchmark/work/<cell>.json``.

    python3 benchmark/tools/count_work.py --workload super.frames \\
        --pixels 16384 --seed 1 [--device cpu]

The reference renders every sample of ``--pixels`` pixels drawn from
``--seed`` (frame seed ``--seed``) and counts the traces its path rules
make: one camera trace a sample, and one shadow trace a light for each
surface point that faces it (``lamb < 0 || TraceRay(...)``).  The mean
traces a path, times the frame's W x H x spp paths, is the frame's trace
count; each trace costs at least one ray-triangle test
(``OPS_PER_TEST`` FP32 operations).  The bytes are the raw scene read
once and the float film written once.  Nothing of the program is
imported, so the count is the same whatever renders the frame.
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

from benchmark.harness import scenes, spec  # noqa: E402


def count(cfg: dict, pixels: int, seed: int, device) -> dict:
    ref = spec.plugin("reference", cfg["reference"])
    raw = scenes.make_scene(cfg["scene"])
    g = ref.geometry(raw, device)
    w, h, spp = cfg["width"], cfg["height"], cfg["spp"]
    pix = np.sort(np.random.default_rng(seed).choice(w * h, size=pixels,
                                                     replace=False))
    counts = {"primary": 0, "shadow": 0}
    t0 = time.perf_counter()
    ref.film_pixels(g, seed, pix, w, spp, quirks=cfg.get("quirks"),
                           counts=counts)
    paths = pixels * spp
    per_path = (counts["primary"] + counts["shadow"]) / paths
    frame_paths = w * h * spp
    frame_traces = int(round(per_path * frame_paths))
    sb = scenes.scene_bytes(raw)
    film_bytes = w * h * 3 * 4
    return {
        "counted_by": f"benchmark/reference/{cfg['reference']}.py"
                      "::film_pixels",
        "tool": "benchmark/tools/count_work.py",
        "seed": seed, "sample_pixels": pixels, "spp": spp,
        "sample_paths": paths, "primary": counts["primary"],
        "shadow": counts["shadow"], "traces_per_path": per_path,
        "frame_paths": frame_paths, "frame_traces": frame_traces,
        "ops_per_test": ref.OPS_PER_TEST,
        "frame_ops": frame_traces * ref.OPS_PER_TEST,
        "scene_bytes": sb, "film_bytes": film_bytes,
        "frame_bytes": sb + film_bytes,
        "derivation": (
            f"traces_per_path = (primary + shadow) / sample_paths = "
            f"({counts['primary']} + {counts['shadow']}) / {paths}; "
            f"frame_traces = traces_per_path * {w}*{h}*{spp}; frame_ops = "
            f"frame_traces * {ref.OPS_PER_TEST}; frame_bytes = "
            f"scene_bytes + {w}*{h}*3*4 (the float film)"),
        "seconds": round(time.perf_counter() - t0, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--pixels", type=int, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    cell = spec.cell(ns.workload)
    work = dict(cell=ns.workload, **count(cell.config, ns.pixels, ns.seed,
                                         torch.device(ns.device)))
    out = os.path.join(spec.BENCH_DIR, "work", f"{ns.workload}.json")
    with open(out, "w") as fp:
        json.dump(work, fp, indent=1)
        fp.write("\n")
    print(json.dumps(work))
    return 0


if __name__ == "__main__":
    sys.exit(main())
