"""Frame-wide common-random-number validation of the card's films.

Port of ``tools/validate_crn_frame.py``.  Each integrator family renders
one whole frame through ``api.render`` on the device and through the
port's NumPy oracle (``models/oracle*.py``) on the same threefry streams of
``make_key(4242)``, so the residual holds no Monte-Carlo noise: only float
rounding, and the razor-edge tie class (horizon floor hits, silhouette
discriminants) where any two float implementations may flip a whole
occlusion unit.  The families, as in the JAX tool: ``super`` under the
default and the reference quirks, ``simple`` at 5 bounces,
``bidirectional`` with n_vlp = 128 and ``metropolis`` with 16 chains x 2
rounds, on ``scene/builtin.py::demo_scene()`` (the JAX tool reads the
reference's scene files).

Per family, on the display scale ``(film / spp * 64) / 255`` of the
per-pixel max-channel difference: the RMSE over the frame, the contract's
quantile, the max, the share of tie pixels (> 1e-4), the device's render
time (warm, host clock to a synchronise, ms) and the oracle's (s).  The contract is ``utils/crn.py``'s, the JAX tool's: p99.5 < 1e-5
and ties < 0.6% (``SUPER``), for ``simple`` p95 < 1e-5 and ties < 2%
(``SIMPLE``, its mirror chain amplifies the tie class).

    python -m opencl_montecarlo_path_tracing_tpu_torch.tools.validate_crn_frame
        [--size 512] [--spp 4] [--families super,metropolis] [--device cuda]

``--families`` keeps the families whose name contains one of the given
substrings.  Prints the table, exits 1 if a family violates its contract
(2 if no family matches), and writes no file.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from .. import api
from ..core.quirks import REFERENCE
from ..core.rng import make_key
from ..models.oracle import render_oracle
from ..models.oracle_bpt import render_oracle_bpt
from ..models.oracle_mlt import render_oracle_mlt
from ..models.oracle_super import render_oracle_super
from ..scene.builtin import demo_scene
from ..utils.crn import SIMPLE, SUPER, crn_stats

SEED = 4242


def families(scene, size: int, spp: int) -> list:
    """(name, render kwargs, oracle thunk, contract) of each family."""
    key = make_key(SEED)
    s = size
    return [
        ("super (intended math)",
         dict(variant="super", scene=scene),
         lambda: render_oracle_super(scene, s, s, spp=spp, key=key),
         SUPER),
        ("super (quirks=reference)",
         dict(variant="super", scene=scene, quirks=REFERENCE),
         lambda: render_oracle_super(scene, s, s, spp=spp, key=key,
                                     quirks=REFERENCE),
         SUPER),
        ("simple (5-bounce mirrors)",
         dict(variant="simple", max_bounces=5),
         lambda: render_oracle(s, s, spp=spp, key=key, max_depth=5),
         SIMPLE),
        ("bidirectional nvlp=128",
         dict(variant="bidirectional", scene=scene, n_vlp=128),
         lambda: render_oracle_bpt(scene, s, s, spp=spp, n_vlp=128, key=key),
         SUPER),
        ("metropolis 16 chains x 2 rounds",
         dict(variant="metropolis", scene=scene, n_seedpaths=16,
              mutation_rounds=2),
         lambda: render_oracle_mlt(scene, s, s, spp=spp, n_seedpaths=16,
                                   mutation_rounds=2, key=key),
         SUPER),
    ]


def card_line(device: torch.device) -> str:
    """The device's name, and on a CUDA device its power limit as
    ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return f"device {device} (plain PyTorch)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(device)


def run(size: int, spp: int, only: list, device) -> list:
    """Render and compare every family whose name contains one of ``only``
    (all when empty); returns one dict of statistics a family."""
    device = torch.device(device)
    scene = demo_scene(prefer_reference=False)[0]
    rows = []
    for name, kw, oracle, contract in families(scene, size, spp):
        if only and not any(p in name for p in only):
            continue
        variant = kw.pop("variant")

        def render():
            film = api.render(variant, width=size, height=size, spp=spp,
                              seed=SEED, device=device, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return film

        render()
        t0 = time.perf_counter()
        film = render()
        t_device = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = oracle()
        t_oracle = time.perf_counter() - t0
        got = film.detach().cpu().numpy().astype(np.float64)
        st = crn_stats(got, want, spp, contract)
        d = (got - np.asarray(want, np.float64)) / spp * 64.0 / 255.0
        st.update(name=name, rmse=float(np.sqrt((d ** 2).mean())),
                  contract=contract, t_device=t_device, t_oracle=t_oracle,
                  ok=st["q"] < contract.q_limit
                  and st["tie_frac"] < contract.tie_limit)
        rows.append(st)
        print(f"{name}: rmse {st['rmse']:.3e} p{contract.quantile * 100:g} "
              f"{st['q']:.3e} max {st['max']:.3e} ties "
              f"{st['tie_frac'] * 100:.3f}% (device {t_device:.2f} ms, oracle "
              f"{t_oracle:.1f} s) {'ok' if st['ok'] else 'VIOLATION'}",
              flush=True)
    return rows


def table(rows: list) -> str:
    lines = ["| family | RMSE | quantile | max | tie pixels | device ms | "
             "oracle s |", "|---|---|---|---|---|---|---|"]
    for st in rows:
        c = st["contract"]
        lines.append(
            f"| {st['name']} | {st['rmse']:.3e} | "
            f"p{c.quantile * 100:g}={st['q']:.3e} | {st['max']:.3e} | "
            f"{st['tie_frac'] * 100:.3f}%"
            f"{'' if st['ok'] else ' **VIOLATION**'} | {st['t_device']:.2f} | "
            f"{st['t_oracle']:.1f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512,
                    help="frame width and height (default 512)")
    ap.add_argument("--spp", type=int, default=4,
                    help="samples a pixel (default 4)")
    ap.add_argument("--families", default="",
                    help="comma-separated substrings of the family names "
                         "to run (default: all five)")
    ap.add_argument("--device", default="cuda",
                    help="the device that renders (default cuda)")
    args = ap.parse_args(argv)
    only = [p for p in args.families.split(",") if p]
    device = torch.device(args.device)
    rows = run(args.size, args.spp, only, device)
    if not rows:
        print(f"no family matches {args.families!r}", file=sys.stderr)
        return 2
    ok = all(st["ok"] for st in rows)
    print(f"\nframe-wide CRN validation, {args.size}x{args.size}, "
          f"{args.spp} spp, make_key({SEED}), demo_scene(); "
          f"{card_line(device)}\n")
    print(table(rows))
    print(f"\ncontract {'OK' if ok else 'VIOLATED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
