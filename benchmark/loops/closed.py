"""A closed loop with one client: the client asks for frame k + 1 when
frame k's image is on its host, as a render worker does.

Parameters of the mix (``benchmark/traffic/<name>.json``):

* ``clients``: 1;
* ``seed_rule``: ``"splitmix64"``: frame k's 64-bit seed is the
  SplitMix64 output of ``(seed, k)``, so a run's frames are a pure
  function of ``--seed`` and every seed asks for the same work;
* ``warmup_frames``: frames of the cell's own shape rendered in set-up
  (seeded apart from the timed frames);
* ``fresh_every`` (default 0, never): every n-th timed frame (k = 0, n,
  2n, ...) is rendered from a new program object of the same raw scene,
  which the program prepares anew, as when a client sends a changed
  scene.

Every frame of a cell has the configuration's size; only its seed varies.
"""

from __future__ import annotations

from benchmark.harness.traffic import MASK64, splitmix64

_WARMUP_BASE = 1 << 40


class Stream:
    def __init__(self, mix: dict, seed: int):
        if int(mix.get("clients", 1)) != 1:
            raise ValueError(f"a closed loop of one client; the mix asks "
                             f"for {mix}")
        if mix.get("seed_rule") != "splitmix64":
            raise ValueError(f"unknown seed rule {mix.get('seed_rule')!r}")
        self.seed = int(seed) & MASK64
        self.warmup_frames = int(mix.get("warmup_frames", 1))
        self.fresh_every = int(mix.get("fresh_every", 0))

    def frame_seed(self, k: int) -> int:
        """The seed of timed frame ``k`` (k = 0, 1, ...)."""
        return splitmix64(splitmix64(self.seed) ^ (k & MASK64))

    def warmup_seed(self, i: int) -> int:
        return self.frame_seed(_WARMUP_BASE + i)

    def request(self, k: int) -> tuple[int, bool]:
        """(seed, fresh) of timed frame ``k``."""
        fresh = self.fresh_every > 0 and k % self.fresh_every == 0
        return self.frame_seed(k), fresh
