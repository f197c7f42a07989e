"""Faults planted under the timed path, for the harness's own tests.

The benchmark's runs never install one.  Each breaks the program where
its answer is made, so a test can drive a whole run on it and see the
check turn ``correct`` false:

* ``stale``: a frame returns the previous frame's film (a step that
  leaves its state unchanged);
* ``half``: a frame renders the first half of its samples and doubles
  them (half the batch left out, the mean taken over the rest);
* ``altered``: a frame is rendered from another key than its own (an
  answer altered where it is produced).
"""

from __future__ import annotations


def install(names):
    """Patch the program's film function(s) with the faults ``names``;
    returns the function that undoes the patches."""
    names = tuple(names)
    if not names:
        return lambda: None
    from opencl_montecarlo_path_tracing_tpu_torch.models import super as sup
    film_super = sup.film_super
    last = {}

    def broken(key, scn, width, height, spp, spp_offset, spp_total, *a,
               **kw):
        if "altered" in names:
            key = (key[0] ^ 1, key[1])
        if "half" in names:
            film = film_super(key, scn, width, height, spp // 2, spp_offset,
                              spp_total, *a, **kw) * 2.0
        else:
            film = film_super(key, scn, width, height, spp, spp_offset,
                              spp_total, *a, **kw)
        if "stale" in names:
            film, last["film"] = last.get("film", film), film
        return film

    def undo():
        sup.film_super = film_super

    sup.film_super = broken
    return undo
