"""frame_ms_p95 (end to end, host clock): the 95th percentile of every
frame's time in the window, from its render call to its RGBA8 image on
the host, in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.times_ms, 95)) if ctx.times_ms else None
