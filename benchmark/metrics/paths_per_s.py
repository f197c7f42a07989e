"""paths_per_s (end to end, host clock): camera paths (W x H x spp) of
every frame completed in the window over the window's seconds, in
Mpaths/s."""


def read(ctx):
    c = ctx.cfg
    paths = c["width"] * c["height"] * c["spp"] * ctx.frames
    return paths / ctx.window_s / 1e6
