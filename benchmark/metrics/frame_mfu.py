"""frame_mfu (entry, device trace window): the whole frame's share of the
chip's peak, in %: the least time of the cell's counted work over the
traced window's time a frame.  It reads whatever kernels render the
frame, so it still bounds a gain where a change takes the frame off the
kernel whose roofline share is named (that share then reads nothing)."""

from benchmark.harness.roofline import frame_work, least_seconds


def read(ctx):
    if ctx.peak is None or ctx.work is None or not ctx.frames:
        return None
    ops, nbytes = frame_work(ctx.work)
    least = least_seconds(ops, nbytes, ctx.peak)
    return 100.0 * least / (ctx.window_s / ctx.frames)
