"""kernels_per_frame (entry and integrators, device trace): device kernels
launched a frame on the device, eager torch ops and the CUDA
launchers alike; copies and sets are not counted."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.frames:
        return None
    return s.kernels / ctx.frames
