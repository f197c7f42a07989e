"""setup_s (end to end, host clock): from the process's start to the
first timed frame, in s: imports, the CUDA context, the kernels' library
(built on a checkout's first run), the scene and its tables, the warm-up frames."""


def read(ctx):
    return ctx.setup_s
