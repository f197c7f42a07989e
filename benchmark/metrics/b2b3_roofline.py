"""b2b3_roofline (kernels, device trace): kernel B2/B3's
(``csrc/mega_blocked.cu``) share of its roofline, in %: the least time of
the cell's counted work on one chip over B2/B3's device time a frame."""

from benchmark.harness.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "mega_blocked_kernel")
