"""b1_roofline (kernels, device trace): kernel B1's (``csrc/mega_super.cu``)
share of its roofline, in %: the least time of the cell's counted work on
one chip over B1's device time a frame."""

from benchmark.harness.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, "mega_super_kernel")
