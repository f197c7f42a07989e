"""scene_prep_ms (host preparation, host clock): a frame from a fresh
``Scene`` of the cell's configuration, which the program prepares anew
(its arrays, block tables, packed buffers), less a frame of the prepared
scene: the median of 5 such pairs after the traced window, in ms."""


def read(ctx):
    return ctx.scene_prep_ms
