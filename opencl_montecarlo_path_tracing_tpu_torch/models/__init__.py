from .simple import render_simple
from .super import render_super
from .sample_parallel import render_sample_parallel
from .trianglegrid import render_trianglegrid

__all__ = ["render_simple", "render_super", "render_sample_parallel",
           "render_trianglegrid"]
