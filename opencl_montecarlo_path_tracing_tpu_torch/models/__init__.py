from .super import render_super
from .trianglegrid import render_trianglegrid

__all__ = ["render_super", "render_trianglegrid"]
