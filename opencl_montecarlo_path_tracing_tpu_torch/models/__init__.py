from .super import render_super

__all__ = ["render_super"]
