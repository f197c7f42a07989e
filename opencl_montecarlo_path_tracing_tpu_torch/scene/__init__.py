from .formats import (
    parse_array_file, parse_triangles_file, parse_lights_file,
    MAX_TRIANGLES, MAX_LIGHTS,
)
from .scene import Scene, bitmap_to_spheres, bitmap_to_squares, load_scene

__all__ = [
    "parse_array_file", "parse_triangles_file", "parse_lights_file",
    "MAX_TRIANGLES", "MAX_LIGHTS",
    "Scene", "bitmap_to_spheres", "bitmap_to_squares", "load_scene",
]
