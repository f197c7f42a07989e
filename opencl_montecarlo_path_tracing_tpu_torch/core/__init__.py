from .rng import threefry2x32, rand2, randn_draws, make_key
from .camera import Camera, make_camera, primary_rays
from .quirks import Quirks

__all__ = [
    "threefry2x32", "rand2", "randn_draws", "make_key",
    "Camera", "make_camera", "primary_rays",
    "Quirks",
]
