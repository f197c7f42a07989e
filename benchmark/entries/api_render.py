"""``api.render(variant, scene, W, H, spp=spp, seed=s, quirks=q,
as_rgba8=True, device=d, **render_kw)``: one frame of a one-device
configuration, returned as its RGBA8 image on the host."""

from __future__ import annotations


def port_scene(raw: dict):
    """A new program ``Scene`` of the raw arrays (copies of them)."""
    from opencl_montecarlo_path_tracing_tpu_torch.scene.scene import Scene
    return Scene(sphere_centers=raw["spheres"].copy(),
                 square_kj=raw["squares"].copy(),
                 triangles=raw["triangles"].copy(),
                 lights=raw["lights"].copy())


def port_quirks(cfg: dict):
    from opencl_montecarlo_path_tracing_tpu_torch.core.quirks import Quirks
    return Quirks(**cfg.get("quirks", {}))


class Entry:
    def __init__(self, cfg: dict, raw: dict, device):
        from opencl_montecarlo_path_tracing_tpu_torch import api
        self.render = api.render
        self.cfg = cfg
        self.raw = raw
        self.device = device
        self.quirks = port_quirks(cfg)
        self.scene = port_scene(raw)

    def frame(self, seed: int, fresh: bool = False):
        c = self.cfg
        return self.render(c["variant"],
                           port_scene(self.raw) if fresh else self.scene,
                           c["width"], c["height"], spp=c["spp"], seed=seed,
                           quirks=self.quirks, as_rgba8=True,
                           device=self.device, **c.get("render_kw", {}))
