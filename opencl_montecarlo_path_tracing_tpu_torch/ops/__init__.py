from .intersect import SceneArrays, prep_scene, trace_ray, any_hit, TraceResult

__all__ = ["SceneArrays", "prep_scene", "trace_ray", "any_hit", "TraceResult"]
