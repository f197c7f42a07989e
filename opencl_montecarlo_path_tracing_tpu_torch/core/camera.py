"""Camera model: fixed pinhole basis + per-sample thin-lens DoF jitter.

Port of ``opencl_montecarlo_path_tracing_tpu/core/camera.py``.  The basis
is built in numpy float32 with the same operations, so it is bit-identical
to the JAX package's; ``primary_rays`` runs on tensors.

    cam_pos     = (17, 16, 8)
    cam_forward = normalize(-6, -16, 0)
    cam_up      = 0.002 * normalize(cross(z_vect, cam_forward))
    cam_right   = 0.002 * normalize(cross(cam_forward, cam_up))
    eye_offset  = -256 * (cam_up + cam_right) + cam_forward

``z_sign=-1`` is the GPU-variant basis, ``z_sign=+1`` the CPU oracle's.
Per sample, with uniforms r1..r4 and pixel coordinates (i, j):

    delta     = cam_up * (r1 - .5) * 99 + cam_right * (r2 - .5) * 99
    origin    = cam_pos + delta
    direction = normalize(-delta + (cam_up*(r3 + i) + cam_right*(j + r4)
                                    + eye_offset) * 16)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    right: np.ndarray
    eye_offset: np.ndarray
    lens_jitter: float = 99.0
    fov_scale: float = 16.0


def _normalize(x: np.ndarray) -> np.ndarray:
    return (np.float32(1.0) / np.sqrt(np.float32(np.dot(x, x)))) * x


def make_camera(z_sign: float = -1.0) -> Camera:
    """z_sign=-1: GPU-variant basis; z_sign=+1: CPU-oracle basis."""
    f32 = np.float32
    pos = np.array([17, 16, 8], f32)
    z_vect = np.array([0, 0, z_sign], f32)
    forward = _normalize(np.array([-6, -16, 0], f32))
    up = f32(0.002) * _normalize(np.cross(z_vect, forward).astype(f32))
    right = f32(0.002) * _normalize(np.cross(forward, up).astype(f32))
    eye_offset = f32(-256) * (up + right) + forward
    return Camera(pos=pos, forward=forward, up=up, right=right,
                  eye_offset=eye_offset)


def primary_rays(cam: Camera, i, j, r1, r2, r3, r4):
    """Batched primary rays.  ``i``/``j`` are float32 pixel-coordinate
    tensors, ``r1..r4`` uniforms of the same shape.  Returns origin and
    direction as (..., 3) tensors."""
    dev = r1.device
    up = torch.as_tensor(cam.up, device=dev)
    right = torch.as_tensor(cam.right, device=dev)
    eye = torch.as_tensor(cam.eye_offset, device=dev)
    pos = torch.as_tensor(cam.pos, device=dev)
    lj = float(np.float32(cam.lens_jitter))
    fs = float(np.float32(cam.fov_scale))

    delta = (up * ((r1 - 0.5) * lj)[..., None]
             + right * ((r2 - 0.5) * lj)[..., None])
    origin = pos + delta
    d = (-delta
         + (up * (r3 + i)[..., None] + right * (j + r4)[..., None] + eye) * fs)
    dx, dy, dz = d.unbind(-1)
    inv_norm = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return origin, d * inv_norm[..., None]
