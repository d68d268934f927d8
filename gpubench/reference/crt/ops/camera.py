"""Cameras (``computational_ray_tracer_tpu/ops/camera.py``): frozen configs
with a host-side basis; ``generate_rays(pixel_xy, u_lens)`` maps raster
coordinates + lens uniforms to world rays.

Camera space looks along +z with the raster y axis pointing down. A camera
is placed at ``position`` looking at a ``look_at`` target. The one kind
here is ``PerspectiveCamera`` (optional thin-lens depth of field)."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from gpubench.reference.crt.ops import sampling as smp


def look_at_basis(eye, target, up=(0.0, 1.0, 0.0)):
    look = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    look /= np.linalg.norm(look)
    right = np.cross(np.asarray(up, np.float64), look)
    right /= np.linalg.norm(right)
    return look, right, np.cross(look, right)


@functools.lru_cache(maxsize=64)
def _frame(basis, position, device):
    """The camera-to-world rotation (columns right, up, look) and the
    position as float32 on ``device``, built once per camera and device:
    a pass makes no host copy."""
    look, right, up = basis
    return (torch.as_tensor(np.stack([right, up, look], axis=1),
                            dtype=torch.float32, device=device),
            torch.as_tensor(position, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class CameraBase:
    """Film geometry and world placement; a subclass gives the
    camera-space rays (``_rays_camera_space``)."""
    position: tuple
    basis: tuple           # (look, right, up), world space
    resolution: tuple      # (W, H)

    def _ndc(self, pixel_xy):
        w, h = self.resolution
        return pixel_xy[..., 0] / w, pixel_xy[..., 1] / h

    def generate_rays(self, pixel_xy, u_lens):
        """(..., 2) raster coords + (..., 2) lens uniforms -> world (o, d)."""
        o, d = self._rays_camera_space(pixel_xy, u_lens)
        m, pos = _frame(tuple(map(tuple, self.basis)), tuple(self.position),
                        str(d.device))
        o = o @ m.T + pos
        d = d @ m.T
        return o, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _make(cls, position, resolution, look_at, **kw):
    basis = look_at_basis(position, look_at)
    return cls(position=tuple(position),
               basis=tuple(tuple(b) for b in basis),
               resolution=tuple(resolution), **kw)


def _unit(d):
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera(CameraBase):
    """Pinhole projection with optional thin-lens depth of field; fov_y in
    degrees."""
    fov_y: float = 45.0
    lens_radius: float = 0.0
    focal_distance: float = 1e6

    @classmethod
    def create(cls, position, resolution, fov_y=45.0, lens_radius=0.0,
               focal_distance=1e6, **kw):
        return _make(cls, position, resolution, fov_y=fov_y,
                     lens_radius=lens_radius, focal_distance=focal_distance,
                     **kw)

    def _rays_camera_space(self, pixel_xy, u_lens):
        w, h = self.resolution
        tan_half = math.tan(math.radians(self.fov_y) / 2.0)
        nx, ny = self._ndc(pixel_xy)
        sx = (2.0 * nx - 1.0) * tan_half * (w / h)
        sy = (1.0 - 2.0 * ny) * tan_half
        d = torch.stack([sx, sy, torch.ones_like(sx)], dim=-1)
        o = torch.zeros_like(d)
        if self.lens_radius > 0.0:
            p_lens = smp.sample_uniform_disk_concentric(u_lens,
                                                        self.lens_radius)
            o = torch.cat([p_lens, torch.zeros_like(sx)[..., None]], dim=-1)
            d = d * self.focal_distance - o
        return o, _unit(d)


