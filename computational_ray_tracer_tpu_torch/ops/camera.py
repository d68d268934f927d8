"""Perspective camera (``computational_ray_tracer_tpu/ops/camera.py:
98-133``): a frozen config with host-side basis; ``generate_rays`` maps
raster coordinates + lens uniforms to world rays."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import sampling as smp


def look_at_basis(eye, target, up=(0.0, 1.0, 0.0)):
    look = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    look /= np.linalg.norm(look)
    right = np.cross(np.asarray(up, np.float64), look)
    right /= np.linalg.norm(right)
    return look, right, np.cross(look, right)


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Pinhole projection with optional thin-lens depth of field; camera
    space looks along +z with the raster y axis pointing down."""
    position: tuple
    basis: tuple           # (look, right, up), world space
    resolution: tuple      # (W, H)
    fov_y: float = 45.0
    lens_radius: float = 0.0
    focal_distance: float = 1e6

    @classmethod
    def create(cls, position, resolution, look_at, fov_y=45.0,
               lens_radius=0.0, focal_distance=1e6):
        basis = look_at_basis(position, look_at)
        return cls(tuple(position), tuple(tuple(b) for b in basis),
                   tuple(resolution), fov_y, lens_radius, focal_distance)

    def generate_rays(self, pixel_xy, u_lens):
        """(..., 2) raster coords + (..., 2) lens uniforms -> world (o, d)."""
        w, h = self.resolution
        tan_half = math.tan(math.radians(self.fov_y) / 2.0)
        sx = (2.0 * (pixel_xy[..., 0] / w) - 1.0) * tan_half * (w / h)
        sy = (1.0 - 2.0 * (pixel_xy[..., 1] / h)) * tan_half
        d = torch.stack([sx, sy, torch.ones_like(sx)], dim=-1)
        o = torch.zeros_like(d)
        if self.lens_radius > 0.0:
            p_lens = smp.sample_uniform_disk_concentric(u_lens,
                                                        self.lens_radius)
            o = torch.cat([p_lens, torch.zeros_like(sx)[..., None]], dim=-1)
            d = d * self.focal_distance - o
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        look, right, up = self.basis
        m = torch.as_tensor(np.stack([right, up, look], axis=1),
                            dtype=torch.float32, device=d.device)
        pos = torch.as_tensor(self.position, dtype=torch.float32,
                              device=d.device)
        o = o @ m.T + pos
        d = d @ m.T
        return o, d / torch.linalg.norm(d, dim=-1, keepdim=True)
