"""Cameras (``computational_ray_tracer_tpu/ops/camera.py``): frozen configs
with a host-side basis; ``generate_rays(pixel_xy, u_lens)`` maps raster
coordinates + lens uniforms to world rays.

Camera space looks along +z with the raster y axis pointing down. A camera
is placed at ``position`` with a yaw/pitch pair (degrees) or a ``look_at``
target. Kinds: ``PerspectiveCamera`` (optional thin-lens depth of field),
``OrthographicCamera``, ``PinholeCamera`` (a sensor behind a hole of finite
radius) and ``ThinLensCamera`` (lensmaker focal length, focused by the
conjugate equation)."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from computational_ray_tracer_tpu_torch.ops import sampling as smp


def yaw_pitch_basis(yaw, pitch):
    """(look, right, up) from yaw/pitch in degrees."""
    cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
    cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
    look = np.array([cy * cp, sp, sy * cp])
    look /= np.linalg.norm(look)
    right = np.cross(np.array([0.0, 1.0, 0.0]), look)
    if np.linalg.norm(right) < 1e-8:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    return look, right, np.cross(look, right)


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

    def frame(self, device):
        """(camera-to-world rotation, position) on ``device``, the tensors
        ``generate_rays`` reads there."""
        return _frame(tuple(map(tuple, self.basis)), tuple(self.position),
                      str(device))

    def generate_rays(self, pixel_xy, u_lens):
        """(..., 2) raster coords + (..., 2) lens uniforms -> world (o, d)."""
        o, d = self._rays_camera_space(pixel_xy, u_lens)
        m, pos = self.frame(d.device)
        o = o @ m.T + pos
        d = d @ m.T
        return o, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _make(cls, position, resolution, yaw=0.0, pitch=0.0, look_at=None,
          **kw):
    basis = (look_at_basis(position, look_at) if look_at is not None
             else yaw_pitch_basis(yaw, pitch))
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


@dataclasses.dataclass(frozen=True)
class OrthographicCamera(CameraBase):
    """Parallel rays over a world-space (width, height) window."""
    window: tuple = (2.0, 2.0)

    @classmethod
    def create(cls, position, resolution, window=(2.0, 2.0), **kw):
        return _make(cls, position, resolution, window=tuple(window), **kw)

    def _rays_camera_space(self, pixel_xy, u_lens):
        nx, ny = self._ndc(pixel_xy)
        ww, wh = self.window
        x = (2.0 * nx - 1.0) * ww / 2.0
        y = (1.0 - 2.0 * ny) * wh / 2.0
        zero = torch.zeros_like(x)
        return (torch.stack([x, y, zero], dim=-1),
                torch.stack([zero, zero, torch.ones_like(x)], dim=-1))


@dataclasses.dataclass(frozen=True)
class PinholeCamera(CameraBase):
    """A sensor plane ``sensor_distance`` behind a hole of radius
    ``hole_radius`` (0: an ideal pinhole); raster coordinates are flipped
    so the image is upright."""
    sensor_size: tuple = (0.036, 0.024)   # (width, height), world units
    sensor_distance: float = 0.05
    hole_radius: float = 0.0

    @classmethod
    def create(cls, position, resolution, sensor_size=(0.036, 0.024),
               sensor_distance=0.05, hole_radius=0.0, **kw):
        return _make(cls, position, resolution, sensor_size=tuple(sensor_size),
                     sensor_distance=sensor_distance, hole_radius=hole_radius,
                     **kw)

    def _rays_camera_space(self, pixel_xy, u_lens):
        nx, ny = self._ndc(pixel_xy)
        sw, sh = self.sensor_size
        px = (1.0 - 2.0 * nx) * sw / 2.0
        py = (2.0 * ny - 1.0) * sh / 2.0
        p_sensor = torch.stack(
            [px, py, torch.full_like(px, -self.sensor_distance)], dim=-1)
        if self.hole_radius > 0.0:
            p_hole2 = smp.sample_uniform_disk_concentric(u_lens,
                                                         self.hole_radius)
        else:
            p_hole2 = torch.zeros_like(p_sensor[..., :2])
        p_hole = torch.cat([p_hole2, torch.zeros_like(p_sensor[..., :1])],
                           dim=-1)
        return p_hole, _unit(p_hole - p_sensor)


@dataclasses.dataclass(frozen=True)
class ThinLensCamera(CameraBase):
    """A symmetric biconvex lens of curvature radius R and index n
    (lensmaker focal length), an aperture of radius ``aperture_radius``,
    focused at ``focus_distance`` by the conjugate equation."""
    lens_radius_of_curvature: float = 0.5
    lens_ior: float = 1.5
    aperture_radius: float = 0.01
    focus_distance: float = 2.0
    sensor_size: tuple = (0.036, 0.024)

    @classmethod
    def create(cls, position, resolution, lens_radius_of_curvature=0.5,
               lens_ior=1.5, aperture_radius=0.01, focus_distance=2.0,
               sensor_size=(0.036, 0.024), **kw):
        return _make(cls, position, resolution,
                     lens_radius_of_curvature=lens_radius_of_curvature,
                     lens_ior=lens_ior, aperture_radius=aperture_radius,
                     focus_distance=focus_distance,
                     sensor_size=tuple(sensor_size), **kw)

    @property
    def focal_length(self):
        return 1.0 / ((self.lens_ior - 1.0) * 2.0
                      / self.lens_radius_of_curvature)

    @property
    def image_distance(self):
        return 1.0 / max(1.0 / self.focal_length - 1.0 / self.focus_distance,
                         1e-9)

    def _rays_camera_space(self, pixel_xy, u_lens):
        nx, ny = self._ndc(pixel_xy)
        sw, sh = self.sensor_size
        so = self.focus_distance
        px = (1.0 - 2.0 * nx) * sw / 2.0
        py = (2.0 * ny - 1.0) * sh / 2.0
        mag = so / self.image_distance
        p_obj = torch.stack([-px * mag, -py * mag, torch.full_like(px, so)],
                            dim=-1)
        p_lens2 = smp.sample_uniform_disk_concentric(u_lens,
                                                     self.aperture_radius)
        o = torch.cat([p_lens2, torch.zeros_like(px)[..., None]], dim=-1)
        return o, _unit(p_obj - o)
