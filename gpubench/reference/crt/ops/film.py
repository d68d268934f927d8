"""Film accumulation and resolve (``computational_ray_tracer_tpu/ops/
film.py``): per-pixel weighted sensor-RGB sums; resolve goes sensor RGB ->
XYZ -> sRGB (-> sRGB encode)."""

from __future__ import annotations

import dataclasses

import torch

from gpubench.reference.crt.ops import color as colorlib


@dataclasses.dataclass
class Film:
    rgb_sum: torch.Tensor      # (H, W, 3)
    weight_sum: torch.Tensor   # (H, W)

    def resolve(self, sensor):
        """The sRGB-encoded image, clipped to [0, 1] (the reference's
        defaults: sRGB, exposure 1)."""
        w = torch.clamp(self.weight_sum[..., None], min=1e-12)
        rgb = colorlib.SRGB.to_rgb(sensor.sensor_rgb_to_xyz(self.rgb_sum / w))
        return colorlib.linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
