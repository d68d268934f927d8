"""Film accumulation and resolve (``computational_ray_tracer_tpu/ops/
film.py``): per-pixel weighted sensor-RGB sums; resolve goes sensor RGB ->
XYZ -> colour space RGB (-> sRGB encode)."""

from __future__ import annotations

import dataclasses

import torch

from computational_ray_tracer_tpu_torch.ops import color as colorlib


@dataclasses.dataclass
class Film:
    rgb_sum: torch.Tensor      # (H, W, 3)
    weight_sum: torch.Tensor   # (H, W)
    spp_done: int = 0

    @classmethod
    def create(cls, resolution, device="cpu"):
        w, h = resolution
        return cls(torch.zeros((h, w, 3), dtype=torch.float32, device=device),
                   torch.zeros((h, w), dtype=torch.float32, device=device), 0)

    def add_aligned(self, rgb, weight, spp_added=1):
        """Accumulate one per-pixel sample pass (H, W, 3) + (H, W)."""
        return Film(self.rgb_sum + rgb * weight[..., None],
                    self.weight_sum + weight, self.spp_done + spp_added)

    def resolve(self, sensor, colorspace=colorlib.SRGB, exposure=1.0,
                to_srgb=True, clip=True):
        w = torch.clamp(self.weight_sum[..., None], min=1e-12)
        rgb = colorspace.to_rgb(
            sensor.sensor_rgb_to_xyz(self.rgb_sum / w * exposure))
        if clip:
            rgb = torch.clamp(rgb, 0.0, 1.0)
        if to_srgb:
            rgb = colorlib.linear_to_srgb(rgb)
        return rgb
