"""The canonical frame's constants (the port's ``entry._canonical_spectra``,
for ``gpubench/reference/passes.py``): the direct Li of
``benchmarks/canonical.py`` takes the F1 illuminant, a white illuminant, a
0.5 gray albedo and the light direction (0, 0, -1)."""

from __future__ import annotations

import dataclasses
import functools

import torch

from gpubench.reference.crt.ops import color as colorlib
from gpubench.reference.crt.ops import spectrum as spec

CANONICAL_LIGHT_WI = (0.0, 0.0, -1.0)


def _on(x, device):
    """A copy of a dataclass of tensors on ``device``."""
    return type(x)(**{f.name: getattr(x, f.name).to(device)
                      for f in dataclasses.fields(x)})


@functools.lru_cache(maxsize=4)
def _canonical_spectra(device):
    """The canonical Li's constants on ``device``: the F1 illuminant, the
    white illuminant, the 0.5 gray albedo and the light direction."""
    return (spec.DenselySampledSpectrum.from_named("stdillum-F1", device),
            _on(colorlib.RGBIlluminantSpectrum.from_rgb((1.0, 1.0, 1.0)),
                device),
            _on(colorlib.RGBAlbedoSpectrum.from_rgb((0.5, 0.5, 0.5)),
                device),
            torch.tensor(CANONICAL_LIGHT_WI, device=device))
