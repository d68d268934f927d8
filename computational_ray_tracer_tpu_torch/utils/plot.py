"""Headless 2D plots (``computational_ray_tracer_tpu/utils/plot.py``, the
reference's Graph2D) without matplotlib: ``Graph2D`` keeps the reference's
API and rasterises into an RGB ``uint8`` canvas with NumPy.

The canvas holds an axes frame, a grid of 5 x 5 cells over the data range,
and each series in its own colour: lines as densely sampled segments,
points as small discs, histogram bars blended over the background.
``save(path)`` writes the PNG with the port's own codec
(``utils/image.py``) and beside it ``path + ".json"``: the title, the axis
labels, the ranges and every series' data. There is no font, so the text
that matplotlib would draw is in that file.
"""

from __future__ import annotations

import json

import numpy as np

from computational_ray_tracer_tpu_torch.utils import image

# matplotlib's default colour cycle (tab10).
_COLORS = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207)], np.uint8)
_DPI = 110
_PX_PER_PT = _DPI / 72.0       # line widths and marker sizes are in points
_MARGIN = (30, 20, 45, 60)     # top, right, bottom, left, in pixels
_GRID_CELLS = 5
_HIST_ALPHA = 0.55


def _np(a):
    """A float64 NumPy copy of an array, a tensor on any device, or a list."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _disc(r):
    """Pixel offsets (k, 2) of a disc of radius r."""
    k = int(np.ceil(r))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    inside = dx * dx + dy * dy <= r * r + 0.25
    return np.stack([dy[inside], dx[inside]], axis=1)


class Graph2D:
    """Multi-series 2D plot: functions, lines, points and histograms."""

    def __init__(self, title="", xlabel="x", ylabel="y", figsize=(7, 5)):
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.width = int(figsize[0] * _DPI)
        self.height = int(figsize[1] * _DPI)
        self.series = []
        self.xlim = [None, None]
        self.ylim = [None, None]

    def _add(self, kind, label, **data):
        self.series.append({"kind": kind, "label": label, **data})
        return self

    def plot_function(self, f, a, b, n=512, label=None, **kw):
        x = np.linspace(a, b, n)
        return self.plot_line(x, f(x), label=label, **kw)

    def plot_line(self, x, y, label=None, lw=1.5, **kw):
        return self._add("line", label, x=_np(x), y=_np(y), lw=float(lw))

    def plot_points(self, x, y, label=None, s=6, **kw):
        return self._add("points", label, x=_np(x), y=_np(y), s=float(s))

    def plot_histogram(self, samples, bins=64, range=None, density=True,
                       label=None, **kw):
        """Bars of ``np.histogram(samples, bins, range, density)``."""
        heights, edges = np.histogram(_np(samples), bins=bins, range=range,
                                      density=density)
        return self._add("histogram", label, edges=edges,
                         heights=heights.astype(np.float64),
                         density=bool(density))

    def set_range(self, xmin=None, xmax=None, ymin=None, ymax=None):
        if xmin is not None or xmax is not None:
            self.xlim = [xmin, xmax]
        if ymin is not None or ymax is not None:
            self.ylim = [ymin, ymax]
        return self

    # ---- layout ----
    def _data_ranges(self):
        xs, ys = [], []
        for s in self.series:
            if s["kind"] == "histogram":
                xs.append(s["edges"])
                ys.append(np.append(s["heights"], 0.0))
            else:
                xs.append(s["x"])
                ys.append(s["y"])

        def span(vals, lim, pad):
            v = np.concatenate(vals) if vals else np.zeros(1)
            v = v[np.isfinite(v)]
            lo, hi = (float(v.min()), float(v.max())) if v.size else (0, 1)
            if hi <= lo:
                lo, hi = lo - 0.5, hi + 0.5
            d = (hi - lo) * pad
            lo, hi = lo - d, hi + d
            return [lo if lim[0] is None else float(lim[0]),
                    hi if lim[1] is None else float(lim[1])]

        return span(xs, self.xlim, 0.0), span(ys, self.ylim, 0.05)

    def _to_pixels(self, x, y, xr, yr):
        top, right, bottom, left = _MARGIN
        w = self.width - left - right - 1
        h = self.height - top - bottom - 1
        px = left + (x - xr[0]) / (xr[1] - xr[0]) * w
        py = top + h - (y - yr[0]) / (yr[1] - yr[0]) * h
        return px, py

    def render(self):
        """The plot as an (H, W, 3) uint8 canvas."""
        xr, yr = self._data_ranges()
        img = np.full((self.height, self.width, 3), 255, np.uint8)
        top, right, bottom, left = _MARGIN
        x0, x1 = left, self.width - right - 1
        y0, y1 = top, self.height - bottom - 1
        for k in range(1, _GRID_CELLS):
            gx = x0 + (x1 - x0) * k // _GRID_CELLS
            gy = y0 + (y1 - y0) * k // _GRID_CELLS
            img[y0:y1 + 1, gx] = 220
            img[gy, x0:x1 + 1] = 220
        inside = lambda py, px: (py >= y0) & (py <= y1) & (px >= x0) & (
            px <= x1)

        def stamp(px, py, r, color):
            off = _disc(r)
            py = np.rint(py)[:, None] + off[None, :, 0]
            px = np.rint(px)[:, None] + off[None, :, 1]
            keep = inside(py, px)
            img[py[keep].astype(int), px[keep].astype(int)] = color

        for i, s in enumerate(self.series):
            color = _COLORS[i % len(_COLORS)]
            if s["kind"] == "histogram":
                e, hgt = s["edges"], s["heights"]
                ex, _ = self._to_pixels(e, np.zeros_like(e), xr, yr)
                _, hy = self._to_pixels(e[:-1], hgt, xr, yr)
                _, base = self._to_pixels(0.0, 0.0, xr, yr)
                for a, b, t, v in zip(ex[:-1], ex[1:], hy, hgt):
                    if v == 0:
                        continue
                    ca, cb = int(np.ceil(min(a, b))), int(np.floor(max(a, b)))
                    ra, rb = sorted((int(np.rint(t)), int(np.rint(base))))
                    ca, cb = max(ca, x0), min(cb, x1)
                    ra, rb = max(ra, y0), min(rb, y1)
                    if ca <= cb and ra <= rb:
                        blk = img[ra:rb + 1, ca:cb + 1].astype(np.float64)
                        img[ra:rb + 1, ca:cb + 1] = np.rint(
                            (1 - _HIST_ALPHA) * blk + _HIST_ALPHA * color)
                continue
            ok = np.isfinite(s["x"]) & np.isfinite(s["y"])
            px, py = self._to_pixels(s["x"], s["y"], xr, yr)
            if s["kind"] == "points":
                stamp(px[ok], py[ok], np.sqrt(s["s"]) / 2.0 * _PX_PER_PT,
                      color)
                continue
            seg = ok[:-1] & ok[1:]
            ax, ay = px[:-1][seg], py[:-1][seg]
            bx, by = px[1:][seg], py[1:][seg]
            n = np.ceil(np.maximum(np.abs(bx - ax), np.abs(by - ay))).astype(
                int) + 1
            t = np.concatenate([np.linspace(0.0, 1.0, k) for k in n]) \
                if n.size else np.zeros(0)
            rep = np.repeat(np.arange(n.size), n)
            stamp(ax[rep] + t * (bx - ax)[rep], ay[rep] + t * (by - ay)[rep],
                  s["lw"] / 2.0 * _PX_PER_PT, color)
        img[y0, x0:x1 + 1] = img[y1, x0:x1 + 1] = 0
        img[y0:y1 + 1, x0] = img[y0:y1 + 1, x1] = 0
        return img

    def _sidecar(self):
        xr, yr = self._data_ranges()
        series = []
        for s in self.series:
            series.append({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                           for k, v in s.items()})
        return {"title": self.title, "xlabel": self.xlabel,
                "ylabel": self.ylabel, "xrange": xr, "yrange": yr,
                "size": [self.width, self.height], "series": series}

    def save(self, path):
        """Write the PNG at ``path`` and its data at ``path + ".json"``."""
        image.write_png(path, self.render())
        with open(path + ".json", "w") as f:
            json.dump(self._sidecar(), f)
        return path
