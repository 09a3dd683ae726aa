"""delogo, logo removal by SAR-weighted 4-edge interpolation — counterpart
of `gmat_tpu/ops/delogo.py`.

vf_delogo.c (apply_delogo :80-195): every pixel strictly inside the
(band-expanded) logo rectangle is replaced by a weighted mix of 3-sample
sums taken just inside the rectangle's four edges, weighted by the
product of distances to the other three edges (SAR-corrected), with
round-half-up integer division.  `show=1` blacks the inner border ring.

The weight products need 64-bit integers (a 1080p-wide logo reaches
~2^42): the JAX op widens under a scoped `jax.enable_x64`, here the
region math runs in native int64 on the plane's device.  The weight
grids are host numpy, built once per geometry and kept on the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_WEIGHTS: Dict = {}


def _region_tables(key, x1, x2, y1, y2, logo_x, logo_y, logo_w, logo_h,
                   band, sar_num, sar_den, show, device):
    """The weight grids, band blend distances and masks of one region,
    int64 / bool on `device`, cached by geometry."""
    ck = key + (str(device),)
    hit = _WEIGHTS.get(ck)
    if hit is not None:
        return hit
    ys = np.arange(y1 + 1, y2)          # interior rows
    xs = np.arange(x1 + 1, x2)          # interior cols
    dxl = (xs - x1).astype(np.uint64)
    dxr = (x2 - xs).astype(np.uint64)
    dyt = (ys - y1).astype(np.uint64)
    dyb = (y2 - ys).astype(np.uint64)
    sn, sd = np.uint64(sar_num), np.uint64(sar_den)
    wl = np.outer(dyt * dyb, dxr) * sd                   # (|ys|, |xs|)
    wr = np.outer(dyt * dyb, dxl) * sd
    wt = np.outer(dyb, dxl * dxr) * sn
    wb = np.outer(dyt, dxl * dxr) * sn
    weight = (wl + wr + wt + wb) * np.uint64(3)
    t = {k: torch.as_tensor(v.astype(np.int64), device=device)
         for k, v in (("wl", wl), ("wr", wr), ("wt", wt), ("wb", wb),
                      ("weight", weight))}
    gx, gy = np.meshgrid(xs, ys)
    t["blend"] = None
    if band > 0:
        # band blend (:172-189): pixels within `band` of the logo border
        # mix src and interp by integer distance
        dist = np.zeros(gx.shape, np.int64)
        for m, v in ((gx < logo_x + band, logo_x - gx + band),
                     (gx >= logo_x + logo_w - band,
                      gx - (logo_x + logo_w - 1 - band)),
                     (gy < logo_y + band, logo_y - gy + band),
                     (gy >= logo_y + logo_h - band,
                      gy - (logo_y + logo_h - 1 - band))):
            dist[m] = np.maximum(dist[m], v[m])
        inner = ((gy >= logo_y + band) & (gy < logo_y + logo_h - band)
                 & (gx >= logo_x + band) & (gx < logo_x + logo_w - band))
        if not inner.all():
            t["blend"] = (torch.as_tensor(dist, device=device),
                          torch.as_tensor(inner, device=device))
    t["ring"] = None
    if show:
        ring = ((gy == y1 + 1) | (gy == y2 - 1)
                | (gx == x1 + 1) | (gx == x2 - 1))
        t["ring"] = torch.as_tensor(ring, device=device)
    if len(_WEIGHTS) > 32:
        _WEIGHTS.clear()
    _WEIGHTS[ck] = t
    return t


def apply_delogo_plane(src: torch.Tensor, w: int, h: int, sar_num: int,
                       sar_den: int, logo_x: int, logo_y: int,
                       logo_w: int, logo_h: int, band: int,
                       show: bool) -> torch.Tensor:
    """src: (N, H, W) uint8 plane; returns the plane with the logo
    region interpolated away (vf_delogo.c:80-195, exact integer math)."""
    xclipl = max(-logo_x, 0)
    xclipr = max(logo_x + logo_w - w, 0)
    yclipt = max(-logo_y, 0)
    yclipb = max(logo_y + logo_h - h, 0)

    x1 = logo_x + xclipl
    x2 = logo_x + logo_w - xclipr - 1
    y1 = logo_y + yclipt
    y2 = logo_y + logo_h - yclipb - 1
    if x2 - x1 < 2 or y2 - y1 < 2:
        return src            # nothing strictly inside

    key = (w, h, sar_num, sar_den, logo_x, logo_y, logo_w, logo_h, band,
           bool(show))
    t = _region_tables(key, x1, x2, y1, y2, logo_x, logo_y, logo_w,
                       logo_h, band, sar_num, sar_den, show, src.device)
    # the region and its edges in int64, rows y1..y2 and columns x1..x2
    # (region coordinates: the edges at 0 and y2-y1 / x2-x1)
    c = src[:, y1:y2 + 1, x1:x2 + 1].to(torch.int64)
    ry, rx = y2 - y1, x2 - x1
    # 3-sample edge sums (the C's left/right per-row and topleft/botleft
    # per-column sums, :134-141,160-168)
    left = (c[:, 0:ry - 1, 0] + c[:, 1:ry, 0]
            + c[:, 2:ry + 1, 0])[:, :, None]             # (N, |ys|, 1)
    right = (c[:, 0:ry - 1, rx] + c[:, 1:ry, rx]
             + c[:, 2:ry + 1, rx])[:, :, None]
    top = (c[:, 0, 0:rx - 1] + c[:, 0, 1:rx]
           + c[:, 0, 2:rx + 1])[:, None, :]               # (N, 1, |xs|)
    bot = (c[:, ry, 0:rx - 1] + c[:, ry, 1:rx]
           + c[:, ry, 2:rx + 1])[:, None, :]
    weight = t["weight"]
    interp = (left * t["wl"] + right * t["wr"] + top * t["wt"]
              + bot * t["wb"] + (weight >> 1)) // weight
    if t["blend"] is not None:
        dist, inner = t["blend"]
        blend = (c[:, 1:ry, 1:rx] * dist
                 + interp * (band - dist)) // band
        interp = torch.where(inner, interp, blend)
    if t["ring"] is not None:
        interp = torch.where(t["ring"], torch.zeros_like(interp), interp)
    out = src.clone()
    out[:, y1 + 1:y2, x1 + 1:x2] = interp.to(src.dtype)
    return out
