"""deband, the banding-artifact remover (vf_deband.c) — counterpart of
`gmat_tpu/ops/deband.py`.

Per-pixel 4-reference sampling at a static pseudo-random offset field
(frand(x, y) = fract(sinf(x*12.9898 + y*78.233) * 43758.545),
vf_deband.c:113-118), averaged and selected against per-plane thresholds
(:129-176 deband_8_c / :300-358 deband_16_c; the coupling variants
:179-298).

The offset table is the JAX module's float32 numpy transcription,
copied, built once per (W, H, range, direction).  The four reference
index maps derived from it are built once per (table, plane shape,
device) and live on the device; each batch is then four gathers per
plane.  Chroma planes index the LUMA-width table at their own
coordinates (:151-152): the luma table sliced to the plane's size.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_TABLE_CACHE: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}
_INDEX_CACHE: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def offset_table(w: int, h: int, rng: int, direction: float):
    """(x_pos, y_pos) int32 (h, w) tables (config_input :396-403)."""
    key = (w, h, rng, float(direction))
    tab = _TABLE_CACHE.get(key)
    if tab is not None:
        return tab
    f32 = np.float32
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    arg = (x * f32(12.9898) + y * f32(78.233)).astype(np.float32)
    r = (np.sin(arg, dtype=np.float32) * f32(43758.545)).astype(np.float32)
    r = (r - np.floor(r)).astype(np.float32)
    d = f32(direction)
    dir_ = np.full_like(r, -d) if direction < 0 else (r * d)
    dist = (np.full_like(r, -rng) if rng < 0
            else (r * f32(rng))).astype(np.int32)   # C int trunc
    x_pos = (np.cos(dir_, dtype=np.float32)
             * dist.astype(np.float32)).astype(np.int32)
    y_pos = (np.sin(dir_, dtype=np.float32)
             * dist.astype(np.float32)).astype(np.int32)
    _TABLE_CACHE[key] = (x_pos, y_pos)
    return x_pos, y_pos


def reference_index(key, x_pos: np.ndarray, y_pos: np.ndarray, h: int,
                    w: int, device) -> Tuple[torch.Tensor, ...]:
    """The four clipped reference positions (±y_pos, ±x_pos) of every
    pixel of an (h, w) plane as flat int64 indices on `device`, cached
    under (key, h, w, device); key names the table."""
    ck = (key, h, w, str(device))
    hit = _INDEX_CACHE.get(ck)
    if hit is not None:
        return hit
    xp, yp = x_pos[:h, :w].astype(np.int64), y_pos[:h, :w].astype(np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    iyp = np.clip(yy + yp, 0, h - 1)
    iym = np.clip(yy - yp, 0, h - 1)
    ixp = np.clip(xx + xp, 0, w - 1)
    ixm = np.clip(xx - xp, 0, w - 1)
    hit = tuple(torch.as_tensor((iy * w + ix).reshape(-1), device=device)
                for iy, ix in ((iyp, ixp), (iym, ixp), (iym, ixm),
                               (iyp, ixm)))
    if len(_INDEX_CACHE) > 16:
        _INDEX_CACHE.clear()
    _INDEX_CACHE[ck] = hit
    return hit


def _refs(plane: torch.Tensor, index):
    """The four reference samples per pixel, int32 (N, h, w) each
    (advanced indexing: on the CPU several times faster than
    index_select along dim 1)."""
    n, h, w = plane.shape
    flat = plane.reshape(n, h * w).to(torch.int32)
    return tuple(flat[:, i].reshape(n, h, w) for i in index)


def _test(src, refs, avg, thr: int, blur: bool):
    if blur:
        return (src - avg).abs() < thr
    r0, r1, r2, r3 = refs
    return (((src - r0).abs() < thr) & ((src - r1).abs() < thr)
            & ((src - r2).abs() < thr) & ((src - r3).abs() < thr))


def deband_plane(plane: torch.Tensor, index, thr: int,
                 blur: bool) -> torch.Tensor:
    """Uncoupled per-plane kernel (deband_8_c / deband_16_c)."""
    refs = _refs(plane, index)
    src = plane.to(torch.int32)
    avg = (refs[0] + refs[1] + refs[2] + refs[3]) // 4
    return torch.where(_test(src, refs, avg, thr, blur), avg,
                       src).to(plane.dtype)


def deband_coupled(planes, index, thrs, blur: bool):
    """Coupling variant (444/RGB only): every plane must pass its
    threshold test for ANY plane to be replaced (:179-298)."""
    avgs, srcs, all_pass = [], [], None
    for plane, thr in zip(planes, thrs):
        refs = _refs(plane, index)
        src = plane.to(torch.int32)
        avg = (refs[0] + refs[1] + refs[2] + refs[3]) // 4
        cmp_ = _test(src, refs, avg, thr, blur)
        all_pass = cmp_ if all_pass is None else all_pass & cmp_
        avgs.append(avg)
        srcs.append(src)
    return [torch.where(all_pass, a, s).to(p.dtype)
            for p, a, s in zip(planes, avgs, srcs)]
