"""Scene-change scoring — counterpart of `gmat_tpu/ops/scene.py`, the
rebuild of select_cuda's GPU SAD.

Reference: vf_select_cuda.c:308-358 (get_scene_score) + scene_sad_cuda.cu:
  sad   = sum over planes of |cur - prev|        (all planes, full res)
  mafd  = sad / total_pixel_count / 2^(bitdepth-8)
  diff  = |mafd - prev_mafd|
  score = clip(min(mafd, diff) / 100, 0, 1)

The whole batch is scored with a few tensor reductions on the batch's
device: SAD between consecutive frames is one reduction per plane, so a
GOP of frames is scored in one pass.  No TPU kernel runs here; this is
plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.frame import FrameBatch

# BT.601 luma weights — the reference scene SAD operates on true luma
# (scene_sad_cuda.cu:38-76 reads the Y plane); RGB batches reduce to it
_LUMA601 = (0.299, 0.587, 0.114)


def _score_view(fmt, planes: dict) -> dict:
    """Planes the SAD actually reads.  YUV batches pass through (the
    reference sums all planes).  RGB batches reduce to BT.601 luma at
    8-bit scale; >8-bit and float samples normalize to 0..255 so mafd
    uses bitdepth 8.

    The channel axis is read from the tensor: a channels-last (h, w, c)
    batch and a planar (c, h, w) float batch both reduce correctly."""
    if not fmt.is_rgb:
        return planes
    arr = planes["rgb"]
    nc = len(fmt.channel_order)
    ax = (arr.dim() - 1 if arr.shape[-1] == nc
          else arr.dim() - 3 if arr.dim() >= 3 and arr.shape[-3] == nc
          else arr.dim() - 1)
    idx = {c: i for i, c in enumerate(fmt.channel_order)}
    a = arr.to(torch.float32)
    y = (_LUMA601[0] * a.select(ax, idx["r"])
         + _LUMA601[1] * a.select(ax, idx["g"])
         + _LUMA601[2] * a.select(ax, idx["b"]))
    if fmt.is_float:
        y = y * 255.0
    elif fmt.bits > 8:
        y = y * (1.0 / (1 << (fmt.bits - 8)))
    return {"y601": y}


def score_depth(fmt) -> int:
    """Effective bit depth of the SAD input (RGB reduces to 8-bit luma)."""
    return 8 if fmt.is_rgb else fmt.bits


def _score_count(fmt, h: int, w: int) -> int:
    """Sample count the mafd normalizes by, matching _score_view."""
    if fmt.is_rgb:
        return h * w
    count = 0
    for p in fmt.planes:
        sh = fmt.plane_shape(p.name, h, w)
        count += sh[0] * sh[1] * (sh[2] if len(sh) > 2 else 1)
    return count


def batch_sad(fb: FrameBatch, prev_last: Optional[dict] = None
              ) -> torch.Tensor:
    """(N,) sum-abs-diff between frame i and i-1 across the score planes
    (all YUV planes, or true luma for RGB batches).

    Element 0 compares against `prev_last` (the final frame of the previous
    batch, as a dict of RAW planes) or is 0 when there is no predecessor.
    """
    planes = _score_view(fb.fmt, fb.planes)
    prev = (_score_view(fb.fmt, prev_last)
            if prev_last is not None else None)
    total = None
    for name, arr in planes.items():
        a = arr.to(torch.float32)
        if prev is not None:
            p = prev[name].to(torch.float32)
            if p.dim() == a.dim() - 1:
                p = p[None]
            prv = torch.cat([p, a[:-1]], dim=0)
        else:
            prv = torch.cat([a[:1], a[:-1]], dim=0)
        # sum in f32: int32 overflows at 4K (3840*2160*255 > 2^31);
        # |diff| <= 65535 is exact in f32 and the sum's rounding error is
        # ~1e-7 relative, invisible in mafd
        s = torch.sum(torch.abs(a - prv), dim=tuple(range(1, a.dim())))
        total = s if total is None else total + s
    if prev_last is None:
        total[0] = 0
    return total


def scene_scores(fb: FrameBatch, prev_last: Optional[dict] = None,
                 prev_mafd=0.0, bitdepth: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame scene score (N,) plus the final mafd (carry for the next
    batch).  Exact select_cuda math."""
    score, mafd = scene_scores_mafd(fb, prev_last, prev_mafd, bitdepth)
    return score, mafd[-1]


def scene_scores_mafd(fb: FrameBatch, prev_last: Optional[dict] = None,
                      prev_mafd=0.0, bitdepth: int = 8):
    """Like scene_scores but also returns the full per-frame mafd array —
    callers scoring a padded batch need the carry at the last REAL frame,
    not at the padded tail (a duplicate frame's mafd is 0).  f32 throughout,
    as the JAX package computes it with x64 off."""
    sad = batch_sad(fb, prev_last)
    count = _score_count(fb.fmt, fb.height, fb.width)
    mafd = sad / count / (1 << (bitdepth - 8))
    carry = torch.as_tensor(prev_mafd, dtype=mafd.dtype,
                            device=mafd.device).reshape(1)
    prev = torch.cat([carry, mafd[:-1]])
    diff = torch.abs(mafd - prev)
    score = torch.clamp(torch.minimum(mafd, diff) / 100.0, 0.0, 1.0)
    if prev_last is None:
        score[0] = 0.0
    return score, mafd
