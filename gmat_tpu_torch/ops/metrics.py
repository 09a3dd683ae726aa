"""Quality metrics: PSNR / SSIM over frame batches — counterpart of
`gmat_tpu/ops/metrics.py`.

The measurement half of the reference's manual quality tooling
(metrans/test/AppNvTransDiff.cpp compares interpolated/scaled/encoded
output by eyeball and printed values) — batched f32 reductions on the
planes' device, usable in tests and quality gates.  The f32 means sum in
another order than XLA's, so values agree with the JAX module to f32
rounding (rtol 1e-5), not bit for bit.
"""
from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 255.0) -> torch.Tensor:
    """Per-frame PSNR (dB) over (N, ...) batches."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    dims = tuple(range(1, a.ndim))
    mse = torch.mean((af - bf) ** 2, dim=dims)
    peak = torch.tensor(max_val * max_val, dtype=torch.float32,
                        device=a.device)
    return 10.0 * torch.log10(peak / torch.clamp(mse, min=1e-10))


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0,
         win: int = 8) -> torch.Tensor:
    """Per-frame mean SSIM over (N, H, W) planes (non-overlapping windows,
    uniform weighting — the fast variant used for monitoring)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    n, h, w = a.shape
    if h < win or w < win:
        raise ValueError(f"ssim needs planes of at least {win}x{win}, "
                         f"got {h}x{w} (pass a smaller win=)")
    hh, ww = h // win * win, w // win * win

    def blocks(x):
        x = x[:, :hh, :ww].to(torch.float32)
        return x.reshape(n, hh // win, win, ww // win, win)

    xa, xb = blocks(a), blocks(b)
    mu_a = xa.mean(dim=(2, 4))
    mu_b = xb.mean(dim=(2, 4))
    var_a = xa.var(dim=(2, 4), correction=0)
    var_b = xb.var(dim=(2, 4), correction=0)
    cov = (xa * xb).mean(dim=(2, 4)) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2) /
         ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return s.mean(dim=(1, 2))
