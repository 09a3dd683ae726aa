"""8x8 DCT / quantization tiles — counterpart of `gmat_tpu/ops/dct.py`,
the device half of the JPEG still codec (the nvjpeg analog: the
coefficients on the card, Huffman coding on the host in
csrc/gmat_jpeg.cpp).

A frame is blockified to (..., 8, 8) tiles and the whole batch goes
through C = D @ X @ D^T (orthonormal DCT-II) as f32 tensor ops on the
plane's device.  Each 8-term product runs as XLA's CPU dot computes it
(four accumulators, j mod 4, each a chain of fused multiply-adds, summed
as (a0 + a1) + (a2 + a3)); a fused multiply-add is taken in float64 (the
f32 product is exact there) and rounded once to f32.  So the
coefficients equal the JAX package's bit for bit, on the CPU and on the
card, and no TF32 or reduced-precision product can enter.  Quantization
divides by the table as a tensor on the device (never a host scalar,
which CUDA divides through its reciprocal); `torch.round` rounds half to
even, as `jnp.round` does.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# ITU-T81 Annex K base quantization tables
QUANT_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

QUANT_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)


def quality_tables(quality: int):
    """libjpeg quality scaling -> (luma, chroma) uint8 tables."""
    q = int(np.clip(quality, 1, 100))
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def scale_tbl(t):
        return np.clip((t * scale + 50) // 100, 1, 255).astype(np.uint8)

    return scale_tbl(QUANT_LUMA), scale_tbl(QUANT_CHROMA)


@lru_cache(maxsize=1)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix."""
    k = np.arange(8)
    D = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    D[0] *= 1.0 / np.sqrt(2.0)
    return (D * 0.5).astype(np.float32)


# T.81 zigzag scan: ZIGZAG[i] = natural (row-major) index of scan pos i
ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int32)
ZIGZAG_INV = np.argsort(ZIGZAG).astype(np.int32)

_consts = {}


def _const(name, arr: np.ndarray, device) -> torch.Tensor:
    """A host table as a tensor on `device`, made once per device."""
    key = (name, str(device))
    if key not in _consts:
        if len(_consts) > 64:
            _consts.clear()
        _consts[key] = torch.as_tensor(arr, device=device)
    return _consts[key]


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding: the f32 product is exact in f64."""
    return (a.double() * b + c.double()).float()


def _mm4(terms) -> torch.Tensor:
    """sum_j a_j * b_j over 8 terms (f64 products), XLA CPU's way: four
    fused multiply-add chains (j mod 4), then (a0 + a1) + (a2 + a3)."""
    acc = [None] * 4
    for j, (a, b) in enumerate(terms):
        p = a * b
        r = j % 4
        acc[r] = p.float() if acc[r] is None else (p + acc[r].double()).float()
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _left(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """out[..., i, k] = sum_j L[i, j] X[..., j, k]."""
    Xd = X.double()
    return _mm4((L[:, j, None], Xd[..., j, None, :]) for j in range(8))


def _right(X: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_k X[..., i, k] R[k, j]."""
    Xd = X.double()
    return _mm4((Xd[..., :, k, None], R[k, None, :]) for k in range(8))


def _dmat(device) -> torch.Tensor:
    return _const("D", dct_matrix().astype(np.float64), device)


def to_zigzag(coefs: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) natural-order blocks -> (..., 64) zigzag scan order, so
    the host entropy coder reads purely sequential memory."""
    flat = coefs.reshape(coefs.shape[:-2] + (64,))
    return flat[..., _const("zz", ZIGZAG.astype(np.int64), coefs.device)]


def from_zigzag(z: torch.Tensor) -> torch.Tensor:
    """(..., 64) zigzag order -> (..., 8, 8) natural-order blocks."""
    flat = z[..., _const("izz", ZIGZAG_INV.astype(np.int64), z.device)]
    return flat.reshape(z.shape[:-1] + (8, 8))


def blockify(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H//8, W//8, 8, 8)."""
    n, h, w = x.shape
    return x.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def unblockify(b: torch.Tensor) -> torch.Tensor:
    """(N, bh, bw, 8, 8) -> (N, bh*8, bw*8)."""
    n, bh, bw = b.shape[:3]
    return b.permute(0, 1, 3, 2, 4).reshape(n, bh * 8, bw * 8)


def dct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """DCT-II over the trailing (8, 8) dims: D @ X @ D^T, f32 out."""
    D = _dmat(blocks.device)
    return _right(_left(D, blocks.to(torch.float32)), D.t())


def idct8x8(coefs: torch.Tensor) -> torch.Tensor:
    """D^T @ C @ D, f32 out."""
    D = _dmat(coefs.device)
    return _right(_left(D.t(), coefs.to(torch.float32)), D)


def qtable(table, device) -> torch.Tensor:
    """A quantization table (64 entries, or (N, 1, 1, 8, 8) per image) as
    an f32 tensor on `device`; 64-entry tables are kept per device, so a
    batch after the first uploads none."""
    q = np.asarray(table, np.float32)
    if q.size == 64:
        return _const(("q", q.tobytes()), q.reshape(8, 8), device)
    return torch.as_tensor(q, device=device)


def encode_plane(x: torch.Tensor, table) -> torch.Tensor:
    """(N, H, W) u8 (or f32 0..255) plane -> (N, H//8, W//8, 8, 8) int16
    quantized coefficients of the level-shifted JPEG forward transform
    (the orthonormal D gives T.81's scale: DC of a flat-128 block is 0)."""
    blocks = blockify(x.to(torch.float32) - 128.0)
    coefs = dct8x8(blocks)
    q = table if isinstance(table, torch.Tensor) else qtable(table, x.device)
    return torch.round(coefs / q).to(torch.int16)


def decode_plane(coefs: torch.Tensor, table) -> torch.Tensor:
    """Quantized coefficients -> (N, H, W) u8 plane."""
    q = table if isinstance(table, torch.Tensor) else qtable(table,
                                                             coefs.device)
    blocks = idct8x8(coefs.to(torch.float32) * q)
    x = unblockify(blocks) + 128.0
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
