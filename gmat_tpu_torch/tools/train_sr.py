"""Train the bundled ESPCN checkpoints (`models/weights/espcn_x{2,3}.npz`)
— counterpart of `tools/train_sr.py`.

A real x2 (or x3) model trained on a procedural dataset (smooth gradients
+ anti-aliased shapes + sinusoid textures, the content classes the PSNR
golden test holds out), written as the ~110 KB .npz that the port's
InferFilter auto-loads from its own `models/weights/`.

    python -m gmat_tpu_torch.tools.train_sr [--steps 24000] [--scale 2|3]
        [--hidden 64] [--platform cuda|cpu] [--out path.npz]

Degradation model: HR -> kxk box average (area downsample, k=--scale),
the `area` kernel of ops/resize, so the chain `scale=area,infer=sr2x`
(or sr3x) is self-consistent.

The dataset generator is a copy of the JAX tool's (bit-equal output), and
the batches are drawn from the same index stream, so on equal parameters
both trainers see the same batches.  Adam with optax's defaults under
optax's cosine decay (`cosine_decay`); each step's forward and backward
pass run with TF32 off (`train_step`).  `--platform` names the torch
device: the card by default, `cpu` on request; there is no fallback.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import models
from ..av.ingest import _device
from ..core.frame import to_device
from ..filters.infer import WEIGHTS_DIR
from ..models import sr
from ..ops.resize import resize_plane

# steps per index draw: the JAX trainer's lax.scan chunk, kept so that
# both trainers draw the same batches from the same seed
CHUNK = 100


# ------------------------------------------------------------ dataset

def _upsample_smooth(rng, n, size, lo_min=6, lo_max=24):
    """Low-res noise linearly upsampled -> smooth natural-ish gradients."""
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        lo = rng.integers(lo_min, lo_max)
        small = rng.uniform(0, 1, (lo, lo, 3)).astype(np.float32)
        # separable linear upsample (np only)
        xi = np.linspace(0, lo - 1, size)
        x0 = np.floor(xi).astype(int)
        x1 = np.minimum(x0 + 1, lo - 1)
        fx = (xi - x0).astype(np.float32)
        t = small[x0] * (1 - fx)[:, None, None] + small[x1] * fx[:, None, None]
        t = (t[:, x0] * (1 - fx)[None, :, None]
             + t[:, x1] * fx[None, :, None])
        out[i] = t
    return out


def _draw_shapes(rng, img):
    """Anti-aliased ellipses/rectangles/lines drawn at 4x then box-averaged
    (sub-pixel edges are what SR must learn to reconstruct)."""
    size = img.shape[0]
    s4 = size * 4
    canvas = np.repeat(np.repeat(img, 4, 0), 4, 1).astype(np.float32)
    yy, xx = np.mgrid[0:s4, 0:s4].astype(np.float32)
    for _ in range(rng.integers(2, 7)):
        color = rng.uniform(0, 1, 3).astype(np.float32)
        kind = rng.integers(0, 3)
        if kind == 0:      # ellipse
            cy, cx = rng.uniform(0, s4, 2)
            ry, rx = rng.uniform(s4 * 0.03, s4 * 0.35, 2)
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        elif kind == 1:    # rectangle
            y0, x0 = rng.uniform(0, s4 * 0.8, 2)
            hgt, wid = rng.uniform(s4 * 0.05, s4 * 0.5, 2)
            m = (yy >= y0) & (yy < y0 + hgt) & (xx >= x0) & (xx < x0 + wid)
        else:              # thick line
            a = rng.uniform(0, np.pi)
            c, s = np.cos(a), np.sin(a)
            d = rng.uniform(-s4 / 2, s4 / 2)
            t = rng.uniform(2.0, 14.0)
            m = np.abs((xx - s4 / 2) * c + (yy - s4 / 2) * s - d) < t
        alpha = rng.uniform(0.5, 1.0)
        canvas[m] = canvas[m] * (1 - alpha) + color * alpha
    # 4x4 box average back to size (anti-aliased edges)
    return canvas.reshape(size, 4, size, 4, 3).mean((1, 3))


def _add_texture(rng, img):
    size = img.shape[0]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(rng.integers(0, 3)):
        fy, fx = rng.uniform(0.05, 0.8, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.02, 0.12)
        wave = amp * np.sin(fy * yy + fx * xx + ph)
        ch = rng.integers(0, 3)
        img[..., ch] = np.clip(img[..., ch] + wave, 0, 1)
    return img


def make_dataset(n_patches: int, hr: int, seed: int):
    """(N, 3, hr, hr) HR patches in [0,1], NCHW (host numpy)."""
    rng = np.random.default_rng(seed)
    out = _upsample_smooth(rng, n_patches, hr)
    for i in range(n_patches):
        out[i] = _draw_shapes(rng, out[i])
        out[i] = _add_texture(rng, out[i])
    return np.clip(out, 0, 1).transpose(0, 3, 1, 2).astype(np.float32)


def area_down(x, k=2):
    """(N, C, H, W) -> (N, C, H/k, W/k) kxk box average."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // k, k, w // k, k).mean((3, 5))


# ------------------------------------------------------------ training

def cosine_decay(lr: float, steps: int, alpha: float = 0.0):
    """`optax.cosine_decay_schedule(lr, steps, alpha)`: the learning rate
    at a step count, in optax's float32 arithmetic (the cosine rounded
    once from float64, as XLA's scalar cosine is)."""
    f = np.float32

    def schedule(count: int) -> float:
        arg = f(np.pi) * f(min(count, steps)) / f(steps)
        decay = f(0.5) * (f(1) + f(np.cos(np.float64(arg))))
        return float(f(lr) * (f(1 - alpha) * decay + f(alpha)))
    return schedule


def make_optimizer(params, lr: float, steps: int):
    """Adam with optax's defaults over `params`, its rate set before each
    step by cosine_decay(lr, steps, alpha=0.01): LambdaLR over a base rate
    of 1 takes the schedule's value as the rate.  Step the scheduler after
    every optimizer step (`train_step` does)."""
    opt = torch.optim.Adam(params, lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, cosine_decay(lr, steps, alpha=0.01))
    return opt, sched


def train_step(opt, sched, loss_fn, params, *batch) -> torch.Tensor:
    """One step of loss_fn(params, *batch).  The forward and the backward
    pass both run under `models.exact_f32()`: cuDNN's backward
    convolutions follow the flags that hold while `backward()` runs, and
    PyTorch's default lets them use TF32.  Returns the loss, not read
    back."""
    opt.zero_grad(set_to_none=True)
    with models.exact_f32():
        loss = loss_fn(params, *batch)
        loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def whole_chunks(steps: int) -> int:
    """The step count rounded up to whole chunks, as the JAX trainer
    runs it."""
    return -(-steps // CHUNK) * CHUNK


def index_chunks(seed: int, patches: int, batch: int, steps: int):
    """(first step, (CHUNK, batch) patch indices) per chunk: the JAX
    trainer's index stream."""
    rng = np.random.default_rng(seed + 1)
    for i in range(0, whole_chunks(steps), CHUNK):
        yield i, rng.integers(0, patches, (CHUNK, batch))


def psnr(a, b):
    return -10 * np.log10(max(np.mean((a - b) ** 2), 1e-12))


def held_out(params, hr: int, scale: int, seed: int, device):
    """PSNR of the model and of bicubic upsampling on 16 held-out patches
    (seed + 999), as the JAX trainer evaluates."""
    test = make_dataset(16, hr, seed + 999)
    test_lr = area_down(test, scale)
    with torch.no_grad():
        pred = sr.apply(params, to_device(test_lr, device)).cpu().numpy()
    flat = test_lr.reshape(-1, test_lr.shape[2], test_lr.shape[3])
    bic = resize_plane(to_device(flat, device) * 255.0, hr, hr,
                       "bicubic").cpu().numpy() / 255.0
    bic = np.clip(bic.reshape(test.shape), 0, 1)
    return psnr(pred, test), psnr(bic, test)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m gmat_tpu_torch.tools.train_sr")
    p.add_argument("--steps", type=int, default=24000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--hr", type=int, default=96)
    p.add_argument("--patches", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--scale", type=int, default=2, choices=(2, 3))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="cuda",
                   help="the torch device to train on (cuda, cuda:N, cpu)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not args.out:
        # non-default widths land in their own file (the _bundled_weights
        # naming): --hidden 128 must not overwrite the shipped h64 npz
        # with shape-incompatible weights
        suffix = f"_h{args.hidden}" if args.hidden != 64 else ""
        args.out = os.path.join(WEIGHTS_DIR,
                                f"espcn_x{args.scale}{suffix}.npz")
    if args.hr % args.scale:
        raise SystemExit("--hr must be divisible by --scale")
    dev = _device(args.platform)

    print(f"generating {args.patches} HR patches ...", flush=True)
    t0 = time.time()
    hrs = make_dataset(args.patches, args.hr, args.seed)
    lrs = area_down(hrs, args.scale)
    print(f"  {time.time() - t0:.1f}s", flush=True)

    params = sr.init_params(models.generator(args.seed), scale=args.scale,
                            hidden=args.hidden, device=dev)
    for t in params.values():
        t.requires_grad_(True)
    # cosine decay to ~0: the last-mile mse on smooth regions is what
    # decides PSNR vs bicubic on this dataset
    opt, sched = make_optimizer(list(params.values()), args.lr, args.steps)

    lrs_d, hrs_d = to_device(lrs, dev), to_device(hrs, dev)
    t0 = time.time()
    for i, idxs in index_chunks(args.seed, args.patches, args.batch,
                                args.steps):
        for idx in torch.as_tensor(idxs, device=dev):
            loss = train_step(opt, sched, sr.loss_fn, params, lrs_d[idx],
                              hrs_d[idx])
        if (i // CHUNK) % 20 == 0 or i + CHUNK >= args.steps:
            l = float(loss)
            print(f"step {i + CHUNK:5d}  mse {l:.6f}  psnr "
                  f"{-10 * np.log10(max(l, 1e-12)):.2f} dB  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    # held-out eval: model vs bicubic upsample
    p_model, p_bic = held_out(params, args.hr, args.scale, args.seed, dev)
    print(f"held-out PSNR: model {p_model:.2f} dB vs bicubic "
          f"{p_bic:.2f} dB (gain {p_model - p_bic:+.2f})")
    if p_model <= p_bic:
        raise SystemExit("model does not beat bicubic; not saving")

    np.savez(args.out, **{k: v.detach().cpu().numpy()
                          for k, v in params.items()})
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KB)")
    return {"psnr_model": float(p_model), "psnr_bicubic": float(p_bic),
            "loss": l, "steps": whole_chunks(args.steps),
            "train_s": train_s, "out": args.out}


if __name__ == "__main__":
    main()
