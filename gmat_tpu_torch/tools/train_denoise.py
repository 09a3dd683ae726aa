"""Train the bundled DnCNN denoise checkpoint (`models/weights/dncnn.npz`)
— counterpart of `tools/train_denoise.py`.

Blind gaussian denoising: procedural patches (the SR trainer's generator)
corrupted with sigma ~ U[5, 30]/255 noise; the residual net learns the
noise, so `infer=denoise` removes real noise out of the box.

    python -m gmat_tpu_torch.tools.train_denoise [--steps 16000]
        [--channels 3|1] [--platform cuda|cpu] [--out path.npz]

The noise is drawn on the training device from a `torch.Generator`
seeded per chunk of steps with the JAX trainer's key seed (`jax.random`
draws cannot be reproduced, so the two trainers see other noise); the
held-out evaluation uses the JAX trainer's numpy noise, so equal
parameters give equal numbers.
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
from ..models import denoise
from .train_sr import (CHUNK, index_chunks, make_dataset, make_optimizer,
                       train_step, whole_chunks)


def luma(x):
    """BT.601 luma of (N, 3, H, W) RGB patches: the luma-only set."""
    return (0.299 * x[:, :1] + 0.587 * x[:, 1:2]
            + 0.114 * x[:, 2:3]).astype(np.float32)


def add_noise(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """x + N(0, 1) * sigma, sigma ~ U[5, 30]/255 per image, clipped to
    [0, 1]; drawn from `gen` on x's device."""
    nz = torch.randn(x.shape, generator=gen, device=x.device)
    sg = torch.empty(x.shape[0], device=x.device).uniform_(
        5.0 / 255, 30.0 / 255, generator=gen)
    return torch.clamp(x + nz * sg[:, None, None, None], 0.0, 1.0)


def loss_fn(params, noisy, target):
    return torch.mean((denoise.apply(params, noisy) - target) ** 2)


def psnr(a, b):
    return -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12))


def held_out(params, size: int, channels: int, seed: int, device):
    """PSNR of the noisy input and of the model on 16 held-out patches
    (seed + 777) at sigma = 25, the JAX trainer's numpy noise."""
    test = make_dataset(16, size, seed + 777)
    if channels == 1:
        test = luma(test)
    trng = np.random.default_rng(42)
    noisy = np.clip(test + trng.normal(0, 25.0 / 255, test.shape)
                    .astype(np.float32), 0, 1)
    with torch.no_grad():
        pred = denoise.apply(params, to_device(noisy, device)).cpu().numpy()
    return psnr(noisy, test), psnr(pred, test)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gmat_tpu_torch.tools.train_denoise")
    p.add_argument("--steps", type=int, default=16000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--patches", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="cuda",
                   help="the torch device to train on (cuda, cuda:N, cpu)")
    p.add_argument("--channels", type=int, default=3, choices=(1, 3),
                   help="1 trains the luma-only checkpoint "
                        "(dncnn_l.npz — infer denoise luma_only=1)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not args.out:
        name = "dncnn.npz" if args.channels == 3 else "dncnn_l.npz"
        args.out = os.path.join(WEIGHTS_DIR, name)
    dev = _device(args.platform)

    print(f"generating {args.patches} patches ...", flush=True)
    t0 = time.time()
    clean = make_dataset(args.patches, args.size, args.seed)
    if args.channels == 1:
        clean = luma(clean)
    print(f"  {time.time() - t0:.1f}s", flush=True)

    params = denoise.init_params(models.generator(args.seed),
                                 channels=args.channels, device=dev)
    leaves = [t for layer in params["layers"] for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    opt, sched = make_optimizer(leaves, args.lr, args.steps)

    clean_d = to_device(clean, dev)
    total = whole_chunks(args.steps)
    t0 = time.time()
    for i, idxs in index_chunks(args.seed, args.patches, args.batch,
                                args.steps):
        gen = torch.Generator(device=dev).manual_seed(args.seed * 100003 + i)
        for idx in torch.as_tensor(idxs, device=dev):
            x = clean_d[idx]
            loss = train_step(opt, sched, loss_fn, params,
                              add_noise(x, gen), x)
        if (i // CHUNK) % 20 == 0 or i + CHUNK >= total:
            l = float(loss)
            print(f"step {i + CHUNK:5d}  mse {l:.6f}  psnr "
                  f"{-10 * np.log10(max(l, 1e-12)):.2f} dB  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    # held-out eval at sigma=25
    p_noisy, p_model = held_out(params, args.size, args.channels, args.seed,
                                dev)
    print(f"held-out sigma=25: noisy {p_noisy:.2f} dB -> model "
          f"{p_model:.2f} dB (gain {p_model - p_noisy:+.2f})")
    if p_model < p_noisy + 3.0:
        raise SystemExit("model gain < 3 dB; not saving")

    flat = {}
    for i, layer in enumerate(params["layers"]):
        flat[f"layers.{i}.w"] = layer["w"].detach().cpu().numpy()
        flat[f"layers.{i}.b"] = layer["b"].detach().cpu().numpy()
    np.savez(args.out, **flat)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KB)")
    return {"psnr_noisy": p_noisy, "psnr_model": p_model, "loss": l,
            "steps": total, "train_s": train_s, "out": args.out}


if __name__ == "__main__":
    main()
