"""In-graph inference filter (the tensorrt filter) — counterpart of
`gmat_tpu/filters/infer.py`.

Where the reference binds AVFrames as TensorRT engine bindings
(vf_tensorrt.c:160-179, tensorrt.cpp:586-631), the model here is a plain
PyTorch function on the batch's device, run eagerly between the graph's
other filters, so activations never leave the card.

Two IO modes mirroring the reference (vf_tensorrt.c:206-217):
  * 3-channel: RGBPF32 in -> RGBPF32 out (any spatial scale factor)
  * luma-only: Y plane in (1 channel), chroma passed through / resampled
    (copy_UV_plane, tensorrt.cpp:562-584)

The params live on the host and are copied (and, for bf16, cast) once
per device on first use.
"""
from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from .. import models
from ..core.frame import FrameBatch
from ..ops import csc, resize

# the JAX package's shipped checkpoints, read where they are (data files)
WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "gmat_tpu", "models", "weights")


def _bundled_weights(model: str, channels: int, hidden: int) -> str:
    """Path of a shipped pretrained checkpoint for this config, or ''."""
    name = None
    if model == "sr2x" and channels == 3 and hidden in (0, 64):
        name = "espcn_x2.npz"
    elif model == "sr2x" and channels == 3 and hidden == 128:
        name = "espcn_x2_h128.npz"
    elif model == "sr3x" and channels == 3 and hidden in (0, 64):
        name = "espcn_x3.npz"
    elif model == "denoise" and channels == 3:
        name = "dncnn.npz"
    elif model == "denoise" and channels == 1:
        # luma-only checkpoint; an absent file falls through to ''
        name = "dncnn_l.npz"
    if name:
        p = os.path.join(WEIGHTS_DIR, name)
        if os.path.exists(p):
            return p
    return ""


def _load_one(name, v, loaded):
    if hasattr(v, "shape") and tuple(loaded[name].shape) != tuple(v.shape):
        raise ValueError(
            f"weights[{name!r}] shape {loaded[name].shape} does not "
            f"match the model's {tuple(v.shape)} — was the "
            "checkpoint trained at a different hidden width?")
    return torch.tensor(loaded[name], device=v.device)


def _load_weights(params, path: str):
    """Map a flat .npz onto the model's param tree.  Flat dicts match by
    key; lists of layer dicts use the `layers.{i}.{name}` convention."""
    if not path or path == "random":   # "random" skips the bundled npz
        return params
    with np.load(path) as z:
        loaded = dict(z)
    used = set()
    out = {}
    for k, v in params.items():
        if k in loaded:
            out[k] = _load_one(k, v, loaded)
            used.add(k)
        elif isinstance(v, list):
            # a checkpoint carrying ANY layers.* keys must carry them all:
            # a depth-mismatched npz would mix trained and random weights
            has_any = any(key.startswith(f"{k}.") for key in loaded)
            missing = [f"{k}.{i}.{n}"
                       for i, layer in enumerate(v)
                       for n in layer
                       if f"{k}.{i}.{n}" not in loaded]
            if has_any and missing:
                raise ValueError(
                    f"checkpoint {path!r} is missing {missing[:3]}... — "
                    "was it trained at a different depth?")
            out[k] = [
                {n: (_load_one(f"{k}.{i}.{n}", a, loaded)
                     if f"{k}.{i}.{n}" in loaded else a)
                 for n, a in layer.items()}
                for i, layer in enumerate(v)]
            used.update(key for key in loaded if key.startswith(f"{k}."))
        else:
            out[k] = v
    unused = sorted(set(loaded) - used)
    if unused:
        # keys matching nothing mean the wrong/renamed checkpoint
        raise ValueError(
            f"checkpoint {path!r} has keys the model does not: "
            f"{unused[:4]}{'...' if len(unused) > 4 else ''}")
    return out


class InferFilter:
    """Callable FrameBatch filter wrapping a PyTorch model."""

    def __init__(self, model: str = "sr2x", weights: str = "",
                 luma_only: bool = False, precision: str = "bf16",
                 hidden: int = 0):
        """precision="bf16" (default) runs the convs on bf16 values with
        f32 accumulation (the reference builds its engines with the FP16
        flag, tensorrt.cpp:198-222); "fp32" keeps full f32 (no TF32).
        hidden widens the sr model's conv layers (0 = the default 64)."""
        if precision not in ("bf16", "fp32"):
            raise ValueError(f"precision must be bf16|fp32, got {precision!r}")
        self.precision = precision
        self.name = model
        self.luma_only = luma_only
        self.last_output = None          # for the vector models (numpy)
        self._dev = {}                   # device -> params there
        channels = 1 if luma_only else 3
        if int(hidden) and not (model.startswith("sr") and ":" not in model):
            raise ValueError("hidden= only applies to the sr models")
        if ":" in model:
            # custom module:function FIRST — a user module named
            # 'sr_models' must not be taken by the sr prefix
            mod, fn = model.split(":", 1)
            self.apply = getattr(importlib.import_module(mod), fn)
            self.params = None
            self.scale = 1
            self.kind = "image"
        elif model.startswith("sr"):
            from ..models import sr
            scale = int(model[2]) if len(model) > 2 and model[2].isdigit() \
                else 2
            kw = {"hidden": int(hidden)} if int(hidden) else {}
            params = sr.init_params(scale=scale, channels=channels,
                                    device="cpu", **kw)
            if not weights:
                weights = _bundled_weights(model, channels, int(hidden))
            self.params = _load_weights(params, weights)
            self.apply = sr.apply
            self.scale = scale
            self.kind = "image"
        elif model == "denoise":
            from ..models import denoise
            params = denoise.init_params(channels=channels, device="cpu")
            if not weights:
                weights = _bundled_weights(model, channels, 0)
            self.params = _load_weights(params, weights)
            self.apply = denoise.apply
            self.scale = 1
            self.kind = "image"
        elif model == "pose":
            from ..models import pose
            self.params = _load_weights(pose.init_params(device="cpu"),
                                        weights)
            self.apply = pose.apply
            self.scale = 1
            self.kind = "vector"
        elif model == "classify":
            from ..models import classify
            self.params = _load_weights(classify.init_params(device="cpu"),
                                        weights)
            self.apply = classify.apply
            self.scale = 1
            self.kind = "vector"
        else:
            raise ValueError(f"unknown infer model {model!r} "
                             "(sr2x|sr3x|denoise|pose|classify|"
                             "module:function)")

    def params_on(self, device):
        """The params on `device`, in the filter's precision."""
        key = str(device)
        if key not in self._dev:
            p = models.to_device(self.params, device)
            if self.precision == "bf16":
                p = models.cast(p, torch.bfloat16)
            self._dev[key] = p
        return self._dev[key]

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        if self.params is None:
            return self.apply(x)
        params = self.params_on(x.device)
        if self.precision == "bf16":
            # cast at the model boundary: convs and inter-layer
            # activations in bf16, products accumulated in f32
            return self.apply(params, x.to(torch.bfloat16)).float()
        return self.apply(params, x)

    def __call__(self, fb: FrameBatch) -> FrameBatch:
        if self.luma_only:
            return self._call_luma(fb)
        rgb = fb if fb.format == "rgbpf32" else csc.convert(
            fb, "rgbpf32", norm=255.0)
        out = self._run(csc.to_nchw(rgb))
        if self.kind == "vector":
            self.last_output = out.float().cpu().numpy()
            return fb
        return csc.from_nchw(out, "rgbpf32", fb.colorspace)

    def _call_luma(self, fb: FrameBatch) -> FrameBatch:
        if fb.fmt.is_rgb:
            raise ValueError("luma_only infer requires a YUV input")
        if fb.fmt.bits != 8:
            raise ValueError("luma_only infer is an 8-bit lane (got "
                             f"{fb.format}); insert format=yuv420p first")
        y = fb.planes["y"].to(torch.float32)[:, None]
        y = y / torch.tensor(255.0, device=y.device)   # a true division
        out = torch.clamp(self._run(y), 0.0, 1.0)
        y_out = torch.round(out[:, 0] * 255.0).to(torch.uint8)
        r = self.scale
        planes = {"y": y_out}
        for c in ("u", "v"):
            if c not in fb.planes:       # gray8: luma IS the image
                continue
            p = fb.planes[c]
            if r != 1:   # keep chroma consistent with the scaled luma
                p = resize.resize_plane(p, p.shape[1] * r, p.shape[2] * r,
                                        "nearest", dtype=torch.float32)
                p = torch.clamp(torch.round(p), 0, 255).to(torch.uint8)
            planes[c] = p
        return fb.with_planes(planes, width=fb.width * r,
                              height=fb.height * r)
