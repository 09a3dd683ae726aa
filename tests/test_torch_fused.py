"""The slice as a whole: the port's preprocess_nchw against the JAX one on
the same inputs, its kernel dispatch, and bucketing."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.core import formats as jformats
from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.core.frame import pack_nv12 as jpack_nv12
from gmat_tpu.ops import fused as jfused
from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu_torch.core.frame import FrameBatch, unpack_nv12
from gmat_tpu_torch.ops import fused, ladder

K1_LSB, K2_LSB = 0.01, 1.0


def _planes(rng, fmt, n=2, h=64, w=128):
    f = jformats.get(fmt)
    dt = np.dtype(f.planes[0].dtype)
    hi = (1 << f.bits) if dt == np.uint16 else 256
    return {p.name: rng.integers(0, hi, (n,) + f.plane_shape(p.name, h, w))
            .astype(dt) for p in f.planes}


def _pair(planes, fmt, w=128, h=64, cs="bt709"):
    jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()}, fmt, w,
                      h, cs)
    return jfb, FrameBatch.from_numpy(planes, fmt, w, h, cs, device="cpu")


def _lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    return float(np.abs(a - b).max()) * 255.0


_LANES = {   # name: (format, preprocess kwargs, bound)
    "yuv420p": ("yuv420p", {}, K1_LSB),
    "nv12": ("nv12", {"method": "nearest"}, K1_LSB),
    "yuv420p10": ("yuv420p10", {}, K2_LSB),
    "yuv444p": ("yuv444p", {}, K2_LSB),
    "crop_smooth_flip": ("yuv420p", {"crop_box": (16, 8, 64, 48),
                                     "smooth": (3, 3, 0.0, 0.0, "replicate"),
                                     "flip_code": 1}, K2_LSB),
    "crop_flip_i8": ("yuv420p", {"crop_box": (16, 8, 64, 48),
                                 "flip_code": -1, "shift": (0.5,) * 3},
                     K1_LSB),
    "yuv420p10_crop_bt601": ("yuv420p10", {"crop_box": (0, 16, 96, 32)},
                             K2_LSB),
}


@pytest.mark.parametrize("lane", sorted(_LANES))
def test_preprocess_nchw_reference_matches_interpret(rng, lane):
    fmt, kw, bound = _LANES[lane]
    cs = "bt601" if "bt601" in lane else "bt709"
    jfb, fb = _pair(_planes(rng, fmt), fmt, cs=cs)
    want = jfused.preprocess_nchw(jfb, 48, 32, use_pallas="interpret", **kw)
    before = dict(ladder.LAUNCHES)
    got = fused.preprocess_nchw(fb, 48, 32, use_kernel="reference", **kw)
    assert ladder.LAUNCHES == before
    assert _lsb(got.numpy(), want) <= bound


def test_bf16_lane_matches_pallas(rng, monkeypatch):
    """use_kernel="bf16" routes yuv420p to the bf16 kernel wherever the
    kernels run; on CPU tensors that kernel is its plain version."""
    planes = _planes(rng, "yuv420p")
    jfb, fb = _pair(planes, "yuv420p")
    monkeypatch.setattr(fused, "_kernel_eligible", lambda *a, **k: True)
    calls = []
    orig = fused.fused_ladder
    monkeypatch.setattr(fused, "fused_ladder",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = fused.preprocess_nchw(fb, 48, 32, use_kernel="bf16")
    assert calls
    want = jpk.fused_ladder(*(jnp.asarray(planes[k]) for k in "yuv"), 32, 48,
                            interpret=True)
    assert _lsb(got.numpy(), want) <= K2_LSB
    # on CPU tensors, as in JAX on a CPU backend, "bf16" is the
    # separate-op path
    monkeypatch.undo()
    got_cpu = fused.preprocess_nchw(fb, 48, 32, use_kernel="bf16")
    want_cpu = jfused.preprocess_nchw(jfb, 48, 32, use_pallas="bf16")
    assert _lsb(got_cpu.numpy(), want_cpu) <= 1.0 + 1e-3


def test_nv12_wire_planes_take_the_kernel_path(rng):
    """Planes unpacked from NV12 are strided views; the dispatch hands the
    kernels contiguous copies."""
    planes = _planes(rng, "yuv420p")
    jfb, fb = _pair(planes, "yuv420p")
    wire = torch.from_numpy(np.array(jpack_nv12(jfb)))
    nv = unpack_nv12(wire, 64, 128)
    assert not nv.planes["u"].is_contiguous()
    got = fused.preprocess_nchw(nv, 48, 32, use_kernel="reference")
    want = jfused.preprocess_nchw(
        JFrameBatch(jfb.planes, "nv12", 128, 64, "bt709"), 48, 32,
        use_pallas="interpret")
    assert _lsb(got.numpy(), want) <= K1_LSB


def test_auto_on_cpu_takes_separate_ops(rng):
    _, fb = _pair(_planes(rng, "yuv420p"), "yuv420p")
    for k in ladder.LAUNCHES:
        ladder.LAUNCHES[k] = 0
    auto = fused.preprocess_nchw(fb, 48, 32)
    never = fused.preprocess_nchw(fb, 48, 32, use_kernel="never")
    assert set(ladder.LAUNCHES.values()) == {0}
    torch.testing.assert_close(auto, never, rtol=0, atol=0)
    with pytest.raises(ValueError, match="use_kernel"):
        fused.preprocess_nchw(fb, 48, 32, use_kernel="interpret")


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic", "area",
                                    "lanczos3", "spline"])
def test_kernel_eligible_matches_pallas_eligible(method, monkeypatch):
    monkeypatch.setattr(jfused.jax, "default_backend", lambda: "tpu")
    for fmt in sorted(jformats.FORMATS):
        f = jformats.get(fmt)
        planes = {p.name: np.zeros((1,) + f.plane_shape(p.name, 8, 8),
                                   f.planes[0].dtype) for p in f.planes}
        jfb = JFrameBatch(planes, fmt, 8, 8)
        for kw in ({}, {"exact": True}):
            want = jfused._pallas_eligible(jfb, method, kw)
            assert fused._kernel_eligible(fmt, method, kw, "cuda") == want
            assert fused._kernel_eligible(fmt, method, kw, "cpu") is False
            assert fused._kernel_eligible(fmt, method, kw, "cpu",
                                          force=True) == \
                jfused._pallas_eligible(jfb, method, kw, force=True)


@pytest.mark.parametrize("fmt,kw,entry", [
    ("yuv420p", {}, "fused_ladder_i8"),
    ("nv12", {}, "fused_ladder_i8"),
    ("yuv420p10", {}, "fused_ladder_u16"),
    ("yuv444p", {}, "fused_ladder"),
    ("yuv420p", {"use_kernel": "bf16"}, "fused_ladder"),
    ("yuv420p", {"crop_box": (1, 0, 32, 32)}, None),        # odd: not fusable
    ("yuv444p", {"crop_box": (0, 0, 32, 32)}, None),        # non-4:2:0 crop
    ("yuv420p", {"smooth": (3, 3, 0.0, 0.0, "constant")}, None),
    ("yuv420p", {"flip_code": 2}, None),
    ("yuv422p", {}, None),
])
def test_dispatch_tree(rng, monkeypatch, fmt, kw, entry):
    """The JAX dispatch, as the port takes it on a CUDA device."""
    _, fb = _pair(_planes(rng, fmt, n=1), fmt)
    eligible = fused._kernel_eligible
    monkeypatch.setattr(fused, "_kernel_eligible",
                        lambda f, m, k, d, force=False:
                        eligible(f, m, k, "cuda", force))
    seen = []
    for name in ("fused_ladder", "fused_ladder_i8", "fused_ladder_u16"):
        monkeypatch.setattr(fused, name,
                            lambda *a, _n=name, **k: seen.append(_n))

    class Separate(Exception):
        pass

    def separate(*a, **k):
        raise Separate

    monkeypatch.setattr(fused, "preprocess", separate)
    if entry:
        fused.preprocess_nchw(fb, 16, 16, **kw)
        assert seen == [entry]
    else:
        with pytest.raises(Separate):
            fused.preprocess_nchw(fb, 16, 16, **kw)
        assert seen == []


@pytest.mark.parametrize("content", [(1280, 720), (1000, 700), (960, 540)])
def test_bucketed_matches_jax(rng, content):
    cw, ch = content
    bw, bh = fused.bucket_for(cw, ch)
    assert (bw, bh) == jfused.bucket_for(cw, ch)
    planes = _planes(rng, "yuv420p", n=1, h=bh, w=bw)
    jfb, fb = _pair(planes, "yuv420p", w=bw, h=bh)
    want = np.asarray(jfused.preprocess_nchw_bucketed(jfb, cw, ch, 64, 48))
    got = fused.preprocess_nchw_bucketed(fb, cw, ch, 64, 48).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bucket_for_matches_jax():
    for w, h in ((100, 100), (640, 360), (641, 360), (3840, 2160),
                 (4000, 3000), (7680, 4320)):
        assert fused.bucket_for(w, h) == jfused.bucket_for(w, h)
