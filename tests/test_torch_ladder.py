"""The ladder kernels' plain PyTorch versions against the Pallas kernels
(interpret mode), on the same inputs, and the wrappers' validation.

Bounds (u8 LSBs): the int8 row stage is exact, so K1's plain version and
the Pallas kernel round the same f32 values to bf16: 0.01.  K2's f32 row
sum can run in another order and round to the neighbouring bf16 value:
1 (measured 3.05e-5 on these inputs: no such flip occurred)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu_torch.ops import ladder

K1_LSB, K2_LSB = 0.01, 1.0


def _data(rng, n=2, h=64, w=128, chroma=None, hi=256, dtype=np.uint8):
    ch, cw = chroma or (h // 2, w // 2)
    return (rng.integers(0, hi, (n, h, w)).astype(dtype),
            rng.integers(0, hi, (n, ch, cw)).astype(dtype),
            rng.integers(0, hi, (n, ch, cw)).astype(dtype))


def _jax(fn, planes, *a, **k):
    return np.asarray(fn(*(jnp.asarray(p) for p in planes), *a,
                         interpret=True, **k))


def _port(fn, planes, *a, **k):
    before = dict(ladder.LAUNCHES)
    out = fn(*(torch.from_numpy(p) for p in planes), *a, **k).numpy()
    assert ladder.LAUNCHES == before      # CPU tensors: plain version
    return out


def _lsb(a, b, scale=255.0):
    assert a.shape == b.shape and a.dtype == np.float32
    return float(np.abs(a - b).max()) * scale


_K1_CASES = {
    "bilinear": ((32, 32), {}),
    "nearest": ((32, 32), {"method": "nearest"}),
    "crop": ((24, 32), {"crop_box": (16, 8, 64, 48)}),
    "smooth": ((32, 32), {"smooth": (3, 3, 0.0, 0.0, "replicate")}),
    "flip": ((32, 32), {"flip": -1}),
    "bt601_shift": ((32, 32), {"colorspace": "bt601",
                               "shift": (127.5, 127.5, 127.5)}),
    "bicubic": ((32, 48), {"method": "bicubic"}),
}


@pytest.mark.parametrize("case", sorted(_K1_CASES))
def test_k1_plain_matches_pallas(rng, case):
    (oh, ow), kw = _K1_CASES[case]
    planes = _data(rng)
    want = _jax(jpk.fused_ladder_i8, planes, oh, ow, **kw)
    got = _port(ladder.fused_ladder_i8, planes, oh, ow, **kw)
    assert _lsb(got, want) <= K1_LSB


def test_k1_plain_called_directly(rng):
    """_ladder_i8_plain on the builder's operands == the Pallas kernel."""
    planes = _data(rng)
    geom = (64, 128, 32, 64, 32, 32, "bilinear", None, None, None)
    ops = ladder._plain_operands("i8", geom, "cpu")
    c = ladder._epilogue("bt709", 8, 255.0, (0.0, 0.0, 0.0))
    got = ladder._ladder_i8_plain(*(torch.from_numpy(p) for p in planes),
                                  ops, c).numpy()
    assert _lsb(got, _jax(jpk.fused_ladder_i8, planes, 32, 32)) <= K1_LSB


_K2_CASES = {
    "u8": (dict(), {}),
    "u8_crop_flip": (dict(), {"crop_box": (16, 8, 64, 48), "flip": 1}),
    "u8_smooth": (dict(), {"smooth": (5, 3, 1.1, 0.0, "reflect101")}),
    "yuv444p": (dict(chroma=(64, 128)), {}),
    "u16_10bit": (dict(hi=1024, dtype=np.uint16), {"bits": 10}),
    "u16_10bit_smooth_flip": (dict(hi=1024, dtype=np.uint16),
                              {"bits": 10, "flip": 0,
                               "smooth": (5, 5, 0.0, 0.0, "replicate")}),
    "u16_12bit": (dict(hi=4096, dtype=np.uint16), {"bits": 12}),
}


@pytest.mark.parametrize("case", sorted(_K2_CASES))
def test_k2_plain_matches_pallas(rng, case):
    data_kw, kw = _K2_CASES[case]
    planes = _data(rng, **data_kw)
    if "bits" in kw:
        jfn, fn = jpk.fused_ladder_u16, ladder.fused_ladder_u16
    else:
        jfn, fn = jpk.fused_ladder, ladder.fused_ladder
    oh, ow = (24, 32) if "crop_box" in kw else (32, 32)
    want = _jax(jfn, planes, oh, ow, **kw)
    got = _port(fn, planes, oh, ow, **kw)
    assert _lsb(got, want) <= K2_LSB


def test_k2_plain_called_directly(rng):
    planes = _data(rng, hi=1024, dtype=np.uint16)
    geom = (64, 128, 32, 64, 32, 32, "bilinear", None, None, None)
    ops = ladder._plain_operands("bf16", geom, "cpu")
    c = ladder._epilogue("bt709", 10, 1023.0, (0.0, 0.0, 0.0))
    got = ladder._ladder_bf16_plain(*(torch.from_numpy(p) for p in planes),
                                    ops, c).numpy()
    want = _jax(jpk.fused_ladder_u16, planes, 32, 32, bits=10)
    assert _lsb(got, want) <= K2_LSB


@pytest.mark.parametrize("fusions", [(None, None, None),
                                     ((32, 8, 192, 48),
                                      (3, 3, 0.0, 0.0, "replicate"), -1)],
                         ids=["plain", "crop_smooth_flip"])
def test_k3_wide_frame_matches_chunked_pallas(rng, fusions):
    """The port sends wide frames to the same kernel as K1; hold it
    against the TPU's column-chunked kernel (2 chunks)."""
    n, h, w = 2, 64, 512
    planes = _data(rng, n=n, h=h, w=w)
    crop, sm, flip = fusions
    oh, ow = (24, 32) if crop else (32, 32)
    fn = jpk._build_ladder_i8_chunked(
        n, h, w, h // 2, w // 2, oh, ow, "bt709", "bilinear", 255.0,
        (0.0, 0.0, 0.0), True, 2, crop, sm, flip)
    want = np.asarray(fn(*(jnp.asarray(p) for p in planes)))
    if crop is None:
        got = _port(ladder.fused_ladder_i8, planes, oh, ow)
    else:
        # the Pallas builder skips the entry's i8 gate (which sends this
        # smooth to the bf16 kernel): run the int8 kernel's plain version
        geom = (h, w, h // 2, w // 2, oh, ow, "bilinear", crop, sm, flip)
        got = ladder._run("i8", *(torch.from_numpy(p) for p in planes),
                          geom, ladder._epilogue("bt709", 8, 255.0,
                                                 (0.0, 0.0, 0.0)),
                          False).numpy()
    # the same bound as the TPU's chunked-vs-whole test (test_pallas.py:152)
    assert _lsb(got, want) <= 1.0


def test_i8_gate_sends_wide_taps_to_bf16(rng, monkeypatch):
    """Where int8 cannot hold the taps, fused_ladder_i8 hands the call
    (fusions included) to the bf16 kernel, as the JAX entry does."""
    planes = _data(rng, n=1, h=96, w=160)
    calls = []
    orig = ladder.fused_ladder
    monkeypatch.setattr(ladder, "fused_ladder",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    got = _port(ladder.fused_ladder_i8, planes, 32, 48, method="lanczos3",
                flip=1)
    assert calls and calls[0]["flip"] == 1
    want = _jax(jpk.fused_ladder_i8, planes, 32, 48, method="lanczos3",
                flip=1)
    assert _lsb(got, want) <= K2_LSB


@pytest.mark.parametrize("kw,match", [
    ({"crop_box": (1, 0, 64, 48)}, "even"),
    ({"crop_box": (0, 0, 63, 48)}, "even"),
    ({"crop_box": (-2, 0, 64, 48)}, "non-negative"),
    ({"crop_box": (96, 0, 64, 48)}, "outside"),
    ({"crop_box": (0, 0, 0, 48)}, "positive"),
    ({"smooth": (3, 3, 0.0, 0.0, "constant")}, "constant"),
    ({"smooth": (4, 3, 0.0, 0.0, "replicate")}, "odd"),
    ({"flip": 2}, "flip"),
    ({"method": "cubic"}, "method"),
])
@pytest.mark.parametrize("fn", ["fused_ladder_i8", "fused_ladder",
                                "fused_ladder_u16"])
def test_validators_raise(rng, fn, kw, match):
    if fn != "fused_ladder_i8" and "method" in kw:
        match = "resize method"
    planes = _data(rng, n=1, dtype=np.uint16 if fn.endswith("u16")
                   else np.uint8)
    with pytest.raises(ValueError, match=match):
        getattr(ladder, fn)(*(torch.from_numpy(p) for p in planes), 32, 32,
                            **kw)
    # the JAX entry points refuse the same input
    with pytest.raises(ValueError):
        getattr(jpk, fn)(*(jnp.asarray(p) for p in planes), 32, 32,
                         interpret=True, **kw)


def _band_eval(kind, planes, geom, c):
    """numpy walk of the CUDA kernel's loops over the band operands (one
    output pixel at a time), to check the band form and its indexing."""
    ops = ladder._kernel_operands(kind, geom, "cpu")
    oh, ow = geom[4], geom[5]

    def bf16(x):
        return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))

    def px(x, row, col, i, j, inv_s):
        (rlo, rn, rw), (clo, cn, cw) = row, col
        acc = np.float32(0)
        for b in range(int(cn[j])):
            w = int(clo[j]) + b
            hs = range(int(rlo[i]), int(rlo[i]) + int(rn[i]))
            if kind == "i8":
                t = sum(int(rw[i, a]) * (int(x[h, w]) - 128)
                        for a, h in enumerate(hs))
                tb = bf16(np.float32(t) * np.float32(inv_s))
            else:
                t = np.float32(0)
                for a, h in enumerate(hs):
                    t = np.float32(t + np.float32(rw[i, a])
                                   * np.float32(bf16(float(x[h, w]))))
                tb = bf16(t)
            acc = np.float32(acc + np.float32(tb) * np.float32(cw[j, b]))
        return acc

    band = {k: tuple(t.float().numpy() if t.dtype == torch.bfloat16
                     else t.numpy() for t in ops[k])
            for k in ("row_y", "col_y", "row_c", "col_c")}
    out = np.zeros((planes[0].shape[0], 3, oh, ow), np.float32)
    m = c["mat"]
    for f in range(out.shape[0]):
        for i in range(oh):
            for j in range(ow):
                o = [px(planes[0][f], band["row_y"], band["col_y"], i, j,
                        ops.get("inv_sy", 1.0)),
                     px(planes[1][f], band["row_c"], band["col_c"], i, j,
                        ops.get("inv_sc", 1.0)),
                     px(planes[2][f], band["row_c"], band["col_c"], i, j,
                        ops.get("inv_sc", 1.0))]
                if kind == "i8":
                    o = [o[0] + ops["off_y"][i].item(),
                         o[1] + ops["off_c"][i].item(),
                         o[2] + ops["off_c"][i].item()]
                yy, uu, vv = (np.float32(o[0] - c["low"]),
                              np.float32(o[1] - c["mid"]),
                              np.float32(o[2] - c["mid"]))
                for k in range(3):
                    s = np.float32(np.float32(m[k, 0] * yy + m[k, 1] * uu)
                                   + m[k, 2] * vv)
                    s = min(max(s, 0.0), c["maxv"])
                    out[f, k, i, j] = np.float32(
                        (s - c["shift"][k])) * np.float32(c["inv_norm"])
    return out


@pytest.mark.parametrize("kind,geom,bits", [
    ("i8", (24, 40, 12, 20, 7, 9, "bilinear", (4, 2, 32, 20),
            (3, 3, 0.0, 0.0, "reflect"), -1), 8),
    ("bf16", (24, 40, 12, 20, 9, 7, "lanczos3", None, None, 1), 10),
], ids=["i8", "bf16"])
def test_band_walk_matches_plain(rng, kind, geom, bits):
    """The kernels' band-form walk (lo/len windows, packed weights,
    recomputed row stage) gives the plain versions' numbers."""
    dtype = np.uint8 if bits == 8 else np.uint16
    planes = _data(rng, n=1, h=geom[0], w=geom[1], chroma=geom[2:4],
                   hi=1 << bits, dtype=dtype)
    c = ladder._epilogue("bt601", bits, float((1 << bits) - 1),
                         (0.5, 0.0, 2.0))
    want = ladder._PLAIN[kind](*(torch.from_numpy(p) for p in planes),
                               ladder._plain_operands(kind, geom, "cpu"),
                               c).numpy()
    got = _band_eval(kind, planes, geom, c)
    assert _lsb(got, want, (1 << bits) - 1) <= 1e-3
