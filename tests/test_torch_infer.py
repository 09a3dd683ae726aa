"""The port's in-graph inference filter (filters/infer, the `infer` and
`tensorrt` names) against the JAX package's, on the CPU: the checkpoint
loader and its errors, the 3-channel RGBPF32 and luma-only IO modes, the
vector models' `last_output`, `hidden=`, `precision=` and user
`module:function` models, through FilterGraph.

The random-init models (luma sr, luma denoise, pose, classify, sr at
another width) take checkpoints written from the JAX package's init, so
both packages run the same weights.  `run_pair` runs the JAX graph op by
op and holds the port to it: fp32 0 LSB for u8 planes, rtol 1e-5 / atol
1e-6 for float RGB and `last_output`; the bf16 lane (the default) rounds
every layer's f32 sums to bf16, and the two packages' sums may round a
value one bf16 step apart: 1 LSB, rtol 2^-7 / atol 2^-8 (the step at
[0.5, 1)).  Against the jitted JAX graph (XLA fuses the bf16 lane's
casts and the conversions' multiply-adds) the same 1 LSB and bf16
step."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.filters import graph as jgraph, infer as jinfer
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.filters import graph, infer
from tests.test_torch_color import run_pair, yuv_frames

H, W = 24, 32
JIT_ATOL = 2.0 ** -8


def halve(x):
    """A user model for `infer=module:function` (jnp or torch)."""
    return x * 0.5


def _flat(params):
    """A param tree as the npz keys the loaders read."""
    out = {}
    for k, v in params.items():
        if isinstance(v, list):
            for i, layer in enumerate(v):
                for n, a in layer.items():
                    out[f"{k}.{i}.{n}"] = a.numpy()
        else:
            out[k] = v.numpy()
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Checkpoints of seeded random weights (the port's init, generator
    seed 5, with seeded biases), loaded by both packages."""
    from gmat_tpu_torch import models
    from gmat_tpu_torch.models import classify, denoise, pose, sr
    d = tmp_path_factory.mktemp("ckpt")
    gen = models.generator(5)
    made = {"sr_luma": sr.init_params(gen, channels=1, device="cpu"),
            "sr_h32": sr.init_params(gen, hidden=32, device="cpu"),
            "dn_luma": denoise.init_params(gen, channels=1, device="cpu"),
            "pose": pose.init_params(gen, device="cpu"),
            "classify": classify.init_params(gen, device="cpu")}
    out = {}
    for name, params in made.items():
        flat = _flat(params)
        for k, v in flat.items():
            if v.ndim == 1:
                flat[k] = (0.05 * torch.randn(v.shape, generator=gen)).numpy()
        out[name] = str(d / f"{name}.npz")
        np.savez(out[name], **flat)
    return out


@pytest.fixture(scope="module")
def frames():
    return yuv_frames(np.random.default_rng(11), 4, H, W)


def _two(frames):
    return [{k: v[:2] for k, v in frames.items()},
            {k: v[2:] for k, v in frames.items()}]


# spec with {ckpt} names: the bf16 lane (the default precision) rounds
# every layer's f32 sums to bf16, and the two packages' sums may round one
# value a bf16 step apart: float RGB within rtol 2^-7 / atol 2^-8 (the
# step at [0.5, 1)), u8 planes within 1 LSB; fp32 within 1e-5 / 0 LSB
_SPECS = {
    "rgb_tensorrt_sr2x": "format=rgbpf32le:255,tensorrt=sr2x",
    "rgb_sr2x_fp32": "format=rgbpf32le,infer=sr2x:precision=fp32",
    "rgb_sr3x": "format=rgbpf32le,infer=sr3x",
    "rgb_denoise": "format=rgbpf32le,infer=denoise",
    "yuv_denoise_fp32": "infer=denoise:precision=fp32",
    "luma_sr2x": "infer=sr2x:luma_only=1:weights={sr_luma}",
    "luma_sr2x_fp32": "infer=sr2x:luma_only=1:precision=fp32:"
                      "weights={sr_luma}",
    "luma_denoise": "infer=denoise:luma_only=1:weights={dn_luma}",
    "luma_denoise_fp32": "infer=denoise:luma_only=1:precision=fp32:"
                         "weights={dn_luma}",
    "hidden_128": "format=rgbpf32le,infer=sr2x:hidden=128",
    "hidden_32_fp32": "format=rgbpf32le,infer=sr2x:hidden=32:"
                      "precision=fp32:weights={sr_h32}",
    "denoise_then_yuv": "infer=denoise,format=yuv420p",
    "denoise_then_yuv_fp32": "infer=denoise:precision=fp32,format=yuv420p",
}
BF16 = dict(lsb=1, rtol=2.0 ** -7, atol=2.0 ** -8)
FP32 = dict(lsb=0, rtol=1e-5, atol=1e-6)


def _bound(spec):
    return FP32 if "fp32" in spec else BF16


@pytest.mark.parametrize("case", sorted(_SPECS))
def test_infer_graph_matches_jax(case, ckpt, frames):
    spec = _SPECS[case].format(**ckpt)
    run_pair(spec, _two(frames), **_bound(spec))


@pytest.mark.parametrize("case", ["rgb_tensorrt_sr2x", "luma_sr2x",
                                  "denoise_then_yuv", "hidden_32_fp32"])
def test_infer_graph_matches_jitted_jax(case, ckpt, frames):
    spec = _SPECS[case].format(**ckpt)
    run_pair(spec, _two(frames), lsb=1, eager=False, rtol=2.0 ** -7,
             atol=JIT_ATOL)


def _vector_pair(spec, frames):
    """Both graphs (the JAX one op by op) over two batches: frames pass
    through unchanged, and each batch's last_output agrees."""
    with mock.patch.object(jgraph.FilterGraph, "_jit_pure",
                           lambda self, idx, fn: fn):
        jg, g = jgraph.FilterGraph(spec), graph.FilterGraph(spec)
        for planes in _two(frames):
            jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()},
                              "yuv420p", W, H)
            fb = FrameBatch.from_numpy(planes, "yuv420p", W, H,
                                       device="cpu")
            want, _ = jg.process(jfb)
            got, _ = g.process(fb)
            assert got.format == want.format
            for k, p in want.planes.items():
                np.testing.assert_allclose(got.planes[k].numpy(),
                                           np.asarray(p), rtol=1e-6,
                                           atol=1e-6)
            yield g.filters[-1].last_output, jg.filters[-1].last_output


@pytest.mark.parametrize("spec,n_out", [
    ("scale=224:224,format=rgbpf32le,infer=classify:weights={classify}",
     1000),
    ("format=rgbpf32le,infer=classify:precision=fp32:weights={classify}",
     1000),
    ("infer=pose:weights={pose}", 62),
    ("format=rgbpf32le,infer=pose:precision=fp32:weights={pose}", 62),
], ids=["classify", "classify_fp32", "pose_passthrough", "pose_fp32"])
def test_vector_models_last_output_matches_jax(spec, n_out, ckpt, frames):
    """Vector models pass frames through and leave a host numpy array in
    last_output, per batch: fp32 within rtol 1e-5 / atol 1e-6, bf16 within
    a bf16 step (rtol 2^-7, atol 2^-8)."""
    b = _bound(spec)
    for got, want in _vector_pair(spec.format(**ckpt), frames):
        assert isinstance(got, np.ndarray) and got.shape == (2, n_out)
        np.testing.assert_allclose(got, np.asarray(want), rtol=b["rtol"],
                                   atol=b["atol"])


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_module_function_model_matches_jax(precision, frames):
    """A user model `module:function` (the API form: the graph parser
    splits options at ':') runs on the batch's tensors in both packages."""
    planes = {k: v[:2] for k, v in frames.items()}
    model = "tests.test_torch_infer:halve"
    jf = jinfer.InferFilter(model, precision=precision)
    f = infer.InferFilter(model, precision=precision)
    assert f.params is None and f.kind == "image" and f.scale == 1
    want = jf(JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()},
                          "yuv420p", W, H))
    got = f(FrameBatch.from_numpy(planes, "yuv420p", W, H, device="cpu"))
    assert got.format == want.format == "rgbpf32"
    np.testing.assert_allclose(got.planes["rgb"].numpy(),
                               np.asarray(want.planes["rgb"]), rtol=1e-6,
                               atol=1e-6)


def test_bundled_weights_paths_match_jax():
    for model in ("sr2x", "sr3x", "denoise", "pose", "classify"):
        for channels in (1, 3):
            for hidden in (0, 32, 64, 128):
                assert infer._bundled_weights(model, channels, hidden) == \
                    jinfer._bundled_weights(model, channels, hidden)
    assert infer._bundled_weights("sr2x", 3, 0).endswith(
        "gmat_tpu/models/weights/espcn_x2.npz")


def _errors(build, jbuild):
    with pytest.raises(ValueError) as want:
        jbuild()
    with pytest.raises(ValueError) as got:
        build()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_loader_errors_match_jax(tmp_path, ckpt):
    """Shape mismatch, missing layers, unused keys, unknown model, bad
    precision, hidden= off the sr models: the JAX messages."""
    x2 = infer._bundled_weights("sr2x", 3, 0)
    msg = _errors(lambda: infer.InferFilter("sr2x", x2, hidden=128),
                  lambda: jinfer.InferFilter("sr2x", x2, hidden=128))
    assert "different hidden width" in msg
    z = dict(np.load(infer._bundled_weights("denoise", 3, 0)))
    short = str(tmp_path / "short.npz")
    np.savez(short, **{k: v for k, v in z.items()
                       if not k.startswith("layers.4.")})
    msg = _errors(lambda: infer.InferFilter("denoise", short),
                  lambda: jinfer.InferFilter("denoise", short))
    assert "different depth" in msg
    extra = str(tmp_path / "extra.npz")
    np.savez(extra, **dict(np.load(x2)), stray=np.zeros(3, np.float32))
    msg = _errors(lambda: infer.InferFilter("sr2x", extra),
                  lambda: jinfer.InferFilter("sr2x", extra))
    assert "stray" in msg
    for kw in ({"model": "frobnicate"}, {"precision": "fp16"},
               {"model": "denoise", "hidden": 64}):
        _errors(lambda: infer.InferFilter(**kw),
                lambda: jinfer.InferFilter(**kw))


def test_random_skips_the_bundled_checkpoint():
    """weights=random keeps the port's own init (the torch generator, seed
    0); the default loads the shipped espcn_x2."""
    from gmat_tpu_torch.models import sr
    rand = infer.InferFilter("sr2x", "random")
    init = sr.init_params(device="cpu")
    assert all(torch.equal(rand.params[k], init[k]) for k in init)
    shipped = infer.InferFilter("sr2x")
    z = np.load(infer._bundled_weights("sr2x", 3, 0))
    assert all(np.array_equal(shipped.params[k].numpy(), z[k]) for k in z)


def test_params_move_once_per_device_and_precision():
    f = infer.InferFilter("sr2x", precision="bf16")
    p = f.params_on(torch.device("cpu"))
    assert p is f.params_on("cpu")
    assert p["w1"].dtype == torch.bfloat16
    assert f.params["w1"].dtype == torch.float32
    x = torch.rand(1, 3, 8, 8)
    assert f._run(x).dtype == torch.float32


def test_luma_only_refuses_rgb_and_10_bit(frames):
    f = infer.InferFilter("sr2x", "random", luma_only=True)
    rgb = FrameBatch.from_numpy({"rgb": np.zeros((1, 8, 8, 3), np.uint8)},
                                "rgb24", 8, 8, device="cpu")
    with pytest.raises(ValueError, match="YUV"):
        f(rgb)
    p10 = {k: v[:1].astype(np.uint16) for k, v in frames.items()}
    fb10 = FrameBatch.from_numpy(p10, "yuv420p10", W, H, device="cpu")
    with pytest.raises(ValueError, match="8-bit"):
        f(fb10)
