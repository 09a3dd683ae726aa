"""The port's in-graph inference models (models/sr, denoise, pose,
classify) against the JAX package's on the same seeded inputs, on the
CPU.

Parity goes through the JAX params handed over as numpy
(`models.from_jax_params`) or the bundled checkpoints: the port's own
random init draws from a `torch.Generator`, which cannot reproduce
`jax.random`.

Bounds: fp32 within rtol 1e-5 / atol 1e-6 of the JAX model (the f32 sums
run in another order).  bf16 within one bf16 step of the JAX bf16 lane
(rtol 2^-7, atol 2^-8: the step of a value in [0.5, 1), the largest a
residual or an image sample rounds at; the f32 sums of the two packages
may round one bf16 layer output apart), and against the port's own fp32
output within the JAX
package's bf16-vs-fp32 bound: <= 8 u8-LSB max and <= 1.0 mean
(tests/test_filters.py:135-144)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmat_tpu.filters import infer as jinfer
from gmat_tpu.models import classify as jclassify, denoise as jdenoise
from gmat_tpu.models import pose as jpose, sr as jsr
from gmat_tpu_torch import models
from gmat_tpu_torch.filters import infer
from gmat_tpu_torch.models import classify, denoise, pose, sr

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -8
BF16_MAX_LSB, BF16_MEAN_LSB = 8.0, 1.0

# name: (JAX module, port module, init kwargs, input shape)
_MODELS = {
    "sr2x": (jsr, sr, {}, (2, 3, 17, 20)),
    "sr3x_h32": (jsr, sr, {"scale": 3, "hidden": 32}, (2, 3, 12, 15)),
    "sr2x_luma": (jsr, sr, {"channels": 1}, (2, 1, 16, 18)),
    "denoise": (jdenoise, denoise, {"channels": 3}, (2, 3, 16, 19)),
    "denoise_luma": (jdenoise, denoise, {}, (2, 1, 21, 16)),
    "pose": (jpose, pose, {}, (2, 3, 30, 31)),
    "classify": (jclassify, classify, {"num_classes": 40}, (2, 3, 32, 33)),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed=3):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture(scope="module", params=sorted(_MODELS))
def model(request):
    jm, m, kw, shape = _MODELS[request.param]
    jp = jm.init_params(jax.random.PRNGKey(1), **kw)
    return jm, m, jp, models.from_jax_params(_np_tree(jp), "cpu"), _x(shape)


def test_apply_fp32_matches_jax(model):
    jm, m, jp, p, x = model
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = m.apply(p, torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_apply_bf16_matches_jax(model):
    """The bf16 lane: params and input cast at the boundary, as
    InferFilter does in both packages."""
    jm, m, jp, p, x = model
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    want = np.asarray(jax.jit(jm.apply)(jb, jnp.asarray(x).astype(
        jnp.bfloat16)).astype(jnp.float32))
    got = m.apply(models.cast(p, torch.bfloat16),
                  torch.as_tensor(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
    if m in (sr, denoise):          # images in [0, 1]: the u8 bound
        f32 = m.apply(p, torch.as_tensor(x)).numpy()
        d = np.abs(got - f32) * 255.0
        assert d.max() <= BF16_MAX_LSB and d.mean() <= BF16_MEAN_LSB, \
            (d.max(), d.mean())


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax(r):
    x = _x((2, 3 * r * r, 5, 7))
    want = np.asarray(jsr.pixel_shuffle(jnp.asarray(x), r))
    np.testing.assert_array_equal(sr.pixel_shuffle(torch.as_tensor(x),
                                                   r).numpy(), want)


@pytest.mark.parametrize("scale,channels", [(2, 3), (3, 3), (4, 1)])
def test_scale_of_matches_jax(scale, channels):
    jp = jsr.init_params(jax.random.PRNGKey(0), scale=scale,
                         channels=channels, hidden=8)
    p = sr.init_params(scale=scale, channels=channels, hidden=8,
                       device="cpu")
    assert sr.scale_of(p, channels) == jsr.scale_of(jp, channels) == scale


def test_loss_fn_matches_jax():
    jp = jsr.init_params(jax.random.PRNGKey(2), hidden=16)
    p = models.from_jax_params(_np_tree(jp), "cpu")
    x_lr, y_hr = _x((2, 3, 9, 11), 4), _x((2, 3, 18, 22), 5)
    want = float(jsr.loss_fn(jp, jnp.asarray(x_lr), jnp.asarray(y_hr)))
    got = sr.loss_fn(p, torch.as_tensor(x_lr), torch.as_tensor(y_hr))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


# bundled checkpoints: (file, JAX init, port init, channels)
_BUNDLED = {
    "espcn_x2": (lambda: jsr.init_params(jax.random.PRNGKey(0)),
                 lambda: sr.init_params(device="cpu"), sr, jsr),
    "espcn_x2_h128": (
        lambda: jsr.init_params(jax.random.PRNGKey(0), hidden=128),
        lambda: sr.init_params(hidden=128, device="cpu"), sr, jsr),
    "espcn_x3": (lambda: jsr.init_params(jax.random.PRNGKey(0), scale=3),
                 lambda: sr.init_params(scale=3, device="cpu"), sr, jsr),
    "dncnn": (lambda: jdenoise.init_params(jax.random.PRNGKey(0),
                                           channels=3),
              lambda: denoise.init_params(channels=3, device="cpu"),
              denoise, jdenoise),
}


@pytest.mark.parametrize("name", sorted(_BUNDLED))
def test_bundled_checkpoint_matches_jax(name):
    """Every shipped checkpoint, read where the JAX package keeps it, on a
    2 x 32x32 input: fp32 within rtol 1e-5."""
    jinit, init, m, jm = _BUNDLED[name]
    path = f"{infer.WEIGHTS_DIR}/{name}.npz"
    jp = jinfer._load_weights(jinit(), path)
    p = infer._load_weights(init(), path)
    x = _x((2, 3, 32, 32), 6)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = m.apply(p, torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# (JAX init, port init kwargs, port module)
_INITS = {
    "sr": (lambda k: jsr.init_params(k, scale=3, hidden=32),
           {"scale": 3, "hidden": 32}, sr),
    "denoise": (lambda k: jdenoise.init_params(k, channels=3, depth=6),
                {"channels": 3, "depth": 6}, denoise),
    "pose": (lambda k: jpose.init_params(k), {}, pose),
    "classify": (lambda k: jclassify.init_params(k, num_classes=300),
                 {"num_classes": 300}, classify),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", sorted(_INITS))
def test_init_shapes_scales_and_draws(name):
    """The port's own init: the JAX shapes, dtypes and He scales; zero
    biases; the same generator seed gives the same draws, a different
    seed others; the default generator is seed 0."""
    jinit, kw, m = _INITS[name]
    want = dict(_leaves(_np_tree(jinit(jax.random.PRNGKey(0)))))
    got = dict(_leaves(m.init_params(models.generator(0), device="cpu",
                                     **kw)))
    assert sorted(got) == sorted(want)
    for key, w in got.items():
        assert tuple(w.shape) == want[key].shape and w.dtype == torch.float32
        if w.dim() == 1:
            assert not w.any(), key
            continue
        fan_in = w.shape[0] if w.dim() == 2 else int(np.prod(w.shape[1:]))
        gain = 1.0 if w.dim() == 2 else 2.0
        std = float(w.std())
        assert abs(std / np.sqrt(gain / fan_in) - 1.0) < 0.1, (key, std)
    again = dict(_leaves(m.init_params(models.generator(0), device="cpu",
                                       **kw)))
    default = dict(_leaves(m.init_params(device="cpu", **kw)))
    other = dict(_leaves(m.init_params(models.generator(1), device="cpu",
                                       **kw)))
    for key, w in got.items():
        assert torch.equal(w, again[key]) and torch.equal(w, default[key])
        if w.dim() > 1:
            assert not torch.equal(w, other[key])


def test_init_bf16_and_devices():
    p = sr.init_params(dtype=torch.bfloat16, device="cpu", hidden=8)
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            sr.init_params(hidden=8)     # the card is the default


def test_same_pads_match_xla():
    """models.same_pads is XLA's "SAME": stride-2 convs of even planes
    pad only after (224 -> 112), odd planes on both sides."""
    assert models.same_pads(224, 3, 2) == (0, 1)
    assert models.same_pads(15, 3, 2) == (1, 1)
    assert models.same_pads(16, 3, 1) == (1, 1)
    for n in range(1, 40):
        x = jnp.zeros((1, 1, n, 1))
        w = jnp.zeros((1, 1, 3, 1))
        out = jax.lax.conv_general_dilated(
            x, w, (2, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"))
        lo, hi = models.same_pads(n, 3, 2)
        assert (n + lo + hi - 3) // 2 + 1 == out.shape[2]
