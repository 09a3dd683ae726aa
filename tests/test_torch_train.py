"""The port's trainers (`gmat_tpu_torch/tools/train_sr.py`,
`train_denoise.py`) and its bundled checkpoints against the JAX tools'
and checkpoints, on the CPU at small sizes (ESPCN hidden 16, DnCNN
hidden 8, patches of 12-24 pixels):

  * the dataset generator and `area_down` bit-equal to `tools/train_sr.py`
    (loaded by path, as tests/test_sr_pretrained.py loads it);
  * `cosine_decay` equal to `optax.cosine_decay_schedule` (rtol 1e-7);
  * one step's loss and gradients equal to `jax.value_and_grad` of the
    JAX losses on the same batch (rtol 1e-5, gradients with an absolute
    floor of 1e-5 of their largest magnitude), and 50 Adam steps from
    equal parameters within rtol 1e-5 on every loss and 2e-5 absolute
    on the parameters;
  * the held-out evaluations equal the JAX tools' for equal parameters;
  * both `main`s: the save branch (the JAX keys and shapes, loadable by
    both packages' InferFilter) and the refuse branch (the JAX tools'
    SystemExit);
  * the backward pass of every train step runs with TF32 off, with the
    global flag at PyTorch's default (the trainers' `train_step` and the
    distributed self-test's step);
  * the counterpart of tests/test_sr_pretrained.py for the port's own
    bundled checkpoints, which are byte copies of the JAX package's.

The JAX trainers draw their init and noise from `jax.random`, which
torch cannot reproduce: parity goes through `models.from_jax_params` and
fixed noisy batches, and the `main` runs start from a bundled checkpoint
where they must pass a gate.
"""
import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gmat_tpu.core.frame import FrameBatch as JFrameBatch
from gmat_tpu.filters import infer as jinfer
from gmat_tpu.models import denoise as jdenoise, sr as jsr
from gmat_tpu.ops.resize import resize_plane as jresize_plane
from gmat_tpu_torch import models
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.filters import infer
from gmat_tpu_torch.models import denoise, sr
from gmat_tpu_torch.ops.resize import resize_plane
from gmat_tpu_torch.parallel import distributed
from gmat_tpu_torch.tools import train_denoise, train_sr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_WEIGHTS = os.path.join(REPO, "gmat_tpu", "models", "weights")
RTOL = 1e-5            # one step, and every loss of 50 Adam steps
PARAM_ATOL = 2e-5      # the parameters after 50 Adam steps
SCHED_RTOL = 1e-7
PSNR_ATOL = 1e-3       # dB, held-out evaluations on equal parameters
FILTER_ATOL = 1e-5     # a written checkpoint through both InferFilters
HR, PATCHES, BATCH, STEPS = 24, 64, 8, 50
# The 50-step trajectory is held from an init whose pre-activations stay
# off ReLU's kink: where one lands within an ulp of 0, the two packages'
# sums put the pixel on opposite sides and that step's gradient differs
# in a few elements by percents (PRNGKey(0) at step 18 of this data: one
# w1 element 0.000471 against 0.000510, the parameters 3.5e-5 apart after
# 50 steps).  Away from the kink every step agrees within 1e-6.
ADAM_SR_KEY = 1


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtrain_sr = _tool("train_sr")
jtrain_denoise = _tool("train_denoise")


def _tensors(tree):
    """A JAX param tree (numpy) as port tensors that take gradients."""
    out = models.from_jax_params(jax.tree.map(np.asarray, tree), "cpu")
    for t in _leaves(out):
        t.requires_grad_(True)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _jax_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _jax_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _jax_leaves(v)]
    return [np.asarray(tree)]


def _jax_dncnn_loss(p, noisy, target):
    """The JAX trainer's loss (defined inside its main)."""
    return jnp.mean((jdenoise.apply(p, noisy) - target) ** 2)


def _noisy(clean, seed):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(5 / 255, 30 / 255, (clean.shape[0], 1, 1, 1))
    return np.clip(clean + rng.normal(0, 1, clean.shape) * sigma,
                   0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    hrs = train_sr.make_dataset(PATCHES, HR, 0)
    return hrs, train_sr.area_down(hrs, 2)


# ------------------------------------------------------------- dataset

@pytest.mark.parametrize("n,hr,seed", [(16, 24, 0), (8, 96, 123456),
                                       (3, 64, 777)])
def test_make_dataset_bit_equal(n, hr, seed):
    got = train_sr.make_dataset(n, hr, seed)
    want = jtrain_sr.make_dataset(n, hr, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 3])
def test_area_down_bit_equal(k):
    x = train_sr.make_dataset(4, 48, 5)
    got, want = train_sr.area_down(x, k), jtrain_sr.area_down(x, k)
    assert got.dtype == want.dtype and got.shape == (4, 3, 48 // k, 48 // k)
    np.testing.assert_array_equal(got, want)


def test_luma_set_bit_equal():
    x = train_sr.make_dataset(4, 16, 3)
    want = (0.299 * x[:, :1] + 0.587 * x[:, 1:2]
            + 0.114 * x[:, 2:3]).astype(np.float32)   # the JAX tool's
    np.testing.assert_array_equal(train_denoise.luma(x), want)


def test_index_stream_is_the_jax_trainers():
    """rng(seed + 1), one (100, batch) draw per chunk, whole chunks."""
    rng = np.random.default_rng(8)
    got = list(train_sr.index_chunks(7, 300, 5, 250))
    assert [i for i, _ in got] == [0, 100, 200]
    for _, idxs in got:
        np.testing.assert_array_equal(idxs, rng.integers(0, 300, (100, 5)))


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("steps", [1, 50, 300])
def test_cosine_decay_matches_optax(steps):
    want = optax.cosine_decay_schedule(1e-3, steps, alpha=0.01)
    got = train_sr.cosine_decay(1e-3, steps, alpha=0.01)
    for c in range(steps + 4):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=SCHED_RTOL,
                                   err_msg=f"count {c}")


def test_optimizer_steps_at_the_schedule():
    """LambdaLR over a base rate of 1: each step runs at the schedule's
    value for the steps taken before it, as optax counts."""
    w = torch.zeros(3, requires_grad=True)
    opt, sched = train_sr.make_optimizer([w], 2e-3, 10)
    want = train_sr.cosine_decay(2e-3, 10, alpha=0.01)
    for c in range(12):
        assert opt.param_groups[0]["lr"] == want(c)
        w.grad = torch.ones(3)
        opt.step()
        sched.step()


# ------------------------------------------------------ one train step

def _assert_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


def test_sr_step_matches_jax(data):
    hrs, lrs = data
    x, y = lrs[:BATCH], hrs[:BATCH]
    jp = jsr.init_params(jax.random.PRNGKey(1), scale=2, hidden=16)
    loss, grads = jax.value_and_grad(jsr.loss_fn)(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
    p = _tensors(jp)
    with models.exact_f32():
        got = sr.loss_fn(p, torch.as_tensor(x), torch.as_tensor(y))
        got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL)
    _assert_grads([t.grad.numpy() for t in _leaves(p)], _jax_leaves(grads))


@pytest.mark.parametrize("channels", [1, 3])
def test_dncnn_step_matches_jax(channels):
    clean = train_sr.make_dataset(BATCH, 16, 4)
    if channels == 1:
        clean = train_denoise.luma(clean)
    noisy = _noisy(clean, 9)
    jp = jdenoise.init_params(jax.random.PRNGKey(2), channels=channels,
                              hidden=8)
    loss, grads = jax.value_and_grad(_jax_dncnn_loss)(
        jp, jnp.asarray(noisy), jnp.asarray(clean))
    p = _tensors(jp)
    with models.exact_f32():
        got = train_denoise.loss_fn(p, torch.as_tensor(noisy),
                                    torch.as_tensor(clean))
        got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL)
    _assert_grads([t.grad.numpy() for t in _leaves(p)], _jax_leaves(grads))


# ------------------------------------------------------ 50 Adam steps

def _jax_adam(loss_fn, params, batches):
    """The JAX trainers' optimizer and step, one call a step."""
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, STEPS, alpha=0.01))

    @jax.jit
    def step(params, state, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    state, losses = opt.init(params), []
    for batch in batches:
        params, state, loss = step(params, state, *map(jnp.asarray, batch))
        losses.append(float(loss))
    return params, losses


def _port_adam(loss_fn, params, batches):
    opt, sched = train_sr.make_optimizer(_leaves(params), 1e-3, STEPS)
    losses = [float(train_sr.train_step(opt, sched, loss_fn, params,
                                        *map(torch.as_tensor, batch)))
              for batch in batches]
    return params, losses


def _adam_case(model, data):
    hrs, lrs = data
    _, idxs = next(train_sr.index_chunks(0, PATCHES, BATCH, STEPS))
    if model == "sr":
        jp = jsr.init_params(jax.random.PRNGKey(ADAM_SR_KEY), scale=2,
                             hidden=16)
        batches = [(lrs[i], hrs[i]) for i in idxs[:STEPS]]
        return jsr.loss_fn, sr.loss_fn, jp, batches
    jp = jdenoise.init_params(jax.random.PRNGKey(0), channels=3, hidden=8)
    clean = [lrs[i] for i in idxs[:STEPS]]        # 12x12 patches
    batches = [(_noisy(c, s), c) for s, c in enumerate(clean)]
    return _jax_dncnn_loss, train_denoise.loss_fn, jp, batches


@pytest.mark.parametrize("model", ["sr", "dncnn"])
def test_50_adam_steps_match_optax(model, data):
    jloss, loss, jp, batches = _adam_case(model, data)
    p = _tensors(jp)
    jp, want = _jax_adam(jloss, jp, batches)
    p, got = _port_adam(loss, p, batches)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for t, w in zip(_leaves(p), _jax_leaves(jp)):
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                   atol=PARAM_ATOL)


# ------------------------------------------------ held-out evaluations

@pytest.mark.parametrize("scale", [2, 3])
def test_sr_held_out_matches_jax(scale):
    """The JAX trainer's evaluation (its main's lines) on equal params."""
    jp = jsr.init_params(jax.random.PRNGKey(3), scale=scale, hidden=16)
    got = train_sr.held_out(_tensors(jp), HR, scale, 5, "cpu")
    test = jtrain_sr.make_dataset(16, HR, 5 + 999)
    test_lr = jtrain_sr.area_down(test, scale)
    pred = np.asarray(jax.jit(jsr.apply)(jp, jnp.asarray(test_lr)))
    flat = test_lr.reshape(-1, test_lr.shape[2], test_lr.shape[3])
    bic = np.asarray(jresize_plane(jnp.asarray(flat) * 255.0, HR, HR,
                                   "bicubic")) / 255.0
    bic = np.clip(bic.reshape(test.shape), 0, 1)

    def psnr(a, b):
        return -10 * np.log10(max(np.mean((a - b) ** 2), 1e-12))

    want = (psnr(pred, test), psnr(bic, test))
    np.testing.assert_allclose(got, want, rtol=0, atol=PSNR_ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_dncnn_held_out_matches_jax(channels):
    jp = jdenoise.init_params(jax.random.PRNGKey(4), channels=channels,
                              hidden=8)
    got = train_denoise.held_out(_tensors(jp), 16, channels, 6, "cpu")
    test = jtrain_sr.make_dataset(16, 16, 6 + 777)
    if channels == 1:
        test = (0.299 * test[:, :1] + 0.587 * test[:, 1:2]
                + 0.114 * test[:, 2:3]).astype(np.float32)
    trng = np.random.default_rng(42)
    noisy = np.clip(test + trng.normal(0, 25.0 / 255, test.shape)
                    .astype(np.float32), 0, 1)
    pred = np.asarray(jax.jit(jdenoise.apply)(jp, jnp.asarray(noisy)))

    def psnr(a, b):
        return -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12))

    assert got[0] == psnr(noisy, test)
    np.testing.assert_allclose(got[1], psnr(pred, test), rtol=0,
                               atol=PSNR_ATOL)


# ----------------------------------------------------------- the mains

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            return main(argv), out.getvalue()
        except SystemExit as e:
            return e, out.getvalue()


def _frames(n=2, h=24, w=32):
    rng = np.random.default_rng(12)
    return {"y": rng.integers(16, 236, (n, h, w)).astype(np.uint8),
            "u": rng.integers(16, 240, (n, h // 2, w // 2)).astype(np.uint8),
            "v": rng.integers(16, 240, (n, h // 2, w // 2)).astype(np.uint8)}


def _through_both_filters(model, path):
    planes = _frames()
    h, w = planes["y"].shape[1:]
    want = jinfer.InferFilter(model, path, precision="fp32")(JFrameBatch(
        {k: jnp.asarray(v) for k, v in planes.items()}, "yuv420p", w, h))
    got = infer.InferFilter(model, path, precision="fp32")(
        FrameBatch.from_numpy(planes, "yuv420p", w, h, device="cpu"))
    np.testing.assert_allclose(got.planes["rgb"].numpy(),
                               np.asarray(want.planes["rgb"]), rtol=0,
                               atol=FILTER_ATOL)


def _bundled(name):
    with np.load(os.path.join(infer.WEIGHTS_DIR, name)) as z:
        return {k: z[k] for k in z.files}


def test_train_sr_main_saves(tmp_path, monkeypatch):
    """From the bundled x2 weights at a near-zero rate the model beats
    bicubic: the npz holds the JAX keys and shapes and runs in both
    packages' InferFilter."""
    start = _bundled("espcn_x2.npz")
    monkeypatch.setattr(sr, "init_params", lambda gen, scale, hidden,
                        device: models.from_jax_params(start, device))
    out = str(tmp_path / "x2.npz")
    rec, log = _run(train_sr.main, [
        "--platform", "cpu", "--steps", "1", "--patches", "16", "--batch",
        "2", "--hr", "36", "--lr", "1e-7", "--out", out])
    monkeypatch.undo()
    assert isinstance(rec, dict), (rec, log)
    assert "held-out PSNR: model" in log and f"saved {out}" in log
    assert rec["psnr_model"] > rec["psnr_bicubic"] and rec["steps"] == 100
    jp = jsr.init_params(jax.random.PRNGKey(0), scale=2, hidden=64)
    with np.load(out) as z:
        assert {k: z[k].shape for k in z.files} == \
            {k: v.shape for k, v in jp.items()}
        assert all(z[k].dtype == np.float32 for k in z.files)
    _through_both_filters("sr2x", out)


def test_train_denoise_main_saves(tmp_path, monkeypatch):
    start = _bundled("dncnn.npz")
    layers = [{"w": start[f"layers.{i}.w"], "b": start[f"layers.{i}.b"]}
              for i in range(len(start) // 2)]
    monkeypatch.setattr(denoise, "init_params", lambda gen, channels,
                        device: models.from_jax_params({"layers": layers},
                                                       device))
    out = str(tmp_path / "dn.npz")
    rec, log = _run(train_denoise.main, [
        "--platform", "cpu", "--steps", "1", "--patches", "8", "--batch",
        "2", "--size", "40", "--lr", "1e-7", "--out", out])
    monkeypatch.undo()
    assert isinstance(rec, dict), (rec, log)
    assert rec["psnr_model"] >= rec["psnr_noisy"] + 3.0
    assert "held-out sigma=25: noisy" in log and f"saved {out}" in log
    jp = jdenoise.init_params(jax.random.PRNGKey(0), channels=3)
    with np.load(out) as z:
        assert sorted(z.files) == sorted(
            f"layers.{i}.{n}" for i in range(len(jp["layers"]))
            for n in "wb")
        for i, layer in enumerate(jp["layers"]):
            assert z[f"layers.{i}.w"].shape == layer["w"].shape
            assert z[f"layers.{i}.b"].shape == layer["b"].shape
    _through_both_filters("denoise", out)


@pytest.mark.parametrize("tool", ["train_sr", "train_denoise"])
def test_mains_refuse_like_jax(tool, tmp_path, monkeypatch):
    """A model that learns nothing (rate 0) fails the gate in both tools
    with the same message, and writes nothing."""
    import gmat_tpu.utils.compile_cache as jcache
    monkeypatch.setattr(jcache, "enable", lambda *a, **k: None)
    size = ["--hr", "24"] if tool == "train_sr" else ["--size", "24"]
    argv = ["--steps", "1", "--patches", "8", "--batch", "2", "--lr", "0",
            *size]
    port = {"train_sr": train_sr, "train_denoise": train_denoise}[tool]
    jtool = {"train_sr": jtrain_sr, "train_denoise": jtrain_denoise}[tool]
    want, _ = _run(jtool.main, argv + ["--out", str(tmp_path / "j.npz")])
    got, log = _run(port.main, argv + ["--platform", "cpu", "--out",
                                       str(tmp_path / "p.npz")])
    assert isinstance(want, SystemExit) and isinstance(got, SystemExit)
    assert str(got) == str(want) and "not saving" in str(got), log
    assert not os.listdir(tmp_path)


def test_default_outputs_are_the_ports_weights():
    """Without --out the trainers write into the port's weights
    directory, the one InferFilter reads, never the JAX package's."""
    want = os.path.join(REPO, "gmat_tpu_torch", "models", "weights")
    assert os.path.samefile(infer.WEIGHTS_DIR, want)
    assert train_sr.WEIGHTS_DIR == train_denoise.WEIGHTS_DIR == \
        infer.WEIGHTS_DIR


def test_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (train_sr.main, train_denoise.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--steps", "1"])


# ------------------------------------------------ TF32 in the backward

def _hooked(loss_fn, seen):
    """loss_fn whose output records the TF32 flag when its gradient
    flows back (each parameter's hook records it too)."""
    def fn(params, *batch):
        for t in _leaves(params):
            t.register_hook(lambda g: seen.append(
                torch.backends.cudnn.allow_tf32))
        loss = loss_fn(params, *batch)
        loss.register_hook(lambda g: seen.append(
            torch.backends.cudnn.allow_tf32))
        return loss
    return fn


@pytest.fixture
def tf32_default(monkeypatch):
    """PyTorch's default: cuDNN may use TF32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def test_train_step_backward_runs_without_tf32(tf32_default):
    p = sr.init_params(models.generator(0), hidden=8, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    opt, sched = train_sr.make_optimizer(list(p.values()), 1e-3, 10)
    x, y = torch.rand(2, 3, 6, 6), torch.rand(2, 3, 12, 12)
    seen = []
    train_sr.train_step(opt, sched, _hooked(sr.loss_fn, seen), p, x, y)
    assert seen == [False] * 7
    assert torch.backends.cudnn.allow_tf32


def test_distributed_step_backward_runs_without_tf32(tf32_default,
                                                     monkeypatch):
    """The self-test's dp x tp train step, in a world of one on gloo."""
    seen = []
    forward = distributed.pmesh.sr_forward_tp

    def hooked(cols, x):
        pred = forward(cols, x)
        pred.register_hook(lambda g: seen.append(
            torch.backends.cudnn.allow_tf32))
        return pred

    monkeypatch.setattr(distributed.pmesh, "sr_forward_tp", hooked)
    args = distributed.worker_args([
        "--selftest-worker", "--coordinator", "127.0.0.1:1",
        "--num-processes", "1", "--process-id", "0",
        "--devices-per-host", "2", "--platform", "cpu"])
    distributed.init_distributed(f"127.0.0.1:{distributed.free_port()}", 1,
                                 0, local_device_count=2, platform="cpu",
                                 timeout=30)
    try:
        rec = distributed.run_workload(args)
    finally:
        distributed.shutdown()
    assert rec["workload"] == "train" and np.isfinite(rec["loss"])
    assert seen == [False] * rec["mesh"]["data"]   # a prediction a row
    assert torch.backends.cudnn.allow_tf32


# ----------------------------------- the port's bundled checkpoints

@pytest.mark.parametrize("name", sorted(os.listdir(JAX_WEIGHTS)))
def test_weights_are_byte_copies(name):
    with open(os.path.join(JAX_WEIGHTS, name), "rb") as f:
        want = f.read()
    with open(os.path.join(infer.WEIGHTS_DIR, name), "rb") as f:
        assert f.read() == want


def test_weights_directory_holds_the_same_files():
    assert sorted(os.listdir(infer.WEIGHTS_DIR)) == \
        sorted(os.listdir(JAX_WEIGHTS))


def _psnr(a, b):
    return -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12))


def _sr_and_bicubic(model, scale, hidden=0):
    hr = train_sr.make_dataset(8, 96, seed=123456)       # held-out seed
    lr = train_sr.area_down(hr, scale)
    filt = infer.InferFilter(model=model, precision="fp32", hidden=hidden)
    with torch.no_grad():
        pred = sr.apply(filt.params, torch.as_tensor(lr)).numpy()
    assert pred.shape == hr.shape
    flat = torch.as_tensor(lr.reshape(-1, lr.shape[2], lr.shape[3]))
    bic = resize_plane(flat * 255.0, 96, 96, "bicubic").numpy() / 255.0
    bic = np.clip(bic.reshape(hr.shape), 0, 1)
    return filt, _psnr(pred, hr), _psnr(bic, hr)


@pytest.mark.parametrize("model,scale", [("sr2x", 2), ("sr3x", 3)])
def test_bundled_sr_beats_bicubic(model, scale):
    filt, p_model, p_bic = _sr_and_bicubic(model, scale)
    # auto-loaded bundled weights, not the random init
    rnd = sr.init_params(scale=scale, device="cpu")
    assert not np.allclose(filt.params["w1"].numpy(), rnd["w1"].numpy())
    assert filt.scale == scale
    assert p_model > p_bic, (p_model, p_bic)


def test_bundled_sr2x_h128_beats_h64():
    _, p64, _ = _sr_and_bicubic("sr2x", 2)
    _, p128, _ = _sr_and_bicubic("sr2x", 2, hidden=128)
    assert p128 > p64, (p64, p128)


def test_bundled_weights_opt_out():
    rnd = sr.init_params(scale=2, device="cpu")
    filt = infer.InferFilter(model="sr2x", weights="random")
    np.testing.assert_array_equal(filt.params["w1"].numpy(),
                                  rnd["w1"].numpy())


def test_bundled_denoise_removes_noise():
    clean = train_sr.make_dataset(6, 64, seed=987654)    # held-out seed
    rng = np.random.default_rng(11)
    noisy = np.clip(clean + rng.normal(0, 25.0 / 255, clean.shape)
                    .astype(np.float32), 0, 1)
    filt = infer.InferFilter(model="denoise", precision="fp32")
    with torch.no_grad():
        pred = denoise.apply(filt.params, torch.as_tensor(noisy)).numpy()
    p_noisy, p_model = _psnr(noisy, clean), _psnr(pred, clean)
    assert p_model > p_noisy + 3.0, (p_noisy, p_model)


@pytest.mark.parametrize("name", ["espcn_x2.npz", "espcn_x3.npz",
                                  "dncnn.npz"])
def test_checkpoint_exists_and_small(name):
    path = os.path.join(infer.WEIGHTS_DIR, name)
    assert os.path.exists(path), f"{name} must ship with the port"
    assert os.path.getsize(path) < 1 << 20
