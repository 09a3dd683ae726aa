"""The port's mesh and sharded pipeline (`gmat_tpu_torch/parallel/mesh.py`,
`parallel/pipeline.py`) against the JAX package's on its forced 8-device
CPU mesh (tests/conftest.py).

The port's mesh is an array of `torch.device`s; here eight `cpu`
entries stand in for the eight XLA CPU devices.  Each test of
tests/test_parallel.py has a counterpart below on the same inputs (a
numpy seed): the sharded ladder and the ragged batch within atol 1e-5 of
JAX's `ShardedPipeline`, the tensor-parallel SR forward with the JAX
params (`models.from_jax_params`) within atol 2e-5 of JAX's sharded
`sr.apply`, scene scores over shards with a one-frame halo, and the
per-shard work shrinking with the data axis (JAX's serialization canary,
there read from XLA's cost analysis, here from the frames each shard's
call is handed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gmat_tpu.core.frame import from_numpy_yuv420 as jax_yuv420
from gmat_tpu.models import sr as jax_sr
from gmat_tpu.ops import fused as jax_fused
from gmat_tpu.ops.scene import scene_scores as jax_scene_scores
from gmat_tpu.parallel import mesh as jax_pm
from gmat_tpu.parallel.pipeline import ShardedPipeline as JaxPipeline
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.models import from_jax_params, sr
from gmat_tpu_torch.ops import fused
from gmat_tpu_torch.ops.scene import scene_scores_mafd
from gmat_tpu_torch.parallel import mesh as pm
from gmat_tpu_torch.parallel.pipeline import ShardedPipeline, run_sharded

CPU8 = [torch.device("cpu")] * 8
LADDER_ATOL = 1e-5
TP_ATOL = 2e-5


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jax_pm.make_mesh(4, 2)


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(4, 2, devices=CPU8)


def planes(rng, n=8, h=64, w=96):
    return {"y": rng.integers(0, 256, (n, h, w)).astype(np.uint8),
            "u": rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
            "v": rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8)}


def both(p):
    h, w = p["y"].shape[1:]
    return (jax_yuv420(p["y"], p["u"], p["v"]),
            FrameBatch.from_numpy(p, "yuv420p", w, h, device="cpu"))


def test_mesh_shapes(mesh8, jax_mesh8):
    assert mesh8.shape == jax_mesh8.shape == {"data": 4, "model": 2}
    assert mesh8.devices.shape == (4, 2)
    assert (pm.DATA_AXIS, pm.MODEL_AXIS) == (jax_pm.DATA_AXIS,
                                             jax_pm.MODEL_AXIS)


def test_make_mesh_default_is_every_card(monkeypatch):
    """With no devices given the mesh spans the machine's cards; with no
    card it raises instead of laying itself over the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()
    with pytest.raises(ValueError, match="needs 8 devices"):
        pm.make_mesh(4, 2, devices=CPU8[:6])


@pytest.mark.parametrize("n", [8, 6], ids=["even", "ragged"])
def test_sharded_preprocess_matches_jax(rng, mesh8, jax_mesh8, n):
    """test_parallel.py's sharded ladder and ragged batch: the port's
    pipeline pads 6 frames to 8 by repeating the last, like JAX's, and
    every frame is within atol 1e-5 of JAX's sharded output and equal to
    the port's unsharded call."""
    size = 32 if n == 8 else 16
    jfb, fb = both(planes(rng, n=n))
    want = np.asarray(JaxPipeline(
        lambda b: jax_fused.preprocess_nchw(b, size, size),
        mesh=jax_mesh8)(jfb))
    got = ShardedPipeline(lambda b: fused.preprocess_nchw(b, size, size),
                          mesh=mesh8)(fb)
    assert got.shape == want.shape == (8, 3, size, size)
    np.testing.assert_allclose(got.numpy(), want, atol=LADDER_ATOL)
    single = fused.preprocess_nchw(fb, size, size)
    assert torch.equal(got[:n], single)
    if n < 8:
        # the padding frames are the last frame again
        assert torch.equal(got[n:], single[-1:].expand(8 - n, -1, -1, -1))


def test_run_sharded_trims_the_padding(rng, mesh8):
    _, fb = both(planes(rng, n=5))
    out = run_sharded(lambda b: fused.preprocess_nchw(b, 16, 16), fb,
                      mesh8)
    assert out.shape[0] == 5
    rb = run_sharded(lambda b: b.with_planes(
        {k: 255 - v for k, v in b.planes.items()}), fb, mesh8)
    assert rb.batch == 5
    for k in "yuv":
        assert torch.equal(rb.planes[k], 255 - fb.planes[k])
    # a list of batches, as a rung ladder returns
    from gmat_tpu_torch.apps.metrans import ladder_step
    sizes = ((48, 32), (32, 16))
    got = run_sharded(lambda b: ladder_step(b, sizes), fb, mesh8)
    want = ladder_step(fb, sizes)
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        assert (g.batch, g.width, g.height) == (5, w.width, w.height)
        for k in "yuv":
            assert torch.equal(g.planes[k], w.planes[k])


def test_shard_batch_places_one_shard_per_data_row(rng, mesh8):
    _, fb = both(planes(rng, n=8))
    shards = pm.shard_batch(fb, mesh8)
    assert [s.batch for s in shards] == [2, 2, 2, 2]
    for i, s in enumerate(shards):
        for k in "yuv":
            assert torch.equal(s.planes[k], fb.planes[k][2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="does not split"):
        pm.shard_batch(both(planes(rng, n=6))[1], mesh8)


def test_tensor_parallel_sr(rng, mesh8, jax_mesh8):
    """The port's TP forward with the JAX params against JAX's sharded
    `sr.apply` (XLA inserting the all-reduce), and against the port's
    unsharded model."""
    params = jax_sr.init_params(jax.random.PRNGKey(0), scale=2, hidden=16)
    sharded = jax_pm.shard_sr_params(params, jax_mesh8)
    xn = rng.uniform(0, 1, (4, 3, 16, 16)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(xn),
                        NamedSharding(jax_mesh8, P(jax_pm.DATA_AXIS)))
    with jax_mesh8:
        want = np.asarray(jax.jit(jax_sr.apply)(sharded, xs))
    tparams = from_jax_params({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    placed = pm.shard_sr_params(tparams, mesh8)
    x = torch.from_numpy(xn)
    parts = torch.chunk(x, 4)
    got = torch.cat([pm.sr_apply_tp(placed[r], parts[r]) for r in range(4)])
    np.testing.assert_allclose(got.numpy(), want, atol=TP_ATOL)
    np.testing.assert_allclose(got.numpy(), sr.apply(tparams, x).numpy(),
                               atol=TP_ATOL)


def test_shard_sr_params_layout(mesh8):
    """w1/b1 split on their out channels, w2 on its in channels; b2, w3
    and b3 only in column 0; gathering a row gives the params back."""
    params = sr.init_params(scale=2, hidden=16, device="cpu")
    placed = pm.shard_sr_params(params, mesh8)
    assert len(placed) == 4 and all(len(row) == 2 for row in placed)
    for row in placed:
        assert row[0]["w1"].shape == (8, 3, 5, 5)
        assert row[1]["b1"].shape == (8,)
        assert row[1]["w2"].shape == (8, 8, 3, 3)
        assert set(row[0]) == {"w1", "b1", "w2", "b2", "w3", "b3"}
        assert set(row[1]) == {"w1", "b1", "w2"}
    back = pm.gather_sr_params(placed, 3)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="does not split"):
        pm.shard_sr_params(params, pm.make_mesh(2, 3, devices=CPU8))


def test_scene_scores_sharded(rng, mesh8, jax_mesh8):
    """Scene scores over the data axis: each shard scores its frames with
    a one-frame halo (the previous shard's last frame and its mafd), and
    the joined scores equal JAX's sharded scores."""
    p = planes(rng, n=8)
    jfb, fb = both(p)
    sh = NamedSharding(jax_mesh8, P(jax_pm.DATA_AXIS))
    jfb2 = jfb.with_planes({k: jax.device_put(v, sh)
                            for k, v in jfb.planes.items()})
    with jax_mesh8:
        want, _ = jax.jit(lambda b: jax_scene_scores(b))(jfb2)
    scores, prev_last, prev_mafd = [], None, 0.0
    for shard in pm.shard_batch(fb, mesh8):
        s, mafd = scene_scores_mafd(shard, prev_last, prev_mafd)
        scores.append(s)
        prev_last = {k: v[-1] for k, v in shard.planes.items()}
        prev_mafd = mafd[-1]
    np.testing.assert_allclose(torch.cat(scores).numpy(), np.asarray(want),
                               atol=1e-5)


def test_dp_per_shard_work_shrinks(rng):
    """Serialization canary: with n data rows each shard's call sees 1/n
    of the batch — no row is handed the whole batch (an accidentally
    serialized pipeline would gather it first)."""
    _, fb = both(planes(rng, n=8, h=32, w=48))
    seen = {}
    for n in (1, 2, 8):
        calls = []

        def ladder(b):
            calls.append(b.batch)
            return fused.preprocess_nchw(b, 16, 16, use_kernel="never")
        out = ShardedPipeline(ladder, pm.make_mesh(n, 1,
                                                   devices=CPU8[:n]))(fb)
        assert out.shape == (8, 3, 16, 16)
        seen[n] = calls
    assert seen == {1: [8], 2: [4, 4], 8: [1] * 8}
