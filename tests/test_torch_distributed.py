"""The port's multi-process scale-out (`gmat_tpu_torch/parallel/
distributed.py`, on `torch.distributed`) against the JAX package's.

Each test of tests/test_distributed.py has a counterpart here.  The real
check launches 2 coordinated OS processes with 4 host devices each (a
gloo process group, the counterpart of JAX's 2 x 4 CPU cluster) and runs
one dp x tp SGD step of the SR model with per-process ingest: both
processes report the same loss, and that loss and the updated parameters
equal one unsharded JAX `optax.sgd(1e-3)` step of `sr.loss_fn` on the
same global batch from the same `PRNGKey(0)` parameters, within rtol
1e-5.  The ladder workload holds every shard against its process's local
recompute at atol 1e-5.  Each launch carries its own time limit, and a
process that fails stops its peers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gmat_tpu.core.frame import FrameBatch as JaxFrameBatch
from gmat_tpu.models import sr as jax_sr
from gmat_tpu.ops import fused as jax_fused
from gmat_tpu.parallel import distributed as jax_dist
from gmat_tpu.parallel import mesh as jax_pm
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.parallel import distributed as dist
from gmat_tpu_torch.parallel import mesh as pm

CPU8 = [torch.device("cpu")] * 8
DRYRUN_TIMEOUT_S = 120
STEP_RTOL = 1e-5


def _raises_alike(fn_jax, fn_port):
    with pytest.raises(ValueError) as ej:
        fn_jax()
    with pytest.raises(ValueError) as ep:
        fn_port()
    assert str(ep.value) == str(ej.value)


def _jax_step(n_processes=2, n_local=8, h=64, w=64):
    """One unsharded JAX SGD step on the global batch that the port's
    processes each draw their part of (`train_workload`'s draws)."""
    params = jax_sr.init_params(jax.random.PRNGKey(0), scale=2, hidden=16)
    ys, us, vs, ts = [], [], [], []
    for pid in range(n_processes):
        rng = np.random.default_rng(pid)
        ys.append(rng.integers(0, 256, (n_local, h, w)).astype(np.uint8))
        us.append(rng.integers(0, 256, (n_local, h // 2, w // 2))
                  .astype(np.uint8))
        vs.append(rng.integers(0, 256, (n_local, h // 2, w // 2))
                  .astype(np.uint8))
        ts.append(rng.uniform(0, 1, (n_local, 3, 64, 64)).astype(np.float32))
    fb = JaxFrameBatch({"y": jnp.asarray(np.concatenate(ys)),
                        "u": jnp.asarray(np.concatenate(us)),
                        "v": jnp.asarray(np.concatenate(vs))},
                       "yuv420p", w, h, "bt709")
    x = jax_fused.preprocess_nchw(fb, 32, 32, use_pallas="never")
    target = jnp.asarray(np.concatenate(ts))
    loss, grads = jax.value_and_grad(jax_sr.loss_fn)(params, x, target)
    opt = optax.sgd(1e-3)
    updates, _ = opt.update(grads, opt.init(params))
    return params, float(loss), optax.apply_updates(params, updates)


def test_multihost_dryrun_2x4(tmp_path):
    """2 processes x 4 devices: the dp x tp train step, per-process data
    feeding, the same loss in both processes — and the same loss and
    updated parameters as JAX's unsharded step."""
    params, want_loss, want = _jax_step()
    src, out = tmp_path / "params.npz", tmp_path / "after.npz"
    np.savez(src, **{k: np.asarray(v) for k, v in params.items()})
    recs = dist.dryrun_multihost(
        2, 4, timeout=DRYRUN_TIMEOUT_S, platform="cpu",
        extra_args=["--params", str(src), "--out", str(out)])
    assert [r["process"] for r in recs] == [0, 1]
    assert all(r["mesh"] == {"data": 4, "model": 2} for r in recs)
    np.testing.assert_allclose(recs[0]["loss"], want_loss, rtol=STEP_RTOL)
    with np.load(out) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=STEP_RTOL, atol=1e-7,
                                       err_msg=k)
        # the step moved every tensor of the model
        assert all(not np.array_equal(got[k], np.asarray(params[k]))
                   for k in ("w1", "w2", "w3"))


def test_multihost_ladder_workload_2x4():
    """The production shape across 2 processes: per-process frame feeding
    into the sharded ladder; each process holds its shards against a
    local unsharded recompute."""
    recs = dist.dryrun_multihost(2, 4, timeout=DRYRUN_TIMEOUT_S,
                                 workload="ladder", platform="cpu")
    assert [r["frames_checked"] for r in recs] == [8, 8]
    assert all(r["global_batch"] == 16 for r in recs)


def test_dryrun_stops_the_group_when_a_process_fails(tmp_path):
    """A process that dies does not leave its peers waiting: the launcher
    stops them and reports the failure well inside its time limit."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed") as e:
        dist.dryrun_multihost(2, 2, timeout=DRYRUN_TIMEOUT_S,
                              platform="cpu",
                              extra_args=["--params",
                                          str(tmp_path / "missing.npz")])
    assert "missing.npz" in str(e.value)
    assert time.monotonic() - t0 < DRYRUN_TIMEOUT_S / 2


def test_entry_points_default_to_the_card():
    """The worker and the launcher run on the card unless asked for the
    host; without a card the worker fails at once instead of falling back
    to the host."""
    import inspect
    argv = ["--selftest-worker", "--coordinator", "127.0.0.1:1",
            "--num-processes", "1", "--process-id", "0"]
    assert dist.worker_args(argv).platform == "cuda"
    assert inspect.signature(
        dist.dryrun_multihost).parameters["platform"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dist.init_distributed("127.0.0.1:1", 1, 0, platform="cuda",
                                  timeout=5)
        assert not torch.distributed.is_initialized()


def test_process_batch_size_divisibility():
    mesh = pm.make_mesh(4, 2, devices=CPU8)
    jmesh = jax_pm.make_mesh(4, 2, devices=jax.devices()[:8])
    # single process here: local == global, any batch divides
    for n in (32, 33):
        assert dist.process_batch_size(mesh, n) == \
            jax_dist.process_batch_size(jmesh, n) == n


def test_feed_process_local_single_process_matches_device_put():
    """In a 1-process cluster the local block is the whole batch: each
    data row gets its contiguous slice at its global offset, as JAX's
    sharded array holds it."""
    mesh = pm.make_mesh(8, 1, devices=CPU8)
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    fed = dist.feed_process_local(mesh, x)
    assert fed.rows == list(range(8)) and fed.starts == list(range(8))
    assert fed.global_len == 8
    jarr = jax_dist.feed_process_local(
        jax_pm.make_mesh(8, 1, devices=jax.devices()[:8]), x)
    np.testing.assert_array_equal(torch.cat(fed.shards).numpy(),
                                  np.asarray(jarr))
    for shard, js in zip(fed.shards, sorted(jarr.addressable_shards,
                                            key=lambda s: s.index[0].start)):
        np.testing.assert_array_equal(shard.numpy(), np.asarray(js.data))


def test_global_mesh_model_axis_host_local():
    mesh = dist.global_mesh(n_model=2, devices=CPU8)
    jmesh = jax_dist.global_mesh(n_model=2)
    assert mesh.shape == jmesh.shape == {"data": 4, "model": 2}
    # model-axis neighbours belong to the same process
    for row in mesh.process_index:
        assert len(set(row.tolist())) == 1
    two = [(p, torch.device("cpu")) for p in (0, 0, 1, 1)]
    assert dist.global_mesh(2, two).process_index.tolist() == [[0, 0],
                                                               [1, 1]]
    with pytest.raises(ValueError, match="spans processes"):
        dist.global_mesh(2, [two[0], two[2], two[1], two[3]])


def test_shard_batch_global_roundtrip():
    mesh = dist.global_mesh(n_model=1, devices=CPU8)
    jmesh = jax_dist.global_mesh(n_model=1)
    n = mesh.shape[dist.DATA_AXIS]
    rng = np.random.default_rng(0)
    planes = {"y": rng.integers(0, 256, (n, 16, 32)).astype(np.uint8),
              "u": rng.integers(0, 256, (n, 8, 16)).astype(np.uint8),
              "v": rng.integers(0, 256, (n, 8, 16)).astype(np.uint8)}
    fb = FrameBatch.from_numpy(planes, "yuv420p", 32, 16, device="cpu")
    out = dist.shard_batch_global(fb, mesh)
    jout = jax_dist.shard_batch_global(
        JaxFrameBatch(planes, "yuv420p", 32, 16, "bt709"), jmesh)
    assert [s.batch for s in out.shards] == [1] * n
    assert out.starts == list(range(n)) and out.global_len == n
    for k in ("y", "u", "v"):
        joined = torch.cat([s.planes[k] for s in out.shards]).numpy()
        np.testing.assert_array_equal(joined, planes[k])
        np.testing.assert_array_equal(joined, np.asarray(jout.planes[k]))


def test_init_distributed_validates_partial_cluster_args():
    _raises_alike(
        lambda: jax_dist.init_distributed(
            coordinator_address="localhost:9999"),
        lambda: dist.init_distributed(coordinator_address="localhost:9999"))
    assert not torch.distributed.is_initialized()


def test_global_mesh_validates_actual_device_list():
    # subset layouts validate against the DEVICES GIVEN: 6-of-8 with
    # n_model=3 is process-local and legal
    m = dist.global_mesh(n_model=3, devices=CPU8[:6])
    assert m.devices.shape == (2, 3)
    assert jax_dist.global_mesh(n_model=3, devices=jax.devices()[:6]) \
        .devices.shape == (2, 3)
    _raises_alike(
        lambda: jax_dist.global_mesh(n_model=3, devices=jax.devices()[:8]),
        lambda: dist.global_mesh(n_model=3, devices=CPU8))


def test_init_distributed_single_process_gloo():
    """A world of one on the host: the group forms, the global mesh is the
    process's own devices, and a collective leaves the value as it is."""
    port = dist.free_port()
    dist.init_distributed(f"127.0.0.1:{port}", 1, 0, local_device_count=2,
                          platform="cpu", timeout=30)
    try:
        mesh = dist.global_mesh(n_model=1)
        assert mesh.shape == {"data": 2, "model": 1}
        assert dist.local_rows(mesh) == [0, 1]
        t = torch.arange(4.0)
        assert torch.equal(dist.all_reduce_sum(t.clone()), t)
        rep = dist.replicate_global({"w": np.ones(3, np.float32)}, mesh)
        assert torch.equal(rep["w"], torch.ones(3))
    finally:
        dist.shutdown()
    assert not torch.distributed.is_initialized()
