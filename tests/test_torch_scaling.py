"""The port's scaling-shape tool (`gmat_tpu_torch/tools/scaling_shape.py`)
against the JAX tool's artifact, on the CPU: per-shard flops and bytes
over 1, 2, 4 and 8 shards are 1/n of one shard's within the JAX tool's
1.35 factor, the artifact carries every key of `SCALING.json` (the JAX
tool's, committed), and the near-linear check trips on a pipeline that
hands every shard the whole batch."""
import json
import os

import numpy as np
import pytest
import torch

from gmat_tpu_torch.tools import scaling_shape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLACK = 1.35           # tools/scaling_shape.py's near-linear factor


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "SCALING_torch.json"
    got = scaling_shape.main(["--device", "cpu", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == got
    return got


@pytest.mark.parametrize("ratio", ["flops_ratio_vs_1dev",
                                   "bytes_ratio_vs_1dev"])
def test_per_shard_work_is_one_nth(artifact, ratio):
    rows = artifact["rows"]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    for r in rows:
        n = r["devices"]
        assert 1 / (SLACK * n) <= r[ratio] <= SLACK / n, (n, r[ratio])


def test_artifact_has_the_jax_keys(artifact):
    with open(os.path.join(REPO, "SCALING.json")) as f:
        want = json.load(f)
    assert set(want) <= set(artifact)
    assert set(want["rows"][0]) <= set(artifact["rows"][0])
    for k in ("case", "total_batch", "src", "out"):
        assert artifact[k] == want[k]
    assert artifact["device"] == "cpu"
    assert all(r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
               and np.isfinite(r["wall_ms_median"]) for r in artifact["rows"])


def test_serialized_pipeline_trips_the_check(tmp_path, monkeypatch):
    """A pipeline that gathers the batch before the ladder keeps the
    per-shard work flat: the tool refuses it."""
    class Gathering:
        def __init__(self, fn, mesh):
            self.fn, self.n = fn, mesh.shape["data"]

        def __call__(self, fb):
            return [self.fn(fb) for _ in range(self.n)][0]

    monkeypatch.setattr(scaling_shape, "ShardedPipeline", Gathering)
    with pytest.raises(SystemExit, match="not near-linear"):
        scaling_shape.main(["--device", "cpu", "--out",
                            str(tmp_path / "s.json")])


def test_counters():
    """One flop per output element of an elementwise op; each op's
    operand and result bytes, none for a view."""
    from torch.utils.flop_counter import FlopCounterMode
    a, b = torch.ones(4, 5), torch.ones(4, 5)
    with FlopCounterMode(display=False, custom_mapping={
            op: scaling_shape._per_element
            for op in scaling_shape.ELEMENTWISE}) as fc, \
            scaling_shape.ByteCounter() as bc:
        c = (a + b).view(20)
    assert fc.get_total_flops() == 20
    assert bc.bytes == 3 * 20 * 4 and c.shape == (20,)


def test_cuda_without_a_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling_shape.main(["--out", str(tmp_path / "s.json")])
    assert not os.listdir(tmp_path)
