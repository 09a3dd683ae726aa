"""The port's perf harness (`gmat_tpu_torch/apps/perf.py`) against the JAX
package's, on the CPU.

Every perf smoke of tests/test_apps.py and tests/test_utils.py runs here
with `gmat_tpu.apps.perf.main` replaced by a twin: the JAX harness runs
first, then the port's (`device="cpu"`) on the same arguments, and the
twin holds the two JSON lines to each other before the JAX test's own
assertions judge the port's line: the same field names at every level,
and the same values for every field that is not a rate, a time or a note
(frame, image and batch counts, the rung list, the HEIF still's size,
the extract counts, the ingest rows' frames).  The device cases that no
JAX smoke runs (ladder, ladder10, infer, graph, pipeline from a Y4M and
over two decode processes) go through the same twin at small sizes.
"""
import contextlib
import inspect
import io
import json
import re
import sys

import numpy as np
import pytest
import torch

import gmat_tpu.apps.perf as jax_perf
from gmat_tpu_torch.apps import perf as port_perf
from gmat_tpu_torch.av import rawvideo

from . import test_apps, test_utils
from .test_apps import clip  # noqa: F401  (the mirrored tests' fixture)
from .torch_deadline import deadline

MIRRORED = [(test_apps, "test_perf_sustained_smoke"),
            (test_apps, "test_perf_ingest_smoke"),
            (test_apps, "test_perf_rungs_smoke"),
            (test_utils, "test_perf_encode_and_ladder"),
            (test_utils, "test_perf_extract")]
# fields that hold a rate, a time or prose: they differ between two runs
TIME_FIELD = re.compile(r"fps|_ms_per_batch$|^seconds$|^wall_s$|speedup|"
                        r"efficiency|scaling|^note$|^timing$")
# a perf case that spawns decode processes gets this long
SPAWN_TIMEOUT_S = 120
_JAX_MAIN = jax_perf.main


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def same_record(a, b, where="record"):
    """JAX's record `a` and the port's `b`: the same keys everywhere, the
    same values outside the rate/time/prose fields."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            f"{where}: {list(a)} vs {b}"
        for k in a:
            if not TIME_FIELD.search(k):
                same_record(a[k], b[k], f"{where}.{k}")
            else:
                assert type(b[k]) is type(a[k]) or {type(a[k]), type(
                    b[k])} <= {int, float}, f"{where}.{k}"
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_record(x, y, f"{where}[{i}]")
        return
    assert a == b, f"{where}: {a!r} vs {b!r}"


def perf_twin(argv=None):
    """gmat-perf of both packages on the same arguments; the port's line
    is what the caller reads."""
    rc_jax, out_jax = _run(_JAX_MAIN, argv)
    rc, out = _run(lambda a: port_perf.main(a, device="cpu"), argv)
    assert rc == rc_jax == 0
    rec_jax = json.loads(out_jax.strip().splitlines()[-1])
    rec = json.loads(out.strip().splitlines()[-1])
    same_record(rec_jax, rec)
    sys.stdout.write(out)
    return rc


@pytest.mark.parametrize("module,name", MIRRORED,
                         ids=[n for _, n in MIRRORED])
def test_perf_mirrors_jax(module, name, request, monkeypatch):
    monkeypatch.setattr(jax_perf, "main", perf_twin)
    fn = getattr(module, name)
    kw = {p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters}
    with deadline(SPAWN_TIMEOUT_S):
        fn(**kw)


@pytest.mark.parametrize("argv", [
    ["ladder", "-width", "64", "-height", "32"],
    ["ladder10", "-width", "64", "-height", "32"],
    ["infer", "-width", "64", "-height", "32"],
    ["graph", "-width", "128", "-height", "64"],
], ids=lambda a: a[0])
def test_device_case_matches_jax(argv, capsys):
    assert perf_twin(argv) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["case"] == argv[0] and rec["platform"] == "cpu"
    rates = ([r["fps"] for r in rec["per_filters"].values()]
             if argv[0] == "graph" else [rec["fps"]])
    assert all(r > 0 for r in rates)


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = str(tmp_path_factory.mktemp("perf") / "in.y4m")
    wr = rawvideo.Y4MWriter(path, 64, 48, (30, 1))
    for _ in range(40):
        wr.write(rng.integers(0, 256, (48, 64)).astype(np.uint8),
                 rng.integers(0, 256, (24, 32)).astype(np.uint8),
                 rng.integers(0, 256, (24, 32)).astype(np.uint8))
    wr.close()
    return path


def test_pipeline_from_y4m_matches_jax(y4m, capsys):
    """The pipeline case on a Y4M (no libav*): both harnesses count every
    frame of the file through the ladder."""
    assert perf_twin(["pipeline", "-i", y4m]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 40 and rec["procs"] == 1


def test_pipeline_over_decode_processes_matches_jax(clip, capsys):
    """-procs 2: two decode processes fan in over the shared-memory rings
    (av/shm_ring) to the ladder; both harnesses count both copies of the
    clip."""
    with deadline(SPAWN_TIMEOUT_S):
        assert perf_twin(["pipeline", "-i", clip, "-procs", "2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["procs"] == 2 and rec["frames"] == 2 * test_apps.NFRAMES


def test_perf_main_defaults_to_the_card(monkeypatch):
    """Without device= a device case runs on the card: with no card it
    raises instead of timing the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_perf.main(["ladder", "-width", "64", "-height", "32"])


def test_perf_twin_catches_a_different_count(monkeypatch, capsys):
    """The twin is not a pass-through: a port that reports one frame too
    many fails the comparison."""
    real = port_perf.CASES["encode"]
    monkeypatch.setitem(port_perf.CASES, "encode",
                        lambda a: dict(real(a), frames=a.frames + 1))
    with pytest.raises(AssertionError, match="frames"):
        perf_twin(["encode", "-frames", "4", "-width", "64",
                   "-height", "32"])


def test_every_jax_case_has_a_port():
    parser_cases = re.findall(r'"(\w+)": perf_\w+',
                              inspect.getsource(jax_perf.main))
    assert sorted(port_perf.CASES) == sorted(parser_cases)
    assert len(port_perf.CASES) == 16
