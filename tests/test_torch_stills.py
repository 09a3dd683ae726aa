"""The HEVC parser, the HEIF still codec and the scan app of the port
(`gmat_tpu_torch/av/hevc.py`, `av/heif.py`, `apps/scan.py`) against the
JAX package's on the same inputs.

Every test of tests/test_hevc_pps.py, test_hevc_rps.py,
test_hevc_timing.py and test_heif.py runs here with its module's `hevc`
and `heif` replaced by twins (tests/torch_twin.py): each call goes to the
JAX module and to the port's, and the two must agree exactly — parsed
SPS/PPS/VPS/VUI/HRD/slice/SEI dataclasses field by field, container and
HEVC bytes equal, decoded planes equal (0 LSB), the same exceptions —
before the JAX test's own assertions judge the port's result.  The scan
app runs as a twin of `gmat_tpu.apps.scan.main`: both apps' stdout must
match line by line, JSON lines key by key apart from `fps` (a rate of
this run's clock).  The JAX tests' inputs and sizes are kept.
"""
import contextlib
import inspect
import io
import json
import sys

import pytest

import gmat_tpu.apps.scan as jax_scan
from gmat_tpu.av import heif as jax_heif, hevc as jax_hevc
from gmat_tpu_torch.apps import scan as port_scan
from gmat_tpu_torch.av import heif as port_heif, hevc as port_hevc

from . import test_heif, test_hevc_pps, test_hevc_rps, test_hevc_timing
# the mirrored tests' fixtures, looked up by name
from .test_heif import still_annexb  # noqa: F401
from .test_hevc_rps import hevc_stream, hevc_stream_pts  # noqa: F401
from .torch_twin import Twin

MODULES = (test_hevc_pps, test_hevc_rps, test_hevc_timing, test_heif)
MIRRORED = [(m, name) for m in MODULES for name, fn in vars(m).items()
            if name.startswith("test_") and inspect.isfunction(fn)]
# what the scan apps print that differs between two runs of one app
SCAN_TIME_FIELDS = ("fps",)
_JAX_SCAN_MAIN = jax_scan.main


def _captured(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _scan_lines(text):
    lines = []
    for line in text.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            lines.append(line)
            continue
        if isinstance(rec, dict):
            rec = {k: v for k, v in rec.items() if k not in SCAN_TIME_FIELDS}
        lines.append(rec)
    return lines


def scan_twin(argv=None):
    """gmat-scan of both packages on the same arguments: the same exit
    code and output; the port's output is what the caller reads."""
    rc_jax, out_jax = _captured(_JAX_SCAN_MAIN, argv)
    rc, out = _captured(port_scan.main, argv)
    assert rc == rc_jax
    assert _scan_lines(out) == _scan_lines(out_jax)
    sys.stdout.write(out)
    return rc


@pytest.mark.parametrize(
    "module,name", MIRRORED,
    ids=[f"{m.__name__.rsplit('.', 1)[-1]}.{n}" for m, n in MIRRORED])
def test_mirrors_jax(module, name, request, monkeypatch):
    for attr, ref, port in (("hevc", jax_hevc, port_hevc),
                            ("heif", jax_heif, port_heif)):
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, Twin(ref, port, name=attr))
    monkeypatch.setattr(jax_scan, "main", scan_twin)
    fn = getattr(module, name)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


def test_mirror_covers_every_jax_test():
    """73 tests: 8 + 15 + 7 HEVC, 43 HEIF."""
    counts = {m.__name__.rsplit(".", 1)[-1]: 0 for m in MODULES}
    for m, _ in MIRRORED:
        counts[m.__name__.rsplit(".", 1)[-1]] += 1
    assert counts == {"test_hevc_pps": 8, "test_hevc_rps": 15,
                      "test_hevc_timing": 7, "test_heif": 43}


def test_twin_catches_a_difference(monkeypatch):
    """The twin is not a pass-through: a port that parses one field
    differently fails the mirrored test."""
    nal = test_hevc_pps.make_sps(sps_id=2)
    real = port_hevc.parse_sps_full

    def off_by_one(data):
        got = real(data)
        got.log2_max_poc_lsb += 1
        return got
    monkeypatch.setattr(port_hevc, "parse_sps_full", off_by_one)
    with pytest.raises(AssertionError, match="log2_max_poc_lsb"):
        Twin(jax_hevc, port_hevc, name="hevc").parse_sps_full(nal)
