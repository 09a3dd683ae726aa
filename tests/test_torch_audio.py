"""The port's audio lane (`gmat_tpu_torch/av/audio_filters.py`, `biquads`,
`loudnorm`, `ebur128`, `dynaudnorm`, `amix`, `swr`) against the JAX
package's.

Every test of tests/test_audio.py, test_audio_mix.py, test_amix.py,
test_biquads.py, test_loudnorm.py, test_dynaudnorm.py, test_adelay.py and
test_aloop.py runs here with the audio modules' functions and classes
replaced by twins (tests/torch_twin.py): each call goes to the JAX module
and to the port's, and the two must agree bit for bit — every PCM block,
every measurement, every coefficient, the same exceptions — before the
JAX test's own assertions judge the port's result.  Both packages run
the same numpy code and the same `csrc/gmat_dsp.cpp` (built into each
package's own `av/_lib`).

The twins reach the tests two ways: the names a test module imported at
its top are replaced in that module, and the audio modules in
`sys.modules` are replaced by proxies that hand a twin to any importer
outside the JAX package (the tests' function-level imports), and the
real object to the JAX package's own lazy imports, so that the JAX side
stays all JAX.  The tests that run a metrans session or the CLI with
audio run both apps (the port's on the CPU): the same frame counts and
the same audio packets in the written files.
"""
import dataclasses
import inspect
import sys

import pytest
from _pytest.mark.structures import ParameterSet

import gmat_tpu.apps.metrans as jax_metrans
import gmat_tpu.av.amix
import gmat_tpu.av.audio_filters
import gmat_tpu.av.biquads
import gmat_tpu.av.dynaudnorm
import gmat_tpu.av.ebur128
import gmat_tpu.av.loudnorm
import gmat_tpu.av.swr
from gmat_tpu.av import toolkit as jtk
from gmat_tpu_torch.apps import metrans as port_metrans
from gmat_tpu_torch.av import (amix, audio_filters, biquads, dynaudnorm,
                               ebur128, loudnorm, native, swr)

from . import (test_adelay, test_aloop, test_amix, test_audio,
               test_audio_mix, test_biquads, test_dynaudnorm, test_loudnorm)
from .test_torch_cli import cli_twin
from .torch_twin import Twin

AUDIO = {"audio_filters": (gmat_tpu.av.audio_filters, audio_filters),
         "biquads": (gmat_tpu.av.biquads, biquads),
         "loudnorm": (gmat_tpu.av.loudnorm, loudnorm),
         "ebur128": (gmat_tpu.av.ebur128, ebur128),
         "dynaudnorm": (gmat_tpu.av.dynaudnorm, dynaudnorm),
         "amix": (gmat_tpu.av.amix, amix),
         "swr": (gmat_tpu.av.swr, swr)}
MODULES = (test_audio, test_audio_mix, test_amix, test_biquads,
           test_loudnorm, test_dynaudnorm, test_adelay, test_aloop)


def _cases(module, name):
    """(module, name, params) for each case of a JAX test: one per entry
    of its parametrize marks."""
    cases = [{}]
    for mark in getattr(getattr(module, name), "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = mark.args[0]
        names = ([n.strip() for n in names.split(",")]
                 if isinstance(names, str) else list(names))
        rows = []
        for v in mark.args[1]:
            if isinstance(v, ParameterSet):
                rows.append(tuple(v.values))
            else:
                rows.append((v,) if len(names) == 1 else tuple(v))
        cases = [dict(c, **dict(zip(names, r))) for c in cases
                 for r in rows]
    return [(module, name, c) for c in cases]


MIRRORED = [case for m in MODULES for name, fn in vars(m).items()
            if name.startswith("test_") and inspect.isfunction(fn)
            for case in _cases(m, name)]


class ModuleTwin:
    """A JAX audio module as its importers outside the JAX package see
    it: each public name a twin of the JAX object and the port's."""

    def __init__(self, ref, port):
        self._ref, self._port = ref, port

    def __getattr__(self, name):
        real = getattr(self._ref, name)
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if name.startswith("__") or caller.startswith("gmat_tpu."):
            return real
        short = self._ref.__name__.rsplit(".", 1)[-1]
        return Twin(real, getattr(self._port, name), name=f"{short}.{name}")


def _audio_packets(path):
    dm = jtk.Demuxer(path)
    try:
        return [bytes(p.data) for p in dm if p.stream == 1]
    finally:
        dm.close()


def run_session_twin(session_idx, opts, batch=16, frames_limit=0,
                     quiet=True):
    """metrans run_session of both packages on the same options (the
    port's on the CPU): the same frame counts, and each rung's file the
    same audio packets."""
    res_jax = jax_metrans.run_session(session_idx, opts, batch,
                                      frames_limit, quiet)
    paths = [r.out_file.replace("#", str(session_idx)) for r in opts.rungs]
    audio_jax = [_audio_packets(p) for p in paths]
    fields = {f.name: getattr(opts, f.name)
              for f in dataclasses.fields(opts) if f.name != "rungs"}
    popts = port_metrans.Options(**fields, rungs=[
        port_metrans.Rung(**dataclasses.asdict(r)) for r in opts.rungs])
    res = port_metrans.run_session(session_idx, popts, batch, frames_limit,
                                   quiet, device="cpu")
    for k in ("session", "frames_in", "frames_out"):
        assert res[k] == res_jax[k], (k, res[k], res_jax[k])
    for p, want in zip(paths, audio_jax):
        assert _audio_packets(p) == want, p
    return res


class MetransTwin:
    """`gmat_tpu.apps.metrans` for the audio tests: its options, and
    run_session of both packages."""
    Options = jax_metrans.Options
    Rung = jax_metrans.Rung
    run_session = staticmethod(run_session_twin)

    def __getattr__(self, name):
        return getattr(jax_metrans, name)


def _install(monkeypatch, module):
    for key, (ref, port) in AUDIO.items():
        monkeypatch.setitem(sys.modules, ref.__name__,
                            ModuleTwin(ref, port))
    monkeypatch.setitem(sys.modules, "gmat_tpu.apps.metrans", MetransTwin())
    monkeypatch.setattr(sys.modules["gmat_tpu.apps.cli"], "main", cli_twin)
    for name, obj in list(vars(module).items()):
        for ref, port in AUDIO.values():
            if getattr(ref, name, None) is obj and callable(obj) \
                    and not name.startswith("__"):
                monkeypatch.setattr(module, name, Twin(
                    obj, getattr(port, name), name=name))


def _argument(module, name, request):
    """A test argument: the test module's own fixture (two modules both
    name theirs `sig`), else a fixture of this run."""
    fix = getattr(module, name, None)
    if hasattr(fix, "_get_wrapped_function"):
        return fix._get_wrapped_function()()
    return request.getfixturevalue(name)


def _ids(cases):
    """test_module.test_name, with the case's index where it has one."""
    seen, ids = {}, []
    for module, name, params in cases:
        key = f"{module.__name__.rsplit('.', 1)[-1]}.{name}"
        if params:
            seen[key] = seen.get(key, -1) + 1
            key += f"[{seen[key]}]"
        ids.append(key)
    return ids


@pytest.mark.parametrize("case", MIRRORED, ids=_ids(MIRRORED))
def test_mirrors_jax(case, request, monkeypatch):
    module, name, params = case
    _install(monkeypatch, module)
    fn = getattr(module, name)
    fn(**{p: params[p] if p in params else _argument(module, p, request)
          for p in inspect.signature(fn).parameters})


def test_mirror_covers_every_jax_test():
    counts = {m.__name__.rsplit(".", 1)[-1]: set() for m in MODULES}
    for m, n, _ in MIRRORED:
        counts[m.__name__.rsplit(".", 1)[-1]].add(n)
    assert {k: len(v) for k, v in counts.items()} == {
        "test_audio": 21, "test_audio_mix": 13, "test_amix": 6,
        "test_biquads": 7, "test_loudnorm": 13, "test_dynaudnorm": 9,
        "test_adelay": 5, "test_aloop": 4}


def test_twin_catches_a_difference(monkeypatch):
    """The twin is not a pass-through: a port volume filter one LSB off
    fails the mirrored comparison."""
    import numpy as np
    real = audio_filters.volume

    def off(*a, **kw):
        return real(*a, **kw) + np.int16(1)
    monkeypatch.setattr(audio_filters, "volume", off)
    x = np.arange(-400, 400, dtype=np.int16).reshape(-1, 2)
    with pytest.raises(AssertionError, match="volume"):
        Twin(gmat_tpu.av.audio_filters, audio_filters,
             name="audio_filters").volume(x, 0.5)


def test_dsp_builds_into_the_port():
    """The biquad loop is built from the shared csrc/gmat_dsp.cpp into
    the port's own av/_lib, never the JAX package's."""
    lib = native.load("gmat_dsp")
    path = native._LIBDIR / "libgmat_dsp.so"
    assert path.exists() and native._LIBDIR.parent.name == "av"
    assert native._LIBDIR.parents[1].name == "gmat_tpu_torch"
    assert lib.gdsp_biquad_di_s16 is not None
    assert native._LIBS["gmat_dsp"] == (["gmat_dsp.cpp"], [])
