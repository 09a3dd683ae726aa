"""The port's user-facing entry points against the JAX package's: the
`gmat` CLI (`gmat_tpu_torch/apps/cli.py`), tracing and the build cache
(`utils/tracing.py`, `utils/compile_cache.py`) and the bindings façade
(`bindings.py`), all on the CPU.

Every `test_cli_*` of tests/test_apps.py runs here with
`gmat_tpu.apps.cli.main` replaced by a twin: the JAX CLI runs first, then
the port's (`device="cpu"`) on the same arguments, and the twin holds the
two runs to each other before the JAX test's own assertions judge the
port's output:
  * the same exit code and the same frame counts in and out;
  * the files each run wrote: the same names; with an integer graph (no
    scale, format, smooth or tensorrt) the same bytes, whatever the sink;
    otherwise lossless sinks (.y4m, .png) within 1 LSB — the jitted JAX
    graph contracts f32 multiply-adds into FMAs that the port's eager ops
    round separately — and codec sinks (.jpg, .heic, containers) the
    same frame count and geometry;
  * `-list-filters` the same names and options (yadif and bwdif list no
    `pad_batch`: the port's eager graph has no padded batches, a
    difference by design in ROADMAP.md section 3), `-h filter=NAME` the
    same options.
The bindings tests run with the façade's classes replaced by twins
(device verbs within rtol 1e-6 of JAX, the rest equal).
"""
import contextlib
import inspect
import io
import json
import os
import re
import sys
import tempfile

import numpy as np
import pytest
import torch

import gmat_tpu.apps.cli as jax_cli
import gmat_tpu.bindings as jax_bindings
from gmat_tpu_torch import bindings as port_bindings
from gmat_tpu_torch.apps import cli as port_cli
from gmat_tpu_torch.av import heif, jpeg, toolkit as tk
from gmat_tpu_torch.av.rawvideo import Y4MReader
from gmat_tpu_torch.utils.png import read_png

from . import test_apps, test_utils
from .test_apps import clip  # noqa: F401  (the mirrored tests' fixture)
from .torch_twin import Twin

MIRRORED = [(test_apps, n) for n, fn in vars(test_apps).items()
            if n.startswith("test_cli_") and inspect.isfunction(fn)]
BINDINGS = [(test_apps, "test_bindings_reference_surface"),
            (test_utils, "test_bindings_facade"),
            (test_utils, "test_extract_app_and_image_provider")]
# graphs whose float math the jitted JAX graph contracts into FMAs
FMA_FILTERS = ("scale", "format", "smooth", "tensorrt")
FMA_LSB = 1
LOSSLESS = (".y4m", ".png")
# options of the JAX filters that the port's eager graph has no use for
NO_PAD_BATCH = {"yadif", "bwdif"}
BINDINGS_RTOL = 1e-6
_JAX_MAIN = jax_cli.main
_COUNTS = re.compile(r"gmat: (\d+) frames in, (\d+) frames out")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _option(argv, names, default):
    for i, a in enumerate(argv[:-1]):
        if a in names:
            return argv[i + 1]
    return default


def _files(d):
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns
            for n in os.listdir(d)
            if os.path.isfile(os.path.join(d, n))} if d else {}


def _written(d, before):
    now = _files(d)
    return sorted(n for n, t in now.items() if before.get(n) != t)


def _decoded(path):
    """The pictures a written file holds, as lists of numpy planes."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        rd = Y4MReader(path)
        try:
            return [f[:3] for f in rd.frames()]
        finally:
            rd.close()
    if ext == ".png":
        return [(read_png(path),)]
    if ext in (".jpg", ".jpeg"):
        with open(path, "rb") as f:
            return [jpeg.decode_jpeg_bytes(f.read())]
    if ext == ".heic":
        return [heif.decode_still(path)]
    dm = tk.Demuxer(path)
    dec = tk.Decoder.from_demuxer(dm)
    try:
        frames = [f for p in dm if p.stream == 0
                  for f in dec.decode(p.data, p.pts)]
        return [f[:3] for f in frames + list(dec.decode(None))]
    finally:
        dm.close()
        dec.close()


def _same_output(name, ref, got, tol):
    """One file of the JAX run (`ref`) and of the port's (`got`)."""
    if tol == 0:
        assert ref == got, f"{name}: bytes differ"
        return
    ext = os.path.splitext(name)[1].lower()
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for tag, data in (("ref", ref), ("got", got)):
            paths.append(os.path.join(d, tag + ext))
            with open(paths[-1], "wb") as f:
                f.write(data)
        a, b = (_decoded(p) for p in paths)
    assert len(a) == len(b), f"{name}: {len(a)} vs {len(b)} pictures"
    for fa, fb in zip(a, b):
        assert [p.shape for p in fa] == [p.shape for p in fb], name
        if ext in LOSSLESS:
            worst = max(int(np.abs(x.astype(np.int64) - y).max())
                        for x, y in zip(fa, fb))
            assert worst <= tol, f"{name}: {worst} LSB"


def _filter_lines(text):
    """-list-filters: name -> options, `pad_batch` dropped where the port
    has none."""
    out = {}
    for line in text.splitlines():
        name, _, opts = line.partition(" ")
        if name in NO_PAD_BATCH:
            opts = opts.replace(", pad_batch=0", "")
        out[name] = opts.strip()
    return out


def cli_twin(argv=None):
    """gmat of both packages on the same arguments; the port's outputs
    and messages are what the caller sees."""
    argv = list(argv)
    output = _option(argv, ("-o", "--output"), "null")
    d = (None if output == "null"
         else os.path.dirname(os.path.abspath(output)))
    before = _files(d)
    rc_jax, out_jax, err_jax = _run(_JAX_MAIN, argv)
    made_jax = {}
    for n in _written(d, before):
        with open(os.path.join(d, n), "rb") as f:
            made_jax[n] = f.read()
        os.remove(os.path.join(d, n))
    rc, out, err = _run(lambda a: port_cli.main(a, device="cpu"), argv)
    made = _written(d, before)
    assert rc == rc_jax, (rc, rc_jax, err)
    assert _COUNTS.findall(err) == _COUNTS.findall(err_jax), err
    vf = _option(argv, ("-vf", "--filter"), "null")
    tol = FMA_LSB if any(f in vf for f in FMA_FILTERS) else 0
    assert made == sorted(made_jax), (made, sorted(made_jax))
    for n in made:
        with open(os.path.join(d, n), "rb") as f:
            _same_output(n, made_jax[n], f.read(), tol)
    if "-list-filters" in argv:
        assert _filter_lines(out) == _filter_lines(out_jax)
    elif "-h" in argv:
        assert out.partition("  options:")[2] == \
            out_jax.partition("  options:")[2]
    sys.stdout.write(out)
    sys.stderr.write(err)
    return rc


@pytest.mark.parametrize("name", [n for _, n in MIRRORED])
def test_cli_mirrors_jax(name, request, monkeypatch):
    monkeypatch.setattr(jax_cli, "main", cli_twin)
    monkeypatch.setattr(jax_cli, "_strip_ffmpeg_noops", Twin(
        jax_cli._strip_ffmpeg_noops, port_cli._strip_ffmpeg_noops))
    fn = getattr(test_apps, name)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


@pytest.mark.parametrize("module,name", BINDINGS, ids=[n for _, n in BINDINGS])
def test_bindings_mirror_jax(module, name, request, monkeypatch):
    for cls in ("FrameExtractor", "ImageProvider", "HeifFormat", "NvEncLite",
                "NvDecLite", "NvHeifWriter", "NvHeifReader", "Swscale",
                "SwscaleCuda"):
        monkeypatch.setattr(jax_bindings, cls, Twin(
            getattr(jax_bindings, cls), getattr(port_bindings, cls),
            rtol=BINDINGS_RTOL, port_kw={"device": "cpu"}, name=cls))
    fn = getattr(module, name)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


def test_mirror_covers_every_jax_cli_test():
    assert len(MIRRORED) == 27


def test_cli_twin_sees_a_one_lsb_change(clip, tmp_path, monkeypatch):
    """The twin is not a pass-through: one code value moved in the port's
    integer graph fails the comparison."""
    from gmat_tpu_torch.filters import graph

    class Nudged(graph.FilterGraph):
        def process(self, fb, **kw):
            out, keep = super().process(fb, **kw)
            out.planes["y"][0, 0, 0] ^= 1
            return out, keep
    monkeypatch.setattr(graph, "FilterGraph", Nudged)
    with pytest.raises(AssertionError, match="bytes differ"):
        cli_twin(["-i", clip, "-vf", "hflip", "-o",
                  str(tmp_path / "n.y4m"), "-frames", "4", "-batch", "4"])


def test_cli_defaults_to_the_card(clip, tmp_path, monkeypatch):
    """Without device=, main() stages its batches on the card: with no
    card it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["-i", clip, "-o", str(tmp_path / "x.y4m"),
                       "-frames", "2", "-batch", "2"])


def test_cli_batches_stay_on_the_device(clip, monkeypatch):
    """The graph gets the decoded batches on the device main() was given
    (the null sink reads nothing back)."""
    from gmat_tpu_torch.filters import graph
    seen = []

    class Spy(graph.FilterGraph):
        def process(self, fb, **kw):
            out, keep = super().process(fb, **kw)
            seen.append((fb.device.type, out.device.type))
            return out, keep
    monkeypatch.setattr(graph, "FilterGraph", Spy)
    assert port_cli.main(["-i", clip, "-vf", "scale=96:64", "-o", "null",
                          "-frames", "8", "-batch", "4"], device="cpu") == 0
    assert seen == [("cpu", "cpu")] * 2


def test_cli_audio_filters_wait_for_the_audio_slice(clip, tmp_path):
    with pytest.raises(NotImplementedError, match="slice 6"):
        port_cli.main(["-i", clip, "-af", "volume=0.5", "-c:a", "aac",
                       "-o", str(tmp_path / "a.mp4")], device="cpu")


def test_cli_pad_batch_is_accepted_and_changes_nothing(clip, tmp_path):
    outs = []
    for extra in ([], ["-pad-batch"]):
        path = str(tmp_path / f"p{len(extra)}.y4m")
        assert port_cli.main(["-i", clip, "-vf", "select=lt(n\\,5)", "-o",
                              path, "-batch", "4"] + extra,
                             device="cpu") == 0
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_cli_still_pattern_is_the_jax_one():
    for out in ("a.jpg", "x_%03d.png", "100%_%d.jpg", "noext"):
        assert port_cli.still_pattern(out) == jax_cli.still_pattern(out)
    from gmat_tpu_torch.apps import extract
    assert extract.still_pattern is port_cli.still_pattern


def test_cli_no_op_and_pix_fmt_tables_match_jax():
    assert port_cli._FFMPEG_NOOP_VALUED == jax_cli._FFMPEG_NOOP_VALUED
    assert port_cli._FFMPEG_NOOP_FLAGS == jax_cli._FFMPEG_NOOP_FLAGS
    assert port_cli._PIX_FMT_BITS == jax_cli._PIX_FMT_BITS
    flags = lambda p: sorted(  # noqa: E731
        (a.option_strings, a.default) for a in p._actions)
    assert flags(port_cli.build_parser()) == flags(jax_cli.build_parser())


# ------------------------------------------------------ tracing, cache

def test_tracing_range_and_timer():
    """tests/test_utils.py test_tracing_range_and_timer on tensors."""
    from gmat_tpu_torch.utils.tracing import device_timer, trace_range
    with trace_range("Frame#0"):
        x = torch.ones((8, 8)) * 2
    with device_timer("op", sync=lambda: x) as t:
        x + 1
    assert t["seconds"] is not None and t["seconds"] >= 0
    assert "sync_missing" not in t


@pytest.mark.parametrize("sync", [None, lambda: None, lambda: [], {},
                                  lambda: {"a": 1.0}, 3.0],
                         ids=["none", "returns_none", "returns_empty",
                              "empty_value", "returns_dict", "scalar"])
def test_device_timer_sync_missing_as_jax(sync):
    """sync_missing is set exactly where the JAX timer sets it."""
    from gmat_tpu.utils import tracing as jax_tracing
    from gmat_tpu_torch.utils import tracing
    flags = []
    for mod in (jax_tracing, tracing):
        with mod.device_timer("t", sync=sync) as t:
            pass
        flags.append(t.get("sync_missing", False))
    assert flags[0] == flags[1]


def test_trace_writes_chrome_trace_with_ranges(tmp_path):
    from gmat_tpu_torch.utils import tracing

    @tracing.annotate_fn("gmat_fn")
    def work(x):
        return x * 2

    tracing.start_trace(str(tmp_path))
    with tracing.trace_range("Frame#7"):
        work(torch.ones(4))
    path = tracing.stop_trace()
    assert tracing.stop_trace() is None       # nothing left to stop
    assert os.path.dirname(path) == str(tmp_path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"Frame#7", "gmat_fn"} <= names


def test_compile_cache_enable(tmp_path, monkeypatch):
    """tests/test_utils.py test_compile_cache_enable: the kernel build
    cache is the directory enable() names."""
    from gmat_tpu_torch.ops import _build
    from gmat_tpu_torch.utils import compile_cache
    assert compile_cache.DEFAULT_DIR == str(_build.BUILD_DIR)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    d = compile_cache.enable(str(tmp_path / "cache"))
    assert os.path.isdir(d) and _build.BUILD_DIR == tmp_path / "cache"


def test_bindings_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nv12 = np.zeros((12, 8), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_bindings.Swscale(8, 8).nv12_to_rgbpf32(nv12)
    rgb = port_bindings.Swscale(8, 8, device="cpu").nv12_to_rgbpf32(nv12)
    assert rgb.shape == (3, 8, 8) and rgb.device.type == "cpu"
