"""The port's ABR ladder app (apps/metrans) against the JAX one: options,
the per-batch ladder step (per-rung resize and the fused rung kernel's
plain version), the filtered step around it, and whole sessions on the
CPU, with and without filter graphs, compared by what each encoder
worker is handed."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.apps import metrans as jmetrans
from gmat_tpu.av import ingest as jingest, toolkit as jtk
from gmat_tpu.filters import graph as jgraph
from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu_torch.apps import metrans
from gmat_tpu_torch.av import ingest, rawvideo
from gmat_tpu_torch.core.frame import FrameBatch
from gmat_tpu_torch.ops import rungs
from tests.test_extractor import make_clip

W, H, NF = 160, 96, 21


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    """Gradient plus noise, 21 frames (a padded tail at batch 8)."""
    rng = np.random.default_rng(7)
    path = str(tmp_path_factory.mktemp("mt") / "in.y4m")
    wr = rawvideo.Y4MWriter(path, W, H, (30, 1))
    ramp = np.add.outer(np.arange(H), np.arange(W)).astype(np.float32)
    for i in range(NF):
        y = np.clip(ramp + i + rng.normal(0, 12, (H, W)), 0, 255)
        u = rng.integers(60, 200, (H // 2, W // 2))
        v = rng.integers(60, 200, (H // 2, W // 2))
        wr.write(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))
    wr.close()
    return path


_XML = """<Options>
  <InputFile>{clip}</InputFile>
  <Session>2</Session>
  <VideoEncParam>codec=h264:preset=p1:bitrate=500K</VideoEncParam>
  <Resolutions>
    <Resolution><Width>160</Width><Height>120</Height>
      <OutputFile>{out}/a_#.mp4</OutputFile></Resolution>
    <Resolution><Width>96</Width><Height>64</Height>
      <VideoFilterDesc>hflip</VideoFilterDesc>
      <VideoEncParamSuffix>maxbitrate=800K</VideoEncParamSuffix>
      <OutputFile>{out}/b_#.mp4</OutputFile></Resolution>
  </Resolutions>
</Options>"""


def test_load_xml_matches_jax(tmp_path):
    """The XML of test_apps.py's metrans config loads to the same options
    in both packages."""
    xml = tmp_path / "options.xml"
    xml.write_text(_XML.format(clip="in.mp4", out=tmp_path))
    got = metrans.Options.load_xml(str(xml))
    want = jmetrans.Options.load_xml(str(xml))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sessions == 2 and got.rungs[1].filter_desc == "hflip"
    assert got.rungs[1].enc_suffix == "maxbitrate=800K"


def _capture(monkeypatch, module):
    """Record every frame each rung's EncoderWorker.put is handed."""
    seen = {}
    orig = module.EncoderWorker.put

    def put(self, frame):
        seen.setdefault(self.name, []).append(
            tuple(np.array(p, copy=True) for p in frame))
        return orig(self, frame)
    monkeypatch.setattr(module.EncoderWorker, "put", put)
    return seen


def _opts(module, src, tmp_path, tag, sizes):
    return module.Options(
        input_file=src, video_enc_param="codec=h264:preset=p1:constqp=25",
        rungs=[module.Rung(w, h, out_file=str(tmp_path / f"{tag}{i}_#.mp4"))
               for i, (w, h) in enumerate(sizes)])


@pytest.mark.parametrize("source", ["y4m", "mp4"])
def test_run_session_matches_jax(monkeypatch, tmp_path, y4m, source):
    """Two unfiltered rungs, both packages on the CPU (each takes the
    per-rung resize): every encoder is handed equal frames, equally
    many, and the muxed files decode to that many frames."""
    if source == "mp4":
        src = str(tmp_path / "clip.mp4")
        make_clip(src)
        n_in = 60
    else:
        src, n_in = y4m, NF
    sizes = ((96, 64), (48, 32))
    seen_port = _capture(monkeypatch, metrans)
    seen_jax = _capture(monkeypatch, jmetrans)
    res = metrans.run_session(0, _opts(metrans, src, tmp_path, "p", sizes),
                              batch=8, device="cpu")
    jres = jmetrans.run_session(0, _opts(jmetrans, src, tmp_path, "j",
                                         sizes), batch=8)
    assert res["frames_in"] == jres["frames_in"] == n_in
    assert res["frames_out"] == jres["frames_out"] == 2 * n_in
    assert sorted(seen_port) == sorted(seen_jax) == ["enc0", "enc1"]
    for name, (w, h) in zip(("enc0", "enc1"), sizes):
        got, want = seen_port[name], seen_jax[name]
        assert len(got) == len(want) == n_in
        assert got[0][0].shape == (h, w) and got[0][1].shape == (h // 2,
                                                                   w // 2)
        for g, j in zip(got, want):
            for a, b in zip(g, j):
                np.testing.assert_array_equal(a, b)
    for i, (w, h) in enumerate(sizes):
        dm = jtk.Demuxer(str(tmp_path / f"p{i}_0.mp4"))
        assert (dm.width, dm.height) == (w, h)
        dec = jtk.Decoder.from_demuxer(dm)
        n = sum(len(list(dec.decode(p.data, p.pts))) for p in dm
                if p.stream == 0) + len(list(dec.decode(None)))
        dm.close()
        dec.close()
        assert n == n_in


def test_ladder_step_fused_branch_matches_pallas(monkeypatch, rng):
    """The fused branch, forced on the CPU, runs the rung kernel's plain
    version: within 1 LSB of the JAX fused_rungs (interpret mode)."""
    n, h, w = 2, 64, 128
    sizes = ((96, 48), (64, 32), (32, 16))
    planes = {"y": rng.integers(0, 256, (n, h, w)).astype(np.uint8),
              "u": rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
              "v": rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8)}
    fb = FrameBatch.from_numpy(planes, "yuv420p", w, h, device="cpu")
    assert not metrans.fused_ok(fb, sizes)          # CPU planes: resize
    monkeypatch.setattr(metrans, "fused_ok", lambda fb, s: True)
    before = dict(rungs.LAUNCHES)
    outs = metrans.ladder_step(fb, sizes)
    assert rungs.LAUNCHES == before
    want = jpk.fused_rungs(*(jnp.asarray(planes[k]) for k in "yuv"), sizes,
                           interpret=True)
    for (ow, oh), rb, wr in zip(sizes, outs, want):
        assert (rb.width, rb.height, rb.format) == (ow, oh, "yuv420p")
        rb.validate()
        for k, wp in zip("yuv", wr):
            d = np.abs(rb.planes[k].numpy().astype(int)
                       - np.asarray(wp).astype(int)).max()
            assert d <= 1, (k, (ow, oh), d)


def test_ladder_step_resize_branch(rng):
    """Off the card each rung is one resize, as the JAX app does on a
    non-TPU backend."""
    planes = {"y": rng.integers(0, 256, (1, 32, 64)).astype(np.uint8),
              "u": rng.integers(0, 256, (1, 16, 32)).astype(np.uint8),
              "v": rng.integers(0, 256, (1, 16, 32)).astype(np.uint8)}
    fb = FrameBatch.from_numpy(planes, "yuv420p", 64, 32, device="cpu")
    outs = metrans.ladder_step(fb, ((32, 16), (16, 8)))
    from gmat_tpu_torch.ops.resize import resize
    for rb, (ow, oh) in zip(outs, ((32, 16), (16, 8))):
        want = resize(fb, ow, oh)
        for k in "yuv":
            assert torch.equal(rb.planes[k], want.planes[k])


def _capture_fps(monkeypatch, module):
    """Record the frame rate each rung's EncoderWorker is built with."""
    rates = {}
    orig = module.EncoderWorker.__init__

    def init(self, name, path, w, h, fps, enc_kwargs, *a, **kw):
        rates[name] = tuple(enc_kwargs.get("fps", fps))
        return orig(self, name, path, w, h, fps, enc_kwargs, *a, **kw)
    monkeypatch.setattr(module.EncoderWorker, "__init__", init)
    return rates


# (common VideoFilterDesc, one filter per rung): the filter sets of
# tests/test_apps.py's metrans cases
_FILTERED = {
    "common_yadif": ("yadif=1", ("", "")),
    "rung_eq_lut_unsharp": ("", (
        "eq=contrast=1.2:brightness=0.05,lutyuv=y=gammaval(0.9):u=val:"
        "v=val,unsharp=5:5:0.8", "hflip")),
    "rung_fps_key_select": ("", ("fps=15", r"select=eq(key\,1)")),
    "common_and_rung": ("hflip,yadif=1", ("fps=30", "format=yuv444p")),
    # HDR10 -> SDR: tests/test_tonemap.py:243's chain with explicit input
    # tags (metrans builds its graphs without stream meta) on a 10-bit
    # PQ source
    "hdr10_to_sdr": (
        "zscale=tin=smpte2084:min=bt2020nc:pin=bt2020:t=linear:npl=100,"
        "format=gbrpf32le,zscale=p=bt709,tonemap=tonemap=hable:desat=0,"
        "zscale=t=bt709:m=bt709:r=tv,format=yuv420p", ("", "hflip")),
    # inverse telecine: a 3:2-pulldown 30/1 source back to 24/1 with a
    # fade in, as chip_smoke.py's abr_ivtc phase runs it
    "ivtc": ("detelecine=first_field=top:pattern=23,fade=in:0:12",
             ("", "hflip")),
    # in-graph inference as the common graph, in the default bf16 lane:
    # luma-only ESPCN x2 (seeded weights both packages load, {sr_luma})
    # and the bundled 3-channel DnCNN back to yuv420p
    "infer_sr2x_luma": ("infer=sr2x:luma_only=1:weights={sr_luma}",
                        ("", "hflip")),
    "infer_denoise": ("infer=denoise,format=yuv420p", ("", "")),
}
# the key select needs an encoded source's keyframe flags
_SOURCES = {"rung_fps_key_select": "mp4", "hdr10_to_sdr": "y4m10",
            "ivtc": "telecined"}
# every case hands the encoders equal frames but the HDR chain's and the
# models': the HDR chain's f32
# pow/exp/log (the PQ EOTF, the BT.709 OETF) differ by an ulp between
# XLA's and PyTorch's CPU implementations, which moves a rare sample by
# 1 LSB (1 of the 241,920 rung samples here); the bound
# of tests/test_torch_hdr.py, and at most 1 sample in 10^3
# the model cases likewise: the packages' f32 conv sums run in another
# order, and a layer output rounds one bf16 step (or, in fp32, a final
# value one ulp) apart, which moves a rare sample across a rounding edge
# (4 and 105 of the 241,920 rung samples here for sr2x and denoise; 3
# and 4 in fp32); tests/test_torch_infer.py's bound
_LSB = {"hdr10_to_sdr": 1, "infer_sr2x_luma": 1, "infer_denoise": 1}
_DIFFER = {"hdr10_to_sdr": 1e-3, "infer_sr2x_luma": 1e-3,
           "infer_denoise": 1e-3}


def make_pq_y4m(path, n=NF):
    """A 10-bit PQ-coded 4:2:0 Y4M: a luma ramp over codes 64-940 that
    moves per frame, chroma around 512, seeded noise."""
    rng = np.random.default_rng(17)
    wr = rawvideo.Y4MWriter(path, W, H, (30, 1), bits=10)
    xx = np.arange(W)[None, :]
    for i in range(n):
        y = 64 + (xx * 876 // (W - 1) + 9 * i) % 877 \
            + rng.integers(-8, 9, (H, W))
        u = 512 + rng.integers(-60, 61, (H // 2, W // 2))
        v = 512 + rng.integers(-60, 61, (H // 2, W // 2))
        wr.write(*(np.clip(p, 64, 960).astype(np.uint16) for p in (y, u, v)))
    wr.close()


def make_telecined_y4m(path, n=24):
    """n progressive frames (gradient plus noise) through the port's
    telecine=first_field=top:pattern=23 on the CPU, written as a 30/1
    Y4M of n * 5 / 4 frames."""
    from gmat_tpu_torch.filters.graph import FilterGraph
    rng = np.random.default_rng(19)
    ramp = np.add.outer(np.arange(H), np.arange(W)).astype(np.float32)
    planes = {"y": np.stack([np.clip(ramp + 3 * i + rng.normal(0, 12, (H, W)),
                                     0, 255) for i in range(n)]),
              "u": rng.integers(60, 200, (n, H // 2, W // 2)),
              "v": rng.integers(60, 200, (n, H // 2, W // 2))}
    fb = FrameBatch.from_numpy({k: v.astype(np.uint8)
                                for k, v in planes.items()},
                               "yuv420p", W, H, device="cpu")
    out, keep = FilterGraph("telecine=first_field=top:pattern=23").process(
        fb, pts=np.arange(n))
    wr = rawvideo.Y4MWriter(path, W, H, (30, 1))
    for i in np.nonzero(keep)[0]:
        wr.write(*(out.planes[k][i].numpy() for k in "yuv"))
    wr.close()
    return int(keep.sum())


def _sr_luma_ckpt(tmp_path):
    """A luma-only ESPCN x2 checkpoint of seeded weights (the port's init,
    generator seed 3), which both packages load by key."""
    from gmat_tpu_torch import models
    from gmat_tpu_torch.models import sr
    params = sr.init_params(models.generator(3), channels=1, device="cpu")
    path = str(tmp_path / "sr_luma.npz")
    np.savez(path, **{k: v.numpy() for k, v in params.items()})
    return path


@pytest.mark.parametrize("case", sorted(_FILTERED))
def test_filtered_session_matches_jax(monkeypatch, tmp_path, y4m, case):
    """VideoFilterDesc and rung filters, both packages on the CPU: every
    encoder is handed equal frames, equally many, at the same rate (a
    common yadif=1 doubles it, fps=N decimates it), EOF flush included;
    a rung that a filter left as yuv444p is converted back to yuv420p."""
    if _SOURCES.get(case) == "mp4":
        src = str(tmp_path / "clip.mp4")
        make_clip(src)
    elif _SOURCES.get(case) == "telecined":
        src = str(tmp_path / "telecined.y4m")
        assert make_telecined_y4m(src) == 30
    elif _SOURCES.get(case) == "y4m10":
        src = str(tmp_path / "pq.y4m")
        make_pq_y4m(src)
        # run_session opens its source at 8 bits in both packages: hand
        # both the 10-bit lane of their decode_stream
        for mod in (jingest, ingest):
            monkeypatch.setattr(mod, "decode_stream", functools.partial(
                mod.decode_stream, bits=10))
        # the JAX graphs op by op: jitted, XLA contracts the float chain's
        # multiply-adds into FMAs on the CPU and moves more samples by
        # 1 LSB (tests/test_torch_hdr.py)
        monkeypatch.setattr(jgraph.FilterGraph, "_jit_pure",
                            lambda self, idx, fn: fn)
    else:
        src = y4m
    common, rung_filters = _FILTERED[case]
    if case.startswith("infer"):
        common = common.format(sr_luma=_sr_luma_ckpt(tmp_path))
        # the JAX graphs op by op: jitted, XLA fuses the bf16 lane's
        # casts (tests/test_torch_infer.py)
        monkeypatch.setattr(jgraph.FilterGraph, "_jit_pure",
                            lambda self, idx, fn: fn)
    sizes = ((96, 64), (48, 32))
    seen_port = _capture(monkeypatch, metrans)
    seen_jax = _capture(monkeypatch, jmetrans)
    rates_port = _capture_fps(monkeypatch, metrans)
    rates_jax = _capture_fps(monkeypatch, jmetrans)

    def opts(module, tag):
        o = _opts(module, src, tmp_path, tag, sizes)
        o.video_filter_desc = common
        for r, f in zip(o.rungs, rung_filters):
            r.filter_desc = f
        return o
    res = metrans.run_session(0, opts(metrans, "p"), batch=7, device="cpu")
    jres = jmetrans.run_session(0, opts(jmetrans, "j"), batch=7)
    assert res["frames_in"] == jres["frames_in"]
    assert res["frames_out"] == jres["frames_out"] > 0
    assert rates_port == rates_jax
    if case == "ivtc":
        # detelecine's fps_mul 0.8 takes the 30/1 source to 24/1, and the
        # 30 telecined frames back to 24 progressive ones per rung
        from fractions import Fraction
        assert {Fraction(*r) for r in rates_port.values()} == {24}
        assert res["frames_in"] == 30 and res["frames_out"] == 2 * 24
    assert sorted(seen_port) == sorted(seen_jax)
    lsb = _LSB.get(case, 0)
    differ = total = 0
    for name in seen_jax:
        got, want = seen_port[name], seen_jax[name]
        assert len(got) == len(want)
        for g, j in zip(got, want):
            for a, b in zip(g, j):
                assert a.shape == b.shape and a.dtype == b.dtype
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                assert d.max() <= lsb, (name, d.max())
                differ += int(np.count_nonzero(d))
                total += d.size
    assert differ <= _DIFFER.get(case, 0) * total, (differ, total)


def test_filtered_step_fused_branch_matches_jax_rungs(monkeypatch, rng):
    """filtered_step with the fused branch forced on the CPU (the rung
    kernel's plain version): a common yadif=1 then per-rung eq/lut/unsharp
    and hflip, against the JAX graphs around the JAX fused_rungs
    (interpret mode), batch by batch and through the flush."""
    from gmat_tpu.core.frame import FrameBatch as JFrameBatch
    from gmat_tpu.filters.graph import FilterGraph as JGraph
    from gmat_tpu_torch.filters.graph import FilterGraph
    n, h, w = 4, 64, 128
    sizes = ((96, 48), (64, 32))
    rung_specs = ("eq=contrast=1.2:brightness=0.05,lutyuv=y=gammaval(0.9):"
                  "u=val:v=val,unsharp=5:5:0.8", "hflip")
    monkeypatch.setattr(metrans, "fused_ok", lambda fb, s: True)
    common, jcommon = FilterGraph("yadif=1"), JGraph("yadif=1")
    graphs = [FilterGraph(s, 60.0) for s in rung_specs]
    jgraphs = [JGraph(s, 60.0) for s in rung_specs]
    before = dict(rungs.LAUNCHES)
    for b in range(2):
        planes = {"y": rng.integers(0, 256, (n, h, w)).astype(np.uint8),
                  "u": rng.integers(0, 256, (n, h // 2, w // 2))
                  .astype(np.uint8),
                  "v": rng.integers(0, 256, (n, h // 2, w // 2))
                  .astype(np.uint8)}
        pts = np.arange(b * n, (b + 1) * n)
        fb = FrameBatch.from_numpy(planes, "yuv420p", w, h, device="cpu")
        outs = metrans.filtered_step(fb, pts, n, sizes, common, graphs,
                                     {"times": pts / 30.0}, 1.0 / 30.0)
        jfb = JFrameBatch({k: jnp.asarray(v) for k, v in planes.items()},
                          "yuv420p", w, h)
        jfb, keep = jcommon.process(jfb, pts=pts, valid=n,
                                    times=pts / 30.0)
        jpts = jcommon.out_pts
        jouts = jpk.fused_rungs(*(jfb.planes[k] for k in "yuv"), sizes,
                                interpret=True)
        assert len(outs) == len(sizes)
        for (rb, rkeep), (ow, oh), g, jo in zip(outs, sizes, jgraphs,
                                                jouts):
            want = JFrameBatch(dict(zip("yuv", jo)), "yuv420p", ow, oh)
            want, jkeep = g.process(want, pts=jpts, keep=keep,
                                    times=jpts / 30.0)
            np.testing.assert_array_equal(rkeep, jkeep)
            assert rb.format == "yuv420p" and (rb.width, rb.height) == (ow,
                                                                        oh)
            for k in "yuv":
                d = np.abs(rb.planes[k].numpy().astype(int)
                           - np.asarray(want.planes[k]).astype(int)).max()
                # the plain rung version is within 1 LSB of the Pallas
                # kernel; eq's contrast and unsharp may double that
                assert d <= 3, (k, (ow, oh), d)
    assert rungs.LAUNCHES == before
    flushed = common.flush()
    assert len(flushed) == 1 and flushed[0][0].batch == 2


@pytest.mark.parametrize("field,value,slice_no", [
    ("audio_filter_desc", "volume=0.5", 6),
    ("proc_decode", True, 7),
])
def test_unported_options_raise(tmp_path, y4m, field, value, slice_no):
    opts = _opts(metrans, y4m, tmp_path, "x", ((32, 16),))
    setattr(opts, field, value)
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        metrans.run_session(0, opts, device="cpu")
    if field == "audio_filter_desc":
        opts.audio_codec = "aac"
        with pytest.raises(NotImplementedError, match="slice 6"):
            metrans.transcode_audio(opts)


def test_sessions_need_placeholder(tmp_path, y4m):
    opts = _opts(metrans, y4m, tmp_path, "s", ((32, 16),))
    opts.sessions = 2
    opts.rungs[0].out_file = str(tmp_path / "fixed.mp4")
    with pytest.raises(ValueError, match="placeholder"):
        metrans.run_session(0, opts, device="cpu")


def test_main_runs_on_the_card_only(tmp_path, y4m, capsys):
    """The CLI drives run_session on the card: without one it reports
    the session failed (rc 1), it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = metrans.main(["-i", y4m, "-r", f"64x32:{tmp_path}/o.mp4"])
    assert rc == 1
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        metrans.main(["-i", y4m])                 # no rungs
