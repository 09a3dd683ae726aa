"""The port's ABR ladder app (apps/metrans) against the JAX one: options,
the per-batch ladder step (per-rung resize and the fused rung kernel's
plain version), and whole sessions on the CPU, compared by what each
encoder worker is handed."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmat_tpu.apps import metrans as jmetrans
from gmat_tpu.av import toolkit as jtk
from gmat_tpu.ops import pallas_kernels as jpk
from gmat_tpu_torch.apps import metrans
from gmat_tpu_torch.av import rawvideo
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


@pytest.mark.parametrize("field,value,slice_no", [
    ("video_filter_desc", "hflip", 3),
    ("audio_filter_desc", "volume=0.5", 6),
    ("proc_decode", True, 7),
    ("rung_filter", "scale=32:16", 3),
])
def test_unported_options_raise(tmp_path, y4m, field, value, slice_no):
    opts = _opts(metrans, y4m, tmp_path, "x", ((32, 16),))
    if field == "rung_filter":
        opts.rungs[0].filter_desc = value
    else:
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
