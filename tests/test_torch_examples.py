"""The port's examples (`gmat_tpu_torch/examples/`) against the JAX
package's (`examples/`), on the CPU.

Every demo of `avtoolkit_demos.DEMOS` runs through a twin: the JAX demo
in one work directory, then the port's (`device="cpu"`) in another, and
the two runs are held to each other with `tests/torch_twin.assert_same`:
the same printed lines and the same files, byte for byte (every demo is
deterministic: libx264, AAC and the muxers write the same bytes for the
same inputs, and the two filter graphs give the same planes).
`stills_and_torch` prints the JAX example's JPEG and HEIF lines;
`quickstart` runs end to end into a temporary directory."""
import contextlib
import io
import os
import sys

import pytest
import torch

from gmat_tpu_torch.examples import avtoolkit_demos, quickstart
from gmat_tpu_torch.examples import stills_and_torch

from .torch_twin import assert_same

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import avtoolkit_demos as jax_demos  # noqa: E402
import stills_and_torch as jax_stills  # noqa: E402


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    return rc, out.getvalue()


def _written(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def twin_demo(name, wd):
    """The JAX demo, then the port's on the CPU; their prints and files
    held to each other."""
    runs = {}
    for side, fn in (("jax", lambda d: jax_demos.DEMOS[name](d)),
                     ("port", lambda d: avtoolkit_demos.DEMOS[name](
                         d, "cpu"))):
        d = os.path.join(wd, side)
        os.makedirs(d)
        _, printed = _printed(fn, d)
        runs[side] = (printed, _written(d))
    assert_same(runs["jax"], runs["port"], where=name)
    return runs["port"]


def test_demos_are_the_jax_demos():
    assert list(avtoolkit_demos.DEMOS) == list(jax_demos.DEMOS)


@pytest.mark.parametrize("name", list(jax_demos.DEMOS))
def test_avtoolkit_demo_matches_jax(name, tmp_path):
    printed, files = twin_demo(name, str(tmp_path))
    assert printed.startswith(f"{name}:")
    assert bool(files) == (name != "aud_filt")    # PCM in memory only


def test_demos_main_runs_the_named_demos(tmp_path):
    rc, printed = _printed(avtoolkit_demos.main,
                           ["aud_filt", "vid_filt", "--workdir",
                            str(tmp_path)], device="cpu")
    assert rc == 0
    assert [ln.split(":")[0] for ln in printed.splitlines()] == \
        ["aud_filt", "vid_filt"]
    assert sorted(os.listdir(tmp_path)) == ["vf_in.iyuv", "vf_out.iyuv"]


def test_quickstart_runs_on_the_cpu(tmp_path):
    rc, printed = _printed(quickstart.main, ["--workdir", str(tmp_path)],
                           device="cpu")
    lines = printed.splitlines()
    assert rc == 0 and len(lines) == 5, printed
    assert lines[0] == "1) preprocessed 90 frames -> model-ready tensors"
    assert lines[1].startswith("2) smart-extracted 3 frames")
    assert "rc=0" in lines[2]
    assert "alpha=True, thumb=True" in lines[4]
    assert sorted(os.listdir(tmp_path)) == [
        "quickstart.heic", "quickstart.mp4", "quickstart_lr.png",
        "quickstart_out.mp4", "quickstart_sr2x.png"]


def test_stills_and_torch_runs_on_the_cpu(tmp_path):
    rc, printed = _printed(stills_and_torch.main,
                           ["--workdir", str(tmp_path)], device="cpu")
    _, want = _printed(jax_stills.main)
    assert rc == 0
    lines = printed.splitlines()
    # the JPEG and HEIF lines are the JAX example's
    assert lines[:3] == want.splitlines()[:3], (printed, want)
    assert lines[3] == ("torch tensor: (8, 3, 224, 224) torch.float32 "
                        "on cpu")
    assert lines[4] == ("extract_to_torch: 1 batches [(2, 3, 224, 224)] "
                        "on cpu")
    assert os.listdir(tmp_path) == ["stills_clip.mp4"]


def test_stills_parts_on_a_batch():
    """The parts the chip run drives on the card, on host tensors."""
    from gmat_tpu_torch.core.frame import from_numpy_yuv420
    import numpy as np
    y, u, v = stills_and_torch.planes()
    fb = from_numpy_yuv420(np.stack([y] * 2), np.stack([u] * 2),
                           np.stack([v] * 2), device="cpu")
    rec = stills_and_torch.jpeg_part(fb, y)
    assert rec["images"] == 2 and rec["mean_err"] < 1.0
    t = stills_and_torch.tensor_part(fb)
    assert t.shape == (2, 3, 224, 224) and t.dtype == torch.float32


@pytest.mark.parametrize("main", [quickstart.main, stills_and_torch.main])
def test_examples_default_to_the_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--workdir", str(tmp_path)])
