"""The PyTorch port stands alone: no jax, no gmat_tpu, no silent CPU
fallback, no nvcc at import time."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gmat_tpu_torch import FrameBatch
from gmat_tpu_torch.core.frame import from_numpy_rgb, from_numpy_yuv420
from gmat_tpu_torch.ops import _build, ladder, rungs

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "gmat_tpu_torch"


def test_import_pulls_in_no_jax():
    # a subprocess: this test process already imported jax (conftest.py)
    code = (
        "import sys\n"
        "import gmat_tpu_torch, gmat_tpu_torch.ops.fused, "
        "gmat_tpu_torch.ops.ladder, gmat_tpu_torch.ops.rungs, "
        "gmat_tpu_torch.av.ingest, gmat_tpu_torch.av.rawvideo, "
        "gmat_tpu_torch.av.toolkit, gmat_tpu_torch.av.native, "
        "gmat_tpu_torch.utils.encparam, gmat_tpu_torch.utils.stopwatch, "
        "gmat_tpu_torch.apps.metrans, gmat_tpu_torch.ops.scene, "
        "gmat_tpu_torch.av.extractor, gmat_tpu_torch.av.torch_interop, "
        "gmat_tpu_torch.apps.extract, gmat_tpu_torch.utils.logger, "
        "gmat_tpu_torch.ops.lut, gmat_tpu_torch.ops.csc, "
        "gmat_tpu_torch.ops.geometry, gmat_tpu_torch.ops.smooth, "
        "gmat_tpu_torch.ops.enhance, gmat_tpu_torch.ops.yadif, "
        "gmat_tpu_torch.ops.bwdif, gmat_tpu_torch.filters.expr, "
        "gmat_tpu_torch.filters.builtin, gmat_tpu_torch.filters.graph, "
        "gmat_tpu_torch.filters.hdr, gmat_tpu_torch.filters.lut3d, "
        "gmat_tpu_torch.core.transfer, gmat_tpu_torch.ops.tonemap, "
        "gmat_tpu_torch.ops.blur, gmat_tpu_torch.ops.hqdn3d, "
        "gmat_tpu_torch.ops.deband, gmat_tpu_torch.ops.noise, "
        "gmat_tpu_torch.ops.vignette, gmat_tpu_torch.ops.delogo, "
        "gmat_tpu_torch.ops.blend, gmat_tpu_torch.ops.metrics, "
        "gmat_tpu_torch.filters.xfade, gmat_tpu_torch.models, "
        "gmat_tpu_torch.models.sr, gmat_tpu_torch.models.denoise, "
        "gmat_tpu_torch.models.pose, gmat_tpu_torch.models.classify, "
        "gmat_tpu_torch.filters.infer, gmat_tpu_torch.ops.dct, "
        "gmat_tpu_torch.ops.overlay, gmat_tpu_torch.av.jpeg_tpu, "
        "gmat_tpu_torch.av.jpeg, gmat_tpu_torch.utils.png, "
        "gmat_tpu_torch.utils.hostpool\n"
        "bad = [m for m in sys.modules if m.startswith('jax') "
        "or m == 'gmat_tpu' or m.startswith('gmat_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\w*|gmat_tpu)(?:\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    assert not _FORBIDDEN.findall(path.read_text()), path


def _yuv(n=1, h=8, w=8):
    return (np.zeros((n, h, w), np.uint8), np.zeros((n, h // 2, w // 2),
            np.uint8), np.zeros((n, h // 2, w // 2), np.uint8))


@pytest.mark.parametrize("make", [
    lambda: from_numpy_yuv420(*_yuv()),
    lambda: from_numpy_rgb(np.zeros((1, 8, 8, 3), np.uint8)),
    lambda: FrameBatch.from_numpy(dict(zip("yuv", _yuv())), "yuv420p", 8, 8),
], ids=["from_numpy_yuv420", "from_numpy_rgb", "FrameBatch.from_numpy"])
def test_entry_points_default_to_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_kernel_wrappers_take_no_other_device():
    # a tensor that is neither on the CPU nor on CUDA must not reach a
    # plain version: the kernel path refuses it
    y, u, v = (torch.as_tensor(a).to("meta") for a in _yuv(1, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ladder.fused_ladder_i8(y, u, v, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ladder.fused_ladder(y, u, v, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rungs.fused_rungs(y, u, v, [(8, 8)])
    wire = torch.zeros((1, 24, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ladder.fused_ladder_nv12_i8(wire, 8, 8)


def test_find_nvcc(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(fake)
    monkeypatch.delenv("CUDA_HOME")
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_key_covers_sources_and_flags():
    assert [p.name for p in _build.SOURCES] == ["ladder.cu", "rungs.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert re.fullmatch(r"[0-9a-f]{16}", _build._digest())


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
