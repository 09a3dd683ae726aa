#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py          # from the repo root; needs one CUDA device

Builds the kernels (gmat_tpu_torch/csrc/ladder.cu and rungs.cu) with
nvcc, runs the port's main paths at full size -- `preprocess_nchw` on a
64 x 1080p yuv420p batch -> (64, 3, 224, 224) f32; the wire-format lane,
the same batch as NV12 and a 10-bit one as P010 -> the same output; the
filter graph on a 32 x 1080p batch; in-graph inference, 32 x 1080p ->
`preprocess_nchw` -> 224^2 -> the bundled ESPCN x2 -> 448^2 and the other
models through FilterGraph; and the ABR ladder: a 96-frame 1080p
Y4M file -> `decode_stream` -> `metrans.ladder_step` -> rung planes on
the host, whose batches are also scene-scored, the same file through the
filtered ABR path (common graph -> ladder -> rung graphs), a 10-bit
PQ file through the HDR10 -> SDR chain as the common graph, a
telecined file through inverse telecine as the common graph, and its
first batch through a DnCNN as the common graph and through the JPEG
still codec; the whole file through the gmat CLI as a user runs it; the
main path sharded over device meshes and across processes, a
shared-memory ring from a producer process, the gmat-perf harness, the
audio filter chain, the scaling-shape tool, the stills example and both
trainers at full width -- and holds every kernel against its plain
PyTorch version on the card:

  device           card name, compute capability, power limit, kernel build
  main_path        K1 (ladder_i8) through preprocess_nchw, quality gate vs
                   the exact path, a crop + smooth + flip case
  infer_pipeline   BASELINE config #4: 32 x 1080p -> preprocess_nchw (one
                   ladder_i8 launch) -> 224^2 -> InferFilter("sr2x"), the
                   bundled espcn_x2 -> 448^2, in bf16 and fp32: fp32 within
                   rtol 1e-4 / atol 1e-5 of the CPU on 4 frames, bf16 within
                   the JAX bf16 bound (8 LSB max, 1 mean) of fp32; ladder,
                   model and chain ms, frames/s, counted FLOPs and their
                   share of the card's peak; bf16 within one bf16 step
                   (rtol 2^-7, atol 2^-8) of the CPU's bf16 on 4 frames
  infer_models     sr2x h128, sr3x, classify (224^2), pose (120^2), luma
                   sr2x (540x960), luma and 3-channel DnCNN (1080p) through
                   FilterGraph, bf16 and fp32, against the CPU on 2 frames
                   (the 1080p ones cut to 544x960): fp32 within rtol 1e-4,
                   bf16 within one bf16 step (1 LSB on u8 planes) of the
                   CPU's bf16; timed on 32 frames
  ladder_bf16      K2 (ladder_bf16): use_kernel="bf16", yuv420p10, yuv444p
  ladder_wide      K3 (ladder_i8 at 8K) and a 5760x3240 frame
  ladder_ragged    ladder_i8 and ladder_bf16 on 4 x 998x562 -> 225x223: no
                   source or output width a multiple of 4 or of the tile
  wire_lane        K6 (ladder_nv12), K7 (ladder_nv12_i8), K8 (ladder_p010)
                   through the wire-format entry points, each against its
                   plain version and its planar twin; K7 on 8 x 8K NV12
  wire_ragged      the wire kernels on 4 x 998x562 NV12 / P010 -> 225x223
                   (499 U,V pairs a row): K6 bilinear and bicubic, K7, K8
  filter_graph     every ported filter (filters/builtin, filters/hdr)
                   through FilterGraph on 32 x 1080p (or its rgb24, rgba
                   or linear-light conversion): each pure filter alone and
                   the long FILTER_CHAIN, then the stream and keep-mask
                   filters (yadif ... thumbnail, hue, hqdn3d, deband,
                   noise, vignette, FILTER_CHAIN_2) on 3 batches of 4
                   frames with flush; outputs on the card, held against
                   the CPU run on 4 frames (0 LSB, 1 for float math,
                   resamplers and conversions), ms per 32 x 1080p batch;
                   then a 10-bit leg (12 x 960x544 yuv420p10: u16 planes
                   on the card); the temporal and structural filters
                   (separatefields ... psnr/ssim, overlay;
                   STREAM_FILTERS_3) the
                   same way, some checked on a cut, each timed at 32 x
                   1080p (the per-pixel expressions on a cut); every
                   blend mode on 16-bit planes against the CPU
  abr_ladder       K4 through the ABR path on the 1080p ladder 720p/540p/360p,
                   where the int8 tap gate picks the bf16 rows (rungs_bf16);
                   rung files written and read back as Y4M
  abr_ladder_i8    the same path on 720p/360p, where it picks int8 (rungs_i8)
  abr_filtered     the filtered ABR path (`metrans.filtered_step`): common
                   yadif, K4-int8 on 720p/360p, eq + lutyuv + unsharp per
                   rung; one rungs_i8 launch per batch (flush included),
                   the first batch against the CPU run (0 LSB), source
                   frames/s beside abr_ladder_i8's
  abr_hdr          a 64-frame 1080p 10-bit PQ Y4M through decode_stream
                   and `metrans.filtered_step` with the HDR10 -> SDR chain
                   as the common graph, K4-int8 on 720p/360p: one rungs_i8
                   launch per batch, 64 frames per rung, the common graph
                   within 1 LSB of the CPU on 4 frames, the first batch's
                   rungs 0 LSB from the plain version on the card's own
                   common output; source frames/s beside abr_ladder_i8's
  abr_ivtc         the ABR source's first 64 frames through telecine (3:2
                   pulldown) into an 80-frame 30/1 Y4M, back through
                   `metrans.filtered_step` with detelecine and a fade in
                   as the common graph, K4-int8 on 720p/360p: one
                   rungs_i8 launch per non-empty batch, 24/1 and the
                   frame counts of the CPU run, the post-fade frames 0
                   LSB from the progressive source, the first batch 0
                   LSB from the CPU, its rungs 0 LSB from the plain
                   version; source frames/s beside abr_ladder_i8's
  abr_enhance      the ABR source's first batch through the bundled
                   DnCNN (bf16) as the common graph, K4-int8 on 720p/360p:
                   one rungs_i8 launch, the common graph within the bf16
                   bound of the CPU on a 2 x 544x960 cut, the rungs 0 LSB
                   from the plain version; source frames/s
  jpeg_still       BASELINE config #5: the ABR source's first batch through
                   jpeg_tpu.encode_batch at q=90 (baseline, optimize,
                   progressive, restart_mcus=8) and decode_batch: the
                   coefficients, bytes and decoded planes against the CPU
                   on 4 frames, the smooth round trip < 3 LSB mean; the
                   coefficient and pixel programs' ms against their byte
                   bound, host entropy ms, images/s
  rungs_bf16       bf16 rows forced on the first batch, both ladders
  rungs_i8_forced  int8 rows forced on the 720p/540p/360p ladder
  rungs_wide       K5 (rungs_i8 at 8 x 4K) and a nearest-neighbour ladder
  rungs_ragged     both rung kernels on 4 x 562x1000 -> 640x360 / 426x240:
                   widths that are not a multiple of 16 or of the tile
  scene            scene_scores on the ABR source's batches on the card,
                   last frame and mafd carried across batches, against the
                   same calls on CPU copies; ms per 32 x 1080p batch
  metrans_session  run_session with libx264 rungs and abr_filtered's
                   filters, where libavcodec exists
  smart_decode     FrameExtractor, FrameSelect and extract_to_torch on a
                   small libx264 clip, where libavcodec exists
  cli              the gmat CLI (apps/cli.main, device="cuda") on the ABR
                   source: scale + unsharp -> 720p Y4M, the tensorrt doc
                   pipeline 540p -> sr2x -> 1080p Y4M in bf16 and fp32,
                   the user guide's nvcv pipeline -> 8 PNG stills, 224^2
                   rgbpf32 -> null under a torch.profiler trace: frames in
                   and out, every graph batch on the card, frames/s, each
                   against its CPU run on 4 frames (1 LSB; bf16 one step;
                   the stills' bytes where their planes are equal), CUDA
                   kernel events in the trace
  stills_av        overlay=path= with a .jpg (av/jpeg.py), gmat-extract's
                   JPEG output, a HEIF round trip of a card-made 1080p
                   frame and the CLI's .heic and .jpg sinks on the card
                   against the CPU, where libavcodec exists
  scale_out        parallel/: ShardedPipeline(preprocess_nchw) on the 64 x
                   1080p batch over a (1, 1) and a (2, 2) mesh of cuda:0,
                   0 LSB from the unsharded call, one ladder_i8 a data
                   row; over (2, 2) the 10-bit batch (ladder_bf16) and
                   the ABR rung ladders (rungs_i8, rungs_bf16), 0 LSB;
                   tensor-parallel ESPCN x2 (fp32) on 32 x 224^2 over
                   (2, 2) within TP_ATOL of the unsharded model; the
                   distributed self-test (ladder at 1080p, one dp x tp
                   train step) in a group of one on NCCL and as two
                   processes on gloo, equal losses
  shm_ring         a producer process writes 96 x 1080p I420 frames into a
                   ShmRing; batches go through pinned buffers to the card
                   and preprocess_nchw (one ladder_i8 a batch); every frame
                   bit-equal (checked on the card), frames/s, the
                   producer's put span; the decode workers where
                   libavcodec exists
  perf             gmat-perf (apps/perf.main, device="cuda"): ladder,
                   ladder10, rungs, infer, graph, sustained, jpeg at its
                   1080p defaults and pipeline on the ABR source, each
                   case's JSON line and the launches counted while it ran
                   (each case's kernels launched); the libav* cases where
                   libavcodec exists
  audio            AudioFilterStream over 10 s of seeded 48 kHz stereo
                   PCM: atempo, volume, afade, aecho, loudnorm, dynaudnorm
                   (loudnorm between two aresample stages where
                   libswresample is missing), samples/s and a checksum
  scaling          tools/scaling_shape (`python -m
                   gmat_tpu_torch.tools.scaling_shape`) on the card:
                   ShardedPipeline of the separate-op ladder, 16 x 360p ->
                   224^2, over 1, 2, 4 and 8 shards of cuda:0; per-shard
                   flops and bytes 1/n within 1.35x, wall times
  examples         examples/stills_and_torch on the card: the JPEG part
                   and the tensor part (one ladder_i8 launch) against
                   their CPU runs; HEIF and extract_to_torch where
                   libavcodec exists
  train            both trainers (tools/train_sr, tools/train_denoise)
                   through their `main` at full width under PyTorch's
                   default backend flags: ESPCN x2 hidden 64, batch 32,
                   96^2 HR, 16,000 steps; DnCNN 3 channels, batch 32, 64^2,
                   2,000 steps; 512 patches each: each past its own gate,
                   its checkpoint through InferFilter on the card against
                   the CPU; the first 20 steps from the same init and
                   batches on the card and the CPU (step-1 gradients
                   within 1e-4 of each tensor's largest magnitude, losses
                   within rtol 1e-4); ms per step (CUDA events), steps/s,
                   held-out PSNR, wall s
  timing           CUDA-event medians: kernel, plain version, library call,
                   separate-op path; for the ladder, wire and rung kernels
                   also the wrapper's device and host time and the ptxas
                   registers and spills of the instance timed; for the rung
                   kernels GB/s and tiles

Each phase prints one JSON line, and `elapsed` the script's seconds.
Then come the card's name and power limit (nvidia-smi), the kernels
line, and last
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result line.  Launch counters are zeroed
just before each phase drives its path and read just after; launches made
to compare or time a kernel are not counted.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
N, H, W, OUT = 64, 1080, 1920, 224
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, published
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
LSB_I8, LSB_BF16, LSB_GATE = 0.01, 1.0, 1.5   # u8 LSBs
JAX = "gmat_tpu/ops/pallas_kernels.py"
# ABR ladder: perf.py:319's ladder for a 1080p source, and its 720p/360p
# subset (every row tap quantizes within the int8 gate); 4K as in
# test_pallas.py:390-394
ABR_FRAMES, ABR_BATCH = 96, 32
LADDER_1080 = ((1280, 720), (960, 540), (640, 360))
LADDER_1080_I8 = ((1280, 720), (640, 360))
LADDER_4K = ((1920, 1080), (1280, 720), (960, 540))
# a ragged rung geometry: even, not a multiple of 16 or of the tile; its
# bound against the exact resize is 3 for both row stages (at 562 -> 360
# and 281 -> 180 bf16 taps sit further from the exact weights than at the
# JAX tests' ratios, and the plain bf16 version is 2 LSB off)
RAGGED_SRC, RAGGED_SIZES = (4, 562, 1000), ((640, 360), (426, 240))
LSB_RAGGED_EXACT = 3
# a ragged planar ladder: 998x562 (chroma 499x281) -> 225x223 (W x H)
RAGGED_LADDER_SRC, RAGGED_LADDER_OUT = (4, 562, 998), (223, 225)
# rung kernels (u8 outputs, in LSBs): against the plain version 0 (the
# kernel sums in the plain version's order), against the exact resize 3
# for int8 rows and 1 for bf16 (test_pallas.py:268-294)
LSB_RUNG_PLAIN = 0
LSB_RUNG_EXACT = {"i8": 3, "bf16": 1}
# wire kernels against their planar twins: the JAX package's bounds
# (test_pallas.py:91-101, 206-220, 308-326)
LSB_TWIN = 1.0
# scene scores on the card against the CPU: f32 sums in another order
SCENE_RTOL = 1e-5
# the filter graph: a 1080p batch through each filter of the GPU layer
# alone and through one long chain, each against the port's own CPU run
# on the first FILTER_CPU_FRAMES frames; (spec, bound in u8 LSBs): 0 for
# integer filters, 1 for the f32 resamplers and conversions
FILTER_BATCH, FILTER_CPU_FRAMES, FILTER_CUT = 32, 4, 6
FILTER_CHAIN = ("crop=1920:1072:0:4,smooth=type=median:kw=5:kh=5,"
                "rotate=angle=5,hflip,transpose=1,pad=iw+16:ih+16:8:8,"
                "scale=1280:-2,eq=contrast=1.2,lutyuv=y=gammaval(0.9),"
                "unsharp=5:5:0.8,format=rgbpf32le")
# (spec, bound[, source]): the source batch is the 1080p yuv420p one unless
# named -- "rgb24", "rgba" (both converted from it on the card) or
# "linear" (its rgbpf32 conversion times 4: linear light above 1, the
# tonemap filter's input); lut3d/lut1d read the seeded .cube files
# (LUT3D_FILE, LUT1D_FILE) the phase writes to its temp dir.  Bounds: 0
# for integer filters, 1 for float math (its exp/pow/cos/log may differ
# by an ulp between the card and the CPU) and for the resamplers and
# conversions
LUT3D_FILE, LUT1D_FILE = "grade.cube", "curve.cube"
PURE_FILTERS = (
    ("crop=1920:1072:0:4", 0), ("crop_nvcv=1280:720", 0),
    ("rotate=angle=5", 1), ("rotate_nvcv=30:cubic", 1),
    ("rotate=angle=-12:interp=nearest", 1), ("pad=iw+16:ih+16:8:8", 0),
    ("pad=2048:1152:-1:-1:0x3366CC", 0), ("eq=contrast=1.2:brightness=0.05",
                                          0),
    ("lut=c0=negval", 0), ("lutyuv=y=gammaval(0.9):u=val:v=val", 0),
    ("format=rgb24,lutrgb=r=negval", 1), ("unsharp=5:5:0.8", 0),
    ("flip=-1", 0), ("hflip", 0), ("vflip", 0), ("transpose=1", 0),
    ("transpose_npp=dir=cclock", 0), ("smooth=type=median:kw=5:kh=5", 0),
    ("smooth=gaussian:5:5:reflect101", 1), ("scale=1280:-2", 1),
    ("scale_cuda=640:360:bicubic", 1), ("scale_npp=960:540:area", 1),
    ("format=rgbpf32le", 1), ("format_cuda=yuv444p", 1), ("null", 0),
    ("hwupload_cuda", 0), ("chromakey=0x00FF00:0.2:0.1", 1),
    (FILTER_CHAIN, 1),
    # filters/builtin.py part 2 and filters/hdr.py
    ("negate", 0), ("swapuv", 0), ("extractplanes=u", 0),
    ("monochrome=cb=0.3:cr=-0.2:size=2:high=0.3", 1),
    ("drawbox=x=160:y=90:w=640:h=360:color=red@0.5:t=8", 0),
    ("boxblur=2:1", 0), ("gblur=sigma=1.5", 1), ("sharpen_npp", 0),
    ("delogo=x=1600:y=40:w=240:h=120", 0),
    ("zscale=tin=bt709:pin=bt709:p=bt2020:t=linear:npl=100", 1),
    ("colorchannelmixer=0.5:0.3:0.2:0:0.1:0.8:0.1", 0, "rgb24"),
    ("colorbalance=rs=0.3:gm=-0.2:bh=0.4", 1, "rgb24"),
    ("colorbalance=rs=0.3:gm=-0.2:bh=0.4:pl=1", 1, "rgb24"),
    ("curves=preset=vintage", 0, "rgb24"),
    ("colortemperature=4000:0.8:0.5", 1, "rgb24"),
    (f"lut3d={LUT3D_FILE}:tetrahedral", 1, "rgb24"),
    (f"lut1d={LUT1D_FILE}:cubic", 1, "rgb24"),
    ("drawbox=100:100:400:300:blue@0.7:fill", 0, "rgb24"),
    ("alphaextract", 0, "rgba"),
    ("exposure=1:0.05", 1, "linear"),
    ("tonemap=hable:desat=0", 1, "linear"),
    ("tonemap=tonemap=mobius:param=0.3:desat=2", 1, "linear"),
    # filters/builtin.py part 3: il is a pure row gather
    ("il=l=d:c=d", 0), ("il=luma_mode=interleave:chroma_mode=i:"
                        "luma_swap=1", 0))
# the stream and keep-mask filters: 3 batches of FILTER_CPU_FRAMES frames
# (a scene cut at FILTER_CUT) through process and flush, card and CPU
# the long chain of the denoise and grain filters (stream filters among
# them, so it runs here)
FILTER_CHAIN_2 = ("hqdn3d,deband,format=rgb24,colorbalance=rs=0.1,"
                  "curves=preset=vintage,format=yuv420p,gblur=sigma=1.5,"
                  "vignette,noise=alls=8:allf=t")
STREAM_FILTERS = ("yadif", "yadif=1", "bwdif", "bwdif=send_frame",
                  r"select=gt(scene\,0.3)", "fps=15",
                  "trim=start_frame=2:end_frame=9", "setpts=PTS-STARTPTS",
                  "thumbnail=4",
                  "hue=h=30:s=1.2:b=0.5", "hqdn3d", "deband",
                  "noise=alls=20:allf=t", "vignette", FILTER_CHAIN_2)
# checked on a LEG_CUT cut of the batch (its CPU reference at 1080p would
# cost ~20 s of the script), timed at 32 x 1080p
STREAM_ON_CUT = (FILTER_CHAIN_2,)
# timed by one call, without a warm-up (the check before it ran the same
# path): each call is a host loop of thousands of launches (the IIR
# scans) or of LFG draws
FILTER_SLOW = ("gblur=sigma=1.5", "hqdn3d", "noise=alls=20:allf=t",
               FILTER_CHAIN_2)
# the 10-bit leg (yuv420p10, u16 planes on the card, LEG_10BIT = (h, w)):
# checked, not timed
LEG_10BIT = LEG_CUT = (544, 960)
PURE_FILTERS_10BIT = (
    ("crop=960:536:0:4", 0), ("rotate=angle=5", 1),
    ("pad=iw+16:ih+16:8:8:red", 0), ("lutyuv=y=negval:u=val*0.9", 0),
    ("unsharp=5:5:0.8:5:5:0.4", 0), ("hflip", 0), ("transpose=1", 0),
    ("smooth=type=median:kw=3:kh=3", 0), ("scale=640:-2", 1),
    ("format=p010", 0), ("format=rgb48", 1),
    ("negate", 0), ("swapuv", 0), ("extractplanes=v", 0),
    ("monochrome=0.2:0.1", 1), ("boxblur=2:1", 0), ("gblur=sigma=1.5", 1),
    ("format=rgb48,colorchannelmixer=0.9:0.1", 1),
    ("format=rgb48,curves=preset=vintage", 1),
    ("zscale=tin=smpte2084:min=bt2020nc:pin=bt2020:t=linear:npl=100", 1),
    ("il=l=d:c=d", 0))
STREAM_FILTERS_10BIT = ("yadif=1", "bwdif=send_frame",
                        r"select=gt(scene\,0.3)", "thumbnail=4",
                        r"select=not(mod(n\,2)),yadif",
                        "hqdn3d", "deband", "hue=h=30:b=0.5")
# the temporal and structural filters (filters/builtin part 3): (spec,
# bound in u8 LSBs, where it is checked).  "full": the 3 x
# FILTER_CPU_FRAMES frames of the 1080p batch; "cut": the same frames cut
# to LEG_CUT (their CPU reference at 1080p would cost seconds of the
# script: zoompan's per-output gathers, the blends' int32 chains, fade,
# framerate's blends, the transitions, the metrics' f32 reductions);
# "expr": the same frames cut to EXPR_CUT, for the expressions evaluated
# per pixel on the host (vf_blend's cN_expr, xfade's custom), which are
# timed on that cut too (EXPR_BATCH x EXPR_CUT).  Everything else is
# timed at FILTER_BATCH x 1080p as one process + flush of a fresh graph.
# "{b}" is the second input (blend's bottom, xfade's second video, the
# metrics' reference): a Y4M of SECOND_FRAMES frames at the batch's size
# that the phase writes with write_y4m_source and seed SEED + 13; "{tmp}"
# its temp dir, where "{dev}" tells the card's stats file from the
# CPU's.  Bounds: 0 for integer
# filters, 1 for float math and resampling (zoompan's bicubic gathers,
# blend's interpolate); the psnr/ssim values within METRIC_RTOL of the
# CPU's
EXPR_CUT, EXPR_BATCH, SECOND_FRAMES, METRIC_RTOL = (36, 64), 8, 36, 1e-5
# "{o}": overlay's second input, an OVERLAY_FRAMES-frame Y4M of
# OVERLAY_SIZE (h, w) from write_y4m_source with seed SEED + 19
OVERLAY_FRAMES, OVERLAY_SIZE = 6, (270, 480)
STREAM_FILTERS_3 = (
    ("separatefields", 0, "full"), ("weave=bottom", 0, "full"),
    ("doubleweave", 0, "full"),
    ("telecine=first_field=top:pattern=23", 0, "full"),
    ("detelecine=first_field=top:pattern=23", 0, "full"),
    ("shuffleframes=2|0|1|-1", 0, "full"), ("reverse", 0, "full"),
    ("tpad=start=2:stop=3:color=red", 0, "full"),
    ("tpad=2:2:clone:clone", 0, "full"),
    ("loop=loop=2:size=3:start=1", 0, "full"),
    # blends across the scene cut at FILTER_CUT, which its score gates
    ("framerate=fps=50:scene=8.2", 0, "cut"),
    ("fade=in:0:5", 0, "cut"), ("fade=t=out:s=2:n=6", 0, "cut"),
    ("zoompan=z=min(zoom+0.1\\,1.5):x=iw/2-(iw/zoom/2):"
     "y=ih/2-(ih/zoom/2):d=3:s=1280x720", 1, "cut"),
    ("blend=all_mode=multiply:video={b}", 0, "cut"),
    ("blend=c0_mode=heat:c1_mode=divide:c2_mode=screen:video={b}", 0,
     "cut"),
    ("blend=all_mode=harmonic:video={b}", 0, "cut"),
    ("blend=all_mode=interpolate:all_opacity=0.5:video={b}", 1, "cut"),
    ("tblend=all_mode=difference", 0, "cut"),
    ("tblend=c0_mode=exclusion:c1_mode=heat:c2_mode=divide", 0, "cut"),
    ("tblend=c0_expr=(A+B)/2-X*Y/64", 0, "expr"),
    ("format=yuv444p,xfade=transition=wipeleft:duration=0.1:offset=0.05:"
     "video={b}", 0, "cut"),
    ("format=yuv444p,xfade=transition=fade:duration=0.2:offset=0:"
     "video={b}", 0, "cut"),
    ("format=yuv444p,xfade=transition=custom:duration=0.1:offset=0:"
     "expr=A*P+B*(1-P):video={b}", 0, "expr"),
    ("psnr=video={b}:stats_file={tmp}/{dev}_psnr.log", 0, "cut"),
    ("ssim=video={b}:stats_file={tmp}/{dev}_ssim.log", 0, "cut"),
    # overlay: a position expression sliding in from a negative odd x,
    # and eof_action=pass once the OVERLAY_FRAMES-frame clip ends
    ("overlay=video={o}:x=-301+n*37:y=main_h-overlay_h-n*5:"
     "eof_action=pass", 0, "full"),
    ("overlay_cuda=video={o}:x=100:y=50", 0, "full"))
# timed by one call, without a warm-up: host loops over frames (zoompan's
# per-output taps, xfade's numpy transitions, every second input's
# decode and upload)
FILTER_SLOW_3 = ("zoompan", "xfade", "video=")
# the part-3 filters that take 16-bit planes, on the 10-bit leg; the
# framerate gate (8-bit planes only, as in the JAX filter) must raise
STREAM_FILTERS_3_10BIT = (
    "separatefields", "weave", "doubleweave", "telecine", "detelecine",
    "fade=in:0:5", "tblend=c0_mode=exclusion:c1_mode=heat:c2_mode=divide",
    "blend=all_mode=screen:video={b}")
# every blend mode name on 16-bit planes (a grid over the whole code
# range, where the C products wrap int32), card against CPU: 0 LSB
BLEND16_GRID = 513
# the filtered ABR path: perf.py:712's ladder (LADDER_1080_I8) between a
# common yadif and perf.py:722-723's three rung filters
ABR_COMMON = "yadif=0:-1:0"
ABR_RUNG_FILTERS = ("eq=contrast=1.2:brightness=0.05,"
                    "lutyuv=y=gammaval(0.9):u=val:v=val,unsharp=5:5:0.8")
# the HDR10 -> SDR ABR path: a 10-bit PQ source (BT.2020, limited range)
# through tests/test_tonemap.py:243's chain with explicit input tags (the
# metrans graphs get no stream meta) as the common graph, then the int8
# ladder (LADDER_1080_I8); the card's common output is held to 1 LSB of
# the CPU's on its first ABR_HDR_CPU_FRAMES frames (f32 pow/exp/log), the
# rungs to 0 LSB of the rung kernel's plain version on that output
ABR_HDR_FRAMES, ABR_HDR_CPU_FRAMES, LSB_HDR = 64, 4, 1
ABR_HDR_COMMON = (
    "zscale=tin=smpte2084:min=bt2020nc:pin=bt2020:t=linear:npl=100,"
    "format=gbrpf32le,zscale=p=bt709,tonemap=tonemap=hable:desat=0,"
    "zscale=t=bt709:m=bt709:r=tv,format=yuv420p")
# the inverse-telecine ABR path: the ABR source's first ABR_IVTC_FRAMES
# frames through the port's telecine (3:2 pulldown, 24 -> 30 frames a
# second's worth) into a 30/1 Y4M, then back through detelecine with a
# fade in as the common graph, onto the int8 ladder (LADDER_1080_I8);
# frames from ABR_IVTC_FADE_END on leave the fade untouched and must equal
# the progressive source
ABR_IVTC_FRAMES, ABR_IVTC_FADE_END = 64, 13
ABR_IVTC_TELECINE = "telecine=first_field=top:pattern=23"
ABR_IVTC_COMMON = "detelecine=first_field=top:pattern=23,fade=in:0:12"
# in-graph inference (BASELINE config #4, perf.py:357-394): a 32 x 1080p
# yuv420p batch -> preprocess_nchw (K1) -> 224^2 -> the bundled ESPCN x2
# -> 448^2, in bf16 and fp32.  fp32 on the card within INFER_RTOL /
# INFER_ATOL of the port's CPU run on INFER_CPU_FRAMES frames (f32 sums in
# another order); bf16 within the JAX package's bf16-vs-fp32 bound
# (tests/test_filters.py:135-144): BF16_MAX_LSB max and BF16_MEAN_LSB mean
# u8 LSBs from fp32
INFER_BATCH, INFER_CPU_FRAMES, INFER_RTOL, INFER_ATOL = 32, 4, 1e-4, 1e-5
BF16_MAX_LSB, BF16_MEAN_LSB = 8.0, 1.0
# the card's bf16 lane against the CPU's bf16 lane on the same weights: one
# bf16 step on float outputs, 1 LSB on u8 planes (two f32 sum orders round
# a layer output a step apart now and then; tests/test_torch_models.py
# holds the port to JAX on the CPU with the same bound)
BF16_STEP_RTOL, BF16_STEP_ATOL, BF16_STEP_LSB = 2.0 ** -7, 2.0 ** -8, 1
# float32 without the tensor cores (the fp32 lane runs no TF32)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
# the other models through FilterGraph: (spec, source); each checked
# against the CPU on INFER_MODEL_CPU_FRAMES frames of its source (the
# 1080p sources cut to INFER_CUT), timed on the whole source.  The
# random-init models (luma sr2x, luma denoise, pose) draw from the port's
# generator on the host, so the card and the CPU run the same weights
INFER_MODEL_CPU_FRAMES, INFER_CUT = 2, (544, 960)
INFER_MODELS = (
    ("infer=sr2x:hidden=128", "rgb224"), ("infer=sr3x", "rgb224"),
    ("infer=sr2x:luma_only=1", "yuv540"),
    ("infer=denoise:luma_only=1", "yuv1080"),
    ("infer=denoise", "yuv1080"),
    ("infer=classify", "rgb224"), ("infer=pose", "rgb120"))
# the enhanced ABR path: the first 32 frames of the ABR source through the
# bundled 3-channel DnCNN (bf16) and back to yuv420p as the common graph,
# onto the int8 ladder; the common graph held to the CPU on
# ABR_ENHANCE_CPU_FRAMES frames cut to INFER_CUT
ABR_ENHANCE_COMMON = "infer=denoise,format=yuv420p"
ABR_ENHANCE_CPU_FRAMES = 2
# the JPEG still lane (BASELINE config #5, the nvjpeg analog): the first
# 32 frames of the ABR source at JPEG_Q in each JPEG_VARIANTS, the CPU
# reference on JPEG_CPU_FRAMES of them: coefficients equal (a flipped
# rounding tie may move one by 1: at most JPEG_COEF_SHARE of them), bytes
# equal wherever the coefficients are, decoded planes within 1 LSB.  The
# round trip is held to the JAX bound (mean < JPEG_RT_MEAN LSB,
# tests/test_jpeg_tpu.py test_jpeg_self_roundtrip) on the JAX test's kind
# of content, smooth gradients with little noise (filter_frames); the
# source's +-24 uniform noise is reported, not held to it
JPEG_Q, JPEG_CPU_FRAMES, JPEG_COEF_SHARE, JPEG_RT_MEAN = 90, 4, 1e-5, 3.0
JPEG_VARIANTS = {"baseline": {}, "optimize": {"optimize": True},
                 "progressive": {"progressive": True},
                 "restart_8": {"restart_mcus": 8}}
# the gmat CLI (apps/cli.main) on the ABR source, device="cuda": (name,
# arguments) of each run, the output named by the run; each is run again
# on the CPU on CLI_CPU_FRAMES frames, batches of that size, and the
# card's first frames held to it: scale + unsharp, the user guide's stills
# and sr2x in fp32 to CLI_LSB, sr2x in bf16 to BF16_STEP_LSB.  The stills
# are PNG: the .jpg sink (av/jpeg.py) and .heic need libav*, and
# stills_av runs them where it exists
CLI_SR = ("scale_npp=960:540,format_cuda=rgbpf32le:255,tensorrt=sr2x{},"
          "format_cuda=yuv420p")
CLI_RUNS = (
    ("scale_unsharp", ["-vf", "scale=1280:720,unsharp", "-o", "out.y4m"]),
    ("sr2x_bf16", ["-vf", CLI_SR.format(""), "-o", "sr.y4m"]),
    ("sr2x_fp32", ["-vf", CLI_SR.format(":precision=fp32"), "-o", "sr.y4m"]),
    ("user_guide", ["-vf", "format=rgb24,hwupload_cuda,crop_nvcv=640:480,"
                    "flip_nvcv=0,smooth_nvcv=gaussian", "-o", "still_%d.png",
                    "-frames", "8"]),
    ("null_224", ["-vf", "scale=224:224,format=rgbpf32le", "-o", "null",
                  "-stats"]))
CLI_CPU_FRAMES, CLI_LSB = 4, 1
# stills_av's HEIF leg: an integer graph (card and CPU planes equal) and
# the CLI's default crf
STILLS_HEIF_GRAPH, STILLS_HEIF_CRF = "unsharp", 22.0
AV_LIBS = ("avformat", "avcodec", "avutil", "swscale", "swresample")
# smart decode clip: test_extractor.py's, 60 frames with a cut at 30
SMART_SIZE, SMART_FRAMES, SMART_CUT = (320, 240), 60, 30


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def lsb(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference in u8 LSBs (outputs are normalized to [0, 1])."""
    return float((a - b).abs().max()) * 255.0


def zero_counts(ladder) -> None:
    for k in ladder.LAUNCHES:
        ladder.LAUNCHES[k] = 0
    ladder.LAUNCHES_BY_SOURCE.clear()


# The K3 and K5 rows: the port's ladder_i8 and rungs_i8 kernels take
# every source size, so these rows count the launches (from the wrappers'
# LAUNCHES_BY_SOURCE) on the sources the TPU sends to its chunked kernels:
# frames of more than 24 MiB of samples (`_pick_w_chunks`,
# pallas_kernels.py:1346), and 4K or larger sources (`rungs_fit_vmem`,
# pallas_kernels.py:1138, refuses a 4K rung ladder).
K3_ROW, K5_ROW = "ladder_i8 (K3 at 8K)", "rungs_i8 (K5 at 4K)"
K3_FRAME_BYTES = 24 * 1024 * 1024


def wide_counts_of(module) -> dict:
    """{row name: launches} of the K3 or K5 row since `zero_counts`."""
    if "ladder_i8" in module.LAUNCHES:
        return {K3_ROW: sum(n for (k, h, w), n
                            in module.LAUNCHES_BY_SOURCE.items()
                            if k == "ladder_i8"
                            and h * w * 3 // 2 > K3_FRAME_BYTES)}
    return {K5_ROW: sum(n for (k, h, w), n
                        in module.LAUNCHES_BY_SOURCE.items()
                        if k == "rungs_i8" and h * w >= 3840 * 2160)}


def want_counts(module, **launched) -> dict:
    """Every counter of `module.LAUNCHES` at 0 but those named."""
    return {k: launched.get(k, 0) for k in module.LAUNCHES}


class Planes:
    """Random planes made on the card from one seeded generator."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def __call__(self, n, h, w, ch, cw, hi=256, dtype=torch.uint8):
        def one(shape):
            return torch.randint(0, hi, shape, generator=self.gen,
                                 device="cuda", dtype=torch.int32).to(dtype)
        return one((n, h, w)), one((n, ch, cw)), one((n, ch, cw))


def smooth_content(h: int, w: int):
    """bench.py's quality-gate frame: gradients, not noise."""
    sy = np.tile(np.linspace(20, 230, w, dtype=np.float32), (h, 1))
    sy = (sy + np.linspace(0, 20, h, dtype=np.float32)[:, None]).astype(np.uint8)
    su = np.tile(np.linspace(50, 200, w // 2, dtype=np.float32),
                 (h // 2, 1)).astype(np.uint8)
    sv = np.tile(np.linspace(200, 60, w // 2, dtype=np.float32),
                 (h // 2, 1)).astype(np.uint8)
    return sy[None], su[None], sv[None]


def event_ms(fn, calls: int = 10, reps: int = 7, warm: int = 2):
    """Median over `reps` of the mean device time of `calls` calls of
    fn(i) (CUDA events) after `warm` untimed calls, every run, and the
    median host time to issue a call (no synchronisation inside the
    loop)."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), times, statistics.median(host)


def launcher(entry: str, args, result, label: str):
    """Launch a kernel's C entry from prebuilt arguments (no per-call host
    work), so that event time is device time.  Not counted in LAUNCHES."""
    from gmat_tpu_torch.ops import _build
    fn = getattr(_build.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = fn(ctypes.byref(args), stream)
        check(err == 0, f"{label} launch: {_build.error_string(err)}")
        return result
    return go


def raw_launcher(ladder, kind, y, u, v, geom, c):
    ops = ladder._kernel_operands(kind, geom, str(y.device))
    out = torch.empty((y.shape[0], 3, geom[4], geom[5]), device=y.device)
    return launcher(ladder._ENTRIES[(kind, y.dtype)][1],
                    ladder._ladder_args(y, u, v, out, ops, c), out, kind)


def wire_launcher(ladder, kind, wire, geom, c):
    ops = ladder._wire_kernel_operands(kind, geom, str(wire.device))
    out = torch.empty((wire.shape[0], 3, geom[2], geom[3]),
                      device=wire.device)
    return launcher(ladder._WIRE[kind].entry,
                    ladder._wire_args(kind, wire, out, ops, c), out, kind)


def operand_bytes(ops) -> int:
    """Bytes of the tensors in a dict of kernel operands, or in a list,
    tuple or dict of such (nested) containers."""
    if isinstance(ops, torch.Tensor):
        return ops.numel() * ops.element_size()
    if isinstance(ops, dict):
        ops = list(ops.values())
    if isinstance(ops, (list, tuple)):
        return sum(operand_bytes(v) for v in ops)
    return 0


def ptxas_usage(log: str) -> dict:
    """Per entry function of nvcc's -Xptxas -v log: registers, static
    shared memory and spill bytes."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                usage[name].update(spill_stores=int(m[1]),
                                   spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                sm = re.search(r"(\d+) bytes smem", line)
                usage[name].update(registers=int(m[1]),
                                   static_smem=int(sm[1]) if sm else 0)
    return usage


def kernel_ptxas(usage: dict, kernel: str, kind: str, dtype=None,
                 taps=None) -> dict:
    """ptxas usage of one kernel instance: rungs_kernel<kI8>, or
    ladder_kernel<T, kI8, kTaps> for its sample dtype and tap count."""
    tag = f"{kernel}I"
    if dtype is not None:
        tag += "h" if dtype == torch.uint8 else "t"
    tag += f"Lb{int(kind == 'i8')}E"
    if taps is not None:
        tag += f"Li{taps}E"
    found = [u for name, u in usage.items() if tag in name]
    check(len(found) == 1, f"ptxas log: {len(found)} entries for {tag}")
    return found[0]


def rung_tiling(rungs, kind, geom) -> dict:
    """The tiles the host picked for a rung geometry (per plane), the
    launch's dynamic shared memory and its tiles per frame."""
    ops = rungs._kernel_operands(kind, geom, "cuda:0")
    planes = [r[k] for r in ops for k in "yc"]
    return {"tiles": [[d["th"], d["tw"]] for d in planes],
            "dynamic_smem": rungs.launch_smem(ops),
            "tiles_per_frame": sum(d["tiles_x"] * d["tiles_y"]
                                   for d in planes)}


def sectors(addr) -> int:
    """Bytes of the distinct 32-byte sectors holding these byte addresses."""
    return np.unique(np.asarray(addr).ravel() // 32).size * 32


def finish_bound(total, ops_row, ops_col, row_kind, dense):
    """Bound of a batch that moves `total` bytes and does ops_row row-stage
    (int8 or bf16) and ops_col bf16 column-stage operations."""
    row_peak = PEAK_OPS["int8"] if row_kind == "i8" else PEAK_OPS["bf16"]
    t_bytes = total / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_row / row_peak + ops_col / PEAK_OPS["bf16"]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(total), "ops": int(ops_row + ops_col),
            "dense_bytes": int(dense)}


def bound(ladder, kind, geom, n, itemsize):
    """Least time for the work this geometry needs on an H100 SXM: bytes of
    the 32-byte sectors holding input samples with a nonzero weight (each
    read once), the band operands and the f32 output, over the memory
    rate; nonzero multiply-adds over the peak rate for their type."""
    h, w, ch, cw, oh, ow = geom[:6]
    m = ladder._ladder_matrices(kind, geom)
    bytes_in = ops_row = ops_col = 0
    for ah, aw, pw, planes in ((m["ahy"], m["awy"], w, 1),
                               (m["ahc"], m["awc"], cw, 2)):
        rows = np.flatnonzero((ah != 0).any(axis=0))
        cols = np.flatnonzero((aw != 0).any(axis=1))
        bytes_in += planes * sectors(rows[:, None] * (pw * itemsize)
                                     + cols[None, :] * itemsize)
        ops_row += planes * 2 * int((ah != 0).sum()) * cols.size
        ops_col += planes * 2 * int((aw != 0).sum()) * oh
    out_bytes = n * 3 * oh * ow * 4
    total = (n * bytes_in + operand_bytes(
        ladder._kernel_operands(kind, geom, "cuda:0")) + out_bytes)
    dense = n * (h * w + 2 * ch * cw) * itemsize + out_bytes
    return finish_bound(total, n * ops_row, n * ops_col, kind, dense)


def wire_bound(ladder, kind, geom, n, itemsize):
    """bound() for a wire kernel: the sectors are those of the wire layout
    (luma rows, then U,V rows of w samples, U at even and V at odd
    samples), so interleaved U,V touches the sectors that planar U plus V
    would; the row stage of U and V counts twice, as in bound()."""
    h, w, oh, ow = geom[:4]
    m = ladder._wire_matrices(kind, geom)
    pitch = w * itemsize
    bytes_in = ops_row = ops_col = 0
    for ah, aw, first, step, planes in ((m["ahy"], m["awy"], 0, 1, 1),
                                        (m["ahc"], m["awc"], h, 2, 2)):
        rows = np.flatnonzero((ah != 0).any(axis=0))
        cols = np.flatnonzero((aw != 0).any(axis=1))
        samples = (step * cols[:, None] + np.arange(step)[None, :]).ravel()
        bytes_in += sectors((first + rows[:, None]) * pitch
                            + samples[None, :] * itemsize)
        ops_row += planes * 2 * int((ah != 0).sum()) * cols.size
        ops_col += planes * 2 * int((aw != 0).sum()) * oh
    out_bytes = n * 3 * oh * ow * 4
    total = (n * bytes_in + operand_bytes(
        ladder._wire_kernel_operands(kind, geom, "cuda:0")) + out_bytes)
    dense = n * (h * 3 // 2) * w * itemsize + out_bytes
    return finish_bound(total, n * ops_row, n * ops_col,
                        ladder._WIRE[kind].row, dense)


def write_y4m_pq(path: str, n: int, h: int, w: int, seed: int) -> None:
    """A 10-bit 4:2:0 Y4M, PQ-coded BT.2020 limited range: a luma ramp
    over codes 64-900 (highlights on the steep end of the PQ curve) that
    moves from frame to frame, chroma around 512, seeded noise."""
    from gmat_tpu_torch.av.rawvideo import Y4MWriter
    rng = np.random.default_rng(seed)
    ramp_y = np.add.outer(np.linspace(0, 120, h), np.linspace(64, 780, w))
    ramp_c = np.add.outer(np.linspace(-40, 40, h // 2),
                          np.linspace(-30, 30, w // 2))
    wr = Y4MWriter(path, w, h, (30, 1), bits=10)
    try:
        for i in range(n):
            y = ramp_y + 4 * (i % 16) + rng.integers(-12, 13, ramp_y.shape)
            u = 512 + ramp_c + (i % 8) + rng.integers(-16, 17, ramp_c.shape)
            v = 512 - ramp_c - (i % 8) + rng.integers(-16, 17, ramp_c.shape)
            wr.write(*(np.clip(p, 64, 960).astype(np.uint16)
                       for p in (y, u, v)))
    finally:
        wr.close()


def write_luts(tmp: str, seed: int) -> None:
    """The seeded .cube files of the lut3d and lut1d specs: a 17^3 grade
    near identity and a 1D curve, under `tmp`."""
    rng = np.random.default_rng(seed)
    g = np.linspace(0.0, 1.0, 17)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")   # red fastest
    lut = np.stack([r, gg, b], -1).reshape(-1, 3)
    lut = np.clip(lut ** 0.9 + rng.normal(0, 0.02, lut.shape), 0, 1)
    with open(os.path.join(tmp, LUT3D_FILE), "w") as f:
        f.write("TITLE \"seeded grade\"\nLUT_3D_SIZE 17\n")
        f.writelines(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in lut)
    curve = np.sort(np.clip(np.linspace(0, 1, 64)[:, None] ** [0.8, 1.0, 1.2]
                            + rng.normal(0, 0.01, (64, 3)), 0, 1), axis=0)
    with open(os.path.join(tmp, LUT1D_FILE), "w") as f:
        f.write("LUT_1D_SIZE 64\n")
        f.writelines(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in curve)


def write_y4m_source(path: str, n: int, h: int, w: int, seed: int) -> None:
    """A 4:2:0 u8 Y4M file: gradients plus noise, from one seed."""
    from gmat_tpu_torch.av.rawvideo import Y4MWriter
    rng = np.random.default_rng(seed)
    ramp_y = np.add.outer(np.linspace(16, 176, h), np.linspace(0, 50, w))
    ramp_c = np.add.outer(np.linspace(80, 150, h // 2),
                          np.linspace(-30, 30, w // 2))
    ramps = [r.astype(np.int16) for r in (ramp_y, ramp_c, 240 - ramp_c)]
    wr = Y4MWriter(path, w, h, (30, 1))
    try:
        for i in range(n):
            wr.write(*(np.clip(r + (i % 8) + rng.integers(
                -24, 25, r.shape, dtype=np.int16), 0, 255).astype(np.uint8)
                for r in ramps))
    finally:
        wr.close()


def rung_lsb(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def rung_errors(rungs, planes, outs, sizes, quant, method="bilinear"):
    """Largest difference, in u8 LSBs over every plane of every rung, of
    `outs` from the plain version and from the exact per-plane resize
    rounded to u8."""
    from gmat_tpu_torch.ops.resize import resize_plane
    want = rungs.fused_rungs(*planes, sizes, method=method, quant=quant,
                             reference=True)
    plain = exact = 0
    for (ow, oh), got, ref in zip(sizes, outs, want):
        for g, r, src, shape in zip(got, ref, planes,
                                    ((oh, ow), (oh // 2, ow // 2),
                                     (oh // 2, ow // 2))):
            check(tuple(g.shape) == (src.shape[0], *shape)
                  and g.dtype == torch.uint8 and g.is_contiguous(),
                  f"rung plane {tuple(g.shape)} {g.dtype}, want {shape} u8")
            plain = max(plain, rung_lsb(g, r))
            exact = max(exact, rung_lsb(g, torch.clamp(torch.round(
                resize_plane(src, *shape, method)), 0, 255)))
    return plain, exact


def abr_ladder(phase, rungs, path, sizes, tmp):
    """The ABR main path once: the Y4M file -> decode_stream ->
    metrans.ladder_step per batch -> rung planes on the host, timed from
    the first read to the last copy; then every rung against its plain
    version and the exact resize, and the rung files written as Y4M and
    read back."""
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.av.rawvideo import Y4MReader, Y4MWriter
    quant = rungs.resolve_quant(H, H // 2, sizes, "bilinear", "auto")
    zero_counts(rungs)
    t0 = time.perf_counter()
    batches = []
    for fb, _pts, valid in decode_stream(path, batch=ABR_BATCH):
        outs = metrans.ladder_step(fb, sizes)
        host = [{k: rb.planes[k].cpu() for k in "yuv"} for rb in outs]
        batches.append((fb, outs, host, int(valid)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rungs.LAUNCHES)
    frames = sum(b[3] for b in batches)
    check(frames == ABR_FRAMES, f"{phase}: {frames} frames decoded")
    want = {"rungs_i8": 0, "rungs_bf16": 0}
    want[f"rungs_{quant}"] = len(batches)
    check(counts == want, f"{phase} launches {counts}, want {want}")
    plain = exact = 0
    for fb, outs, _host, _valid in batches:
        check(all(rb.device.type == "cuda" and rb.format == "yuv420p"
                  for rb in outs), f"{phase}: rung batches off the card")
        p, e = rung_errors(rungs, tuple(fb.planes[k] for k in "yuv"),
                           [tuple(rb.planes[k] for k in "yuv")
                            for rb in outs], sizes, quant)
        plain, exact = max(plain, p), max(exact, e)
    check(plain <= LSB_RUNG_PLAIN, f"{phase} vs plain: {plain} LSB")
    check(exact <= LSB_RUNG_EXACT[quant], f"{phase} vs exact: {exact} LSB")
    read_back = {}
    for r, (ow, oh) in enumerate(sizes):
        out = os.path.join(tmp, f"{phase}_{ow}x{oh}.y4m")
        wr = Y4MWriter(out, ow, oh, (30, 1))
        for _fb, _outs, host, valid in batches:
            for j in range(valid):
                wr.write(*(host[r][k][j].numpy() for k in "yuv"))
        wr.close()
        rd = Y4MReader(out)
        got = list(rd.frames())
        rd.close()
        check(len(got) == ABR_FRAMES and all(
            f[0].shape == (oh, ow) and f[1].shape == (oh // 2, ow // 2)
            for f in got), f"{phase}: {out} read back {len(got)} frames")
        _fb, _outs, host, valid = batches[-1]
        check(np.array_equal(got[-1][2], host[r]["v"][valid - 1].numpy()),
              f"{phase}: {out} last frame differs from the rung")
        read_back[f"{ow}x{oh}"] = len(got)
    emit(phase, source=[ABR_FRAMES, H, W], batch=ABR_BATCH,
         rungs=[f"{ow}x{oh}" for ow, oh in sizes], quant=quant,
         launches=counts, max_lsb_vs_plain=plain, max_lsb_vs_exact=exact,
         y4m_read_back=read_back, wall_s=wall,
         source_frames_per_s=frames / wall)
    return {"quant": quant, "counts": counts, "plain": plain,
            "batches": batches, "fps": frames / wall}


def rung_launcher(rungs, kind, y, u, v, geom):
    sizes = geom[4]
    check(len(sizes) <= rungs.MAX_RUNGS, "one launch per ladder")
    ops = rungs._kernel_operands(kind, geom, str(y.device))
    outs = [tuple(torch.empty(s, dtype=torch.uint8, device=y.device)
                  for s in ((y.shape[0], oh, ow),
                            (y.shape[0], oh // 2, ow // 2),
                            (y.shape[0], oh // 2, ow // 2)))
            for ow, oh in sizes]
    return launcher(rungs._ENTRIES[kind][1],
                    rungs._rungs_args(y, u, v, outs, ops), outs,
                    f"rungs_{kind}")


def rung_bound(rungs, kind, geom, n):
    """Least time for one rung batch on an H100 SXM: bytes of the 32-byte
    sectors holding source samples with a nonzero weight in any rung (each
    read once for all rungs), the band operands and the u8 outputs, over
    the memory rate; nonzero multiply-adds (row stage on the input columns
    each rung needs, then column stage) over the peak rate for their
    type."""
    h, w, ch, cw, sizes = geom[:5]
    mats = rungs._rung_operands(kind, geom)
    bytes_in = ops_row = ops_col = 0
    for key, ph, pw, planes in (("y", h, w, 1), ("c", ch, cw, 2)):
        touched = np.zeros((ph, pw), bool)
        for m in mats:
            ah, aw = m["ah" + key], m["aw" + key]
            rows = np.flatnonzero((ah != 0).any(axis=0))
            cols = np.flatnonzero((aw != 0).any(axis=1))
            touched[np.ix_(rows, cols)] = True
            ops_row += planes * 2 * int((ah != 0).sum()) * cols.size
            ops_col += planes * 2 * int((aw != 0).sum()) * ah.shape[0]
        # one byte per sample
        bytes_in += planes * sectors(np.flatnonzero(touched))
    out_bytes = n * sum(oh * ow + 2 * (oh // 2) * (ow // 2)
                        for ow, oh in sizes)
    total = (n * bytes_in + operand_bytes(
        list(rungs._kernel_operands(kind, geom, "cuda:0"))) + out_bytes)
    dense = n * (h * w + 2 * ch * cw) + out_bytes
    return finish_bound(total, n * ops_row, n * ops_col, kind, dense)


def interpolate_rungs(y, u, v, sizes):
    """The library call for the same function: one bilinear
    F.interpolate per plane and rung (the half-pixel, edge-clamped
    resample of resample_matrix, in exact f32), rounded to u8."""
    import torch.nn.functional as F
    outs = []
    for ow, oh in sizes:
        outs.append(tuple(
            torch.clamp(torch.round(F.interpolate(
                p.float()[:, None], size=s, mode="bilinear",
                align_corners=False)[:, 0]), 0, 255).to(torch.uint8)
            for p, s in ((y, (oh, ow)), (u, (oh // 2, ow // 2)),
                         (v, (oh // 2, ow // 2)))))
    return outs


def filter_frames(n: int, seed: int):
    """A 1080p yuv420p batch on the card: smooth_content's gradients,
    moved a little from frame to frame, seeded noise, and a scene cut
    (every plane inverted) from frame FILTER_CUT on."""
    from gmat_tpu_torch.core.frame import FrameBatch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step = (torch.arange(n, device="cuda", dtype=torch.int32) % 8 * 2
            ).reshape(-1, 1, 1)
    planes = {}
    for k, base in zip("yuv", smooth_content(H, W)):
        b = torch.as_tensor(base, device="cuda").to(torch.int32)
        x = b + step + torch.randint(-4, 5, (n,) + tuple(b.shape[1:]),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)
        x[FILTER_CUT:] = 255 - x[FILTER_CUT:]
        planes[k] = torch.clamp(x, 0, 255).to(torch.uint8)
    return FrameBatch(planes, "yuv420p", W, H).validate()


def on_card(fb) -> bool:
    return all(v.device.type == "cuda" for v in fb.planes.values())


def head_cpu(fb, n: int):
    """The first n frames of a batch, copied to the host."""
    return fb.with_planes({k: v[:n].cpu() for k, v in fb.planes.items()})


def planes_lsb(got, want) -> float:
    """Largest difference of two batches' planes in u8 LSBs (float planes
    are RGB in [0, 1]); their formats, sizes and dtypes must agree."""
    check((got.format, got.width, got.height, sorted(got.planes))
          == (want.format, want.width, want.height, sorted(want.planes)),
          f"{got.format} {got.width}x{got.height} vs {want.format} "
          f"{want.width}x{want.height}")
    worst = 0.0
    for k, b in want.planes.items():
        a = got.planes[k].cpu()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"plane {k}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
              f"{b.dtype}")
        if a.numel() == 0:
            continue
        if b.is_floating_point():
            d = float((a - b).abs().max()) * 255.0
        else:
            d = float((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        worst = max(worst, d)
    return worst


def pure_filter(spec: str, fb, tol: float):
    """One pure filter on a card batch: every frame out, on the card, the
    first FILTER_CPU_FRAMES within `tol` LSB of the CPU run.  Returns the
    graph, the output and its error."""
    from gmat_tpu_torch.filters.graph import FilterGraph
    g = FilterGraph(spec)
    out, keep = g.process(fb)
    torch.cuda.synchronize()
    check(on_card(out) and out.batch == fb.batch and keep.all(),
          f"filter {spec} on {fb.format}: output off the card or frames "
          "lost")
    want, _ = FilterGraph(spec).process(head_cpu(fb, FILTER_CPU_FRAMES))
    err = planes_lsb(head_cpu(out, FILTER_CPU_FRAMES), want)
    check(err <= tol, f"filter {spec} on {fb.format} vs CPU: {err} LSB > "
          f"{tol}")
    return g, out, err


def stream_filter(spec: str, fb, tol: float = 0):
    """A stream or keep-mask filter on the first 3 x FILTER_CPU_FRAMES
    frames of a card batch, as 3 batches through process and then flush,
    on the card and on the CPU: every keep mask and pts equal, every
    output within `tol` LSB (0 unless named).  "{dev}" in the spec
    becomes "card" or "cpu".  Returns (frames kept, fps_mul, largest
    error)."""
    from gmat_tpu_torch.filters.graph import FilterGraph
    n = FILTER_CPU_FRAMES
    graphs = {dev: FilterGraph(spec.replace("{dev}", dev))
              for dev in ("card", "cpu")}
    outs = {"card": [], "cpu": []}
    for b in range(3):
        part = fb.with_planes({k: v[b * n:(b + 1) * n]
                               for k, v in fb.planes.items()})
        pts = np.arange(b * n, (b + 1) * n)
        meta = dict(pts=pts, times=pts / 30.0,
                    keys=(pts % 5 == 0).astype(np.int64))
        for dev, src in (("card", part), ("cpu", head_cpu(part, n))):
            out, keep = graphs[dev].process(src, **meta)
            outs[dev].append((out, keep, graphs[dev].out_pts))
    for dev, g in graphs.items():
        outs[dev] += [(o, k, m.get("pts")) for o, k, m in g.flush()]
    check(len(outs["card"]) == len(outs["cpu"]),
          f"filter {spec} on {fb.format}: {len(outs['card'])} outputs on "
          f"the card, {len(outs['cpu'])} on the CPU")
    kept, worst = 0, 0.0
    for (o, k, p), (oh, kh, ph) in zip(outs["card"], outs["cpu"]):
        check(on_card(o), f"filter {spec} on {fb.format}: output off the "
              "card")
        check(np.array_equal(k, kh) and (p is None) == (ph is None)
              and (p is None or np.array_equal(p, ph)),
              f"filter {spec} on {fb.format}: keep masks or pts differ "
              "from the CPU")
        err = planes_lsb(o, oh)
        check(err <= tol, f"filter {spec} on {fb.format} vs CPU: {err} LSB "
              f"> {tol}")
        worst = max(worst, err)
        kept += int(np.count_nonzero(k))
    return kept, graphs["card"].fps_mul, worst


def filter_sources(fb) -> dict:
    """The source batches of PURE_FILTERS, made on the card from the
    1080p yuv420p batch."""
    from gmat_tpu_torch.ops import csc
    lin = csc.convert(fb, "rgbpf32")
    return {"yuv420p": fb, "rgb24": csc.convert(fb, "rgb24"),
            "rgba": csc.convert(fb, "rgba"),
            "linear": lin.with_planes({"rgb": lin.planes["rgb"] * 4.0})}


def cut_batch(fb, n: int, h: int, w: int):
    """The first n frames of a yuv420p batch, cropped to h x w."""
    return fb.with_planes(
        {k: v[:n, :h >> (k != "y"), :w >> (k != "y")].contiguous()
         for k, v in fb.planes.items()}, width=w, height=h)


class SecondInputs:
    """The second-input Y4M files of the part-3 specs, one per frame
    size, written on first use under `tmp` (write_y4m_source, seed
    SEED + 13)."""

    def __init__(self, tmp: str):
        self.tmp, self.paths, self.write_s = tmp, {}, 0.0

    def spec(self, spec: str, fb) -> str:
        key = (fb.height, fb.width)
        if "{b}" in spec and key not in self.paths:
            path = os.path.join(self.tmp, f"second_{fb.width}x{fb.height}"
                                ".y4m")
            t0 = time.perf_counter()
            write_y4m_source(path, SECOND_FRAMES, fb.height, fb.width,
                             SEED + 13)
            self.write_s += time.perf_counter() - t0
            self.paths[key] = path
        if "{o}" in spec and "overlay" not in self.paths:
            oh, ow = OVERLAY_SIZE
            path = os.path.join(self.tmp, f"overlay_{ow}x{oh}.y4m")
            t0 = time.perf_counter()
            write_y4m_source(path, OVERLAY_FRAMES, oh, ow, SEED + 19)
            self.write_s += time.perf_counter() - t0
            self.paths["overlay"] = path
        return spec.replace("{b}", self.paths.get(key, "")).replace(
            "{o}", self.paths.get("overlay", "")).replace("{tmp}", self.tmp)


def fresh_run(spec: str, fb) -> int:
    """One process + flush of a new graph on a batch; frames out."""
    from gmat_tpu_torch.filters.graph import FilterGraph
    g = FilterGraph(spec)
    pts = np.arange(fb.batch)
    out, keep = g.process(fb, pts=pts, times=pts / 30.0)
    kept = int(np.count_nonzero(keep))
    for o, k, _m in g.flush():
        kept += int(np.count_nonzero(k))
    return kept


def metric_files(tmp: str, kind: str) -> dict:
    """The card's and the CPU's stats files of a psnr/ssim spec: the
    largest relative difference of their numbers (printed to 4
    decimals, so at least one unit of that digit is allowed)."""
    texts = {}
    for dev in ("card", "cpu"):
        with open(os.path.join(tmp, f"{dev}_{kind}.log")) as f:
            texts[dev] = f.read().splitlines()
    check(len(texts["card"]) == len(texts["cpu"]) > 0,
          f"{kind} stats: {len(texts['card'])} lines on the card, "
          f"{len(texts['cpu'])} on the CPU")
    worst = 0.0
    for a, b in zip(texts["card"], texts["cpu"]):
        na = [float(v) for v in re.findall(r":(-?[\d.]+)", a)]
        nb = [float(v) for v in re.findall(r":(-?[\d.]+)", b)]
        check(len(na) == len(nb), f"{kind} stats lines {a!r} vs {b!r}")
        for x, y in zip(na, nb):
            d = abs(x - y)
            check(d <= 1e-4 * 1.0001 or d <= METRIC_RTOL * abs(y),
                  f"{kind} stats {a!r} vs CPU {b!r}")
            worst = max(worst, d / max(abs(y), 1e-12))
    return {"lines": len(texts["card"]), "max_rel_diff": worst}


def filter_part3(fb, fb_cut, tmp: str) -> dict:
    """The temporal and structural filters on the card: each checked as
    3 batches + flush against the CPU (stream_filter) where
    STREAM_FILTERS_3 says, then timed; returns the phase's entries."""
    seconds = SecondInputs(tmp)
    h, w = EXPR_CUT
    fb_expr = cut_batch(fb, 3 * FILTER_CPU_FRAMES, h, w)
    fb_expr_t = cut_batch(fb, EXPR_BATCH, h, w)
    where = {"full": fb, "cut": fb_cut, "expr": fb_expr}
    out = {}
    for spec, tol, at in STREAM_FILTERS_3:
        src = where[at]
        kept, fps_mul, err = stream_filter(seconds.spec(spec, src), src, tol)
        entry = {"checked_on": [3 * FILTER_CPU_FRAMES, src.height,
                                src.width], "frames_out": kept,
                 "fps_mul": fps_mul, "max_lsb_vs_cpu": err,
                 "bound_lsb": tol}
        for kind in ("psnr", "ssim"):
            if spec.startswith(kind):
                entry["stats_vs_cpu"] = metric_files(tmp, kind)
        timed = fb_expr_t if at == "expr" else fb
        tspec = seconds.spec(spec, timed).replace("{dev}", "timed")
        slow = any(name in spec for name in FILTER_SLOW_3)
        ms, runs, host = event_ms(lambda i: fresh_run(tspec, timed),
                                  calls=1, reps=1 if slow else 3,
                                  warm=0 if slow else 1)
        entry.update(timed_on=[timed.batch, timed.height, timed.width],
                     ms_per_batch=ms, runs_ms=runs, host_ms=host)
        out[spec] = entry
    out["second_input_write_s"] = seconds.write_s
    return out


def blend16_check() -> dict:
    """Every blend mode name on 16-bit planes on the card against the
    same call on the CPU (0 LSB): a BLEND16_GRID^2 grid over the whole
    code range, where the C products (2*A*B, (MAX-B)^2, MAX*A) wrap
    int32, at opacity 1 and 0.5."""
    from gmat_tpu_torch.ops import blend
    g = torch.linspace(0, 65535, BLEND16_GRID).round().to(torch.int32)
    a = g[:, None].expand(BLEND16_GRID, BLEND16_GRID)
    b = g[None, :].expand(BLEND16_GRID, BLEND16_GRID)
    a = a.to(torch.uint16)[None].contiguous()
    b = b.to(torch.uint16)[None].contiguous()
    a_c, b_c = a.cuda(), b.cuda()
    worst = 0
    for mode in sorted(blend.MODE_NAMES):
        for opacity in (1.0, 0.5):
            got = blend.blend_plane(a_c, b_c, mode, opacity, 16)
            want = blend.blend_plane(a, b, mode, opacity, 16)
            check(got.device.type == "cuda" and got.dtype == torch.uint16,
                  f"blend {mode} 16-bit: {got.dtype} on {got.device}")
            d = int((got.cpu().to(torch.int32)
                     - want.to(torch.int32)).abs().max())
            check(d == 0, f"blend {mode}@{opacity} 16-bit vs CPU: {d} LSB")
            worst = max(worst, d)
    return {"modes": len(blend.MODE_NAMES), "opacities": [1.0, 0.5],
            "grid": [BLEND16_GRID, BLEND16_GRID], "max_lsb_vs_cpu": worst}


def filter_graph_phase():
    """Every ported filter on the card: each pure filter alone and the
    long chain on a 32 x 1080p batch (or its rgb24, rgba or linear-light
    float conversion), the stream and keep-mask filters on a 3-batch
    sequence through process and flush; every output held against the
    port's own CPU run on the same frames and timed at 32 x 1080p (ms per
    batch, median of 3 single calls; FILTER_SLOW one).  Then the 10-bit
    leg: the filters that take 16-bit planes on a yuv420p10 cut of the
    batch, checked, not timed."""
    from gmat_tpu_torch.filters.graph import FilterGraph
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_luts_")
    try:
        write_luts(tmp, SEED + 3)
        fb = filter_frames(FILTER_BATCH, SEED + 7)
        sources = filter_sources(fb)
        pure = {}
        for spec, tol, *src in PURE_FILTERS:
            src = src[0] if src else "yuv420p"
            path_spec = spec
            for name in (LUT3D_FILE, LUT1D_FILE):
                path_spec = path_spec.replace(name, os.path.join(tmp, name))
            g, out, err = pure_filter(path_spec, sources[src], tol)
            slow = spec in FILTER_SLOW
            ms, runs, host = event_ms(lambda i: g.process(sources[src]),
                                      calls=1, reps=1 if slow else 3,
                                      warm=0 if slow else 2)
            pure[spec] = {"source": src,
                          "out": f"{out.format} {out.width}x{out.height}",
                          "max_lsb_vs_cpu": err, "bound_lsb": tol,
                          "ms_per_batch": ms, "runs_ms": runs,
                          "host_ms": host}
            del out
        del sources
        n, (h, w) = 3 * FILTER_CPU_FRAMES, LEG_CUT
        fb_cut = cut_batch(fb, n, h, w)
        stream = {}
        for spec in STREAM_FILTERS:
            on_cut = spec in STREAM_ON_CUT
            kept, fps_mul, _ = stream_filter(spec,
                                             fb_cut if on_cut else fb)
            g = FilterGraph(spec)
            slow = spec in FILTER_SLOW
            ms, runs, host = event_ms(
                lambda i: g.process(fb, pts=np.arange(i * FILTER_BATCH,
                                                      (i + 1) * FILTER_BATCH),
                                    times=np.arange(FILTER_BATCH) / 30.0),
                calls=1, reps=1 if slow else 3, warm=0 if slow else 2)
            stream[spec] = {"frames_in": 3 * FILTER_CPU_FRAMES,
                            "checked_on": [n, h, w] if on_cut else
                            [n, H, W],
                            "frames_out": kept, "fps_mul": fps_mul,
                            "max_lsb_vs_cpu": 0, "ms_per_batch": ms,
                            "runs_ms": runs, "host_ms": host}
        part3 = filter_part3(fb, fb_cut, tmp)
        # the 10-bit leg: the same cut at 10 bits (x << 2 | 2): its first
        # 3 x FILTER_CPU_FRAMES frames at 960x544 (the CPU references
        # stay short)
        fb10 = fb_cut.with_planes(
            {k: ((v.to(torch.int32) << 2) | 2).to(torch.uint16)
             for k, v in fb_cut.planes.items()}, "yuv420p10")
        del fb, fb_cut
        leg10 = {}
        for spec, tol in PURE_FILTERS_10BIT:
            leg10[spec] = {"max_lsb_vs_cpu": pure_filter(spec, fb10, tol)[2],
                           "bound_lsb": tol}
        for spec in STREAM_FILTERS_10BIT:
            leg10[spec] = {"frames_out": stream_filter(spec, fb10)[0],
                           "max_lsb_vs_cpu": 0}
        seconds10 = SecondInputs(tmp)
        for spec in STREAM_FILTERS_3_10BIT:
            leg10[spec] = {"frames_out": stream_filter(
                seconds10.spec(spec, fb10), fb10)[0], "max_lsb_vs_cpu": 0}
        try:
            FilterGraph("framerate=fps=50").process(fb10)
            raised = ""
        except Exception as e:          # the 8-bit gate of the JAX filter
            raised = str(e)
        check("8-bit" in raised, f"framerate on yuv420p10: {raised!r}")
        leg10["framerate=fps=50"] = {"raises": raised}
        leg10["blend_plane_16bit"] = blend16_check()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("filter_graph", source=[FILTER_BATCH, H, W], scene_cut=FILTER_CUT,
         cpu_frames=FILTER_CPU_FRAMES, pure=pure, stream=stream,
         temporal_structural=part3,
         yuv420p10={"source": [n, h, w], **leg10},
         phase_s=time.perf_counter() - t_phase)


def abr_filtered(rungs, path, sizes, bare_fps):
    """The filtered ABR path once: the Y4M file -> decode_stream -> the
    common graph (yadif, send_frame) -> metrans.filtered_step's
    ladder_step on the int8 ladder -> each rung's eq, lutyuv and unsharp
    -> rung planes on the host.  One rungs_i8 launch per batch, flushed
    batches included; every frame of the first batch's rungs equals the
    same steps run on the CPU (the rung kernel's plain version) on the
    whole first batch.  Returns the launch counts."""
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.core.frame import FrameBatch
    from gmat_tpu_torch.filters.graph import FilterGraph
    tb = 1.0 / 30.0
    common = FilterGraph(ABR_COMMON, 30.0)
    graphs = [FilterGraph(ABR_RUNG_FILTERS, 30.0) for _ in sizes]
    kept = [0] * len(sizes)

    def to_host(outs):
        host = []
        for r, (rb, keep) in enumerate(outs):
            if rb is None:
                host.append(None)
                continue
            check(on_card(rb) and rb.format == "yuv420p"
                  and (rb.width, rb.height) == sizes[r],
                  f"abr_filtered: rung {r} is {rb.format} {rb.width}x"
                  f"{rb.height}, on the card: {on_card(rb)}")
            idx = torch.as_tensor(np.nonzero(keep)[0], device=rb.device)
            host.append({k: rb.planes[k][idx].cpu() for k in "yuv"})
            kept[r] += len(idx)
        return host

    t_phase = time.perf_counter()
    zero_counts(rungs)
    t0 = time.perf_counter()
    steps = frames_in = 0
    first = None
    for fb, pts, valid in decode_stream(path, batch=ABR_BATCH):
        if first is None:
            # a copy on the card (the ingest ring reuses its buffers),
            # moved to the host after the timed loop
            first = (fb.with_planes({k: v.clone()
                                     for k, v in fb.planes.items()}),
                     pts.copy(), int(valid))
        outs = metrans.filtered_step(fb, pts, valid, sizes, common, graphs,
                                     {"times": pts * tb}, tb)
        check(common.out_pts is not None and len(common.out_pts) > 0,
              "abr_filtered: the common graph emitted nothing")
        host = to_host(outs)
        if steps == 0:
            first_out = host
        steps += 1
        frames_in += int(valid)
    for fb, keep, meta in common.flush():
        fpts = meta["pts"]
        to_host(metrans.rung_step(fb, keep, fpts, {"times": fpts * tb},
                                  sizes, graphs))
        steps += 1
    check(all(not g.flush() for g in graphs), "abr_filtered: rung flush")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rungs.LAUNCHES)
    check(counts == {"rungs_i8": steps, "rungs_bf16": 0},
          f"abr_filtered launches {counts}, want {steps} rungs_i8")
    check(frames_in == ABR_FRAMES and kept == [frames_in] * len(sizes),
          f"abr_filtered: {frames_in} frames in, {kept} out per rung "
          "(yadif send_frame keeps the count)")
    # the same steps on the CPU over the whole first batch: the rung
    # kernel's plain version
    src, pts, valid = first
    src = head_cpu(src, src.batch)
    cg = FilterGraph(ABR_COMMON, 30.0)
    cfb, ckeep = cg.process(src, pts=pts, valid=valid, times=pts * tb)
    cpts = cg.out_pts
    err, compared = 0.0, []
    for r, ((ow, oh), planes) in enumerate(zip(sizes, rungs.fused_rungs(
            *(cfb.planes[k] for k in "yuv"), sizes))):
        rb = FrameBatch(dict(zip("yuv", planes)), "yuv420p", ow, oh)
        rb, rkeep = FilterGraph(ABR_RUNG_FILTERS, 30.0).process(
            rb, pts=cpts, keep=ckeep, times=cpts * tb)
        idx = torch.as_tensor(np.nonzero(rkeep)[0])
        want = rb.with_planes({k: v[idx] for k, v in rb.planes.items()})
        got = FrameBatch({k: first_out[r][k] for k in "yuv"}, "yuv420p",
                         ow, oh)
        err = max(err, planes_lsb(got, want))
        compared.append(len(idx))
    check(err == 0 and compared == [first_out[0]["y"].shape[0]] * len(sizes)
          and compared[0] == valid - 1,
          f"abr_filtered vs CPU: {err} LSB over {compared} frames")
    fps = frames_in / wall
    emit("abr_filtered", source=[ABR_FRAMES, H, W], batch=ABR_BATCH,
         common=ABR_COMMON, rung_filters=ABR_RUNG_FILTERS,
         rungs=[f"{ow}x{oh}" for ow, oh in sizes], launches=counts,
         ladder_steps=steps, frames_out_per_rung=kept,
         first_batch_frames_vs_cpu=compared, max_lsb_vs_cpu=err,
         wall_s=wall, source_frames_per_s=fps,
         bare_ladder_source_frames_per_s=bare_fps,
         phase_s=time.perf_counter() - t_phase)
    return counts


class GraphTap:
    """A FilterGraph that keeps its first output batch (and, with
    keep_all, every output batch): the common graph of the HDR and IVTC
    paths, so that the phase can check the card's own output of the timed
    run."""

    def __init__(self, graph, keep_all: bool = False):
        self.graph, self.first, self.keep_all = graph, None, keep_all
        self.outs = []

    def process(self, fb, **kw):
        out, keep = self.graph.process(fb, **kw)
        if self.first is None:
            self.first = (out, keep)
        if self.keep_all:
            self.outs.append((out, keep))
        return out, keep

    @property
    def out_pts(self):
        return self.graph.out_pts

    @property
    def fps_mul(self):
        return self.graph.fps_mul


def abr_hdr(rungs, tmp, sizes, bare_fps):
    """The HDR10 -> SDR ABR path once: a 64-frame 1080p 10-bit PQ Y4M ->
    decode_stream(bits=10) -> metrans.filtered_step with ABR_HDR_COMMON
    as the common graph -> the int8 ladder -> rung planes on the host.
    One rungs_i8 launch per batch, none of rungs_bf16, 64 frames per rung;
    the common graph's output on its first ABR_HDR_CPU_FRAMES frames
    within LSB_HDR of the CPU's, and the first batch's rungs equal (0 LSB)
    to the rung kernel's plain version on the card's own common output."""
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.filters.graph import FilterGraph
    t_phase = time.perf_counter()
    path = os.path.join(tmp, "source_1080p_pq10.y4m")
    t0 = time.perf_counter()
    write_y4m_pq(path, ABR_HDR_FRAMES, H, W, SEED + 11)
    write_s = time.perf_counter() - t0
    tb = 1.0 / 30.0
    common = GraphTap(FilterGraph(ABR_HDR_COMMON, 30.0))
    kept = [0] * len(sizes)
    first_src = first_rungs = None
    zero_counts(rungs)
    t0 = time.perf_counter()
    steps = frames_in = 0
    for fb, pts, valid in decode_stream(path, batch=ABR_BATCH, bits=10):
        check(fb.format == "yuv420p10" and fb.device.type == "cuda",
              f"abr_hdr: source batch {fb.format} on {fb.device}")
        if first_src is None:
            # the ingest ring reuses its buffers: the first batch, copied
            # on the card, for the CPU reference and the graph's timing
            first_src = fb.with_planes({k: v.clone()
                                        for k, v in fb.planes.items()})
        outs = metrans.filtered_step(fb, pts, valid, sizes, common, None,
                                     {"times": pts * tb}, tb)
        host = []
        for r, (rb, keep) in enumerate(outs):
            check(rb is not None and on_card(rb) and rb.format == "yuv420p"
                  and (rb.width, rb.height) == sizes[r],
                  f"abr_hdr: rung {r} missing, off the card or misshaped")
            idx = torch.as_tensor(np.nonzero(keep)[0], device=rb.device)
            host.append({k: rb.planes[k][idx].cpu() for k in "yuv"})
            kept[r] += len(idx)
        if first_rungs is None:
            first_rungs = host
        steps += 1
        frames_in += int(valid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rungs.LAUNCHES)
    check(counts == {"rungs_i8": steps, "rungs_bf16": 0},
          f"abr_hdr launches {counts}, want {steps} rungs_i8")
    check(frames_in == ABR_HDR_FRAMES and kept == [frames_in] * len(sizes),
          f"abr_hdr: {frames_in} frames in, {kept} out per rung")
    # the common graph on the card against the CPU on the first frames
    card_common, card_keep = common.first
    check(card_common.format == "yuv420p" and bool(card_keep.all()),
          f"abr_hdr: common output {card_common.format}")
    want, _ = FilterGraph(ABR_HDR_COMMON, 30.0).process(
        head_cpu(first_src, ABR_HDR_CPU_FRAMES))
    got = head_cpu(card_common, ABR_HDR_CPU_FRAMES)
    err_common = planes_lsb(got, want)
    differ = sum(int((got.planes[k].to(torch.int32)
                      != want.planes[k].to(torch.int32)).sum())
                 for k in "yuv")
    samples = sum(v.numel() for v in want.planes.values())
    check(err_common <= LSB_HDR, f"abr_hdr common graph vs CPU: "
          f"{err_common} LSB > {LSB_HDR}")
    # the first batch's rungs against the plain version on the card's own
    # common output, copied to the host
    cpu_common = head_cpu(card_common, card_common.batch)
    plain = rungs.fused_rungs(*(cpu_common.planes[k] for k in "yuv"), sizes)
    err_rungs = 0
    for got_r, want_r in zip(first_rungs, plain):
        for k, wp in zip("yuv", want_r):
            check(tuple(got_r[k].shape) == tuple(wp.shape),
                  f"abr_hdr rung plane {tuple(got_r[k].shape)}")
            err_rungs = max(err_rungs, rung_lsb(got_r[k], wp))
    check(err_rungs == 0, f"abr_hdr rungs vs plain: {err_rungs} LSB")
    timed = FilterGraph(ABR_HDR_COMMON, 30.0)
    common_ms, common_runs, common_host = event_ms(
        lambda i: timed.process(first_src), calls=1, reps=3)
    fps = frames_in / wall
    emit("abr_hdr", source=[ABR_HDR_FRAMES, H, W], bits=10, batch=ABR_BATCH,
         common=ABR_HDR_COMMON, rungs=[f"{ow}x{oh}" for ow, oh in sizes],
         launches=counts, ladder_steps=steps, frames_out_per_rung=kept,
         common_max_lsb_vs_cpu=err_common, common_bound_lsb=LSB_HDR,
         common_samples_differing=differ, common_samples=samples,
         common_cpu_frames=ABR_HDR_CPU_FRAMES,
         rungs_max_lsb_vs_plain_on_card_common=err_rungs,
         rungs_plain_frames=cpu_common.batch,
         common_ms_per_batch=common_ms, common_runs_ms=common_runs,
         common_host_ms=common_host, write_s=write_s,
         wall_s=wall, source_frames_per_s=fps,
         bare_ladder_source_frames_per_s=bare_fps,
         phase_s=time.perf_counter() - t_phase)
    os.remove(path)
    return counts


def encoder_rate(src_fps: int, fps_mul):
    """The rate run_session hands a rung's encoder: the source rate times
    the graphs' fps_mul, kept rational (x1000)."""
    from fractions import Fraction
    if fps_mul == 1:
        return Fraction(src_fps)
    return Fraction(int(round(src_fps * fps_mul * 1000)), 1000)


def write_telecined(src: str, path: str):
    """The ABR source's first ABR_IVTC_FRAMES frames through the port's
    telecine on the card, written as a 30/1 Y4M.  Returns the progressive
    frames (on the card) and the frames written."""
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.av.rawvideo import Y4MWriter
    from gmat_tpu_torch.filters.graph import FilterGraph
    tel = FilterGraph(ABR_IVTC_TELECINE, 30.0)
    progressive, written, n_read = [], 0, 0
    wr = Y4MWriter(path, W, H, (30, 1))
    try:
        for fb, pts, valid in decode_stream(src, batch=ABR_BATCH):
            take = min(int(valid), ABR_IVTC_FRAMES - n_read)
            if take <= 0:
                continue
            part = fb.with_planes({k: v[:take].clone()
                                   for k, v in fb.planes.items()})
            progressive.append(part)
            out, keep = tel.process(part, pts=pts[:take])
            check(on_card(out), "abr_ivtc: telecine output off the card")
            idx = torch.as_tensor(np.nonzero(keep)[0], device=out.device)
            host = {k: v[idx].cpu().numpy() for k, v in out.planes.items()}
            for j in range(len(idx)):
                wr.write(*(host[k][j] for k in "yuv"))
            written += len(idx)
            n_read += take
        check(not tel.flush(), "abr_ivtc: telecine flushed frames")
    finally:
        wr.close()
    return progressive, written


def abr_ivtc(rungs, src, tmp, sizes, bare_fps):
    """The inverse-telecine ABR path once: the telecined Y4M ->
    decode_stream -> metrans.filtered_step with ABR_IVTC_COMMON as the
    common graph -> the int8 ladder -> rung planes on the host.  One
    rungs_i8 launch per non-empty batch, none of rungs_bf16; each rung's
    frame count and encoder rate (24/1) equal to the CPU run's; the
    common output from ABR_IVTC_FADE_END on equal (0 LSB) to the
    progressive source; the first batch's common output equal to the CPU
    run's, and its rungs to the rung kernel's plain version on the card's
    own common output (0 LSB)."""
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.filters.graph import FilterGraph
    t_phase = time.perf_counter()
    path = os.path.join(tmp, "source_1080p_telecined.y4m")
    t0 = time.perf_counter()
    progressive, written = write_telecined(src, path)
    write_s = time.perf_counter() - t0
    check(written == ABR_IVTC_FRAMES * 5 // 4,
          f"abr_ivtc: telecine wrote {written} frames")
    tb = 1.0 / 30.0
    common = GraphTap(FilterGraph(ABR_IVTC_COMMON, 30.0), keep_all=True)
    kept = [0] * len(sizes)
    first_rungs = None
    zero_counts(rungs)
    t0 = time.perf_counter()
    steps = frames_in = 0
    for fb, pts, valid in decode_stream(path, batch=ABR_BATCH):
        outs = metrans.filtered_step(fb, pts, valid, sizes, common, None,
                                     {"times": pts * tb}, tb)
        host = []
        for r, (rb, keep) in enumerate(outs):
            if rb is None:
                host.append(None)
                continue
            check(on_card(rb) and rb.format == "yuv420p"
                  and (rb.width, rb.height) == sizes[r],
                  f"abr_ivtc: rung {r} off the card or misshaped")
            idx = torch.as_tensor(np.nonzero(keep)[0], device=rb.device)
            host.append({k: rb.planes[k][idx].cpu() for k in "yuv"})
            kept[r] += len(idx)
        if common.outs[-1][0].batch:
            steps += 1
            if first_rungs is None:
                first_rungs = host
        frames_in += int(valid)
    check(not common.graph.flush(), "abr_ivtc: the common graph flushed "
          "frames (detelecine drops a buffered half frame, fade holds none)")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rungs.LAUNCHES)
    check(counts == {"rungs_i8": steps, "rungs_bf16": 0},
          f"abr_ivtc launches {counts}, want {steps} rungs_i8")
    # the same common graph on the CPU over the whole file: frame counts,
    # encoder rate and the first batch's output
    cg = FilterGraph(ABR_IVTC_COMMON, 30.0)
    cpu_kept, cpu_first = 0, None
    for fb, pts, valid in decode_stream(path, batch=ABR_BATCH, device="cpu"):
        cfb, ckeep = cg.process(fb, pts=pts, valid=valid, times=pts * tb)
        cpu_kept += int(np.count_nonzero(ckeep))
        if cpu_first is None:
            cpu_first = (cfb, ckeep)
    rate = encoder_rate(30, common.fps_mul)
    cpu_rate = encoder_rate(30, cg.fps_mul)
    check(frames_in == written and kept == [cpu_kept] * len(sizes)
          and rate == cpu_rate == 24,
          f"abr_ivtc: {frames_in} frames in, {kept} out per rung at "
          f"{rate}; the CPU run {cpu_kept} at {cpu_rate}")
    card_first, card_keep = common.first
    check(np.array_equal(card_keep, cpu_first[1]),
          "abr_ivtc: first batch keep mask differs from the CPU")
    err_first = planes_lsb(head_cpu(card_first, card_first.batch),
                           cpu_first[0])
    check(err_first == 0, f"abr_ivtc first batch vs CPU: {err_first} LSB")
    # the round trip: what the fade leaves alone is the progressive source
    card_out = {k: torch.cat([o.planes[k][torch.as_tensor(
        np.nonzero(kp)[0], device=o.device)] for o, kp in common.outs
        if o.batch]) for k in "yuv"}
    source = {k: torch.cat([p.planes[k] for p in progressive])
              for k in "yuv"}
    n_out = card_out["y"].shape[0]
    check(n_out == cpu_kept and n_out <= ABR_IVTC_FRAMES,
          f"abr_ivtc: {n_out} common frames")
    round_trip = max(int((card_out[k][ABR_IVTC_FADE_END:].to(torch.int32)
                          - source[k][ABR_IVTC_FADE_END:n_out]
                          .to(torch.int32)).abs().max()) for k in "yuv")
    check(round_trip == 0, f"abr_ivtc: frames {ABR_IVTC_FADE_END}.."
          f"{n_out - 1} are {round_trip} LSB from the progressive source")
    # the first batch's rungs against the plain version on the card's own
    # common output, copied to the host
    cpu_common = head_cpu(card_first, card_first.batch)
    plain = rungs.fused_rungs(*(cpu_common.planes[k] for k in "yuv"), sizes)
    err_rungs = 0
    for got_r, want_r in zip(first_rungs, plain):
        for k, wp in zip("yuv", want_r):
            check(tuple(got_r[k].shape) == tuple(wp.shape),
                  f"abr_ivtc rung plane {tuple(got_r[k].shape)}")
            err_rungs = max(err_rungs, rung_lsb(got_r[k], wp))
    check(err_rungs == 0, f"abr_ivtc rungs vs plain: {err_rungs} LSB")
    fps = frames_in / wall
    emit("abr_ivtc", source=[written, H, W], progressive=ABR_IVTC_FRAMES,
         batch=ABR_BATCH, telecine=ABR_IVTC_TELECINE, common=ABR_IVTC_COMMON,
         rungs=[f"{ow}x{oh}" for ow, oh in sizes], launches=counts,
         ladder_steps=steps, frames_out_per_rung=kept,
         common_frames_per_batch=[o.batch for o, _k in common.outs],
         cpu_frames_out=cpu_kept, encoder_rate=f"{rate.numerator}/"
         f"{rate.denominator}", cpu_encoder_rate=f"{cpu_rate.numerator}/"
         f"{cpu_rate.denominator}",
         first_batch_max_lsb_vs_cpu=err_first,
         round_trip_max_lsb_from_frame=[round_trip, ABR_IVTC_FADE_END],
         rungs_max_lsb_vs_plain_on_card_common=err_rungs,
         write_s=write_s, wall_s=wall, source_frames_per_s=fps,
         bare_ladder_source_frames_per_s=bare_fps,
         phase_s=time.perf_counter() - t_phase)
    os.remove(path)
    return counts


def av_precondition(phase: str) -> bool:
    """Whether the host runtime can be built here (libav* libraries and
    headers); prints `{phase}_precondition`, and `{phase}` with run: false
    when it cannot."""
    found = {lib: ctypes.util.find_library(lib) for lib in AV_LIBS}
    arch = subprocess.run(["g++", "-print-multiarch"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    headers = any(os.path.exists(os.path.join(d, "libavcodec", "avcodec.h"))
                  for d in ("/usr/include", f"/usr/include/{arch}",
                            "/usr/local/include"))
    ok = all(found.values()) and headers
    emit(f"{phase}_precondition", find_library=found,
         libavcodec_headers=headers, run=ok)
    if not ok:
        emit(phase, run=False, why="no libavcodec on this machine")
    return ok


def metrans_session(path, tmp):
    """run_session on the Y4M source with libx264 rungs, where the host
    runtime can be built (libav* present); otherwise say why not."""
    if not av_precondition("metrans_session"):
        return None
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av import toolkit as tk
    opts = metrans.Options(
        input_file=path, video_enc_param="codec=h264:preset=p1:constqp=28",
        video_filter_desc=ABR_COMMON,
        rungs=[metrans.Rung(ow, oh, filter_desc=ABR_RUNG_FILTERS,
                            out_file=os.path.join(
                                tmp, f"session_{ow}x{oh}_#.mp4"))
               for ow, oh in LADDER_1080])
    res = metrans.run_session(0, opts, batch=ABR_BATCH)
    check(res["frames_in"] == ABR_FRAMES
          and res["frames_out"] == ABR_FRAMES * len(LADDER_1080),
          f"metrans_session: {res}")
    counted = {}
    for r in opts.rungs:
        dm = tk.Demuxer(r.out_file.replace("#", "0"))
        dec = tk.Decoder.from_demuxer(dm)
        n = 0
        for pkt in dm:
            if pkt.stream == 0:
                n += sum(1 for _ in dec.decode(pkt.data, pkt.pts))
        n += sum(1 for _ in dec.decode(None))
        dims = (dm.width, dm.height)
        dm.close()
        dec.close()
        check(n == ABR_FRAMES and dims == (r.width, r.height),
              f"metrans_session: {r.out_file} has {n} frames at {dims}")
        counted[f"{r.width}x{r.height}"] = n
    emit("metrans_session", run=True, result=res, frames_per_file=counted)
    return res


def scene_phase(path):
    """scene_scores on the ABR source's batches on the card, the last
    frame and the mafd carried from batch to batch as FrameSelect carries
    them, against the same calls on CPU copies; then the time per batch."""
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.ops import scene
    carry, carry_cpu = (None, 0.0), (None, 0.0)
    mafd_rel = score_err = 0.0
    frames, last = 0, None
    for fb, _pts, valid in decode_stream(path, batch=ABR_BATCH):
        cpu = fb.with_planes({k: v.cpu() for k, v in fb.planes.items()})
        score, mafd = scene.scene_scores_mafd(fb, *carry)
        want, want_mafd = scene.scene_scores_mafd(cpu, *carry_cpu)
        check(score.device.type == "cuda" and tuple(score.shape) == (fb.batch,)
              and bool(torch.isfinite(score).all()), "scene: bad scores")
        mafd_rel = max(mafd_rel, float(((mafd.cpu() - want_mafd).abs()
                                        / want_mafd.abs()).max()))
        # the score's own scale: min(mafd, |mafd - prev|) / 100 can cancel
        # most digits of two mafds, so hold it to what 1e-5 relative on
        # the mafds allows
        score_err = max(score_err, float((score.cpu() - want).abs().max())
                        / (2.0 * float(want_mafd.abs().max()) / 100.0))
        carry = ({k: v[-1] for k, v in fb.planes.items()}, mafd[-1])
        carry_cpu = ({k: v[-1] for k, v in cpu.planes.items()},
                     want_mafd[-1])
        frames += int(valid)
        last = fb
    check(frames == ABR_FRAMES, f"scene: {frames} frames")
    check(mafd_rel <= SCENE_RTOL and score_err <= SCENE_RTOL,
          f"scene vs CPU: mafd {mafd_rel}, score {score_err} relative")
    ms, runs, host_ms = event_ms(lambda i: scene.scene_scores(last, *carry))
    emit("scene", frames=frames, batch=ABR_BATCH, source=[H, W],
         mafd_max_rel_err_vs_cpu=mafd_rel,
         score_max_err_vs_cpu_rel_to_mafd=score_err,
         ms_per_batch=ms, runs_ms=runs, host_ms=host_ms)
    return ms


def smart_clip(path: str) -> None:
    """A libx264 clip: flat frames, luma 20 + 3 * i, a scene cut at frame
    SMART_CUT (test_extractor.py's make_clip)."""
    from gmat_tpu_torch.av import toolkit as tk
    w, h = SMART_SIZE
    enc = tk.Encoder("libx264", w, h, fps=(30, 1), gop=12, preset="veryfast",
                     crf=14.0)
    pkts = []
    for i in range(SMART_FRAMES):
        lum, uu, vv = ((20 + 3 * i, 110, 140) if i < SMART_CUT
                       else (235 - (i - SMART_CUT) * 2, 60, 200))
        pkts += enc.encode(np.full((h, w), lum, np.uint8),
                           np.full((h // 2, w // 2), uu, np.uint8),
                           np.full((h // 2, w // 2), vv, np.uint8), pts=i)
    pkts += enc.flush()
    mux = tk.Muxer(path, w, h, (30, 1), tk.CODEC_H264, enc.extradata())
    for p in pkts:
        mux.write(p)
    mux.close()
    enc.close()


def smart_decode(tmp, device="cuda"):
    """FrameExtractor, FrameSelect (scores on `device`) and
    extract_to_torch on a small libx264 clip, where the host runtime can
    be built; otherwise say why not."""
    if not av_precondition("smart_decode"):
        return None
    from gmat_tpu_torch.av.extractor import FrameExtractor, FrameSelect
    from gmat_tpu_torch.av.torch_interop import extract_to_torch
    clip = os.path.join(tmp, "smart.mp4")
    smart_clip(clip)

    def index(fx, pts):
        num, den = fx.dm.time_base
        return round(pts * num / den * 30.0)

    fx = FrameExtractor(clip, frame_interval=10)
    picked = [index(fx, f[3]) for f in fx.frames()]
    stats = {k: getattr(fx, k) for k in ("n_decoded", "n_skipped_seek",
                                         "n_skipped_nonref")}
    fx.close()
    check(picked == list(range(0, SMART_FRAMES, 10))
          and stats["n_decoded"] < SMART_FRAMES,
          f"FrameExtractor picked {picked}, {stats}")
    selected = {}
    for dev in (device, "cpu"):
        fs = FrameSelect(clip, threshold=0.4, batch_size=16, device=dev)
        selected[dev] = [(index(fs, f[3]), f[4]) for f in fs.frames()]
        fs.close()
    sel = selected[device]
    check(len(sel) == 1 and sel[0][0] == SMART_CUT
          and [s[0] for s in selected["cpu"]] == [SMART_CUT]
          and abs(sel[0][1] - selected["cpu"][0][1])
          <= SCENE_RTOL * selected["cpu"][0][1],
          f"FrameSelect: {selected}")
    outs = {dev: list(extract_to_torch(clip, 20, (64, 48), batch=2,
                                       device=dev))
            for dev in (device, "cpu")}
    shapes = [list(t.shape) for t, _ in outs[device]]
    check(shapes == [[2, 3, 48, 64], [1, 3, 48, 64]]
          and all(t.device.type == torch.device(device).type
                  for t, _ in outs[device]), f"extract_to_torch {shapes}")
    err = max(lsb(t.cpu(), c) for (t, _), (c, _) in zip(outs[device],
                                                        outs["cpu"]))
    check(err <= LSB_GATE, f"extract_to_torch vs CPU: {err} LSB")
    emit("smart_decode", run=True, extracted=picked, stats=stats,
         selected=sel, extract_to_torch_shapes=shapes,
         extract_to_torch_max_lsb_vs_cpu=err)
    return sel


def model_flops(filt, n: int, h: int, w: int) -> int:
    """FLOPs (2 per multiply-add) of one InferFilter call on n frames of
    an h x w network input, counted from its param shapes: stride-1
    "same" convs for sr and denoise; stride-2 "SAME" convs, then the
    head, for pose and classify."""
    p = filt.params
    if "w1" in p:
        weights, strided, head = [p["w1"], p["w2"], p["w3"]], False, None
    else:
        weights = [l["w"] for l in p.get("layers", p.get("convs"))]
        strided, head = "head_w" in p, p.get("head_w")
    total = 0
    for wt in weights:
        if strided:
            h, w = -(-h // 2), -(-w // 2)
        cout, cin, kh, kw = wt.shape
        total += 2 * n * h * w * cout * cin * kh * kw
    if head is not None:
        total += 2 * n * head.shape[0] * head.shape[1]
    return total


def lsb_stats(got, want):
    """(max, mean) |got - want| over two batches' planes in u8 LSBs
    (float planes are RGB in [0, 1])."""
    check(sorted(got.planes) == sorted(want.planes)
          and (got.format, got.width, got.height)
          == (want.format, want.width, want.height),
          f"{got.format} {got.width}x{got.height} vs {want.format} "
          f"{want.width}x{want.height}")
    worst, total, count = 0.0, 0.0, 0
    for k, b in want.planes.items():
        d = (got.planes[k].cpu().double() - b.double()).abs()
        if b.is_floating_point():
            d = d * 255.0
        worst = max(worst, float(d.max()))
        total += float(d.sum())
        count += d.numel()
    return worst, total / count


def rel_excess(got: torch.Tensor, want: torch.Tensor, rtol: float,
               atol: float) -> float:
    """Largest |got - want| / (atol + rtol |want|): <= 1 is within."""
    got, want = got.cpu().double(), want.cpu().double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def infer_pipeline(fused, ladder, pair):
    """BASELINE config #4 once per precision: a 32 x 1080p yuv420p batch
    -> preprocess_nchw (one ladder_i8 launch) -> (32, 3, 224, 224) ->
    InferFilter("sr2x") with the bundled espcn_x2 -> (32, 3, 448, 448).
    fp32 held to the port's CPU run on INFER_CPU_FRAMES frames of the
    same 224^2 input, bf16 to fp32 within the JAX bf16 bound and to the
    CPU's bf16 run within one bf16 step; then the
    ladder alone, the model alone and the chain timed (CUDA events), with
    the model's counted FLOPs against the card's peak for its precision.
    Returns the launch count and the fp32 224^2 input."""
    from gmat_tpu_torch.filters.infer import InferFilter
    from gmat_tpu_torch.ops import csc
    t_phase = time.perf_counter()
    filters = {p: InferFilter("sr2x", precision=p) for p in ("bf16", "fp32")}

    def chain(fb, prec):
        x = fused.preprocess_nchw(fb, OUT, OUT)
        return x, filters[prec](csc.from_nchw(x, "rgbpf32"))

    runs, launches = {}, 0
    for prec in ("bf16", "fp32"):
        zero_counts(ladder)
        x, out = chain(pair[0], prec)
        torch.cuda.synchronize()
        counts = dict(ladder.LAUNCHES)
        check(counts == want_counts(ladder, ladder_i8=1),
              f"infer_pipeline {prec} launches {counts}")
        launches += counts["ladder_i8"]
        rgb = out.planes["rgb"]
        check(out.format == "rgbpf32" and on_card(out)
              and tuple(rgb.shape) == (INFER_BATCH, 2 * OUT, 2 * OUT, 3)
              and bool(torch.isfinite(rgb).all()),
              f"infer_pipeline {prec}: {out.format} {tuple(rgb.shape)}")
        runs[prec] = (x, rgb)
    x, f32 = runs["fp32"]
    n = INFER_CPU_FRAMES
    x_cpu = csc.from_nchw(x[:n].cpu(), "rgbpf32")
    cpu = {p: filters[p](x_cpu).planes["rgb"] for p in ("bf16", "fp32")}
    excess = rel_excess(f32[:n], cpu["fp32"], INFER_RTOL, INFER_ATOL)
    check(excess <= 1.0, f"infer_pipeline fp32 vs CPU: {excess} x the "
          f"rtol {INFER_RTOL} / atol {INFER_ATOL} bound")
    d = (runs["bf16"][1] - f32).abs() * 255.0
    bf_max, bf_mean = float(d.max()), float(d.mean())
    check(bf_max <= BF16_MAX_LSB and bf_mean <= BF16_MEAN_LSB,
          f"infer_pipeline bf16 vs fp32: max {bf_max}, mean {bf_mean} LSB")
    dc = (runs["bf16"][1][:n].cpu() - cpu["bf16"]).abs() * 255.0
    bf_step = rel_excess(runs["bf16"][1][:n], cpu["bf16"], BF16_STEP_RTOL,
                         BF16_STEP_ATOL)
    check(bf_step <= 1.0, f"infer_pipeline bf16 vs CPU bf16: {bf_step} x "
          f"the one-bf16-step bound (rtol {BF16_STEP_RTOL}, atol "
          f"{BF16_STEP_ATOL})")
    del runs, d, f32
    # timing: the ladder alone, the model alone, the chain
    ladder_ms, ladder_runs, ladder_host = event_ms(
        lambda i: fused.preprocess_nchw(pair[i % 2], OUT, OUT))
    xs = [csc.from_nchw(fused.preprocess_nchw(fb, OUT, OUT), "rgbpf32")
          for fb in pair]
    flops = model_flops(filters["fp32"], INFER_BATCH, OUT, OUT)
    timing = {}
    for prec in ("bf16", "fp32"):
        model_ms, model_runs, model_host = event_ms(
            lambda i: filters[prec](xs[i % 2]), calls=3, reps=5)
        ms, chain_runs, host = event_ms(
            lambda i: chain(pair[i % 2], prec), calls=3, reps=5)
        timing[prec] = {
            "chain_ms_per_batch": ms, "chain_runs_ms": chain_runs,
            "chain_host_ms": host, "frames_per_s": INFER_BATCH / ms * 1e3,
            "model_ms_per_batch": model_ms, "model_runs_ms": model_runs,
            "model_host_ms": model_host,
            "model_tflop_per_s": flops / model_ms / 1e9,
            "model_peak_share": flops / (model_ms * 1e-3) / PEAK_FLOPS[prec],
            "peak_flop_per_s": PEAK_FLOPS[prec]}
    emit("infer_pipeline", source=[INFER_BATCH, H, W], net_input=[OUT, OUT],
         output_nchw=[INFER_BATCH, 3, 2 * OUT, 2 * OUT], model="sr2x",
         weights="espcn_x2.npz", launches_ladder_i8=launches,
         fp32_vs_cpu_bound_excess=excess, cpu_frames=n,
         bf16_vs_fp32_max_lsb=bf_max, bf16_vs_fp32_mean_lsb=bf_mean,
         bf16_vs_cpu_bf16_max_lsb=float(dc.max()),
         bf16_vs_cpu_bf16_mean_lsb=float(dc.mean()),
         bf16_vs_cpu_bf16_step_excess=bf_step,
         flops_per_batch=flops, flops_per_frame=flops // INFER_BATCH,
         ladder_ms_per_batch=ladder_ms, ladder_runs_ms=ladder_runs,
         ladder_host_ms=ladder_host, timing=timing,
         phase_s=time.perf_counter() - t_phase)
    return launches, x


def bf16_step(spec, got, vec, want, vec_want) -> dict:
    """The card's bf16 run against the CPU's bf16 run of the same graph:
    float planes and last_output within one bf16 step, u8 planes within
    BF16_STEP_LSB."""
    out = {}
    if vec is not None:
        out["last_output_vs_cpu_bf16_step_excess"] = rel_excess(
            torch.as_tensor(vec), torch.as_tensor(vec_want), BF16_STEP_RTOL,
            BF16_STEP_ATOL)
    if got.fmt.is_float:
        out["vs_cpu_bf16_step_excess"] = max(
            rel_excess(got.planes[k], want.planes[k], BF16_STEP_RTOL,
                       BF16_STEP_ATOL) for k in want.planes)
    else:
        out["max_lsb_vs_cpu_bf16"] = planes_lsb(got, want)
        check(out["max_lsb_vs_cpu_bf16"] <= BF16_STEP_LSB,
              f"{spec} vs CPU bf16: {out['max_lsb_vs_cpu_bf16']} LSB")
    for key in ("last_output_vs_cpu_bf16_step_excess",
                "vs_cpu_bf16_step_excess"):
        check(out.get(key, 0.0) <= 1.0,
              f"{spec} vs CPU bf16: {out.get(key)} x the one-bf16-step "
              f"bound (rtol {BF16_STEP_RTOL}, atol {BF16_STEP_ATOL})")
    return out


def _head(fb, n: int):
    return fb.with_planes({k: v[:n] for k, v in fb.planes.items()})


def infer_models(rgb224):
    """Every other model through FilterGraph, bf16 and fp32: sr2x h128,
    sr3x, classify (on the pipeline's 224^2 input), pose (120^2), luma
    sr2x (32 x 540x960), luma and 3-channel DnCNN (32 x 1080p).  Each is
    checked on INFER_MODEL_CPU_FRAMES frames (the 1080p sources cut to
    INFER_CUT) against the port's CPU runs with the same weights: fp32
    float outputs and last_output within INFER_RTOL / INFER_ATOL of the
    CPU's fp32, fp32 u8 planes within 1 LSB (a rounding edge); bf16
    within the JAX bf16 bound of the CPU's fp32 and within one bf16 step
    (BF16_STEP_RTOL / BF16_STEP_ATOL on floats and last_output,
    BF16_STEP_LSB on u8 planes) of the CPU's bf16; then timed on the
    whole source."""
    from gmat_tpu_torch.filters.graph import FilterGraph
    from gmat_tpu_torch.ops import csc, fused
    t_phase = time.perf_counter()
    yuv1080 = filter_frames(INFER_BATCH, SEED + 17)
    sources = {
        "rgb224": csc.from_nchw(rgb224, "rgbpf32"),
        "rgb120": csc.from_nchw(fused.preprocess_nchw(yuv1080, 120, 120),
                                "rgbpf32"),
        "yuv540": cut_batch(yuv1080, INFER_BATCH, 540, 960),
        "yuv1080": yuv1080}
    n = INFER_MODEL_CPU_FRAMES
    out = {}
    for spec, src in INFER_MODELS:
        fb = sources[src]
        probe = (cut_batch(fb, n, *INFER_CUT) if src == "yuv1080"
                 else _head(fb, n))
        probe_cpu = head_cpu(probe, n)
        res, cpu = {}, {}
        for prec in ("fp32", "bf16"):
            pspec = spec if prec == "bf16" else spec + ":precision=fp32"
            g = FilterGraph(pspec)
            got, _ = g.process(probe)
            torch.cuda.synchronize()
            check(on_card(got), f"{pspec}: output off the card")
            vec = g.filters[-1].last_output
            gc = FilterGraph(pspec)
            cpu[prec] = (gc.process(probe_cpu)[0],
                         gc.filters[-1].last_output)
            want, vec_cpu = cpu["fp32"]
            entry = {}
            if prec == "bf16":
                entry.update(bf16_step(pspec, got, vec, *cpu["bf16"]))
            if vec is not None:
                vec, vec_cpu = torch.as_tensor(vec), torch.as_tensor(vec_cpu)
                check(tuple(vec.shape) == tuple(vec_cpu.shape)
                      and bool(torch.isfinite(vec).all()),
                      f"{pspec}: last_output {tuple(vec.shape)}")
                entry["last_output_vs_cpu_fp32_excess"] = rel_excess(
                    vec, vec_cpu, INFER_RTOL, INFER_ATOL)
                entry["last_output_vs_cpu_fp32_max_abs"] = float(
                    (vec - vec_cpu).abs().max())
                if prec == "fp32":
                    check(entry["last_output_vs_cpu_fp32_excess"] <= 1.0,
                          f"{pspec} last_output vs CPU: "
                          f"{entry['last_output_vs_cpu_fp32_excess']}")
            mx, mean = lsb_stats(got, want)
            entry.update(max_lsb_vs_cpu_fp32=mx, mean_lsb_vs_cpu_fp32=mean,
                         out=f"{got.format} {got.width}x{got.height}")
            if prec == "bf16":
                check(mx <= BF16_MAX_LSB and mean <= BF16_MEAN_LSB,
                      f"{pspec} vs CPU fp32: max {mx}, mean {mean} LSB")
            elif got.fmt.is_float:
                entry["vs_cpu_fp32_excess"] = max(
                    rel_excess(got.planes[k], want.planes[k], INFER_RTOL,
                               INFER_ATOL) for k in want.planes)
                check(entry["vs_cpu_fp32_excess"] <= 1.0,
                      f"{pspec} vs CPU: {entry['vs_cpu_fp32_excess']}")
            else:
                check(mx <= 1, f"{pspec} vs CPU: {mx} LSB")
            del got
            tg = FilterGraph(pspec)
            ms, runs, host = event_ms(lambda i: tg.process(fb), calls=1,
                                      reps=3, warm=1)
            flops = model_flops(tg.filters[-1], fb.batch, fb.height,
                                fb.width)
            entry.update(ms_per_batch=ms, runs_ms=runs, host_ms=host,
                         frames_per_s=fb.batch / ms * 1e3,
                         flops_per_batch=flops,
                         tflop_per_s=flops / ms / 1e9,
                         peak_share=flops / (ms * 1e-3) / PEAK_FLOPS[prec])
            res[prec] = entry
        out[spec] = {"source": [fb.batch, fb.height, fb.width, fb.format],
                     "checked_on": [n, probe.height, probe.width], **res}
    emit("infer_models", models=out, phase_s=time.perf_counter() - t_phase)


def abr_enhance(rungs, src, sizes, bare_fps):
    """The enhanced ABR path once: the ABR source's first batch (32 x
    1080p) -> decode_stream -> metrans.filtered_step with
    ABR_ENHANCE_COMMON (the bundled DnCNN in bf16, back to yuv420p) as
    the common graph -> the int8 ladder -> rung planes on the host.  One
    rungs_i8 launch; the common graph on ABR_ENHANCE_CPU_FRAMES frames
    cut to INFER_CUT within the JAX bf16 bound of the CPU's fp32 run (and
    its difference from the CPU's bf16 run reported); the rungs 0 LSB from
    the rung kernel's plain version on the card's own common output."""
    from gmat_tpu_torch.apps import metrans
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.filters.graph import FilterGraph
    t_phase = time.perf_counter()
    tb = 1.0 / 30.0
    common = GraphTap(FilterGraph(ABR_ENHANCE_COMMON, 30.0))
    zero_counts(rungs)
    t0 = time.perf_counter()
    stream = decode_stream(src, batch=ABR_BATCH)
    try:
        fb, pts, valid = next(iter(stream))
        first_src = fb.with_planes({k: v.clone()
                                    for k, v in fb.planes.items()})
        outs = metrans.filtered_step(fb, pts, valid, sizes, common, None,
                                     {"times": pts * tb}, tb)
        host = []
        for r, (rb, keep) in enumerate(outs):
            check(rb is not None and on_card(rb) and rb.format == "yuv420p"
                  and (rb.width, rb.height) == sizes[r] and keep.all(),
                  f"abr_enhance: rung {r} missing, off the card or "
                  "misshaped")
            host.append({k: rb.planes[k].cpu() for k in "yuv"})
    finally:
        stream.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rungs.LAUNCHES)
    check(counts == {"rungs_i8": 1, "rungs_bf16": 0},
          f"abr_enhance launches {counts}, want 1 rungs_i8")
    check(int(valid) == ABR_BATCH, f"abr_enhance: {valid} frames")
    # the common graph on a cut, card against the CPU
    n = ABR_ENHANCE_CPU_FRAMES
    cut = cut_batch(first_src, n, *INFER_CUT)
    card, _ = FilterGraph(ABR_ENHANCE_COMMON).process(cut)
    cpu16, _ = FilterGraph(ABR_ENHANCE_COMMON).process(head_cpu(cut, n))
    fp32 = ABR_ENHANCE_COMMON.replace("infer=denoise",
                                      "infer=denoise:precision=fp32")
    cpu32, _ = FilterGraph(fp32).process(head_cpu(cut, n))
    mx16, mean16 = lsb_stats(card, cpu16)
    mx32, mean32 = lsb_stats(card, cpu32)
    check(mx32 <= BF16_MAX_LSB and mean32 <= BF16_MEAN_LSB,
          f"abr_enhance common graph vs CPU fp32: max {mx32}, mean "
          f"{mean32} LSB")
    # the rungs against the plain version on the card's own common output
    card_common, _ = common.first
    cpu_common = head_cpu(card_common, card_common.batch)
    plain = rungs.fused_rungs(*(cpu_common.planes[k] for k in "yuv"), sizes)
    err_rungs = 0
    for got_r, want_r in zip(host, plain):
        for k, wp in zip("yuv", want_r):
            check(tuple(got_r[k].shape) == tuple(wp.shape),
                  f"abr_enhance rung plane {tuple(got_r[k].shape)}")
            err_rungs = max(err_rungs, rung_lsb(got_r[k], wp))
    check(err_rungs == 0, f"abr_enhance rungs vs plain: {err_rungs} LSB")
    timed = FilterGraph(ABR_ENHANCE_COMMON, 30.0)
    common_ms, common_runs, common_host = event_ms(
        lambda i: timed.process(first_src), calls=1, reps=3)
    fps = int(valid) / wall
    emit("abr_enhance", source=[ABR_BATCH, H, W], batch=ABR_BATCH,
         common=ABR_ENHANCE_COMMON, rungs=[f"{ow}x{oh}" for ow, oh in sizes],
         launches=counts, common_checked_on=[n, *INFER_CUT],
         common_vs_cpu_fp32_max_lsb=mx32, common_vs_cpu_fp32_mean_lsb=mean32,
         common_vs_cpu_bf16_max_lsb=mx16, common_vs_cpu_bf16_mean_lsb=mean16,
         rungs_max_lsb_vs_plain_on_card_common=err_rungs,
         common_ms_per_batch=common_ms, common_runs_ms=common_runs,
         common_host_ms=common_host, wall_s=wall,
         source_frames_per_s=fps, bare_ladder_source_frames_per_s=bare_fps,
         phase_s=time.perf_counter() - t_phase)
    return counts


def round_trip_mean(fb, out) -> float:
    """Largest per-plane mean |decoded - source| in LSBs."""
    return max(float((out.planes[k].to(torch.int32)
                      - fb.planes[k].to(torch.int32)).abs().float().mean())
               for k in "yuv")


def jpeg_still(src):
    """BASELINE config #5 (the nvjpeg analog): the ABR source's first 32
    frames -> jpeg_tpu.encode_batch at JPEG_Q in each JPEG_VARIANTS ->
    decode_batch on the card.  Against the port's CPU run on
    JPEG_CPU_FRAMES frames: int16 coefficients equal (at most
    JPEG_COEF_SHARE of them 1 apart), bytes equal wherever the
    coefficients are, every variant's decoded planes within 1 LSB of the
    CPU's decode; the round trip of
    smooth content within the JAX mean bound.  Timed: the coefficient
    program and the pixel program per batch (CUDA events) against their
    byte bounds, the host entropy coding, encode and decode images/s."""
    from gmat_tpu_torch.av import jpeg_tpu
    from gmat_tpu_torch.av.ingest import decode_stream
    from gmat_tpu_torch.core.frame import to_device
    t_phase = time.perf_counter()
    stream = decode_stream(src, batch=ABR_BATCH)
    try:
        fb, _pts, _valid = next(iter(stream))
        fb = fb.with_planes({k: v.clone() for k, v in fb.planes.items()})
    finally:
        stream.close()
    n = JPEG_CPU_FRAMES
    cpu_fb = head_cpu(fb, n)
    # the coefficients, card against CPU
    subsamp, qy, qc, coefs = jpeg_tpu.coefficients(fb, JPEG_Q)
    _, _, _, coefs_cpu = jpeg_tpu.coefficients(cpu_fb, JPEG_Q)
    differ = total = worst = 0
    frame_equal = np.ones(n, bool)
    for c, cc in zip(coefs, coefs_cpu):
        check(c.device.type == "cuda" and c.dtype == torch.int16,
              f"jpeg_still coefficients {c.dtype} on {c.device}")
        d = (c[:n].cpu().to(torch.int32) - cc.to(torch.int32)).abs()
        differ += int(d.count_nonzero())
        total += d.numel()
        worst = max(worst, int(d.max()))
        frame_equal &= (d.reshape(n, -1).amax(dim=1) == 0).numpy()
    check(worst <= 1 and differ <= JPEG_COEF_SHARE * total,
          f"jpeg_still coefficients vs CPU: {differ} of {total} differ, "
          f"max {worst}")
    # the CPU run's bytes: encode_batch's host half on its coefficients
    # (encode_batch is coefficients() then entropy_encode()); every
    # variant codes the same coefficients losslessly, so one CPU decode
    # of the first variant's bytes is every variant's reference
    planes = [np.ascontiguousarray(c.cpu().numpy()) for c in coefs]
    planes_cpu = [np.ascontiguousarray(c.numpy()) for c in coefs_cpu]
    out_cpu = None
    variants = {}
    for name, kw in JPEG_VARIANTS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        datas = jpeg_tpu.encode_batch(fb, JPEG_Q, **kw)
        enc_s = time.perf_counter() - t0
        want = jpeg_tpu.entropy_encode(planes_cpu, cpu_fb.width,
                                       cpu_fb.height, subsamp, qy, qc, **kw)
        same = [a == b for a, b in zip(datas[:n], want)]
        check(all(s for s, eq in zip(same, frame_equal) if eq),
              f"jpeg_still {name}: bytes differ from the CPU's where the "
              f"coefficients are equal ({same}, {frame_equal.tolist()})")
        t0 = time.perf_counter()
        jpeg_tpu.entropy_encode(planes, fb.width, fb.height, subsamp, qy, qc,
                                **kw)
        entropy_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jpeg_tpu.decode_batch(datas)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        check(on_card(out) and out.format == "yuv420p"
              and (out.width, out.height) == (W, H), f"jpeg_still {name} "
              f"decode: {out.format} {out.width}x{out.height}")
        if out_cpu is None:
            out_cpu = jpeg_tpu.decode_batch(want, device="cpu")
        dec_err = planes_lsb(head_cpu(out, n), out_cpu)
        check(dec_err <= 1, f"jpeg_still {name} decode vs CPU: {dec_err} LSB")
        t0 = time.perf_counter()
        jpeg_tpu.entropy_decode(datas)
        entropy_dec_s = time.perf_counter() - t0
        variants[name] = {
            "bytes_per_image": sum(len(d) for d in datas) / len(datas),
            "cpu_frames_bytes_equal": int(sum(same)), "encode_s": enc_s,
            "encode_images_per_s": fb.batch / enc_s,
            "host_entropy_encode_ms": entropy_s * 1e3,
            "decode_s": dec_s, "decode_images_per_s": fb.batch / dec_s,
            "host_entropy_decode_ms": entropy_dec_s * 1e3,
            "decode_max_lsb_vs_cpu": dec_err,
            "source_round_trip_mean_lsb": round_trip_mean(fb, out)}
    # the round trip of smooth content (the JAX test's kind) at JPEG_Q
    smooth = filter_frames(FILTER_CPU_FRAMES, SEED + 23)
    back = jpeg_tpu.decode_batch(jpeg_tpu.encode_batch(smooth, JPEG_Q))
    rt = round_trip_mean(smooth, back)
    check(rt < JPEG_RT_MEAN, f"jpeg_still smooth round trip: mean {rt} LSB")
    # the device programs, timed from prebuilt inputs
    fb2 = fb.with_planes({k: torch.flip(v, (0,)).contiguous()
                          for k, v in fb.planes.items()})
    pair = (fb, fb2)
    coef_ms, coef_runs, coef_host = event_ms(
        lambda i: jpeg_tpu.coefficients(pair[i % 2], JPEG_Q), calls=2,
        reps=5)
    w, h, _s, hcoefs, tables = jpeg_tpu.entropy_decode(
        jpeg_tpu.encode_batch(fb, JPEG_Q))
    dcoefs = [to_device(c, "cuda") for c in hcoefs]
    dtables = [to_device(q, "cuda") for q in tables]
    pix_ms, pix_runs, pix_host = event_ms(
        lambda i: jpeg_tpu.pixels(dcoefs, dtables), calls=2, reps=5)
    samples = sum(v.numel() for v in fb.planes.values())
    coef_bytes = samples * (1 + 2)      # u8 in, int16 out (and back)
    bound_ms = coef_bytes / HBM_BYTES_PER_S * 1e3
    emit("jpeg_still", source=[fb.batch, H, W], quality=JPEG_Q,
         coefficients_vs_cpu={"frames": n, "differ": differ,
                              "total": total, "max_abs": worst,
                              "allowed_share": JPEG_COEF_SHARE},
         variants=variants, smooth_round_trip_mean_lsb=rt,
         coefficient_program={"ms_per_batch": coef_ms, "runs_ms": coef_runs,
                              "host_ms": coef_host, "bytes": coef_bytes,
                              "bound_ms": bound_ms,
                              "bound_share": bound_ms / coef_ms},
         pixel_program={"ms_per_batch": pix_ms, "runs_ms": pix_runs,
                        "host_ms": pix_host, "bytes": coef_bytes,
                        "bound_ms": bound_ms,
                        "bound_share": bound_ms / pix_ms},
         phase_s=time.perf_counter() - t_phase)


def stills_av(tmp, src):
    """The still paths that need libav*, where the host runtime can be
    built: overlay=path= with a .jpg written by av/jpeg.py on a 1080p
    batch, card against CPU (0 LSB); gmat-extract's JPEG output on the
    card, bytes equal to device="cpu"; a 1080p frame the card's graph
    made through heif.encode_still and decode_still, planes and bytes
    equal to the CPU's round trip; the CLI's .heic and .jpg sinks on 4
    frames of the ABR source, bytes equal to the CPU run's; otherwise say
    why not."""
    if not av_precondition("stills_av"):
        return None
    from gmat_tpu_torch.apps import extract
    from gmat_tpu_torch.av import jpeg
    from gmat_tpu_torch.filters.graph import FilterGraph
    rng = np.random.default_rng(SEED + 29)
    still = os.path.join(tmp, "still.jpg")
    with open(still, "wb") as f:
        f.write(jpeg.encode_rgb_to_jpeg(
            rng.integers(0, 256, (270, 480, 3)).astype(np.uint8)))
    fb = filter_frames(FILTER_CPU_FRAMES, SEED + 31)
    spec = f"overlay=path={still}:x=-101+n*64:y=main_h-overlay_h-n"
    got, _ = FilterGraph(spec).process(fb, pts=np.arange(fb.batch))
    want, _ = FilterGraph(spec).process(head_cpu(fb, fb.batch),
                                        pts=np.arange(fb.batch))
    err = planes_lsb(got, want)
    check(err == 0, f"stills_av overlay=path= vs CPU: {err} LSB")
    clip = os.path.join(tmp, "stills.mp4")
    smart_clip(clip)
    outs = {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(tmp, f"extract_{dev}")
        os.makedirs(d)
        check(extract.main(["-i", clip, "-interval", "20", "-o",
                            os.path.join(d, "f_%d.jpg")], device=dev) == 0,
              f"gmat-extract on {dev}")
        outs[dev] = [open(os.path.join(d, name), "rb").read()
                     for name in sorted(os.listdir(d))]
    check(len(outs["cuda"]) == SMART_FRAMES // 20
          and outs["cuda"] == outs["cpu"],
          f"gmat-extract JPEG: {len(outs['cuda'])} files on the card, "
          "bytes equal to the CPU's: " + str(outs["cuda"] == outs["cpu"]))
    # HEIF: a card-made 1080p frame round trip, against the CPU's
    from gmat_tpu_torch.av import heif
    blobs, planes = {}, {}
    for dev, x in (("cuda", fb), ("cpu", head_cpu(fb, fb.batch))):
        g, _ = FilterGraph(STILLS_HEIF_GRAPH).process(x)
        yuv = [g.planes[k][0].cpu().numpy() for k in "yuv"]
        blobs[dev] = heif.encode_still(*yuv, crf=STILLS_HEIF_CRF)
        planes[dev] = heif.decode_still(blobs[dev])
    check(blobs["cuda"] == blobs["cpu"]
          and all(np.array_equal(a, b) for a, b in zip(planes["cuda"],
                                                        planes["cpu"])),
          "stills_av HEIF round trip: bytes or planes differ from the CPU's")
    sinks = {}
    for ext in ("heic", "jpg"):
        for dev in ("cuda", "cpu"):
            d = os.path.join(tmp, f"{ext}_{dev}")
            cli_run(["-i", src, "-vf", STILLS_HEIF_GRAPH, "-o",
                     f"s_%d.{ext}", "-frames", "4", "-batch", "4"], dev, d)
            sinks[ext, dev] = [
                open(os.path.join(d, f"s_{i}.{ext}"), "rb").read()
                for i in range(4)]
        check(sinks[ext, "cuda"] == sinks[ext, "cpu"], f"stills_av CLI "
              f".{ext} sink: bytes differ from the CPU run's")
    emit("stills_av", run=True, overlay_path_max_lsb_vs_cpu=err,
         extract_jpegs=len(outs["cuda"]), extract_bytes_equal_cpu=True,
         heif_bytes=len(blobs["cuda"]), heif_equal_cpu=True,
         cli_heic_stills=len(sinks["heic", "cuda"]),
         cli_jpg_stills=len(sinks["jpg", "cuda"]), cli_bytes_equal_cpu=True)
    return err


class GraphDevices:
    """While active, every FilterGraph records the device of each batch it
    returns (the CLI builds its graph inside main())."""

    def __enter__(self):
        from gmat_tpu_torch.filters import graph
        self.module, self.real, self.seen = graph, graph.FilterGraph, []
        seen = self.seen

        class Recording(self.real):
            def process(self, fb, **kw):
                out, keep = super().process(fb, **kw)
                seen.append(out.device.type)
                return out, keep
        graph.FilterGraph = Recording
        return self.seen

    def __exit__(self, *exc):
        self.module.FilterGraph = self.real


def cli_run(argv, device, workdir):
    """apps.cli.main on argv with its output under workdir: (exit code,
    frames in, frames out, the CLI's fps, wall seconds, devices of the
    graph's output batches)."""
    from gmat_tpu_torch.apps import cli
    os.makedirs(workdir, exist_ok=True)
    argv = list(argv)
    i = argv.index("-o") + 1
    if argv[i] != "null":
        argv[i] = os.path.join(workdir, argv[i])
    err = io.StringIO()
    t0 = time.perf_counter()
    with GraphDevices() as seen, contextlib.redirect_stderr(err):
        rc = cli.main(argv, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = re.search(r"gmat: (\d+) frames in, (\d+) frames out, ([\d.]+)s, "
                  r"([\d.]+) fps", err.getvalue())
    check(rc == 0 and m is not None, f"gmat {argv}: rc {rc}, "
          f"{err.getvalue()[-400:]}")
    return (rc, int(m.group(1)), int(m.group(2)), float(m.group(4)), wall,
            seen)


def cli_counts(argv, total: int, batch: int):
    """(frames in, frames out) as the JAX CLI counts them: every frame of
    each batch it reads, up to -frames out."""
    frames = int(argv[argv.index("-frames") + 1]) if "-frames" in argv else 0
    if not frames:
        return total, total
    return min(total, -(-frames // batch) * batch), min(frames, total)


def y4m_frames(path: str, n: int):
    from gmat_tpu_torch.av.rawvideo import Y4MReader
    rd = Y4MReader(path)
    try:
        return [f[:3] for _, f in zip(range(n), rd.frames())]
    finally:
        rd.close()


def np_lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def trace_kernels(path: str) -> dict:
    """CUDA kernel events of a Chrome trace: count and summed time, over
    the span of all events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in timed)
            - min(e["ts"] for e in timed)) / 1e3 if timed else 0.0
    return {"kernel_events": len(kern),
            "kernel_ms": sum(e.get("dur", 0) for e in kern) / 1e3,
            "memcpy_events": sum(1 for e in events
                                 if e.get("cat") == "gpu_memcpy"),
            "trace_span_ms": span, "trace_events": len(events)}


def cli_phase(src, tmp):
    """The gmat CLI as a user runs it, on the 96-frame 1080p ABR source:
    scale + unsharp to 720p Y4M; the tensorrt doc pipeline, 540p -> sr2x ->
    1080p Y4M in bf16 and fp32; the user guide's nvcv pipeline to PNG
    stills; 224^2 rgbpf32 into the null sink under a torch.profiler trace.
    Each run: frames in and out as the JAX CLI counts them, every graph
    output batch on the card, frames/s; its CPU run on CLI_CPU_FRAMES
    frames against the card's first frames (the stills' bytes equal
    wherever their planes are); the trace holds CUDA kernels.  Returns
    the launches of each kernel over the card's runs."""
    from gmat_tpu_torch.ops import ladder, rungs
    from gmat_tpu_torch.utils import tracing
    from gmat_tpu_torch.utils.png import read_png
    t_phase = time.perf_counter()
    runs, launches = {}, {}
    for name, args in CLI_RUNS:
        card_dir = os.path.join(tmp, f"cli_{name}_card")
        zero_counts(ladder)
        zero_counts(rungs)
        trace = None
        if name == "null_224":
            tracing.start_trace(os.path.join(tmp, "cli_trace"))
        try:
            _rc, n_in, n_out, cli_fps, wall, seen = cli_run(
                ["-i", src, "-batch", str(ABR_BATCH)] + args, "cuda",
                card_dir)
        finally:
            if name == "null_224":
                trace = trace_kernels(tracing.stop_trace())
        for k, v in {**ladder.LAUNCHES, **rungs.LAUNCHES,
                     **wide_counts_of(ladder),
                     **wide_counts_of(rungs)}.items():
            launches[k] = launches.get(k, 0) + v
        want = cli_counts(args, ABR_FRAMES, ABR_BATCH)
        check((n_in, n_out) == want, f"cli {name}: {n_in} in, {n_out} "
              f"out, want {want}")
        check(seen and all(d == "cuda" for d in seen),
              f"cli {name}: graph outputs on {sorted(set(seen))}")
        entry = {"argv": args, "frames_in": n_in, "frames_out": n_out,
                 "cli_fps": cli_fps, "wall_s": wall,
                 "frames_per_s": n_in / wall, "batches": len(seen)}
        if trace is not None:
            check(trace["kernel_events"] >= 1,
                  f"cli {name}: the trace holds no CUDA kernel: {trace}")
            entry["trace"] = trace
            entry["kernel_busy_share"] = trace["kernel_ms"] / (wall * 1e3)
            runs[name] = entry
            continue
        cpu_dir = os.path.join(tmp, f"cli_{name}_cpu")
        cut = args[:args.index("-frames")] if "-frames" in args else args
        _rc, c_in, c_out, _fps, cpu_wall, cpu_seen = cli_run(
            ["-i", src] + cut + ["-frames", str(CLI_CPU_FRAMES),
                                 "-batch", str(CLI_CPU_FRAMES)],
            "cpu", cpu_dir)
        check((c_in, c_out) == (CLI_CPU_FRAMES, CLI_CPU_FRAMES)
              and all(d == "cpu" for d in cpu_seen),
              f"cli {name} on the CPU: {c_in} in, {c_out} out, {cpu_seen}")
        entry["cpu_wall_s"] = cpu_wall
        out = args[args.index("-o") + 1]
        if out.endswith(".y4m"):
            card = y4m_frames(os.path.join(card_dir, out), CLI_CPU_FRAMES)
            cpu = y4m_frames(os.path.join(cpu_dir, out), CLI_CPU_FRAMES)
            check(len(card) == len(cpu) == CLI_CPU_FRAMES
                  and all(a.shape == b.shape for fa, fb in zip(card, cpu)
                          for a, b in zip(fa, fb)),
                  f"cli {name}: frames or shapes differ from the CPU's")
            err = max(np_lsb(a, b) for fa, fb in zip(card, cpu)
                      for a, b in zip(fa, fb))
            tol = BF16_STEP_LSB if name == "sr2x_bf16" else CLI_LSB
            check(err <= tol, f"cli {name} vs CPU: {err} LSB > {tol}")
            entry.update(max_lsb_vs_cpu=err, out_shape=list(card[0][0].shape))
        else:
            # the stills: planes within CLI_LSB of the CPU's, bytes equal
            # wherever the planes are
            errs, same = [], []
            for i in range(CLI_CPU_FRAMES):
                blobs = [open(os.path.join(d, out % i), "rb").read()
                         for d in (card_dir, cpu_dir)]
                a, b = (read_png(x) for x in blobs)
                check(a.shape == b.shape, f"cli {name}: still {i} shape")
                errs.append(np_lsb(a, b))
                same.append(blobs[0] == blobs[1])
                check(same[-1] or errs[-1] > 0, f"cli {name}: still {i} "
                      "bytes differ from the CPU's on equal planes")
            check(max(errs) <= CLI_LSB,
                  f"cli {name} stills vs CPU: {max(errs)} LSB")
            n_files = len(os.listdir(card_dir))
            check(n_files == n_out, f"cli {name}: {n_files} stills")
            entry.update(max_lsb_vs_cpu=max(errs), bytes_equal=same,
                         stills=n_files, still_shape=list(a.shape))
        runs[name] = entry
        shutil.rmtree(card_dir, ignore_errors=True)
        shutil.rmtree(cpu_dir, ignore_errors=True)
    emit("cli", run=True, source=[ABR_FRAMES, H, W], batch=ABR_BATCH,
         cpu_frames=CLI_CPU_FRAMES, runs=runs, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches


# scale-out: the sharded main path over a (1, 1) and a (2, 2) mesh laid on
# the one card, the tensor-parallel ESPCN over a (2, 2) mesh, then the
# distributed self-test workloads in a process group of one (NCCL) and of
# two processes on the card (gloo)
SCALE_OUT_MESHES = ((1, 1), (2, 2))
TP_BATCH, TP_ATOL = 32, 1e-4
DRYRUN_TIMEOUT_S = 240
# the shared-memory ring: a producer process fills a ring of 1080p I420
# slots that the card's consumer drains in ABR_BATCH batches
SHM_FRAMES, SHM_SLOTS = 96, 8
# gmat-perf: the device cases (kernels they must launch), then the libav*
# cases, run where libavcodec exists on the smart-decode clip
PERF_CASES = (("ladder", ("ladder_bf16",)), ("ladder10", ("ladder_bf16",)),
              ("rungs", ("rungs_i8", "rungs_bf16")),
              ("infer", ("ladder_i8",)), ("graph", ("rungs_i8",)),
              ("sustained", ("ladder_i8",)), ("jpeg", ()),
              ("pipeline", ("ladder_i8",)))
PERF_AV_CASES = ("decode", "encode", "extract", "heif", "mjpeg", "mjpegdec",
                 "ingest", "saturation")
# the audio lane: 10 s of seeded 48 kHz stereo PCM through one chain
AUDIO_RATE, AUDIO_SECONDS, AUDIO_BLOCK = 48000, 10, 4800
AUDIO_CHAIN = ("atempo=1.25", "volume=0.8", "afade=t=in:d=1",
               "aecho=0.8:0.9:40:0.4", "loudnorm", "dynaudnorm")


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def scale_out_phase(bufs, fb10):
    """parallel/: ShardedPipeline(preprocess_nchw) on the 64 x 1080p batch
    over a (1, 1) and a (2, 2) mesh of cuda:0, equal to the unsharded call
    with one ladder_i8 launch per data row; over (2, 2) the 10-bit batch
    (one ladder_bf16 a row) and the ABR rung ladders of the first 32
    frames (`metrans.ladder_step`: 720p/360p, one rungs_i8 a row;
    720p/540p/360p, one rungs_bf16 a row), each equal to its unsharded
    call; the tensor-parallel ESPCN x2
    (fp32, the bundled weights) on 32 x 224^2 over a (2, 2) mesh against
    the unsharded model; the self-test's ladder workload at 1080p and one
    dp x tp train step in a process group of one (NCCL); both again as two
    processes on the card (gloo, which stages collectives through the
    host: NCCL refuses two ranks on one card).  Returns the launches of
    each kernel over the in-process runs."""
    from gmat_tpu_torch.apps.metrans import ladder_step
    from gmat_tpu_torch.filters.infer import InferFilter
    from gmat_tpu_torch.models import sr
    from gmat_tpu_torch.ops import fused, ladder, rungs
    from gmat_tpu_torch.parallel import distributed as dist
    from gmat_tpu_torch.parallel import mesh as pm
    from gmat_tpu_torch.parallel.pipeline import ShardedPipeline
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    launches = {}
    single = fused.preprocess_nchw(bufs[0], OUT, OUT)
    single_ms = event_ms(lambda i: fused.preprocess_nchw(bufs[i % 2], OUT,
                                                         OUT))[0]
    meshes = {}
    for n_data, n_model in SCALE_OUT_MESHES:
        mesh = pm.make_mesh(n_data, n_model, [card] * (n_data * n_model))
        pipe = ShardedPipeline(lambda b: fused.preprocess_nchw(b, OUT, OUT),
                               mesh)
        zero_counts(ladder)
        got = pipe(bufs[0])
        torch.cuda.synchronize()
        counts = dict(ladder.LAUNCHES)
        add_counts(launches, counts)
        add_counts(launches, wide_counts_of(ladder))
        check(counts == want_counts(ladder, ladder_i8=n_data),
              f"sharded {n_data}x{n_model} launches {counts}")
        err = lsb(got, single)
        check(tuple(got.shape) == tuple(single.shape) and err == 0,
              f"sharded {n_data}x{n_model} vs unsharded: {err} LSB")
        ms = event_ms(lambda i: pipe(bufs[i % 2]), calls=5, reps=5)[0]
        meshes[f"{n_data}x{n_model}"] = {
            "launches": counts, "max_lsb_vs_unsharded": err, "ms": ms,
            "frames_per_s": N / ms * 1e3}

    # K2 and K4 over the (2, 2) mesh: the 10-bit batch and a rung ladder
    mesh = pm.make_mesh(2, 2, [card] * 4)
    fb_abr = bufs[0].with_planes({k: v[:ABR_BATCH]
                                  for k, v in bufs[0].planes.items()})
    for name, fb, fn, kname, module in (
            ("10bit_2x2", fb10, lambda b: fused.preprocess_nchw(b, OUT, OUT),
             "ladder_bf16", ladder),
            ("rungs_2x2", fb_abr, lambda b: ladder_step(b, LADDER_1080_I8),
             "rungs_i8", rungs),
            ("rungs_bf16_2x2", fb_abr, lambda b: ladder_step(b, LADDER_1080),
             "rungs_bf16", rungs)):
        pipe = ShardedPipeline(fn, mesh)
        want = fn(fb)
        zero_counts(module)
        got = pipe(fb)
        torch.cuda.synchronize()
        counts = dict(module.LAUNCHES)
        add_counts(launches, counts)
        add_counts(launches, wide_counts_of(module))
        check(counts == want_counts(module, **{kname: 2}),
              f"sharded {name} launches {counts}")
        if module is rungs:
            err = max(rung_lsb(g.planes[k], w.planes[k])
                      for g, w in zip(got, want) for k in "yuv")
        else:
            err = lsb(got, want)
        check(err == 0, f"sharded {name} vs unsharded: {err} LSB")
        ms = event_ms(lambda i: pipe(fb), calls=5, reps=5)[0]
        meshes[name] = {"launches": counts, "max_lsb_vs_unsharded": err,
                        "ms": ms, "unsharded_ms": event_ms(
                            lambda i: fn(fb), calls=5, reps=5)[0]}

    params = InferFilter(model="sr2x", precision="fp32").params_on(card)
    x = single[:TP_BATCH]
    placed = pm.shard_sr_params(params, mesh)

    def tp(xx):
        parts = torch.chunk(xx, 2)
        return torch.cat([pm.sr_apply_tp(placed[r], parts[r])
                          for r in range(2)])
    got, want = tp(x), sr.apply(params, x)
    tp_err = float((got - want).abs().max())
    check(tuple(got.shape) == (TP_BATCH, 3, 2 * OUT, 2 * OUT)
          and bool(torch.isfinite(got).all()) and tp_err <= TP_ATOL,
          f"tensor-parallel sr2x vs unsharded: {tp_err}")
    tp_ms = event_ms(lambda i: tp(x), calls=3, reps=5)[0]
    full_ms = event_ms(lambda i: sr.apply(params, x), calls=3, reps=5)[0]

    # the self-test workloads in a process group of one, on NCCL
    argv = ["--selftest-worker", "--coordinator", "in-process",
            "--num-processes", "1", "--process-id", "0",
            "--devices-per-host", "4", "--platform", "cuda",
            "--height", str(H), "--width", str(W), "--out-size", str(OUT)]
    args = dist.worker_args(argv)
    dist.init_distributed(f"127.0.0.1:{dist.free_port()}", 1, 0,
                          local_device_count=4, platform="cuda",
                          timeout=DRYRUN_TIMEOUT_S)
    nccl = {}
    try:
        check(torch.distributed.get_backend() == "nccl", "backend")
        for workload in ("ladder", "train"):
            args.workload = workload
            zero_counts(ladder)
            t0 = time.perf_counter()
            rec = dist.run_workload(args)
            torch.cuda.synchronize()
            counts = dict(ladder.LAUNCHES)
            add_counts(launches, counts)
            add_counts(launches, wide_counts_of(ladder))
            check(counts["ladder_i8"] + counts["ladder_bf16"] >= 2
                  and np.isfinite(rec["loss"]),
                  f"NCCL {workload}: {rec}, launches {counts}")
            nccl[workload] = {**rec, "launches": counts,
                              "wall_s": time.perf_counter() - t0}
    finally:
        dist.shutdown()

    # two processes on one card: NCCL refuses that, so the group is gloo
    gloo = {}
    for workload, extra in (("train", []),
                            ("ladder", ["--height", str(H), "--width",
                                        str(W), "--out-size", str(OUT)])):
        t0 = time.perf_counter()
        recs = dist.dryrun_multihost(2, 2, timeout=DRYRUN_TIMEOUT_S,
                                     workload=workload, platform="cuda",
                                     extra_args=extra)
        check(all(r["backend"] == "gloo" for r in recs),
              f"two ranks on one card: backend {recs}")
        gloo[workload] = {"records": recs,
                          "wall_s": time.perf_counter() - t0}
    check(gloo["train"]["records"][0]["loss"]
          == gloo["train"]["records"][1]["loss"], "gloo losses differ")
    emit("scale_out", meshes=meshes, unsharded_ms=single_ms,
         tensor_parallel={"batch": TP_BATCH, "mesh": [2, 2],
                          "max_abs_err_vs_unsharded": tp_err, "ms": tp_ms,
                          "unsharded_ms": full_ms},
         nccl_world_1=nccl, gloo_2_ranks=gloo, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches


def ring_base(w: int, h: int, seed: int):
    """The shared-memory phase's base frame: frame i is it plus i (mod
    256), so the card can check every sample without a host copy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def ring_producer(name: str, w: int, h: int, slots: int, n: int,
                  seed: int, span) -> None:
    """A spawned process: writes n I420 frames into the ring `name`, and
    the wall-clock times of its first and last put into `span`."""
    from gmat_tpu_torch.av.shm_ring import ShmRing
    ring = ShmRing(w, h, slots, name=name, create=False)
    try:
        base = ring_base(w, h, seed)
        span[0] = time.time()
        for i in range(n):
            ring.put(*(p + np.uint8(i % 256) for p in base), pts=i)
        span[1] = time.time()
        ring.set_eof()
    except BaseException as e:
        ring.set_error(f"{type(e).__name__}: {e}")
        raise
    finally:
        ring.close()


def shm_ring_phase(tmp):
    """av/shm_ring: a producer process writes SHM_FRAMES synthetic 1080p
    I420 frames into a ShmRing; this process batches them through pinned
    buffers to the card (av/ingest) and runs preprocess_nchw (one
    ladder_i8 a batch); every frame arrives bit-equal (checked on the
    card), frames/s.  Then the decode workers (decode_stream_multiproc,
    two libx264 decode processes) where libavcodec exists.  Returns the
    launches of each kernel."""
    import multiprocessing
    from gmat_tpu_torch.av import ingest
    from gmat_tpu_torch.av.shm_ring import ShmRing, decode_stream_multiproc
    from gmat_tpu_torch.ops import fused, ladder
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    ring = ShmRing(W, H, SHM_SLOTS)
    ctx = multiprocessing.get_context("spawn")
    span = ctx.Array("d", 2)
    t_wall = time.time()
    proc = ctx.Process(target=ring_producer, args=(
        ring.name, W, H, SHM_SLOTS, SHM_FRAMES, SEED, span), daemon=True)
    proc.start()
    base = [torch.from_numpy(p).to(card) for p in ring_base(W, H, SEED)]

    def frames():
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        while time.monotonic() < deadline:
            item = ring.get_nowait()
            if item is not None:
                yield item
                continue
            if ring.eof and ring.empty():
                check(ring.error is None, f"ring producer: {ring.error}")
                return
            check(proc.is_alive() or not ring.empty() or ring.eof,
                  f"ring producer died (exitcode {proc.exitcode})")
            time.sleep(0.001)
        check(False, "ring producer timed out")

    try:
        q = ingest._queue(frames(), ABR_BATCH, 3, card, W, H, "bt709",
                          "yuv420p")
        zero_counts(ladder)
        n, bad, batches, t_first, arrivals = 0, 0, 0, None, []
        try:
            for fb, pts, valid in q:
                arrivals.append(time.time() - t_wall)
                if t_first is None:
                    t_first = time.perf_counter()
                out = fused.preprocess_nchw(fb, OUT, OUT)
                idx = torch.as_tensor(pts[:valid] % 256,
                                      device=card).to(torch.uint8)
                for k, b in zip("yuv", base):
                    want = b[None] + idx[:, None, None]
                    bad += int((fb.planes[k][:valid] != want).flatten(1)
                               .any(1).sum())
                n += int(valid)
                batches += 1
            torch.cuda.synchronize()
            t_last = time.perf_counter()
        finally:
            q.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_phase
        counts = dict(ladder.LAUNCHES)
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
        ring.close(unlink=True)
    check(n == SHM_FRAMES and bad == 0, f"ring: {n} frames, {bad} differ")
    check(counts == want_counts(ladder, ladder_i8=batches),
          f"ring launches {counts}")
    check(tuple(out.shape[1:]) == (3, OUT, OUT)
          and bool(torch.isfinite(out).all()), "ring ladder output")
    workers = {"run": False, "why": "no libavcodec on this machine"}
    if av_precondition("shm_ring_decode"):
        clip = os.path.join(tmp, "ring.mp4")
        smart_clip(clip)
        got = 0
        q = decode_stream_multiproc(clip, procs=2, batch=16, device=card)
        try:
            for fb, _pts, valid in q:
                check(fb.device == card, "decode worker batch off the card")
                got += int(valid)
        finally:
            q.close()
        check(got == 2 * SMART_FRAMES, f"decode workers: {got} frames")
        workers = {"run": True, "procs": 2, "frames": got}
    emit("shm_ring", frames=n, batches=batches, bit_equal=bad == 0,
         source=[SHM_FRAMES, H, W], slots=SHM_SLOTS, wall_s=wall,
         frames_per_s=n / wall, producer_first_put_s=span[0] - t_wall,
         producer_puts_s=span[1] - span[0],
         producer_frames_per_s=SHM_FRAMES / max(span[1] - span[0], 1e-9),
         batch_arrival_s=arrivals,
         steady_frames_per_s=(n - ABR_BATCH) / max(t_last - t_first, 1e-9),
         launches=counts, decode_workers=workers,
         phase_s=time.perf_counter() - t_phase)
    return counts


def perf_phase(src, tmp):
    """gmat-perf (apps/perf.main, device="cuda"): the device cases at the
    harness's 1080p defaults, `pipeline` on the ABR source; each case's
    JSON line and the kernel launches counted while it ran, every case's
    kernels launched; the libav* cases where libavcodec exists (else run:
    false).  Returns the launches of each kernel over the cases."""
    from gmat_tpu_torch.apps import perf
    from gmat_tpu_torch.ops import ladder, rungs
    t_phase = time.perf_counter()
    launches, cases = {}, {}
    av = av_precondition("perf_av")
    clip = os.path.join(tmp, "perf.mp4")
    if av:
        smart_clip(clip)
    av_args = {"decode": ["-i", clip], "extract": ["-i", clip],
               "ingest": ["-i", clip, "-procs", "2"],
               "saturation": ["-i", clip, "-procs", "1"]}
    small = ["-width", str(SMART_SIZE[0]), "-height", str(SMART_SIZE[1]),
             "-frames", "16"]
    runs = [(c, k, ["-i", src] if c == "pipeline" else [])
            for c, k in PERF_CASES]
    runs += [(c, (), av_args.get(c, small)) for c in PERF_AV_CASES]
    for case, kernels, extra in runs:
        if case in PERF_AV_CASES and not av:
            cases[case] = {"run": False, "why": "no libavcodec"}
            continue
        zero_counts(ladder)
        zero_counts(rungs)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = perf.main([case, *extra], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in {**ladder.LAUNCHES, **rungs.LAUNCHES,
                                    **wide_counts_of(ladder),
                                    **wide_counts_of(rungs)}.items() if v}
        add_counts(launches, counts)
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        check(rc == 0 and rec["case"] == case, f"perf {case}: rc {rc}")
        check(all(counts.get(k, 0) > 0 for k in kernels),
              f"perf {case}: launches {counts}, want {kernels}")
        cases[case] = {"run": True, "result": rec, "launches": counts,
                       "wall_s": wall}
        emit("perf_case", case=case, result=rec, launches=counts,
             wall_s=wall)
    emit("perf", cases=sorted(cases), launches=launches,
         av_cases={c: cases[c]["run"] for c in PERF_AV_CASES},
         phase_s=time.perf_counter() - t_phase)
    return launches


def audio_phase():
    """The audio lane (av/audio_filters): AudioFilterStream over
    AUDIO_SECONDS of seeded 48 kHz stereo PCM through atempo, volume,
    afade, aecho, loudnorm and dynaudnorm, pushed in 100 ms blocks:
    samples/s and a checksum of the output.  loudnorm runs at 192 kHz:
    through libswresample where it loads, else between two aresample
    stages (their linear lane)."""
    import hashlib
    from gmat_tpu_torch.av import audio_filters, swr
    t_phase = time.perf_counter()
    try:
        swr._load()
        have_swr = True
    except OSError:
        have_swr = False
    chain = list(AUDIO_CHAIN)
    if not have_swr:
        i = chain.index("loudnorm")
        chain[i:i + 1] = ["aresample=192000", "loudnorm",
                          f"aresample={AUDIO_RATE}"]
    rng = np.random.default_rng(SEED)
    t = np.arange(AUDIO_RATE * AUDIO_SECONDS) / AUDIO_RATE
    tone = 6000 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 0.3 * t))
    pcm = np.stack([tone, 0.7 * tone], 1) + rng.normal(0, 400, (len(t), 2))
    pcm = np.clip(pcm, -32768, 32767).astype(np.int16)
    st = audio_filters.AudioFilterStream(",".join(chain), AUDIO_RATE)
    t0 = time.perf_counter()
    outs = [st.push(pcm[i:i + AUDIO_BLOCK])
            for i in range(0, len(pcm), AUDIO_BLOCK)]
    outs.append(st.flush())
    dt = time.perf_counter() - t0
    out = np.concatenate([o for o in outs if o.size])
    want = len(pcm) / 1.25
    check(out.dtype == np.int16 and out.shape[1] == 2
          and abs(len(out) - want) < 0.02 * want and st.out_rate == AUDIO_RATE
          and int(np.abs(out.astype(np.int32)).max()) > 0,
          f"audio chain gave {out.shape} {out.dtype} at {st.out_rate}")
    emit("audio", chain=",".join(chain), libswresample=have_swr,
         seconds=AUDIO_SECONDS, rate=AUDIO_RATE, samples_in=len(pcm),
         samples_out=len(out), samples_per_s=len(pcm) / dt, wall_s=dt,
         sha256=hashlib.sha256(out.tobytes()).hexdigest(),
         phase_s=time.perf_counter() - t_phase)


# The train phase: both trainers' `main` at full width, cut in steps and
# patches only (SR 24,000 -> 16,000 steps, DnCNN 16,000 -> 2,000; 4,096 ->
# 512 patches, which the host generates in about 10 s and 4 s).  The SR
# gate needs the steps: on an H100 its held-out gain over bicubic was
# -1.74 dB after 3,000 steps, -0.49 after 6,000 (-0.46 on 2,048 patches)
# and +0.29 after 12,000; DnCNN gained +6.36 dB after 2,000
TRAIN_RUNS = (
    ("sr", "train_sr", ("--scale", "2", "--hidden", "64", "--batch", "32",
                        "--hr", "96", "--patches", "512", "--steps",
                        "16000")),
    ("dncnn", "train_denoise", ("--channels", "3", "--batch", "32",
                                "--size", "64", "--patches", "512",
                                "--steps", "2000")),
)
TRAIN_PAIR_STEPS = 20         # card against CPU: the first steps' losses
TRAIN_PAIR_PATCHES = 64
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4         # of each gradient tensor's largest magnitude
TRAIN_FILTER_RTOL = 1e-4      # a written checkpoint, card against CPU
SCALING_SLACK = 1.35          # tools/scaling_shape.py's near-linear factor


@contextlib.contextmanager
def torch_default_flags():
    """PyTorch's default backend flags inside the block (what a user's run
    sees: cuDNN may use TF32, matmuls may not), this script's after it."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def all_launches() -> dict:
    """Every kernel counter of ops/ladder and ops/rungs since they were
    last zeroed."""
    from gmat_tpu_torch.ops import ladder, rungs
    return {**ladder.LAUNCHES, **rungs.LAUNCHES}


def zero_all_counts() -> None:
    from gmat_tpu_torch.ops import ladder, rungs
    zero_counts(ladder)
    zero_counts(rungs)


def param_leaves(params) -> list:
    if isinstance(params, dict) and "layers" in params:
        return [t for layer in params["layers"] for t in layer.values()]
    return list(params.values())


def train_cases():
    """Per trainer: the CPU init of its run, its loss, and TRAIN_PAIR_STEPS
    host batches drawn as the trainer draws them (the DnCNN noise from a
    seeded CPU generator, so that both devices see the same batches)."""
    from gmat_tpu_torch import models
    from gmat_tpu_torch.models import denoise, sr
    from gmat_tpu_torch.tools import train_denoise, train_sr
    _, idxs = next(train_sr.index_chunks(SEED, TRAIN_PAIR_PATCHES, 32,
                                         TRAIN_PAIR_STEPS))
    idxs = torch.as_tensor(idxs[:TRAIN_PAIR_STEPS])
    hrs = torch.as_tensor(train_sr.make_dataset(TRAIN_PAIR_PATCHES, 96,
                                                SEED))
    lrs = torch.as_tensor(train_sr.area_down(hrs.numpy(), 2))
    clean = torch.as_tensor(train_sr.make_dataset(TRAIN_PAIR_PATCHES, 64,
                                                  SEED))
    gen = torch.Generator().manual_seed(SEED)
    return {
        "sr": (lambda: sr.init_params(models.generator(SEED), scale=2,
                                      hidden=64, device="cpu"),
               sr.loss_fn, [(lrs[i], hrs[i]) for i in idxs]),
        "dncnn": (lambda: denoise.init_params(models.generator(SEED),
                                              channels=3, device="cpu"),
                  train_denoise.loss_fn,
                  [(train_denoise.add_noise(clean[i], gen), clean[i])
                   for i in idxs]),
    }


def trainable(make_params, device, steps: int):
    """The CPU init on `device`, taking gradients, with the trainers'
    optimizer and schedule over `steps`."""
    from gmat_tpu_torch import models
    from gmat_tpu_torch.tools import train_sr
    params = models.to_device(make_params(), device)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return (params, leaves, *train_sr.make_optimizer(leaves, 1e-3, steps))


def train_pair(make_params, loss_fn, batches, device):
    """The trainer's step on `device` from the CPU init over `batches`:
    the step-1 gradients and every step's loss, on the host."""
    from gmat_tpu_torch.tools import train_sr
    params, leaves, opt, sched = trainable(make_params, device, len(batches))
    losses, grads = [], None
    for batch in batches:
        losses.append(train_sr.train_step(
            opt, sched, loss_fn, params, *(b.to(device) for b in batch)))
        if grads is None:
            grads = [t.grad.detach().cpu().clone() for t in leaves]
    return torch.stack(losses).cpu(), grads


def step_ms(make_params, loss_fn, batches, noise: bool):
    """CUDA-event ms of the trainer's loop body on the card at full width:
    a batch gathered from a device dataset, the DnCNN noise drawn on the
    card, the step (optimizer and schedule included)."""
    from gmat_tpu_torch.tools import train_denoise, train_sr
    params, _, opt, sched = trainable(make_params, "cuda", 10_000)
    xs, ys = (torch.cat([b[k] for b in batches]).cuda() for k in (0, 1))
    idx = torch.randperm(len(xs), generator=torch.Generator().manual_seed(
        SEED)).view(-1, 32).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def body(i):
        rows = idx[i % len(idx)]
        y = ys[rows]
        x = train_denoise.add_noise(y, gen) if noise else xs[rows]
        train_sr.train_step(opt, sched, loss_fn, params, x, y)
    return event_ms(body, calls=50, reps=5, warm=10)


def filter_check(model, path, frames):
    """The written checkpoint through InferFilter(weights=path), fp32, on
    the card and on the CPU: output shape, finite, within
    TRAIN_FILTER_RTOL."""
    from gmat_tpu_torch.core.frame import FrameBatch
    from gmat_tpu_torch.filters.infer import InferFilter
    outs = {}
    for dev in ("cuda", "cpu"):
        filt = InferFilter(model=model, weights=path, precision="fp32")
        fb = FrameBatch.from_numpy(frames, "yuv420p", frames["y"].shape[2],
                                   frames["y"].shape[1], device=dev)
        outs[dev] = filt(fb).planes["rgb"]
    got, want = outs["cuda"].cpu(), outs["cpu"]
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{model} checkpoint output {tuple(got.shape)}")
    err = rel_excess(got, want, TRAIN_FILTER_RTOL, 1e-5)
    check(err <= 1, f"{model} checkpoint card vs CPU: {err} of the bound")
    return list(got.shape)


def train_phase(tmp):
    """Both trainers' `main` on the card at full width (TRAIN_RUNS) under
    PyTorch's default flags: each past its own gate, its checkpoint written
    to `tmp` and run through InferFilter on the card against the CPU; the
    first TRAIN_PAIR_STEPS steps of each from the same init and batches on
    the card and on the CPU (step-1 gradients within TRAIN_GRAD_TOL of
    each tensor's largest magnitude, losses within TRAIN_LOSS_RTOL); ms
    per step from CUDA events, steps/s, held-out PSNR, wall s.  No
    ladder or rung kernel runs."""
    from gmat_tpu_torch.tools import train_denoise, train_sr
    tools = {"train_sr": train_sr, "train_denoise": train_denoise}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    frames = {"y": rng.integers(16, 236, (2, 270, 480)).astype(np.uint8),
              "u": rng.integers(16, 240, (2, 135, 240)).astype(np.uint8),
              "v": rng.integers(16, 240, (2, 135, 240)).astype(np.uint8)}
    runs = {}
    with torch_default_flags():
        check(torch.backends.cudnn.allow_tf32, "default flags not set")
        zero_all_counts()
        for name, tool, argv in TRAIN_RUNS:
            out_path = os.path.join(tmp, f"{name}.npz")
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rec = tools[tool].main([*argv, "--out", out_path])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(isinstance(rec, dict) and os.path.exists(out_path),
                  f"{tool} wrote no checkpoint")
            runs[name] = {**rec, "wall_s": wall,
                          "steps_per_s_loop": rec["steps"] / rec["train_s"],
                          "log": log.getvalue().splitlines()}
        launches = {k: v for k, v in all_launches().items() if v}
        check(not launches, f"the trainers launched {launches}")
        runs["sr"]["filter_output"] = filter_check(
            "sr2x", runs["sr"]["out"], frames)
        runs["dncnn"]["filter_output"] = filter_check(
            "denoise", runs["dncnn"]["out"], frames)
        for name, (make, loss_fn, batches) in train_cases().items():
            t0 = time.perf_counter()
            card_losses, card_grads = train_pair(make, loss_fn, batches,
                                                 "cuda")
            cpu_losses, cpu_grads = train_pair(make, loss_fn, batches, "cpu")
            pair_s = time.perf_counter() - t0
            grad_err = max(float((g - w).abs().max() / w.abs().max())
                           for g, w in zip(card_grads, cpu_grads))
            loss_err = float(((card_losses - cpu_losses).abs()
                              / cpu_losses.abs()).max())
            check(grad_err <= TRAIN_GRAD_TOL,
                  f"{name} step-1 gradients card vs CPU: {grad_err}")
            check(loss_err <= TRAIN_LOSS_RTOL,
                  f"{name} losses card vs CPU: {loss_err}")
            ms, ms_runs, host_ms = step_ms(make, loss_fn, batches,
                                           noise=name == "dncnn")
            runs[name].update(grad_rel_err_step1=grad_err,
                              loss_rel_err_20=loss_err, pair_s=pair_s,
                              ms_per_step=ms, runs_ms=ms_runs,
                              host_ms_per_step=host_ms,
                              steps_per_s=1e3 / ms)
    check(torch.backends.cudnn.allow_tf32 is False,
          "the script's flags were not restored")
    emit("train", runs=runs, phase_s=time.perf_counter() - t_phase)
    return runs


def scaling_phase(tmp):
    """tools/scaling_shape on the card: ShardedPipeline of the separate-op
    ladder over 1, 2, 4 and 8 shards of cuda:0; per-shard flops and bytes
    1/n of one shard's within SCALING_SLACK, the wall times; no kernel
    launch (use_kernel="never")."""
    from gmat_tpu_torch.tools import scaling_shape
    t_phase = time.perf_counter()
    zero_all_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        art = scaling_shape.main(["--device", "cuda", "--out",
                                  os.path.join(tmp, "SCALING_torch.json")])
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    check(not launches, f"scaling launched {launches}")
    for r in art["rows"]:
        n = r["devices"]
        for key in ("flops_ratio_vs_1dev", "bytes_ratio_vs_1dev"):
            check(1 / (SCALING_SLACK * n) <= r[key] <= SCALING_SLACK / n,
                  f"scaling {n} shards: {key} {r[key]}")
    emit("scaling", device=art["device"], rows=art["rows"],
         phase_s=time.perf_counter() - t_phase)


def examples_phase(tmp):
    """examples/stills_and_torch on the card: the JPEG part (8 x 360p,
    DCT on the card) and the tensor part (preprocess_nchw, one ladder_i8
    launch), each against its CPU run: the same JPEG sizes and error, the
    tensor within LSB_GATE; the HEIF and extract_to_torch parts where
    libavcodec exists.  Returns the launches."""
    from gmat_tpu_torch.core.frame import from_numpy_yuv420
    from gmat_tpu_torch.examples import stills_and_torch as st
    t_phase = time.perf_counter()
    y, u, v = st.planes()
    batch = [np.stack([p] * 8) for p in (y, u, v)]
    fb = from_numpy_yuv420(*batch, device="cuda")
    zero_all_counts()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        jpeg = st.jpeg_part(fb, y)
        t = st.tensor_part(fb)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    check(launches == {"ladder_i8": 1}, f"examples launches {launches}")
    fb_cpu = from_numpy_yuv420(*batch, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        jpeg_cpu = st.jpeg_part(fb_cpu, y)
        t_cpu = st.tensor_part(fb_cpu)
    check(jpeg == jpeg_cpu and jpeg["mean_err"] < 1.0,
          f"examples JPEG {jpeg} vs CPU {jpeg_cpu}")
    check(t.is_cuda and tuple(t.shape) == (8, 3, 224, 224)
          and bool(torch.isfinite(t).all()), "examples tensor")
    err = lsb(t.cpu(), t_cpu)
    check(err <= LSB_GATE, f"examples tensor vs CPU: {err} LSB")
    rec = {"jpeg": jpeg, "tensor": list(t.shape), "tensor_lsb_vs_cpu": err,
           "launches": launches, "log": log.getvalue().splitlines()}
    if av_precondition("examples_av"):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rec["heif"] = st.heif_part(y, u, v)
            rec["extract"] = st.extract_part(tmp, "cuda")
        rec["log"] += log.getvalue().splitlines()
    emit("examples", **rec, phase_s=time.perf_counter() - t_phase)
    return launches


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs one CUDA device")
    from gmat_tpu_torch.av import native
    from gmat_tpu_torch.core.frame import FrameBatch, pack_nv12
    from gmat_tpu_torch.ops import _build, fused, ladder, rungs

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- device
    card_name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, want (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    # the JPEG lane's host coder (g++) builds beside the kernels (nvcc)
    with ThreadPoolExecutor(1) as pool:
        jpeg_lib = pool.submit(native.load, "gmat_jpeg")
        _build.library()
        jpeg_lib.result()
    emit("device", name=card_name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         ptxas=_build.BUILD_INFO.get("ptxas", ""))

    make = Planes(SEED)
    bufs = [FrameBatch(dict(zip("yuv", make(N, H, W, H // 2, W // 2))),
                       "yuv420p", W, H).validate() for _ in range(2)]
    yuv0 = tuple(bufs[0].planes[k] for k in "yuv")

    # ------------------------------------------------- main path (K1)
    zero_counts(ladder)
    out = fused.preprocess_nchw(bufs[0], OUT, OUT)
    torch.cuda.synchronize()
    main_counts = dict(ladder.LAUNCHES)
    check(tuple(out.shape) == (N, 3, OUT, OUT) and out.dtype == torch.float32,
          f"main path gave {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), "main path output not finite")
    check(main_counts == want_counts(ladder, ladder_i8=1),
          f"main path launches {main_counts}")
    ref = ladder.fused_ladder_i8(*yuv0, OUT, OUT, reference=True)
    err_k1 = lsb(out, ref)
    check(err_k1 <= LSB_I8, f"ladder_i8 vs plain: {err_k1} LSB")

    sm = tuple(torch.as_tensor(p, device="cuda") for p in smooth_content(H, W))
    fb_s = FrameBatch(dict(zip("yuv", sm)), "yuv420p", W, H)
    gate = lsb(fused.preprocess_nchw(fb_s, OUT, OUT),
               fused.preprocess_nchw(fb_s, OUT, OUT, exact=True))
    check(gate <= LSB_GATE, f"quality gate: {gate} LSB vs exact")

    fusions = dict(crop_box=(240, 0, 1440, 1080),
                   smooth=(3, 3, 0.0, 0.0, "replicate"), flip_code=1)
    zero_counts(ladder)
    got = fused.preprocess_nchw(bufs[0], OUT, OUT, **fusions)
    torch.cuda.synchronize()
    fused_counts = dict(ladder.LAUNCHES)
    check(sum(fused_counts.values()) == 1, f"fused case {fused_counts}")
    want = fused.preprocess_nchw(bufs[0], OUT, OUT, use_kernel="reference",
                                 **fusions)
    err_fused = lsb(got, want)
    tol = LSB_I8 if fused_counts["ladder_i8"] else LSB_BF16
    check(err_fused <= tol, f"crop+smooth+flip vs plain: {err_fused} LSB")
    emit("main_path", shape=list(out.shape), launches=main_counts,
         max_lsb_vs_plain=err_k1, quality_gate_lsb=gate,
         fused_case_launches=fused_counts, fused_case_max_lsb=err_fused)

    # ------------------------- in-graph inference (K1 -> ESPCN, config #4)
    infer_pair = tuple(FrameBatch({k: v[:INFER_BATCH]
                                   for k, v in b.planes.items()},
                                  "yuv420p", W, H) for b in bufs)
    infer_launches, rgb224 = infer_pipeline(fused, ladder, infer_pair)
    infer_models(rgb224)
    del infer_pair, rgb224

    # ------------------------------------------------------ K2 (bf16)
    p10 = make(N, H, W, H // 2, W // 2, hi=1024, dtype=torch.uint16)
    fb10 = FrameBatch(dict(zip("yuv", p10)), "yuv420p10", W, H).validate()
    p444 = make(N, H, W, H, W)
    fb444 = FrameBatch(dict(zip("yuv", p444)), "yuv444p", W, H).validate()
    zero_counts(ladder)
    k2_u8 = fused.preprocess_nchw(bufs[0], OUT, OUT, use_kernel="bf16")
    k2_10 = fused.preprocess_nchw(fb10, OUT, OUT)
    k2_444 = fused.preprocess_nchw(fb444, OUT, OUT)
    torch.cuda.synchronize()
    bf16_counts = dict(ladder.LAUNCHES)
    check(bf16_counts == want_counts(ladder, ladder_bf16=3),
          f"bf16 phase launches {bf16_counts}")
    errs_k2 = {
        "u8": lsb(k2_u8, ladder.fused_ladder(*yuv0, OUT, OUT,
                                             reference=True)),
        "yuv420p10": lsb(k2_10, fused.preprocess_nchw(
            fb10, OUT, OUT, use_kernel="reference")),
        "yuv444p": lsb(k2_444, fused.preprocess_nchw(
            fb444, OUT, OUT, use_kernel="reference")),
    }
    for lane, e in errs_k2.items():
        check(e <= LSB_BF16, f"ladder_bf16 {lane} vs plain: {e} LSB")
    for t in (k2_u8, k2_10, k2_444):
        check(bool(torch.isfinite(t).all()), "bf16 output not finite")
    emit("ladder_bf16", launches=bf16_counts, max_lsb_vs_plain=errs_k2)

    # ---------------------------------------------- K3 (8K) and 5760
    n8 = 8
    p8k = make(n8, 4320, 7680, 2160, 3840)
    p57 = make(1, 3240, 5760, 1620, 2880)
    zero_counts(ladder)
    k3 = ladder.fused_ladder_i8(*p8k, OUT, OUT)
    k57 = ladder.fused_ladder_i8(*p57, 32, 32)
    torch.cuda.synchronize()
    wide_counts = dict(ladder.LAUNCHES)
    check(wide_counts == want_counts(ladder, ladder_i8=2)
          and wide_counts_of(ladder) == {K3_ROW: 2},
          f"wide phase launches {wide_counts}, "
          f"by source {dict(ladder.LAUNCHES_BY_SOURCE)}")
    err_k3 = lsb(k3, ladder.fused_ladder_i8(*p8k, OUT, OUT, reference=True))
    err_57 = lsb(k57, ladder.fused_ladder_i8(*p57, 32, 32, reference=True))
    check(err_k3 <= LSB_I8 and err_57 <= LSB_I8,
          f"wide vs plain: 8K {err_k3}, 5760x3240 {err_57} LSB")
    emit("ladder_wide", launches=wide_counts, max_lsb_vs_plain_8k=err_k3,
         max_lsb_vs_plain_5760x3240=err_57, shape_8k=list(k3.shape))
    del p57, k3, k57

    # ------------------------- ladder_i8 and ladder_bf16 on ragged widths
    n_r, h_r, w_r = RAGGED_LADDER_SRC
    oh_r, ow_r = RAGGED_LADDER_OUT
    p_r = make(n_r, h_r, w_r, h_r // 2, w_r // 2)
    ragged_ladder = {}
    for kname, fn, tol in (("ladder_i8", ladder.fused_ladder_i8, LSB_I8),
                           ("ladder_bf16", ladder.fused_ladder, LSB_BF16)):
        zero_counts(ladder)
        got = fn(*p_r, oh_r, ow_r)
        torch.cuda.synchronize()
        counts = dict(ladder.LAUNCHES)
        check(counts == want_counts(ladder, **{kname: 1}),
              f"ragged {kname} launches {counts}")
        check(tuple(got.shape) == (n_r, 3, oh_r, ow_r)
              and bool(torch.isfinite(got).all()), f"ragged {kname} output")
        err = lsb(got, fn(*p_r, oh_r, ow_r, reference=True))
        check(err <= tol, f"ragged {kname} vs plain: {err} LSB")
        ragged_ladder[kname] = {"launches": counts, "max_lsb_vs_plain": err}
    emit("ladder_ragged", source=[n_r, h_r, w_r],
         output=[oh_r, ow_r], **ragged_ladder)
    del got

    # --------------------------------------------------- filter graph
    filter_graph_phase()

    # ----------------------------------------- wire lane (K6, K7, K8)
    def nv12_wire(planes):
        return pack_nv12(FrameBatch(dict(zip("yuv", planes)), "yuv420p",
                                    planes[0].shape[2], planes[0].shape[1]))

    def p010_wire(planes):
        """P010 wire of 10-bit planes: samples << 6, U,V interleaved."""
        return nv12_wire([p.to(torch.int32) << 6
                          for p in planes]).to(torch.uint16)

    nv12, p010, nv12_8k = pack_nv12(bufs[0]), p010_wire(p10), nv12_wire(p8k)
    zero_counts(ladder)
    k6 = ladder.fused_ladder_nv12(nv12, OUT, OUT)
    k7 = ladder.fused_ladder_nv12_i8(nv12, OUT, OUT)
    k6_bicubic = ladder.fused_ladder_nv12_i8(nv12, OUT, OUT, method="bicubic")
    k8 = ladder.fused_ladder_p010(p010, OUT, OUT)
    k7_8k = ladder.fused_ladder_nv12_i8(nv12_8k, OUT, OUT)
    torch.cuda.synchronize()
    wire_counts = dict(ladder.LAUNCHES)
    check(wire_counts == want_counts(ladder, ladder_nv12=2, ladder_nv12_i8=2,
                                     ladder_p010=1),
          f"wire lane launches {wire_counts}")
    for t in (k6, k7, k6_bicubic, k8, k7_8k):
        check(tuple(t.shape[1:]) == (3, OUT, OUT) and t.dtype == torch.float32
              and bool(torch.isfinite(t).all()), "wire lane output")
    errs_wire = {
        "ladder_nv12": max(
            lsb(k6, ladder.fused_ladder_nv12(nv12, OUT, OUT, reference=True)),
            lsb(k6_bicubic, ladder.fused_ladder_nv12(
                nv12, OUT, OUT, method="bicubic", reference=True))),
        "ladder_nv12_i8": max(
            lsb(k7, ladder.fused_ladder_nv12_i8(nv12, OUT, OUT,
                                                reference=True)),
            lsb(k7_8k, ladder.fused_ladder_nv12_i8(nv12_8k, OUT, OUT,
                                                   reference=True))),
        "ladder_p010": lsb(k8, ladder.fused_ladder_p010(p010, OUT, OUT,
                                                        reference=True)),
    }
    for kname, tol in (("ladder_nv12", LSB_BF16), ("ladder_nv12_i8", LSB_I8),
                       ("ladder_p010", LSB_BF16)):
        check(errs_wire[kname] <= tol,
              f"{kname} vs plain: {errs_wire[kname]} LSB")
    twins = {   # each against the planar kernel on the same samples
        "ladder_nv12": lsb(k6, ladder.fused_ladder(*yuv0, OUT, OUT)),
        "ladder_nv12_i8": lsb(k7, ladder.fused_ladder_i8(*yuv0, OUT, OUT)),
        "ladder_p010": lsb(k8, ladder.fused_ladder_u16(*p10, OUT, OUT,
                                                       bits=10)),
    }
    for kname, e in twins.items():
        check(e <= LSB_TWIN, f"{kname} vs its planar twin: {e} LSB")
    emit("wire_lane", shape=[N, H * 3 // 2, W], launches=wire_counts,
         max_lsb_vs_plain=errs_wire, max_lsb_vs_planar_twin=twins,
         shape_8k=list(nv12_8k.shape))
    del k6, k7, k6_bicubic, k8, k7_8k

    # ---------------------------- wire kernels on ragged widths (K6-K8)
    p_r10 = make(n_r, h_r, w_r, h_r // 2, w_r // 2, hi=1024,
                 dtype=torch.uint16)
    nv12_r, p010_r = nv12_wire(p_r), p010_wire(p_r10)
    bicubic = {"method": "bicubic"}
    ragged_cases = {   # name: (wrapper, wire, options, tolerance, twin)
        "ladder_nv12": (ladder.fused_ladder_nv12, nv12_r, {}, LSB_BF16,
                        lambda: ladder.fused_ladder(*p_r, oh_r, ow_r)),
        "ladder_nv12 bicubic": (
            ladder.fused_ladder_nv12, nv12_r, bicubic, LSB_BF16,
            lambda: ladder.fused_ladder(*p_r, oh_r, ow_r, **bicubic)),
        "ladder_nv12_i8": (ladder.fused_ladder_nv12_i8, nv12_r, {}, LSB_I8,
                           lambda: ladder.fused_ladder_i8(*p_r, oh_r, ow_r)),
        "ladder_p010": (ladder.fused_ladder_p010, p010_r, {}, LSB_BF16,
                        lambda: ladder.fused_ladder_u16(*p_r10, oh_r, ow_r,
                                                        bits=10)),
    }
    zero_counts(ladder)
    got_r = {k: fn(wire, oh_r, ow_r, **kw)
             for k, (fn, wire, kw, _tol, _twin) in ragged_cases.items()}
    torch.cuda.synchronize()
    ragged_wire_counts = dict(ladder.LAUNCHES)
    check(ragged_wire_counts == want_counts(ladder, ladder_nv12=2,
                                            ladder_nv12_i8=1, ladder_p010=1),
          f"ragged wire launches {ragged_wire_counts}")
    ragged_wire = {}
    for k, (fn, wire, kw, tol, twin) in ragged_cases.items():
        got = got_r[k]
        check(tuple(got.shape) == (n_r, 3, oh_r, ow_r)
              and bool(torch.isfinite(got).all()), f"ragged {k} output")
        err = lsb(got, fn(wire, oh_r, ow_r, reference=True, **kw))
        err_twin = lsb(got, twin())
        check(err <= tol and err_twin <= LSB_TWIN,
              f"ragged {k}: {err} LSB vs plain, {err_twin} vs its twin")
        kind = k.split()[0][len("ladder_"):]
        geom_r = (h_r, w_r, oh_r, ow_r, kw.get("method", "bilinear"))
        ragged_wire[k] = {
            "max_lsb_vs_plain": err, "max_lsb_vs_planar_twin": err_twin,
            "taps": ladder._wire_kernel_operands(kind, geom_r,
                                                 "cuda:0")["taps"]}
    emit("wire_ragged", source=[n_r, h_r * 3 // 2, w_r],
         output=[oh_r, ow_r], launches=ragged_wire_counts, **ragged_wire)
    del p_r, p_r10, nv12_r, p010_r, got_r, got

    # ------------------------------------ ABR ladder (K4) and K5 (4K)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        src = os.path.join(tmp, "source_1080p.y4m")
        t0 = time.perf_counter()
        write_y4m_source(src, ABR_FRAMES, H, W, SEED)
        emit("abr_source", path_bytes=os.path.getsize(src),
             frames=ABR_FRAMES, write_s=time.perf_counter() - t0)
        abr = abr_ladder("abr_ladder", rungs, src, LADDER_1080, tmp)
        check(abr["quant"] == "bf16", "the 960x540 rung's 2:1 taps should "
              "send the 1080p ladder to bf16 rows, as the JAX gate does")
        abr_i8 = abr_ladder("abr_ladder_i8", rungs, src, LADDER_1080_I8,
                            tmp)
        check(abr_i8["quant"] == "i8", "720p/360p should take int8 rows")
        filtered = abr_filtered(rungs, src, LADDER_1080_I8, abr_i8["fps"])
        hdr = abr_hdr(rungs, tmp, LADDER_1080_I8, abr_i8["fps"])
        ivtc = abr_ivtc(rungs, src, tmp, LADDER_1080_I8, abr_i8["fps"])
        enhance = abr_enhance(rungs, src, LADDER_1080_I8, abr_i8["fps"])
        jpeg_still(src)
        cli_launches = cli_phase(src, tmp)
        rung_src = [tuple(b[0].planes[k] for k in "yuv")
                    for b in abr["batches"][:2]]
        for b in abr["batches"] + abr_i8["batches"]:
            b[1].clear()
            b[2].clear()
        abr_i8_counts, abr_i8_plain = abr_i8["counts"], abr_i8["plain"]
        del abr_i8

        # each row stage forced on the first batch: bf16 on both ladders,
        # int8 on the one whose 960x540 rung the gate keeps off int8
        forced = {}
        for phase, quant, ladders in (
                ("rungs_bf16", "bf16", (LADDER_1080, LADDER_1080_I8)),
                ("rungs_i8_forced", "i8", (LADDER_1080,))):
            zero_counts(rungs)
            outs = [rungs.fused_rungs(*rung_src[0], sizes, quant=quant)
                    for sizes in ladders]
            torch.cuda.synchronize()
            counts = dict(rungs.LAUNCHES)
            want = {"rungs_i8": 0, "rungs_bf16": 0}
            want[f"rungs_{quant}"] = len(ladders)
            check(counts == want, f"{phase} launches {counts}")
            errs = [rung_errors(rungs, rung_src[0], o, sizes, quant)
                    for o, sizes in zip(outs, ladders)]
            plain, exact = max(e[0] for e in errs), max(e[1] for e in errs)
            check(plain <= LSB_RUNG_PLAIN and exact <= LSB_RUNG_EXACT[quant],
                  f"{phase}: {plain} LSB vs plain, {exact} vs exact")
            forced[quant] = plain
            emit(phase, ladders=[[f"{ow}x{oh}" for ow, oh in sizes]
                                 for sizes in ladders],
                 launches=counts, max_lsb_vs_plain=plain,
                 max_lsb_vs_exact=exact)
            del outs

        # K5: int8 rungs of 8 x 4K (one launch), and nearest at 720p
        n4k = 8
        p4k = make(n4k, 2160, 3840, 1080, 1920)
        zero_counts(rungs)
        k5 = rungs.fused_rungs(*p4k, LADDER_4K, quant="i8")
        torch.cuda.synchronize()
        k5_counts = dict(rungs.LAUNCHES)
        check(k5_counts == {"rungs_i8": 1, "rungs_bf16": 0}
              and wide_counts_of(rungs) == {K5_ROW: 1},
              f"4K launches {k5_counts}, "
              f"by source {dict(rungs.LAUNCHES_BY_SOURCE)}")
        err_k5, exact_k5 = rung_errors(rungs, p4k, k5, LADDER_4K, "i8")
        near_sizes = ((640, 360), (320, 180))
        p720 = make(4, 720, 1280, 360, 640)
        zero_counts(rungs)
        near = rungs.fused_rungs(*p720, near_sizes, method="nearest")
        torch.cuda.synchronize()
        near_counts = dict(rungs.LAUNCHES)
        check(near_counts == {"rungs_i8": 1, "rungs_bf16": 0},
              f"nearest launches {near_counts}")
        err_near, exact_near = rung_errors(rungs, p720, near, near_sizes,
                                           "i8", method="nearest")
        check(err_k5 <= LSB_RUNG_PLAIN and err_near <= LSB_RUNG_PLAIN
              and exact_k5 <= LSB_RUNG_EXACT["i8"] and exact_near == 0,
              f"wide rungs: 4K {err_k5}/{exact_k5}, nearest "
              f"{err_near}/{exact_near} LSB vs plain/exact")
        emit("rungs_wide", source_4k=[n4k, 2160, 3840],
             rungs_4k=[f"{ow}x{oh}" for ow, oh in LADDER_4K],
             launches_4k=k5_counts, max_lsb_vs_plain_4k=err_k5,
             max_lsb_vs_exact_4k=exact_k5, launches_nearest=near_counts,
             max_lsb_vs_plain_nearest=err_near,
             max_lsb_vs_exact_nearest=exact_near)
        del k5, near, p720

        # both kernels on a ragged geometry
        pr = make(*RAGGED_SRC, RAGGED_SRC[1] // 2, RAGGED_SRC[2] // 2)
        ragged = {}
        for quant in ("i8", "bf16"):
            zero_counts(rungs)
            got = rungs.fused_rungs(*pr, RAGGED_SIZES, quant=quant)
            torch.cuda.synchronize()
            counts = dict(rungs.LAUNCHES)
            want = want_counts(rungs, **{f"rungs_{quant}": 1})
            check(counts == want, f"ragged {quant} launches {counts}")
            plain, exact = rung_errors(rungs, pr, got, RAGGED_SIZES, quant)
            check(plain <= LSB_RUNG_PLAIN and exact <= LSB_RAGGED_EXACT,
                  f"ragged {quant}: {plain} LSB vs plain, {exact} vs exact")
            ragged[quant] = {"launches": counts, "max_lsb_vs_plain": plain,
                             "max_lsb_vs_exact": exact}
        emit("rungs_ragged", source=list(RAGGED_SRC),
             rungs=[f"{ow}x{oh}" for ow, oh in RAGGED_SIZES], **ragged)
        del pr, got

        scene_ms = scene_phase(src)
        metrans_session(src, tmp)
        smart_decode(tmp)
        stills_av(tmp, src)
        scale_out_launches = scale_out_phase(bufs, fb10)
        shm_launches = shm_ring_phase(tmp)
        perf_launches = perf_phase(src, tmp)
        audio_phase()
        scaling_phase(tmp)
        examples_launches = examples_phase(tmp)
        train_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---------------------------------------------------------- timing
    geom = (H, W, H // 2, W // 2, OUT, OUT, "bilinear", None, None, None)
    c8 = ladder._epilogue("bt709", 8, 255.0, (0.0, 0.0, 0.0))
    c10 = ladder._epilogue("bt709", 10, 1023.0, (0.0, 0.0, 0.0))
    yuv1 = tuple(bufs[1].planes[k] for k in "yuv")
    p10b = make(N, H, W, H // 2, W // 2, hi=1024, dtype=torch.uint16)
    p8kb = make(n8, 4320, 7680, 2160, 3840)
    geom8k = (4320, 7680, 2160, 3840, OUT, OUT, "bilinear", None, None,
              None)
    usage = ptxas_usage(_build.BUILD_INFO.get("ptxas", ""))
    cases = {   # name: (kind, geometry, constants, two input buffers, wrapper)
        "ladder_i8": ("i8", geom, c8, (yuv0, yuv1),
                      lambda *p: ladder.fused_ladder_i8(*p, OUT, OUT)),
        "ladder_bf16": ("bf16", geom, c8, (yuv0, yuv1),
                        lambda *p: ladder.fused_ladder(*p, OUT, OUT)),
        "ladder_bf16_u16": ("bf16", geom, c10, (p10, p10b),
                            lambda *p: ladder.fused_ladder_u16(
                                *p, OUT, OUT, bits=10)),
        "ladder_i8_8k": ("i8", geom8k, c8, (p8k, p8kb),
                         lambda *p: ladder.fused_ladder_i8(*p, OUT, OUT)),
    }
    timing = {}
    for case, (kind, g, c, pair, wrapper) in cases.items():
        go = [raw_launcher(ladder, kind, *p, g, c) for p in pair]
        ms, runs, host_ms = event_ms(lambda i: go[i % 2]())
        wrapper_ms, _, wrapper_host_ms = event_ms(
            lambda i: wrapper(*pair[i % 2]))
        taps = ladder._kernel_operands(kind, g, "cuda:0")["taps"]
        pops = [ladder._plain_operands(kind, g, "cuda:0")]
        plain_ms, _, _ = event_ms(
            lambda i: ladder._PLAIN[kind](*pair[i % 2], pops[0], c),
            calls=2, reps=5)
        n = pair[0][0].shape[0]
        b = bound(ladder, kind, g, n, pair[0][0].element_size())
        timing[case] = {"ms": ms, "runs_ms": runs, "host_ms": host_ms,
                        "wrapper_ms": wrapper_ms,
                        "wrapper_host_ms": wrapper_host_ms,
                        "plain_ms": plain_ms,
                        "frames": n, "frames_per_s": n / ms * 1e3,
                        "launches_per_batch": 1, "taps": taps,
                        "bound_share": b["bound_ms"] / ms,
                        "ptxas": kernel_ptxas(usage, "ladder_kernel", kind,
                                              pair[0][0].dtype, taps), **b}
    geom_w = (H, W, OUT, OUT, "bilinear")
    geom_w8k = (4320, 7680, OUT, OUT, "bilinear")
    pair_nv12, pair_p010 = (nv12, pack_nv12(bufs[1])), (p010, p010_wire(p10b))
    wire_cases = {   # name: (kind, geometry, constants, two wire batches)
        "ladder_nv12": ("nv12", geom_w, c8, pair_nv12),
        "ladder_nv12_i8": ("nv12_i8", geom_w, c8, pair_nv12),
        "ladder_p010": ("p010", geom_w, c10, pair_p010),
        "ladder_nv12_i8_8k": ("nv12_i8", geom_w8k, c8,
                              (nv12_8k, nv12_wire(p8kb))),
    }
    wire_entries = {"nv12": ladder.fused_ladder_nv12,
                    "nv12_i8": ladder.fused_ladder_nv12_i8,
                    "p010": ladder.fused_ladder_p010}
    for case, (kind, g, c, pair) in wire_cases.items():
        go = [wire_launcher(ladder, kind, p, g, c) for p in pair]
        ms, runs, host_ms = event_ms(lambda i: go[i % 2]())
        wrapper_ms, _, wrapper_host_ms = event_ms(
            lambda i: wire_entries[kind](pair[i % 2], OUT, OUT))
        taps = ladder._wire_kernel_operands(kind, g, "cuda:0")["taps"]
        pops = ladder._wire_plain_operands(kind, g, "cuda:0")
        plain_ms, _, _ = event_ms(
            lambda i: ladder._WIRE_PLAIN[kind](pair[i % 2], pops, c),
            calls=2, reps=5)
        n = pair[0].shape[0]
        b = wire_bound(ladder, kind, g, n, pair[0].element_size())
        timing[case] = {"ms": ms, "runs_ms": runs, "host_ms": host_ms,
                        "wrapper_ms": wrapper_ms,
                        "wrapper_host_ms": wrapper_host_ms,
                        "plain_ms": plain_ms, "library_ms": None,
                        "frames": n, "frames_per_s": n / ms * 1e3,
                        "launches_per_batch": 1, "taps": taps,
                        "bound_share": b["bound_ms"] / ms,
                        "ptxas": kernel_ptxas(usage, "wire_kernel",
                                              ladder._WIRE[kind].row,
                                              pair[0].dtype, taps), **b}
    del nv12_8k, pair_nv12, pair_p010
    p4kb = make(n4k, 2160, 3840, 1080, 1920)
    geom_r = (H, W, H // 2, W // 2, LADDER_1080, "bilinear")
    geom_4k = (2160, 3840, 1080, 1920, LADDER_4K, "bilinear")
    rung_cases = {   # name: (kind, geometry, two input buffers)
        "rungs_i8": ("i8", geom_r, rung_src),
        "rungs_bf16": ("bf16", geom_r, rung_src),
        "rungs_i8_4k": ("i8", geom_4k, (p4k, p4kb)),
    }
    for case, (kind, g, pair) in rung_cases.items():
        sizes = g[4]
        go = [rung_launcher(rungs, kind, *p, g) for p in pair]
        ms, runs, host_ms = event_ms(lambda i: go[i % 2]())
        wrapper_ms, _, wrapper_host_ms = event_ms(
            lambda i: rungs.fused_rungs(*pair[i % 2], sizes, quant=kind))
        pops = rungs._plain_operands(kind, g, "cuda:0")
        plain_ms, _, _ = event_ms(
            lambda i: rungs._PLAIN[kind](*pair[i % 2], pops),
            calls=2, reps=5)
        library_ms, _, _ = event_ms(
            lambda i: interpolate_rungs(*pair[i % 2], sizes),
            calls=2, reps=5)
        lib_lsb = max(rung_lsb(a, b) for ra, rb in zip(
            interpolate_rungs(*pair[0], sizes), go[0]()) for a, b in zip(ra, rb))
        n = pair[0][0].shape[0]
        b = rung_bound(rungs, kind, g, n)
        timing[case] = {"ms": ms, "runs_ms": runs, "host_ms": host_ms,
                        "wrapper_host_ms": wrapper_host_ms,
                        "wrapper_ms": wrapper_ms,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "library_max_lsb_vs_kernel": lib_lsb,
                        "frames": n, "frames_per_s": n / ms * 1e3,
                        "rungs": [f"{ow}x{oh}" for ow, oh in sizes],
                        "launches_per_batch": 1,
                        "bound_share": b["bound_ms"] / ms,
                        "effective_GBps": b["bytes"] / ms / 1e6,
                        "ptxas": kernel_ptxas(usage, "rungs_kernel", kind),
                        **rung_tiling(rungs, kind, g), **b}
    e2e_ms, e2e_runs, e2e_host = event_ms(
        lambda i: fused.preprocess_nchw(bufs[i % 2], OUT, OUT))
    sep_ms, _, _ = event_ms(
        lambda i: fused.preprocess_nchw(bufs[i % 2], OUT, OUT,
                                        use_kernel="never"),
        calls=2, reps=5)
    emit("timing", kernels=timing,
         preprocess_nchw={"ms": e2e_ms, "runs_ms": e2e_runs,
                          "host_ms": e2e_host,
                          "frames_per_s": N / e2e_ms * 1e3},
         separate_op_path={"ms": sep_ms, "frames_per_s": N / sep_ms * 1e3},
         scene_scores={"ms_per_batch": scene_ms, "batch": ABR_BATCH},
         nvidia_smi=smi)

    # --------------------------------------------------------- summary
    def row(name, case, replaces, jax_fn, launches, err, source="ladder.cu",
            abs_err=None):
        t = timing[case]
        r = {"name": name, "route": "cuda",
             "source": f"gmat_tpu_torch/csrc/{source}",
             "replaces": f"{JAX}:{replaces}", "jax": f"{JAX}:{jax_fn}",
             "launches": launches,
             "max_abs_err": err / 255.0 if abs_err is None else abs_err,
             "max_lsb": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t.get("library_ms")}
        if "taps" in t:
            r["taps"] = t["taps"]
        return r

    k2 = row("ladder_bf16", "ladder_bf16", 123, "_ladder_kernel",
             bf16_counts["ladder_bf16"], max(errs_k2.values()))
    k2.update(ms_u16=timing["ladder_bf16_u16"]["ms"],
              plain_ms_u16=timing["ladder_bf16_u16"]["plain_ms"],
              bound_ms_u16=timing["ladder_bf16_u16"]["bound_ms"])
    k7 = row("ladder_nv12_i8", "ladder_nv12_i8", 611, "_ladder_nv12_kernel_i8",
             wire_counts["ladder_nv12_i8"], errs_wire["ladder_nv12_i8"])
    k7.update(ms_8k=timing["ladder_nv12_i8_8k"]["ms"],
              plain_ms_8k=timing["ladder_nv12_i8_8k"]["plain_ms"],
              bound_ms_8k=timing["ladder_nv12_i8_8k"]["bound_ms"])
    # the filtered ABR path launches the same kernel once per batch
    rungs_i8_row = row("rungs_i8", "rungs_i8", 876, "_rungs_kernel_i8",
                       abr_i8_counts["rungs_i8"],
                       max(abr_i8_plain, forced["i8"]), "rungs.cu",
                       max(abr_i8_plain, forced["i8"]))
    rungs_i8_row["launches_abr_filtered"] = filtered["rungs_i8"]
    rungs_i8_row["launches_abr_hdr"] = hdr["rungs_i8"]
    rungs_i8_row["launches_abr_ivtc"] = ivtc["rungs_i8"]
    rungs_i8_row["launches_abr_enhance"] = enhance["rungs_i8"]
    k1 = row("ladder_i8", "ladder_i8", 455, "_ladder_kernel_i8",
             main_counts["ladder_i8"], err_k1)
    # the in-graph inference path launches it once per batch
    k1["launches_infer"] = infer_launches
    kernels = [
        k1,
        k2,
        row(K3_ROW, "ladder_i8_8k", 1230,
            "_ladder_kernel_i8_chunked", wide_counts["ladder_i8"],
            max(err_k3, err_57)),
        # u8 outputs: the error is in u8 codes
        rungs_i8_row,
        row("rungs_bf16", "rungs_bf16", 845, "_rungs_kernel",
            abr["counts"]["rungs_bf16"], max(abr["plain"], forced["bf16"]),
            "rungs.cu", max(abr["plain"], forced["bf16"])),
        row(K5_ROW, "rungs_i8_4k", 907,
            "_rungs_kernel_i8_chunked", k5_counts["rungs_i8"], err_k5,
            "rungs.cu", err_k5),
        row("ladder_nv12", "ladder_nv12", 321, "_ladder_nv12_kernel",
            wire_counts["ladder_nv12"], errs_wire["ladder_nv12"]),
        k7,
        row("ladder_p010", "ladder_p010", 734, "_ladder_p010_kernel",
            wire_counts["ladder_p010"], errs_wire["ladder_p010"]),
    ]
    for r in kernels:   # launches over the cli phase's card runs
        r["launches_cli"] = cli_launches[r["name"]]
        # the K3 and K5 rows: launches on their sources (wide_counts_of)
        r["launches_perf"] = perf_launches.get(r["name"], 0)
        r["launches_scale_out"] = scale_out_launches.get(r["name"], 0)
    k1["launches_shm_ring"] = shm_launches["ladder_i8"]
    # the examples' tensor part; the train and scaling phases launch none
    k1["launches_examples"] = examples_launches["ladder_i8"]
    emit("elapsed", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
