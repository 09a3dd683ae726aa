"""Filter-graph parser and runner — counterpart of
`gmat_tpu/filters/graph.py`.

Keeps ffmpeg-gpu's `-vf` semantics (filters separated by ',', options by
':' as k=v or positional, '\\' escapes) so GMAT CLI pipelines port
directly, e.g.:

    scale=1280:720,format=rgbpf32le
    crop=w=480:h=480,rotate=angle=45,smooth=type=median:kw=5
    select='gt(scene,0.4)'

Execution model: consecutive *pure* filters are composed into one
function that runs eagerly on the batch's device (the JAX package jits
each such segment; PyTorch needs no trace).  Keep-mask filters
(select/fps/trim) evaluate masks between pure segments; stream filters
(yadif/bwdif/setpts/thumbnail, and the per-frame filters that carry
state: hqdn3d, deband, noise, vignette, hue) may change the batch size
and carry state across batches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.frame import FrameBatch
from .builtin import FILTERS, FilterError, _take_frames

# positional option names per filter (ffmpeg shorthand order)
POSITIONAL = {
    "tpad": ("start", "stop", "start_mode", "stop_mode",
             "start_duration", "stop_duration", "color"),
    "delogo": ("x", "y", "w", "h", "show"),
    "deband": ("1thr", "2thr", "3thr", "4thr", "range", "direction",
               "blur", "coupling"),
    "crop": ("w", "h", "x", "y"),
    "crop_nvcv": ("w", "h", "x", "y"),
    "scale": ("w", "h", "interp"),
    "scale_cuda": ("w", "h", "interp"),
    "scale_npp": ("w", "h", "interp"),
    "rotate": ("angle", "interp", "shift_x", "shift_y"),
    "rotate_nvcv": ("angle", "interp", "shift_x", "shift_y"),
    "pad": ("w", "h", "x", "y", "color"),
    "trim": ("start", "end"),
    "loop": ("loop", "size", "start"),
    "setpts": ("expr",),
    "eq": ("contrast", "brightness", "saturation", "gamma"),
    "fade": ("type", "start_frame", "nb_frames"),
    "drawbox": ("x", "y", "w", "h", "color", "thickness"),
    "unsharp": ("luma_msize_x", "luma_msize_y", "luma_amount",
                "chroma_msize_x", "chroma_msize_y", "chroma_amount"),
    "hue": ("h", "s", "H", "b"),
    "lut3d": ("file", "interp"),
    "lut1d": ("file", "interp"),
    "curves": ("preset", "master"),
    "colorchannelmixer": ("rr", "rg", "rb", "ra", "gr", "gg", "gb", "ga",
                          "br", "bg", "bb", "ba", "ar", "ag", "ab", "aa",
                          "pc", "pa"),
    "colorbalance": ("rs", "gs", "bs", "rm", "gm", "bm", "rh", "gh",
                     "bh", "pl"),
    "hqdn3d": ("luma_spatial", "chroma_spatial", "luma_tmp",
               "chroma_tmp"),
    "lut": ("c0", "c1", "c2", "c3"),
    "lutyuv": ("c0", "c1", "c2", "c3"),
    "lutrgb": ("c0", "c1", "c2", "c3"),
    "flip": ("code",),
    "flip_nvcv": ("code",),
    "transpose": ("dir", "passthrough"),
    "transpose_npp": ("dir", "passthrough"),
    "sharpen_npp": ("border_type",),
    "smooth": ("type", "kw", "kh", "border_type", "sigmaX", "sigmaY"),
    "smooth_nvcv": ("type", "kw", "kh", "border_type", "sigmaX", "sigmaY"),
    "format": ("pix_fmt", "norm", "shift"),
    "format_cuda": ("pix_fmt", "norm", "shift"),
    "select": ("expr",),
    "select_cuda": ("expr",),
    "select_gpu": ("expr",),
    "fps": ("fps",),
    "framerate": ("fps", "interp_start", "interp_end", "scene",
                  "flags"),
    "separatefields": (),
    "telecine": ("first_field", "pattern"),
    "detelecine": ("first_field", "pattern", "start_frame"),
    "xfade": ("transition", "duration", "offset", "expr"),
    "il": ("luma_mode", "chroma_mode", "alpha_mode", "luma_swap",
           "chroma_swap", "alpha_swap"),
    "shuffleframes": ("mapping",),
    "reverse": (),
    "zoompan": ("zoom", "x", "y", "d", "s", "fps"),
    "blend": ("c0_mode", "c1_mode", "c2_mode", "c3_mode", "all_mode"),
    "tblend": ("c0_mode", "c1_mode", "c2_mode", "c3_mode", "all_mode"),
    "exposure": ("exposure", "black"),
    "colortemperature": ("temperature", "mix", "pl"),
    "weave": ("first_field",),
    "doubleweave": ("first_field",),
    "thumbnail": ("n",),
    "thumbnail_cuda": ("n",),
    "tensorrt": ("model", "weights", "luma_only"),
    "infer": ("model", "weights", "luma_only"),
    "chromakey": ("color", "similarity", "blend"),
    "chromakey_cuda": ("color", "similarity", "blend"),
    "overlay": ("path", "x", "y"),
    "overlay_cuda": ("path", "x", "y"),
    "yadif": ("mode", "parity", "deint"),
    "bwdif": ("mode", "parity", "deint"),
    # boxblur positionals per the documented shorthand (vf_boxblur.c
    # options order); gblur per gblur_options
    "boxblur": ("luma_radius", "luma_power", "chroma_radius",
                "chroma_power", "alpha_radius", "alpha_power"),
    "gblur": ("sigma", "steps", "planes", "sigmaV"),
    "yadif_cuda": ("mode", "parity", "deint"),
    "null": (),
    "copy": (),
    "hflip": (),
    "vflip": (),
    "negate": ("components", "negate_alpha"),
    "swapuv": (),
    "extractplanes": ("planes",),
    "alphaextract": (),
    "monochrome": ("cb", "cr", "size", "high"),
    # tonemap's single positional is the algorithm (vf_tonemap.c options
    # table); zscale's are w/h (vf_zscale.c:1004-1006)
    "tonemap": ("tonemap", "param", "desat", "peak"),
    "zscale": ("w", "h"),
}



def _split(s: str, sep: str) -> List[str]:
    """Split on sep, honoring backslash escapes and quotes."""
    out, cur, i, q = [], [], 0, None
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            cur.append(s[i + 1])
            i += 2
            continue
        if q:
            if ch == q:
                q = None
            else:
                cur.append(ch)
        elif ch in "'\"":
            q = ch
        elif ch == sep:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    out.append("".join(cur))
    return out


def parse_graph(spec: str) -> List[Tuple[str, Dict[str, str]]]:
    chain = []
    for part in _split(spec.strip(), ","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, argstr = part.split("=", 1)
        else:
            name, argstr = part, ""
        name = name.strip()
        if name not in FILTERS:
            raise FilterError(f"unknown filter {name!r}; known: "
                              f"{sorted(set(FILTERS))}")
        kwargs: Dict[str, str] = {}
        pos = POSITIONAL.get(name, ())
        if argstr:
            named_seen = False
            for i, tok in enumerate(_split(argstr, ":")):
                # named options may START with a digit (deband's
                # 1thr..4thr are real AVOption names); only a purely
                # numeric "key" stays positional
                if "=" in tok and \
                        tok.split("=", 1)[0].replace("_", "").isalnum() and \
                        not tok.split("=", 1)[0].isdigit():
                    k, v = tok.split("=", 1)
                    kwargs[k.strip()] = v
                    named_seen = True
                else:
                    if named_seen:     # ffmpeg rejects this too — binding
                        raise FilterError(   # by token index would be wrong
                            f"positional value {tok!r} after named options "
                            f"in {name}; use key=value")
                    if i >= len(pos):
                        raise FilterError(
                            f"too many positional args for {name}: {tok!r}")
                    kwargs[pos[i]] = tok
        chain.append((name, kwargs))
    return chain


class FilterGraph:
    """Filter chain over FrameBatches, run eagerly on the batch's device.

    Three segment kinds:
      pure    — composed FrameBatch->FrameBatch functions
      control — keep-mask filters (select/fps/trim), run between pure
                segments
      stream  — stateful N->M batch transforms (yadif, bwdif, setpts,
                thumbnail) that may change the batch size / carry
                temporal state; they thread the per-frame metadata
                (pts/times/keys/keep) along.

    After each process() call, out_pts/out_times/out_keys hold the
    metadata matching the *returned* batch (stream filters may delay,
    drop, or double frames).  flush() drains stateful filters at EOF.

    `link_state` is the build-time analog of AVFilterLink property
    propagation: seeded from `stream_meta` (a stream probe's color_trc,
    primaries and mdcv/clli side data), read and rewritten in chain
    order by the link-aware filters (zscale, tonemap; filters/hdr.py).
    """

    def __init__(self, spec: str, src_fps: float = 30.0,
                 stream_meta: Optional[Dict] = None):
        self.spec = spec
        self.segments: List = []
        # every instance, chain order: the handle for reading per-filter
        # state after processing (infer's last_output, select counters)
        self.filters: List = []
        self.link_state: Dict = dict(stream_meta or {})
        pure: List = []
        for name, kwargs in parse_graph(spec):
            factory = FILTERS[name]
            if name in ("fps", "tpad", "framerate", "telecine",
                        "detelecine", "xfade", "zoompan"):
                kwargs.setdefault("src_fps", src_fps)
            if getattr(factory, "wants_link", False):
                kwargs.setdefault("_link", self.link_state)
            inst = factory(**kwargs)
            self.filters.append(inst)
            if getattr(inst, "batch_control", False):
                kind = "control"
            elif getattr(inst, "stream_filter", False):
                kind = "stream"
            else:
                pure.append(inst)
                continue
            if pure:
                self.segments.append(("pure", self._compose(pure)))
                pure = []
            self.segments.append((kind, inst))
        if pure:
            self.segments.append(("pure", self._compose(pure)))
        self.fps_mul = 1
        for kind, seg in self.segments:
            self.fps_mul *= getattr(seg, "fps_mul", 1)
        self.out_pts = self.out_times = self.out_keys = None

    @staticmethod
    def _compose(fns: Sequence):
        def run(fb: FrameBatch) -> FrameBatch:
            for f in fns:
                fb = f(fb)
            return fb
        return run

    def _run_segments(self, fb: FrameBatch, meta: Dict, start: int = 0):
        for i in range(start, len(self.segments)):
            if fb.batch == 0:
                break
            kind, seg = self.segments[i]
            if kind == "pure":
                fb = seg(fb)
            elif kind == "stream":
                fb, meta = seg.process_batch(fb, meta)
            else:
                # the filter sees only frames still alive (ffmpeg chain
                # semantics: its counters skip frames an upstream
                # select/fps already dropped, and the padded tail)
                mask = seg.keep_mask(fb, pts=meta["pts"], times=meta["times"],
                                     keys=meta["keys"],
                                     pos=meta.get("pos"),
                                     keep=meta["keep"])
                meta["keep"] = meta["keep"] & mask
        return fb, meta

    def process(self, fb: FrameBatch, pts: Optional[np.ndarray] = None,
                times: Optional[np.ndarray] = None,
                keys: Optional[np.ndarray] = None,
                valid: Optional[int] = None,
                keep: Optional[np.ndarray] = None,
                pos: Optional[np.ndarray] = None,
                interlaced: Optional[np.ndarray] = None):
        """Run the chain on one batch.

        Returns (FrameBatch, keep_mask); keep_mask matches the returned
        batch and already excludes padded tail frames when `valid` < batch
        (and anything masked out by an upstream `keep`).
        """
        n = fb.batch
        k = np.ones(n, bool) if keep is None else np.asarray(keep).copy()
        if valid is not None:
            k[valid:] = False
        padmask = np.zeros(n, bool)
        if valid is not None:
            padmask[valid:] = True
        meta = {"pts": pts, "times": times, "keys": keys, "pos": pos,
                "interlaced": interlaced, "keep": k, "pad": padmask}
        fb, meta = self._run_segments(fb, meta)
        self.out_pts = meta.get("pts")
        self.out_times = meta.get("times")
        self.out_keys = meta.get("keys")
        return fb, meta["keep"]

    def flush(self):
        """End-of-stream: drain every stateful filter, pushing its residual
        frames through the rest of the chain (so e.g. a flushed thumbnail
        still gets scaled downstream).  Returns a list of (FrameBatch,
        keep_mask, meta) in emission order; meta carries the matching
        pts/times/keys arrays (entries may be None)."""
        outs = []
        for i, (kind, seg) in enumerate(self.segments):
            fl = getattr(seg, "flush", None)
            if fl is None:
                continue
            res = fl()
            if res is None:
                continue
            # a filter may flush a LIST of (fb, meta) chunks
            items = res if isinstance(res, list) else [res]
            for fb, meta in items:
                for key in ("pts", "times", "keys", "pos"):
                    meta.setdefault(key, None)
                if meta.get("keep") is None:
                    meta["keep"] = np.ones(fb.batch, bool)
                fb, meta = self._run_segments(fb, meta, i + 1)
                if fb.batch:
                    outs.append((fb, meta["keep"], meta))
        return outs

    def run_frames(self, batch_iter):
        """Iterate (FrameBatch, pts, valid) batches -> per-frame results.

        Yields (frame_planes_dict, pts, FrameBatch) for kept frames (host
        numpy), including end-of-stream flush output.
        """
        def emit(out, keep, opts):
            idx = np.nonzero(keep)[0]
            if len(idx) == 0:
                return
            planes = out.planes
            if len(idx) < out.batch:
                # gather the kept frames on the device before the host
                # copy: a sparse select would otherwise copy the whole
                # batch only to discard most of it
                planes = _take_frames(planes, idx)
            host = {k: v.cpu().numpy() for k, v in planes.items()}
            for j, i in enumerate(idx):
                p = int(opts[i]) if opts is not None else 0
                yield {k: v[j] for k, v in host.items()}, p, out

        for fb, pts, valid in batch_iter:
            out, keep = self.process(fb, pts=pts, valid=valid)
            yield from emit(out, keep, self.out_pts)
        for out, keep, meta in self.flush():
            yield from emit(out, keep, meta.get("pts"))
