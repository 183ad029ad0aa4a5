"""Measure the port's auto-dispatch regions on the card and derive its table.

    python -m acids_transforms_tpu_torch.tools.sweep_regions [--batch 128] [--seconds 4.0]
        [--sessions 1,8,64,256] [--session-seconds 2.0] [--runs 5] [--seed 0]
        [--out dispatch_regions.json] [--raw raw.json] [--parts fuse,fit,stream,memory]
        [--update dispatch_regions.json]

The port's twin of the JAX package's ``tools/sweep_region_check.py``.  Every
value of ``acids_transforms_tpu_torch/dispatch_regions.json`` comes from a run
of this script (``--out`` writes the table it derives; ``--raw`` every
measurement).  The parts:

* ``fuse``: ``fuse_forward`` of each pattern with ``backend="kernel"``
  against ``backend="eager"`` (what ``auto`` runs outside the region), the
  card's time per call (CUDA events over 3 calls back to back, median of
  ``--runs`` runs), on ``--batch`` stereo clips of ``--seconds`` s at 44.1
  kHz made on the card from ``--seed``, at n_fft 128, 256, 512, 768, 896,
  1024, 1408, 2048 and 4096 with overlap 4, at 64 with overlap 2 (the
  kernels take a hop that is a multiple of 32 only) and at 1024 with overlap
  2 and 8.  768 = 2^8 3 measures the smooth route of every pattern's kernels
  (A, E, G); 896 = 2^7 7 the smooth route's radix-7 instance of the
  magnitude patterns' kernels (A, E) and the factored and product routes of
  the representations' (G, which has no radix-7 instance); 1408 = 2^7 11
  the magnitude patterns' factored and product routes
  (:func:`route_points`).  The patterns:
  ``Mono + STFT(hann) + Magnitude(log1p, mel)`` (melspec_taps), ``Mono +
  DGT + Magnitude(log1p)`` (melspec_fullk), ``Mono + STFT | DGT + PolarIF``
  (repr_if taps / fullk), ``Mono + STFT | DGT + Polar`` (repr_phase_imag
  taps / fullk) and ``Mono + MFCC`` (mfcc).
* ``fit``: ``fuse_fit(backend="kernel")`` against ``chain.fit`` for the
  DGT's magnitude and PolarIF chains (F, H full-K) at the same n_fft (64 to
  4096 with 1408, overlap 4 but 64/32).
* ``stream``: each session route (``backend="fused"``) against the generic
  chunk scan on ``--sessions`` mono sessions of ``--session-seconds`` s of
  ``OverlapAdd + RealtimeSTFT`` at each of :data:`STREAM_SHAPES`: 1024/256
  (chunks of 4096, the FFT route), 1200/300 (chunks of 4800, 16 frames as
  at 1024; the smooth route) and 1344/336 (chunks of 5376; the encodes, the
  roundtrips and the decodes on the smooth route's radix-7 stage, O's
  two-launch projection's analysis on its product); the encode, the
  complex roundtrip and decode, and the roundtrip and decode of ``random``,
  ``pghi``, ``pghi_gl`` and ``sinebank``; the host's clock to the card's end, median of 3 runs
  (the generic scans are host loops).  A generic scan that took over 15 s
  at one batch is not run at the next of that shape, and the skip is
  recorded.
* ``memory``: each phaseless route's and the sinebank closed form's peak
  allocation (``torch.cuda.max_memory_allocated`` over the call, less what
  was allocated before) per byte of its session buffer, at the two largest
  batches, at 1024/256.

The derived table: a shape region per pattern (the measured power-of-two
n_fft around 1024 where the kernel wins, and the routes it admits: ``fft``,
``smooth`` where the pattern's kernel won at every smooth point of
:func:`route_points`, ``factored`` / ``product`` where it won at every
other-route point); the full-K fit's largest
n_fft up to which both fits win at every measured power of two, and per fit
the routes it admits by the same rule; per session mode the
largest measured batch up
to which the route wins at every measured batch of every measured shape
(None where it wins at all); the angle and frame buffer caps at which a
session peaks at half the card's memory.  The table has no key for an
overlap or for the fit's smallest n_fft: the derivation raises if the
kernel lost at an overlap other than 4 or at the fit's smallest sizes (the
card would then need one; the raw measurements are written first).  With
``--update TABLE`` the sections of the parts run replace those of an
existing table (``fuse``: ``fuse_forward``; ``fit``: ``fuse_fit``;
``stream`` and ``memory`` together: ``streaming``) and the others stay as
they were measured: after a change to a session kernel's route,
``--parts stream,memory --update`` re-measures the sessions alone.  It
needs a CUDA device: there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from .._device import resolve_device

SR = 44100
SHAPES = [(64, 32), (128, 32), (256, 64), (512, 128), (768, 192), (896, 224), (1024, 256), (1408, 352),
          (2048, 512), (4096, 1024), (1024, 512), (1024, 128)]
#: the fit's shapes: overlap 4 (64/32 at overlap 2)
FIT_SHAPES = SHAPES[:10]
#: the powers of two the FFT route covers, each measured at overlap 4 but 64
#: (overlap 2: a hop of 16 is no multiple of 32)
POW2 = {64: "64/32", 128: "128/32", 256: "256/64", 512: "512/128", 1024: "1024/256", 2048: "2048/512",
        4096: "4096/1024"}
KINDS = ["melspec_taps", "melspec_fullk", "repr_if_taps", "repr_if_fullk", "repr_phase_taps",
         "repr_phase_fullk", "mfcc"]
FIT_KINDS = ["fit_melspec_fullk", "fit_repr_if_fullk"]
#: the points that measure each route off a power of two for the
#: representations (G, H): the smooth route at 768 (2^8 3), their factored /
#: product front end at 896 (2^7 7: no radix-7 instance of G or H)
SMOOTH_POINTS = {"smooth": ["768/192"], "other": ["896/224"]}
#: the same for the magnitude patterns (A, B, E, F): the smooth route at 768
#: and, on its radix-7 instance, at 896; their factored / product front end
#: at 1408 (2^7 11)
SEVEN_POINTS = {"smooth": ["768/192", "896/224"], "other": ["1408/352"]}
#: the patterns whose kernels are A, B, E or F
MAGNITUDE_KINDS = ("melspec_taps", "melspec_fullk", "mfcc", "fit_melspec_fullk")


def route_points(kind: str) -> Dict[str, List[str]]:
    """Per route a pattern's kernel takes off a power of two (``smooth``,
    and ``other``: its factored or product front end), the shapes that
    measure it: :data:`SEVEN_POINTS` for the magnitude patterns
    (:data:`MAGNITUDE_KINDS`: A, B, E and F take the smooth route at 896 on
    their radix-7 instance), :data:`SMOOTH_POINTS` for the
    representations."""
    return SEVEN_POINTS if kind in MAGNITUDE_KINDS else SMOOTH_POINTS


def other_route(kind: str) -> str:
    """The name of a pattern's front end at n_fft neither route covers."""
    return "product" if kind.endswith("fullk") else "factored"


def admitted_routes(kind: str, wins: Dict[str, bool]) -> List[str]:
    """The routes a region of ``kind`` admits: ``fft``, and each other route
    whose every measured point won (``wins``: shape -> the kernel won)."""
    out = ["fft"]
    for route, points in route_points(kind).items():
        if all(wins[p] for p in points):
            out.append(other_route(kind) if route == "other" else route)
    return out
#: the session sweep's shapes, (n_fft, hop, chunk): 16 frames a chunk each
STREAM_SHAPES = [(1024, 256, 4096), (1200, 300, 4800), (1344, 336, 5376)]
#: the share of the card's memory a session may peak at under ``auto``
CARD_SHARE = 0.5
#: a generic scan slower than this at one batch is not run at the next
GENERIC_LIMIT_S = 15.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_audio(batch: int, length: int, gen: torch.Generator, channels: int = 2) -> torch.Tensor:
    """Per clip a few harmonics with random pitch and decay plus a noise
    floor, peak about 0.5 (``chip_smoke.py``'s corpus)."""
    dev = gen.device
    t = torch.arange(length, device=dev, dtype=torch.float32) / SR
    f0 = 80.0 + 800.0 * torch.rand((batch, 1, 1), generator=gen, device=dev)
    x = torch.zeros((batch, channels, length), device=dev)
    for h in range(1, 6):
        ph = 2 * math.pi * torch.rand((batch, channels, 1), generator=gen, device=dev)
        x += torch.sin(2 * math.pi * h * f0 * t + ph) / h
    decay = torch.exp(-t * (0.2 + 2.0 * torch.rand((batch, 1, 1), generator=gen, device=dev)))
    x = x * decay + 0.02 * torch.randn(x.shape, generator=gen, device=dev)
    return 0.5 * x / x.abs().amax(dim=(-2, -1), keepdim=True)


def device_ms(fn, runs: int, calls: int = 3, warmup: int = 2) -> float:
    """The card's time per call: CUDA events over ``calls`` calls back to
    back, median of ``runs`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def wall_ms(fn, runs: int) -> float:
    """The host's clock from the call to the card's end, median of ``runs``
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def build_chain(T, kind: str, n_fft: int, hop: int, dev):
    if kind == "mfcc":
        return T.Mono(device=dev) + T.MFCC(n_fft=n_fft, hop_length=hop, device=dev)
    fullk = kind.endswith("fullk")
    front = (T.DGT(n_fft=n_fft, hop_length=hop, device=dev) if fullk
             else T.STFT(n_fft=n_fft, hop_length=hop, device=dev))
    if kind.startswith("fit_melspec") or kind.startswith("melspec"):
        last = T.Magnitude(mode="unipolar", contrast="log1p", mel=not fullk, n_fft=n_fft, device=dev)
    elif "repr_if" in kind:
        last = T.PolarIF(magnitude_args={"mode": "bipolar", "n_fft": n_fft}, device=dev)
    else:
        last = T.Polar(magnitude_args={"mode": "bipolar", "n_fft": n_fft}, device=dev)
    return T.Mono(device=dev) + front + last


def sweep_fuse(att, T, audio, runs: int, log) -> Dict[str, Dict[str, dict]]:
    out: Dict[str, Dict[str, dict]] = {}
    for kind in KINDS:
        out[kind] = {}
        for n_fft, hop in SHAPES:
            chain = build_chain(T, kind, n_fft, hop, audio.device)
            kf = att.fuse_forward(chain, backend="kernel")
            ef = att.fuse_forward(chain, backend="eager")
            k_ms = device_ms(lambda: kf(audio), runs)
            e_ms = device_ms(lambda: ef(audio), runs)
            out[kind]["%d/%d" % (n_fft, hop)] = {"kernel_ms": k_ms, "eager_ms": e_ms, "ratio": k_ms / e_ms}
            log("  fuse %-16s %4d/%-4d kernel %8.3f ms  eager %8.3f ms  ratio %.3f"
                % (kind, n_fft, hop, k_ms, e_ms, k_ms / e_ms))
            del kf, ef
        torch.cuda.empty_cache()
    return out


def sweep_fit(att, T, audio, runs: int, log) -> Dict[str, Dict[str, dict]]:
    out: Dict[str, Dict[str, dict]] = {}
    for kind in FIT_KINDS:
        out[kind] = {}
        for n_fft, hop in FIT_SHAPES:
            chain = build_chain(T, kind, n_fft, hop, audio.device)
            kfit = att.fuse_fit(chain, backend="kernel")
            k_ms = device_ms(lambda: kfit(audio), runs)
            e_ms = device_ms(lambda: chain.fit(audio), runs)
            out[kind]["%d/%d" % (n_fft, hop)] = {"kernel_ms": k_ms, "eager_ms": e_ms, "ratio": k_ms / e_ms}
            log("  fit  %-18s %4d/%-4d kernel %8.3f ms  chain.fit %8.3f ms  ratio %.3f"
                % (kind, n_fft, hop, k_ms, e_ms, k_ms / e_ms))
        torch.cuda.empty_cache()
    return out


def session_calls(streaming, T, dev, B: int, length: int, seed: int, shape=STREAM_SHAPES[0]):
    """Per session mode the route and the generic scan of each call, and
    the session's buffer sizes, at ``shape`` ``(n_fft, hop, chunk)``."""
    n_fft, hop, chunk = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    x = make_audio(B, length, gen, channels=1)[:, 0].contiguous()
    T_c = chunk // hop

    def chain(mode=None):
        return T.OverlapAdd(n_fft, hop, device=dev) + T.RealtimeSTFT(
            n_fft=n_fft, hop_length=hop, device=dev, **({"inversion_mode": mode} if mode else {}))

    c0 = chain()
    spec, _ = streaming.scan_forward(c0, x, chunk, backend="generic")
    mags = spec.abs()

    def g():
        return torch.Generator(device=dev).manual_seed(seed + 5)

    calls = {
        "encode": [(lambda b: streaming.scan_forward(c0, x, chunk, backend=b))],
        "complex": [(lambda b: streaming.scan_roundtrip(c0, x, chunk, backend=b))],
        "complex_decode": [(lambda b: streaming.scan_invert(c0, spec, T_c, backend=b))],
    }
    for mode in ("random", "pghi", "pghi_gl", "sinebank"):
        cm = chain(mode)
        calls[mode] = [
            (lambda b, cm=cm, mode=mode: streaming.scan_roundtrip(cm, x, chunk, mode, generator=g(), backend=b)),
            (lambda b, cm=cm, mode=mode: streaming.scan_invert(cm, mags, T_c, mode, generator=g(), backend=b)),
        ]
    n_frames = mags.shape[-2]
    sizes = {"angle_bytes": B * n_frames * mags.shape[-1] * 4, "frame_bytes": B * n_frames * n_fft * 4}
    return calls, sizes


def sweep_stream(streaming, T, dev, batches: List[int], length: int, seed: int, log) -> dict:
    """Per shape ``"n_fft/hop"`` of :data:`STREAM_SHAPES`, per mode and
    batch, the route's and the generic scan's times."""
    return {"%d/%d" % shape[:2]: _sweep_stream_shape(streaming, T, dev, batches, length, seed, log, shape)
            for shape in STREAM_SHAPES}


def _sweep_stream_shape(streaming, T, dev, batches, length, seed, log, shape) -> dict:
    out: Dict[str, Dict[str, dict]] = {}
    skip: Dict[str, bool] = {}
    where = "%d/%d" % shape[:2]
    for B in batches:
        calls, _ = session_calls(streaming, T, dev, B, length, seed, shape)
        for mode, fns in calls.items():
            row = out.setdefault(mode, {})
            if skip.get(mode):
                row[str(B)] = {"skipped": "the generic scan took over %.0f s at the batch before" % GENERIC_LIMIT_S}
                log("  stream %-9s %-14s B=%-4d skipped" % (where, mode, B))
                continue
            r_ms, g_ms = [], []
            for fn in fns:
                r_ms.append(wall_ms(lambda: fn("fused"), 3))
                g_ms.append(wall_ms(lambda: fn("generic"), 3))
            if max(g_ms) > 1e3 * GENERIC_LIMIT_S:
                skip[mode] = True
            row[str(B)] = {"route_ms": r_ms, "generic_ms": g_ms, "ratio": [r / g for r, g in zip(r_ms, g_ms)]}
            log("  stream %-9s %-14s B=%-4d route %s ms  generic %s ms  ratio %s" % (
                where, mode, B, " / ".join("%.2f" % v for v in r_ms), " / ".join("%.1f" % v for v in g_ms),
                " / ".join("%.3f" % (r / g) for r, g in zip(r_ms, g_ms))))
        del calls
        torch.cuda.empty_cache()
    return out


def sweep_memory(streaming, T, dev, batches: List[int], length: int, seed: int, log) -> dict:
    out: Dict[str, Dict[str, dict]] = {}
    for B in batches:
        calls, sizes = session_calls(streaming, T, dev, B, length, seed)
        for mode in ("random", "pghi", "pghi_gl", "sinebank"):
            buf = sizes["frame_bytes" if mode == "sinebank" else "angle_bytes"]
            for which, fn in zip(("roundtrip", "decode"), calls[mode]):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                y = fn("fused")
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                del y
                out.setdefault(mode, {})["%s B=%d" % (which, B)] = {
                    "peak_bytes": peak, "buffer_bytes": buf, "per_buffer_byte": peak / buf}
                log("  memory %-9s %-9s B=%-4d peak %.1f MB over a buffer of %.1f MB: %.2f"
                    % (mode, which, B, peak / 1e6, buf / 1e6, peak / buf))
        del calls
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- the table
def _run(values: Dict, keys: List, centre) -> Optional[List]:
    """The longest run of winners in ``keys`` (in order) around ``centre``."""
    if not values.get(centre, False):
        return None
    i = keys.index(centre)
    lo = hi = i
    while lo > 0 and values.get(keys[lo - 1], False):
        lo -= 1
    while hi < len(keys) - 1 and values.get(keys[hi + 1], False):
        hi += 1
    return keys[lo: hi + 1]


def shape_region(rows: Dict[str, dict], card: str, what: str, kind: str) -> Optional[dict]:
    wins = {k: v["ratio"] < 1.0 for k, v in rows.items()}
    pow2 = sorted(POW2)
    n_run = _run({n: wins[POW2[n]] for n in pow2}, pow2, 1024)
    ratios = ", ".join("%s %.2fx" % (k, v["ratio"]) for k, v in rows.items())
    why = ("%s: %s; kernel / eager route time per call (the card's, median of the runs) at %s"
           % (card, what, ratios))
    if n_run is None:
        return {"_why": why + "; the kernel loses at 1024/256: no region"}
    if not (wins["1024/512"] and wins["1024/128"]):
        raise ValueError("%s: the kernel lost at an overlap other than 4, and the table has no "
                         "overlap key: %s" % (what, ratios))
    routes = admitted_routes(kind, wins)
    return {
        "_why": why + "; the region holds the winners around 1024/256 (below 1) on the routes whose every "
                      "measured point won (%s)" % route_note(kind),
        "n_fft_min": n_run[0],
        "n_fft_max": n_run[-1],
        "routes": routes,
    }


def route_note(kind: str) -> str:
    """Which shape measured which route, for a ``_why``."""
    return "; ".join("%s: %s" % (other_route(kind) if r == "other" else r, ", ".join(p))
                     for r, p in route_points(kind).items())


_DOC = [
    "The port's auto-dispatch regions (regions.py), every value measured on the card named in",
    "its _why by acids_transforms_tpu_torch/tools/sweep_regions.py; none is the JAX package's.",
]


def derive_table(raw: dict, card: str, total_mem: int) -> dict:
    return {
        "_doc": list(_DOC),
        "fuse_forward": fuse_section(raw["fuse"], card),
        "fuse_fit": fit_section(raw["fit"], card),
        "streaming": streaming_section(raw["stream"], raw["memory"], card, total_mem),
    }


def fuse_section(fuse: dict, card: str) -> dict:
    what = {
        "melspec_taps": "Mono + STFT(hann) + Magnitude(unipolar, log1p, mel)",
        "melspec_fullk": "Mono + DGT + Magnitude(unipolar, log1p)",
        "repr_if_taps": "Mono + STFT(hann) + PolarIF", "repr_if_fullk": "Mono + DGT + PolarIF",
        "repr_phase_taps": "Mono + STFT(hann) + Polar (Cartesian shares it)",
        "repr_phase_fullk": "Mono + DGT + Polar (Cartesian shares it)", "mfcc": "Mono + MFCC",
    }
    regions = {k: shape_region(fuse[k], card, what[k], k) for k in KINDS}
    return {
        "melspec_taps": regions["melspec_taps"],
        "melspec_fullk": regions["melspec_fullk"],
        "repr_if": {"taps": regions["repr_if_taps"], "fullk": regions["repr_if_fullk"]},
        "repr_phase_imag": {"taps": regions["repr_phase_taps"], "fullk": regions["repr_phase_fullk"]},
        "mfcc": regions["mfcc"],
    }


def fit_section(fit: dict, card: str) -> dict:
    """The full-K fit: the largest n_fft up to which both fits win, and per
    fit the routes it admits off a power of two (:func:`admitted_routes`)."""
    pow2 = sorted(POW2)
    both = {n: all(fit[k][POW2[n]]["ratio"] < 1.0 for k in FIT_KINDS) for n in pow2}
    run = _run(both, pow2, 1024)
    if not run or run[0] != pow2[0]:
        raise ValueError("the full-K fit lost below 1024, and the table has no key for its smallest n_fft")
    fit_ratios = "; ".join("%s: %s" % (k, ", ".join("%s %.2fx" % (s, v["ratio"]) for s, v in fit[k].items()))
                           for k in FIT_KINDS)
    routes = {k: admitted_routes(k, {s: v["ratio"] < 1.0 for s, v in fit[k].items()}) for k in FIT_KINDS}
    return {
        "_why": "%s: fuse_fit(backend='kernel') / chain.fit time per call of the DGT chains (the card's, "
                "median of the runs) at %s; the largest n_fft up to which both win, and per fit the routes "
                "whose every measured point won (magnitude, F: %s; PolarIF, H full-K: %s)"
                % (card, fit_ratios, route_note("fit_melspec_fullk"), route_note("fit_repr_if_fullk")),
        "fullk_n_fft_max": run[-1] if run else 0,
        "melspec_fullk_routes": routes["fit_melspec_fullk"],
        "repr_fullk_routes": routes["fit_repr_if_fullk"],
    }


def _batch_cap(rows: dict) -> Optional[int]:
    """The largest measured batch up to which the route wins at every
    measured batch of one shape; None where it wins at all."""
    measured = sorted(int(b) for b, v in rows.items() if "ratio" in v)
    won = [b for b in measured if max(rows[str(b)]["ratio"]) < 1.0]
    if won == measured:
        return None
    cap = 0
    for b in measured:
        if b not in won:
            break
        cap = b
    return cap


def streaming_section(stream: dict, mem: dict, card: str, total_mem: int) -> dict:
    # batch caps: the least of the shapes' (None: the route won everywhere)
    caps, cap_why = {}, []
    for mode in ("complex", "complex_decode", "encode", "pghi", "pghi_gl", "random"):
        per_shape = [_batch_cap(stream[shape][mode]) for shape in stream]
        caps[mode] = min((c for c in per_shape if c is not None), default=None)
        cap_why.append("%s %s" % (mode, "; ".join("%s: %s" % (shape, ", ".join(
            "B=%s %s" % (b, "/".join("%.3f" % r for r in v["ratio"]) if "ratio" in v else "not run")
            for b, v in stream[shape][mode].items())) for shape in stream)))
    # memory caps: the buffer at which a session peaks at CARD_SHARE of the card
    ang = max(v["per_buffer_byte"] for m in ("random", "pghi", "pghi_gl") for v in mem[m].values())
    sb = max(v["per_buffer_byte"] for v in mem["sinebank"].values())
    mib = 1 << 20

    def cap_of(r):
        return int(CARD_SHARE * total_mem / r) // mib * mib

    mem_txt = "; ".join("%s %s" % (m, ", ".join("%s %.2f" % (k, v["per_buffer_byte"]) for k, v in mem[m].items()))
                        for m in ("random", "pghi", "pghi_gl"))
    shapes = " and ".join("OverlapAdd(%d, %d) + RealtimeSTFT(%d, %d), chunks of %d" % (n, h, n, h, c)
                          for n, h, c in STREAM_SHAPES if "%d/%d" % (n, h) in stream)
    return {
        "angle_cap_bytes": cap_of(ang),
        "_angle_why": "%s (%.1f GB): the phaseless sessions' peak allocation per byte of their (B, T, F) "
                      "float32 angle buffer, at most %.2f (%s); capped where a session peaks at %d %% of the "
                      "card, the rest kept free; the generic scan draws chunk by chunk above"
                      % (card, total_mem / 1e9, ang, mem_txt, int(100 * CARD_SHARE)),
        "sinebank_cap_bytes": cap_of(sb),
        "_sinebank_why": "%s (%.1f GB): the sinebank closed form's peak allocation per byte of its "
                         "(B, T, n_fft) float32 frame tensor, at most %.2f; capped where a session peaks at "
                         "%d %% of the card; the generic scan above" % (card, total_mem / 1e9, sb,
                                                                       int(100 * CARD_SHARE)),
        "batch_caps": caps,
        "_batch_why": "%s: session route / generic chunk scan time (host clock to the card's end, median of "
                      "3 runs; roundtrip / decode) on 2 s mono sessions of %s: %s; a cap is the largest batch "
                      "up to which the route wins at every measured batch of every shape, None where it wins "
                      "at all" % (card, shapes, "; ".join(cap_why)),
    }


def _loadable(table: dict) -> dict:
    """A region without a winner at 1024/256 loads as None."""
    ff = table["fuse_forward"]
    for k, v in ff.items():
        if v is None:
            continue
        if "_why" in v and "n_fft_min" not in v:
            ff[k] = None
        elif "_why" not in v:
            for s in list(v):
                if v[s] is not None and "n_fft_min" not in v[s]:
                    v[s] = None
    return table


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--sessions", default="1,8,64,256")
    ap.add_argument("--session-seconds", type=float, default=2.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="fuse,fit,stream,memory")
    ap.add_argument("--out", default=None, help="write the derived table here")
    ap.add_argument("--raw", default=None, help="write every measurement here")
    ap.add_argument("--update", default=None,
                    help="a table whose sections of the parts run are replaced (the others kept)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False

    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import streaming
    from acids_transforms_tpu_torch import transforms as T

    def log(msg):
        print(msg, flush=True)

    card = card_line()
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    log("sweep_regions on %s, torch %s, CUDA %s" % (card, torch.__version__, torch.version.cuda))
    parts = set(args.parts.split(","))
    raw = {"card": card, "total_memory": total_mem, "batch": args.batch, "seconds": args.seconds}
    t0 = time.perf_counter()
    if parts & {"fuse", "fit"}:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        audio = make_audio(args.batch, int(args.seconds * SR), gen)
        if "fuse" in parts:
            raw["fuse"] = sweep_fuse(att, T, audio, args.runs, log)
        if "fit" in parts:
            raw["fit"] = sweep_fit(att, T, audio, args.runs, log)
        del audio
        torch.cuda.empty_cache()
    batches = [int(b) for b in args.sessions.split(",")]
    length = int(args.session_seconds * SR)
    if "stream" in parts:
        raw["stream"] = sweep_stream(streaming, T, dev, batches, length, args.seed, log)
    if "memory" in parts:
        raw["memory"] = sweep_memory(streaming, T, dev, batches[-2:], length, args.seed, log)
    log("sweep took %.1f s" % (time.perf_counter() - t0))
    if args.raw:
        with open(args.raw, "w") as f:
            json.dump(raw, f, indent=1)
    table = None
    if args.update:
        with open(args.update) as f:
            table = json.load(f)
        if "fuse" in parts:
            table["fuse_forward"] = fuse_section(raw["fuse"], card)
        if "fit" in parts:
            table["fuse_fit"] = fit_section(raw["fit"], card)
        if parts >= {"stream", "memory"}:
            table["streaming"] = streaming_section(raw["stream"], raw["memory"], card, total_mem)
    elif parts >= {"fuse", "fit", "stream", "memory"}:
        table = derive_table(raw, card, total_mem)
    if table is not None:
        table = _loadable(table)
        text = json.dumps(table, indent=2)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        raw["table"] = table
    return raw


if __name__ == "__main__":
    main()
    sys.exit(0)
