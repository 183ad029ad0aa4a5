"""The readings that two bounds of ``chip_smoke.py`` are set from: the
``pghi_gl`` sessions at 1344/336 (n_fft 2^6 3 7: the decodes and O's polish on
their radix-7 instances) and O's product analysis at 1408/352 (n_fft 2^7 11).

Usage (on a machine with a CUDA card)::

    python -m acids_transforms_tpu_torch.tools.session_bounds [--seed 0] [--out FILE]

* ``pghi_gl``: ``OverlapAdd + RealtimeSTFT(inversion_mode="pghi_gl")``
  sessions of 4 mono clips x 8 chunks of 2 hops, at 1344/336 and 1408/352
  (the product route), with 16 and with 1 projection a chunk, on 4 sets of
  clips of ``chip_smoke.py``'s corpus (set 0 and seed 156 are its phase 4h
  input) and two generator seeds: the session's distance to the generic
  scan (max-abs difference over the scan's max-abs) and both spectral
  convergences.  At 1344/336 also the same session with the decodes on the
  product route they took before the radix-7 stage, and, at seed 156, with the
  decodes' synthesis window perturbed by ``eps`` (uniform, relative): what a
  wrong decode reads.
* ``analysis``: O's projection analysis on its product route
  (``gl_project_analysis_kernel``) on the product synthesis of 8 random grids
  of 64 sessions (3 pinned + 8 + 3 zero frames) at 1408/352, against its
  plain version and the float64 analysis, and with its basis perturbed by
  ``eps``.  A phase is read as ``|Y| (cos,
  sin)(phase)`` over the session's largest ``|Y|``, ``Y`` the float64
  re-framed spectrum (a bin's angle is only as good as its magnitude).

One JSON object to ``--out`` (default: standard output only), a line per
reading on standard output.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from .. import streaming
from .. import transforms as T
from .._device import resolve_device
from ..ops.cuda import stream_step as ss
from .sweep_regions import SR, card_line, make_audio

SHAPES = ((1344, 336), (1408, 352))
SEEDS = (156, 1156)
EPS_DECODE = (1e-4, 1e-3)
EPS_ANALYSIS = (1e-5, 1e-4)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def decodes_on_product(fn):
    """``fn()`` with every session decode on its product route."""
    route = ss.session_route
    ss.session_route = lambda n, kind, hop=None: "product" if kind == "decode" else route(n, kind, hop)
    ss._decode_plan.cache_clear()
    try:
        return fn()
    finally:
        ss.session_route = route
        ss._decode_plan.cache_clear()


def decode_window_fault(eps: float, gen: torch.Generator, fn):
    """``fn()`` with the decodes' synthesis window times ``1 + eps u``, ``u``
    uniform in [-1, 1)."""
    operands = ss._decode_operands

    def faulty(inv_window, gain, n_fft, hop):
        u = 2 * torch.rand(inv_window.shape, generator=gen, device=inv_window.device) - 1
        return operands(inv_window * (1 + eps * u), gain, n_fft, hop)
    ss._decode_operands = faulty
    try:
        return fn()
    finally:
        ss._decode_operands = operands


def spectral_convergence(x: torch.Tensor, n_fft: int, hop: int):
    """The session output's spectral convergence against its input, after
    the chain's delay (``chip_smoke.py``'s phase 4h reading)."""
    w = torch.hann_window(n_fft, device=x.device)

    def spec(v):
        return torch.stft(v, n_fft, hop, window=w, center=True, pad_mode="reflect", return_complex=True).abs()

    def sc(y):
        d, n = n_fft - hop, x.shape[-1]
        ref, m = spec(x[..., : n - d]), spec(y[..., d:n])
        k = min(m.shape[-1], ref.shape[-1]) - 2
        return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()
    return sc


def pghi_gl_readings(mono: torch.Tensor, seed: int, log) -> list:
    dev, rows = mono.device, []
    for n_fft, hop in SHAPES:
        chunk = 8 * hop
        for iters in (16, 1):
            chain = T.OverlapAdd(n_fft, hop, device=dev) + T.RealtimeSTFT(
                n_fft=n_fft, hop_length=hop, gl_iterations=iters, device=dev)
            for clips in range(4):
                x = mono[4 * clips: 4 * clips + 4, : 8 * chunk].contiguous()
                sc = spectral_convergence(x, n_fft, hop)
                for k in SEEDS:
                    def run(backend="auto", k=k):
                        g = torch.Generator(device=dev).manual_seed(seed + 60 + k)
                        return streaming.scan_roundtrip(chain, x, chunk, "pghi_gl", generator=g, backend=backend)
                    y, y_g = run(), run("generic")
                    row = dict(shape=f"{n_fft}/{hop}", iterations=iters, clips=clips, seed=k, route=rel(y, y_g),
                               sc=sc(y), sc_generic=sc(y_g))
                    if ss.session_route(n_fft, "decode") == "smooth":
                        y_p = decodes_on_product(run)
                        row.update(product=rel(y_p, y_g), sc_product=sc(y_p), route_vs_product=rel(y, y_p))
                        if k == SEEDS[0]:
                            for eps in EPS_DECODE:
                                fault = torch.Generator(device=dev).manual_seed(seed + 7)
                                y_f = decode_window_fault(eps, fault, run)
                                row[f"fault_{eps:g}"] = rel(y_f, y_g)
                                row[f"sc_fault_{eps:g}"] = sc(y_f)
                    log(row)
                    rows.append(row)
    return rows


def analysis_readings(dev, seed: int, log) -> list:
    n_fft, hop, sessions = 1408, 352, 64
    rt = (T.OverlapAdd(n_fft, hop, device=dev) + T.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device=dev))[1]
    ov, F, ctx = n_fft // hop, n_fft // 2 + 1, rt.gl_context
    tp = ctx + 8 + ov - 1
    tx = tp - (ov - 1)
    lo, hi = rt.gl_frozen(8)
    wc, ws = ss._ana_basis(rt.window, n_fft, ss._k_analysis(n_fft))
    ops = ss._decode_operands(rt.inv_window, float(ov), n_fft, hop)
    upd = torch.ones(tx - ctx, dtype=torch.bool, device=dev)
    upd[lo - ctx: hi - ctx] = False
    rows = []
    for s in range(8):
        g = torch.Generator(device=dev).manual_seed(seed + 56 + 1000 * s)
        gm = torch.rand((sessions, tp, F), generator=g, device=dev)
        gm[:, -(ov - 1):] = 0.0
        gp = 2 * math.pi * torch.rand((sessions, tp, F), generator=g, device=dev)
        y = ss._launch_decode(gm, gp, ops, n_fft, hop, rows=ss.PROJECT_SYN_ROWS, name="gl_project_synthesis")
        fr = y.unfold(-1, n_fft, hop)[:, ctx:tx]
        a_p = torch.atan2(torch.matmul(fr, ws[:n_fft]), torch.matmul(fr, wc[:n_fft]))
        fr64 = y.double().unfold(-1, n_fft, hop)[:, ctx:tx]
        re64, im64 = torch.matmul(fr64, wc[:n_fft].double()), torch.matmul(fr64, ws[:n_fft].double())
        a_64, mag = torch.atan2(im64, re64)[:, upd], torch.hypot(re64, im64)[:, upd]
        scale = mag.amax(dim=(-2, -1), keepdim=True)

        def off(a, b):
            a, b = a.double(), b.double()
            return (mag * torch.stack([a.cos() - b.cos(), a.sin() - b.sin()]) / scale).abs().max().item()

        def kernel(wc_k, ws_k):
            out = gp.clone()
            ss._launch_project_analysis(y, out, (wc_k, ws_k), n_fft, hop, tx, ctx, lo, hi)
            return out[:, ctx:tx][:, upd]
        a_k, a_p = kernel(wc, ws), a_p[:, upd]
        row = dict(grid=s, kernel_vs_plain=off(a_k, a_p), kernel_vs_float64=off(a_k, a_64),
                   plain_vs_float64=off(a_p, a_64))
        for eps in EPS_ANALYSIS:
            fault = torch.Generator(device=dev).manual_seed(seed + 9)
            a_f = kernel(*(b * (1 + eps * (2 * torch.rand(b.shape, generator=fault, device=dev) - 1))
                           for b in (wc, ws)))
            row[f"fault_{eps:g}_vs_float64"] = off(a_f, a_64)
        log(row)
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the readings here as one JSON object")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    mono = make_audio(128, int(4.0 * SR), torch.Generator(device=dev).manual_seed(args.seed)).mean(-2).contiguous()

    def log(row):
        print(json.dumps(row), flush=True)
    out = dict(card=card_line(), pghi_gl=pghi_gl_readings(mono, args.seed, log),
               analysis=analysis_readings(dev, args.seed, log))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
