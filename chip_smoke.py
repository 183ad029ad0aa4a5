#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--batch 128] [--seconds 4.0] [--repeats 5]

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives the chains through the
public entry points at a real size (128 stereo clips of 4 s at 44.1 kHz by
default): the flagship log-mel chain (fit -> fused forward -> Griffin-Lim
invert), the DGT magnitude chain (fit -> full-K fused forward -> PGHI invert,
then the same magnitudes through ``pghi_gl``: PGHI seed and 30 full-K
Griffin-Lim steps), the DGT + PolarIF representation chain (fit -> fused
two-channel forward -> IF integration and inverse DGT), STFT + Polar (fit
-> fused forward), and the streaming chain OverlapAdd + RealtimeSTFT on 64
concurrent mono sessions of 4 s (``--streams``): encode, the complex and the
random roundtrip, the random decode and the [.., Magnitude] random roundtrip,
each as one whole-session kernel, then (phase 4g) the RT-PGHI roundtrip and
decode and the [.., Magnitude] RT-PGHI roundtrip of that chain in pghi mode
and of OverlapAdd + RealtimeDGT, the complex decode, and the same routes in
``pghi_gl`` (the RT-PGHI seed and 16 pinned-context Griffin-Lim projections a
chunk, one polish launch; lookahead 4 too; a grid the polish does not take on
two launches a projection), all held against the generic chunk scan, and (phase
4h) the dispatch outside the JAX package's gates: shapes no kernel covers
(``STFT(1024, 300)``, ``RealtimeSTFT(1000, 250)``) on the eager route against
the same calls on the CPU, and shapes the port's kernels take (1200/300) on
the kernels, and (phase 4i) BASELINE configs 2 and 3: ``Mono() + MFCC(1024,
256)`` (power 2, 128 mels) and its ``norm_mode="unipolar"`` twin through
``fuse_forward`` on kernel A (the rectangular bank, no contrast), held
against the eager chain and A against its plain version at that shape, and
the raw and layout transforms (MidSide, Stereo, Window, MuLaw and its
one-hot modes, OneHot, Transpose, Squeeze, Unsqueeze) on CUDA tensors
against the same calls on the CPU, and (phase 4j) the sinebank resynthesis:
offline at the main path's B against the same call on the CPU, the
streaming closed form (decode and roundtrip, the log-mel 3-chain and
RealtimeDGT) against the generic chunk scan, with the measured dispatch
regions' decisions at every phase's shapes (the main paths' required to
take their kernels; phase 4h forces ``backend="kernel"`` where ``auto`` now
runs the eager route), and (phase 4k) the deployment surface: the bucketed
server ``serving.CompiledTransform`` over the fitted log-mel chain (warmup of
every (batch, bucket) pair, requests at the ladder's shape bit-identical to
``fuse_forward``, padded ones on their interior frames, int16 PCM, the
bucketed Griffin-Lim invert within the GL margin, no input shape added
after warmup, A once a forward, C twice and D seven times an invert), the
live session ``serving.StreamingSession`` (RT-PGHI, bit-identical to the
eager step loop, its convergence against the session kernels', ms a
chunk), npz checkpoints (``export.save_transform`` / ``load_transform``),
``torch.export`` of the kernel forward (``export.export_program`` /
``load_program``: kernel A as the registered operator
``acids_transforms_tpu_torch::fused_melspec``, one launch a call at any
batch, int16 too) and ``invert_with_phase_fn``, and (phase 4l) the parallel
layer on a world of one over NCCL (``parallel.local_mesh()`` on the card):
``fuse_fit`` / ``fuse_forward`` / the three scans / ``CompiledTransform`` /
``StreamingSession`` / ``export_program(in_shardings=)`` under ``mesh=``,
bit-identical to the direct calls where deterministic, with their launches
and the collectives each issued (none but the fit's three scalar
all-reduces), the sequence-parallel STFT / ISTFT on 2^24 samples, a
``torch.profiler`` trace of the log-mel fit + forward, and the native layer
(``pghi_exact``'s heap beside the numpy one, 128 clips through the WAV
writer and ``import_data``).  The session encode (R, the magnitude encode), the full-K
melspec front end (E, F), the full-K Griffin-Lim step (J) and the streaming
roundtrips (L, M), K's synthesis, the full-K representation kernels (G,
H), the Griffin-Lim step of cosine-sum windows (C, its chain D, the
projection I) and the streaming decodes (P, S, O's projection synthesis)
have two routes, picked by n_fft alone: a shared-memory FFT
(``csrc/fft_smem.cuh``: ``frames_rfft`` for the analyses, ``frames_irfft``
for the syntheses of C, D, I, J, L, M, K, P, S and O) at a power of two
from 64 to 4096, the window-folded products elsewhere (R, L, M, P, S,
O's synthesis, E, F, G, H, J, C, D, I and K's synthesis take a third route,
the mixed-radix FFT, at even 5-smooth n_fft; R, the magnitude encode, L,
M, P, S, O's synthesis, E, F, G, H, J and K's synthesis also at even
7-smooth n_fft with a factor 7, on their radix-7 instances, the roundtrips,
G, H, J and K's synthesis where their block fits); so do the log-mel
forward and fit (A and B: E's and F's FFT, smooth and radix-7 instances under the
taps' own window, the factored front end elsewhere), the representations' forward
and fit statistics with taps (G and H: G and H full-K's FFT, smooth and
radix-7 instances under the taps' own window), and O's polish
(``gl_polish_fft_kernel``: every projection of a chunk in one launch, where
its block holds the grid, on the FFT route, the smooth route or its radix-7
instance; two launches a projection elsewhere, the analysis's
``gl_project_analysis_fft_kernel`` on the FFT and smooth routes, with the
polish's pairs, so that the two launches equal the polish bit for bit, and
``gl_project_analysis_kernel``, a product, at n_fft neither a power of two
nor 7-smooth).  Phases 3 and 4f
hold the FFT route against its plain version (within 1e-5 for R, E and F;
1e-6 for C, D, I, J, L, M, K's synthesis, G, H, P, S and O's synthesis,
which come out bit-identical; A within 2e-5 and B and H with taps with their
extrema bit-identical and sums within 1e-5, at every power of two from 64
under hann, hamming and blackman) and against a float64 oracle at 1024, 512,
2048 and 4096 (C, D, I, K, G, H, P, S and O's synthesis at every power of
two from 64), the factored route at 1408/352 (A, B, G, H), and
the product route at 896/224 (C, D, I),
8192/2048 (J) and 1408/352 (R, L, M, P, S, O's synthesis, E, F, G, H, J, K),
and the smooth route of R, L, M, P, S, O's synthesis and O's polish (the
mixed-radix FFT) at 1200/300, 960/240, 768/192, 400/100 and 1920/480, and
of R, the magnitude encode, L, M, P, S and O's synthesis (its radix-7
instances) at 1344/336 and 896/224 (L, M, P, S and O's synthesis also at
overlap 2, 3, 5, 6, 7 and 8), bit-identical to its plain version, of O's
polish (its radix-7 instance) at 1344/336 and 896/224 and O's analysis on the
FFT route (4096/1024), the smooth route (3072/768, 2560/1280) and its radix-7
instance (3584/896, 1344/336), bit-identical, with ``gl_iterations``
two-launch projections equal to one polish launch at 1024/256, 1200/300 and
1344/336, of E and F (A and B under hann and blackman taps) at
768/256, 768/192, 640/160, 384/96, 1536/384, 1920/480 and 3072/768 and (their
radix-7 instances) at 896/224, 896/128, 896/448, 1344/448, 1344/192,
1568/224, 1120/160 and 672/96 (|X| and
the extrema bit-identical, the mel product's and the sums' order aside), of
J's radix-7 instance at 896/224, 896/128, 1344/192, 1568/224, 672/96 and
4032/2016 and K's synthesis's at 896/224, 1344/336, 1568/224, 1764/252 and
4032/1008 (bit-identical, within 1e-5 of the float64 oracle), of
J, C, D and I at those seven framings (bit-identical, D to four C, every
frame of C, I and J within 1e-5 of the float64 oracle), of G and H full-K
at those seven and (their radix-7 instance) at 896/224, 896/128, 1568/224,
1344/192 and 672/96 (within 1e-6 of the plain version, 1e-5 of the float64
oracle; G and H with taps at 768/192 under hann, hamming and blackman, and
at 896/224 under hann with the bank; G with the IF and a bank at
4032/2016, where no smooth block fits, on the product and factored
routes), and
of K's
synthesis at those seven and 1200/300 (bit-identical, within 1e-5 of a
float64 istft);
the launch counters' route tally shows
every main-path launch of the nineteen on the FFT route, and phase 4h
drives the smooth, product and factored routes through the entry points
(1200/300 sessions: R, L, M, the magnitude encode, the decodes and, in
``pghi_gl``, O's polish on the smooth route, one launch a chunk; a 3072/768
``pghi_gl`` grid of 3 + 40 + 3 frames, which no polish block holds, on the
two-launch projection, its analysis on the smooth route, as a 2560/1280 one
of 3 + 39 + 1 and, on its radix-7 instance, a 3584/896 one of 1 + 40 + 3;
1344/336 sessions: R, L, M, the magnitude encode, the decodes and O's
polish (one launch a chunk, timed in turns with the two-launch route it
replaced) on the smooth route's radix-7 instances;
1408/352 sessions: R, L, M, the magnitude encode and the decodes (O's
two-launch synthesis and analysis among them) on the product route;
``STFT(1200, 300)`` and ``DGT(768, 256)``
``pghi`` inverts: K's synthesis on the smooth route, ``DGT(896, 224)`` on
its radix-7 instance, ``DGT(1408, 352)`` on the product route; STFT(768,
192) and STFT(896, 224)
Griffin-Lim inverts (C, D on the smooth, then the product route),
STFT(768, 192) log-mel (A, B on the smooth route) and Polar chains' fit and
forward, a DGT(768, 256) chain's fit and forward (E, F on the smooth
route), ``pghi`` and ``pghi_gl`` (J on the smooth route), DGT(768, 256) +
PolarIF's fit and forward (G, H full-K on the smooth route; the Polar chain
puts G and H with taps there), the STFT(896, 224) log-mel and DGT(896, 224)
magnitude chains' fit and forward (A, B, E, F on their radix-7 instances),
and the magnitude chain's ``pghi_gl`` (J on its radix-7 instance), the
STFT(896, 224) Polar and DGT(896, 224) PolarIF chains' fit and forward: G,
H and G, H full-K on their radix-7 instances (timed in turns with the
factored and product routes 896 took before); the STFT(1408, 352) Polar
and DGT(1408, 352) PolarIF chains: G, H factored and G, H full-K on the
product route; the
STFT(1408, 352) log-mel and DGT(1408, 352) magnitude chains: A, B factored
and E, F on the product route, the latter's ``pghi`` and ``pghi_gl``
inverts K's synthesis and J on the product route, 1408 = 2^7 11).  Phase
6 runs the floor sweep of A's factored design
(``acids_transforms_tpu_torch.tools.sweep_kernel_floor``: kernel T, A cut
after each of its stages) at the main path's shape, prints each stage's
increment beside its own floor, and holds every stage against its plain
version; at 1408/352, where A keeps the factored front end, ``s7_full`` is
bit-identical to A and, ``_prepare_rows`` included, within 10 % of its
time (both the card's time a call, the calls queued behind a sleep kernel,
timed in turns).  Phase 3 also holds the
RT-PGHI recurrence (producer warps planning each stage of frames from the
magnitudes, chain warps walking them) against its plain version
at 33 to 4096 bins, fresh and seeded.  It shows by
the launch counters that each path went through its kernels, times them, and
prints

* a line with one JSON object ``{"kernels": [...]}`` (per kernel: launches on
  the main path, max error against the plain version, its time (``ms``, also
  as ``kernel_ms``: the card's time a call, in runs of calls back to back),
  the plain version's and the library call's alike, the least time the card could take
  for the function (``bound_ms``: bytes moved once, or the operations an FFT
  formulation needs), and apart from the bound the fp32
  ceiling of the kernel's own design (the product's multiply-adds, or the
  FFT route's operations, at 67 TFLOP/s); ``front_end`` "fft", "smooth",
  "product" or "factored" on the rows of A, B, H, R, the magnitude encode,
  C, D, E, F, I, J, L, M, K's synthesis, G and H full-K, P, S and O's
  synthesis, one row a route; A also through its registered operator, row
  ``fused_melspec_op``, timed in turns with the direct launch),
* the card's name and power limit as ``nvidia-smi`` gives them,
* and as the last line ``{"ok": true, "device": {...}}``.

Any failed phase raises: the exit code is then not 0 and no result is printed.
Without a CUDA device the script fails at once; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import torch

N_FFT, HOP, SR = 1024, 256, 44100
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, data sheet
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores, data sheet
# the least latency of one step of the RT-PGHI chain, a model: a shared-memory
# load (about 30 cycles), two dependent float adds (4 each), a named barrier
# of the chain's warps (about 20)
RT_STEP_CYCLES = 58
# the same for K's walk: a shared-memory load, one float add, a block barrier
K_STEP_CYCLES = 54
# even 5-smooth framings of the log-mel / magnitude kernels' smooth route (A,
# B, E, F): 2^8 3 at overlap 3 and 4, 2^7 5, 2^7 3, 2^9 3, 2^7 3 5, 2^10 3
SMOOTH_SHAPES = ((768, 256), (768, 192), (640, 160), (384, 96), (1536, 384), (1920, 480), (3072, 768))
# even 7-smooth framings with a factor 7 of the log-mel / magnitude kernels'
# radix-7 instance (A, B, E, F): 2^7 7 at overlap 4, 7 and 2, 2^6 3 7 at
# overlap 3 and 7, 2^5 7^2 (radices 7 7) at overlap 7, 2^5 5 7, 2^5 3 7
MELSPEC_SEVEN_SHAPES = ((896, 224), (896, 128), (896, 448), (1344, 448), (1344, 192), (1568, 224), (1120, 160),
                        (672, 96))
# the session framings of the smooth route (R, L, M, the decodes, O's polish):
# 2^4 3 5^2, 2^6 3 5, 2^8 3, 2^4 5^2, 2^7 3 5 at overlap 4
SESSION_SMOOTH_SHAPES = ((1200, 300), (960, 240), (768, 192), (400, 100), (1920, 480))
# the framings phase 3 holds J's radix-7 instance at: 2^7 7 at overlap 4 and
# 7, 2^6 3 7 at overlap 7, 2^5 7^2 (radices 7 7) at overlap 7, 2^5 3 7 at
# overlap 7, 2^6 3^2 7 at overlap 2
J_SEVEN_SHAPES = ((896, 224), (896, 128), (1344, 192), (1568, 224), (672, 96), (4032, 2016))
# and K's synthesis's: 2^7 7 and 2^6 3 7 at overlap 4, 2^5 7^2 at overlap
# 7, 2^2 3^2 7^2 at overlap 7, 2^6 3^2 7 at overlap 4
K_SEVEN_SHAPES = ((896, 224), (1344, 336), (1568, 224), (1764, 252), (4032, 1008))
# the framings phase 3 holds G's and H's radix-7 instance at (full-K, no
# bank): 2^7 7 at overlap 4 and 7, 2^5 7^2 (radices 7 7) at overlap 7, 2^6 3
# 7 at overlap 7, 2^5 3 7 at overlap 7
REPR_SEVEN_SHAPES = ((896, 224), (896, 128), (1568, 224), (1344, 192), (672, 96))
# the framings of R's, L's and the decode's radix-7 instances whose plans
# phase 5 sweeps: 2^7 7, 2^6 3 7, 2^8 7, 2^4 3 5 7 at overlap 4
SEVEN_SHAPES = ((896, 224), (1344, 336), (1792, 448), (1680, 420))
# the kernels with a radix-7 instance (R, the magnitude encode, L, M, P, S,
# O's synthesis), by their launch counters' names
SEVEN_KERNELS = ("session_encode", "session_magnitude", "session_roundtrip", "session_random_roundtrip",
                 "session_random_decode", "session_complex_decode", "gl_project_synthesis", "gl_polish",
                 "gl_project_analysis")


def log(msg: str) -> None:
    print(msg, flush=True)


#: the smooth route's plan sweep: the framings it times E and F at
PLAN_SWEEP_SHAPES = ((768, 256), (768, 192), (640, 160), (1536, 384), (1920, 480))
#: and those of the radix-7 instances of E and F, J and K's synthesis (and
#: of G and H: the first)
SEVEN_PLAN_SWEEP_SHAPES = ((896, 224), (1568, 224))


def smooth_plan_sweep(mono: torch.Tensor, repeats: int) -> dict:
    """E and F (full-K, the DGT's gaussian window, log1p) on the smooth route
    at each of PLAN_SWEEP_SHAPES (and on its radix-7 instance at each of
    SEVEN_PLAN_SWEEP_SHAPES) under every plan the kernels take (frame
    tile 32, 16, 8 x 1, 2, 4 FFTs side by side, within the route's teams and
    shared memory), the card's time a call back to back (device_ms); E's
    output must be bit-identical under every plan (the frame pairs do not
    depend on it).  Returns per shape the rows, the rule's pick
    (spectral._kernel_plan) and the fastest plan of E + F."""
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff, spectral
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window

    rule = spectral._kernel_plan
    out = {}
    try:
        for n_fft, hop in PLAN_SWEEP_SHAPES + SEVEN_PLAN_SWEEP_SHAPES:
            w = gaussian_dgt_window(n_fft, device=mono.device)
            ov, F = n_fft // hop, n_fft // 2 + 1
            pick = rule(n_fft, hop, None)
            y_pick = spectral.fused_melspec(mono, n_fft, hop, None, 0.0, 1.0, "log1p", window=w)
            rows = []
            for tile_t in spectral.TILES:
                for teams in (1, 2, 4):
                    smem = spectral._fft_smem_bytes(tile_t, hop, ov, F, teams)
                    if teams > ff.fft_smooth_max_teams(n_fft) or smem > ff.MAX_SMEM:
                        continue
                    spectral._kernel_plan = lambda *a, p=(tile_t, teams): p
                    y = spectral.fused_melspec(mono, n_fft, hop, None, 0.0, 1.0, "log1p", window=w)
                    require(torch.equal(y, y_pick), f"E {n_fft}/{hop}: plan {(tile_t, teams)} changes the output")
                    e_ms = device_ms(lambda: spectral.fused_melspec(mono, n_fft, hop, None, 0.0, 1.0, "log1p",
                                                                    window=w), repeats)
                    f_ms = device_ms(lambda: spectral.fused_melspec_stats(mono, n_fft, hop, "log1p", window=w),
                                     repeats)
                    spectral._kernel_plan = rule
                    rows.append(dict(tile=tile_t, teams=teams, smem_kb=smem / 1024.0,
                                     blocks=min(2, ff.SM_SMEM // (smem + 1024)), e_ms=e_ms, f_ms=f_ms))
            best = min(rows, key=lambda r: r["e_ms"] + r["f_ms"])
            mine = next(r for r in rows if (r["tile"], r["teams"]) == pick)
            out[f"{n_fft}/{hop}"] = dict(rows=rows, pick=pick, best=(best["tile"], best["teams"]),
                                         over=(mine["e_ms"] + mine["f_ms"]) / (best["e_ms"] + best["f_ms"]) - 1.0)
            del y_pick
    finally:
        spectral._kernel_plan = rule
    return out


def seven_plan_sweep(sx: torch.Tensor, repeats: int) -> dict:
    """R, L / M and P / S on the smooth route's radix-7 instances at each of
    SEVEN_SHAPES under every plan the kernels take (R: 2 to 64 frames a
    block x 1, 2, 4 ... FFTs side by side; L / M and P / S: a multiple of 2
    overlap chunks up to 64 x as many FFTs; each up to the route's teams and
    within shared memory), on ``sx``'s sessions in chunks of 8 frames (P and
    S on as many frames of random magnitudes and angles), the card's time a
    call back to back (device_ms); every plan's output must be bit-identical
    to the rule's (a block's frame pairs are the session's).  Returns per
    shape the rows, the rule's picks and the fastest plans."""
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff, stream_step as ss

    rule_e, rule_r, rule_d = ss._encode_plan, ss._roundtrip_plan, ss._decode_plan
    out = {}
    try:
        for n_fft, hop in SEVEN_SHAPES:
            ov, Tn = n_fft // hop, -(-sx.shape[-1] // (8 * hop)) * 8
            chain = T.OverlapAdd(n_fft, hop) + T.RealtimeSTFT(n_fft=n_fft, hop_length=hop)
            e_ops = ss._encode_operands(chain[1].window, n_fft)
            r_ops = ss._Session(chain, 8).roundtrip_operands()
            ang = 2 * math.pi * torch.rand((sx.shape[0], Tn, n_fft // 2 + 1), device=sx.device,
                                           generator=torch.Generator(device=sx.device).manual_seed(n_fft))

            def enc():
                return ss._launch_encode(sx, e_ops, n_fft, hop, Tn)

            def rt_l():
                return ss._launch_roundtrip(sx, None, r_ops, n_fft, hop, Tn)

            def rt_m():
                return ss._launch_roundtrip(sx, ang, r_ops, n_fft, hop, Tn)
            mag = torch.rand(ang.shape, device=sx.device,
                             generator=torch.Generator(device=sx.device).manual_seed(hop))
            spec_ri = torch.view_as_real(torch.polar(mag, ang)).contiguous()
            d_ops = ss._decode_operands(chain[1].inv_window, float(chain[0].gain_compensation), n_fft, hop)

            def dec_p():
                return ss._launch_decode(mag, ang, d_ops, n_fft, hop)

            def dec_s():
                return ss._launch_decode(spec_ri, None, d_ops, n_fft, hop)
            pick_e, pick_r, pick_d = rule_e(n_fft, hop), rule_r(n_fft, hop), rule_d(n_fft, hop)
            ref_e, ref_l, ref_m, ref_p, ref_s = enc(), rt_l(), rt_m(), dec_p(), dec_s()
            e_rows, r_rows, d_rows, teams = [], [], [], 1
            while teams <= ff.fft_smooth_max_teams(n_fft):
                for rows in (2, 4, 8, 16, 32, 64):
                    smem = ss._encode_fft_smem_bytes(rows, hop, n_fft, teams)
                    if smem > ff.MAX_SMEM:
                        break
                    ss._encode_plan = lambda *a, p=(rows, teams): p
                    require(torch.equal(enc(), ref_e), f"R {n_fft}/{hop}: plan {(rows, teams)} changes the output")
                    e_rows.append(dict(rows=rows, teams=teams, smem_kb=smem / 1024.0,
                                       blocks=min(2, ff.SM_SMEM // (smem + 1024)), ms=device_ms(enc, repeats)))
                    ss._encode_plan = rule_e
                for rows in range(2 * ov, 65, 2 * ov):
                    smem = ss._roundtrip_fft_smem_bytes(rows, ov, hop, teams)
                    if smem > ff.MAX_SMEM:
                        break
                    ss._roundtrip_plan = lambda *a, p=(rows, teams): p
                    require(torch.equal(rt_l(), ref_l) and torch.equal(rt_m(), ref_m),
                            f"L / M {n_fft}/{hop}: plan {(rows, teams)} changes the output")
                    r_rows.append(dict(rows=rows, teams=teams, smem_kb=smem / 1024.0,
                                       blocks=min(2, ff.SM_SMEM // (smem + 1024)), l_ms=device_ms(rt_l, repeats),
                                       m_ms=device_ms(rt_m, repeats)))
                    ss._roundtrip_plan = rule_r
                for rows in range(2 * ov, 65, 2 * ov):
                    smem = ss._decode_fft_smem_bytes(rows, hop, n_fft, teams)
                    if smem > ff.MAX_SMEM:
                        break
                    ss._decode_plan = lambda *a, p=(rows, teams): p
                    require(torch.equal(dec_p(), ref_p) and torch.equal(dec_s(), ref_s),
                            f"P / S {n_fft}/{hop}: plan {(rows, teams)} changes the output")
                    d_rows.append(dict(rows=rows, teams=teams, smem_kb=smem / 1024.0,
                                       blocks=min(ss.DECODE_SEVEN_BLOCKS, ff.SM_SMEM // (smem + 1024)),
                                       p_ms=device_ms(dec_p, repeats), s_ms=device_ms(dec_s, repeats)))
                    ss._decode_plan = rule_d
                teams *= 2
            best_e = min(e_rows, key=lambda r: r["ms"])
            best_r = min(r_rows, key=lambda r: r["l_ms"] + r["m_ms"])
            best_d = min(d_rows, key=lambda r: r["p_ms"] + r["s_ms"])
            mine_e = next(r for r in e_rows if (r["rows"], r["teams"]) == pick_e)
            mine_r = next(r for r in r_rows if (r["rows"], r["teams"]) == pick_r)
            mine_d = next(r for r in d_rows if (r["rows"], r["teams"]) == pick_d)
            out[f"{n_fft}/{hop}"] = dict(
                encode=e_rows, roundtrip=r_rows, decode=d_rows, frames=Tn, pick_e=pick_e, pick_r=pick_r,
                pick_d=pick_d, best_e=(best_e["rows"], best_e["teams"]), best_r=(best_r["rows"], best_r["teams"]),
                best_d=(best_d["rows"], best_d["teams"]), over_e=mine_e["ms"] / best_e["ms"] - 1.0,
                over_r=(mine_r["l_ms"] + mine_r["m_ms"]) / (best_r["l_ms"] + best_r["m_ms"]) - 1.0,
                over_d=(mine_d["p_ms"] + mine_d["s_ms"]) / (best_d["p_ms"] + best_d["s_ms"]) - 1.0)
            del ref_e, ref_l, ref_m, ref_p, ref_s, mag, spec_ri
    finally:
        ss._encode_plan, ss._roundtrip_plan, ss._decode_plan = rule_e, rule_r, rule_d
    return out


def repr_plan_sweep(mono: torch.Tensor, repeats: int) -> dict:
    """G and H full-K (the DGT's gaussian window) on the smooth route at each
    of PLAN_SWEEP_SHAPES and on its radix-7 instance at 896/224 (the first
    of SEVEN_PLAN_SWEEP_SHAPES) under every plan the kernels take (frame
    tile 32, 16, 8, 4, 2 x 1, 2, 4, ... FFTs side by side, within the route's
    teams and shared memory), with the IF and a mel bank (G's; H has none) and
    with the angle and no bank, the card's time a call back to back
    (device_ms); G's output must be bit-identical under every plan (the
    frame pairs, the halo's included, do not depend on it).  Returns per
    (shape, configuration) the rows, the rule's pick (spectral._repr_plan
    of G, and of H) and the fastest plan of G + H."""
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff, spectral
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window

    rule = spectral._repr_plan
    out = {}
    try:
        for n_fft, hop in PLAN_SWEEP_SHAPES + SEVEN_PLAN_SWEEP_SHAPES[:1]:
            w = gaussian_dgt_window(n_fft, device=mono.device)
            ov, F = n_fft // hop, n_fft // 2 + 1
            bank = T.Magnitude(mode="bipolar", n_fft=n_fft).mel_bank
            for second, mel in (("if", True), ("phase", False)):
                kw = dict(mel_bank=bank if mel else None, weighted=second == "if", window=w)
                pick = (rule(n_fft, hop, None, False, second, mel), rule(n_fft, hop, None, True, second, False))
                y_pick = spectral.fused_spectral_repr(mono, n_fft, hop, second, **kw)
                rows = []
                for tile_t in spectral.FFT_TILES:
                    teams = 1
                    while teams <= ff.fft_smooth_max_teams(n_fft):
                        g_b = spectral._repr_fft_smem_bytes(tile_t, hop, ov, F, teams, False, second, mel)
                        h_b = spectral._repr_fft_smem_bytes(tile_t, hop, ov, F, teams, True, second, False)
                        row = dict(tile=tile_t, teams=teams, g_ms=None, h_ms=None, g_kb=g_b / 1024.0,
                                   h_kb=h_b / 1024.0)
                        spectral._repr_plan = lambda *a, p=(tile_t, teams): p
                        if g_b <= ff.MAX_SMEM:
                            y = spectral.fused_spectral_repr(mono, n_fft, hop, second, **kw)
                            require(torch.equal(y[0], y_pick[0]) and torch.equal(y[1], y_pick[1]),
                                    f"G {n_fft}/{hop} {second}: plan {(tile_t, teams)} changes the output")
                            row["g_ms"] = device_ms(
                                lambda: spectral.fused_spectral_repr(mono, n_fft, hop, second, **kw), repeats)
                        if h_b <= ff.MAX_SMEM:
                            row["h_ms"] = device_ms(lambda: spectral.fused_repr_stats(
                                mono, n_fft, hop, second, weighted=second == "if", window=w), repeats)
                        spectral._repr_plan = rule
                        if row["g_ms"] is not None or row["h_ms"] is not None:
                            rows.append(row)
                        teams *= 2
                res = {}
                for i, k in enumerate(("g_ms", "h_ms")):
                    timed = [r for r in rows if r[k] is not None]
                    best = min(timed, key=lambda r: r[k])
                    mine = next(r[k] for r in timed if (r["tile"], r["teams"]) == pick[i])
                    res[k[0]] = dict(pick=pick[i], best=(best["tile"], best["teams"]), over=mine / best[k] - 1.0)
                out[f"{n_fft}/{hop} {second}{' mel' if mel else ''}"] = dict(rows=rows, **res)
                del y_pick
    finally:
        spectral._repr_plan = rule
    return out


def gl_plan_sweep(mono: torch.Tensor, repeats: int) -> dict:
    """C (hann) and J (the DGT's gaussian) on the smooth route at each of
    PLAN_SWEEP_SHAPES, and J on its radix-7 instance at each of
    SEVEN_PLAN_SWEEP_SHAPES (C has none: the product route there), under
    every plan the kernels take (tile_t a multiple
    of 2 overlap up to 64 x 1, 2, 4, ... FFTs side by side, within the
    route's teams and shared memory), the card's time a call back to back
    (device_ms); the output must be bit-identical under every plan (the
    frame pairs do not depend on it).  Returns per kernel and shape the
    rows, the rule's pick (glstep._step_fft_plan, glstep._fullk_plan) and the
    fastest plan."""
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff, glstep
    from acids_transforms_tpu_torch.ops.fft import stft, taps_for_window
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window

    rule_c, rule_j = glstep._step_fft_plan, glstep._pick_fullk_fft_block
    mom, out = 0.99 / 1.99, {}
    try:
        for n_fft, hop in PLAN_SWEEP_SHAPES + SEVEN_PLAN_SWEEP_SHAPES:
            ov = n_fft // hop
            for kernel in ("C", "J") if (n_fft, hop) in PLAN_SWEEP_SHAPES else ("J",):
                if kernel == "C":
                    w = get_window("hann", n_fft, device=mono.device)
                    taps = taps_for_window(w)
                    pick = rule_c(n_fft, hop)

                    def make():
                        return glstep.make_gl_momentum_step(mag, n_fft, hop, taps, w, mom)[0]

                    def fits(tile, teams):
                        return glstep._fft_smem_bytes(tile, ov, hop, teams) <= ff.MAX_SMEM
                else:
                    w = gaussian_dgt_window(n_fft, device=mono.device)
                    pick = rule_j(n_fft, hop)[1:]

                    def make():
                        return glstep.make_gl_momentum_step_fullk(mag, n_fft, hop, w, mom)[0]

                    def fits(tile, teams):
                        return glstep._fullk_fft_smem_bytes(tile + ov, hop, n_fft, teams) <= ff.MAX_SMEM
                mag = stft(mono, n_fft, hop, w).abs()
                g = torch.Generator(device=mono.device).manual_seed(n_fft + hop)
                ph = 2 * math.pi * torch.rand(mag.shape, generator=g, device=mono.device)
                st = (torch.cos(ph), torch.sin(ph), torch.zeros_like(ph), torch.zeros_like(ph))
                del ph
                ref = make()(*st)
                rows = []
                for tile in range(2 * ov, 65, 2 * ov):
                    teams = 1
                    while teams <= ff.fft_smooth_max_teams(n_fft):
                        if fits(tile, teams):
                            if kernel == "C":
                                glstep._step_fft_plan = lambda *a, p=(tile, teams): p
                            else:
                                glstep._pick_fullk_fft_block = lambda *a, p=(tile + ov, tile, teams): p
                            step = make()
                            require(all(torch.equal(a, b) for a, b in zip(step(*st), ref)),
                                    f"{kernel} {n_fft}/{hop}: plan {(tile, teams)} changes the output")
                            rows.append(dict(tile=tile, teams=teams, ms=device_ms(lambda: step(*st), repeats)))
                            glstep._step_fft_plan, glstep._pick_fullk_fft_block = rule_c, rule_j
                        teams *= 2
                best = min(rows, key=lambda r: r["ms"])
                mine = next(r for r in rows if (r["tile"], r["teams"]) == tuple(pick))
                out[f"{kernel} {n_fft}/{hop}"] = dict(rows=rows, pick=tuple(pick), best=(best["tile"], best["teams"]),
                                                       over=mine["ms"] / best["ms"] - 1.0)
                del mag, st, ref
    finally:
        glstep._step_fft_plan, glstep._pick_fullk_fft_block = rule_c, rule_j
    return out


def k_synth_plan_sweep(mono: torch.Tensor, repeats: int) -> dict:
    """K's synthesis on the smooth route at each of PLAN_SWEEP_SHAPES, and
    on its radix-7 instance at each of SEVEN_PLAN_SWEEP_SHAPES (the DGT's
    gaussian window, random phases) under every plan the kernel takes
    (rows a multiple of 2 overlap up to max(64, 2 overlap) x 1, 2, 4, ...
    FFTs side by side, within the route's teams and shared memory), the
    card's time a call back to back; the output must be bit-identical under
    every plan (the frame pairs are the clip's).  Returns per shape the rows,
    the rule's pick (pghi_kernel._synth_fft_plan) and the fastest plan."""
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff, pghi_kernel as pk
    from acids_transforms_tpu_torch.ops.fft import stft
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window

    rule, out = pk._synth_fft_plan, {}
    try:
        for n_fft, hop in PLAN_SWEEP_SHAPES + SEVEN_PLAN_SWEEP_SHAPES:
            ov = n_fft // hop
            mag = stft(mono, n_fft, hop, gaussian_dgt_window(n_fft, device=mono.device)).abs()
            ph = 2 * math.pi * torch.rand(mag.shape, device=mono.device,
                                          generator=torch.Generator(device=mono.device).manual_seed(n_fft + hop))
            w = T.DGT(n_fft=n_fft, hop_length=hop, device=mono.device).inv_window
            pick = rule(n_fft, hop)
            ref = pk.pghi_synthesize_fused(mag, ph, n_fft, hop, w)
            rows = []
            for r in range(2 * ov, max(64, 2 * ov) + 1, 2 * ov):
                teams = 1
                while teams <= ff.fft_smooth_max_teams(n_fft):
                    if pk._synth_fft_smem_bytes(r, hop, n_fft, teams) <= ff.MAX_SMEM:
                        pk._synth_fft_plan = lambda *a, p=(r, teams): p
                        y = pk.pghi_synthesize_fused(mag, ph, n_fft, hop, w)
                        require(torch.equal(y, ref), f"K {n_fft}/{hop}: plan {(r, teams)} changes the output")
                        rows.append(dict(rows=r, teams=teams, ms=device_ms(
                            lambda: pk.pghi_synthesize_fused(mag, ph, n_fft, hop, w), repeats)))
                        pk._synth_fft_plan = rule
                    teams *= 2
            best = min(rows, key=lambda x: x["ms"])
            mine = next(x for x in rows if (x["rows"], x["teams"]) == tuple(pick))
            out[f"{n_fft}/{hop}"] = dict(rows=rows, pick=tuple(pick), best=(best["rows"], best["teams"]),
                                         over=mine["ms"] / best["ms"] - 1.0)
            del mag, ph, ref
    finally:
        pk._synth_fft_plan = rule
    return out


def polish_plan_sweep(sessions: int, repeats: int, dev) -> dict:
    """O's polish on the smooth route at each of SESSION_SMOOTH_SHAPES and
    at 1344/336 (its radix-7 instance): a
    grid of gl_context 3 + 8 + overlap - 1 frames of `sessions` sessions
    (random magnitudes, phases to 50 rad, the zero frames last), 16
    projections in one launch, under every (teams, resident) the kernel
    takes (teams 1, 2, 4, ... within the route's teams; the grid in shared
    memory where it fits, and in device memory), the card's time a call back
    to back; the output must be bit-identical under every plan.  Returns per
    shape the rows, the rule's pick (stream_step._polish_plan) and the
    fastest plan."""
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff, stream_step as ss

    rule, out = ss._polish_plan, {}
    try:
        for n_fft, hop in SESSION_SMOOTH_SHAPES + ((1344, 336),):
            ov, Fb = n_fft // hop, n_fft // 2 + 1
            rt = T.RealtimeSTFT(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl", device=dev)
            ctx, iters = rt.gl_context, rt.gl_iterations
            tp = ctx + 8 + ov - 1
            lo, hi = rt.gl_frozen(8)
            g = torch.Generator(device=dev).manual_seed(n_fft + hop + 7)
            gm = torch.rand((sessions, tp, Fb), generator=g, device=dev)
            gm[:, -(ov - 1):] = 0.0
            gp = (2 * torch.rand((sessions, tp, Fb), generator=g, device=dev) - 1) * 50.0
            syn = ss._decode_operands(rt.inv_window, float(ov), n_fft, hop)

            def run(p):
                return ss.gl_polish(gm, p, syn, rt.inv_window, rt.window, None, None, n_fft, hop, ctx, lo, hi,
                                    iters)
            pick = rule(n_fft, hop, tp)
            ref = run(gp.clone())
            rows = []
            teams = 1
            while teams <= ff.fft_smooth_max_teams(n_fft):
                for res in (True, False):
                    if ss._polish_smem_bytes(tp, hop, n_fft, teams, res) <= ff.MAX_SMEM:
                        ss._polish_plan = lambda *a, p=(teams, res): p
                        require(torch.equal(run(gp.clone()), ref),
                                f"polish {n_fft}/{hop}: plan {(teams, res)} changes the output")
                        scratch = gp.clone()
                        rows.append(dict(teams=teams, resident=res, ms=device_ms(lambda: run(scratch), repeats)))
                        ss._polish_plan = rule
                teams *= 2
            best = min(rows, key=lambda x: x["ms"])
            mine = next(x for x in rows if (x["teams"], x["resident"]) == tuple(pick))
            out[f"{n_fft}/{hop}"] = dict(rows=rows, pick=tuple(pick), best=(best["teams"], best["resident"]),
                                         over=mine["ms"] / best["ms"] - 1.0, tp=tp)
    finally:
        ss._polish_plan = rule
    return out


def k_polish_route_turns(mono: torch.Tensor, sessions: int, repeats: int, dev) -> dict:
    """K's synthesis at 768/256 and 1200/300 (the DGT's windows, random
    phases) on the product instance, the route those shapes took before the
    smooth one (pghi_kernel.synth_route forced to "product"), and on the
    smooth instance; O's polish at 1200/300 (`sessions` sessions, 3 + 8 + 3
    frames, 16 projections) as 16 two-launch projections
    (stream_step._polish_plan forced to None) and as one smooth launch; in
    turns old, new, new, old, each the card's time a call back to back.
    Returns per kernel and shape the two routes' times."""
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as pk, stream_step as ss
    from acids_transforms_tpu_torch.ops.fft import stft
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window

    rule_k, rule_p, out = pk.synth_route, ss._polish_plan, {}
    g = torch.Generator(device=dev).manual_seed(24)
    try:
        for n, hop in ((768, 256), (1200, 300)):
            mag = stft(mono, n, hop, gaussian_dgt_window(n, device=dev)).abs()
            ph = 2 * math.pi * torch.rand(mag.shape, generator=g, device=dev)
            w = T.DGT(n_fft=n, hop_length=hop, device=dev).inv_window
            t = {"product": [], "smooth": []}
            for turn in ("product", "smooth", "smooth", "product"):
                pk.synth_route = (lambda *a: "product") if turn == "product" else rule_k
                t[turn].append(device_ms(lambda: pk.pghi_synthesize_fused(mag, ph, n, hop, w), repeats))
                pk.synth_route = rule_k
            out[f"K {n}/{hop}"] = t
            del mag, ph
        n, hop = 1200, 300
        rt = T.RealtimeSTFT(n_fft=n, hop_length=hop, inversion_mode="pghi_gl", device=dev)
        ov, Fb = n // hop, n // 2 + 1
        tp = rt.gl_context + 8 + ov - 1
        gm = torch.rand((sessions, tp, Fb), generator=g, device=dev)
        gm[:, -(ov - 1):] = 0.0
        gp = 2 * math.pi * torch.rand((sessions, tp, Fb), generator=g, device=dev)
        lo, hi = rt.gl_frozen(8)
        syn = ss._decode_operands(rt.inv_window, float(ov), n, hop)
        wc, ws = ss._ana_basis(rt.window, n, ss._k_analysis(n))
        t = {"two-launch": [], "polish": []}
        for turn in ("two-launch", "polish", "polish", "two-launch"):
            ss._polish_plan = (lambda *a: None) if turn == "two-launch" else rule_p
            t[turn].append(device_ms(lambda: ss.gl_polish(gm, gp.clone(), syn, rt.inv_window, rt.window, wc, ws, n,
                                                          hop, rt.gl_context, lo, hi, rt.gl_iterations), repeats))
            ss._polish_plan = rule_p
        out[f"O {n}/{hop}"] = t
    finally:
        pk.synth_route, ss._polish_plan = rule_k, rule_p
    return out


def gl_route_turns(mono: torch.Tensor, repeats: int) -> dict:
    """C, D (chain 4) and I at 768/192 (hann) and J at 768/256 (the DGT's
    gaussian) on the product instance, the route these shapes took before
    the smooth one (glstep.gl_step_route / _fullk_plan forced to
    "product"), and on the smooth instance, in turns product, smooth,
    smooth, product, the card's time a call back to back (device_ms).
    Returns per (route, kernel) the two turns' times."""
    from acids_transforms_tpu_torch.ops.cuda import glstep
    from acids_transforms_tpu_torch.ops.fft import stft, taps_for_window
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window

    dev, mom = mono.device, 0.99 / 1.99
    rule_c, rule_j = glstep.gl_step_route, glstep._fullk_plan
    w = get_window("hann", 768, device=dev)
    taps = taps_for_window(w)
    wg = gaussian_dgt_window(768, device=dev)
    mag, magj = stft(mono, 768, 192, w).abs(), stft(mono, 768, 256, wg).abs()
    g = torch.Generator(device=dev).manual_seed(768)
    st, stj = [tuple(f(ph) for f in (torch.cos, torch.sin, torch.zeros_like, torch.zeros_like))
               for ph in (2 * math.pi * torch.rand(m.shape, generator=g, device=dev) for m in (mag, magj))]
    out = {}
    try:
        for product in (True, False, False, True):
            if product:
                glstep.gl_step_route = lambda n_fft, hop: "product"
                glstep._fullk_plan = lambda n_fft, hop: ("product",) + glstep._pick_fullk_block(n_fft, hop)
            s1 = glstep.make_gl_momentum_step(mag, 768, 192, taps, w, mom)[0]
            s4 = glstep.make_gl_momentum_step(mag, 768, 192, taps, w, mom, iters=4)[0]
            sj = glstep.make_gl_momentum_step_fullk(magj, 768, 256, wg, mom)[0]
            route = "product" if product else "smooth"
            for key, fn in (("C", lambda: s1(*st)), ("D", lambda: s4(*st)),
                            ("I", lambda: glstep.gl_project(mag, st[0], st[1], 768, 192, taps, w)),
                            ("J", lambda: sj(*stj))):
                out.setdefault((route, key), []).append(device_ms(fn, repeats))
            glstep.gl_step_route, glstep._fullk_plan = rule_c, rule_j
    finally:
        glstep.gl_step_route, glstep._fullk_plan = rule_c, rule_j
    return out


def melspec_smooth_instance(res: dict, seven: bool = False):
    """The resources of the two smooth instances phase 5 times (float32
    rows, float32 out): the forward's and the statistics'; ``seven``: the
    radix-7 instances'."""
    front = "Li4E" if seven else "Li3E"
    sm = melspec_smooth_resources(res, seven)
    fwd = next(v for k, v in sm.items() if "melspec_forward_kernelILb0ELb0E" + front + "E" in k)
    stats = next(v for k, v in sm.items() if "melspec_stats_kernelILb0E" + front + "E" in k)
    return fwd, stats


def melspec_smooth_resources(res: dict, seven: bool = False) -> dict:
    """The build log's resources (``_build.kernel_resources()``) of the
    melspec kernels' smooth instances: template argument kFront =
    kFrontSmooth = 3, ``Li3E`` in the mangled name; ``seven``: the radix-7
    instances, kFrontSmooth7 = 4, ``Li4E``."""
    front = "Li4E" if seven else "Li3E"
    return {k: v for k, v in res.items()
            if ("melspec_forward_kernel" in k or "melspec_stats_kernel" in k) and front in k}


def repr_smooth_resources(res: dict) -> dict:
    """The build log's resources of G's and H's smooth instances
    (``repr_forward_kernel`` / ``repr_stats_kernel<kInt16, kFrontSmooth>``,
    ``Li3E`` in the mangled name) and of their radix-7 instances
    (``<kInt16, kFrontSmooth7>``, ``Li4E``), by the labels ``G``, ``H``
    (float32 rows), ``G int16``, ``H int16`` and ``G seven``, ``H seven``,
    ``G seven int16``, ``H seven int16``."""
    out = {}
    for k, v in res.items():
        for kern, label in (("repr_forward_kernel", "G"), ("repr_stats_kernel", "H")):
            for front, seven in (("Li3E", ""), ("Li4E", " seven")):
                if kern in k and front in k:
                    out[label + seven + (" int16" if "ILb1E" + front in k else "")] = v
    return out


def gl_smooth_resources(res: dict) -> dict:
    """The build log's resources of the Griffin-Lim steps' 5-smooth
    instances (template argument kSmooth = true): ``gl_step_fft_kernel<true>``
    (C, D, I; ``ILb1EE`` in the mangled name) and ``gl_fullk_fft_kernel<true,
    false>`` (J; ``ILb1ELb0EE``)."""
    return {k: v for k, v in res.items()
            if "gl_step_fft_kernelILb1EE" in k or "gl_fullk_fft_kernelILb1ELb0EE" in k}


def gl_k_seven_resources(res: dict) -> dict:
    """The build log's resources of J's and K's synthesis's radix-7
    instances (``gl_fullk_fft_kernel<true, true>``,
    ``pghi_synthesize_fft_kernel<true, true>``: ``ILb1ELb1EE``), by the
    labels ``J`` and ``K``."""
    out = {}
    for k, v in res.items():
        if "gl_fullk_fft_kernelILb1ELb1EE" in k:
            out["J"] = v
        elif "pghi_synthesize_fft_kernelILb1ELb1EE" in k:
            out["K"] = v
    return out


def seven_blocks(regs: int) -> int:
    """Blocks of 256 threads an SM holds at ``regs`` registers a thread (the
    registers allocated 8 a thread at a time, 65536 an SM)."""
    return 65536 // (256 * 8 * -(-regs // 8))


def k_polish_smooth_resources(res: dict) -> dict:
    """The build log's resources of K's synthesis's and O's polish's smooth
    instances: ``pghi_synthesize_fft_kernel<true, false>`` (``ILb1ELb0EE``)
    and ``gl_polish_fft_kernel<kResident, true, false>`` (``ILb0ELb1ELb0EE``,
    ``ILb1ELb1ELb0EE``), by the labels ``K``, ``O resident``, ``O device``."""
    out = {}
    for k, v in res.items():
        if "pghi_synthesize_fft_kernelILb1ELb0EE" in k:
            out["K"] = v
        elif "gl_polish_fft_kernelILb1ELb1ELb0EE" in k:
            out["O resident"] = v
        elif "gl_polish_fft_kernelILb0ELb1ELb0EE" in k:
            out["O device"] = v
    return out


def o_route_resources(res: dict) -> dict:
    """The build log's resources of O's polish's radix-7 instances
    (``gl_polish_fft_kernel<kResident, true, true>``: ``ILb1ELb1ELb1EE``,
    ``ILb0ELb1ELb1EE``) and of O's analysis on the FFT and smooth routes
    (``gl_project_analysis_fft_kernel<kSmooth, kSeven>``: ``ILb0ELb0EE``,
    ``ILb1ELb0EE``, ``ILb1ELb1EE``), by the labels ``O seven resident``, ``O
    seven device``, ``Oana fft``, ``Oana smooth``, ``Oana seven``."""
    out = {}
    for k, v in res.items():
        for kern, label in (("gl_polish_fft_kernelILb1ELb1ELb1EE", "O seven resident"),
                            ("gl_polish_fft_kernelILb0ELb1ELb1EE", "O seven device"),
                            ("gl_project_analysis_fft_kernelILb0ELb0EE", "Oana fft"),
                            ("gl_project_analysis_fft_kernelILb1ELb0EE", "Oana smooth"),
                            ("gl_project_analysis_fft_kernelILb1ELb1EE", "Oana seven")):
            if kern in k:
                out[label] = v
    return out


def session_seven_resources(res: dict) -> dict:
    """The build log's resources of R's, the magnitude encode's, L's, M's, P's
    and S's radix-7 instances (``session_encode_kernel<kMag, true, true,
    true>``, ``session_roundtrip_fft_kernel<kRandom, true, true>``,
    ``session_decode_fft_kernel<kComplex, true, true>``: P's is O's
    synthesis too), by the labels ``R``, ``N``, ``L``, ``M``, ``P``, ``S``."""
    out = {}
    for k, v in res.items():
        for kern, label in (("session_encode_kernelILb0ELb1ELb1ELb1EE", "R"),
                            ("session_encode_kernelILb1ELb1ELb1ELb1EE", "N"),
                            ("session_roundtrip_fft_kernelILb0ELb1ELb1EE", "L"),
                            ("session_roundtrip_fft_kernelILb1ELb1ELb1EE", "M"),
                            ("session_decode_fft_kernelILb0ELb1ELb1EE", "P"),
                            ("session_decode_fft_kernelILb1ELb1ELb1EE", "S")):
            if kern in k:
                out[label] = v
    return out


def smooth_instance_resources(res: dict) -> dict:
    """The build log's resources of every mixed-radix instance of every
    kernel, by its mangled name: the sessions' (encode, roundtrip, decode,
    polish, O's analysis; their kSmooth argument true), E's and F's (the radix-7 ones
    too), G's and H's (the radix-7 ones too), the Griffin-Lim steps' and K's
    synthesis's (J's and K's radix-7 ones too)."""
    out = dict(melspec_smooth_resources(res))
    out.update(melspec_smooth_resources(res, seven=True))
    out.update({k: v for k, v in res.items() if ("repr_forward_kernel" in k or "repr_stats_kernel" in k)
                and ("Li3E" in k or "Li4E" in k)})
    out.update(gl_smooth_resources(res))
    for k, v in res.items():
        if ("pghi_synthesize_fft_kernelILb1E" in k or "gl_fullk_fft_kernelILb1ELb1EE" in k
                or "gl_polish_fft_kernelIL" in k and ("ELb1ELb0EE" in k or "ELb1ELb1EE" in k)
                or "gl_project_analysis_fft_kernelILb1E" in k
                or "session_decode_fft_kernelIL" in k and ("ELb1ELb0EE" in k or "ELb1ELb1EE" in k)
                or "session_encode_kernelILb" in k and ("ELb1ELb1ELb0EE" in k or "ELb1ELb1ELb1EE" in k)
                or "session_roundtrip_fft_kernelIL" in k and ("ELb1ELb0EE" in k or "ELb1ELb1EE" in k)):
            out[k] = v
    return out


class analysis_on_product:
    """Within it, O's two-launch analysis takes its product route at every
    n_fft (``stream_step.session_route`` answers "product" for the kind
    ``"project"``) and, with ``polish=False``, the polish refuses every grid
    (``stream_step._polish_plan`` answers None): the route O took before its
    analysis had FFT routes and its polish a radix-7 instance, for timing in
    turns.  ``on=False`` changes nothing."""

    def __init__(self, ss, on: bool = True, polish: bool = True):
        self.ss, self.on, self.polish = ss, on, polish

    def __enter__(self):
        ss = self.ss
        self.saved = ss.session_route, ss._polish_plan
        if self.on:
            route = self.saved[0]
            ss.session_route = lambda n, kind, hop=None: "product" if kind == "project" else route(n, kind, hop)
            if not self.polish:
                ss._polish_plan = lambda *a: None
        return self

    def __exit__(self, *exc):
        self.ss.session_route, self.ss._polish_plan = self.saved
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit("FAILED: " + what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max-abs of the difference over max-abs of the reference ``b``."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def time_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Median over ``repeats`` of one call timed alone: CUDA events around
    it, the card idle before and after, so the host's time to enqueue the
    call shows wherever it is longer than the card's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, calls: int, warmup: int = 2, runs: int = 3) -> float:
    """The card's time of one call of ``fn``: CUDA events around ``calls``
    calls back to back, over the count, median of ``runs`` such runs after
    ``warmup`` calls.  Back to back the host enqueues a call while the card
    runs the one before, so the host's time shows only where it is the longer;
    a call that synchronises shows all of it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def host_and_device_ms(fn, n: int):
    """Per call of ``fn`` (``n`` calls back to back): the host's time to
    enqueue it, and the card's time to run it with the calls queued behind a
    sleep kernel, so that the card never waits for the host (None where the
    host took longer than the sleep)."""
    fn()
    torch.cuda.synchronize()
    e_s, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e_s.record()
    torch.cuda._sleep(400_000_000)      # about 0.2 s at the card's clock
    e0.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = 1e3 * (time.perf_counter() - t0)
    e1.record()
    torch.cuda.synchronize()
    return host / n, (e0.elapsed_time(e1) / n if host < e_s.elapsed_time(e0) else None)


def path_split(att, chain, x, runs: int = 5) -> dict:
    """fit + forward of a chain through the entry points, host clock, median
    over ``runs``: the wall time to the card's end (``wall``) and the host's
    time to return from ``fuse_fit`` (``fit``), from building the fused
    forward (``build``) and from calling it (``forward``), nothing
    synchronised in between (the kernels run behind the host).  Where
    ``fit + build + forward`` nears ``wall``, the host holds the path."""
    rows = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted = att.fuse_fit(chain)(x)
        t1 = time.perf_counter()
        fwd = att.fuse_forward(fitted)
        t2 = time.perf_counter()
        fwd(x)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        rows.append((t4 - t0, t1 - t0, t2 - t1, t3 - t2))
    return {k: 1e3 * statistics.median(r[i] for r in rows) for i, k in enumerate(("wall", "fit", "build", "forward"))}


def max_sm_clock_mhz() -> float:
    """The card's largest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0].strip())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def make_audio(batch: int, length: int, gen: torch.Generator, channels: int = 2) -> torch.Tensor:
    """Seeded synthetic corpus made on the device: per clip a few harmonics
    with random pitch and decay plus a noise floor, peak about 0.5."""
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


def check_gl(name, mag, n_fft, hop, taps, window, mom, seed, tol, results, chain=4):
    """Kernels C and D against the plain version, a float64 oracle and each
    other, on the route (n_fft, hop) picks (glstep.gl_step_route): the FFT
    route (a power of two from 64 to 4096) and the smooth route (even
    5-smooth n_fft) also against their plain version on every frame within
    1e-6 (it repeats the kernel's float32 operations in order: measured
    bit-identical)."""
    from acids_transforms_tpu_torch.ops.cuda import glstep

    dev = mag.device
    route = glstep.gl_step_route(n_fft, hop)
    glstep.reset_launches()
    g = torch.Generator(device=dev).manual_seed(seed)
    ph = 2 * math.pi * torch.rand(mag.shape, generator=g, device=dev)
    are, aim = torch.cos(ph), torch.sin(ph)
    tre = 0.1 * mag * torch.randn(mag.shape, generator=g, device=dev)
    tim = 0.1 * mag * torch.randn(mag.shape, generator=g, device=dev)
    env = glstep._env_rows(mag.shape[1], n_fft, hop, window)
    step1, to_rows, _ = glstep.make_gl_momentum_step(mag, n_fft, hop, taps, window, mom)
    step4, _, _ = glstep.make_gl_momentum_step(mag, n_fft, hop, taps, window, mom, iters=chain)
    state = tuple(to_rows(a) for a in (are, aim, tre, tim))

    def plain(st, iters):
        return glstep.gl_momentum_step_reference(mag, *st, env, n_fft, hop, taps, mom, iters)

    m = n_fft // hop - 1
    n_t = mag.shape[1]

    def inner(a, k=1):
        return a[:, k * m: n_t - k * m]

    def edges(a, k=1):
        return torch.cat([a[:, : k * m], a[:, n_t - k * m:]], dim=1)

    def against_oracle(kernel_out, plain_out, st, iters):
        """Projection error of the kernel and of the plain version against the
        float64 FFT oracle, on interior and edge frames, over the oracle's
        largest value.  The oracle runs 16 clips at a time (float64 frames of
        the whole batch would not fit beside the rest)."""
        worst = {("kernel", "interior"): 0.0, ("kernel", "edge"): 0.0,
                 ("plain", "interior"): 0.0, ("plain", "edge"): 0.0}
        squares = {"kernel": 0.0, "plain": 0.0}   # of the edge frames' differences
        scale = 0.0
        for b0 in range(0, mag.shape[0], 16):
            sl = slice(b0, b0 + 16)
            orc = glstep.gl_momentum_step_oracle(
                mag[sl], *[a[sl] for a in st], env, n_fft, hop, taps, mom, iters)
            scale = max(scale, orc[2].abs().max().item(), orc[3].abs().max().item())
            for who, out in (("kernel", kernel_out), ("plain", plain_out)):
                for part, pick in (("interior", inner), ("edge", edges)):
                    d = [pick(out[i][sl].double(), iters) - pick(orc[i], iters) for i in (2, 3)]
                    worst[(who, part)] = max(worst[(who, part)], *(x.abs().max().item() for x in d))
                    if part == "edge":
                        squares[who] += sum((x * x).sum().item() for x in d)
        err = {k: v / scale for k, v in worst.items()}
        err["edge rms ratio"] = math.sqrt(squares["kernel"] / max(squares["plain"], 1e-300))
        return err

    oracle_errs = {}

    def compare(kernel_out, plain_out, st, label, iters=1, tol=tol):
        # Interior frames: fp32 sums in another order than cuBLAS, 1e-4 leaves
        # two decades.  The first and last iters * (overlap - 1) frames hold
        # the signal's first and last samples, where this formulation cancels
        # (the window is applied in the spectral domain, so a sample under
        # window value w is a sum that cancels to w times its terms, divided
        # by the envelope w^2) and rounding is amplified by 1 / w.  How far
        # that goes is measured, not assumed: the plain version's own error
        # against the float64 oracle on those frames.  The kernel must be
        # within 1e-4 of the oracle there (hamming, w >= 0.08, holds the edge
        # frames to that outright), or, where the plain version is further
        # off (hann and blackman reach w ~ 1e-5), no worse than it by more
        # than chance: the root mean square over the edge frames within 4
        # times the plain version's, the largest value within 10 times (one
        # sample per clip end, the one under the smallest window value,
        # carries the maximum, so with a few clips the two maxima are a
        # handful of independent draws each).
        err = against_oracle(kernel_out, plain_out, st, iters)
        oracle_errs[label] = err
        edge_tol = max(tol, 10.0 * err[("plain", "edge")])
        log(f"  {name} {label} vs float64 oracle: interior kernel {err[('kernel', 'interior')]:.3e} "
            f"plain {err[('plain', 'interior')]:.3e} (tol {tol:g}); edge kernel "
            f"{err[('kernel', 'edge')]:.3e} plain {err[('plain', 'edge')]:.3e} (tol {edge_tol:.3g}), "
            f"rms kernel / plain {err['edge rms ratio']:.2f} (tol 4)")
        require(err[("kernel", "interior")] <= tol, f"{name} {label}: interior frames off the oracle")
        # (a chain's edge frames carry several iterations of that amplified
        # rounding in both versions: they are held through D == k x C instead)
        require(iters > 1 or err[("kernel", "edge")] <= tol
                or (err[("kernel", "edge")] <= edge_tol and err["edge rms ratio"] <= 4.0),
                f"{name} {label}: edge frames off the oracle")
        require(all(torch.isfinite(o).all().item() for o in kernel_out), f"{name} {label}: non-finite")
        # kernel against plain, whole batch
        scale_r = max(plain_out[2].abs().max().item(), plain_out[3].abs().max().item())
        abs_r = max(abs_err(inner(kernel_out[i], iters), inner(plain_out[i], iters)) for i in (2, 3))
        log(f"  {name} {label} vs plain, interior frames: projection rel {abs_r / scale_r:.3e} (tol {tol:g})")
        require(abs_r / scale_r <= tol, f"{name} {label} disagrees with plain on interior frames")
        return abs_r

    def compare_angles(kernel_out, plain_out, prev, label):
        # The new angles are u / |u| with u = R - mom * tprev: an error d in R
        # turns the angle by d / |u|, without bound where u vanishes.  So (1)
        # weighted by |u| / max|u| the difference must stay within what R is
        # held to, on every frame; (2) unweighted, on interior frames where
        # |u| >= 1e-2 max|u| (d / |u| <= 100 d), within 1e-4 as well.
        u_re = plain_out[2] - mom * prev[2]
        u_im = plain_out[3] - mom * prev[3]
        w = torch.sqrt(u_re * u_re + u_im * u_im)
        w = w / w.max()
        big = inner(w) >= 1e-2
        for i in (0, 1):
            d = (kernel_out[i] - plain_out[i]).abs()
            e_w = (inner(d) * inner(w)).max().item()
            e_u = (inner(d) * big).max().item()
            e_edge = (edges(d) * edges(w)).max().item()
            log(f"  {name} {label} angles[{i}]: interior weighted {e_w:.3e}, unweighted where "
                f"|u| >= 1e-2 max ({100 * big.float().mean().item():.1f}% of bins) {e_u:.3e} "
                f"(tol {tol:g}); edge weighted {e_edge:.3e}")
            require(e_w <= tol and e_u <= tol, f"{name} {label}: angles disagree with plain")

    def exact(kernel_out, plain_out, prev, label):
        # the FFT and the smooth route: the projection on every frame within
        # 1e-6 of its largest value, the angles weighted by |u| / max|u|
        # within 1e-6
        if route == "product":
            return
        scale_r = max(plain_out[2].abs().max().item(), plain_out[3].abs().max().item())
        e_r = max(abs_err(kernel_out[i], plain_out[i]) for i in (2, 3)) / scale_r
        u = torch.sqrt((plain_out[2] - mom * prev[2]) ** 2 + (plain_out[3] - mom * prev[3]) ** 2)
        e_a = max(((kernel_out[i] - plain_out[i]).abs() * u / u.max()).max().item() for i in (0, 1))
        same = all(torch.equal(a, b) for a, b in zip(kernel_out, plain_out))
        log(f"  {name} {label} ({route} route, block {glstep._step_fft_plan(n_fft, hop)}): every frame vs plain "
            f"{e_r:.3e}, angles weighted by |u| {e_a:.3e} (tol 1e-06; bit-identical {same})")
        require(e_r <= 1e-6 and e_a <= 1e-6, f"{name} {label}: the {route} route differs from its plain version")

    # C: one invocation from a random state, and one from the state
    # chain - 1 iterations later (so every iteration of a chain is covered
    # one by one)
    k1 = step1(*state)
    p1 = plain(state, 1)
    err_c = compare(k1, p1, state, "C (1 iteration)")
    compare_angles(k1, p1, state, "C (1 iteration)")
    exact(k1, p1, state, "C (1 iteration)")
    if route == "smooth":
        # the smooth route's window is in the time domain, as the FFT
        # route's: every frame of one step within 1e-5 of the float64 oracle
        e_all = max(v for k, v in oracle_errs["C (1 iteration)"].items() if k[0] == "kernel")
        log(f"  {name} C (1 iteration, smooth route): every frame vs float64 oracle {e_all:.3e} (tol 1e-05)")
        require(e_all <= 1e-5, f"{name}: the smooth route's C is off the float64 oracle")
    st = k1
    for _ in range(chain - 2):
        st = step1(*st)
    k4_single = step1(*st)
    err_c = max(err_c, compare(k4_single, plain(st, 1), st, f"C (iteration {chain})"))
    # D: one invocation of `chain` chained iterations == `chain` invocations
    # of C.  Every output element runs the same sequence of fp32 operations
    # in both, so the tolerance 1e-5 only allows for nothing but that.
    k4 = step4(*state)
    torch.cuda.synchronize()
    err_chain = max(rel_err(a, b) for a, b in zip(k4, k4_single))
    log(f"  {name} D (chain of {chain}) vs {chain} x C: {err_chain:.3e} (tol 1e-05; bit-identical "
        f"{all(torch.equal(a, b) for a, b in zip(k4, k4_single))})")
    require(err_chain <= 1e-5, f"{name}: chain of {chain} differs from {chain} single steps")
    # D against the plain version and the oracle directly: chained iterations
    # of a chaotic map amplify the 1e-7 rounding differences
    # (tests/test_gl_parity.py measures 1e-7 -> 1.3e-4 in five iterations),
    # hence 1e-3 on the projection here; the per-iteration agreement above is
    # the sharp check.
    p4 = plain(state, chain)
    abs_d = compare(k4, p4, state, f"D (chain of {chain})", iters=chain, tol=1e-3)
    exact(k4, p4, st, f"D (chain of {chain})")
    got = {k: v for k, v in glstep.routes.items() if v}
    log(f"  {name}: C and D launches by route {got}")
    require(set(got) == {f"gl_momentum_step:{route}", f"gl_momentum_chain:{route}"},
            f"{name}: C and D must take the {route} route")
    key = {"fft": "", "smooth": "_smooth", "product": "_product"}[route]
    results["C" + key] = max(results.get("C" + key, 0.0), err_c)
    results["D" + key] = max(results.get("D" + key, 0.0), abs_d)
    return state, step1, step4, env


def if_to_radians(d: torch.Tensor, weighted: bool) -> torch.Tensor:
    """A difference of IF rows ``(B, T, F)`` (pre-affine units) as the
    difference of the phase steps it is made of: rows over pi carry half a
    step over pi, the last row half a step, row 0 the angle over pi; with the
    parabolic window divided back out (its zero last row is left out)."""
    T = d.shape[1]
    c = torch.full((T,), 2.0 * math.pi, dtype=torch.float64, device=d.device)
    c[0], c[-1] = math.pi, 2.0
    if weighted:
        n = torch.arange(T, dtype=torch.float64, device=d.device)
        g = 1.5 * T / (T * T - 1.0) * (1 - ((n - (T / 2 - 1)) / (T / 2)) ** 2)
        c = torch.where(g > 0, c / torch.where(g > 0, g, 1.0), 0.0)
    return d.double() * c[None, :, None]


def angle_error(second: str, a: torch.Tensor, b: torch.Tensor, scale: float, weighted: bool = False):
    """Channel-2 difference of two normalized outputs as an angle on the
    circle (radians): the phase itself, or the IF's phase steps."""
    d = (a.double() - b.double()) * scale
    if second == "if":
        d = if_to_radians(d, weighted)
    return torch.remainder(d + math.pi, 2 * math.pi).sub_(math.pi).abs_()


def magnitude_weights(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor, second: str):
    """|X| / max|X| per clip (for the IF: of the quieter frame of each step)."""
    from acids_transforms_tpu_torch.ops.fft import stft

    m = stft(x, n_fft, hop, window).abs()
    m = m / m.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30)
    if second == "if":
        m[:, 1:] = torch.minimum(m[:, 1:], m[:, :-1])
    return m


def check_channel2(label, second, y_k, y_p, scale, wt, weighted, tol_w, tol_loud):
    """Channel 2 of a representation against a reference: the angle error
    weighted by |X| / max|X| within tol_w, and unweighted at bins above 1e-3
    of the clip's largest magnitude within tol_loud (radians)."""
    if second == "imag":
        e = rel_err(y_k, y_p)
        log(f"    {label} ch2 (imag) rel {e:.3e} (tol {tol_w:g})")
        require(e <= tol_w, f"{label}: channel 2 disagrees")
        return e
    err = angle_error(second, y_k, y_p, scale, weighted)
    e_w = (err * wt).max().item()
    loud = wt > 1e-3
    e_l = err[loud].max().item()
    log(f"    {label} ch2 ({second}) angle error weighted by |X| {e_w:.3e} (tol {tol_w:g}); "
        f"at bins above 1e-3 of the largest ({100 * loud.float().mean().item():.1f}% of bins) "
        f"{e_l:.3e} rad (tol {tol_loud:g})")
    require(e_w <= tol_w and e_l <= tol_loud, f"{label}: channel 2 disagrees")
    return e_w


def unit_spec(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """``mag * (cos, sin)(phase)`` over the clip's largest magnitude: what the
    synthesis reads of a phase, on the scale of the audio's error."""
    ph = phase.double()
    z = torch.stack([mag.double() * torch.cos(ph), mag.double() * torch.sin(ph)])
    return z / mag.double().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30)


def check_pghi(name, mag, n_fft, hop, window, gamma, seed, results, n64=4):
    """Kernel K's entry points against their plain versions, the recurrence
    against its float64 run, and the recurrence's two launches apart.

    The plan (``pghi_plan``) against its plain version: every bin's source
    the same (the anchors and the distances come from float32 comparisons of
    the same magnitudes), ``off`` within 1e-6 of its largest value plus 1e-5
    rad (measured bit-identical where the card's logf is torch's).  The walk
    on the kernel's plan against the plain walk on the same plan:
    bit-identical (a gather and one float32 addition a bin, in the same
    order).

    Phases are unwrapped float32 sums (1e5 rad and more late in a long clip,
    one ulp 0.01 to 0.06 rad there), so they are compared on what is used of
    them, ``mag * (cos, sin)(phase)`` over the clip's largest magnitude, and
    on the audio.  The plain version adds in the kernel's order, so the two
    should agree far better than either agrees with exact arithmetic.  How far
    float32 is from exact is measured, not assumed: the plain version's
    distance to the same recurrence in float64 (same masks, same order) on the
    first ``n64`` clips.  The kernel must agree with the plain version within
    1e-4, or, where float32 itself is further off, within that measured
    distance (one logarithm that differs in its last bit between the card's
    logf and PyTorch's moves the rounding of a sum by an ulp of the phase at
    that point, and the difference then rides along the chain); and it may be
    no further from the float64 run than 1.5 times the plain version plus
    1e-4."""
    from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as pk

    dev = mag.device
    g = torch.Generator(device=dev).manual_seed(seed)
    angles = 2 * math.pi * torch.rand(mag.shape, generator=g, device=dev)
    kw = dict(tolerance=1e-2, angles=angles)
    sub = slice(0, min(n64, mag.shape[0]))
    kw64 = dict(tolerance=1e-2, angles=angles[sub])
    F = mag.shape[-1]
    for label, kern, plain in (("phases", pk.pghi_phases_fused, pk.pghi_phases_fused_reference),
                               ("bidir phases", pk.pghi_phases_bidir, pk.pghi_phases_bidir_reference)):
        bidir = label != "phases"
        src_k, off_k = pk.pghi_plan(mag, gamma, n_fft, hop, 1e-2, bidir, angles=angles)
        src_p, off_p = pk.pghi_plan_reference(mag, gamma, n_fft, hop, 1e-2, bidir, angles=angles)
        walk_k = pk.pghi_walk(src_k, off_k, F, bidir)
        walk_p = pk.pghi_walk_reference(src_k, off_k, F, bidir)
        torch.cuda.synchronize()
        e_off = (off_k - off_p).abs().max().item()
        tol_off = 1e-6 * off_p.abs().max().item() + 1e-5
        log(f"  K {name} {label} plan {pk._phases_plan(F, mag.shape[1])}: sources equal "
            f"{torch.equal(src_k, src_p)}, off vs plain {e_off:.3g} (tol {tol_off:.3g}; bit-identical "
            f"{torch.equal(off_k, off_p)}, {100 * (off_k != off_p).float().mean().item():.4f}% of bins differ); "
            f"the walk on it bit-identical {torch.equal(walk_k, walk_p)}")
        require(torch.equal(src_k, src_p) and e_off <= tol_off, f"K {name} {label}: the plan disagrees with plain")
        require(torch.equal(walk_k, walk_p), f"K {name} {label}: the walk is not its plain version bit for bit")
        results["K_plan"] = max(results.get("K_plan", 0.0), e_off)
        results["K_walk"] = max(results.get("K_walk", 0.0), (walk_k - walk_p).abs().max().item())
        del src_k, off_k, src_p, off_p, walk_k, walk_p
        ph_k = kern(mag, gamma, n_fft, hop, **kw)
        ph_p = plain(mag, gamma, n_fft, hop, **kw)
        ph_64 = plain(mag[sub], gamma, n_fft, hop, dtype=torch.float64, **kw64)
        torch.cuda.synchronize()
        require(torch.isfinite(ph_k).all().item() and ph_k.shape == mag.shape, f"K {name} {label}: bad output")
        e_kp = (unit_spec(mag, ph_k) - unit_spec(mag, ph_p)).abs().max().item()
        z64 = unit_spec(mag[sub], ph_64)
        e_p64 = (unit_spec(mag[sub], ph_p[sub]) - z64).abs().max().item()
        e_k64 = (unit_spec(mag[sub], ph_k[sub]) - z64).abs().max().item()
        differ = (ph_k != ph_p).float().mean().item()
        tol = max(1e-4, e_p64)
        log(f"  K {name} {label}: kernel vs plain {e_kp:.3e} (tol {tol:.3g}; phases differ in "
            f"{100 * differ:.4f}% of bins, by at most {(ph_k - ph_p).abs().max().item():.3g} rad of "
            f"{ph_p.abs().max().item():.3g}); vs the float64 recurrence: plain {e_p64:.3e}, kernel {e_k64:.3e}")
        require(e_kp <= tol, f"K {name} {label}: kernel disagrees with plain")
        require(e_k64 <= 1.5 * e_p64 + 1e-4, f"K {name} {label}: kernel further from float64 than plain")
        key = "K_bidir" if bidir else "K_phases"
        results[key] = max(results.get(key, 0.0), e_kp)
        results.setdefault("K_f64", {})[f"{name} {label}"] = (
            e_p64, e_k64, (ph_p[sub].double() - ph_64).abs().max().item(), ph_64.abs().max().item())
        # synthesis of the kernel's own phases: kernel vs plain.  The FFT and
        # smooth routes repeat their plain version's float32 operations in
        # order (and sincosf equals torch's sin and cos on the card): 1e-6,
        # measured bit-identical; the product route sums in another order
        # than cuBLAS: 1e-4
        route = pk.synth_route(n_fft, hop)
        fft = route != "product"
        tol_s = 1e-6 if fft else 1e-4
        pk.reset_launches()
        a_k = pk.pghi_synthesize_fused(mag, ph_k, n_fft, hop, window)
        require(pk.routes[f"pghi_synthesize:{route}"] == 1 and sum(pk.routes.values()) == 1,
                f"K {name}: the synthesis did not take the {route} route")
        a_p = pk.pghi_synthesize_fused_reference(mag, ph_k, n_fft, hop, window)
        torch.cuda.synchronize()
        e_s = rel_err(a_k, a_p)
        log(f"  K {name} synthesis of the {label} ({route} route): audio rel {e_s:.3e} (tol {tol_s:.0e}; "
            f"bit-identical {torch.equal(a_k, a_p)}), shape {tuple(a_k.shape)}")
        require(torch.isfinite(a_k).all().item() and a_k.shape == a_p.shape, f"K {name}: bad audio")
        require(e_s <= tol_s, f"K {name} synthesis disagrees with plain")
        key = {"fft": "K_synth", "smooth": "K_synth_smooth", "product": "K_synth_product"}[route]
        results[key] = max(results.get(key, 0.0), abs_err(a_k, a_p))
        # the whole inversion, kernels against plain versions
        inv_k = (pk.pghi_invert_fused if label == "phases" else pk.pghi_invert_bidir)(
            mag, gamma, n_fft, hop, window, **kw)
        inv_p = pk.pghi_synthesize_fused_reference(mag, ph_p, n_fft, hop, window)
        require(torch.equal(inv_k, a_k), f"K {name} {label}: the inversion is not phases then synthesis")
        e_i = rel_err(inv_k, inv_p)
        log(f"  K {name} inversion ({label}): audio rel {e_i:.3e} (tol {max(1e-4, tol):.3g})")
        require(e_i <= max(1e-4, tol), f"K {name} inversion disagrees with plain")


def crel(a: torch.Tensor, b: torch.Tensor) -> float:
    """rel_err of two complex tensors over their (re, im) parts."""
    return rel_err(torch.view_as_real(a), torch.view_as_real(b))


STREAM_CHUNK = 4096
STREAM_LEN = 43 * STREAM_CHUNK   # 4 s at 44.1 kHz in whole chunks (bench.py:524)


def stream_phase(args, dev, gen, errs, counts, other_wrappers):
    """Phase 4f: the streaming chain OverlapAdd(1024, 256) + RealtimeSTFT(1024,
    256, hann) on ``args.streams`` mono sessions of 4 s, chunks of 4096.

    Drives the four routes through the entry points (encode ``scan_forward``,
    the complex and the random ``scan_roundtrip``, the random ``scan_invert``)
    and the 3-chain random roundtrip, each with every launch counter at 0
    just before and read just after, and holds each against the generic chunk
    scan on the same input with a generator seeded alike (which draws the
    same angles): within 1e-4 of the output's largest value (the JAX gate,
    ``tests/test_streaming.py:271``), the complex roundtrip's SNR at the
    ``bench.py:527-530`` delay and trim at least 100 dB, the random modes'
    spectral convergence (``bench.py:566-575``) within ``1.1 s + 1e-3`` of the
    generic scan's.  Then B = 1, RealtimeDGT at B = 8, each kernel against
    its plain version at the main shape, 512/128 and 2048/512, and the routes'
    times beside the generic scan's at B = 1, 8 and 64.  Returns what phase 5
    needs to time the kernels."""
    from acids_transforms_tpu_torch import streaming
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff
    from acids_transforms_tpu_torch.ops.cuda import stream_step as ss

    t_start = time.perf_counter()
    SB, SL, CH = args.streams, STREAM_LEN, STREAM_CHUNK
    T_C = CH // HOP
    n_sf = SL // CH * T_C
    F = N_FFT // 2 + 1
    delay = N_FFT - HOP
    log(f"[4f] streaming: OverlapAdd({N_FFT}, {HOP}) + RealtimeSTFT({N_FFT}, {HOP}, hann) on {SB} mono "
        f"sessions of {SL} samples, chunks of {CH} ({n_sf} frames a session)")
    sx = make_audio(SB, SL, gen, channels=1)[:, 0].contiguous()
    s_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP)
    f_chain = s_chain + T.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT)
    s_rt = s_chain[1]

    def zero_all():
        for w in other_wrappers + (ss,):
            w.reset_launches()

    def others():
        return sum(sum(w.launches.values()) for w in other_wrappers)

    def route(label, fn, expect, main=True, front="fft", seven=False):
        """One run through the entry point, counters at 0 before and read
        after; the main routes' launches go into the kernels line.  Every
        launch of the encode (R, the magnitude encode), of the roundtrips (L,
        M) and of the decodes must have taken the route ``front``: "fft" at a
        power-of-two n_fft, "smooth" (every one of them at an even 5-smooth
        n_fft) or "product"; a dict names the route kernel by
        kernel ("fft" for those it leaves out).  The smooth and the product
        routes' launches are counted for their rows (4h); ``seven``: the
        smooth launches are the radix-7 instances' (an n_fft with a factor
        7), counted as ``<kernel>:smooth7`` for their rows."""
        zero_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = {k: v for k, v in ss.launches.items() if v}
        fronts = {k: v for k, v in ss.routes.items() if v}
        log(f"  {label}: {ms:.1f} ms, launches {got}" + (f", encode routes {fronts}" if fronts else ""))
        require(got == expect and others() == 0, f"{label}: expected the launches {expect}, got {got}")
        for k in ("session_encode", "session_magnitude", "session_roundtrip", "session_random_roundtrip",
                  "session_random_decode", "session_complex_decode", "gl_project_synthesis", "gl_polish",
                  "gl_project_analysis"):
            fk = front.get(k, "fft") if isinstance(front, dict) else front
            on = ss.routes.get(f"{k}:{fk}", 0)
            require(on == ss.launches[k], f"{label}: {k} launched {ss.launches[k]} times, {on} on the {fk} route")
        for k, v in got.items():
            counts[k] += v if main else 0
        for k, v in fronts.items():
            counts[k + ("7" if seven and k.endswith(":smooth") else "")] += v if main or not k.endswith(":fft") else 0
        return out

    def generic(label, fn):
        zero_all()
        out = fn()
        torch.cuda.synchronize()
        require(sum(ss.launches.values()) == 0 and others() == 0, f"{label}: the generic scan launched a kernel")
        return out

    def sgen(k):
        return torch.Generator(device=dev).manual_seed(args.seed + 60 + k)

    win = torch.hann_window(N_FFT, device=dev)

    def offline_mag(v):
        return torch.stft(v, N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                          return_complex=True).abs()

    def make_sc(x):
        ref = offline_mag(x[..., : SL - delay])

        def sc_of(y):
            m = offline_mag(y[..., delay:SL])
            n = min(m.shape[-1], ref.shape[-1]) - 2
            return (torch.linalg.norm(m[..., 2:n] - ref[..., 2:n]) / torch.linalg.norm(ref[..., 2:n])).item()
        return sc_of

    def snr_of(x, y):
        ref, out = x[..., : SL - delay - 2048], y[..., delay: SL - 2048]
        return 10 * math.log10((ref ** 2).sum().item() / max(((out - ref) ** 2).sum().item(), 1e-300))

    for k in list(ss.launches) + list(ss.routes) + [k + ":smooth7" for k in SEVEN_KERNELS]:
        counts[k] = 0
    sc_of = make_sc(sx)
    # encode
    spec_k, st_k = route("encode: scan_forward", lambda: streaming.scan_forward(s_chain, sx, CH),
                         {"session_encode": 1})
    spec_g, st_g = generic("encode", lambda: streaming.scan_forward(s_chain, sx, CH, backend="generic"))
    e = crel(spec_k, spec_g)
    same_state = (st_k[1] == st_g[1] == {} and all(torch.equal(st_k[0][n], st_g[0][n]) for n in st_g[0]))
    log(f"    kernel route vs generic scan: rel {e:.3e} (tol 1e-04); final state equal: {same_state}")
    require(tuple(spec_k.shape) == (SB, n_sf, F) and torch.isfinite(torch.view_as_real(spec_k)).all().item(),
            f"encode output {tuple(spec_k.shape)}")
    require(e <= 1e-4 and same_state, "encode route differs from the generic scan")
    del spec_g
    # complex roundtrip
    y_k = route("complex roundtrip: scan_roundtrip", lambda: streaming.scan_roundtrip(s_chain, sx, CH),
                {"session_roundtrip": 1})
    y_g = generic("complex roundtrip", lambda: streaming.scan_roundtrip(s_chain, sx, CH, backend="generic"))
    e = rel_err(y_k, y_g)
    snr_k, snr_g = snr_of(sx, y_k), snr_of(sx, y_g)
    log(f"    kernel route vs generic scan: rel {e:.3e} (tol 1e-04); SNR after the {delay}-sample delay: kernel "
        f"{snr_k:.2f} dB (the product design's, PR 4: 132.35 dB), generic {snr_g:.2f} dB (must be >= 100, "
        f">= generic - 1 and >= 127.3, the generic scan's in PR 4)")
    require(tuple(y_k.shape) == (SB, SL) and torch.isfinite(y_k).all().item(), f"roundtrip output {tuple(y_k.shape)}")
    require(e <= 1e-4 and snr_k >= 100.0 and snr_k >= snr_g - 1.0 and snr_k >= 127.3,
            "complex roundtrip out of budget")
    quality = {"snr_kernel_db": snr_k, "snr_generic_db": snr_g}

    def random_pair(label, kernel_fn, generic_fn, expect):
        y1 = route(label, kernel_fn, expect)
        y2 = generic(label, generic_fn)
        e = rel_err(y1, y2)
        s1, s2 = sc_of(y1), sc_of(y2)
        log(f"    kernel route vs generic scan (same seed): rel {e:.3e} (tol 1e-04); spectral convergence "
            f"kernel {s1:.5f}, generic {s2:.5f} (must be <= {1.1 * s2 + 1e-3:.5f})")
        require(tuple(y1.shape) == tuple(y2.shape) and torch.isfinite(y1).all().item(), f"{label}: bad output")
        require(e <= 1e-4 and s1 <= 1.1 * s2 + 1e-3, f"{label}: differs from the generic scan")
        return y1, s1, s2

    _, quality["sc_random_kernel"], quality["sc_random_generic"] = random_pair(
        "random roundtrip: scan_roundtrip(random)",
        lambda: streaming.scan_roundtrip(s_chain, sx, CH, "random", generator=sgen(1)),
        lambda: streaming.scan_roundtrip(s_chain, sx, CH, "random", generator=sgen(1), backend="generic"),
        {"session_random_roundtrip": 1})
    mags = spec_k.abs()
    _, quality["sc_decode_kernel"], quality["sc_decode_generic"] = random_pair(
        "random decode: scan_invert(random)",
        lambda: streaming.scan_invert(s_chain, mags, T_C, "random", generator=sgen(2)),
        lambda: streaming.scan_invert(s_chain, mags, T_C, "random", generator=sgen(2), backend="generic"),
        {"session_random_decode": 1})
    random_pair(
        "3-chain [OverlapAdd, RealtimeSTFT, Magnitude] random roundtrip",
        lambda: streaming.scan_roundtrip(f_chain, sx, CH, "random", generator=sgen(3)),
        lambda: streaming.scan_roundtrip(f_chain, sx, CH, "random", generator=sgen(3), backend="generic"),
        {"session_magnitude": 1, "session_random_decode": 1})
    # one stream: under one wave of the card's SMs
    x1, sc1 = sx[:1], make_sc(sx[:1])
    y1 = route("B=1 complex roundtrip", lambda: streaming.scan_roundtrip(s_chain, x1, CH), {"session_roundtrip": 1},
               main=False)
    e1 = rel_err(y1, generic("B=1", lambda: streaming.scan_roundtrip(s_chain, x1, CH, backend="generic")))
    y1m = route("B=1 random roundtrip", lambda: streaming.scan_roundtrip(s_chain, x1, CH, "random", generator=sgen(4)),
                {"session_random_roundtrip": 1}, main=False)
    y1g = generic("B=1 random", lambda: streaming.scan_roundtrip(s_chain, x1, CH, "random", generator=sgen(4),
                                                                   backend="generic"))
    e1m = rel_err(y1m, y1g)
    log(f"    B=1 vs generic scan: complex rel {e1:.3e}, random rel {e1m:.3e} (tol 1e-04), spectral convergence "
        f"{sc1(y1m):.5f} / {sc1(y1g):.5f}")
    require(e1 <= 1e-4 and e1m <= 1e-4, "B=1 sessions differ from the generic scan")
    # the gaussian window on the full-K path
    d_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeDGT(n_fft=N_FFT, hop_length=HOP, inversion_mode="random")
    x8 = sx[:8]
    yd = route("RealtimeDGT B=8 complex roundtrip", lambda: streaming.scan_roundtrip(d_chain, x8, CH),
               {"session_roundtrip": 1}, main=False)
    ydg = generic("DGT", lambda: streaming.scan_roundtrip(d_chain, x8, CH, backend="generic"))
    e_d, snr_d, snr_dg = rel_err(yd, ydg), snr_of(x8, yd), snr_of(x8, ydg)
    log(f"    vs generic scan: rel {e_d:.3e} (tol 1e-04); SNR kernel {snr_d:.2f} dB, generic {snr_dg:.2f} dB "
        f"(must be >= generic - 1)")
    require(e_d <= 1e-4 and snr_d >= snr_dg - 1.0, "RealtimeDGT session differs from the generic scan")
    quality.update(snr_dgt_kernel_db=snr_d, snr_dgt_generic_db=snr_dg)
    del y1, y1m, y1g, yd, ydg, y_g

    # each kernel against its plain version: fp32 sums in another order than
    # cuBLAS (contractions of n_fft for the analysis, overlap x Kp for the
    # synthesis), a few 1e-7 of the largest value; 2e-5 leaves a decade.  L
    # and M on the FFT route repeat their plain version's float32 operations
    # in order (bit-identical on the card): 1e-6.  On the smooth route (the
    # mixed-radix instances, n_fft even and 5-smooth) R, L, M and P must be
    # bit-identical to their plain versions.  L and M also against a
    # float64 oracle (torch.fft of the row-padded frames, |X| with the angles
    # for M, irfft times the synthesis window over the gain, overlap-added):
    # within 1e-5 of the largest sample on every route.
    def oracle_roundtrip(x, rt, gain, n_fft, hop, n_frames, ang=None):
        fr = ss.session_rows(x, n_fft, hop, n_frames).double().unfold(-1, n_fft, hop) * rt.window.double()
        spec = torch.fft.rfft(fr, dim=-1)
        del fr
        if ang is not None:
            spec = torch.polar(spec.abs(), ang[:, :n_frames].double())
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * (rt.inv_window.double() / gain)
        del spec
        out = torch.zeros((x.shape[0], (n_frames - 1) * hop + n_fft), dtype=torch.float64, device=x.device)
        for i in range(n_fft // hop):                      # piece i of every frame
            out[:, i * hop: i * hop + n_frames * hop] += frames[..., i * hop: (i + 1) * hop].reshape(x.shape[0], -1)
        return out[:, : n_frames * hop]

    def check_kernels(label, n_fft, hop, x, chunk):
        oadd, rt = T.OverlapAdd(n_fft, hop), T.RealtimeSTFT(n_fft=n_fft, hop_length=hop)
        chain = oadd + rt
        Fb = n_fft // 2 + 1
        n_chunks = -(-x.shape[-1] // chunk)
        Tn = n_chunks * chunk // hop
        ang = ss.session_angles((x.shape[0],), n_chunks, chunk // hop, Fb, dev, sgen(5))
        re, im = ss.session_encode_reference(x, rt.window, n_fft, hop, Tn)
        spec, _ = ss.make_fused_forward_session(chain, chunk)(x)
        mag = torch.sqrt(re * re + im * im)
        gain = oadd.gain_compensation
        pairs = {
            "R": (torch.view_as_real(spec), torch.stack([re, im], dim=-1)),
            "L": (ss.make_fused_roundtrip(chain, chunk)(x),
                  ss.session_roundtrip_reference(x, rt.window, rt.inv_window, gain, n_fft, hop, Tn)),
            "M": (ss.make_fused_random_roundtrip(chain, chunk, angles=ang)(x),
                  ss.session_roundtrip_reference(x, rt.window, rt.inv_window, gain, n_fft, hop, Tn, angles=ang)),
            "P": (ss.make_fused_random_invert(chain, chunk // hop, angles=ang)(mag),
                  ss.session_decode_reference(mag, ang, rt.inv_window, gain, n_fft, hop)),
        }
        torch.cuda.synchronize()
        fft = ff.fft_covers(n_fft)
        fronts = {"R": ss.session_route(n_fft, "encode"), "L": ss.session_route(n_fft, "roundtrip", hop),
                  "M": ss.session_route(n_fft, "roundtrip", hop), "P": ss.session_route(n_fft, "decode")}
        msg = []
        for key, (k_out, p_out) in pairs.items():
            front = fronts[key]
            e = rel_err(k_out, p_out)
            tol = 1e-6 if fft and key in ("L", "M", "P") else 2e-5
            same = torch.equal(k_out, p_out)
            msg.append(f"{key} {e:.3e} (tol {tol:.0e}{' bit-identical' if same else ''})")
            require(k_out.shape == p_out.shape and torch.isfinite(k_out).all().item(), f"{key} {label}: bad output")
            require(e <= tol, f"{key} {label} disagrees with plain")
            require(same or front != "smooth", f"{key} {label}: the smooth route is not bit-identical "
                    "to its plain version")
            if key in ("L", "M"):
                o = oracle_roundtrip(x, rt, gain, n_fft, hop, Tn, ang if key == "M" else None)
                e_o = rel_err(k_out.double(), o)
                msg[-1] += f", oracle {e_o:.3e} (tol 1e-05)"
                require(e_o <= 1e-5, f"{key} {label} disagrees with the float64 oracle")
                del o
            if front != "fft":
                key += "_" + front + ("7" if front == "smooth" and n_fft % 7 == 0 else "")
            errs[key] = max(errs.get(key, 0.0), abs_err(k_out, p_out))
        log(f"  kernels vs plain, {label} (routes {fronts}; blocks: encode "
            f"{ss._encode_plan(n_fft, hop)}, roundtrip {ss._roundtrip_plan(n_fft, hop)}, decode "
            f"{ss._decode_plan(n_fft, hop)} as (rows, FFTs)): rel {', '.join(msg)}")

    check_kernels(f"main shape {SB} x {SL}", N_FFT, HOP, sx, CH)
    check_kernels("512/128, 3 x 20000 (ragged)", 512, 128, sx[:3, :20000].contiguous(), 2048)
    check_kernels("2048/512, 2 x 30000 (ragged)", 2048, 512, sx[:2, :30000].contiguous(), 4096)
    # the smooth route (R, L, M, P) at five shapes users frame audio in at
    # 48 kHz (25, 20, 16, 8.3 and 40 ms); the radix-7 instances of R, L, M
    # and P at 1344/336 (2^6 3 7: 28 ms at 48 kHz) and 896/224 (2^7 7: 56 ms
    # at 16 kHz), bit-identical to their plain versions, and at 1764/588
    # (2^2 3^2 7^2, 40 ms at 44.1 kHz, overlap 3); the radix-7 instances at
    # every other overlap the roundtrip gate takes: 4032/2016 (overlap 2),
    # 1680/336 (5), 1344/224 (6), 3528/504 (7: two sevens) and 1344/168 (8),
    # each L and M against the float64 oracle under the chain's own gain
    # (overlap); the product route of R, L, M and P at 1408/352 (2^7 11)
    for n_s, hop_s in ((1200, 300), (960, 240), (768, 192), (400, 100), (1920, 480)):
        check_kernels(f"{n_s}/{hop_s}, 4 x 40000 (ragged)", n_s, hop_s, sx[:4, :40000].contiguous(), 2 * n_s)
    check_kernels("1344/336, 4 x 40000 (ragged)", 1344, 336, sx[:4, :40000].contiguous(), 2688)
    check_kernels("896/224, 4 x 40000 (ragged)", 896, 224, sx[:4, :40000].contiguous(), 1792)
    check_kernels("1764/588, 3 x 40000 (ragged)", 1764, 588, sx[:3, :40000].contiguous(), 3528)
    for n_s, hop_s in ((4032, 2016), (1680, 336), (1344, 224), (3528, 504), (1344, 168)):
        require(ss.session_route(n_s, "encode") == ss.session_route(n_s, "roundtrip", hop_s) == "smooth",
                f"{n_s}/{hop_s}: R, L and M must take the radix-7 instances")
        check_kernels(f"{n_s}/{hop_s}, 3 x 40000 (ragged)", n_s, hop_s, sx[:3, :40000].contiguous(), 2 * n_s)
    check_kernels("1408/352, 4 x 40000 (ragged)", 1408, 352, sx[:4, :40000].contiguous(), 2816)

    # P, S and O's projection synthesis by route: the FFT route at every power
    # of two it takes (hop n_fft / 4), on magnitudes with phases up to 1e3 rad
    # (S: with imaginary parts at DC and nyquist, which neither route reads)
    # and an odd frame count, against the plain version (1e-6: it repeats
    # the kernel's float32 operations in order, and sincosf is torch's sin and
    # cos on the card; measured bit-identical) and a float64 oracle (irfft
    # times the synthesis window over the gain, overlap-added: 1e-5); O's
    # narrow blocks too; the smooth route at the five shapes of the encode's
    # and the roundtrips' smooth route, and its radix-7 instance at 1344/336,
    # 896/224 and every other overlap the gate takes (4032/2016, 1680/336,
    # 1344/224, 3528/504, 1344/168), bit-identical to its plain version; the
    # product route at 1408/352 (2^7 11) against its plain version (2e-5: fp32
    # products in another order than cuBLAS) and the oracle.  P and S take
    # the chain's gain (OverlapAdd's gain_compensation, the overlap), O's
    # synthesis the overlap, the kernel, its plain version and the oracle
    # the same operands
    def chain_gain(n_fft, hop):
        return float(T.OverlapAdd(n_fft, hop).gain_compensation)

    def check_decode_routes(n_fft, hop, B=3, T=45):
        Fb, ov = n_fft // 2 + 1, n_fft // hop
        gain = chain_gain(n_fft, hop)
        front = ss.session_route(n_fft, "decode")
        fft = front != "product"
        g = sgen(n_fft + hop)
        mag = torch.rand((B, T, Fb), generator=g, device=dev)
        ang = 1e3 * torch.rand((B, T, Fb), generator=g, device=dev)
        spec = torch.polar(mag, ang)
        spec[..., 0] += 0.5j
        spec[..., -1] -= 0.25j
        inv_w = torch.hann_window(n_fft, device=dev)
        msg = []
        for key, gain, rows, kname in (("P", gain, None, "session_random_decode"),
                                       ("S", gain, None, "session_complex_decode"),
                                       ("Osyn", float(ov), ss.PROJECT_SYN_ROWS, "gl_project_synthesis")):
            ops = ss._decode_operands(inv_w, gain, n_fft, hop)
            ss.reset_launches()
            if key == "S":
                k_out = ss._launch_decode(torch.view_as_real(spec).contiguous(), None, ops, n_fft, hop)
                p_out = ss.session_complex_decode_reference(spec, inv_w, gain, n_fft, hop)
                o_spec = spec.to(torch.complex128)
                o_spec[..., 0] = o_spec[..., 0].real
                o_spec[..., -1] = o_spec[..., -1].real
            else:
                k_out = ss._launch_decode(mag, ang, ops, n_fft, hop, rows=rows, name=kname)
                p_out = ss.session_decode_reference(mag, ang, inv_w, gain, n_fft, hop)
                o_spec = torch.polar(mag.double(), ang.double())
            fr = torch.fft.irfft(o_spec, n=n_fft) * (inv_w.double() / gain)
            o = torch.zeros((B, (T - 1) * hop + n_fft), dtype=torch.float64, device=dev)
            for t in range(T):
                o[:, t * hop: t * hop + n_fft] += fr[:, t]
            o = o[:, : T * hop]
            torch.cuda.synchronize()
            e_p, e_o = rel_err(k_out, p_out), rel_err(k_out.double(), o)
            tol = 1e-6 if fft else 2e-5
            plan = ss._decode_plan(n_fft, hop, rows)
            msg.append(f"{key} {e_p:.3e} (tol {tol:.0e}; bit-identical {torch.equal(k_out, p_out)}), oracle "
                       f"{e_o:.3e} (tol 1e-05), block {plan}")
            require(ss.routes[f"{kname}:{front}"] == 1 and sum(ss.routes.values()) == 1,
                    f"{key} {n_fft}/{hop}: not on the {front} route")
            require(k_out.shape == p_out.shape == (B, T * hop) and torch.isfinite(k_out).all().item(),
                    f"{key} {n_fft}/{hop}: bad output")
            require(e_p <= tol and e_o <= 1e-5, f"{key} {n_fft}/{hop}: out of budget")
            require(torch.equal(k_out, p_out) or front != "smooth",
                    f"{key} {n_fft}/{hop}: the smooth route is not bit-identical to its plain version")
            k = key if front == "fft" else key + "_" + front + ("7" if front == "smooth" and n_fft % 7 == 0 else "")
            errs[k] = max(errs.get(k, 0.0), abs_err(k_out, p_out))
        log(f"  decodes {n_fft}/{hop} ({front} route{', radix 7' if n_fft % 7 == 0 and front == 'smooth' else ''}, "
            f"{B} x {T} frames): " + "; ".join(msg))

    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        check_decode_routes(n_fft, n_fft // 4)
    check_decode_routes(1024, 128)
    check_decode_routes(4096, 2048)
    for n_s in (1200, 960, 768, 400, 1920):
        check_decode_routes(n_s, n_s // 4)
    for n_s, hop_s in ((1344, 336), (896, 224), (4032, 2016), (1680, 336), (1344, 224), (3528, 504), (1344, 168)):
        require(ss.session_route(n_s, "decode") == "smooth", f"{n_s}/{hop_s}: the decodes must take the radix-7 "
                "instance")
        check_decode_routes(n_s, hop_s)
    require(ss.session_route(1408, "decode") == "product", "1408/352: the decodes must take the product route")
    check_decode_routes(1408, 352)
    ss.reset_launches()

    # R and the magnitude encode on the FFT route (fft_smem.cuh:frames_rfft)
    # against their plain version (frames_fft.frames_rfft_reference, the
    # kernel's schedule: the same float32 operations in the same order, so
    # within 1e-5 of the largest value and bit-identical where nothing rounds
    # otherwise) and against the float64 oracle (torch.fft.rfft of the
    # windowed frames in float64: float32 FFT sums, within 1e-5 of the largest
    # magnitude); the smooth route at 1200/300, 960/240, 768/192, 400/100 and
    # 1920/480, and its radix-7 instance at 1344/336 and 896/224,
    # bit-identical to its plain version; the product route at 1408/352
    # against its plain version at the product's 2e-5
    def check_encode_routes(label, n_fft, hop, x, n_frames):
        w = torch.hann_window(n_fft, device=dev)
        ops = ss._encode_operands(w, n_fft)
        front = ss.session_route(n_fft, "encode")
        fft = front != "product"
        ss.reset_launches()
        spec = ss._launch_encode(x, ops, n_fft, hop, n_frames)
        mag = ss._launch_encode(x, ops, n_fft, hop, n_frames, magnitude=True)
        require(ss.routes[f"session_encode:{front}"] == 1 and ss.routes[f"session_magnitude:{front}"] == 1,
                f"{label}: the encode took another route than {front}")
        re, im = ss.session_encode_reference(x, w, n_fft, hop, n_frames)
        plain = torch.stack([re, im], dim=-1)
        e_r, e_m = rel_err(spec, plain), rel_err(mag, torch.sqrt(re * re + im * im))
        bit = torch.equal(spec, plain) and torch.equal(mag, torch.sqrt(re * re + im * im))
        fr = ss.session_rows(x, n_fft, hop, n_frames).double().unfold(-1, n_fft, hop) * w.double()
        ora = torch.fft.rfft(fr, dim=-1)
        del fr
        o_r, o_m = rel_err(torch.view_as_complex(spec), ora), rel_err(mag, ora.abs())
        del ora
        tol = 1e-5 if fft else 2e-5
        log(f"  R / magnitude encode {label} ({front} route, plan {ss._encode_plan(n_fft, hop)}): vs plain rel "
            f"{e_r:.3e} / {e_m:.3e} (tol {tol:.0e}; bit-identical: {bit}), vs float64 oracle {o_r:.3e} / "
            f"{o_m:.3e} (tol 1e-05)")
        require(torch.isfinite(spec).all().item() and torch.isfinite(mag).all().item(), f"{label}: not finite")
        require(e_r <= tol and e_m <= tol and o_r <= 1e-5 and o_m <= 1e-5, f"R {label}: out of budget")
        require(bit or front != "smooth", f"R {label}: the smooth route is not bit-identical to its plain version")
        key = "" if front == "fft" else "_" + front + ("7" if front == "smooth" and n_fft % 7 == 0 else "")
        errs["R" + key] = max(errs.get("R" + key, 0.0), abs_err(spec, plain))
        errs["Rmag" + key] = max(errs.get("Rmag" + key, 0.0), abs_err(mag, torch.sqrt(re * re + im * im)))

    check_encode_routes(f"main shape {SB} x {SL}", N_FFT, HOP, sx, n_sf)
    check_encode_routes("512/128, 3 x 20000 (odd: 157 frames)", 512, 128, sx[:3, :20000].contiguous(), 157)
    check_encode_routes("2048/512, 2 x 30000 (odd: 59 frames)", 2048, 512, sx[:2, :30000].contiguous(), 59)
    check_encode_routes("1200/300, 4 x 40000", 1200, 300, sx[:4, :40000].contiguous(), 136)
    check_encode_routes("960/240, 4 x 40000 (odd: 167 frames)", 960, 240, sx[:4, :40000].contiguous(), 167)
    check_encode_routes("768/192, 4 x 40000 (odd: 209 frames)", 768, 192, sx[:4, :40000].contiguous(), 209)
    check_encode_routes("400/100, 4 x 40000 (odd: 401 frames)", 400, 100, sx[:4, :40000].contiguous(), 401)
    check_encode_routes("1920/480, 4 x 40000 (odd: 85 frames)", 1920, 480, sx[:4, :40000].contiguous(), 85)
    check_encode_routes("1344/336, 4 x 40000 (odd: 121 frames)", 1344, 336, sx[:4, :40000].contiguous(), 121)
    check_encode_routes("896/224, 4 x 40000 (odd: 181 frames)", 896, 224, sx[:4, :40000].contiguous(), 181)
    check_encode_routes("1764/588, 3 x 40000 (odd: 69 frames)", 1764, 588, sx[:3, :40000].contiguous(), 69)
    check_encode_routes("1408/352, 4 x 40000 (odd: 115 frames)", 1408, 352, sx[:4, :40000].contiguous(), 115)
    ss.reset_launches()
    torch.cuda.empty_cache()

    # the routes through the entry points beside the generic scan, B = 1, 8, 64
    log("  route times (CUDA events around the entry point, median of 3): kernel route / generic scan")
    route_ms = {}
    for b in sorted({1, 8, SB}):
        xb, mb = sx[:b], mags[:b]
        rows = (
            ("encode", lambda: streaming.scan_forward(s_chain, xb, CH),
             lambda: streaming.scan_forward(s_chain, xb, CH, backend="generic")),
            ("complex roundtrip", lambda: streaming.scan_roundtrip(s_chain, xb, CH),
             lambda: streaming.scan_roundtrip(s_chain, xb, CH, backend="generic")),
            ("random roundtrip", lambda: streaming.scan_roundtrip(s_chain, xb, CH, "random", generator=sgen(6)),
             lambda: streaming.scan_roundtrip(s_chain, xb, CH, "random", generator=sgen(6), backend="generic")),
            ("random decode", lambda: streaming.scan_invert(s_chain, mb, T_C, "random", generator=sgen(7)),
             lambda: streaming.scan_invert(s_chain, mb, T_C, "random", generator=sgen(7), backend="generic")),
        )
        for name, kfn, gfn in rows:
            k_ms, g_ms = time_ms(kfn, 3, 1), time_ms(gfn, 3, 1)
            route_ms[(name, b)] = (k_ms, g_ms)
            log(f"    B={b:3d} {name:18s}: {k_ms:9.3f} ms / {g_ms:9.3f} ms ({g_ms / k_ms:.2f}x)")
    log("  stream quality: " + json.dumps({k: round(v, 6) for k, v in quality.items()}))
    log(f"  phase 4f {time.perf_counter() - t_start:.1f} s")
    return dict(sx=sx, mags=mags.contiguous(), rt=s_rt, chain=s_chain, n_frames=n_sf, ss=ss,
                angles=ss.session_angles((SB,), SL // CH, T_C, F, dev, sgen(8)),
                spec=spec_k, route=route, generic=generic, sgen=sgen, make_sc=make_sc, snr_of=snr_of)


def stream_pghi_phase(args, dev, errs, counts, stream):
    """Phase 4g: the streaming RT-PGHI sessions and the complex decode, on
    phase 4f's 64 mono sessions of 43 x 4096 samples, through the entry
    points, for the hann chain OverlapAdd(1024, 256) + RealtimeSTFT(1024, 256,
    hann, inversion_mode="pghi") (``bench.py:560-562``) and the default
    OverlapAdd(1024, 256) + RealtimeDGT(1024, 256):

    * ``scan_roundtrip(pghi)`` (N: the magnitude encode, the recurrence, P's
      synthesis), ``scan_invert(pghi)`` of the chain window's offline
      magnitudes (Q: the recurrence, P's synthesis), and the 3-chain
      ``[.., Magnitude(unipolar, log1p, mel=False)]`` pghi roundtrip (the
      magnitude encode, Magnitude forward and invert, Q), each held against
      the generic chunk scan with a generator in the same state by spectral
      convergence within ``1.1 s + 1e-3`` of the scan's: the roundtrip at
      ``bench.py:566-592``'s delay and frames, the decode at ``:640-675``'s
      (the kernels' magnitudes round otherwise than the scan's ``torch.stft``
      products, which can move an anchor at a threshold, so sample equality is
      not the gate);
    * for the hann chain the complex decode ``scan_invert`` of
      ``scan_forward``'s spectra (S) within 1e-4 of the generic scan, and S
      after R equal to the complex roundtrip L within 1e-5 with an SNR of at
      least 100 dB after the delay.

    Every launch counter is 0 before each route and read after it.  Then each
    new kernel against its plain version on identical inputs (the recurrence
    on the kernel's own magnitudes) at the main shape, 512/128 and 2048/512,
    and the routes' times beside the generic scan's at B = 1, 8 and 64.
    Returns what phase 5 needs."""
    from acids_transforms_tpu_torch import streaming
    from acids_transforms_tpu_torch import transforms as T

    ss, sx, route, generic, sgen = (stream[k] for k in ("ss", "sx", "route", "generic", "sgen"))
    SB, SL, CH = sx.shape[0], STREAM_LEN, STREAM_CHUNK
    T_C = CH // HOP
    F = N_FFT // 2 + 1
    delay = N_FFT - HOP
    sc_of = stream["make_sc"](sx)
    log(f"[4g] streaming RT-PGHI and the complex decode on {SB} mono sessions of {SL} samples, chunks of {CH}")
    pghi_launches = {"session_magnitude": 1, "rt_pghi_phases": 1, "session_random_decode": 1}
    decode_launches = {"rt_pghi_phases": 1, "session_random_decode": 1}
    h_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi")
    d_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeDGT(n_fft=N_FFT, hop_length=HOP)
    quality, dec_mags = {}, {}

    def offline_mags(v, window):
        """The chain window's centred offline magnitudes, whole chunks of frames (bench.py:641-643)."""
        m = torch.stft(v, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                       return_complex=True).abs().transpose(-2, -1)
        return m[..., : m.shape[-2] // T_C * T_C, :].contiguous()

    def sc_dec_of(mags, window):
        def sc(y):
            m = offline_mags(y[..., N_FFT // 2:], window)
            n = min(m.shape[-2], mags.shape[-2]) - 4
            return (torch.linalg.norm(m[..., 2:n, :] - mags[..., 2:n, :]) / torch.linalg.norm(mags[..., 2:n, :])).item()
        return sc

    def sc_pair(label, kernel_fn, generic_fn, expect, sc, seed):
        y1 = route(label, lambda: kernel_fn(sgen(seed)), expect)
        y2 = generic(label, lambda: generic_fn(sgen(seed)))
        s1, s2 = sc(y1), sc(y2)
        log(f"    kernel route vs generic scan (same seed): rel {rel_err(y1, y2):.3e}; spectral convergence "
            f"kernel {s1:.5f}, generic {s2:.5f} (must be <= {1.1 * s2 + 1e-3:.5f})")
        require(tuple(y1.shape) == tuple(y2.shape) and torch.isfinite(y1).all().item(), f"{label}: bad output")
        require(s1 <= 1.1 * s2 + 1e-3, f"{label}: converges worse than the generic scan")
        return s1, s2

    for name, chain, seed in (("hann", h_chain, 70), ("dgt", d_chain, 80)):
        rt = chain[1]
        f_chain = chain + T.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT)
        # the chain streams on the card eagerly too: state, one step, one inversion
        st = chain.init_state((2,))
        st, fr = chain.step(st, sx[:2, :CH])
        st, y_e = chain.step_invert(st, fr.abs(), generator=sgen(seed))
        require(torch.isfinite(y_e).all().item() and set(st[1]) == {"mag_buffer", "phase_buffer"},
                f"{name}: the eager pghi step failed")
        quality[f"sc_{name}_roundtrip"] = sc_pair(
            f"{name} pghi roundtrip: scan_roundtrip(pghi)",
            lambda g: streaming.scan_roundtrip(chain, sx, CH, "pghi", generator=g),
            lambda g: streaming.scan_roundtrip(chain, sx, CH, "pghi", generator=g, backend="generic"),
            pghi_launches, sc_of, seed + 1)
        mags = offline_mags(sx, rt.window)
        dec_mags[name] = mags
        quality[f"sc_{name}_decode"] = sc_pair(
            f"{name} pghi decode: scan_invert(pghi) of {tuple(mags.shape)} offline magnitudes",
            lambda g: streaming.scan_invert(chain, mags, T_C, "pghi", generator=g),
            lambda g: streaming.scan_invert(chain, mags, T_C, "pghi", generator=g, backend="generic"),
            decode_launches, sc_dec_of(mags, rt.window), seed + 2)
        quality[f"sc_{name}_3chain"] = sc_pair(
            f"{name} 3-chain [.., Magnitude] pghi roundtrip",
            lambda g: streaming.scan_roundtrip(f_chain, sx, CH, "pghi", generator=g),
            lambda g: streaming.scan_roundtrip(f_chain, sx, CH, "pghi", generator=g, backend="generic"),
            pghi_launches, sc_of, seed + 3)

    # S: the complex decode of the encode's spectra (R ran in phase 4f)
    spec = stream["spec"]
    y_s = route("complex decode: scan_invert(complex spectrum)", lambda: streaming.scan_invert(h_chain, spec, T_C),
                {"session_complex_decode": 1})
    y_sg = generic("complex decode", lambda: streaming.scan_invert(h_chain, spec, T_C, backend="generic"))
    y_l = ss.make_fused_roundtrip(h_chain, CH)(sx)
    e_g, e_l = rel_err(y_s, y_sg), rel_err(y_s, y_l)
    snr_s = stream["snr_of"](sx, y_s)
    log(f"    kernel route vs generic scan: rel {e_g:.3e} (tol 1e-04); S after R vs L: rel {e_l:.3e} (tol 1e-05); "
        f"SNR after the {delay}-sample delay {snr_s:.2f} dB (must be >= 100)")
    require(tuple(y_s.shape) == (SB, SL) and torch.isfinite(y_s).all().item(), f"complex decode output {tuple(y_s.shape)}")
    require(e_g <= 1e-4 and e_l <= 1e-5 and snr_s >= 100.0, "complex decode out of budget")
    quality["snr_complex_decode_db"] = snr_s
    del y_s, y_sg, y_l

    # each new kernel against its plain version on identical inputs
    def check_kernels(label, chain, x, chunk):
        rt = chain[1]
        n_fft, hop = rt.n_fft, rt.hop_length
        Fb, T_c = n_fft // 2 + 1, chunk // hop
        n_chunks = -(-x.shape[-1] // chunk)
        Tn = n_chunks * T_c
        gain = chain[0].gain_compensation
        ang = ss.session_angles((x.shape[0],), n_chunks, T_c, Fb, dev, sgen(90))
        mag_k = ss.make_fused_magnitude_session(chain, chunk)(x)
        mag_p = ss.session_magnitude_reference(x, rt.window, n_fft, hop, Tn)
        args_r = (rt.gamma, n_fft, hop, rt.tolerance, T_c)
        ph_k = ss.rt_pghi_phases(mag_k, ang, *args_r)
        ph_p = ss.rt_pghi_phases_reference(mag_k, ang, *args_r)
        syn = ss._decode_operands(rt.inv_window, float(gain), n_fft, hop)
        y_k = ss._launch_decode(mag_k, ph_k, syn, n_fft, hop)
        y_p = ss.session_decode_reference(mag_k, ph_k, rt.inv_window, gain, n_fft, hop)
        spec, _ = ss.make_fused_forward_session(chain, chunk)(x)
        s_k = ss.make_fused_complex_invert(chain, T_c)(spec)
        s_p = ss.session_complex_decode_reference(spec, rt.inv_window, gain, n_fft, hop)
        torch.cuda.synchronize()
        e_m, e_y, e_s = rel_err(mag_k, mag_p), rel_err(y_k, y_p), rel_err(s_k, s_p)
        e_ph = (unit_spec(mag_k, ph_k) - unit_spec(mag_k, ph_p)).abs().max().item()
        differ = (ph_k != ph_p).float().mean().item()
        log(f"  kernels vs plain, {label}: magnitude encode rel {e_m:.3e} (tol 2e-05); recurrence "
            f"|X| (cos, sin)(phase) off by {e_ph:.3e} of the largest (tol 1e-04; phases differ in "
            f"{100 * differ:.4f}% of bins, by at most {(ph_k - ph_p).abs().max().item():.3g} rad of "
            f"{ph_p.abs().max().item():.3g}); synthesis of its phases rel {e_y:.3e}, S rel {e_s:.3e} (tol 2e-05)")
        for what, out in (("magnitude encode", mag_k), ("recurrence", ph_k), ("synthesis", y_k), ("S", s_k)):
            require(torch.isfinite(out).all().item(), f"{what} {label}: not finite")
        require(mag_k.shape == mag_p.shape == (x.shape[0], Tn, Fb) and ph_k.shape == ph_p.shape
                and s_k.shape == s_p.shape == (x.shape[0], Tn * hop), f"{label}: shapes")
        require(e_m <= 2e-5 and e_ph <= 1e-4 and e_y <= 2e-5 and e_s <= 2e-5, f"{label}: a kernel disagrees with plain")
        errs["Rmag"] = max(errs.get("Rmag", 0.0), abs_err(mag_k, mag_p))
        errs["RT"] = max(errs.get("RT", 0.0), e_ph)
        errs["P"] = max(errs.get("P", 0.0), abs_err(y_k, y_p))
        errs["S"] = max(errs.get("S", 0.0), abs_err(s_k, s_p))
        return mag_k, ang

    main_mag, main_ang = check_kernels(f"main shape hann {SB} x {SL}", h_chain, sx, CH)
    check_kernels(f"main shape dgt {SB} x {SL}", d_chain, sx, CH)
    check_kernels("512/128 hann, 3 x 20000 (ragged)",
                  T.OverlapAdd(512, 128) + T.RealtimeSTFT(n_fft=512, hop_length=128, inversion_mode="pghi"),
                  sx[:3, :20000].contiguous(), 2048)
    check_kernels("2048/512 dgt, 2 x 30000 (ragged)", T.OverlapAdd(2048, 512) + T.RealtimeDGT(n_fft=2048, hop_length=512),
                  sx[:2, :30000].contiguous(), 4096)

    # the routes through the entry points beside the generic scan (a Python
    # loop over frames: one run each), B = 1, 8, 64
    log("  route times (CUDA events around the entry point; kernel route median of 3, generic scan one run)")
    route_ms = {}
    for b in sorted({1, 8, SB}):
        xb = sx[:b]
        rows = (
            ("hann pghi roundtrip", lambda g: streaming.scan_roundtrip(h_chain, xb, CH, "pghi", generator=g),
             lambda g: streaming.scan_roundtrip(h_chain, xb, CH, "pghi", generator=g, backend="generic")),
            ("hann pghi decode", lambda g: streaming.scan_invert(h_chain, dec_mags["hann"][:b], T_C, "pghi", generator=g),
             lambda g: streaming.scan_invert(h_chain, dec_mags["hann"][:b], T_C, "pghi", generator=g,
                                             backend="generic")),
            ("hann complex decode", lambda g: streaming.scan_invert(h_chain, spec[:b], T_C),
             lambda g: streaming.scan_invert(h_chain, spec[:b], T_C, backend="generic")),
            ("dgt pghi roundtrip", lambda g: streaming.scan_roundtrip(d_chain, xb, CH, "pghi", generator=g),
             lambda g: streaming.scan_roundtrip(d_chain, xb, CH, "pghi", generator=g, backend="generic")),
            ("dgt pghi decode", lambda g: streaming.scan_invert(d_chain, dec_mags["dgt"][:b], T_C, "pghi", generator=g),
             lambda g: streaming.scan_invert(d_chain, dec_mags["dgt"][:b], T_C, "pghi", generator=g,
                                             backend="generic")),
        )
        for name, kfn, gfn in rows:
            k_ms = time_ms(lambda: kfn(sgen(99)), 3, 1)
            g_ms = time_ms(lambda: gfn(sgen(99)), 1, 0)
            route_ms[(name, b)] = (k_ms, g_ms)
            log(f"    B={b:3d} {name:20s}: {k_ms:9.3f} ms / {g_ms:9.3f} ms ({g_ms / k_ms:.2f}x)")
    log("  RT-PGHI stream quality: " + json.dumps(
        {k: [round(v, 6) for v in val] if isinstance(val, tuple) else round(val, 6) for k, val in quality.items()}))
    return dict(mag=main_mag, angles=main_ang, chain=h_chain, spec=spec, sc_dec_of=sc_dec_of,
                dec_mags=dec_mags, quality=quality, route_ms=route_ms)


def stream_pghi_gl_phase(args, dev, errs, counts, stream, rt_stream):
    """Phase 4g, ``pghi_gl``: session O on phase 4f's 64 mono sessions of 43 x
    4096 samples, through the entry points, for OverlapAdd(1024, 256) +
    RealtimeSTFT(1024, 256, hann, inversion_mode="pghi_gl") and the default
    OverlapAdd(1024, 256) + RealtimeDGT(1024, 256) in ``pghi_gl``
    (``gl_iterations`` 16, ``gl_context`` 3, the defaults):

    * ``scan_roundtrip(pghi_gl)`` (the magnitude encode, per chunk one seeded
      recurrence and one polish launch of 16 projections, P's synthesis),
      ``scan_invert(pghi_gl)`` of the offline magnitudes and the 3-chain
      ``[.., Magnitude]`` roundtrip, each with every launch counter at 0
      before and read after, held against the generic chunk scan under a
      generator in the same state by spectral convergence within ``1.1 s +
      1e-3`` (``bench.py:566-592``, ``:640-675``); the hann roundtrip again
      at lookahead 4, with the ``pghi`` figure of the same sessions beside;
      the hann roundtrip (lookahead 0 and 4) and decode at B = 1 and 8 too;
      a grid the polish does not take (4096/1024, ``gl_context`` 1, chunks
      of 40 frames) on two launches a projection, the analysis on its FFT
      route (timed in turns with its product route, host clock);
    * each new kernel against its plain version on identical inputs at the
      main shape, 512/128 and 2048/512, lookahead 0 and 4: the seeded
      recurrence (phases bit-identical, or ``|X| (cos, sin)`` within 1e-4 of
      the largest), the projection (pinned and frozen rows included, within
      1e-4 of the largest ``|X| (cos, sin)``; its synthesis alone within 2e-5
      relative), the polish of 16 projections (bit-identical to its plain
      version and to 16 two-launch projections) and the whole
      session against the plain session (spectral
      convergence within ``1.1 s + 1e-3``, finite);
    * the hann roundtrip's and decode's times beside the generic scan's at B
      = 1, 8 and 64.

    Returns what phase 5 needs."""
    from acids_transforms_tpu_torch import streaming
    from acids_transforms_tpu_torch import transforms as T

    ss, sx, route, generic, sgen = (stream[k] for k in ("ss", "sx", "route", "generic", "sgen"))
    SB, SL, CH = sx.shape[0], STREAM_LEN, STREAM_CHUNK
    T_C = CH // HOP
    n_chunks = SL // CH
    delay = N_FFT - HOP
    log(f"[4g] streaming pghi_gl (session O) on {SB} mono sessions of {SL} samples, chunks of {CH}")

    def gl_chain(kind, la=0, n_fft=N_FFT, hop=HOP):
        rt_t = T.RealtimeDGT if kind == "dgt" else T.RealtimeSTFT
        return T.OverlapAdd(n_fft, hop) + rt_t(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl",
                                               lookahead_frames=la)

    h_chain, d_chain = gl_chain("hann"), gl_chain("dgt")
    iters = h_chain[1].gl_iterations

    def expect(encode):
        # one polish launch a chunk (all 16 projections), no two-launch projection
        d = {"rt_pghi_seeded": n_chunks, "gl_polish": n_chunks, "session_random_decode": 1}
        return dict(d, session_magnitude=1) if encode else d

    win = torch.hann_window(N_FFT, device=dev)

    def sc_roundtrip(x, extra=0, n_fft=N_FFT, hop=HOP, length=None):
        """Spectral convergence of a roundtrip's output against its input,
        after the ``(overlap - 1 + extra) hop`` delay (``bench.py:566-575``)."""
        w = win if n_fft == N_FFT else torch.hann_window(n_fft, device=dev)
        n = x.shape[-1] if length is None else length
        d = n_fft - hop + extra * hop

        def spec(v):
            return torch.stft(v, n_fft, hop, window=w, center=True, pad_mode="reflect",
                              return_complex=True).abs()
        ref = spec(x[..., : n - d])

        def sc(y):
            m = spec(y[..., d:n])
            k = min(m.shape[-1], ref.shape[-1]) - 2
            return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()
        return sc

    quality, g_times = {}, {}

    def sc_pair(label, kernel_fn, generic_fn, launches, sc, seed, key=None):
        y1 = route(label, lambda: kernel_fn(sgen(seed)), launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y2 = generic(label, lambda: generic_fn(sgen(seed)))
        g_ms = 1e3 * (time.perf_counter() - t0)
        s1, s2 = sc(y1), sc(y2)
        log(f"    kernel route vs generic scan (same seed; the scan {g_ms:.0f} ms): rel {rel_err(y1, y2):.3e}; "
            f"spectral convergence kernel {s1:.5f}, generic {s2:.5f} (must be <= {1.1 * s2 + 1e-3:.5f})")
        require(tuple(y1.shape) == tuple(y2.shape) and torch.isfinite(y1).all().item(), f"{label}: bad output")
        require(s1 <= 1.1 * s2 + 1e-3, f"{label}: converges worse than the generic scan")
        if key is not None:
            g_times[key] = g_ms
        return s1, s2

    sc_rt = sc_roundtrip(sx)
    for name, chain, seed in (("hann", h_chain, 110), ("dgt", d_chain, 120)):
        rt = chain[1]
        f_chain = chain + T.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT)
        # the eager step on the card: the pinned-context carry
        st = chain.init_state((2,))
        st, fr = chain.step(st, sx[:2, :CH])
        st, y_e = chain.step_invert(st, fr.abs(), generator=sgen(seed))
        require(torch.isfinite(y_e).all().item()
                and set(st[1]) == {"mag_buffer", "phase_buffer", "gl_mag", "gl_phase"},
                f"{name}: the eager pghi_gl step failed")
        quality[f"sc_{name}_roundtrip"] = sc_pair(
            f"{name} pghi_gl roundtrip: scan_roundtrip(pghi_gl)",
            lambda g: streaming.scan_roundtrip(chain, sx, CH, "pghi_gl", generator=g),
            lambda g: streaming.scan_roundtrip(chain, sx, CH, "pghi_gl", generator=g, backend="generic"),
            expect(True), sc_rt, seed + 1, key=(f"{name} pghi_gl roundtrip", SB))
        mags = rt_stream["dec_mags"][name]
        quality[f"sc_{name}_decode"] = sc_pair(
            f"{name} pghi_gl decode: scan_invert(pghi_gl) of {tuple(mags.shape)} offline magnitudes",
            lambda g: streaming.scan_invert(chain, mags, T_C, "pghi_gl", generator=g),
            lambda g: streaming.scan_invert(chain, mags, T_C, "pghi_gl", generator=g, backend="generic"),
            expect(False), rt_stream["sc_dec_of"](mags, rt.window), seed + 2, key=(f"{name} pghi_gl decode", SB))
        quality[f"sc_{name}_3chain"] = sc_pair(
            f"{name} 3-chain [.., Magnitude] pghi_gl roundtrip",
            lambda g: streaming.scan_roundtrip(f_chain, sx, CH, "pghi_gl", generator=g),
            lambda g: streaming.scan_roundtrip(f_chain, sx, CH, "pghi_gl", generator=g, backend="generic"),
            expect(True), sc_rt, seed + 3)
    la_chain = gl_chain("hann", 4)
    quality["sc_hann_roundtrip_la4"] = sc_pair(
        "hann pghi_gl roundtrip, lookahead 4", 
        lambda g: streaming.scan_roundtrip(la_chain, sx, CH, "pghi_gl", generator=g),
        lambda g: streaming.scan_roundtrip(la_chain, sx, CH, "pghi_gl", generator=g, backend="generic"),
        expect(True), sc_roundtrip(sx, extra=4), 131)
    # B = 1 and 8 too: the hann roundtrip at lookahead 0 and 4 and the decode
    dm = rt_stream["dec_mags"]["hann"]
    for b in sorted({1, 8} - {SB}):
        xb, mb = sx[:b].contiguous(), dm[:b].contiguous()
        quality[f"sc_hann_roundtrip_B{b}"] = sc_pair(
            f"hann pghi_gl roundtrip at B={b}",
            lambda g: streaming.scan_roundtrip(h_chain, xb, CH, "pghi_gl", generator=g),
            lambda g: streaming.scan_roundtrip(h_chain, xb, CH, "pghi_gl", generator=g, backend="generic"),
            expect(True), sc_roundtrip(xb), 160 + b, key=("hann pghi_gl roundtrip", b))
        quality[f"sc_hann_decode_B{b}"] = sc_pair(
            f"hann pghi_gl decode at B={b}",
            lambda g: streaming.scan_invert(h_chain, mb, T_C, "pghi_gl", generator=g),
            lambda g: streaming.scan_invert(h_chain, mb, T_C, "pghi_gl", generator=g, backend="generic"),
            expect(False), rt_stream["sc_dec_of"](mb, h_chain[1].window), 170 + b, key=("hann pghi_gl decode", b))
        quality[f"sc_hann_roundtrip_la4_B{b}"] = sc_pair(
            f"hann pghi_gl roundtrip, lookahead 4, at B={b}",
            lambda g: streaming.scan_roundtrip(la_chain, xb, CH, "pghi_gl", generator=g),
            lambda g: streaming.scan_roundtrip(la_chain, xb, CH, "pghi_gl", generator=g, backend="generic"),
            expect(True), sc_roundtrip(xb, extra=4), 180 + b)
    # a grid that the polish's block cannot hold (4096/1024, gl_context 1,
    # chunks of 40 frames: 44 grid frames, 271 KB even with the grid in
    # device memory) keeps the two-launch projections, here on the decode's
    # and the analysis's FFT routes; these launches are the Osyn and
    # Oana_fft rows' counts
    fb_n, fb_hop, fb_ctx, fb_tc = 4096, 1024, 1, 40
    fb_chain = T.OverlapAdd(fb_n, fb_hop) + T.RealtimeSTFT(n_fft=fb_n, hop_length=fb_hop, inversion_mode="pghi_gl",
                                                         gl_context=fb_ctx)
    fb_chunk, fb_chunks = fb_tc * fb_hop, 4
    fb_x = sx[:2, : fb_chunks * fb_chunk].contiguous()
    fb_tp = fb_ctx + fb_tc + fb_n // fb_hop - 1
    require(ss._polish_plan(fb_n, fb_hop, fb_tp) is None and ss.kernel_covers("project", fb_n, fb_hop, fb_tc, fb_ctx),
            "4096/1024 with gl_context 1: the polish must refuse the grid and the two-launch route take it")
    fb_expect = {"session_magnitude": 1, "rt_pghi_seeded": fb_chunks, "gl_project_synthesis": fb_chunks * iters,
                 "gl_project_analysis": fb_chunks * iters, "session_random_decode": 1}
    fb_sc = sc_roundtrip(fb_x, n_fft=fb_n, hop=fb_hop)
    y1 = route(f"two-launch polish: {fb_n}/{fb_hop} gl_context {fb_ctx} pghi_gl roundtrip, 2 x {fb_x.shape[-1]}",
               lambda: streaming.scan_roundtrip(fb_chain, fb_x, fb_chunk, "pghi_gl", generator=sgen(190)),
               fb_expect, main=False)
    y2 = generic("two-launch polish generic", lambda: streaming.scan_roundtrip(
        fb_chain, fb_x, fb_chunk, "pghi_gl", generator=sgen(190), backend="generic"))
    s1, s2 = fb_sc(y1), fb_sc(y2)
    log(f"    vs the generic scan (same seed): rel {rel_err(y1, y2):.3e}; spectral convergence {s1:.5f} / {s2:.5f} "
        f"(must be <= {1.1 * s2 + 1e-3:.5f})")
    require(y1.shape == y2.shape and torch.isfinite(y1).all().item() and s1 <= 1.1 * s2 + 1e-3,
            "the two-launch polish converges worse than the generic scan")
    for k in ("gl_project_synthesis", "gl_project_synthesis:fft", "gl_project_analysis", "gl_project_analysis:fft"):
        counts[k] += fb_chunks * iters
    # the same session with the analysis on the product route it took before
    # (session_route forced to "product" for it), in turns old, new, new, old,
    # host clock to the card's end, warm
    fb_turns = {"product": [], "fft": []}
    for turn in ("product", "fft", "fft", "product"):
        with analysis_on_product(ss, turn == "product"):
            fb_turns[turn].append(time_ms(lambda: streaming.scan_roundtrip(
                fb_chain, fb_x, fb_chunk, "pghi_gl", generator=sgen(190)), 1, 1))
    log(f"    {fb_n}/{fb_hop} pghi_gl roundtrip with the analysis on the product route vs the FFT route, in turns "
        f"old, new, new, old (host clock, one call alone, warm): "
        f"{' / '.join(f'{v:.2f}' for v in fb_turns['product'])} -> {' / '.join(f'{v:.2f}' for v in fb_turns['fft'])} ms")
    del y1, y2
    pq = rt_stream["quality"]
    log("  pghi_gl against pghi on the same sessions (kernel routes; spectral convergence): "
        + ", ".join(f"{k} pghi_gl {quality[k][0]:.5f} / pghi {pq[k][0]:.5f}"
                    for k in ("sc_hann_roundtrip", "sc_hann_decode", "sc_dgt_roundtrip", "sc_dgt_decode"))
        + f"; hann roundtrip at lookahead 4 {quality['sc_hann_roundtrip_la4'][0]:.5f}")

    # each new kernel against its plain version on identical inputs
    def unit(mag, phase):
        ph = phase.double()
        return torch.stack([mag * torch.cos(ph), mag * torch.sin(ph)]) / mag.abs().max().clamp_min(1e-30)

    def check_kernels(label, chain, x, chunk, seed):
        rt = chain[1]
        n_fft, hop = rt.n_fft, rt.hop_length
        ov, Fb, T_c = n_fft // hop, n_fft // 2 + 1, chunk // hop
        ctx, la = rt.gl_context, rt.lookahead_frames
        Tt = T_c + la
        B = x.shape[0]
        g = sgen(seed)
        mag = ss.make_fused_magnitude_session(chain, chunk)(x)
        # the seeded recurrence: chunk 1's T_c + la frames after chunk 0's carries
        prev, m = mag[:, T_c - 2: T_c].contiguous(), mag[:, T_c: T_c + Tt].contiguous()
        pp = (2 * torch.rand((B, Fb), generator=g, device=dev) - 1) * math.pi
        a = ss.session_angles((B,), 1, Tt, Fb, dev, g)
        r_args = (rt.gamma, n_fft, hop, rt.tolerance, Tt)
        ph_k = ss.rt_pghi_phases(m, a, *r_args, prev_mag=prev, prev_phase=pp)
        ph_p = ss.rt_pghi_phases_reference(m, a, *r_args, prev_mag=prev, prev_phase=pp)
        e_rt = (unit(m, ph_k) - unit(m, ph_p)).abs().max().item()
        differ = (ph_k != ph_p).float().mean().item()
        # one projection of the grid [ctx pinned; those frames; overlap - 1 zero]
        tail = mag.new_zeros((B, ov - 1, Fb))
        gm = torch.cat([mag[:, T_c - ctx: T_c], m, tail], 1).contiguous()
        gp = torch.cat([(2 * torch.rand((B, ctx, Fb), generator=g, device=dev) - 1) * math.pi, ph_k, tail],
                       1).contiguous()
        lo, hi = rt.gl_frozen(T_c)
        syn = ss._decode_operands(rt.inv_window, float(ov), n_fft, hop)
        WC, WS = ss._ana_basis(rt.window, n_fft, ss._k_analysis(n_fft))
        y_k = ss._launch_decode(gm, gp, syn, n_fft, hop, rows=ss.PROJECT_SYN_ROWS, name="gl_project_synthesis")
        y_p = ss._synthesis_reference(gm * torch.cos(gp), gm * torch.sin(gp), rt.inv_window, float(ov), n_fft,
                                      hop, gm.shape[1])
        p_k = ss.gl_project(gm, gp.clone(), syn, rt.inv_window, rt.window, WC, WS, n_fft, hop, ctx, lo, hi)
        p_p = ss.gl_project_reference(gm, gp, rt.inv_window, rt.window, n_fft, hop, ctx, lo, hi)
        e_syn, e_pr = rel_err(y_k, y_p), (unit(gm, p_k) - unit(gm, p_p)).abs().max().item()
        kept = torch.equal(p_k[:, :ctx], gp[:, :ctx]) and torch.equal(p_k[:, lo:hi], gp[:, lo:hi])
        # the polish of that grid, gl_iterations projections in one launch,
        # against its plain version and against as many two-launch
        # projections (both bit-identical: the polish's synthesis is P's and
        # its analysis the FFT-route analysis's frames_rfft with its pairs)
        iters_o = rt.gl_iterations
        q_k = ss.gl_polish(gm, gp.clone(), syn, rt.inv_window, rt.window, None, None, n_fft, hop, ctx, lo, hi, iters_o)
        q_p = ss.gl_polish_reference(gm, gp, rt.inv_window, rt.window, n_fft, hop, ctx, lo, hi, iters_o)
        q_two = gp.clone()
        for _ in range(iters_o):
            q_two = ss.gl_project(gm, q_two, syn, rt.inv_window, rt.window, WC, WS, n_fft, hop, ctx, lo, hi)
        e_pol = (unit(gm, q_k) - unit(gm, q_p)).abs().max().item()
        e_two = (unit(gm, q_k) - unit(gm, q_two)).abs().max().item()
        same_pol, same_two = torch.equal(q_k, q_p), torch.equal(q_k, q_two)
        kept = kept and torch.equal(q_k[:, :ctx], gp[:, :ctx]) and torch.equal(q_k[:, lo:hi], gp[:, lo:hi])
        # the whole session against the plain session on the same magnitudes and angles
        n_ch = mag.shape[1] // T_c
        ang = ss.session_angles((B,), n_ch, Tt, Fb, dev, g)
        y_s = ss.make_fused_pghi_gl_roundtrip(chain, chunk, angles=ang)(x)
        y_sp = ss.session_pghi_gl_reference(mag, ang, rt, float(chain[0].gain_compensation), T_c, mag.shape[1])
        torch.cuda.synchronize()
        sc = sc_roundtrip(x, extra=la, n_fft=n_fft, hop=hop)
        s_k, s_p = sc(y_s), sc(y_sp)
        log(f"  kernels vs plain, {label}: seeded recurrence |X| (cos, sin)(phase) off by {e_rt:.3e} (tol "
            f"1e-04; {100 * differ:.4f}% of bins differ); projection synthesis rel {e_syn:.3e} (tol 2e-05), "
            f"projection {e_pr:.3e} (tol 1e-04), polish of {iters_o} bit-identical to its plain version: {same_pol} "
            f"({e_pol:.3e}), {iters_o} two-launch projections bit-identical to it: {same_two} ({e_two:.3e}), "
            f"pinned and frozen "
            f"rows kept: {kept}; session vs plain session "
            f"rel {rel_err(y_s, y_sp):.3e}, spectral convergence {s_k:.5f} / {s_p:.5f} (must be <= "
            f"{1.1 * s_p + 1e-3:.5f})")
        for what, out in (("recurrence", ph_k), ("synthesis", y_k), ("projection", p_k), ("session", y_s)):
            require(torch.isfinite(out).all().item(), f"{what} {label}: not finite")
        require(y_s.shape == y_sp.shape and p_k.shape == gp.shape, f"{label}: shapes")
        require(e_rt <= 1e-4 and e_syn <= 2e-5 and e_pr <= 1e-4 and kept and s_k <= 1.1 * s_p + 1e-3
                and same_pol and same_two and torch.isfinite(q_k).all().item(),
                f"{label}: an O kernel disagrees with its plain version")
        errs["Opol"] = max(errs.get("Opol", 0.0), e_pol)
        errs["RTs"] = max(errs.get("RTs", 0.0), e_rt)
        errs["Osyn"] = max(errs.get("Osyn", 0.0), abs_err(y_k, y_p))
        errs["Oana_fft"] = max(errs.get("Oana_fft", 0.0), e_pr)
        return dict(mag=mag, m=m, prev=prev, pp=pp, a=a, gm=gm, gp=gp, lo=lo, hi=hi, syn=syn, WC=WC, WS=WS,
                    y=y_k, rt=rt)

    main = check_kernels(f"main shape hann {SB} x {SL}", h_chain, sx, CH, 140)
    check_kernels(f"main shape dgt, lookahead 4 {SB} x {SL}", gl_chain("dgt", 4), sx, CH, 141)
    check_kernels(f"main shape hann, lookahead 4 {SB} x {SL}", la_chain, sx, CH, 142)
    small3, small2 = sx[:3, :20000].contiguous(), sx[:2, :30000].contiguous()
    for la in (0, 4):
        check_kernels(f"512/128 hann, lookahead {la}, 3 x 20000 (ragged)", gl_chain("hann", la, 512, 128),
                      small3, 2048, 143 + la)
        check_kernels(f"2048/512 dgt, lookahead {la}, 2 x 30000 (ragged)", gl_chain("dgt", la, 2048, 512),
                      small2, 4096, 144 + la)

    # the routes through the entry points beside the generic scan, B = 1, 8, 64
    log("  route times (CUDA events around the entry point; kernel route median of 3, generic scan one run)")
    route_ms = {}
    dm = rt_stream["dec_mags"]["hann"]
    for b in sorted({1, 8, SB}):
        xb, mb = sx[:b], dm[:b]
        rows = (
            ("hann pghi_gl roundtrip", lambda g: streaming.scan_roundtrip(h_chain, xb, CH, "pghi_gl", generator=g),
             lambda g: streaming.scan_roundtrip(h_chain, xb, CH, "pghi_gl", generator=g, backend="generic")),
            ("hann pghi_gl decode", lambda g: streaming.scan_invert(h_chain, mb, T_C, "pghi_gl", generator=g),
             lambda g: streaming.scan_invert(h_chain, mb, T_C, "pghi_gl", generator=g, backend="generic")),
        )
        for name, kfn, gfn in rows:
            k_ms = time_ms(lambda: kfn(sgen(199)), 3, 1)
            g_ms = g_times[(name, b)] if (name, b) in g_times else time_ms(lambda: gfn(sgen(199)), 1, 0)
            route_ms[(name, b)] = (k_ms, g_ms)
            log(f"    B={b:3d} {name:22s}: {k_ms:9.3f} ms / {g_ms:9.3f} ms ({g_ms / k_ms:.2f}x)")
    log("  pghi_gl stream quality: " + json.dumps(
        {k: [round(v, 6) for v in val] for k, val in quality.items()}))
    pr = rt_stream["route_ms"]
    log("  kernel route times, pghi beside pghi_gl (the same sessions, ms): " + "; ".join(
        f"B={b} {kind} {pr[('hann pghi ' + kind, b)][0]:.3f} / {route_ms[('hann pghi_gl ' + kind, b)][0]:.3f}"
        for b in sorted({1, 8, SB}) for kind in ("roundtrip", "decode")))
    return main


def structure_phase(dev, mono, stream, wrappers, errs, counts):
    """Phase 4h: the dispatch at shapes outside the JAX package's gates, and
    the smooth and product routes of the encode, the decodes, the full-K
    kernels (E, F, J, K's synthesis, G, H) and the Griffin-Lim steps.

    * Shapes that neither the JAX package's gates nor the port's kernels
      cover run the eager route on the card, as the JAX package runs them on
      a TPU, with no kernel launch, and match the same call on a CPU tensor:
      ``STFT(1024, 300)`` (hop does not divide n_fft) in ``pghi`` within 1e-4
      relative (``pghi_scan`` and the ISTFT, float32 in another order on the
      two devices) and in ``pghi_gl`` by spectral convergence within ``1.1 s
      + 1e-3`` of the CPU's (its Griffin-Lim loop is a chaotic map that
      amplifies the seed's rounding differences: tests/test_gl_parity.py
      measures 1e-7 -> 1.3e-4 in five iterations, and the default runs 32);
      the ``OverlapAdd(1000, 250) + RealtimeSTFT(1000, 250)`` session (hop %
      4 != 0 and no JAX layout: the generic scan; encode and complex
      roundtrip within 1e-4 of the CPU's).
    * Shapes whose layout the JAX package refuses but the port's kernels take
      stay on the kernels: ``STFT(1200, 300)`` in ``pghi`` launches K (the
      recurrence and the synthesis, on the smooth route; K against its plain
      versions there as in phase 3), and the ``OverlapAdd(1200, 300) +
      RealtimeSTFT(1200, 300)``
      sessions launch L (complex roundtrip, within 1e-4 of the CPU's generic
      scan, SNR at least 100 dB after the delay), N (``pghi``) and O
      (``pghi_gl``), each against the card's generic scan under a generator
      in the same state by spectral convergence within ``1.1 s + 1e-3``.
      Their encode (``scan_forward``), magnitude encodes, L, M, the
      decodes (S, P) and O's polish (one launch a chunk) take the smooth
      route (1200 = 2^4 3 5^2): those launches are the smooth rows' counts.
      A 3072/768 ``pghi_gl`` session with chunks of 40 frames (a 46-frame
      grid no polish block holds) runs the two-launch projection, its
      synthesis and its analysis on the smooth route, as a 2560/1280 one
      with 39-frame chunks and, on their radix-7 instances, a 3584/896 one
      with 40-frame chunks and ``gl_context`` 1: the counts of O's smooth
      synthesis and analysis.  The same sessions at 1344/336 (2^6 3 7), the
      complex decode and ``pghi_gl`` among them, run R, L, M, the magnitude
      encode, the decodes and O's polish on the smooth route's radix-7
      instances (those rows' counts; the ``pghi_gl`` roundtrip timed in
      turns with the two-launch route it took before), all within 1e-4 of
      the generic scan or by spectral convergence against it; at 1408/352
      (2^7 11) the complex and random roundtrips, the encode, the decodes
      and the ``pghi`` and ``pghi_gl`` roundtrips run R, L, M, the magnitude
      encode, P, S and O's two-launch projection on the product route: those
      rows' counts.
    * E and F on the smooth route through the entry points: the DGT
      magnitude chain at 768/256 (``fuse_fit`` + ``fuse_forward`` on up to 16
      clips), its fit and forward within 1e-5 / 1e-4 of the eager chain's, as
      phase 4b holds the main shape; A and B likewise through the
      STFT(768, 192) log-mel chain; the same two chains at 896/224 (2^7 7)
      put E, F, A and B on the smooth route's radix-7 instance (timed in
      turns with the product and factored routes 896 took before), at
      1408/352 (2^7 11) E and F on the product route and A and B on the
      factored one.
      The Griffin-Lim invert of an ``STFT(768, 192)`` takes C and D's smooth
      route, of an ``STFT(896, 224)`` their product route; the 768/256
      chain's ``pghi_gl`` invert takes J's smooth route, the 896/224 chain's
      J's radix-7 instance (counted ``:smooth7``, timed in turns with the
      product route 896 took before), the 1408/352 chain's J's product
      route, and the 768/256 ``pghi`` invert K's synthesis's smooth route,
      the 896/224 one its radix-7 instance (``:smooth7``, timed in turns
      likewise), the 1408/352 one its product route, each converging like
      the eager route; G and H full-K
      through ``DGT(768, 256) + PolarIF``'s fit and forward (the smooth
      route), ``DGT(896, 224) + PolarIF``'s (its radix-7 instance, counted
      ``:smooth7``, timed in turns with the product route 896 took before)
      and ``DGT(1408, 352) + PolarIF``'s (product), G and H with taps
      through the STFT + Polar chains at the same shapes (factored at
      1408), the magnitude's fit and channel 1 against the eager chain."""
    from acids_transforms_tpu_torch import streaming
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as pk

    sgen, route, generic = stream["sgen"], stream["route"], stream["generic"]
    t_start = time.perf_counter()
    log("[4h] the dispatch outside the JAX package's gates: the eager route where no kernel covers the shape, "
        "the kernels where they do")

    def zero():
        for w in wrappers:
            w.reset_launches()

    def launched():
        return sum(sum(w.launches.values()) for w in wrappers)

    x = mono[:4, :44100].contiguous()
    for mode in ("pghi", "pghi_gl"):
        st_c = T.STFT(n_fft=1024, hop_length=300, inversion_mode=mode)
        st_p = T.STFT(n_fft=1024, hop_length=300, inversion_mode=mode, device="cpu")
        mag = st_c(x).abs()
        ang = 2 * math.pi * torch.rand(mag.shape, generator=sgen(150), device=dev)
        zero()
        y_c = st_c.invert(mag, angles=ang)
        torch.cuda.synchronize()
        n_l = launched()
        y_p = st_p.invert(mag.cpu(), angles=ang.cpu())

        def sc(y):
            R = st_p(y.cpu()).abs()
            n = min(R.shape[-2], mag.shape[-2])
            return (torch.linalg.norm(R[:, :n] - mag.cpu()[:, :n]) / torch.linalg.norm(mag.cpu()[:, :n])).item()
        s_c, s_p = sc(y_c), sc(y_p)
        e = rel_err(y_c.cpu(), y_p)
        need = "rel <= 1e-04" if mode == "pghi" else f"spectral convergence <= {1.1 * s_p + 1e-3:.5f}"
        log(f"  STFT(1024, 300) {mode}: launches {n_l}; card vs CPU rel {e:.3e}, spectral convergence "
            f"{s_c:.5f} / {s_p:.5f} (must be {need})")
        require(n_l == 0 and y_c.shape == y_p.shape and torch.isfinite(y_c).all().item(),
                f"STFT(1024, 300) {mode}: launched a kernel or bad output")
        ok = e <= 1e-4 if mode == "pghi" else s_c <= 1.1 * s_p + 1e-3
        require(ok, f"STFT(1024, 300) {mode}: the card's eager route differs from the CPU's")
    xs = mono[:4, :40000].contiguous()
    c_c = T.OverlapAdd(1000, 250) + T.RealtimeSTFT(n_fft=1000, hop_length=250)
    c_p = T.OverlapAdd(1000, 250, device="cpu") + T.RealtimeSTFT(n_fft=1000, hop_length=250, device="cpu")
    require(streaming.plan_roundtrip(c_c, tuple(xs.shape), 2000, device=dev) == "generic"
            and streaming.plan_forward(c_c, tuple(xs.shape), 2000, device=dev) == "generic",
            "RealtimeSTFT(1000, 250) must plan the generic scan")
    zero()
    y_c = streaming.scan_roundtrip(c_c, xs, 2000)
    f_c, _ = streaming.scan_forward(c_c, xs, 2000)
    torch.cuda.synchronize()
    n_l = launched()
    y_p = streaming.scan_roundtrip(c_p, xs.cpu(), 2000)
    f_p, _ = streaming.scan_forward(c_p, xs.cpu(), 2000)
    e_y, e_f = rel_err(y_c.cpu(), y_p), crel(f_c.cpu(), f_p)
    log(f"  OverlapAdd(1000, 250) + RealtimeSTFT(1000, 250) session: launches {n_l}; card vs CPU: complex "
        f"roundtrip rel {e_y:.3e}, encode rel {e_f:.3e} (tol 1e-04)")
    require(n_l == 0 and e_y <= 1e-4 and e_f <= 1e-4, "RealtimeSTFT(1000, 250): the card differs from the CPU")

    # 1200 / 300: no JAX layout (neither n_fft nor hop a multiple of 128), hop % 4 == 0
    n_fft, hop, chunk = 1200, 300, 2400
    st = T.STFT(n_fft=n_fft, hop_length=hop, inversion_mode="pghi")
    mag = st(x).abs()
    ang = 2 * math.pi * torch.rand(mag.shape, generator=sgen(151), device=dev)
    require(pk.pghi_dispatch("pghi", n_fft, hop) == "fused", "STFT(1200, 300) must dispatch to K")
    zero()
    y_k = st.invert(mag, angles=ang)
    torch.cuda.synchronize()
    got, n_l = {k: v for k, v in pk.launches.items() if v}, launched()
    y_f = pk.pghi_invert_fused(mag, st.gamma, n_fft, hop, st.inv_window, tolerance=st.tolerance, angles=ang)
    log(f"  STFT(1200, 300) pghi: launches {got}; the same as pghi_invert_fused: {torch.equal(y_k, y_f)}")
    require(got == {"pghi_plan": 1, "pghi_phases": 1, "pghi_synthesize": 1} and n_l == 3 and torch.equal(y_k, y_f)
            and pk.routes["pghi_synthesize:smooth"] == 2, "STFT(1200, 300) pghi must run K, its synthesis "
            "on the smooth route")
    counts["pghi_synthesize:smooth"] += 1
    check_pghi("1200/300", mag, n_fft, hop, st.inv_window, st.gamma, 152, errs)
    xs = mono[:4, :8 * chunk].contiguous()
    chain = T.OverlapAdd(n_fft, hop) + T.RealtimeSTFT(n_fft=n_fft, hop_length=hop)
    c_p = T.OverlapAdd(n_fft, hop, device="cpu") + T.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu")
    n_ch = xs.shape[-1] // chunk
    y_c = route("1200/300 complex roundtrip (the smooth route)", lambda: streaming.scan_roundtrip(chain, xs, chunk),
                {"session_roundtrip": 1}, main=False, front="smooth")
    # R on the smooth route (n_fft 1200 = 2^4 3 5^2), counted for its row
    f_c, _ = route("1200/300 encode: scan_forward (the smooth route)",
                   lambda: streaming.scan_forward(chain, xs, chunk), {"session_encode": 1}, main=False,
                   front="smooth")
    f_p, _ = streaming.scan_forward(c_p, xs.cpu(), chunk)
    e_f = crel(f_c.cpu(), f_p)
    log(f"    the session vs the CPU's generic scan: rel {e_f:.3e} (tol 1e-04)")
    require(e_f <= 1e-4, "1200/300 encode: the session differs from the generic scan")
    y_p = streaming.scan_roundtrip(c_p, xs.cpu(), chunk)
    e_y = rel_err(y_c.cpu(), y_p)

    def snr_db_of(x, y, n_fft, hop, chunk):
        d, n = n_fft - hop, x.shape[-1]
        ref, out = x[..., : n - d - chunk], y[..., d: n - chunk]
        return 10 * math.log10((ref ** 2).sum().item() / max(((out - ref) ** 2).sum().item(), 1e-300))
    snr_c = snr_db_of(xs, y_c, n_fft, hop, chunk)
    log(f"    the session vs the CPU's generic scan: rel {e_y:.3e} (tol 1e-04); SNR after the delay {snr_c:.2f} dB "
        f"(must be >= 100)")
    require(e_y <= 1e-4 and snr_c >= 100.0, "1200/300 complex roundtrip: the session differs from the generic scan")
    # S on the smooth route: the complex decode of that encode, against the
    # CPU's generic scan
    y_s = route("1200/300 complex decode: scan_invert (the smooth route)",
                lambda: streaming.scan_invert(chain, f_c, chunk // hop), {"session_complex_decode": 1}, main=False,
                front="smooth")
    e_s = rel_err(y_s.cpu(), streaming.scan_invert(c_p, f_c.cpu(), chunk // hop))
    log(f"    the session vs the CPU's generic scan: rel {e_s:.3e} (tol 1e-04)")
    require(torch.isfinite(y_s).all().item() and e_s <= 1e-4,
            "1200/300 complex decode: the session differs from the generic scan")
    # M on the smooth route, against the card's generic scan with a generator in the same state
    y_m = route("1200/300 random roundtrip (the smooth route)",
                lambda: streaming.scan_roundtrip(chain, xs, chunk, "random", generator=sgen(154)),
                {"session_random_roundtrip": 1}, main=False, front="smooth")
    y_mg = generic("1200/300 random generic", lambda: streaming.scan_roundtrip(
        chain, xs, chunk, "random", generator=sgen(154), backend="generic"))
    e_m = rel_err(y_m, y_mg)
    log(f"    the session vs the generic scan (same seed): rel {e_m:.3e} (tol 1e-04)")
    require(y_m.shape == y_mg.shape and torch.isfinite(y_m).all().item() and e_m <= 1e-4,
            "1200/300 random roundtrip: the session differs from the generic scan")
    del y_m, y_mg
    sw = torch.hann_window(n_fft, device=dev)

    def sc(y, extra=0):
        d = n_fft - hop + extra * hop
        n = xs.shape[-1]

        def spec(v):
            return torch.stft(v, n_fft, hop, window=sw, center=True, pad_mode="reflect", return_complex=True).abs()
        ref, m = spec(xs[..., : n - d]), spec(y[..., d:n])
        k = min(m.shape[-1], ref.shape[-1]) - 2
        return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()

    # pghi_gl: one smooth polish launch a chunk (all gl_iterations
    # projections), no two-launch projection
    for mode, expect in (
        ("pghi", {"session_magnitude": 1, "rt_pghi_phases": 1, "session_random_decode": 1}),
        ("pghi_gl", {"session_magnitude": 1, "rt_pghi_seeded": n_ch, "gl_polish": n_ch,
                     "session_random_decode": 1}),
    ):
        require(streaming.plan_roundtrip(chain, tuple(xs.shape), chunk, mode, device=dev) == mode,
                f"1200/300 {mode}: must plan the session")
        y_k = route(f"1200/300 {mode} roundtrip (the smooth route)",
                    lambda: streaming.scan_roundtrip(chain, xs, chunk, mode, generator=sgen(153)), expect,
                    main=False, front="smooth")
        y_g = generic(f"1200/300 {mode} generic", lambda: streaming.scan_roundtrip(
            chain, xs, chunk, mode, generator=sgen(153), backend="generic"))
        s_k, s_g = sc(y_k), sc(y_g)
        log(f"    vs the generic scan: rel {rel_err(y_k, y_g):.3e}; spectral convergence {s_k:.5f} / {s_g:.5f} "
            f"(must be <= {1.1 * s_g + 1e-3:.5f})")
        require(y_k.shape == y_g.shape and torch.isfinite(y_k).all().item() and s_k <= 1.1 * s_g + 1e-3,
                f"1200/300 {mode}: the session converges worse than the generic scan")
        if mode == "pghi_gl":
            t_w = time_ms(lambda: streaming.scan_roundtrip(chain, xs, chunk, mode, generator=sgen(153)), 3, 1)
            log(f"    1200/300 pghi_gl roundtrip on the smooth polish ({n_ch} polish launches), warm (median of 3): "
                f"{t_w:.2f} ms; the first call is the line above (the two-launch route's first call: 18.9 ms, "
                "PERF.md section 6)")
    # a smooth grid that the polish's block cannot hold keeps the two-launch
    # projection, its synthesis on the decode's smooth instance and its
    # analysis on the smooth route: 3072/768 (2^10 3) with chunks of 40
    # frames and gl_context 3 (46 grid frames, 233 KB even with the grid in
    # device memory); these launches are the Osyn_smooth and Oana_smooth
    # rows' counts
    n_t, hop_t, tc_t = 3072, 768, 40
    chunk_t = tc_t * hop_t
    xs_t = mono[:2, : 4 * chunk_t].contiguous()
    chain_t = T.OverlapAdd(n_t, hop_t) + T.RealtimeSTFT(n_fft=n_t, hop_length=hop_t, inversion_mode="pghi_gl")
    n_cht, iters_t = xs_t.shape[-1] // chunk_t, chain_t[1].gl_iterations
    tp_t = chain_t[1].gl_context + tc_t + n_t // hop_t - 1
    require(stream["ss"].session_route(n_t, "polish") == "smooth" and stream["ss"]._polish_plan(n_t, hop_t, tp_t) is None
            and stream["ss"].kernel_covers("project", n_t, hop_t, tc_t, chain_t[1].gl_context),
            f"{n_t}/{hop_t}: the polish must refuse the {tp_t}-frame grid and the two-launch route take it")
    w_t = torch.hann_window(n_t, device=dev)

    def sc_t(y):
        d, n = n_t - hop_t, xs_t.shape[-1]

        def spec(v):
            return torch.stft(v, n_t, hop_t, window=w_t, center=True, pad_mode="reflect", return_complex=True).abs()
        ref, m = spec(xs_t[..., : n - d]), spec(y[..., d:n])
        k = min(m.shape[-1], ref.shape[-1]) - 2
        return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()
    y_t = route(f"{n_t}/{hop_t} pghi_gl roundtrip, {tc_t}-frame chunks (the two-launch projection, smooth route)",
                lambda: streaming.scan_roundtrip(chain_t, xs_t, chunk_t, "pghi_gl", generator=sgen(158)),
                {"session_magnitude": 1, "rt_pghi_seeded": n_cht, "gl_project_synthesis": n_cht * iters_t,
                 "gl_project_analysis": n_cht * iters_t, "session_random_decode": 1}, main=False, front="smooth")
    y_tg = generic(f"{n_t}/{hop_t} pghi_gl generic", lambda: streaming.scan_roundtrip(
        chain_t, xs_t, chunk_t, "pghi_gl", generator=sgen(158), backend="generic"))
    s_k, s_g = sc_t(y_t), sc_t(y_tg)
    log(f"    vs the generic scan: spectral convergence {s_k:.5f} / {s_g:.5f} (must be <= {1.1 * s_g + 1e-3:.5f})")
    require(y_t.shape == y_tg.shape and torch.isfinite(y_t).all().item() and s_k <= 1.1 * s_g + 1e-3,
            f"{n_t}/{hop_t} pghi_gl: the two-launch session converges worse than the generic scan")
    del y_t, y_tg

    def two_launch_session(n_s, hop_s, tc_s, ctx_s, n_chunks, seed, seven):
        """A pghi_gl roundtrip of 2 sessions whose grid no polish block holds,
        on the two-launch projection with its analysis on the smooth route
        (its radix-7 instance where ``seven``), against the generic scan by
        spectral convergence within 1.1 s + 1e-3."""
        chunk_s = tc_s * hop_s
        xs_s = mono[:2, : n_chunks * chunk_s].contiguous()
        chain_s = T.OverlapAdd(n_s, hop_s) + T.RealtimeSTFT(n_fft=n_s, hop_length=hop_s, inversion_mode="pghi_gl",
                                                             gl_context=ctx_s)
        iters_s = chain_s[1].gl_iterations
        tp_s = ctx_s + tc_s + n_s // hop_s - 1
        ssm = stream["ss"]
        require(ssm.session_route(n_s, "project") == "smooth" and ssm._polish_plan(n_s, hop_s, tp_s) is None
                and ssm.kernel_covers("project", n_s, hop_s, tc_s, ctx_s),
                f"{n_s}/{hop_s}: the polish must refuse the {tp_s}-frame grid and the two-launch route take it")
        w_s = torch.hann_window(n_s, device=dev)

        def sc_s(y):
            d, n = n_s - hop_s, xs_s.shape[-1]

            def spec(v):
                return torch.stft(v, n_s, hop_s, window=w_s, center=True, pad_mode="reflect",
                                  return_complex=True).abs()
            ref, m = spec(xs_s[..., : n - d]), spec(y[..., d:n])
            k = min(m.shape[-1], ref.shape[-1]) - 2
            return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()
        y_s = route(f"{n_s}/{hop_s} pghi_gl roundtrip, gl_context {ctx_s}, {tc_s}-frame chunks (the two-launch "
                    f"projection, its analysis on the smooth route{', radix 7' if seven else ''})",
                    lambda: streaming.scan_roundtrip(chain_s, xs_s, chunk_s, "pghi_gl", generator=sgen(seed)),
                    {"session_magnitude": 1, "rt_pghi_seeded": n_chunks, "gl_project_synthesis": n_chunks * iters_s,
                     "gl_project_analysis": n_chunks * iters_s, "session_random_decode": 1}, main=False,
                    front="smooth", seven=seven)
        y_sg = generic(f"{n_s}/{hop_s} pghi_gl generic", lambda: streaming.scan_roundtrip(
            chain_s, xs_s, chunk_s, "pghi_gl", generator=sgen(seed), backend="generic"))
        s_k, s_g = sc_s(y_s), sc_s(y_sg)
        log(f"    vs the generic scan: spectral convergence {s_k:.5f} / {s_g:.5f} (must be <= "
            f"{1.1 * s_g + 1e-3:.5f})")
        require(y_s.shape == y_sg.shape and torch.isfinite(y_s).all().item() and s_k <= 1.1 * s_g + 1e-3,
                f"{n_s}/{hop_s} pghi_gl: the two-launch session converges worse than the generic scan")

    # 3584/896 (2^9 7) with 40-frame chunks: the analysis's radix-7 instance;
    # 2560/1280 (2^9 5) with 39-frame chunks, a shape the card refused while
    # the analysis was a product of one block
    two_launch_session(3584, 896, 40, 1, 4, 161, True)
    two_launch_session(2560, 1280, 39, 3, 3, 162, False)

    # R, L, M, the magnitude encode, the decodes and O's polish on the smooth
    # route's radix-7 instances: the same sessions at 1344/336 (2^6 3 7: 28
    # ms at 48 kHz); the decodes within 1e-4 of the generic scan
    n_x, hop_x, chunk_x = 1344, 336, 2688
    xs_x = mono[:4, :8 * chunk_x].contiguous()
    chain_x = T.OverlapAdd(n_x, hop_x) + T.RealtimeSTFT(n_fft=n_x, hop_length=hop_x)
    c_px = T.OverlapAdd(n_x, hop_x, device="cpu") + T.RealtimeSTFT(n_fft=n_x, hop_length=hop_x, device="cpu")
    ssx = stream["ss"]
    require(ssx.session_route(n_x, "encode") == "smooth" and ssx.session_route(n_x, "roundtrip", hop_x) == "smooth"
            and ssx.session_route(n_x, "decode") == "smooth" and ssx.session_route(n_x, "polish") == "smooth"
            and ssx._polish_plan(n_x, hop_x, 3 + chunk_x // hop_x + n_x // hop_x - 1) is not None,
            "1344/336: the encodes, the roundtrips, the decodes and the polish must take the smooth route")
    y_x = route("1344/336 complex roundtrip (the smooth route, radix 7)",
                lambda: streaming.scan_roundtrip(chain_x, xs_x, chunk_x), {"session_roundtrip": 1}, main=False,
                front="smooth", seven=True)
    f_x, _ = route("1344/336 encode: scan_forward (the smooth route, radix 7)",
                   lambda: streaming.scan_forward(chain_x, xs_x, chunk_x), {"session_encode": 1}, main=False,
                   front="smooth", seven=True)
    e_fx = crel(f_x.cpu(), streaming.scan_forward(c_px, xs_x.cpu(), chunk_x)[0])
    e_yx = rel_err(y_x.cpu(), streaming.scan_roundtrip(c_px, xs_x.cpu(), chunk_x))
    snr_x = snr_db_of(xs_x, y_x, n_x, hop_x, chunk_x)
    log(f"    the sessions vs the CPU's generic scan: encode rel {e_fx:.3e}, complex roundtrip rel {e_yx:.3e} (tol "
        f"1e-04); SNR after the delay {snr_x:.2f} dB (must be >= 100)")
    require(e_fx <= 1e-4 and e_yx <= 1e-4 and snr_x >= 100.0, "1344/336: the sessions differ from the generic scan")
    y_sx = route("1344/336 complex decode: scan_invert (the smooth route, radix 7)",
                 lambda: streaming.scan_invert(chain_x, f_x, chunk_x // hop_x), {"session_complex_decode": 1},
                 main=False, front="smooth", seven=True)
    e_sx = rel_err(y_sx.cpu(), streaming.scan_invert(c_px, f_x.cpu(), chunk_x // hop_x))
    log(f"    the session vs the CPU's generic scan: rel {e_sx:.3e} (tol 1e-04)")
    require(torch.isfinite(y_sx).all().item() and e_sx <= 1e-4,
            "1344/336 complex decode: the session differs from the generic scan")
    y_mx = route("1344/336 random roundtrip (the smooth route, radix 7)",
                 lambda: streaming.scan_roundtrip(chain_x, xs_x, chunk_x, "random", generator=sgen(155)),
                 {"session_random_roundtrip": 1}, main=False, front="smooth", seven=True)
    e_mx = rel_err(y_mx, generic("1344/336 random generic", lambda: streaming.scan_roundtrip(
        chain_x, xs_x, chunk_x, "random", generator=sgen(155), backend="generic")))
    log(f"    the session vs the generic scan (same seed): rel {e_mx:.3e} (tol 1e-04)")
    require(torch.isfinite(y_mx).all().item() and e_mx <= 1e-4, "1344/336 random roundtrip: differs from the scan")
    w_x = torch.hann_window(n_x, device=dev)

    def sc_x(y):
        d, n = n_x - hop_x, xs_x.shape[-1]

        def spec(v):
            return torch.stft(v, n_x, hop_x, window=w_x, center=True, pad_mode="reflect", return_complex=True).abs()
        ref, m = spec(xs_x[..., : n - d]), spec(y[..., d:n])
        k = min(m.shape[-1], ref.shape[-1]) - 2
        return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()
    n_chx, iters_x = xs_x.shape[-1] // chunk_x, chain_x[1].gl_iterations
    for mode, expect in (
        ("pghi", {"session_magnitude": 1, "rt_pghi_phases": 1, "session_random_decode": 1}),
        ("pghi_gl", {"session_magnitude": 1, "rt_pghi_seeded": n_chx, "gl_polish": n_chx,
                     "session_random_decode": 1}),
    ):
        require(streaming.plan_roundtrip(chain_x, tuple(xs_x.shape), chunk_x, mode, device=dev) == mode,
                f"1344/336 {mode}: must plan the session")
        y_kx = route(f"1344/336 {mode} roundtrip (the magnitude encode and the decodes on the smooth route, "
                     "radix 7" + ("; O's polish on its radix-7 instance, one launch a chunk)" if mode == "pghi_gl"
                                  else ")"),
                     lambda: streaming.scan_roundtrip(chain_x, xs_x, chunk_x, mode, generator=sgen(156)), expect,
                     main=False, front="smooth", seven=True)
        y_gx = generic(f"1344/336 {mode} generic", lambda: streaming.scan_roundtrip(
            chain_x, xs_x, chunk_x, mode, generator=sgen(156), backend="generic"))
        s_k, s_g = sc_x(y_kx), sc_x(y_gx)
        e_kx = rel_err(y_kx, y_gx)
        log(f"    vs the generic scan: rel {e_kx:.3e}" + (" (tol 1e-04)" if mode == "pghi" else "")
            + f"; spectral convergence {s_k:.5f} / {s_g:.5f} (must be <= {1.1 * s_g + 1e-3:.5f})")
        require(y_kx.shape == y_gx.shape and torch.isfinite(y_kx).all().item() and s_k <= 1.1 * s_g + 1e-3
                and (mode == "pghi_gl" or e_kx <= 1e-4), f"1344/336 {mode}: the session differs from the generic scan")
        if mode == "pghi_gl":
            # the route before: 16 two-launch projections a chunk, the
            # analysis a product (the polish refused, the analysis forced to
            # its product route), in turns old, new, new, old, host clock
            x_turns = {"two-launch": [], "polish": []}
            for turn in ("two-launch", "polish", "polish", "two-launch"):
                with analysis_on_product(ssx, turn == "two-launch", polish=False):
                    x_turns[turn].append(time_ms(lambda: streaming.scan_roundtrip(
                        chain_x, xs_x, chunk_x, mode, generator=sgen(156)), 1, 1))
            log(f"    1344/336 pghi_gl roundtrip on {n_chx} x 16 two-launch projections (product analysis) vs "
                f"{n_chx} radix-7 polish launches, in turns old, new, new, old (host clock, one call alone, warm): "
                f"{' / '.join(f'{v:.2f}' for v in x_turns['two-launch'])} -> "
                f"{' / '.join(f'{v:.2f}' for v in x_turns['polish'])} ms")
    # pghi_gl with 16 projections a chunk is held by spectral convergence, as
    # every pghi_gl session is: the projections amplify float32 differences
    # of the analysis (a product when these readings were taken, the polish's
    # radix-7 FFT since, cuFFT in the generic scan), and its distance to the
    # generic scan is not a property of the decode (readings
    # of tools/session_bounds.py: 3.3e-5 to 1.5e-3 over 4 clip sets and 2
    # seeds, the same sessions with the decodes on the product route 4.5e-5
    # to 1.5e-3).  With one projection a chunk the decodes and the analysis
    # run once each and the distance is one of the decode: the same readings
    # 1.9e-5 to 1.1e-4, the product route's within 2.8e-6 of them; the
    # decodes' synthesis window perturbed by 1e-4 reads 2.1e-4 to 2.6e-4
    # (perturbed by 1e-3, the session's spectral convergence stays within
    # 1e-4 of the scan's: the convergence check does not see such a fault).
    # Required within tol_gl1, between the two
    tol_gl1 = 1.5e-4
    chain_x1 = T.OverlapAdd(n_x, hop_x) + T.RealtimeSTFT(n_fft=n_x, hop_length=hop_x, gl_iterations=1)
    y_kx = route("1344/336 pghi_gl roundtrip, one projection a chunk (the decodes and O's polish on the smooth "
                 "route, radix 7)",
                 lambda: streaming.scan_roundtrip(chain_x1, xs_x, chunk_x, "pghi_gl", generator=sgen(156)),
                 {"session_magnitude": 1, "rt_pghi_seeded": n_chx, "gl_polish": n_chx, "session_random_decode": 1},
                 main=False, front="smooth", seven=True)
    y_gx = generic("1344/336 pghi_gl generic, one projection a chunk", lambda: streaming.scan_roundtrip(
        chain_x1, xs_x, chunk_x, "pghi_gl", generator=sgen(156), backend="generic"))
    s_k, s_g = sc_x(y_kx), sc_x(y_gx)
    e_kx = rel_err(y_kx, y_gx)
    log(f"    vs the generic scan: rel {e_kx:.3e} (tol {tol_gl1:g}); spectral convergence {s_k:.5f} / "
        f"{s_g:.5f} (must be <= {1.1 * s_g + 1e-3:.5f})")
    require(y_kx.shape == y_gx.shape and torch.isfinite(y_kx).all().item() and s_k <= 1.1 * s_g + 1e-3
            and e_kx <= tol_gl1, "1344/336 pghi_gl, one projection a chunk: the session differs from the "
            "generic scan")
    del y_x, f_x, y_mx, y_kx, y_gx, y_sx

    # R, L, M, the magnitude encode and the decodes (P, S, O's two-launch
    # synthesis) on the product route: the sessions at 1408/352 (2^7 11: no
    # route but the products), the encode, the complex roundtrip and the
    # complex decode against the CPU's generic scan (1e-4, SNR >= 100 dB),
    # the random roundtrip against the card's (1e-4, same seed), the pghi and
    # pghi_gl roundtrips by spectral convergence
    n_y, hop_y, chunk_y = 1408, 352, 2816
    xs_y = mono[:4, :8 * chunk_y].contiguous()
    chain_y = T.OverlapAdd(n_y, hop_y) + T.RealtimeSTFT(n_fft=n_y, hop_length=hop_y)
    c_py = T.OverlapAdd(n_y, hop_y, device="cpu") + T.RealtimeSTFT(n_fft=n_y, hop_length=hop_y, device="cpu")
    require(ssx.session_route(n_y, "encode") == ssx.session_route(n_y, "roundtrip", hop_y)
            == ssx.session_route(n_y, "decode") == ssx.session_route(n_y, "polish") == "product",
            "1408/352 must take the product route")
    y_y = route("1408/352 complex roundtrip (the product route)",
                lambda: streaming.scan_roundtrip(chain_y, xs_y, chunk_y), {"session_roundtrip": 1}, main=False,
                front="product")
    f_y, _ = route("1408/352 encode: scan_forward (the product route)",
                   lambda: streaming.scan_forward(chain_y, xs_y, chunk_y), {"session_encode": 1}, main=False,
                   front="product")
    e_fy = crel(f_y.cpu(), streaming.scan_forward(c_py, xs_y.cpu(), chunk_y)[0])
    e_yy = rel_err(y_y.cpu(), streaming.scan_roundtrip(c_py, xs_y.cpu(), chunk_y))
    snr_y = snr_db_of(xs_y, y_y, n_y, hop_y, chunk_y)
    log(f"    the sessions vs the CPU's generic scan: encode rel {e_fy:.3e}, complex roundtrip rel {e_yy:.3e} (tol "
        f"1e-04); SNR after the delay {snr_y:.2f} dB (must be >= 100)")
    require(e_fy <= 1e-4 and e_yy <= 1e-4 and snr_y >= 100.0, "1408/352: the sessions differ from the generic scan")
    y_sy = route("1408/352 complex decode: scan_invert (the product route)",
                 lambda: streaming.scan_invert(chain_y, f_y, chunk_y // hop_y), {"session_complex_decode": 1},
                 main=False, front="product")
    e_sy = rel_err(y_sy.cpu(), streaming.scan_invert(c_py, f_y.cpu(), chunk_y // hop_y))
    log(f"    the session vs the CPU's generic scan: rel {e_sy:.3e} (tol 1e-04)")
    require(torch.isfinite(y_sy).all().item() and e_sy <= 1e-4,
            "1408/352 complex decode: the session differs from the generic scan")
    y_my = route("1408/352 random roundtrip (the product route)",
                 lambda: streaming.scan_roundtrip(chain_y, xs_y, chunk_y, "random", generator=sgen(159)),
                 {"session_random_roundtrip": 1}, main=False, front="product")
    e_my = rel_err(y_my, generic("1408/352 random generic", lambda: streaming.scan_roundtrip(
        chain_y, xs_y, chunk_y, "random", generator=sgen(159), backend="generic")))
    log(f"    the session vs the generic scan (same seed): rel {e_my:.3e} (tol 1e-04)")
    require(torch.isfinite(y_my).all().item() and e_my <= 1e-4, "1408/352 random roundtrip: differs from the scan")
    w_y = torch.hann_window(n_y, device=dev)

    def sc_y(y):
        d, n = n_y - hop_y, xs_y.shape[-1]

        def spec(v):
            return torch.stft(v, n_y, hop_y, window=w_y, center=True, pad_mode="reflect", return_complex=True).abs()
        ref, m = spec(xs_y[..., : n - d]), spec(y[..., d:n])
        k = min(m.shape[-1], ref.shape[-1]) - 2
        return (torch.linalg.norm(m[..., 2:k] - ref[..., 2:k]) / torch.linalg.norm(ref[..., 2:k])).item()
    n_chy, iters_y = xs_y.shape[-1] // chunk_y, chain_y[1].gl_iterations
    for mode, expect in (
        ("pghi", {"session_magnitude": 1, "rt_pghi_phases": 1, "session_random_decode": 1}),
        ("pghi_gl", {"session_magnitude": 1, "rt_pghi_seeded": n_chy, "gl_project_synthesis": n_chy * iters_y,
                     "gl_project_analysis": n_chy * iters_y, "session_random_decode": 1}),
    ):
        require(streaming.plan_roundtrip(chain_y, tuple(xs_y.shape), chunk_y, mode, device=dev) == mode,
                f"1408/352 {mode}: must plan the session")
        y_ky = route(f"1408/352 {mode} roundtrip (the product route)",
                     lambda: streaming.scan_roundtrip(chain_y, xs_y, chunk_y, mode, generator=sgen(160)), expect,
                     main=False, front="product")
        y_gy = generic(f"1408/352 {mode} generic", lambda: streaming.scan_roundtrip(
            chain_y, xs_y, chunk_y, mode, generator=sgen(160), backend="generic"))
        s_k, s_g = sc_y(y_ky), sc_y(y_gy)
        log(f"    vs the generic scan: rel {rel_err(y_ky, y_gy):.3e}; spectral convergence {s_k:.5f} / {s_g:.5f} "
            f"(must be <= {1.1 * s_g + 1e-3:.5f})")
        require(y_ky.shape == y_gy.shape and torch.isfinite(y_ky).all().item() and s_k <= 1.1 * s_g + 1e-3,
                f"1408/352 {mode}: the session converges worse than the generic scan")
    del y_y, f_y, y_sy, y_my, y_ky, y_gy

    # C and D through the Griffin-Lim invert of an STFT(n_fft, hop, hann) on 16
    # clips (7 D + 2 C), converging like the eager loop from the same seed:
    # the smooth route at 768/192 (2^8 3), the product route at 896/224 (2^7
    # 7).  Each path timed again once warm (host clock to the card's end)
    from acids_transforms_tpu_torch.ops.cuda import glstep as gs

    def gl_invert(n_fft, hop, route):
        st_g = T.STFT(n_fft=n_fft, hop_length=hop)
        mag_g = st_g(mono[:16]).abs()
        require(gs.gl_step_route(n_fft, hop) == route, f"STFT({n_fft}, {hop}) must take the {route} route")

        def run(fused):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = st_g.griffin_lim(mag_g, generator=torch.Generator(device=dev).manual_seed(157), fused=fused)
            torch.cuda.synchronize()
            return y, 1e3 * (time.perf_counter() - t0)
        zero()
        rec_g, _ = run(None)
        got = {k: v for k, v in gs.routes.items() if v}
        log(f"  STFT({n_fft}, {hop}) Griffin-Lim invert on {tuple(mag_g.shape)}: launches "
            f"{ {k: v for k, v in gs.launches.items() if v} }, routes {got}")
        require(set(got) == {f"gl_momentum_step:{route}", f"gl_momentum_chain:{route}"}
                and launched() == sum(got.values()),
                f"STFT({n_fft}, {hop}) Griffin-Lim: C and D must launch on the {route} route")
        for k, v in got.items():
            counts[k] += v
        rec_ge, _ = run(False)
        (_, t_k), (_, t_e) = run(None), run(False)

        def conv_g(y):
            R = st_g(y).abs()
            n = min(R.shape[-2], mag_g.shape[-2])
            return (torch.linalg.norm(R[:, :n] - mag_g[:, :n]) / torch.linalg.norm(mag_g)).item()
        s_k, s_e = conv_g(rec_g), conv_g(rec_ge)
        log(f"    spectral convergence through C and D {s_k:.5f}, eager loop from the same seed {s_e:.5f} "
            f"(must be < {max(1.15 * s_e, s_e + 0.02):.5f}); the invert warm, host clock to the card's end: "
            f"{t_k:.2f} ms through the kernels, {t_e:.2f} ms eager")
        require(torch.isfinite(rec_g).all().item() and s_k < max(1.15 * s_e, s_e + 0.02),
                f"STFT({n_fft}, {hop}) Griffin-Lim: the {route} route converges worse than the eager loop")

    gl_invert(768, 192, "smooth")
    gl_invert(896, 224, "product")

    # A, B, E and F through the entry points: the DGT magnitude chain's and
    # the STFT log-mel chain's fit and forward at 768 (2^8 3: the smooth
    # route), at 896 (2^7 7: the smooth route's radix-7 instance, counted
    # `:smooth7` for its rows; the fit + forward timed in turns with the
    # product / factored route 896 ran before) and at 1408 (2^7 11: E and F
    # on the product route, A and B on the factored one), each against the
    # eager chain.  backend="kernel" forces the kernels; auto follows
    # regions.py (logged)
    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import regions
    from acids_transforms_tpu_torch.ops.cuda import spectral as sp

    audio = mono[:16, None].expand(-1, 2, -1).contiguous()      # up to 16 stereo clips

    def fit_forward(label, chain, want, seven=False):
        """fuse_fit + fuse_forward of `chain` on the kernels, one launch of
        each kernel of `want` (its route tally), fit and forward against the
        eager chain; returns the fitted chain and its forward.  `seven`: the
        launches are the radix-7 instance's (counted `<kernel>:smooth7`), and
        the fit + forward is timed in turns with the product / factored
        route (old, new, new, old; one call alone, host clock to the card's
        end, median of 3)."""
        zero()
        fitted = att.fuse_fit(chain, backend="kernel")(audio)
        y = att.fuse_forward(fitted, backend="kernel")(audio)
        torch.cuda.synchronize()
        got = {k: v for k, v in sp.routes.items() if v}
        auto = {"forward": att.fuse._kernel_preferred(chain), "fit": att.fuse._fit_region(chain[1])}
        log(f"  {label}, fit + forward on {tuple(audio.shape)}: launches "
            f"{ {k: v for k, v in sp.launches.items() if v} }, routes {got}; auto would take the kernel: {auto}")
        require(got == {k: 1 for k in want} and launched() == 2, f"{label}: expected one launch each of {want}")
        for k, v in got.items():
            counts[k + ("7" if seven else "")] += v
        if seven:
            plan = sp._kernel_plan

            def fit_fwd():
                return att.fuse_forward(att.fuse_fit(chain, backend="kernel")(audio), backend="kernel")(audio)

            def on_old(fn):
                sp._kernel_plan = lambda n_fft, hop, taps: (sp._kernel_tile(n_fft, hop, taps), 0)
                try:
                    return fn()
                finally:
                    sp._kernel_plan = plan

            turns = [on_old(lambda: time_ms(fit_fwd, 3)), time_ms(fit_fwd, 3), time_ms(fit_fwd, 3),
                     on_old(lambda: time_ms(fit_fwd, 3))]
            log(f"    fit + forward, one call alone (host clock to the card's end, median of 3), in turns the "
                f"route 896 took before, radix-7, radix-7, before: {' / '.join(f'{t:.3f}' for t in turns)} ms")
        e_fit = chain.fit(audio)
        e_off = abs(fitted[2].norm.offset.item() - e_fit[2].norm.offset.item()) / abs(e_fit[2].norm.scale.item())
        e_scl = abs(fitted[2].norm.scale.item() - e_fit[2].norm.scale.item()) / abs(e_fit[2].norm.scale.item())
        e_y = rel_err(y, fitted.forward(audio))
        log(f"    fit offset / scale vs chain.fit: {e_off:.3e} / {e_scl:.3e} of the scale (tol 1e-05); forward vs "
            f"the eager chain rel {e_y:.3e} (tol 1e-04)")
        require(torch.isfinite(y).all().item() and e_off <= 1e-5 and e_scl <= 1e-5 and e_y <= 1e-4,
                f"{label}: the kernels' fit or forward differs from the eager chain")
        return fitted, y

    def dgt_mag(n_fft, hop):
        return T.Mono() + T.DGT(n_fft=n_fft, hop_length=hop) + T.Magnitude(mode="unipolar", contrast="log1p",
                                                                          mel=False)

    def stft_logmel(n_fft, hop):
        return T.Mono() + T.STFT(n_fft=n_fft, hop_length=hop) + T.Magnitude(mode="unipolar", contrast="log1p",
                                                                           mel=True, n_fft=n_fft)

    d_fit, y_k = fit_forward("DGT(768, 256) magnitude chain (E, F smooth)", dgt_mag(768, 256),
                             ("fused_melspec_fullk:smooth", "fused_melspec_stats_fullk:smooth"))
    require(regions.melspec_region_ok(768, 256, False) == ("smooth" in regions.table()["fuse_forward"][
        "melspec_fullk"]["routes"]), "regions: E's decision at 768 is not the table's smooth route")
    d_fit_y, y_y = fit_forward("DGT(896, 224) magnitude chain (E, F radix-7)", dgt_mag(896, 224),
                               ("fused_melspec_fullk:smooth", "fused_melspec_stats_fullk:smooth"), seven=True)
    d_fit_11, y_11 = fit_forward("DGT(1408, 352) magnitude chain (E, F product)", dgt_mag(1408, 352),
                                 ("fused_melspec_fullk:product", "fused_melspec_stats_fullk:product"))
    fit_forward("STFT(768, 192) log-mel chain (A, B smooth)", stft_logmel(768, 192),
                ("fused_melspec:smooth", "fused_melspec_stats:smooth"))
    fit_forward("STFT(896, 224) log-mel chain (A, B radix-7)", stft_logmel(896, 224),
                ("fused_melspec:smooth", "fused_melspec_stats:smooth"), seven=True)
    fit_forward("STFT(1408, 352) log-mel chain (A, B factored)", stft_logmel(1408, 352),
                ("fused_melspec:factored", "fused_melspec_stats:factored"))
    # G and H through the entry points: STFT + Polar (taps) and DGT +
    # PolarIF (full-K), fit and forward, at 768 (the smooth route), at 896
    # (2^7 7: the smooth route's radix-7 instance, counted `:smooth7` for its
    # rows) and at 1408 (2^7 11: the factored and the product route), each
    # against the eager chain, one launch each of H and G; the fit +
    # forward's time (one call alone, host clock to the card's end, median
    # of 3) on its route and, at 768 and 896, in turns with the route the
    # shape ran before (old, new, new, old)
    def repr_chain(label, chain, want, old, seven=False):
        zero()
        fitted = att.fuse_fit(chain, backend="kernel")(audio)
        y = att.fuse_forward(fitted, backend="kernel")(audio)
        torch.cuda.synchronize()
        got = {k: v for k, v in sp.routes.items() if v}
        log(f"  {label}, fit + forward on {tuple(audio.shape)}: launches "
            f"{ {k: v for k, v in sp.launches.items() if v} }, routes {got}")
        require(got == {k: 1 for k in want} and launched() == 2, f"{label}: H and G must launch once each on {want}")
        for k, v in got.items():
            counts[k + ("7" if seven else "")] += v
        e_fit = chain.fit(audio)
        e_m = max(abs(getattr(fitted[2].magnitude.norm, a).item() - getattr(e_fit[2].magnitude.norm, a).item())
                  for a in ("offset", "scale")) / abs(e_fit[2].magnitude.norm.scale.item())
        e_y = rel_err(y[..., 0, :], fitted.forward(audio)[..., 0, :])
        log(f"    magnitude fit vs chain.fit {e_m:.3e} of the scale (tol 1e-05); channel 1 vs the eager chain rel "
            f"{e_y:.3e} (tol 1e-04)")
        require(torch.isfinite(y).all().item() and e_m <= 1e-5 and e_y <= 1e-4,
                f"{label}: the kernels' fit or forward differs from the eager chain")
        del y

        def fit_fwd():
            return att.fuse_forward(att.fuse_fit(chain, backend="kernel")(audio), backend="kernel")(audio)

        plan = sp._repr_plan

        def on_old(fn):
            sp._repr_plan = lambda n_fft, hop, taps, *a: (sp._repr_kernel_tile(n_fft, hop, taps), 0)
            try:
                return fn()
            finally:
                sp._repr_plan = plan

        if old is None:
            log(f"    fit + forward {time_ms(fit_fwd, 3):.3f} ms (one call alone, host clock to the card's end)")
            return
        turns = [on_old(lambda: time_ms(fit_fwd, 3)), time_ms(fit_fwd, 3), time_ms(fit_fwd, 3),
                 on_old(lambda: time_ms(fit_fwd, 3))]
        new = "radix-7" if seven else "smooth"
        log(f"    fit + forward, one call alone (host clock to the card's end, median of 3), in turns {old} route "
            f"(the route this shape took before), {new}, {new}, {old}: {' / '.join(f'{t:.3f}' for t in turns)} ms")

    repr_chain("STFT(768, 192) + Polar (G, H smooth)", T.Mono() + T.STFT(n_fft=768, hop_length=192) + T.Polar(
        magnitude_args={"mode": "bipolar", "n_fft": 768}), ("fused_repr_stats:smooth", "fused_spectral_repr:smooth"),
        "factored")
    repr_chain("STFT(896, 224) + Polar (G, H radix-7)", T.Mono() + T.STFT(n_fft=896, hop_length=224) + T.Polar(
        magnitude_args={"mode": "bipolar", "n_fft": 896}), ("fused_repr_stats:smooth", "fused_spectral_repr:smooth"),
        "factored", seven=True)
    repr_chain("STFT(1408, 352) + Polar (G, H factored)", T.Mono() + T.STFT(n_fft=1408, hop_length=352) + T.Polar(
        magnitude_args={"mode": "bipolar", "n_fft": 1408}),
        ("fused_repr_stats:factored", "fused_spectral_repr:factored"), None)
    repr_chain("DGT(768, 256) + PolarIF (G, H full-K smooth)", T.Mono() + T.DGT(n_fft=768, hop_length=256) + T.PolarIF(
        magnitude_args={"mode": "bipolar", "n_fft": 768}),
        ("fused_repr_stats_fullk:smooth", "fused_spectral_repr_fullk:smooth"), "product")
    repr_chain("DGT(896, 224) + PolarIF (G, H full-K radix-7)", T.Mono() + T.DGT(n_fft=896, hop_length=224)
               + T.PolarIF(magnitude_args={"mode": "bipolar", "n_fft": 896}),
               ("fused_repr_stats_fullk:smooth", "fused_spectral_repr_fullk:smooth"), "product", seven=True)
    repr_chain("DGT(1408, 352) + PolarIF (G, H full-K product)", T.Mono() + T.DGT(n_fft=1408, hop_length=352)
               + T.PolarIF(magnitude_args={"mode": "bipolar", "n_fft": 1408}),
               ("fused_repr_stats_fullk:product", "fused_spectral_repr_fullk:product"), None)
    # J through that chain's pghi_gl inversion, converging like the eager
    # loop from the same seed: the smooth route at 768/256 (2^8 3), its
    # radix-7 instance at 896/224 (2^7 7; `seven`: counted `:smooth7`), the
    # product route at 1408/352 (2^7 11)
    def pghi_gl(fit, y, n_fft, hop, route, seven=False):
        dgt = fit[1]
        draws = dgt._draws
        zero()
        rec = fit.invert(y, inversion_mode="pghi_gl")
        torch.cuda.synchronize()
        got = {k: v for k, v in gs.routes.items() if v}
        log(f"  DGT({n_fft}, {hop}) pghi_gl invert: launches {gs.launches['gl_momentum_fullk']} J, routes {got}"
            + (" (the radix-7 instance)" if seven else ""))
        require(got == {f"gl_momentum_fullk:{route}": dgt.gl_iterations} and torch.isfinite(rec).all().item()
                and (n_fft % 7 == 0) == seven,
                f"DGT({n_fft}, {hop}) pghi_gl: J must launch on the {route} route every iteration")
        counts[f"gl_momentum_fullk:{route}" + ("7" if seven else "")] = got[f"gl_momentum_fullk:{route}"]
        target = fit[2].invert(y)
        ph0 = dgt.pghi(target, generator=torch.Generator(device=dev).manual_seed(dgt.seed + draws))
        rec_e = dgt.griffin_lim(target, init_phase=ph0, fused=False)

        def conv(v):
            R = dgt(v.reshape(-1, v.shape[-1])).abs()
            n = min(R.shape[-2], target.shape[-2])
            return (torch.linalg.norm(R[:, :n] - target[:, :n]) / torch.linalg.norm(target)).item()
        s_j, s_e = conv(rec), conv(rec_e)
        log(f"    spectral convergence through J {s_j:.5f}, eager loop from the same seed {s_e:.5f} "
            f"(must be < {max(1.15 * s_e, s_e + 0.02):.5f})")
        require(s_j < max(1.15 * s_e, s_e + 0.02), f"DGT({n_fft}, {hop}) pghi_gl: J converges worse than the eager "
                                                   "loop")
        return dgt, target, conv

    dgt, target, conv = pghi_gl(d_fit, y_k, 768, 256, "smooth")
    dgt_y, target_y, conv_y = pghi_gl(d_fit_y, y_y, 896, 224, "smooth", seven=True)
    dgt_11, target_11, conv_11 = pghi_gl(d_fit_11, y_11, 1408, 352, "product")
    # K's synthesis on the smooth route (768/256), its radix-7 instance
    # (896/224) and the product route (1408/352): each chain's pghi
    # inversion, converging like the eager pghi_scan + istft from the same
    # seed
    from acids_transforms_tpu_torch.ops import pghi as pghi_ops
    from acids_transforms_tpu_torch.ops.fft import istft

    def pghi_invert(fit, y, dgt_c, target_c, conv_c, n_fft, hop, route, seven=False):
        zero()
        rec = fit.invert(y, inversion_mode="pghi")
        torch.cuda.synchronize()
        got = {k: v for k, v in pk.routes.items() if v}
        log(f"  DGT({n_fft}, {hop}) pghi invert: launches { {k: v for k, v in pk.launches.items() if v} }, "
            f"routes {got}" + (" (the radix-7 instance)" if seven else ""))
        require(got == {f"pghi_synthesize:{route}": 1} and pk.launches["pghi_phases"] == 1
                and pk.launches["pghi_plan"] == 1 and torch.isfinite(rec).all().item()
                and (n_fft % 7 == 0) == seven,
                f"DGT({n_fft}, {hop}) pghi: K's synthesis must take the {route} route")
        counts[f"pghi_synthesize:{route}" + ("7" if seven else "")] += 1
        g_e = torch.Generator(device=dev).manual_seed(dgt_c.seed)
        ph_e = pghi_ops.pghi_scan(target_c, dgt_c.gamma, n_fft, hop, tolerance=dgt_c.tolerance,
                                  time_stencil="central", generator=g_e)
        s_k, s_e = conv_c(rec), conv_c(istft(torch.polar(target_c, ph_e), n_fft, hop, dgt_c.inv_window))
        log(f"    spectral convergence through K {s_k:.5f}, eager pghi_scan + istft {s_e:.5f} "
            f"(must be < {max(1.15 * s_e, s_e + 0.02):.5f})")
        require(s_k < max(1.15 * s_e, s_e + 0.02), f"DGT({n_fft}, {hop}) pghi: K converges worse than the eager "
                                                   "scan")

    pghi_invert(d_fit, y_k, dgt, target, conv, 768, 256, "smooth")
    pghi_invert(d_fit_y, y_y, dgt_y, target_y, conv_y, 896, 224, "smooth", seven=True)
    pghi_invert(d_fit_11, y_11, dgt_11, target_11, conv_11, 1408, 352, "product")

    # the 896/224 inversions end to end on the radix-7 instances against the
    # product routes 896 took before (J's plan and K's synthesis route sent
    # to the product), in turns old, new, new, old: one call alone, host
    # clock to the card's end, median of 3
    plan_j, route_k = gs._fullk_plan, pk.synth_route

    def on_product(fn):
        gs._fullk_plan = lambda n_fft, hop: ("product",) + gs._pick_fullk_block(n_fft, hop)
        pk.synth_route = lambda *a: "product"
        try:
            return fn()
        finally:
            gs._fullk_plan, pk.synth_route = plan_j, route_k

    for mode in ("pghi_gl", "pghi"):
        def inv():
            return d_fit_y.invert(y_y, inversion_mode=mode)
        turns = [on_product(lambda: time_ms(inv, 3)), time_ms(inv, 3), time_ms(inv, 3),
                 on_product(lambda: time_ms(inv, 3))]
        log(f"    DGT(896, 224) {mode} invert, one call alone (host clock to the card's end, median of 3), in turns "
            f"the product route 896 took before, radix-7, radix-7, product: {' / '.join(f'{t:.3f}' for t in turns)} "
            "ms")
    log(f"  phase 4h {time.perf_counter() - t_start:.1f} s")


def snr_db(ref: torch.Tensor, rec: torch.Tensor) -> float:
    """SNR of ``rec`` against ``ref`` in float64 over their common length
    (infinite where they are equal)."""
    n = min(ref.shape[-1], rec.shape[-1])
    ref, rec = ref[..., :n].double(), rec[..., :n].double()
    err = ((ref - rec) ** 2).sum().item()
    return float("inf") if err == 0 else 10.0 * math.log10((ref ** 2).sum().item() / err)


def baseline_phase(dev, audio, mono, errs, counts):
    """Phase 4i: BASELINE configs 2 and 3 through the entry points.

    Config 3 (``bench.py:298-310``): ``Mono() + MFCC(1024, 256)`` (power 2,
    128 mels, mel 0 an empty filter) and the same chain with
    ``norm_mode="unipolar"`` fitted on the raw input, each through
    ``fuse_forward``: one launch of kernel A each on the FFT route, the
    fused output within 1e-4 of the eager ``chain.forward``'s largest value
    (``bench.py:303-308``), mel 0 exactly as the eager chain has it (0
    without a norm), the bf16 output the cast of the float32 one, int16 PCM
    bit-identical to the pre-converted float; A at this shape within 2e-5 of
    its plain version; the path's median host-clock time over 5 runs.
    Config 2 (``bench.py:370-377``) on CUDA tensors: the MidSide (at least
    120 dB), Stereo, Window(1024, 256) (exact) and MuLaw roundtrips at the
    main path's B, MuLaw's codes against the same call on the CPU (flips of
    +-1 on at most 1e-4 of the samples: the two ``log1pf`` may differ by an
    ulp at a code's rounding boundary; equal codes decode within 1e-6), its
    SNR within 0.5 dB of the CPU's; the one-hot modes and OneHot at B = 8
    (the int32 one-hot of 128 clips would take 46 GB), against the same
    calls on the CPU; Transpose, Squeeze and Unsqueeze equal to the CPU's.
    Returns what phase 5 needs."""
    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import fuse
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import spectral

    B, L = audio.shape[0], audio.shape[-1]
    n_frames = 1 + L // HOP
    log(f"[4i] BASELINE config 3: Mono() + MFCC({N_FFT}, {HOP}) (power 2, 128 mels) through fuse_forward, "
        f"plain and with norm_mode='unipolar', on {B} stereo clips; config 2: the raw and layout transforms")
    t_start = time.perf_counter()
    chain = T.Mono() + T.MFCC(n_fft=N_FFT, hop_length=HOP)
    mfcc = chain[1]
    unip = (T.Mono() + T.MFCC(n_fft=N_FFT, hop_length=HOP, norm_mode="unipolar")).fit(audio)
    spectral.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = att.fuse_forward(chain)(audio)
    y_n = att.fuse_forward(unip)(audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launched = {k: v for k, v in spectral.launches.items() if v}
    by_route = {k: v for k, v in spectral.routes.items() if v}
    log(f"  two fused forwards {1e3 * (t1 - t0):.1f} ms; launches {launched}, by route {by_route}")
    require(launched == {"fused_melspec": 2} and by_route == {"fused_melspec:fft": 2},
            "config 3: expected one launch of A on the FFT route a chain")
    counts["fused_melspec_mfcc:fft"] = by_route["fused_melspec:fft"]
    for label, fitted, out in (("MFCC", chain, y), ("MFCC(norm_mode='unipolar')", unip, y_n)):
        require(tuple(out.shape) == (B, mfcc.n_mels, n_frames) and out.dtype == torch.float32
                and torch.isfinite(out).all().item(), f"config 3 {label}: output {tuple(out.shape)}")
        ref = fitted.forward(audio)
        e = rel_err(out, ref)
        same0 = torch.equal(out[:, 0], ref[:, 0])
        log(f"  {label}: fused vs eager chain.forward rel {e:.3e} (tol 1e-04); mel 0 as the eager chain's: {same0}")
        require(e <= 1e-4 and same0, f"config 3 {label}: the fused forward differs from chain.forward")
        del ref
    require(bool((y[:, 0] == 0).all().item()), "config 3: mel 0 (an empty filter) is not exactly 0")
    require(torch.equal(att.fuse_forward(chain, out_dtype=torch.bfloat16)(audio), y.to(torch.bfloat16)),
            "config 3: the bf16 output is not the cast of the float32 one")
    pcm = torch.round(audio * 32767.0).to(torch.int16)
    require(torch.equal(att.fuse_forward(chain)(pcm), att.fuse_forward(chain)(pcm.to(torch.float32) * 2.0 ** -15)),
            "config 3: int16 PCM is not bit-identical to the pre-converted float")
    del pcm, y_n
    log("  mel 0 exactly 0; bf16 output the rounded float32; int16 PCM bit-identical")
    # A at this shape against its plain version: the rectangular bank (M = 128,
    # mel 0 empty), power 2, no contrast, offset 0, scale 1
    taps = fuse._mfcc_taps(mfcc)
    kw = dict(mel_bank=mfcc.mel_bank, offset=0.0, scale=1.0, contrast="none", taps=taps, power=2.0)
    y_k = spectral.fused_melspec(mono, N_FFT, HOP, **kw)
    y_p = spectral.fused_melspec_reference(mono, N_FFT, HOP, **kw)
    e = rel_err(y_k, y_p)
    zero0 = bool((y_k[..., 0] == 0).all().item() and (y_p[..., 0] == 0).all().item())
    errs["A_mfcc"] = abs_err(y_k, y_p)
    log(f"  A at the MFCC shape {tuple(y_k.shape)} vs plain: rel {e:.3e} (tol 2e-05), abs {errs['A_mfcc']:.3e}; "
        f"mel 0 exactly 0 in both: {zero0}")
    require(e <= 2e-5 and zero0, "A at the MFCC shape disagrees with its plain version")
    del y_k, y_p
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        att.fuse_forward(chain)(audio)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    log(f"  config 3 path (fuse_forward built and called, Mono + A + transpose), median of 5 runs: "
        f"{statistics.median(walls):.2f} ms (host clock, to the card's end)")
    del y

    # config 2 on CUDA tensors, beside the JAX figures (BENCH_r05, on another
    # signal and a TPU: MidSide 143.9 dB, MuLaw 38.4 dB, Window exact)
    x, xc = audio, audio.cpu()
    ms = T.MidSide()
    s_ms = snr_db(x, ms.invert(ms.forward(x)))
    ys = T.Stereo().forward(mono[:, None])
    st_ok = torch.equal(ys.cpu(), T.Stereo(device="cpu").forward(mono[:, None].cpu())) and torch.equal(
        T.Stereo().invert(ys), ys)
    wd = T.Window(window_size=N_FFT, hop_size=HOP)
    back = wd.invert(wd.forward(x))
    w_ok = back.shape[-1] == HOP * (1 + (L - N_FFT) // HOP) + (N_FFT - HOP) and torch.equal(back, x[..., : back.shape[-1]])
    del ys, back
    codes = T.MuLaw().forward(x)
    codes_c = T.MuLaw(device="cpu").forward(xc)
    d = codes.cpu().long() - codes_c.long()
    flips, max_flip = int((d != 0).sum().item()), int(d.abs().max().item())
    dec = T.MuLaw().invert(codes)
    e_dec = (dec.cpu() - T.MuLaw(device="cpu").invert(codes.cpu())).abs().max().item()
    s_mu, s_mu_c = snr_db(x, dec), snr_db(xc, T.MuLaw(device="cpu").invert(codes_c))
    del dec, d
    log(f"  config 2 at B = {B}: MidSide SNR {s_ms:.1f} dB (JAX 143.9; need >= 120), Stereo equal to the CPU's: "
        f"{st_ok}, Window(1024, 256) roundtrip exact: {w_ok}, MuLaw SNR {s_mu:.2f} dB, on the CPU {s_mu_c:.2f} dB "
        f"(JAX 38.4; need within 0.5 dB); codes against the CPU's: {flips} of {codes.numel()} flipped (at most "
        f"{max_flip}; allowed +-1 on 1e-4), equal codes decode within {e_dec:.1e} (tol 1e-6)")
    require(s_ms >= 120.0, "config 2: MidSide roundtrip under 120 dB")
    require(st_ok and w_ok, "config 2: the Stereo or the Window roundtrip is not exact")
    require(codes.dtype == torch.int32 and max_flip <= 1 and flips <= 1e-4 * codes.numel() and e_dec <= 1e-6,
            "config 2: MuLaw codes or their decode differ from the CPU's")
    require(abs(s_mu - s_mu_c) <= 0.5, "config 2: MuLaw SNR not within 0.5 dB of the CPU's")
    b8 = min(8, B)
    x8, x8c = x[:b8], xc[:b8]
    for mode in ("categorical", "channel"):
        mk, mc = T.MuLaw(one_hot=mode), T.MuLaw(one_hot=mode, device="cpu")
        oh = mk.forward(x8)
        shape_ok = oh.dtype == torch.int32 and oh.shape[-1 if mode == "categorical" else -2] == 256
        s_k = snr_db(x8, mk.invert(oh))
        del oh
        s_c = snr_db(x8c, mc.invert(mc.forward(x8c)))
        log(f"  MuLaw one_hot={mode!r} at B = {b8}: SNR {s_k:.2f} dB, on the CPU {s_c:.2f} dB; int32, 256 classes: "
            f"{shape_ok}")
        require(shape_ok and abs(s_k - s_c) <= 0.5, f"config 2: MuLaw {mode} differs from the CPU's")
    c8 = codes[:b8]
    ohk, ohc = T.OneHot().fit(c8), T.OneHot(device="cpu").fit(c8.cpu())
    r_k, r_c = ohk.invert(ohk.forward(c8)), ohc.invert(ohc.forward(c8.cpu()))
    oh_ok = ohk.n_classes == ohc.n_classes and torch.equal(r_k.cpu(), r_c) and torch.equal(r_c, c8.cpu().long())
    log(f"  OneHot at B = {b8}: {ohk.n_classes} classes fitted, roundtrip equal to the CPU's and to the codes: {oh_ok}")
    require(oh_ok, "config 2: OneHot's roundtrip differs from the CPU's")
    del codes, codes_c, r_k, r_c
    lay_ok = {}
    for name, kt, ct, inp in (("Transpose", T.Transpose(), T.Transpose(device="cpu"), x),
                              ("Unsqueeze", T.Unsqueeze(dim=1), T.Unsqueeze(dim=1, device="cpu"), x),
                              ("Squeeze", T.Squeeze(dim=1), T.Squeeze(dim=1, device="cpu"), mono[:, None])):
        yk, yc = kt.forward(inp), ct.forward(inp.cpu())
        lay_ok[name] = torch.equal(yk.cpu(), yc) and torch.equal(kt.invert(yk).cpu(), ct.invert(yc))
    log(f"  layout transforms equal to the CPU's both ways: {lay_ok}; phase 4i {time.perf_counter() - t_start:.1f} s")
    require(all(lay_ok.values()), "config 2: a layout transform differs from the CPU's")
    return {"bank": mfcc.mel_bank, "taps": taps}


def sinebank_regions_phase(dev, audio, mono, stream, wrappers):
    """Phase 4j: the sinebank resynthesis, offline and streaming, and the
    port's measured dispatch regions (``regions.py``).

    * Offline: ``STFT(1024, 256).invert(|STFT(x)|, inversion_mode="sinebank")``
      on phase 4's mono clips at the main path's B (torch ops, no kernel
      launch), its time and peak memory; two clips against the same call on
      the CPU with the same phases (relative L2 within 1e-4).
    * Streaming on phase 4f's sessions: ``scan_invert`` of the encode's
      magnitudes and ``scan_roundtrip`` on the 2-chain and the log-mel
      3-chain, and ``RealtimeDGT``'s decode, each by the closed form under
      ``auto`` (the roundtrips encode through R) against the generic chunk
      scan with a generator seeded alike: relative L2 below 5e-3 (the JAX
      package's bound, ``tests/test_streaming.py:1046``) and below 1e-5 (both
      routes build the same angles; ``tests/test_torch_sinebank.py`` shows a
      clock off by float32 rounding failing it); route times at B =
      1, 8 and the session count beside the generic scan's.
    * Regions: the table's decision at each phase's shapes, required to be
      the kernel at the main paths' shapes (1024/256 log-mel, DGT, Polar,
      PolarIF, MFCC, and the 64-session routes); the kernel / eager ratio at
      the edges of each region and the batch caps, printed, not gated."""
    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import regions, streaming
    from acids_transforms_tpu_torch import transforms as T

    t_start = time.perf_counter()
    route, generic, sgen = stream["route"], stream["generic"], stream["sgen"]
    B, F = mono.shape[0], N_FFT // 2 + 1
    log(f"[4j] sinebank: offline STFT({N_FFT}, {HOP}) on {B} mono clips, the streaming closed form on "
        f"{stream['sx'].shape[0]} sessions; the dispatch regions")

    def zero():
        for w in wrappers:
            w.reset_launches()

    def launched():
        return sum(sum(w.launches.values()) for w in wrappers)

    def rel_l2(a, b):
        return (torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double())).item()

    # ---- offline
    st = T.STFT(n_fft=N_FFT, hop_length=HOP)
    mag = st(mono).abs()
    phi = 2 * math.pi * torch.rand((F,), generator=sgen(170), device=dev)
    st._phase_buffer = None     # the forward's stashed phase: not needed here
    zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    y = st.invert(mag, inversion_mode="sinebank", angles=phi)
    torch.cuda.synchronize()
    off_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    n_l = launched()
    ok = (tuple(y.shape) == (B, HOP * mag.shape[-2] + N_FFT) and torch.isfinite(y).all().item()
          and abs(y.abs().max().item() - 1.0) < 1e-6)
    del y
    y2 = st.invert(mag[:2], inversion_mode="sinebank", angles=phi)
    y2_p = T.STFT(n_fft=N_FFT, hop_length=HOP, device="cpu").invert(mag[:2].cpu(), inversion_mode="sinebank",
                                                                     angles=phi.cpu())
    e_off = rel_l2(y2.cpu(), y2_p)
    log(f"  offline sinebank on {tuple(mag.shape)}: {off_ms:.1f} ms, peak {peak / 2 ** 30:.2f} GiB over "
        f"what was allocated, launches {n_l}; two clips against the CPU: relative L2 {e_off:.3e} (tol 1e-04)")
    require(ok and n_l == 0 and e_off <= 1e-4, "offline sinebank: bad output, a kernel launch or the CPU disagrees")
    del mag, y2, y2_p
    torch.cuda.empty_cache()

    # ---- streaming: the closed form against the generic scan
    sx, spec, CH = stream["sx"], stream["spec"], STREAM_CHUNK
    T_C = CH // HOP
    s_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank")
    f_chain = s_chain + T.Magnitude(mode=None, contrast="log1p", mel=True, n_fft=N_FFT)
    d_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeDGT(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank")
    mags = spec.abs()
    feats, _ = streaming.scan_forward(f_chain, sx, CH, backend="generic")
    cases = (
        ("2-chain decode", lambda b: streaming.scan_invert(s_chain, mags, T_C, "sinebank", generator=sgen(171),
                                                           backend=b), {}),
        ("2-chain roundtrip", lambda b: streaming.scan_roundtrip(s_chain, sx, CH, "sinebank", generator=sgen(172),
                                                                 backend=b), {"session_encode": 1}),
        ("log-mel 3-chain roundtrip", lambda b: streaming.scan_roundtrip(f_chain, sx, CH, "sinebank",
                                                                         generator=sgen(173), backend=b),
         {"session_encode": 1}),
        ("log-mel 3-chain decode", lambda b: streaming.scan_invert(f_chain, feats, T_C, "sinebank",
                                                                   generator=sgen(174), backend=b), {}),
        ("RealtimeDGT decode", lambda b: streaming.scan_invert(d_chain, mags, T_C, "sinebank", generator=sgen(175),
                                                               backend=b), {}),
    )
    for name, fn, expect in cases:
        y_c = route(f"sinebank {name}: closed form", lambda: fn("auto"), expect)
        y_g = generic(f"sinebank {name} generic", lambda: fn("generic"))
        e = rel_l2(y_c, y_g)
        log(f"    closed form vs generic scan: relative L2 {e:.3e} (tol 5e-03, and 1e-05 for the same angles)")
        require(y_c.shape == y_g.shape and torch.isfinite(y_c).all().item() and e < 5e-3 and e < 1e-5,
                f"sinebank {name}: the closed form differs from the generic scan")
    del feats
    log("  sinebank route times (median of 3, host clock to the card's end): closed form / generic scan")
    for b in sorted({1, 8, sx.shape[0]}):
        xb, mb = sx[:b], mags[:b]
        for name, fn in (
            ("decode", lambda bk: streaming.scan_invert(s_chain, mb, T_C, "sinebank", generator=sgen(176), backend=bk)),
            ("roundtrip", lambda bk: streaming.scan_roundtrip(s_chain, xb, CH, "sinebank", generator=sgen(177),
                                                              backend=bk)),
        ):
            c_ms, g_ms = time_ms(lambda: fn("auto"), 3, 1), time_ms(lambda: fn("generic"), 3, 1)
            log(f"    B={b:3d} sinebank {name:9s}: {c_ms:9.3f} ms / {g_ms:9.3f} ms ({g_ms / c_ms:.2f}x)")
    del mags
    torch.cuda.empty_cache()

    # ---- the regions
    table = regions.table()
    log("  dispatch regions (regions.py, measured by tools/sweep_regions.py): " + json.dumps(
        {k: table["streaming"][k] for k in ("angle_cap_bytes", "sinebank_cap_bytes", "batch_caps")}))
    shapes = [("4 log-mel", "melspec", 1024, 256, True), ("4b DGT", "melspec", 1024, 256, False),
              ("4c DGT + PolarIF", "if", 1024, 256, False), ("4d STFT + Polar", "phase", 1024, 256, True),
              ("4i MFCC", "mfcc", 1024, 256, True), ("4h STFT(768, 192) log-mel", "melspec", 768, 192, True),
              ("4h STFT(768, 192) + Polar", "phase", 768, 192, True), ("4h DGT(768, 256)", "melspec", 768, 256, False),
              ("4h DGT(768, 256) + PolarIF", "if", 768, 256, False),
              ("4h STFT(896, 224) log-mel", "melspec", 896, 224, True),
              ("4h DGT(896, 224)", "melspec", 896, 224, False), ("4h STFT(896, 224) + Polar", "phase", 896, 224, True),
              ("4h DGT(896, 224) + PolarIF", "if", 896, 224, False),
              ("4h STFT(1408, 352) log-mel", "melspec", 1408, 352, True),
              ("4h DGT(1408, 352)", "melspec", 1408, 352, False),
              ("4h STFT(1408, 352) + Polar", "phase", 1408, 352, True),
              ("4h DGT(1408, 352) + PolarIF", "if", 1408, 352, False)]
    main_ok = True
    for label, kind, n_fft, hop, taps in shapes:
        if kind == "melspec":
            inside = regions.melspec_region_ok(n_fft, hop, taps)
        elif kind == "mfcc":
            inside = regions.mfcc_region_ok(n_fft, hop)
        else:
            inside = regions.repr_region_ok(n_fft, hop, taps, kind)
        fit_inside = taps or regions.fit_fullk_region_ok(n_fft, two_channel=kind in ("if", "phase"))
        log(f"    phase {label} {n_fft}/{hop}: auto forward -> {'kernel' if inside else 'eager'}"
            + ("" if kind == "mfcc" else f", fit -> {'kernel' if fit_inside else 'chain.fit'}"))
        if n_fft == N_FFT:
            main_ok = main_ok and inside and fit_inside
    SB = sx.shape[0]
    three = s_chain + T.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT)
    plans = {
        "encode": streaming.plan_forward(stream["chain"], (SB, sx.shape[-1]), CH),
        "complex roundtrip": streaming.plan_roundtrip(stream["chain"], (SB, sx.shape[-1]), CH),
        "complex decode": streaming.plan_invert(stream["chain"], tuple(spec.shape), T_C, y_is_complex=True),
        "sinebank roundtrip": streaming.plan_roundtrip(s_chain, (SB, sx.shape[-1]), CH, "sinebank"),
    }
    for mode in ("random", "pghi", "pghi_gl"):
        plans[f"{mode} roundtrip"] = streaming.plan_roundtrip(stream["chain"], (SB, sx.shape[-1]), CH, mode)
        plans[f"{mode} decode"] = streaming.plan_invert(stream["chain"], (SB, stream["n_frames"], F), T_C, mode)
        plans[f"{mode} 3-chain roundtrip"] = streaming.plan_roundtrip(three, (SB, sx.shape[-1]), CH, mode)
    want = {k: ("fused" if k == "encode" else "complex" if k.startswith("complex") else k.split()[0])
            for k in plans}
    log(f"    phases 4f / 4g, {SB} sessions: " + ", ".join(f"{k} -> {v}" for k, v in plans.items()))
    require(main_ok and plans == want, "regions: a main path's shape does not resolve to its kernel under auto")
    # the kernel / eager ratio at each region's edges (not gated)
    clips = audio[:32]
    edges = []
    for kind, key in (("melspec_taps", ("melspec_taps",)), ("melspec_fullk", ("melspec_fullk",)),
                      ("mfcc", ("mfcc",))):
        r = table["fuse_forward"][key[0]]
        if r is None:
            continue
        pts = {r["n_fft_min"], r["n_fft_max"]}
        if r["n_fft_min"] > 64:
            pts.add(r["n_fft_min"] // 2)
        if r["n_fft_max"] < 4096:
            pts.add(2 * r["n_fft_max"])
        pts.update((768, 896, 1408))    # the smooth route (896 its radix-7 instance), the factored / product one
        for n_fft in sorted(pts):
            hop = 32 if n_fft == 64 else n_fft // 4   # the kernels' hop is a multiple of 32
            if kind == "mfcc":
                chain = T.Mono() + T.MFCC(n_fft=n_fft, hop_length=hop)
            else:
                front = T.STFT(n_fft=n_fft, hop_length=hop) if kind.endswith("taps") else T.DGT(n_fft=n_fft,
                                                                                             hop_length=hop)
                chain = T.Mono() + front + T.Magnitude(mode="unipolar", contrast="log1p",
                                                       mel=kind.endswith("taps"), n_fft=n_fft)
            k_ms = device_ms(lambda: att.fuse_forward(chain, backend="kernel")(clips), 3, 1)
            e_ms = device_ms(lambda: att.fuse_forward(chain, backend="eager")(clips), 3, 1)
            edges.append(f"{kind} {n_fft}/{hop} {k_ms / e_ms:.2f}x")
    zero()
    for mode, cap in table["streaming"]["batch_caps"].items():
        if cap is not None:
            edges.append(f"batch cap {mode} = {cap} (ratios in dispatch_regions.json)")
    log("    kernel / eager at the regions' edges (32 stereo clips; not gated): " + "; ".join(edges))
    log(f"  phase 4j {time.perf_counter() - t_start:.1f} s")


def serving_export_phase(args, dev, audio, stream, errs, counts):
    """Phase 4k: the deployment surface on the card, at the flagship's full
    width (``Mono() + STFT(1024, 256, hann) + Magnitude(unipolar, log1p,
    mel)``) on phase 4's clips, through the entry points a user calls:

    * **server**: ``fuse_fit`` (B), then ``serving.CompiledTransform(fitted,
      buckets=(88200, 176400, 352800), batch_sizes=(8, 32, 128))`` (buckets
      of half, one and two clip lengths; the main path's B joins the batch
      sizes), ``warmup()`` (2 x 3 x 3 = 18 calls at the default B);
      requests at the ladder's shape (bit-identical to ``fuse_forward``), two
      padded ones (interior frames within 1e-5 of the unbucketed call's
      largest value, ``tests/test_serving.py:31-34``) and an int16 one
      (bit-identical to the same request as float); each request's
      ``invert`` (Griffin-Lim: C and D) within the GL margin ``max(1.15 s,
      s + 0.02)`` (``tests/test_gl_parity.py:167``) of ``fitted.invert`` of
      the unbucketed features; no request adds an input shape after warmup;
      A launched once a forward, C twice and D seven times an invert; host
      and card times beside the direct calls';
    * **live session**: ``serving.StreamingSession`` over phase 4f's
      sessions (``OverlapAdd(1024, 256) + RealtimeSTFT(1024, 256, pghi)``,
      chunks of 4096): ``process`` bit-identical to the eager ``step`` /
      ``step_invert`` loop with a generator seeded alike, its spectral
      convergence within 1e-5 of ``scan_roundtrip(pghi)`` on the session
      kernels (the anchor-flip class, ROADMAP Queue 3), ms a chunk at B = 1
      and the sessions' B beside the scan's share a chunk;
    * **export**: ``save_transform`` / ``load_transform`` of the fitted
      chain (its forward bit-identical), ``export_program(fuse_forward(
      fitted, backend="kernel"), polymorphic_batch=True)`` saved to bytes,
      loaded and called at B = 8 and the main path's B (bit-identical to the
      direct call, one launch of A through the registered operator each),
      the same on int16 input, and ``invert_with_phase_fn`` on ``STFT(1024,
      256)`` within 1e-4.

    Every launch counter is 0 just before each call it checks and read just
    after."""
    import tempfile

    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import export, serving, streaming
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import glstep, spectral

    t_start = time.perf_counter()
    B, L = audio.shape[0], audio.shape[-1]
    buckets = (L // 2, L, 2 * L)
    batch_sizes = tuple(sorted({8, 32, 128, B}))
    log(f"[4k] serving and export: the flagship chain on {B} stereo clips of {L} samples; server buckets "
        f"{buckets}, batch sizes {batch_sizes}")

    def zero():
        spectral.reset_launches()
        glstep.reset_launches()

    def launched():
        return ({k: v for k, v in spectral.launches.items() if v}, {k: v for k, v in glstep.launches.items() if v})

    chain = T.Mono() + T.STFT(n_fft=N_FFT, hop_length=HOP) + T.Magnitude(
        mode="unipolar", contrast="log1p", mel=True, n_fft=N_FFT)
    zero()
    fitted = att.fuse_fit(chain)(audio)
    torch.cuda.synchronize()
    require(launched() == ({"fused_melspec_stats": 1}, {}), f"fuse_fit: launches {launched()}")
    direct = att.fuse_forward(fitted)

    # ---- the server
    server = serving.CompiledTransform(fitted, buckets=buckets, batch_sizes=batch_sizes)
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_warm = server.warmup(channels=(2,))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    expect = 2 * len(buckets) * len(batch_sizes)
    sp, gl = launched()
    log(f"  warmup: {n_warm} calls (expected {expect}) in {warm_s:.2f} s; launches {sp}, {gl}")
    require(n_warm == expect and sp == {"fused_melspec": expect // 2}
            and gl == {"gl_momentum_step": expect, "gl_momentum_chain": 7 * expect // 2},
            "warmup: wrong call count or launches")
    warm_shapes = {k: set(v) for k, v in server.shapes.items()}

    # the clips repeated where a request needs more rows or samples than they have
    rows = lambda n: torch.arange(n, device=dev) % B
    n1, n2 = round(L * 150000 / 176400), round(L * 300000 / 176400)   # 150000 and 300000 at 4 s
    requests = [
        ("the ladder's shape", audio, True),
        ("padded", audio[rows(20)][..., :n1].contiguous(), False),
        ("padded", torch.cat([audio[rows(5)], audio[rows(5)]], dim=-1)[..., :n2].contiguous(), False),
    ]
    target_of = fitted[2].invert
    stft_f = fitted[1]

    def convergence(rec, target):
        R = stft_f.forward(rec.reshape(target.shape[0], -1)).abs()
        n = min(R.shape[-2], target.shape[-2])
        return (torch.linalg.norm(R[:, :n] - target[:, :n]) / torch.linalg.norm(target[:, :n])).item()

    for label, x, exact in requests:
        b, n = x.shape[0], x.shape[-1]
        bb, nb = server._batch(b), server._bucket(n)
        zero()
        y = server.forward(x)
        torch.cuda.synchronize()
        sp, gl = launched()
        require(sp == {"fused_melspec": 1} and not gl, f"server forward {tuple(x.shape)}: launches {sp}, {gl}")
        ref = direct(x)
        require(tuple(y.shape) == tuple(ref.shape), f"server forward {tuple(x.shape)}: shape {tuple(y.shape)}")
        t_in = (n - N_FFT // 2) // HOP
        d = (y[:, :t_in] - ref[:, :t_in]).abs().max().item()
        scale = ref.abs().max().item()
        same = torch.equal(y, ref)
        log(f"  request {tuple(x.shape)} ({label}), served at ({bb}, .., {nb}): bit-identical to fuse_forward: "
            f"{same}; interior frames max |diff| {d:.3e} = {d / scale:.3e} of the scale (tol 1e-05)")
        if exact:
            require(same, f"request {tuple(x.shape)} at the ladder's shape is not bit-identical")
        require(d <= 1e-5 * scale, f"request {tuple(x.shape)}: interior frames off the unbucketed call")
        zero()
        rec = server.invert(y)
        torch.cuda.synchronize()
        sp, gl = launched()
        require(gl == {"gl_momentum_step": 2, "gl_momentum_chain": 7} and not sp,
                f"server invert {tuple(y.shape)}: launches {sp}, {gl}")
        rec_d = fitted.invert(ref)
        require(tuple(rec.shape) == tuple(rec_d.shape) and torch.isfinite(rec).all().item(),
                f"server invert {tuple(y.shape)}: shape {tuple(rec.shape)} against {tuple(rec_d.shape)}")
        target = target_of(ref)
        s_srv, s_dir = convergence(rec, target), convergence(rec_d, target)
        bound = max(1.15 * s_dir, s_dir + 0.02)
        log(f"    invert {tuple(rec.shape)}: spectral convergence served {s_srv:.5f}, direct {s_dir:.5f} "
            f"(must be < {bound:.5f})")
        require(s_srv < bound, f"server invert {tuple(y.shape)} converges worse than the direct invert")
        h_s, c_s = host_and_device_ms(lambda: server.forward(x), 10)
        h_d, c_d = host_and_device_ms(lambda: direct(x), 10)
        i_s, i_d = time_ms(lambda: server.invert(y), 2, 1), time_ms(lambda: fitted.invert(ref), 2, 1)
        fmt = lambda v: "not isolated" if v is None else f"{v:.3f}"
        log(f"    forward a call: host {h_s:.3f} ms, card {fmt(c_s)} ms; direct fuse_forward host {h_d:.3f}, "
            f"card {fmt(c_d)}; invert one call {i_s:.2f} ms, direct {i_d:.2f}")
        del y, ref, rec, rec_d, target
    new = {k: server.shapes[k] - warm_shapes[k] for k in warm_shapes}
    log(f"  input shapes handed to the chain after warmup: {sum(len(v) for v in new.values())} new "
        f"({len(warm_shapes['forward'])} forward, {len(warm_shapes['invert'])} invert shapes warmed)")
    require(not any(new.values()), f"requests added shapes after warmup: {new}")
    # raw PCM: its forwards warmed as production that sends int16 would
    # (the inverses run again at the shapes already warmed)
    n16 = server.warmup(channels=(2,), dtypes=(torch.int16,))
    warm_shapes = {k: set(v) for k, v in server.shapes.items()}
    log(f"  warmup(dtypes=(torch.int16,)): {n16} calls, {len(warm_shapes['forward'])} forward shapes warmed")
    pcm = torch.round(audio[: min(B, 32)] * 32767.0).to(torch.int16)
    zero()
    y_i = server.forward(pcm)
    torch.cuda.synchronize()
    require(launched() == ({"fused_melspec": 1}, {}), f"int16 request: launches {launched()}")
    same = torch.equal(y_i, server.forward(pcm.to(torch.float32) * 2.0 ** -15))
    log(f"  int16 request {tuple(pcm.shape)}: bit-identical to the same request as float: {same}")
    require(same, "int16 request differs from the pre-converted float request")
    del y_i
    new = {k: server.shapes[k] - warm_shapes[k] for k in warm_shapes}
    require(not any(new.values()), f"the int16 request added shapes after warmup: {new}")

    # ---- kernel A through the registered operator, against the direct wrapper
    mono = audio.mean(-2)
    kw = dict(mel_bank=fitted[2].mel_bank, offset=fitted[2].norm.offset, scale=fitted[2].norm.scale,
              contrast="log1p", taps=stft_f._window_taps)
    zero()
    y_op = spectral.fused_melspec_op(mono, N_FFT, HOP, **kw)
    torch.cuda.synchronize()
    require(spectral.op_calls["fused_melspec"] == 1 and spectral.launches["fused_melspec"] == 1,
            "the registered operator did not launch A once")
    y_dir = spectral.fused_melspec(mono, N_FFT, HOP, **kw)
    errs["A_op"] = abs_err(y_op, spectral.fused_melspec_reference(mono, N_FFT, HOP, **kw))
    require(torch.equal(y_op, y_dir), "A through the registered operator differs from the direct launch")
    log(f"  A through torch.ops.acids_transforms_tpu_torch.fused_melspec: bit-identical to the direct launch; "
        f"abs {errs['A_op']:.3e} against the plain version")
    del y_op, y_dir

    # ---- the live session
    ss = stream["ss"]
    sx = stream["sx"]
    SB, CH = sx.shape[0], STREAM_CHUNK
    n_ch = sx.shape[-1] // CH
    s_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi")
    seed = args.seed + 95
    sess = serving.StreamingSession(s_chain, CH, batch_shape=(SB,), inversion_mode="pghi", seed=seed)
    sess.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [sess.process(sx[:, i * CH:(i + 1) * CH]) for i in range(n_ch)]
    torch.cuda.synchronize()
    sess_ms = 1e3 * (time.perf_counter() - t0) / n_ch
    st = s_chain.init_state((SB,), mode="pghi")
    g = torch.Generator(device=dev).manual_seed(seed)
    same = True
    for i in range(n_ch):
        st, fr = s_chain.step(st, sx[:, i * CH:(i + 1) * CH])
        st, rec = s_chain.step_invert(st, fr.abs(), inversion_mode="pghi", generator=g)
        same = same and torch.equal(rec, outs[i])
    y_sess = torch.cat(outs, dim=-1)
    del outs
    log(f"  live session: {SB} sessions x {n_ch} chunks of {CH}, process bit-identical to the eager step / "
        f"step_invert loop (same seed): {same}")
    require(same, "the live session differs from the eager step loop")
    sc_of = stream["make_sc"](sx)
    for w in (spectral, glstep, ss):
        w.reset_launches()
    y_scan = streaming.scan_roundtrip(s_chain, sx, CH, "pghi", generator=stream["sgen"](95))
    torch.cuda.synchronize()
    got = {k: v for k, v in ss.launches.items() if v}
    require(got == {"session_magnitude": 1, "rt_pghi_phases": 1, "session_random_decode": 1},
            f"scan_roundtrip(pghi): launches {got}")
    s_sess, s_scan = sc_of(y_sess), sc_of(y_scan)
    log(f"    spectral convergence: session {s_sess:.6f}, scan_roundtrip(pghi) on the kernels {s_scan:.6f}, "
        f"|difference| {abs(s_sess - s_scan):.3e} (tol 1e-05); outputs max |diff| "
        f"{(y_sess - y_scan).abs().max().item():.3e} of {y_scan.abs().max().item():.3e}")
    require(abs(s_sess - s_scan) <= 1e-5, "the live session's convergence is off the session kernels'")
    del y_sess, y_scan
    for b in (1, SB):
        xs = sx[:b]
        s_b = serving.StreamingSession(s_chain, CH, batch_shape=(b,), inversion_mode="pghi", seed=seed)
        s_b.warmup()
        n_t = min(n_ch, 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_t):
            s_b.process(xs[:, i * CH:(i + 1) * CH])
        torch.cuda.synchronize()
        per = 1e3 * (time.perf_counter() - t0) / n_t
        # the two halves apart: encode a chunk, then decode its magnitudes
        s_b.reset()
        frames = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_t):
            frames.append(s_b.encode(xs[:, i * CH:(i + 1) * CH]).abs())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for f in frames:
            s_b.decode(f)
        torch.cuda.synchronize()
        enc, dec = 1e3 * (t1 - t0) / n_t, 1e3 * (time.perf_counter() - t1) / n_t
        scan_ms = time_ms(lambda: streaming.scan_roundtrip(s_chain, xs, CH, "pghi", generator=stream["sgen"](96)),
                          3, 1)
        log(f"    B={b:3d}: live session {per:.3f} ms a chunk (host clock, {n_t} chunks; encode {enc:.3f}, decode "
            f"{dec:.3f}); scan_roundtrip(pghi) {scan_ms / n_ch:.3f} ms a chunk ({scan_ms:.2f} ms for {n_ch}); a chunk "
            f"is {1e3 * CH / SR:.1f} ms of audio")

    # ---- export
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/flagship.npz"
        export.save_transform(fitted, path)
        loaded = export.load_transform(path, device=dev)
    same = torch.equal(att.fuse_forward(loaded)(audio), direct(audio))
    log(f"  save_transform -> load_transform(device='cuda'): forward bit-identical: {same}")
    require(same, "the loaded checkpoint's forward differs")
    fwd_k = att.fuse_forward(fitted, backend="kernel")
    blob = export.export_program(fwd_k, (audio[:8],), polymorphic_batch=True)
    prog = export.load_program(blob)
    nodes = [str(nd.target) for nd in prog.graph.nodes if nd.op == "call_function"]
    require("acids_transforms_tpu_torch.fused_melspec.default" in nodes, f"no fused_melspec node: {nodes}")
    for b in sorted({8, B}):
        zero()
        y_p = prog(audio[:b])
        torch.cuda.synchronize()
        n_a, n_op = spectral.launches["fused_melspec"], spectral.op_calls["fused_melspec"]
        same = torch.equal(y_p, fwd_k(audio[:b]))
        log(f"  exported program ({len(blob)} bytes, {len(nodes)} graph nodes) at B={b}: bit-identical to the direct "
            f"call: {same}; A launched {n_a} time(s), through the operator {n_op}")
        require(same and n_a == 1 and n_op == 1, f"exported program at B={b}")
    pcm8 = torch.round(audio[:8] * 32767.0).to(torch.int16)
    prog16 = export.load_program(export.export_program(fwd_k, (pcm8,), polymorphic_batch=True))
    pcm = torch.round(audio * 32767.0).to(torch.int16)
    same = torch.equal(prog16(pcm), prog(pcm.to(torch.float32) * 2.0 ** -15))
    log(f"  exported int16 program at B={B}: bit-identical to the float program on the converted input: {same}")
    require(same, "the int16 program differs from the float program")
    stft_t = T.STFT(n_fft=N_FFT, hop_length=HOP)
    spec = stft_t.forward(mono)
    back = export.invert_with_phase_fn(stft_t)(spec.abs(), spec.angle())
    e = rel_err(back, mono[..., : back.shape[-1]])
    log(f"  invert_with_phase_fn(STFT({N_FFT}, {HOP})): rel {e:.3e} (tol 1e-04)")
    require(e <= 1e-4, "invert_with_phase_fn roundtrip out of budget")
    log(f"  phase 4k {time.perf_counter() - t_start:.1f} s")


def parallel_phase(args, dev, audio, stream, errs):
    """Phase 4l: the parallel layer, ``utils`` and ``native`` on the card.

    The machine holds one card and NCCL refuses two ranks on one GPU, so the
    phase runs a **world of one** over NCCL (a ``HashStore``, rank 0 of 1),
    builds ``parallel.local_mesh()`` on ``"cuda"`` and destroys the group at
    its end.  Each ``mesh=`` leg then launches exactly the kernels of the
    direct call, and every deterministic output must be bit-identical to it
    (a one-rank all-reduce is the identity):

    * **log-mel chain** (phase 4's clips at full width): ``fuse_fit(mesh=)``
      (one B launch, the fitted chain bit-identical) then
      ``fuse_forward(mesh=)`` (one A launch, bit-identical), timed beside the
      direct calls in turns (``host_and_device_ms``);
    * **sessions** (phase 4f's sessions): ``scan_forward`` (R, bit-identical,
      its state too), ``scan_roundtrip(pghi)`` and ``scan_invert(random)``
      under ``mesh=`` with the direct routes' launches; the keyed modes draw
      from a generator of the shard's own, so their spectral convergence must
      lie within ``1.1 s + 1e-3`` of the direct route's;
    * **serving**: ``CompiledTransform(mesh=)`` at the ladder's shape (A once,
      bit-identical; the invert's C and D launches as the direct server's,
      within the GL margin) and ``StreamingSession(mesh=)`` for 3 chunks
      (the encode bit-identical to a direct session's);
    * **sequence parallel**: ``sequence_parallel_stft`` / ``istft`` on 1 x
      2^24 samples (1024/256 hann) within 1e-5 of the unsharded
      ``center=False`` STFT, the roundtrip within 1e-5 on the interior, timed;
    * **collectives** (``utils.record_collectives``): none on the forward,
      the sessions, the server and the export; three scalar all-reduces on
      the fit;
    * **export**: ``export_program(in_shardings=mesh)`` of the kernel forward,
      loaded and run (one A launch through the operator, bit-identical);
    * **trace**: ``utils.trace`` around one log-mel fit + forward: the kernel
      events and the host / device split (the port's first profiler trace);
    * **native**: ``STFT.pghi_exact`` (the native heap) on one 690 x 513
      clip beside the numpy heap in host ms (within 1e-3 rad on audible
      cells), and 128 clips written and read back as WAV (bit-identical)."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import export, parallel, serving, streaming, utils
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.native import build as native_build
    from acids_transforms_tpu_torch.native import pghi_native, wavio_native
    from acids_transforms_tpu_torch.ops.cuda import glstep, pghi_kernel, spectral
    from acids_transforms_tpu_torch.ops.fft import istft, stft
    from acids_transforms_tpu_torch.ops.pghi import pghi_heap_numpy
    from acids_transforms_tpu_torch.utils.collectives import collective_violations, record_collectives

    t_start = time.perf_counter()
    ss = stream["ss"]
    wrappers = (spectral, glstep, pghi_kernel, ss)

    def zero():
        for w in wrappers:
            w.reset_launches()

    def launched():
        torch.cuda.synchronize()
        return {k: v for w in wrappers for k, v in w.launches.items() if v}

    def run(fn):
        """``fn()`` with every counter at 0 before and read after, and the
        collectives it issued."""
        zero()
        with record_collectives() as recs:
            out = fn()
        return out, launched(), recs

    fmt = lambda v: "not isolated" if v is None else f"{v:.3f}"
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = parallel.local_mesh()
        B, L = audio.shape[0], audio.shape[-1]
        log(f"[4l] parallel layer: a world of one over NCCL ({dist.get_backend()}), mesh {mesh}; "
            f"{B} stereo clips of {L} samples")
        require(mesh.device_type == "cuda" and mesh.size() == 1 and mesh.mesh_dim_names == ("data",),
                "local_mesh() on the card")
        coll = {}

        # ---- the log-mel chain
        chain = T.Mono() + T.STFT(n_fft=N_FFT, hop_length=HOP) + T.Magnitude(
            mode="unipolar", contrast="log1p", mel=True, n_fft=N_FFT)
        fit_d, got_d, _ = run(lambda: att.fuse_fit(chain)(audio))
        fit_m, got_m, coll["fit"] = run(lambda: att.fuse_fit(chain, mesh=mesh)(audio))
        same = all(torch.equal(getattr(fit_m[2].norm, k), getattr(fit_d[2].norm, k)) for k in ("offset", "scale"))
        log(f"  fuse_fit(mesh=): launches {got_m} (direct {got_d}); fitted offset / scale bit-identical: {same}")
        require(got_m == got_d == {"fused_melspec_stats": 1} and same, "fuse_fit(mesh=) on a world of one")
        fwd_d, fwd_m = att.fuse_forward(fit_d), att.fuse_forward(fit_d, mesh=mesh)
        y_d, got_d, _ = run(lambda: fwd_d(audio))
        y_m, got_m, coll["forward"] = run(lambda: fwd_m(audio))
        same = torch.equal(y_m.to_local(), y_d)
        log(f"  fuse_forward(mesh=): {type(y_m).__name__} {tuple(y_m.shape)} placed {y_m.placements}, launches "
            f"{got_m} (direct {got_d}); bit-identical: {same}")
        require(got_m == got_d == {"fused_melspec": 1} and same, "fuse_forward(mesh=) on a world of one")
        legs = (("fit", lambda: att.fuse_fit(chain)(audio), lambda: att.fuse_fit(chain, mesh=mesh)(audio)),
                ("forward", lambda: fwd_d(audio), lambda: fwd_m(audio)))
        for name, f_d, f_m in legs:
            rows = {"direct": [], "mesh": []}
            for _ in range(3):     # in turns
                rows["direct"].append(host_and_device_ms(f_d, 10))
                rows["mesh"].append(host_and_device_ms(f_m, 10))
            for k, v in rows.items():
                host = statistics.median(h for h, _ in v)
                cards = [c for _, c in v if c is not None]
                card = statistics.median(cards) if cards else None
                log(f"    {name} {k:6s}: host {host:.3f} ms a call to enqueue, card {fmt(card)} ms a call "
                    f"(3 turns of 10 calls)")
        del y_d, y_m

        # ---- the streaming sessions
        sx, s_chain, sgen, CH = stream["sx"], stream["chain"], stream["sgen"], STREAM_CHUNK
        T_C = CH // HOP
        sc_of = stream["make_sc"](sx)
        (sp_d, st_d), got_d, _ = run(lambda: streaming.scan_forward(s_chain, sx, CH))
        (sp_m, st_m), got_m, coll["scan_forward"] = run(lambda: streaming.scan_forward(s_chain, sx, CH, mesh=mesh))
        leaves = lambda s: [l for l in torch.utils._pytree.tree_leaves(s) if isinstance(l, torch.Tensor)]
        same = torch.equal(sp_m.to_local(), sp_d) and all(
            torch.equal(a.to_local(), b) for a, b in zip(leaves(st_m), leaves(st_d)))
        log(f"  scan_forward(mesh=) on {tuple(sx.shape)}: launches {got_m} (direct {got_d}); spectra and state "
            f"bit-identical: {same}")
        require(got_m == got_d and got_d.get("session_encode") == 1 and same, "scan_forward(mesh=)")
        mags = sp_d.abs()
        keyed = (
            ("scan_roundtrip(pghi)", lambda g: streaming.scan_roundtrip(s_chain, sx, CH, "pghi", generator=g),
             lambda g: streaming.scan_roundtrip(s_chain, sx, CH, "pghi", generator=g, mesh=mesh)),
            ("scan_invert(random)", lambda g: streaming.scan_invert(s_chain, mags, T_C, "random", generator=g),
             lambda g: streaming.scan_invert(s_chain, mags, T_C, "random", generator=g, mesh=mesh)),
        )
        for i, (name, f_d, f_m) in enumerate(keyed):
            r_d, got_d, _ = run(lambda: f_d(sgen(100 + i)))
            r_m, got_m, coll[name] = run(lambda: f_m(sgen(100 + i)))
            s_d, s_m = sc_of(r_d), sc_of(r_m.to_local())
            log(f"  {name} (mesh=): launches {got_m} (direct {got_d}); spectral convergence {s_m:.5f}, direct "
                f"{s_d:.5f} (must be <= {1.1 * s_d + 1e-3:.5f})")
            require(got_m == got_d and got_d and s_m <= 1.1 * s_d + 1e-3, f"{name} under mesh=")
            del r_d, r_m
        del sp_d, sp_m, st_d, st_m, mags

        # ---- serving
        srv_d = serving.CompiledTransform(fit_d, buckets=(L,), batch_sizes=(B,))
        srv_m = serving.CompiledTransform(fit_d, buckets=(L,), batch_sizes=(B,), mesh=mesh)
        y_d, _, _ = run(lambda: srv_d.forward(audio))
        y_m, got_m, coll["serve_forward"] = run(lambda: srv_m.forward(audio))
        same = torch.equal(y_m.to_local(), y_d)
        log(f"  CompiledTransform(mesh=).forward at the ladder's shape {tuple(audio.shape)}: launches {got_m}; "
            f"bit-identical to the direct server: {same}")
        require(got_m == {"fused_melspec": 1} and same, "CompiledTransform(mesh=).forward")
        r_d, got_d, _ = run(lambda: srv_d.invert(y_d))
        r_m, got_m, coll["serve_invert"] = run(lambda: srv_m.invert(y_m))
        stft_f, target = fit_d[1], fit_d[2].invert(y_d)

        def convergence(rec):
            R = stft_f.forward(rec.reshape(target.shape[0], -1)).abs()
            n = min(R.shape[-2], target.shape[-2])
            return (torch.linalg.norm(R[:, :n] - target[:, :n]) / torch.linalg.norm(target[:, :n])).item()

        s_d, s_m = convergence(r_d), convergence(r_m.to_local())
        bound = max(1.15 * s_d, s_d + 0.02)
        log(f"  CompiledTransform(mesh=).invert: launches {got_m} (direct {got_d}); spectral convergence "
            f"{s_m:.5f}, direct {s_d:.5f} (must be < {bound:.5f})")
        require(got_m == got_d and s_m < bound, "CompiledTransform(mesh=).invert")
        del y_d, y_m, r_d, r_m, target
        SB = sx.shape[0]
        sess_chain = T.OverlapAdd(N_FFT, HOP) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi")
        s_d = serving.StreamingSession(sess_chain, CH, batch_shape=(SB,), inversion_mode="pghi")
        s_m = serving.StreamingSession(sess_chain, CH, batch_shape=(SB,), inversion_mode="pghi", mesh=mesh)
        same, recs_all, outs = True, [], []
        for i in range(3):
            chunk = sx[:, i * CH:(i + 1) * CH]
            with record_collectives() as recs:
                f_m = s_m.encode(chunk)
                outs.append(s_m.decode(f_m.abs()))
            recs_all += recs
            same = same and torch.equal(f_m.to_local(), s_d.encode(chunk))
        coll["session"] = recs_all
        fin = all(torch.isfinite(o.to_local()).all().item() and tuple(o.shape) == (SB, CH) for o in outs)

        def chunk_ms(sess):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(3, 6):
                sess.process(sx[:, i * CH:(i + 1) * CH])
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / 3

        ms_m, ms_d = chunk_ms(s_m), chunk_ms(s_d)
        log(f"  StreamingSession(mesh=) {SB} sessions x 3 chunks: encode bit-identical to a direct session's: "
            f"{same}; decodes finite ({fin}); then {ms_m:.1f} ms a chunk, a direct session {ms_d:.1f} "
            f"(process, host clock, 3 chunks)")
        require(same and fin, "StreamingSession(mesh=)")
        del outs

        # ---- sequence parallelism
        smesh = parallel.local_mesh(axis="seq")
        gen = torch.Generator(device=dev).manual_seed(args.seed + 97)
        xl = 0.3 * torch.randn((1, 1 << 24), generator=gen, device=dev)
        w = torch.hann_window(N_FFT, device=dev)
        sp, _, coll["seq_stft"] = run(lambda: parallel.sequence_parallel_stft(xl, N_FFT, HOP, w, smesh))
        ref = stft(xl, N_FFT, HOP, w, center=False)
        m = ref.shape[-2]
        e_stft = rel_err(torch.view_as_real(sp.to_local()[..., :m, :]), torch.view_as_real(ref))
        back = parallel.sequence_parallel_istft(sp, N_FFT, HOP, w, smesh).to_local()
        inner = slice(N_FFT, xl.shape[-1] - N_FFT)
        e_rt = abs_err(back[..., inner], xl[..., inner])
        inner_u = slice(N_FFT, (m - 1) * HOP)     # where both cover every sample with whole frames
        e_istft = rel_err(back[..., inner_u], istft(ref, N_FFT, HOP, w, center=False)[..., inner_u])
        t_s = time_ms(lambda: parallel.sequence_parallel_stft(xl, N_FFT, HOP, w, smesh), 3, 1)
        t_i = time_ms(lambda: parallel.sequence_parallel_istft(sp, N_FFT, HOP, w, smesh), 3, 1)
        t_u = time_ms(lambda: stft(xl, N_FFT, HOP, w, center=False), 3, 1)
        log(f"  sequence_parallel_stft on {tuple(xl.shape)} ({N_FFT}/{HOP} hann): {tuple(sp.shape)}, rel {e_stft:.3e} "
            f"against the unsharded center=False STFT (tol 1e-5); istft rel {e_istft:.3e} against the unsharded "
            f"istft on the interior, roundtrip abs {e_rt:.3e} on the interior (tol 1e-5); {t_s:.2f} ms / {t_i:.2f} ms (stft / "
            f"istft), unsharded stft {t_u:.2f} ms")
        require(e_stft <= 1e-5 and e_rt <= 1e-5 and e_istft <= 1e-5, "sequence parallel STFT / ISTFT")
        require(coll["seq_stft"] == [], "a world of one exchanges no halo")
        del xl, sp, ref, back

        # ---- export
        fwd_k = att.fuse_forward(fit_d, backend="kernel")
        blob = export.export_program(fwd_k, (audio[:8],), in_shardings=mesh)
        prog = export.load_program(blob, mesh=mesh)
        y_p, got, coll["export"] = run(lambda: prog(audio[:8]))
        n_op = spectral.op_calls["fused_melspec"]
        same = torch.equal(y_p.to_local(), fwd_k(audio[:8]))
        log(f"  export_program(in_shardings=mesh): {len(blob)} bytes, sharding {prog.sharding}; loaded and run: "
            f"launches {got}, through the operator {n_op}; bit-identical: {same}")
        require(same and got == {"fused_melspec": 1} and n_op == 1, "the sharded exported program")
        del y_p

        # ---- collectives
        log("  collectives a leg (utils.record_collectives): " + json.dumps(
            {k: [list(r) for r in v] for k, v in coll.items()}))
        for k, v in coll.items():
            if k == "fit":
                require([op for op, _ in v] == ["all_reduce"] * 3
                        and not collective_violations(v, allow_scalar_all_reduce=True),
                        f"fuse_fit(mesh=) issued {v}")
            else:
                require(not v, f"{k} issued collectives {v}")
    finally:
        dist.destroy_process_group()
    log(f"  process group destroyed: {not dist.is_initialized()}")

    # ---- the trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as log_dir:
        with utils.trace(log_dir) as prof:
            with utils.annotate("att_fit"):
                fitted = att.fuse_fit(chain)(audio)
            with utils.annotate("att_forward"):
                att.fuse_forward(fitted)(audio)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        with open(os.path.join(log_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    from torch.autograd import DeviceType

    dev_of = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    ev = prof.key_averages()
    spans = ("att_fit", "att_forward")     # the annotations' own ranges on the card's timeline
    kernels_ev = sorted((e for e in ev if e.device_type == DeviceType.CUDA and e.key not in spans), key=dev_of,
                        reverse=True)
    host_us = sum(e.self_cpu_time_total for e in ev if e.device_type == DeviceType.CPU)
    dev_us = sum(dev_of(e) for e in kernels_ev)
    names = {e.get("name") for e in events}
    kev = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e["dur"] for e in kev)
    span = max(e["ts"] + e["dur"] for e in kev) - min(e["ts"] for e in kev)
    log(f"  trace (utils.trace's trace.json, {len(names)} event names) of one log-mel fit + forward: {wall:.3f} ms of "
        f"wall (profiler on), host operators' self time {host_us / 1e3:.3f} ms, {len(kernels_ev)} kernels' card time "
        f"{dev_us / 1e3:.3f} ms; on the timeline {len(kev)} launches busy {busy / 1e3:.3f} ms of the "
        f"{span / 1e3:.3f} ms from the first to the last: the card idle {1 - busy / span:.3f} of it")
    for e in kernels_ev[:8]:
        log(f"    {e.key[:80]:80s} card {dev_of(e) / 1e3:8.3f} ms, calls {e.count}")
    require(set(spans) <= names, "the trace lacks the annotations")

    # ---- native
    t0 = time.perf_counter()
    native_build.load()
    log(f"  native library {native_build.lib_path()} loaded in {time.perf_counter() - t0:.2f} s (built at first use)")
    stft_1 = T.STFT(n_fft=N_FFT, hop_length=HOP)
    mag = stft_1.forward(audio[:1].mean(-2)).abs()[0]
    mag_np = mag.cpu().numpy()
    t0 = time.perf_counter()
    ph = stft_1.pghi_exact(mag)
    t_native = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ph_np = pghi_heap_numpy(mag_np, stft_1.gamma, N_FFT, HOP, stft_1._tol(None))
    t_numpy = 1e3 * (time.perf_counter() - t0)
    audible = mag_np > 1e-2 * mag_np.max()
    d_ph = float(np.abs(ph.cpu().numpy() - ph_np)[audible].max())
    same = np.array_equal(ph.cpu().numpy(), pghi_native.pghi(mag_np, stft_1.gamma, N_FFT, HOP, stft_1._tol(None)))
    log(f"  pghi_exact on one {tuple(mag.shape)} clip: native heap {t_native:.1f} ms, numpy heap {t_numpy:.1f} ms "
        f"(host clock); max phase difference on audible cells {d_ph:.3e} rad (tol 1e-3); the native call's: {same}")
    require(tuple(mag.shape) == (L // HOP + 1, N_FFT // 2 + 1) and d_ph < 1e-3 and same, "pghi_exact on the host")
    clips = audio.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i, c in enumerate(clips):
            wavio_native.save_wav(os.path.join(tmp, "clip%03d.wav" % i), c, SR)
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [wavio_native.load_wav(os.path.join(tmp, "clip%03d.wav" % i))[0] for i in range(len(clips))]
        t_r = time.perf_counter() - t0
        t0 = time.perf_counter()
        data, names = utils.import_data(tmp, sr=SR)
        t_i = time.perf_counter() - t0
    same = all(np.array_equal(b, c) for b, c in zip(back, clips)) and np.array_equal(data, clips)
    mb = clips.nbytes / 1e6
    log(f"  WAV: {len(clips)} clips ({mb:.1f} MB float32) written in {t_w:.3f} s, read in {t_r:.3f} s, import_data "
        f"of the directory {t_i:.3f} s (host clock, a warm file cache); bit-identical: {same}")
    require(same and len(names) == len(clips), "the WAV round trip of the clips")
    log(f"  phase 4l {time.perf_counter() - t_start:.1f} s")


def sweep_phase(args, dev, mono, bank, off, scl, taps, kernels, bound_of, wrappers):
    """Phase 6: kernel T, A's factored design built up stage by stage.  Runs
    the floor sweep through its entry point at the main path's shape (its
    own additive signal, as the tool has it) and counts its launches, prints
    each stage's increment beside that increment's own floor, holds every
    stage against its plain version on the main path's clips, and, at
    1408/352 where A keeps the factored front end (the main path's A takes
    the FFT route, 768 the smooth one, 896 its radix-7 instance), ``s7_full``
    bit-identical to A and within 10 % of phase 5's row A_factored; appends
    row T."""
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.cuda import spectral
    from acids_transforms_tpu_torch.ops.fft import taps_for_window
    from acids_transforms_tpu_torch.ops.windows import get_window
    from acids_transforms_tpu_torch.tools import sweep_kernel_floor as sweep_tool

    log("[6] kernel T: A's factored design built up stage by stage (the floor sweep), CUDA events over "
        f"{sweep_tool.RUNS} x {sweep_tool.ITERS} launches back to back")
    for w in wrappers:
        w.reset_launches()
    rows_sw = sweep_tool.sweep(args.batch, seed=args.seed)
    t_launches = spectral.launches["melspec_stage"]
    others = sum(v for w in wrappers for k, v in w.launches.items() if k != "melspec_stage")
    expect = len(spectral.STAGES) * (1 + sweep_tool.RUNS * sweep_tool.ITERS)
    require(t_launches == expect and others == 0,
            f"the sweep launched T {t_launches} times (expected {expect}) and other kernels {others} times")

    B = mono.shape[0]
    F, M, ov = N_FFT // 2 + 1, bank.shape[1], N_FFT // HOP
    tile_t = spectral._kernel_tile(N_FFT, HOP, taps)
    rows, n_fr, _ = spectral._prepare_rows(mono, N_FFT, HOP, True, tile_t)
    fr = float(B * n_fr)
    nnz = float((bank != 0).sum().item())
    # what each stage adds to the one it builds on: bytes moved once (rows
    # read and F columns written at s0; the bank read by the mel products),
    # and the operations of this design (the chunk product of every chunk a
    # frame starts at and its overlap - 1 halo chunks, counted once; the
    # twiddle combine, 4 multiply-adds per twiddle; the centre tap and the
    # power; 2 multiply-adds per neighbour tap; sqrt; 2 per nonzero of the
    # bank, or of the whole bank dense; log1p and the affine, 3 per output)
    added = {
        "s0_copy": (4.0 * rows.numel() + 4.0 * fr * F, 0.0),
        "s1_dots": (0.0, 4.0 * B * (n_fr + ov - 1) * HOP * F + fr * F),
        "s3_combine": (0.0, 8.0 * fr * F * ov + 5.0 * fr * F),
        "s4_taps": (0.0, 8.0 * fr * F * (len(taps) - 1)),
        "s5_mag": (0.0, fr * F),
        "s6_mel_banded": (4.0 * F * M, 2.0 * fr * nnz),
        "s7_full": (0.0, 3.0 * fr * M),
        "s8_mel_dense": (4.0 * F * M, 2.0 * fr * F * M),
    }
    res = {r["stage"]: r for r in rows_sw}
    for name, r in res.items():
        if name == "s3_combine":
            log(f"  s2_dots3: absent ({sweep_tool.S2_ABSENT})")
        floor, by = bound_of(*added[name])
        r["floor_ms"], r["floor_by"] = floor, by
        log(f"  {name}: {r['ms']:.3f} ms, +{r['increment_ms']:.3f} over {r['over'] or 'nothing'}; that "
            f"increment's floor {floor:.4f} ms by {by} ({100 * floor / r['increment_ms']:.1f}% of it "
            f"reached); {r['mframes_per_s']:.2f} M frames/s; {r['registers']} registers, "
            f"{r['spill_bytes']} B spilled")
    prep_ms = time_ms(lambda: spectral._prepare_rows(mono, N_FFT, HOP, True, tile_t), args.repeats)
    log(f"  _prepare_rows at {tuple(mono.shape)} -> {tuple(rows.shape)}: {prep_ms:.4f} ms "
        "(outside every kernel; A's phase-5 time includes it)")

    # every stage against its plain version on the main path's clips
    from acids_transforms_tpu_torch.ops.fft import _chunk_dft_matrices, _tables

    Ch, Sh = _tables(_chunk_dft_matrices, dev, N_FFT, HOP)
    c_max = torch.complex(torch.matmul(rows, Ch), torch.matmul(rows, Sh)).abs().max().item()
    shape_t = (N_FFT, HOP, n_fr, taps, bank, off, scl)
    out, t_err = {}, 0.0
    for name in spectral.STAGES:
        y_k = spectral.melspec_forward_stage(rows, name, *shape_t)
        y_p = spectral.melspec_forward_stage_reference(rows, name, *shape_t)
        torch.cuda.synchronize()
        require(tuple(y_k.shape) == tuple(y_p.shape) and torch.isfinite(y_k).all().item(),
                f"T {name}: bad output {tuple(y_k.shape)}")
        e_abs, e_rel = abs_err(y_k, y_p), rel_err(y_k, y_p)
        t_err = max(t_err, e_abs)
        out[name] = y_k
        if name == "s0_copy":
            log(f"  T {name}: bit-identical to plain: {torch.equal(y_k, y_p)}")
            require(torch.equal(y_k, y_p), "T s0_copy differs from its plain version")
        elif name == "s1_dots":
            # fp32 sums of 256 products in another order than cuBLAS
            log(f"  T {name}: abs {e_abs:.3e} = {e_abs / c_max:.3e} of the largest |C| (tol 1e-05)")
            require(e_abs <= 1e-5 * c_max, "T s1_dots disagrees with plain")
        else:
            # as A: a few 1e-7 per product through the combine, taps, sqrt, mel
            log(f"  T {name}: f32 rel {e_rel:.3e} (tol 2e-05)")
            require(e_rel <= 2e-5, f"T {name} disagrees with plain")
    e_86 = rel_err(out["s8_mel_dense"], out["s6_mel_banded"])
    log(f"  T s8 against s6 rel {e_86:.3e} (tol 1e-06, the banded product is exact), bit-identical: "
        f"{torch.equal(out['s8_mel_dense'], out['s6_mel_banded'])}")
    require(e_86 <= 1e-6, "T s8_mel_dense differs from s6_mel_banded")
    del out

    # s7_full is A where A is factored: at 1408/352 (2^7 11; phase 5's row
    # A_factored, the same clips, bank and affine), bit-identical, and its
    # time with _prepare_rows within 10 % of that row's (a fused_melspec call
    # in a run of calls back to back: _prepare_rows, then the kernel; so
    # _prepare_rows then s7_full, timed the same way)
    n_fft_g, hop_g = 1408, 352
    taps_g = taps_for_window(get_window("hann", n_fft_g, device=dev))
    bank_g = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft_g).mel_bank
    tile_g = spectral._kernel_tile(n_fft_g, hop_g, taps_g)
    require(spectral._kernel_plan(n_fft_g, hop_g, taps_g) == (tile_g, 0), "A must be factored at 1408/352")
    rows_g, n_fr_g, _ = spectral._prepare_rows(mono, n_fft_g, hop_g, True, tile_g)
    shape_g = (n_fft_g, hop_g, n_fr_g, taps_g, bank_g, off, scl)
    spectral.reset_launches()
    y_s7 = spectral.melspec_forward_stage(rows_g, "s7_full", *shape_g)
    y_a = spectral.fused_melspec(mono, n_fft_g, hop_g, mel_bank=bank_g, offset=off, scale=scl, contrast="log1p",
                                 taps=taps_g)
    torch.cuda.synchronize()
    same = torch.equal(y_s7, y_a)
    log(f"  T s7_full at {n_fft_g}/{hop_g} bit-identical to A (factored route, "
        f"{spectral.routes['fused_melspec:factored']} launch): {same}")
    require(same and spectral.routes["fused_melspec:factored"] == 1,
            f"T s7_full is not bit-identical to A at {n_fft_g}/{hop_g}")
    del y_s7, y_a
    a_row = next(r for r in kernels if r["name"] == "fused_melspec_factored")
    s7g_ms = device_ms(lambda: spectral.melspec_forward_stage(rows_g, "s7_full", *shape_g), args.repeats)

    def a_call():
        return spectral.fused_melspec(mono, n_fft_g, hop_g, mel_bank=bank_g, offset=off, scale=scl,
                                      contrast="log1p", taps=taps_g)

    def s7_call():
        return spectral.melspec_forward_stage(spectral._prepare_rows(mono, n_fft_g, hop_g, True, tile_g)[0],
                                              "s7_full", *shape_g)

    # both sides timed the same way, in turns: the card's time a call with the
    # calls queued behind a sleep kernel (host_and_device_ms), so that neither
    # side's host enqueue enters.  Back to back, a call reads its host's time
    # wherever that is the longer: at B = 8 a call's card time (about 0.24 ms
    # at 768/192 on the H100) is no longer than either wrapper's enqueue
    # (0.19-0.24 ms, each its own Python path), so the back-to-back ratio read
    # the two wrappers' host times and their jitter (-11 % to +4 % on
    # untouched code) while the card's times agree; phase 5's back-to-back row
    # stays beside it, reported only
    turns = {"A": [], "s7": []}
    hosts = {"A": [], "s7": []}
    for _ in range(3):
        for k, fn in (("A", a_call), ("s7", s7_call)):
            host, card = host_and_device_ms(fn, 20)
            require(card is not None, f"phase 6: the {k} calls outran the sleep kernel")
            turns[k].append(card)
            hosts[k].append(host)
    a_card, both_g = statistics.median(turns["A"]), statistics.median(turns["s7"])
    d_full = both_g / a_card - 1.0
    d_b2b = device_ms(s7_call, args.repeats) / a_row["ms"] - 1.0
    # the form this check had before A left the factored route at the main
    # shape, kept in the log beside it: the two parts timed apart and added
    # (_prepare_rows one call alone, host time included), which counts the
    # launch gaps of both parts
    prep_g = time_ms(lambda: spectral._prepare_rows(mono, n_fft_g, hop_g, True, tile_g), args.repeats)
    d_apart = (s7g_ms + prep_g) / a_row["ms"] - 1.0
    log(f"  _prepare_rows then s7_full at {n_fft_g}/{hop_g}, the card's time a call in turns with A's (calls "
        f"behind a sleep kernel): {both_g:.4f} ms against A_factored's {a_card:.4f} ms: {100 * d_full:+.1f}% "
        f"(tol 10 %; turns A {', '.join(f'{v:.4f}' for v in turns['A'])}, s7 "
        f"{', '.join(f'{v:.4f}' for v in turns['s7'])}; host enqueue a call A {statistics.median(hosts['A']):.4f}, s7 "
        f"{statistics.median(hosts['s7']):.4f} ms); back to back against phase 5's row "
        f"{a_row['ms']:.3f} ms: {100 * d_b2b:+.1f}%, s7_full alone {100 * (s7g_ms / a_row['ms'] - 1):+.1f}%; timed "
        f"apart, s7_full + _prepare_rows {s7g_ms:.3f} + {prep_g:.3f} ms: {100 * d_apart:+.1f}% (reported only)")
    require(abs(d_full) <= 0.10, "T s7_full with _prepare_rows is not within 10 % of A_factored's time")
    del rows_g
    s7_ms = res["s7_full"]["ms"]
    plain = time_ms(lambda: spectral.melspec_forward_stage_reference(rows, "s7_full", *shape_t),
                    max(1, args.repeats // 2))
    # T at the main shape computes A's function: A's bound and library call;
    # its design is the factored one, whose operations the stages add up to
    a_main = next(r for r in kernels if r["name"] == "fused_melspec")
    design = sum(added[k][1] for k in added if k not in ("s0_copy", "s8_mel_dense"))
    kernels.append(dict(
        name="melspec_stage", route="cuda", source="acids_transforms_tpu_torch/csrc/spectral.cu",
        replaces="tools/sweep_kernel_floor.py:110", launches=t_launches, max_abs_err=t_err, ms=s7_ms,
        kernel_ms=s7_ms, plain_ms=plain, bound_ms=a_main["bound_ms"], bound_by=a_main["bound_by"],
        library_ms=a_main["library_ms"], design_fma_ceiling_ms=1e3 * design / PEAK_FP32_FLOPS))
    log(f"  T melspec_stage (s7_full): {s7_ms:.3f} ms, plain {plain:.3f} ms, {t_launches} launches in the "
        f"sweep; bound and library as A's at the main shape (A's FFT route there: {a_main['ms']:.3f} ms)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128, help="stereo clips on the main path")
    ap.add_argument("--streams", type=int, default=64, help="mono streaming sessions of 4 s (phase 4f)")
    ap.add_argument("--seconds", type=float, default=4.0, help="clip length")
    ap.add_argument("--repeats", type=int, default=5, help="timed repeats per kernel (median)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    import acids_transforms_tpu_torch as att
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops import pghi as pghi_ops
    from acids_transforms_tpu_torch.ops.cuda import _build, frames_fft as ff, glstep, pghi_kernel, spectral
    from acids_transforms_tpu_torch.ops.fft import istft, taps_for_window
    from acids_transforms_tpu_torch.ops.windows import dgt_gamma, gaussian_dgt_window, get_window

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32

    # ------------------------------------------------------------ 1. device
    smi = nvidia_smi_line()
    log(f"[1] device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ------------------------------------------------------------- 2. build
    lib = _build.load_library()
    log(f"[2] kernels built and loaded in {_build.build_seconds():.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("    " + line.strip())
    for name, res in _build.kernel_resources().items():
        if any(k in name for k in ("gl_polish", "rt_pghi", "session_encode_kernel", "session_roundtrip_fft")):
            log(f"    {name}: {res['registers']} registers, spill stores / loads {res['spill_stores']} / "
                f"{res['spill_loads']} B")
    # E's and F's smooth instances (kFrontSmooth = 3 in the mangled name):
    # at most 128 registers (two blocks an SM) and no spill
    smooth_res = melspec_smooth_resources(_build.kernel_resources())
    for name, res in smooth_res.items():
        log(f"    {name}: {res['registers']} registers, spill stores / loads {res.get('spill_stores', 0)} / "
            f"{res.get('spill_loads', 0)} B (the melspec smooth route)")
    require(len(smooth_res) == 6 and all(r["registers"] <= 128 and not r.get("spill_stores") and not r.get("spill_loads")
                                         for r in smooth_res.values()),
            "the melspec smooth instances: six, at most 128 registers, no spill")
    # G's and H's smooth instances and their radix-7 instances: at most 128
    # registers (two blocks an SM); their spill reported (the FFT instance of
    # G spills 4 B)
    repr_res = repr_smooth_resources(_build.kernel_resources())
    for name, res in repr_res.items():
        log(f"    {name} smooth instance: {res['registers']} registers, spill stores / loads "
            f"{res.get('spill_stores', 0)} / {res.get('spill_loads', 0)} B (the representations' smooth route"
            f"{', radix 7' if 'seven' in name else ''})")
    require(set(repr_res) == {"G", "H", "G int16", "H int16", "G seven", "H seven", "G seven int16",
                              "H seven int16"} and all(r["registers"] <= 128 for r in repr_res.values()),
            f"the representations' smooth and radix-7 instances: eight, at most 128 registers (found "
            f"{sorted(repr_res)})")
    for tile_t in spectral.TILES:
        require(
            lib.att_melspec_smem_bytes(tile_t, HOP, N_FFT // HOP, N_FFT // 2 + 1)
            == spectral._smem_bytes(tile_t, HOP, N_FFT // HOP, N_FFT // 2 + 1),
            "melspec shared-memory size: wrapper and source disagree",
        )
    for n_fft_s, hop_s in ((N_FFT, HOP), (512, 64), (2048, 512)):
        kp, rows = pghi_kernel._k_padded(n_fft_s // 2 + 1), pghi_kernel._pick_rows(n_fft_s, hop_s)
        require(
            lib.att_pghi_synth_smem_bytes(rows, n_fft_s // hop_s, kp)
            == pghi_kernel._synth_smem_bytes(rows, n_fft_s // hop_s, kp),
            "PGHI synthesis shared-memory size: wrapper and source disagree",
        )
    # K's recurrence: the plan's and the walk's blocks as _phases_plan picks
    # them, and what the entries refuse before any launch (a plan tile over 4
    # frames, more than 4096 bins, a walk block too narrow for its bins, a
    # ring of neither 2 nor 4 slots)
    for f_s in (2, 33, 257, 513, 1025, 2049, 2232, 2233, 4096):
        for t_s in (1, 3, 690):
            tile_s, _, slots_s = pghi_kernel._phases_plan(f_s, t_s)
            require(lib.att_pghi_plan_smem_bytes(f_s, tile_s) == pghi_kernel._plan_smem_bytes(f_s, tile_s)
                    <= ff.MAX_SMEM and lib.att_pghi_walk_smem_bytes(f_s, slots_s)
                    == pghi_kernel._walk_smem_bytes(f_s, slots_s) <= ff.MAX_SMEM,
                    "K's plan / walk shared-memory size: wrapper and source disagree")
    require(lib.att_pghi_plan(None, None, None, None, None, 1, 32, 513, 1.0, 1.0, 1.0, 0, 5, None) == 1
            and lib.att_pghi_plan(None, None, None, None, None, 1, 32, 4097, 1.0, 1.0, 1.0, 0, 1, None) == 1
            and lib.att_pghi_walk(None, None, None, 1, 32, 513, 0, 2, 16, None) == 1
            and lib.att_pghi_walk(None, None, None, 1, 32, 513, 0, 3, 3, None) == 1,
            "K's recurrence: a plan tile over 4 frames, 4097 bins, 2 walk warps for 513 bins or 3 ring slots "
            "must be refused")
    for tile_t, chain in ((64, 4), (64, 1), (32, 3)):
        require(
            lib.att_gl_smem_bytes(tile_t, chain, N_FFT // HOP, HOP)
            == glstep._smem_bytes(tile_t, chain, N_FFT // HOP, HOP),
            "GL shared-memory size: wrapper and source disagree",
        )
    for n_fft_s, hop_s in ((N_FFT, HOP), (2048, 512), (4096, 1024)):
        ov_s, f_s = n_fft_s // hop_s, n_fft_s // 2 + 1
        for tile_t in spectral.TILES:
            for st in (0, 1):
                require(lib.att_repr_smem_bytes(tile_t, hop_s, ov_s, f_s, st)
                        == spectral._repr_smem_bytes(tile_t, hop_s, ov_s, f_s, bool(st)),
                        "representation shared-memory size: wrapper and source disagree")
        for rows in (6, 7, 15, 16, 32):
            kp = pghi_kernel._k_padded(f_s)
            require(lib.att_gl_fullk_smem_bytes(rows, ov_s, hop_s, kp)
                    == glstep._fullk_smem_bytes(rows, ov_s, hop_s, kp),
                    "full-K GL shared-memory size: wrapper and source disagree")
    from acids_transforms_tpu_torch.ops.cuda import stream_step as ss

    for f_s in (2, 33, 257, 513, 1025, 2049, 4096):
        for t_c in (1, 8, 16, 22, 43):
            st_s = ss._rt_plan(f_s, t_c)[0]
            require(lib.att_rt_pghi_smem_bytes(f_s, st_s) == ss._rt_smem_bytes(f_s, st_s)
                    <= ff.MAX_SMEM, "RT-PGHI shared-memory size: wrapper and source disagree")
    # a stage beyond the kernel's limit (a chunk of 32 frames as one stage)
    # or a block beyond 24 warps is refused before any launch
    require(lib.att_rt_pghi_phases(None, None, None, None, None, 1, 32, 32, 513, 32, 1e-3, 1.0, 1.0, 1.0,
                                   ss._RT_STAGE + 1, 1, 1, None) == 1
            and lib.att_rt_pghi_phases(None, None, None, None, None, 1, 32, 32, 513, 32, 1e-3, 1.0, 1.0, 1.0,
                                       ss._RT_STAGE, ss._RT_STAGE, ss._RT_WARPS - ss._RT_STAGE + 1, None) == 1,
            "RT-PGHI: a stage beyond 16 frames or more than 24 warps must be refused")
    for n_fft_s, hop_s in ((N_FFT, HOP), (512, 128), (2048, 512), (4096, 1024), (1024, 128)):
        ov_s, kp, kn = n_fft_s // hop_s, ss._k_padded(n_fft_s // 2 + 1), ss._k_analysis(n_fft_s)
        for rows in (1, 7, 16, 32):
            require(lib.att_session_encode_smem_bytes(rows, hop_s, kn) == ss._encode_smem_bytes(rows, hop_s, kn)
                    and lib.att_session_roundtrip_smem_bytes(rows, ov_s, hop_s, kn, kp)
                    == ss._roundtrip_smem_bytes(rows, ov_s, hop_s, kn, kp)
                    and lib.att_session_decode_smem_bytes(rows, ov_s, kp) == ss._decode_smem_bytes(rows, ov_s, kp),
                    "session kernels' shared-memory size: wrapper and source disagree")
    # the smooth route of R / the magnitude encode, of L / M and of the
    # decodes (P, S, O's synthesis): every layout at every size it takes from
    # 64 to 4096 with hop n_fft / 4, at the plans' team counts and fewer
    for n_fft_s in [n for n in range(64, 4097, 4) if ff.fft_covers_smooth(n) and (n // 4) % 4 == 0]:
        hop_s = n_fft_s // 4
        (rows_e, teams_e), (rows_r, teams_r) = ss._encode_plan(n_fft_s, hop_s), ss._roundtrip_plan(n_fft_s, hop_s)
        plans_d = [ss._decode_plan(n_fft_s, hop_s, narrow) for narrow in (None, ss.PROJECT_SYN_ROWS)]
        require(teams_e > 0 and teams_r > 0 and all(tm > 0 for _, tm in plans_d)
                and ss.session_route(n_fft_s, "decode") == "smooth",
                f"{n_fft_s}/{hop_s}: the encode, the roundtrip and the decode must take the smooth route")
        for tm in sorted({1, teams_e}):
            require(lib.att_session_encode_fft_smem_bytes(rows_e, hop_s, n_fft_s, tm)
                    == ss._encode_fft_smem_bytes(rows_e, hop_s, n_fft_s, tm)
                    and lib.att_session_roundtrip_fft_smem_bytes(rows_r, 4, hop_s, tm)
                    == ss._roundtrip_fft_smem_bytes(rows_r, 4, hop_s, tm),
                    f"{n_fft_s}/{hop_s}: the smooth route's shared-memory size: wrapper and source disagree")
        for rows_d, teams_d in plans_d:
            for tm in sorted({1, teams_d}):
                require(lib.att_session_decode_fft_smem_bytes(rows_d, hop_s, n_fft_s, tm)
                        == ss._decode_fft_smem_bytes(rows_d, hop_s, n_fft_s, tm) <= ff.MAX_SMEM,
                        f"{n_fft_s}/{hop_s}: the decode's smooth shared-memory size: wrapper and source disagree")
    # R / the magnitude encode, L / M and the decodes (P, S, O's synthesis)
    # on the smooth route's radix-7 instances: every even 7-smooth n_fft with
    # a factor 7 from 64 to 4096 at every overlap the gates take (hop a
    # multiple of 4), the layouts at the plans' team counts and one team
    # (the decode's plan and O's narrow blocks), the roundtrip on the
    # product route where its smooth block does not fit (4032 at overlap 4,
    # 6, 7, 8); the six instances' registers (at most 128: two blocks an SM;
    # the decode's plan counts ss.DECODE_SEVEN_BLOCKS) and spill
    n_seven = n_seven_product = 0
    for n_fft_s in [n for n in range(64, 4097, 2) if ff.fft_covers_smooth7(n) and not ff.fft_covers_smooth(n)]:
        for ov_s in range(2, 9):
            if n_fft_s % ov_s or (n_fft_s // ov_s) % 4:
                continue
            hop_s = n_fft_s // ov_s
            (rows_e, teams_e), (rows_r, teams_r) = ss._encode_plan(n_fft_s, hop_s), ss._roundtrip_plan(n_fft_s, hop_s)
            route_r = ss.session_route(n_fft_s, "roundtrip", hop_s)
            plans_d = [ss._decode_plan(n_fft_s, hop_s, narrow) for narrow in (None, ss.PROJECT_SYN_ROWS)]
            require(teams_e > 0 and ss.session_route(n_fft_s, "encode") == "smooth"
                    and (teams_r > 0) == (route_r == "smooth") and ss.session_route(n_fft_s, "decode") == "smooth"
                    and all(tm > 0 for _, tm in plans_d),
                    f"{n_fft_s}/{hop_s}: the encode, the roundtrip (where it fits) and the decode must take the "
                    "smooth route")
            for rows_d, teams_d in plans_d:
                for tm in sorted({1, teams_d}):
                    require(lib.att_session_decode_fft_smem_bytes(rows_d, hop_s, n_fft_s, tm)
                            == ss._decode_fft_smem_bytes(rows_d, hop_s, n_fft_s, tm) <= ff.MAX_SMEM,
                            f"{n_fft_s}/{hop_s}: the decode's radix-7 shared-memory size: wrapper and source "
                            "disagree")
            n_seven_product += route_r == "product"
            for tm in sorted({1, teams_e}):
                require(lib.att_session_encode_fft_smem_bytes(rows_e, hop_s, n_fft_s, tm)
                        == ss._encode_fft_smem_bytes(rows_e, hop_s, n_fft_s, tm),
                        f"{n_fft_s}/{hop_s}: the encode's radix-7 shared-memory size: wrapper and source disagree")
            require(ss._encode_fft_smem_bytes(rows_e, hop_s, n_fft_s, teams_e) <= ff.MAX_SMEM,
                    f"{n_fft_s}/{hop_s}: the encode's radix-7 plan exceeds shared memory")
            if teams_r:
                for tm in sorted({1, teams_r}):
                    require(lib.att_session_roundtrip_fft_smem_bytes(rows_r, ov_s, hop_s, tm)
                            == ss._roundtrip_fft_smem_bytes(rows_r, ov_s, hop_s, tm),
                            f"{n_fft_s}/{hop_s}: the roundtrip's radix-7 shared-memory size: wrapper and source "
                            "disagree")
            n_seven += 1
    seven_res = session_seven_resources(_build.kernel_resources())
    for name, res in seven_res.items():
        log(f"    {name} radix-7 instance: {res['registers']} registers, spill stores / loads "
            f"{res.get('spill_stores', 0)} / {res.get('spill_loads', 0)} B")
    require(set(seven_res) == {"R", "N", "L", "M", "P", "S"}
            and all(r["registers"] <= 128 for r in seven_res.values()),
            f"the radix-7 instances: R, N's encode, L, M, P and S, at most 128 registers (found {sorted(seven_res)})")
    d_regs = max(seven_res["P"]["registers"], seven_res["S"]["registers"])
    d_blocks = seven_blocks(d_regs)
    log(f"    the decode's radix-7 instances: {d_regs} registers, {d_blocks} blocks an SM by registers (the plan "
        f"counts {ss.DECODE_SEVEN_BLOCKS})")
    require(d_blocks == ss.DECODE_SEVEN_BLOCKS, "the decode's radix-7 plan counts another number of blocks an SM "
            "than the instance's registers allow")
    log(f"    the radix-7 instances: plans and shared-memory sizes agree at {n_seven} shapes, {n_seven_product} "
        f"roundtrips on the product route (encode / roundtrip / decode / O's narrow synthesis at 1344/336 "
        f"{ss._encode_plan(1344, 336)} / {ss._roundtrip_plan(1344, 336)} / {ss._decode_plan(1344, 336)} / "
        f"{ss._decode_plan(1344, 336, ss.PROJECT_SYN_ROWS)}, 896/224 {ss._encode_plan(896, 224)} / "
        f"{ss._roundtrip_plan(896, 224)} / {ss._decode_plan(896, 224)} / "
        f"{ss._decode_plan(896, 224, ss.PROJECT_SYN_ROWS)} as (rows, FFTs))")
    require(n_seven == 199 and n_seven_product == 4, "the radix-7 route: 199 shapes, 4 roundtrips on the product")
    # E / F (and A / B) on the smooth route: every shape the route takes
    # (hop a multiple of 32, overlap 2 to 8), the plan's layout and the
    # other tiles at its team count and one team
    n_smooth = 0
    for n_fft_s in [n for n in range(64, 4097, 2) if ff.fft_covers_smooth(n)]:
        for ov_s in range(2, 9):
            if n_fft_s % ov_s or (n_fft_s // ov_s) % 32:
                continue
            hop_s, f_s = n_fft_s // ov_s, n_fft_s // 2 + 1
            tile_t, teams = spectral._kernel_plan(n_fft_s, hop_s, None)
            require(teams > 0 and spectral.melspec_route(n_fft_s) == "smooth"
                    and spectral._kernel_plan(n_fft_s, hop_s, (0.5, -0.25)) == (tile_t, teams),
                    f"{n_fft_s}/{hop_s}: E, F, A and B must take the smooth route")
            for t_s in spectral.TILES:
                for tm in sorted({1, teams}):
                    require(lib.att_melspec_fft_smem_bytes(t_s, hop_s, ov_s, f_s, tm)
                            == spectral._fft_smem_bytes(t_s, hop_s, ov_s, f_s, tm),
                            f"{n_fft_s}/{hop_s}: the melspec smooth route's shared-memory size: wrapper and "
                            "source disagree")
            require(spectral._fft_smem_bytes(tile_t, hop_s, ov_s, f_s, teams) <= ff.MAX_SMEM,
                    f"{n_fft_s}/{hop_s}: the smooth plan exceeds shared memory")
            # G and H (full-K and with taps) on the smooth route at the same
            # shapes: every plan on it, each layout at the plan's team count
            for st in (0, 1):
                for second, sel in spectral.SECONDS.items():
                    for mel in ((0,) if st else (0, 1)):
                        tile_r, teams_r = spectral._repr_plan(n_fft_s, hop_s, None, bool(st), second, bool(mel))
                        require(teams_r > 0 and spectral._repr_plan(n_fft_s, hop_s, (0.5, -0.25), bool(st), second,
                                                                    bool(mel)) == (tile_r, teams_r),
                                f"{n_fft_s}/{hop_s}: G and H must take the smooth route")
                        for t_s in spectral.FFT_TILES:
                            for tm in sorted({1, teams_r}):
                                require(lib.att_repr_fft_smem_bytes(t_s, hop_s, ov_s, f_s, tm, st, sel, mel)
                                        == spectral._repr_fft_smem_bytes(t_s, hop_s, ov_s, f_s, tm, bool(st),
                                                                         second, bool(mel)),
                                        f"{n_fft_s}/{hop_s}: the representations' smooth shared-memory size: "
                                        "wrapper and source disagree")
            n_smooth += 1
    log(f"    the melspec and representation smooth route: plans and shared-memory sizes agree at {n_smooth} shapes "
        f"(768/256 {spectral._kernel_plan(768, 256, None)}, 768/192 {spectral._kernel_plan(768, 192, None)}, "
        f"1920/480 {spectral._kernel_plan(1920, 480, None)} as (frame tile, FFTs side by side); G / H full-K with "
        f"the IF and a mel bank at 768/256 {spectral._repr_plan(768, 256, None, False, 'if', True)} / "
        f"{spectral._repr_plan(768, 256, None, True, 'if', False)}, G / H Polar with taps at 768/192 "
        f"{spectral._repr_plan(768, 192, (0.5, -0.25), False, 'phase', True)} / "
        f"{spectral._repr_plan(768, 192, (0.5, -0.25), True, 'phase', False)})")
    # E / F (and A / B) on the smooth route's radix-7 instance: every even
    # 7-smooth shape with a factor 7 the gate takes (hop a multiple of 32,
    # overlap 2 to 8; 42 shapes), the plan's layout against the source's at
    # the plan's team count and one team; 4032/2016 refused on both routes
    # (no smooth plan, no product tile); the six instances' registers (at
    # most 128: two blocks an SM, as _pick_smooth_plan counts) and spill.
    # G and H (full-K and with taps, every second, with and without the
    # bank) on their radix-7 instance at the same shapes, every plan's layout
    # against the source's at the plan's team count and one team, but G with
    # the IF and a bank at 4032/2016, which keeps its product / factored
    # tile (8 frames; no smooth block fits)
    mseven_res = melspec_smooth_resources(_build.kernel_resources(), seven=True)
    for name, res in mseven_res.items():
        log(f"    {name}: {res['registers']} registers, spill stores / loads {res.get('spill_stores', 0)} / "
            f"{res.get('spill_loads', 0)} B (the melspec radix-7 instance)")
    require(len(mseven_res) == 6 and all(r["registers"] <= 128 for r in mseven_res.values()),
            f"the melspec radix-7 instances: six, at most 128 registers (found {len(mseven_res)})")
    n_seven_m = n_seven_refused = n_seven_r = n_seven_r_kept = 0
    for n_fft_s in [n for n in range(64, 4097, 2) if ff.fft_covers_smooth7(n) and n % 7 == 0]:
        for ov_s in range(2, 9):
            if n_fft_s % ov_s or (n_fft_s // ov_s) % 32:
                continue
            hop_s, f_s = n_fft_s // ov_s, n_fft_s // 2 + 1
            require(spectral.melspec_route(n_fft_s) == "smooth",
                    f"{n_fft_s}/{hop_s}: E, F, A, B, G and H must take the smooth route")
            for st in (0, 1):
                for second, sel in spectral.SECONDS.items():
                    for mel in ((0,) if st else (0, 1)):
                        tile_r, teams_r = spectral._repr_plan(n_fft_s, hop_s, None, bool(st), second, bool(mel))
                        require(spectral._repr_plan(n_fft_s, hop_s, (0.5, -0.25), bool(st), second, bool(mel))
                                == (tile_r, teams_r), f"{n_fft_s}/{hop_s}: G / H with taps plan otherwise")
                        if teams_r == 0:
                            require((n_fft_s, hop_s, st, second, mel) == (4032, 2016, 0, "if", 1)
                                    and tile_r == 8 and lib.att_repr_smem_bytes(tile_r, hop_s, ov_s, f_s, st)
                                    == spectral._repr_smem_bytes(tile_r, hop_s, ov_s, f_s, False) <= ff.MAX_SMEM,
                                    f"{n_fft_s}/{hop_s}: G / H must take the radix-7 instance")
                            n_seven_r_kept += 1
                            continue
                        for tm in sorted({1, teams_r}):
                            require(lib.att_repr_fft_smem_bytes(tile_r, hop_s, ov_s, f_s, tm, st, sel, mel)
                                    == spectral._repr_fft_smem_bytes(tile_r, hop_s, ov_s, f_s, tm, bool(st),
                                                                     second, bool(mel)),
                                    f"{n_fft_s}/{hop_s}: the representations' radix-7 shared-memory size: "
                                    "wrapper and source disagree")
                        require(spectral._repr_fft_smem_bytes(tile_r, hop_s, ov_s, f_s, teams_r, bool(st), second,
                                                              bool(mel)) <= ff.MAX_SMEM,
                                f"{n_fft_s}/{hop_s}: G / H's radix-7 plan exceeds shared memory")
                        n_seven_r += 1
            n_seven_m += 1
            if spectral._pick_smooth_plan(n_fft_s, hop_s) is None:
                for tp in (None, (0.5, -0.25)):
                    try:
                        spectral._kernel_plan(n_fft_s, hop_s, tp)
                        require(False, f"{n_fft_s}/{hop_s}: no smooth plan, the plan must raise")
                    except NotImplementedError:
                        pass
                require(spectral._pick_tile(hop_s, ov_s, f_s) is None,
                        f"{n_fft_s}/{hop_s}: a product tile fits where the smooth route refuses")
                n_seven_refused += 1
                continue
            tile_t, teams = spectral._kernel_plan(n_fft_s, hop_s, None)
            require(teams > 0 and spectral._kernel_plan(n_fft_s, hop_s, (0.5, -0.25)) == (tile_t, teams),
                    f"{n_fft_s}/{hop_s}: E, F, A and B must take the radix-7 instance")
            for tm in sorted({1, teams}):
                require(lib.att_melspec_fft_smem_bytes(tile_t, hop_s, ov_s, f_s, tm)
                        == spectral._fft_smem_bytes(tile_t, hop_s, ov_s, f_s, tm),
                        f"{n_fft_s}/{hop_s}: the melspec radix-7 shared-memory size: wrapper and source disagree")
            require(spectral._fft_smem_bytes(tile_t, hop_s, ov_s, f_s, teams) <= ff.MAX_SMEM,
                    f"{n_fft_s}/{hop_s}: the radix-7 plan exceeds shared memory")
    log(f"    the melspec radix-7 instance: {n_seven_m} shapes, {n_seven_m - n_seven_refused} plans whose shared-memory "
        f"sizes agree, {n_seven_refused} refused (4032/2016); plans 896/224 {spectral._kernel_plan(896, 224, None)}, "
        f"1568/224 {spectral._kernel_plan(1568, 224, None)}, 1344/448 {spectral._kernel_plan(1344, 448, None)} as "
        f"(frame tile, FFTs side by side)")
    require(n_seven_m == 42 and n_seven_refused == 1, "the melspec radix-7 route: 42 shapes, 4032/2016 refused")
    log(f"    G and H on the radix-7 instance: {n_seven_r} plans of 42 shapes (each second, with and without the "
        f"bank; G and H alike) whose shared-memory sizes agree, {n_seven_r_kept} on the product / factored tile "
        f"(G with the IF and a bank at 4032/2016: {spectral._repr_plan(4032, 2016, None, False, 'if', True)}); "
        f"896/224 G / H with the IF {spectral._repr_plan(896, 224, None, False, 'if', True)} / "
        f"{spectral._repr_plan(896, 224, None, True, 'if', False)}, G / H Polar with taps "
        f"{spectral._repr_plan(896, 224, (0.5, -0.25), False, 'phase', True)} / "
        f"{spectral._repr_plan(896, 224, (0.5, -0.25), True, 'phase', False)}, 1568/224 G Polar with taps "
        f"{spectral._repr_plan(1568, 224, (0.5, -0.25), False, 'phase', True)} as (frame tile, FFTs side by side)")
    require(n_seven_r == 42 * 9 - 1 and n_seven_r_kept == 1,
            "G and H's radix-7 route: every launch at 42 shapes but G with the IF and a bank at 4032/2016")
    # C / D / I and J on the smooth route: every shape their gates take (hop
    # a multiple of 32, overlap 2 to 8) takes it (no smooth shape falls back
    # to the product), the plans' layouts at their team counts and one team;
    # the two instances at most 128 registers (two blocks an SM) and no
    # spill; the plans count four blocks an SM, which 64 registers allow
    gl_res = gl_smooth_resources(_build.kernel_resources())
    for name, res in gl_res.items():
        log(f"    {name}: {res['registers']} registers, spill stores / loads {res.get('spill_stores', 0)} / "
            f"{res.get('spill_loads', 0)} B (the Griffin-Lim smooth route; its plans assume four blocks an SM: "
            f"{'held' if res['registers'] <= 64 else 'NOT held'})")
    require(len(gl_res) == 2 and all(r["registers"] <= 128 and not r.get("spill_stores") and not r.get("spill_loads")
                                     for r in gl_res.values()),
            "the Griffin-Lim smooth instances: two, at most 128 registers, no spill")
    n_gl = 0
    for n_fft_s in [n for n in range(64, 4097, 2) if ff.fft_covers_smooth(n)]:
        for ov_s in range(2, 9):
            if n_fft_s % ov_s or (n_fft_s // ov_s) % 32:
                continue
            hop_s = n_fft_s // ov_s
            tile_c, teams_c = glstep._step_fft_plan(n_fft_s, hop_s)
            route_j, rows_j, _, teams_j = glstep._fullk_plan(n_fft_s, hop_s)
            require(glstep.gl_step_route(n_fft_s, hop_s) == "smooth" and route_j == "smooth",
                    f"{n_fft_s}/{hop_s}: C, D, I and J must take the smooth route")
            for tm in sorted({1, teams_c}):
                require(lib.att_gl_fft_smem_bytes(tile_c, ov_s, hop_s, tm)
                        == glstep._fft_smem_bytes(tile_c, ov_s, hop_s, tm),
                        f"{n_fft_s}/{hop_s}: C / D / I's smooth shared-memory size: wrapper and source disagree")
            for tm in sorted({1, teams_j}):
                require(lib.att_gl_fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, tm)
                        == glstep._fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, tm),
                        f"{n_fft_s}/{hop_s}: J's smooth shared-memory size: wrapper and source disagree")
            require(glstep._fft_smem_bytes(tile_c, ov_s, hop_s, teams_c) <= ff.MAX_SMEM
                    and glstep._fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, teams_j) <= ff.MAX_SMEM,
                    f"{n_fft_s}/{hop_s}: a Griffin-Lim smooth plan exceeds shared memory")
            n_gl += 1
    # K's synthesis and O's polish on the smooth route: the three instances'
    # registers and spill (reported: K's plan counts four blocks an SM, which
    # 64 registers allow; the polish runs one block an SM), K's route at every
    # even 5-smooth shape its gate takes (hop a multiple of 4), both layouts
    # against the wrapper's at the plans and at one team
    kp_res = k_polish_smooth_resources(_build.kernel_resources())
    for name, res in kp_res.items():
        log(f"    {name} smooth instance: {res.get('registers')} registers, spill stores / loads "
            f"{res.get('spill_stores', 0)} / {res.get('spill_loads', 0)} B"
            + (f" (K's plan assumes four blocks an SM: {'held' if res.get('registers', 999) <= 64 else 'NOT held'})"
               if name == "K" else ""))
    require(set(kp_res) == {"K", "O resident", "O device"}, f"K's and O's smooth instances: found {sorted(kp_res)}")
    n_kp = 0
    for n_fft_s in [n for n in range(64, 4097, 2) if ff.fft_covers_smooth(n)]:
        for ov_s in range(2, 9):
            if n_fft_s % ov_s or (n_fft_s // ov_s) % 4 or not pghi_kernel.pghi_fused_available(n_fft_s,
                                                                                                 n_fft_s // ov_s):
                continue
            hop_s = n_fft_s // ov_s
            require(pghi_kernel.synth_route(n_fft_s, hop_s) == "smooth", f"{n_fft_s}/{hop_s}: K must be smooth")
            rows, teams = pghi_kernel._synth_fft_plan(n_fft_s, hop_s)
            for tm in sorted({1, teams}):
                require(lib.att_pghi_synth_fft_smem_bytes(rows, hop_s, n_fft_s, tm)
                        == pghi_kernel._synth_fft_smem_bytes(rows, hop_s, n_fft_s, tm),
                        f"{n_fft_s}/{hop_s}: K's smooth shared-memory size: wrapper and source disagree")
            for tp in (ov_s, 14, 22, 46):
                plan = ss._polish_plan(n_fft_s, hop_s, tp)
                for tm in sorted({1, plan[0] if plan else 1}):
                    for res in (0, 1):
                        require(lib.att_gl_polish_smem_bytes(tp, hop_s, n_fft_s, tm, res)
                                == ss._polish_smem_bytes(tp, hop_s, n_fft_s, tm, bool(res)),
                                f"{n_fft_s}/{hop_s}: the polish's smooth shared-memory size: wrapper and "
                                "source disagree")
            n_kp += 1
    log(f"    K's synthesis and O's polish on the smooth route: K smooth at every one of {n_kp} shapes, shared-memory "
        f"sizes agree (K at 768/256 {pghi_kernel._synth_fft_plan(768, 256)}, 1200/300 "
        f"{pghi_kernel._synth_fft_plan(1200, 300)} as (chunks, FFTs); the polish at 1200/300 and 14 grid frames "
        f"{ss._polish_plan(1200, 300, 14)} as (FFTs, grid in shared memory))")
    log(f"    the Griffin-Lim smooth route: every one of {n_gl} shapes takes it, plans and shared-memory sizes agree "
        f"(C / D / I at 768/192 {glstep._step_fft_plan(768, 192)}, 640/160 {glstep._step_fft_plan(640, 160)} as "
        f"(frames, FFTs); J at 768/256 {glstep._fullk_plan(768, 256)} as (route, chunks, frames, FFTs))")
    # J and K's synthesis on the smooth route's radix-7 instance: every even
    # 7-smooth shape with a factor 7 their gates take (J: hop a multiple of
    # 32, overlap 2 to 8, 42 shapes; K: hop a multiple of 4 and a product
    # tile that fits, 321), the route and the plan's layout against the
    # source's at the plan's team count and one team; C, D and I keep the
    # product route there; the two instances' registers and spill, and the
    # blocks an SM their plans count against what those registers allow
    jk_res = gl_k_seven_resources(_build.kernel_resources())
    for name, res in jk_res.items():
        log(f"    {name} radix-7 instance: {res['registers']} registers, spill stores / loads "
            f"{res.get('spill_stores', 0)} / {res.get('spill_loads', 0)} B, {seven_blocks(res['registers'])} blocks "
            f"an SM by registers (the plan counts "
            f"{glstep.FULLK_SEVEN_BLOCKS if name == 'J' else pghi_kernel.SYNTH_SEVEN_BLOCKS})")
    require(set(jk_res) == {"J", "K"} and all(r["registers"] <= 128 for r in jk_res.values()),
            f"the radix-7 instances of J and K's synthesis: two, at most 128 registers (found {sorted(jk_res)})")
    require(seven_blocks(jk_res["J"]["registers"]) == glstep.FULLK_SEVEN_BLOCKS
            and seven_blocks(jk_res["K"]["registers"]) == pghi_kernel.SYNTH_SEVEN_BLOCKS,
            "J's or K's radix-7 plan counts another number of blocks an SM than the instance's registers allow")
    sevens = [n for n in range(64, 4097, 2) if ff.fft_covers_smooth7(n) and n % 7 == 0]
    n_seven_j = n_seven_k = 0
    for n_fft_s in sevens:
        for ov_s in range(2, 9):
            hop_s = n_fft_s // ov_s
            if n_fft_s % ov_s or not glstep.gl_fullk_available(n_fft_s, hop_s):
                continue
            route_j, rows_j, tile_j, teams_j = glstep._fullk_plan(n_fft_s, hop_s)
            require(route_j == "smooth" and glstep.gl_step_route(n_fft_s, hop_s) == "product"
                    and tile_j % (2 * ov_s) == 0 and rows_j == tile_j + ov_s,
                    f"{n_fft_s}/{hop_s}: J must take its radix-7 instance, C / D / I the product")
            for tm in sorted({1, teams_j}):
                require(lib.att_gl_fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, tm)
                        == glstep._fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, tm),
                        f"{n_fft_s}/{hop_s}: J's radix-7 shared-memory size: wrapper and source disagree")
            require(glstep._fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, teams_j) <= ff.MAX_SMEM,
                    f"{n_fft_s}/{hop_s}: J's radix-7 plan exceeds shared memory")
            n_seven_j += 1
        for hop_s in range(4, n_fft_s // 2 + 1, 4):
            if n_fft_s % hop_s or not pghi_kernel.pghi_fused_available(n_fft_s, hop_s):
                continue
            require(pghi_kernel.synth_route(n_fft_s, hop_s) == "smooth",
                    f"{n_fft_s}/{hop_s}: K's synthesis must take its radix-7 instance")
            rows, teams = pghi_kernel._synth_fft_plan(n_fft_s, hop_s)
            for tm in sorted({1, teams}):
                require(lib.att_pghi_synth_fft_smem_bytes(rows, hop_s, n_fft_s, tm)
                        == pghi_kernel._synth_fft_smem_bytes(rows, hop_s, n_fft_s, tm),
                        f"{n_fft_s}/{hop_s}: K's radix-7 shared-memory size: wrapper and source disagree")
            n_seven_k += 1
    log(f"    J and K's synthesis on the radix-7 instance: {n_seven_j} / {n_seven_k} shapes, routes and shared-memory "
        f"sizes agree (J at 896/224 {glstep._fullk_plan(896, 224)}, 1568/224 {glstep._fullk_plan(1568, 224)} as "
        f"(route, chunks, frames, FFTs); K at 896/224 {pghi_kernel._synth_fft_plan(896, 224)}, 1344/336 "
        f"{pghi_kernel._synth_fft_plan(1344, 336)} as (chunks, FFTs))")
    require(n_seven_j == 42 and n_seven_k == 321, "the radix-7 route of J and K: 42 and 321 shapes")
    # O's polish on its radix-7 instance and O's analysis on the FFT and
    # smooth routes: the new instances' registers and spill (the analysis
    # runs the encode's block, two an SM: at most 128 registers; the polish
    # one block an SM), the polish's layout against the source's at every
    # even 7-smooth shape with a factor 7 (at the plan's teams and one team,
    # resident or not, for grids of overlap, 14, 22 and 46 frames) and the
    # plan's within shared memory, and the analysis's plan (the encode's: an
    # even frame count) within shared memory and equal to the source's layout
    # at every shape the two-launch route takes on the FFT and smooth routes
    o_res = o_route_resources(_build.kernel_resources())
    for name, res in sorted(o_res.items()):
        log(f"    {name} instance: {res.get('registers')} registers, spill stores / loads "
            f"{res.get('spill_stores', 0)} / {res.get('spill_loads', 0)} B")
    require(set(o_res) == {"O seven resident", "O seven device", "Oana fft", "Oana smooth", "Oana seven"}
            and all(o_res[k]["registers"] <= 128 for k in ("Oana fft", "Oana smooth", "Oana seven")),
            f"O's new instances: five, the analysis's at most 128 registers (found {sorted(o_res)})")
    n_pol7 = n_ana = 0
    for n_fft_s in range(64, 4097, 2):
        for ov_s in range(2, 9):
            if n_fft_s % ov_s or (n_fft_s // ov_s) % 4:
                continue
            hop_s = n_fft_s // ov_s
            if ss.session_route(n_fft_s, "project") != "product" and ss.kernel_covers("decode", n_fft_s, hop_s):
                rows_a, teams_a = ss._encode_plan(n_fft_s, hop_s)
                require(rows_a % 2 == 0 and lib.att_session_encode_fft_smem_bytes(rows_a, hop_s, n_fft_s, teams_a)
                        == ss._encode_fft_smem_bytes(rows_a, hop_s, n_fft_s, teams_a) <= ff.MAX_SMEM,
                        f"{n_fft_s}/{hop_s}: O's analysis plan is odd, over shared memory or unlike the source's")
                n_ana += 1
            if n_fft_s % 7 or not ff.fft_covers_smooth7(n_fft_s):
                continue
            require(ss.session_route(n_fft_s, "polish") == "smooth", f"{n_fft_s}: the polish must take radix 7")
            for tp in (ov_s, 14, 22, 46):
                plan = ss._polish_plan(n_fft_s, hop_s, tp)
                for tm in sorted({1, plan[0] if plan else 1}):
                    for res in (0, 1):
                        require(lib.att_gl_polish_smem_bytes(tp, hop_s, n_fft_s, tm, res)
                                == ss._polish_smem_bytes(tp, hop_s, n_fft_s, tm, bool(res)),
                                f"{n_fft_s}/{hop_s}: the polish's radix-7 shared-memory size: wrapper and source "
                                "disagree")
                require(plan is None or ss._polish_smem_bytes(tp, hop_s, n_fft_s, *plan) <= ff.MAX_SMEM,
                        f"{n_fft_s}/{hop_s}: the polish's radix-7 plan exceeds shared memory")
            n_pol7 += 1
    log(f"    O's polish on the radix-7 instance at {n_pol7} shapes, layouts agree (1344/336 and 14 grid frames "
        f"{ss._polish_plan(1344, 336, 14)}, 896/224 {ss._polish_plan(896, 224, 14)} as (FFTs, grid in shared "
        f"memory)); O's analysis on the FFT and smooth routes at {n_ana} shapes, plans even and within shared "
        f"memory (4096/1024 {ss._encode_plan(4096, 1024)}, 3072/768 {ss._encode_plan(3072, 768)}, 3584/896 "
        f"{ss._encode_plan(3584, 896)}, 1344/336 {ss._encode_plan(1344, 336)} as (frames, FFTs))")
    require(n_ana == 483, f"O's analysis on the FFT and smooth routes: 483 shapes, found {n_ana}")
    # the FFT route of R / the magnitude encode and of E / F: both layouts at
    # every size the route takes, with the plans' team counts and fewer
    n_fft_checked = 0
    for n_fft_s in (64, 128, 256, 512, 1024, 2048, 4096):
        for ov_s in (2, 4, 8):
            hop_s, f_s = n_fft_s // ov_s, n_fft_s // 2 + 1
            rows, teams = ss._encode_plan(n_fft_s, hop_s)
            require(teams > 0, f"{n_fft_s}/{hop_s}: the encode must take the FFT route")
            for tm in sorted({1, teams // 2 or 1, teams}):
                require(lib.att_session_encode_fft_smem_bytes(2 * tm, hop_s, n_fft_s, tm)
                        == ss._encode_fft_smem_bytes(2 * tm, hop_s, n_fft_s, tm),
                        "encode FFT route's shared-memory size: wrapper and source disagree")
            if hop_s % 32 == 0:
                tile_t, teams = spectral._kernel_plan(n_fft_s, hop_s, None)
                require(teams > 0, f"{n_fft_s}/{hop_s}: E and F must take the FFT route")
                for t_s in spectral.TILES:
                    for tm in sorted({1, teams}):
                        require(lib.att_melspec_fft_smem_bytes(t_s, hop_s, ov_s, f_s, tm)
                                == spectral._fft_smem_bytes(t_s, hop_s, ov_s, f_s, tm),
                                "melspec FFT route's shared-memory size: wrapper and source disagree")
                rows_j, _, teams_j = glstep._pick_fullk_fft_block(n_fft_s, hop_s)
                require(lib.att_gl_fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, teams_j)
                        == glstep._fullk_fft_smem_bytes(rows_j, hop_s, n_fft_s, teams_j),
                        "full-K GL FFT route's shared-memory size: wrapper and source disagree")
            rows, teams = ss._roundtrip_plan(n_fft_s, hop_s)
            require(teams > 0 and lib.att_session_roundtrip_fft_smem_bytes(rows, ov_s, hop_s, teams)
                    == ss._roundtrip_fft_smem_bytes(rows, ov_s, hop_s, teams),
                    "roundtrip FFT route's shared-memory size: wrapper and source disagree")
            rows, teams = pghi_kernel._synth_fft_plan(n_fft_s, hop_s)
            require(lib.att_pghi_synth_fft_smem_bytes(rows, hop_s, n_fft_s, teams)
                    == pghi_kernel._synth_fft_smem_bytes(rows, hop_s, n_fft_s, teams),
                    "K synthesis FFT route's shared-memory size: wrapper and source disagree")
            for narrow in (None, ss.PROJECT_SYN_ROWS):
                rows, teams = ss._decode_plan(n_fft_s, hop_s, narrow)
                require(teams > 0 and lib.att_session_decode_fft_smem_bytes(rows, hop_s, n_fft_s, teams)
                        == ss._decode_fft_smem_bytes(rows, hop_s, n_fft_s, teams),
                        "decode FFT route's shared-memory size: wrapper and source disagree")
            for tp in (ov_s, 22, 26, 44):
                for tm in sorted({1, ff.fft_max_teams(n_fft_s)}):
                    for res in (0, 1):
                        require(lib.att_gl_polish_smem_bytes(tp, hop_s, n_fft_s, tm, res)
                                == ss._polish_smem_bytes(tp, hop_s, n_fft_s, tm, bool(res)),
                                "polish's shared-memory size: wrapper and source disagree")
            if hop_s % 32 == 0:
                tile_c, teams_c = glstep._step_fft_plan(n_fft_s, hop_s)
                for tm in sorted({1, teams_c}):
                    require(lib.att_gl_fft_smem_bytes(tile_c, ov_s, hop_s, tm)
                            == glstep._fft_smem_bytes(tile_c, ov_s, hop_s, tm),
                            "C / D / I FFT route's shared-memory size: wrapper and source disagree")
            if hop_s % 32 == 0:
                for st in (0, 1):
                    for second, sel in spectral.SECONDS.items():
                        for mel in (0, 1):
                            tile_r, teams_r = spectral._repr_plan(n_fft_s, hop_s, None, bool(st), second, bool(mel))
                            require(teams_r > 0, f"{n_fft_s}/{hop_s}: G and H must take the FFT route")
                            for t_s in spectral.FFT_TILES:
                                require(lib.att_repr_fft_smem_bytes(t_s, hop_s, ov_s, f_s, teams_r, st, sel, mel)
                                        == spectral._repr_fft_smem_bytes(t_s, hop_s, ov_s, f_s, teams_r, bool(st),
                                                                         second, bool(mel)),
                                        "representation FFT route's shared-memory size: wrapper and source "
                                        "disagree")
            n_fft_checked += 1
    log(f"    shared-memory sizes of the FFT route: wrapper and source agree at {n_fft_checked} shapes "
        f"(plans at {N_FFT}/{HOP}: encode {ss._encode_plan(N_FFT, HOP)}, E/F "
        f"{spectral._kernel_plan(N_FFT, HOP, None)}, L/M {ss._roundtrip_plan(N_FFT, HOP)}, K's synthesis "
        f"{pghi_kernel._synth_fft_plan(N_FFT, HOP)}, G / H full-K with the IF "
        f"{spectral._repr_plan(N_FFT, HOP, None, False, 'if', True)} / "
        f"{spectral._repr_plan(N_FFT, HOP, None, True, 'if', False)}, C / D / I {glstep._step_fft_plan(N_FFT, HOP)}, "
        f"P / S {ss._decode_plan(N_FFT, HOP)}, O's synthesis {ss._decode_plan(N_FFT, HOP, ss.PROJECT_SYN_ROWS)} "
        f"as (rows or tile, FFTs side by side); J {glstep._fullk_plan(N_FFT, HOP)} as (route, chunks, frames, FFTs); "
        f"O's polish at 22 / 26 grid frames {ss._polish_plan(N_FFT, HOP, 22)} / {ss._polish_plan(N_FFT, HOP, 26)} "
        f"as (FFTs side by side, grid in shared memory))")

    # ------------------------------------------------ 3. kernels vs plain
    log("[3] each kernel against its plain PyTorch version on the card")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    B, L = args.batch, int(args.seconds * SR)
    audio = make_audio(B, L, gen)                      # (B, 2, L)
    mono = audio.mean(-2).contiguous()                 # (B, L)
    errs: dict = {}  # per kernel: largest absolute difference to the plain version seen

    def front_end(wname, n_fft):
        """(kernel letters, taps, window) of a named window; "gaussian" is the
        DGT's and takes the full-K kernels E and F."""
        if wname == "gaussian":
            return ("E", "F"), None, gaussian_dgt_window(n_fft, device=dev)
        return ("A", "B"), taps_for_window(get_window(wname, n_fft)), None

    def taps_oracle_window(taps, n_fft):
        """The cosine-sum window of ``taps`` in float64 (the oracle's)."""
        k = torch.arange(n_fft, device=dev, dtype=torch.float64)
        return sum((1.0 if p == 0 else 2.0) * c * torch.cos(2 * math.pi * p * k / n_fft) for p, c in enumerate(taps))

    def seven_suffix(n_fft, route):
        """"7" for the smooth route's radix-7 instance (n_fft with a factor
        7): its rows are apart from the 5-smooth instance's."""
        return "7" if route == "smooth" and n_fft % 7 == 0 else ""

    def check_forward(name, x, n_fft, hop, wname, bank, offset, scale, power=1.0, contrast="log1p", taps=None):
        """A or E against its plain version.  A (taps) takes the FFT route
        wherever n_fft is a power of two from 64 to 4096 (E's instance under
        the taps' own window: |X| bit-identical to the plain version, the mel
        product's fmaf sums in another order than cuBLAS), the smooth route
        where it is even and 5-smooth (row A_smooth) and its radix-7 instance
        where it is even and 7-smooth with a factor 7 (row A_smooth7), the
        factored front end elsewhere (row A_factored)."""
        (A, _), taps_w, window = front_end(wname, n_fft)
        taps = taps_w if taps is None else taps
        kw = dict(mel_bank=bank, offset=offset, scale=scale, contrast=contrast, taps=taps,
                  window=window, power=power)
        spectral.reset_launches()
        y_k = spectral.fused_melspec(x, n_fft, hop, **kw)
        y_p = spectral.fused_melspec_reference(x, n_fft, hop, **kw)
        torch.cuda.synchronize()
        if taps is not None:
            route = {"fft": "fft", "smooth": "smooth", "other": "factored"}[spectral.melspec_route(n_fft)]
            require(spectral.routes[f"fused_melspec:{route}"] == 1, f"A {name}: not on the {route} route")
            A = {"fft": "A", "smooth": "A_smooth", "factored": "A_factored"}[route] + seven_suffix(n_fft, route)
        e = rel_err(y_k, y_p)
        # fp32 sums in another order than cuBLAS: a few 1e-7 per product,
        # through sqrt, mel and log1p; 2e-5 leaves a decade of room
        log(f"  {A} {name}{'' if bank is None else ', mel'}{', power 2' if power == 2.0 else ''}: f32 rel "
            f"{e:.3e} (tol 2e-05), shape {tuple(y_k.shape)}")
        require(torch.isfinite(y_k).all().item() and y_k.shape == y_p.shape, f"{A} {name}: bad output")
        require(e <= 2e-5, f"{A} {name} disagrees with plain")
        y_b = spectral.fused_melspec(x, n_fft, hop, out_dtype=torch.bfloat16, **kw)
        require(torch.equal(y_b, y_k.to(torch.bfloat16)), f"{A} {name}: bf16 store is not the rounded f32")
        x16 = torch.round(x * 32767.0).to(torch.int16)
        y_i = spectral.fused_melspec(x16, n_fft, hop, **kw)
        y_f = spectral.fused_melspec(x16.to(torch.float32) * 2.0 ** -15, n_fft, hop, **kw)
        require(torch.equal(y_i, y_f), f"{A} {name}: int16 input differs from pre-converted float")
        log(f"  {A} {name}: bf16 store bit-equal to rounding, int16 input bit-identical")
        if taps is not None and contrast == "none":
            # A's row reports the log-mel outputs' error, as it did while only
            # those were checked: the unnormalised |X|^2 of a power spectrogram
            # is on another scale, so its error is logged apart
            log(f"  {A} {name}: abs {abs_err(y_k, y_p):.3e} (not in the row)")
        else:
            errs[A] = max(errs.get(A, 0.0), abs_err(y_k, y_p))

    def check_stats(name, x, n_fft, hop, wname, taps=None):
        """B or F against its plain version.  B (taps) takes the FFT route
        wherever n_fft is a power of two from 64 to 4096 (F's instance under
        the taps' own window), the smooth route where it is even and
        7-smooth (its radix-7 instance where n_fft has a factor 7), the
        factored front end elsewhere: on the FFT and smooth
        routes the statistics are bit-identical to the plain version's where
        the order of the sums does not enter (the extrema: one value each),
        and the sums differ by the order of the float64 reduction of the
        blocks' float32 partials only."""
        (_, Bk), taps_w, window = front_end(wname, n_fft)
        taps = taps_w if taps is None else taps
        spectral.reset_launches()
        s_k = spectral.fused_melspec_stats(x, n_fft, hop, "log1p", taps=taps, window=window)
        s_p = spectral.fused_melspec_stats_reference(x, n_fft, hop, "log1p", taps=taps, window=window)
        if taps is not None:
            route = {"fft": "fft", "smooth": "smooth", "other": "factored"}[spectral.melspec_route(n_fft)]
            require(spectral.routes[f"fused_melspec_stats:{route}"] == 1, f"B {name}: not on the {route} route")
            if route != "factored":
                same = s_k["min"].item() == s_p["min"].item() and s_k["max"].item() == s_p["max"].item()
                log(f"  B {name} ({route} route): extrema bit-identical to the plain version: {same}")
                require(same, f"B {name}: the {route} route's extrema differ from the plain version's")
            Bk = {"fft": "B", "smooth": "B_smooth", "factored": "B_factored"}[route] + seven_suffix(n_fft, route)
        e_sum = abs(s_k["sum"].item() - s_p["sum"].item()) / abs(s_p["sum"].item())
        e_sq = abs(s_k["sumsq"].item() - s_p["sumsq"].item()) / abs(s_p["sumsq"].item())
        e_min = abs(s_k["min"].item() - s_p["min"].item())
        e_max = abs(s_k["max"].item() - s_p["max"].item())
        # sums: fp32 values summed in float64 on both sides, so what differs is
        # the values' own rounding (1e-7 each, averaging out): 1e-5.  min/max
        # pick single values of log1p(|X|), equal to a few ulp: 1e-6 absolute
        # per unit of magnitude.
        tol_ext = 1e-6 * max(1.0, abs(s_p["max"].item()))
        log(f"  {Bk} {name}: sum rel {e_sum:.3e}, sumsq rel {e_sq:.3e} (tol 1e-05); "
            f"min abs {e_min:.3e}, max abs {e_max:.3e} (tol {tol_ext:.1e}); count {s_k['count']}")
        require(s_k["count"] == s_p["count"], f"{Bk} {name}: count differs")
        require(e_sum <= 1e-5 and e_sq <= 1e-5, f"{Bk} {name}: sums disagree with plain")
        require(e_min <= tol_ext and e_max <= tol_ext, f"{Bk} {name}: extrema disagree with plain")
        errs[Bk] = max(errs.get(Bk, 0.0), e_min, e_max)

    def check_polish(n_fft, hop, la, seed):
        """O's polish (gl_polish_fft_kernel, one launch of 4 projections, then
        one of 16; its smooth instance at an even 5-smooth n_fft) against
        gl_polish_reference on 3 sessions of a random grid (phases up to 50
        rad): bit-identical (it repeats the kernel's float32 operations in
        order, and sincosf / atan2f are torch's sin, cos and atan2 on the
        card); the pinned, frozen and zero rows untouched."""
        rt = T.RealtimeSTFT(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl", lookahead_frames=la)
        ov, Fb, T_c = n_fft // hop, n_fft // 2 + 1, max(4, 16384 // n_fft)
        ctx = rt.gl_context
        tp = ctx + T_c + la + ov - 1
        g = torch.Generator(device=dev).manual_seed(args.seed + seed)
        gm = torch.rand((3, tp, Fb), generator=g, device=dev)
        gm[:, -(ov - 1):] = 0.0
        gp = (2 * torch.rand((3, tp, Fb), generator=g, device=dev) - 1) * 50.0
        lo, hi = rt.gl_frozen(T_c)
        syn = ss._decode_operands(rt.inv_window, float(ov), n_fft, hop)
        plan = ss._polish_plan(n_fft, hop, tp)
        route = ss.session_route(n_fft, "polish")
        require(plan is not None, f"the polish must take {n_fft}/{hop} at {tp} grid frames")
        worst = 0.0
        for iters in (4, 16):
            ss.reset_launches()
            p_k = ss.gl_polish(gm, gp.clone(), syn, rt.inv_window, rt.window, None, None, n_fft, hop, ctx, lo, hi,
                               iters)
            p_p = ss.gl_polish_reference(gm, gp, rt.inv_window, rt.window, n_fft, hop, ctx, lo, hi, iters)
            torch.cuda.synchronize()
            same = torch.equal(p_k, p_p)
            kept = (torch.equal(p_k[:, :ctx], gp[:, :ctx]) and torch.equal(p_k[:, lo:hi], gp[:, lo:hi])
                    and torch.equal(p_k[:, -(ov - 1):], gp[:, -(ov - 1):]))
            e = (unit_spec(gm, p_k) - unit_spec(gm, p_p)).abs().max().item()
            worst = max(worst, e)
            require(ss.launches["gl_polish"] == 1 and ss.routes[f"gl_polish:{route}"] == 1
                    and sum(ss.launches.values()) == 1, f"polish {n_fft}/{hop}: expected one polish launch on "
                    f"the {route} route")
            require(same and kept and torch.isfinite(p_k).all().item(),
                    f"polish {n_fft}/{hop} lookahead {la}, {iters} projections: differs from its plain version")
        log(f"  O polish {n_fft}/{hop} lookahead {la} ({route} route, {tp} grid frames, plan {plan}): 4 and 16 "
            f"projections bit-identical to the plain version, |X| (cos, sin) off by {worst:.3e}; pinned, frozen "
            f"and zero rows untouched")
        key = "Opol" if route == "fft" else "Opol_smooth7" if n_fft % 7 == 0 else "Opol_smooth"
        errs[key] = max(errs.get(key, 0.0), worst)

    def check_analysis(n_fft, hop, ctx, rows, seed):
        """O's analysis on the FFT and smooth routes
        (gl_project_analysis_fft_kernel, the two-launch projection's second
        launch) against gl_project_analysis_reference on 3 sessions of a
        random signal (phases up to 50 rad): bit-identical, one launch on its
        route, the pinned, frozen and zero rows untouched; and a whole
        two-launch projection (gl_project: P's synthesis, then the analysis)
        against gl_project_reference, bit for bit."""
        rt = T.RealtimeSTFT(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl", gl_context=ctx)
        ov, Fb = n_fft // hop, n_fft // 2 + 1
        tp = ctx + rows + ov - 1
        tx = tp - (ov - 1)
        g = torch.Generator(device=dev).manual_seed(args.seed + seed)
        y = torch.randn((3, tp * hop), generator=g, device=dev)
        gm = torch.rand((3, tp, Fb), generator=g, device=dev)
        gm[:, -(ov - 1):] = 0.0
        gp = (2 * torch.rand((3, tp, Fb), generator=g, device=dev) - 1) * 50.0
        lo, hi = rt.gl_frozen(rows)
        route = ss.session_route(n_fft, "project")
        require(route != "product" and ss.kernel_covers("project", n_fft, hop, rows, ctx),
                f"the analysis must take {n_fft}/{hop} with {rows} frames on the FFT or smooth route")
        ss.reset_launches()
        a_k = gp.clone()
        ss._launch_project_analysis(y, a_k, ss._project_operands(rt.window, None, None, n_fft, dev), n_fft, hop, tx,
                                    ctx, lo, hi)
        a_p = ss.gl_project_analysis_reference(y, gp, rt.window, n_fft, hop, ctx, lo, hi)
        torch.cuda.synchronize()
        require(ss.launches["gl_project_analysis"] == 1 and ss.routes[f"gl_project_analysis:{route}"] == 1
                and sum(ss.launches.values()) == 1, f"analysis {n_fft}/{hop}: expected one launch on the {route} route")
        same = torch.equal(a_k, a_p)
        kept = (torch.equal(a_k[:, :ctx], gp[:, :ctx]) and torch.equal(a_k[:, lo:hi], gp[:, lo:hi])
                and torch.equal(a_k[:, tx:], gp[:, tx:]))
        syn = ss._decode_operands(rt.inv_window, float(ov), n_fft, hop)
        p_k = ss.gl_project(gm, gp.clone(), syn, rt.inv_window, rt.window, None, None, n_fft, hop, ctx, lo, hi)
        p_p = ss.gl_project_reference(gm, gp, rt.inv_window, rt.window, n_fft, hop, ctx, lo, hi)
        torch.cuda.synchronize()
        same_p = torch.equal(p_k, p_p)
        e = (a_k - a_p).abs().max().item()
        log(f"  O analysis {n_fft}/{hop} ({route} route{', radix 7' if n_fft % 7 == 0 else ''}, gl_context {ctx}, "
            f"{rows} polished frames, plan {ss._encode_plan(n_fft, hop)} as (frames, FFTs)): bit-identical to its "
            f"plain version {same} (max abs {e:.3e}); pinned, frozen and zero rows untouched {kept}; the two-launch "
            f"projection bit-identical to its plain version {same_p}")
        require(same and kept and same_p and torch.isfinite(a_k).all().item(),
                f"analysis {n_fft}/{hop}: differs from its plain version")
        key = "Oana_" + ("fft" if route == "fft" else "smooth7" if n_fft % 7 == 0 else "smooth")
        errs[key] = max(errs.get(key, 0.0), e)

    def check_two_halves(n_fft, hop, seed):
        """gl_iterations two-launch projections (gl_project, its synthesis and
        analysis on the FFT or smooth route) against one polish launch of as
        many projections on the same grid (3 sessions, 3 + 8 + overlap - 1
        frames, phases up to 50 rad): bit for bit, since the polish's
        synthesis is P's and its analysis the same frames_rfft with the same
        pairs."""
        rt = T.RealtimeSTFT(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl")
        ov, Fb, ctx, iters = n_fft // hop, n_fft // 2 + 1, rt.gl_context, rt.gl_iterations
        tp = ctx + 8 + ov - 1
        g = torch.Generator(device=dev).manual_seed(args.seed + seed)
        gm = torch.rand((3, tp, Fb), generator=g, device=dev)
        gm[:, -(ov - 1):] = 0.0
        gp = (2 * torch.rand((3, tp, Fb), generator=g, device=dev) - 1) * 50.0
        lo, hi = rt.gl_frozen(8)
        syn = ss._decode_operands(rt.inv_window, float(ov), n_fft, hop)
        require(ss._polish_plan(n_fft, hop, tp) is not None, f"the polish must take {n_fft}/{hop} at {tp} frames")
        q_k = ss.gl_polish(gm, gp.clone(), syn, rt.inv_window, rt.window, None, None, n_fft, hop, ctx, lo, hi, iters)
        ss.reset_launches()
        q_two = gp.clone()
        for _ in range(iters):
            q_two = ss.gl_project(gm, q_two, syn, rt.inv_window, rt.window, None, None, n_fft, hop, ctx, lo, hi)
        torch.cuda.synchronize()
        route = ss.session_route(n_fft, "project")
        require(ss.routes[f"gl_project_analysis:{route}"] == iters and ss.launches["gl_project_synthesis"] == iters,
                f"{n_fft}/{hop}: the two-launch projections must run on the {route} route")
        same = torch.equal(q_k, q_two)
        log(f"  O at {n_fft}/{hop} ({route} route): {iters} two-launch projections bit-identical to one polish launch "
            f"of {iters}: {same} (max abs {(q_k - q_two).abs().max().item():.3e})")
        require(same, f"{n_fft}/{hop}: the two-launch projections differ from the polish")

    mag_t = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=N_FFT)
    stft_t = T.STFT(n_fft=N_FFT, hop_length=HOP)
    taps_main = stft_t._window_taps
    check_forward("main shape", mono, N_FFT, HOP, "hann", mag_t.mel_bank, 0.0123, 2.345)
    check_stats("main shape", mono, N_FFT, HOP, "hann")
    # ragged: T = 1 + 20000 // 128 = 157 is no multiple of the 32-frame tile,
    # blackman has P = 2 taps, another overlap and bank size
    rag = mono[:5, :20000].contiguous()
    small = mono[:3, :30000].contiguous()
    mag_r = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=512)
    check_forward("ragged 512/128 blackman", rag, 512, 128, "blackman", mag_r.mel_bank, -0.2, 0.7)
    check_stats("ragged 512/128 blackman", rag, 512, 128, "blackman")
    # O's polish at every power of two it takes, lookahead 0 and 4, and its
    # smooth instance at the five session framings of the smooth route
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        for la in (0, 4):
            check_polish(n_fft, n_fft // 4, la, 300 + n_fft + la)
    for n_fft, hop in SESSION_SMOOTH_SHAPES:
        for la in (0, 4):
            check_polish(n_fft, hop, la, 300 + n_fft + la)
    # its radix-7 instance (2^6 3 7, 2^7 7); O's analysis on the FFT route
    # (4096/1024, gl_context 1, 40 frames: a grid no polish block holds), the
    # smooth route (3072/768, 40 frames; 2560/1280, 39) and its radix-7
    # instance (3584/896, gl_context 1, 40 frames, which the polish refuses;
    # 1344/336, 8 frames); the two halves against the polish
    for n_fft, hop in ((1344, 336), (896, 224)):
        for la in (0, 4):
            check_polish(n_fft, hop, la, 300 + n_fft + la)
    for i, (n_fft, hop, ctx, rows) in enumerate(((4096, 1024, 1, 40), (3072, 768, 3, 40), (2560, 1280, 3, 39),
                                                 (3584, 896, 1, 40), (1344, 336, 3, 8))):
        check_analysis(n_fft, hop, ctx, rows, 320 + i)
    for i, (n_fft, hop) in enumerate(((1024, 256), (1200, 300), (1344, 336))):
        check_two_halves(n_fft, hop, 330 + i)
    spec_main = stft_t.forward(mono)
    gl_mag = spec_main.abs()
    del spec_main
    mom = 0.99 / 1.99
    gl_state, step1, step4, gl_env = check_gl(
        "main shape", gl_mag, N_FFT, HOP, taps_main, stft_t.inv_window, mom, args.seed + 1, 1e-4, errs)
    w_r = get_window("blackman", 512, device=dev)
    mag_rag = att.ops.stft(rag, 512, 128, w_r).abs()
    check_gl("ragged 512/128 blackman", mag_rag, 512, 128, taps_for_window(w_r), w_r, mom,
             args.seed + 2, 1e-4, errs)
    # the other shapes the dispatch can send to the kernels: hamming at the
    # main shape's framing (no small window value, so the edge frames are
    # held to 1e-4 outright), overlap 8 (the widest halo, chains of 3),
    # overlap 2, a hop wider than one pass of the synthesis product (512 > 256
    # sample columns), and n_fft 4096 (chains of 3)
    for n_fft, hop, wname in ((1024, 256, "hamming"), (1024, 128, "hamming"), (512, 256, "hann"),
                              (2048, 512, "hann"), (4096, 1024, "hann")):
        label = f"{n_fft}/{hop} {wname}"
        w_s = get_window(wname, n_fft, device=dev)
        taps_s = taps_for_window(w_s)
        require(spectral.fused_melspec_available(n_fft, hop, taps_s)
                and glstep.gl_project_available(n_fft, hop, taps_s), f"kernels must cover {label}")
        bank_s = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft).mel_bank
        check_forward(label, small, n_fft, hop, wname, bank_s, 0.05, 1.3)
        check_stats(label, small, n_fft, hop, wname)
        chain = glstep.gl_max_chain(n_fft, hop, 3 if n_fft // hop == 8 else 4)
        log(f"  {label}: (frame tile, FFTs) {spectral._kernel_plan(n_fft, hop, taps_s)} in A and B, "
            f"chain of {chain} in D")
        require(chain >= 2, f"no chain fits shared memory at {label}")
        check_gl(label, att.ops.stft(small, n_fft, hop, w_s).abs(), n_fft, hop, taps_s, w_s, mom,
                 args.seed + n_fft + hop, 1e-4, errs, chain=chain)
    # C and D on the FFT route at the other powers of two it takes (hop
    # n_fft / 4, at least the kernels' 32; 4096/2048 the widest hop), on the
    # smooth route at every SMOOTH_SHAPES framing (even 5-smooth n_fft:
    # bit-identical to the plain version, every frame of C within 1e-5 of
    # the float64 oracle), and on the product route (896/224 = 2^7 7)
    for n_fft, hop in ((64, 32), (128, 32), (256, 64), (512, 128), (2048, 512), (4096, 2048), (896, 224)) \
            + SMOOTH_SHAPES:
        w_s = get_window("hann", n_fft, device=dev)
        check_gl(f"{n_fft}/{hop} hann", att.ops.stft(small, n_fft, hop, w_s).abs(), n_fft, hop,
                 taps_for_window(w_s), w_s, mom, args.seed + 3 * n_fft + hop, 1e-4, errs,
                 chain=glstep.gl_max_chain(n_fft, hop, 4))
    # E and F: the full-K front end under the DGT's gaussian window.  Main
    # shape without mel (the DGT chain's configuration), then a dense mel
    # bank, the power spectrogram, and the framings with tiles of 32 and 16
    # and 8 (each call also holds the bf16 store and the int16 input)
    check_forward("main shape gaussian", mono, N_FFT, HOP, "gaussian", None, 0.0123, 2.345)
    check_stats("main shape gaussian", mono, N_FFT, HOP, "gaussian")
    check_forward("main shape gaussian, mel", mono, N_FFT, HOP, "gaussian", mag_t.mel_bank, 0.0123, 2.345)
    check_forward("gaussian, power 2, mel, no contrast", small, N_FFT, HOP, "gaussian", mag_t.mel_bank,
                  0.05, 1.3, power=2.0, contrast="none")
    for n_fft, hop in ((512, 128), (2048, 512), (4096, 1024)):
        require(spectral.fused_melspec_available(n_fft, hop, None), f"full-K must cover {n_fft}/{hop}")
        check_forward(f"{n_fft}/{hop} gaussian", rag, n_fft, hop, "gaussian", None, -0.2, 0.7)
        check_stats(f"{n_fft}/{hop} gaussian", rag, n_fft, hop, "gaussian")

    # E and F on the FFT route (every call above took it: n_fft a power of
    # two), |X| itself (no contrast, no affine) against the plain version
    # within 1e-5 of the largest value and against the float64 oracle
    # (torch.stft in float64 of the same clips) within 1e-5 of the largest
    # magnitude; F's statistics of log1p |X| against the oracle's (sums within
    # 1e-5 relative, extrema within 1e-5 of the largest).  The smooth route
    # (n_fft even and 5-smooth: 768 = 2^8 3, 640, 384, 1536, 1920, 3072; its
    # radix-7 instance at even 7-smooth n_fft with a factor 7: 896, 1344,
    # 1568, 1120, 672) the same, and |X| bit-identical to its plain version
    # (the mixed-radix frames_rfft in the plain version's order, as R's); the
    # product route at 1408/352 (2^7 11) against its plain version, as
    # above.
    def check_fullk_routes(name, x, n_fft, hop):
        w = gaussian_dgt_window(n_fft, device=dev)
        front = {"fft": "fft", "smooth": "smooth", "other": "product"}[spectral.melspec_route(n_fft)]
        fft = front != "product"
        kw = dict(mel_bank=None, offset=0.0, scale=1.0, contrast="none", taps=None, window=w)
        spectral.reset_launches()
        m_k = spectral.fused_melspec(x, n_fft, hop, **kw)
        s_k = spectral.fused_melspec_stats(x, n_fft, hop, "log1p", taps=None, window=w)
        require(spectral.routes[f"fused_melspec_fullk:{front}"] == 1
                and spectral.routes[f"fused_melspec_stats_fullk:{front}"] == 1,
                f"E/F {name}: took another route than {front}")
        m_p = spectral.fused_melspec_reference(x, n_fft, hop, **kw)
        s_p = spectral.fused_melspec_stats_reference(x, n_fft, hop, "log1p", taps=None, window=w)
        ora = torch.stft(x.double(), n_fft, hop, window=w.double(), center=True, pad_mode="reflect",
                         return_complex=True).abs().transpose(-2, -1)
        v = torch.log1p(ora)
        s_o = {"sum": v.sum().item(), "sumsq": (v * v).sum().item(), "min": v.min().item(), "max": v.max().item()}
        del v
        e_p, e_o = rel_err(m_k, m_p), rel_err(m_k, ora)
        del ora
        ext = max(1.0, abs(s_o["max"]))
        e_s = max(abs(s_k[k].item() - s_o[k]) / abs(s_o[k]) for k in ("sum", "sumsq"))
        e_x = max(abs(s_k[k].item() - s_o[k]) / ext for k in ("min", "max"))
        e_sp = max(abs(s_k[k].item() - s_p[k].item()) / abs(s_p[k].item()) for k in ("sum", "sumsq"))
        tol = 1e-5 if fft else 2e-5
        same = torch.equal(m_k, m_p)
        log(f"  E / F {name} ({front} route, plan {spectral._kernel_plan(n_fft, hop, None)}): |X| vs plain rel "
            f"{e_p:.3e} (tol {tol:.0e}; bit-identical: {same}), vs float64 oracle {e_o:.3e} (tol 1e-05); "
            f"statistics vs oracle: sums {e_s:.3e}, extrema {e_x:.3e} (tol 1e-05), sums vs plain {e_sp:.3e} "
            f"(tol 1e-05)")
        require(torch.isfinite(m_k).all().item() and m_k.shape == m_p.shape, f"E {name}: bad output")
        require(e_p <= tol and e_o <= 1e-5 and e_s <= 1e-5 and e_x <= 1e-5 and e_sp <= 1e-5,
                f"E / F {name}: out of budget")
        require(same or front != "smooth", f"E {name}: the smooth route's |X| is not bit-identical to its plain "
                                           "version")
        key = {"fft": "", "smooth": "_smooth", "product": "_product"}[front] + seven_suffix(n_fft, front)
        errs["E" + key] = max(errs.get("E" + key, 0.0), abs_err(m_k, m_p))
        errs["F" + key] = max(errs.get("F" + key, 0.0),
                              *(abs(s_k[k].item() - s_p[k].item()) for k in ("min", "max")))

    check_fullk_routes(f"main shape {B} x {L}", mono, N_FFT, HOP)
    for n_fft, hop in ((512, 128), (2048, 512), (4096, 1024), (1408, 352)) + SMOOTH_SHAPES + MELSPEC_SEVEN_SHAPES:
        check_fullk_routes(f"{n_fft}/{hop}, 5 x 20000", rag, n_fft, hop)
    # A and B on the smooth route at the same shapes (hann; blackman, P = 2,
    # at 768/192, 1920/480, 896/224 and 1568/224), with each shape's square
    # mel bank, the bf16 store and the int16 input; and factored at 1408/352
    for n_fft, hop in SMOOTH_SHAPES + MELSPEC_SEVEN_SHAPES + ((1408, 352),):
        bank_s = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft).mel_bank
        two = ((768, 192), (1920, 480), (896, 224), (1568, 224))
        for wname in ("hann", "blackman") if (n_fft, hop) in two else ("hann",):
            check_forward(f"{n_fft}/{hop} {wname}, 5 x 20000", rag, n_fft, hop, wname, bank_s, -0.2, 0.7)
            check_stats(f"{n_fft}/{hop} {wname}, 5 x 20000", rag, n_fft, hop, wname)
    # A and B on the radix-7 instance, bit for bit: A's |X| (no bank, no
    # contrast, no affine) equal to its plain version and within 1e-5 of the
    # float64 oracle under the taps' cosine-sum window; A with the bank
    # equal to E under taps_window; B's extrema equal to its plain version's
    for n_fft, hop in MELSPEC_SEVEN_SHAPES:
        for wname in ("hann", "blackman"):
            taps_s = taps_for_window(get_window(wname, n_fft))
            w_tw = torch.as_tensor(ff.taps_window(tuple(float(t) for t in taps_s), n_fft), device=dev)
            bank_s = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft).mel_bank
            spectral.reset_launches()
            kw0 = dict(mel_bank=None, offset=0.0, scale=1.0, contrast="none", taps=taps_s)
            a_k = spectral.fused_melspec(rag, n_fft, hop, **kw0)
            a_p = spectral.fused_melspec_reference(rag, n_fft, hop, **kw0)
            a_b = spectral.fused_melspec(rag, n_fft, hop, bank_s, 0.1, 1.2, taps=taps_s)
            e_b = spectral.fused_melspec(rag, n_fft, hop, bank_s, 0.1, 1.2, taps=None, window=w_tw)
            b_k = spectral.fused_melspec_stats(rag, n_fft, hop, "log1p", taps=taps_s)
            b_p = spectral.fused_melspec_stats_reference(rag, n_fft, hop, "log1p", taps=taps_s)
            ora = torch.stft(rag.double(), n_fft, hop, window=taps_oracle_window(taps_s, n_fft), center=True,
                             pad_mode="reflect", return_complex=True).abs().transpose(-2, -1)
            torch.cuda.synchronize()
            same = (torch.equal(a_k, a_p), torch.equal(a_b, e_b),
                    b_k["min"].item() == b_p["min"].item() and b_k["max"].item() == b_p["max"].item())
            e_o = rel_err(a_k, ora)
            del ora
            log(f"  A / B {n_fft}/{hop} {wname} (radix-7 instance, plan {spectral._kernel_plan(n_fft, hop, taps_s)}): "
                f"|X| bit-identical to the plain version {same[0]}, vs float64 oracle {e_o:.3e} (tol 1e-05); with "
                f"the bank bit-identical to E under taps_window {same[1]}; B's extrema bit-identical {same[2]}")
            require(all(same) and e_o <= 1e-5 and spectral.routes["fused_melspec:smooth"] == 2
                    and spectral.routes["fused_melspec_stats:smooth"] == 1
                    and spectral.routes["fused_melspec_fullk:smooth"] == 1,
                    f"A / B {n_fft}/{hop} {wname}: the radix-7 instance differs from its plain version")
    # A on the smooth route is E's instance under the taps' own window: bit
    # for bit the same output (with the mel bank, so the product's order too)
    w_t = get_window("hann", 768, device=dev)
    taps_t = taps_for_window(w_t)
    w_tw = torch.as_tensor(ff.taps_window(tuple(float(t) for t in taps_t), 768), device=dev)
    bank_t = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=768).mel_bank
    a_t = spectral.fused_melspec(rag, 768, 192, bank_t, 0.1, 1.2, taps=taps_t)
    e_t = spectral.fused_melspec(rag, 768, 192, bank_t, 0.1, 1.2, taps=None, window=w_tw)
    require(torch.equal(a_t, e_t), "A at 768/192 is not E's smooth instance under the taps' window")
    log("  A at 768/192 (hann taps) bit-identical to E under taps_window: True")
    spectral.reset_launches()
    torch.cuda.empty_cache()  # the float64 oracles' blocks: no later phase finds its cache grown
    # K: the PGHI recurrence (causal and bidirectional), the synthesis and the
    # whole inversion.  Main shape on 16 clips (the plain recurrence is a
    # Python loop over 690 frames), two hops that need no special layout on
    # the card (64: overlap 8; 192: neither a multiple nor a divisor of 128),
    # the wide shapes (1025 bins: two bins per thread and synthesis tiles of
    # 16 chunks; 2049 bins: four per thread, tiles of 8), and a batch with
    # silent frames inside a clip and one all-silent clip.
    w_dgt = gaussian_dgt_window(N_FFT, device=dev)
    dgt_mag = att.ops.stft(mono[:16], N_FFT, HOP, w_dgt).abs()
    check_pghi("main shape", dgt_mag, N_FFT, HOP, w_dgt, dgt_gamma(N_FFT), args.seed + 11, errs)
    holes = dgt_mag[:3].clone()
    holes[0, 100:104] = 0.0
    holes[0, 300] = 0.0
    holes[1] = 0.0
    check_pghi("silent frames and a silent clip", holes, N_FFT, HOP, w_dgt, dgt_gamma(N_FFT),
               args.seed + 12, errs)
    for n_fft, hop in ((512, 64), (768, 192), (2048, 512), (4096, 1024)):
        require(pghi_kernel.pghi_fused_available(n_fft, hop), f"PGHI kernels must cover {n_fft}/{hop}")
        w_s = gaussian_dgt_window(n_fft, device=dev)
        check_pghi(f"{n_fft}/{hop}", att.ops.stft(small, n_fft, hop, w_s).abs(), n_fft, hop, w_s,
                   dgt_gamma(n_fft), args.seed + n_fft + hop, errs)
    del holes

    # K's synthesis on the FFT route at every power of two it takes and on
    # the smooth route at every SMOOTH_SHAPES framing and 1200/300, against
    # its plain version (1e-6: the plain version repeats the kernel's float32
    # operations in order, and sincosf is torch's sin and cos on the card;
    # measured bit-identical) and against a float64 istft of the same
    # magnitudes and float32 phases (1e-5: float32 sums over 2.5 n log2 n
    # terms), on unwrapped phases up to 1e4 rad, with silent frames, a silent
    # clip and an odd frame count whose last pair group has no partners; its
    # radix-7 instance at the K_SEVEN_SHAPES framings (bit-identical to the
    # plain version, rows K_synth_smooth7); the product route at 1408/352
    # (2^7 11) against its plain version (1e-4: fp32 products in another
    # order than cuBLAS) and the oracle.  The route comes from the rule
    # (pghi_kernel.synth_route).
    def check_synth_route(name, n_fft, hop, x):
        w_s = gaussian_dgt_window(n_fft, device=dev)
        mag = att.ops.stft(x, n_fft, hop, w_s).abs()
        ov = n_fft // hop
        T_odd = mag.shape[1] - (mag.shape[1] % (2 * ov)) - ov - 1
        mag = mag[:, :T_odd].contiguous()
        mag[0, 3:7] = 0.0
        mag[1] = 0.0
        g = torch.Generator(device=dev).manual_seed(n_fft + hop)
        ph = 1e4 * torch.rand(mag.shape, generator=g, device=dev)
        route = pghi_kernel.synth_route(n_fft, hop)
        fft = route != "product"
        pghi_kernel.reset_launches()
        a_k = pghi_kernel.pghi_synthesize_fused(mag, ph, n_fft, hop, w_s)
        require(pghi_kernel.routes[f"pghi_synthesize:{route}"] == 1, f"K synthesis {name}: not on the {route} route")
        a_p = pghi_kernel.pghi_synthesize_fused_reference(mag, ph, n_fft, hop, w_s)
        ora = torch.istft(torch.polar(mag.double(), ph.double()).transpose(-2, -1), n_fft, hop,
                          window=w_s.double(), center=True)
        torch.cuda.synchronize()
        e_p, e_o = rel_err(a_k, a_p), rel_err(a_k.double(), ora)
        tol = 1e-6 if fft else 1e-4
        plan = pghi_kernel._synth_fft_plan(n_fft, hop) if fft else pghi_kernel._pick_rows(n_fft, hop)
        log(f"  K synthesis {name} ({route} route, block {plan}; T = {T_odd}, phases to "
            f"{ph.abs().max().item():.4g} rad): vs plain rel {e_p:.3e} (tol {tol:.0e}; bit-identical "
            f"{torch.equal(a_k, a_p)}), vs float64 istft {e_o:.3e} (tol 1e-05)")
        require(torch.isfinite(a_k).all().item() and a_k.shape == a_p.shape and not a_k[1].any(),
                f"K synthesis {name}: bad audio")
        require(e_p <= tol and e_o <= 1e-5, f"K synthesis {name} out of budget")
        seven = route == "smooth" and n_fft % 7 == 0
        require(not seven or torch.equal(a_k, a_p), f"K synthesis {name}: the radix-7 instance is not bit-identical")
        key = {"fft": "K_synth", "smooth": "K_synth_smooth", "product": "K_synth_product"}[route] + ("7" if seven
                                                                                                      else "")
        errs[key] = max(errs.get(key, 0.0), abs_err(a_k, a_p))
        return route

    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        check_synth_route(f"{n_fft}/{n_fft // 4}", n_fft, n_fft // 4, small)
    check_synth_route("main shape, 16 clips", N_FFT, HOP, mono[:16])
    check_synth_route("512/64", 512, 64, small)
    for n_fft, hop in SMOOTH_SHAPES + ((1200, 300),):
        require(check_synth_route(f"{n_fft}/{hop}", n_fft, hop, small) == "smooth",
                f"K synthesis {n_fft}/{hop}: must take the smooth route")
    for n_fft, hop in K_SEVEN_SHAPES:
        require(check_synth_route(f"{n_fft}/{hop}", n_fft, hop, small) == "smooth",
                f"K synthesis {n_fft}/{hop}: must take the radix-7 instance")
    require(check_synth_route("1408/352", 1408, 352, small) == "product",
            "K synthesis 1408/352: must take the product route")

    # G and H: the two-channel representation kernels (Polar "phase",
    # PolarIF "if", Cartesian "imag"), factored (hann) and full-K (gaussian).
    # Channel 1 as A and E (fp32 sums in another order than cuBLAS: 2e-5).
    # Channel 2 as an angle: the spectrum's rounding turns a bin's angle by
    # its error over the bin's own magnitude, so the angle error weighted by
    # |X| / max|X| (the spectrum's relative error across the phase) is held
    # to 1e-5, the budget of channel 1 (measured: 3e-7 at n_fft 1024, 1e-6
    # at 2048 and 4096 where the factored front end adds hop-long chunk
    # products), and unweighted at bins above 1e-3 of the largest to 1e-3 rad.
    def repr_route(n_fft, hop, taps, stats, second, mel):
        """The route of G (or, with ``stats``, H) at this shape
        (spectral._repr_route: melspec_route's rule, but the product or
        factored front end where no smooth block fits) and the suffix of its
        rows' keys ("_smooth7" on the radix-7 instance)."""
        route = spectral._repr_route(n_fft, hop, taps, stats, second, mel)
        if route == "other":
            route = "factored" if taps is not None else "product"
        suffix = {"fft": "", "smooth": "_smooth", "factored": "_factored", "product": "_product"}[route]
        return route, suffix + seven_suffix(n_fft, route)

    def check_repr(name, x, n_fft, hop, wname, second, bank, weighted=False, taps=None):
        """G (with taps: the FFT route under the taps' own window wherever
        n_fft is a power of two from 64 to 4096, the smooth route where it is
        even and 5-smooth, row G_smooth, and its radix-7 instance where it is
        even and 7-smooth with a factor 7, row G_smooth7; the factored front
        end elsewhere, row G_factored) or G full-K against its plain version;
        with taps on the FFT or smooth route also against the float64 oracle
        (torch.stft under the cosine-sum window in float64): channel 1 and
        the |X|-weighted angle (or the IF's phase steps) within 1e-4, the JAX
        package's budget."""
        _, taps_w, window = front_end(wname, n_fft)
        taps = taps_w if taps is None else taps
        route, suffix = repr_route(n_fft, hop, taps, False, second, bank is not None and second != "imag")
        fft = route in ("fft", "smooth")
        require(fft == (spectral._repr_plan(n_fft, hop, taps, False, second,
                                            bank is not None and second != "imag")[1] > 0),
                f"G {name}: the plan does not follow the route rule")
        key = ("G" if taps is not None else "G_fk") + suffix
        spectral.reset_launches()
        # the IF is held before a channel-2 offset: the output's float32
        # resolution, divided by the parabolic window near its zeros, would
        # otherwise exceed the angle's own error
        aff = (0.0123, 2.345, 0.0 if second == "if" else -0.05, 1.3)
        kw = dict(mel_bank=bank, aff=aff, weighted=weighted, taps=taps, window=window)
        k1, k2 = spectral.fused_spectral_repr(x, n_fft, hop, second, **kw)
        route = "fused_spectral_repr" + ("" if taps is not None else "_fullk") + ":" + route
        require(spectral.routes[route] == 1, f"{key} {name}: not on {route}")
        p1, p2 = spectral.fused_spectral_repr_reference(x, n_fft, hop, second, **kw)
        torch.cuda.synchronize()
        label = f"{key} {name} {second}{' weighted' if weighted else ''}{'' if bank is None else ' mel'}"
        log(f"  {label} ({route}): bit-identical to the plain version {torch.equal(k1, p1) and torch.equal(k2, p2)}")
        require(all(torch.isfinite(t).all().item() for t in (k1, k2)) and k1.shape == p1.shape
                and k2.shape == p2.shape, f"{label}: bad output")
        e1 = rel_err(k1, p1)
        log(f"  {label}: ch1 rel {e1:.3e} (tol 2e-05), shapes {tuple(k1.shape)}")
        require(e1 <= 2e-5, f"{label}: channel 1 disagrees with plain")
        w_an = window if window is not None else get_window(wname, n_fft, device=dev)
        wt = magnitude_weights(x, n_fft, hop, w_an, second)
        check_channel2(label, second, k2, p2, aff[3], wt, weighted, 2e-5 if second == "imag" else 1e-5, 1e-3)
        x16 = torch.round(x * 32767.0).to(torch.int16)
        a16 = spectral.fused_spectral_repr(x16, n_fft, hop, second, **kw)
        a32 = spectral.fused_spectral_repr(x16.to(torch.float32) * 2.0 ** -15, n_fft, hop, second, **kw)
        require(all(torch.equal(u, v) for u, v in zip(a16, a32)), f"{label}: int16 input differs")
        if taps is not None and fft:
            S = torch.stft(x.double(), n_fft, hop, window=taps_oracle_window(taps, n_fft), center=True,
                           pad_mode="reflect", return_complex=True).transpose(-2, -1)
            if second == "imag":
                o2 = S.imag.clone()
                o2[..., -1] = 0.0
                e_o = max(rel_err(k1.double(), (S.real - aff[0]) / aff[1]), rel_err(k2.double(), (o2 - aff[2]) / aff[3]))
            else:
                o1 = S.abs() if bank is None else torch.matmul(S.abs(), bank.double())
                o1 = (torch.log1p(o1) - aff[0]) / aff[1]
                ang = torch.angle(S)
                ang[..., -1] = torch.where(S.real[..., -1] < 0, math.pi, 0.0)
                o2 = ang if second == "phase" else spectral._if_rows(ang, weighted)
                wo = S.abs() / S.abs().amax(dim=(-2, -1), keepdim=True)
                if second == "if":
                    wo[:, 1:] = torch.minimum(wo[:, 1:], wo[:, :-1])
                e_a = (angle_error(second, k2, (o2 - aff[2]) / aff[3], aff[3], weighted) * wo).max().item()
                e_o = max(rel_err(k1.double(), o1), e_a)
            log(f"    {label}: vs the float64 oracle {e_o:.3e} (tol 1e-04)")
            require(e_o <= 1e-4, f"{label}: off the float64 oracle")
            del S
        errs[key] = max(errs.get(key, 0.0), abs_err(k1, p1))
        del k1, k2, p1, p2, wt

    # H against the statistics of G's own (pre-affine, non-mel) channels: the
    # same float32 values (up to an ulp where the compiler contracts the two
    # kernels' arithmetic differently) summed in float64 in another order
    # (1e-7 of the sum of |values|, extrema within 1e-6); and against its
    # plain version: channel 1
    # as B and F, channel 2 within the elementwise difference of the two
    # versions' channels (a bin at the +-pi boundary may land on either side).
    # H with taps takes the FFT route wherever n_fft is a power of two from
    # 64 to 4096 and the smooth route where it is even and 7-smooth (its
    # radix-7 instance where n_fft has a factor 7; H full-K's instance under
    # the taps' own window: G's channels are then those of G full-K under
    # that window, and the extrema are bit-identical to the plain
    # version's), the factored front end elsewhere (row H_factored)
    def check_repr_stats(name, x, n_fft, hop, wname, second, weighted=False, taps=None):
        _, taps_w, window = front_end(wname, n_fft)
        taps = taps_w if taps is None else taps
        route, suffix = repr_route(n_fft, hop, taps, True, second, False)
        fft = route in ("fft", "smooth")
        require(fft == (spectral._repr_plan(n_fft, hop, taps, True, second, False)[1] > 0),
                f"H {name}: the plan does not follow the route rule")
        key = ("H" if taps is not None else "H_fk") + suffix
        kw = dict(weighted=weighted, taps=taps, window=window)
        spectral.reset_launches()
        s_k = spectral.fused_repr_stats(x, n_fft, hop, second, **kw)
        route = "fused_repr_stats" + ("" if taps is not None else "_fullk") + ":" + route
        require(spectral.routes[route] == 1, f"{key} {name}: not on {route}")
        s_p = spectral.fused_repr_stats_reference(x, n_fft, hop, second, **kw)
        kw_g = kw
        if taps is not None and fft:
            kw_g = dict(kw, taps=None, window=torch.as_tensor(ff.taps_window(tuple(taps), n_fft), device=dev))
        g_k = spectral.fused_spectral_repr(x, n_fft, hop, second, **kw_g)
        g_p = spectral.fused_spectral_repr_reference(x, n_fft, hop, second, **kw_g)
        torch.cuda.synchronize()
        require(s_k["count"] == s_p["count"] == g_k[0].numel(), f"{key} {name}: count differs")
        if fft:
            same = all(s_k[ch][k].item() == s_p[ch][k].item() for ch in ("ch1", "ch2") for k in ("min", "max"))
            tile = spectral._repr_plan(n_fft, hop, taps, True, second, False)[0]
            log(f"  {key} {name} {second} ({route}, tile {tile}): extrema "
                f"bit-identical to the plain version: {same}")
            require(same, f"{key} {name}: the {route} extrema differ from the plain version's")
        worst = 0.0
        for i, ch in enumerate(("ch1", "ch2")):
            v, vp = g_k[i].double(), g_p[i].double()
            tot = v.abs().sum().item()
            e_g = max(abs(s_k[ch]["sum"].item() - v.sum().item()) / tot,
                      abs(s_k[ch]["sumsq"].item() - (v * v).sum().item()) / (v * v).sum().item())
            ext_tol = 1e-6 * max(1.0, v.abs().max().item())
            same_ext = max(abs(s_k[ch]["min"].item() - v.min().item()),
                           abs(s_k[ch]["max"].item() - v.max().item())) <= ext_tol
            d_sum = abs(s_k[ch]["sum"].item() - s_p[ch]["sum"].item())
            d_sq = abs(s_k[ch]["sumsq"].item() - s_p[ch]["sumsq"].item())
            d_min = abs(s_k[ch]["min"].item() - s_p[ch]["min"].item())
            d_max = abs(s_k[ch]["max"].item() - s_p[ch]["max"].item())
            if ch == "ch1" or second == "imag":
                ok = (d_sum <= 1e-5 * tot and d_sq <= 1e-5 * (vp * vp).sum().item()
                      and max(d_min, d_max) <= 1e-6 * max(1.0, v.abs().max().item()))
                what = "1e-5 of the sums, 1e-6 on the extrema"
            else:
                slack = (v - vp).abs()
                ok = (d_sum <= slack.sum().item() + 1e-6 * tot
                      and d_sq <= (v * v - vp * vp).abs().sum().item() + 1e-6 * (vp * vp).sum().item()
                      and max(d_min, d_max) <= max(slack.max().item(), 1e-6))
                what = "the channels' elementwise differences"
            log(f"  {key} {name} {second} {ch}: vs G's channels sums {e_g:.3e} (tol 1e-07), extrema "
                f"{'within' if same_ext else 'NOT within'} {ext_tol:.1e}; vs plain sum {d_sum:.4g}, "
                f"sumsq {d_sq:.4g}, min {d_min:.3e}, max {d_max:.3e} (tol: {what})")
            require(e_g <= 1e-7 and same_ext, f"{key} {name}: statistics differ from G's channels")
            require(ok, f"{key} {name} {ch}: statistics disagree with plain")
            worst = max(worst, d_min, d_max)
        errs[key] = max(errs.get(key, 0.0), worst)

    mag_polar = T.Magnitude(mode="bipolar", contrast="log1p", mel=True, n_fft=N_FFT)
    for wname in ("hann", "gaussian"):
        for second in ("phase", "if", "imag"):
            check_repr("main shape", mono, N_FFT, HOP, wname, second, None if second == "imag" else mag_polar.mel_bank)
            check_repr_stats("main shape", mono, N_FFT, HOP, wname, second)
        check_repr("main shape", mono, N_FFT, HOP, wname, "if", None, weighted=True)
        check_repr("main shape", mono, N_FFT, HOP, wname, "phase", None)
        check_repr_stats("main shape", mono, N_FFT, HOP, wname, "if", weighted=True)
    # frame tiles of 32 (ragged T = 157 at 512/128), 16 (2048/512) and 8 (4096/1024)
    for n_fft, hop in ((512, 128), (2048, 512), (4096, 1024)):
        bank_s = T.Magnitude(mode="bipolar", n_fft=n_fft).mel_bank
        for wname in ("hann", "gaussian"):
            check_repr(f"{n_fft}/{hop}", rag, n_fft, hop, wname, "if", bank_s)
            check_repr_stats(f"{n_fft}/{hop}", rag, n_fft, hop, wname, "phase")

    # A, B, G and H on the FFT route at every power of two they take (hop
    # n_fft / 4, at least the kernels' 32) under hann, hamming and blackman
    # taps (A with the flagship's bank, its bf16 store and int16 input, and
    # the power spectrogram; G and H with each second), and on the smooth
    # route at 768/192 (2^8 3; rows A_smooth, B_smooth, G_smooth, H_smooth).  The taps are given: the port reads
    # no taps off a 64-point blackman window, whose chains run eager
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096, 768):
        hop_s = max(32, n_fft // 4)
        bank_s = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft).mel_bank
        for wname, taps_s in (("hann", (0.5, -0.25)), ("hamming", (0.54, -0.23)),
                              ("blackman", (0.42, -0.25, 0.04))):
            label = f"{n_fft}/{hop_s} {wname}"
            check_forward(label, small, n_fft, hop_s, wname, bank_s, 0.05, 1.3, taps=taps_s)
            check_stats(label, small, n_fft, hop_s, wname, taps_s)
            for second in ("phase", "if", "imag"):
                check_repr_stats(label, small, n_fft, hop_s, wname, second, weighted=second == "if", taps=taps_s)
                check_repr(label, small, n_fft, hop_s, wname, second, None if second == "imag" else bank_s,
                           weighted=second == "if", taps=taps_s)
            check_repr(label, small, n_fft, hop_s, wname, "phase", None, taps=taps_s)
        check_forward(f"{n_fft}/{hop_s} hann", small, n_fft, hop_s, "hann", bank_s, 0.05, 1.3, power=2.0,
                      contrast="none", taps=(0.5, -0.25))

    # G and H full-K by route.  The FFT route at every power of two it takes
    # (hop n_fft / 4; 1024/128 for overlap 8), the smooth route at every
    # SMOOTH_SHAPES framing (even 5-smooth n_fft) and its radix-7 instance
    # at every REPR_SEVEN_SHAPES framing (even 7-smooth n_fft with a factor
    # 7), Polar, weighted PolarIF and Cartesian without mel, contrast or
    # affine, against the plain version: both channels within 1e-6 of their
    # largest value (the plain version repeats the kernel's float32
    # operations in order and atan2f is torch's atan2 on the card: measured
    # bit-identical on the FFT route), against the float64 oracle
    # (torch.stft in float64): |X| and Re / Im within 1e-5 of the largest
    # value, the angle (or the IF's phase steps) weighted by |X| / max|X|
    # within 1e-5; the launches on the route; H as above.  The product route
    # (n_fft 1408 = 2^7 11) and the factored one (hann taps) at 1408/352 as
    # check_repr / check_repr_stats hold them.
    def check_repr_route(name, x, n_fft, hop):
        w = gaussian_dgt_window(n_fft, device=dev)
        route = spectral.melspec_route(n_fft)
        require(route in ("fft", "smooth"), f"G / H full-K {name}: no FFT or smooth route's shape")
        S = torch.stft(x.double(), n_fft, hop, window=w.double(), center=True, pad_mode="reflect",
                       return_complex=True).transpose(-2, -1)
        for second, weighted in (("phase", False), ("if", True), ("imag", False)):
            kw = dict(mel_bank=None, aff=(0.0, 1.0, 0.0, 1.0), contrast="none", weighted=weighted,
                      taps=None, window=w)
            spectral.reset_launches()
            k1, k2 = spectral.fused_spectral_repr(x, n_fft, hop, second, **kw)
            s_k = spectral.fused_repr_stats(x, n_fft, hop, second, contrast="none", weighted=weighted,
                                            taps=None, window=w)
            require(spectral.routes[f"fused_spectral_repr_fullk:{route}"] == 1
                    and spectral.routes[f"fused_repr_stats_fullk:{route}"] == 1,
                    f"G / H full-K {name} {second}: not on the {route} route")
            p1, p2 = spectral.fused_spectral_repr_reference(x, n_fft, hop, second, **kw)
            torch.cuda.synchronize()
            e1, e2 = rel_err(k1, p1), rel_err(k2, p2)
            same = torch.equal(k1, p1) and torch.equal(k2, p2)
            if second == "imag":
                o1, o2 = S.real, S.imag.clone()
                o2[..., -1] = 0.0
                e_o = max(rel_err(k1.double(), o1), rel_err(k2.double(), o2))
                what = "Re / Im"
            else:
                ang = torch.angle(S)
                ang[..., -1] = torch.where(S.real[..., -1] < 0, math.pi, 0.0)
                o2 = ang if second == "phase" else spectral._if_rows(ang, weighted)
                wt = S.abs() / S.abs().amax(dim=(-2, -1), keepdim=True)
                if second == "if":
                    wt[:, 1:] = torch.minimum(wt[:, 1:], wt[:, :-1])
                e_a = (angle_error(second, k2, o2, 1.0, weighted) * wt).max().item()
                e_o = max(rel_err(k1.double(), S.abs()), e_a)
                what = "|X| and the |X|-weighted angle"
            log(f"  G full-K {name} {second}{' weighted' if weighted else ''} ({route} route, plan "
                f"{spectral._repr_plan(n_fft, hop, None, False, second, False)}): vs plain ch1 {e1:.3e}, ch2 "
                f"{e2:.3e} (tol 1e-06; bit-identical {same}); vs float64 oracle ({what}) {e_o:.3e} "
                f"(tol 1e-05)")
            require(all(torch.isfinite(t).all().item() for t in (k1, k2)), f"G full-K {name}: not finite")
            require(e1 <= 1e-6 and e2 <= 1e-6 and e_o <= 1e-5, f"G full-K {name} {second} out of budget")
            key = ("G_fk" if route == "fft" else "G_fk_smooth") + seven_suffix(n_fft, route)
            errs[key] = max(errs.get(key, 0.0), abs_err(k1, p1))
            check_repr_stats(name, x, n_fft, hop, "gaussian", second, weighted)
            del k1, k2, p1, p2
        del S

    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        hop_s = max(32, n_fft // 4)                   # the kernels' gate: hop a multiple of 32
        check_repr_route(f"{n_fft}/{hop_s}", rag, n_fft, hop_s)
    check_repr_route("1024/128", rag, 1024, 128)
    check_repr_route("main shape, 16 clips", mono[:16], N_FFT, HOP)
    for n_fft, hop in SMOOTH_SHAPES + REPR_SEVEN_SHAPES:
        check_repr_route(f"{n_fft}/{hop}", rag, n_fft, hop)
    # G and H on the smooth route with the mel bank and the affine (full-K
    # at 768/256, hann taps at 768/192: the chains' configurations)
    for n_fft, hop, wname in ((768, 256, "gaussian"), (768, 192, "hann")):
        bank_s = T.Magnitude(mode="bipolar", n_fft=n_fft).mel_bank
        check_repr(f"{n_fft}/{hop}", rag, n_fft, hop, wname, "if", bank_s, True)
        check_repr(f"{n_fft}/{hop}", rag, n_fft, hop, wname, "phase", bank_s)
    # G and H on the radix-7 instance at 896/224 (2^7 7): full-K under the
    # DGT's gaussian and with hann taps, each second (the IF weighted), with
    # the bank and the affine (rows G_smooth7, G_fk_smooth7, H_smooth7,
    # H_fk_smooth7); the product route and the factored one (hann taps) at
    # 1408/352 (2^7 11; rows G_factored, G_fk_product, H_factored,
    # H_fk_product)
    for n_fft, hop, fks in ((896, 224, ("_fullk:smooth", ":smooth")), (1408, 352, ("_fullk:product", ":factored"))):
        bank_p = T.Magnitude(mode="bipolar", n_fft=n_fft).mel_bank
        for second, weighted in (("phase", False), ("if", True), ("imag", False)):
            for wname, fk in zip(("gaussian", "hann"), fks):
                sfx = fk[fk.index(":"):]
                check_repr(f"{n_fft}/{hop}", rag, n_fft, hop, wname, second, None if second == "imag" else bank_p,
                           weighted)
                on_g = spectral.routes["fused_spectral_repr" + fk] >= 1 and all(
                    k.endswith(sfx) for k, v in spectral.routes.items() if v)
                check_repr_stats(f"{n_fft}/{hop}", rag, n_fft, hop, wname, second, weighted)
                on_h = spectral.routes["fused_repr_stats" + fk] >= 1 and all(
                    k.endswith(sfx) for k, v in spectral.routes.items() if v)
                require(on_g and on_h, f"G / H {wname} at {n_fft}/{hop}: not on the {sfx[1:]} route")
    # G with the IF and a bank at 4032/2016: no smooth block fits, so it
    # keeps its product (full-K) and factored (hann taps) route, within
    # check_repr's tolerances of its plain version, which reads the same
    # rule; H there takes the radix-7 instance
    bank_4k = T.Magnitude(mode="bipolar", n_fft=4032).mel_bank
    for wname, fk in (("gaussian", "_fullk:product"), ("hann", ":factored")):
        check_repr("4032/2016", rag, 4032, 2016, wname, "if", bank_4k, True)
        require(spectral.routes["fused_spectral_repr" + fk] >= 1 and all(
            k.endswith(fk[fk.index(":"):]) for k, v in spectral.routes.items() if v),
            f"G {wname} with the IF and a bank at 4032/2016: not on the {fk[fk.index(':') + 1:]} route")
        check_repr_stats("4032/2016", rag, 4032, 2016, wname, "if", True)
    spectral.reset_launches()
    torch.cuda.empty_cache()

    # RT and RTs: the RT-PGHI recurrence (csrc/pghi.cu:rt_pghi_phases_kernel,
    # producer warps planning each stage of frames from the magnitudes, chain
    # warps walking them) against its plain version (the same float32
    # operations in the same order: expected bit-identical) on synthetic
    # sessions of 8 streams (ridges drifting in frequency over noise, a tenth
    # of the frames near-silent, which the onset rule seeds, and in the fresh
    # sessions an all-silent chunk), at 33, 513, 1025, 2049 and 4096 bins
    # (the plans' stages: whole chunks, 8, 4 and 1 frames), fresh (4 chunks)
    # and seeded (one chunk after a carried history).  Tolerance: |X| (cos,
    # sin)(phase) within 1e-4 of the largest |X|, the recurrence's gate on
    # the main path (phase 4g); bit identity is logged.
    def rt_session(n, T, n_bins, seed, silent=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        t = torch.arange(T, device=dev, dtype=torch.float32)[:, None]
        k = torch.arange(n_bins, device=dev, dtype=torch.float32)[None, :]
        m = 1e-3 * torch.rand((n, T, n_bins), generator=g, device=dev)
        for b in range(n):
            for c, w, a in (torch.rand((6, 3), generator=g, device=dev).cpu() * torch.tensor([n_bins - 4.0, 3.0, 0.8])
                            + torch.tensor([2.0, 1.0, 0.2])).tolist():
                m[b] += a * torch.exp(-0.5 * ((k - c - 0.05 * t) / w) ** 2)
        m = torch.where(torch.rand((n, T, 1), generator=g, device=dev) < 0.1, 1e-6 * m, m)
        if silent is not None:
            m[:, silent[0]: silent[1]] = 0.0
        return m.contiguous()

    def check_rt(n_bins, T_c, seeded, n=8):
        n_fft_r = 2 * (n_bins - 1)
        hop_r = n_fft_r // 4 if n_fft_r % 4 == 0 else n_fft_r // 2
        gamma_r = 0.25645 * n_fft_r * n_fft_r
        T = T_c if seeded else 4 * T_c
        seed = 300 + n_bins + T_c
        mag = rt_session(n, T, n_bins, seed, None if seeded else (2 * T_c, 3 * T_c))
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        ang = 2 * math.pi * torch.rand((n, T + 3, n_bins), generator=g, device=dev)
        prev = pp = None
        if seeded:
            prev = rt_session(n, 2, n_bins, seed + 2)
            pp = (2 * torch.rand((n, n_bins), generator=g, device=dev) - 1) * math.pi
        r_args = (gamma_r, n_fft_r, hop_r, 1e-2, T_c)
        ss.reset_launches()
        ph_k = ss.rt_pghi_phases(mag, ang, *r_args, prev_mag=prev, prev_phase=pp)
        name = "rt_pghi_seeded" if seeded else "rt_pghi_phases"
        require(ss.launches[name] == 1 and sum(ss.launches.values()) == 1, f"RT {n_bins} bins: no launch")
        ph_p = ss.rt_pghi_phases_reference(mag, ang, *r_args, prev_mag=prev, prev_phase=pp)
        torch.cuda.synchronize()
        e = (unit_spec(mag, ph_k) - unit_spec(mag, ph_p)).abs().max().item()
        same = torch.equal(ph_k, ph_p)
        key = "RTs" if seeded else "RT"
        log(f"  {key} {n_bins} bins, chunks of {T_c}, {n} x {T} frames, plan {ss._rt_plan(n_bins, T_c)}: "
            f"|X| (cos, sin)(phase) off by {e:.3e} of the largest (tol 1e-04); bit-identical {same} "
            f"({100 * (ph_k != ph_p).float().mean().item():.4f}% of bins differ)")
        require(torch.isfinite(ph_k).all().item() and ph_k.shape == ph_p.shape and e <= 1e-4,
                f"{key} {n_bins} bins: the recurrence disagrees with its plain version")
        errs[key] = max(errs.get(key, 0.0), e)

    for n_bins, T_c, T_s in ((33, 8, 12), (513, 16, 22), (1025, 16, 22), (2049, 16, 10), (4096, 2, 3)):
        check_rt(n_bins, T_c, False)
        check_rt(n_bins, T_s, True)
    ss.reset_launches()

    # I: the projection alone.  It is the step kernel without its momentum
    # update, so it must equal C's projection from tprev = 0 bit for bit;
    # against the plain version interior frames within 1e-4, and (hann's edge
    # frames are ill-conditioned on the product route, Queue 3) edge frames
    # no further off the float64 oracle than 10 times the plain version is;
    # on the FFT and the smooth route every frame within 1e-6 of the plain
    # version (measured bit-identical) and 1e-5 of the oracle
    def check_project(name, mag, n_fft, hop, wname, seed):
        w_s = get_window(wname, n_fft, device=dev)
        taps_s = taps_for_window(w_s)
        route = glstep.gl_step_route(n_fft, hop)
        glstep.reset_launches()
        g = torch.Generator(device=dev).manual_seed(seed)
        ph = 2 * math.pi * torch.rand(mag.shape, generator=g, device=dev)
        are, aim = torch.cos(ph), torch.sin(ph)
        rk = glstep.gl_project(mag, are, aim, n_fft, hop, taps_s, w_s)
        rp = glstep.gl_project_reference(mag, are, aim, n_fft, hop, taps_s, w_s)
        z = torch.zeros_like(mag)
        step_c, _, _ = glstep.make_gl_momentum_step(mag, n_fft, hop, taps_s, w_s, 0.3)
        c_out = step_c(are.contiguous(), aim.contiguous(), z, z)
        env = glstep._env_rows(mag.shape[1], n_fft, hop, w_s)
        oo = glstep.gl_momentum_step_oracle(mag[:16], are[:16], aim[:16], z[:16], z[:16], env,
                                            n_fft, hop, taps_s, 0.3)
        torch.cuda.synchronize()
        m = n_fft // hop - 1
        scale = max(rp[0].abs().max().item(), rp[1].abs().max().item())
        e_in = max(abs_err(rk[i][:, m:-m], rp[i][:, m:-m]) for i in (0, 1)) / scale
        sc16 = max(oo[2].abs().max().item(), oo[3].abs().max().item())
        e_k = max((rk[i][:16].double() - oo[2 + i]).abs().max().item() for i in (0, 1)) / sc16
        e_p = max((rp[i][:16].double() - oo[2 + i]).abs().max().item() for i in (0, 1)) / sc16
        same = torch.equal(rk[0], c_out[2]) and torch.equal(rk[1], c_out[3])
        log(f"  I {name} {wname}: interior vs plain {e_in:.3e} (tol 1e-04); every frame vs float64 "
            f"oracle kernel {e_k:.3e}, plain {e_p:.3e} (tol {max(1e-4, 10 * e_p):.3g}); "
            f"equal to C's projection from tprev = 0: {same}")
        require(all(torch.isfinite(t).all().item() for t in rk), f"I {name}: not finite")
        require(e_in <= 1e-4 and e_k <= max(1e-4, 10 * e_p) and same, f"I {name} disagrees")
        require(glstep.routes[f"gl_project:{route}"] == 1, f"I {name}: not on the {route} route")
        if route != "product":
            e_all = max(abs_err(rk[i], rp[i]) for i in (0, 1)) / scale
            bit = torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1])
            log(f"  I {name} ({route} route, block {glstep._step_fft_plan(n_fft, hop)}): every frame vs plain "
                f"{e_all:.3e} (tol 1e-06; bit-identical {bit}), vs float64 oracle {e_k:.3e} (tol 1e-05)")
            require(e_all <= 1e-6 and e_k <= 1e-5, f"I {name}: the {route} route out of budget")
        key = {"fft": "I", "smooth": "I_smooth", "product": "I_product"}[route]
        errs[key] = max(errs.get(key, 0.0), max(abs_err(rk[i][:, m:-m], rp[i][:, m:-m]) for i in (0, 1)))

    check_project("main shape", gl_mag, N_FFT, HOP, "hann", args.seed + 31)
    check_project("512/128", mag_rag, 512, 128, "hamming", args.seed + 32)
    for n_fft, hop, wname in ((64, 32, "hann"), (256, 64, "blackman"), (2048, 512, "hann"), (4096, 2048, "hann"),
                              (896, 224, "hann")) + tuple((n, h, "hann") for n, h in SMOOTH_SHAPES):
        w_s = get_window(wname, n_fft, device=dev)
        check_project(f"{n_fft}/{hop}", att.ops.stft(small, n_fft, hop, w_s).abs(), n_fft, hop, wname,
                      args.seed + 5 * n_fft + hop)

    # J: the full-K momentum step under the DGT's gaussian (w >= 0.01, so
    # every frame is well conditioned): against the plain version (fp32 sums
    # in another order, 1e-4 of the projection's largest value, every frame)
    # and the float64 oracle on 16 clips (1e-5); the new angles weighted by
    # |u| / max|u| within 1e-4.  Then one step is one istft + stft of the
    # eager loop (its boundary rule), and the shapes with other block sizes
    # (blocks of 15 and 7 chunks, no multiple of 8, at 2048/256 and
    # 4096/1024).  Under kaiser (another window without taps, w down to 5e-5
    # at its edges) the same tolerances hold on every frame: the trimmed
    # signal's samples all lie within hop / 2 of a frame's centre.
    def check_fullk(name, mag, n_fft, hop, seed, w_s=None):
        if w_s is None:
            w_s = gaussian_dgt_window(n_fft, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        ph = 2 * math.pi * torch.rand(mag.shape, generator=g, device=dev)
        st = (torch.cos(ph), torch.sin(ph), 0.1 * mag * torch.randn(mag.shape, generator=g, device=dev),
              0.1 * mag * torch.randn(mag.shape, generator=g, device=dev))
        route = glstep._fullk_plan(n_fft, hop)[0]
        glstep.reset_launches()
        step, to_rows, _ = glstep.make_gl_momentum_step_fullk(mag, n_fft, hop, w_s, mom)
        ko = step(*[to_rows(a) for a in st])
        want = "fft" if ff.fft_covers(n_fft) else ("smooth" if ff.fft_covers_smooth7(n_fft) else "product")
        require(glstep.routes[f"gl_momentum_fullk:{route}"] == 1 and sum(glstep.routes.values()) == 1
                and route == want, f"J {name}: not on the {want} route")
        env = glstep._env_rows(mag.shape[1], n_fft, hop, w_s)
        po = glstep.gl_momentum_step_fullk_reference(mag, *st, env, n_fft, hop, w_s, mom)
        oo = glstep.gl_momentum_step_fullk_oracle(mag[:16], *[a[:16] for a in st], env, n_fft, hop, w_s, mom)
        spec = torch.complex(mag[:16] * st[0][:16], mag[:16] * st[1][:16])
        eager = att.ops.stft(istft(spec, n_fft, hop, w_s), n_fft, hop, w_s)
        torch.cuda.synchronize()
        scale = max(po[2].abs().max().item(), po[3].abs().max().item())
        e_p = max(abs_err(ko[i], po[i]) for i in (2, 3)) / scale
        sc16 = max(oo[2].abs().max().item(), oo[3].abs().max().item())
        e_o = max((ko[i][:16].double() - oo[i]).abs().max().item() for i in (2, 3)) / sc16
        e_e = max(abs_err(ko[2][:16], eager.real), abs_err(ko[3][:16], eager.imag)) / sc16
        u = torch.sqrt((po[2] - mom * st[2]) ** 2 + (po[3] - mom * st[3]) ** 2)
        wu = u / u.max()
        e_a = max(((ko[i] - po[i]).abs() * wu).max().item() for i in (0, 1))
        # the FFT and the smooth route repeat their plain version's float32
        # operations in order (bit-identical on the card): 1e-6; the product
        # route sums in another order than cuBLAS: 1e-4
        tol = 1e-6 if route != "product" else 1e-4
        same = all(torch.equal(a, b) for a, b in zip(ko, po))
        log(f"  J {name}, {route} route: projection vs plain {e_p:.3e} (tol {tol:.0e}; bit-identical "
            f"{same}), vs float64 oracle {e_o:.3e} (tol 1e-05), vs one eager istft + stft {e_e:.3e} "
            f"(tol 1e-05); angles weighted by |u| {e_a:.3e} (tol {tol:.0e}); block "
            f"{glstep._fullk_plan(n_fft, hop)[1:]} (chunks, frames, FFTs or slab)")
        require(all(torch.isfinite(t).all().item() for t in ko), f"J {name}: not finite")
        require(e_p <= tol and e_o <= 1e-5 and e_e <= 1e-5 and e_a <= tol, f"J {name} disagrees")
        seven = route == "smooth" and n_fft % 7 == 0
        require(not seven or same, f"J {name}: the radix-7 instance is not bit-identical to its plain version")
        key = {"fft": "J", "smooth": "J_smooth", "product": "J_product"}[route] + ("7" if seven else "")
        errs[key] = max(errs.get(key, 0.0), max(abs_err(ko[i], po[i]) for i in (2, 3)))

    check_fullk("main shape", att.ops.stft(mono, N_FFT, HOP, w_dgt).abs(), N_FFT, HOP, args.seed + 41)
    w_kai = get_window("kaiser", N_FFT, device=dev)
    require(taps_for_window(w_kai) is None, "kaiser must take the full-K step")
    check_fullk("main shape, kaiser", att.ops.stft(mono, N_FFT, HOP, w_kai).abs(), N_FFT, HOP,
                args.seed + 42, w_kai)
    del w_kai
    for n_fft, hop in ((512, 128), (1024, 128), (2048, 512), (2048, 256), (4096, 1024)):
        require(glstep.gl_fullk_available(n_fft, hop), f"J must cover {n_fft}/{hop}")
        w_s = gaussian_dgt_window(n_fft, device=dev)
        check_fullk(f"{n_fft}/{hop}", att.ops.stft(small, n_fft, hop, w_s).abs(), n_fft, hop,
                    args.seed + n_fft + hop)
    # 4096/512 on the FFT route (its product block would need slabs); the
    # smooth route at every SMOOTH_SHAPES framing (bit-identical to the plain
    # version) and its radix-7 instance at every J_SEVEN_SHAPES framing
    # (bit-identical too, rows J_smooth7); the product route where n_fft is
    # neither (1408/352 = 2^7 11) or above 4096 (8192/2048: not even overlap
    # + 2 chunks' whole [re | im] rows fit shared memory, so J builds them in
    # slabs); a clip of three frames reflects its trimmed signal twice (L =
    # n_fft / 2)
    for n_fft, hop in ((4096, 512), (1408, 352), (8192, 2048)) + SMOOTH_SHAPES + J_SEVEN_SHAPES:
        w_s = gaussian_dgt_window(n_fft, device=dev)
        check_fullk(f"{n_fft}/{hop}", att.ops.stft(small, n_fft, hop, w_s).abs(), n_fft, hop,
                    args.seed + n_fft + hop)
    require(glstep._pick_fullk_rows(8192, 2048) is None and glstep._fullk_plan(8192, 2048)[3] == 1056,
            "8192/2048 must take the product route's slabbed block")
    clip3 = att.ops.stft(mono[:, : 2 * HOP + 1].contiguous(), N_FFT, HOP, w_dgt).abs()
    require(clip3.shape[1] == 3, "the short clip must have three frames")
    check_fullk("3-frame clip (two reflections)", clip3, N_FFT, HOP, args.seed + 43)
    del clip3

    # a shape whose narrowest tile exceeds shared memory is refused, not
    # quietly computed some other way
    w_big = get_window("hann", 8192, device=dev)
    try:
        spectral.fused_melspec(small, 8192, 2048, taps=taps_for_window(w_big))
    except NotImplementedError as exc:
        log(f"  A 8192/2048 on the card raises NotImplementedError: {str(exc)[:60]}...")
    else:
        raise SystemExit("FAILED: fused_melspec at 8192/2048 neither ran a kernel nor raised")

    # -------------------------------------------------------- 4. main path
    log(f"[4] main path: Mono + STFT({N_FFT}, {HOP}, hann) + Magnitude(unipolar, log1p, mel) "
        f"on {B} stereo clips of {args.seconds:g} s")
    chain = T.Mono() + T.STFT(n_fft=N_FFT, hop_length=HOP) + T.Magnitude(
        mode="unipolar", contrast="log1p", mel=True, n_fft=N_FFT)
    spectral.reset_launches()
    glstep.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = att.fuse_fit(chain)(audio)
    y = att.fuse_forward(fitted)(audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = fitted.invert(y)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {**spectral.launches, **glstep.launches}
    # the fused forward reaches A through the registered operator
    counts["fused_melspec_op"] = spectral.op_calls["fused_melspec"]
    require(counts["fused_melspec_op"] == counts["fused_melspec"], "fuse_forward did not launch A through the operator")
    log(f"  fit + forward {1e3 * (t1 - t0):.1f} ms, invert (Griffin-Lim, "
        f"{fitted[1].gl_iterations} iterations) {1e3 * (t2 - t1):.1f} ms; launches {counts}")
    for k in ("fused_melspec", "fused_melspec_stats", "gl_momentum_step", "gl_momentum_chain"):
        require(counts[k] > 0, f"kernel {k} was not launched on the main path")
    log(f"  C and D by route: { {k: v for k, v in glstep.routes.items() if v} }")
    for k in ("gl_momentum_step", "gl_momentum_chain"):
        require(glstep.routes[k + ":fft"] == counts[k],
                f"{k}: the main path's launches must all take the FFT route")
        counts[k + ":fft"] = glstep.routes[k + ":fft"]
        counts[k + ":smooth"] = 0       # the smooth and the product route's launches: phase 4h
        counts[k + ":product"] = 0
    log(f"  A and B by route: { {k: v for k, v in spectral.routes.items() if v} }")
    require(spectral.routes["fused_melspec_stats:fft"] == counts["fused_melspec_stats"]
            and spectral.routes["fused_melspec:fft"] == counts["fused_melspec"],
            "the main path's fit (B) and forward (A) must take the FFT route")
    for k in ("fused_melspec_stats", "fused_melspec"):
        counts[k + ":fft"] = spectral.routes[k + ":fft"]
        counts[k + ":smooth"] = 0        # the smooth, radix-7 and factored route's launches: phase 4h
        counts[k + ":smooth7"] = 0
        counts[k + ":factored"] = 0
    sp_m = path_split(att, chain, audio)
    log(f"  fit + forward, median of 5 runs: {sp_m['wall']:.2f} ms to the card's end; the host returns from the "
        f"fit after {sp_m['fit']:.2f} ms, from building the forward after {sp_m['build']:.2f}, from calling it "
        f"after {sp_m['forward']:.2f} (host {sp_m['fit'] + sp_m['build'] + sp_m['forward']:.2f} ms in all)")
    n_frames = 1 + L // HOP
    require(tuple(y.shape) == (B, n_frames, N_FFT // 2 + 1), f"log-mel shape {tuple(y.shape)}")
    require(torch.isfinite(y).all().item(), "log-mel not finite")
    require(tuple(rec.shape) == (B, 1, HOP * (n_frames - 1)), f"inverted shape {tuple(rec.shape)}")
    require(torch.isfinite(rec).all().item(), "inverted audio not finite")

    # what came out is right: against the eager chain
    eager_fit = chain.fit(audio)
    for name in ("offset", "scale"):
        a = getattr(fitted[2].norm, name).item()
        b = getattr(eager_fit[2].norm, name).item()
        e = abs(a - b) / abs(eager_fit[2].norm.scale.item())
        log(f"  fit {name}: kernel {a:.7g}, eager {b:.7g}, difference / scale {e:.3e} (tol 1e-05)")
        require(e <= 1e-5, f"fused fit {name} differs from chain.fit")
    y_eager = fitted.forward(audio)
    e = rel_err(y, y_eager)
    log(f"  fused forward vs eager chain.forward: rel {e:.3e} (tol 1e-04)")
    require(e <= 1e-4, "fused forward differs from chain.forward")
    del y_eager
    pcm = torch.round(mono * 32767.0).to(torch.int16)
    y_pcm = att.fuse_forward(fitted)(pcm)
    y_flt = att.fuse_forward(fitted)(pcm.to(torch.float32) * 2.0 ** -15)
    require(torch.equal(y_pcm, y_flt), "int16 PCM input is not bit-identical to pre-converted float")
    log("  int16 PCM through fuse_forward: bit-identical to the pre-converted float input")
    del y_pcm, y_flt, pcm

    stft_f = fitted[1]
    target = fitted[2].invert(y)
    bank = fitted[2].mel_bank
    off, scl = fitted[2].norm.offset, fitted[2].norm.scale

    def spectral_convergence(audio_rec):
        R = stft_f.forward(audio_rec).abs()
        n = min(R.shape[-2], target.shape[-2])
        return (torch.linalg.norm(R[:, :n] - target[:, :n]) / torch.linalg.norm(target)).item()

    s_kernel = spectral_convergence(rec.squeeze(-2))
    seed_gen = torch.Generator(device=dev).manual_seed(stft_f.seed)
    rec_eager = stft_f.griffin_lim(target, generator=seed_gen, fused=False)
    s_eager = spectral_convergence(rec_eager)
    bound = max(1.15 * s_eager, s_eager + 0.02)
    log(f"  Griffin-Lim spectral convergence: kernel loop {s_kernel:.5f}, eager loop {s_eager:.5f} "
        f"(must be < {bound:.5f})")
    require(s_kernel < bound, "kernel Griffin-Lim converges worse than the eager loop")
    del rec_eager, target
    xm = fitted[0].forward(audio)
    back = stft_f.invert(stft_f.forward(xm))
    e = rel_err(back, xm[..., : back.shape[-1]])
    log(f"  complex STFT -> ISTFT roundtrip: rel {e:.3e} (tol 1e-04)")
    require(e <= 1e-4, "STFT roundtrip out of budget")
    del back, xm

    # ---------------------------------------------------- 4b. the DGT path
    log(f"[4b] DGT path: Mono + DGT({N_FFT}, {HOP}, pghi) + Magnitude(unipolar, log1p, no mel) "
        f"on {B} stereo clips of {args.seconds:g} s")
    del y, rec, fitted, eager_fit
    dgt_chain = T.Mono() + T.DGT(sr=SR, n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi") + T.Magnitude(
        mode="unipolar", contrast="log1p", mel=False)
    spectral.reset_launches()
    glstep.reset_launches()
    pghi_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dgt_fit = att.fuse_fit(dgt_chain)(audio)
    y_dgt = att.fuse_forward(dgt_fit)(audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec_dgt = dgt_fit.invert(y_dgt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dgt_counts = {**spectral.launches, **glstep.launches, **pghi_kernel.launches}
    log(f"  fit + forward {1e3 * (t1 - t0):.1f} ms, invert (PGHI) {1e3 * (t2 - t1):.1f} ms; "
        f"launches {dgt_counts}")
    for k in ("fused_melspec_fullk", "fused_melspec_stats_fullk", "pghi_plan", "pghi_phases", "pghi_synthesize"):
        require(dgt_counts[k] > 0, f"kernel {k} was not launched on the DGT path")
    log(f"  E and F by route: {spectral.routes}; K's synthesis by route: {pghi_kernel.routes}")
    for k in ("fused_melspec_fullk", "fused_melspec_stats_fullk"):
        require(spectral.routes[k + ":fft"] == dgt_counts[k] and spectral.routes[k + ":product"] == 0,
                f"{k}: the DGT path's launches must all take the FFT route")
    require(pghi_kernel.routes["pghi_synthesize:fft"] == dgt_counts["pghi_synthesize"]
            and pghi_kernel.routes["pghi_synthesize:product"] == 0,
            "pghi_synthesize: the DGT path's launches must all take the FFT route")
    counts.update({k: v for k, v in spectral.routes.items() if "_fullk:" in k})   # A and B's: phase 4
    counts.update({k + ":smooth7": 0 for k in ("fused_melspec_fullk", "fused_melspec_stats_fullk")})   # phase 4h
    counts.update(pghi_kernel.routes)
    counts["pghi_synthesize:smooth7"] = 0      # K's synthesis's radix-7 launches: phase 4h
    counts.update({k: dgt_counts[k] for k in ("fused_melspec_fullk", "fused_melspec_stats_fullk",
                                              "pghi_plan", "pghi_phases", "pghi_synthesize")})
    require(tuple(y_dgt.shape) == (B, n_frames, N_FFT // 2 + 1), f"DGT magnitude shape {tuple(y_dgt.shape)}")
    require(torch.isfinite(y_dgt).all().item(), "DGT magnitude not finite")
    require(tuple(rec_dgt.shape) == (B, 1, HOP * (n_frames - 1)), f"PGHI audio shape {tuple(rec_dgt.shape)}")
    require(torch.isfinite(rec_dgt).all().item(), "PGHI audio not finite")
    dgt_eager_fit = dgt_chain.fit(audio)
    for name in ("offset", "scale"):
        a = getattr(dgt_fit[2].norm, name).item()
        b = getattr(dgt_eager_fit[2].norm, name).item()
        e = abs(a - b) / abs(dgt_eager_fit[2].norm.scale.item())
        log(f"  fit {name}: kernel {a:.7g}, eager {b:.7g}, difference / scale {e:.3e} (tol 1e-05)")
        require(e <= 1e-5, f"fused DGT fit {name} differs from chain.fit")
    del dgt_eager_fit
    y_eager = dgt_fit.forward(audio)
    e = rel_err(y_dgt, y_eager)
    log(f"  fused forward vs eager chain.forward: rel {e:.3e} (tol 1e-04)")
    require(e <= 1e-4, "fused DGT forward differs from chain.forward")
    del y_eager
    dgt_f = dgt_fit[1]
    xm = dgt_fit[0].forward(audio)
    back = dgt_f.invert(dgt_f.forward(xm))
    e = rel_err(back, xm[..., : back.shape[-1]])
    log(f"  complex DGT -> inverse roundtrip: rel {e:.3e} (tol 1e-04)")
    require(e <= 1e-4, "DGT roundtrip out of budget")
    del back, xm
    dgt_target = dgt_fit[2].invert(y_dgt)

    def dgt_convergence(audio_rec, tgt):
        R = dgt_f.forward(audio_rec).abs()
        n = min(R.shape[-2], tgt.shape[-2])
        return (torch.linalg.norm(R[:, :n] - tgt[:, :n]) / torch.linalg.norm(tgt)).item()

    s_kernel = dgt_convergence(rec_dgt.squeeze(-2), dgt_target)
    # the eager route on the same magnitudes: pghi_scan + istft, plain PyTorch
    n_e = min(B, 16)
    g_e = torch.Generator(device=dev).manual_seed(dgt_f.seed)
    ph_e = pghi_ops.pghi_scan(dgt_target[:n_e], dgt_f.gamma, N_FFT, HOP, tolerance=dgt_f.tolerance,
                              time_stencil="central", generator=g_e)
    rec_e = istft(torch.polar(dgt_target[:n_e], ph_e), N_FFT, HOP, dgt_f.inv_window)
    s_eager = dgt_convergence(rec_e, dgt_target[:n_e])
    s_kernel_e = dgt_convergence(rec_dgt.squeeze(-2)[:n_e], dgt_target[:n_e])
    bound = max(1.15 * s_eager, s_eager + 0.02)
    log(f"  PGHI spectral convergence: kernels {s_kernel:.5f} on all clips, {s_kernel_e:.5f} on the first "
        f"{n_e}; eager pghi_scan + istft there {s_eager:.5f} (must be < {bound:.5f})")
    require(s_kernel_e < bound, "kernel PGHI converges worse than the eager scan")
    del ph_e, rec_e, rec_dgt
    # the bidirectional inversion through the entry point: K's recurrence
    # with two walk blocks a clip (counted for row K_bidir), converging like
    # the causal kernels (the JAX package's contract for bidir,
    # tests/test_pallas.py:790)
    pghi_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_bid = dgt_fit.invert(y_dgt, inversion_mode="pghi_bidir")
    torch.cuda.synchronize()
    bid_ms = 1e3 * (time.perf_counter() - t0)
    bid_counts = {k: v for k, v in pghi_kernel.launches.items() if v}
    require(bid_counts == {"pghi_plan": 1, "pghi_phases": 1, "pghi_synthesize": 1}
            and tuple(rec_bid.shape) == (B, 1, HOP * (n_frames - 1)) and torch.isfinite(rec_bid).all().item(),
            f"DGT pghi_bidir invert: launches {bid_counts}, audio {tuple(rec_bid.shape)}")
    counts["pghi_bidir"] = bid_counts["pghi_phases"]
    s_bid = dgt_convergence(rec_bid.squeeze(-2)[:n_e], dgt_target[:n_e])
    bound_b = max(1.15 * s_kernel_e, s_kernel_e + 0.02)
    log(f"  invert (pghi_bidir) {bid_ms:.1f} ms; launches {bid_counts}; spectral convergence on the first {n_e} "
        f"clips {s_bid:.5f} (the causal kernels' {s_kernel_e:.5f}; must be < {bound_b:.5f})")
    require(s_bid < bound_b, "kernel bidirectional PGHI converges worse than the causal kernels")
    del rec_bid

    # ------------------------------------------ 4c. the DGT + PolarIF chain
    log(f"[4c] chain R: Mono + DGT({N_FFT}, {HOP}) + PolarIF() (bipolar mel log1p magnitude, bipolar "
        f"forward IF) on {B} stereo clips of {args.seconds:g} s")
    del y_dgt
    r_chain = T.Mono() + T.DGT(sr=SR, n_fft=N_FFT, hop_length=HOP) + T.PolarIF(sr=SR)
    spectral.reset_launches()
    glstep.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_fit = att.fuse_fit(r_chain)(audio)
    y_r = att.fuse_forward(r_fit)(audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec_r = r_fit.invert(y_r)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    r_counts = {**spectral.launches, **glstep.launches}
    log(f"  fit + forward {1e3 * (t1 - t0):.1f} ms, invert (IF integration, polar, inverse DGT) "
        f"{1e3 * (t2 - t1):.1f} ms; launches {r_counts}")
    require(r_counts["fused_repr_stats_fullk"] == 1 and r_counts["fused_spectral_repr_fullk"] == 1
            and sum(r_counts.values()) == 2, "chain R: expected one H and one G launch")
    r_routes = {k: v for k, v in spectral.routes.items() if v}
    log(f"  G and H by route: {r_routes}")
    require(r_routes == {"fused_repr_stats_fullk:fft": 1, "fused_spectral_repr_fullk:fft": 1},
            "chain R: H and G must take the FFT route")
    counts.update({k: r_counts[k] for k in ("fused_repr_stats_fullk", "fused_spectral_repr_fullk")})
    counts.update(r_routes)
    require(tuple(y_r.shape) == (B, n_frames, 2, N_FFT // 2 + 1), f"chain R shape {tuple(y_r.shape)}")
    require(torch.isfinite(y_r).all().item(), "chain R output not finite")
    require(tuple(rec_r.shape) == (B, 1, HOP * (n_frames - 1)) and torch.isfinite(rec_r).all().item(),
            f"chain R inverted audio {tuple(rec_r.shape)}")

    def check_repr_chain(label, chain, fitted, y, second, window, fit_tol2):
        """Fused fit and forward of a representation chain against the eager
        chain: channel 1 and its normalizer as the magnitude chains (1e-5 of
        the scale, 1e-4 relative); channel 2's normalizer within fit_tol2 of
        its scale (its extrema are single bins at the +-pi boundary), and
        channel 2 as an angle."""
        eager_fit = chain.fit(audio)
        for half, tol in (("magnitude", 1e-5), ("phase", fit_tol2)):
            for name in ("offset", "scale"):
                a = getattr(getattr(fitted[2], half).norm, name).item()
                b = getattr(getattr(eager_fit[2], half).norm, name).item()
                e = abs(a - b) / abs(getattr(eager_fit[2], half).norm.scale.item())
                log(f"  fit {half}.{name}: kernel {a:.7g}, eager {b:.7g}, difference / scale {e:.3e} (tol {tol:g})")
                require(e <= tol, f"{label}: fused fit {half}.{name} differs from chain.fit")
        del eager_fit
        y_e = fitted.forward(audio)
        e1 = rel_err(y[..., 0, :], y_e[..., 0, :])
        log(f"  fused forward vs eager chain.forward: ch1 rel {e1:.3e} (tol 1e-04)")
        require(e1 <= 1e-4, f"{label}: channel 1 differs from chain.forward")
        wt = magnitude_weights(fitted[0].forward(audio).squeeze(-2), N_FFT, HOP, window, second)
        scale = fitted[2].phase.norm.scale.item()
        tol_loud = 1e-3
        if second == "if":
            # the eager chain unwraps with a float32 cumulative sum of 2 pi
            # steps, whose values reach |p| (ulp(|p|) of rounding per frame);
            # the kernel's frame-local form has no such term
            from acids_transforms_tpu_torch.ops.phase import unwrap

            p_max = unwrap(torch.angle(fitted[1].forward(fitted[0].forward(audio)))).abs().max().item()
            ulp = torch.finfo(torch.float32).eps * 2.0 ** math.floor(math.log2(p_max))
            tol_loud = max(1e-3, 4.0 * ulp)
            log(f"    the eager chain's unwrapped phases reach {p_max:.4g} rad (one float32 ulp "
                f"{ulp:.3g}): tolerance {tol_loud:.3g} rad")
        check_channel2(f"{label} fused vs eager", second, y[..., 1, :], y_e[..., 1, :], scale, wt, False,
                       tol_loud, tol_loud)
        return y_e

    y_re = check_repr_chain("chain R", r_chain, r_fit, y_r, "if", w_dgt, 1e-4)
    # the IF round trip: the phases integrated back from channel 2 against
    # the DGT's own, weighted by |X| (an SNR over the complex spectrum), for
    # the fused and the eager forward; and the audio against the input
    spec_r = r_fit[1].forward(r_fit[0].forward(audio))

    def if_phase_snr(y):
        ph = r_fit[2].phase.invert(y[..., 1, :])
        err = (spec_r.abs() * (torch.polar(torch.ones_like(ph), ph) - torch.exp(1j * torch.angle(spec_r))).abs())
        return 10 * math.log10((spec_r.abs() ** 2).sum().item() / max((err ** 2).sum().item(), 1e-300))

    snr_k, snr_e = if_phase_snr(y_r), if_phase_snr(y_re)
    xm = r_fit[0].forward(audio)
    e_audio = rel_err(rec_r.squeeze(-2), xm[..., : rec_r.shape[-1]])
    e_audio_e = rel_err(r_fit.invert(y_re).squeeze(-2), xm[..., : rec_r.shape[-1]])
    log(f"  IF round trip: phases back from channel 2 vs the DGT's, |X|-weighted SNR {snr_k:.2f} dB "
        f"(eager chain {snr_e:.2f} dB, must be no worse than 0.5 dB below); audio rel {e_audio:.4f} "
        f"(eager {e_audio_e:.4f}: the mel pseudo-inverse of the magnitude dominates)")
    require(snr_k >= snr_e - 0.5 and e_audio <= 1.01 * e_audio_e + 1e-4, "chain R round trip worse than eager")
    del spec_r, y_re, xm, rec_r

    # ------------------------------------------------- 4d. STFT + Polar
    log(f"[4d] STFT + Polar: Mono + STFT({N_FFT}, {HOP}, hann) + Polar() on {B} stereo clips")
    p_chain = T.Mono() + T.STFT(sr=SR, n_fft=N_FFT, hop_length=HOP) + T.Polar(sr=SR)
    spectral.reset_launches()
    glstep.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_fit = att.fuse_fit(p_chain)(audio)
    y_p = att.fuse_forward(p_fit)(audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p_counts = {**spectral.launches, **glstep.launches}
    log(f"  fit + forward {1e3 * (t1 - t0):.1f} ms; launches {p_counts}")
    require(p_counts["fused_repr_stats"] == 1 and p_counts["fused_spectral_repr"] == 1
            and sum(p_counts.values()) == 2, "STFT + Polar: expected one H and one G launch")
    log(f"  H and G by route: { {k: v for k, v in spectral.routes.items() if v} }")
    require(spectral.routes["fused_repr_stats:fft"] == 1 and spectral.routes["fused_spectral_repr:fft"] == 1,
            "STFT + Polar: the fit (H) and the forward (G) must take the FFT route")
    counts.update({k: p_counts[k] for k in ("fused_repr_stats", "fused_spectral_repr")})
    counts["fused_repr_stats:fft"] = spectral.routes["fused_repr_stats:fft"]
    counts["fused_spectral_repr:fft"] = spectral.routes["fused_spectral_repr:fft"]
    for k in ("fused_repr_stats", "fused_spectral_repr"):
        counts[k + ":smooth"] = counts[k + ":factored"] = 0    # the smooth and factored routes': phase 4h
    for k in ("fused_repr_stats", "fused_spectral_repr", "fused_repr_stats_fullk", "fused_spectral_repr_fullk"):
        counts[k + ":smooth7"] = 0                             # the radix-7 instance's: phase 4h
    y_pb = att.fuse_forward(p_fit, out_dtype=torch.bfloat16)(audio)
    require(torch.equal(y_pb, y_p.to(torch.bfloat16)), "STFT + Polar: the bf16 forward is not the rounded f32")
    log("  the bf16 forward bit-equal to the rounded float32 one")
    del y_pb
    sp_p = path_split(att, p_chain, audio)
    log(f"  fit + forward, median of 5 runs: {sp_p['wall']:.2f} ms to the card's end; the host returns from the "
        f"fit after {sp_p['fit']:.2f} ms, from building the forward after {sp_p['build']:.2f}, from calling it "
        f"after {sp_p['forward']:.2f} (host {sp_p['fit'] + sp_p['build'] + sp_p['forward']:.2f} ms in all)")
    require(tuple(y_p.shape) == (B, n_frames, 2, N_FFT // 2 + 1) and torch.isfinite(y_p).all().item(),
            f"STFT + Polar output {tuple(y_p.shape)}")
    check_repr_chain("STFT + Polar", p_chain, p_fit, y_p, "phase", stft_t.window, 1e-4)
    del y_p

    # -------------------------------------- 4e. D': pghi_gl through kernel J
    log(f"[4e] D': the DGT chain's magnitudes inverted with pghi_gl (PGHI seed, "
        f"{dgt_f.gl_iterations} full-K Griffin-Lim steps)")
    y_dgt = att.fuse_forward(dgt_fit)(audio)
    spectral.reset_launches()
    glstep.reset_launches()
    pghi_kernel.reset_launches()
    draws = dgt_f._draws
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_gl = dgt_fit.invert(y_dgt, inversion_mode="pghi_gl")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gl_counts = {**glstep.launches, **pghi_kernel.launches}
    gl_inv_ms = 1e3 * (t1 - t0)
    log(f"  invert (pghi_gl) {gl_inv_ms:.1f} ms; launches {gl_counts}, J's routes "
        f"{ {k: v for k, v in glstep.routes.items() if v} }")
    require(gl_counts["pghi_plan"] == 1 and gl_counts["pghi_phases"] == 1
            and gl_counts["gl_momentum_fullk"] == dgt_f.gl_iterations
            and glstep.routes["gl_momentum_fullk:fft"] == dgt_f.gl_iterations
            and gl_counts["pghi_synthesize"] == 0, "D': expected 1 recurrence and 30 J launches on the FFT route")
    counts["gl_momentum_fullk"] = gl_counts["gl_momentum_fullk"]
    counts["gl_momentum_fullk:fft"] = glstep.routes["gl_momentum_fullk:fft"]
    # I has no caller on any of the main paths: its launches there, all summed
    counts["gl_project"] = sum(c["gl_project"] for c in (counts, dgt_counts, r_counts, p_counts, gl_counts))
    require(counts["gl_project"] == 0, "gl_project was launched on a main path")
    counts["gl_project:fft"] = counts["gl_project:smooth"] = counts["gl_project:product"] = 0
    require(tuple(rec_gl.shape) == (B, 1, HOP * (n_frames - 1)) and torch.isfinite(rec_gl).all().item(),
            f"pghi_gl audio {tuple(rec_gl.shape)}")
    s_j = dgt_convergence(rec_gl.squeeze(-2), dgt_target)
    # the eager loop from the same seed: the same PGHI phases (the generator
    # the chain drew for them), then fused=False
    ph0 = dgt_f.pghi(dgt_target, generator=torch.Generator(device=dev).manual_seed(dgt_f.seed + draws))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_ge = dgt_f.griffin_lim(dgt_target, init_phase=ph0, fused=False)
    torch.cuda.synchronize()
    gl_eager_ms = 1e3 * (time.perf_counter() - t0)
    s_e = dgt_convergence(rec_ge, dgt_target)
    s_p = dgt_convergence(istft(torch.polar(dgt_target, ph0), N_FFT, HOP, dgt_f.inv_window), dgt_target)
    bound = max(1.15 * s_e, s_e + 0.02)
    log(f"  spectral convergence: pghi_gl through J {s_j:.5f}, eager loop from the same seed {s_e:.5f} "
        f"({gl_eager_ms:.1f} ms), must be < {bound:.5f}; the PGHI seed alone {s_p:.5f}")
    require(s_j < bound, "pghi_gl through J converges worse than the eager loop")
    del rec_gl, rec_ge, ph0

    # ------------------------------------------ 4f. streaming sessions
    stream = stream_phase(args, dev, gen, errs, counts, (spectral, glstep, pghi_kernel))
    # ---------------------------- 4g. streaming RT-PGHI, the complex decode
    rt_stream = stream_pghi_phase(args, dev, errs, counts, stream)
    # ------------------------------------------ 4g. streaming pghi_gl (O)
    gl_stream = stream_pghi_gl_phase(args, dev, errs, counts, stream, rt_stream)
    # ----------------------------- 4h. shapes outside the kernels' structure
    structure_phase(dev, mono, stream, (spectral, glstep, pghi_kernel, ss), errs, counts)
    # ------------------------------------------ 4i. BASELINE configs 2 and 3
    base = baseline_phase(dev, audio, mono, errs, counts)
    # ---------------------- 4j. sinebank, offline and streaming; the regions
    sinebank_regions_phase(dev, audio, mono, stream, (spectral, glstep, pghi_kernel, ss))
    # ----------------------------------------- 4k. serving and export
    serving_export_phase(args, dev, audio, stream, errs, counts)
    # --------------------- 4l. the parallel layer, utils and native
    parallel_phase(args, dev, audio, stream, errs)

    # ------------------------------------------------------------ 5. times
    log("[5] kernel times at the main-path shape (CUDA events around runs of "
        f"{args.repeats} calls back to back, per call, median of 3 runs after warm-up)")
    F = N_FFT // 2 + 1
    Tn = n_frames
    ov = N_FFT // HOP
    window = stft_f.window
    kw = dict(mel_bank=bank, offset=off, scale=scl, contrast="log1p", taps=taps_main)
    nnz = int((bank != 0).sum().item())
    # Operations the function needs, whatever the algorithm: a real FFT of
    # n_fft points is about 2.5 n_fft log2 n_fft operations, then a few per
    # bin for the window, the magnitude, the contrast and the affine.
    fft_flops = 2.5 * N_FFT * math.log2(N_FFT) * B * Tn
    # Operations of the formulation these kernels use (chunk DFT as a
    # product, twiddle combine, taps conv), for the fp32 FMA ceiling of this
    # design: reported beside the bound, never as the bound.
    chunk_flops = 4.0 * B * (Tn + ov - 1) * HOP * F        # cos and sin products of every chunk
    combine_flops = 8.0 * B * Tn * F * ov + 4.0 * B * Tn * F * (2 * len(taps_main) - 1)

    def lib_spec(x):
        return torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                          return_complex=True).abs().transpose(-2, -1)

    def lib_forward():
        return (torch.log1p(torch.matmul(lib_spec(mono), bank)) - off) / scl

    def lib_stats():
        v = torch.log1p(lib_spec(mono))
        return v.sum(), (v * v).sum(), v.min(), v.max()

    def lib_gl(iters):
        a = torch.complex(gl_state[0], gl_state[1])
        tp = torch.complex(gl_state[2], gl_state[3])
        for _ in range(iters):
            sig = torch.istft((gl_mag * a).transpose(-2, -1), N_FFT, HOP, window=window)
            reb = torch.stft(sig, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                             return_complex=True).transpose(-2, -1)
            u = reb - mom * tp
            a, tp = u / u.abs().clamp_min(1e-16), reb
        return a, tp

    def bound_of(n_bytes, flops):
        t_b, t_o = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    def ceiling_of(flops):
        return 1e3 * flops / PEAK_FP32_FLOPS

    def fft_design_flops(n, frames):
        """Operations fft_smem.cuh:frames_rfft does for `frames` frames of n
        points, two a pair: the window (2 n products), per radix-4 butterfly
        16 additions and 3 complex products (6 each), per radix-2 butterfly 4
        additions, and the split (8 per bin)."""
        lg = int(math.log2(n))
        pair = 2.0 * n + (lg // 2) * (n / 4) * 34.0 + (lg % 2) * (n / 2) * 4.0 + 8.0 * (n // 2 + 1)
        return pair * frames / 2.0

    def smooth_design_flops(n, frames):
        """Operations the mixed-radix frames_rfft (fft_smem.cuh, kSmooth)
        does for `frames` frames of n points, two a pair: the window (2 n),
        per butterfly of radix 7 / 5 / 3 / 4 / 2 96 / 48 / 16 / 16 / 4 operations and
        6 a twiddle (r - 1 of them, none in the last stage), the split (8 a
        bin)."""
        bfly, rad = {7: 96, 5: 48, 3: 16, 4: 16, 2: 4}, ff.fft_radices(n)
        pair = 2.0 * n + 8.0 * (n // 2 + 1)
        for st, r in enumerate(rad):
            pair += (n / r) * (bfly[r] + (6.0 * (r - 1) if st < len(rad) - 1 else 0.0))
        return pair * frames / 2.0

    # window (1 per sample), |X| (4 per bin), mel (2 per nonzero), log1p and affine (3 per bin)
    fwd_flops = fft_flops + B * Tn * (N_FFT + 7.0 * F + 2.0 * nnz)
    stats_flops = fft_flops + B * Tn * (N_FFT + 5.0 * F + 4.0 * F)
    gl_bytes = 9.0 * 4 * B * Tn * F + 4.0 * (Tn + ov - 1) * HOP
    # per iteration: inverse and forward FFT, both windowings, the envelope
    # division, mag * angles (2 per bin), u and its normalisation (10 per bin)
    gl_need = 2 * fft_flops + B * Tn * (3.0 * N_FFT + 12.0 * F)
    gl_flops = 2 * chunk_flops + 2 * combine_flops + 10.0 * B * Tn * F
    # C and D on the FFT route: per block of c_tile frames, frames_irfft of
    # c_tile + 2 overlap frames (the neighbours' frames synthesized again)
    # and frames_rfft of the tile's frames (fft_design_flops), mag * angles
    # and the update (12 per bin), the leak and the envelope (3 per sample).
    # Their smooth route's rows at 768/192 (2^8 3) on the same clips: the same
    # with smooth_design_flops at the smooth plan's tile; their product
    # route's rows at 896/224 (2^7 7): that design's chunk products and taps
    # conv, as above, the chain's halo recomputed.
    c_tile = glstep._step_fft_plan(N_FFT, HOP)[0]
    c_blocks = B * -(-Tn // c_tile)
    c_flops = (fft_design_flops(N_FFT, c_blocks * (c_tile + 2 * ov)) + fft_design_flops(N_FFT, B * Tn)
               + 12.0 * B * Tn * F + 3.0 * B * (Tn + ov - 1) * HOP)
    n_fft_g, hop_g = 768, 192
    w_g = get_window("hann", n_fft_g, device=dev)
    taps_g = taps_for_window(w_g)
    mag_g = att.ops.stft(mono, n_fft_g, hop_g, w_g).abs()
    Tg, Fg, ov_g = mag_g.shape[1], mag_g.shape[2], n_fft_g // hop_g
    gg = torch.Generator(device=dev).manual_seed(args.seed + 55)
    ph_g = 2 * math.pi * torch.rand(mag_g.shape, generator=gg, device=dev)
    g_st = (torch.cos(ph_g), torch.sin(ph_g), torch.zeros_like(ph_g), torch.zeros_like(ph_g))
    del ph_g
    env_g = glstep._env_rows(Tg, n_fft_g, hop_g, w_g)
    chain_g = glstep.gl_max_chain(n_fft_g, hop_g, 4)
    step1_g = glstep.make_gl_momentum_step(mag_g, n_fft_g, hop_g, taps_g, w_g, mom)[0]
    step4_g = glstep.make_gl_momentum_step(mag_g, n_fft_g, hop_g, taps_g, w_g, mom, iters=chain_g)[0]
    el_g = float(B * Tg * Fg)
    fft_g = 2.5 * n_fft_g * math.log2(n_fft_g) * B * Tg
    gl_bytes_g = 9.0 * 4 * el_g + 4.0 * (Tg + ov_g - 1) * hop_g
    gl_need_g = 2 * fft_g + B * Tg * (3.0 * n_fft_g + 12.0 * Fg)
    cg_tile = glstep._step_fft_plan(n_fft_g, hop_g)[0]
    cg_flops = (smooth_design_flops(n_fft_g, B * -(-Tg // cg_tile) * (cg_tile + 2 * ov_g))
                + smooth_design_flops(n_fft_g, B * Tg) + 12.0 * el_g + 3.0 * B * (Tg + ov_g - 1) * hop_g)

    def lib_stats_g():
        v = torch.log1p(torch.stft(mono, n_fft_g, hop_g, window=w_g, center=True, pad_mode="reflect",
                                   return_complex=True).abs())
        return v.sum(), (v * v).sum(), v.min(), v.max()

    def lib_gl_g(iters):
        a = torch.complex(g_st[0], g_st[1])
        tp = torch.complex(g_st[2], g_st[3])
        for _ in range(iters):
            sig = torch.istft((mag_g * a).transpose(-2, -1), n_fft_g, hop_g, window=w_g)
            reb = torch.stft(sig, n_fft_g, hop_g, window=w_g, center=True, pad_mode="reflect",
                             return_complex=True).transpose(-2, -1)
            u = reb - mom * tp
            a, tp = u / u.abs().clamp_min(1e-16), reb
        return a, tp

    # A's and B's smooth route at 768/192 (2^8 3) on the same clips, with
    # the square bank of that size: E's and F's smooth instances under the
    # taps' own window, frames_rfft<true>'s operations (smooth_design_flops);
    # their radix-7 instance at 896/224 (2^7 7) likewise (rows A_smooth7,
    # B_smooth7); their factored route at 1408/352 (2^7 11): that design's
    # chunk products, twiddle combine and taps conv.  Phase 4h's launches,
    # all three
    bank_g = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft_g).mel_bank
    nnz_g = int((bank_g != 0).sum().item())
    kw_ag = dict(kw, mel_bank=bank_g, taps=taps_g)

    def lib_forward_g():
        S = torch.stft(mono, n_fft_g, hop_g, window=w_g, center=True, pad_mode="reflect", return_complex=True)
        return (torch.log1p(torch.matmul(S.abs().transpose(-2, -1), bank_g)) - off) / scl

    n_fft_y, hop_y = 896, 224
    w_y = get_window("hann", n_fft_y, device=dev)
    taps_y = taps_for_window(w_y)
    Ty, Fy, ov_y = 1 + L // hop_y, n_fft_y // 2 + 1, n_fft_y // hop_y
    el_y = float(B * Ty * Fy)
    fft_y = 2.5 * n_fft_y * math.log2(n_fft_y) * B * Ty
    bank_y = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft_y).mel_bank
    nnz_y = int((bank_y != 0).sum().item())
    kw_ay = dict(kw, mel_bank=bank_y, taps=taps_y)
    n11, hop11 = 1408, 352
    w11 = get_window("hann", n11, device=dev)
    taps11 = taps_for_window(w11)
    T11, F11, ov11 = 1 + L // hop11, n11 // 2 + 1, n11 // hop11
    el11 = float(B * T11 * F11)
    fft11 = 2.5 * n11 * math.log2(n11) * B * T11
    bank11 = T.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n11).mel_bank
    nnz11 = int((bank11 != 0).sum().item())
    kw_a11 = dict(kw, mel_bank=bank11, taps=taps11)
    require(spectral.melspec_route(n_fft_g) == spectral.melspec_route(n_fft_y) == "smooth"
            and spectral.melspec_route(n11) == "other",
            "phase 5: A and B must be smooth at 768 and 896 (its radix-7 instance) and factored at 1408")

    def lib_forward_11():
        S = torch.stft(mono, n11, hop11, window=w11, center=True, pad_mode="reflect", return_complex=True)
        return (torch.log1p(torch.matmul(S.abs().transpose(-2, -1), bank11)) - off) / scl

    def lib_stats_11():
        v = torch.log1p(torch.stft(mono, n11, hop11, window=w11, center=True, pad_mode="reflect",
                                   return_complex=True).abs())
        return v.sum(), (v * v).sum(), v.min(), v.max()

    factored11 = (4.0 * B * (T11 + ov11 - 1) * hop11 * F11 + 8.0 * el11 * ov11
                  + 4.0 * el11 * (2 * len(taps11) - 1))       # the factored design's front end at 1408/352
    seven_fwd, seven_stats = melspec_smooth_instance(_build.kernel_resources(), seven=True)

    def lib_forward_y():
        S = torch.stft(mono, n_fft_y, hop_y, window=w_y, center=True, pad_mode="reflect", return_complex=True)
        return (torch.log1p(torch.matmul(S.abs().transpose(-2, -1), bank_y)) - off) / scl

    def lib_stats_y():
        v = torch.log1p(torch.stft(mono, n_fft_y, hop_y, window=w_y, center=True, pad_mode="reflect",
                                   return_complex=True).abs())
        return v.sum(), (v * v).sum(), v.min(), v.max()

    smooth_fwd, smooth_stats = melspec_smooth_instance(_build.kernel_resources())
    gl_res = gl_smooth_resources(_build.kernel_resources())
    res_c = next(v for k, v in gl_res.items() if "gl_step_fft_kernel" in k)
    res_j = next(v for k, v in gl_res.items() if "gl_fullk_fft_kernel" in k)
    # C, D and I's product route at 896/224 (2^7 7) on the same clips
    mag_gy = att.ops.stft(mono, n_fft_y, hop_y, w_y).abs()
    gy = torch.Generator(device=dev).manual_seed(args.seed + 56)
    ph_y = 2 * math.pi * torch.rand(mag_gy.shape, generator=gy, device=dev)
    y_st = (torch.cos(ph_y), torch.sin(ph_y), torch.zeros_like(ph_y), torch.zeros_like(ph_y))
    del ph_y
    env_y = glstep._env_rows(Ty, n_fft_y, hop_y, w_y)
    chain_y = glstep.gl_max_chain(n_fft_y, hop_y, 4)
    require(glstep.gl_step_route(n_fft_y, hop_y) == "product" and glstep.gl_step_route(n_fft_g, hop_g) == "smooth"
            and chain_g == chain_y == 4, "phase 5: C, D and I must be smooth at 768/192 and product at 896/224")
    step1_y = glstep.make_gl_momentum_step(mag_gy, n_fft_y, hop_y, taps_y, w_y, mom)[0]
    step4_y = glstep.make_gl_momentum_step(mag_gy, n_fft_y, hop_y, taps_y, w_y, mom, iters=chain_y)[0]
    gl_bytes_y = 9.0 * 4 * el_y + 4.0 * (Ty + ov_y - 1) * hop_y
    gl_need_y = 2 * fft_y + B * Ty * (3.0 * n_fft_y + 12.0 * Fy)
    gl_flops_y = (2 * 4.0 * B * (Ty + ov_y - 1) * hop_y * Fy + 2 * 8.0 * el_y * ov_y
                  + 2 * 4.0 * el_y * (2 * len(taps_y) - 1) + 10.0 * el_y)
    y_tile = glstep._pick_tile(Ty, chain_y, ov_y, hop_y)
    gl_flops_y_chain = gl_flops_y * (y_tile + 2 * (ov_y - 1) * (chain_y - 1)) / y_tile

    def lib_gl_y(iters):
        a = torch.complex(y_st[0], y_st[1])
        tp = torch.complex(y_st[2], y_st[3])
        for _ in range(iters):
            sig = torch.istft((mag_gy * a).transpose(-2, -1), n_fft_y, hop_y, window=w_y)
            reb = torch.stft(sig, n_fft_y, hop_y, window=w_y, center=True, pad_mode="reflect",
                             return_complex=True).transpose(-2, -1)
            u = reb - mom * tp
            a, tp = u / u.abs().clamp_min(1e-16), reb
        return a, tp

    def lib_project_y():
        sig = torch.istft((mag_gy * torch.complex(y_st[0], y_st[1])).transpose(-2, -1), n_fft_y, hop_y, window=w_y)
        return torch.stft(sig, n_fft_y, hop_y, window=w_y, center=True, pad_mode="reflect", return_complex=True)

    specs = [
        dict(key="A", name="fused_melspec", front_end="fft",
             source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:732",
             launches=counts["fused_melspec:fft"],
             run=lambda: spectral.fused_melspec(mono, N_FFT, HOP, **kw),
             plain=lambda: spectral.fused_melspec_reference(mono, N_FFT, HOP, **kw),
             library=lib_forward,
             bound=bound_of(4.0 * B * L + 4.0 * B * Tn * F + 4.0 * F * F, fwd_flops),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 7.0 * B * Tn * F + 2.0 * B * Tn * nnz)),
        dict(key="A_op", name="fused_melspec_op", front_end="fft",
             source="acids_transforms_tpu_torch/ops/cuda/spectral.py (torch.library.custom_op over "
                    "csrc/spectral.cu)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:732",
             launches=counts["fused_melspec_op"],
             run=lambda: spectral.fused_melspec_op(mono, N_FFT, HOP, **kw),
             plain=lambda: spectral.fused_melspec_reference(mono, N_FFT, HOP, **kw),
             library=lib_forward,
             bound=bound_of(4.0 * B * L + 4.0 * B * Tn * F + 4.0 * F * F, fwd_flops),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 7.0 * B * Tn * F + 2.0 * B * Tn * nnz)),
        dict(key="A_smooth", name="fused_melspec_smooth", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:732",
             launches=counts["fused_melspec:smooth"],
             run=lambda: spectral.fused_melspec(mono, n_fft_g, hop_g, **kw_ag),
             plain=lambda: spectral.fused_melspec_reference(mono, n_fft_g, hop_g, **kw_ag),
             library=lib_forward_g,
             bound=bound_of(4.0 * B * L + 4.0 * el_g + 4.0 * Fg * Fg,
                            fft_g + B * Tg * (n_fft_g + 7.0 * Fg + 2.0 * nnz_g)),
             ceiling=ceiling_of(smooth_design_flops(n_fft_g, B * Tg) + 7.0 * el_g + 2.0 * B * Tg * nnz_g),
             resources=smooth_fwd),
        dict(key="A_smooth7", name="fused_melspec_smooth7", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:732",
             launches=counts["fused_melspec:smooth7"],
             run=lambda: spectral.fused_melspec(mono, n_fft_y, hop_y, **kw_ay),
             plain=lambda: spectral.fused_melspec_reference(mono, n_fft_y, hop_y, **kw_ay),
             library=lib_forward_y,
             bound=bound_of(4.0 * B * L + 4.0 * el_y + 4.0 * Fy * Fy,
                            fft_y + B * Ty * (n_fft_y + 7.0 * Fy + 2.0 * nnz_y)),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, B * Ty) + 7.0 * el_y + 2.0 * B * Ty * nnz_y),
             resources=seven_fwd),
        dict(key="A_factored", name="fused_melspec_factored", front_end="factored",
             source="acids_transforms_tpu_torch/csrc/spectral.cu",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:732",
             launches=counts["fused_melspec:factored"],
             run=lambda: spectral.fused_melspec(mono, n11, hop11, **kw_a11),
             plain=lambda: spectral.fused_melspec_reference(mono, n11, hop11, **kw_a11),
             library=lib_forward_11,
             bound=bound_of(4.0 * B * L + 4.0 * el11 + 4.0 * F11 * F11,
                            fft11 + B * T11 * (n11 + 7.0 * F11 + 2.0 * nnz11)),
             ceiling=ceiling_of(factored11 + 3.0 * el11 + 2.0 * B * T11 * nnz11)),
        dict(key="B", name="fused_melspec_stats", front_end="fft",
             source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:903",
             launches=counts["fused_melspec_stats:fft"],
             run=lambda: spectral.fused_melspec_stats(mono, N_FFT, HOP, "log1p", taps=taps_main),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, N_FFT, HOP, "log1p", taps=taps_main),
             library=lib_stats,
             bound=bound_of(4.0 * B * L, stats_flops),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 9.0 * B * Tn * F)),
        dict(key="B_smooth", name="fused_melspec_stats_smooth", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:903",
             launches=counts["fused_melspec_stats:smooth"],
             run=lambda: spectral.fused_melspec_stats(mono, n_fft_g, hop_g, "log1p", taps=taps_g),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, n_fft_g, hop_g, "log1p", taps=taps_g),
             library=lib_stats_g,
             bound=bound_of(4.0 * B * L, fft_g + B * Tg * (n_fft_g + 9.0 * Fg)),
             ceiling=ceiling_of(smooth_design_flops(n_fft_g, B * Tg) + 9.0 * el_g), resources=smooth_stats),
        dict(key="B_smooth7", name="fused_melspec_stats_smooth7", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:903",
             launches=counts["fused_melspec_stats:smooth7"],
             run=lambda: spectral.fused_melspec_stats(mono, n_fft_y, hop_y, "log1p", taps=taps_y),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, n_fft_y, hop_y, "log1p", taps=taps_y),
             library=lib_stats_y,
             bound=bound_of(4.0 * B * L, fft_y + B * Ty * (n_fft_y + 9.0 * Fy)),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, B * Ty) + 9.0 * el_y), resources=seven_stats),
        dict(key="B_factored", name="fused_melspec_stats_factored", front_end="factored",
             source="acids_transforms_tpu_torch/csrc/spectral.cu",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:903",
             launches=counts["fused_melspec_stats:factored"],
             run=lambda: spectral.fused_melspec_stats(mono, n11, hop11, "log1p", taps=taps11),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, n11, hop11, "log1p", taps=taps11),
             library=lib_stats_11,
             bound=bound_of(4.0 * B * L, fft11 + B * T11 * (n11 + 9.0 * F11)),
             ceiling=ceiling_of(factored11 + 8.0 * el11)),
        dict(key="C", name="gl_momentum_step", front_end="fft",
             source="acids_transforms_tpu_torch/csrc/glstep.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:294",
             launches=counts["gl_momentum_step:fft"],
             run=lambda: step1(*gl_state),
             plain=lambda: glstep.gl_momentum_step_reference(
                 gl_mag, *gl_state, gl_env, N_FFT, HOP, taps_main, mom, 1),
             library=lambda: lib_gl(1),
             bound=bound_of(gl_bytes, gl_need),
             ceiling=ceiling_of(c_flops)),
        dict(key="C_smooth", name="gl_momentum_step_smooth", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/glstep.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:294",
             launches=counts["gl_momentum_step:smooth"],
             run=lambda: step1_g(*g_st),
             plain=lambda: glstep.gl_momentum_step_reference(mag_g, *g_st, env_g, n_fft_g, hop_g, taps_g, mom, 1),
             library=lambda: lib_gl_g(1), bound=bound_of(gl_bytes_g, gl_need_g), ceiling=ceiling_of(cg_flops),
             resources=res_c),
        dict(key="C_product", name="gl_momentum_step_product", front_end="product",
             source="acids_transforms_tpu_torch/csrc/glstep.cu", replaces="acids_transforms_tpu/ops/pallas/glstep.py:294",
             launches=counts["gl_momentum_step:product"],
             run=lambda: step1_y(*y_st),
             plain=lambda: glstep.gl_momentum_step_reference(mag_gy, *y_st, env_y, n_fft_y, hop_y, taps_y, mom, 1),
             library=lambda: lib_gl_y(1), bound=bound_of(gl_bytes_y, gl_need_y), ceiling=ceiling_of(gl_flops_y)),
        dict(key="D", name="gl_momentum_chain", front_end="fft",
             source="acids_transforms_tpu_torch/csrc/glstep.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:326",
             launches=counts["gl_momentum_chain:fft"],
             run=lambda: step4(*gl_state),
             plain=lambda: glstep.gl_momentum_step_reference(
                 gl_mag, *gl_state, gl_env, N_FFT, HOP, taps_main, mom, 4),
             library=lambda: lib_gl(4),
             bound=bound_of(gl_bytes, 4 * gl_need),
             ceiling=ceiling_of(4 * c_flops)),
        dict(key="D_smooth", name="gl_momentum_chain_smooth", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/glstep.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:326",
             launches=counts["gl_momentum_chain:smooth"],
             run=lambda: step4_g(*g_st),
             plain=lambda: glstep.gl_momentum_step_reference(mag_g, *g_st, env_g, n_fft_g, hop_g, taps_g, mom,
                                                             chain_g),
             library=lambda: lib_gl_g(chain_g), bound=bound_of(gl_bytes_g, chain_g * gl_need_g),
             ceiling=ceiling_of(chain_g * cg_flops), resources=res_c),
        dict(key="D_product", name="gl_momentum_chain_product", front_end="product",
             source="acids_transforms_tpu_torch/csrc/glstep.cu", replaces="acids_transforms_tpu/ops/pallas/glstep.py:326",
             launches=counts["gl_momentum_chain:product"],
             run=lambda: step4_y(*y_st),
             plain=lambda: glstep.gl_momentum_step_reference(mag_gy, *y_st, env_y, n_fft_y, hop_y, taps_y, mom,
                                                             chain_y),
             library=lambda: lib_gl_y(chain_y), bound=bound_of(gl_bytes_y, chain_y * gl_need_y),
             ceiling=ceiling_of(chain_y * gl_flops_y_chain)),
    ]
    # ---- the DGT path's kernels.  E and F: the same function as A and B
    # under another window (no mel), so the same bound.  On the main path they
    # take the FFT route (fft_smem.cuh:frames_rfft): its own fp32 ceiling is
    # the operations this design does (fft_design_flops), not a bound.  Their
    # smooth route (768/256 = 2^8 3, on the same clips) does
    # smooth_design_flops, its radix-7 instance (896/224 = 2^7 7) likewise;
    # their product route (1408/352 = 2^7 11) the full n_fft-long product per
    # frame, `overlap` times the chunk products.  All counted in phase 4h.
    kw_e = dict(mel_bank=None, offset=dgt_fit[2].norm.offset, scale=dgt_fit[2].norm.scale,
                contrast="log1p", taps=None, window=dgt_f.window)
    e_need = fft_flops + B * Tn * (N_FFT + 7.0 * F)
    n_fft_p, hop_p = 768, 256      # E, F, J, G and H full-K and K's synthesis smooth
    Tp, Fp = 1 + L // hop_p, n_fft_p // 2 + 1
    w_p = gaussian_dgt_window(n_fft_p, device=dev)
    kw_p = dict(kw_e, window=w_p)
    fft_p = 2.5 * n_fft_p * math.log2(n_fft_p) * B * Tp
    el_p = float(B * Tp * Fp)
    e_need_p = fft_p + B * Tp * (n_fft_p + 7.0 * Fp)

    def lib_dgt_spec_p(x):
        return torch.stft(x, n_fft_p, hop_p, window=w_p, center=True, pad_mode="reflect",
                          return_complex=True).abs().transpose(-2, -1)
    gamma = dgt_f.gamma
    k_angles = 2 * math.pi * torch.rand(dgt_target.shape, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(args.seed + 21))
    k_phases = pghi_kernel.pghi_phases_fused(dgt_target, gamma, N_FFT, HOP, tolerance=dgt_f.tolerance,
                                             angles=k_angles)
    silent = (dgt_target <= pghi_kernel._abstol(dgt_target, dgt_f.tolerance)[:, None, None]).float().mean().item()
    n_el = float(B * Tn * F)
    n_audio = float(B * (Tn + ov - 1) * HOP)
    # recurrence: magnitudes read, phases written, angles read at the silent
    # bins only (this run's share); three logarithms, the gradients and the
    # two scans are some 150 operations per bin.  Its plan reads the
    # magnitudes and those angles and writes (B, T, Fp) int16 sources and
    # float offsets; its walk reads that plan and writes the phases, one
    # addition a bin
    phases_bound = bound_of(4.0 * n_el * (2.0 + silent), 150.0 * n_el)
    n_plan = float(B * Tn * pghi_kernel._plan_row(F))
    k_src, k_off = pghi_kernel.pghi_plan(dgt_target, gamma, N_FFT, HOP, dgt_f.tolerance, False, angles=k_angles)
    plan_bound = bound_of(4.0 * n_el * (1.0 + silent) + 6.0 * n_plan, 150.0 * n_el)
    walk_bound = bound_of(6.0 * n_plan + 4.0 * n_el, n_el)
    # synthesis: magnitudes and phases read, the overlap-add signal written;
    # an inverse FFT per frame, sincos and the products per bin, the window.
    # Its FFT route runs, per block of R output chunks, frames_irfft of R + 2
    # overlap frames (fft_design_flops: the pack in place of the split, the
    # window in place of the windowing), sincos and two products per bin (22)
    # and one addition per sample; the smooth route (768/256 here, on the
    # same clips) the same with smooth_design_flops, its radix-7 instance
    # (896/224 = 2^7 7) likewise; the product route (1408/352 = 2^7 11, on
    # the same clips) the product of 2F terms per sample and overlap.
    synth_need = fft_flops + B * Tn * (40.0 * F + 2.0 * N_FFT)
    synth_bound = bound_of(8.0 * n_el + 4.0 * n_audio, synth_need)
    k_rows, _ = pghi_kernel._synth_fft_plan(N_FFT, HOP)
    k_blocks = B * -(-(Tn + ov - 1) // k_rows)
    synth_flops = (fft_design_flops(N_FFT, k_blocks * (k_rows + 2 * ov)) + 22.0 * n_el
                   + float(B * Tn * N_FFT))
    ov_p = n_fft_p // hop_p
    n_audio_p = float(B * (Tp + ov_p - 1) * hop_p)
    kp_target = att.ops.stft(mono, n_fft_p, hop_p, w_p).abs()
    kp_phases = 2 * math.pi * torch.rand(kp_target.shape, device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(args.seed + 22))
    w_p_inv = dgt_f.inv_window if n_fft_p == N_FFT else T.DGT(n_fft=n_fft_p, hop_length=hop_p).inv_window
    synth_bound_p = bound_of(8.0 * el_p + 4.0 * n_audio_p, fft_p + B * Tp * (40.0 * Fp + 2.0 * n_fft_p))
    kp_rows, _ = pghi_kernel._synth_fft_plan(n_fft_p, hop_p)
    kp_blocks = B * -(-(Tp + ov_p - 1) // kp_rows)
    synth_flops_p = (smooth_design_flops(n_fft_p, kp_blocks * (kp_rows + 2 * ov_p)) + 22.0 * el_p
                     + float(B * Tp * n_fft_p))
    # K's synthesis on its radix-7 instance at 896/224 (2^7 7), the same clips
    ky_n, ky_hop = 896, 224
    ky_T, ky_F, ky_ov = 1 + L // ky_hop, ky_n // 2 + 1, ky_n // ky_hop
    ky_el, ky_audio = float(B * ky_T * ky_F), float(B * (ky_T + ky_ov - 1) * ky_hop)
    w_ky = gaussian_dgt_window(ky_n, device=dev)
    ky_target = att.ops.stft(mono, ky_n, ky_hop, w_ky).abs()
    ky_phases = 2 * math.pi * torch.rand(ky_target.shape, device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(args.seed + 23))
    w_ky_inv = T.DGT(n_fft=ky_n, hop_length=ky_hop).inv_window
    synth_bound_y = bound_of(8.0 * ky_el + 4.0 * ky_audio, 2.5 * ky_n * math.log2(ky_n) * B * ky_T
                             + B * ky_T * (40.0 * ky_F + 2.0 * ky_n))
    ky_rows, _ = pghi_kernel._synth_fft_plan(ky_n, ky_hop)
    ky_blocks = B * -(-(ky_T + ky_ov - 1) // ky_rows)
    synth_flops_y = (smooth_design_flops(ky_n, ky_blocks * (ky_rows + 2 * ky_ov)) + 22.0 * ky_el
                     + float(B * ky_T * ky_n))
    # and on the product route at 1408/352 (2^7 11), the same clips
    kx_n, kx_hop = 1408, 352
    kx_T, kx_F, kx_ov = 1 + L // kx_hop, kx_n // 2 + 1, kx_n // kx_hop
    kx_el, kx_audio = float(B * kx_T * kx_F), float(B * (kx_T + kx_ov - 1) * kx_hop)
    kx_target = att.ops.stft(mono, kx_n, kx_hop, gaussian_dgt_window(kx_n, device=dev)).abs()
    kx_phases = 2 * math.pi * torch.rand(kx_target.shape, device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(args.seed + 25))
    w_kx_inv = T.DGT(n_fft=kx_n, hop_length=kx_hop).inv_window
    synth_bound_x = bound_of(8.0 * kx_el + 4.0 * kx_audio, 2.5 * kx_n * math.log2(kx_n) * B * kx_T
                             + B * kx_T * (40.0 * kx_F + 2.0 * kx_n))
    synth_flops_x = 2.0 * kx_audio * kx_ov * 2.0 * kx_F + 22.0 * kx_el    # the product this route runs

    def lib_dgt_spec(x):
        return torch.stft(x, N_FFT, HOP, window=dgt_f.window, center=True, pad_mode="reflect",
                          return_complex=True).abs().transpose(-2, -1)

    def lib_dgt_stats():
        v = torch.log1p(lib_dgt_spec(mono))
        return v.sum(), (v * v).sum(), v.min(), v.max()

    def lib_istft():
        return torch.istft(torch.polar(dgt_target, k_phases).transpose(-2, -1), N_FFT, HOP,
                           window=dgt_f.inv_window)

    def lib_istft_p():
        return torch.istft(torch.polar(kp_target, kp_phases).transpose(-2, -1), n_fft_p, hop_p, window=w_p_inv)

    def lib_istft_y():
        return torch.istft(torch.polar(ky_target, ky_phases).transpose(-2, -1), ky_n, ky_hop, window=w_ky_inv)

    def lib_istft_x():
        return torch.istft(torch.polar(kx_target, kx_phases).transpose(-2, -1), kx_n, kx_hop, window=w_kx_inv)

    def whole_inversion():
        return pghi_kernel.pghi_invert_fused(dgt_target, gamma, N_FFT, HOP, dgt_f.inv_window,
                                             tolerance=dgt_f.tolerance, angles=k_angles)

    pghi_src = "acids_transforms_tpu_torch/csrc/pghi.cu"
    pghi_tpu = "acids_transforms_tpu/ops/pallas/pghi_kernel.py:124"
    def lib_dgt_stats_p():
        v = torch.log1p(lib_dgt_spec_p(mono))
        return v.sum(), (v * v).sum(), v.min(), v.max()

    w_yd = gaussian_dgt_window(n_fft_y, device=dev)
    kw_yd = dict(kw_e, window=w_yd)
    e_need_y = fft_y + B * Ty * (n_fft_y + 7.0 * Fy)
    w11d = gaussian_dgt_window(n11, device=dev)
    kw_e11 = dict(kw_e, window=w11d)
    e_need11 = fft11 + B * T11 * (n11 + 7.0 * F11)
    fullk11 = 4.0 * B * T11 * n11 * F11

    def lib_dgt_spec_11(x):
        return torch.stft(x, n11, hop11, window=w11d, center=True, pad_mode="reflect",
                          return_complex=True).abs().transpose(-2, -1)

    def lib_dgt_stats_11():
        v = torch.log1p(lib_dgt_spec_11(mono))
        return v.sum(), (v * v).sum(), v.min(), v.max()

    def lib_dgt_spec_y(x):
        return torch.stft(x, n_fft_y, hop_y, window=w_yd, center=True, pad_mode="reflect",
                          return_complex=True).abs().transpose(-2, -1)

    def lib_dgt_stats_y():
        v = torch.log1p(lib_dgt_spec_y(mono))
        return v.sum(), (v * v).sum(), v.min(), v.max()

    spectral_src = "acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)"
    specs += [
        dict(key="E", name="fused_melspec_fullk", source=spectral_src, front_end="fft",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:715",
             launches=counts["fused_melspec_fullk:fft"],
             run=lambda: spectral.fused_melspec(mono, N_FFT, HOP, **kw_e),
             plain=lambda: spectral.fused_melspec_reference(mono, N_FFT, HOP, **kw_e),
             library=lambda: (torch.log1p(lib_dgt_spec(mono)) - kw_e["offset"]) / kw_e["scale"],
             bound=bound_of(4.0 * B * L + 4.0 * n_el, e_need),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 7.0 * n_el)),
        dict(key="F", name="fused_melspec_stats_fullk", source=spectral_src, front_end="fft",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:888",
             launches=counts["fused_melspec_stats_fullk:fft"],
             run=lambda: spectral.fused_melspec_stats(mono, N_FFT, HOP, "log1p", taps=None, window=dgt_f.window),
             plain=lambda: spectral.fused_melspec_stats_reference(
                 mono, N_FFT, HOP, "log1p", taps=None, window=dgt_f.window),
             library=lib_dgt_stats,
             bound=bound_of(4.0 * B * L, e_need + 2.0 * n_el),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 9.0 * n_el)),
        dict(key="E_smooth", name="fused_melspec_fullk_smooth", front_end="smooth", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:715",
             launches=counts["fused_melspec_fullk:smooth"],
             run=lambda: spectral.fused_melspec(mono, n_fft_p, hop_p, **kw_p),
             plain=lambda: spectral.fused_melspec_reference(mono, n_fft_p, hop_p, **kw_p),
             library=lambda: (torch.log1p(lib_dgt_spec_p(mono)) - kw_e["offset"]) / kw_e["scale"],
             bound=bound_of(4.0 * B * L + 4.0 * el_p, e_need_p),
             ceiling=ceiling_of(smooth_design_flops(n_fft_p, B * Tp) + 7.0 * el_p), resources=smooth_fwd),
        dict(key="F_smooth", name="fused_melspec_stats_fullk_smooth", front_end="smooth", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:888",
             launches=counts["fused_melspec_stats_fullk:smooth"],
             run=lambda: spectral.fused_melspec_stats(mono, n_fft_p, hop_p, "log1p", taps=None, window=w_p),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, n_fft_p, hop_p, "log1p", taps=None,
                                                                  window=w_p),
             library=lib_dgt_stats_p,
             bound=bound_of(4.0 * B * L, e_need_p + 2.0 * el_p),
             ceiling=ceiling_of(smooth_design_flops(n_fft_p, B * Tp) + 9.0 * el_p), resources=smooth_stats),
        dict(key="E_smooth7", name="fused_melspec_fullk_smooth7", front_end="smooth", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:715",
             launches=counts["fused_melspec_fullk:smooth7"],
             run=lambda: spectral.fused_melspec(mono, n_fft_y, hop_y, **kw_yd),
             plain=lambda: spectral.fused_melspec_reference(mono, n_fft_y, hop_y, **kw_yd),
             library=lambda: (torch.log1p(lib_dgt_spec_y(mono)) - kw_e["offset"]) / kw_e["scale"],
             bound=bound_of(4.0 * B * L + 4.0 * el_y, e_need_y),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, B * Ty) + 7.0 * el_y), resources=seven_fwd),
        dict(key="F_smooth7", name="fused_melspec_stats_fullk_smooth7", front_end="smooth", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:888",
             launches=counts["fused_melspec_stats_fullk:smooth7"],
             run=lambda: spectral.fused_melspec_stats(mono, n_fft_y, hop_y, "log1p", taps=None, window=w_yd),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, n_fft_y, hop_y, "log1p", taps=None,
                                                                  window=w_yd),
             library=lib_dgt_stats_y,
             bound=bound_of(4.0 * B * L, e_need_y + 2.0 * el_y),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, B * Ty) + 9.0 * el_y), resources=seven_stats),
        dict(key="E_product", name="fused_melspec_fullk_product", front_end="product",
             source="acids_transforms_tpu_torch/csrc/spectral.cu",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:715",
             launches=counts["fused_melspec_fullk:product"],
             run=lambda: spectral.fused_melspec(mono, n11, hop11, **kw_e11),
             plain=lambda: spectral.fused_melspec_reference(mono, n11, hop11, **kw_e11),
             library=lambda: (torch.log1p(lib_dgt_spec_11(mono)) - kw_e["offset"]) / kw_e["scale"],
             bound=bound_of(4.0 * B * L + 4.0 * el11, e_need11),
             ceiling=ceiling_of(fullk11 + 7.0 * el11)),
        dict(key="F_product", name="fused_melspec_stats_fullk_product", front_end="product",
             source="acids_transforms_tpu_torch/csrc/spectral.cu",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:888",
             launches=counts["fused_melspec_stats_fullk:product"],
             run=lambda: spectral.fused_melspec_stats(mono, n11, hop11, "log1p", taps=None, window=w11d),
             plain=lambda: spectral.fused_melspec_stats_reference(mono, n11, hop11, "log1p", taps=None,
                                                                  window=w11d),
             library=lib_dgt_stats_11,
             bound=bound_of(4.0 * B * L, e_need11 + 2.0 * el11),
             ceiling=ceiling_of(fullk11 + 9.0 * el11)),
        # the recurrence has no single PyTorch call to stand beside it
        dict(key="K_phases", name="pghi_phases", source=pghi_src, replaces=pghi_tpu,
             launches=counts["pghi_phases"],
             run=lambda: pghi_kernel.pghi_phases_fused(dgt_target, gamma, N_FFT, HOP,
                                                       tolerance=dgt_f.tolerance, angles=k_angles),
             plain=lambda: pghi_kernel.pghi_phases_fused_reference(
                 dgt_target, gamma, N_FFT, HOP, tolerance=dgt_f.tolerance, angles=k_angles),
             plain_once=True, library=None, bound=phases_bound, ceiling=ceiling_of(150.0 * n_el)),
        dict(key="K_plan", name="pghi_plan", source=pghi_src, replaces=pghi_tpu, launches=counts["pghi_plan"],
             run=lambda: pghi_kernel.pghi_plan(dgt_target, gamma, N_FFT, HOP, dgt_f.tolerance, False,
                                               angles=k_angles),
             plain=lambda: pghi_kernel.pghi_plan_reference(dgt_target, gamma, N_FFT, HOP, dgt_f.tolerance, False,
                                                           angles=k_angles),
             plain_once=True, library=None, bound=plan_bound, ceiling=ceiling_of(150.0 * n_el)),
        dict(key="K_walk", name="pghi_walk", source=pghi_src, replaces=pghi_tpu, launches=counts["pghi_phases"],
             run=lambda: pghi_kernel.pghi_walk(k_src, k_off, F),
             plain=lambda: pghi_kernel.pghi_walk_reference(k_src, k_off, F),
             plain_once=True, library=None, bound=walk_bound, ceiling=ceiling_of(n_el)),
        dict(key="K_bidir", name="pghi_phases_bidir", source=pghi_src, replaces=pghi_tpu,
             launches=counts["pghi_bidir"],
             run=lambda: pghi_kernel.pghi_phases_bidir(dgt_target, gamma, N_FFT, HOP,
                                                       tolerance=dgt_f.tolerance, angles=k_angles),
             plain=lambda: pghi_kernel.pghi_phases_bidir_reference(
                 dgt_target, gamma, N_FFT, HOP, tolerance=dgt_f.tolerance, angles=k_angles),
             plain_once=True, library=None, bound=phases_bound, ceiling=ceiling_of(150.0 * n_el)),
        dict(key="K_synth", name="pghi_synthesize", source=pghi_src + " (+ csrc/fft_smem.cuh)", replaces=pghi_tpu,
             front_end="fft", launches=counts["pghi_synthesize:fft"],
             run=lambda: pghi_kernel.pghi_synthesize_fused(dgt_target, k_phases, N_FFT, HOP, dgt_f.inv_window),
             plain=lambda: pghi_kernel.pghi_synthesize_fused_reference(
                 dgt_target, k_phases, N_FFT, HOP, dgt_f.inv_window),
             library=lib_istft, bound=synth_bound, ceiling=ceiling_of(synth_flops)),
        dict(key="K_synth_smooth", name="pghi_synthesize_smooth", front_end="smooth",
             source=pghi_src + " (+ csrc/fft_smem.cuh)", replaces=pghi_tpu,
             launches=counts["pghi_synthesize:smooth"],
             run=lambda: pghi_kernel.pghi_synthesize_fused(kp_target, kp_phases, n_fft_p, hop_p, w_p_inv),
             plain=lambda: pghi_kernel.pghi_synthesize_fused_reference(
                 kp_target, kp_phases, n_fft_p, hop_p, w_p_inv),
             library=lib_istft_p, bound=synth_bound_p, ceiling=ceiling_of(synth_flops_p),
             resources=kp_res.get("K")),
        dict(key="K_synth_smooth7", name="pghi_synthesize_smooth7", front_end="smooth",
             source=pghi_src + " (+ csrc/fft_smem.cuh)", replaces=pghi_tpu,
             launches=counts["pghi_synthesize:smooth7"],
             run=lambda: pghi_kernel.pghi_synthesize_fused(ky_target, ky_phases, ky_n, ky_hop, w_ky_inv),
             plain=lambda: pghi_kernel.pghi_synthesize_fused_reference(
                 ky_target, ky_phases, ky_n, ky_hop, w_ky_inv),
             library=lib_istft_y, bound=synth_bound_y, ceiling=ceiling_of(synth_flops_y),
             resources=jk_res.get("K")),
        dict(key="K_synth_product", name="pghi_synthesize_product", front_end="product",
             source=pghi_src + " (+ csrc/synth_ola.cuh)", replaces=pghi_tpu,
             launches=counts["pghi_synthesize:product"],
             run=lambda: pghi_kernel.pghi_synthesize_fused(kx_target, kx_phases, kx_n, kx_hop, w_kx_inv),
             plain=lambda: pghi_kernel.pghi_synthesize_fused_reference(
                 kx_target, kx_phases, kx_n, kx_hop, w_kx_inv),
             library=lib_istft_x, bound=synth_bound_x, ceiling=ceiling_of(synth_flops_x)),
    ]
    require(pghi_kernel.synth_route(n_fft_p, hop_p) == pghi_kernel.synth_route(ky_n, ky_hop) == "smooth"
            and pghi_kernel.synth_route(kx_n, kx_hop) == "product",
            "phase 5: K's synthesis must be smooth at 768/256 and 896/224 (its radix-7 instance) and product at "
            "1408/352")
    # K's smooth synthesis at 1200/300 too (a line, not a row): the same
    # clips, kernel against the library call, back to back
    kq_w = gaussian_dgt_window(1200, device=dev)
    kq_target = att.ops.stft(mono, 1200, 300, kq_w).abs()
    kq_phases = 2 * math.pi * torch.rand(kq_target.shape, device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(args.seed + 24))
    kq_inv = T.DGT(n_fft=1200, hop_length=300).inv_window
    kq_ms = device_ms(lambda: pghi_kernel.pghi_synthesize_fused(kq_target, kq_phases, 1200, 300, kq_inv),
                      args.repeats)
    kq_lib = device_ms(lambda: torch.istft(torch.polar(kq_target, kq_phases).transpose(-2, -1), 1200, 300,
                                           window=kq_inv), args.repeats)
    kq_el = float(kq_target.numel())
    kq_b, kq_by = bound_of(8.0 * kq_el + 4.0 * B * (kq_target.shape[1] + 3) * 300,
                           2.5 * 1200 * math.log2(1200) * B * kq_target.shape[1]
                           + B * kq_target.shape[1] * (40.0 * 601 + 2.0 * 1200))
    log(f"  K_synth_smooth at 1200/300 ({tuple(kq_target.shape)}, plan {pghi_kernel._synth_fft_plan(1200, 300)}): "
        f"{kq_ms:.3f} ms, library {kq_lib:.3f} ms ({kq_ms / kq_lib:.2f}x), bound {kq_b:.3f} ms by {kq_by}")
    del kq_target, kq_phases
    # ---- the representation kernels.  G computes the Polar / PolarIF
    # forward: what A and E need plus, per bin, an atan2 (about 20
    # operations with its range reduction), the IF's wrap and scaling (about
    # 8) and a second affine (2); it writes two channels.  H: the front end,
    # |X| and log1p, the atan2 (and the IF's steps) and four statistics of
    # each channel (8 operations per bin); it writes nothing of size.
    p_rep, r_rep = p_fit[2], r_fit[2]
    aff_p = (p_rep.magnitude.norm.offset, p_rep.magnitude.norm.scale, p_rep.phase.norm.offset,
             p_rep.phase.norm.scale)
    aff_r = (r_rep.magnitude.norm.offset, r_rep.magnitude.norm.scale, r_rep.phase.norm.offset,
             r_rep.phase.norm.scale)
    kw_g = dict(mel_bank=p_rep.magnitude.mel_bank, aff=aff_p, contrast="log1p", taps=taps_main)
    kw_gk = dict(mel_bank=r_rep.magnitude.mel_bank, aff=aff_r, contrast="log1p", taps=None,
                 window=dgt_f.window)
    nnz_r = int((r_rep.magnitude.mel_bank != 0).sum().item())
    g_need = fft_flops + B * Tn * (N_FFT + 7.0 * F + 2.0 * nnz_r + 22.0 * F)
    gif_need = g_need + 8.0 * n_el
    h_need = fft_flops + B * Tn * (N_FFT + 5.0 * F + 20.0 * F + 16.0 * F)
    hif_need = h_need + 8.0 * n_el

    def lib_polar():
        S = torch.stft(mono, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                       return_complex=True).transpose(-2, -1)
        y1 = (torch.log1p(torch.matmul(S.abs(), kw_g["mel_bank"])) - aff_p[0]) / aff_p[1]
        return y1, (torch.angle(S) - aff_p[2]) / aff_p[3]

    def lib_if(S):
        ph = torch.angle(S)
        d = torch.remainder(ph[:, 1:] - ph[:, :-1] + math.pi, 2 * math.pi) - math.pi
        v = torch.cat([ph[:, :1], 0.5 * d], dim=1)
        return torch.cat([v[:, :-1] / math.pi, v[:, -1:]], dim=1)

    def lib_polarif():
        S = torch.stft(mono, N_FFT, HOP, window=dgt_f.window, center=True, pad_mode="reflect",
                       return_complex=True).transpose(-2, -1)
        y1 = (torch.log1p(torch.matmul(S.abs(), kw_gk["mel_bank"])) - aff_r[0]) / aff_r[1]
        return y1, (lib_if(S) - aff_r[2]) / aff_r[3]

    def lib_repr_stats(S, second):
        v1 = torch.log1p(S.abs())
        v2 = torch.angle(S) if second == "phase" else lib_if(S)
        return [(v.sum(), (v * v).sum(), v.min(), v.max()) for v in (v1, v2)]

    def lib_stats_polar():
        return lib_repr_stats(torch.stft(mono, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                                         return_complex=True).transpose(-2, -1), "phase")

    def lib_stats_polarif():
        return lib_repr_stats(torch.stft(mono, N_FFT, HOP, window=dgt_f.window, center=True,
                                         pad_mode="reflect", return_complex=True).transpose(-2, -1), "if")

    # G and H full-K on the FFT route: per block of tile_t frames, frames_rfft
    # of the tile and the IF's two halo frames (fft_design_flops), then the
    # epilogue per bin; H writes (n_blocks, 8, F) partials, a block a tile,
    # that a second kernel reads back (not the function's bytes: their
    # traffic at the peak rate is modelled and printed in the log line, kept
    # out of the row).  G and H with taps take the same route (Polar: no
    # halo).  Their smooth rows on the same clips (phase 4h's launches): full-K
    # at 768/256 (PolarIF, the DGT's gaussian), with hann taps at 768/192
    # (Polar), the same with smooth_design_flops at their plans' tiles; their
    # radix-7 rows at 896/224 (2^7 7) likewise; their product and factored
    # rows at 1408/352 (2^7 11).
    g_tile, _ = spectral._repr_plan(N_FFT, HOP, None, False, "if", True)
    g_frames = B * -(-Tn // g_tile) * (g_tile + 2)

    def h_blocks_of(second):
        """(tile_t, blocks) of H's FFT route at the main shape."""
        tile, _ = spectral._repr_plan(N_FFT, HOP, None, True, second, False)
        return tile, B * -(-Tn // tile)

    def partials_ms(blocks):
        """The partials' traffic (written, then read back) at the peak rate: a model."""
        return 1e3 * 2.0 * 4 * blocks * 8 * F / PEAK_BYTES_PER_S

    h_tile, h_blocks = h_blocks_of("if")
    _, hp_blocks = h_blocks_of("phase")

    def lib_stats_polar_g():
        return lib_repr_stats(torch.stft(mono, n_fft_g, hop_g, window=w_g, center=True, pad_mode="reflect",
                                         return_complex=True).transpose(-2, -1), "phase")

    # G's smooth route at 768/192 (phase 4h's STFT(768, 192) + Polar
    # forward), with the square bipolar bank of that size and Polar's affine
    bank_gg = T.Magnitude(mode="bipolar", contrast="log1p", mel=True, n_fft=n_fft_g).mel_bank
    nnz_gg = int((bank_gg != 0).sum().item())
    kw_gg = dict(kw_g, mel_bank=bank_gg, taps=taps_g)
    g_need_g = fft_g + B * Tg * (n_fft_g + 7.0 * Fg + 2.0 * nnz_gg + 22.0 * Fg)
    repr_res = repr_smooth_resources(_build.kernel_resources())

    def blocks_of(n_fft, hop, T_, taps, stats, second, mel):
        """(tile_t, blocks) of G's or H's plan at this shape."""
        tile = spectral._repr_plan(n_fft, hop, taps, stats, second, mel)[0]
        return tile, B * -(-T_ // tile)

    _, hs_blocks = blocks_of(n_fft_g, hop_g, Tg, taps_g, True, "phase", False)
    gks_tile, gks_blocks = blocks_of(n_fft_p, hop_p, Tp, None, False, "if", True)
    hks_tile, hks_blocks = blocks_of(n_fft_p, hop_p, Tp, None, True, "if", False)
    # G's and H's radix-7 rows at 896/224 (phase 4h's STFT(896, 224) + Polar
    # and DGT(896, 224) + PolarIF), with hann taps and full-K
    gys_tile, gys_blocks = blocks_of(n_fft_y, hop_y, Ty, None, False, "if", True)
    hys_tile, hys_blocks = blocks_of(n_fft_y, hop_y, Ty, None, True, "if", False)
    _, hyp_blocks = blocks_of(n_fft_y, hop_y, Ty, taps_y, True, "phase", False)
    bank_gy = T.Magnitude(mode="bipolar", contrast="log1p", mel=True, n_fft=n_fft_y).mel_bank
    nnz_gy = int((bank_gy != 0).sum().item())
    kw_gy = dict(kw_g, mel_bank=bank_gy, taps=taps_y)
    kw_gky = dict(kw_gk, mel_bank=bank_gy, window=w_yd)
    g_need_y = fft_y + B * Ty * (n_fft_y + 7.0 * Fy + 2.0 * nnz_gy + 22.0 * Fy)
    gif_need_y = g_need_y + 8.0 * el_y
    hif_need_y = fft_y + B * Ty * (n_fft_y + 5.0 * Fy + 20.0 * Fy + 16.0 * Fy) + 8.0 * el_y

    def stft_y(w):
        return torch.stft(mono, n_fft_y, hop_y, window=w, center=True, pad_mode="reflect",
                          return_complex=True).transpose(-2, -1)

    def lib_polar_y():
        S = stft_y(w_y)
        y1 = (torch.log1p(torch.matmul(S.abs(), bank_gy)) - aff_p[0]) / aff_p[1]
        return y1, (torch.angle(S) - aff_p[2]) / aff_p[3]

    def lib_polarif_y():
        S = stft_y(w_yd)
        y1 = (torch.log1p(torch.matmul(S.abs(), bank_gy)) - aff_r[0]) / aff_r[1]
        return y1, (lib_if(S) - aff_r[2]) / aff_r[3]

    def lib_polar_g():
        S = torch.stft(mono, n_fft_g, hop_g, window=w_g, center=True, pad_mode="reflect",
                       return_complex=True).transpose(-2, -1)
        y1 = (torch.log1p(torch.matmul(S.abs(), bank_gg)) - aff_p[0]) / aff_p[1]
        return y1, (torch.angle(S) - aff_p[2]) / aff_p[3]

    # G's and H's factored rows and their full-K product rows at 1408/352
    # (phase 4h's STFT(1408, 352) + Polar and DGT(1408, 352) + PolarIF)
    bank_g11 = T.Magnitude(mode="bipolar", contrast="log1p", mel=True, n_fft=n11).mel_bank
    nnz_g11 = int((bank_g11 != 0).sum().item())
    kw_g11 = dict(kw_g, mel_bank=bank_g11, taps=taps11)
    kw_gk11 = dict(kw_gk, mel_bank=bank_g11, window=w11d)
    g_need11 = fft11 + B * T11 * (n11 + 7.0 * F11 + 2.0 * nnz_g11 + 22.0 * F11)
    gif_need11 = g_need11 + 8.0 * el11
    hif_need11 = fft11 + B * T11 * (n11 + 5.0 * F11 + 20.0 * F11 + 16.0 * F11) + 8.0 * el11

    def stft11(w):
        return torch.stft(mono, n11, hop11, window=w, center=True, pad_mode="reflect",
                          return_complex=True).transpose(-2, -1)

    def lib_polar_11():
        S = stft11(w11)
        y1 = (torch.log1p(torch.matmul(S.abs(), bank_g11)) - aff_p[0]) / aff_p[1]
        return y1, (torch.angle(S) - aff_p[2]) / aff_p[3]

    def lib_polarif_11():
        S = stft11(w11d)
        y1 = (torch.log1p(torch.matmul(S.abs(), bank_g11)) - aff_r[0]) / aff_r[1]
        return y1, (lib_if(S) - aff_r[2]) / aff_r[3]
    bank_rp = T.Magnitude(mode="bipolar", n_fft=n_fft_p).mel_bank
    nnz_rp = int((bank_rp != 0).sum().item())
    kw_gkp = dict(kw_gk, mel_bank=bank_rp, window=w_p)
    gif_need_p = fft_p + B * Tp * (n_fft_p + 7.0 * Fp + 2.0 * nnz_rp + 22.0 * Fp) + 8.0 * el_p
    hif_need_p = fft_p + B * Tp * (n_fft_p + 5.0 * Fp + 20.0 * Fp + 16.0 * Fp) + 8.0 * el_p

    def stft_p():
        return torch.stft(mono, n_fft_p, hop_p, window=w_p, center=True, pad_mode="reflect",
                          return_complex=True).transpose(-2, -1)

    def lib_polarif_p():
        S = stft_p()
        y1 = (torch.log1p(torch.matmul(S.abs(), bank_rp)) - aff_r[0]) / aff_r[1]
        return y1, (lib_if(S) - aff_r[2]) / aff_r[3]

    # I: the projection at the log-mel chain's shape (no main-path caller).
    # Bytes: magnitudes and angles read, the projection written (5 arrays);
    # operations: both FFTs, both windowings, the envelope, mag * angles.
    i_state = (gl_state[0], gl_state[1])
    i_bytes = 5.0 * 4 * B * Tn * F + 4.0 * (Tn + ov - 1) * HOP
    i_need = 2 * fft_flops + B * Tn * (3.0 * N_FFT + 2.0 * F)

    def lib_project():
        sig = torch.istft((gl_mag * torch.complex(*i_state)).transpose(-2, -1), N_FFT, HOP, window=window)
        return torch.stft(sig, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                          return_complex=True)

    def lib_project_g():
        sig = torch.istft((mag_g * torch.complex(g_st[0], g_st[1])).transpose(-2, -1), n_fft_g, hop_g, window=w_g)
        return torch.stft(sig, n_fft_g, hop_g, window=w_g, center=True, pad_mode="reflect", return_complex=True)

    # J at the D' shape: the DGT target magnitudes and a random state;
    # bytes and operations as C's (nine arrays; two FFTs and the momentum).
    # Its FFT route runs, per block of tile_t frames, frames_irfft of tile_t
    # + 2 overlap frames (the halo recomputed) and frames_rfft of the tile's
    # frames (fft_design_flops each), mag * angles and the momentum update
    # (12 per bin) and the envelope division; its smooth route (768/256 here,
    # on the same clips) the same with smooth_design_flops, its radix-7
    # instance (896/224, 2^7 7) likewise.  The product route (1408/352, 2^7
    # 11) runs, per block of R chunks and tile_t frames, the synthesis product
    # (R chunks x overlap x Kp x hop) and the analysis product (tile_t frames
    # x n_fft x 2 x 128-column tiles).
    def j_state(shape, seed):
        jg = torch.Generator(device=dev).manual_seed(seed)
        jph = 2 * math.pi * torch.rand(shape, generator=jg, device=dev)
        return (torch.cos(jph), torch.sin(jph), torch.zeros_like(jph), torch.zeros_like(jph))

    j_st = j_state(dgt_target.shape, args.seed + 51)
    jstep, _, _ = glstep.make_gl_momentum_step_fullk(dgt_target, N_FFT, HOP, dgt_f.inv_window, mom)
    j_env = glstep._env_rows(Tn, N_FFT, HOP, dgt_f.inv_window)
    _, j_rows, j_tile, _ = glstep._fullk_plan(N_FFT, HOP)
    j_blocks = B * -(-Tn // j_tile)
    j_flops = (fft_design_flops(N_FFT, j_blocks * (j_tile + 2 * ov)) + fft_design_flops(N_FFT, B * Tn)
               + 12.0 * n_el + float(B * (Tn + ov - 1) * HOP))
    w_jp = gaussian_dgt_window(n_fft_p, device=dev)
    jp_target = att.ops.stft(mono, n_fft_p, hop_p, w_jp).abs()
    jp_st = j_state(jp_target.shape, args.seed + 53)
    jp_step, _, _ = glstep.make_gl_momentum_step_fullk(jp_target, n_fft_p, hop_p, w_jp, mom)
    jp_env = glstep._env_rows(Tp, n_fft_p, hop_p, w_jp)
    jp_route, _, jp_tile, _ = glstep._fullk_plan(n_fft_p, hop_p)
    jp_blocks = B * -(-Tp // jp_tile)
    ov_p = n_fft_p // hop_p
    jp_flops = (smooth_design_flops(n_fft_p, jp_blocks * (jp_tile + 2 * ov_p)) + smooth_design_flops(n_fft_p, B * Tp)
                + 12.0 * el_p + float(B * (Tp + ov_p - 1) * hop_p))
    jp_bytes = 9.0 * 4 * el_p + 4.0 * (Tp + ov_p - 1) * hop_p
    jp_need = 2 * fft_p + B * Tp * (3.0 * n_fft_p + 12.0 * Fp)
    w_jy = gaussian_dgt_window(n_fft_y, device=dev)
    jy_target = att.ops.stft(mono, n_fft_y, hop_y, w_jy).abs()
    jy_st = j_state(jy_target.shape, args.seed + 54)
    jy_step, _, _ = glstep.make_gl_momentum_step_fullk(jy_target, n_fft_y, hop_y, w_jy, mom)
    jy_env = glstep._env_rows(Ty, n_fft_y, hop_y, w_jy)
    jy_route, jy_rows, jy_tile, _ = glstep._fullk_plan(n_fft_y, hop_y)
    jy_blocks = B * -(-Ty // jy_tile)
    jy_flops = (smooth_design_flops(n_fft_y, jy_blocks * (jy_tile + 2 * ov_y)) + smooth_design_flops(n_fft_y, B * Ty)
                + 12.0 * el_y + float(B * (Ty + ov_y - 1) * hop_y))
    jy_bytes = 9.0 * 4 * el_y + 4.0 * (Ty + ov_y - 1) * hop_y
    jy_need = 2 * fft_y + B * Ty * (3.0 * n_fft_y + 12.0 * Fy)
    w_jx = gaussian_dgt_window(n11, device=dev)
    jx_target = att.ops.stft(mono, n11, hop11, w_jx).abs()
    jx_st = j_state(jx_target.shape, args.seed + 55)
    jx_step, _, _ = glstep.make_gl_momentum_step_fullk(jx_target, n11, hop11, w_jx, mom)
    jx_env = glstep._env_rows(T11, n11, hop11, w_jx)
    jx_route, jx_rows, jx_tile, _ = glstep._fullk_plan(n11, hop11)
    require(jp_route == jy_route == "smooth" and jx_route == "product",
            "phase 5: J must be smooth at 768/256 and 896/224 (its radix-7 instance), product at 1408/352")
    jx_flops = 2.0 * B * -(-T11 // jx_tile) * (jx_rows * ov11 * pghi_kernel._k_padded(F11) * hop11
                                               + jx_tile * n11 * 2 * 128 * -(-F11 // 128)) + 10.0 * el11
    jx_bytes = 9.0 * 4 * el11 + 4.0 * (T11 + ov11 - 1) * hop11
    jx_need = 2 * fft11 + B * T11 * (3.0 * n11 + 12.0 * F11)

    def lib_gl_fullk(target, st, n_fft, hop, w):
        a = torch.complex(st[0], st[1])
        sig = torch.istft((target * a).transpose(-2, -1), n_fft, hop, window=w)
        reb = torch.stft(sig, n_fft, hop, window=w, center=True, pad_mode="reflect",
                         return_complex=True).transpose(-2, -1)
        u = reb - mom * torch.complex(st[2], st[3])
        return u / u.abs().clamp_min(1e-16), reb

    spectral_src = "acids_transforms_tpu_torch/csrc/spectral.cu"
    specs += [
        dict(key="G", name="fused_spectral_repr", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:869", front_end="fft",
             launches=counts["fused_spectral_repr:fft"],
             run=lambda: spectral.fused_spectral_repr(mono, N_FFT, HOP, "phase", **kw_g),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, N_FFT, HOP, "phase", **kw_g),
             library=lib_polar, bound=bound_of(4.0 * B * L + 8.0 * n_el, g_need),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 2.0 * B * Tn * nnz_r + 30.0 * n_el)),
        dict(key="G_smooth", name="fused_spectral_repr_smooth", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:869", front_end="smooth",
             launches=counts["fused_spectral_repr:smooth"],
             run=lambda: spectral.fused_spectral_repr(mono, n_fft_g, hop_g, "phase", **kw_gg),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, n_fft_g, hop_g, "phase", **kw_gg),
             library=lib_polar_g, bound=bound_of(4.0 * B * L + 8.0 * el_g, g_need_g),
             ceiling=ceiling_of(smooth_design_flops(n_fft_g, B * Tg) + 2.0 * B * Tg * nnz_gg + 30.0 * el_g),
             resources=repr_res["G"]),
        dict(key="G_smooth7", name="fused_spectral_repr_smooth7", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:869", front_end="smooth",
             launches=counts["fused_spectral_repr:smooth7"],
             run=lambda: spectral.fused_spectral_repr(mono, n_fft_y, hop_y, "phase", **kw_gy),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, n_fft_y, hop_y, "phase", **kw_gy),
             library=lib_polar_y, bound=bound_of(4.0 * B * L + 8.0 * el_y, g_need_y),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, B * Ty) + 2.0 * B * Ty * nnz_gy + 30.0 * el_y),
             resources=repr_res["G seven"]),
        dict(key="G_factored", name="fused_spectral_repr_factored", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:869", front_end="factored",
             launches=counts["fused_spectral_repr:factored"],
             run=lambda: spectral.fused_spectral_repr(mono, n11, hop11, "phase", **kw_g11),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, n11, hop11, "phase", **kw_g11),
             library=lib_polar_11, bound=bound_of(4.0 * B * L + 8.0 * el11, g_need11),
             ceiling=ceiling_of(factored11 + 2.0 * B * T11 * nnz_g11 + 30.0 * el11)),
        dict(key="G_fk", name="fused_spectral_repr_fullk", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:851", front_end="fft",
             launches=counts["fused_spectral_repr_fullk:fft"],
             run=lambda: spectral.fused_spectral_repr(mono, N_FFT, HOP, "if", **kw_gk),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, N_FFT, HOP, "if", **kw_gk),
             library=lib_polarif, bound=bound_of(4.0 * B * L + 8.0 * n_el, gif_need),
             ceiling=ceiling_of(fft_design_flops(N_FFT, g_frames) + 2.0 * B * Tn * nnz_r + 38.0 * n_el)),
        dict(key="G_fk_smooth", name="fused_spectral_repr_fullk_smooth",
             source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:851", front_end="smooth",
             launches=counts["fused_spectral_repr_fullk:smooth"],
             run=lambda: spectral.fused_spectral_repr(mono, n_fft_p, hop_p, "if", **kw_gkp),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, n_fft_p, hop_p, "if", **kw_gkp),
             library=lib_polarif_p, bound=bound_of(4.0 * B * L + 8.0 * el_p, gif_need_p),
             ceiling=ceiling_of(smooth_design_flops(n_fft_p, gks_blocks * (gks_tile + 2)) + 2.0 * B * Tp * nnz_rp
                                + 38.0 * el_p), resources=repr_res["G"]),
        dict(key="G_fk_smooth7", name="fused_spectral_repr_fullk_smooth7",
             source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:851", front_end="smooth",
             launches=counts["fused_spectral_repr_fullk:smooth7"],
             run=lambda: spectral.fused_spectral_repr(mono, n_fft_y, hop_y, "if", **kw_gky),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, n_fft_y, hop_y, "if", **kw_gky),
             library=lib_polarif_y, bound=bound_of(4.0 * B * L + 8.0 * el_y, gif_need_y),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, gys_blocks * (gys_tile + 2)) + 2.0 * B * Ty * nnz_gy
                                + 38.0 * el_y), resources=repr_res["G seven"]),
        dict(key="G_fk_product", name="fused_spectral_repr_fullk_product", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:851", front_end="product",
             launches=counts["fused_spectral_repr_fullk:product"],
             run=lambda: spectral.fused_spectral_repr(mono, n11, hop11, "if", **kw_gk11),
             plain=lambda: spectral.fused_spectral_repr_reference(mono, n11, hop11, "if", **kw_gk11),
             library=lib_polarif_11, bound=bound_of(4.0 * B * L + 8.0 * el11, gif_need11),
             ceiling=ceiling_of(fullk11 * (T11 + 1) / T11 + 2.0 * B * T11 * nnz_g11 + 38.0 * el11)),
        dict(key="H", name="fused_repr_stats", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:938", front_end="fft",
             launches=counts["fused_repr_stats:fft"],
             run=lambda: spectral.fused_repr_stats(mono, N_FFT, HOP, "phase", taps=taps_main),
             plain=lambda: spectral.fused_repr_stats_reference(mono, N_FFT, HOP, "phase", taps=taps_main),
             library=lib_stats_polar, bound=bound_of(4.0 * B * L, h_need),
             ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 36.0 * n_el),
             extra=dict(modelled_partials_bytes_ms=partials_ms(hp_blocks), blocks=hp_blocks)),
        dict(key="H_smooth", name="fused_repr_stats_smooth", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:938", front_end="smooth",
             launches=counts["fused_repr_stats:smooth"],
             run=lambda: spectral.fused_repr_stats(mono, n_fft_g, hop_g, "phase", taps=taps_g),
             plain=lambda: spectral.fused_repr_stats_reference(mono, n_fft_g, hop_g, "phase", taps=taps_g),
             library=lib_stats_polar_g, bound=bound_of(4.0 * B * L, fft_g + B * Tg * (n_fft_g + 41.0 * Fg)),
             ceiling=ceiling_of(smooth_design_flops(n_fft_g, B * Tg) + 36.0 * el_g), resources=repr_res["H"],
             extra=dict(modelled_partials_bytes_ms=2.0 * 4 * hs_blocks * 8 * Fg / PEAK_BYTES_PER_S * 1e3,
                        blocks=hs_blocks)),
        dict(key="H_smooth7", name="fused_repr_stats_smooth7", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:938", front_end="smooth",
             launches=counts["fused_repr_stats:smooth7"],
             run=lambda: spectral.fused_repr_stats(mono, n_fft_y, hop_y, "phase", taps=taps_y),
             plain=lambda: spectral.fused_repr_stats_reference(mono, n_fft_y, hop_y, "phase", taps=taps_y),
             library=lambda: lib_repr_stats(stft_y(w_y), "phase"),
             bound=bound_of(4.0 * B * L, fft_y + B * Ty * (n_fft_y + 41.0 * Fy)),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, B * Ty) + 36.0 * el_y), resources=repr_res["H seven"],
             extra=dict(modelled_partials_bytes_ms=2.0 * 4 * hyp_blocks * 8 * Fy / PEAK_BYTES_PER_S * 1e3,
                        blocks=hyp_blocks)),
        dict(key="H_factored", name="fused_repr_stats_factored", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:938", front_end="factored",
             launches=counts["fused_repr_stats:factored"],
             run=lambda: spectral.fused_repr_stats(mono, n11, hop11, "phase", taps=taps11),
             plain=lambda: spectral.fused_repr_stats_reference(mono, n11, hop11, "phase", taps=taps11),
             library=lambda: lib_repr_stats(stft11(w11), "phase"),
             bound=bound_of(4.0 * B * L, fft11 + B * T11 * (n11 + 41.0 * F11)),
             ceiling=ceiling_of(factored11 + 36.0 * el11)),
        dict(key="H_fk", name="fused_repr_stats_fullk", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:916", front_end="fft",
             launches=counts["fused_repr_stats_fullk:fft"],
             run=lambda: spectral.fused_repr_stats(mono, N_FFT, HOP, "if", taps=None, window=dgt_f.window),
             plain=lambda: spectral.fused_repr_stats_reference(mono, N_FFT, HOP, "if", taps=None,
                                                               window=dgt_f.window),
             library=lib_stats_polarif, bound=bound_of(4.0 * B * L, hif_need),
             ceiling=ceiling_of(fft_design_flops(N_FFT, h_blocks * (h_tile + 2)) + 44.0 * n_el),
             extra=dict(modelled_partials_bytes_ms=partials_ms(h_blocks), blocks=h_blocks)),
        dict(key="H_fk_smooth", name="fused_repr_stats_fullk_smooth", source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:916", front_end="smooth",
             launches=counts["fused_repr_stats_fullk:smooth"],
             run=lambda: spectral.fused_repr_stats(mono, n_fft_p, hop_p, "if", taps=None, window=w_p),
             plain=lambda: spectral.fused_repr_stats_reference(mono, n_fft_p, hop_p, "if", taps=None, window=w_p),
             library=lambda: lib_repr_stats(stft_p(), "if"), bound=bound_of(4.0 * B * L, hif_need_p),
             ceiling=ceiling_of(smooth_design_flops(n_fft_p, hks_blocks * (hks_tile + 2)) + 44.0 * el_p),
             resources=repr_res["H"],
             extra=dict(modelled_partials_bytes_ms=2.0 * 4 * hks_blocks * 8 * Fp / PEAK_BYTES_PER_S * 1e3,
                        blocks=hks_blocks)),
        dict(key="H_fk_smooth7", name="fused_repr_stats_fullk_smooth7",
             source=spectral_src + " (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:916", front_end="smooth",
             launches=counts["fused_repr_stats_fullk:smooth7"],
             run=lambda: spectral.fused_repr_stats(mono, n_fft_y, hop_y, "if", taps=None, window=w_yd),
             plain=lambda: spectral.fused_repr_stats_reference(mono, n_fft_y, hop_y, "if", taps=None, window=w_yd),
             library=lambda: lib_repr_stats(stft_y(w_yd), "if"), bound=bound_of(4.0 * B * L, hif_need_y),
             ceiling=ceiling_of(smooth_design_flops(n_fft_y, hys_blocks * (hys_tile + 2)) + 44.0 * el_y),
             resources=repr_res["H seven"],
             extra=dict(modelled_partials_bytes_ms=2.0 * 4 * hys_blocks * 8 * Fy / PEAK_BYTES_PER_S * 1e3,
                        blocks=hys_blocks)),
        dict(key="H_fk_product", name="fused_repr_stats_fullk_product", source=spectral_src,
             replaces="acids_transforms_tpu/ops/pallas/spectral.py:916", front_end="product",
             launches=counts["fused_repr_stats_fullk:product"],
             run=lambda: spectral.fused_repr_stats(mono, n11, hop11, "if", taps=None, window=w11d),
             plain=lambda: spectral.fused_repr_stats_reference(mono, n11, hop11, "if", taps=None, window=w11d),
             library=lambda: lib_repr_stats(stft11(w11d), "if"), bound=bound_of(4.0 * B * L, hif_need11),
             ceiling=ceiling_of(fullk11 * (T11 + 1) / T11 + 44.0 * el11)),
        dict(key="I", name="gl_project", front_end="fft",
             source="acids_transforms_tpu_torch/csrc/glstep.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:236",
             launches=counts["gl_project:fft"],
             run=lambda: glstep.gl_project(gl_mag, *i_state, N_FFT, HOP, taps_main, window),
             plain=lambda: glstep.gl_project_reference(gl_mag, *i_state, N_FFT, HOP, taps_main, window),
             library=lib_project, bound=bound_of(i_bytes, i_need), ceiling=ceiling_of(c_flops - 10.0 * n_el)),
        dict(key="I_smooth", name="gl_project_smooth", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/glstep.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:236",
             launches=counts["gl_project:smooth"],
             run=lambda: glstep.gl_project(mag_g, g_st[0], g_st[1], n_fft_g, hop_g, taps_g, w_g),
             plain=lambda: glstep.gl_project_reference(mag_g, g_st[0], g_st[1], n_fft_g, hop_g, taps_g, w_g),
             library=lib_project_g, bound=bound_of(5.0 * 4 * el_g + 4.0 * (Tg + ov_g - 1) * hop_g,
                                                   2 * fft_g + B * Tg * (3.0 * n_fft_g + 2.0 * Fg)),
             ceiling=ceiling_of(cg_flops - 10.0 * el_g), resources=res_c),
        dict(key="I_product", name="gl_project_product", front_end="product",
             source="acids_transforms_tpu_torch/csrc/glstep.cu", replaces="acids_transforms_tpu/ops/pallas/glstep.py:236",
             launches=counts["gl_project:product"],
             run=lambda: glstep.gl_project(mag_gy, y_st[0], y_st[1], n_fft_y, hop_y, taps_y, w_y),
             plain=lambda: glstep.gl_project_reference(mag_gy, y_st[0], y_st[1], n_fft_y, hop_y, taps_y, w_y),
             library=lib_project_y, bound=bound_of(5.0 * 4 * el_y + 4.0 * (Ty + ov_y - 1) * hop_y,
                                                   2 * fft_y + B * Ty * (3.0 * n_fft_y + 2.0 * Fy)),
             ceiling=ceiling_of(gl_flops_y - 10.0 * el_y)),
        dict(key="J", name="gl_momentum_fullk", front_end="fft",
             source="acids_transforms_tpu_torch/csrc/glstep_fullk.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:571",
             launches=counts["gl_momentum_fullk:fft"],
             run=lambda: jstep(*j_st),
             plain=lambda: glstep.gl_momentum_step_fullk_reference(dgt_target, *j_st, j_env, N_FFT, HOP,
                                                                   dgt_f.inv_window, mom),
             library=lambda: lib_gl_fullk(dgt_target, j_st, N_FFT, HOP, dgt_f.inv_window),
             bound=bound_of(gl_bytes, gl_need), ceiling=ceiling_of(j_flops)),
        dict(key="J_smooth", name="gl_momentum_fullk_smooth", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/glstep_fullk.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:571",
             launches=counts["gl_momentum_fullk:smooth"],
             run=lambda: jp_step(*jp_st),
             plain=lambda: glstep.gl_momentum_step_fullk_reference(jp_target, *jp_st, jp_env, n_fft_p, hop_p,
                                                                   w_jp, mom),
             library=lambda: lib_gl_fullk(jp_target, jp_st, n_fft_p, hop_p, w_jp),
             bound=bound_of(jp_bytes, jp_need), ceiling=ceiling_of(jp_flops), resources=res_j),
        dict(key="J_smooth7", name="gl_momentum_fullk_smooth7", front_end="smooth",
             source="acids_transforms_tpu_torch/csrc/glstep_fullk.cu (+ csrc/fft_smem.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:571",
             launches=counts["gl_momentum_fullk:smooth7"],
             run=lambda: jy_step(*jy_st),
             plain=lambda: glstep.gl_momentum_step_fullk_reference(jy_target, *jy_st, jy_env, n_fft_y, hop_y,
                                                                   w_jy, mom),
             library=lambda: lib_gl_fullk(jy_target, jy_st, n_fft_y, hop_y, w_jy),
             bound=bound_of(jy_bytes, jy_need), ceiling=ceiling_of(jy_flops), resources=jk_res.get("J")),
        dict(key="J_product", name="gl_momentum_fullk_product", front_end="product",
             source="acids_transforms_tpu_torch/csrc/glstep_fullk.cu (+ csrc/synth_ola.cuh, csrc/dft_common.cuh)",
             replaces="acids_transforms_tpu/ops/pallas/glstep.py:571",
             launches=counts["gl_momentum_fullk:product"],
             run=lambda: jx_step(*jx_st),
             plain=lambda: glstep.gl_momentum_step_fullk_reference(jx_target, *jx_st, jx_env, n11, hop11, w_jx,
                                                                   mom),
             library=lambda: lib_gl_fullk(jx_target, jx_st, n11, hop11, w_jx),
             bound=bound_of(jx_bytes, jx_need), ceiling=ceiling_of(jx_flops)),
    ]
    # ---- the streaming sessions at phase 4f's shape (64 mono sessions of
    # 4 s, 688 frames each).  Bounds: R reads the signal and writes the
    # complex spectrum, one FFT and the window per frame; L reads the signal
    # and writes the audio, two FFTs, both windows and the overlap-add; M adds
    # the angles read and, per bin, |X|, a sincos and two products (26
    # operations); P reads magnitudes and angles, writes the audio, one
    # inverse FFT, the window, the overlap-add and 22 operations per bin.
    # The product route of R, L, M, P and S (1408/352 = 2^7 11, 504 frames)
    # runs the full-length products: the analysis of every frame a block holds (n_fft rounded to
    # 32 x 128-bin column tiles, cos and sin) and the synthesis of 8 ceil(R /
    # 8) chunks x overlap x Kp x hop per block; R's FFT route does
    # fft_design_flops, its smooth route (1200/300, 592 frames; the radix-7
    # instances at 1344/336, 528 frames) smooth_design_flops, its product
    # route the analysis product; the FFT and smooth routes of L and M a
    # forward and an inverse FFT of rows + 2 overlap frames a block of rows
    # chunks, those of P and S an inverse FFT of as many (the pack's
    # operations as the split's).  The yardsticks (timed, used
    # nowhere): torch.stft(center=False) on the padded rows; torch.fft.irfft
    # x the synthesis window + fold.
    ss = stream["ss"]
    sx, s_rt, s_mags, s_ang, n_sf = (stream[k] for k in ("sx", "rt", "mags", "angles", "n_frames"))
    SB = sx.shape[0]
    s_ops = ss._encode_operands(s_rt.window, N_FFT)
    s_syn = ss._decode_operands(s_rt.inv_window, float(ov), N_FFT, HOP)
    s_fr = float(SB * n_sf)
    s_fft = 2.5 * N_FFT * math.log2(N_FFT) * s_fr
    s_in, s_out, s_spec = 4.0 * SB * STREAM_LEN, 4.0 * SB * n_sf * HOP, 8.0 * s_fr * F
    r_rt, r_dec = ss._roundtrip_plan(N_FFT, HOP)[0], ss._decode_plan(N_FFT, HOP)[0]
    t_rt, t_dec = -(-n_sf // r_rt), -(-n_sf // r_dec)
    s_rt_ops = ss._Session(stream["chain"], STREAM_CHUNK // HOP).roundtrip_operands()

    rt_design = 2.0 * fft_design_flops(N_FFT, SB * t_rt * (r_rt + 2 * ov)) + 3.0 * N_FFT * s_fr
    rt_need = 2 * s_fft + 3.0 * N_FFT * s_fr
    s_syn_window = s_rt.inv_window / ov

    def lib_encode():
        rows = ss.session_rows(sx, N_FFT, HOP, n_sf)
        return torch.stft(rows, N_FFT, HOP, window=s_rt.window, center=False, return_complex=True)

    n_fft_q, hop_q = 1200, 300          # the smooth route's shape (R, L, M, P, S, O's synthesis)
    F_q, T_q = n_fft_q // 2 + 1, -(-STREAM_LEN // 2400) * 8
    w_q = torch.hann_window(n_fft_q, device=dev)
    q_ops = ss._encode_operands(w_q, n_fft_q)
    q_fr = float(SB * T_q)
    q_fft = 2.5 * n_fft_q * math.log2(n_fft_q) * q_fr

    def lib_encode_q():
        rows = ss.session_rows(sx, n_fft_q, hop_q, T_q)
        return torch.stft(rows, n_fft_q, hop_q, window=w_q, center=False, return_complex=True)

    # L and M on the smooth route at 1200/300: the same functions, a forward
    # and an inverse mixed-radix FFT of rows + 2 overlap frames a block of
    # rows chunks, overlap 4 and gain 4
    ov_q = n_fft_q // hop_q
    q_chain = T.OverlapAdd(n_fft_q, hop_q) + T.RealtimeSTFT(n_fft=n_fft_q, hop_length=hop_q)
    q_rt = q_chain[1]
    q_rt_ops = ss._Session(q_chain, 8).roundtrip_operands()
    q_ang = 2 * math.pi * torch.rand((SB, T_q, F_q), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(args.seed + 54))
    r_q = ss._roundtrip_plan(n_fft_q, hop_q)[0]
    t_q = -(-T_q // r_q)
    q_design = 2.0 * smooth_design_flops(n_fft_q, SB * t_q * (r_q + 2 * ov_q)) + 3.0 * n_fft_q * q_fr
    q_need = 2 * q_fft + 3.0 * n_fft_q * q_fr
    q_out = 4.0 * SB * T_q * hop_q

    # R, L, M, the magnitude encode and the decodes P and S on the smooth
    # route's radix-7 instances at 1344/336 (2^6 3 7): the same functions, a
    # forward and an inverse mixed-radix FFT (radices 7 3 4 4 4) of rows + 2
    # overlap frames a block of rows chunks, overlap 4 and gain 4
    n_fft_x, hop_x = 1344, 336
    F_x, T_x, ov_x = n_fft_x // 2 + 1, -(-STREAM_LEN // 2688) * 8, n_fft_x // hop_x
    w_x = torch.hann_window(n_fft_x, device=dev)
    x_ops = ss._encode_operands(w_x, n_fft_x)
    x_fr = float(SB * T_x)
    x_fft = 2.5 * n_fft_x * math.log2(n_fft_x) * x_fr
    x_chain = T.OverlapAdd(n_fft_x, hop_x) + T.RealtimeSTFT(n_fft=n_fft_x, hop_length=hop_x)
    x_rt = x_chain[1]
    x_rt_ops = ss._Session(x_chain, 8).roundtrip_operands()
    x_ang = 2 * math.pi * torch.rand((SB, T_x, F_x), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(args.seed + 56))
    r_x = ss._roundtrip_plan(n_fft_x, hop_x)[0]
    t_x = -(-T_x // r_x)
    x_design = 2.0 * smooth_design_flops(n_fft_x, SB * t_x * (r_x + 2 * ov_x)) + 3.0 * n_fft_x * x_fr
    x_need = 2 * x_fft + 3.0 * n_fft_x * x_fr
    x_out = 4.0 * SB * T_x * hop_x

    # R, L, M, the magnitude encode and the decodes on the product route at
    # 1408/352 (2^7 11): the window-folded products (rows + overlap - 1
    # frames' analysis, the synthesis product), overlap 4 and gain 4
    n_fft_z, hop_z = 1408, 352
    F_z, T_z, ov_z = n_fft_z // 2 + 1, -(-STREAM_LEN // 2816) * 8, n_fft_z // hop_z
    w_z = torch.hann_window(n_fft_z, device=dev)
    z_ops = ss._encode_operands(w_z, n_fft_z)
    z_fr = float(SB * T_z)
    z_fft = 2.5 * n_fft_z * math.log2(n_fft_z) * z_fr
    z_ana = 4.0 * z_fr * ss._k_analysis(n_fft_z) * 128 * -(-F_z // 128)
    z_chain = T.OverlapAdd(n_fft_z, hop_z) + T.RealtimeSTFT(n_fft=n_fft_z, hop_length=hop_z)
    z_rt = z_chain[1]
    z_rt_ops = ss._Session(z_chain, 8).roundtrip_operands()
    z_ang = 2 * math.pi * torch.rand((SB, T_z, F_z), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(args.seed + 57))
    r_z = ss._roundtrip_plan(n_fft_z, hop_z)[0]
    t_z = -(-T_z // r_z)
    z_design = (4.0 * SB * (T_z + t_z * (ov_z - 1)) * ss._k_analysis(n_fft_z) * 128 * -(-F_z // 128)
                + 2.0 * SB * t_z * 8 * -(-r_z // 8) * ov_z * ss._k_padded(F_z) * hop_z)
    z_need = 2 * z_fft + 3.0 * n_fft_z * z_fr
    z_out = 4.0 * SB * T_z * hop_z
    require(ss.session_route(n_fft_q, "decode") == "smooth" and ss.session_route(n_fft_x, "encode") == "smooth"
            and ss.session_route(n_fft_x, "roundtrip", hop_x) == "smooth"
            and ss.session_route(n_fft_x, "decode") == "smooth"
            and ss.session_route(n_fft_z, "encode") == ss.session_route(n_fft_z, "roundtrip", hop_z)
            == ss.session_route(n_fft_z, "decode") == "product"
            and x_ops[0].shape == (n_fft_x,) and z_ops[0].shape[0] == ss._k_analysis(n_fft_z),
            "phase 5: the smooth, radix-7 and product shapes' routes")

    def lib_encode_x():
        rows = ss.session_rows(sx, n_fft_x, hop_x, T_x)
        return torch.stft(rows, n_fft_x, hop_x, window=w_x, center=False, return_complex=True)

    def lib_encode_z():
        rows = ss.session_rows(sx, n_fft_z, hop_z, T_z)
        return torch.stft(rows, n_fft_z, hop_z, window=w_z, center=False, return_complex=True)

    def lib_synth_z(S):
        fr = torch.fft.irfft(S, n=n_fft_z) * (z_rt.inv_window / ov_z)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (T_z - 1) * hop_z + n_fft_z), (1, n_fft_z),
                                     stride=(1, hop_z))
        return y.reshape(SB, -1)[:, : T_z * hop_z]

    def lib_synth_x(S):
        fr = torch.fft.irfft(S, n=n_fft_x) * (x_rt.inv_window / ov_x)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (T_x - 1) * hop_x + n_fft_x), (1, n_fft_x),
                                     stride=(1, hop_x))
        return y.reshape(SB, -1)[:, : T_x * hop_x]

    def lib_synth_q(S):
        fr = torch.fft.irfft(S, n=n_fft_q) * (q_rt.inv_window / ov_q)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (T_q - 1) * hop_q + n_fft_q), (1, n_fft_q),
                                     stride=(1, hop_q))
        return y.reshape(SB, -1)[:, : T_q * hop_q]

    def lib_synth(S):
        fr = torch.fft.irfft(S, n=N_FFT) * s_syn_window
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (n_sf - 1) * HOP + N_FFT), (1, N_FFT),
                                     stride=(1, HOP))
        return y.reshape(SB, -1)[:, : n_sf * HOP]

    # P and S on the FFT route: per block of r_dec chunks, frames_irfft of
    # r_dec + 2 overlap frames (fft_design_flops); on the smooth route at
    # 1200/300 and its radix-7 instance at 1344/336 the mixed-radix
    # frames_irfft of as many (smooth_design_flops); their product route at
    # 1408/352: the synthesis product of 8 ceil(R / 8) chunks x overlap x Kp
    # x hop per block of R chunks
    dec_design = fft_design_flops(N_FFT, SB * t_dec * (r_dec + 2 * ov))
    q_dec_ops = ss._decode_operands(q_rt.inv_window, float(ov_q), n_fft_q, hop_q)
    q_spec = lib_encode_q().transpose(1, 2).contiguous()
    q_mags = q_spec.abs().contiguous()
    q_spec_ri = torch.view_as_real(q_spec).contiguous()
    r_dq = ss._decode_plan(n_fft_q, hop_q)[0]
    q_dec_design = smooth_design_flops(n_fft_q, SB * -(-T_q // r_dq) * (r_dq + 2 * ov_q))
    x_dec_ops = ss._decode_operands(x_rt.inv_window, float(ov_x), n_fft_x, hop_x)
    x_spec = lib_encode_x().transpose(1, 2).contiguous()
    x_mags = x_spec.abs().contiguous()
    x_spec_ri = torch.view_as_real(x_spec).contiguous()
    r_dx = ss._decode_plan(n_fft_x, hop_x)[0]
    x_dec_design = smooth_design_flops(n_fft_x, SB * -(-T_x // r_dx) * (r_dx + 2 * ov_x))
    z_dec_ops = ss._decode_operands(z_rt.inv_window, float(ov_z), n_fft_z, hop_z)
    z_spec = lib_encode_z().transpose(1, 2).contiguous()
    z_mags = z_spec.abs().contiguous()
    z_spec_ri = torch.view_as_real(z_spec).contiguous()
    r_dz = ss._decode_plan(n_fft_z, hop_z)[0]
    z_dec_design = 2.0 * SB * -(-T_z // r_dz) * 8 * -(-r_dz // 8) * ov_z * ss._k_padded(F_z) * hop_z
    require(q_dec_ops[0] is None and x_dec_ops[0] is None and z_dec_ops[1] is None,
            "phase 5: the decodes' smooth, radix-7 and product operands")

    stream_src = "acids_transforms_tpu_torch/csrc/stream_step.cu"
    stream_tpu = "acids_transforms_tpu/ops/pallas/stream_step.py"
    specs += [
        dict(key="R", name="session_encode", source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="fft",
             replaces=stream_tpu + ":1670", launches=counts["session_encode:fft"],
             run=lambda: ss._launch_encode(sx, s_ops, N_FFT, HOP, n_sf),
             plain=lambda: ss.session_encode_reference(sx, s_rt.window, N_FFT, HOP, n_sf),
             library=lib_encode, bound=bound_of(s_in + s_spec, s_fft + N_FFT * s_fr),
             ceiling=ceiling_of(fft_design_flops(N_FFT, s_fr))),
        dict(key="R_smooth", name="session_encode_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":1670", launches=counts["session_encode:smooth"],
             run=lambda: ss._launch_encode(sx, q_ops, n_fft_q, hop_q, T_q),
             plain=lambda: ss.session_encode_reference(sx, w_q, n_fft_q, hop_q, T_q),
             library=lib_encode_q, bound=bound_of(s_in + 8.0 * q_fr * F_q, q_fft + n_fft_q * q_fr),
             ceiling=ceiling_of(smooth_design_flops(n_fft_q, q_fr))),
        dict(key="R_smooth7", name="session_encode_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":1670", launches=counts["session_encode:smooth7"],
             run=lambda: ss._launch_encode(sx, x_ops, n_fft_x, hop_x, T_x),
             plain=lambda: ss.session_encode_reference(sx, w_x, n_fft_x, hop_x, T_x),
             library=lib_encode_x, bound=bound_of(s_in + 8.0 * x_fr * F_x, x_fft + n_fft_x * x_fr),
             ceiling=ceiling_of(smooth_design_flops(n_fft_x, x_fr)), resources=seven_res["R"]),
        dict(key="R_product", name="session_encode_product", source=stream_src, front_end="product",
             replaces=stream_tpu + ":1670", launches=counts["session_encode:product"],
             run=lambda: ss._launch_encode(sx, z_ops, n_fft_z, hop_z, T_z),
             plain=lambda: ss.session_encode_reference(sx, w_z, n_fft_z, hop_z, T_z),
             library=lib_encode_z, bound=bound_of(s_in + 8.0 * z_fr * F_z, z_fft + n_fft_z * z_fr),
             ceiling=ceiling_of(z_ana)),
        dict(key="L", name="session_roundtrip", source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="fft",
             replaces=stream_tpu + ":211", launches=counts["session_roundtrip:fft"],
             run=lambda: ss._launch_roundtrip(sx, None, s_rt_ops, N_FFT, HOP, n_sf),
             plain=lambda: ss.session_roundtrip_reference(sx, s_rt.window, s_rt.inv_window, float(ov), N_FFT,
                                                          HOP, n_sf),
             library=lambda: lib_synth(lib_encode().transpose(1, 2)),
             bound=bound_of(s_in + s_out, rt_need), ceiling=ceiling_of(rt_design)),
        dict(key="M", name="session_random_roundtrip", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="fft", replaces=stream_tpu + ":372", launches=counts["session_random_roundtrip:fft"],
             run=lambda: ss._launch_roundtrip(sx, s_ang, s_rt_ops, N_FFT, HOP, n_sf),
             plain=lambda: ss.session_roundtrip_reference(sx, s_rt.window, s_rt.inv_window, float(ov), N_FFT,
                                                          HOP, n_sf, angles=s_ang),
             library=lambda: lib_synth(torch.polar(lib_encode().transpose(1, 2).abs(), s_ang)),
             bound=bound_of(s_in + s_out + 4.0 * s_fr * F, rt_need + 26.0 * s_fr * F),
             ceiling=ceiling_of(rt_design + 26.0 * s_fr * F)),
        dict(key="L_smooth", name="session_roundtrip_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":211", launches=counts["session_roundtrip:smooth"],
             run=lambda: ss._launch_roundtrip(sx, None, q_rt_ops, n_fft_q, hop_q, T_q),
             plain=lambda: ss.session_roundtrip_reference(sx, q_rt.window, q_rt.inv_window, float(ov_q), n_fft_q,
                                                          hop_q, T_q),
             library=lambda: lib_synth_q(lib_encode_q().transpose(1, 2)),
             bound=bound_of(s_in + q_out, q_need), ceiling=ceiling_of(q_design)),
        dict(key="M_smooth", name="session_random_roundtrip_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":372", launches=counts["session_random_roundtrip:smooth"],
             run=lambda: ss._launch_roundtrip(sx, q_ang, q_rt_ops, n_fft_q, hop_q, T_q),
             plain=lambda: ss.session_roundtrip_reference(sx, q_rt.window, q_rt.inv_window, float(ov_q), n_fft_q,
                                                          hop_q, T_q, angles=q_ang),
             library=lambda: lib_synth_q(torch.polar(lib_encode_q().transpose(1, 2).abs(), q_ang)),
             bound=bound_of(s_in + q_out + 4.0 * q_fr * F_q, q_need + 26.0 * q_fr * F_q),
             ceiling=ceiling_of(q_design + 26.0 * q_fr * F_q)),
        dict(key="L_smooth7", name="session_roundtrip_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":211", launches=counts["session_roundtrip:smooth7"],
             run=lambda: ss._launch_roundtrip(sx, None, x_rt_ops, n_fft_x, hop_x, T_x),
             plain=lambda: ss.session_roundtrip_reference(sx, x_rt.window, x_rt.inv_window, float(ov_x), n_fft_x,
                                                          hop_x, T_x),
             library=lambda: lib_synth_x(lib_encode_x().transpose(1, 2)),
             bound=bound_of(s_in + x_out, x_need), ceiling=ceiling_of(x_design), resources=seven_res["L"]),
        dict(key="M_smooth7", name="session_random_roundtrip_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":372", launches=counts["session_random_roundtrip:smooth7"],
             run=lambda: ss._launch_roundtrip(sx, x_ang, x_rt_ops, n_fft_x, hop_x, T_x),
             plain=lambda: ss.session_roundtrip_reference(sx, x_rt.window, x_rt.inv_window, float(ov_x), n_fft_x,
                                                          hop_x, T_x, angles=x_ang),
             library=lambda: lib_synth_x(torch.polar(lib_encode_x().transpose(1, 2).abs(), x_ang)),
             bound=bound_of(s_in + x_out + 4.0 * x_fr * F_x, x_need + 26.0 * x_fr * F_x),
             ceiling=ceiling_of(x_design + 26.0 * x_fr * F_x), resources=seven_res["M"]),
        dict(key="L_product", name="session_roundtrip_product", source=stream_src + " (+ csrc/synth_ola.cuh)",
             front_end="product", replaces=stream_tpu + ":211", launches=counts["session_roundtrip:product"],
             run=lambda: ss._launch_roundtrip(sx, None, z_rt_ops, n_fft_z, hop_z, T_z),
             plain=lambda: ss.session_roundtrip_reference(sx, z_rt.window, z_rt.inv_window, float(ov_z), n_fft_z,
                                                          hop_z, T_z),
             library=lambda: lib_synth_z(lib_encode_z().transpose(1, 2)),
             bound=bound_of(s_in + z_out, z_need), ceiling=ceiling_of(z_design)),
        dict(key="M_product", name="session_random_roundtrip_product",
             source=stream_src + " (+ csrc/synth_ola.cuh)", front_end="product",
             replaces=stream_tpu + ":372", launches=counts["session_random_roundtrip:product"],
             run=lambda: ss._launch_roundtrip(sx, z_ang, z_rt_ops, n_fft_z, hop_z, T_z),
             plain=lambda: ss.session_roundtrip_reference(sx, z_rt.window, z_rt.inv_window, float(ov_z), n_fft_z,
                                                          hop_z, T_z, angles=z_ang),
             library=lambda: lib_synth_z(torch.polar(lib_encode_z().transpose(1, 2).abs(), z_ang)),
             bound=bound_of(s_in + z_out + 4.0 * z_fr * F_z, z_need + 26.0 * z_fr * F_z),
             ceiling=ceiling_of(z_design + 26.0 * z_fr * F_z)),
        dict(key="P", name="session_random_decode", source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="fft",
             replaces=stream_tpu + ":1328", launches=counts["session_random_decode:fft"],
             run=lambda: ss._launch_decode(s_mags, s_ang, s_syn, N_FFT, HOP),
             plain=lambda: ss.session_decode_reference(s_mags, s_ang, s_rt.inv_window, float(ov), N_FFT, HOP),
             library=lambda: lib_synth(torch.polar(s_mags, s_ang)),
             bound=bound_of(8.0 * s_fr * F + s_out, s_fft + 2.0 * N_FFT * s_fr + 22.0 * s_fr * F),
             ceiling=ceiling_of(dec_design + 22.0 * s_fr * F)),
        dict(key="P_smooth", name="session_random_decode_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":1328", launches=counts["session_random_decode:smooth"],
             run=lambda: ss._launch_decode(q_mags, q_ang, q_dec_ops, n_fft_q, hop_q),
             plain=lambda: ss.session_decode_reference(q_mags, q_ang, q_rt.inv_window, float(ov_q), n_fft_q, hop_q),
             library=lambda: lib_synth_q(torch.polar(q_mags, q_ang)),
             bound=bound_of(8.0 * q_fr * F_q + q_out, q_fft + 2.0 * n_fft_q * q_fr + 22.0 * q_fr * F_q),
             ceiling=ceiling_of(q_dec_design + 22.0 * q_fr * F_q)),
        dict(key="P_smooth7", name="session_random_decode_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":1328", launches=counts["session_random_decode:smooth7"],
             run=lambda: ss._launch_decode(x_mags, x_ang, x_dec_ops, n_fft_x, hop_x),
             plain=lambda: ss.session_decode_reference(x_mags, x_ang, x_rt.inv_window, float(ov_x), n_fft_x, hop_x),
             library=lambda: lib_synth_x(torch.polar(x_mags, x_ang)),
             bound=bound_of(8.0 * x_fr * F_x + x_out, x_fft + 2.0 * n_fft_x * x_fr + 22.0 * x_fr * F_x),
             ceiling=ceiling_of(x_dec_design + 22.0 * x_fr * F_x), resources=seven_res["P"]),
        dict(key="P_product", name="session_random_decode_product", source=stream_src + " (+ csrc/synth_ola.cuh)",
             front_end="product", replaces=stream_tpu + ":1328", launches=counts["session_random_decode:product"],
             run=lambda: ss._launch_decode(z_mags, z_ang, z_dec_ops, n_fft_z, hop_z),
             plain=lambda: ss.session_decode_reference(z_mags, z_ang, z_rt.inv_window, float(ov_z), n_fft_z, hop_z),
             library=lambda: lib_synth_z(torch.polar(z_mags, z_ang)),
             bound=bound_of(8.0 * z_fr * F_z + z_out, z_fft + 2.0 * n_fft_z * z_fr + 22.0 * z_fr * F_z),
             ceiling=ceiling_of(z_dec_design + 22.0 * z_fr * F_z)),
    ]
    # ---- the RT-PGHI sessions and the complex decode (phase 4g's shape).
    # The magnitude encode: R's analysis, |X| written instead of (re, im), the
    # bound R's less half the output bytes plus 4 operations per bin.  The
    # recurrence, as K's: magnitudes read, phases written, the silent bins'
    # angles read (this run's share), some 150 operations per bin; no library
    # call computes it.  Its chain's floor (logged, a model): the serial
    # steps (a frame each, and a re-wrap at each chunk boundary) times the
    # least latency of one (a shared-memory load of phi[src], two dependent
    # float adds, a named barrier: RT_STEP_CYCLES) at the card's largest SM
    # clock.  S: the spectrum read, the audio written, one inverse
    # FFT, the window and the overlap-add per frame, P's synthesis product;
    # yardstick irfft x window + fold, as P's.
    rt_mag, rt_ang, h_chain, rt_spec = (rt_stream[k] for k in ("mag", "angles", "chain", "spec"))
    h_rt = h_chain[1]
    rt_args = (h_rt.gamma, N_FFT, HOP, h_rt.tolerance, STREAM_CHUNK // HOP)
    chunk_max = rt_mag.reshape(SB, -1, STREAM_CHUNK // HOP * F).amax(-1).repeat_interleave(STREAM_CHUNK // HOP, 1)
    rt_silent = (rt_mag <= torch.clamp_min(h_rt.tolerance * chunk_max, 1.19e-7)[..., None]).float().mean().item()
    rt_spec_ri = torch.view_as_real(rt_spec).contiguous()
    specs += [
        dict(key="Rmag", name="session_magnitude_encode", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="fft", replaces=stream_tpu + ":602", launches=counts["session_magnitude:fft"],
             run=lambda: ss._launch_encode(sx, s_ops, N_FFT, HOP, n_sf, magnitude=True),
             plain=lambda: ss.session_magnitude_reference(sx, s_rt.window, N_FFT, HOP, n_sf),
             library=lambda: lib_encode().abs(), bound=bound_of(s_in + s_spec / 2, s_fft + (N_FFT + 4.0 * F) * s_fr),
             ceiling=ceiling_of(fft_design_flops(N_FFT, s_fr) + 4.0 * s_fr * F)),
        dict(key="Rmag_smooth", name="session_magnitude_encode_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":602", launches=counts["session_magnitude:smooth"],
             run=lambda: ss._launch_encode(sx, q_ops, n_fft_q, hop_q, T_q, magnitude=True),
             plain=lambda: ss.session_magnitude_reference(sx, w_q, n_fft_q, hop_q, T_q),
             library=lambda: lib_encode_q().abs(),
             bound=bound_of(s_in + 4.0 * q_fr * F_q, q_fft + (n_fft_q + 4.0 * F_q) * q_fr),
             ceiling=ceiling_of(smooth_design_flops(n_fft_q, q_fr) + 4.0 * q_fr * F_q)),
        dict(key="Rmag_smooth7", name="session_magnitude_encode_smooth7",
             source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="smooth", replaces=stream_tpu + ":602",
             launches=counts["session_magnitude:smooth7"],
             run=lambda: ss._launch_encode(sx, x_ops, n_fft_x, hop_x, T_x, magnitude=True),
             plain=lambda: ss.session_magnitude_reference(sx, w_x, n_fft_x, hop_x, T_x),
             library=lambda: lib_encode_x().abs(),
             bound=bound_of(s_in + 4.0 * x_fr * F_x, x_fft + (n_fft_x + 4.0 * F_x) * x_fr),
             ceiling=ceiling_of(smooth_design_flops(n_fft_x, x_fr) + 4.0 * x_fr * F_x), resources=seven_res["N"]),
        dict(key="Rmag_product", name="session_magnitude_encode_product", source=stream_src,
             front_end="product", replaces=stream_tpu + ":602", launches=counts["session_magnitude:product"],
             run=lambda: ss._launch_encode(sx, z_ops, n_fft_z, hop_z, T_z, magnitude=True),
             plain=lambda: ss.session_magnitude_reference(sx, w_z, n_fft_z, hop_z, T_z),
             library=lambda: lib_encode_z().abs(),
             bound=bound_of(s_in + 4.0 * z_fr * F_z, z_fft + (n_fft_z + 4.0 * F_z) * z_fr),
             ceiling=ceiling_of(z_ana + 4.0 * z_fr * F_z)),
        dict(key="RT", name="rt_pghi_phases", source="acids_transforms_tpu_torch/csrc/pghi.cu",
             replaces=stream_tpu + ":668", launches=counts["rt_pghi_phases"],
             run=lambda: ss._launch_rt_pghi(rt_mag, rt_ang, *rt_args),
             plain=lambda: ss.rt_pghi_phases_reference(rt_mag, rt_ang, *rt_args), plain_once=True,
             library=None, bound=bound_of(4.0 * s_fr * F * (2.0 + rt_silent), 150.0 * s_fr * F),
             ceiling=ceiling_of(150.0 * s_fr * F)),
        dict(key="S", name="session_complex_decode", source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="fft",
             replaces=stream_tpu + ":1803", launches=counts["session_complex_decode:fft"],
             run=lambda: ss._launch_decode(rt_spec_ri, None, s_syn, N_FFT, HOP),
             plain=lambda: ss.session_complex_decode_reference(rt_spec, s_rt.inv_window, float(ov), N_FFT, HOP),
             library=lambda: lib_synth(rt_spec),
             bound=bound_of(8.0 * s_fr * F + s_out, s_fft + 2.0 * N_FFT * s_fr),
             ceiling=ceiling_of(dec_design)),
        dict(key="S_smooth", name="session_complex_decode_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":1803", launches=counts["session_complex_decode:smooth"],
             run=lambda: ss._launch_decode(q_spec_ri, None, q_dec_ops, n_fft_q, hop_q),
             plain=lambda: ss.session_complex_decode_reference(q_spec, q_rt.inv_window, float(ov_q), n_fft_q, hop_q),
             library=lambda: lib_synth_q(q_spec),
             bound=bound_of(8.0 * q_fr * F_q + q_out, q_fft + 2.0 * n_fft_q * q_fr),
             ceiling=ceiling_of(q_dec_design)),
        dict(key="S_smooth7", name="session_complex_decode_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":1803", launches=counts["session_complex_decode:smooth7"],
             run=lambda: ss._launch_decode(x_spec_ri, None, x_dec_ops, n_fft_x, hop_x),
             plain=lambda: ss.session_complex_decode_reference(x_spec, x_rt.inv_window, float(ov_x), n_fft_x, hop_x),
             library=lambda: lib_synth_x(x_spec),
             bound=bound_of(8.0 * x_fr * F_x + x_out, x_fft + 2.0 * n_fft_x * x_fr),
             ceiling=ceiling_of(x_dec_design), resources=seven_res["S"]),
        dict(key="S_product", name="session_complex_decode_product", source=stream_src + " (+ csrc/synth_ola.cuh)",
             front_end="product", replaces=stream_tpu + ":1803", launches=counts["session_complex_decode:product"],
             run=lambda: ss._launch_decode(z_spec_ri, None, z_dec_ops, n_fft_z, hop_z),
             plain=lambda: ss.session_complex_decode_reference(z_spec, z_rt.inv_window, float(ov_z), n_fft_z, hop_z),
             library=lambda: lib_synth_z(z_spec),
             bound=bound_of(8.0 * z_fr * F_z + z_out, z_fft + 2.0 * n_fft_z * z_fr),
             ceiling=ceiling_of(z_dec_design)),
    ]
    # ---- O (phase 4g's pghi_gl shape: one chunk's grid of gl_context 3 +
    # 16 frames, 64 sessions; the port pads it with 3 zero frames, which the
    # bounds do not count).  The polish (Opol) runs every projection of it in
    # one launch.  The two-launch projection runs where the polish does not
    # take the grid, and its rows are timed there (4096/1024 with
    # gl_context 1 for the synthesis's FFT route, 1200/300 for its smooth
    # route, 1344/336 for its radix-7 instance and the analysis, 1408/352 for
    # its product route).  The
    # projection's synthesis is P's kernel in
    # blocks of 8 chunks; what the function needs of it: the grid's
    # magnitudes and phases read, the overlap-add signal from the first
    # polished frame on written ((Tp - ctx) hop samples: the analysis reads
    # no earlier one), an inverse FFT per grid frame, sincos and the window.
    # Its analysis reads those samples and writes the phases of the polished
    # frames that are not frozen (T_c + la - freeze_n rows), an FFT per row,
    # the window and an atan2 (20) per bin.  The seeded recurrence as the
    # recurrence, over 16 frames and the carries.  Yardsticks (timed, used
    # nowhere): irfft x window + fold; unfold x window + rfft + angle.
    g_rt = gl_stream["rt"]
    gm, gp, g_syn, g_wc, g_ws = (gl_stream[k] for k in ("gm", "gp", "syn", "WC", "WS"))
    g_ctx, g_lo, g_hi = g_rt.gl_context, gl_stream["lo"], gl_stream["hi"]
    g_tp = gm.shape[1]
    g_tx = g_tp - (ov - 1)
    g_y = gl_stream["y"]
    g_win_syn = g_rt.inv_window / ov

    def lib_proj_synth():
        fr = torch.fft.irfft(torch.polar(gm, gp), n=N_FFT) * g_win_syn
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (g_tp - 1) * HOP + N_FFT), (1, N_FFT),
                                     stride=(1, HOP))
        return y.reshape(SB, -1)[:, : g_tp * HOP]

    def lib_proj_analysis():
        fr = g_y.unfold(-1, N_FFT, HOP)[:, g_ctx:g_tx] * g_rt.window
        return torch.angle(torch.fft.rfft(fr, n=N_FFT))

    g_fr = float(SB * g_tx)
    g_rows = g_tx - g_ctx
    g_upd = g_rows - (g_hi - g_lo)          # rows the analysis computes and writes
    g_el = float(SB * g_upd * F)
    # O's synthesis on the smooth route: a grid of 3 pinned + 8 + 3 zero
    # frames at 1200/300 (phase 4h's sessions), random magnitudes and phases;
    # on the radix-7 instance the same grid at 1344/336, on the product route
    # at 1408/352
    gq_tp = g_ctx + 8 + ov_q - 1
    gq_g = torch.Generator(device=dev).manual_seed(args.seed + 56)
    gm_q = torch.rand((SB, gq_tp, F_q), generator=gq_g, device=dev)
    gm_q[:, -(ov_q - 1):] = 0.0
    gp_q = 2 * math.pi * torch.rand((SB, gq_tp, F_q), generator=gq_g, device=dev)
    gq_ops = ss._decode_operands(q_rt.inv_window, float(ov_q), n_fft_q, hop_q)
    gq_fr = float(SB * (gq_tp - (ov_q - 1)))

    def lib_proj_synth_q():
        fr = torch.fft.irfft(torch.polar(gm_q, gp_q), n=n_fft_q) * (q_rt.inv_window / ov_q)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (gq_tp - 1) * hop_q + n_fft_q), (1, n_fft_q),
                                     stride=(1, hop_q))
        return y.reshape(SB, -1)[:, : gq_tp * hop_q]

    gq_rows_syn = ss._decode_plan(n_fft_q, hop_q, ss.PROJECT_SYN_ROWS)[0]
    gx_tp = g_ctx + 8 + ov_x - 1
    gm_x = torch.rand((SB, gx_tp, F_x), generator=gq_g, device=dev)
    gm_x[:, -(ov_x - 1):] = 0.0
    gp_x = 2 * math.pi * torch.rand((SB, gx_tp, F_x), generator=gq_g, device=dev)
    gx_ops = ss._decode_operands(x_rt.inv_window, float(ov_x), n_fft_x, hop_x)
    gx_fr = float(SB * (gx_tp - (ov_x - 1)))

    def lib_proj_synth_x():
        fr = torch.fft.irfft(torch.polar(gm_x, gp_x), n=n_fft_x) * (x_rt.inv_window / ov_x)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (gx_tp - 1) * hop_x + n_fft_x), (1, n_fft_x),
                                     stride=(1, hop_x))
        return y.reshape(SB, -1)[:, : gx_tp * hop_x]

    gx_rows_syn = ss._decode_plan(n_fft_x, hop_x, ss.PROJECT_SYN_ROWS)[0]
    gz_tp = g_ctx + 8 + ov_z - 1
    gz_g = torch.Generator(device=dev).manual_seed(args.seed + 58)
    gm_z = torch.rand((SB, gz_tp, F_z), generator=gz_g, device=dev)
    gm_z[:, -(ov_z - 1):] = 0.0
    gp_z = 2 * math.pi * torch.rand((SB, gz_tp, F_z), generator=gz_g, device=dev)
    gz_ops = ss._decode_operands(z_rt.inv_window, float(ov_z), n_fft_z, hop_z)
    gz_fr = float(SB * (gz_tp - (ov_z - 1)))

    def lib_proj_synth_z():
        fr = torch.fft.irfft(torch.polar(gm_z, gp_z), n=n_fft_z) * (z_rt.inv_window / ov_z)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (gz_tp - 1) * hop_z + n_fft_z), (1, n_fft_z),
                                     stride=(1, hop_z))
        return y.reshape(SB, -1)[:, : gz_tp * hop_z]

    # O's projection synthesis on the FFT route where it now runs: the
    # two-launch projection of a grid that the polish does not take, phase
    # 4g's 4096/1024 sessions with gl_context 1 (1 pinned + 40 + 3 zero
    # frames), random magnitudes and phases
    gf_n, gf_hop, gf_ctx = 4096, 1024, 1
    gf_ov, gf_F = gf_n // gf_hop, gf_n // 2 + 1
    gf_tp = gf_ctx + 40 + gf_ov - 1
    gf_win = torch.hann_window(gf_n, device=dev)
    gm_f = torch.rand((SB, gf_tp, gf_F), generator=gq_g, device=dev)
    gm_f[:, -(gf_ov - 1):] = 0.0
    gp_f = 2 * math.pi * torch.rand((SB, gf_tp, gf_F), generator=gq_g, device=dev)
    gf_ops = ss._decode_operands(gf_win, float(gf_ov), gf_n, gf_hop)
    gf_fr = float(SB * (gf_tp - (gf_ov - 1)))
    gf_rows_syn = ss._decode_plan(gf_n, gf_hop, ss.PROJECT_SYN_ROWS)[0]
    gf_tiles = -(-gf_tp // gf_rows_syn)

    def lib_proj_synth_f():
        fr = torch.fft.irfft(torch.polar(gm_f, gp_f), n=gf_n) * (gf_win / gf_ov)
        y = torch.nn.functional.fold(fr.transpose(1, 2), (1, (gf_tp - 1) * gf_hop + gf_n), (1, gf_n),
                                     stride=(1, gf_hop))
        return y.reshape(SB, -1)[:, : gf_tp * gf_hop]

    # O's projection analysis on the product route (Oana), where it now runs:
    # the two-launch projection of 1408/352's grid above (2^7 11; its
    # synthesis on the decode's product route); the analysis against its
    # plain version and the float64 analysis on the synthesis's signal, the
    # pinned and frozen rows untouched.  A phase is read as |Y| (cos,
    # sin)(phase) over the session's largest |Y|, Y the float64 re-framed
    # spectrum: a bin's angle is only as good as its magnitude, and a random
    # grid's re-framed spectrum has near-silent bins whose angle float32
    # rounds to 1e-3 rad and worse (read against the grid's magnitude
    # instead, the plain version's own distance to the float64 analysis moved
    # 4.5x with the float32 rounding of its input).  Readings of
    # tools/session_bounds.py when this check ran at 1344/336 (8 grids of 64
    # sessions): kernel vs plain 4.2e-7 to 5.4e-7, kernel vs float64 3.0e-7
    # to 3.5e-7, plain vs float64 4.2e-7 to 5.5e-7; the basis perturbed by
    # 1e-5 reads 6.1e-6 to 6.9e-6 (the tool reads 1408/352 since).  Both of
    # the kernel's distances required within tol_a, between the two
    tol_a = 2e-6
    gz_tx = gz_tp - (ov_z - 1)
    gz_lo, gz_hi = z_rt.gl_frozen(8)
    gz_wc, gz_ws = ss._ana_basis(z_rt.window, n_fft_z, ss._k_analysis(n_fft_z))
    gz_y = ss._launch_decode(gm_z, gp_z, gz_ops, n_fft_z, hop_z, rows=ss.PROJECT_SYN_ROWS, name="gl_project_synthesis")
    gz_scratch = gp_z.clone()
    require(ss.session_route(n_fft_z, "project") == "product", "1408/352: O's analysis must take the product route")

    def plain_proj_analysis_z():
        fr = gz_y.unfold(-1, n_fft_z, hop_z)[:, g_ctx:gz_tx]
        return torch.atan2(torch.matmul(fr, gz_ws[:n_fft_z]), torch.matmul(fr, gz_wc[:n_fft_z]))

    ss._launch_project_analysis(gz_y, gz_scratch, (gz_wc, gz_ws), n_fft_z, hop_z, gz_tx, g_ctx, gz_lo, gz_hi)
    a_p = plain_proj_analysis_z()
    upd_z = torch.ones(gz_tx - g_ctx, dtype=torch.bool, device=dev)
    upd_z[gz_lo - g_ctx: gz_hi - g_ctx] = False
    fr64 = gz_y.double().unfold(-1, n_fft_z, hop_z)[:, g_ctx:gz_tx]
    re64, im64 = torch.matmul(fr64, gz_wc[:n_fft_z].double()), torch.matmul(fr64, gz_ws[:n_fft_z].double())
    a_64, y_u = torch.atan2(im64, re64), torch.hypot(re64, im64)[:, upd_z]

    def angle_off(a, b):
        return (unit_spec(y_u, a[:, upd_z]) - unit_spec(y_u, b[:, upd_z])).abs().max().item()
    e_oa = angle_off(gz_scratch[:, g_ctx:gz_tx], a_p)
    e_p64, e_k64 = angle_off(a_p, a_64), angle_off(gz_scratch[:, g_ctx:gz_tx], a_64)
    kept_z = torch.equal(gz_scratch[:, :g_ctx], gp_z[:, :g_ctx]) and torch.equal(
        gz_scratch[:, gz_lo:gz_hi], gp_z[:, gz_lo:gz_hi])
    log(f"  O's projection analysis at 1408/352 (the product route, {gz_tx - g_ctx} polished frames, {SB} sessions) "
        f"on the product synthesis's signal, |Y| (cos, sin): against its plain version {e_oa:.3e}, against the "
        f"float64 analysis {e_k64:.3e} (tol {tol_a:g} each; the plain version's {e_p64:.3e}); pinned and frozen rows "
        f"kept: {kept_z}")
    require(e_oa <= tol_a and e_k64 <= tol_a and kept_z,
            "O's projection analysis at 1408/352 disagrees with its plain version")
    del fr64, re64, im64, a_64
    errs["Oana"] = max(errs.get("Oana", 0.0), e_oa)

    # O's analysis on the FFT route (Oana_fft: 4096/1024's grid above, 1 +
    # 40 + 3 frames, which no polish block holds), the smooth route
    # (Oana_smooth: 3072/768, 3 + 40 + 3 frames) and its radix-7 instance
    # (Oana_smooth7: 1344/336's grid above, 3 + 8 + 3 frames, the product
    # row's input before), each on its synthesis's signal.  What the function
    # needs: the samples of the polished frames read once ((Tp - ctx) hop a
    # session), the phases of the rows it writes (not frozen) written once;
    # an FFT, the window and an atan2 (20) a written row and bin.  Its design:
    # frames_rfft of every polished row, pairs in blocks of the encode's plan
    # (fft_design_flops / smooth_design_flops), an atan2 a bin
    gs_n, gs_hop = 3072, 768
    gs_ov, gs_F = gs_n // gs_hop, gs_n // 2 + 1
    gs_tp = g_ctx + 40 + gs_ov - 1
    gs_win = torch.hann_window(gs_n, device=dev)
    gm_s = torch.rand((SB, gs_tp, gs_F), generator=gq_g, device=dev)
    gm_s[:, -(gs_ov - 1):] = 0.0
    gp_s = 2 * math.pi * torch.rand((SB, gs_tp, gs_F), generator=gq_g, device=dev)
    gs_y = ss._launch_decode(gm_s, gp_s, ss._decode_operands(gs_win, float(gs_ov), gs_n, gs_hop), gs_n, gs_hop,
                             rows=ss.PROJECT_SYN_ROWS, name="gl_project_synthesis")
    gf_y = ss._launch_decode(gm_f, gp_f, gf_ops, gf_n, gf_hop, rows=ss.PROJECT_SYN_ROWS, name="gl_project_synthesis")
    gx_y = ss._launch_decode(gm_x, gp_x, gx_ops, n_fft_x, hop_x, rows=ss.PROJECT_SYN_ROWS, name="gl_project_synthesis")
    gx_tx = gx_tp - (ov_x - 1)
    gx_lo, gx_hi = x_rt.gl_frozen(8)
    gx_wc, gx_ws = ss._ana_basis(x_rt.window, n_fft_x, ss._k_analysis(n_fft_x))

    def ana_case(key, n, hop, ctx, tp, y, gp_, w):
        """What a row of O's analysis needs at one shape: the run, the plain
        version, the yardstick, the bound, the design's ceiling, and the
        product instance at the same shape (for the turns)."""
        ov_a, F_a = n // hop, n // 2 + 1
        tx = tp - (ov_a - 1)
        lo, hi = T.RealtimeSTFT(n_fft=n, hop_length=hop, inversion_mode="pghi_gl", gl_context=ctx).gl_frozen(
            tx - ctx)
        route_a = ss.session_route(n, "project")
        require(route_a != "product", f"{key}: {n}/{hop} must take the FFT or smooth route")
        ops = ss._project_operands(w, None, None, n, dev)
        wc, ws = ss._ana_basis(w, n, ss._k_analysis(n))
        scratch = gp_.clone()
        upd = tx - ctx - (hi - lo)
        el = float(SB * upd * F_a)
        rows_a = ss._encode_plan(n, hop)[0]
        frames = SB * sum(2 * -(-min(rows_a, tx - ctx - i) // 2) for i in range(0, tx - ctx, rows_a))
        design = (fft_design_flops if route_a == "fft" else smooth_design_flops)(n, frames)
        prod = 4.0 * SB * (tx - ctx) * ss._k_analysis(n) * 128 * -(-F_a // 128)

        def old():
            with analysis_on_product(ss):
                ss._launch_project_analysis(y, scratch, (wc, ws), n, hop, tx, ctx, lo, hi)
        return dict(
            run=lambda: ss._launch_project_analysis(y, scratch, ops, n, hop, tx, ctx, lo, hi),
            plain=lambda: ss.gl_project_analysis_reference(y, gp_, w, n, hop, ctx, lo, hi),
            library=lambda: torch.angle(torch.fft.rfft(y.unfold(-1, n, hop)[:, ctx:tx] * w, n=n)),
            bound=bound_of(4.0 * SB * (tp - ctx) * hop + 4.0 * el,
                           2.5 * n * math.log2(n) * SB * upd + n * SB * upd + 20.0 * el),
            ceiling=ceiling_of(design + 20.0 * el), old=old, old_ceiling=ceiling_of(prod + 20.0 * el))

    ana_f = ana_case("Oana_fft", gf_n, gf_hop, gf_ctx, gf_tp, gf_y, gp_f, gf_win)
    ana_s = ana_case("Oana_smooth", gs_n, gs_hop, g_ctx, gs_tp, gs_y, gp_s, gs_win)
    ana_x = ana_case("Oana_smooth7", n_fft_x, hop_x, g_ctx, gx_tp, gx_y, gp_x, x_rt.window)
    gz_el = float(SB * (gz_tx - g_ctx - (gz_hi - gz_lo)) * F_z)
    gz_upd = gz_tx - g_ctx - (gz_hi - gz_lo)
    gz_samples = 4.0 * SB * (gz_tp - g_ctx) * hop_z
    gz_ana_flops = 4.0 * SB * (gz_tx - g_ctx) * ss._k_analysis(n_fft_z) * 128 * -(-F_z // 128)
    # O's polish on its radix-7 instance (Opol_smooth7): 1344/336's grid above
    # (3 pinned + 8 + 3 zero frames, 64 sessions), gl_iterations projections
    # in one launch, counted as the Opol_smooth row counts its own;
    # yardstick gl_iterations times the grid's two projection yardsticks
    gx_iters = x_rt.gl_iterations
    gx_pol, gx_pol_old = gp_x.clone(), gp_x.clone()
    gx_plan = ss._polish_plan(n_fft_x, hop_x, gx_tp)
    require(gx_plan is not None and ss.session_route(n_fft_x, "polish") == "smooth",
            "phase 5: the polish must hold 1344/336's 14-frame grid on its radix-7 instance")
    gx_rows = gx_tx - g_ctx
    gx_upd = gx_rows - (gx_hi - gx_lo)
    gx_el = float(SB * gx_upd * F_x)
    gx_pframes = gx_tp + ov_x - 1
    gx_pairs = sum((gx_pframes - 1 - c) // (2 * ov_x) + 1 for c in range(ov_x))
    polx_design = gx_iters * (smooth_design_flops(n_fft_x, 2 * SB * gx_pairs)
                              + smooth_design_flops(n_fft_x, 2 * SB * -(-gx_rows // 2))
                              + 22.0 * SB * gx_tp * F_x + 20.0 * gx_el)
    polx_need = gx_iters * (2.5 * n_fft_x * math.log2(n_fft_x) * (gx_fr + SB * gx_upd)
                            + n_fft_x * (gx_fr + SB * gx_upd) + 22.0 * gx_fr * F_x + 20.0 * gx_el)
    lib_ana_x = ana_x["library"]

    def lib_polish_x():
        for _ in range(gx_iters):
            lib_proj_synth_x()
            lib_ana_x()

    def polish_x_old():
        # the route 1344/336 took before: gl_iterations two-launch
        # projections, the analysis a product
        with analysis_on_product(ss, polish=False):
            ss.gl_polish(gm_x, gx_pol_old, gx_ops, x_rt.inv_window, x_rt.window, gx_wc, gx_ws, n_fft_x, hop_x, g_ctx,
                         gx_lo, gx_hi, gx_iters)
    # O's polish on the smooth route: the 1200/300 grid above (3 pinned + 8 +
    # 3 zero frames, 64 sessions), gl_iterations projections in one launch;
    # what the function needs as the Opol row counts it, its design the
    # mixed-radix stages (smooth_design_flops).  Yardstick: gl_iterations
    # times the smooth grid's two projection yardsticks
    gq_tx = gq_tp - (ov_q - 1)
    gq_lo, gq_hi = q_rt.gl_frozen(8)
    gq_rows = gq_tx - g_ctx
    gq_upd = gq_rows - (gq_hi - gq_lo)
    gq_el = float(SB * gq_upd * F_q)
    gq_iters = q_rt.gl_iterations
    gq_pol = gp_q.clone()
    gq_plan = ss._polish_plan(n_fft_q, hop_q, gq_tp)
    require(gq_plan is not None and ss.session_route(n_fft_q, "polish") == "smooth",
            "phase 5: the polish must hold 1200/300's 14-frame grid on the smooth route")
    gq_pframes = gq_tp + ov_q - 1
    gq_pairs = sum((gq_pframes - 1 - c) // (2 * ov_q) + 1 for c in range(ov_q))
    polq_design = gq_iters * (smooth_design_flops(n_fft_q, 2 * SB * gq_pairs)
                              + smooth_design_flops(n_fft_q, 2 * SB * -(-gq_rows // 2))
                              + 22.0 * SB * gq_tp * F_q + 20.0 * gq_el)
    polq_need = gq_iters * (2.5 * n_fft_q * math.log2(n_fft_q) * (gq_fr + SB * gq_upd)
                            + n_fft_q * (gq_fr + SB * gq_upd) + 22.0 * gq_fr * F_q + 20.0 * gq_el)
    gq_y = ss._synthesis_reference(gm_q * torch.cos(gp_q), gm_q * torch.sin(gp_q), q_rt.inv_window, float(ov_q),
                                   n_fft_q, hop_q, gq_tp)

    def lib_polish_q():
        for _ in range(gq_iters):
            lib_proj_synth_q()
            fr = gq_y.unfold(-1, n_fft_q, hop_q)[:, g_ctx:gq_tx] * q_rt.window
            torch.angle(torch.fft.rfft(fr, n=n_fft_q))
    # O's polish (phase 4g's shape, the grid of gl_context 3 + 16 frames and 3
    # zero frames, 64 sessions, gl_iterations 16 projections in one launch).
    # What the function needs: the grid's magnitudes and phases read once and
    # the polished rows' phases written once; per projection the synthesis's
    # and the analysis's operations as the Osyn and Oana rows count them.  Its
    # design: per projection frames_irfft of the Tp + overlap - 1 frames from
    # -(overlap - 1) (the decode's pairs) and frames_rfft of the polished
    # rows, sincos and two products per grid bin (22), an atan2 (20) per
    # written bin.  Yardstick: gl_iterations times the two projection
    # yardsticks below.
    g_iters = g_rt.gl_iterations
    g_pol = gp.clone()
    pol_frames = g_tp + ov - 1
    pol_pairs = sum((pol_frames - 1 - c) // (2 * ov) + 1 for c in range(ov))
    pol_design = g_iters * (fft_design_flops(N_FFT, 2 * SB * pol_pairs) + fft_design_flops(N_FFT, 2 * SB * -(-g_rows // 2))
                            + 22.0 * SB * g_tp * F + 20.0 * g_el)
    pol_need = g_iters * (2.5 * N_FFT * math.log2(N_FFT) * (g_fr + SB * g_upd) + N_FFT * (g_fr + SB * g_upd)
                          + 22.0 * g_fr * F + 20.0 * g_el)

    def lib_polish():
        for _ in range(g_iters):
            lib_proj_synth()
            lib_proj_analysis()
    s_m, s_prev, s_pp, s_a = (gl_stream[k] for k in ("m", "prev", "pp", "a"))
    s_tt = s_m.shape[1]
    rs_args = (g_rt.gamma, N_FFT, HOP, g_rt.tolerance, s_tt)
    s_silent = (s_m <= torch.clamp_min(g_rt.tolerance * s_m.amax(dim=(1, 2), keepdim=True), 1.19e-7)).float()
    s_silent = s_silent.mean().item()
    specs += [
        dict(key="Osyn", name="gl_project_synthesis", source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="fft",
             replaces=stream_tpu + ":940", launches=counts["gl_project_synthesis:fft"],
             run=lambda: ss._launch_decode(gm_f, gp_f, gf_ops, gf_n, gf_hop, rows=ss.PROJECT_SYN_ROWS,
                                           name="gl_project_synthesis"),
             plain=lambda: ss._synthesis_reference(gm_f * torch.cos(gp_f), gm_f * torch.sin(gp_f), gf_win,
                                                   float(gf_ov), gf_n, gf_hop, gf_tp),
             library=lib_proj_synth_f,
             bound=bound_of(8.0 * gf_fr * gf_F + 4.0 * SB * (gf_tp - gf_ctx) * gf_hop,
                            2.5 * gf_n * math.log2(gf_n) * gf_fr + gf_n * gf_fr + 22.0 * gf_fr * gf_F),
             ceiling=ceiling_of(fft_design_flops(gf_n, SB * gf_tiles * (gf_rows_syn + 2 * gf_ov))
                                + 22.0 * gf_fr * gf_F)),
        dict(key="Osyn_smooth", name="gl_project_synthesis_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":940", launches=counts["gl_project_synthesis:smooth"],
             run=lambda: ss._launch_decode(gm_q, gp_q, gq_ops, n_fft_q, hop_q, rows=ss.PROJECT_SYN_ROWS,
                                           name="gl_project_synthesis"),
             plain=lambda: ss._synthesis_reference(gm_q * torch.cos(gp_q), gm_q * torch.sin(gp_q), q_rt.inv_window,
                                                   float(ov_q), n_fft_q, hop_q, gq_tp),
             library=lib_proj_synth_q,
             bound=bound_of(8.0 * gq_fr * F_q + 4.0 * SB * (gq_tp - g_ctx) * hop_q,
                            2.5 * n_fft_q * math.log2(n_fft_q) * gq_fr + n_fft_q * gq_fr + 22.0 * gq_fr * F_q),
             ceiling=ceiling_of(smooth_design_flops(n_fft_q, SB * -(-gq_tp // gq_rows_syn) * (gq_rows_syn + 2 * ov_q))
                                + 22.0 * gq_fr * F_q)),
        dict(key="Osyn_smooth7", name="gl_project_synthesis_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":940", launches=counts["gl_project_synthesis:smooth7"],
             run=lambda: ss._launch_decode(gm_x, gp_x, gx_ops, n_fft_x, hop_x, rows=ss.PROJECT_SYN_ROWS,
                                           name="gl_project_synthesis"),
             plain=lambda: ss._synthesis_reference(gm_x * torch.cos(gp_x), gm_x * torch.sin(gp_x), x_rt.inv_window,
                                                   float(ov_x), n_fft_x, hop_x, gx_tp),
             library=lib_proj_synth_x,
             bound=bound_of(8.0 * gx_fr * F_x + 4.0 * SB * (gx_tp - g_ctx) * hop_x,
                            2.5 * n_fft_x * math.log2(n_fft_x) * gx_fr + n_fft_x * gx_fr + 22.0 * gx_fr * F_x),
             ceiling=ceiling_of(smooth_design_flops(n_fft_x, SB * -(-gx_tp // gx_rows_syn) * (gx_rows_syn + 2 * ov_x))
                                + 22.0 * gx_fr * F_x), resources=seven_res["P"]),
        dict(key="Osyn_product", name="gl_project_synthesis_product", source=stream_src + " (+ csrc/synth_ola.cuh)",
             front_end="product", replaces=stream_tpu + ":940", launches=counts["gl_project_synthesis:product"],
             run=lambda: ss._launch_decode(gm_z, gp_z, gz_ops, n_fft_z, hop_z, rows=ss.PROJECT_SYN_ROWS,
                                           name="gl_project_synthesis"),
             plain=lambda: ss._synthesis_reference(gm_z * torch.cos(gp_z), gm_z * torch.sin(gp_z), z_rt.inv_window,
                                                   float(ov_z), n_fft_z, hop_z, gz_tp),
             library=lib_proj_synth_z,
             bound=bound_of(8.0 * gz_fr * F_z + 4.0 * SB * (gz_tp - g_ctx) * hop_z,
                            2.5 * n_fft_z * math.log2(n_fft_z) * gz_fr + n_fft_z * gz_fr + 22.0 * gz_fr * F_z),
             ceiling=ceiling_of(2.0 * SB * -(-gz_tp // 8) * 8 * ov_z * ss._k_padded(F_z) * hop_z + 22.0 * gz_fr * F_z)),
        dict(key="Opol", name="gl_polish", source=stream_src + " (+ csrc/fft_smem.cuh)", front_end="fft",
             replaces=stream_tpu + ":940", launches=counts["gl_polish:fft"],
             run=lambda: ss.gl_polish(gm, g_pol, g_syn, g_rt.inv_window, g_rt.window, None, None, N_FFT, HOP, g_ctx,
                                      g_lo, g_hi, g_iters),
             plain=lambda: ss.gl_polish_reference(gm, gp, g_rt.inv_window, g_rt.window, N_FFT, HOP, g_ctx, g_lo,
                                                  g_hi, g_iters),
             library=lib_polish, bound=bound_of(8.0 * g_fr * F + 4.0 * g_el, pol_need),
             ceiling=ceiling_of(pol_design)),
        dict(key="Opol_smooth", name="gl_polish_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":940", launches=counts["gl_polish:smooth"],
             run=lambda: ss.gl_polish(gm_q, gq_pol, gq_ops, q_rt.inv_window, q_rt.window, None, None, n_fft_q, hop_q,
                                      g_ctx, gq_lo, gq_hi, gq_iters),
             plain=lambda: ss.gl_polish_reference(gm_q, gp_q, q_rt.inv_window, q_rt.window, n_fft_q, hop_q, g_ctx,
                                                  gq_lo, gq_hi, gq_iters),
             library=lib_polish_q, bound=bound_of(8.0 * gq_fr * F_q + 4.0 * gq_el, polq_need),
             ceiling=ceiling_of(polq_design),
             resources=kp_res.get("O resident" if gq_plan[1] else "O device")),
        dict(key="Opol_smooth7", name="gl_polish_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":940", launches=counts["gl_polish:smooth7"],
             run=lambda: ss.gl_polish(gm_x, gx_pol, gx_ops, x_rt.inv_window, x_rt.window, None, None, n_fft_x, hop_x,
                                      g_ctx, gx_lo, gx_hi, gx_iters),
             plain=lambda: ss.gl_polish_reference(gm_x, gp_x, x_rt.inv_window, x_rt.window, n_fft_x, hop_x, g_ctx,
                                                  gx_lo, gx_hi, gx_iters),
             library=lib_polish_x, bound=bound_of(8.0 * gx_fr * F_x + 4.0 * gx_el, polx_need),
             ceiling=ceiling_of(polx_design),
             resources=o_res["O seven resident" if gx_plan[1] else "O seven device"], old=polish_x_old),
        dict(key="Oana", name="gl_project_analysis", source=stream_src, front_end="product",
             replaces=stream_tpu + ":940", launches=counts["gl_project_analysis:product"],
             run=lambda: ss._launch_project_analysis(gz_y, gz_scratch, (gz_wc, gz_ws), n_fft_z, hop_z, gz_tx, g_ctx,
                                                     gz_lo, gz_hi),
             plain=plain_proj_analysis_z,
             library=lambda: torch.angle(torch.fft.rfft(gz_y.unfold(-1, n_fft_z, hop_z)[:, g_ctx:gz_tx] * z_rt.window,
                                                        n=n_fft_z)),
             bound=bound_of(gz_samples + 4.0 * gz_el,
                            2.5 * n_fft_z * math.log2(n_fft_z) * SB * gz_upd + n_fft_z * SB * gz_upd + 20.0 * gz_el),
             ceiling=ceiling_of(gz_ana_flops + 20.0 * gz_el)),
        dict(key="Oana_fft", name="gl_project_analysis_fft", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="fft", replaces=stream_tpu + ":940", launches=counts["gl_project_analysis:fft"],
             resources=o_res["Oana fft"], **ana_f),
        dict(key="Oana_smooth", name="gl_project_analysis_smooth", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":940", launches=counts["gl_project_analysis:smooth"],
             resources=o_res["Oana smooth"], **ana_s),
        dict(key="Oana_smooth7", name="gl_project_analysis_smooth7", source=stream_src + " (+ csrc/fft_smem.cuh)",
             front_end="smooth", replaces=stream_tpu + ":940", launches=counts["gl_project_analysis:smooth7"],
             resources=o_res["Oana seven"], **ana_x),
        dict(key="RTs", name="rt_pghi_seeded", source="acids_transforms_tpu_torch/csrc/pghi.cu",
             replaces=stream_tpu + ":668", launches=counts["rt_pghi_seeded"],
             run=lambda: ss._launch_rt_pghi(s_m, s_a, *rs_args, s_prev, s_pp),
             plain=lambda: ss.rt_pghi_phases_reference(s_m, s_a, *rs_args, prev_mag=s_prev, prev_phase=s_pp),
             library=None,
             bound=bound_of(4.0 * SB * s_tt * F * (2.0 + s_silent) + 12.0 * SB * F, 150.0 * SB * s_tt * F),
             ceiling=ceiling_of(150.0 * SB * s_tt * F)),
    ]
    log(f"  RT-PGHI recurrence: {100 * rt_silent:.1f}% of the bins silent (angles read there); seeded, one "
        f"chunk: {100 * s_silent:.1f}%")
    sm_mhz = max_sm_clock_mhz()
    for key, n_steps in (("RT", rt_mag.shape[1] + rt_mag.shape[1] // (STREAM_CHUNK // HOP) - 1), ("RTs", s_tt)):
        log(f"  {key} chain floor (model): {n_steps} serial steps x {RT_STEP_CYCLES} cycles at {sm_mhz} MHz = "
            f"{1e3 * n_steps * RT_STEP_CYCLES / (sm_mhz * 1e6):.4f} ms")
    for key, n_steps in (("K_walk", Tn), ("K_bidir", Tn // 2 + 1)):
        log(f"  {key} chain floor (model): {n_steps} serial steps x {K_STEP_CYCLES} cycles at {sm_mhz} MHz = "
            f"{1e3 * n_steps * K_STEP_CYCLES / (sm_mhz * 1e6):.4f} ms")
    # A at phase 4i's MFCC shape: the rectangular bank (128 mels, mel 0
    # empty), power 2, no contrast.  What the function needs: the mono clips
    # read and the (B, T, 128) mels written once; an FFT a frame, the window,
    # the power (3 a bin) and 2 a nonzero of the bank.  Library: torch.stft,
    # abs() ** 2 and one product with the bank.
    bank_m, nnz_m = base["bank"], int((base["bank"] != 0).sum().item())
    kw_m = dict(mel_bank=bank_m, offset=0.0, scale=1.0, contrast="none", taps=base["taps"], power=2.0)

    def lib_mfcc():
        S = torch.stft(mono, N_FFT, HOP, window=window, center=True, pad_mode="reflect", return_complex=True)
        return torch.matmul(S.abs().pow(2).transpose(-2, -1), bank_m)

    specs.append(dict(
        key="A_mfcc", name="fused_melspec_mfcc", front_end="fft",
        source="acids_transforms_tpu_torch/csrc/spectral.cu (+ csrc/fft_smem.cuh)",
        replaces="acids_transforms_tpu/ops/pallas/spectral.py:732",
        launches=counts["fused_melspec_mfcc:fft"],
        run=lambda: spectral.fused_melspec(mono, N_FFT, HOP, **kw_m),
        plain=lambda: spectral.fused_melspec_reference(mono, N_FFT, HOP, **kw_m),
        library=lib_mfcc,
        bound=bound_of(4.0 * B * L + 4.0 * B * Tn * bank_m.shape[1] + 4.0 * bank_m.numel(),
                       fft_flops + B * Tn * (N_FFT + 3.0 * F + 2.0 * nnz_m)),
        ceiling=ceiling_of(fft_design_flops(N_FFT, B * Tn) + 3.0 * B * Tn * F + 2.0 * B * Tn * nnz_m)))
    kernels = []
    for s in specs:
        # turns: plain, kernel, plain; each time is the card's per call in
        # runs of calls back to back (device_ms), so that the host's enqueue
        # (0.2-1.2 ms a call of A, with the row preparation, varying with the
        # host's load) hides behind the card's work as it does on the paths
        # (a plain version that is a Python loop over frames takes seconds:
        # it runs once per turn, without warm-up); the kernel and the library
        # call are also timed one call alone (time_ms), host time included,
        # as phase 5 timed every row before it timed back to back, so that the
        # host's time stays visible
        p_rep, p_warm, p_runs = (1, 0, 1) if s.get("plain_once") else (max(1, args.repeats // 2), 2, 3)
        l_rep = max(1, args.repeats // 2)
        p1 = device_ms(s["plain"], p_rep, p_warm, p_runs)
        k_ms = device_ms(s["run"], args.repeats)
        k_single = time_ms(s["run"], args.repeats)
        p2 = device_ms(s["plain"], p_rep, p_warm, p_runs)
        l_ms = None if s["library"] is None else device_ms(s["library"], l_rep)
        l_single = None if s["library"] is None else time_ms(s["library"], l_rep)
        b_ms, b_by = s["bound"]
        row = dict(name=s["name"], route="cuda", source=s["source"], replaces=s["replaces"],
                   launches=s["launches"], max_abs_err=errs[s["key"]], ms=k_ms, kernel_ms=k_ms,
                   plain_ms=0.5 * (p1 + p2), bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                   design_fma_ceiling_ms=s["ceiling"], single_call_ms=k_single,
                   library_single_call_ms=l_single)
        if "front_end" in s:
            row["front_end"] = s["front_end"]
        if "resources" in s:             # the instance's -Xptxas -v figures
            row["registers"] = s["resources"]["registers"]
            row["spill_bytes"] = s["resources"].get("spill_stores", 0) + s["resources"].get("spill_loads", 0)
        kernels.append(row)
        front = f" [{s['front_end']} route]" if "front_end" in s else ""
        ratio = "" if l_ms is None else f", {k_ms / l_ms:.2f}x the library"
        single = f"; one call alone {k_single:.3f} ms" + (
            "" if l_single is None else f", the library's {l_single:.3f} ms")
        # figures from the plan or a model, not measured: the log line only
        extra = "".join(f"; {k} {v:.3f}" for k, v in s.get("extra", {}).items())
        if "resources" in s:
            extra += f"; {row['registers']} registers, {row['spill_bytes']} B spilled"
        log(f"  {s['key']} {s['name']}{front}: {k_ms:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {'none' if l_ms is None else format(l_ms, '.3f') + ' ms'}{ratio}, bound {b_ms:.3f} ms by "
            f"{b_by} ({100 * b_ms / k_ms:.1f}% of it reached); fp32 ceiling of this design "
            f"{s['ceiling']:.3f} ms ({100 * s['ceiling'] / k_ms:.1f}%){single}{extra}")

    # O's new instances in turns with the route their shape took before (the
    # analysis's product instance at the same shape; at 1344/336 the polish's
    # gl_iterations two-launch projections with it) and with the library
    # yardstick: 5 rounds, each the card's time a call with 20 calls queued
    # behind a sleep kernel (host_and_device_ms), in the order old, new,
    # library, then back; medians.  A call of thousands of small launches (the
    # polish's yardstick) fills the launch queue behind the sleep, and the
    # host then waits for the card: such a turn is timed back to back
    # (device_ms) instead and marked "b2b".  The yardstick's median replaces
    # its back-to-back time in the row (its spread between calls reached
    # 2.4-4x at these small grids), which stays beside it as library_b2b_ms
    for s in specs:
        if "old" not in s:
            continue
        turns = {"old": [], "new": [], "library": []}
        b2b = set()
        order = (("old", s["old"]), ("new", s["run"]), ("library", s["library"]))
        for rnd in range(5):
            for k, fn in (order if rnd % 2 == 0 else order[::-1]):
                t = host_and_device_ms(fn, 20)[1]
                if t is None:
                    b2b.add(k)
                    t = device_ms(fn, 5, 1, 1)
                turns[k].append(t)
        med = {k: statistics.median(v) for k, v in turns.items()}
        row = next(r for r in kernels if r["name"] == s["name"])
        row["library_b2b_ms"], row["library_ms"], row["turns_ms"] = row["library_ms"], med["library"], med
        if "old_ceiling" in s:
            row["old_design_fma_ceiling_ms"] = s["old_ceiling"]

        def fmt(k):
            return " / ".join(f"{v:.4f}" for v in turns[k]) + (" (b2b)" if k in b2b else "")
        log(f"  {s['key']} in turns with the route before and the library, 5 rounds behind a sleep kernel (card ms a "
            f"call): old {fmt('old')}; new {fmt('new')}; library {fmt('library')}; medians old {med['old']:.4f}, new "
            f"{med['new']:.4f}, library {med['library']:.4f}")

    # A through the registered operator against the direct wrapper, in turns
    # (direct, operator, ...), each back to back and one call alone: what the
    # dispatcher adds to a call
    a_turns = {"direct": [], "op": [], "direct_single": [], "op_single": []}
    for _ in range(3):
        for k, fn in (("direct", lambda: spectral.fused_melspec(mono, N_FFT, HOP, **kw)),
                      ("op", lambda: spectral.fused_melspec_op(mono, N_FFT, HOP, **kw))):
            a_turns[k].append(device_ms(fn, args.repeats))
            a_turns[k + "_single"].append(time_ms(fn, args.repeats))
    a_med = {k: statistics.median(v) for k, v in a_turns.items()}
    op_row = next(r for r in kernels if r["name"] == "fused_melspec_op")
    op_row["direct_ms"], op_row["direct_single_call_ms"] = a_med["direct"], a_med["direct_single"]
    log(f"  A through the operator against the direct launch, 3 turns: b2b {a_med['op']:.4f} / {a_med['direct']:.4f} "
        f"ms ({100 * (a_med['op'] / a_med['direct'] - 1):+.1f}%), one call alone {a_med['op_single']:.4f} / "
        f"{a_med['direct_single']:.4f} ms ({a_med['op_single'] - a_med['direct_single']:+.4f} ms)")
    h_op, _ = host_and_device_ms(lambda: spectral.fused_melspec_op(mono, N_FFT, HOP, **kw), 20)
    h_dir, _ = host_and_device_ms(lambda: spectral.fused_melspec(mono, N_FFT, HOP, **kw), 20)
    log(f"  A's host enqueue a call: through the operator {h_op:.4f} ms, direct {h_dir:.4f} ms")

    # E and F on the smooth route under every plan: the rule's pick against
    # the fastest (reported, not gated: run-to-run noise is a few %)
    sweep = smooth_plan_sweep(mono, args.repeats)
    for shape, r in sweep.items():
        log(f"  smooth plan sweep {shape} (E + F b2b, ms; tile x FFTs, KB, blocks an SM): " + "; ".join(
            f"{p['tile']} x {p['teams']} ({p['smem_kb']:.1f} KB, {p['blocks']}) {p['e_ms']:.3f} + {p['f_ms']:.3f}"
            for p in r["rows"]) + f"; the rule's pick {r['pick']} {100 * r['over']:+.1f}% over the best {r['best']}")
    # R, L / M and P / S on the smooth route's radix-7 instances under every
    # plan (reported, not gated), and the registers and spill of every
    # mixed-radix instance of the build
    for shape, r in seven_plan_sweep(sx, args.repeats).items():
        log(f"  radix-7 plan sweep {shape}, {SB} sessions x {r['frames']} frames: R (b2b ms; frames x FFTs, KB, "
            f"blocks an SM) " + "; ".join(
                f"{p['rows']} x {p['teams']} ({p['smem_kb']:.1f} KB, {p['blocks']}) {p['ms']:.3f}" for p in r["encode"])
            + f"; the rule's pick {r['pick_e']} {100 * r['over_e']:+.1f}% over the best {r['best_e']}")
        log(f"  radix-7 plan sweep {shape}: L / M (b2b ms; chunks x FFTs, KB, blocks an SM) " + "; ".join(
            f"{p['rows']} x {p['teams']} ({p['smem_kb']:.1f} KB, {p['blocks']}) {p['l_ms']:.3f} / {p['m_ms']:.3f}"
            for p in r["roundtrip"]) + f"; the rule's pick {r['pick_r']} {100 * r['over_r']:+.1f}% over the best "
            f"{r['best_r']}")
        log(f"  radix-7 plan sweep {shape}: P / S (b2b ms; chunks x FFTs, KB, blocks an SM) " + "; ".join(
            f"{p['rows']} x {p['teams']} ({p['smem_kb']:.1f} KB, {p['blocks']}) {p['p_ms']:.3f} / {p['s_ms']:.3f}"
            for p in r["decode"]) + f"; the rule's pick {r['pick_d']} {100 * r['over_d']:+.1f}% over the best "
            f"{r['best_d']}")
    for name, res in smooth_instance_resources(_build.kernel_resources()).items():
        log(f"  mixed-radix instance {name}: {res.get('registers')} registers, spill stores / loads "
            f"{res.get('spill_stores', 0)} / {res.get('spill_loads', 0)} B")

    # G and H full-K on the smooth route and its radix-7 instance under every
    # plan (reported, not gated)
    def opt_ms(v):
        return "-" if v is None else f"{v:.3f}"

    for label, r in repr_plan_sweep(mono, args.repeats).items():
        log(f"  G / H smooth plan sweep {label} (G / H b2b ms; tile x FFTs, G's / H's KB): " + "; ".join(
            f"{p['tile']} x {p['teams']} ({p['g_kb']:.1f} / {p['h_kb']:.1f} KB) {opt_ms(p['g_ms'])} / "
            f"{opt_ms(p['h_ms'])}" for p in r["rows"]) + "; " + "; ".join(
            f"{k.upper()}: the rule's pick {r[k]['pick']} {100 * r[k]['over']:+.1f}% over the best {r[k]['best']}"
            for k in ("g", "h")))
    # C, D, I and J at 768 on the product instance against the smooth one, in
    # turns (reported, not gated): what the smooth route changed
    turns = gl_route_turns(mono, args.repeats)
    log("  GL product vs smooth instance at 768/192 (C, D, I) and 768/256 (J), in turns product, smooth, smooth, "
        "product (b2b ms): " + "; ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in turns[('product', k)])} -> "
            f"{' / '.join(f'{v:.3f}' for v in turns[('smooth', k)])}" for k in "CDIJ"))
    # C and J on the smooth route under every plan, J on its radix-7
    # instance too (reported, not gated)
    for label, r in gl_plan_sweep(mono, args.repeats).items():
        log(f"  GL smooth plan sweep {label} (b2b ms; frames x FFTs): " + "; ".join(
            f"{p['tile']} x {p['teams']} {p['ms']:.3f}" for p in r["rows"])
            + f"; the rule's pick {r['pick']} {100 * r['over']:+.1f}% over the best {r['best']}")

    # K's synthesis and O's polish on the product / two-launch route against
    # the smooth one, in turns (reported, not gated): what the smooth route
    # changed; then under every plan (reported, not gated)
    kp_turns = k_polish_route_turns(mono, SB, args.repeats, dev)
    log("  K product vs smooth instance at 768/256 and 1200/300, O's 16 two-launch projections vs the smooth polish "
        "at 1200/300, in turns old, new, new, old (b2b ms): " + "; ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in old)} -> {' / '.join(f'{v:.3f}' for v in new)}"
            for k, (old, new) in ((k, tuple(t.values())) for k, t in kp_turns.items())))
    for shape, r in k_synth_plan_sweep(mono, args.repeats).items():
        log(f"  K smooth plan sweep {shape} (b2b ms; chunks x FFTs): " + "; ".join(
            f"{p['rows']} x {p['teams']} {p['ms']:.3f}" for p in r["rows"])
            + f"; the rule's pick {r['pick']} {100 * r['over']:+.1f}% over the best {r['best']}")
    for shape, r in polish_plan_sweep(SB, args.repeats, dev).items():
        log(f"  O polish smooth plan sweep {shape}, {SB} sessions, {r['tp']} grid frames (b2b ms; FFTs, grid in "
            f"shared memory): " + "; ".join(f"{p['teams']}, {p['resident']} {p['ms']:.3f}" for p in r["rows"])
            + f"; the rule's pick {r['pick']} {100 * r['over']:+.1f}% over the best {r['best']}")

    # O's host share: a chunk's polish (one launch) and, for the grids the
    # polish does not take, a projection's two launches, enqueued back to
    # back behind a sleep kernel, so that the card never waits for the host
    # while the host's time is taken
    for b in (1, SB):
        mb, pb = gm[:b].contiguous(), gp[:b].clone()
        h_ms, d_ms = host_and_device_ms(
            lambda: ss.gl_polish(mb, pb, g_syn, g_rt.inv_window, g_rt.window, None, None, N_FFT, HOP, g_ctx, g_lo,
                                 g_hi, g_iters), 20)
        log(f"  O polish at B={b}: host {h_ms:.4f} ms a chunk ({g_iters} projections, one launch) to enqueue, card "
            f"{'not isolated' if d_ms is None else format(d_ms, '.4f') + ' ms'} a chunk back to back")
        h_ms, d_ms = host_and_device_ms(
            lambda: ss.gl_project(mb, pb, g_syn, g_rt.inv_window, g_rt.window, g_wc, g_ws, N_FFT, HOP,
                                  g_ctx, g_lo, g_hi), 100)
        log(f"  O two-launch projection at B={b}: host {h_ms:.4f} ms a projection to enqueue, card "
            f"{'not isolated' if d_ms is None else format(d_ms, '.4f') + ' ms'} a projection back to back")

    # J at 4096/512 (the FFT route; its product block needed slabs of the
    # synthesis rows), on the main path's clips: one step, kernel and plain
    # version
    w_4k = gaussian_dgt_window(4096, device=dev)
    mag_4k = att.ops.stft(mono, 4096, 512, w_4k).abs()
    j4, _, _ = glstep.make_gl_momentum_step_fullk(mag_4k, 4096, 512, w_4k, mom)
    g4 = torch.Generator(device=dev).manual_seed(args.seed + 52)
    ph4 = 2 * math.pi * torch.rand(mag_4k.shape, generator=g4, device=dev)
    st4 = (torch.cos(ph4), torch.sin(ph4), torch.zeros_like(ph4), torch.zeros_like(ph4))
    env4 = glstep._env_rows(mag_4k.shape[1], 4096, 512, w_4k)
    j4_ms = time_ms(lambda: j4(*st4), args.repeats)
    j4_plain = time_ms(lambda: glstep.gl_momentum_step_fullk_reference(mag_4k, *st4, env4, 4096, 512, w_4k, mom),
                       max(1, args.repeats // 2))
    log(f"  J at 4096/512 ({tuple(mag_4k.shape)}, {glstep._fullk_plan(4096, 512)}): {j4_ms:.3f} ms, "
        f"plain {j4_plain:.3f} ms")
    del mag_4k, ph4, st4, env4

    inv_ms = time_ms(whole_inversion, args.repeats)
    whole_b, whole_by = bound_of(4.0 * n_el * (1.0 + silent) + 4.0 * n_audio, synth_need + 150.0 * n_el)
    log(f"  K pghi_invert_fused (phases then synthesis, envelope division and trim included): "
        f"{inv_ms:.3f} ms; the function's bound (magnitudes and the silent bins' angles read, "
        f"{100 * silent:.1f}% of bins, audio written) {whole_b:.3f} ms by {whole_by}")
    for label, (e_p64, e_k64, d_ph, ph_max) in errs.get("K_f64", {}).items():
        log(f"  K float32 against the float64 recurrence, {label}: mag * e^(i phase) off by "
            f"{e_p64:.3e} (plain) / {e_k64:.3e} (kernel) of the largest magnitude; phases off by up to "
            f"{d_ph:.3g} rad of {ph_max:.3g}")
    sweep_phase(args, dev, mono, bank, off, scl, taps_main, kernels, bound_of,
                (spectral, glstep, pghi_kernel, ss))
    # every row's kernel ran on a path of this run, except I's (no caller)
    idle = [r["name"] for r in kernels
            if r["launches"] < 1 and r["name"] not in ("gl_project", "gl_project_smooth", "gl_project_product")]
    require(not idle, f"kernels launched no time on their paths: {idle}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
