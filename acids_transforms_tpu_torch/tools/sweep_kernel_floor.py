"""Stage-by-stage floor sweep of kernel A, the fused log-mel forward, on the card.

    python -m acids_transforms_tpu_torch.tools.sweep_kernel_floor [--batch 128] [--iters 50] [--seed 0]

It measures A's chunk-factored design, the front end the public forward
keeps where n_fft is no power of two (at 1024/256 the forward takes the
FFT route, ``ops/cuda/spectral.py:_kernel_plan``).  Builds A up stage by stage, each stage a kernel of its own with A's grid,
threads and shared memory (``ops/cuda/spectral.py:melspec_forward_stage``,
kernel T of ``csrc/spectral.cu``), and times each on the same prepared rows,
so that each increment is the time that stage adds to A; a cut inside the
one kernel could be hidden by the compiler's scheduling.  Stages:

  s0_copy        read the block, write zeros plus its first sample
  s1_dots        + the chunk product (fp32 FMA, as A)
  s2_dots3       absent: A's product is one fp32 pass, there is no bf16x3 to time
  s3_combine     + the twiddle combine, centre tap only, power
  s4_taps        + the neighbour taps, power
  s5_mag         + sqrt
  s6_mel_banded  + the banded mel product
  s7_full        + log1p and the affine (A itself)
  s8_mel_dense   s6 with the dense mel product

The shape is the JAX package's headline: ``--batch`` rows of one 4 s
additive signal at 44.1 kHz (four partials, start phases drawn from
``--seed``), n_fft 1024, hop 256, hann through its cosine taps, the square
mel bank, float32.  Prints per stage the cumulative time (CUDA events over
``--iters`` launches back to back, median of 5 runs), the increment over the
stage it adds to, M frames/s, the host's time to enqueue one launch, and the
registers and spills ``ptxas`` reported; returns the rows.  The kernels are
built from the package's sources at first use.  It needs a CUDA device:
there is no CPU mode.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .._device import resolve_device
from ..ops.cuda import _build, spectral
from ..ops.fft import taps_for_window
from ..ops.mel import square_mel_banks
from ..ops.windows import get_window

N_FFT, HOP, SR = 1024, 256, 44100
SECONDS = 4.0
BATCH = 128
RUNS = 5
ITERS = 50

#: stage -> the stage whose time it adds to (s8 replaces s6's banded product)
BASE = {"s1_dots": "s0_copy", "s3_combine": "s1_dots", "s4_taps": "s3_combine",
        "s5_mag": "s4_taps", "s6_mel_banded": "s5_mag", "s7_full": "s6_mel_banded",
        "s8_mel_dense": "s5_mag"}
#: why the JAX tool's s2_dots3 (a bf16x3 chunk product) has no stage here
S2_ABSENT = "A's chunk product is one fp32 pass with no bf16 split; nothing is timed in its place"


def additive_signal(length: int, seed: int) -> np.ndarray:
    """Four partials (220, 440, 660, 880 Hz at 1 / (i + 1)), start phases
    drawn from ``seed``, peak 0.5, float32."""
    t = np.arange(length) / SR
    phases = np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi, 4)
    x = sum(np.sin(2 * np.pi * f * t + p) / (i + 1)
            for i, (f, p) in enumerate(zip((220, 440, 660, 880), phases)))
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def time_launches(fn, iters: int):
    """Per launch of ``fn``: the card's time (CUDA events over ``iters``
    launches back to back, median of ``RUNS``) and the host's time to
    enqueue one (median), in ms."""
    fn()
    torch.cuda.synchronize()
    card, host = [], []
    for _ in range(RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append(1e3 * (time.perf_counter() - t0) / iters)
        e1.record()
        e1.synchronize()
        card.append(e0.elapsed_time(e1) / iters)
    return statistics.median(card), statistics.median(host)


def stage_resources() -> Dict[int, Dict[str, int]]:
    """``ptxas``'s registers and spills of each stage's instantiation."""
    out = {}
    for name, res in _build.kernel_resources().items():
        if "melspec_stage_kernelILi" in name:
            out[int(name.split("melspec_stage_kernelILi")[1].split("E")[0])] = res
    return out


def sweep(batch: int = BATCH, iters: int = ITERS, seed: int = 0) -> List[dict]:
    """Time every stage at the headline shape on the current CUDA device;
    print and return the rows."""
    if not torch.cuda.is_available():
        raise RuntimeError("the floor sweep times kernels on a CUDA device and none is "
                           "available; it has no CPU mode")
    dev = resolve_device(None)
    length = int(SECONDS * SR)
    x = torch.as_tensor(additive_signal(length, seed), device=dev).expand(batch, length).contiguous()
    taps = taps_for_window(get_window("hann", N_FFT))
    bank = torch.as_tensor(square_mel_banks(N_FFT, SR)[0], dtype=torch.float32, device=dev)
    offset, scale = torch.zeros((), device=dev), torch.ones((), device=dev)
    tile_t = spectral._kernel_tile(N_FFT, HOP, taps)
    rows, n_frames, n_tiles = spectral._prepare_rows(x, N_FFT, HOP, True, tile_t)
    _build.load_library()
    res = stage_resources()
    frames = batch * n_frames
    print(f"device={torch.cuda.get_device_name(dev)} rows={tuple(rows.shape)} frames={n_frames} "
          f"tile_t={tile_t} grid={batch}x{n_tiles} threads=256 shared="
          f"{spectral._smem_bytes(tile_t, HOP, N_FFT // HOP, N_FFT // 2 + 1)} B", flush=True)
    out: List[dict] = []
    by_name: Dict[str, float] = {}
    for name, s in spectral.STAGES.items():
        if name == "s3_combine":
            print(f"s2_dots3: absent ({S2_ABSENT})", flush=True)
        ms, host_ms = time_launches(
            lambda: spectral.melspec_forward_stage(rows, name, N_FFT, HOP, n_frames, taps, bank,
                                                   offset, scale), iters)
        by_name[name] = ms
        over = BASE.get(name)
        r = res.get(s, {})
        row = dict(stage=name, ms=ms, over=over,
                   increment_ms=ms - by_name[over] if over else ms,
                   mframes_per_s=frames / ms / 1e3, host_ms=host_ms,
                   registers=r.get("registers"),
                   spill_bytes=(r["spill_stores"] + r["spill_loads"]) if "spill_stores" in r else None)
        out.append(row)
        regs = "not in the build log" if row["registers"] is None else (
            f"{row['registers']} registers, {row['spill_bytes']} B spilled")
        print(f"{name}: {ms:.3f} ms  (+{row['increment_ms']:.3f} over {over or 'nothing'})  "
              f"{row['mframes_per_s']:.2f} M frames/s  host {host_ms:.4f} ms a launch  {regs}",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH, help="rows of 4 s")
    ap.add_argument("--iters", type=int, default=ITERS, help="launches back to back per timed run")
    ap.add_argument("--seed", type=int, default=0, help="draws the partials' start phases")
    args = ap.parse_args(argv)
    sweep(args.batch, args.iters, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
