"""Whole-iteration momentum Griffin-Lim step (twin of the JAX
``ops/pallas/glstep.py``, chunk-factored momentum entries).

One invocation runs ``iters`` full iterations: consistency projection
``STFT(ISTFT(mag * angles))`` with the chunk factorization both ways, momentum
extrapolation and phase renormalization,

    Y = taps_conv(mag . angles);  D[c] = sum_j conj(tw_j) Y[c - j]
    samples[c] = D[c] @ (restricted inverse basis) / envelope[c]
    C[c] = samples[c] @ (chunk basis);  X[t] = sum_j tw_j C[t + j]
    R = taps_conv(X);  u = R - mom * tprev;  angles = u / max(|u|, 1e-16)

Boundary semantics (those of the JAX kernel): the projection works on the
un-trimmed overlap-add signal (length ``(T-1) hop + n_fft``) re-framed in
place; spectrogram rows outside ``[0, T)`` are zero; the envelope is the
overlap-add of the squared synthesis window over the true ``T`` frames, one
outside the signal.  Interior frames equal the torch-convention trim +
reflect re-pad; the ``overlap - 1`` edge frames differ, so parity with the
eager loop is spectral convergence, not bit-equality.  The imaginary part of
``angles`` at the nyquist bin is ignored (a real signal has none there); at
DC it enters the taps conv like any other bin, as in the JAX kernel.

The edge samples are also where this formulation is least accurate: the
window is applied in the spectral domain, so a sample where the window is
``w`` comes out of a sum that cancels to ``w`` times its terms and is then
divided by the envelope ``w^2``.  Over the first and last few samples of the
signal (hann: ``w ~ 4e-5`` at n_fft 512) the rounding of the sum is amplified
accordingly, in the first and last frame only.

On CUDA tensors the step launches ``csrc/glstep.cu`` (or raises); on CPU
tensors it runs :func:`gl_momentum_step_reference`, the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from ..fft import (
    _chunk_dft_matrices,
    _hermitian_weights,
    _tables,
    _taps_conv,
    _twiddle_analysis,
    _twiddle_synthesis,
    _twiddles,
)
from ..framing import overlap_add
from . import _build

__all__ = [
    "make_gl_momentum_step",
    "gl_momentum_step_reference",
    "gl_momentum_step_oracle",
    "gl_project_available",
    "gl_max_chain",
    "launches",
    "reset_launches",
]

MAX_OVERLAP = 8                   # halo rows per side the kernel's tiles hold
MAX_SMEM = 232448                 # bytes of shared memory a block may use on sm_90

#: kernel launches made by the steps of this module, by kernel
launches: Dict[str, int] = {"gl_momentum_step": 0, "gl_momentum_chain": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _smem_bytes(tile_t: int, chain: int, overlap: int, hop: int) -> int:
    """Shared memory of one block, as ``csrc/glstep.cu`` lays it out."""
    m = overlap - 1
    rows = tile_t + 2 * m * (chain - 1) + m
    syn = 64 * 256 + 32 * 64 + 2 * 40 * 40
    ana = 2 * 32 * 128 + 2 * 40 * 128 + 2 * 32 * 128 + 2 * 128
    return 4 * (rows * hop + max(syn, ana))


def _pick_tile(T: int, chain: int, overlap: int, hop: int) -> Optional[int]:
    """Frames per block: the widest tile (at most 128) whose signal window
    fits shared memory, evened out over the tiles it takes to cover ``T``
    frames, or None when not even 8 frames fit.  Wide tiles keep the halo
    that a block recomputes a small share of its work."""
    widest = None
    for tile_t in range(8, 129):
        if _smem_bytes(tile_t, chain, overlap, hop) > MAX_SMEM:
            break
        widest = tile_t
    if widest is None:
        return None
    return -(-T // -(-T // widest))


def gl_project_available(n_fft: int, hop_length: int, taps) -> bool:
    """Whether the shape suits the kernel.  The port's own limits: cosine-sum
    taps with P <= 4, ``hop | n_fft`` with 2 <= overlap <= 8 (the halo a tile
    holds) and hop a multiple of 32 (the staged contraction chunk).  A shape
    inside this gate whose window exceeds shared memory even unchained (hop
    above 2048) is not silently sent elsewhere: the step factory raises
    ``NotImplementedError`` for it on a CUDA tensor."""
    if taps is None or len(taps) > 5 or n_fft % hop_length != 0 or n_fft % 2:
        return False
    overlap = n_fft // hop_length
    return 2 <= overlap <= MAX_OVERLAP and hop_length % 32 == 0


def gl_max_chain(n_fft: int, hop_length: int, want: int) -> int:
    """The longest chain ``<= want`` whose window (tile plus the halo of
    ``chain * (overlap - 1)`` frames per side) fits shared memory, at least 1."""
    overlap = n_fft // hop_length
    chain = max(1, want)
    while chain >= 2 and _pick_tile(1 << 30, chain, overlap, hop_length) is None:
        chain -= 1
    return chain


def _env_rows(T: int, n_fft: int, hop_length: int, window: torch.Tensor) -> torch.Tensor:
    """Chunk-major OLA envelope ``(T + overlap - 1, hop)`` of the squared
    synthesis window over the true ``T`` frames, one where it vanishes.

    "Vanishes" is ``<= eps(float32)^2``: a window value below float32's eps is
    the rounding residue of the window's own construction (periodic blackman:
    ``w[0] = 0.42 - 0.5 + 0.08 = -1.4e-17``).  The un-trimmed signal keeps its
    very first sample, so dividing by such a square (1.9e-34) would blow the
    first frame up.  For hann and hamming up to n_fft 4096 no sample falls
    between that floor and the smallest normal number, so the rule equals
    ``env > tiny`` there."""
    w2 = (window.to(torch.float32) ** 2).expand(T, n_fft)
    env = overlap_add(w2, hop_length)
    floor = torch.finfo(torch.float32).eps ** 2
    env = torch.where(env > floor, env, torch.ones_like(env))
    return env.reshape(T - 1 + n_fft // hop_length, hop_length).contiguous()


def _project(mag, are, aim, env, n_fft, hop, taps):
    """Consistency projection with the kernel's boundary rule, plain PyTorch."""
    dev = mag.device
    overlap = n_fft // hop
    T = mag.shape[-2]
    Yim = mag * aim
    Yim[..., -1] = 0.0  # the nyquist bin of a real signal's spectrum is real
    Yre, Yim = _taps_conv(mag * are, Yim, taps)
    (wgt,) = _tables(_hermitian_weights, dev, n_fft)
    Dre, Dim = _twiddle_synthesis(Yre * wgt, Yim * wgt, n_fft, hop)
    Ch, Sh = _tables(_chunk_dft_matrices, dev, n_fft, hop)
    samples = (torch.matmul(Dre, Ch.T) + torch.matmul(Dim, Sh.T)) / env
    # frame t re-reads chunks t .. t + overlap - 1 of the un-trimmed signal
    Cre = torch.matmul(samples, Ch)
    Cim = torch.matmul(samples, Sh)
    Xre, Xim = _twiddle_analysis(Cre, Cim, n_fft, hop, T)
    return _taps_conv(Xre, Xim, taps)


def gl_momentum_step_reference(
    mag: torch.Tensor,
    are: torch.Tensor,
    aim: torch.Tensor,
    tre: torch.Tensor,
    tim: torch.Tensor,
    env: torch.Tensor,
    n_fft: int,
    hop_length: int,
    taps: Tuple[float, ...],
    mom: float,
    iters: int = 1,
):
    """Plain PyTorch version of the kernel: ``iters`` momentum-GL iterations on
    ``(B, T, F)`` arrays, returning ``(nare, naim, rre, rim)``.  Rows outside
    ``[0, T)`` are zero, so no halo is needed here and ``iters`` chained
    iterations are ``iters`` single ones."""
    for _ in range(iters):
        rre, rim = _project(mag, are, aim, env, n_fft, hop_length, taps)
        ure = rre - mom * tre
        uim = rim - mom * tim
        n = torch.clamp_min(torch.sqrt(ure * ure + uim * uim), 1e-16)
        are, aim, tre, tim = ure / n, uim / n, rre, rim
    return are, aim, tre, tim


def gl_momentum_step_oracle(mag, are, aim, tre, tim, env, n_fft, hop_length, taps, mom, iters=1):
    """The same function in float64 by the textbook route, independent of the
    chunk factorization: window the inverse FFT of each frame, overlap-add
    the un-trimmed signal, divide by the envelope, re-frame in place, window,
    FFT.  Against it the checks tell a wrong boundary rule from rounding: on
    the first and last ``overlap - 1`` frames the float32 versions are as far
    from it as the window's smallest value makes them (see the module note),
    and the kernel may be no further than its plain version.  Same arguments
    as :func:`gl_momentum_step_reference`; returns float64 tensors."""
    f64 = torch.float64
    mag, are, aim, tre, tim = (a.to(f64) for a in (mag, are, aim, tre, tim))
    env = env.to(f64).reshape(-1)
    ang = 2.0 * torch.pi * torch.arange(n_fft, dtype=f64, device=mag.device) / n_fft
    w = sum((1.0 if p == 0 else 2.0) * c * torch.cos(p * ang) for p, c in enumerate(taps))
    tprev = torch.complex(tre, tim)
    for _ in range(iters):
        spec = torch.complex(mag * are, mag * aim)
        # the taps conv reads bin 0 as stored, so an imaginary part there (not
        # a real signal's) reaches bins 1..P; irfft alone would drop it
        leak = torch.zeros_like(spec)
        for p in range(1, len(taps)):
            leak[..., p] = 1j * taps[p] * spec[..., 0].imag
        frames = torch.fft.irfft(spec, n=n_fft) * w + torch.fft.irfft(leak, n=n_fft)
        signal = overlap_add(frames, hop_length) / env
        rebuilt = torch.fft.rfft(signal.unfold(-1, n_fft, hop_length) * w)
        u = rebuilt - mom * tprev
        angles = u / torch.clamp_min(u.abs(), 1e-16)
        are, aim, tprev = angles.real, angles.imag, rebuilt
    return are, aim, tprev.real, tprev.imag


def make_gl_momentum_step(
    mag: torch.Tensor,
    n_fft: int,
    hop_length: int,
    taps: Tuple[float, ...],
    window: torch.Tensor,
    momentum: float,
    iters: int = 1,
) -> Tuple[Callable, Callable, Callable]:
    """Whole-iteration momentum-GL step factory.

    Returns ``(step, to_rows, from_rows)``: ``step(are, aim, tre, tim) ->
    (nare, naim, rre, rim)`` runs ``iters`` full iterations in one kernel
    invocation on arrays in the row layout ``to_rows`` produces (float32,
    contiguous ``(B, T, F)``; the kernel masks rows outside ``[0, T)`` itself,
    so the layout carries no padding).  ``momentum`` is the already-scaled
    coefficient ``mom / (1 + mom)``.  The magnitude and the envelope are baked
    in here, outside the loop.  Inputs are never written: the step returns
    fresh tensors."""
    if mag.ndim != 3:
        raise ValueError("expected (B, T, F) magnitudes")
    B, T, F = mag.shape
    if F != n_fft // 2 + 1:
        raise ValueError("magnitude has %d bins, n_fft=%d needs %d" % (F, n_fft, n_fft // 2 + 1))
    if iters < 1:
        raise ValueError("iters must be >= 1")
    dev = mag.device
    overlap = n_fft // hop_length
    mag32 = mag.to(torch.float32).contiguous()
    env = _env_rows(T, n_fft, hop_length, window.to(dev))
    mom = float(momentum)

    def to_rows(a: torch.Tensor) -> torch.Tensor:
        return a.to(torch.float32).contiguous()

    def from_rows(a: torch.Tensor) -> torch.Tensor:
        return a

    if not mag.is_cuda:
        def step_plain(are, aim, tre, tim):
            return gl_momentum_step_reference(
                mag32, are, aim, tre, tim, env, n_fft, hop_length, taps, mom, iters
            )

        return step_plain, to_rows, from_rows

    if not gl_project_available(n_fft, hop_length, taps):
        raise ValueError(
            "the CUDA Griffin-Lim kernel does not cover n_fft=%d hop=%d "
            "(need cosine-sum taps with P <= 4, hop | n_fft, 2 <= overlap <= 8 "
            "and hop %% 32 == 0)" % (n_fft, hop_length)
        )
    tile_t = _pick_tile(T, iters, overlap, hop_length)
    if tile_t is None:
        raise NotImplementedError(
            "the CUDA Griffin-Lim kernel holds a block's signal window in shared "
            "memory, which n_fft=%d hop=%d iters=%d exceeds (ROADMAP Queue 2, "
            "K3: hops above 2048; see gl_max_chain for a shorter chain); use "
            "fused=False" % (n_fft, hop_length, iters)
        )
    n_tiles = -(-T // tile_t)
    Ch, Sh = _tables(_chunk_dft_matrices, dev, n_fft, hop_length)
    twr, twi = _tables(_twiddles, dev, n_fft, hop_length)
    (wgt,) = _tables(_hermitian_weights, dev, n_fft)
    # restricted inverse bases (F, hop) with the hermitian weights folded in
    ict = (Ch.T * wgt[:, None]).contiguous()
    ist = (Sh.T * wgt[:, None]).contiguous()
    taps_c, P = _build.taps_array(taps)
    scratch = None
    if iters >= 2:
        wmax = tile_t + 2 * (overlap - 1) * (iters - 1)
        scratch = torch.empty((B * n_tiles, 4, wmax, F), dtype=torch.float32, device=dev)
    name = "gl_momentum_chain" if iters >= 2 else "gl_momentum_step"
    lib = _build.load_library()

    def _checked(a: torch.Tensor, what: str) -> torch.Tensor:
        if a.device != dev or a.dtype != torch.float32 or tuple(a.shape) != (B, T, F):
            raise ValueError(
                "%s must be float32 %s on %s, got %s %s on %s"
                % (what, (B, T, F), dev, a.dtype, tuple(a.shape), a.device)
            )
        if not a.is_contiguous():
            raise ValueError("%s must be contiguous (use to_rows)" % what)
        return a

    def step(are, aim, tre, tim):
        ins = [_checked(a, n) for a, n in zip((are, aim, tre, tim), ("are", "aim", "tre", "tim"))]
        outs = [torch.empty((B, T, F), dtype=torch.float32, device=dev) for _ in range(4)]
        with torch.cuda.device(dev):
            code = lib.att_gl_step(
                mag32.data_ptr(), *[a.data_ptr() for a in ins], env.data_ptr(),
                B, T, F, hop_length, overlap,
                Ch.data_ptr(), Sh.data_ptr(), ict.data_ptr(), ist.data_ptr(),
                twr.data_ptr(), twi.data_ptr(), taps_c, P, mom, iters, tile_t,
                *[o.data_ptr() for o in outs],
                None if scratch is None else scratch.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            )
        _build.check(code, name)
        launches[name] += 1
        return tuple(outs)

    return step, to_rows, from_rows
