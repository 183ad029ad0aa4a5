"""Whole-iteration momentum Griffin-Lim step and the consistency projection
(twin of the JAX ``ops/pallas/glstep.py``: the chunk-factored entries for
cosine-sum windows, and the full-K step for any other window).

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
``gl_project`` is the projection alone (kernel I, the same source without the
momentum update).  Three routes, chosen by ``(n_fft, hop)`` alone
(:func:`gl_step_route`): where ``n_fft`` is a power of two from 64 to 4096
(``frames_fft.fft_covers``), the shared-memory FFT both ways
(``gl_step_fft_kernel<false>``: ``frames_irfft`` under the window over
``n_fft``, the overlap-add in class order, the envelope, the in-place
re-framing, ``frames_rfft`` under the window; a chain is one cooperative
launch with a barrier across the grid between iterations), with the window
in the time domain, so the edge samples lose the amplified rounding
described above; where ``frames_fft.fft_covers_smooth7(n_fft)`` (even, ``2^a
3^b 5^c 7^d``, no power of two: 768, 1200, 640, 896, 1344, ...) and its block
fits, the same kernel on the mixed-radix FFT (``gl_step_fft_kernel<true>``,
the smooth route; its radix-7 instance ``gl_step_fft_kernel<true, true>``
where ``n_fft`` has a factor 7); elsewhere (1408 = 2^7 11, 8192, ...) the
chunk products.  The window of the
FFT route is the taps' own (:func:`taps_window`), so both routes compute one
function of the taps.  The taps conv reads the imaginary part of bin 0, which
an inverse real FFT does not: the FFT route adds it back unwindowed to every
sample of a frame, ``Im(Y_0)`` times :func:`_leak_table` (the oracle's
``leak`` term).  Its plain version (:func:`_project_fft`) repeats the
kernel's float32 operations in order.

``make_gl_momentum_step_fullk`` is the step for a window without cosine-sum
taps (the DGT's gaussian, kernel J in ``csrc/glstep_fullk.cu``): every frame
is synthesized on its own and overlap-added, then analysed again.  Three
routes, chosen by ``(n_fft, hop)`` alone (:func:`_fullk_plan`): where
``frames_fft.fft_covers(n_fft)`` (a power of two from 64 to 4096) the
shared-memory FFT both ways (``csrc/fft_smem.cuh``: ``frames_irfft``, then
``frames_rfft``), where ``fft_covers_smooth7(n_fft)`` and its block fits the
same on the mixed-radix FFT (the smooth route; its radix-7 instance where
``n_fft`` has a factor 7: 896, 1344, 1568, ...), elsewhere (1408 = 2^7 11,
8192, ...) full-length inverse and forward DFT bases with the window folded
in.  Both steps ask one coverage question (:func:`_fft_plan`), each
with its own block and registers.  J's
boundary rule is the eager loop's, not the one above: the overlap-add
signal (envelope floored at ``eps^2``) is trimmed to the centre and
reflect-padded again before it is re-framed, so every frame equals one
``istft`` + ``stft`` of the eager loop.  The JAX kernel it
replaces re-frames the un-trimmed signal; seeded by PGHI, that leaves the
loud first and last frames far off the target (ROADMAP Queue 3).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..fft import (
    _chunk_dft_matrices,
    _hermitian_weights,
    _reflect_pad,
    _tables,
    _taps_conv,
    _twiddle_analysis,
    _twiddle_synthesis,
    _twiddles,
)
from ..framing import overlap_add
from . import _build
from .frames_fft import (
    MAX_SMEM,
    class_plan,
    class_plan_smooth,
    fft_covers,
    fft_covers_smooth7,
    fft_area_floats,
    fft_twiddles,
    frames_irfft_reference,
    frames_rfft_reference,
    irfft_window,
    overlap_add_classes,
    taps_window,
)
from .spectral import _fullk_basis

__all__ = [
    "make_gl_momentum_step",
    "gl_momentum_step_reference",
    "gl_momentum_step_oracle",
    "gl_project_available",
    "gl_project",
    "gl_project_reference",
    "gl_max_chain",
    "gl_step_route",
    "gl_fullk_available",
    "make_gl_momentum_step_fullk",
    "gl_momentum_step_fullk_reference",
    "gl_momentum_step_fullk_oracle",
    "launches",
    "routes",
    "reset_launches",
]

MAX_OVERLAP = 8                   # halo rows per side the kernel's tiles hold

#: kernel launches made by the steps of this module, by kernel
launches: Dict[str, int] = {
    "gl_momentum_step": 0, "gl_momentum_chain": 0, "gl_project": 0, "gl_momentum_fullk": 0,
}
#: launches by route, ``"<kernel>:fft"`` / ``"<kernel>:smooth"`` /
#: ``"<kernel>:product"`` (each also counts in ``launches``)
routes: Dict[str, int] = {
    "gl_momentum_step:fft": 0, "gl_momentum_step:smooth": 0, "gl_momentum_step:product": 0,
    "gl_momentum_chain:fft": 0, "gl_momentum_chain:smooth": 0, "gl_momentum_chain:product": 0,
    "gl_project:fft": 0, "gl_project:smooth": 0, "gl_project:product": 0,
    "gl_momentum_fullk:fft": 0, "gl_momentum_fullk:smooth": 0, "gl_momentum_fullk:product": 0,
}


def reset_launches() -> None:
    for d in (launches, routes):
        for k in d:
            d[k] = 0


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
    """The longest chain ``<= want`` that one launch runs, at least 1: any on
    the FFT and the smooth route (no halo: a barrier across the grid between
    iterations); on the product route the longest whose window (tile plus the
    halo of ``chain * (overlap - 1)`` frames per side) fits shared memory."""
    overlap = n_fft // hop_length
    chain = max(1, want)
    if gl_step_route(n_fft, hop_length) != "product":
        return chain
    while chain >= 2 and _pick_tile(1 << 30, chain, overlap, hop_length) is None:
        chain -= 1
    return chain



def _fft_smem_bytes(tile_t: int, overlap: int, hop: int, teams: int) -> int:
    """Shared memory of one block of the FFT or the smooth route, as
    ``csrc/glstep.cu`` lays it out: the samples of ``tile_t + overlap - 1``
    chunks, ``frames_rfft``'s area, the synthesis window, the leak table and
    one leak factor per synthesized frame."""
    n = overlap * hop
    return 4 * ((tile_t + overlap - 1) * hop + fft_area_floats(n, teams) + 2 * n + tile_t + 2 * overlap)


#: blocks an SM the radix-7 instance of C, D and I
#: (``gl_step_fft_kernel<true, true>``) runs at the registers its build
#: takes: 256 threads, 65536 registers an SM
STEP_SEVEN_BLOCKS = 3


def _fft_plan(n_fft: int, hop: int, smem: Callable[[int, int], int],
              seven_blocks: int) -> Optional[Tuple[int, int]]:
    """The coverage question C, D, I and J share: ``(tile_t, teams)`` of the
    FFT route's block where ``fft_covers(n_fft)`` (``frames_fft.class_plan``)
    or the smooth route's where ``fft_covers_smooth7(n_fft)``
    (``class_plan_smooth`` with up to four blocks an SM, the 5-smooth
    instances' 64 registers, or ``seven_blocks`` where ``n_fft`` has a factor
    7: what the radix-7 instance's registers allow), each scored with the
    analysis's ``tile_t / 2`` pairs and ``smem(tile_t, teams)`` bytes a
    block; None where neither route takes ``n_fft`` or no block fits.
    ``tile_t`` is a multiple of ``2 overlap``: the synthesis's pair groups
    start at the block's first frame, the analysis's pairs ``(2j, 2j + 1)``
    at an even one."""
    def pairs(t):
        return t // 2

    if fft_covers(n_fft):
        return class_plan(n_fft, hop, smem, analysis_pairs=pairs)
    if fft_covers_smooth7(n_fft):
        blocks = seven_blocks if n_fft % 7 == 0 else 4
        return class_plan_smooth(n_fft, hop, smem, blocks=blocks, analysis_pairs=pairs)
    return None


@functools.lru_cache(maxsize=None)
def _step_fft_plan(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(tile_t, teams)`` of the FFT or the smooth route's block
    (:func:`_fft_plan` over :func:`_fft_smem_bytes`), or None on the
    product route's sizes: 56 frames and 4 FFTs at 1024/256 (two blocks an
    SM) and at 768/192, 24 and 4 at 640/160 (four blocks an SM:
    ``chip_smoke.py``'s plan sweep on an H100 found it the fastest plan at
    three of five shapes and within 2.7 % at the others, where two blocks an
    SM at most picked 56 x 4 at 640/160, 20.4 % slower), 24 and 4 at 896/224
    (the radix-7 instance, :data:`STEP_SEVEN_BLOCKS`)."""
    overlap = n_fft // hop

    def smem(t, teams):
        return _fft_smem_bytes(t, overlap, hop, teams)

    return _fft_plan(n_fft, hop, smem, STEP_SEVEN_BLOCKS)


def gl_step_route(n_fft: int, hop_length: int) -> str:
    """The route of C, D and I at ``(n_fft, hop_length)``, read by the
    kernel wrappers and the plain versions alike: ``"fft"`` where
    ``fft_covers(n_fft)`` (a power of two from 64 to 4096), ``"smooth"`` where
    ``fft_covers_smooth7(n_fft)`` and a smooth block fits
    (:func:`_step_fft_plan`; the radix-7 instance where ``n_fft`` has a
    factor 7: 896, 1344, 1568, ...), else ``"product"`` (1408 = 2^7 11,
    8192, ...)."""
    if fft_covers(n_fft):
        return "fft"
    return "product" if _step_fft_plan(n_fft, hop_length) is None else "smooth"


def _fft_operands(taps, n_fft: int, dev):
    """What the FFT and the smooth route read besides the state: the taps'
    window, the synthesis window (it over ``n_fft``; on the smooth route
    rounded once from float64), the leak table and the twiddles (the smooth
    stages read the first ``fft_smooth_table(n_fft)`` of each row)."""
    taps = tuple(float(t) for t in taps)
    (w,) = _tables(taps_window, dev, taps, n_fft)
    (leak,) = _tables(_leak_table, dev, taps, n_fft)
    (tw,) = _tables(fft_twiddles, dev, n_fft)
    return w, irfft_window(w, n_fft, not fft_covers(n_fft)).contiguous(), leak, tw


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


@functools.lru_cache(maxsize=None)
def _leak_table(taps: Tuple[float, ...], n_fft: int) -> np.ndarray:
    """``-(2 / n_fft) sum_{p >= 1} taps[p] sin(2 pi p i / n_fft)``, float64
    rounded once: what an imaginary part of 1 at bin 0 adds to sample ``i`` of
    a frame through the taps conv (bins 1..P gain ``i taps[p]``), and an
    inverse real FFT drops."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    s = sum((c * np.sin(p * ang) for p, c in enumerate(taps) if p >= 1), np.zeros(n_fft))
    return np.asarray(-(2.0 / n_fft) * s, dtype=np.float32)


def _fft_frames(mag, are, aim, n_fft: int, hop: int, window, smooth: bool = False) -> torch.Tensor:
    """``frames_irfft`` of the spectra ``mag * (are, aim)`` ``(B, T, F)`` under
    ``irfft_window(window)``, as the FFT route's kernels (C, D, I, J) pair
    them: frames ``f`` and ``f + overlap`` for ``f mod 2 overlap >= overlap``
    (frames 0 .. overlap - 1 pair with zero frames before the clip).
    ``smooth``: the smooth route's schedule (the mixed-radix stages, the
    window's ``1 / n_fft`` fold rounded once from float64)."""
    ov = n_fft // hop
    lead = mag.new_zeros(mag.shape[:-2] + (ov, mag.shape[-1]))
    re = torch.cat([lead, mag * are], dim=-2)
    im = torch.cat([lead, mag * aim], dim=-2)
    return frames_irfft_reference(re, im, irfft_window(window, n_fft, smooth), ov, smooth)[..., ov:, :]


def _project_fft(mag, are, aim, env, n_fft, hop, taps, smooth: bool = False):
    """The consistency projection on the FFT route's schedule, plain PyTorch
    in the kernel's order of float32 operations: the frames of
    :func:`_fft_frames` under the taps' window, plus ``Im(Y_0)`` times
    :func:`_leak_table` on every sample, the overlap-add in class order
    ``f mod overlap``, the division by the envelope, the in-place framing of
    the un-trimmed signal, ``frames_rfft_reference`` (pairs ``(2j, 2j +
    1)``) under the taps' window.  ``smooth``: the smooth route's schedule."""
    taps = tuple(float(t) for t in taps)
    (w,) = _tables(taps_window, mag.device, taps, n_fft)
    (leak,) = _tables(_leak_table, mag.device, taps, n_fft)
    frames = _fft_frames(mag, are, aim, n_fft, hop, w, smooth)
    lam = mag[..., 0] * aim[..., 0]
    frames = frames + lam[..., None] * leak
    signal = overlap_add_classes(frames, hop) / env.reshape(-1)
    return frames_rfft_reference(signal.unfold(-1, n_fft, hop), w, smooth=smooth)


def _projection_reference(mag, are, aim, env, n_fft, hop, taps):
    """The plain projection of the route :func:`gl_step_route` picks:
    :func:`_project_fft` on the FFT and (``smooth=True``) the smooth route,
    else :func:`_project`."""
    route = gl_step_route(n_fft, hop)
    if route != "product":
        return _project_fft(mag, are, aim, env, n_fft, hop, taps, smooth=route == "smooth")
    return _project(mag, are, aim, env, n_fft, hop, taps)


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
    ``(B, T, F)`` arrays, returning ``(nare, naim, rre, rim)``, on the route
    ``n_fft`` picks (:func:`_projection_reference`).  Rows outside ``[0, T)``
    are zero, so no halo is needed here and ``iters`` chained iterations are
    ``iters`` single ones."""
    for _ in range(iters):
        rre, rim = _projection_reference(mag, are, aim, env, n_fft, hop_length, taps)
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


def _to_rows(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).contiguous()


def _from_rows(a: torch.Tensor) -> torch.Tensor:
    return a


def _checked(a: torch.Tensor, what: str, dev, shape) -> torch.Tensor:
    """A step's state array, as the kernels take it, or raise."""
    if a.device != dev or a.dtype != torch.float32 or tuple(a.shape) != shape:
        raise ValueError(
            "%s must be float32 %s on %s, got %s %s on %s"
            % (what, shape, dev, a.dtype, tuple(a.shape), a.device)
        )
    if not a.is_contiguous():
        raise ValueError("%s must be contiguous (use to_rows)" % what)
    return a


_STATE = ("are", "aim", "tre", "tim")


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

    if not mag.is_cuda:
        def step_plain(are, aim, tre, tim):
            return gl_momentum_step_reference(
                mag32, are, aim, tre, tim, env, n_fft, hop_length, taps, mom, iters
            )

        return step_plain, _to_rows, _from_rows

    if not gl_project_available(n_fft, hop_length, taps):
        raise ValueError(
            "the CUDA Griffin-Lim kernel does not cover n_fft=%d hop=%d "
            "(need cosine-sum taps with P <= 4, hop | n_fft, 2 <= overlap <= 8 "
            "and hop %% 32 == 0)" % (n_fft, hop_length)
        )
    name = "gl_momentum_chain" if iters >= 2 else "gl_momentum_step"
    if gl_step_route(n_fft, hop_length) != "product":
        return _make_fft_step(mag32, env, n_fft, hop_length, taps, mom, iters, name), _to_rows, _from_rows
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
    lib = _build.load_library()

    def step(are, aim, tre, tim):
        ins = [_checked(a, n, dev, (B, T, F)) for a, n in zip((are, aim, tre, tim), _STATE)]
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
        routes[name + ":product"] += 1
        return tuple(outs)

    return step, _to_rows, _from_rows


def _fft_plan_or_raise(n_fft: int, hop: int) -> Tuple[int, int]:
    plan = _step_fft_plan(n_fft, hop)
    if plan is None:
        raise NotImplementedError(
            "the CUDA Griffin-Lim kernel's FFT route holds a block's samples in shared "
            "memory, which n_fft=%d hop=%d exceeds (ROADMAP Queue 2, K3); use fused=False"
            % (n_fft, hop))
    return plan


def _make_fft_step(mag32, env, n_fft: int, hop: int, taps, mom: float, iters: int, name: str) -> Callable:
    """The step of :func:`make_gl_momentum_step` on the FFT or the smooth
    route: one launch of ``gl_step_fft_kernel`` (the route's instance) a call
    (a cooperative one for a chain, whose intermediate state goes through a
    scratch set of four ``(B, T, F)`` arrays allocated here)."""
    B, T, F = mag32.shape
    dev = mag32.device
    route = gl_step_route(n_fft, hop)
    tile_t, teams = _fft_plan_or_raise(n_fft, hop)
    ops = _fft_operands(taps, n_fft, dev)
    scratch = barrier = None
    if iters >= 2:
        scratch = torch.empty((4, B, T, F), dtype=torch.float32, device=dev)
        barrier = torch.zeros(2, dtype=torch.int32, device=dev)
    lib = _build.load_library()

    def step(are, aim, tre, tim):
        ins = [_checked(a, n, dev, (B, T, F)) for a, n in zip((are, aim, tre, tim), _STATE)]
        outs = [torch.empty((B, T, F), dtype=torch.float32, device=dev) for _ in range(4)]
        with torch.cuda.device(dev):
            code = lib.att_gl_step_fft(
                mag32.data_ptr(), *[a.data_ptr() for a in ins], env.data_ptr(),
                *[o.data_ptr() for o in ops], B, T, F, hop, n_fft // hop, tile_t, teams, mom, iters, 0,
                *[o.data_ptr() for o in outs], None if scratch is None else scratch.data_ptr(),
                None if barrier is None else barrier.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            )
        _build.check(code, name)
        launches[name] += 1
        routes[name + ":" + route] += 1
        return tuple(outs)

    return step


# ------------------------------------------------- kernel I: the projection
def gl_project_reference(mag, ang_re, ang_im, n_fft, hop_length, taps, window):
    """Plain PyTorch version of :func:`gl_project`, on the route
    :func:`gl_step_route` picks."""
    env = _env_rows(mag.shape[-2], n_fft, hop_length, window.to(mag.device))
    return _projection_reference(mag.to(torch.float32), ang_re.to(torch.float32),
                                 ang_im.to(torch.float32), env, n_fft, hop_length, taps)


def gl_project(mag, ang_re, ang_im, n_fft, hop_length, taps, window):
    """One Griffin-Lim consistency projection ``STFT(ISTFT(mag * (ang_re + i
    ang_im)))`` of ``(B, T, F)`` real pairs, with the step's boundary rule
    (module note); returns ``(re, im)``.  On a CUDA tensor one launch of the
    step kernel without its momentum update (or a raise)."""
    if mag.ndim != 3:
        raise ValueError("expected (B, T, F) magnitudes")
    if not mag.is_cuda:
        return gl_project_reference(mag, ang_re, ang_im, n_fft, hop_length, taps, window)
    if not gl_project_available(n_fft, hop_length, taps):
        raise ValueError(
            "the CUDA Griffin-Lim kernel does not cover n_fft=%d hop=%d (need "
            "cosine-sum taps with P <= 4, hop | n_fft, 2 <= overlap <= 8 and "
            "hop %% 32 == 0)" % (n_fft, hop_length)
        )
    B, T, F = mag.shape
    dev = mag.device
    if gl_step_route(n_fft, hop_length) != "product":
        return _fft_project(mag, ang_re, ang_im, n_fft, hop_length, taps, window)
    tile_t = _pick_tile(T, 1, n_fft // hop_length, hop_length)
    if tile_t is None:
        raise NotImplementedError(
            "the CUDA Griffin-Lim kernel holds a block's signal window in shared "
            "memory, which n_fft=%d hop=%d exceeds (ROADMAP Queue 2, K9)" % (n_fft, hop_length)
        )
    ins = [a.to(torch.float32).contiguous() for a in (mag, ang_re, ang_im)]
    for a in ins:
        if a.device != dev or tuple(a.shape) != (B, T, F):
            raise ValueError("mag, ang_re and ang_im must be (B, T, F) on one device")
    env = _env_rows(T, n_fft, hop_length, window.to(dev))
    Ch, Sh = _tables(_chunk_dft_matrices, dev, n_fft, hop_length)
    twr, twi = _tables(_twiddles, dev, n_fft, hop_length)
    (wgt,) = _tables(_hermitian_weights, dev, n_fft)
    ict = (Ch.T * wgt[:, None]).contiguous()
    ist = (Sh.T * wgt[:, None]).contiguous()
    taps_c, P = _build.taps_array(taps)
    rre = torch.empty((B, T, F), dtype=torch.float32, device=dev)
    rim = torch.empty_like(rre)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_gl_project(
            *[a.data_ptr() for a in ins], env.data_ptr(), B, T, F, hop_length, n_fft // hop_length,
            Ch.data_ptr(), Sh.data_ptr(), ict.data_ptr(), ist.data_ptr(), twr.data_ptr(),
            twi.data_ptr(), taps_c, P, tile_t, rre.data_ptr(), rim.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(code, "gl_project")
    launches["gl_project"] += 1
    routes["gl_project:product"] += 1
    return rre, rim


def _fft_project(mag, ang_re, ang_im, n_fft: int, hop: int, taps, window):
    """:func:`gl_project` on the FFT or the smooth route: the step kernel's
    instance of the route with ``project = 1`` (no momentum update, R written
    alone)."""
    route = gl_step_route(n_fft, hop)
    B, T, F = mag.shape
    dev = mag.device
    tile_t, teams = _fft_plan_or_raise(n_fft, hop)
    ins = [a.to(torch.float32).contiguous() for a in (mag, ang_re, ang_im)]
    for a in ins:
        if a.device != dev or tuple(a.shape) != (B, T, F):
            raise ValueError("mag, ang_re and ang_im must be (B, T, F) on one device")
    env = _env_rows(T, n_fft, hop, window.to(dev))
    ops = _fft_operands(taps, n_fft, dev)
    rre = torch.empty((B, T, F), dtype=torch.float32, device=dev)
    rim = torch.empty_like(rre)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_gl_step_fft(
            ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(), None, None, env.data_ptr(),
            *[o.data_ptr() for o in ops], B, T, F, hop, n_fft // hop, tile_t, teams, 0.0, 1, 1,
            None, None, rre.data_ptr(), rim.data_ptr(), None, None,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(code, "gl_project")
    launches["gl_project"] += 1
    routes["gl_project:" + route] += 1
    return rre, rim


# --------------------------------------- kernel J: the full-K momentum step
def _fullk_smem_bytes(rows: int, overlap: int, hop: int, k_padded: int) -> int:
    """Shared memory of one block of the full-K step, as ``csrc/glstep_fullk.cu``
    lays it out: the block's samples, then the frames' ``[re | im]`` rows (or
    a slab of ``k_padded`` of their columns) and the staged synthesis basis,
    or the analysis work area where larger."""
    syn = (rows + overlap - 1) * k_padded + 32 * 256
    ana = 2 * 32 * 128 + 2 * 40 * 128 + 2 * 32 * 128 + 2 * 128
    return 4 * (rows * hop + max(syn, ana))


def _pick_fullk_rows(n_fft: int, hop: int) -> Optional[Tuple[int, int]]:
    """``(rows, tile_t)`` of the widest block that fits shared memory, or
    None.  A block computes ``rows <= 32`` hop chunks of samples starting one
    chunk before its first frame, and its frames are ``tile_t = min(32, rows
    - overlap)``; ``rows >= overlap + 2``, so that the first block holds chunk
    ``overlap``, whose first sample the reflection of frame 0 reads."""
    from .pghi_kernel import _k_padded  # pghi_kernel imports this module

    overlap = n_fft // hop
    kp = _k_padded(n_fft // 2 + 1)
    for rows in range(32, overlap + 1, -1):
        if _fullk_smem_bytes(rows, overlap, hop, kp) <= MAX_SMEM:
            return rows, min(32, rows - overlap)
    return None


def _pick_fullk_block(n_fft: int, hop: int) -> Optional[Tuple[int, int, int]]:
    """``(rows, tile_t, slab)`` of the block the step launches: the block of
    :func:`_pick_fullk_rows` with the frames' whole ``[re | im]`` rows
    (``slab = Kp``) where one fits, else the most chunks (at most 32) whose
    samples and analysis work area fit beside a synthesis slab of at least 256
    contraction columns, the widest such slab (a multiple of 32); None when
    not even ``overlap + 2`` chunks fit so."""
    from .pghi_kernel import _k_padded

    overlap = n_fft // hop
    kp = _k_padded(n_fft // 2 + 1)
    pick = _pick_fullk_rows(n_fft, hop)
    if pick is not None:
        return pick + (kp,)
    for rows in range(32, overlap + 1, -1):
        free = MAX_SMEM // 4 - rows * hop - 32 * 256
        slab = min(kp, free // (rows + overlap - 1) // 32 * 32)
        if slab >= 256 and _fullk_smem_bytes(rows, overlap, hop, slab) <= MAX_SMEM:
            return rows, min(32, rows - overlap), slab
    return None


def _fullk_fft_smem_bytes(rows: int, hop: int, n_fft: int, teams: int) -> int:
    """Shared memory of one block of the full-K step's FFT or smooth route:
    the samples of ``rows`` chunks, ``frames_rfft``'s area on the route
    ``n_fft`` takes and the synthesis window."""
    return 4 * (rows * hop + fft_area_floats(n_fft, teams) + n_fft)


#: blocks an SM J's radix-7 instance (``gl_fullk_fft_kernel<true, true>``)
#: runs at the registers its build takes: 256 threads, 65536 registers an SM
FULLK_SEVEN_BLOCKS = 3


@functools.lru_cache(maxsize=None)
def _pick_fullk_fft_block(n_fft: int, hop: int) -> Optional[Tuple[int, int, int]]:
    """``(rows, tile_t, teams)`` of the FFT or the smooth route's block
    (:func:`_fft_plan` over :func:`_fullk_fft_smem_bytes`), ``rows =
    tile_t + overlap`` chunks, or None: on the smooth route 12 frames and 4
    FFTs at 768/256, the fastest plan of ``chip_smoke.py``'s sweep at all five
    shapes (the analysis's term moved the pick there from 42 frames, 3.3 %
    slower on an H100), and where ``n_fft`` has a factor 7 (the radix-7
    instance) up to :data:`FULLK_SEVEN_BLOCKS` blocks an SM."""
    overlap = n_fft // hop

    def smem(t, teams):
        return _fullk_fft_smem_bytes(t + overlap, hop, n_fft, teams)

    plan = _fft_plan(n_fft, hop, smem, FULLK_SEVEN_BLOCKS)
    if plan is None:
        return None
    tile_t, teams = plan
    return tile_t + overlap, tile_t, teams


def _fullk_plan(n_fft: int, hop: int) -> Optional[Tuple[str, int, int, int]]:
    """The full-K step's route and block, read by the kernel wrapper and the
    plain version alike: ``("fft", rows, tile_t, teams)`` where
    ``fft_covers(n_fft)`` (:func:`_pick_fullk_fft_block`), ``("smooth", rows,
    tile_t, teams)`` where ``fft_covers_smooth7(n_fft)`` and a smooth block
    fits (the radix-7 instance where ``n_fft`` has a factor 7), else
    ``("product", rows, tile_t, slab)`` (:func:`_pick_fullk_block`); None
    when no block fits.  The route reads ``(n_fft, hop)`` alone."""
    pick = _pick_fullk_fft_block(n_fft, hop)
    if pick is not None:
        return ("fft" if fft_covers(n_fft) else "smooth",) + pick
    if fft_covers(n_fft):
        return None
    pick = _pick_fullk_block(n_fft, hop)
    return None if pick is None else ("product",) + pick


def _fullk_route(n_fft: int, hop: int) -> str:
    """The route of :func:`_fullk_plan` (``"product"`` where no block fits:
    the plain version's products)."""
    if fft_covers(n_fft):
        return "fft"
    plan = _fullk_plan(n_fft, hop)
    return "product" if plan is None else plan[0]


def _fullk_reflection_covered(T: int, n_fft: int, hop: int, rows: int, tile_t: int) -> bool:
    """Whether every block finds its frames' reflected samples among its own
    chunks: always where one reflection covers the pad (``(T - 1) hop >
    n_fft / 2``); a shorter clip reflects again, from anywhere in the trimmed
    signal, so one block must hold all its frames and that signal."""
    L, half = (T - 1) * hop, n_fft // 2
    if L > half:
        return True
    return T >= 2 and T <= tile_t and half + L <= (rows - 1) * hop


def gl_fullk_available(n_fft: int, hop_length: int) -> bool:
    """Whether the full-K step's structure covers the shape (any window):
    ``hop | n_fft`` with 2 <= overlap <= 8 and hop a multiple of 32 (the
    staged contraction chunk).  A shape inside this gate that the kernel's
    block still cannot take is not silently sent elsewhere: the step factory
    raises ``NotImplementedError`` on a CUDA tensor."""
    if n_fft % hop_length != 0 or n_fft % 2:
        return False
    return 2 <= n_fft // hop_length <= MAX_OVERLAP and hop_length % 32 == 0


def _trim_reflect(signal: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """The un-trimmed overlap-add signal ``(..., (T - 1) hop + n_fft)`` with
    its centre ``(T - 1) hop`` samples kept and reflect-padded by ``n_fft //
    2`` again: what one ``istft`` then ``stft`` of the eager loop frames."""
    half = n_fft // 2
    trimmed = signal[..., half: signal.shape[-1] - (n_fft - half)]
    return _reflect_pad(trimmed, half)


def gl_momentum_step_fullk_reference(mag, are, aim, tre, tim, env, n_fft, hop_length, window, mom):
    """Plain version of the full-K step: one momentum-GL iteration on
    ``(B, T, F)`` arrays, returning ``(nare, naim, rre, rim)``.  On the FFT
    and the smooth route (:func:`_fullk_plan`) it repeats the kernel's
    schedule (see :func:`_fullk_fft_signal`; the analysis
    ``frames_rfft_reference``, the update rounded step by step as the kernel
    rounds it); elsewhere the products with the window-folded bases."""
    w = window.to(mag.device)
    route = _fullk_route(n_fft, hop_length)
    if route != "product":
        smooth = route == "smooth"
        signal = _fullk_fft_signal(mag, are, aim, n_fft, hop_length, w, smooth) / env.reshape(-1)
        reframed = _trim_reflect(signal, n_fft, hop_length).unfold(-1, n_fft, hop_length)
        rre, rim = frames_rfft_reference(reframed, w, smooth=smooth)
    else:
        from .pghi_kernel import _windowed_idft

        Aw, Bw = _windowed_idft(w, n_fft)
        frames = torch.matmul(mag * are, Aw) + torch.matmul(mag * aim, Bw)
        signal = overlap_add(frames, hop_length) / env.reshape(-1)
        WC, WS = _fullk_basis(w, n_fft)
        reframed = _trim_reflect(signal, n_fft, hop_length).unfold(-1, n_fft, hop_length)
        rre, rim = torch.matmul(reframed, WC), torch.matmul(reframed, WS)
    ure = rre - mom * tre
    uim = rim - mom * tim
    n = torch.clamp_min(torch.sqrt(ure * ure + uim * uim), 1e-16)
    return ure / n, uim / n, rre, rim


def _fullk_fft_signal(mag, are, aim, n_fft: int, hop: int, window, smooth: bool = False) -> torch.Tensor:
    """The FFT route's synthesis: the overlap-add ``(B, (T - 1) hop + n_fft)``
    of ``frames_irfft`` of the spectra ``mag * (are, aim)``, as the kernel
    pairs them (frames ``f`` and ``f + overlap`` for ``f mod 2 overlap >=
    overlap``: frames 0 .. overlap - 1 pair with zero frames before the
    clip) and sums them (class ``f mod overlap`` after class).  ``smooth``:
    the smooth route's schedule."""
    return overlap_add_classes(_fft_frames(mag, are, aim, n_fft, hop, window, smooth), hop)


def gl_momentum_step_fullk_oracle(mag, are, aim, tre, tim, env, n_fft, hop_length, window, mom):
    """The full-K step in float64 by the textbook route (windowed inverse FFT
    of each frame, overlap-add, envelope, centre trim, reflect padding,
    re-frame, window, FFT); same arguments as
    :func:`gl_momentum_step_fullk_reference`."""
    f64 = torch.float64
    mag, are, aim, tre, tim = (a.to(f64) for a in (mag, are, aim, tre, tim))
    w = window.to(device=mag.device, dtype=f64)
    frames = torch.fft.irfft(torch.complex(mag * are, mag * aim), n=n_fft) * w
    signal = overlap_add(frames, hop_length) / env.to(f64).reshape(-1)
    padded = _trim_reflect(signal, n_fft, hop_length)
    rebuilt = torch.fft.rfft(padded.unfold(-1, n_fft, hop_length) * w)
    u = rebuilt - mom * torch.complex(tre, tim)
    angles = u / torch.clamp_min(u.abs(), 1e-16)
    return angles.real, angles.imag, rebuilt.real, rebuilt.imag


def make_gl_momentum_step_fullk(
    mag: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    momentum: float,
) -> Tuple[Callable, Callable, Callable]:
    """Full-K variant of :func:`make_gl_momentum_step` for windows without
    cosine-sum taps: the same contract, one iteration per invocation (the
    kernel has no chained form), with the eager loop's boundary rule (module
    note)."""
    if mag.ndim != 3:
        raise ValueError("expected (B, T, F) magnitudes")
    B, T, F = mag.shape
    if F != n_fft // 2 + 1:
        raise ValueError("magnitude has %d bins, n_fft=%d needs %d" % (F, n_fft, n_fft // 2 + 1))
    dev = mag.device
    mag32 = mag.to(torch.float32).contiguous()
    window = window.to(dev)
    env = _env_rows(T, n_fft, hop_length, window)
    mom = float(momentum)

    if not mag.is_cuda:
        def step_plain(are, aim, tre, tim):
            return gl_momentum_step_fullk_reference(
                mag32, are, aim, tre, tim, env, n_fft, hop_length, window, mom)

        return step_plain, _to_rows, _from_rows

    if not gl_fullk_available(n_fft, hop_length):
        raise ValueError(
            "the CUDA full-K Griffin-Lim kernel does not cover n_fft=%d hop=%d "
            "(need hop | n_fft, 2 <= overlap <= 8 and hop %% 32 == 0)" % (n_fft, hop_length)
        )
    plan = _fullk_plan(n_fft, hop_length)
    if plan is None:
        raise NotImplementedError(
            "the CUDA full-K Griffin-Lim kernel holds a block's samples and a slab "
            "of its frames in shared memory, which n_fft=%d hop=%d exceeds (ROADMAP "
            "Queue 2, K9); use fused=False" % (n_fft, hop_length)
        )
    route, rows, tile_t, last = plan
    if not _fullk_reflection_covered(T, n_fft, hop_length, rows, tile_t):
        raise NotImplementedError(
            "the CUDA full-K Griffin-Lim kernel reflects a short clip inside one block, "
            "which %d frames at n_fft=%d hop=%d do not fit (ROADMAP Queue 2, K9); use "
            "fused=False" % (T, n_fft, hop_length)
        )
    if route != "product":
        # the FFT and the smooth route read the window, the window / n_fft
        # (rounded once from float64 on the smooth route) and the twiddles
        teams, slab, kp = last, 0, 0
        (tw,) = _tables(fft_twiddles, dev, n_fft)
        win = window.to(torch.float32).contiguous()
        ops = (None, None, None, win, irfft_window(win, n_fft, route == "smooth").contiguous(), tw)
    else:
        from .pghi_kernel import _synth_basis

        teams, slab = 0, last
        syn = _synth_basis(window, n_fft, hop_length)
        WC, WS = _fullk_basis(window, n_fft)
        kp = syn.shape[1]
        ops = (syn, WC, WS, None, None, None)
    lib = _build.load_library()

    def step(are, aim, tre, tim):
        ins = [_checked(a, n, dev, (B, T, F)) for a, n in zip((are, aim, tre, tim), _STATE)]
        outs = [torch.empty((B, T, F), dtype=torch.float32, device=dev) for _ in range(4)]
        with torch.cuda.device(dev):
            code = lib.att_gl_fullk_step(
                mag32.data_ptr(), *[a.data_ptr() for a in ins], env.data_ptr(),
                *[None if o is None else o.data_ptr() for o in ops],
                B, T, F, hop_length, n_fft // hop_length, kp, rows, tile_t, slab, teams, mom,
                *[o.data_ptr() for o in outs], ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            )
        _build.check(code, "gl_momentum_fullk")
        launches["gl_momentum_fullk"] += 1
        routes["gl_momentum_fullk:" + route] += 1
        return tuple(outs)

    return step, _to_rows, _from_rows
