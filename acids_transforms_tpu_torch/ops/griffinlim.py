"""Griffin-Lim phase reconstruction with momentum (fast Griffin-Lim).

Twin of the JAX ``ops/griffinlim.py``; the algorithm is torchaudio's
(30 iterations, momentum 0.99, random init by default): alternate ISTFT/STFT
projections of the target magnitude with the momentum extrapolation of
Perraudin et al.

Three loops: the eager one (one ``istft`` + one ``stft`` per iteration); the
kernel loop for a cosine-sum window, where each invocation of the fused step
(``ops/cuda/glstep.py``) runs ``GL_CHAIN`` whole iterations and the remainder
runs through the single-iteration step; and the full-K kernel loop for any
other window (the DGT's gaussian), one launch per iteration.
"""
from __future__ import annotations

from typing import Optional

import torch

from .fft import istft, stft

__all__ = ["griffin_lim", "GL_CHAIN"]

# Chained iterations per fused-kernel invocation: divides the per-iteration
# traffic of the five state arrays and the launches by the chain length, at
# the price of a halo of chain * (overlap - 1) recomputed frames per side.
GL_CHAIN = 4


def _unit(re: torch.Tensor, im: torch.Tensor):
    n = torch.clamp_min(torch.sqrt(re * re + im * im), torch.finfo(torch.float32).tiny)
    return re / n, im / n


def griffin_lim(
    magnitude: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    n_iter: int = 30,
    momentum: float = 0.99,
    length: Optional[int] = None,
    rand_init: bool = True,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
    init_phase: Optional[torch.Tensor] = None,
    taps=None,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Reconstruct a waveform from a magnitude spectrogram ``(..., T, F)``.

    ``init_phase`` seeds the iteration with an explicit phase estimate instead
    of random or ones.  ``generator`` (on the magnitude's device) drives the
    random init; without one a generator seeded with 0 is used.  ``taps``
    (cosine-sum coefficients of the synthesis window) select the factored step.

    Which kernel: a window with cosine-sum ``taps`` (hann, hamming, blackman)
    takes the chunk-factored step (kernels C and D, ``gl_project_available``);
    a window without them (``taps=None``: the DGT's gaussian) takes the full-K
    step (kernel J, ``gl_fullk_available``), e.g. kaiser and bartlett too.
    ``fused=None`` takes that kernel when the magnitude lies on a CUDA device
    and the shape is eligible, else the eager loop.  ``fused=True`` on an
    ineligible shape raises; on a CPU tensor it runs the step's plain PyTorch
    version through the same loop.  ``fused=False`` forces the eager loop.

    The boundary rule depends on the window.  The factored step re-frames
    the un-trimmed overlap-add signal (the JAX kernel's rule), so its first
    and last ``overlap - 1`` frames differ from the eager loop's; the full-K
    step trims and reflect-pads as the eager loop does (``ops/cuda/glstep.py``
    module note).  Both converge alike; neither is bit-equal to the other.
    """
    from .cuda.glstep import (
        gl_fullk_available,
        gl_max_chain,
        gl_project_available,
        make_gl_momentum_step,
        make_gl_momentum_step_fullk,
    )

    dev = magnitude.device
    mom = momentum / (1.0 + momentum)
    if init_phase is not None:
        ph = init_phase.to(torch.float32)
        are, aim = torch.cos(ph), torch.sin(ph)
    elif rand_init:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        are = torch.randn(magnitude.shape, generator=generator, device=dev)
        aim = torch.randn(magnitude.shape, generator=generator, device=dev)
    else:
        are = torch.ones(magnitude.shape, device=dev)
        aim = torch.zeros(magnitude.shape, device=dev)
    are, aim = _unit(are, aim)

    overlap = n_fft // hop_length
    chain_k = min(GL_CHAIN, n_iter)
    while chain_k >= 2 and chain_k * (overlap - 1) > 24:
        chain_k -= 1
    eligible = gl_project_available(n_fft, hop_length, taps)
    if eligible:
        chain_k = gl_max_chain(n_fft, hop_length, chain_k)  # the window must fit shared memory
    fullk = not eligible and gl_fullk_available(n_fft, hop_length)
    if fused is None:
        use_kernel = magnitude.is_cuda and (eligible or fullk)
    else:
        use_kernel = bool(fused)
        if use_kernel and not (eligible or fullk):
            raise ValueError(
                "fused=True requested but no Griffin-Lim kernel covers this shape "
                "(needs hop | n_fft, overlap <= 8, hop % 32 == 0); use "
                "fused=None to fall back to the eager loop"
            )

    if use_kernel and n_iter > 0:
        batch_shape = magnitude.shape[:-2]
        T, F = magnitude.shape[-2:]
        mag3 = magnitude.reshape((-1, T, F))
        step = step_k = None
        if fullk:
            chain_k = 1  # the full-K step has no chained form
        elif chain_k >= 2:
            step_k, to_rows, from_rows = make_gl_momentum_step(
                mag3, n_fft, hop_length, taps, window, mom, iters=chain_k
            )
        if chain_k < 2 or n_iter % chain_k:
            # built only when remainder (or unchained) steps will run
            if fullk:
                step, to_rows, from_rows = make_gl_momentum_step_fullk(
                    mag3, n_fft, hop_length, window, mom
                )
            else:
                step, to_rows, from_rows = make_gl_momentum_step(
                    mag3, n_fft, hop_length, taps, window, mom
                )
        carry = (
            to_rows(are.reshape((-1, T, F))),
            to_rows(aim.reshape((-1, T, F))),
        )
        carry = carry + (torch.zeros_like(carry[0]), torch.zeros_like(carry[0]))
        if step_k is not None:
            groups, rem = divmod(n_iter, chain_k)
            for _ in range(groups):
                carry = step_k(*carry)
        else:
            rem = n_iter
        for _ in range(rem):
            carry = step(*carry)
        are = from_rows(carry[0]).reshape(batch_shape + (T, F))
        aim = from_rows(carry[1]).reshape(batch_shape + (T, F))
        return istft(
            torch.complex(magnitude * are, magnitude * aim), n_fft, hop_length,
            window, length=length, impl=impl, taps=taps,
        )

    angles = torch.complex(are, aim)
    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(
            magnitude * angles, n_fft, hop_length, window, length=length,
            impl=impl, taps=taps,
        )
        rebuilt = stft(inverse, n_fft, hop_length, window, impl=impl, taps=taps)
        upd = rebuilt - mom * tprev
        angles = upd / torch.clamp_min(upd.abs(), 1e-16)
        tprev = rebuilt
    return istft(
        magnitude * angles, n_fft, hop_length, window, length=length,
        impl=impl, taps=taps,
    )
