"""Discrete Gabor Transform with PGHI phaseless inversion (twin of the JAX
``transforms/dgt.py:DGT``).

The DGT is an STFT with a truncated Gaussian analysis window, whose
time-frequency ratio ``gamma = 2 pi lambda^2`` makes the phase-magnitude
Cauchy-Riemann relations exact: the basis of PGHI phase reconstruction.  The
offline complex inversion is the least-squares ISTFT with the *analysis*
window, which is exact; the canonical dual window (``dual``) belongs to the
streaming variant, ``RealtimeDGT``: the gaussian window on ``RealtimeSTFT``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.windows import dgt_gamma, dual_window, gaussian_dgt_window
from .stft import STFT, RealtimeSTFT

__all__ = ["DGT", "RealtimeDGT"]


class DGT(STFT):
    """Offline DGT.

    Inversion modes: ``pghi`` (default; peak-anchored scan integration, on the
    card one kernel for the recurrence and one for the synthesis),
    ``pghi_bidir``, ``pghi_exact`` (exact heap on the host), ``pghi_gl``,
    ``griffin_lim``, ``random``, ``keep_input`` and ``sinebank``.
    """

    def __init__(
        self,
        sr: int = 44100,
        n_fft: int = 1024,
        hop_length: int = 256,
        inversion_mode: str = "pghi",
        tolerance: float = 1e-2,
        impl: str = "auto",
        seed: int = 0,
        device=None,
    ):
        super().__init__(
            sr=sr,
            n_fft=n_fft,
            hop_length=hop_length,
            inversion_mode=inversion_mode,
            window="hann",  # placeholder; _get_window overrides
            impl=impl,
            seed=seed,
            tolerance=tolerance,
            device=device,
        )

    def _get_window(self) -> torch.Tensor:
        return gaussian_dgt_window(self.n_fft, device=self.device)

    @property
    def gamma(self) -> float:
        return dgt_gamma(self.n_fft)

    @property
    def dual(self) -> torch.Tensor:
        """Canonical dual synthesis window (used by the streaming variant)."""
        return dual_window(self.window, self.hop_length, device=self.device)

    @staticmethod
    def get_inversion_modes() -> List[str]:
        return [
            "pghi",
            "pghi_bidir",
            "griffin_lim",
            "random",
            "keep_input",
            "sinebank",
            "pghi_exact",
            "pghi_gl",
        ]

    # invert_without_phase / pghi / pghi_exact are inherited from STFT: they
    # dispatch on ``self.gamma``, which this class overrides with the exact
    # Gaussian value

    def realtime(self) -> "RealtimeDGT":
        mode = (
            self.inversion_mode
            if self.inversion_mode in RealtimeDGT.get_inversion_modes()
            else "pghi"
        )
        return RealtimeDGT(
            sr=self.sr, n_fft=self.n_fft, hop_length=self.hop_length, inversion_mode=mode,
            tolerance=self.tolerance, impl=self.impl, device=self.device,
        )


class RealtimeDGT(RealtimeSTFT):
    """Streaming DGT: the machinery of :class:`RealtimeSTFT` with the gaussian
    analysis window, its exact ``gamma`` and the scaled canonical dual
    synthesis window.  Its default mode is ``pghi`` (causal RT-PGHI, with this
    transform's ``tolerance``)."""

    def __init__(
        self,
        sr: int = 44100,
        n_fft: int = 1024,
        hop_length: int = 256,
        inversion_mode: str = "pghi",
        tolerance: float = 1e-2,
        batch_size: int = 2,
        impl: str = "auto",
        seed: int = 0,
        gl_iterations: int = 16,
        gl_context: Optional[int] = None,
        lookahead_frames: int = 0,
        device=None,
    ):
        super().__init__(
            sr=sr, n_fft=n_fft, hop_length=hop_length, inversion_mode=inversion_mode,
            window="hann",  # placeholder; _get_window overrides
            impl=impl, seed=seed, batch_size=batch_size, gl_iterations=gl_iterations,
            gl_context=gl_context, lookahead_frames=lookahead_frames, device=device,
        )
        self.tolerance = float(tolerance)

    def _get_window(self) -> torch.Tensor:
        return gaussian_dgt_window(self.n_fft, device=self.device)

    @property
    def gamma(self) -> float:
        return dgt_gamma(self.n_fft)

    @property
    def dual(self) -> torch.Tensor:
        return dual_window(self.window, self.hop_length, device=self.device)

    @staticmethod
    def get_inversion_modes() -> List[str]:
        return ["random", "pghi", "keep_input", "sinebank", "pghi_exact", "pghi_gl"]
