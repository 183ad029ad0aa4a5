"""Offline STFT transform (twin of the JAX ``transforms/stft.py:STFT``).

Ported: forward, the complex least-squares inversion and the phaseless
``griffin_lim`` mode.  The other phaseless modes (``keep_input``, ``random``,
``sinebank``, the PGHI family) and ``RealtimeSTFT`` raise
``NotImplementedError`` until their slice (ROADMAP Queue 1 items 8 and 9).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.fft import istft, stft as stft_op, taps_for_window
from ..ops.griffinlim import griffin_lim
from ..ops.windows import get_window
from .base import AudioTransform

__all__ = ["STFT"]

_UNPORTED_MODES = {
    "keep_input": "Queue 1 item 8",
    "random": "Queue 1 item 8",
    "sinebank": "Queue 1 item 8",
    "pghi": "Queue 1 item 8 / Queue 2 K6",
    "pghi_bidir": "Queue 1 item 8 / Queue 2 K6",
    "pghi_gl": "Queue 1 item 8 / Queue 2 K6",
    "pghi_exact": "Queue 1 item 8",
}


class STFT(AudioTransform):
    """Offline STFT with phaseless inversion.

    Inversion modes: ``griffin_lim`` (default) is ported; ``keep_input``,
    ``random``, ``sinebank`` and the PGHI family are known names that raise
    ``NotImplementedError`` for now.
    """

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(
        self,
        sr: int = 44100,
        n_fft: int = 1024,
        hop_length: int = 256,
        inversion_mode: str = "griffin_lim",
        window: str = "hann",
        impl: str = "auto",
        seed: int = 0,
        gl_iterations: int = 30,
        gl_momentum: float = 0.99,
        tolerance: float = 1e-2,
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        self.window_name = window
        self.impl = impl
        self.gl_iterations = int(gl_iterations)
        self.gl_momentum = float(gl_momentum)
        self.tolerance = float(tolerance)
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self.seed = int(seed)
        self._draws = 0
        self._refresh_windows()
        if inversion_mode not in self.get_inversion_modes():
            raise ValueError("Inversion mode %s not known" % inversion_mode)
        self.inversion_mode = inversion_mode

    # ------------------------------------------------------------- parameters
    def _get_window(self) -> torch.Tensor:
        return get_window(self.window_name, self.n_fft, device=self.device)

    def _get_inv_window(self) -> torch.Tensor:
        # the offline ISTFT divides by the squared-window envelope, so
        # synthesis = analysis gives the exact least-squares inverse
        return self._get_window()

    def _refresh_windows(self) -> None:
        for name, w in (("window", self._get_window()), ("inv_window", self._get_inv_window())):
            if name in self._buffers:
                self._buffers[name] = w
            else:
                self.register_buffer(name, w)
        self._refresh_taps()

    def _refresh_taps(self) -> None:
        """Cosine-sum spectral taps of the two windows (None otherwise):
        consumed by ``impl="factored"`` and by the fused kernels' dispatch."""
        self._window_taps = taps_for_window(self.window)
        self._inv_window_taps = taps_for_window(self.inv_window)

    def set_params(self, n_fft: int, hop_length: int) -> None:
        """Reconfigure in place (rebuilds the window buffers)."""
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self._refresh_windows()

    @property
    def ratio(self) -> int:
        return self.hop_length

    def propagate_mask(self, mask, x):
        """Sample mask (..., L) -> frame mask (..., T, 1): a frame is real iff
        the sample at its hop-start is real."""
        if mask is None:
            return None
        T = x.shape[-1] // self.hop_length + 1
        starts = torch.clamp(
            torch.arange(T, device=mask.device) * self.hop_length, 0, mask.shape[-1] - 1
        )
        return mask.index_select(-1, starts)[..., :, None]

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    # ---------------------------------------------------------------- modes
    @staticmethod
    def get_inversion_modes() -> List[str]:
        return ["griffin_lim", "keep_input", "random", "sinebank", "pghi", "pghi_bidir", "pghi_gl", "pghi_exact"]

    def set_inversion_mode(self, inversion_mode: str) -> None:
        if inversion_mode not in self.get_inversion_modes():
            raise ValueError("inversion mode %s not valid" % inversion_mode)
        self.inversion_mode = inversion_mode

    # -------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(..., L) -> complex (..., T, n_fft//2 + 1)``."""
        self._check(x)
        return stft_op(
            x, self.n_fft, self.hop_length, self.window, impl=self.impl,
            taps=self._window_taps,
        )

    # ---------------------------------------------------------------- invert
    def invert(
        self,
        x: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        self._check(x)
        if not x.is_complex():
            return self.invert_without_phase(
                x, inversion_mode, generator=generator, init_phase=init_phase
            )
        return istft(
            x, self.n_fft, self.hop_length, self.inv_window, impl=self.impl,
            taps=self._inv_window_taps,
        )

    def invert_without_phase(
        self,
        mag: torch.Tensor,
        inversion_mode: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        mode = self._resolve_mode(inversion_mode)
        if mode == "griffin_lim":
            return self.griffin_lim(mag, generator=generator, init_phase=init_phase)
        if mode in _UNPORTED_MODES:
            raise NotImplementedError(
                "STFT inversion mode %r is not ported yet (ROADMAP %s)"
                % (mode, _UNPORTED_MODES[mode])
            )
        raise ValueError("inversion mode %s not valid." % mode)

    def _next_generator(self) -> torch.Generator:
        """A generator for one random draw: a function of ``seed`` and of how
        many draws this transform has made, so repeated calls differ."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + self._draws)
        self._draws += 1
        return g

    def griffin_lim(
        self,
        mag: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        init_phase: Optional[torch.Tensor] = None,
        fused: Optional[bool] = None,
    ) -> torch.Tensor:
        """Momentum Griffin-Lim (defaults: 30 iterations, momentum 0.99;
        configurable via ``gl_iterations`` / ``gl_momentum``)."""
        if generator is None and init_phase is None:
            generator = self._next_generator()
        return griffin_lim(
            mag,
            self.n_fft,
            self.hop_length,
            self.inv_window,
            n_iter=self.gl_iterations,
            momentum=self.gl_momentum,
            generator=generator,
            impl=self.impl,
            init_phase=init_phase,
            taps=self._inv_window_taps,
            fused=fused,
        )

    def extra_repr(self) -> str:
        return "n_fft=%d, hop_length=%d, inversion_mode=%s" % (
            self.n_fft, self.hop_length, self.inversion_mode,
        )
