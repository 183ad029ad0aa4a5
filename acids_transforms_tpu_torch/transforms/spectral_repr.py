"""Real-valued spectral representations over complex STFT frames (twin of the
JAX ``transforms/spectral_repr.py``).

Ported: ``Dummy``, the ``_Representation`` base and ``Magnitude``.  ``Real``,
``Imaginary``, ``Phase``, ``IF`` and the stacked representations wait (ROADMAP
Queue 1 item 8).  The mel projection and its pseudo-inverse are single
``torch.matmul`` calls against precomputed square filterbanks.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.mel import square_mel_banks
from .base import AudioTransform
from .norm import Normalize

__all__ = ["Dummy", "Magnitude"]


class Dummy(AudioTransform):
    """Identity stand-in used when ``mode=None``."""


class _Representation(AudioTransform):
    """Shared base: owns a :class:`Normalize` (or :class:`Dummy`), handles the
    ``keep_nyquist`` bin-drop/re-pad."""

    scriptable = True
    invertible = True
    needs_scaling = True

    def __init__(
        self,
        sr: int = 44100,
        mode: Optional[str] = None,
        keep_nyquist: bool = True,
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        if mode is None or mode == "none":
            self.norm: AudioTransform = Dummy(device=self.device)
        else:
            self.norm = Normalize(mode, device=self.device)
        self.keep_nyquist = bool(keep_nyquist)

    # subclasses define the real-valued extraction used by forward/fit
    def _extract(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _drop_nyquist(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.keep_nyquist else x[..., 1:]

    def _pad_nyquist(self, x: torch.Tensor) -> torch.Tensor:
        if self.keep_nyquist:
            return x
        return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._drop_nyquist(self.norm.forward(self._extract(x)))

    def fit(self, x: torch.Tensor, mask=None) -> "_Representation":
        return self.replace(norm=self.norm.fit(self._extract(x), mask=mask))

    def invert(self, x, inversion_mode=None, generator=None):
        return self._pad_nyquist(self.norm.invert(x))


class Magnitude(_Representation):
    """|X| -> optional square-mel product -> contrast -> norm.

    The mel pair: column-normalized forward bank, row-normalized transposed
    pseudo-inverse, ``n_mels = n_bins`` (``mel_inverse="pinv"`` swaps in a
    regularized least-squares inverse).  Contrast modes: ``log1p`` (default)
    / ``log`` / ``log10`` / ``none`` with exact inverses.
    """

    def __init__(
        self,
        sr: int = 44100,
        mode: Optional[str] = "unipolar",
        contrast: Optional[str] = "log1p",
        mel: bool = True,
        n_fft: int = 1024,
        eps: Optional[float] = None,
        keep_nyquist: bool = True,
        mel_inverse: str = "transpose",
        norm: Optional[str] = None,
        device=None,
    ):
        # `norm=` is an alias of `mode=` (overrides it)
        if norm is not None:
            mode = norm
        super().__init__(sr=sr, mode=mode, keep_nyquist=keep_nyquist, device=device)
        if contrast not in ("log1p", "log", "log10", "none", None):
            raise TypeError("unknown contrast type %s" % contrast)
        self.contrast_mode = contrast
        self.mel = bool(mel)
        self.n_fft = int(n_fft)
        self.eps = float(eps if eps is not None else torch.finfo(torch.float32).eps)
        self.mel_inverse = mel_inverse
        fwd, inv = square_mel_banks(
            self.n_fft, sr, keep_nyquist=self.keep_nyquist, inverse=mel_inverse
        )
        self.register_buffer("mel_bank", torch.as_tensor(fwd, device=self.device))
        self.register_buffer("inverse_mel_bank", torch.as_tensor(inv, device=self.device))

    # ------------------------------------------------------------- contrast
    def contrast(self, mag: torch.Tensor) -> torch.Tensor:
        if self.contrast_mode == "log1p":
            return torch.log1p(mag)
        if self.contrast_mode == "log":
            return torch.log(torch.clamp_min(mag, self.eps))
        if self.contrast_mode == "log10":
            return torch.log10(torch.clamp_min(mag, self.eps))
        return mag

    def invert_contrast(self, mag: torch.Tensor) -> torch.Tensor:
        if self.contrast_mode == "log1p":
            return torch.expm1(mag)
        if self.contrast_mode == "log":
            return torch.exp(mag) - self.eps
        if self.contrast_mode == "log10":
            return torch.pow(10.0, mag)
        return mag

    # ---------------------------------------------------------------- api
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        mag = x.abs()
        if self.mel:
            mag = torch.matmul(mag, self.mel_bank)
        mag = self.contrast(mag)
        mag = self.norm.forward(mag)
        return self._drop_nyquist(mag)

    def invert(self, x, inversion_mode=None, generator=None):
        self._check(x)
        mag = self.norm.invert(x)
        mag = self._pad_nyquist(mag)
        mag = self.invert_contrast(mag)
        if self.mel:
            mag = torch.matmul(mag, self.inverse_mel_bank)
        return mag

    def fit(self, x: torch.Tensor, mask=None) -> "Magnitude":
        # the norm is fitted on the *non-mel* contrasted magnitude (a quirk
        # kept from the package this one mirrors)
        stats_in = self.contrast(x.abs())
        return self.replace(norm=self.norm.fit(stats_in, mask=mask))
