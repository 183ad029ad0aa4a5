"""Real-valued spectral representations over complex STFT frames (twin of the
JAX ``transforms/spectral_repr.py``).

All transforms consume the complex ``(..., frames, bins)`` layout, produce
real tensors, and invert by undoing the normalization (and the mel
pseudo-inverse or the phase integration).  The mel projection and its
pseudo-inverse are single ``torch.matmul`` calls against precomputed square
filterbanks; the IF integration is ``cumsum``-based (``ops/phase.py``).  The
stacked pairs (``Polar``, ``PolarIF``, ``Cartesian``) have a fused forward
and fit on the card (``fuse.py``, kernels in ``ops/cuda/spectral.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ..ops.mel import square_mel_banks
from ..ops.phase import (
    expi,
    fdiff_backward,
    fdiff_central,
    fdiff_forward,
    fint_backward,
    fint_central,
    fint_forward,
    unwrap,
)
from .base import AudioTransform
from .norm import Normalize

__all__ = [
    "Dummy",
    "Real",
    "Imaginary",
    "Magnitude",
    "Phase",
    "IF",
    "SpectralRepresentation",
    "Cartesian",
    "Polar",
    "PolarIF",
]


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

    # ------------------------------------------------------------- test hooks
    def _test_spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """Representations consume complex spectra: an STFT runs first."""
        from .stft import STFT

        return STFT(sr=self.sr, device=self.device).forward(x)

    def test_forward(self, x: torch.Tensor, time=None):
        spec = self._test_spectrum(x)
        self.scale_data(spec)
        out = self.forward(spec)
        return out if time is None else (out, time)

    def test_inversion(self, x: torch.Tensor):
        spec = self._test_spectrum(x)
        self.scale_data(spec)
        return {"inverted": self.invert(self.forward(spec))}


class Real(_Representation):
    """Real part + norm."""

    def _extract(self, x):
        return torch.real(x)

    def forward(self, x):
        self._check(x)
        # the nyquist bin is dropped on the complex input
        return self.norm.forward(torch.real(self._drop_nyquist(x)))


class Imaginary(_Representation):
    """Imaginary part + norm; zeros for a real input."""

    def _extract(self, x):
        return torch.imag(x)

    def forward(self, x):
        self._check(x)
        y = self.norm.forward(torch.imag(x)) if x.is_complex() else torch.zeros_like(x)
        return self._drop_nyquist(y)


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


class Phase(_Representation):
    """``angle(X)`` + optional unwrap + norm."""

    def __init__(
        self,
        sr: int = 44100,
        mode: Optional[str] = None,
        keep_nyquist: bool = True,
        unwrap: bool = False,
        device=None,
    ):
        super().__init__(sr=sr, mode=mode, keep_nyquist=keep_nyquist, device=device)
        self.unwrap = bool(unwrap)

    def _extract(self, x):
        self._check(x)
        p = torch.angle(x)
        return unwrap(p) if self.unwrap else p


IF_METHODS = ("backward", "forward", "central")


class IF(_Representation):
    """Instantaneous frequency: unwrap + frame-axis finite difference, with
    cumulative-sum inversion.

    ``method`` selects the stencil (``backward`` / ``forward`` / ``central``,
    scaled by -pi / pi / 2 pi on the interior rows); ``weighted`` applies a
    parabolic frame window, which the inversion divides back out (the final
    frame, where the window is 0, is unrecoverable).  ``backward`` and
    ``forward`` integrate exactly; ``central`` is exact for even frame counts
    and sets the odd chain's offset by least squares otherwise
    (``ops/phase.py:fint_central``).
    """

    def __init__(
        self,
        sr: int = 44100,
        mode: Optional[str] = "gaussian",
        method: str = "forward",
        weighted: bool = False,
        keep_nyquist: bool = True,
        device=None,
    ):
        super().__init__(sr=sr, mode=mode, keep_nyquist=keep_nyquist, device=device)
        if method not in IF_METHODS:
            raise AttributeError("method %s not known" % method)
        self.method = method
        self.weighted = bool(weighted)

    def get_if_methods(self):
        return list(IF_METHODS)

    def _weight_window(self, n_frames: int, device=None) -> torch.Tensor:
        n = torch.arange(n_frames, dtype=torch.float32, device=device)
        w = (1.5 * n_frames) / (n_frames ** 2 - 1) * (
            1.0 - ((n - (n_frames / 2 - 1)) / (n_frames / 2)) ** 2
        )
        return w[:, None]

    def get_if(self, x: torch.Tensor) -> torch.Tensor:
        return self.get_if_from_phase(torch.angle(x))

    def get_if_from_phase(self, p: torch.Tensor) -> torch.Tensor:
        """IF over an already extracted (wrapped) phase: the entry the fused
        forward's eager formulation shares (``fuse.py``)."""
        p = unwrap(p)
        if self.method == "backward":
            d = fdiff_backward(p)
            d = torch.cat([d[..., :1, :], d[..., 1:, :] / -math.pi], dim=-2)
        elif self.method == "forward":
            d = fdiff_forward(p)
            d = torch.cat([d[..., :-1, :] / math.pi, d[..., -1:, :]], dim=-2)
        else:
            d = fdiff_central(p)
            d = torch.cat([d[..., :1, :], d[..., 1:-1, :] / (2.0 * math.pi), d[..., -1:, :]], dim=-2)
        if self.weighted:
            d = d * self._weight_window(d.shape[-2], d.device)
        return d

    def _extract(self, x):
        self._check(x)
        return self.get_if(x)

    def invert(self, x, inversion_mode=None, generator=None):
        self._check(x)
        d = self.norm.invert(x)
        if self.weighted:
            w = self._weight_window(d.shape[-2], d.device)
            d = torch.where(w.abs() > 1e-12, d / torch.where(w == 0, 1.0, w), d)
        if self.method == "backward":
            d = torch.cat([d[..., :1, :], d[..., 1:, :] * -math.pi], dim=-2)
            p = fint_backward(d)
        elif self.method == "forward":
            d = torch.cat([d[..., :-1, :] * math.pi, d[..., -1:, :]], dim=-2)
            p = fint_forward(d)
        else:
            d = torch.cat([d[..., :1, :], d[..., 1:-1, :] * (2.0 * math.pi), d[..., -1:, :]], dim=-2)
            p = fint_central(d)
        return self._pad_nyquist(p)


SpectralRepresentationType = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class SpectralRepresentation(AudioTransform):
    """Pair of representations (``magnitude``, ``phase``).

    ``forward`` stacks the two on ``stack`` (default -2) or returns a tuple
    when ``stack=None``; ``invert`` splits and recombines ``mag * e^{i
    phase}``.  A fitted pair keeps reporting ``needs_scaling`` (only its
    ``Normalize`` children drop the flag), as the JAX package's does.
    """

    scriptable = True
    invertible = True
    needs_scaling = True

    def __init__(
        self,
        sr: int = 44100,
        magnitude_transform=None,
        phase_transform=None,
        magnitude_args: Optional[dict] = None,
        phase_args: Optional[dict] = None,
        stack: Optional[int] = -2,
        keep_nyquist: bool = True,
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        if type(self) is SpectralRepresentation:
            raise RuntimeError("SpectralRepresentation should not be called directly.")
        self.keep_nyquist = bool(keep_nyquist)
        self.stack = stack
        self.magnitude = magnitude_transform(
            sr=sr, keep_nyquist=keep_nyquist, device=self.device, **(magnitude_args or {})
        )
        self.phase = phase_transform(
            sr=sr, keep_nyquist=keep_nyquist, device=self.device, **(phase_args or {})
        )

    def fit(self, x: torch.Tensor, mask=None) -> "SpectralRepresentation":
        return self.replace(
            magnitude=self.magnitude.fit(x, mask=mask),
            phase=self.phase.fit(x, mask=mask),
        )

    def forward(self, x: torch.Tensor) -> SpectralRepresentationType:
        m = self.magnitude.forward(x)
        p = self.phase.forward(x)
        if self.stack is not None:
            return torch.stack([m, p], dim=self.stack)
        return (m, p)

    def output_frame_axis(self, axis_in=None):
        if axis_in is None:
            return None
        if self.stack is None:
            return axis_in  # tuple output: both halves keep the input layout
        if self.stack >= 0:
            return None  # a front-counted stack dim depends on the batch rank
        return axis_in - 1 if self.stack >= axis_in else axis_in

    def _split(self, x):
        if self.stack is None:
            return x[0], x[1]
        return x.select(self.stack, 0), x.select(self.stack, 1)

    def invert(self, x, inversion_mode=None, generator=None):
        m, p = self._split(x)
        return self.magnitude.invert(m) * expi(self.phase.invert(p))

    # ------------------------------------------------------------- test hooks
    def test_forward(self, x: torch.Tensor, time=None):
        from .stft import STFT

        spec = STFT(sr=self.sr, device=self.device).forward(x)
        self.scale_data(spec)
        out = self.forward(spec)
        return out if time is None else (out, time)

    def test_inversion(self, x: torch.Tensor):
        from .stft import STFT

        stft_t = STFT(sr=self.sr, device=self.device)
        spec = stft_t.forward(x)
        self.scale_data(spec)
        return {"inverted": stft_t.invert(self.invert(self.forward(spec)))}


class Cartesian(SpectralRepresentation):
    """Real + Imaginary pair (gaussian norms by default)."""

    def __init__(
        self,
        sr: int = 44100,
        real_args: Optional[dict] = None,
        imag_args: Optional[dict] = None,
        stack: Optional[int] = -2,
        keep_nyquist: bool = True,
        device=None,
    ):
        super().__init__(
            sr,
            Real,
            Imaginary,
            real_args if real_args is not None else {"mode": "gaussian"},
            imag_args if imag_args is not None else {"mode": "gaussian"},
            stack=stack,
            keep_nyquist=keep_nyquist,
            device=device,
        )

    def invert(self, x, inversion_mode=None, generator=None):
        re, im = self._split(x)
        return torch.complex(self.magnitude.invert(re), self.phase.invert(im))


class Polar(SpectralRepresentation):
    """Magnitude + Phase pair (bipolar norms by default)."""

    def __init__(
        self,
        sr: int = 44100,
        magnitude_args: Optional[dict] = None,
        phase_args: Optional[dict] = None,
        stack: Optional[int] = -2,
        keep_nyquist: bool = True,
        device=None,
    ):
        super().__init__(
            sr,
            Magnitude,
            Phase,
            magnitude_args if magnitude_args is not None else {"mode": "bipolar"},
            phase_args if phase_args is not None else {"mode": "bipolar"},
            stack=stack,
            keep_nyquist=keep_nyquist,
            device=device,
        )


class PolarIF(SpectralRepresentation):
    """Magnitude + Instantaneous Frequency pair (bipolar norms by default)."""

    def __init__(
        self,
        sr: int = 44100,
        magnitude_args: Optional[dict] = None,
        phase_args: Optional[dict] = None,
        stack: Optional[int] = -2,
        keep_nyquist: bool = True,
        device=None,
    ):
        super().__init__(
            sr,
            Magnitude,
            IF,
            magnitude_args if magnitude_args is not None else {"mode": "bipolar"},
            phase_args if phase_args is not None else {"mode": "bipolar"},
            stack=stack,
            keep_nyquist=keep_nyquist,
            device=device,
        )
