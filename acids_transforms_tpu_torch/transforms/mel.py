"""MFCC: the mel spectrogram transform (twin of the JAX ``transforms/mel.py``).

The reference's ``MFCC`` is a misnomer: it wraps torchaudio's
``MelSpectrogram`` with no DCT.  Kept as the JAX package has it: power
spectrogram -> rectangular mel bank product, output in torchaudio's bin-major
layout ``(..., n_mels, frames)``, not invertible.  ``n_mfcc`` adds a real
cepstral stage (log, then an orthonormal DCT-II); it runs eagerly only.
``fit`` fits the normalizer on the raw input it is handed (the reference's
quirk, kept).  On a CUDA tensor ``fuse_forward`` runs the whole forward of a
``[Mono?] + MFCC`` chain in the log-mel kernel A (``fuse.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.fft import stft as stft_op
from ..ops.mel import mel_banks
from ..ops.windows import hann_window
from .base import AudioTransform, NotInvertibleError
from .norm import Normalize

__all__ = ["MFCC"]


def _dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II ``(n_mels, n_mfcc)``, float32."""
    k = np.arange(n_mels)[:, None]
    c = np.arange(n_mfcc)[None, :]
    d = np.cos(np.pi * (k + 0.5) * c / n_mels) * np.sqrt(2.0 / n_mels)
    d[:, 0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


class MFCC(AudioTransform):
    scriptable = True
    invertible = False

    def __init__(
        self,
        n_fft: int = 1024,
        hop_length: int = 256,
        power: float = 2.0,
        n_mels: int = 128,
        sr: int = 44100,
        norm_mode: Optional[str] = None,
        n_mfcc: Optional[int] = None,
        impl: str = "auto",
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        self.n_fft = int(n_fft)
        self.hop_length = int(hop_length)
        self.power = float(power)
        self.n_mels = int(n_mels)
        self.n_mfcc = int(n_mfcc) if n_mfcc else None
        self.impl = impl
        self.norm = Normalize(mode=norm_mode, device=self.device) if norm_mode is not None else None
        self.register_buffer("window", hann_window(self.n_fft, device=self.device))
        self.register_buffer(
            "mel_bank", torch.as_tensor(mel_banks(self.n_fft, sr, self.n_mels), device=self.device)
        )
        dct = None if self.n_mfcc is None else torch.as_tensor(
            _dct_matrix(self.n_mels, self.n_mfcc), device=self.device)
        self.register_buffer("dct_mat", dct)

    @property
    def needs_scaling(self) -> bool:
        return self.norm is not None

    @property
    def ratio(self) -> int:
        return self.hop_length

    def output_frame_axis(self, axis_in=None):
        return -1  # torchaudio's bin-major layout (..., n_mels, frames)

    def _melspec(self, x: torch.Tensor) -> torch.Tensor:
        spec = stft_op(x, self.n_fft, self.hop_length, self.window, impl=self.impl)
        mel = torch.matmul(spec.abs() ** self.power, self.mel_bank)  # (..., T, n_mels)
        if self.dct_mat is not None:
            mel = torch.matmul(torch.log(torch.clamp_min(mel, 1e-6)), self.dct_mat)
        return mel.transpose(-2, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        y = self._melspec(x)
        if self.norm is not None:
            y = self.norm.forward(y)
        return y

    def fit(self, x: torch.Tensor, mask=None) -> "MFCC":
        if self.norm is None:
            return self
        # fitted on the raw input, as the reference does
        return self.replace(norm=self.norm.fit(x, mask=mask))

    def propagate_mask(self, mask, x):
        if mask is None:
            return None
        T = x.shape[-1] // self.hop_length + 1
        starts = torch.clamp(
            torch.arange(T, device=mask.device) * self.hop_length, 0, mask.shape[-1] - 1
        )
        return mask.index_select(-1, starts)[..., None, :]  # (..., 1, frames)

    def forward_with_time(self, x, time):
        y = self.forward(x)
        # the frame axis is -1 in this layout (the reference counted axis -2,
        # the mels: corrected, as in the JAX package)
        shifts = torch.arange(y.shape[-1], device=y.device, dtype=torch.float32) * (
            self.hop_length / self.sr
        )
        return y, shifts + time[..., None]

    def invert(self, x, inversion_mode=None, generator=None):
        raise NotInvertibleError
