"""Raw-domain transforms: channel layout, framing, companding (twin of the
JAX ``transforms/raw.py``).

Elementwise and slice-level ops in plain PyTorch; ``Window`` shares the
framing primitive of the spectral transforms (``ops/framing.py``).  Kept from
the JAX package: ``normalize`` divides by the SIGNED max (a reference quirk,
its PARITY.md), ``Mono.invert`` honours its ``inversion_mode``, ``MuLaw.invert``
reverses every ``one_hot`` mode, and ``Window`` refuses a ``batch_dim`` the
reference never read.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..ops.framing import frame
from ..ops.mulaw import mulaw_decode, mulaw_encode
from .base import AudioTransform

__all__ = ["Mono", "Stereo", "MidSide", "Window", "MuLaw"]


def _signed_max_normalize(x: torch.Tensor) -> torch.Tensor:
    # divides by the SIGNED max, not abs().max(): a signal whose largest
    # magnitude sample is negative is flipped and blown up.  Behaviour kept
    # from the JAX package; Normalize is the well-behaved peak normalizer.
    return x / x.max()


def _one_hot(codes: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot on a new last axis without an int64 intermediate; a code
    outside ``[0, n)`` gives a row of zeros, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(n, dtype=codes.dtype, device=codes.device)
    return (codes[..., None] == classes).to(torch.int32)


class Mono(AudioTransform):
    """Stereo -> mono via ``mix`` / ``left`` / ``right``."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(
        self,
        mode: str = "mix",
        normalize: bool = False,
        squeeze: bool = True,
        inversion_mode: str = "mono",
        sr: int = 44100,
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        if mode not in ("mix", "left", "right"):
            raise ValueError("unknown mono mode %r" % mode)
        self.mode = mode
        self.normalize = bool(normalize)
        self.squeeze = bool(squeeze)
        self.inversion_mode = inversion_mode

    def get_inversion_modes(self) -> List[str]:
        return ["mono", "stereo"]

    def forward(self, x):
        if isinstance(x, list):
            return [self.forward(v) for v in x]
        self._check(x)
        if x.ndim >= 2 and x.shape[-2] == 2:
            if self.mode == "mix":
                x = (x.sum(-2) / 2.0)[..., None, :]
            elif self.mode == "right":
                x = x[..., 1:2, :]
            else:
                x = x[..., 0:1, :]
        if self.normalize:
            x = _signed_max_normalize(x)
        if self.squeeze and x.ndim >= 2 and x.shape[-2] == 1:
            x = x.squeeze(-2)
        return x

    def forward_with_time(self, x, time):
        time = time[..., 0] if self.squeeze else time[..., 0:1]
        return self.forward(x), time

    def propagate_mask(self, mask, x):
        """A channel-free sample mask (ndim = x.ndim - 1) survives the channel
        mix/squeeze unchanged; a mask carrying the channel axis is reduced the
        same way the signal is."""
        if mask is None:
            return None
        if mask.ndim < x.ndim:
            return mask
        if mask.ndim >= 2 and mask.shape[-2] == 2:
            mask = mask.amax(-2)[..., None, :]
        if self.squeeze and mask.ndim >= 2 and mask.shape[-2] == 1:
            mask = mask.squeeze(-2)
        return mask

    def invert(self, x, inversion_mode=None, generator=None):
        mode = self._resolve_mode(inversion_mode)
        if self.squeeze:
            x = x[..., None, :]
        if x.shape[-2] == 1 and mode == "stereo":
            x = torch.cat([x, x], dim=-2)
        return x

    def test_inversion(self, x) -> Dict[str, torch.Tensor]:
        y = self.forward(x)
        return {mode: self.invert(y, inversion_mode=mode) for mode in self.get_inversion_modes()}


class Stereo(AudioTransform):
    """Mono -> stereo by duplication."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(self, normalize: bool = False, sr: int = 44100, device=None):
        super().__init__(sr=sr, device=device)
        self.normalize = bool(normalize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if x.ndim == 1:
            x = torch.stack([x, x], dim=0)
        elif x.shape[-2] == 1:
            x = torch.cat([x, x], dim=-2)
        elif x.shape[-2] > 2:
            raise ValueError("Stereo only works with 1/2 channels")
        if self.normalize:
            x = _signed_max_normalize(x)
        return x

    def invert(self, x, inversion_mode=None, generator=None):
        if x.ndim == 1:
            return torch.stack([x, x], dim=0)
        if x.shape[-2] == 1:
            return torch.cat([x, x], dim=-2)
        if x.shape[-2] > 2:
            return x[..., :2, :]
        return x


class MidSide(AudioTransform):
    """Mid/side encode ``mid = (L+R)/2, side = (L-R)/2`` with optional
    ``1/sqrt(2)`` mid scaling; exact inverse."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(self, sr: int = 44100, normalize: bool = False, pad_mid: bool = True, device=None):
        super().__init__(sr=sr, device=device)
        self.normalize = bool(normalize)
        self.pad_mid = bool(pad_mid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if x.ndim == 1:
            x = torch.stack([x, torch.zeros_like(x)], dim=0)
        elif x.shape[-2] == 1:
            x = torch.cat([x, torch.zeros_like(x)], dim=-2)
        elif x.shape[-2] > 2:
            raise ValueError("MidSide only works with 1 or 2 channels")
        else:
            mid = (x[..., 0, :] + x[..., 1, :]) / 2.0
            side = (x[..., 0, :] - x[..., 1, :]) / 2.0
            if self.pad_mid:
                mid = mid / math.sqrt(2.0)
            x = torch.stack([mid, side], dim=-2)
        if self.normalize:
            x = _signed_max_normalize(x)
        return x

    def invert(self, x, inversion_mode=None, generator=None):
        if x.ndim == 1:
            return torch.stack([x, x], dim=0)
        if x.shape[-2] == 1:
            return torch.cat([x, x], dim=-2)
        mid, side = x[..., 0, :], x[..., 1, :]
        if self.pad_mid:
            mid = mid * math.sqrt(2.0)
        return torch.stack([mid + side, mid - side], dim=-2)


class Window(AudioTransform):
    """Overlapping framing as a standalone transform: ``dim`` of ``(...,
    L, ...)`` becomes ``(..., n_frames, window_size, ...)``."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(
        self,
        sr: int = 44100,
        window_size: int = 1024,
        hop_size: Optional[int] = 256,
        dim: int = -1,
        batch_dim: int = 0,
        inversion_mode: str = "crop",
        device=None,
    ):
        super().__init__(sr=sr, device=device)
        self.window_size = int(window_size)
        self.hop_size = int(hop_size) if hop_size else self.window_size
        if self.window_size < self.hop_size:
            raise ValueError("window_size must be >= hop_size")
        self.dim = int(dim)
        if int(batch_dim) != 0:
            # the reference accepts `batch_dim` but never reads it: refused
            # rather than silently ignored
            raise ValueError("Window only supports batch_dim=0 (leading batch axes)")
        self.batch_dim = int(batch_dim)
        self.inversion_mode = inversion_mode

    def get_inversion_modes(self) -> List[str]:
        return ["crop"]

    @property
    def ratio(self) -> int:
        return self.hop_size

    def output_frame_axis(self, axis_in=None):
        return -2 if self.dim == -1 else None

    def propagate_mask(self, mask, x):
        if mask is None or self.dim != -1:
            return None
        T = max((x.shape[-1] - self.window_size) // self.hop_size, 0) + 1
        starts = torch.clamp(
            torch.arange(T, device=mask.device) * self.hop_size, 0, mask.shape[-1] - 1
        )
        return mask.index_select(-1, starts)[..., :, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return frame(x, self.window_size, self.hop_size, self.dim)

    def forward_with_time(self, x, time):
        chunks = self.forward(x)
        shifts = torch.arange(chunks.shape[-2], device=chunks.device, dtype=torch.float32) * (
            self.hop_size / self.sr
        )
        return chunks, shifts + time[..., None]

    def invert(self, x, inversion_mode=None, generator=None):
        # forward put the frame axis at `dim` and the window axis right after
        # it; for a negative dim the window axis lands at ndim + dim
        if self.dim >= 0:
            f_axis, w_axis = self.dim, self.dim + 1
        else:
            w_axis = x.ndim + self.dim
            f_axis = w_axis - 1
        if self.window_size == self.hop_size:
            # exact: merge the frame and window axes
            return x.reshape(
                x.shape[:f_axis] + (x.shape[f_axis] * x.shape[w_axis],) + x.shape[w_axis + 1:]
            )
        # "crop": the first hop samples of each frame and the last frame's tail
        x_moved = torch.movedim(x, (f_axis, w_axis), (-2, -1))
        head = x_moved[..., :, : self.hop_size]
        head = head.reshape(head.shape[:-2] + (head.shape[-2] * self.hop_size,))
        out = torch.cat([head, x_moved[..., -1, self.hop_size:]], dim=-1)
        return torch.movedim(out, -1, f_axis)


class MuLaw(AudioTransform):
    """Mu-law companding to int32 codes with optional one-hot encodings.

    ``one_hot``: ``"none"`` -> integer codes; ``"categorical"`` -> int32
    one-hot on a new last axis; ``"channel"`` -> that one-hot with its last
    two axes swapped.  ``invert`` reverses ``forward`` for every mode."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(self, channels: int = 256, one_hot: str = "none", sr: int = 44100, device=None):
        super().__init__(sr=sr, device=device)
        if one_hot not in ("none", "channel", "categorical"):
            raise ValueError("unknown one_hot mode %r" % one_hot)
        self.channels = int(channels)
        self.one_hot = one_hot

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        codes = mulaw_encode(x, self.channels)
        if self.one_hot == "channel":
            return _one_hot(codes, self.channels).transpose(-1, -2)
        if self.one_hot == "categorical":
            return _one_hot(codes, self.channels)
        return codes

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        if self.one_hot == "channel":
            x = torch.argmax(x, dim=-2)
        elif self.one_hot == "categorical":
            x = torch.argmax(x, dim=-1)
        return mulaw_decode(x, self.channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)

    def invert(self, x, inversion_mode=None, generator=None):
        return self.decode(x)

    def propagate_mask(self, mask, x):
        # the one-hot modes change the layout; only the plain codes keep it
        return mask if self.one_hot == "none" else None
