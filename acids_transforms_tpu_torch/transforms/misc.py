"""Shape utilities: Unsqueeze / Squeeze / Transpose / OneHot (twin of the JAX
``transforms/misc.py``).

``output_frame_axis`` follows a negative frame axis through each reshaping;
a front-counted ``dim`` moves it by an amount that depends on the rank, so
it reports ``None``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .base import AudioTransform, NotInvertibleError
from .raw import _one_hot

__all__ = ["Unsqueeze", "Squeeze", "Transpose", "OneHot"]


class Unsqueeze(AudioTransform):
    """Insert a singleton axis."""

    scriptable = True
    needs_scaling = False

    def __init__(self, sr: int = 44100, dim: int = 1, device=None):
        super().__init__(sr=sr, device=device)
        self.dim = dim

    @property
    def invertible(self) -> bool:
        return self.dim is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.unsqueeze(self.dim)

    def invert(self, x, inversion_mode=None, generator=None):
        return x.squeeze(self.dim)

    def output_frame_axis(self, axis_in=None):
        if axis_in is None or self.dim is None or self.dim >= 0:
            return None
        return axis_in - 1 if self.dim >= axis_in else axis_in

    def propagate_mask(self, mask, x):
        if mask is None:
            return None
        return mask.unsqueeze(self.dim) if mask.ndim == x.ndim else None


class Squeeze(AudioTransform):
    """Drop singleton axes; a full squeeze (``dim=None``) is not invertible.
    Squeezing a non-singleton ``dim`` is a no-op (torch semantics)."""

    scriptable = True
    needs_scaling = False

    def __init__(self, sr: int = 44100, dim: Optional[int] = None, device=None):
        super().__init__(sr=sr, device=device)
        self.dim = dim

    @property
    def invertible(self) -> bool:
        return self.dim is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.squeeze() if self.dim is None else x.squeeze(self.dim)

    def invert(self, x, inversion_mode=None, generator=None):
        if self.dim is None:
            raise NotInvertibleError
        return x.unsqueeze(self.dim)

    def output_frame_axis(self, axis_in=None):
        if axis_in is None or self.dim is None or self.dim >= 0 or self.dim == axis_in:
            return None
        return axis_in + 1 if self.dim > axis_in else axis_in

    def propagate_mask(self, mask, x):
        if mask is None:
            return None
        return self.forward(mask) if mask.shape == x.shape else None


class Transpose(AudioTransform):
    """Swap two axes; self-inverse.  ``contiguous`` makes the forward's
    result contiguous, as the reference's did."""

    scriptable = True
    invertible = True
    needs_scaling = False

    def __init__(self, dims: Tuple[int, int] = (-2, -1), contiguous: bool = True, sr: int = 44100,
                 device=None):
        super().__init__(sr=sr, device=device)
        self.dims = tuple(dims)
        self.contiguous = bool(contiguous)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = x.transpose(self.dims[0], self.dims[1])
        return x.contiguous() if self.contiguous else x

    def invert(self, x, inversion_mode=None, generator=None):
        return self.forward(x)

    def output_frame_axis(self, axis_in=None):
        if axis_in is None:
            return None
        d0, d1 = self.dims
        if d0 >= 0 or d1 >= 0:
            return None
        if axis_in == d0:
            return d1
        if axis_in == d1:
            return d0
        return axis_in

    def propagate_mask(self, mask, x):
        if mask is None:
            return None
        return self.forward(mask) if mask.ndim == x.ndim else None


class OneHot(AudioTransform):
    """Integer codes -> int32 one-hot on a new last axis; invert by argmax.

    ``n_classes=-1`` defers the class count to ``fit`` / ``scale_data``,
    which read ``max + 1`` from the data on the host: eager only."""

    scriptable = True
    invertible = True

    def __init__(self, sr: int = 44100, n_classes: int = -1, device=None):
        super().__init__(sr=sr, device=device)
        self.n_classes = int(n_classes)

    @property
    def needs_scaling(self) -> bool:
        return self.n_classes == -1

    def _count(self, x: torch.Tensor, mask) -> int:
        self._check(x)
        if mask is not None:
            x = torch.where((mask > 0).expand(x.shape), x, torch.zeros_like(x))
        return int(x.max().item()) + 1

    def scale_data(self, x: torch.Tensor, mask=None) -> None:
        self.n_classes = self._count(x, mask)

    def fit(self, x: torch.Tensor, mask=None) -> "OneHot":
        return self.replace(n_classes=self._count(x, mask))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if self.n_classes < 0:
            raise ValueError("OneHot used before scale_data set n_classes")
        return _one_hot(x, self.n_classes)

    def invert(self, x, inversion_mode=None, generator=None):
        return torch.argmax(x, dim=-1)

    # ------------------------------------------------------------- test hooks
    def _test_codes(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """OneHot consumes integer codes: draw 1000 per leading index of
        ``x`` in [0, 256) from ``generator`` (a fresh one seeded 0 if None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return torch.randint(0, 256, tuple(x.shape[:-1]) + (1000,), generator=generator,
                             device=self.device)

    def test_forward(self, x, time=None, generator: Optional[torch.Generator] = None):
        codes = self._test_codes(x, generator)
        self.scale_data(codes)
        out = self.forward(codes)
        return out if time is None else (out, time)

    def test_inversion(self, x, generator: Optional[torch.Generator] = None):
        codes = self._test_codes(x, generator)
        self.scale_data(codes)
        return {"inverted": self.invert(self.forward(codes))}
