"""Analysis / synthesis window construction (twin of the JAX ``ops/windows.py``).

Numerics match the periodic torch builders (``torch.hann_window`` etc.); the
windows are computed in float64 numpy and cast, so both packages hold the same
float32 values.  The truncated Gaussian of the DGT and the per-window
time-frequency ratios (``gamma``) that PGHI needs are here as well.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "get_window",
    "hann_window",
    "hamming_window",
    "blackman_window",
    "bartlett_window",
    "kaiser_window",
    "gaussian_dgt_window",
    "dgt_lambda",
    "dgt_gamma",
    "window_gamma",
    "window_envelope",
    "dual_window",
]


def _as_tensor(w: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(w, dtype=np.float64), dtype=dtype, device=device)


def hann_window(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Hann window, equal to ``torch.hann_window(n)``."""
    k = np.arange(n)
    return _as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * k / n), dtype, device)


def hamming_window(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Hamming window, equal to ``torch.hamming_window(n)``."""
    k = np.arange(n)
    return _as_tensor(0.54 - 0.46 * np.cos(2.0 * np.pi * k / n), dtype, device)


def blackman_window(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Blackman window, equal to ``torch.blackman_window(n)``."""
    k = np.arange(n)
    w = (
        0.42
        - 0.5 * np.cos(2.0 * np.pi * k / n)
        + 0.08 * np.cos(4.0 * np.pi * k / n)
    )
    return _as_tensor(w, dtype, device)


def bartlett_window(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Bartlett window, equal to ``torch.bartlett_window(n)``."""
    k = np.arange(n)
    return _as_tensor(1.0 - np.abs(2.0 * k / n - 1.0), dtype, device)


def kaiser_window(n: int, dtype=torch.float32, device="cpu", beta: float = 12.0) -> torch.Tensor:
    """Periodic Kaiser window, equal to ``torch.kaiser_window(n)`` at its defaults."""
    k = np.arange(n)
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - ((k - n / 2.0) / (n / 2.0)) ** 2))
    return _as_tensor(np.i0(arg) / np.i0(beta), dtype, device)


_WINDOWS = {
    "hann": hann_window,
    "hamming": hamming_window,
    "blackman": blackman_window,
    "bartlett": bartlett_window,
    "kaiser": kaiser_window,
}


def get_window(name: str, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Resolve a window by name."""
    if name not in _WINDOWS:
        raise ValueError("Window %s is not known" % name)
    return _WINDOWS[name](n, dtype=dtype, device=device)


def dgt_lambda(n_fft: int) -> float:
    """Gaussian width parameter ``lambda = sqrt(-n_fft^2 / (8 ln 0.01))``."""
    return float((-(n_fft ** 2) / (8.0 * math.log(0.01))) ** 0.5)


#: time-frequency ratio constants ``gamma = c * n_fft^2``: the Gaussian
#: equivalent of each window, which lets PGHI run on non-Gaussian STFTs.
#: hann/hamming/blackman are the published values (Prusa & Sondergaard,
#: "Real-Time Spectrogram Inversion Using Phase Gradient Heap Integration");
#: kaiser (beta 12) and bartlett come from the same least-squares Gaussian fit.
_WINDOW_GAMMA_C = {
    "hann": 0.25645,
    "hamming": 0.29794,
    "blackman": 0.17954,
    "kaiser": 0.12808,
    "bartlett": 0.31743,
}


def window_gamma(name: str, n_fft: int) -> float:
    """Effective PGHI gamma for a named (non-Gaussian) analysis window."""
    if name not in _WINDOW_GAMMA_C:
        raise ValueError("no PGHI gamma constant for window %r" % name)
    return float(_WINDOW_GAMMA_C[name] * n_fft * n_fft)


def dgt_gamma(n_fft: int) -> float:
    """Time-frequency ratio ``gamma = 2 pi lambda^2`` of the DGT's Gaussian."""
    lam = dgt_lambda(n_fft)
    return float(2.0 * math.pi * lam * lam)


def gaussian_dgt_window(n_fft: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Truncated Gaussian DGT analysis window.

    Sampled on the odd points of a ``2 n_fft + 1`` grid centred at ``n_fft``:
    ``w[i] = exp(-n_i^2 / (2 (2 lambda)^2))`` with ``n_i in {1-N, 3-N, ...}``,
    about 0.01 at the edges."""
    lam = dgt_lambda(n_fft)
    n = np.arange(0, 2 * n_fft + 1) - (2 * n_fft) / 2.0
    w = np.exp(-(n ** 2) / (2.0 * (2.0 * lam) ** 2))
    return _as_tensor(w[1: 2 * n_fft + 1: 2], dtype, device)


def window_envelope(window, hop: int) -> np.ndarray:
    """Periodic squared-window OLA envelope ``E[r] = sum_{j = r mod hop} w[j]^2``."""
    w = np.asarray(window, dtype=np.float64)
    n = w.shape[0]
    hop = int(hop)
    n_pad = -(-n // hop) * hop
    w2 = np.zeros(n_pad)
    w2[:n] = w ** 2
    return w2.reshape(-1, hop).sum(axis=0)


def dual_window(window, hop: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Canonical dual synthesis window ``d[l] = w[l] / E[l mod hop]``: plain
    overlap-add of ``d``-windowed inverse frames reconstructs the
    ``w``-analysed signal exactly."""
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    w = np.asarray(window, dtype=np.float64)
    env = window_envelope(w, hop)
    denom = env[np.arange(w.shape[0]) % int(hop)]
    denom = np.where(denom == 0.0, 1.0, denom)
    return _as_tensor(w / denom, dtype, device)
