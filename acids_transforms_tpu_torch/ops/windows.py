"""Analysis / synthesis window construction (twin of the JAX ``ops/windows.py``).

Numerics match the periodic torch builders (``torch.hann_window`` etc.); the
windows are computed in float64 numpy and cast, so both packages hold the same
float32 values.  Only the windows the ported transforms use are here; the
gaussian DGT window and ``window_gamma`` wait for the DGT/PGHI slice.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "get_window",
    "hann_window",
    "hamming_window",
    "blackman_window",
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


_WINDOWS = {
    "hann": hann_window,
    "hamming": hamming_window,
    "blackman": blackman_window,
}

_UNPORTED = ("bartlett", "kaiser", "gaussian")


def get_window(name: str, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Resolve a window by name."""
    if name in _UNPORTED:
        raise NotImplementedError(
            "window %r is not ported yet (ROADMAP Queue 1 item 8: DGT and the "
            "non-cosine windows)" % name
        )
    if name not in _WINDOWS:
        raise ValueError("Window %s is not known" % name)
    return _WINDOWS[name](n, dtype=dtype, device=device)


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
