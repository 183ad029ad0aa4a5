"""The DGT's gaussian window, its time-frequency ratio, the per-window PGHI
constants, the two windows that were still missing (bartlett, kaiser) and the
dual window, against the JAX functions on the CPU.  Both packages build their
windows in float64 numpy and cast, so 1e-6 relative is generous: most are
equal bit for bit."""
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import windows as jwin
from acids_transforms_tpu_torch.ops import windows as pwin
from test_torch_common import t2n

TOL = 1e-6


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("n_fft", [256, 512, 768, 1024, 2048])
def test_gaussian_window_and_gamma_equal_jax(n_fft):
    w = pwin.gaussian_dgt_window(n_fft)
    assert w.dtype == torch.float32 and w.shape == (n_fft,)
    assert close(t2n(w), jwin.gaussian_dgt_window(n_fft))
    assert abs(float(w[0]) - 0.01) < 2e-3 and float(w.max()) > 0.99   # about 0.01 at the edges
    assert pwin.dgt_lambda(n_fft) == jwin.dgt_lambda(n_fft)
    assert pwin.dgt_gamma(n_fft) == jwin.dgt_gamma(n_fft)
    assert close(t2n(pwin.gaussian_dgt_window(n_fft, dtype=torch.float64)),
                 np.asarray(jwin.gaussian_dgt_window(n_fft)))


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "kaiser", "bartlett"])
def test_window_gamma_equals_jax(name):
    for n_fft in (512, 1024):
        assert pwin.window_gamma(name, n_fft) == jwin.window_gamma(name, n_fft)
    assert pwin._WINDOW_GAMMA_C == jwin._WINDOW_GAMMA_C


def test_window_gamma_unknown_raises():
    with pytest.raises(ValueError, match="gamma"):
        pwin.window_gamma("gaussian", 512)


@pytest.mark.parametrize("name", ["bartlett", "kaiser"])
@pytest.mark.parametrize("n", [512, 384])
def test_bartlett_kaiser_equal_jax_and_torch(name, n):
    w = t2n(pwin.get_window(name, n))
    assert close(w, jwin.get_window(name, n))
    ref = getattr(torch, name + "_window")(n, periodic=True, dtype=torch.float64).numpy()
    assert np.abs(w - ref).max() <= 1e-6


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256), (768, 192), (512, 64)])
def test_dgt_dual_window_equals_jax(n_fft, hop):
    from acids_transforms_tpu import transforms as JT
    from acids_transforms_tpu_torch import transforms as PT

    jd = JT.DGT(n_fft=n_fft, hop_length=hop)
    pd = PT.DGT(n_fft=n_fft, hop_length=hop, device="cpu")
    assert close(t2n(pd.window), jd.window) and close(t2n(pd.inv_window), jd.inv_window)
    assert close(t2n(pd.dual), jd.dual)
    assert pd.gamma == jd.gamma and pd._window_taps is None
    assert pd.get_inversion_modes() == jd.get_inversion_modes()
    # painless-frame condition of the dual: sum_k w(n - k hop) d(n - k hop) = 1
    prod = (t2n(pd.window).astype(np.float64) * t2n(pd.dual)).reshape(-1, hop).sum(0)
    assert np.abs(prod - 1.0).max() <= 1e-6
