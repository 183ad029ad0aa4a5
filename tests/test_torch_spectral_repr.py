"""The port's representation classes (``transforms/spectral_repr.py``) against
the JAX package's: fit, forward and invert on the same complex spectrum.

The spectrum is the JAX STFT of seeded audio.  Phases are compared on the
unit circle (distance mod 2 pi) and only at bins above 1e-3 of the clip's
largest magnitude, where the angle is defined by the signal rather than by
rounding.  Magnitude-like channels and fitted statistics: float32 products
and sums in another order, 1e-5 relative; the IF (a difference of unwrapped
phases, which grow to ~1e2 rad): 1e-4 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.windows import get_window as jwin
from test_torch_common import HOP, N_FFT, make_audio, rel, t2n


@pytest.fixture(scope="module")
def spec():
    x = make_audio(31, batch=2, n=6000)[:, 0]
    w = jwin("hann", N_FFT)
    return np.array(jfft.stft(jnp.asarray(x), N_FFT, HOP, w)).astype(np.complex64)


def loud(spec, frac=1e-3):
    m = np.abs(spec)
    return m > frac * m.max(axis=(-2, -1), keepdims=True)


def circ(a, b):
    """Distance of two phases on the circle."""
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64)))))


def fit_both(jt, pt, spec):
    jf = jt.fit(jnp.asarray(spec))
    pf = pt.fit(torch.as_tensor(spec))
    return jf, pf


def norm_close(jn, pn, tol=1e-5):
    if isinstance(jn, JT.Normalize):
        assert abs(float(jn.offset) - float(pn.offset)) <= tol * abs(float(jn.scale))
        assert abs(float(jn.scale) - float(pn.scale)) <= tol * abs(float(jn.scale))
    else:
        assert isinstance(pn, PT.Dummy)


@pytest.mark.parametrize("cls,kw", [
    ("Real", {"mode": "gaussian"}),
    ("Imaginary", {"mode": "gaussian"}),
    ("Real", {"mode": "bipolar", "keep_nyquist": False}),
    ("Imaginary", {"mode": None, "keep_nyquist": False}),
])
def test_real_and_imaginary(spec, cls, kw):
    jf, pf = fit_both(getattr(JT, cls)(**kw), getattr(PT, cls)(device="cpu", **kw), spec)
    norm_close(jf.norm, pf.norm)
    jy = np.array(jf.forward(jnp.asarray(spec)))
    py = t2n(pf.forward(torch.as_tensor(spec)))
    assert py.shape == jy.shape and rel(py, jy) <= 1e-5
    ji = np.array(jf.invert(jnp.asarray(jy)))
    pi_ = t2n(pf.invert(torch.as_tensor(jy)))
    assert pi_.shape == ji.shape and rel(pi_, ji) <= 1e-5
    if cls == "Imaginary":           # a real input has no imaginary part
        z = pf.forward(torch.as_tensor(spec.real.copy()))
        assert not z.abs().max().item()


@pytest.mark.parametrize("unwrap", [False, True])
def test_phase(spec, unwrap):
    kw = dict(mode="bipolar", unwrap=unwrap)
    jf, pf = fit_both(JT.Phase(**kw), PT.Phase(device="cpu", **kw), spec)
    norm_close(jf.norm, pf.norm, tol=1e-4)
    jy = np.array(jf.forward(jnp.asarray(spec)))
    py = t2n(pf.forward(torch.as_tensor(spec)))
    scale = float(jf.norm.scale)
    on = loud(spec)
    if unwrap:
        # unwrapped phases grow with the frame index; compare their wrapped values
        assert circ(py * scale, jy * scale)[on].max() <= 1e-4
    else:
        assert circ(py * scale, jy * scale)[on].max() <= 1e-5
    pi_ = t2n(pf.invert(torch.as_tensor(jy)))
    ji = np.array(jf.invert(jnp.asarray(jy)))
    assert circ(pi_, ji)[on].max() <= 1e-5


@pytest.mark.parametrize("method", ["forward", "backward", "central"])
@pytest.mark.parametrize("weighted", [False, True])
def test_if_forward_fit_invert(spec, method, weighted):
    kw = dict(mode="gaussian", method=method, weighted=weighted)
    jf, pf = fit_both(JT.IF(**kw), PT.IF(device="cpu", **kw), spec)
    norm_close(jf.norm, pf.norm, tol=1e-4)
    jy = np.array(jf.forward(jnp.asarray(spec)))
    py = t2n(pf.forward(torch.as_tensor(spec)))
    scale = float(jf.norm.scale)
    assert np.abs((py - jy) * scale)[loud(spec)].max() <= 1e-4
    # the IF integrates back to the phase (central: exact for even T only)
    ph = np.angle(spec)
    pi_ = t2n(pf.invert(torch.as_tensor(py)))
    ji = np.array(jf.invert(jnp.asarray(jy)))
    on = loud(spec)
    if weighted:
        on[..., -1, :] = False          # the window is 0 there: unrecoverable
    assert circ(pi_, ji)[on].max() <= 1e-3
    # the phase itself comes back where the stencil anchors at a recoverable
    # row (weighted backward / central integrate from the zero-weight frame)
    if method == "forward" or (not weighted and (method == "backward" or spec.shape[-2] % 2 == 0)):
        assert circ(pi_, ph)[on].max() <= 1e-3
    assert pf.get_if_methods() == jf.get_if_methods()


def test_if_rejects_unknown_method():
    with pytest.raises(AttributeError):
        PT.IF(method="sideways", device="cpu")


@pytest.mark.parametrize("kind", ["Polar", "PolarIF", "Cartesian"])
@pytest.mark.parametrize("stack,keep", [(-2, True), (None, True), (-1, False)])
def test_stacked_pairs(spec, kind, stack, keep):
    kw = dict(stack=stack, keep_nyquist=keep)
    if kind != "Cartesian":
        kw["magnitude_args"] = {"mode": "bipolar", "n_fft": N_FFT}
    jt, pt = getattr(JT, kind)(**kw), getattr(PT, kind)(device="cpu", **kw)
    jf, pf = fit_both(jt, pt, spec)
    norm_close(jf.magnitude.norm, pf.magnitude.norm, tol=1e-4)
    norm_close(jf.phase.norm, pf.phase.norm, tol=1e-4)
    assert pf.needs_scaling and not pf.magnitude.norm.needs_scaling   # the flag quirk
    jy = jf.forward(jnp.asarray(spec))
    py = pf.forward(torch.as_tensor(spec))
    if stack is None:
        assert isinstance(py, tuple) and len(py) == 2
        jy1, jy2 = (np.asarray(a) for a in jy)
        py1, py2 = (t2n(a) for a in py)
        back = pf.invert((torch.as_tensor(jy1), torch.as_tensor(jy2)))
        jback = np.array(jf.invert((jnp.asarray(jy1), jnp.asarray(jy2))))
    else:
        jy, py = np.asarray(jy), t2n(py)
        assert py.shape == jy.shape
        jy1, jy2 = np.take(jy, 0, axis=stack), np.take(jy, 1, axis=stack)
        py1, py2 = np.take(py, 0, axis=stack), np.take(py, 1, axis=stack)
        back = pf.invert(torch.as_tensor(jy))
        jback = np.array(jf.invert(jnp.asarray(jy)))
    on = loud(spec)[..., : py1.shape[-1]] if keep else loud(spec)[..., 1:]
    assert rel(py1, jy1) <= 1e-4
    s2 = float(jf.phase.norm.scale)
    if kind == "Polar":
        assert circ(py2 * s2, jy2 * s2)[on].max() <= 1e-5
    else:
        assert np.abs((py2 - jy2) * s2)[on].max() <= 1e-4
    back = t2n(back)
    assert back.shape == jback.shape and back.dtype == np.complex64
    onb = loud(spec) if keep else np.concatenate([loud(spec)[..., 1:], np.zeros_like(on[..., :1])], -1)
    assert np.abs(back - jback)[onb].max() <= 1e-4 * np.abs(jback).max()


def test_pair_is_abstract_and_splits_a_stack():
    with pytest.raises(RuntimeError):
        PT.SpectralRepresentation(device="cpu")
    p = PT.Polar(stack=-3, device="cpu")
    x = torch.arange(24.0).reshape(2, 2, 3, 2)
    m, ph = p._split(x)
    assert torch.equal(m, x[:, 0]) and torch.equal(ph, x[:, 1])
