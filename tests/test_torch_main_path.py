"""The slice as a whole: fit -> fused forward -> Griffin-Lim invert of the
flagship chain ``Mono + STFT + Magnitude(unipolar, log1p, mel)`` in the port
(``device="cpu"``: kernel wrappers run their plain versions) against the JAX
chain with its Pallas kernels in interpret mode, on the same numpy audio.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu as jatt
import acids_transforms_tpu_torch as patt
from acids_transforms_tpu.ops.griffinlim import griffin_lim as jgl
from test_torch_common import HOP, N_FFT, carry_over, chains, make_audio, rel, t2n


@pytest.fixture(scope="module")
def both():
    jc, pc = chains(gl_iterations=6)
    x = make_audio(31, batch=2, n=11000)
    jf = jatt.fuse_fit(jc, backend="pallas")(jnp.asarray(x))
    pf = patt.fuse_fit(pc, backend="kernel")(torch.as_tensor(x))
    return x, jf, pf


def test_fit_agrees(both):
    _, jf, pf = both
    s = float(jf[2].norm.scale)
    # <= 1e-4 of the scale: the JAX statistics come out of bf16x3 products
    assert abs(float(pf[2].norm.offset) - float(jf[2].norm.offset)) <= 1e-4 * s
    assert abs(float(pf[2].norm.scale) - s) <= 1e-4 * s


def test_forward_agrees(both):
    x, jf, pf = both
    yj = np.asarray(jatt.fuse_forward(jf, backend="pallas")(jnp.asarray(x)))
    yp = patt.fuse_forward(pf, backend="kernel")(torch.as_tensor(x))
    assert tuple(yp.shape) == yj.shape == (2, 1 + 11000 // HOP, N_FFT // 2 + 1)
    assert rel(t2n(yp), yj) <= 1e-4
    # a JAX-fitted chain loaded into the port gives the same forward
    _, pc = chains(gl_iterations=6)
    carry_over(jf, pc)
    assert rel(t2n(patt.fuse_forward(pc, backend="kernel")(torch.as_tensor(x))), yj) <= 1e-4
    assert rel(t2n(patt.fuse_forward(pc)(torch.as_tensor(x))), yj) <= 1e-4  # auto: eager on the CPU


def test_inversion_agrees_in_spectral_convergence(both):
    x, jf, pf = both
    y = patt.fuse_forward(pf, backend="kernel")(torch.as_tensor(x))
    mag_p = pf[2].invert(y)                              # the inversion input
    mag_j = np.asarray(jf[2].invert(jnp.asarray(t2n(y))))
    assert rel(t2n(mag_p), mag_j) <= 1e-4
    ph = np.random.default_rng(32).uniform(0, 2 * np.pi, mag_j.shape).astype(np.float32)
    stft_p, stft_j = pf[1], jf[1]
    rec_p = stft_p.griffin_lim(mag_p, init_phase=torch.as_tensor(ph), fused=True)
    rec_e = stft_p.griffin_lim(mag_p, init_phase=torch.as_tensor(ph), fused=False)
    rec_j = jgl(jnp.asarray(mag_j), N_FFT, HOP, stft_j.inv_window, n_iter=6,
                init_phase=jnp.asarray(ph), taps=stft_j._inv_window_taps, fused=True)

    def sc(rec):
        R = t2n(stft_p.forward(torch.as_tensor(np.array(rec))).abs())
        return float(np.linalg.norm(R - mag_j) / np.linalg.norm(mag_j))

    s_p, s_e, s_j = sc(t2n(rec_p)), sc(t2n(rec_e)), sc(np.asarray(rec_j))
    assert s_p < max(1.15 * s_j, s_j + 0.02)             # port kernel loop vs JAX kernel loop
    assert s_p < max(1.15 * s_e, s_e + 0.02)             # ... and vs the eager loop
    # through the chain's own entry point: right length, finite, stereo on request
    out = pf.invert(y, generator=torch.Generator().manual_seed(1))
    assert out.shape == (2, 1, HOP * (y.shape[-2] - 1)) and torch.isfinite(out).all()
    assert pf.invert(y, inversion_mode="stereo").shape[-2] == 2


def test_complex_roundtrip_within_budget(both):
    x, _, pf = both
    xm = pf[0].forward(torch.as_tensor(x))
    back = pf[1].invert(pf[1].forward(xm))
    assert rel(t2n(back), t2n(xm)[..., : back.shape[-1]]) <= 1e-4


def test_gradient_through_the_fused_forward(both):
    x, jf, pf = both
    x = x[:1, :, :4000]
    rng = np.random.default_rng(33)
    T = 1 + 4000 // HOP
    g = rng.standard_normal((1, T, N_FFT // 2 + 1)).astype(np.float32)
    jfwd = jatt.fuse_forward(jf, backend="pallas")
    gj = np.asarray(jax.grad(lambda a: jnp.sum(jfwd(a) * jnp.asarray(g)))(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = patt.fuse_forward(pf, backend="kernel")(xt)
    (y * torch.as_tensor(g)).sum().backward()
    assert xt.grad.shape == x.shape
    assert rel(t2n(xt.grad), gj) <= 1e-3
    # and equal to autograd through the eager formulation
    xe = torch.as_tensor(x).requires_grad_(True)
    (patt.fuse_forward(pf, backend="eager")(xe) * torch.as_tensor(g)).sum().backward()
    assert rel(t2n(xt.grad), t2n(xe.grad)) <= 1e-6
