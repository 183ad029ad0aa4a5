"""The representation chains end to end against the JAX package:
``Mono + (DGT | STFT) + (PolarIF | Polar | Cartesian)`` through ``fuse_fit``,
``fuse_forward(backend="kernel")`` (on the CPU: kernels G and H as their
plain versions) and ``invert``, with the fitted state carried by
``load_jax_state``; and the DGT magnitude chain's ``pghi_gl`` through the
full-K Griffin-Lim step (kernel J's plain version).

Tolerances: channel 1 and the fitted statistics of channel 1 1e-4 relative
(the JAX kernels' bf16x3 budget); channel 2 as an angle on the circle,
weighted by |X| / max|X| (1e-5) and unweighted at bins above 1e-3 of the
clip's largest magnitude (1e-2 rad), as ``test_torch_repr_kernel.py``
argues; the channel-2 normalizer 1e-4 of its scale (its extrema are single
bins at the +-pi boundary, or phases of 0-or-pi bins).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu as jatt
import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch as patt
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from test_torch_common import HOP, N_FFT, carry_over, jax_angles, jax_state, make_audio, rel, t2n

KINDS = [("PolarIF", "DGT"), ("Polar", "STFT"), ("Cartesian", "DGT"), ("PolarIF", "STFT")]


def make_chains(kind, front, **rep_kw):
    if kind != "Cartesian":
        rep_kw.setdefault("magnitude_args", {"mode": "bipolar", "n_fft": N_FFT})
    jc = JT.Mono() + getattr(JT, front)(n_fft=N_FFT, hop_length=HOP) + getattr(JT, kind)(**rep_kw)
    pc = PT.Mono(device="cpu") + getattr(PT, front)(n_fft=N_FFT, hop_length=HOP, device="cpu") \
        + getattr(PT, kind)(device="cpu", **rep_kw)
    return jc, pc


@pytest.fixture(scope="module")
def audio():
    return make_audio(61, batch=2, n=6000)


def weights(x, stft_t):
    """|X| / max|X| of the mono spectrum, per clip."""
    xm = np.asarray(x).mean(-2)
    spec = np.asarray(jfft.stft(jnp.asarray(xm), N_FFT, HOP, jnp.asarray(np.array(stft_t.window))))
    m = np.abs(spec)
    return m / m.max(axis=(-2, -1), keepdims=True)


def channel2_angle_error(rep, p2, j2):
    """Channel 2 back to angles (IF: the phase differences it is made of)."""
    s = float(rep.phase.norm.scale) if isinstance(rep.phase.norm, JT.Normalize) else 1.0
    d = (np.asarray(p2, np.float64) - np.asarray(j2, np.float64)) * s
    if type(rep) is JT.PolarIF:
        T = d.shape[-2]
        c = np.full(T, 2.0 * np.pi)
        c[0], c[-1] = np.pi, 2.0
        d = d * c[:, None]
    return np.abs(np.angle(np.exp(1j * d)))


def fit_both(kind, front, x, **rep_kw):
    jc, pc = make_chains(kind, front, **rep_kw)
    jf = jatt.fuse.fuse_fit(jc)(jnp.asarray(x))
    pf = patt.fuse_fit(pc, backend="kernel")(torch.as_tensor(x))
    return jf, pf, pc


@pytest.mark.parametrize("kind,front", KINDS)
def test_fuse_fit_matches_the_jax_fit(audio, kind, front):
    jf, pf, _ = fit_both(kind, front, audio)
    for name, tol in (("magnitude", 1e-4), ("phase", 1e-4)):
        jn, pn = getattr(jf[2], name).norm, getattr(pf[2], name).norm
        s = abs(float(jn.scale))
        assert abs(float(pn.offset) - float(jn.offset)) <= tol * s
        assert abs(float(pn.scale) - float(jn.scale)) <= tol * s
        assert not pn.needs_scaling
    assert pf.needs_scaling == jf.needs_scaling          # the flag quirk, both packages
    # and the same statistics as the port's own cascade
    ef = make_chains(kind, front)[1].fit(torch.as_tensor(audio))
    assert abs(float(ef[2].magnitude.norm.scale) - float(pf[2].magnitude.norm.scale)) <= 1e-5 * abs(float(ef[2].magnitude.norm.scale))


@pytest.mark.parametrize("kind,front", KINDS)
def test_fuse_forward_matches_the_jax_chain(audio, kind, front):
    jc, pc = make_chains(kind, front)
    jf = jc.fit(jnp.asarray(audio))
    carry_over(jf, pc)
    assert patt.fuse.fusable(pc, "kernel") and patt.fuse.fit_fusable(pc)
    yj = np.asarray(jf.forward(jnp.asarray(audio)))
    yk = t2n(patt.fuse_forward(pc, backend="kernel")(torch.as_tensor(audio)))
    ye = t2n(patt.fuse_forward(pc, backend="eager")(torch.as_tensor(audio)))
    yc = t2n(pc.forward(torch.as_tensor(audio)))
    assert yk.shape == yj.shape == ye.shape == yc.shape == (2, 1 + 6000 // HOP, 2, N_FFT // 2 + 1)
    assert rel(yk[..., 0, :], yj[..., 0, :]) <= 1e-4
    assert rel(yk[..., 0, :], ye[..., 0, :]) <= 1e-4
    assert np.array_equal(ye, yc) or rel(ye, yc) <= 1e-6
    if kind == "Cartesian":
        assert rel(yk[..., 1, :], yj[..., 1, :]) <= 1e-4
        return
    wt = weights(audio, pc[1])
    if kind == "PolarIF":
        wt[:, 1:] = np.minimum(wt[:, 1:], wt[:, :-1])
    for ref in (yj, ye):
        err = channel2_angle_error(jf[2], yk[..., 1, :], ref[..., 1, :])
        assert (err * wt).max() <= 1e-5 and err[wt > 1e-3].max() <= 1e-2


def test_state_keys_of_a_representation_chain(audio):
    jc, pc = make_chains("PolarIF", "DGT")
    st = jax_state(jc.fit(jnp.asarray(audio)))
    assert set(st) == {
        "1.window", "1.inv_window", "2.magnitude.mel_bank", "2.magnitude.inverse_mel_bank",
        "2.magnitude.norm.offset", "2.magnitude.norm.scale", "2.magnitude.norm.needs_scaling",
        "2.phase.norm.offset", "2.phase.norm.scale", "2.phase.norm.needs_scaling",
    }
    patt.convert.load_jax_state(pc, st)
    assert float(pc[2].phase.norm.scale) == float(st["2.phase.norm.scale"])
    assert not pc[2].phase.norm.needs_scaling and pc[2].needs_scaling
    with pytest.raises(KeyError):
        patt.convert.load_jax_state(pc, {"2.phase.nothing": np.zeros(())})


@pytest.mark.parametrize("mel", [True, False])
def test_if_roundtrip_no_worse_than_the_jax_chain(audio, mel):
    """Chain R forward (fused) then invert (IF integration, polar, complex
    inverse DGT): the port's audio is as close to the input as the JAX
    chain's on the same input and state (within 1 %)."""
    jc, pc = make_chains("PolarIF", "DGT", magnitude_args={"mode": "bipolar", "n_fft": N_FFT, "mel": mel})
    jf = jc.fit(jnp.asarray(audio))
    carry_over(jf, pc)
    xm = np.asarray(audio).mean(-2)
    rj = np.asarray(jf.invert(jf.forward(jnp.asarray(audio))))[..., 0, :]
    rp = t2n(pc.invert(patt.fuse_forward(pc, backend="kernel")(torch.as_tensor(audio))))[..., 0, :]
    n = rp.shape[-1]
    assert rj.shape == rp.shape
    e_j, e_p = rel(rj, xm[..., :n]), rel(rp, xm[..., :n])
    assert e_p <= 1.01 * e_j + 1e-6
    if not mel:
        assert e_p <= 1e-3          # exact inversion up to float32 phase integration


def test_gradient_through_the_kernel_is_the_eager_one(audio):
    _, pc = make_chains("PolarIF", "STFT", stack=None)
    pc = pc.fit(torch.as_tensor(audio))
    g = torch.Generator().manual_seed(3)
    grads = []
    for backend in ("kernel", "eager"):
        x = torch.as_tensor(audio).clone().requires_grad_(True)
        y1, y2 = patt.fuse_forward(pc, backend=backend)(x)
        w1 = torch.randn(y1.shape, generator=torch.Generator().manual_seed(4))
        (y1 * w1).sum().backward()
        grads.append(x.grad.clone())
        assert isinstance(y1, torch.Tensor) and y2.shape == y1.shape
    assert torch.isfinite(grads[0]).all() and torch.equal(grads[0], grads[1])
    del g


def test_pghi_gl_through_the_full_k_step_converges_like_the_jax_chain():
    """The DGT magnitude chain inverted with ``pghi_gl``: PGHI seeds 30
    iterations of the full-K step (``fused=True``: kernel J's plain version on
    the CPU); its spectral convergence lands within max(1.15 s, s + 0.02) of
    the JAX chain's (PGHI + its eager Griffin-Lim loop) on the same input."""
    x = make_audio(62, batch=2, n=9000)
    jc = JT.Mono() + JT.DGT(n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi_gl") \
        + JT.Magnitude(mode="unipolar", mel=False, n_fft=N_FFT)
    pc = PT.Mono(device="cpu") + PT.DGT(n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi_gl", device="cpu") \
        + PT.Magnitude(mode="unipolar", mel=False, n_fft=N_FFT, device="cpu")
    jf = jc.fit(jnp.asarray(x))
    carry_over(jf, pc)
    yj = jf.forward(jnp.asarray(x))
    mag_j = np.asarray(jf[2].invert(yj))
    rec_j = np.asarray(jf.invert(yj, inversion_mode="pghi_gl"))[..., 0, :]
    y = patt.fuse_forward(pc, backend="kernel")(torch.as_tensor(x))
    mag = pc[2].invert(y)
    ph = pc[1].pghi(mag, angles=torch.as_tensor(jax_angles(mag.shape)))
    rec_p = t2n(pc[1].griffin_lim(mag, init_phase=ph, fused=True))

    def sc(rec, target):
        R = np.abs(np.asarray(jfft.stft(jnp.asarray(rec), N_FFT, HOP, jf[1].window)))
        n = min(R.shape[-2], target.shape[-2])
        return float(np.linalg.norm(R[..., :n, :] - target[..., :n, :]) / np.linalg.norm(target))

    s_j, s_p = sc(rec_j, mag_j), sc(rec_p, mag_j)
    assert s_p < max(1.15 * s_j, s_j + 0.02), (s_p, s_j)
    # and the eager loop from the same seed lands there too
    rec_e = t2n(pc[1].griffin_lim(mag, init_phase=ph, fused=False))
    assert sc(rec_e, mag_j) < max(1.15 * s_j, s_j + 0.02)


def test_declines_and_fallbacks(audio):
    x = torch.as_tensor(audio)
    _, unwrapped = make_chains("Polar", "STFT", phase_args={"mode": "bipolar", "unwrap": True})
    _, central = make_chains("PolarIF", "DGT", phase_args={"mode": "bipolar", "method": "central"})
    _, front_stack = make_chains("Polar", "DGT", stack=0)
    _, log_c = make_chains("Polar", "STFT", magnitude_args={"mode": "bipolar", "n_fft": N_FFT, "contrast": "log"})
    for chain in (unwrapped, central, front_stack):
        assert not patt.fuse.fusable(chain, "eager") and not patt.fuse.fit_fusable(chain)
        assert patt.fuse_forward(chain) == chain.forward
        with pytest.raises(ValueError, match="kernel"):
            patt.fuse_forward(chain, backend="kernel")
        with pytest.raises(ValueError, match="kernel"):
            patt.fuse_fit(chain, backend="kernel")
    # log contrast: the eager formulation covers it, the kernels decline it
    assert patt.fuse.fusable(log_c, "eager") and not patt.fuse.fusable(log_c, "kernel")
    log_c = log_c.fit(x)
    assert rel(t2n(patt.fuse_forward(log_c)(x))[..., 0, :], t2n(log_c.forward(x))[..., 0, :]) <= 1e-5
    # both channels unnormalized: nothing to fit
    _, bare = make_chains("Polar", "DGT", magnitude_args={"mode": None, "n_fft": N_FFT},
                          phase_args={"mode": None})
    assert patt.fuse_fit(bare, backend="kernel") == bare.fit
    # a mask, or auto on a CPU tensor, takes the exact cascade
    _, pc = make_chains("PolarIF", "DGT")
    fitted = patt.fuse_fit(pc)(x)
    ref = pc.fit(x)
    assert float(fitted[2].phase.norm.scale) == float(ref[2].phase.norm.scale)
    assert all(v == 0 for v in pk.launches.values())


def test_keep_nyquist_false_and_bf16_store(audio):
    x = torch.as_tensor(audio)
    _, pc = make_chains("PolarIF", "DGT", keep_nyquist=False,
                        magnitude_args={"mode": "bipolar", "n_fft": N_FFT})
    pc = pc.fit(x)
    yk = patt.fuse_forward(pc, backend="kernel")(x)
    ye = pc.forward(x)
    assert yk.shape == ye.shape and yk.shape[-1] == N_FFT // 2
    assert rel(t2n(yk[..., 0, :]), t2n(ye[..., 0, :])) <= 1e-4
    yb = patt.fuse_forward(pc, backend="kernel", out_dtype=torch.bfloat16)(x)
    assert yb.dtype == torch.bfloat16 and torch.equal(yb, yk.to(torch.bfloat16))
