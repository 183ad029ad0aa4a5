"""The log-mel forward (kernel A, ``fused_melspec`` with the taps of a
cosine-sum window), the representations' forward (kernel G,
``fused_spectral_repr`` with taps) and their fit statistics (kernel H,
``fused_repr_stats`` with taps) on the shared-memory FFT: where ``n_fft`` is
a power of two from 64 to 4096, A takes E's instance
(``csrc/spectral.cu:melspec_forward_kernel<., kFrontFft>``), G takes G
full-K's (``repr_forward_kernel<., kFrontFft>``) and H takes H full-K's
(``repr_stats_kernel<., kFrontFft>``), all under the taps' own window
(``frames_fft.taps_window``, float64 rounded once); every other ``n_fft``
keeps the factored front end (``spectral._kernel_plan``,
``spectral._repr_plan``).  The plain versions follow the same rules, so on a
CPU tensor the route and its plain version agree; ``chip_smoke.py`` holds
the kernels to them on the card.

Tolerances, and why:

* A's plain version against the JAX package's factored ``fused_melspec``
  (its Pallas kernel in interpret mode, bf16x3 products) within 1e-4 of the
  largest value, the JAX kernel's own budget
  (``acids_transforms_tpu/ops/pallas/spectral.py:35-38``), and against a
  float64 oracle (``np.fft.rfft`` of the windowed frames) within 1e-5;
* G's plain version against the JAX package's factored
  ``fused_spectral_repr`` (interpret mode) as ``tests/test_torch_repr_kernel.py``
  holds G: channel 1 within 1e-4 of its largest value, channel 2 on the
  circle, its angle error weighted by |X| / max|X| within 1e-5 and within
  1e-2 rad at bins above 1e-3 of the largest magnitude;
* H's plain statistics against the JAX package's factored
  ``fused_repr_stats`` (interpret mode) within the two packages' channels'
  elementwise differences plus the JAX kernel's float32 sums (1e-6 of the
  sum of |values|), as ``tests/test_torch_repr_kernel.py`` holds them (an
  angle at the +-pi boundary may land on either side); channel 1 and
  ``imag`` against the float64 oracle's statistics within 1e-5;
* value by value, no new route is further from the float64 oracle than
  the factored route it replaces (G's IF steps within 1.5x of it: see
  ``test_g_fft_route_no_further_from_the_oracle_than_the_factored_route``);
* the new routes' plain versions against the full-K ones under the taps'
  window: bit for bit (they are that function).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch as patt
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops.pallas import spectral as jk
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.ops.cuda.frames_fft import fft_covers, taps_window
from test_torch_common import chains, make_audio, t2n

torch.set_num_threads(1)
TOL = 1e-4
TAPS = {"hann": (0.5, -0.25), "hamming": (0.54, -0.23), "blackman": (0.42, -0.25, 0.04)}
SHAPES = [(512, 128), (1024, 256)]
OFFSET, SCALE = 0.05, 1.3


def cosine_window(taps, n_fft):
    k = np.arange(n_fft)
    return sum((1.0 if p == 0 else 2.0) * c * np.cos(2 * np.pi * p * k / n_fft) for p, c in enumerate(taps))


def oracle_spectrum(x, taps, n_fft, hop):
    """float64 STFT of the reflect-padded frames under the cosine-sum window
    of ``taps``, (B, T, F) complex."""
    k = np.arange(n_fft)
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + k[None, :]
    return np.fft.rfft(xp[:, idx] * cosine_window(taps, n_fft), axis=-1)


def flagship_bank(n_fft):
    return PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank


@pytest.fixture(scope="module")
def audio():
    return make_audio(71, batch=2, n=9000)[:, 0].copy()


@pytest.mark.parametrize("wname", ["hann", "hamming"])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_a_fft_route_plain_version_vs_pallas_and_oracle(audio, n_fft, hop, wname):
    """The flagship configuration: the mel bank, log1p, an affine."""
    taps = TAPS[wname]
    bank = flagship_bank(n_fft)
    yp = pk.fused_melspec(torch.as_tensor(audio), n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)
    yj = np.asarray(jk.fused_melspec(jnp.asarray(audio), n_fft, hop, jnp.ones((n_fft,), jnp.float32),
                                     jnp.asarray(t2n(bank)), OFFSET, SCALE, "log1p", interpret=True,
                                     taps=taps))
    S = oracle_spectrum(audio, taps, n_fft, hop)
    yo = (np.log1p(np.abs(S) @ t2n(bank).astype(np.float64)) - OFFSET) / SCALE
    got = t2n(yp).astype(np.float64)
    assert got.shape == yj.shape == yo.shape
    assert np.abs(got - yj).max() <= TOL * np.abs(yj).max()
    assert np.abs(got - yo).max() <= 1e-5 * np.abs(yo).max()
    # the route's plain version is the full-K forward under the taps' own window
    w = torch.as_tensor(taps_window(taps, n_fft))
    full = pk.fused_melspec(torch.as_tensor(audio), n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=None, window=w)
    assert torch.equal(yp, full)


@pytest.mark.parametrize("power,contrast", [(2.0, "none"), (1.0, "none")])
def test_a_fft_route_options_vs_pallas(audio, power, contrast):
    """The power spectrogram and no contrast, with the bank, at 1024/256."""
    n_fft, hop, taps = 1024, 256, TAPS["hann"]
    bank = flagship_bank(n_fft)
    yp = pk.fused_melspec(torch.as_tensor(audio), n_fft, hop, bank, 0.1, 1.7, contrast, taps=taps, power=power)
    yj = np.asarray(jk.fused_melspec(jnp.asarray(audio), n_fft, hop, jnp.ones((n_fft,), jnp.float32),
                                     jnp.asarray(t2n(bank)), 0.1, 1.7, contrast, interpret=True, taps=taps,
                                     power=power))
    assert yp.shape == yj.shape
    assert np.abs(t2n(yp) - yj).max() <= TOL * np.abs(yj).max()


def stats_of(v):
    v = np.asarray(v, np.float64)
    return {"sum": v.sum(), "sumsq": (v * v).sum(), "min": v.min(), "max": v.max()}


@pytest.mark.parametrize("wname", ["hann", "hamming"])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
@pytest.mark.parametrize("second", ["phase", "if", "imag"])
def test_h_fft_route_plain_version_vs_pallas_and_oracle(audio, n_fft, hop, wname, second):
    taps = TAPS[wname]
    weighted = second == "if"
    x = torch.as_tensor(audio)
    sp = pk.fused_repr_stats(x, n_fft, hop, second, weighted=weighted, taps=taps)
    ones = jnp.ones((n_fft,), jnp.float32)
    sj = jk.fused_repr_stats(jnp.asarray(audio), n_fft, hop, ones, second, interpret=True, taps=taps,
                             weighted=weighted)
    assert sp["count"] == int(sj["count"]) and isinstance(sp["count"], int)
    # the channels each package takes its statistics on (channel 1 without mel)
    aff0 = dict(aff=(0.0, 1.0, 0.0, 1.0), weighted=weighted)
    jy = [np.asarray(a, np.float64) for a in jk.fused_spectral_repr(
        jnp.asarray(audio), n_fft, hop, ones, second, interpret=True, taps=taps, **aff0)]
    w = torch.as_tensor(taps_window(taps, n_fft))
    py = [t2n(a).astype(np.float64) for a in pk.fused_spectral_repr(x, n_fft, hop, second, window=w, **aff0)]
    S = oracle_spectrum(audio, taps, n_fft, hop)
    for i, ch in enumerate(("ch1", "ch2")):
        pv, jv = py[i], jy[i]
        # the route's plain statistics are those of the full-K channels under the taps' window
        assert float(sp[ch]["min"]) == pv.min() and float(sp[ch]["max"]) == pv.max()
        assert abs(float(sp[ch]["sum"]) - pv.sum()) <= 1e-12 * pv.size * np.abs(pv).max()
        # against the JAX kernel
        slack = 1e-6 * np.abs(jv).sum()
        assert abs(float(sp[ch]["sum"]) - float(sj[ch]["sum"])) <= np.abs(pv - jv).sum() + slack
        assert abs(float(sp[ch]["sumsq"]) - float(sj[ch]["sumsq"])) <= (
            np.abs(pv * pv - jv * jv).sum() + 1e-6 * (jv * jv).sum())
        tol = TOL * np.abs(jv).max()
        if ch == "ch2" and second != "imag":
            tol = max(tol, np.abs(pv - jv).max())
        for k in ("min", "max"):
            assert abs(float(sp[ch][k]) - float(sj[ch][k])) <= tol
    # channel 1 (log1p |X|, or Re) and Im against the float64 oracle's statistics
    im = S.imag.copy()
    im[..., -1] = 0.0
    oracles = [(0, S.real), (1, im)] if second == "imag" else [(0, np.log1p(np.abs(S)))]
    for i, v in oracles:
        ch, want = ("ch1", "ch2")[i], stats_of(v)
        for k in ("sum", "sumsq"):
            assert abs(float(sp[ch][k]) - want[k]) <= 1e-5 * np.abs(v).sum() * (np.abs(v).max() if k == "sumsq" else 1)
        for k in ("min", "max"):
            assert abs(float(sp[ch][k]) - want[k]) <= 1e-5 * np.abs(v).max()


@pytest.mark.parametrize("wname", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_fft_routes_no_further_from_the_oracle_than_the_factored_route(audio, n_fft, hop, wname):
    """Value by value: A's output (bank, log1p, affine) and H's channels (log1p
    |X|, Re, Im, and the angle weighted by |X| / max|X|) on the FFT route are
    no further from the float64 oracle than on the factored route, which
    each replaces at a power of two."""
    taps = TAPS[wname]
    x = torch.as_tensor(audio)
    bank = flagship_bank(n_fft)
    S = oracle_spectrum(audio, taps, n_fft, hop)
    yo = (np.log1p(np.abs(S) @ t2n(bank).astype(np.float64)) - OFFSET) / SCALE
    fac = pk._factored_spectrum(x, n_fft, hop, True, taps)
    y_fft = pk.fused_melspec_reference(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)
    y_fac = pk._melspec_epilogue(*fac, bank, OFFSET, SCALE, "log1p", 1.0, torch.float32)
    assert np.abs(t2n(y_fft) - yo).max() <= np.abs(t2n(y_fac) - yo).max()
    fft = pk._spectrum(x, n_fft, hop, True, taps, None)
    wt = np.abs(S) / np.abs(S).max()
    for spec in (fft, fac):
        assert spec[0].shape == S.shape

    def errs(re, im):
        re, im = re.double().numpy(), im.double().numpy()
        d_ang = np.abs(np.angle(np.exp(1j * (np.arctan2(im, re) - np.angle(S)))))[..., :-1]
        return (np.abs(np.log1p(np.hypot(re, im)) - np.log1p(np.abs(S))).max(),
                np.abs(re - S.real).max(), np.abs(im - S.imag).max(), (d_ang * wt[..., :-1]).max())

    e_fft, e_fac = errs(*fft), errs(*fac)
    assert all(a <= b for a, b in zip(e_fft, e_fac)), (e_fft, e_fac)


def test_route_rules():
    """A, B, G and H take the FFT route with taps at every power of two (the
    plans of E, F, G and H full-K); at 768/192 (no power of two) A, B, G
    and H take their full-K instances' smooth route; at 896/224 (2^7 7) G
    and H are factored and A and B take E's and F's radix-7 instance, at
    1408/352 (2^7 11) A and B are factored; no launch is counted on a CPU
    tensor."""
    taps = TAPS["hann"]
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        hop = max(32, n_fft // 4)
        assert pk._kernel_plan(n_fft, hop, taps) == pk._kernel_plan(n_fft, hop, None)
        assert pk._kernel_plan(n_fft, hop, taps)[1] > 0
        for second in pk.SECONDS:
            assert pk._repr_plan(n_fft, hop, taps, True, second, False) == pk._repr_plan(
                n_fft, hop, None, True, second, False)
            assert pk._repr_plan(n_fft, hop, taps, True, second, False)[1] > 0
            for mel in (False, second != "imag"):
                assert pk._repr_plan(n_fft, hop, taps, False, second, mel) == pk._repr_plan(
                    n_fft, hop, None, False, second, mel)
                assert pk._repr_plan(n_fft, hop, taps, False, second, mel)[1] > 0
    assert not fft_covers(768)
    assert pk._kernel_plan(768, 192, taps) == pk._kernel_plan(768, 192, None) and pk._kernel_plan(768, 192, taps)[1]
    assert pk._kernel_plan(1408, 352, taps) == (pk._pick_tile(352, 4, 705), 0)
    assert pk._kernel_plan(896, 224, taps) == pk._kernel_plan(896, 224, None) and pk._kernel_plan(896, 224, taps)[1]
    for stats in (False, True):
        assert pk._repr_plan(896, 224, taps, stats, "phase", not stats) == (pk._pick_repr_tile(224, 4, 449), 0)
        assert pk._repr_plan(768, 192, taps, stats, "phase", not stats) == pk._repr_plan(
            768, 192, None, stats, "phase", not stats) and pk._repr_plan(768, 192, taps, stats, "phase", not stats)[1]
    x = torch.as_tensor(make_audio(72, batch=2, n=6000)[:, 0])
    pk.reset_launches()
    w = torch.as_tensor(taps_window(taps, 512))
    # the plain versions: the FFT route under the taps' window at 512
    h = pk.fused_repr_stats(x, 512, 128, "phase", taps=taps)
    h_w = pk.fused_repr_stats(x, 512, 128, "phase", taps=None, window=w)
    assert all(torch.equal(h[c][k], h_w[c][k]) for c in ("ch1", "ch2") for k in ("sum", "min", "max"))
    g = pk.fused_spectral_repr(x, 512, 128, "imag", taps=taps)
    re, im = pk._fullk_spectrum(x, 512, 128, True, w)
    assert torch.equal(g[0], re) and torch.equal(g[1], pk._pin_nyquist(im))
    # 1408/352: the factored A; 896/224: the factored G and H
    a = pk.fused_melspec(x, 1408, 352, None, 0.0, 1.0, "none", taps=taps)
    re, im = pk._factored_spectrum(x, 1408, 352, True, taps)
    assert torch.equal(a, torch.sqrt(re * re + im * im))
    re, im = pk._factored_spectrum(x, 896, 224, True, taps)
    h = pk.fused_repr_stats(x, 896, 224, "imag", taps=taps)
    assert torch.equal(h["ch1"]["max"], re.max())
    g = pk.fused_spectral_repr(x, 896, 224, "imag", taps=taps)
    assert torch.equal(g[0], re) and torch.equal(g[1], pk._pin_nyquist(im))
    assert not any(pk.launches.values()) and not any(pk.routes.values())
    assert {"fused_melspec:fft", "fused_melspec:smooth", "fused_melspec:factored", "fused_repr_stats:fft",
            "fused_repr_stats:smooth", "fused_repr_stats:factored", "fused_spectral_repr:fft",
            "fused_spectral_repr:smooth", "fused_spectral_repr:factored"} <= set(pk.routes)


@pytest.mark.parametrize("wname", sorted(TAPS))
@pytest.mark.parametrize("second", sorted(pk.SECONDS))
def test_fft_routes_are_the_fullk_function_under_the_taps_window(wname, second):
    """With taps at a power of two, A's and H's plain versions are the full-K
    ones under ``taps_window`` bit for bit (A with the flagship's kind of
    bank, H with each ``second``; a clip of odd length, two tiles of H's
    plan at 256/64): the kernels are the same instances, so the port's two
    front ends compute one function of the taps."""
    n_fft, hop, taps = 256, 64, TAPS[wname]
    x = torch.as_tensor(make_audio(74, batch=2, n=4801)[:, 0])
    w = torch.as_tensor(taps_window(taps, n_fft))
    weighted = second == "if"
    h = pk.fused_repr_stats(x, n_fft, hop, second, weighted=weighted, taps=taps)
    h_w = pk.fused_repr_stats(x, n_fft, hop, second, weighted=weighted, taps=None, window=w)
    assert h["count"] == h_w["count"]
    assert all(torch.equal(h[c][k], h_w[c][k]) for c in ("ch1", "ch2") for k in ("sum", "sumsq", "min", "max"))
    bank = PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank
    a = pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)
    a_w = pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=None, window=w)
    assert torch.equal(a, a_w)


def test_flagship_and_polar_chains_through_the_fft_routes():
    """``fuse_forward`` of the flagship chain and ``fuse_fit`` of STFT + Polar
    on the CPU run the new routes' plain versions; they agree with the eager
    chains (forward 1e-4, fit within 1e-5 of the scale)."""
    _, pc = chains(n_fft=1024, hop=256)
    x = torch.as_tensor(make_audio(73, n=12000))
    fitted = patt.fuse_fit(pc, backend="kernel")(x)
    y = patt.fuse_forward(fitted, backend="kernel")(x)
    y_e = fitted.forward(x)
    assert y.shape == y_e.shape and (y - y_e).abs().max() <= 1e-4 * y_e.abs().max()
    p_chain = PT.Mono(device="cpu") + PT.STFT(n_fft=1024, hop_length=256, device="cpu") + PT.Polar(device="cpu")
    pf = patt.fuse_fit(p_chain, backend="kernel")(x)
    pe = p_chain.fit(x)
    for part in ("magnitude", "phase"):
        s = abs(float(getattr(pe[2], part).norm.scale))
        for a in ("offset", "scale"):
            assert abs(float(getattr(getattr(pf[2], part).norm, a)) - float(getattr(getattr(pe[2], part).norm, a))) <= 1e-5 * s


G_CASES = [("phase", False), ("phase", True), ("if", False), ("if", True), ("imag", False)]


def g_angle_error(second, j2, p2, weighted, scale):
    """Channel-2 difference as an angle on the circle (the IF taken back to
    the phase differences it is made of), as ``test_torch_repr_kernel.py``
    measures it."""
    d = (np.asarray(p2, np.float64) - j2) * scale
    if second == "if":
        T = d.shape[1]
        c = np.full(T, 2.0 * np.pi)
        c[0], c[-1] = np.pi, 2.0
        if weighted:
            n = np.arange(T)
            g = 1.5 * T / (T * T - 1.0) * (1 - ((n - (T / 2 - 1)) / (T / 2)) ** 2)
            c = np.where(g > 0, c / np.where(g > 0, g, 1.0), 0.0)
        d = d * c[None, :, None]
    return np.abs(np.angle(np.exp(1j * d)))


def g_weights(S, second):
    """|X| / max|X| per clip; for the IF, of the quieter of a row's two frames."""
    m = np.abs(S) / np.abs(S).max(axis=(-2, -1), keepdims=True)
    if second == "if":
        m[:, 1:] = np.minimum(m[:, 1:], m[:, :-1])
    return m


@pytest.mark.parametrize("wname", ["hann", "hamming"])
@pytest.mark.parametrize("second,mel", G_CASES)
def test_g_fft_route_plain_version_vs_pallas(audio, wname, second, mel):
    """G's plain version with taps at 1024/256 (the FFT route under the taps'
    window) against the JAX package's factored kernel in interpret mode, with
    and without the mel bank, log1p and an affine (the IF before its
    offset), and bit for bit the full-K plain version under ``taps_window``."""
    n_fft, hop, taps = 1024, 256, TAPS[wname]
    bank = flagship_bank(n_fft) if mel else None
    weighted = second == "if"
    aff = (0.1, 1.3, 0.0, 1.0) if second == "if" else (0.1, 1.3, -0.2, 0.9)
    x = torch.as_tensor(audio)
    py = pk.fused_spectral_repr(x, n_fft, hop, second, mel_bank=bank, aff=aff, weighted=weighted, taps=taps)
    jy = jk.fused_spectral_repr(jnp.asarray(audio), n_fft, hop, jnp.ones((n_fft,), jnp.float32), second,
                                mel_bank=None if bank is None else jnp.asarray(t2n(bank)), aff=aff,
                                weighted=weighted, interpret=True, taps=taps)
    (p1, p2), (j1, j2) = [t2n(a) for a in py], [np.asarray(a, np.float64) for a in jy]
    assert p1.shape == j1.shape and p2.shape == j2.shape
    assert np.abs(p1 - j1).max() <= TOL * np.abs(j1).max()
    if second == "imag":
        assert np.abs(p2 - j2).max() <= TOL * np.abs(j2).max()
    else:
        wt = g_weights(oracle_spectrum(audio, taps, n_fft, hop), second)
        err = g_angle_error(second, j2, p2, weighted, aff[3])
        assert (err * wt).max() <= 1e-5
        assert err[wt > 1e-3].max() <= 1e-2
    w = torch.as_tensor(taps_window(taps, n_fft))
    full = pk.fused_spectral_repr(x, n_fft, hop, second, mel_bank=bank, aff=aff, weighted=weighted,
                                  window=w)
    assert all(torch.equal(a, b) for a, b in zip(py, full))


@pytest.mark.parametrize("wname", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("second,mel", G_CASES)
def test_g_fft_route_no_further_from_the_oracle_than_the_factored_route(audio, monkeypatch, wname, second,
                                                                        mel):
    """Value by value, G's channels (pre-affine, no contrast) on the FFT
    route are no further from the float64 oracle than on the factored front
    end it replaces at 512/128: channel 1 (|X| or its mel product, or Re),
    Im, and the angle or the IF's phase steps weighted by |X| / max|X| (the
    nyquist bin left out: its angle is pinned to 0 or pi by the real part's
    sign in both).  The IF's steps are differences of two frames' angles:
    the factored front end shares its hop-chunk products between
    overlapping frames, so its errors in neighbouring frames are correlated
    and partly cancel there; the FFT route's weighted IF error is held
    within 1.5x the factored route's (measured: 1.36x under blackman, 5.8e-7
    against 4.3e-7, at most 1x under hann and hamming), and its angle, which
    the IF is made of, to no further than the factored route's."""
    n_fft, hop, taps = 512, 128, TAPS[wname]
    bank = flagship_bank(n_fft) if mel else None
    weighted = second == "if"
    x = torch.as_tensor(audio)
    kw = dict(mel_bank=bank, contrast="none", weighted=weighted, taps=taps)
    y_fft = [t2n(a).astype(np.float64) for a in pk.fused_spectral_repr_reference(x, n_fft, hop, second, **kw)]
    monkeypatch.setattr(pk, "_spectrum", lambda x_, n, h, c, t, w, *family: pk._factored_spectrum(x_, n, h, c, t))
    y_fac = [t2n(a).astype(np.float64) for a in pk.fused_spectral_repr_reference(x, n_fft, hop, second, **kw)]
    S = oracle_spectrum(audio, taps, n_fft, hop)
    if second == "imag":
        im = S.imag.copy()
        im[..., -1] = 0.0
        for i, want in enumerate((S.real, im)):
            assert np.abs(y_fft[i] - want).max() <= np.abs(y_fac[i] - want).max()
        return
    want1 = np.abs(S) if bank is None else np.abs(S) @ t2n(bank).astype(np.float64)
    assert np.abs(y_fft[0] - want1).max() <= np.abs(y_fac[0] - want1).max()
    ang = np.angle(S)
    ang[..., -1] = np.where(S.real[..., -1] < 0, np.pi, 0.0)
    want2 = ang if second == "phase" else t2n(pk._if_rows(torch.as_tensor(ang), weighted))
    wt = g_weights(S, second)[..., :-1]
    errs = [(g_angle_error(second, want2, y[1], weighted, 1.0)[..., :-1] * wt).max() for y in (y_fft, y_fac)]
    assert errs[0] <= (1.5 if second == "if" else 1.0) * errs[1], errs
