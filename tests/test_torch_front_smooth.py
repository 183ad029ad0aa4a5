"""The full-K log-mel forward and fit (kernels E and F, ``fused_melspec`` /
``fused_melspec_stats`` with ``taps=None``) and, under the taps' own window,
the cosine-sum forward and fit (A and B) on the smooth route: where ``n_fft``
is even, ``2^a 3^b 5^c``, 64 to 4096 and no power of two
(``frames_fft.fft_covers_smooth``: 768, 640, 384, 1536, 1920, ...) and the
kernels take the shape, they run ``csrc/spectral.cu:melspec_forward_kernel``
/ ``melspec_stats_kernel<., kFrontSmooth>`` (the mixed-radix
``frames_rfft<true>``), whose plain versions are
``frames_rfft_reference(..., smooth=True)`` over the whole clip, frames paired
``(2j, 2j + 1)`` as the kernels' even tiles pair them.  896 = 2^7 7 keeps the
product (E, F) and the factored (A, B) front ends; the representation
kernels G and H take the smooth route at 768 too
(``tests/test_torch_repr_smooth.py``).  ``chip_smoke.py`` holds the kernels
to these plain versions on the card.

Tolerances, and why:

* the plain versions against the JAX package's ``fused_melspec`` /
  ``fused_melspec_stats`` (its Pallas kernels in interpret mode: the full-K
  product without taps, the factored one with them, bf16x3 products) within
  1e-4 of the largest value, the JAX kernels' own budget
  (``acids_transforms_tpu/ops/pallas/spectral.py:35-38``); the sums within
  1e-4 relative;
* against a float64 oracle (``np.fft.rfft`` of the windowed frames) within
  1e-5 of the largest value (sums: relative);
* value by value (the largest error over a clip's |X|, log1p |X| and
  log-mel values), no smooth plain version is further from the oracle than
  the product or factored route it replaces;
* A and B with taps against E and F under ``taps_window(taps, n_fft)``:
  bit for bit (the kernels are one instance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops.pallas import spectral as jk
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.ops.cuda.frames_fft import fft_covers_smooth, taps_window
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window
from test_torch_common import make_audio, t2n

torch.set_num_threads(1)
TOL = 1e-4
SHAPES = [(768, 256), (768, 192), (640, 160), (384, 96)]
TAPS = {"hann": (0.5, -0.25), "blackman": (0.42, -0.25, 0.04)}
OFFSET, SCALE = 0.05, 1.3


@pytest.fixture(scope="module")
def audio():
    return make_audio(83, batch=2, n=6000)[:, 0].copy()


def window_of(name, n_fft):
    return gaussian_dgt_window(n_fft) if name == "gaussian" else get_window(name, n_fft)


def oracle_spectrum(x, w, n_fft, hop):
    """float64 STFT of the reflect-padded frames under the window ``w``,
    (B, T, F) complex."""
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(xp[:, idx] * np.asarray(w, np.float64), axis=-1)


def stats_of(v):
    v = np.asarray(v, np.float64)
    return {"sum": v.sum(), "sumsq": (v * v).sum(), "min": v.min(), "max": v.max()}


def assert_stats(got, want, tol):
    """Sums within ``tol`` relative, extrema within ``tol`` of the largest."""
    for k in ("sum", "sumsq"):
        assert abs(float(got[k]) - float(want[k])) <= tol * abs(float(want[k])), k
    ext = max(abs(float(want["min"])), abs(float(want["max"])))
    for k in ("min", "max"):
        assert abs(float(got[k]) - float(want[k])) <= tol * ext, k


@pytest.mark.parametrize("wname", ["gaussian", "hann"])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_e_f_plain_versions_vs_pallas_and_oracle(audio, n_fft, hop, wname):
    """|X| (no contrast, no affine: the front end itself) and the statistics
    of log1p |X|, full-K under the DGT's gaussian and a hann window."""
    assert pk.melspec_route(n_fft, "melspec") == "smooth" and pk._kernel_plan(n_fft, hop, None)[1] > 0
    w = window_of(wname, n_fft)
    x = torch.as_tensor(audio)
    yp = t2n(pk.fused_melspec(x, n_fft, hop, None, 0.0, 1.0, "none", window=w)).astype(np.float64)
    xj, wj = jnp.asarray(audio), jnp.asarray(t2n(w))
    yj = np.asarray(jk.fused_melspec(xj, n_fft, hop, wj, None, 0.0, 1.0, "none", interpret=True), np.float64)
    S = oracle_spectrum(audio, t2n(w), n_fft, hop)
    yo = np.abs(S)
    assert yp.shape == yj.shape == yo.shape
    assert np.abs(yp - yj).max() <= TOL * np.abs(yj).max()
    assert np.abs(yp - yo).max() <= 1e-5 * yo.max()
    sp = pk.fused_melspec_stats(x, n_fft, hop, "log1p", window=w)
    sj = jk.fused_melspec_stats(xj, n_fft, hop, wj, "log1p", interpret=True)
    assert sp["count"] == int(sj["count"]) == yo.size
    assert_stats(sp, sj, TOL)
    assert_stats(sp, stats_of(np.log1p(yo)), 1e-5)


@pytest.mark.parametrize("n_fft,hop", [(768, 192), (640, 160)])
def test_a_b_plain_versions_vs_pallas_and_oracle(audio, n_fft, hop):
    """The flagship configuration under hann taps: the square mel bank,
    log1p, an affine; the JAX package's factored kernels."""
    taps = TAPS["hann"]
    x = torch.as_tensor(audio)
    bank = PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank
    yp = t2n(pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)).astype(np.float64)
    xj, ones = jnp.asarray(audio), jnp.ones((n_fft,), jnp.float32)
    yj = np.asarray(jk.fused_melspec(xj, n_fft, hop, ones, jnp.asarray(t2n(bank)), OFFSET, SCALE, "log1p",
                                     interpret=True, taps=taps), np.float64)
    S = oracle_spectrum(audio, taps_window(taps, n_fft), n_fft, hop)
    yo = (np.log1p(np.abs(S) @ t2n(bank).astype(np.float64)) - OFFSET) / SCALE
    assert yp.shape == yj.shape == yo.shape
    assert np.abs(yp - yj).max() <= TOL * np.abs(yj).max()
    assert np.abs(yp - yo).max() <= 1e-5 * np.abs(yo).max()
    sp = pk.fused_melspec_stats(x, n_fft, hop, "log1p", taps=taps)
    sj = jk.fused_melspec_stats(xj, n_fft, hop, ones, "log1p", interpret=True, taps=taps)
    assert_stats(sp, sj, TOL)
    assert_stats(sp, stats_of(np.log1p(np.abs(S))), 1e-5)


@pytest.mark.parametrize("n_fft,hop", SHAPES + [(1920, 480)])
def test_smooth_route_no_further_from_the_oracle_than_the_route_it_replaces(audio, n_fft, hop):
    """Value by value, the largest error over a clip's values: E's |X| and
    the log1p |X| that F's statistics sum, against E and F's product route
    (the window-folded basis, what 768 ran before); A's log-mel output and
    B's log1p |X| under hann taps against the factored front end.  (The
    statistics themselves sit at float32 rounding on both routes, 1e-8
    relative, where which is closer is chance: the first tests hold them to
    the oracle within 1e-5.)"""
    x = torch.as_tensor(audio)
    w = gaussian_dgt_window(n_fft)
    S = oracle_spectrum(audio, t2n(w), n_fft, hop)
    smooth = pk._fullk_spectrum(x, n_fft, hop, True, w, smooth=True)
    product = pk._fullk_spectrum(x, n_fft, hop, True, w)
    assert not torch.equal(smooth[0], product[0])

    def errs(re, im, want):
        mag = np.hypot(t2n(re).astype(np.float64), t2n(im).astype(np.float64))
        v = t2n(torch.log1p(torch.sqrt(re * re + im * im))).astype(np.float64)
        return np.abs(mag - np.abs(want)).max(), np.abs(v - np.log1p(np.abs(want))).max()

    e_s, e_p = errs(*smooth, S), errs(*product, S)
    assert e_s[0] <= e_p[0] and e_s[1] <= e_p[1], (e_s, e_p)
    # A and B under hann taps against the factored front end
    taps = TAPS["hann"]
    bank = PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank
    St = oracle_spectrum(audio, taps_window(taps, n_fft), n_fft, hop)
    yo = (np.log1p(np.abs(St) @ t2n(bank).astype(np.float64)) - OFFSET) / SCALE
    y_smooth = pk.fused_melspec_reference(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)
    fac = pk._factored_spectrum(x, n_fft, hop, True, taps)
    y_fac = pk._melspec_epilogue(*fac, bank, OFFSET, SCALE, "log1p", 1.0, torch.float32)
    assert np.abs(t2n(y_smooth) - yo).max() <= np.abs(t2n(y_fac) - yo).max()
    b_s = errs(*pk._spectrum(x, n_fft, hop, True, taps, None), St)
    b_f = errs(*fac, St)
    assert b_s[0] <= b_f[0] and b_s[1] <= b_f[1], (b_s, b_f)


@pytest.mark.parametrize("wname", sorted(TAPS))
@pytest.mark.parametrize("n_fft,hop", [(768, 192), (1920, 480)])
def test_a_b_are_e_f_under_the_taps_window(audio, n_fft, hop, wname):
    """A and B with taps are E and F under ``taps_window(taps, n_fft)``, bit
    for bit (with the bank, the power spectrogram, int16 input), on an odd
    clip length."""
    taps = TAPS[wname]
    x = torch.as_tensor(audio[:, :5999])
    w = torch.as_tensor(taps_window(taps, n_fft))
    bank = PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank
    for power, contrast in ((1.0, "log1p"), (2.0, "none")):
        a = pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, contrast, taps=taps, power=power)
        e = pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, contrast, taps=None, window=w, power=power)
        assert torch.equal(a, e)
    x16 = torch.round(x * 32767.0).to(torch.int16)
    assert torch.equal(pk.fused_melspec(x16, n_fft, hop, taps=taps),
                       pk.fused_melspec(x16, n_fft, hop, taps=None, window=w))
    b = pk.fused_melspec_stats(x, n_fft, hop, "log1p", taps=taps)
    f = pk.fused_melspec_stats(x, n_fft, hop, "log1p", taps=None, window=w)
    assert all(torch.equal(b[k], f[k]) for k in ("sum", "sumsq", "min", "max")) and b["count"] == f["count"]


def test_route_rules_and_plans():
    """The smooth route at every even 5-smooth shape the kernels take, 1408/352
    (2^7 11) on the product and factored front ends, 896/224 on the smooth
    route's radix-7 instance (G and H keep their product and factored front
    ends there; at 768 G and H plan the smooth route),
    the plan rule's picks (the fastest of a sweep of every plan on an H100,
    or within 10 % of it: 1920/480), and no launch counted on a CPU
    tensor."""
    for n_fft in range(64, 4097, 2):
        if not fft_covers_smooth(n_fft):
            continue
        for ov in range(2, 9):
            hop = n_fft // ov
            if n_fft % ov or hop % 32:
                continue
            tile_t, teams = pk._kernel_plan(n_fft, hop, None)
            assert teams > 0 and pk._kernel_plan(n_fft, hop, TAPS["hann"]) == (tile_t, teams)
            assert pk._fft_smem_bytes(tile_t, hop, ov, n_fft // 2 + 1, teams) <= pk.MAX_SMEM
    assert pk._kernel_plan(768, 256, None) == (16, 4) and pk._kernel_plan(768, 192, None) == (16, 4)
    assert pk._kernel_plan(640, 160, None) == (32, 4) and pk._kernel_plan(1536, 384, None) == (8, 2)
    assert pk._kernel_plan(1920, 480, None) == (16, 2)
    for taps in (None, TAPS["hann"]):
        assert pk._kernel_plan(1408, 352, taps) == (pk._pick_tile(352, 4, 705), 0)
        assert pk._kernel_plan(896, 224, taps) == pk._pick_smooth_plan(896, 224) == (16, 4)
    assert pk.melspec_route(1408, "melspec") == "other" and pk.melspec_route(1024, "melspec") == "fft"
    assert pk.melspec_route(896, "melspec") == "smooth"
    for stats in (False, True):
        for second in pk.SECONDS:
            assert pk._repr_plan(896, 224, TAPS["hann"], stats, second, False) == (pk._pick_repr_tile(224, 4, 449), 0)
            assert pk._repr_plan(896, 224, None, stats, second, False) == (pk._pick_repr_tile(224, 4, 449), 0)
            assert pk._repr_plan(768, 192, TAPS["hann"], stats, second, False) == pk._pick_repr_smooth_plan(
                768, 192, stats, second, False)
            assert pk._repr_plan(768, 256, None, stats, second, False)[1] > 0
    x = torch.as_tensor(make_audio(84, batch=2, n=4000)[:, 0])
    pk.reset_launches()
    w = gaussian_dgt_window(768)
    pk.fused_melspec(x, 768, 256, window=w)
    pk.fused_melspec_stats(x, 768, 192, taps=TAPS["hann"])
    # G's plain version takes the smooth route at 768 as E's does (the front
    # end shared with the melspec family), not the product route it ran before
    g = pk.fused_spectral_repr(x, 768, 256, "imag", window=w)
    re, im = pk._fullk_spectrum(x, 768, 256, True, w, smooth=True)
    assert torch.equal(g[0], re) and torch.equal(g[1], pk._pin_nyquist(im))
    assert not torch.equal(re, pk._fullk_spectrum(x, 768, 256, True, w)[0])
    assert not any(pk.launches.values()) and not any(pk.routes.values())
    assert {"fused_melspec:smooth", "fused_melspec_stats:smooth", "fused_melspec_fullk:smooth",
            "fused_melspec_stats_fullk:smooth"} <= set(pk.routes)


def test_no_smooth_plan_raises_no_fallback(monkeypatch):
    """Where no tile of the smooth route fits shared memory the plan raises
    ``NotImplementedError`` naming ROADMAP Queue 2 K1; it never gives way to
    the product or factored route."""
    monkeypatch.setattr(pk, "_pick_smooth_plan", lambda n_fft, hop: None)
    for taps in (None, TAPS["hann"]):
        with pytest.raises(NotImplementedError, match="K1"):
            pk._kernel_plan(768, 192, taps)
