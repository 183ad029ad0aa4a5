"""The full-K log-mel forward and fit (kernels E and F, ``fused_melspec`` /
``fused_melspec_stats`` with ``taps=None``) and, under the taps' own window,
the cosine-sum forward and fit (A and B) on the smooth route's radix-7
instance: where ``n_fft`` is even, ``2^a 3^b 5^c 7^d`` with a factor 7, 64 to
4096 (``frames_fft.fft_covers_smooth7``: 896, 1344, 1568, ...) and the kernels
take the shape, they run ``csrc/spectral.cu:melspec_forward_kernel`` /
``melspec_stats_kernel<., kFrontSmooth7>`` (``frames_rfft<true, true>``),
whose plain versions are ``frames_rfft_reference(..., smooth=True)`` over the
whole clip (the radices of ``frames_fft.fft_radices``, sevens first).  The
route rule is ``spectral.melspec_route(n_fft, family)``: the ``"melspec"``
family (E, F, A, B) takes the sevens, the ``"repr"`` family (G, H) keeps its
product and factored front ends there.  1408 = 2^7 11 keeps the product and
factored front ends for both; 4032/2016 has no plan on either route and
raises.  ``chip_smoke.py`` holds the kernels to these plain versions on the
card.

Tolerances, and why:

* the plain versions against the JAX package's ``fused_melspec`` /
  ``fused_melspec_stats`` (its Pallas full-K kernel in interpret mode,
  bf16x3 products) within 1e-4 of the largest value, the JAX kernels' own
  budget (``acids_transforms_tpu/ops/pallas/spectral.py:35-38``); the sums
  within 1e-4 relative;
* against a float64 oracle (``np.fft.rfft`` of the windowed frames) within
  1e-5 of the largest value (sums: relative);
* value by value (the largest error over a clip's |X|, log1p |X| and
  log-mel values), no radix-7 plain version is further from the oracle than
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
from acids_transforms_tpu_torch import regions
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.ops.cuda.frames_fft import (
    MAX_SMEM, fft_covers_smooth, fft_covers_smooth7, fft_radices, taps_window)
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window
from test_torch_common import make_audio, t2n

torch.set_num_threads(1)
TOL = 1e-4
TAPS = {"hann": (0.5, -0.25), "blackman": (0.42, -0.25, 0.04)}
OFFSET, SCALE = 0.05, 1.3
#: the oracle's shapes: 2^7 7 at overlap 4, 2 and 7, 2^5 7^2 (radices 7 7),
#: 2^6 3 7 at overlap 7, 2^5 3 7 at overlap 7
ORACLE_SHAPES = [(896, 224), (896, 448), (896, 128), (1568, 224), (1344, 192), (672, 96)]


@pytest.fixture(scope="module")
def audio():
    return make_audio(87, batch=2, n=6000)[:, 0].copy()


def seven_shapes():
    """Every (n_fft, hop) E's and F's gate takes (hop a multiple of 32,
    overlap 2 to 8) at an even 7-smooth n_fft with a factor 7."""
    out = []
    for n_fft in range(64, 4097, 2):
        if not fft_covers_smooth7(n_fft) or n_fft % 7:
            continue
        for ov in range(2, 9):
            if n_fft % ov == 0 and (n_fft // ov) % 32 == 0:
                out.append((n_fft, n_fft // ov))
    return out


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


def test_route_rule_by_family_at_every_seven_shape():
    """The 42 shapes of the gate: the melspec family takes the smooth route,
    the repr family its product / factored front end; 1408/352 (2^7 11) is
    neither family's smooth route, and the 5-smooth and power-of-two shapes
    keep their routes in both."""
    shapes = seven_shapes()
    assert len(shapes) == 42 and (4032, 2016) in shapes and (224, 32) in shapes
    for n_fft, _ in shapes:
        assert pk.melspec_route(n_fft, "melspec") == "smooth"
        assert pk.melspec_route(n_fft, "repr") == "other"
        assert fft_radices(n_fft)[0] == 7
    for fam in pk.MELSPEC_ROUTE_FAMILIES:
        assert pk.melspec_route(1408, fam) == "other"
        assert pk.melspec_route(768, fam) == "smooth" and pk.melspec_route(1024, fam) == "fft"
    with pytest.raises(ValueError, match="family"):
        pk.melspec_route(896, "session")


def test_plans_fit_and_4032_2016_raises():
    """A plan at 41 of the 42 shapes, its block within shared memory, the
    same with taps as without; 4032/2016 refuses both (no smooth plan, and
    the product and factored tile does not fit there either), and every
    shape the product or factored kernels took before still has a plan."""
    planned = 0
    for n_fft, hop in seven_shapes():
        ov, F = n_fft // hop, n_fft // 2 + 1
        if (n_fft, hop) == (4032, 2016):
            assert pk._pick_smooth_plan(n_fft, hop) is None and pk._pick_tile(hop, ov, F) is None
            for taps in (None, TAPS["hann"]):
                with pytest.raises(NotImplementedError, match="K1"):
                    pk._kernel_plan(n_fft, hop, taps)
            continue
        tile_t, teams = pk._kernel_plan(n_fft, hop, None)
        assert teams > 0 and pk._kernel_plan(n_fft, hop, TAPS["blackman"]) == (tile_t, teams)
        assert pk._fft_smem_bytes(tile_t, hop, ov, F, teams) <= MAX_SMEM
        planned += 1
    assert planned == 41
    assert pk._kernel_plan(896, 224, None) == (16, 4) and pk._kernel_plan(1568, 224, None) == (8, 2)
    for taps in (None, TAPS["hann"]):
        assert pk._kernel_plan(1408, 352, taps) == (pk._pick_tile(352, 4, 705), 0)


@pytest.mark.parametrize("what", ["forward", "stats"])
def test_e_f_plain_versions_vs_pallas(audio, what):
    """E's |X| (no contrast, no affine) and F's statistics of log1p |X| at
    896/224 under the DGT's gaussian, against the JAX kernels in interpret
    mode."""
    n_fft, hop = 896, 224
    w = gaussian_dgt_window(n_fft)
    x, xj, wj = torch.as_tensor(audio), jnp.asarray(audio), jnp.asarray(t2n(w))
    if what == "forward":
        yp = t2n(pk.fused_melspec(x, n_fft, hop, None, 0.0, 1.0, "none", window=w)).astype(np.float64)
        yj = np.asarray(jk.fused_melspec(xj, n_fft, hop, wj, None, 0.0, 1.0, "none", interpret=True), np.float64)
        assert yp.shape == yj.shape
        assert np.abs(yp - yj).max() <= TOL * np.abs(yj).max()
    else:
        sp = pk.fused_melspec_stats(x, n_fft, hop, "log1p", window=w)
        sj = jk.fused_melspec_stats(xj, n_fft, hop, wj, "log1p", interpret=True)
        assert sp["count"] == int(sj["count"])
        assert_stats(sp, sj, TOL)


@pytest.mark.parametrize("n_fft,hop", ORACLE_SHAPES)
def test_e_f_a_b_vs_the_float64_oracle(audio, n_fft, hop):
    """E's |X| and F's statistics under the gaussian, A's log-mel output and
    B's statistics under hann taps, against ``np.fft.rfft`` in float64."""
    x = torch.as_tensor(audio)
    w = gaussian_dgt_window(n_fft)
    S = oracle_spectrum(audio, t2n(w), n_fft, hop)
    ye = t2n(pk.fused_melspec(x, n_fft, hop, None, 0.0, 1.0, "none", window=w)).astype(np.float64)
    assert ye.shape == S.shape and np.abs(ye - np.abs(S)).max() <= 1e-5 * np.abs(S).max()
    assert_stats(pk.fused_melspec_stats(x, n_fft, hop, "log1p", window=w), stats_of(np.log1p(np.abs(S))), 1e-5)
    taps = TAPS["hann"]
    bank = PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank
    St = oracle_spectrum(audio, taps_window(taps, n_fft), n_fft, hop)
    yo = (np.log1p(np.abs(St) @ t2n(bank).astype(np.float64)) - OFFSET) / SCALE
    ya = t2n(pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)).astype(np.float64)
    assert np.abs(ya - yo).max() <= 1e-5 * np.abs(yo).max()
    assert_stats(pk.fused_melspec_stats(x, n_fft, hop, "log1p", taps=taps), stats_of(np.log1p(np.abs(St))), 1e-5)


@pytest.mark.parametrize("n_fft,hop", [(896, 224), (1568, 224), (1344, 448)])
def test_radix7_route_no_further_from_the_oracle_than_the_route_it_replaces(audio, n_fft, hop):
    """Value by value, the largest error over a clip's values: E's |X| and
    the log1p |X| that F's statistics sum, against E and F's product route
    (what these shapes ran before); A's log-mel output and B's log1p |X|
    under hann taps against the factored front end."""
    x = torch.as_tensor(audio)
    w = gaussian_dgt_window(n_fft)
    S = oracle_spectrum(audio, t2n(w), n_fft, hop)
    seven = pk._spectrum(x, n_fft, hop, True, None, w)
    product = pk._fullk_spectrum(x, n_fft, hop, True, w)
    assert torch.equal(seven[0], pk._fullk_spectrum(x, n_fft, hop, True, w, smooth=True)[0])
    assert not torch.equal(seven[0], product[0])

    def errs(re, im, want):
        mag = np.hypot(t2n(re).astype(np.float64), t2n(im).astype(np.float64))
        v = t2n(torch.log1p(torch.sqrt(re * re + im * im))).astype(np.float64)
        return np.abs(mag - np.abs(want)).max(), np.abs(v - np.log1p(np.abs(want))).max()

    e_s, e_p = errs(*seven, S), errs(*product, S)
    assert e_s[0] <= e_p[0] and e_s[1] <= e_p[1], (e_s, e_p)
    taps = TAPS["hann"]
    bank = PT.Magnitude(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, device="cpu").mel_bank
    St = oracle_spectrum(audio, taps_window(taps, n_fft), n_fft, hop)
    yo = (np.log1p(np.abs(St) @ t2n(bank).astype(np.float64)) - OFFSET) / SCALE
    y_seven = pk.fused_melspec_reference(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)
    fac = pk._factored_spectrum(x, n_fft, hop, True, taps)
    y_fac = pk._melspec_epilogue(*fac, bank, OFFSET, SCALE, "log1p", 1.0, torch.float32)
    assert np.abs(t2n(y_seven) - yo).max() <= np.abs(t2n(y_fac) - yo).max()
    b_s, b_f = errs(*pk._spectrum(x, n_fft, hop, True, taps, None), St), errs(*fac, St)
    assert b_s[0] <= b_f[0] and b_s[1] <= b_f[1], (b_s, b_f)


@pytest.mark.parametrize("wname", sorted(TAPS))
@pytest.mark.parametrize("n_fft,hop", [(896, 224), (1344, 192)])
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


@pytest.mark.parametrize("second", sorted(pk.SECONDS))
def test_g_h_keep_their_routes_at_896(audio, second):
    """G and H have no radix-7 instance: at 896/224 their plain versions
    still run the product front end (full-K) and the factored one (taps),
    their plans have no FFT teams, and 5-smooth 768 keeps their smooth
    route."""
    n_fft, hop = 896, 224
    x = torch.as_tensor(audio)
    w = gaussian_dgt_window(n_fft)
    taps = TAPS["hann"]
    for stats in (False, True):
        assert pk._repr_plan(n_fft, hop, None, stats, second, False)[1] == 0
        assert pk._repr_plan(n_fft, hop, taps, stats, second, False)[1] == 0
        assert pk._repr_plan(768, 192, taps, stats, second, False)[1] > 0
    g = pk.fused_spectral_repr(x, n_fft, hop, "imag", window=w)
    re, im = pk._fullk_spectrum(x, n_fft, hop, True, w)
    assert torch.equal(g[0], re) and torch.equal(g[1], pk._pin_nyquist(im))
    g_t = pk.fused_spectral_repr(x, n_fft, hop, "imag", taps=taps)
    re_t, im_t = pk._factored_spectrum(x, n_fft, hop, True, taps)
    assert torch.equal(g_t[0], re_t) and torch.equal(g_t[1], pk._pin_nyquist(im_t))
    y = pk.fused_spectral_repr(x, n_fft, hop, second, window=w, contrast="none")
    y_ref = pk.fused_spectral_repr_reference(x, n_fft, hop, second, window=w, contrast="none")
    assert all(torch.equal(a, b) for a, b in zip(y, y_ref))
    h = pk.fused_repr_stats(x, n_fft, hop, second, window=w)
    c1, _ = pk._repr_channels(x, n_fft, hop, True, None, w, second, "log1p", None, False)
    assert torch.equal(h["ch1"]["max"], c1.max())
    assert not any(pk.launches.values())


def test_regions_kernel_route_by_family():
    """The region rule names each kernel's route by its family: the
    magnitude kernels (A, B, E, F) smooth at 896, the representations (G, H)
    factored with taps and product without; both families' factored /
    product front end at 1408 and smooth at 768.  The sweep measures the
    magnitude patterns' smooth route at 768 and 896 and their other route at
    1408, the representations' at 768 and 896."""
    assert regions.kernel_route(896, True, "melspec") == "smooth" == regions.kernel_route(896, False, "melspec")
    assert regions.kernel_route(896, True, "repr") == "factored" and regions.kernel_route(896, False, "repr") == "product"
    for fam in ("melspec", "repr"):
        assert regions.kernel_route(1408, True, fam) == "factored"
        assert regions.kernel_route(1408, False, fam) == "product"
        assert regions.kernel_route(768, True, fam) == "smooth" and regions.kernel_route(1024, False, fam) == "fft"
    assert not fft_covers_smooth(896) and fft_covers_smooth7(896)
    from acids_transforms_tpu_torch.tools import sweep_regions as tool

    for kind in tool.KINDS + tool.FIT_KINDS:
        want = tool.SEVEN_POINTS if kind in tool.MAGNITUDE_KINDS else tool.SMOOTH_POINTS
        assert tool.route_points(kind) is want
    assert set(tool.MAGNITUDE_KINDS) == {"melspec_taps", "melspec_fullk", "mfcc", "fit_melspec_fullk"}
    assert (1408, 352) in tool.FIT_SHAPES and (1024, 512) not in tool.FIT_SHAPES
