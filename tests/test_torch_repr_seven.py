"""The two-channel representation kernels G and H (``fused_spectral_repr`` /
``fused_repr_stats``) on the smooth route's radix-7 instance: where ``n_fft``
is even, ``2^a 3^b 5^c 7^d`` with a factor 7, 64 to 4096
(``frames_fft.fft_covers_smooth7``: 896, 1344, 1568, ...) and a block fits
shared memory, both run ``csrc/spectral.cu:repr_forward_kernel`` /
``repr_stats_kernel<., kFrontSmooth7>`` (``frames_rfft<true, true>``),
full-K under any window and with cosine-sum taps under the taps' own window
(``frames_fft.taps_window``).  Their plain versions run
``frames_rfft_reference(..., smooth=True)`` over the whole clip (the radices
of ``frames_fft.fft_radices``, sevens first), frames paired ``(2j, 2j + 1)``;
a block with the IF starts two frames before its tile, as on the 5-smooth
route.  The rule is ``spectral._repr_route``: ``melspec_route``'s, except G
with the IF and a mel bank at 4032/2016, whose narrowest smooth block does
not fit and which keeps the product (full-K) or factored (taps) front end.
``chip_smoke.py`` holds the kernels to these plain versions on the card.

Tolerances, and why:

* against the JAX package's ``fused_spectral_repr`` / ``fused_repr_stats``
  (its Pallas kernels in interpret mode) as ``tests/test_torch_repr_smooth.py``
  holds the 5-smooth route (``check_vs_jax``): channel 1 (and Re / Im)
  within 1e-4 of the largest value, the JAX kernels' budget; the angle (or
  the IF's phase steps) on the circle, weighted by |X| / max|X|, within
  1e-5; the statistics within the two packages' elementwise differences;
* against a float64 oracle (``np.fft.rfft`` of the windowed frames): |X|,
  Re and Im within 1e-5 of the largest |X|, the |X|-weighted angle within
  1e-5, and value by value (|X|, Re / Im) no further from it than the
  product or factored front end these shapes ran before;
* block by block: the plain version's whole-clip spectrum equals a
  tile-by-tile emulation of the kernel bit for bit (with the IF's two halo
  frames), where a halo of one frame would pair the frames otherwise;
* G and H with taps against G and H full-K under ``taps_window(taps,
  n_fft)``: bit for bit (the kernels are one instance).
"""
import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from test_torch_common import make_audio, t2n
from test_torch_repr_kernel import angle_error
from test_torch_repr_smooth import (_block_spectra, check_vs_jax, magnitude_weights, oracle_angle,
                                    oracle_spectrum, window_of)

torch.set_num_threads(1)
HANN = (0.5, -0.25)
N_SAMPLES = 6200          # T = 28 at hop 224, 65 at 96: no whole tile
AFF = (0.0123, 2.345, -0.05, 1.3)


@pytest.fixture(scope="module")
def audio():
    return make_audio(131, batch=2, n=N_SAMPLES)[:, 0].copy()


def seven_shapes():
    """Every (n_fft, hop) the kernels' gate takes (hop a multiple of 32,
    overlap 2 to 8) at an even 7-smooth n_fft with a factor 7."""
    out = []
    for n_fft in range(64, 4097, 2):
        if not FF.fft_covers_smooth7(n_fft) or n_fft % 7:
            continue
        for ov in range(2, 9):
            if n_fft % ov == 0 and (n_fft // ov) % 32 == 0:
                out.append((n_fft, n_fft // ov))
    return out


def configurations():
    """(stats, second, mel) of every launch G and H make."""
    return [(stats, second, mel) for stats in (False, True) for second in pk.SECONDS
            for mel in ((False,) if stats else (False, True))]


def test_route_rule_and_plans_at_every_seven_shape():
    """The 42 shapes: every G and H launch (each second, with and without
    the bank) plans the radix-7 instance, full-K and with taps alike, its
    block within shared memory; G with the IF and a bank at 4032/2016 keeps
    its product / factored tile (8, 0), which fits there.  No shape that had
    a plan loses it."""
    shapes = seven_shapes()
    assert len(shapes) == 42
    kept = []
    for n_fft, hop in shapes:
        ov, F = n_fft // hop, n_fft // 2 + 1
        assert pk.melspec_route(n_fft) == "smooth" and FF.fft_radices(n_fft)[0] == 7
        for stats, second, mel in configurations():
            tile, teams = pk._repr_plan(n_fft, hop, None, stats, second, mel)
            assert pk._repr_plan(n_fft, hop, HANN, stats, second, mel) == (tile, teams)
            if teams == 0:
                kept.append((n_fft, hop, stats, second, mel))
                assert (tile, teams) == (pk._pick_repr_tile(hop, ov, F), 0) == (8, 0)
                assert pk._repr_smem_bytes(tile, hop, ov, F, stats) <= FF.MAX_SMEM
                assert pk._repr_route(n_fft, hop, None, stats, second, mel) == "other"
                continue
            assert tile in pk.FFT_TILES and 1 <= teams <= FF.fft_smooth_max_teams(n_fft)
            assert pk._repr_fft_smem_bytes(tile, hop, ov, F, teams, stats, second, mel) <= FF.MAX_SMEM
            assert pk._repr_route(n_fft, hop, HANN, stats, second, mel) == "smooth"
    assert kept == [(4032, 2016, False, "if", True)]
    assert pk._pick_repr_smooth_plan(4032, 2016, False, "if", True) is None
    assert pk._repr_fft_smem_bytes(2, 2016, 2, 2017, 1, False, "if", True) == 237316 > FF.MAX_SMEM
    # the plans at 896/224 and 1568/224
    assert pk._repr_plan(896, 224, None, False, "if", True) == (8, 4)
    assert pk._repr_plan(896, 224, None, True, "if", False) == (8, 4)
    assert pk._repr_plan(896, 224, HANN, False, "phase", True) == (16, 4)
    assert pk._repr_plan(896, 224, HANN, True, "phase", False) == (8, 4)
    assert pk._repr_plan(1568, 224, HANN, False, "phase", True) == (8, 2)


def test_4032_2016_plain_versions_follow_the_plan(audio):
    """At 4032/2016 G with the IF and a bank runs the product front end in
    its plain version as its kernel does, and without the bank (or H) the
    radix-7 schedule: the plain versions read the same rule."""
    n_fft, hop = 4032, 2016
    x = torch.as_tensor(audio)
    w = torch.as_tensor(window_of(n_fft, None))
    bank = PT.Magnitude(mode="bipolar", n_fft=n_fft, device="cpu").mel_bank
    seven = pk._fullk_spectrum(x, n_fft, hop, True, w, smooth=True)
    product = pk._fullk_spectrum(x, n_fft, hop, True, w)
    assert not torch.equal(seven[0], product[0])

    def channels(re, im):
        im = pk._pin_nyquist(im)
        mag = torch.log1p(torch.matmul(torch.sqrt(re * re + im * im), bank))
        return mag, torch.sqrt(re * re + im * im)

    y1, _ = pk.fused_spectral_repr_reference(x, n_fft, hop, "if", mel_bank=bank, weighted=True, window=w)
    assert torch.equal(y1, channels(*product)[0])
    h = pk.fused_repr_stats_reference(x, n_fft, hop, "if", contrast="none", weighted=True, window=w)
    assert h["ch1"]["max"] == channels(*seven)[1].max()
    y1_s, _ = pk.fused_spectral_repr_reference(x, n_fft, hop, "phase", mel_bank=bank, window=w)
    assert torch.equal(y1_s, channels(*seven)[0])
    assert not any(pk.launches.values())


@pytest.mark.parametrize("second,weighted", [("phase", False), ("if", True), ("imag", False)])
def test_g_h_fullk_seven_plain_vs_pallas_kernel(audio, second, weighted):
    """Under the DGT's gaussian at 896/224 (2^7 7)."""
    check_vs_jax(audio, 896, 224, second, weighted, None)


def test_g_h_taps_seven_plain_vs_pallas_factored_kernel(audio):
    """The Polar chain of ``STFT(896, 224)``: hann taps, the angle."""
    check_vs_jax(audio, 896, 224, "phase", False, HANN)


@pytest.mark.parametrize("taps", [None, HANN], ids=["fullk", "hann"])
@pytest.mark.parametrize("n_fft,hop", [(896, 224), (1568, 224), (672, 96)])
def test_seven_plain_version_vs_float64_oracle(audio, n_fft, hop, taps):
    """|X|, Re, Im and the |X|-weighted angle and IF within 1e-5 of the
    float64 oracle, and value by value (|X|, Re / Im) no further from it
    than the product or factored front end these shapes ran before (the
    weighted angles sit at float32 rounding on both, where which is closer
    is chance).  896 = 2^7 7 at overlap 4, 1568 = 2^5 7^2 (radices 7 7),
    672 = 2^5 3 7 at overlap 7."""
    x = torch.as_tensor(audio)
    w = window_of(n_fft, taps)
    wt_t = None if taps is not None else torch.as_tensor(w)
    S = oracle_spectrum(audio, w, n_fft, hop)
    top = np.abs(S).max()
    old = [t.double().numpy() for t in (pk._fullk_spectrum(x, n_fft, hop, True, wt_t) if taps is None
                                        else pk._factored_spectrum(x, n_fft, hop, True, taps))]
    im_old = old[1].copy()
    im_old[..., -1] = 0.0
    for second, weighted in (("imag", False), ("phase", False), ("if", True)):
        c1, c2 = (c.double().numpy() for c in pk._repr_channels(x, n_fft, hop, True, taps, wt_t, second,
                                                                  "none", None, weighted))
        if second == "imag":
            want = (S.real, np.where(np.arange(S.shape[-1]) == S.shape[-1] - 1, 0.0, S.imag))
            e_new = max(np.abs(c1 - want[0]).max(), np.abs(c2 - want[1]).max())
            e_old = max(np.abs(old[0] - want[0]).max(), np.abs(im_old - want[1]).max())
            assert e_new <= 1e-5 * top and e_new <= e_old, (e_new, e_old)
            continue
        e1 = np.abs(c1 - np.abs(S)).max()
        assert e1 <= 1e-5 * top and e1 <= np.abs(np.hypot(old[0], im_old) - np.abs(S)).max()
        wt = magnitude_weights(S, second)
        e2 = (angle_error(second, oracle_angle(S, second, weighted), c2, weighted, scale=1.0) * wt).max()
        assert e2 <= 1e-5, (second, e2)


@pytest.mark.parametrize("tile_t", [4, 16])
def test_halo_pairs_frames_as_the_whole_clip(audio, tile_t):
    """At 896/224, every frame a block computes, the IF's halo frame
    included, comes out of the block's radix-7 FFTs bit for bit as out of
    the whole-clip schedule of the plain version; a block that started at
    its halo frame would pair it with the tile's first frame (other pairs,
    other rounding)."""
    n_fft, hop = 896, 224
    x = torch.as_tensor(audio)
    w = torch.as_tensor(window_of(n_fft, None))
    re_w, im_w = pk._spectrum(x, n_fft, hop, True, None, w)
    rows, T, _ = pk._prepare_rows(x, n_fft, hop, True)
    frames = rows.reshape(rows.shape[0], -1).unfold(-1, n_fft, hop)[:, :T]
    assert all(torch.equal(a, b) for a, b in zip((re_w, im_w), FF.frames_rfft_reference(frames, w, smooth=True)))
    for halo, same in ((2, True), (1, False)):
        agree = True
        for f0, re, im in _block_spectra(x, n_fft, hop, w, tile_t, halo):
            k = max(0, -f0)                                  # the first block's frames before 0 are padding
            ref_re, ref_im = re_w[:, f0 + k: f0 + re.shape[1]], im_w[:, f0 + k: f0 + re.shape[1]]
            agree &= torch.equal(re[:, k:], ref_re) and torch.equal(im[:, k:], ref_im)
            assert (re[:, k:] - ref_re).abs().max() <= 1e-5 * re_w.abs().max()
        assert agree == same
    c1, _ = pk._repr_channels(x, n_fft, hop, True, None, w, "if", "none", None, True)
    im_p = pk._pin_nyquist(im_w)
    assert torch.equal(c1, torch.sqrt(re_w * re_w + im_p * im_p))


@pytest.mark.parametrize("second", sorted(pk.SECONDS))
@pytest.mark.parametrize("n_fft,hop", [(896, 224), (1344, 192)])
def test_g_h_with_taps_are_g_h_fullk_under_the_taps_window(audio, n_fft, hop, second):
    """G and H with hann taps are G and H full-K under ``taps_window(taps,
    n_fft)``, bit for bit (with the bank and the affine, int16 input), on an
    odd clip length."""
    x = torch.as_tensor(audio[:, :6199])
    w = torch.as_tensor(FF.taps_window(HANN, n_fft))
    bank = None if second == "imag" else PT.Magnitude(mode="bipolar", n_fft=n_fft, device="cpu").mel_bank
    kw = dict(mel_bank=bank, aff=AFF, weighted=second == "if")
    g = pk.fused_spectral_repr(x, n_fft, hop, second, taps=HANN, **kw)
    g_fk = pk.fused_spectral_repr(x, n_fft, hop, second, taps=None, window=w, **kw)
    assert all(torch.equal(a, b) for a, b in zip(g, g_fk))
    x16 = torch.round(x * 32767.0).to(torch.int16)
    assert all(torch.equal(a, b) for a, b in zip(pk.fused_spectral_repr(x16, n_fft, hop, second, taps=HANN),
                                                  pk.fused_spectral_repr(x16, n_fft, hop, second, window=w)))
    h = pk.fused_repr_stats(x, n_fft, hop, second, weighted=second == "if", taps=HANN)
    h_fk = pk.fused_repr_stats(x, n_fft, hop, second, weighted=second == "if", taps=None, window=w)
    assert h["count"] == h_fk["count"] == g[0].numel()
    assert all(torch.equal(h[c][k], h_fk[c][k]) for c in ("ch1", "ch2") for k in ("sum", "sumsq", "min", "max"))
    assert t2n(g[0]).shape == (2, 1 + 6199 // hop, n_fft // 2 + 1)
