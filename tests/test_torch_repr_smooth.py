"""The two-channel representation kernels G and H (``fused_spectral_repr`` /
``fused_repr_stats``) on the smooth route: where ``n_fft`` is even,
``2^a 3^b 5^c``, 64 to 4096 and no power of two
(``frames_fft.fft_covers_smooth``: 768, 384, 640, 1536, 1920, ...) both run
``csrc/spectral.cu:repr_forward_kernel`` / ``repr_stats_kernel<.,
kFrontSmooth>`` (the mixed-radix ``frames_rfft<true>``), full-K under any
window and with cosine-sum taps under the taps' own window
(``frames_fft.taps_window``).  Their plain versions run
``frames_rfft_reference(..., smooth=True)`` over the whole clip, frames paired
``(2j, 2j + 1)``; a block with the IF starts two frames before its tile (the
halo frame and its FFT partner), so that it pairs its frames as the whole
clip does.  896 = 2^7 7 keeps the product (full-K) and factored (taps) front
ends, a power of two the FFT route.  ``chip_smoke.py`` holds the kernels to
these plain versions on the card.

Tolerances, and why:

* against the JAX package's ``fused_spectral_repr`` / ``fused_repr_stats``
  (its Pallas kernels in interpret mode: the full-K product under the DGT's
  gaussian, the factored one under hann taps) as
  ``tests/test_torch_repr_fft.py`` holds the FFT route: channel 1 (and Re /
  Im) within 1e-4 of the largest value, the JAX kernels' budget; the angle
  (or the IF's phase steps) on the circle, weighted by |X| / max|X|, within
  1e-5; the statistics within the two packages' elementwise differences;
* against a float64 oracle (``np.fft.rfft`` of the windowed frames): |X|, Re
  and Im within 1e-5 of the largest |X|, the |X|-weighted angle within 1e-5,
  and value by value no further from it than the product or factored front
  end that 768 ran before;
* block by block: the plain version's whole-clip spectrum equals a
  tile-by-tile emulation of the kernel bit for bit (with the IF's two halo
  frames), where a halo of one frame would pair the frames otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops.pallas import spectral as jk
from acids_transforms_tpu.ops.windows import gaussian_dgt_window as jgauss
from acids_transforms_tpu_torch import regions
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.tools import sweep_regions as tool
from test_torch_common import make_audio, t2n
from test_torch_regions import _sweep_rows, _with_table
from test_torch_repr_kernel import angle_error

torch.set_num_threads(1)
HANN = (0.5, -0.25)
N_SAMPLES = 6200          # T = 25 at hop 256, 33 at 192, 65 at 96: odd, no whole tile
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture(scope="module")
def audio():
    return make_audio(125, batch=2, n=N_SAMPLES)[:, 0].copy()


def window_of(n_fft, taps):
    """The analysis window: the DGT's gaussian full-K, else the taps' own."""
    return np.array(jgauss(n_fft), np.float32) if taps is None else np.asarray(FF.taps_window(taps, n_fft),
                                                                               np.float32)


def oracle_spectrum(x, w, n_fft, hop):
    """float64 STFT of the reflect-padded frames under the window ``w``,
    (B, T, F) complex."""
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.fft.rfft(xp[:, idx] * np.asarray(w, np.float64), axis=-1)


def magnitude_weights(S, second):
    """|X| / max|X| per clip; for the IF, of the quieter of the two frames a
    row's phase difference is taken from."""
    m = np.abs(S) / np.abs(S).max(axis=(-2, -1), keepdims=True)
    if second == "if":
        m[:, 1:] = np.minimum(m[:, 1:], m[:, :-1])
    return m


def oracle_angle(S, second, weighted):
    """Channel 2 of the oracle before its affine: the angle (the nyquist bin
    exactly 0 or pi) or its frame-local IF."""
    ang = np.angle(S)
    ang[..., -1] = np.where(S.real[..., -1] < 0, np.pi, 0.0)
    if second == "phase":
        return ang
    return t2n(pk._if_rows(torch.as_tensor(ang), weighted)).astype(np.float64)


def check_vs_jax(x, n_fft, hop, second, weighted, taps):
    """G's channels (no mel, no affine) and H's statistics of the plain
    smooth versions against the JAX kernels: one JAX call of each."""
    assert pk.melspec_route(n_fft, "repr") == "smooth"
    for stats in (False, True):
        assert pk._repr_plan(n_fft, hop, taps, stats, second, False)[1] > 0
    w = window_of(n_fft, taps)
    wj = jnp.asarray(w if taps is None else np.ones(n_fft, np.float32))
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    kw = dict(weighted=weighted, taps=taps)
    jy = [np.asarray(a, np.float64) for a in jk.fused_spectral_repr(xj, n_fft, hop, wj, second, interpret=True,
                                                                    **kw)]
    py = [a.double() for a in pk.fused_spectral_repr(xt, n_fft, hop, second, window=torch.as_tensor(w), **kw)]
    p1, p2 = py[0].numpy(), py[1].numpy()
    assert p1.shape == jy[0].shape and p2.shape == jy[1].shape
    assert np.abs(p1 - jy[0]).max() <= 1e-4 * np.abs(jy[0]).max()
    if second == "imag":
        assert np.abs(p2 - jy[1]).max() <= 1e-4 * np.abs(jy[1]).max()
    else:
        wt = magnitude_weights(oracle_spectrum(x, w, n_fft, hop), second)
        err = angle_error(second, jy[1], p2, weighted, scale=1.0)
        assert (err * wt).max() <= 1e-5
        assert err[wt > 1e-3].max() <= 1e-2
    sj = jk.fused_repr_stats(xj, n_fft, hop, wj, second, interpret=True, **kw)
    sp = pk.fused_repr_stats(xt, n_fft, hop, second, window=torch.as_tensor(w), **kw)
    assert sp["count"] == sj["count"] == p1.size
    for ch, pv, jv in (("ch1", py[0], jy[0]), ("ch2", py[1], jy[1])):
        # the plain statistics are those of the plain channels
        n = sp["count"]
        assert abs(float(sp[ch]["sum"]) - pv.sum().item()) <= 1e-12 * n * pv.abs().max().item()
        assert float(sp[ch]["min"]) == pv.min().item() and float(sp[ch]["max"]) == pv.max().item()
        # against JAX: within the two packages' elementwise differences
        pv = pv.numpy()
        assert abs(float(sp[ch]["sum"]) - float(sj[ch]["sum"])) <= np.abs(pv - jv).sum() + 1e-6 * np.abs(jv).sum()
        assert (abs(float(sp[ch]["sumsq"]) - float(sj[ch]["sumsq"]))
                <= np.abs(pv * pv - jv * jv).sum() + 1e-6 * (jv * jv).sum())
        tol = 1e-4 * np.abs(jv).max()
        if ch == "ch2" and second != "imag":
            tol = max(tol, np.abs(pv - jv).max())
        for k in ("min", "max"):
            assert abs(float(sp[ch][k]) - float(sj[ch][k])) <= tol


@pytest.mark.parametrize("n_fft,hop,second,weighted", [
    (768, 256, "phase", False), (768, 256, "if", True), (768, 256, "imag", False),
    (384, 96, "phase", False), (384, 96, "if", True)])
def test_g_h_fullk_smooth_plain_vs_pallas_kernel(audio, n_fft, hop, second, weighted):
    """Under the DGT's gaussian; 384/96 (2^7 3) at overlap 4 beside 768/256
    at overlap 3 (its Cartesian channels are the spectrum the first two hold)."""
    check_vs_jax(audio, n_fft, hop, second, weighted, None)


def test_g_h_taps_smooth_plain_vs_pallas_factored_kernel(audio):
    """The Polar chain of ``STFT(768, 192)``: hann taps, the angle."""
    check_vs_jax(audio, 768, 192, "phase", False, HANN)


@pytest.mark.parametrize("n_fft,hop,taps", [(768, 256, None), (768, 192, HANN), (1920, 480, HANN)])
def test_smooth_plain_version_vs_float64_oracle(audio, n_fft, hop, taps):
    """|X|, Re, Im and the |X|-weighted angle and IF within 1e-5 of the
    float64 oracle, and value by value (|X|, Re / Im) no further from it
    than the product or factored front end 768 ran before.  (The weighted
    angles sit at float32 rounding on both front ends, 4e-7, where which is
    closer is chance.)"""
    x = torch.as_tensor(audio)
    w = window_of(n_fft, taps)
    wt_t = None if taps is not None else torch.as_tensor(w)
    S = oracle_spectrum(audio, w, n_fft, hop)
    top = np.abs(S).max()
    old = [t.double().numpy() for t in (pk._fullk_spectrum(x, n_fft, hop, True, wt_t) if taps is None
                                        else pk._factored_spectrum(x, n_fft, hop, True, taps))]
    for second, weighted in (("imag", False), ("phase", False), ("if", True)):
        chans = [pk._repr_channels(x, n_fft, hop, True, taps, wt_t, second, "none", None, weighted)]
        im_old = old[1].copy()
        im_old[..., -1] = 0.0
        if second == "imag":
            want = (S.real, np.where(np.arange(S.shape[-1]) == S.shape[-1] - 1, 0.0, S.imag))
            got = [c.double().numpy() for c in chans[0]]
            e_new = max(np.abs(g - o).max() for g, o in zip(got, want))
            e_old = max(np.abs(old[0] - want[0]).max(), np.abs(im_old - want[1]).max())
            assert e_new <= 1e-5 * top and e_new <= e_old, (e_new, e_old)
            continue
        c1, c2 = (c.double().numpy() for c in chans[0])
        e1 = np.abs(c1 - np.abs(S)).max()
        assert e1 <= 1e-5 * top and e1 <= np.abs(np.hypot(old[0], im_old) - np.abs(S)).max()
        wt = magnitude_weights(S, second)
        want2 = oracle_angle(S, second, weighted)
        e2 = (angle_error(second, want2, c2, weighted, scale=1.0) * wt).max()
        assert e2 <= 1e-5, (second, e2)


def _block_spectra(x, n_fft, hop, window, tile_t, halo):
    """The smooth route's front end block by block as the kernel runs it:
    rows with ``halo`` leading zero chunks, a block's frames ``t0 - halo ..
    t0 + tile_t - 1`` through ``frames_rfft_reference(..., smooth=True)`` in
    the block's own pairs.  Yields ``(first frame, re, im)`` per block."""
    rows, T, n_tiles = pk._prepare_rows(x, n_fft, hop, True, tile_t, lead=halo)
    frames = rows.reshape(rows.shape[0], -1).unfold(-1, n_fft, hop)      # frame f at f + halo
    for tile in range(n_tiles):
        t0 = tile * tile_t
        re, im = FF.frames_rfft_reference(frames[:, t0: t0 + halo + min(tile_t, T - t0)], window, smooth=True)
        yield t0 - halo, re, im


@pytest.mark.parametrize("tile_t", [4, 16])
def test_halo_pairs_frames_as_the_whole_clip(audio, tile_t):
    """Every frame a block computes, the IF's halo frame included, comes out
    of the block's mixed-radix FFTs bit for bit as out of the whole-clip
    schedule of the plain version; a block that started at its halo frame
    would pair it with the tile's first frame (other pairs, other rounding)."""
    n_fft, hop = 768, 256
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
    # the IF channel is the whole-clip spectrum's
    c1, c2 = pk._repr_channels(x, n_fft, hop, True, None, w, "if", "none", None, True)
    im_p = pk._pin_nyquist(im_w)
    assert torch.equal(c1, torch.sqrt(re_w * re_w + im_p * im_p))


def test_route_rule_and_plans():
    """G and H take the smooth route, full-K and with taps, at every even
    5-smooth shape the gate takes (64-4096, overlap 2-8, hop a multiple of
    32), every plan within shared memory; 896/224 keeps the factored and
    product front ends, 1024 the FFT route; no launch is counted on a CPU
    tensor."""
    n_shapes = 0
    for n_fft in range(64, 4097, 2):
        if not FF.fft_covers_smooth(n_fft):
            continue
        for ov in range(2, 9):
            hop = n_fft // ov
            if n_fft % ov or hop % 32:
                continue
            n_shapes += 1
            for stats in (False, True):
                for second in pk.SECONDS:
                    for mel in ((False,) if stats else (False, True)):
                        tile, teams = pk._repr_plan(n_fft, hop, None, stats, second, mel)
                        assert pk._repr_plan(n_fft, hop, HANN, stats, second, mel) == (tile, teams)
                        assert tile in pk.FFT_TILES and 1 <= teams <= FF.fft_smooth_max_teams(n_fft)
                        assert pk._repr_fft_smem_bytes(tile, hop, ov, n_fft // 2 + 1, teams, stats, second,
                                                       mel) <= FF.MAX_SMEM
    assert n_shapes > 40
    for stats in (False, True):
        for second in pk.SECONDS:
            mel = not stats and second != "imag"
            assert pk._repr_plan(896, 224, HANN, stats, second, mel) == (pk._pick_repr_tile(224, 4, 449), 0)
            assert pk._repr_plan(896, 224, None, stats, second, mel) == (pk._pick_repr_tile(224, 4, 449), 0)
            assert pk._repr_plan(1024, 256, None, stats, second, mel) == pk._pick_repr_fft_plan(
                1024, 256, stats, second, mel)
    assert pk.melspec_route(896, "repr") == "other" and pk.melspec_route(1024, "repr") == "fft"
    pk.reset_launches()
    x = torch.as_tensor(make_audio(126, batch=2, n=3000)[:, 0])
    w = torch.as_tensor(window_of(768, None))
    pk.fused_spectral_repr(x, 768, 256, "if", window=w)
    pk.fused_repr_stats(x, 768, 256, "if", window=w)
    pk.fused_spectral_repr(x, 768, 192, "phase", taps=HANN)
    pk.fused_repr_stats(x, 768, 192, "phase", taps=HANN)
    assert not any(pk.launches.values()) and not any(pk.routes.values())
    assert {"fused_spectral_repr:smooth", "fused_repr_stats:smooth", "fused_spectral_repr_fullk:smooth",
            "fused_repr_stats_fullk:smooth"} <= set(pk.routes)


def test_region_rule_reads_the_smooth_point(monkeypatch):
    """The representations' regions read 768/192 as their smooth route's
    point, as the log-mel regions do: a sweep where 768 wins and 896 loses
    admits the smooth route and refuses the product / factored one."""
    assert regions.kernel_route(768, True, "repr") == "smooth" and regions.kernel_route(768, False, "repr") == "smooth"
    assert regions.kernel_route(896, True, "repr") == "factored"
    assert regions.kernel_route(896, False, "repr") == "product"
    for kind in ("repr_if_fullk", "repr_if_taps", "repr_phase_fullk", "repr_phase_taps", "fit_repr_if_fullk"):
        assert tool.route_points(kind) is tool.SMOOTH_POINTS
    win768 = _sweep_rows(tool.SHAPES, s768=0.6, s896=1.4)
    r = {k: tool.shape_region(win768, CARD, "w", k) for k in ("repr_if_fullk", "repr_phase_taps")}
    assert r["repr_if_fullk"]["routes"] == ["fft", "smooth"] and r["repr_phase_taps"]["routes"] == ["fft", "smooth"]
    _with_table(monkeypatch, fuse_forward={"repr_if": {"taps": r["repr_phase_taps"], "fullk": r["repr_if_fullk"]}})
    assert regions.repr_region_ok(768, 256, False, "if") and regions.repr_region_ok(768, 192, True, "if")
    assert not regions.repr_region_ok(896, 224, False, "if") and not regions.repr_region_ok(896, 224, True, "if")
