"""The full-K representation kernels (G and H full-K) on the FFT route
(``csrc/spectral.cu:repr_forward_fft`` / ``repr_stats_fft`` over
``csrc/fft_smem.cuh:frames_rfft``) as their plain versions
(``ops/cuda/spectral.py:fused_spectral_repr_reference`` /
``fused_repr_stats_reference``), which take the FFT route's schedule over the
whole clip where ``frames_fft.fft_covers(n_fft)``: pairs of frames ``(2j, 2j +
1)``, the Stockham passes, the split, then the unchanged epilogue.

* against the JAX package's Pallas kernels ``_repr_kernel`` /
  ``_repr_stats_kernel`` in interpret mode for ``phase``, ``if`` (weighted
  and not) and ``imag`` at 512/128 and 1024/256, the frame count odd and no
  whole number of tiles, under ``tests/test_torch_repr_kernel.py``'s
  tolerances (channel 1 1e-4 relative; angles on the circle, weighted by
  |X| / max|X|, 1e-5; the statistics within the two packages' elementwise
  differences);
* the product route still held against JAX at 1408/352 (2^7 11), the
  smooth route at 768/256;
* the plain version is the same whatever the card's frame tile: the
  whole-clip schedule equals a tile-by-tile emulation of the kernel (two
  frames before each tile: the IF's halo frame and its FFT partner) bit for
  bit at two tile heights, where a halo of one frame would not;
* the block plans, and no route counted on the CPU.

On the card ``chip_smoke.py`` holds the kernels against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops.mel import square_mel_banks
from acids_transforms_tpu.ops.pallas import spectral as jk
from acids_transforms_tpu.ops.windows import gaussian_dgt_window as jgauss
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from test_torch_common import make_audio, t2n
from test_torch_repr_kernel import angle_error

AFF = (0.1, 1.3, -0.2, 0.9)
N_SAMPLES = 6200          # T = 49 at hop 128, 25 at hop 256: odd, no whole tile


@pytest.fixture(scope="module")
def audio():
    return make_audio(61, batch=2, n=N_SAMPLES)[:, 0].copy()


def weights(x, w, n_fft, hop, second):
    """|X| / max|X| per clip; for the IF, of the quieter of the two frames a
    row's phase difference is taken from."""
    from acids_transforms_tpu.ops import fft as jfft

    m = np.abs(np.asarray(jfft.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(w))))
    m = m / m.max(axis=(-2, -1), keepdims=True)
    if second == "if":
        m[:, 1:] = np.minimum(m[:, 1:], m[:, :-1])
    return m


def run_g(x, n_fft, hop, second, weighted):
    w = np.array(jgauss(n_fft))
    bank = square_mel_banks(n_fft, 44100)[0] if second != "imag" else None
    aff = (0.0, 1.3, 0.0, 1.0) if second == "if" else AFF
    jy = jk.fused_spectral_repr(jnp.asarray(x), n_fft, hop, jnp.asarray(w), second,
                                mel_bank=None if bank is None else jnp.asarray(bank), aff=aff,
                                weighted=weighted, interpret=True)
    py = pk.fused_spectral_repr(torch.as_tensor(x), n_fft, hop, second,
                                mel_bank=None if bank is None else torch.as_tensor(bank), aff=aff,
                                weighted=weighted, window=torch.as_tensor(w))
    return [np.asarray(a) for a in jy], [t2n(a) for a in py], w, aff


def check_g(x, n_fft, hop, second, weighted):
    (j1, j2), (p1, p2), w, aff = run_g(x, n_fft, hop, second, weighted)
    assert p1.shape == j1.shape and p2.shape == j2.shape
    assert np.abs(p1 - j1).max() / np.abs(j1).max() <= 1e-4
    if second == "imag":
        assert np.abs(p2 - j2).max() / np.abs(j2).max() <= 1e-4
        return
    wt = weights(x, w, n_fft, hop, second)
    err = angle_error(second, j2, p2, weighted, scale=aff[3])
    assert (err * wt).max() <= 1e-5
    assert err[wt > 1e-3].max() <= 1e-2


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256)])
@pytest.mark.parametrize("second,weighted", [("phase", False), ("if", False), ("if", True), ("imag", False)])
def test_g_fft_plain_vs_pallas_kernel(audio, n_fft, hop, second, weighted):
    assert FF.fft_covers(n_fft) and pk._repr_plan(n_fft, hop, None, False, second, second != "imag")[1] > 0
    T = 1 + audio.shape[-1] // hop
    tile = pk._repr_plan(n_fft, hop, None, False, second, second != "imag")[0]
    assert T % 2 == 1 and T % tile
    check_g(audio, n_fft, hop, second, weighted)


def check_h(x, n_fft, hop, second):
    w = np.array(jgauss(n_fft))
    kw = dict(weighted=second == "if")
    sj = jk.fused_repr_stats(jnp.asarray(x), n_fft, hop, jnp.asarray(w), second, interpret=True, **kw)
    sp = pk.fused_repr_stats(torch.as_tensor(x), n_fft, hop, second, window=torch.as_tensor(w), **kw)
    assert sp["count"] == sj["count"]
    aff0 = dict(aff=(0.0, 1.0, 0.0, 1.0), **kw)
    jy = [np.asarray(a, np.float64) for a in jk.fused_spectral_repr(
        jnp.asarray(x), n_fft, hop, jnp.asarray(w), second, interpret=True, **aff0)]
    py = [a.double() for a in pk.fused_spectral_repr(
        torch.as_tensor(x), n_fft, hop, second, window=torch.as_tensor(w), **aff0)]
    n = sp["count"]
    for ch, pv, jv in (("ch1", py[0], jy[0]), ("ch2", py[1], jy[1])):
        # the plain statistics are those of the plain channels
        assert abs(float(sp[ch]["sum"]) - pv.sum().item()) <= 1e-12 * n * pv.abs().max().item()
        assert float(sp[ch]["min"]) == pv.min().item() and float(sp[ch]["max"]) == pv.max().item()
        # against JAX: within the two packages' elementwise differences
        pv = pv.numpy()
        slack = 1e-6 * np.abs(jv).sum()
        assert abs(float(sp[ch]["sum"]) - float(sj[ch]["sum"])) <= np.abs(pv - jv).sum() + slack
        assert (abs(float(sp[ch]["sumsq"]) - float(sj[ch]["sumsq"]))
                <= np.abs(pv * pv - jv * jv).sum() + 1e-6 * (jv * jv).sum())
        tol = 1e-4 * np.abs(jv).max()
        if ch == "ch2" and second != "imag":
            tol = max(tol, np.abs(pv - jv).max())
        for k in ("min", "max"):
            assert abs(float(sp[ch][k]) - float(sj[ch][k])) <= tol


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256)])
@pytest.mark.parametrize("second", ["phase", "if", "imag"])
def test_h_fft_plain_vs_pallas_kernel(audio, n_fft, hop, second):
    assert pk._repr_plan(n_fft, hop, None, True, second, False)[1] > 0
    check_h(audio, n_fft, hop, second)


def test_product_route_vs_pallas_kernel_at_768_256(audio):
    """The product route, at 1408/352 (2^7 11; 768/256 takes the smooth
    route since G and H have one, held here as G's smooth case and in
    ``tests/test_torch_repr_smooth.py``, and 896/224 its radix-7 instance,
    ``tests/test_torch_repr_seven.py``)."""
    n_fft, hop = 1408, 352
    assert not FF.fft_covers(n_fft) and not FF.fft_covers_smooth7(n_fft)
    for stats in (False, True):
        assert pk._repr_plan(n_fft, hop, None, stats, "if", not stats)[1] == 0
        assert pk._repr_plan(768, 256, None, stats, "if", not stats)[1] > 0
    check_g(audio, n_fft, hop, "if", True)
    check_h(audio, n_fft, hop, "phase")
    check_g(audio, 768, 256, "if", True)


def _block_spectra(x, n_fft, hop, window, tile_t, halo):
    """The FFT route's front end block by block as the kernel runs it: rows
    with ``halo`` leading zero chunks, a block's frames ``t0 - halo .. t0 +
    tile_t - 1`` through ``frames_rfft_reference`` in the block's own pairs.
    Yields ``(first frame, re, im)`` per block."""
    rows, T, n_tiles = pk._prepare_rows(x, n_fft, hop, True, tile_t, lead=halo)
    frames = rows.reshape(rows.shape[0], -1).unfold(-1, n_fft, hop)      # frame f at f + halo
    for tile in range(n_tiles):
        t0 = tile * tile_t
        re, im = FF.frames_rfft_reference(frames[:, t0: t0 + halo + min(tile_t, T - t0)], window)
        yield t0 - halo, re, im


@pytest.mark.parametrize("tile_t", [8, 16])
def test_plain_version_is_the_same_whatever_the_tile(audio, tile_t):
    """Every frame a block computes, its IF's halo frame included, comes out
    of the block's FFTs bit for bit as out of the whole-clip schedule of the
    plain version: the channels, elementwise functions of the spectrum on the
    card, then agree whatever the tile.  A block that started at its halo
    frame (one frame before the tile) would pair it with the tile's first
    frame: other pairs, other rounding."""
    n_fft, hop = 512, 128
    x = torch.as_tensor(audio)
    w = torch.as_tensor(np.array(jgauss(n_fft)))
    re_w, im_w = pk._spectrum(x, n_fft, hop, True, None, w)
    for halo, same in ((2, True), (1, False)):
        agree = True
        for f0, re, im in _block_spectra(x, n_fft, hop, w, tile_t, halo):
            k = max(0, -f0)                                  # the first block's frames before 0 are padding
            ref_re, ref_im = re_w[:, f0 + k: f0 + re.shape[1]], im_w[:, f0 + k: f0 + re.shape[1]]
            agree &= torch.equal(re[:, k:], ref_re) and torch.equal(im[:, k:], ref_im)
            assert (re[:, k:] - ref_re).abs().max() <= 1e-5 * re_w.abs().max()
        assert agree == same
    # the plain channels are those of the whole-clip spectrum
    c1, c2 = pk._repr_channels(x, n_fft, hop, True, None, w, "if", "none", None, True)
    im_p = pk._pin_nyquist(im_w)
    assert torch.equal(c1, torch.sqrt(re_w * re_w + im_p * im_p))


def test_fft_plans_and_routes():
    # the main path (DGT(1024, 256) + PolarIF: IF, a mel bank): 8 frames, 4 FFTs,
    # two blocks an SM, for G and for H
    for stats in (False, True):
        tile, teams = pk._repr_plan(1024, 256, None, stats, "if", not stats)
        assert (tile, teams) == (8, 4)
        assert pk._repr_fft_smem_bytes(tile, 256, 4, 513, teams, stats, "if", not stats) <= FF.TWO_BLOCKS_SMEM
    # every shape the gate takes at a power of two has a plan on the FFT route
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        for ov in (2, 4, 8):
            hop = n_fft // ov
            if not pk.fused_melspec_available(n_fft, hop, None):
                continue
            for stats in (False, True):
                for second in pk.SECONDS:
                    for mel in (False, True):
                        tile, teams = pk._repr_plan(n_fft, hop, None, stats, second, mel)
                        assert tile in pk.FFT_TILES and 1 <= teams <= FF.fft_max_teams(n_fft)
                        assert pk._repr_fft_smem_bytes(tile, hop, ov, n_fft // 2 + 1, teams, stats, second,
                                                       mel) <= FF.MAX_SMEM
    # no route counted on the CPU
    pk.reset_launches()
    x = torch.zeros(2, 3000)
    pk.fused_spectral_repr(x, 512, 128, "if", window=torch.ones(512))
    pk.fused_repr_stats(x, 512, 128, "if", window=torch.ones(512))
    assert not any(pk.routes.values()) and not any(pk.launches.values())


def test_int16_input_on_the_fft_route_is_bit_identical_to_converted_float(audio):
    x16 = torch.round(torch.as_tensor(audio) * 32767).to(torch.int16)
    w = torch.as_tensor(np.array(jgauss(512)))
    a = pk.fused_spectral_repr(x16, 512, 128, "if", window=w)
    b = pk.fused_spectral_repr(x16.to(torch.float32) * 2.0 ** -15, 512, 128, "if", window=w)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
