"""The plain PyTorch versions of kernels G and H (``fused_spectral_repr``,
``fused_repr_stats``) against the JAX package's Pallas kernels in interpret
mode, from the same numpy audio: channels ``phase``, ``if`` and ``imag``,
through the factored front end (hann) and the full-K one (the DGT's
gaussian).

On the CPU the wrappers return exactly these plain versions; the CUDA
kernels are held against them on the card by ``chip_smoke.py``.

Tolerances: channel 1 (|X| through the mel bank and log1p, or Re) 1e-4
relative, the JAX kernel's budget for its bf16x3 products.  Channel 2 is
compared on the circle (distance mod 2 pi) where it is an angle; the IF is
first taken back to the phase differences it is made of (row 0: the angle),
so that a difference that lands on the other side of +-pi in the two
packages is no error.  The JAX kernel's spectrum is about 3e-6 of the
clip's largest magnitude off (bf16x3), which turns a bin's angle by that over
the bin's own magnitude: so the angle error weighted by |X| / max|X| is held
to 1e-5, and at bins above 1e-3 of the largest magnitude the unweighted one
to 1e-2 rad (measured: 3e-6 and 2.3e-3).  Frame 0 has a special case: with a
centred frame and a symmetric window its spectrum is exactly real, so its
angles are 0 or pi decided by rounding, and statistics of channel 2 can
differ by 2 pi per such bin; they are held to the elementwise differences of
the two packages' channels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.mel import square_mel_banks
from acids_transforms_tpu.ops.pallas import spectral as jk
from acids_transforms_tpu.ops.windows import gaussian_dgt_window as jgauss
from acids_transforms_tpu.ops.windows import get_window as jwin
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.ops.cuda.frames_fft import fft_covers, taps_window
from test_torch_common import HOP, N_FFT, make_audio, t2n

AFF = (0.1, 1.3, -0.2, 0.9)


def front(name):
    """(window, taps) of the factored (hann) or full-K (gaussian) front end."""
    if name == "hann":
        w = np.array(jwin("hann", N_FFT))
        return w, jfft.taps_for_window(w)
    return np.array(jgauss(N_FFT)), None


@pytest.fixture(scope="module")
def audio():
    return make_audio(41, batch=2, n=5000)[:, 0].copy()


def magnitude_weights(x, w, second="phase", center=True):
    """|X| / max|X| per clip; for the IF, of the quieter of the two frames a
    row's phase difference is taken from."""
    spec = np.asarray(jfft.stft(jnp.asarray(x), N_FFT, HOP, jnp.asarray(w), center=center))
    m = np.abs(spec)
    m = m / m.max(axis=(-2, -1), keepdims=True)
    if second == "if":
        m[:, 1:] = np.minimum(m[:, 1:], m[:, :-1])
    return m


def run_both(x, second, wname, mel=True, aff=AFF, **kw):
    w, taps = front(wname)
    bank = square_mel_banks(N_FFT, 44100)[0] if second != "imag" and mel else None
    jkw = dict(kw)
    jy = jk.fused_spectral_repr(
        jnp.asarray(x), N_FFT, HOP, jnp.asarray(w), second,
        mel_bank=None if bank is None else jnp.asarray(bank), aff=aff, interpret=True,
        taps=taps, **jkw,
    )
    kw.pop("tile_t", None)
    py = pk.fused_spectral_repr(
        torch.as_tensor(x), N_FFT, HOP, second,
        mel_bank=None if bank is None else torch.as_tensor(bank), aff=aff, taps=taps,
        window=torch.as_tensor(w), **kw,
    )
    return [np.asarray(a) for a in jy], [t2n(a) for a in py], w


def angle_error(second, j2, p2, weighted=False, scale=AFF[3]):
    """Channel-2 difference as an angle on the circle: the phase, or the
    phase differences the IF is made of (rows over pi, the last row not,
    times the parabolic window; the window's zero last row is left out)."""
    d = (p2.astype(np.float64) - j2) * scale
    if second == "if":
        T = d.shape[1]
        c = np.full(T, 2.0 * np.pi)            # IF units -> radians of difference
        c[0], c[-1] = np.pi, 2.0
        if weighted:
            n = np.arange(T)
            g = 1.5 * T / (T * T - 1.0) * (1 - ((n - (T / 2 - 1)) / (T / 2)) ** 2)
            c = np.where(g > 0, c / np.where(g > 0, g, 1.0), 0.0)
        d = d * c[None, :, None]
    return np.abs(np.angle(np.exp(1j * d)))


@pytest.mark.parametrize("wname", ["hann", "gaussian"])
@pytest.mark.parametrize("second", ["phase", "if", "imag"])
def test_plain_g_vs_pallas_kernel(audio, second, wname):
    weighted = second == "if"
    # the IF is compared before its affine: an offset there would put the
    # float32 resolution of the output, divided by the parabolic window's
    # small values at the clip's ends, above the angle's own error
    aff = (0.0, 1.3, 0.0, 1.0) if second == "if" else AFF
    (j1, j2), (p1, p2), w = run_both(audio, second, wname, aff=aff, weighted=weighted)
    assert p1.shape == j1.shape and p2.shape == j2.shape
    assert np.abs(p1 - j1).max() / np.abs(j1).max() <= 1e-4
    if second == "imag":
        assert np.abs(p2 - j2).max() / np.abs(j2).max() <= 1e-4
        return
    wt = magnitude_weights(audio, w, second)
    err = angle_error(second, j2, p2, weighted, scale=aff[3])
    assert (err * wt).max() <= 1e-5
    assert err[wt > 1e-3].max() <= 1e-2


def test_if_carry_across_many_tiles(audio):
    """The JAX kernel carries the previous tile's last phase row across its
    sequential grid; with 8-frame tiles a 40-frame clip crosses 4 tile
    boundaries.  The plain version (and the CUDA kernel, which recomputes a
    halo frame) must agree on every row."""
    (j1, j2), (p1, p2), w = run_both(audio, "if", "gaussian", tile_t=8)
    assert j2.shape[1] > 4 * 8
    err = angle_error("if", j2, p2)
    wt = magnitude_weights(audio, w, "if")
    assert (err * wt).max() <= 1e-5 and err[wt > 1e-3].max() <= 1e-2


@pytest.mark.parametrize("wname", ["hann", "gaussian"])
@pytest.mark.parametrize("second", ["phase", "if", "imag"])
def test_plain_h_vs_pallas_kernel(audio, second, wname):
    w, taps = front(wname)
    kw = dict(weighted=second == "if", center=False)
    sj = jk.fused_repr_stats(jnp.asarray(audio), N_FFT, HOP, jnp.asarray(w), second,
                             interpret=True, taps=taps, **kw)
    sp = pk.fused_repr_stats(torch.as_tensor(audio), N_FFT, HOP, second, taps=taps,
                             window=torch.as_tensor(w), **kw)
    assert sp["count"] == sj["count"] and isinstance(sp["count"], int)
    # the channels the statistics are taken on (channel 1 without mel); with
    # taps at a power of two H takes the FFT route under the taps' own window,
    # whose channels are the full-K ones under that window
    aff0 = dict(aff=(0.0, 1.0, 0.0, 1.0), taps=taps, **kw)
    jy = [np.asarray(a, np.float64) for a in jk.fused_spectral_repr(
        jnp.asarray(audio), N_FFT, HOP, jnp.asarray(w), second, interpret=True, **aff0)]
    pw = torch.as_tensor(w)
    if taps is not None and fft_covers(N_FFT):
        aff0["taps"], pw = None, torch.as_tensor(taps_window(taps, N_FFT))
    py = [a.double() for a in pk.fused_spectral_repr(
        torch.as_tensor(audio), N_FFT, HOP, second, window=pw, **aff0)]
    n = sp["count"]
    for ch, pv, jv in (("ch1", py[0], jy[0]), ("ch2", py[1], jy[1])):
        # the plain statistics are those of the plain channels (the same
        # float32 values, summed in float64)
        assert abs(float(sp[ch]["sum"]) - pv.sum().item()) <= 1e-12 * n * pv.abs().max().item()
        assert float(sp[ch]["min"]) == pv.min().item() and float(sp[ch]["max"]) == pv.max().item()
        # against the JAX kernel: the statistics differ by no more than the
        # two packages' channels do elementwise (a quiet bin's angle is only
        # as good as its magnitude, and a 0-or-pi bin may flip by 2 pi) plus
        # the JAX kernel's own float32 sums (1e-6 of the sum of |values|);
        # channel 1's extrema within 1e-4 of its range
        pv = pv.numpy()
        slack = 1e-6 * np.abs(jv).sum()
        assert abs(float(sp[ch]["sum"]) - float(sj[ch]["sum"])) <= np.abs(pv - jv).sum() + slack
        assert abs(float(sp[ch]["sumsq"]) - float(sj[ch]["sumsq"])) <= np.abs(pv * pv - jv * jv).sum() + 1e-6 * (jv * jv).sum()
        tol = 1e-4 * np.abs(jv).max()
        if ch == "ch2" and second != "imag":
            tol = max(tol, np.abs(pv - jv).max())
        for k in ("min", "max"):
            assert abs(float(sp[ch][k]) - float(sj[ch][k])) <= tol


def test_rows_carry_one_leading_zero_chunk():
    x = torch.as_tensor(make_audio(42, batch=2, n=3000)[:, 0].copy())
    rows, T, n_tiles = pk._prepare_rows(x, N_FFT, HOP, True, 8)
    lead, T2, n2 = pk._prepare_rows(x, N_FFT, HOP, True, 8, lead=1)
    assert (T2, n2) == (T, n_tiles) and lead.shape[1] == rows.shape[1] + 1
    assert not lead[:, 0].abs().max().item() and torch.equal(lead[:, 1:], rows)
    x16 = torch.round(x * 32767).to(torch.int16)
    r16, _, _ = pk._prepare_rows(x16, N_FFT, HOP, True, 8, lead=1)
    assert r16.dtype == torch.int16


def test_int16_input_is_bit_identical_to_converted_float():
    x16 = torch.round(torch.as_tensor(make_audio(43, batch=2, n=3000)[:, 0].copy()) * 32767).to(torch.int16)
    w, taps = front("hann")
    a = pk.fused_spectral_repr(x16, N_FFT, HOP, "if", taps=taps)
    b = pk.fused_spectral_repr(x16.to(torch.float32) * 2.0 ** -15, N_FFT, HOP, "if", taps=taps)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_tiles_and_refusals():
    picks = {(1024, 256): 32, (1024, 128): 32, (512, 64): 32, (2048, 512): 16,
             (4096, 1024): 8, (8192, 2048): None}
    for (n_fft, hop), tile in picks.items():
        assert pk._pick_repr_tile(hop, n_fft // hop, n_fft // 2 + 1) == tile
        if tile is not None:
            assert pk._repr_smem_bytes(tile, hop, n_fft // hop, n_fft // 2 + 1, False) <= pk.MAX_SMEM
            assert tile + n_fft // hop <= 40
    w = jwin("hann", 8192)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pk._repr_kernel_tile(8192, 2048, jfft.taps_for_window(np.array(w)))
    with pytest.raises(ValueError, match="overlap"):
        pk._repr_kernel_tile(512, 32, (0.5, -0.25))
    with pytest.raises(ValueError, match="second"):
        pk.fused_spectral_repr(torch.zeros(1, 3000), N_FFT, HOP, "angle", taps=(0.5, -0.25))
    with pytest.raises(ValueError, match="log"):
        pk.fused_repr_stats(torch.zeros(1, 3000), N_FFT, HOP, "phase", contrast="log", taps=(0.5, -0.25))
    # the wrappers count launches on the card only
    assert all(v == 0 for v in pk.launches.values())
