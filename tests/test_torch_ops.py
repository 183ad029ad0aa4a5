"""Port ops against the JAX ops and against ``torch.stft`` / ``torch.istft``
on the same numpy inputs (CPU, float32).  Tolerances are max-abs over max-abs;
1e-5 covers float32 GEMM summation order (the JAX side runs its DFT GEMMs at
``Precision.HIGH``, itself ~1e-5 accurate; those comparisons say so)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops import framing as jframing
from acids_transforms_tpu.ops import mel as jmel
from acids_transforms_tpu.ops import windows as jwin
from acids_transforms_tpu_torch.ops import fft as pfft
from acids_transforms_tpu_torch.ops import framing as pframing
from acids_transforms_tpu_torch.ops import mel as pmel
from acids_transforms_tpu_torch.ops import windows as pwin
from test_torch_common import HOP, N_FFT, make_audio, rel, t2n

WINDOWS = ["hann", "hamming", "blackman"]


@pytest.mark.parametrize("name", WINDOWS)
@pytest.mark.parametrize("n", [512, 384])
def test_windows_equal_jax_and_torch(name, n):
    w = t2n(pwin.get_window(name, n))
    assert np.array_equal(w, np.asarray(jwin.get_window(name, n)))
    ref = getattr(torch, name + "_window")(n, periodic=True, dtype=torch.float64).numpy()
    assert np.abs(w - ref).max() <= 1e-7


def test_dual_window_and_envelope_equal_jax():
    w = np.asarray(jwin.get_window("hann", N_FFT))
    assert np.array_equal(pwin.window_envelope(w, HOP), jwin.window_envelope(w, HOP))
    assert np.array_equal(t2n(pwin.dual_window(w, HOP)), np.asarray(jwin.dual_window(w, HOP)))


def test_unported_window_raises_not_implemented():
    # no named window is left unported: kaiser and bartlett resolve, and the
    # gaussian is the DGT's own (no name in either package)
    assert not hasattr(pwin, "_UNPORTED")
    for name in ("kaiser", "bartlett"):
        assert pwin.get_window(name, 512).shape == (512,)
    for name in ("nonsense", "gaussian"):
        with pytest.raises(ValueError):
            pwin.get_window(name, 512)
        with pytest.raises(ValueError):
            jwin.get_window(name, 512)


@pytest.mark.parametrize("keep_nyquist", [True, False])
@pytest.mark.parametrize("inverse", ["transpose", "pinv"])
def test_square_mel_banks_equal_jax(keep_nyquist, inverse):
    a = pmel.square_mel_banks(N_FFT, 44100, keep_nyquist=keep_nyquist, inverse=inverse)
    b = jmel.square_mel_banks(N_FFT, 44100, keep_nyquist=keep_nyquist, inverse=inverse)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert np.array_equal(
        pmel.melscale_fbanks(257, 0.0, 8000.0, 40, 16000),
        jmel.melscale_fbanks(257, 0.0, 8000.0, 40, 16000),
    )


@pytest.mark.parametrize("wsize,hsize", [(512, 128), (400, 160), (256, 256)])
def test_frame_and_overlap_add_equal_jax(wsize, hsize):
    x = make_audio(1, batch=2, n=3000)[:, 0]
    fp = pframing.frame(torch.as_tensor(x), wsize, hsize)
    fj = np.asarray(jframing.frame(jnp.asarray(x), wsize, hsize))
    assert fp.shape == fj.shape and np.array_equal(t2n(fp), fj)
    op = pframing.overlap_add(fp, hsize)
    oj = np.asarray(jframing.overlap_add(jnp.asarray(fj), hsize))
    assert op.shape == oj.shape and rel(t2n(op), oj) <= 1e-6
    assert pframing.num_frames(3000, wsize, hsize) == jframing.num_frames(3000, wsize, hsize)
    padded = pframing.pad_axis(torch.as_tensor(x), 3100, -1)
    assert padded.shape[-1] == 3100 and float(padded[..., 3000:].abs().max()) == 0.0


@pytest.mark.parametrize("name", WINDOWS)
def test_taps_equal_jax(name):
    w = np.asarray(jwin.get_window(name, N_FFT))
    assert pfft.taps_for_window(w) == jfft.taps_for_window(w)
    assert len(pfft.taps_for_window(w)) == (3 if name == "blackman" else 2)
    assert pfft.taps_for_window(np.bartlett(N_FFT)) is None


def test_tables_equal_jax():
    for a, b in zip(pfft._chunk_dft_matrices(N_FFT, HOP), jfft._chunk_dft_matrices(N_FFT, HOP)):
        assert np.array_equal(a, b)
    for a, b in zip(pfft._twiddles(N_FFT, HOP), jfft._twiddles(N_FFT, HOP)):
        assert np.array_equal(a, b)
    for a, b in zip(pfft._dft_matrices(N_FFT), jfft._dft_matrices(N_FFT)):
        assert np.array_equal(a, b)
    for a, b in zip(pfft._idft_matrices(N_FFT), jfft._idft_matrices(N_FFT)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", WINDOWS)
@pytest.mark.parametrize("impl", ["matmul", "fft", "factored"])
def test_stft_vs_torch_stft_and_jax(name, impl):
    x = make_audio(2, batch=2, n=6000)[:, 0]
    w = pwin.get_window(name, N_FFT)
    taps = pfft.taps_for_window(w)
    got = t2n(pfft.stft(torch.as_tensor(x), N_FFT, HOP, w, impl=impl, taps=taps))
    ref = torch.stft(
        torch.as_tensor(x), N_FFT, HOP, window=w, center=True, pad_mode="reflect",
        return_complex=True,
    ).transpose(-2, -1).numpy()
    assert got.shape == ref.shape == (2, 1 + 6000 // HOP, N_FFT // 2 + 1)
    assert rel(got, ref) <= 1e-5
    jax_out = np.asarray(
        jfft.stft(jnp.asarray(x), N_FFT, HOP, jnp.asarray(t2n(w)), impl=impl, taps=taps)
    )
    # the JAX GEMM paths run at Precision.HIGH (bf16x3): ~1e-5 of their own
    assert rel(got, jax_out) <= (1e-5 if impl == "fft" else 5e-5)


@pytest.mark.parametrize("name", WINDOWS)
@pytest.mark.parametrize("impl", ["matmul", "fft", "factored"])
def test_istft_vs_torch_istft_and_roundtrip(name, impl):
    x = make_audio(3, batch=2, n=6016)[:, 0]
    w = pwin.get_window(name, N_FFT)
    taps = pfft.taps_for_window(w)
    spec = pfft.stft(torch.as_tensor(x), N_FFT, HOP, w)
    got = t2n(pfft.istft(spec, N_FFT, HOP, w, impl=impl, taps=taps))
    ref = torch.istft(spec.transpose(-2, -1), N_FFT, HOP, window=w).numpy()
    assert got.shape == ref.shape
    assert rel(got, ref) <= 1e-5
    assert rel(got, x[..., : got.shape[-1]]) <= 1e-4  # the roundtrip budget
    jax_out = np.asarray(
        jfft.istft(jnp.asarray(t2n(spec)), N_FFT, HOP, jnp.asarray(t2n(w)), impl=impl, taps=taps)
    )
    assert rel(got, jax_out) <= (1e-5 if impl == "fft" else 5e-5)


def test_istft_length_and_short_clip_padding():
    w = pwin.get_window("hann", N_FFT)
    x = torch.as_tensor(make_audio(4, batch=1, n=200)[:, 0])  # shorter than n_fft // 2
    spec = pfft.stft(x, N_FFT, HOP, w)
    assert spec.shape == (1, 2, N_FFT // 2 + 1)
    jax_spec = np.asarray(jfft.stft(jnp.asarray(t2n(x)), N_FFT, HOP, jnp.asarray(t2n(w))))
    assert rel(t2n(spec), jax_spec) <= 5e-5
    y = pfft.istft(spec, N_FFT, HOP, w, length=300)
    assert y.shape == (1, 300)


def test_unported_impl_and_bad_args_raise():
    w = pwin.get_window("hann", N_FFT)
    x = torch.zeros(1, 2000)
    # the radix-2 split is ported: it runs, and an impl no package has raises
    assert pfft.stft(x, N_FFT, HOP, w, impl="matmul2").shape == pfft.stft(x, N_FFT, HOP, w).shape
    with pytest.raises(ValueError, match="unknown fft impl"):
        pfft.stft(x, N_FFT, HOP, w, impl="radix3")
    with pytest.raises(ValueError):
        pfft.stft(x, N_FFT, HOP, w, impl="factored", taps=None)
    with pytest.raises(ValueError):
        pfft.stft(x, N_FFT, 100, w, impl="factored", taps=(0.5, -0.25))


def test_matmul_runs_in_full_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
