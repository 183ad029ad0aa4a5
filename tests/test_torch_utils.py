"""The port's utility layer (``acids_transforms_tpu_torch/utils``: audio IO,
numerical guards, profiling) against the JAX package's ``utils`` on the
same files, written from a seed.

Tolerances: the numpy IO and resampler are the JAX package's own code, so
bit-identical; ``import_data`` loads through the native layer and is
bit-identical to the JAX package's loader wherever no resample runs, and its
resampler within 1e-4 of the numpy one (the rule of
``tests/test_utils.py:103-118``).
"""
import json

import numpy as np
import pytest
import torch

import acids_transforms_tpu.utils as JU
from acids_transforms_tpu.utils import misc as jmisc
from acids_transforms_tpu_torch import utils as PU
from acids_transforms_tpu_torch.utils import misc as pmisc

RNG = np.random.default_rng(29)


def _audio(*shape):
    return (0.5 * RNG.standard_normal(shape)).astype(np.float32)


def test_public_surface_is_the_jax_packages():
    assert set(PU.__all__) == set(JU.__all__)
    assert set(pmisc.__all__) == set(jmisc.__all__)


@pytest.mark.parametrize("pcm16", [False, True], ids=["float32", "pcm16"])
def test_wav_roundtrip_bit_identical(tmp_path, pcm16):
    x = _audio(2, 20000)
    pp, jp = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
    pmisc.save_wav(pp, x, 22050, pcm16=pcm16)
    jmisc.save_wav(jp, x, 22050, pcm16=pcm16)
    with open(pp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    yp, srp = pmisc.load_wav(pp)
    yj, srj = jmisc.load_wav(pp)
    assert srp == srj == 22050 and yp.dtype == np.float32
    np.testing.assert_array_equal(yp, yj)
    if pcm16:
        ip, _ = pmisc.load_wav_pcm(pp)
        ij, _ = jmisc.load_wav_pcm(pp)
        assert ip.dtype == np.int16
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(ip.astype(np.float32) / 32768.0, yp)
    else:
        np.testing.assert_array_equal(yp, x)
        with pytest.raises(ValueError, match="16-bit PCM"):
            pmisc.load_wav_pcm(pp)


@pytest.mark.parametrize("rates", [(44100, 22050), (22050, 44100), (44100, 16000)])
def test_resample_bit_identical(rates):
    x = _audio(2, 6000)
    np.testing.assert_array_equal(pmisc.resample(x, *rates), jmisc.resample(x, *rates))
    np.testing.assert_array_equal(pmisc.resample(x[0], *rates), jmisc.resample(x[0], *rates))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A directory of WAVs: mono and stereo, float32 and pcm16, three
    lengths, one at another rate, and a file that is no WAV."""
    d = tmp_path_factory.mktemp("corpus")
    jmisc.save_wav(str(d / "a.wav"), _audio(1, 9000), 44100)
    jmisc.save_wav(str(d / "b.wav"), _audio(2, 12000), 44100, pcm16=True)
    jmisc.save_wav(str(d / "c.wav"), _audio(7000), 44100, pcm16=True)
    (d / "notes.txt").write_text("not audio")
    r = tmp_path_factory.mktemp("rates")
    jmisc.save_wav(str(r / "low.wav"), _audio(1, 11025), 22050)
    jmisc.save_wav(str(r / "low16.wav"), _audio(1, 4000), 22050, pcm16=True)
    return d, r


def test_import_data_directory_and_mask(corpus):
    d, _ = corpus
    xp, names_p, mask_p = pmisc.import_data(str(d), sr=44100, return_mask=True)
    xj, names_j, mask_j = jmisc.import_data(str(d), sr=44100, return_mask=True)
    assert names_p == names_j == ["a", "b", "c"]
    assert xp.shape == (3, 2, 12000) and xp.dtype == np.float32
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(mask_p, mask_j)
    assert mask_p.shape == (3, 1, 12000) and mask_p[0, 0, 8999] == 1 and mask_p[0, 0, 9000] == 0


def test_import_data_single_file_and_pcm(corpus):
    d, _ = corpus
    for f in ("a.wav", "b.wav"):
        xp, name, mask = pmisc.import_data(str(d / f), sr=44100, return_mask=True)
        xj, _ = jmisc.import_data(str(d / f), sr=44100)
        assert name == f and mask.shape == (1, xp.shape[1])
        np.testing.assert_array_equal(xp, xj)
    ip, names = pmisc.import_data(str(d), sr=44100, pcm=True)
    ij, _ = jmisc.import_data(str(d), sr=44100, pcm=True)
    assert ip.dtype == np.int16 and names == ["b", "c"]     # a.wav is float: skipped as in JAX
    np.testing.assert_array_equal(ip, ij)
    with pytest.raises(FileNotFoundError):
        pmisc.import_data(str(d / "missing.wav"))


def test_import_data_resamples_with_the_native_layer(corpus):
    _, r = corpus
    xp, _ = pmisc.import_data(str(r / "low.wav"), sr=44100)
    x, sr = jmisc.load_wav(str(r / "low.wav"))
    ref = jmisc.resample(x, sr, 44100)
    assert xp.shape == ref.shape == (1, 22050)
    assert np.abs(xp - ref).max() < 1e-4
    with pytest.raises(ValueError, match="resampling"):
        pmisc.import_data(str(r / "low16.wav"), sr=44100, pcm=True)


def test_checked_names_the_operator():
    fn = PU.checked(lambda x: torch.log(x - 2.0) * 3.0)
    with pytest.raises(FloatingPointError, match="aten.log"):
        fn(torch.ones(4))
    assert torch.equal(fn(torch.full((4,), 3.0)), torch.zeros(4))
    with pytest.raises(FloatingPointError, match="aten.div"):
        PU.checked(lambda x: x / 0.0)(torch.ones(2))
    # allocations are not results: an empty tensor filled later passes
    assert PU.checked(lambda x: torch.empty_like(x).copy_(x))(torch.ones(3)).sum() == 3
    with pytest.raises(FloatingPointError, match="spec contains NaN/Inf"):
        PU.assert_finite(torch.tensor([1.0, float("nan")]), "spec")
    assert PU.assert_finite(torch.ones(2)).sum() == 2


def test_checked_passes_a_finite_chain():
    from acids_transforms_tpu_torch import transforms as T

    chain = T.STFT(n_fft=256, hop_length=64, device="cpu") + T.Magnitude(n_fft=256, device="cpu")
    x = torch.as_tensor(_audio(2, 4096))
    y = PU.checked(chain.forward)(x)
    assert torch.equal(y, chain.forward(x))


def test_trace_holds_the_annotations(tmp_path):
    x = torch.as_tensor(_audio(2, 4096))
    with PU.trace(str(tmp_path)) as prof:
        with PU.annotate("att_stage_stft"):
            torch.stft(x, 256, 64, window=torch.hann_window(256), return_complex=True).abs()
        with PU.annotate("att_stage_sum"):
            x.sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"att_stage_stft", "att_stage_sum"} <= names
    assert any(e.key == "att_stage_stft" for e in prof.key_averages())


def test_device_timeit_positive():
    x = torch.as_tensor(_audio(2, 4096))
    t = PU.device_timeit(lambda v: (v * 2).sum(), x, iters=3, repeats=2)
    assert 0 < t < 1.0

