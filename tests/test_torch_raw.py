"""The raw-domain transforms of the port (``transforms/raw.py``: Mono's
leftovers, Stereo, MidSide, Window, MuLaw; ``ops/mulaw.py``) against the JAX
package on the same numpy inputs.

Tolerances, and why:

* Stereo, MidSide, Window, Mono: bit-identical forward and invert (the same
  float32 operations in the same order; a shape transform moves values
  without arithmetic);
* MuLaw codes: equal, except flips of +-1 on at most 1e-4 of the samples (a
  sample at a rounding boundary of the code, where the two ``log1p`` may
  differ by an ulp); the decode of equal codes within 1e-6 (``pow`` of the
  two libraries); the one-hot modes are the one-hot of those codes, int32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops import mulaw as jmu
from acids_transforms_tpu_torch.ops import mulaw as pmu
from test_torch_common import make_audio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def audio():
    return make_audio(41, batch=2, n=6000)           # (2, 2, 6000), peak 0.5


def both(x):
    return jnp.asarray(x), torch.as_tensor(x)


def same(a, b):
    a, b = np.asarray(a), b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def layouts(audio):
    """Stereo (B, 2, L), mono with a channel axis (B, 1, L), 1-D (L,)."""
    return {"stereo": audio, "one_channel": audio[:, :1].copy(), "flat": audio[0, 0].copy()}


@pytest.mark.parametrize("layout", ["stereo", "one_channel", "flat"])
@pytest.mark.parametrize("normalize", [False, True])
def test_stereo_and_midside_bit_identical(audio, layout, normalize):
    x = layouts(audio)[layout]
    if normalize:
        x = x - 0.6 * np.abs(x).max()     # the signed max is not the peak: the quirk shows
    jx, px = both(x)
    for jt, pt in ((JT.Stereo(normalize=normalize), PT.Stereo(normalize=normalize, device="cpu")),
                   (JT.MidSide(normalize=normalize), PT.MidSide(normalize=normalize, device="cpu")),
                   (JT.MidSide(pad_mid=False), PT.MidSide(pad_mid=False, device="cpu"))):
        yj, yp = jt.forward(jx), pt.forward(px)
        same(yj, yp)
        same(jt.invert(yj), pt.invert(yp))


def test_midside_roundtrip_and_signed_max_quirk(audio):
    x = torch.as_tensor(audio)
    ms = PT.MidSide(device="cpu")
    back = ms.invert(ms.forward(x))
    snr = 10 * np.log10((x ** 2).sum().item() / ((back - x) ** 2).sum().item())
    assert snr > 120.0
    neg = -torch.abs(x) - 0.1                          # every sample negative: the signed max is negative
    y = PT.Stereo(normalize=True, device="cpu").forward(neg)
    assert (y > 0).all()
    with pytest.raises(ValueError, match="1 or 2 channels"):
        ms.forward(torch.zeros(1, 3, 10))
    with pytest.raises(ValueError, match="1/2 channels"):
        PT.Stereo(device="cpu").forward(torch.zeros(1, 3, 10))


def test_stereo_invert_of_more_channels(audio):
    x = np.concatenate([audio, audio[:, :1]], axis=1)   # (B, 3, L)
    jx, px = both(x)
    same(JT.Stereo().invert(jx), PT.Stereo(device="cpu").invert(px))


@pytest.mark.parametrize("window_size,hop", [(256, 64), (256, 256), (300, 128)])
@pytest.mark.parametrize("dim", [-1, -2, 1])
def test_window_forward_invert_bit_identical(audio, window_size, hop, dim):
    x = audio if dim != -2 else np.swapaxes(audio, -1, -2).copy()   # dim -2: (B, L, C)
    jx, px = both(x)
    jw = JT.Window(window_size=window_size, hop_size=hop, dim=dim)
    pw = PT.Window(window_size=window_size, hop_size=hop, dim=dim, device="cpu")
    yj, yp = jw.forward(jx), pw.forward(px)
    same(yj, yp)
    same(jw.invert(yj), pw.invert(yp))
    assert pw.ratio == hop and pw.output_frame_axis(None) == jw.output_frame_axis(None)


def test_window_exact_where_hop_equals_the_window(audio):
    x = torch.as_tensor(audio[:, :, :4096].copy())
    w = PT.Window(window_size=256, hop_size=256, device="cpu")
    assert torch.equal(w.invert(w.forward(x)), x)
    w = PT.Window(window_size=256, hop_size=64, device="cpu")
    back = w.invert(w.forward(x))
    assert torch.equal(back, x[..., : back.shape[-1]])     # crop: exact up to the last frame


def test_window_refusals_and_time_and_mask(audio):
    with pytest.raises(ValueError, match="batch_dim"):
        PT.Window(batch_dim=1, device="cpu")
    with pytest.raises(ValueError, match="window_size"):
        PT.Window(window_size=64, hop_size=128, device="cpu")
    jx, px = both(audio[:, 0].copy())
    t = np.array([0.5, 1.25], np.float32)
    jw, pw = JT.Window(window_size=256, hop_size=64), PT.Window(window_size=256, hop_size=64, device="cpu")
    (yj, tj), (yp, tp) = jw.forward_with_time(jx, jnp.asarray(t)), pw.forward_with_time(px, torch.as_tensor(t))
    same(yj, yp)
    same(tj, tp)
    mask = (np.arange(audio.shape[-1]) < 4000)[None, :].repeat(2, 0).astype(np.float32)
    same(jw.propagate_mask(jnp.asarray(mask), jx), pw.propagate_mask(torch.as_tensor(mask), px))
    assert PT.Window(dim=1, device="cpu").propagate_mask(torch.as_tensor(mask), px) is None


@pytest.mark.parametrize("channels", [256, 16])
def test_mulaw_codes_and_decode_vs_jax(audio, channels):
    # the whole range, the clips, and values on the codes' rounding boundaries
    mu = channels - 1.0
    ramp = np.linspace(-1.0, 1.0, 20001, dtype=np.float32)
    edges = np.arange(channels, dtype=np.float64) + 0.5
    fx = 2.0 * edges / mu - 1.0
    boundary = (np.sign(fx) * np.expm1(np.abs(fx) * np.log1p(mu)) / mu).astype(np.float32)
    x = np.concatenate([audio.reshape(-1), ramp, boundary[np.abs(boundary) <= 1]])
    jx, px = both(x)
    cj, cp = np.asarray(jmu.mulaw_encode(jx, channels)), pmu.mulaw_encode(px, channels)
    assert cp.dtype == torch.int32 and cj.dtype == np.int32
    d = cp.numpy() - cj
    assert np.abs(d).max() <= 1 and (d != 0).mean() <= 1e-4, ((d != 0).sum(), x.size)
    assert cp.min() >= 0 and cp.max() < channels
    codes = np.array(cj)
    dj = np.asarray(jmu.mulaw_decode(jnp.asarray(codes), channels))
    dp = pmu.mulaw_decode(torch.as_tensor(codes), channels).numpy()
    assert dp.dtype == np.float32 and np.abs(dp - dj).max() <= 1e-6


def test_mulaw_truncates_toward_zero_as_astype():
    """The cast of the codes truncates, as the JAX package's astype does."""
    x = torch.tensor([-1.0, -0.9999, 0.0, 0.9999, 1.0])
    codes = pmu.mulaw_encode(x)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jmu.mulaw_encode(jnp.asarray(x.numpy()))))
    assert codes.tolist()[0] == 0 and codes.tolist()[-1] == 255


@pytest.mark.parametrize("one_hot", ["none", "categorical", "channel"])
def test_mulaw_modes_vs_jax(audio, one_hot):
    jx, px = both(audio)
    jm, pm = JT.MuLaw(one_hot=one_hot), PT.MuLaw(one_hot=one_hot, device="cpu")
    yj, yp = jm.forward(jx), pm.forward(px)
    assert yp.dtype == torch.int32
    same(yj, yp)
    rj, rp = jm.invert(yj), pm.invert(yp)
    assert np.abs(np.asarray(rj) - rp.numpy()).max() <= 1e-6
    snr = 10 * np.log10((audio ** 2).sum() / ((rp.numpy() - audio) ** 2).sum())
    assert snr > 25.0
    mask = torch.ones(audio.shape[-1])
    assert (pm.propagate_mask(mask, px) is mask) == (one_hot == "none")


def test_mulaw_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="one_hot"):
        PT.MuLaw(one_hot="binary", device="cpu")


def test_mono_leftovers(audio):
    jx, px = both(audio)
    t = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    for squeeze in (True, False):
        jm, pm = JT.Mono(squeeze=squeeze), PT.Mono(squeeze=squeeze, device="cpu")
        (yj, tj), (yp, tp) = jm.forward_with_time(jx, jnp.asarray(t)), pm.forward_with_time(px, torch.as_tensor(t))
        same(yj, yp)
        same(tj, tp)
        oj, op = jm.test_inversion(jx), pm.test_inversion(px)
        assert sorted(oj) == sorted(op) == ["mono", "stereo"]
        for k in oj:
            same(oj[k], op[k])
