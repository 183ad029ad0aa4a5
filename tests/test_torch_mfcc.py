"""BASELINE config 3: ``MFCC`` (``transforms/mel.py``, the rectangular bank of
``ops/mel.py:mel_banks``) and its fused forward (``fuse.py``'s MFCC pattern:
kernel A, ``fused_melspec`` with MFCC's hann taps, the bank, offset 0, scale
1, no contrast, ``power``; float32 out, then the transpose, the norm and the
cast), against the JAX package on the same numpy inputs.  On a CPU tensor
``fused_melspec`` runs A's plain version; ``chip_smoke.py`` phase 4i holds A
to it on the card.

Tolerances, and why:

* ``mel_banks``: equal (the same float64 numpy, rounded once);
* ``MFCC.forward`` eager: within 1e-5 of the JAX forward's largest value
  (float32 GEMM DFTs summed in another order), power 1 and 2, every norm
  mode; with ``n_mfcc`` (log, then the DCT) within 1e-4 of it and of a
  float64 oracle: the logarithm turns the DFT's absolute error at quiet mel
  bands into a relative one (power 1 at 1024/256 reads 4.6e-5 against the
  JAX forward, 4.3e-5 against the oracle, where the JAX forward reads 3.2e-6:
  torch's float32 CPU product sums less accurately than XLA's there);
  ``forward_with_time`` and ``propagate_mask`` equal;
* the fused forward on the CPU (A's plain version, the FFT route's schedule)
  within 1e-4 of the largest value of the JAX ``_fused_mfcc`` on the Pallas
  backend in interpret mode (bf16x3 products: the JAX kernel's own budget),
  and within 1e-5 of the eager chain; mel 0 of ``mel_banks(1024, 44100,
  128)`` is an empty filter, exactly 0 on both paths; the bf16 output is the
  cast of the float32 one, int16 PCM bit-identical to the pre-converted
  float;
* the gradient through the fused forward within 1e-4 of the eager chain's
  (relative to the largest entry);
* a JAX chain's fitted state carried by ``convert.load_jax_state``: the
  outputs within 1e-5 as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch as patt
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu import fuse as jfuse
from acids_transforms_tpu.ops.mel import mel_banks as j_mel_banks
from acids_transforms_tpu_torch import fuse as pfuse
from acids_transforms_tpu_torch.convert import load_jax_state, state_from_leaves
from acids_transforms_tpu_torch.ops.cuda import spectral as sk
from acids_transforms_tpu_torch.ops.mel import mel_banks as p_mel_banks
from test_torch_common import make_audio, rel, t2n

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def audio():
    return make_audio(47, batch=2, n=8000)           # (2, 2, 8000): 0.18 s


@pytest.mark.parametrize("args", [(1024, 44100, 128), (256, 22050, 32), (512, 16000, 40, 50.0, 7000.0)])
def test_mel_banks_vs_jax(args):
    a, b = j_mel_banks(*args), p_mel_banks(*args)
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_array_equal(a, b)


def test_mel_zero_is_an_empty_filter():
    bank = p_mel_banks(1024, 44100, 128)
    assert not bank[:, 0].any() and bank[:, 1:].any(axis=0).all()
    lo, hi = sk._mel_band(torch.as_tensor(bank))
    assert lo[0].item() == hi[0].item() == 0


def mfccs(**kw):
    return JT.MFCC(**kw), PT.MFCC(device="cpu", **kw)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (1024, 256)])
@pytest.mark.parametrize("power", [1.0, 2.0])
@pytest.mark.parametrize("n_mfcc", [None, 13])
def test_mfcc_forward_vs_jax(audio, n_fft, hop, power, n_mfcc):
    x = audio.mean(1)
    jm, pm = mfccs(n_fft=n_fft, hop_length=hop, power=power, n_mfcc=n_mfcc, n_mels=64 if n_fft == 256 else 128)
    yj, yp = np.asarray(jm.forward(jnp.asarray(x))), t2n(pm.forward(torch.as_tensor(x)))
    assert yp.shape == yj.shape == (2, n_mfcc or pm.n_mels, 1 + x.shape[-1] // hop)
    if n_mfcc is None:
        assert rel(yp, yj) <= 1e-5
        return
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    S = np.abs(np.fft.rfft(xp[:, idx] * t2n(pm.window).astype(np.float64), axis=-1)) ** power
    mel = np.log(np.maximum(S @ t2n(pm.mel_bank).astype(np.float64), 1e-6))
    yo = np.swapaxes(mel @ t2n(pm.dct_mat).astype(np.float64), -1, -2)
    assert rel(yp, yj) <= 1e-4 and rel(yp, yo) <= 1e-4


@pytest.mark.parametrize("norm_mode", ["unipolar", "bipolar", "gaussian"])
def test_mfcc_norm_modes_fit_on_the_raw_input(audio, norm_mode):
    x = audio                                          # (B, 2, L): MFCC keeps the channel axis
    jm, pm = mfccs(n_fft=256, hop_length=64, n_mels=32, norm_mode=norm_mode)
    assert jm.needs_scaling and pm.needs_scaling
    jf, pf = jm.fit(jnp.asarray(x)), pm.fit(torch.as_tensor(x))
    # the reference's quirk: the norm is fitted on the raw input, not the mels
    ref = PT.Normalize(norm_mode, device="cpu").fit(torch.as_tensor(x))
    assert torch.equal(pf.norm.offset, ref.offset) and torch.equal(pf.norm.scale, ref.scale)
    assert abs(pf.norm.offset.item() - float(jf.norm.offset)) <= 1e-6
    assert abs(pf.norm.scale.item() - float(jf.norm.scale)) <= 1e-6 * abs(float(jf.norm.scale))
    assert rel(t2n(pf.forward(torch.as_tensor(x))), np.asarray(jf.forward(jnp.asarray(x)))) <= 1e-5
    pm.scale_data(torch.as_tensor(x))
    assert torch.equal(pm.norm.offset, pf.norm.offset)


def test_mfcc_time_mask_layout_and_refusal(audio):
    x = audio.mean(1)
    jm, pm = mfccs(n_fft=256, hop_length=64, n_mels=32)
    t = np.array([0.25, 2.0], np.float32)
    (yj, tj), (yp, tp) = jm.forward_with_time(jnp.asarray(x), jnp.asarray(t)), pm.forward_with_time(
        torch.as_tensor(x), torch.as_tensor(t))
    assert rel(t2n(yp), np.asarray(yj)) <= 1e-5
    np.testing.assert_array_equal(np.asarray(tj), tp.numpy())
    assert tp.shape == (2, yp.shape[-1])              # one time per frame, frames on axis -1
    mask = (np.arange(x.shape[-1]) < 5000).astype(np.float32)[None].repeat(2, 0)
    mj = jm.propagate_mask(jnp.asarray(mask), jnp.asarray(x))
    mp = pm.propagate_mask(torch.as_tensor(mask), torch.as_tensor(x))
    np.testing.assert_array_equal(np.asarray(mj), mp.numpy())
    assert mp.shape == (2, 1, yp.shape[-1]) and pm.propagate_mask(None, x) is None
    assert pm.ratio == 64 and pm.output_frame_axis(None) == jm.output_frame_axis(None) == -1
    assert not pm.invertible and not pm.needs_scaling
    with pytest.raises(PT.NotInvertibleError):
        pm.invert(yp)
    assert (PT.Mono(device="cpu") + pm).output_frame_axis() == -1


def fused_pair(mono: bool, **kw):
    jm, pm = mfccs(**kw)
    if mono:
        return JT.Mono() + jm, PT.Mono(device="cpu") + pm
    return jm, pm


@pytest.mark.parametrize("mono,power,norm", [(True, 2.0, None), (False, 1.0, None), (True, 2.0, "unipolar")])
def test_fused_mfcc_plain_version_vs_pallas(audio, mono, power, norm):
    """BASELINE config 3's chain at its shape (1024/256, 128 mels)."""
    x = audio if mono else audio[:, 0].copy()
    jc, pc = fused_pair(mono, n_fft=1024, hop_length=256, power=power, norm_mode=norm)
    if norm is not None:
        jc = jc.fit(jnp.asarray(x))
        pc = load_jax_state(pc, state_from_leaves(
            [{}, {"norm": {"offset": np.asarray(jc[1].norm.offset), "scale": np.asarray(jc[1].norm.scale),
                           "needs_scaling": jc[1].norm.needs_scaling}}]))
    jmatch = jfuse._match_mfcc(jc)
    yj = np.asarray(jfuse._fused_mfcc(*jmatch, backend="pallas")(jnp.asarray(x)))
    sk.reset_launches()
    fused = patt.fuse_forward(pc, backend="kernel")
    yp = fused(torch.as_tensor(x))
    assert all(v == 0 for v in sk.launches.values())       # a CPU tensor: the plain version
    ye = pc.forward(torch.as_tensor(x))
    assert yp.shape == ye.shape and tuple(yp.shape) == yj.shape
    assert rel(t2n(yp), yj) <= 1e-4
    assert rel(t2n(yp), t2n(ye)) <= 1e-5
    if norm is None:
        assert (yp[..., 0, :] == 0).all() and (ye[..., 0, :] == 0).all()
        assert (yj[..., 0, :] == 0).all()
    yb = patt.fuse_forward(pc, backend="kernel", out_dtype=torch.bfloat16)(torch.as_tensor(x))
    assert yb.dtype == torch.bfloat16 and torch.equal(yb, yp.to(torch.bfloat16))


@pytest.mark.parametrize("mono", [True, False])
def test_fused_mfcc_int16_and_backends(audio, mono):
    x = audio if mono else audio[:, 1].copy()
    _, pc = fused_pair(mono, n_fft=512, hop_length=128, n_mels=64)
    pcm = torch.round(torch.as_tensor(x) * 32767.0).to(torch.int16)
    flt = pcm.to(torch.float32) * 2.0 ** -15
    for backend in ("kernel", "eager", "auto"):
        f = patt.fuse_forward(pc, backend=backend)
        assert torch.equal(f(pcm), f(flt)), backend
    yk = patt.fuse_forward(pc, backend="kernel")(flt)
    ye = patt.fuse_forward(pc, backend="eager")(flt)
    ya = patt.fuse_forward(pc)(flt)
    assert torch.equal(ya, ye)                           # auto on a CPU tensor: the eager formulation
    assert rel(t2n(yk), t2n(ye)) <= 1e-5 and rel(t2n(ye), t2n(pc.forward(flt))) <= 1e-5


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_fused_mfcc_gradient_is_the_eager_chains(audio, power):
    x = audio[:, :, :4000].copy()
    _, pc = fused_pair(True, n_fft=512, hop_length=128, n_mels=64, power=power)
    w = torch.randn(pc.forward(torch.as_tensor(x)).shape, generator=torch.Generator().manual_seed(1))
    xk = torch.as_tensor(x).requires_grad_(True)
    (patt.fuse_forward(pc, backend="kernel")(xk) * w).sum().backward()
    xe = torch.as_tensor(x).requires_grad_(True)
    (pc.forward(xe) * w).sum().backward()
    assert torch.isfinite(xk.grad).all()
    assert rel(t2n(xk.grad), t2n(xe.grad)) <= 1e-4


def test_fused_mfcc_dispatch():
    def m(**kw):
        return PT.MFCC(device="cpu", **kw)

    assert pfuse._match_mfcc(m()) is not None and pfuse._match_mfcc(PT.Mono(device="cpu") + m()) is not None
    assert pfuse.fusable(m()) and pfuse.fusable(m(), backend="kernel")
    # where the JAX package's _match_mfcc declines: the eager chain serves
    for declined in (m(n_mfcc=13), m(power=3.0), m(impl="fft"), m(n_fft=1000, hop_length=256),
                     PT.Mono(device="cpu") + m() + PT.Transpose(device="cpu")):
        assert pfuse._match_mfcc(declined) is None and jfuse._match_mfcc(_jax_twin(declined)) is None
        assert patt.fuse_forward(declined) == declined.forward
        with pytest.raises(ValueError, match="backend='kernel'"):
            patt.fuse_forward(declined, backend="kernel")
    # matched, but outside A's structure (hop not a multiple of 32): the
    # eager formulation by structure, and an explicit kernel request raises
    odd = m(n_fft=1200, hop_length=300)
    assert pfuse._match_mfcc(odd) is not None and pfuse._match_mfcc(odd, "kernel") is None
    with pytest.raises(ValueError, match="kernel A does not cover"):
        patt.fuse_forward(odd, backend="kernel")
    x = torch.as_tensor(make_audio(3, batch=1, n=3000)[:, 0].copy())
    assert rel(t2n(patt.fuse_forward(odd)(x)), t2n(odd.forward(x))) <= 1e-5


def _jax_twin(chain):
    """The JAX chain of the same structure as a port chain of this test."""
    kids = chain.transforms if isinstance(chain, PT.ComposeAudioTransform) else [chain]
    out = []
    for t in kids:
        if isinstance(t, PT.MFCC):
            out.append(JT.MFCC(n_fft=t.n_fft, hop_length=t.hop_length, power=t.power, n_mfcc=t.n_mfcc,
                               impl=t.impl))
        else:
            out.append(getattr(JT, type(t).__name__)())
    return out[0] if len(out) == 1 else JT.ComposeAudioTransform(out)


@pytest.mark.parametrize("n_mfcc", [None, 13])
def test_load_jax_state_of_a_fitted_mfcc(audio, n_mfcc):
    x = audio.mean(1)
    jm = JT.MFCC(n_fft=256, hop_length=64, n_mels=32, norm_mode="gaussian", n_mfcc=n_mfcc)
    jf = jm.fit(jnp.asarray(x))
    leaves = {"window": np.asarray(jf.window), "mel_bank": np.asarray(jf.mel_bank),
              "dct_mat": None if jf.dct_mat is None else np.asarray(jf.dct_mat),
              "norm": {"offset": np.asarray(jf.norm.offset), "scale": np.asarray(jf.norm.scale),
                       "needs_scaling": jf.norm.needs_scaling}}
    state = state_from_leaves([leaves])
    assert set(state) == {"0.window", "0.mel_bank", "0.norm.offset", "0.norm.scale", "0.norm.needs_scaling"} | (
        set() if n_mfcc is None else {"0.dct_mat"})
    pm = load_jax_state(PT.MFCC(n_fft=256, hop_length=64, n_mels=32, norm_mode="gaussian", n_mfcc=n_mfcc,
                                device="cpu"), state)
    assert pm.norm.offset.item() == float(jf.norm.offset) and not pm.norm.needs_scaling
    assert rel(t2n(pm.forward(torch.as_tensor(x))), np.asarray(jf.forward(jnp.asarray(x)))) <= 1e-5
