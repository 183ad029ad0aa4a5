"""Each ported transform class against its JAX twin on the same numpy input,
after the JAX twin's fitted state was carried across with
``convert.load_jax_state`` (CPU, float32; max-abs over max-abs <= 1e-5 unless
the JAX side runs a bf16x3 GEMM, which is ~1e-5 accurate by itself)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.convert import load_jax_state, state_from_leaves
from test_torch_common import HOP, N_FFT, carry_over, chains, jax_state, make_audio, rel, t2n

GEMM_TOL = 5e-5  # JAX Precision.HIGH GEMMs on one side


@pytest.mark.parametrize("mode", ["mix", "left", "right"])
@pytest.mark.parametrize("squeeze", [True, False])
def test_mono_forward_invert(mode, squeeze):
    x = make_audio(0, batch=2, n=500)
    jt = JT.Mono(mode=mode, squeeze=squeeze)
    pt = PT.Mono(mode=mode, squeeze=squeeze, device="cpu")
    yj = np.asarray(jt.forward(jnp.asarray(x)))
    yp = pt.forward(torch.as_tensor(x))
    assert yp.shape == yj.shape and rel(t2n(yp), yj) <= 1e-6
    for inv in ("mono", "stereo"):
        rj = np.asarray(jt.invert(jnp.asarray(yj), inversion_mode=inv))
        rp = pt.invert(yp, inversion_mode=inv)
        assert rp.shape == rj.shape and np.array_equal(t2n(rp), rj)
    assert pt.get_inversion_modes() == jt.get_inversion_modes()


def test_mono_normalize_and_mask():
    x = make_audio(1, batch=2, n=500)
    yj = np.asarray(JT.Mono(normalize=True).forward(jnp.asarray(x)))
    yp = PT.Mono(normalize=True, device="cpu").forward(torch.as_tensor(x))
    assert rel(t2n(yp), yj) <= 1e-6
    mask = (np.arange(500) < 400).astype(np.float32)[None].repeat(2, 0)
    mj = JT.Mono().propagate_mask(jnp.asarray(mask), jnp.asarray(x))
    mp = PT.Mono(device="cpu").propagate_mask(torch.as_tensor(mask), torch.as_tensor(x))
    assert np.array_equal(t2n(mp), np.asarray(mj))


@pytest.mark.parametrize("mode", ["unipolar", "bipolar", "gaussian"])
@pytest.mark.parametrize("masked", [False, True])
def test_normalize_fit_forward_invert(mode, masked):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 40, 17)) * 2.0 + 0.7).astype(np.float32)
    mask = (rng.uniform(size=(3, 40, 1)) > 0.3).astype(np.float32) if masked else None
    jt = JT.Normalize(mode).fit(jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    pt0 = PT.Normalize(mode, device="cpu")
    assert pt0.needs_scaling
    pt = pt0.fit(torch.as_tensor(x), mask=None if mask is None else torch.as_tensor(mask))
    assert pt is not pt0 and pt0.needs_scaling and not pt.needs_scaling
    assert abs(float(pt.offset) - float(jt.offset)) <= 1e-5 * abs(float(jt.scale))
    assert abs(float(pt.scale) - float(jt.scale)) <= 1e-5 * abs(float(jt.scale))
    loaded = load_jax_state(PT.Normalize(mode, device="cpu"), jax_state(jt))
    assert not loaded.needs_scaling
    yj = np.asarray(jt.forward(jnp.asarray(x)))
    yp = loaded.forward(torch.as_tensor(x))
    assert rel(t2n(yp), yj) <= 1e-6
    assert rel(t2n(loaded.invert(yp)), x) <= 1e-6
    inplace = PT.Normalize(mode, device="cpu")
    inplace.scale_data(torch.as_tensor(x), mask=None if mask is None else torch.as_tensor(mask))
    assert float(inplace.offset) == float(pt.offset) and not inplace.needs_scaling


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("impl", ["auto", "factored"])
def test_stft_forward_and_complex_invert(window, impl):
    x = make_audio(2, batch=2, n=6016)[:, 0]
    jt = JT.STFT(n_fft=N_FFT, hop_length=HOP, window=window, impl=impl)
    pt = PT.STFT(n_fft=N_FFT, hop_length=HOP, window=window, impl=impl, device="cpu")
    load_jax_state(pt, jax_state(jt))
    assert pt._window_taps == jt._window_taps and pt._inv_window_taps == jt._inv_window_taps
    sj = np.asarray(jt.forward(jnp.asarray(x)))
    sp = pt.forward(torch.as_tensor(x))
    assert sp.shape == sj.shape and sp.is_complex()
    assert rel(t2n(sp), sj) <= GEMM_TOL
    rj = np.asarray(jt.invert(jnp.asarray(sj)))
    rp = pt.invert(torch.as_tensor(sj))
    assert rp.shape == rj.shape and rel(t2n(rp), rj) <= GEMM_TOL
    assert rel(t2n(pt.invert(sp)), x[..., : rp.shape[-1]]) <= 1e-4  # roundtrip budget
    assert pt.ratio == jt.ratio == HOP and pt.n_bins == jt.n_bins
    mask = (np.arange(6016) < 5000).astype(np.float32)[None].repeat(2, 0)
    mj = jt.propagate_mask(jnp.asarray(mask), jnp.asarray(x))
    mp = pt.propagate_mask(torch.as_tensor(mask), torch.as_tensor(x))
    assert np.array_equal(t2n(mp), np.asarray(mj))


def test_stft_modes_and_unported_raise():
    pt = PT.STFT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    assert pt.get_inversion_modes() == JT.STFT.get_inversion_modes()
    mag = torch.rand(1, 20, N_FFT // 2 + 1)
    y = pt.invert(mag, inversion_mode="sinebank")               # hop * T + n_fft samples, peak 1
    assert y.shape == (1, 20 * HOP + N_FFT) and torch.isfinite(y).all() and y.abs().max() == 1
    for mode in ("keep_input", "random", "pghi", "pghi_bidir", "pghi_gl", "pghi_exact"):
        y = pt.invert(mag, inversion_mode=mode)                # ported: they run
        assert y.shape == (1, 19 * HOP) and torch.isfinite(y).all()
    with pytest.raises(ValueError):
        pt.invert(mag, inversion_mode="no_such_mode")
    with pytest.raises(ValueError):
        PT.STFT(inversion_mode="no_such_mode", device="cpu")
    pt.set_params(256, 64)
    assert pt.window.shape == (256,) and pt._window_taps is not None
    # the last transform classes are ported: nothing is left to refuse
    for name in ("MFCC", "MidSide", "MuLaw"):
        assert getattr(PT, name).__name__ == name
    assert not PT._UNPORTED
    assert issubclass(PT.DGT, PT.STFT)
    rt = PT.DGT(n_fft=N_FFT, hop_length=HOP, device="cpu").realtime()
    assert isinstance(rt, PT.RealtimeDGT) and (rt.n_fft, rt.hop_length) == (N_FFT, HOP)
    with pytest.raises(AttributeError):
        PT.no_such_class


def test_stft_griffin_lim_eager_matches_jax_from_same_phase():
    x = make_audio(3, batch=1, n=6000)[:, 0]
    jt = JT.STFT(n_fft=N_FFT, hop_length=HOP, gl_iterations=2)
    pt = PT.STFT(n_fft=N_FFT, hop_length=HOP, gl_iterations=2, device="cpu")
    mag = np.abs(np.asarray(jt.forward(jnp.asarray(x))))
    ph = np.random.default_rng(0).uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    from acids_transforms_tpu.ops.griffinlim import griffin_lim as jgl

    rj = np.asarray(jgl(jnp.asarray(mag), N_FFT, HOP, jt.inv_window, n_iter=2,
                        init_phase=jnp.asarray(ph), fused=False))
    rp = pt.invert(torch.as_tensor(mag), init_phase=torch.as_tensor(ph))
    assert rp.shape == rj.shape
    assert rel(t2n(rp), rj) <= 1e-3  # two iterations of a chaotic map (see test_gl_parity)
    # the random init takes an explicit generator and is reproducible
    a = pt.invert(torch.as_tensor(mag), generator=torch.Generator().manual_seed(3))
    b = pt.invert(torch.as_tensor(mag), generator=torch.Generator().manual_seed(3))
    c = pt.invert(torch.as_tensor(mag))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(c).all()


@pytest.mark.parametrize("contrast", ["log1p", "log", "log10", "none"])
@pytest.mark.parametrize("mel,keep_nyquist", [(True, True), (False, True), (True, False)])
def test_magnitude_fit_forward_invert(contrast, mel, keep_nyquist):
    x = make_audio(4, batch=2, n=5000)[:, 0]
    spec = np.asarray(JT.STFT(n_fft=N_FFT, hop_length=HOP).forward(jnp.asarray(x)))
    kw = dict(mode="unipolar", contrast=contrast, mel=mel, n_fft=N_FFT, keep_nyquist=keep_nyquist)
    jt = JT.Magnitude(**kw).fit(jnp.asarray(spec))
    pt0 = PT.Magnitude(device="cpu", **kw)
    assert pt0.needs_scaling and pt0.norm.needs_scaling
    # the port's own fit (on the NON-mel contrasted magnitude, like the JAX one)
    pfit = pt0.fit(torch.as_tensor(spec))
    assert abs(float(pfit.norm.offset) - float(jt.norm.offset)) <= 1e-5 * abs(float(jt.norm.scale))
    assert abs(float(pfit.norm.scale) - float(jt.norm.scale)) <= 1e-5 * abs(float(jt.norm.scale))
    # and the JAX fit carried across
    pt = load_jax_state(PT.Magnitude(device="cpu", **kw), jax_state(jt))
    assert not pt.norm.needs_scaling
    yj = np.asarray(jt.forward(jnp.asarray(spec)))
    yp = pt.forward(torch.as_tensor(spec))
    assert yp.shape == yj.shape
    assert rel(t2n(yp), yj) <= GEMM_TOL
    rj = np.asarray(jt.invert(jnp.asarray(yj)))
    rp = pt.invert(torch.as_tensor(yj))
    assert rp.shape == rj.shape and rel(t2n(rp), rj) <= GEMM_TOL
    assert rel(t2n(pt.invert_contrast(pt.contrast(torch.as_tensor(np.abs(spec))))), np.abs(spec)) <= 1e-5


def test_magnitude_dummy_norm_alias_and_bad_contrast():
    assert isinstance(PT.Magnitude(mode=None, n_fft=N_FFT, device="cpu").norm, PT.Dummy)
    assert PT.Magnitude(norm="bipolar", n_fft=N_FFT, device="cpu").norm.mode == "bipolar"
    with pytest.raises(TypeError):
        PT.Magnitude(contrast="sqrt", n_fft=N_FFT, device="cpu")
    d = PT.Dummy(device="cpu")
    x = torch.ones(3)
    assert d.forward(x) is x and d.invert(x) is x and d.fit(x) is d


def test_compose_flags_add_fit_and_scale_data():
    jc, pc = chains()
    assert isinstance(pc, PT.ComposeAudioTransform) and len(pc) == 3
    assert pc.needs_scaling and pc.invertible and pc.scriptable
    assert pc.ratio == jc.ratio
    assert pc.get_inversion_modes() == jc.get_inversion_modes()
    x = make_audio(6)
    pf = pc.fit(torch.as_tensor(x))
    jf = jc.fit(jnp.asarray(x))
    # fit is pure; as in the JAX package only the normalizer drops its flag
    assert pc[2].norm.needs_scaling and not pf[2].norm.needs_scaling
    assert pf.needs_scaling == jf.needs_scaling
    assert abs(float(pf[2].norm.scale) - float(jf[2].norm.scale)) <= 1e-4 * float(jf[2].norm.scale)
    pc.scale_data(torch.as_tensor(x))                  # scale_data fits in place
    assert not pc[2].norm.needs_scaling
    assert float(pc[2].norm.scale) == float(pf[2].norm.scale)
    # + / __radd__ shapes of the composition
    m = PT.Mono(device="cpu")
    both = m + pf
    assert len(both) == 4 and both[0] is m
    assert len(pf + m) == 4 and len(pf + pf) == 6
    with pytest.raises(TypeError):
        m + 3
    with pytest.raises(TypeError):
        pf + "x"
    masked = pc.propagate_mask(torch.ones(2, 2, 9000), torch.as_tensor(x))
    assert masked.shape == (2, 1 + 9000 // HOP, 1)


def test_compose_forward_invert_after_carry_over():
    jc, pc = chains()
    x = make_audio(7)
    jf = jc.fit(jnp.asarray(x))
    carry_over(jf, pc)
    assert not pc[2].norm.needs_scaling
    yj = np.asarray(jf.forward(jnp.asarray(x)))
    yp = pc.forward(torch.as_tensor(x))
    assert yp.shape == yj.shape and rel(t2n(yp), yj) <= GEMM_TOL
    # the inversion input (mel pseudo-inverse of the log-mel) is the same
    mj = np.asarray(jf[2].invert(jnp.asarray(yj)))
    mp = pc[2].invert(torch.as_tensor(yj))
    assert rel(t2n(mp), mj) <= GEMM_TOL
    rec = pc.invert(yp, inversion_mode="stereo")
    assert rec.shape == (2, 2, HOP * (yp.shape[-2] - 1)) and torch.isfinite(rec).all()
    with pytest.raises(ValueError):
        pc.invert(yp, inversion_mode="no_such_mode")
    PT.AudioTransform.register_inversion_modes("my_mode")
    assert torch.isfinite(pc.invert(yp, inversion_mode="my_mode")).all()


def test_load_jax_state_rejects_foreign_keys_and_shapes():
    _, pc = chains()
    with pytest.raises(KeyError):
        load_jax_state(pc, {"1.no_such_leaf": np.zeros(3)})
    with pytest.raises(ValueError):
        load_jax_state(pc, {"1.window": np.zeros(7, np.float32)})
    st = state_from_leaves([{}, {"window": np.ones(N_FFT)}, {"norm": {"offset": 1.5, "scale": None}}])
    assert set(st) == {"1.window", "2.norm.offset"}
    load_jax_state(pc, st)
    assert float(pc[2].norm.offset) == 1.5 and pc[1]._window_taps == (1.0,)
