"""The plain PyTorch versions of kernels A (fused log-mel forward) and B (fit
statistics) against the JAX package's Pallas kernels, run in interpret mode as
its own tests run them off-TPU, and against a float64 numpy oracle.

On the CPU the port's wrappers (``fused_melspec``, ``fused_melspec_stats``)
run exactly these plain versions; the CUDA kernels are held against them on
the card by ``chip_smoke.py``.  Tolerance: 1e-4 max-abs over max-abs, the
budget the JAX kernel states for itself (its bf16x3 GEMMs measure ~5e-5
against float64; the port's float32 formulation ~1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu as jatt
import acids_transforms_tpu_torch as patt
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from test_torch_common import HOP, N_FFT, Mesh4, carry_over, chains, make_audio, rel, t2n

TOL = 1e-4


def oracle_logmel(x_mono, window64, n_fft, hop, bank, offset, scale, mel=True):
    """float64 numpy reference of the whole forward."""
    x = np.asarray(x_mono, np.float64)
    xp = np.pad(x, [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    T = 1 + x.shape[-1] // hop
    idx = np.arange(T)[:, None] * hop + np.arange(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(xp[:, idx] * window64, axis=-1))
    if mel:
        mag = mag @ np.asarray(bank, np.float64)
    return (np.log1p(mag) - offset) / scale, np.log1p(np.abs(np.fft.rfft(xp[:, idx] * window64, axis=-1)))


def window64(name, n):
    k = np.arange(n)
    if name == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * k / n)
    return 0.42 - 0.5 * np.cos(2 * np.pi * k / n) + 0.08 * np.cos(4 * np.pi * k / n)


@pytest.fixture(scope="module", params=["hann", "blackman"])
def fitted(request):
    """JAX chain fitted by its Pallas stats kernel, and the port chain holding
    the same state."""
    window = request.param
    jc, pc = chains(window=window)
    x = make_audio(11)
    jf = jatt.fuse_fit(jc, backend="pallas")(jnp.asarray(x))
    carry_over(jf, pc)
    return window, x, jc, jf, pc


@pytest.mark.parametrize("pcm", [False, True], ids=["f32in", "int16in"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_plain_forward_vs_pallas_kernel(fitted, pcm, out):
    window, x, _, jf, pc = fitted
    mono = x.mean(1)
    if pcm:
        xin = np.round(mono * 32767).astype(np.int16)   # already mono: converted in the kernel
    else:
        xin = x
    yj = jatt.fuse_forward(jf, backend="pallas", out_dtype=getattr(jnp, out))(jnp.asarray(xin))
    yp = patt.fuse_forward(pc, backend="kernel", out_dtype=getattr(torch, out))(torch.as_tensor(xin))
    assert yp.dtype == getattr(torch, out) and tuple(yp.shape) == tuple(yj.shape)
    yj32 = np.asarray(yj.astype(jnp.float32))
    if out == "float32":
        assert rel(t2n(yp), yj32) <= TOL
    else:
        # both round one float32 result to bf16: equal up to one bf16 ulp where
        # the float32 values differ by their 1e-4
        assert rel(t2n(yp), yj32) <= 2 ** -7
        f32 = patt.fuse_forward(pc, backend="kernel")(torch.as_tensor(xin))
        assert torch.equal(yp, f32.to(torch.bfloat16))  # the store only rounds
    if pcm:
        pre = torch.as_tensor(xin.astype(np.float32) * 2.0 ** -15)
        yf = patt.fuse_forward(pc, backend="kernel", out_dtype=getattr(torch, out))(pre)
        assert torch.equal(yp, yf)                      # bit-identical to pre-converted


def test_plain_forward_vs_float64_oracle(fitted):
    window, x, _, jf, pc = fitted
    mono = x.mean(1)
    off, scl = float(pc[2].norm.offset), float(pc[2].norm.scale)
    ref, _ = oracle_logmel(mono, window64(window, N_FFT), N_FFT, HOP, t2n(pc[2].mel_bank), off, scl)
    yp = patt.fuse_forward(pc, backend="kernel")(torch.as_tensor(x))
    assert rel(t2n(yp), ref) <= TOL
    ye = pc.forward(torch.as_tensor(x))                 # the eager chain too
    assert rel(t2n(ye), ref) <= TOL
    assert rel(t2n(patt.fuse_forward(pc, backend="eager")(torch.as_tensor(x))), ref) <= TOL
    yj = np.asarray(jatt.fuse_forward(jf, backend="pallas")(jnp.asarray(x)))
    assert rel(yj, ref) <= TOL                          # the JAX kernel's own score


def test_plain_stats_vs_pallas_fit_and_oracle(fitted):
    window, x, jc, jf, _ = fitted
    _, pc = chains(window=window)
    pf = patt.fuse_fit(pc, backend="kernel")(torch.as_tensor(x))
    j_off, j_scl = float(jf[2].norm.offset), float(jf[2].norm.scale)
    assert abs(float(pf[2].norm.offset) - j_off) <= TOL * j_scl
    assert abs(float(pf[2].norm.scale) - j_scl) <= TOL * j_scl
    assert not pf[2].norm.needs_scaling and pc[2].norm.needs_scaling
    # the statistics themselves against float64
    mono = x.mean(1)
    _, v = oracle_logmel(mono, window64(window, N_FFT), N_FFT, HOP, None, 0.0, 1.0, mel=False)
    taps = pc[1]._window_taps
    st = pk.fused_melspec_stats(torch.as_tensor(mono), N_FFT, HOP, "log1p", taps=taps)
    assert st["count"] == v.size and isinstance(st["count"], int)
    assert abs(float(st["sum"]) - v.sum()) <= 1e-5 * abs(v.sum())
    assert abs(float(st["sumsq"]) - (v * v).sum()) <= 1e-5 * (v * v).sum()
    assert abs(float(st["min"]) - v.min()) <= 1e-5 and abs(float(st["max"]) - v.max()) <= 1e-5 * v.max()
    # and the eager cascade agrees with the fused fit
    pe = pc.fit(torch.as_tensor(x))
    assert abs(float(pe[2].norm.scale) - float(pf[2].norm.scale)) <= 1e-5 * j_scl
    assert abs(float(pe[2].norm.offset) - float(pf[2].norm.offset)) <= 1e-5 * j_scl


@pytest.mark.parametrize("mode", ["bipolar", "gaussian"])
def test_fused_fit_other_modes_vs_eager_cascade(mode):
    _, pc = chains(mode=mode)
    x = torch.as_tensor(make_audio(12))
    pf = patt.fuse_fit(pc, backend="kernel")(x)
    pe = pc.fit(x)
    s = float(pe[2].norm.scale)
    assert abs(float(pf[2].norm.offset) - float(pe[2].norm.offset)) <= 1e-5 * s
    assert abs(float(pf[2].norm.scale) - s) <= 1e-5 * s


@pytest.mark.parametrize("power,mel,contrast", [(2.0, True, "none"), (1.0, False, "log1p"), (1.0, True, "none")])
def test_plain_forward_options_vs_pallas(power, mel, contrast):
    from acids_transforms_tpu.ops.pallas.spectral import fused_melspec as jfm

    x = make_audio(13, batch=1, n=5000)[:, 0]
    _, pc = chains()
    bank = pc[2].mel_bank if mel else None
    taps = pc[1]._window_taps
    yp = pk.fused_melspec(torch.as_tensor(x), N_FFT, HOP, bank, 0.1, 1.7, contrast, taps=taps, power=power)
    yj = jfm(jnp.asarray(x), N_FFT, HOP, jnp.asarray(t2n(pc[1].window)),
             None if bank is None else jnp.asarray(t2n(bank)), 0.1, 1.7, contrast, taps=taps, power=power)
    assert tuple(yp.shape) == tuple(yj.shape) and rel(t2n(yp), np.asarray(yj)) <= TOL
    one = pk.fused_melspec(torch.as_tensor(x[0]), N_FFT, HOP, bank, 0.1, 1.7, contrast, taps=taps, power=power)
    assert torch.equal(one, yp[0])                      # 1-D input


def test_short_clip_takes_the_multi_reflection_pad():
    x = make_audio(14, batch=2, n=150)[:, 0]            # shorter than n_fft // 2
    w = window64("hann", N_FFT)
    _, pc = chains()
    taps = pc[1]._window_taps
    yp = pk.fused_melspec(torch.as_tensor(x), N_FFT, HOP, None, 0.0, 1.0, "none", taps=taps)
    xp = np.pad(x.astype(np.float64), [(0, 0), (N_FFT // 2, N_FFT // 2)], mode="reflect")
    idx = np.arange(2)[:, None] * HOP + np.arange(N_FFT)[None, :]
    ref = np.abs(np.fft.rfft(xp[:, idx] * w, axis=-1))
    assert yp.shape == (2, 2, N_FFT // 2 + 1) and rel(t2n(yp), ref) <= 1e-5


def test_dispatch_gates_and_explicit_kernel_request():
    _, pc = chains()
    assert patt.fuse.fusable(pc) and patt.fuse.fit_fusable(pc)
    for bad in (chains(contrast="log")[1], chains(hop=100)[1]):
        assert patt.fuse.fusable(bad, "eager") and not patt.fuse.fusable(bad, "kernel")
        assert not patt.fuse.fit_fusable(bad)
        with pytest.raises(ValueError, match="kernel"):
            patt.fuse_forward(bad, backend="kernel")
        with pytest.raises(ValueError, match="kernel"):
            patt.fuse_fit(bad, backend="kernel")
        x = torch.as_tensor(make_audio(15, batch=1, n=3000))
        fitted_bad = patt.fuse_fit(bad)(x)               # auto falls back to the cascade
        y = patt.fuse_forward(fitted_bad)(x)             # and to the eager formulation
        assert torch.isfinite(y).all()
    assert pk.fused_melspec_available(N_FFT, HOP, None)              # full-K: any window
    assert not pk.fused_melspec_available(N_FFT, 100, None)
    assert pk.fused_melspec_available(1024, 256, (0.5, -0.25))
    assert not pk.fused_melspec_available(512, 32, (0.5, -0.25))     # overlap 16
    # shared memory is no silent gate: the frame tile narrows with n_fft, and
    # a shape whose narrowest tile does not fit is for the wrapper to refuse
    assert pk.fused_melspec_available(8192, 2048, (0.5, -0.25))
    picks = {(1024, 256): 32, (512, 64): 32, (2048, 512): 16, (2048, 256): 16,
             (4096, 1024): 8, (4096, 512): 8, (8192, 2048): None}
    for (n_fft, hop), tile in picks.items():
        assert pk._pick_tile(hop, n_fft // hop, n_fft // 2 + 1) == tile
        if tile is not None:
            assert pk._smem_bytes(tile, hop, n_fft // hop, n_fft // 2 + 1) <= pk.MAX_SMEM
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pk._kernel_tile(8192, 2048, (0.5, -0.25))
    with pytest.raises(ValueError, match="overlap"):
        pk._kernel_tile(512, 32, (0.5, -0.25))
    with pytest.raises(ValueError):
        patt.fuse_forward(pc, backend="pallas")
    with pytest.raises(ValueError):
        patt.fuse_forward(pc, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no axis 'seq'"):   # mesh= runs: tests/test_torch_parallel.py
        patt.fuse_forward(pc, mesh=Mesh4(), shard_axis="seq")
    with pytest.raises(ValueError, match="window"):
        pk.fused_melspec(torch.zeros(1, 3000), N_FFT, HOP, taps=None)   # full-K needs the window
    with pytest.raises(ValueError, match="log"):
        pk.fused_melspec(torch.zeros(1, 3000), N_FFT, HOP, contrast="log", taps=(0.5, -0.25))
    only_stft = chains()[1][1]
    assert patt.fuse_forward(only_stft) == only_stft.forward  # unmatched: chain.forward
    assert set(pk.launches) == {"fused_melspec", "fused_melspec_stats", "fused_melspec_fullk",
                                "fused_melspec_stats_fullk", "fused_spectral_repr",
                                "fused_spectral_repr_fullk", "fused_repr_stats",
                                "fused_repr_stats_fullk", "melspec_stage"}
    assert not any(pk.launches.values())                 # nothing launched on the CPU


def test_masked_fit_takes_the_exact_cascade():
    _, pc = chains()
    x = torch.as_tensor(make_audio(16))
    mask = (torch.arange(x.shape[-1]) < 6000).float().expand(2, 2, -1)
    a = patt.fuse_fit(pc, backend="kernel")(x, mask=mask)
    b = pc.fit(x, mask=mask)
    assert float(a[2].norm.scale) == float(b[2].norm.scale)
    c = pc.fit(x)
    assert float(c[2].norm.scale) >= float(b[2].norm.scale)


# ---- kernels E and F: the full-K front end (taps=None, any window) ----------
def gaussian64(n_fft):
    lam = (-(n_fft ** 2) / (8.0 * np.log(0.01))) ** 0.5
    n = np.arange(0, 2 * n_fft + 1) - n_fft
    return np.exp(-(n ** 2) / (2.0 * (2.0 * lam) ** 2))[1: 2 * n_fft + 1: 2]


@pytest.fixture(scope="module")
def fullk():
    from test_torch_common import dgt_chains

    _, pc = dgt_chains()
    x = make_audio(17, batch=2, n=7000)[:, 0]
    return x, pc[1].window, chains()[1][2].mel_bank


@pytest.mark.parametrize("mel,power,contrast", [(False, 1.0, "log1p"), (True, 1.0, "log1p"),
                                                (True, 2.0, "none"), (False, 2.0, "none")])
@pytest.mark.parametrize("pcm", [False, True], ids=["f32in", "int16in"])
def test_plain_fullk_forward_vs_pallas_kernel_and_oracle(fullk, mel, power, contrast, pcm):
    from acids_transforms_tpu.ops.pallas.spectral import fused_melspec as jfm

    x, w, bank = fullk
    bank = bank if mel else None
    xin = np.round(x * 32767).astype(np.int16) if pcm else x
    kw = dict(taps=None, power=power)
    yp = pk.fused_melspec(torch.as_tensor(xin), N_FFT, HOP, bank, 0.1, 1.7, contrast, window=w, **kw)
    yj = jfm(jnp.asarray(xin), N_FFT, HOP, jnp.asarray(t2n(w)),
             None if bank is None else jnp.asarray(t2n(bank)), 0.1, 1.7, contrast, interpret=True, **kw)
    assert tuple(yp.shape) == tuple(yj.shape) and rel(t2n(yp), np.asarray(yj)) <= TOL
    xf = xin.astype(np.float64) / 32768.0 if pcm else x
    xp = np.pad(xf, [(0, 0), (N_FFT // 2, N_FFT // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // HOP)[:, None] * HOP + np.arange(N_FFT)[None, :]
    ref = np.abs(np.fft.rfft(xp[:, idx] * gaussian64(N_FFT), axis=-1)) ** power
    if mel:
        ref = ref @ t2n(bank).astype(np.float64)
    ref = ((np.log1p(ref) if contrast == "log1p" else ref) - 0.1) / 1.7
    assert rel(t2n(yp), ref) <= TOL
    if pcm:
        pre = torch.as_tensor(xin.astype(np.float32) * 2.0 ** -15)
        assert torch.equal(yp, pk.fused_melspec(pre, N_FFT, HOP, bank, 0.1, 1.7, contrast, window=w, **kw))
    yb = pk.fused_melspec(torch.as_tensor(xin), N_FFT, HOP, bank, 0.1, 1.7, contrast, window=w,
                          out_dtype=torch.bfloat16, **kw)
    assert yb.dtype == torch.bfloat16 and torch.equal(yb, yp.to(torch.bfloat16))   # the store only rounds


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256), (512, 64)])
def test_plain_fullk_stats_vs_pallas_kernel_and_oracle(n_fft, hop):
    from acids_transforms_tpu.ops.pallas.spectral import fused_melspec_stats as jfs
    from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window

    x = make_audio(18, batch=2, n=7000)[:, 0]
    w = gaussian_dgt_window(n_fft)
    sp = pk.fused_melspec_stats(torch.as_tensor(x), n_fft, hop, "log1p", taps=None, window=w)
    sj = jfs(jnp.asarray(x), n_fft, hop, jnp.asarray(t2n(w)), "log1p", interpret=True, taps=None)
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    v = np.log1p(np.abs(np.fft.rfft(xp[:, idx] * gaussian64(n_fft), axis=-1)))
    assert sp["count"] == v.size == int(sj["count"]) and isinstance(sp["count"], int)
    for key, want in (("sum", v.sum()), ("sumsq", (v * v).sum()), ("max", v.max())):
        assert abs(float(sp[key]) - want) <= 1e-5 * abs(want)
        assert abs(float(sp[key]) - float(sj[key])) <= TOL * abs(want)
    assert abs(float(sp["min"]) - v.min()) <= 1e-5 and abs(float(sj["min"]) - v.min()) <= TOL


def test_fullk_serves_a_cosine_window_too():
    """taps=None with a hann window is the same function as the factored path."""
    x = make_audio(19, batch=1, n=5000)[:, 0]
    _, pc = chains()
    w, taps = pc[1].window, pc[1]._window_taps
    a = pk.fused_melspec(torch.as_tensor(x), N_FFT, HOP, None, 0.0, 1.0, "log1p", taps=taps)
    b = pk.fused_melspec(torch.as_tensor(x), N_FFT, HOP, None, 0.0, 1.0, "log1p", taps=None, window=w)
    assert rel(t2n(b), t2n(a)) <= 1e-5
    with pytest.raises(ValueError, match="window"):
        pk.fused_melspec_stats(torch.as_tensor(x), N_FFT, HOP, taps=None, window=w[:100])
