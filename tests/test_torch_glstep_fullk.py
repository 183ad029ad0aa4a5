"""Kernels I and J, as their plain PyTorch versions, against the JAX package:
the consistency projection ``gl_project`` (kernel I) and the full-K momentum
Griffin-Lim step for windows without cosine-sum taps (kernel J,
``make_gl_momentum_step_fullk``), in interpret mode, at 512/128 (where the
JAX kernel's ``hop % 128`` gate holds), from the same numpy state.

On the CPU the wrappers return these plain versions; the CUDA kernels are
held against them and the float64 oracles on the card by ``chip_smoke.py``.

J's boundary rule is the eager loop's (trim, reflect-pad, re-frame), not the
JAX kernel's (re-frame the un-trimmed overlap-add signal): the two agree on
every frame whose samples lie inside the trimmed signal, and the port's step
is one ``istft`` + ``stft`` of the eager loop on every frame.  Tolerances:
the JAX kernel's bf16x3 products are 2.5e-5 of the projection's largest
value off a float64 FFT oracle (measured), the port's fp32 ones 4e-7; so
1e-4 against the JAX kernel and 2e-6 against the oracle.  The DGT's gaussian
never falls below 0.01, so the envelope division amplifies rounding by at
most 100 (not the 1e4-1e5 of hann's tails).  I under hann: interior frames
at 1e-4; the first and last ``overlap - 1`` frames are ill-conditioned in
both packages (ROADMAP Queue 3) and are held against the oracle instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.pallas import glstep as jk
from acids_transforms_tpu.ops.windows import gaussian_dgt_window as jgauss
from acids_transforms_tpu.ops.windows import get_window as jwin
from acids_transforms_tpu_torch.ops import griffinlim as pgl
from acids_transforms_tpu_torch.ops.cuda import glstep as pk
from test_torch_common import HOP, N_FFT, make_audio, rel, t2n

MOM = 0.99 / 1.99
M = N_FFT // HOP - 1


def make_state(window, seed=51):
    rng = np.random.default_rng(seed)
    x = make_audio(seed, batch=2, n=7000)[:, 0]
    mag = np.abs(np.asarray(jfft.stft(jnp.asarray(x), N_FFT, HOP, jnp.asarray(window)))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    tre = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    tim = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    return mag, (np.cos(ph), np.sin(ph), tre, tim)


@pytest.fixture(scope="module")
def gauss():
    w = np.array(jgauss(N_FFT))
    mag, st = make_state(w)
    return w, mag, st


def run_jax_fullk(w, mag, st):
    step, to_rows, from_rows = jk.make_gl_momentum_step_fullk(
        jnp.asarray(mag), N_FFT, HOP, jnp.asarray(w), MOM, interpret=True)
    return [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]


def run_port_fullk(w, mag, st):
    step, to_rows, from_rows = pk.make_gl_momentum_step_fullk(
        torch.as_tensor(mag), N_FFT, HOP, torch.as_tensor(w), MOM)
    return [t2n(from_rows(o)) for o in step(*[to_rows(torch.as_tensor(a)) for a in st])]


def oracle_fullk(w, mag, st):
    env = pk._env_rows(mag.shape[1], N_FFT, HOP, torch.as_tensor(w))
    out = pk.gl_momentum_step_fullk_oracle(
        torch.as_tensor(mag), *[torch.as_tensor(a) for a in st], env, N_FFT, HOP,
        torch.as_tensor(w), MOM)
    return [o.numpy() for o in out]


def proj_err(got, ref):
    scale = max(np.abs(ref[2]).max(), np.abs(ref[3]).max())
    return max(np.abs(got[i] - ref[i]).max() for i in (2, 3)) / scale


def test_plain_j_vs_pallas_kernel_and_oracle(gauss):
    w, mag, st = gauss
    assert np.abs(w).min() >= 0.01
    jo, po, oo = run_jax_fullk(w, mag, st), run_port_fullk(w, mag, st), oracle_fullk(w, mag, st)
    assert all(p.shape == j.shape == mag.shape for p, j in zip(po, jo))
    # frames whose samples lie inside the trimmed signal: the boundary rules agree
    inner = slice((N_FFT // 2) // HOP, mag.shape[1] - (N_FFT // 2) // HOP)
    assert proj_err([a[:, inner] for a in po], [a[:, inner] for a in jo]) <= 1e-4
    assert proj_err(po, oo) <= 2e-6                          # every frame
    assert proj_err([a[:, inner] for a in jo], [a[:, inner] for a in oo]) > 5 * proj_err(po, oo)
    # the edge frames: the JAX kernel's un-trimmed re-framing is another function
    assert proj_err(jo, oo) > 1e-2
    # one step of the eager loop (istft, stft) is the same function
    from acids_transforms_tpu_torch.ops.fft import istft, stft

    spec = torch.complex(torch.as_tensor(mag * st[0]), torch.as_tensor(mag * st[1]))
    wt = torch.as_tensor(w)
    reb = stft(istft(spec, N_FFT, HOP, wt), N_FFT, HOP, wt)
    assert proj_err(po, [None, None, t2n(reb.real), t2n(reb.imag)]) <= 2e-6
    # unit phasors, weighted by |u| of the vector they were normalised from
    scale = np.abs(oo[2]).max()
    u = np.sqrt((oo[2] - MOM * st[2]) ** 2 + (oo[3] - MOM * st[3]) ** 2)
    wgt = np.minimum(1.0, u / scale)
    for i in (0, 1):
        assert (np.abs(po[i] - oo[i]) * wgt).max() <= 1e-5
        assert (np.abs(po[i] - jo[i]) * wgt)[:, inner].max() <= 1e-4
    assert np.abs(np.sqrt(po[0] ** 2 + po[1] ** 2) - 1.0).max() <= 1e-5


def test_plain_j_is_identity_on_a_consistent_spectrogram(gauss):
    """A consistent spectrogram is a fixed point of the projection, on every
    frame (the boundary rule is the STFT's own: trim and reflect-pad; the
    clip is a whole number of hops, which the trim keeps whole)."""
    w = gauss[0]
    x = torch.as_tensor(make_audio(52, batch=1, n=46 * HOP)[:, 0])
    from acids_transforms_tpu_torch.ops.fft import stft

    S = stft(x, N_FFT, HOP, torch.as_tensor(w))
    z = torch.zeros_like(S.real)
    mag = S.abs()
    are, aim = S.real / mag.clamp_min(1e-30), S.imag / mag.clamp_min(1e-30)
    env = pk._env_rows(S.shape[-2], N_FFT, HOP, torch.as_tensor(w))
    _, _, rre, rim = pk.gl_momentum_step_fullk_reference(mag, are, aim, z, z, env, N_FFT, HOP,
                                                          torch.as_tensor(w), 0.0)
    assert rel(t2n(torch.complex(rre, rim)), t2n(S)) <= 1e-5


@pytest.mark.parametrize("window", ["hann", "hamming"])
def test_plain_i_vs_pallas_kernel(window):
    w = np.array(jwin(window, N_FFT))
    taps = jfft.taps_for_window(w)
    mag, (are, aim, _, _) = make_state(w, seed=53)
    jre, jim = jk.gl_project(jnp.asarray(mag), jnp.asarray(are), jnp.asarray(aim), N_FFT, HOP, taps,
                             jnp.asarray(w), interpret=True)
    pre, pim = pk.gl_project(torch.as_tensor(mag), torch.as_tensor(are), torch.as_tensor(aim),
                             N_FFT, HOP, taps, torch.as_tensor(w))
    got, ref = [t2n(pre), t2n(pim)], [np.asarray(jre), np.asarray(jim)]
    scale = max(np.abs(r).max() for r in ref)
    inner = slice(M, -M) if window == "hann" else slice(None)   # hamming: w >= 0.08, every frame
    assert max(np.abs(g - r)[:, inner].max() for g, r in zip(got, ref)) / scale <= 1e-4
    # the projection is the momentum step's R with tprev = 0 ...
    env = pk._env_rows(mag.shape[1], N_FFT, HOP, torch.as_tensor(w))
    z = torch.zeros_like(pre)
    step = pk.gl_momentum_step_reference(torch.as_tensor(mag), torch.as_tensor(are),
                                         torch.as_tensor(aim), z, z, env, N_FFT, HOP, taps, MOM)
    assert torch.equal(step[2], pre) and torch.equal(step[3], pim)
    # ... and its edge frames are as good as float32 allows, against float64
    oo = pk.gl_momentum_step_oracle(torch.as_tensor(mag), torch.as_tensor(are),
                                    torch.as_tensor(aim), z, z, env, N_FFT, HOP, taps, MOM)
    w_min = np.abs(w)[np.abs(w) > 1e-7].min()
    edge = max(np.abs(g - o.numpy()).max() for g, o in zip(got, oo[2:])) / scale
    assert edge <= np.finfo(np.float32).eps / w_min


def test_griffin_lim_takes_the_full_k_step_for_a_window_without_taps(gauss, monkeypatch):
    """``fused=True`` on the CPU runs kernel J's plain version (one step per
    iteration); ``fused=None`` on a CPU tensor and ``fused=False`` take the
    eager loop; no launch is counted off the card."""
    w, mag, _ = gauss
    calls = []
    real = pk.make_gl_momentum_step_fullk

    def spy(*a, **k):
        step, to_rows, from_rows = real(*a, **k)

        def counted(*s):
            calls.append(1)
            return step(*s)

        return counted, to_rows, from_rows

    monkeypatch.setattr(pk, "make_gl_momentum_step_fullk", spy)
    m = torch.as_tensor(mag)
    wt = torch.as_tensor(w)
    g = torch.Generator().manual_seed(0)
    y = pgl.griffin_lim(m, N_FFT, HOP, wt, n_iter=5, generator=g, fused=True)
    assert len(calls) == 5 and y.shape == (2, HOP * (mag.shape[1] - 1))
    pgl.griffin_lim(m, N_FFT, HOP, wt, n_iter=5, generator=torch.Generator().manual_seed(0))
    pgl.griffin_lim(m, N_FFT, HOP, wt, n_iter=5, generator=torch.Generator().manual_seed(0), fused=False)
    assert len(calls) == 5
    with pytest.raises(ValueError, match="fused=True"):
        pgl.griffin_lim(m[..., :129], 256, 48, torch.ones(256), n_iter=2, fused=True)
    assert pk.launches["gl_momentum_fullk"] == 0 and pk.launches["gl_project"] == 0


def test_full_k_and_eager_loops_converge_alike(gauss):
    """Eight iterations of the full-K step and of the eager loop from the
    same random phases on a harmonic clip end within the spectral-convergence
    margin of each other (the two differ on the overlap - 1 edge frames, so
    the clip is long enough for those not to dominate: 235 frames, as the JAX
    package's own test of its kernel takes)."""
    w = torch.as_tensor(gauss[0])
    from acids_transforms_tpu_torch.ops.fft import stft

    t = np.arange(30000) / 44100
    x = sum(np.sin(2 * np.pi * f * t) / (i + 1) for i, f in enumerate([220, 440, 880]))
    x = torch.as_tensor((0.7 * x / np.abs(x).max()).astype(np.float32))[None]
    m = stft(x, N_FFT, HOP, w).abs()

    def sc(y):
        R = stft(y, N_FFT, HOP, w).abs()
        return (torch.linalg.norm(R - m) / torch.linalg.norm(m)).item()

    s_k = sc(pgl.griffin_lim(m, N_FFT, HOP, w, n_iter=8, generator=torch.Generator().manual_seed(1), fused=True))
    s_e = sc(pgl.griffin_lim(m, N_FFT, HOP, w, n_iter=8, generator=torch.Generator().manual_seed(1), fused=False))
    assert s_k < max(1.15 * s_e, s_e + 0.02)


def test_gates_and_tiles():
    assert pk.gl_fullk_available(1024, 256) and pk.gl_fullk_available(512, 64)
    assert not pk.gl_fullk_available(1024, 96)        # hop no multiple of 32
    assert not pk.gl_fullk_available(1024, 1024)      # overlap 1
    assert not pk.gl_fullk_available(4096, 256)       # overlap 16
    assert pk.gl_fullk_available(2048, 256) and pk.gl_fullk_available(4096, 512)
    # blocks of fewer than 8 kRPT chunks where shared memory runs short; none
    # at all where even overlap + 2 chunks exceed it (raises on the card)
    picks = {(1024, 256): (32, 28), (1024, 128): (32, 24), (512, 128): (32, 28),
             (2048, 512): (16, 12), (2048, 256): (15, 7), (4096, 1024): (7, 3),
             (4096, 2048): (7, 5), (4096, 512): None, (8192, 2048): None}
    for (n_fft, hop), pick in picks.items():
        assert pk._pick_fullk_rows(n_fft, hop) == pick
        kp = 2 * ((n_fft // 2 + 1 + 15) // 16) * 16
        if pick is not None:
            rows, tile_t = pick
            assert n_fft // hop + 2 <= rows <= 32 and tile_t == min(32, rows - n_fft // hop)
            assert pk._fullk_smem_bytes(rows, n_fft // hop, hop, kp) <= pk.MAX_SMEM
            if rows < 32:
                assert pk._fullk_smem_bytes(rows + 1, n_fft // hop, hop, kp) > pk.MAX_SMEM
        else:
            assert pk._fullk_smem_bytes(n_fft // hop + 2, n_fft // hop, hop, kp) > pk.MAX_SMEM
    with pytest.raises(ValueError, match="bins"):
        pk.make_gl_momentum_step_fullk(torch.ones(1, 4, 100), N_FFT, HOP, torch.ones(N_FFT), MOM)
