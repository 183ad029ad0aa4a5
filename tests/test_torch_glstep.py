"""The plain PyTorch version of kernels C and D (whole momentum Griffin-Lim
iterations, single and chained) against the JAX package's Pallas kernels in
interpret mode, from the same numpy angles.

On the CPU ``make_gl_momentum_step`` returns exactly this plain version; the
CUDA kernel is held against it on the card by ``chip_smoke.py``.

Frames: the first and last ``overlap - 1`` frames per iteration hold the
signal's first and last samples, where the spectral-domain windowing cancels
and the division by the envelope ``w^2`` amplifies rounding by ``1 / w``
(``ops/cuda/glstep.py``).  With hann (``w[1] = 3.8e-5`` at n_fft 512) the JAX
kernel's bf16x3 products are 7e-3 off a float64 oracle there and the port's
fp32 ones 3e-4, so under hann the comparisons run on the interior frames
(``test_hann_edge_frames_differ_by_rounding_only`` holds those numbers).
Under hamming (``w >= 0.08``) nothing is amplified and every frame is
compared, edges included: that is where the boundary rule (zero rows outside
``[0, T)``, un-trimmed signal re-framed in place, envelope of the true frames)
is held against the JAX kernel and the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.griffinlim import griffin_lim as jgl
from acids_transforms_tpu.ops.pallas import glstep as jk
from acids_transforms_tpu.ops.windows import get_window as jwin
from acids_transforms_tpu_torch.ops import griffinlim as pgl_mod
from acids_transforms_tpu_torch.ops.cuda import glstep as pk
from acids_transforms_tpu_torch.ops.fft import stft as pstft
from test_torch_common import HOP, N_FFT, make_audio, rel, t2n

MOM = 0.99 / 1.99
M = N_FFT // HOP - 1


def make_state(window_name):
    rng = np.random.default_rng(21)
    x = make_audio(21, batch=2, n=9000)[:, 0]
    w = np.asarray(jwin(window_name, N_FFT))
    taps = jfft.taps_for_window(w)
    mag = np.abs(np.asarray(jfft.stft(jnp.asarray(x), N_FFT, HOP, jnp.asarray(w)))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    tre = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    tim = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    return w, taps, mag, (np.cos(ph), np.sin(ph), tre, tim)


@pytest.fixture(scope="module")
def state():
    return make_state("hann")


def run_jax(w, taps, mag, st, iters):
    step, to_rows, from_rows = jk.make_gl_momentum_step(
        jnp.asarray(mag), N_FFT, HOP, taps, jnp.asarray(w), MOM, iters=iters)
    return [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]


def run_port(w, taps, mag, st, iters):
    step, to_rows, from_rows = pk.make_gl_momentum_step(
        torch.as_tensor(mag.copy()), N_FFT, HOP, taps, torch.as_tensor(w.copy()), MOM, iters=iters)
    return [t2n(from_rows(o)) for o in step(*[to_rows(torch.as_tensor(a.copy())) for a in st])]


def run_oracle(w, taps, mag, st, iters):
    env = pk._env_rows(mag.shape[1], N_FFT, HOP, torch.as_tensor(w.copy()))
    out = pk.gl_momentum_step_oracle(
        torch.as_tensor(mag.copy()), *[torch.as_tensor(a.copy()) for a in st], env,
        N_FFT, HOP, taps, MOM, iters)
    return [t2n(o) for o in out]


def inner(a, k):
    return a[:, k * M: a.shape[1] - k * M]


def edges(a, k):
    return np.concatenate([a[:, : k * M], a[:, a.shape[1] - k * M:]], axis=1)


def projection_err(got, ref, pick):
    """max-abs difference of both projection outputs on the picked frames over
    the max-abs of the whole reference projection."""
    scale = max(np.abs(ref[2]).max(), np.abs(ref[3]).max())
    return max(np.abs(pick(got[i]) - pick(ref[i])).max() for i in (2, 3)) / scale


# one invocation of 1 / 2 / 4 iterations.  1e-4 holds for a single
# iteration; chained ones are a chaotic map fed the JAX side's 1e-5 bf16x3
# rounding (tests/test_gl_parity.py: 1e-7 grows to 1.3e-4 in five
# iterations), hence 1e-3 there, the bound that file uses for four iterations.
@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (2, 1e-3), (4, 1e-3)])
def test_plain_step_vs_pallas_kernel(state, iters, tol):
    w, taps, mag, st = state
    jo = run_jax(w, taps, mag, st, iters)
    po = run_port(w, taps, mag, st, iters)
    for i in (2, 3):                                    # the projection outputs
        assert po[i].shape == jo[i].shape
        assert rel(inner(po[i], iters), inner(jo[i], iters)) <= tol
    # unit phasors, weighted by |u| of the vector they were normalised from
    # (the direction of a vanishing u amplifies rounding without bound)
    scale = max(np.abs(jo[2]).max(), np.abs(jo[3]).max())
    wgt = np.minimum(1.0, np.sqrt(po[2] ** 2 + po[3] ** 2) / scale)
    for i in (0, 1):
        d = np.abs(po[i] - jo[i]) * wgt
        assert inner(d, iters).max() <= 10 * tol
        assert inner(np.abs(po[i] - jo[i]), iters).mean() <= 10 * tol
    n = np.sqrt(po[0] ** 2 + po[1] ** 2)
    assert np.abs(n - 1.0).max() <= 1e-5                # unit modulus


# the boundary rule, on every frame: hamming never falls below 0.08, so the
# edge frames are as well conditioned as the interior and are held to the
# same tolerances as above, against the JAX kernel and the float64 oracle
@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (2, 1e-3), (4, 1e-3)])
def test_edge_frames_hold_the_boundary_rule_under_hamming(iters, tol):
    w, taps, mag, st = make_state("hamming")
    assert np.abs(w).min() >= 0.079
    jo = run_jax(w, taps, mag, st, iters)
    po = run_port(w, taps, mag, st, iters)
    oo = run_oracle(w, taps, mag, st, iters)
    everything = lambda a: a
    assert projection_err(po, jo, everything) <= tol
    assert projection_err(po, oo, everything) <= tol / 10
    assert projection_err(po, oo, lambda a: edges(a, iters)) <= tol / 10
    wgt = np.minimum(1.0, np.sqrt(oo[2] ** 2 + oo[3] ** 2) / np.abs(oo[2]).max())
    for i in (0, 1):
        assert (np.abs(po[i] - oo[i]) * wgt).max() <= tol


def test_hann_edge_frames_differ_by_rounding_only(state):
    """Why the hann comparisons leave the edge frames out: against the float64
    oracle both packages are right on the interior, and on the edge frames
    each is off by its own product rounding over the window's smallest value
    (fp32 1.2e-7, bf16x3 about 1e-5; ``w[1] = 3.8e-5``), the JAX kernel far
    beyond the 1e-4 the comparison allows."""
    w, taps, mag, st = state
    w_min = np.abs(w)[np.abs(w) > 1e-7].min()
    jo = run_jax(w, taps, mag, st, 1)
    po = run_port(w, taps, mag, st, 1)
    oo = run_oracle(w, taps, mag, st, 1)
    assert projection_err(po, oo, lambda a: inner(a, 1)) <= 1e-5
    assert projection_err(jo, oo, lambda a: inner(a, 1)) <= 1e-4
    port_edge = projection_err(po, oo, lambda a: edges(a, 1))
    jax_edge = projection_err(jo, oo, lambda a: edges(a, 1))
    assert port_edge <= np.finfo(np.float32).eps / w_min          # 3.1e-3; measured 2.8e-4
    assert 1e-3 < jax_edge <= 1e-5 / w_min                        # measured 7.3e-3
    assert jax_edge > 10 * port_edge


@pytest.mark.parametrize("k", [2, 4])
def test_chain_equals_k_single_steps(state, k):
    w, taps, mag, st = state
    chained = run_port(w, taps, mag, st, k)
    cur = st
    for _ in range(k):
        cur = run_port(w, taps, mag, cur, 1)
    for a, b in zip(chained, cur):
        assert rel(a, b) <= 1e-5
    # the reference function itself, called directly with its envelope
    env = pk._env_rows(mag.shape[1], N_FFT, HOP, torch.as_tensor(w.copy()))
    direct = pk.gl_momentum_step_reference(
        torch.as_tensor(mag.copy()), *[torch.as_tensor(a.copy()) for a in st], env,
        N_FFT, HOP, taps, MOM, iters=k)
    for a, b in zip(chained, direct):
        assert np.array_equal(a, t2n(b))


def test_projection_is_identity_on_a_consistent_spectrogram():
    x = torch.as_tensor(make_audio(22, batch=1, n=8000)[:, 0])
    for name in ("hann", "blackman"):
        w = torch.as_tensor(np.asarray(jwin(name, N_FFT)).copy())
        taps = jfft.taps_for_window(t2n(w))
        S = pstft(x, N_FFT, HOP, w)
        env = pk._env_rows(S.shape[-2], N_FFT, HOP, w)
        rre, rim = pk._project(torch.ones_like(S.real), S.real, S.imag, env, N_FFT, HOP, taps)
        got = np.stack([t2n(rre), t2n(rim)])
        ref = np.stack([t2n(S.real), t2n(S.imag)])
        assert rel(got[:, :, M:-M], ref[:, :, M:-M]) <= 1e-5


def test_blackman_edge_stays_bounded_where_the_jax_kernel_blows_up():
    """Periodic blackman has w[0] = -1.4e-17: its square passes the JAX
    package's ``env > tiny`` rule, and dividing the un-trimmed signal's first
    sample by 1.9e-34 blows its frame 0 up.  The port floors the envelope at
    eps^2 (``_env_rows``) and stays bounded."""
    rng = np.random.default_rng(23)
    x = make_audio(23, batch=1, n=6000)[:, 0]
    w = np.asarray(jwin("blackman", N_FFT))
    assert 0 < float(w[0]) ** 2 < 1e-30
    taps = jfft.taps_for_window(w)
    mag = np.abs(np.asarray(jfft.stft(jnp.asarray(x), N_FFT, HOP, jnp.asarray(w)))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    z = np.zeros_like(mag)
    st = (np.cos(ph), np.sin(ph), z, z)
    po = run_port(w, taps, mag, st, 1)
    jo = run_jax(w, taps, mag, st, 1)
    assert np.isfinite(po[2]).all() and np.abs(po[2]).max() <= 10 * mag.max()
    assert np.abs(jo[2][:, 0]).max() > 1e6 * mag.max()   # the JAX kernel's frame 0
    assert rel(inner(po[2], 1), inner(jo[2], 1)) <= 1e-4  # interior frames agree


def test_availability_limits_are_the_ports_own():
    taps = (0.5, -0.25)
    assert pk.gl_project_available(1024, 256, taps)
    assert pk.gl_project_available(512, 128, taps)
    assert pk.gl_project_available(512, 64, taps)         # overlap 8: the halo limit
    assert pk.gl_project_available(256, 32, taps)         # hop 32: no 128-lane rule here
    assert not jk.gl_project_available(256, 32, taps)     # (the TPU's lane rule)
    assert not pk.gl_project_available(512, 32, taps)     # overlap 16
    assert not pk.gl_project_available(512, 48, taps)     # hop does not divide n_fft
    assert not pk.gl_project_available(480, 120, taps)    # hop % 32
    assert not pk.gl_project_available(512, 128, None)
    # shared memory is no silent gate: the chain shortens until the window
    # fits, and a window that never fits is for the step factory to refuse
    assert pk.gl_project_available(8192, 2048, taps)
    assert pk.gl_max_chain(8192, 2048, 4) == 1
    assert pk.gl_max_chain(1024, 256, 4) == 4 and pk.gl_max_chain(512, 64, 3) == 3
    assert pk._pick_tile(690, 1, 4, 4096) is None
    for chain, tile in ((1, 115), (4, 99)):               # widest fitting tile, evened out
        assert pk._pick_tile(690, chain, 4, 256) == tile
        assert pk._smem_bytes(tile, chain, 4, 256) <= pk.MAX_SMEM
        assert pk._smem_bytes(tile + 8, chain, 4, 256) > pk.MAX_SMEM or tile + 8 > 128
    assert pk._pick_tile(47, 4, 4, 128) == 47            # a short clip is one tile


def test_kernel_loop_chain_and_remainder_logic(monkeypatch, state):
    w, taps, mag, st = state
    calls = []
    real = pk.make_gl_momentum_step

    def counting(*a, **kw):
        step, tr, fr = real(*a, **kw)
        iters = kw.get("iters", 1)

        def counted(*s):
            calls.append(iters)
            return step(*s)

        return counted, tr, fr

    monkeypatch.setattr(pk, "make_gl_momentum_step", counting)
    wt = torch.as_tensor(w.copy())
    m = torch.as_tensor(mag.copy())
    ph = torch.as_tensor(np.arctan2(st[1], st[0]))
    for n_iter, expect in ((6, [4, 1, 1]), (8, [4, 4]), (1, [1]), (3, [3]), (5, [4, 1])):
        calls.clear()
        rec = pgl_mod.griffin_lim(m, N_FFT, HOP, wt, n_iter=n_iter, init_phase=ph, taps=taps, fused=True)
        assert calls == expect, (n_iter, calls)
        assert rec.shape == (2, HOP * (mag.shape[1] - 1)) and torch.isfinite(rec).all()
    assert pgl_mod.GL_CHAIN == 4
    calls.clear()
    pgl_mod.griffin_lim(m, N_FFT, HOP, wt, n_iter=2, init_phase=ph, taps=taps)  # auto on the CPU: eager
    assert calls == []
    # without taps the full-K step (kernel J) takes the shape, not this one;
    # a shape no step covers raises
    rec = pgl_mod.griffin_lim(m, N_FFT, HOP, wt, n_iter=2, init_phase=ph, taps=None, fused=True)
    assert calls == [] and rec.shape == (2, HOP * (mag.shape[1] - 1))
    with pytest.raises(ValueError, match="fused=True"):
        pgl_mod.griffin_lim(m[..., :129], 256, 48, torch.ones(256), n_iter=2, taps=None, fused=True)
    assert all(v == 0 for v in pk.launches.values())  # nothing launched on the CPU


def test_kernel_loop_vs_jax_kernel_loop_and_eager_loop(state):
    w, taps, mag, st = state
    ph = np.arctan2(st[1], st[0]).astype(np.float32)
    wt, m = torch.as_tensor(w.copy()), torch.as_tensor(mag.copy())
    rec_p = t2n(pgl_mod.griffin_lim(m, N_FFT, HOP, wt, n_iter=6, init_phase=torch.as_tensor(ph),
                                    taps=taps, fused=True))
    rec_e = t2n(pgl_mod.griffin_lim(m, N_FFT, HOP, wt, n_iter=6, init_phase=torch.as_tensor(ph),
                                    taps=taps, fused=False))
    rec_j = np.asarray(jgl(jnp.asarray(mag), N_FFT, HOP, jnp.asarray(w), n_iter=6,
                           init_phase=jnp.asarray(ph), taps=taps, fused=True))

    def sc(rec):
        R = np.abs(t2n(pstft(torch.as_tensor(np.array(rec)), N_FFT, HOP, wt)))
        return np.linalg.norm(R - mag) / np.linalg.norm(mag)

    s_p, s_e, s_j = sc(rec_p), sc(rec_e), sc(rec_j)
    assert s_p < max(1.15 * s_e, s_e + 0.02)             # the margin of tests/test_gl_parity.py
    assert abs(s_p - s_j) <= 0.01                         # same quality as the JAX kernel loop
    with pytest.raises(ValueError):
        pk.make_gl_momentum_step(m[0], N_FFT, HOP, taps, wt, MOM)
    with pytest.raises(ValueError):
        pk.make_gl_momentum_step(m[..., :-1], N_FFT, HOP, taps, wt, MOM)
