"""Kernels C, D and I on the FFT route (``csrc/glstep.cu:gl_step_fft_kernel``,
every power-of-two n_fft from 64 to 4096) through their plain version,
``ops/cuda/glstep.py:_project_fft`` (``frames_irfft_reference`` under the
taps' window over n_fft, plus ``Im(Y_0)`` times the leak table, the
overlap-add in class order, the envelope, the in-place framing,
``frames_rfft_reference``), which repeats the kernel's float32 operations in
order; on the card ``chip_smoke.py`` holds the kernel to it.

Tolerances, and why:

* against the JAX package's Pallas kernels in interpret mode (512/128: the
  JAX kernels need hop % 128 == 0): 1e-4 for one iteration, 1e-3 for chains
  (a chaotic map fed the JAX side's bf16x3 rounding), on the interior frames
  under hann and on every frame under hamming, as ``test_torch_glstep.py``;
* against the float64 oracle (``gl_momentum_step_oracle``): 1e-5 of the
  largest value on every frame, edge frames included.  The product route's
  spectral-domain window cancels there and is off by up to 1e-3 under hann;
  the FFT route's time-domain window does not, so its edge frames are at
  least as close as the product's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.pallas import glstep as jk
from acids_transforms_tpu.ops.windows import get_window as jwin
from acids_transforms_tpu_torch.ops.cuda import glstep as pk
from acids_transforms_tpu_torch.ops.cuda.frames_fft import (
    fft_covers,
    frames_irfft_reference,
    frames_rfft_reference,
    irfft_window,
    overlap_add_classes,
)
from test_torch_common import make_audio, t2n

MOM = 0.99 / 1.99


def make_state(window_name, n_fft, hop, seed=31, n=6000):
    """Magnitudes of a seeded clip, random unit angles (so Im(Y_0) != 0) and a
    random previous projection, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = make_audio(seed, batch=2, n=n)[:, 0]
    w = np.asarray(jwin(window_name, n_fft))
    taps = jfft.taps_for_window(w)
    mag = np.abs(np.asarray(jfft.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(w)))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    tre = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    tim = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    return w, taps, mag, (np.cos(ph), np.sin(ph), tre, tim)


def tensors(*arrays):
    return [torch.as_tensor(np.array(a, copy=True)) for a in arrays]


def env_of(w, mag, n_fft, hop):
    return pk._env_rows(mag.shape[1], n_fft, hop, torch.as_tensor(np.array(w, copy=True)))


def run_port(w, taps, mag, st, n_fft, hop, iters):
    step, to_rows, from_rows = pk.make_gl_momentum_step(
        *tensors(mag), n_fft, hop, taps, *tensors(w), MOM, iters=iters)
    return [t2n(from_rows(o)) for o in step(*[to_rows(a) for a in tensors(*st)])]


def run_jax(w, taps, mag, st, n_fft, hop, iters):
    step, to_rows, from_rows = jk.make_gl_momentum_step(
        jnp.asarray(mag), n_fft, hop, taps, jnp.asarray(w), MOM, iters=iters)
    return [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]


def run_oracle(w, taps, mag, st, n_fft, hop, iters=1):
    out = pk.gl_momentum_step_oracle(*tensors(mag, *st), env_of(w, mag, n_fft, hop), n_fft, hop, taps,
                                     MOM, iters)
    return [t2n(o) if o.dtype != torch.float64 else o.numpy() for o in out]


def projection_err(got, ref, frames=slice(None)):
    scale = max(np.abs(ref[2]).max(), np.abs(ref[3]).max())
    return max(np.abs(np.float64(got[i][:, frames]) - np.float64(ref[i][:, frames])).max() for i in (2, 3)) / scale


def test_the_route_is_the_fft_schedule_where_fft_covers():
    """On the CPU the step's plain version is the FFT schedule at a power of
    two and the chunk products elsewhere, chosen by n_fft alone."""
    w, taps, mag, st = make_state("hann", 256, 64, n=3000)
    env = env_of(w, mag, 256, 64)
    a = pk.gl_momentum_step_reference(*tensors(mag, *st), env, 256, 64, taps, MOM)
    b = pk._project_fft(*tensors(mag, st[0], st[1]), env, 256, 64, taps)
    assert fft_covers(256) and torch.equal(a[2], b[0]) and torch.equal(a[3], b[1])
    assert not fft_covers(768) and not fft_covers(8192)
    r = pk.gl_project_reference(*tensors(mag, st[0], st[1]), 256, 64, taps, *tensors(w))
    assert torch.equal(r[0], b[0]) and torch.equal(r[1], b[1])


@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (2, 1e-3), (4, 1e-3)])
@pytest.mark.parametrize("window", ["hann", "hamming"])
def test_fft_step_vs_pallas_kernels(window, iters, tol):
    """C (iters 1) and D (chains) against the JAX kernels: interior frames
    under hann (its edge frames are the JAX kernel's bf16x3 rounding over w ~
    4e-5), every frame under hamming (w >= 0.08)."""
    w, taps, mag, st = make_state(window, 512, 128)
    jo = run_jax(w, taps, mag, st, 512, 128, iters)
    po = run_port(w, taps, mag, st, 512, 128, iters)
    m = 3 * iters
    frames = slice(m, mag.shape[1] - m) if window == "hann" else slice(None)
    assert projection_err(po, jo, frames) <= tol
    scale = max(np.abs(jo[2]).max(), np.abs(jo[3]).max())
    wgt = np.minimum(1.0, np.sqrt(po[2] ** 2 + po[3] ** 2) / scale)
    for i in (0, 1):
        assert (np.abs(po[i] - jo[i]) * wgt)[:, frames].max() <= 10 * tol
    assert np.abs(np.sqrt(po[0] ** 2 + po[1] ** 2) - 1.0).max() <= 1e-5


@pytest.mark.parametrize("n_fft,hop,window", [(512, 128, "hann"), (256, 64, "hann"), (256, 64, "blackman"),
                                              (512, 128, "hamming"), (128, 32, "hann")])
def test_edge_frames_against_the_float64_oracle(n_fft, hop, window):
    """Every frame of one step within 1e-5 of the float64 oracle, and the
    edge frames (the first and last overlap - 1) no further from it than the
    product route's (``_project``), which the spectral-domain window
    amplifies there."""
    w, taps, mag, st = make_state(window, n_fft, hop, n=4000)
    env = env_of(w, mag, n_fft, hop)
    oo = run_oracle(w, taps, mag, st, n_fft, hop)
    po = run_port(w, taps, mag, st, n_fft, hop, 1)
    assert projection_err(po, oo) <= 1e-5
    prod = [None, None] + [t2n(x) for x in pk._project(*tensors(mag, st[0], st[1]), env, n_fft, hop, taps)]
    m = n_fft // hop - 1
    for edge in (slice(0, m), slice(mag.shape[1] - m, None)):
        assert projection_err(po, oo, edge) <= projection_err(prod, oo, edge)
    # the new angles, weighted by |u| (their direction is undefined where u vanishes)
    u = np.sqrt((oo[2] - MOM * st[2]) ** 2 + (oo[3] - MOM * st[3]) ** 2)
    for i in (0, 1):
        assert (np.abs(po[i] - oo[i]) * u / u.max()).max() <= 1e-5


def test_the_leak_of_bin_0s_imaginary_part():
    """Random angles give Im(Y_0) != 0: the taps conv carries it into bins
    1..P (the oracle's ``leak``), an inverse real FFT drops it.  With the
    leak table the FFT route meets the oracle and the JAX kernel; the same
    schedule without the term misses both by far more than the tolerance."""
    n_fft, hop = 512, 128
    w, taps, mag, st = make_state("hamming", n_fft, hop)
    assert np.abs(mag[..., 0] * st[1][..., 0]).max() > 1e-2 * mag.max()
    env = env_of(w, mag, n_fft, hop)
    oo = run_oracle(w, taps, mag, st, n_fft, hop)
    jo = run_jax(w, taps, mag, st, n_fft, hop, 1)
    with_leak = [None, None] + [t2n(x) for x in pk._project_fft(*tensors(mag, st[0], st[1]), env, n_fft, hop, taps)]
    assert projection_err(with_leak, oo) <= 1e-5 and projection_err(with_leak, jo) <= 1e-4
    taps_t = tuple(float(t) for t in taps)
    table = pk._leak_table(taps_t, n_fft)
    ang = 2 * np.pi * np.arange(n_fft) / n_fft
    direct = -(2.0 / n_fft) * sum(taps_t[p] * np.sin(p * ang) for p in range(1, len(taps_t)))
    assert np.abs(table - direct).max() <= 1e-7 * np.abs(direct).max()
    # the same schedule without the term
    w_t, = tensors(pk.taps_window(taps_t, n_fft))
    m_t, are_t, aim_t = tensors(mag, st[0], st[1])
    frames = pk._fft_frames(m_t, are_t, aim_t, n_fft, hop, w_t)
    sig = overlap_add_classes(frames, hop) / env.reshape(-1)
    no_leak = [None, None] + [t2n(x) for x in frames_rfft_reference(sig.unfold(-1, n_fft, hop), w_t)]
    assert projection_err(no_leak, oo) > 1e-3 and projection_err(no_leak, jo) > 1e-3
    # a state with Im(Y_0) = 0 needs no leak: both agree bit for bit
    st0 = (st[0].copy(), st[1].copy())
    st0[0][..., 0], st0[1][..., 0] = 1.0, 0.0
    a = pk._project_fft(*tensors(mag, *st0), env, n_fft, hop, taps)
    frames0 = pk._fft_frames(*tensors(mag, *st0), n_fft, hop, w_t)
    sig0 = overlap_add_classes(frames0, hop) / env.reshape(-1)
    b = frames_rfft_reference(sig0.unfold(-1, n_fft, hop), w_t)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_chain_equals_k_single_steps_bit_for_bit(k):
    """D is k iterations of C: the chained plain version, the CPU step of a
    chain and k single steps give the same bits."""
    n_fft, hop = 256, 64
    w, taps, mag, st = make_state("hann", n_fft, hop, n=3000)
    chained = run_port(w, taps, mag, st, n_fft, hop, k)
    cur = st
    for _ in range(k):
        cur = run_port(w, taps, mag, cur, n_fft, hop, 1)
    assert all(np.array_equal(a, b) for a, b in zip(chained, cur))
    direct = pk.gl_momentum_step_reference(*tensors(mag, *st), env_of(w, mag, n_fft, hop), n_fft, hop, taps,
                                           MOM, iters=k)
    assert all(np.array_equal(a, t2n(b)) for a, b in zip(chained, direct))


def emulate_blocks(mag, are, aim, env, n_fft, hop, taps, tile_t, lead):
    """The FFT route's projection block by block, as ``gl_step_fft_kernel``
    computes it: a block owns ``tile_t`` frames ``t0 ..`` and the chunks
    ``t0 .. t0 + tile_t + overlap - 2``, synthesizes its own frames from
    ``t0 - lead`` on with ``frames_irfft_reference`` (pairs (r, r + overlap)
    of its local numbering, so ``lead = overlap`` keeps the clip's pairs),
    adds them into its chunks in class order, divides by the envelope and
    analyses its frames in pairs (2j, 2j + 1) from t0."""
    ov = n_fft // hop
    B, T, F = mag.shape
    taps = tuple(float(t) for t in taps)
    w = torch.as_tensor(pk.taps_window(taps, n_fft))
    leak = torch.as_tensor(pk._leak_table(taps, n_fft))
    env = env.reshape(-1)
    rre, rim = torch.empty_like(mag), torch.empty_like(mag)
    R = tile_t + ov - 1
    for t0 in range(0, T, tile_t):
        f0 = t0 - lead
        n_fr = min(tile_t + 2 * ov, T - f0)
        idx = torch.arange(f0, f0 + n_fr)
        ok = (idx >= 0)[None, :, None]
        take = idx.clamp_min(0)
        re = torch.where(ok, mag[:, take] * are[:, take], torch.zeros(()))
        im = torch.where(ok, mag[:, take] * aim[:, take], torch.zeros(()))
        frames = frames_irfft_reference(re, im, irfft_window(w, n_fft), ov)
        lam = torch.where(ok[..., 0], mag[:, take, 0] * aim[:, take, 0], torch.zeros(()))
        frames = frames + lam[..., None] * leak
        buf = torch.zeros((B, R * hop))
        for c in range(ov):                            # class f mod ov, in order
            for r in range(n_fr):
                f = f0 + r
                if f < 0 or f % ov != c:
                    continue
                p0 = (f - t0) * hop                    # the frames of a class do not overlap
                lo, hi = max(0, -p0), min(n_fft, R * hop - p0)
                if hi > lo:
                    buf[:, p0 + lo: p0 + hi] = buf[:, p0 + lo: p0 + hi] + frames[:, r, lo:hi]
        chunks = torch.arange(t0, t0 + R)
        live = (chunks < T + ov - 1)
        e = env[(chunks.clamp_max(T + ov - 2) * hop)[:, None] + torch.arange(hop)[None, :]].reshape(-1)
        buf = torch.where(live.repeat_interleave(hop)[None, :], buf / e, buf)
        n_t = min(tile_t, T - t0)
        fr = buf.unfold(-1, n_fft, hop)[:, :n_t]
        xr, xi = frames_rfft_reference(fr, w)
        rre[:, t0:t0 + n_t], rim[:, t0:t0 + n_t] = xr, xi
    return rre, rim


def test_blocks_keep_the_session_wide_pairing():
    """Emulating the kernel's blocks gives the whole-clip plain version bit
    for bit, at every tile height the plan could pick (multiples of 2
    overlap): each block synthesizes its frames from t0 - overlap on, so its
    pairs are the clip's.  A block that started its frames at t0 - (overlap -
    1) (the halo a chain shrinking by overlap - 1 frames an iteration would
    use) pairs other frames and does not round alike."""
    n_fft, hop = 256, 64
    ov = n_fft // hop
    w, taps, mag, st = make_state("hann", n_fft, hop, n=2600)
    m_t, are_t, aim_t = tensors(mag, st[0], st[1])
    env = env_of(w, mag, n_fft, hop)
    whole = pk._project_fft(m_t, are_t, aim_t, env, n_fft, hop, taps)
    T = mag.shape[1]
    assert T % (2 * ov) != 0                          # a ragged last block
    for tile_t in (2 * ov, 4 * ov):
        got = emulate_blocks(m_t, are_t, aim_t, env, n_fft, hop, taps, tile_t, lead=ov)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    moved = emulate_blocks(m_t, are_t, aim_t, env, n_fft, hop, taps, 2 * ov, lead=ov - 1)
    assert not (torch.equal(moved[0], whole[0]) and torch.equal(moved[1], whole[1]))
    scale = whole[0].abs().max()
    assert max((moved[i] - whole[i]).abs().max() for i in (0, 1)) <= 1e-5 * scale
    # the chain's iterations are whole-clip steps over such blocks: two of
    # them, the state between through "device memory", equal the plain chain
    s1 = pk.gl_momentum_step_reference(m_t, are_t, aim_t, *tensors(st[2], st[3]), env, n_fft, hop, taps, MOM)
    r2 = emulate_blocks(m_t, s1[0], s1[1], env, n_fft, hop, taps, 2 * ov, lead=ov)
    s2 = pk.gl_momentum_step_reference(m_t, are_t, aim_t, *tensors(st[2], st[3]), env, n_fft, hop, taps, MOM,
                                       iters=2)
    assert torch.equal(r2[0], s2[2]) and torch.equal(r2[1], s2[3])


def test_plans_routes_and_no_launch_on_the_cpu():
    """The FFT route's block: tile heights a multiple of 2 overlap whose
    shared memory fits (two blocks an SM at 1024/256: 56 frames, 4 FFTs);
    chains need no shared memory of their own on that route; nothing is
    launched or counted on the CPU."""
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        for ov in (2, 4, 8):
            hop = n_fft // ov
            if hop % 32:
                continue
            tile_t, teams = pk._step_fft_plan(n_fft, hop)
            assert tile_t % (2 * ov) == 0 and teams >= 1
            assert pk._fft_smem_bytes(tile_t, ov, hop, teams) <= pk.MAX_SMEM
            assert pk.gl_max_chain(n_fft, hop, 4) == 4
    assert pk._step_fft_plan(1024, 256) == (56, 4)
    assert pk._fft_smem_bytes(56, 4, 256, 4) <= 233472 // 2 - 1024
    pk.reset_launches()
    w, taps, mag, st = make_state("hann", 256, 64, n=2000)
    run_port(w, taps, mag, st, 256, 64, 2)
    pk.gl_project(*tensors(mag, st[0], st[1]), 256, 64, taps, *tensors(w))
    assert not any(pk.launches.values()) and not any(pk.routes.values())
    assert {"gl_momentum_step:fft", "gl_momentum_chain:fft", "gl_project:fft",
            "gl_momentum_step:product", "gl_momentum_chain:product", "gl_project:product"} <= set(pk.routes)
