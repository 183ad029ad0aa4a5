"""O's Griffin-Lim polish as one launch a chunk: ``csrc/stream_step.cu:
gl_polish_fft_kernel`` runs every projection of a chunk's grid (the
synthesis through ``frames_irfft`` into an overlap-add signal in shared
memory, then ``frames_rfft`` of the re-framed rows and ``atan2``) where n_fft
is a power of two from 64 to 4096 and ``stream_step._polish_plan`` fits the
grid; elsewhere the polish stays ``gl_iterations`` two-launch projections.
Its plain version, ``stream_step.gl_polish_reference``, repeats the kernel's
schedule (the decode's synthesis, pairs ``(2j, 2j + 1)`` from the first
polished row); ``chip_smoke.py`` holds the kernel to it on the card.

Tolerances, and why:

* against ``iters`` two-launch projections (``gl_project_reference``) and
  against as many of the JAX package's projections
  (``RealtimeSTFT.pghi_gl_stream``'s, written from its operations):
  ``|X| (cos, sin)(phase)`` within 1e-4 of the largest ``|X|``, the bound
  ``test_torch_stream_pghi_gl.py`` holds one projection to;
* the pinned, frozen and zero rows: bit for bit;
* the CPU session route against the port's generic scan with a generator in
  the same state: spectral convergence within ``1.1 s + 1e-3`` of the scan's
  (``bench.py:582, 664``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.fft import irfft_frames as j_irfft, rfft_frames as j_rfft
from acids_transforms_tpu.ops.framing import frame as j_frame, overlap_add as j_ola
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.cuda.frames_fft import fft_covers, fft_max_teams
from test_torch_common import make_audio, t2n
from test_torch_streaming import spectral_convergence

torch.set_num_threads(1)
ITERS = 4
T_C = 8
SHAPES = [(512, 128), (1024, 256)]


def rt_pair(n_fft, hop, la):
    kw = dict(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl", gl_iterations=ITERS, lookahead_frames=la)
    return JT.RealtimeSTFT(**kw), PT.RealtimeSTFT(device="cpu", **kw)


def grid(n_fft, hop, la, sessions, seed):
    """A polish grid: ``gl_context + T_c + la`` frames of magnitudes and
    phases (unwrapped up to 30 rad), then ``overlap - 1`` zero frames."""
    ov, F = n_fft // hop, n_fft // 2 + 1
    Tx = 3 + T_C + la
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((sessions, Tx + ov - 1, F))).astype(np.float32)
    ph = rng.uniform(-30.0, 30.0, mag.shape).astype(np.float32)
    mag[:, Tx:] = 0.0
    ph[:, Tx:] = 0.0
    return mag, ph, Tx


def unit_err(mag, a, b):
    u = lambda p: np.stack([mag * np.cos(p), mag * np.sin(p)])  # noqa: E731
    return float(np.abs(u(np.float64(a)) - u(np.float64(b))).max() / mag.max())


def jax_project(jrt, mag_ext, ph_ext, T_out, n_fft, hop):
    """The JAX package's projection of ``RealtimeSTFT.pghi_gl_stream``, one
    iteration with its keep-mask, written from its own operations."""
    ctx, la = jrt.gl_context, jrt.lookahead_frames
    overlap = n_fft // hop
    y = j_ola(j_irfft(mag_ext * jnp.exp(1j * ph_ext), n_fft=n_fft) * jrt.inv_window, hop) / overlap
    fr = j_frame(y, n_fft, hop, -1)[..., : mag_ext.shape[-2], :]
    new = jnp.angle(j_rfft(fr * jrt.window))
    idx = jnp.arange(mag_ext.shape[-2])
    freeze_n = max(0, min(overlap - 1 - la, T_out))
    keep = (idx < ctx) | ((idx >= ctx + T_out - freeze_n) & (idx < ctx + T_out))
    return jnp.where(keep[:, None], ph_ext, new)


@pytest.mark.parametrize("la", [0, 4])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_polish_plain_version_vs_two_launch_projections(n_fft, hop, la):
    """``gl_polish_reference`` against ``iters`` calls of
    ``gl_project_reference`` on 3 sessions; the rows the polish leaves alone
    keep their bits; the CPU wrapper runs exactly the plain version."""
    _, prt = rt_pair(n_fft, hop, la)
    mag, ph, Tx = grid(n_fft, hop, la, 3, seed=n_fft + la)
    ctx = prt.gl_context
    lo, hi = prt.gl_frozen(T_C)
    m, p = torch.as_tensor(mag), torch.as_tensor(ph)
    got = PK.gl_polish_reference(m, p, prt.inv_window, prt.window, n_fft, hop, ctx, lo, hi, ITERS)
    ref = p.clone()
    for _ in range(ITERS):
        ref = PK.gl_project_reference(m, ref, prt.inv_window, prt.window, n_fft, hop, ctx, lo, hi)
    assert unit_err(mag, t2n(got), t2n(ref)) <= 1e-4
    g = t2n(got)
    assert np.array_equal(g[:, :ctx], ph[:, :ctx]) and np.array_equal(g[:, lo:hi], ph[:, lo:hi])
    assert np.array_equal(g[:, Tx:], ph[:, Tx:]) and not np.array_equal(g[:, ctx:lo], ph[:, ctx:lo])
    assert (hi - lo) == max(0, n_fft // hop - 1 - la)
    wrapped = PK.gl_polish(m, p.clone(), None, prt.inv_window, prt.window, None, None, n_fft, hop, ctx, lo,
                           hi, ITERS)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("la", [0, 4])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_polish_plain_version_vs_jax_projections(n_fft, hop, la):
    """``gl_polish_reference`` against the JAX package's projection, once and
    ``iters`` times, on 2 sessions."""
    jrt, prt = rt_pair(n_fft, hop, la)
    mag, ph, Tx = grid(n_fft, hop, la, 2, seed=7 * n_fft + la)
    ctx = prt.gl_context
    lo, hi = prt.gl_frozen(T_C)
    m, p = torch.as_tensor(mag), torch.as_tensor(ph)
    ref = jnp.asarray(ph[:, :Tx])
    for iters in range(1, ITERS + 1):
        ref = jax_project(jrt, jnp.asarray(mag[:, :Tx]), ref, T_C, n_fft, hop)
        if iters in (1, ITERS):
            got = PK.gl_polish_reference(m, p, prt.inv_window, prt.window, n_fft, hop, ctx, lo, hi, iters)
            assert unit_err(mag[:, :Tx], t2n(got)[:, :Tx], np.array(ref)) <= 1e-4, iters


@pytest.mark.parametrize("n_fft,hop,la", [(512, 128, 4), (1024, 256, 0), (1024, 256, 4)])
def test_session_route_vs_generic_scan(n_fft, hop, la):
    """``scan_roundtrip`` / ``scan_invert`` in ``pghi_gl`` with
    ``backend="fused"`` (on the CPU the session's host loop over the
    recurrence's and the polish's plain versions) against the chunk scan with
    a generator in the same state; no launch is counted."""
    chunk = T_C * hop
    _, prt = rt_pair(n_fft, hop, la)
    chain = PT.OverlapAdd(n_fft, hop, device="cpu") + prt
    x = make_audio(31 + la, batch=2, n=3 * chunk + 300)[:, 0]
    xt = torch.as_tensor(x)
    d = n_fft - hop + la * hop
    PK.reset_launches()

    def pair(fn, ref):
        a = t2n(fn(torch.Generator().manual_seed(9), "fused"))
        b = t2n(fn(torch.Generator().manual_seed(9), "generic"))
        assert a.shape == b.shape and np.isfinite(a).all()
        s_a = spectral_convergence(a[:, d:], ref, n_fft, hop)
        s_b = spectral_convergence(b[:, d:], ref, n_fft, hop)
        assert s_a <= 1.1 * s_b + 1e-3, (s_a, s_b)
        return s_a

    assert pair(lambda g, b: PS.scan_roundtrip(chain, xt, chunk, "pghi_gl", generator=g, backend=b), x) < 0.5
    spec, _ = PS.scan_forward(chain, xt, chunk, backend="generic")
    mags = spec.abs()[:, :-3]
    y = t2n(PS.scan_invert(chain, mags, T_C, "pghi_gl", generator=torch.Generator().manual_seed(9),
                           backend="fused"))
    assert y.shape == (2, mags.shape[1] * hop) and np.isfinite(y).all()
    assert not any(PK.launches.values()) and not any(PK.routes.values())


def test_polish_plan_and_route_rule(monkeypatch):
    """The plan takes every power of two from 64 to 4096 at the sessions'
    grids (lookahead 0 and 4), with the grid in shared memory at the main
    shape, and the even 7-smooth n_fft on the smooth route (1200/300,
    768/192, 1000/200, 1344/336, 896/224); n_fft with another prime
    (1408/352) and a grid the plan refuses take ``iters`` two-launch
    projections, on the CPU their plain version, equal to the polish's bit
    for bit on the FFT route; the gate grows the plan; nothing is counted on
    the CPU."""
    for n in (64, 128, 256, 512, 1024, 2048, 4096):
        hop = n // 4
        for la in (0, 4):
            tp = 3 + 16 + la + 3
            plan = PK._polish_plan(n, hop, tp)
            assert plan is not None, (n, la)
            teams, resident = plan
            assert 1 <= teams <= fft_max_teams(n)
            assert PK._polish_smem_bytes(tp, hop, n, teams, resident) <= PK.MAX_SMEM
    assert PK._polish_plan(1024, 256, 22) == (4, True) and PK._polish_plan(1024, 256, 26) == (4, True)
    assert PK._polish_plan(4096, 1024, 10) == (1, False)           # the grid stays in device memory
    for n, hop in ((1200, 300), (768, 192), (1000, 200), (1344, 336), (896, 224)):
        assert not fft_covers(n) and PK._polish_plan(n, hop, 22) is not None
    for n, hop in ((1408, 352),):
        assert not fft_covers(n) and PK._polish_plan(n, hop, 22) is None
    assert PK._polish_plan(1000, 250, 22) is None                  # hop % 4 != 0
    assert PK._polish_plan(1024, 2, 22) is None and PK._polish_plan(1024, 256, 2) is None
    # the gate: the polish takes more than 40 polished frames where it holds the grid
    # (1200/300 too), the two-launch route's limits stay where it does not
    assert PK.kernel_covers("project", 512, 128, 41, 3) and PK.kernel_covers("project", 1408, 352, 40, 3)
    assert PK.kernel_covers("project", 1200, 300, 41, 3) and PK.kernel_covers("project", 1200, 300, 48, 3)
    assert not PK.kernel_covers("project", 1408, 352, 41, 3)
    with pytest.raises(NotImplementedError, match="K10-K17"):
        PK._require("project", 1408, 352, 48, 3)
    # the route rule on the CPU
    n_fft, hop, la = 512, 128, 0
    _, prt = rt_pair(n_fft, hop, la)
    mag, ph, _ = grid(n_fft, hop, la, 2, seed=3)
    m, p = torch.as_tensor(mag), torch.as_tensor(ph)
    lo, hi = prt.gl_frozen(T_C)
    args = (prt.inv_window, prt.window, n_fft, hop, prt.gl_context, lo, hi)
    PK.reset_launches()
    fft = PK.gl_polish(m, p.clone(), None, prt.inv_window, prt.window, None, None, *args[2:], ITERS)
    assert torch.equal(fft, PK.gl_polish_reference(m, p, *args, ITERS))
    monkeypatch.setattr(PK, "_polish_plan", lambda *a: None)
    two = PK.gl_polish(m, p.clone(), None, prt.inv_window, prt.window, None, None, *args[2:], ITERS)
    ref = p.clone()
    for _ in range(ITERS):
        ref = PK.gl_project_reference(m, ref, *args)
    assert torch.equal(two, ref) and torch.equal(two, fft)
    assert torch.equal(PK.gl_polish(m, p.clone(), None, prt.inv_window, prt.window, None, None, *args[2:], 0), p)
    assert not any(PK.launches.values()) and not any(PK.routes.values())
    assert "gl_polish" in PK.launches and {"gl_polish:fft", "gl_polish:smooth"} <= set(PK.routes)
