"""K's synthesis and O's polish on the smooth route: the mixed-radix
instances ``csrc/pghi.cu:pghi_synthesize_fft_kernel<true>`` and
``csrc/stream_step.cu:gl_polish_fft_kernel<., true>`` wherever
``frames_fft.fft_covers_smooth(n_fft)`` (even, ``2^a 3^b 5^c``, no power of
two) and the block fits, as their plain versions
(``pghi_kernel.pghi_synthesize_fused_reference`` on
``pghi_kernel.synth_route``, ``stream_step.gl_polish_reference`` with
``smooth=True``), which ``chip_smoke.py`` holds the kernels to on the card.

Tolerances, and why:

* K against the JAX package's Pallas synthesis in interpret mode at 768/256
  and 384/96, and at 1200/300 (a layout the JAX kernel refuses: its in-kernel
  overlap-add needs ``hop % 8 == 0`` with ``n_fft % 128 == 0``) against the
  JAX package's ``istft``, the route it takes there: 1e-4 max-abs over
  max-abs, as ``test_torch_pghi_synth_fft.py`` holds the FFT route;
* K against a float64 ``istft`` oracle: 1e-5 (float32 sums over 2.5 n log2 n
  terms), and no further from it than the product route on the same input;
* K whatever block the card cuts the clip into: bit for bit;
* O's polish against the JAX package's projections, once and ``iters``
  times: ``|X| (cos, sin)(phase)`` within 1e-4 of the largest ``|X|``, as
  ``test_torch_gl_polish_fft.py`` holds the FFT route; the pinned, frozen and
  zero rows bit for bit;
* O's session route against the port's generic scan: spectral convergence
  within ``1.1 s + 1e-3`` of the scan's (``bench.py:582, 664``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops.fft import istft as j_istft
from acids_transforms_tpu.ops.pallas import pghi_kernel as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops import windows as pwin
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PK
from acids_transforms_tpu_torch.ops.cuda import stream_step as SS
from test_torch_common import make_audio, rel, t2n, tones
from test_torch_gl_polish_fft import ITERS, T_C, grid, jax_project, rt_pair, unit_err
from test_torch_pghi_synth_fft import _dgt, _oracle
from test_torch_streaming import spectral_convergence

torch.set_num_threads(1)


# ------------------------------------------------------------ K's synthesis
@pytest.mark.parametrize("n_fft,hop", [(768, 256), (1200, 300), (384, 96)])
def test_smooth_plain_vs_jax_synthesis(n_fft, hop):
    assert PK.synth_route(n_fft, hop) == "smooth" and PK.pghi_fused_available(n_fft, hop)
    dgt, mag, ang, w, _ = _dgt(n_fft, hop, tones(6000, [(220, 440), (330,)]), seed=n_fft)
    got = PK.pghi_synthesize_fused(torch.as_tensor(mag), torch.as_tensor(ang), n_fft, hop, w)
    if JK.pghi_fused_available(n_fft, hop):
        ref = JK.pghi_synthesize_fused(jnp.asarray(mag), jnp.asarray(ang), n_fft, hop, dgt.inv_window,
                                       interpret=True)
    else:
        ref = j_istft(jnp.asarray(mag) * jnp.exp(1j * jnp.asarray(ang)), n_fft, hop, dgt.inv_window)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and rel(t2n(got), ref) <= 1e-4


@pytest.mark.parametrize("n_fft,hop", [(768, 192), (1200, 300)])
def test_smooth_plain_vs_float64_oracle_and_product(n_fft, hop, monkeypatch):
    """Unwrapped phases up to 1e4 rad, an odd frame count whose last pair
    group has no partners, silent frames and a silent clip: within 1e-5 of
    the float64 istft, no further from it than the product route, and the
    smooth route's schedule spelled out."""
    ov = n_fft // hop
    rng = np.random.default_rng(n_fft + hop)
    T = 2 * ov * 3 + ov - 1
    w = pwin.gaussian_dgt_window(n_fft, device="cpu")
    mag = torch.as_tensor(rng.random((3, T, n_fft // 2 + 1)).astype(np.float32))
    mag[0, 4:9] = 0.0
    mag[1] = 0.0
    ph = torch.as_tensor((1e4 * rng.random(mag.shape)).astype(np.float32))
    got = PK.pghi_synthesize_fused(mag, ph, n_fft, hop, w)
    ora = _oracle(mag, ph, n_fft, hop, w).numpy()
    assert got.shape == ora.shape and torch.isfinite(got).all() and not got[1].any()
    e_smooth = rel(got.double().numpy(), ora)
    assert e_smooth <= 1e-5
    y = FF.overlap_add_classes(FF.frames_irfft_reference(mag * torch.cos(ph), mag * torch.sin(ph),
                                                         FF.irfft_window(w, n_fft, smooth=True), stride=ov,
                                                         smooth=True), hop)
    assert torch.equal(got, PK._finish_audio(y, w, T, n_fft, hop, None, (3,)))
    monkeypatch.setattr(PK, "synth_route", lambda *a: "product")
    prod = PK.pghi_synthesize_fused_reference(mag, ph, n_fft, hop, w)
    assert not torch.equal(prod, got) and e_smooth <= rel(prod.double().numpy(), ora)


def test_smooth_schedule_does_not_depend_on_the_block():
    """The kernel's blocks emulated at 1200/300: a block owns ``rows`` output
    chunks from ``c0`` and synthesizes the frames ``c0 - 2 overlap .. c0 +
    rows - 1`` with the clip's pairs, adding the frames in class order; bit
    for bit the whole-clip plain version at the plan's height and another."""
    n_fft, hop = 1200, 300
    ov = n_fft // hop
    rng = np.random.default_rng(11)
    T = 37
    mag = torch.as_tensor(rng.random((2, T, n_fft // 2 + 1)).astype(np.float32))
    ph = torch.as_tensor((300 * rng.random(mag.shape)).astype(np.float32))
    w = pwin.gaussian_dgt_window(n_fft, device="cpu")
    wsyn = FF.irfft_window(w, n_fft, smooth=True)
    re, im = mag * torch.cos(ph), mag * torch.sin(ph)
    whole = FF.overlap_add_classes(FF.frames_irfft_reference(re, im, wsyn, stride=ov, smooth=True), hop)
    n_chunks = T + ov - 1
    for rows in (PK._synth_fft_plan(n_fft, hop)[0], 2 * ov):
        y = torch.zeros((2, n_chunks * hop))
        for c0 in range(0, n_chunks, rows):
            f0 = c0 - 2 * ov
            idx = torch.arange(f0, min(c0 + rows, T))
            keep = idx >= 0
            lre = torch.where(keep[:, None], re[:, idx.clamp_min(0)], 0.0)
            lim = torch.where(keep[:, None], im[:, idx.clamp_min(0)], 0.0)
            frames = FF.frames_irfft_reference(lre, lim, wsyn, stride=ov, smooth=True)
            samples = torch.zeros((2, rows * hop))
            for c in range(ov):
                for r in range(c, frames.shape[1], ov):
                    f = f0 + r
                    if f < 0:
                        continue
                    lo = (f - c0) * hop
                    a, b = max(lo, 0), min(lo + n_fft, rows * hop)
                    if a < b:
                        samples[:, a:b] = samples[:, a:b] + frames[:, r, a - lo: b - lo]
            n_out = min(rows, n_chunks - c0) * hop
            y[:, c0 * hop: c0 * hop + n_out] = samples[:, :n_out]
        assert torch.equal(y, whole), rows


# -------------------------------------------------------------- O's polish
@pytest.mark.parametrize("la", [0, 4])
@pytest.mark.parametrize("n_fft,hop", [(1200, 300), (768, 192), (400, 100)])
def test_smooth_polish_vs_jax_projections(n_fft, hop, la):
    """``gl_polish_reference`` on the smooth route against the JAX package's
    projection, once and ``iters`` times, on 2 sessions; the rows the polish
    leaves alone keep their bits; the CPU wrapper runs the plain version."""
    jrt, prt = rt_pair(n_fft, hop, la)
    mag, ph, Tx = grid(n_fft, hop, la, 2, seed=5 * n_fft + la)
    assert SS._polish_plan(n_fft, hop, mag.shape[1]) is not None and SS.session_route(n_fft, "polish") == "smooth"
    ctx = prt.gl_context
    lo, hi = prt.gl_frozen(T_C)
    m, p = torch.as_tensor(mag), torch.as_tensor(ph)
    ref = jnp.asarray(ph[:, :Tx])
    project = jax.jit(lambda mm, pp: jax_project(jrt, mm, pp, T_C, n_fft, hop))
    for iters in range(1, ITERS + 1):
        ref = project(jnp.asarray(mag[:, :Tx]), ref)
        if iters in (1, ITERS):
            got = SS.gl_polish_reference(m, p, prt.inv_window, prt.window, n_fft, hop, ctx, lo, hi, iters)
            assert unit_err(mag[:, :Tx], t2n(got)[:, :Tx], np.array(ref)) <= 1e-4, iters
    g = t2n(got)
    assert np.array_equal(g[:, :ctx], ph[:, :ctx]) and np.array_equal(g[:, lo:hi], ph[:, lo:hi])
    assert np.array_equal(g[:, Tx:], ph[:, Tx:])
    wrapped = SS.gl_polish(m, p.clone(), None, prt.inv_window, prt.window, None, None, n_fft, hop, ctx, lo, hi,
                           ITERS)
    assert torch.equal(wrapped, got)


def test_smooth_polish_session_vs_generic_scan():
    """``scan_roundtrip`` in ``pghi_gl`` at 1200/300 with ``backend="fused"``
    (on the CPU the host loop over the seeded recurrence's and the smooth
    polish's plain versions) against the chunk scan with a generator in the
    same state; no launch is counted."""
    n_fft, hop, la = 1200, 300, 0
    chunk = T_C * hop
    _, prt = rt_pair(n_fft, hop, la)
    chain = PT.OverlapAdd(n_fft, hop, device="cpu") + prt
    x = make_audio(41, batch=2, n=3 * chunk + 300)[:, 0]
    xt = torch.as_tensor(x)
    d = n_fft - hop
    SS.reset_launches()
    a = t2n(PS.scan_roundtrip(chain, xt, chunk, "pghi_gl", generator=torch.Generator().manual_seed(9),
                              backend="fused"))
    b = t2n(PS.scan_roundtrip(chain, xt, chunk, "pghi_gl", generator=torch.Generator().manual_seed(9),
                              backend="generic"))
    assert a.shape == b.shape and np.isfinite(a).all()
    s_a = spectral_convergence(a[:, d:], x, n_fft, hop)
    s_b = spectral_convergence(b[:, d:], x, n_fft, hop)
    assert s_a <= 1.1 * s_b + 1e-3 and s_a < 0.5, (s_a, s_b)
    assert not any(SS.launches.values()) and not any(SS.routes.values())


# -------------------------------------------------------- rules and plans
def test_route_rules_and_plans():
    """Smooth at 768, 1200 and 1000; at 896 and 1344 K and O's polish on
    their radix-7 instances; K's product at 1408; the
    FFT route at 1024.  Every plan of either kernel at an even 5-smooth n_fft
    fits shared memory, and K's route is smooth at every such shape its gate
    takes."""
    for n, hop in ((768, 256), (768, 192), (1200, 300), (1000, 250)):
        assert PK.synth_route(n, hop) == "smooth" and SS.session_route(n, "polish") == "smooth"
    for n, hop in ((768, 192), (1200, 300), (1000, 200)):
        assert SS._polish_plan(n, hop, 3 + T_C + n // hop - 1) is not None
    assert PK.synth_route(1408, 352) == "product" and PK._synth_fft_plan(1408, 352) is None
    for n, hop in ((896, 224), (1344, 336)):
        assert PK.synth_route(n, hop) == "smooth" and PK._synth_fft_plan(n, hop) is not None
        assert SS._polish_plan(n, hop, 3 + T_C + n // hop - 1) is not None
        assert SS.kernel_covers("project", n, hop, T_C, 3)
    assert PK.synth_route(1024, 256) == "fft" and SS._polish_plan(1024, 256, 22) == (4, True)
    # the polish holds 1200/300's 14-frame grid with two FFTs side by side
    assert SS._polish_plan(1200, 300, 14) == (2, True)
    assert SS._polish_smem_bytes(14, 300, 1200, 2, True) <= FF.MAX_SMEM
    for n in range(64, FF.FFT_MAX + 1, 2):
        if not FF.fft_covers_smooth(n):
            continue
        for ov in (2, 3, 4, 5, 6, 8):
            if n % ov or (n // ov) % 4:
                continue
            hop = n // ov
            if PK.pghi_fused_available(n, hop):
                assert PK.synth_route(n, hop) == "smooth", (n, hop)
                rows, teams = PK._synth_fft_plan(n, hop)
                assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
                assert PK._synth_fft_smem_bytes(rows, hop, n, teams) <= FF.MAX_SMEM
            for tc in (4, 8, 16):
                tp = 3 + tc + ov - 1
                plan = SS._polish_plan(n, hop, tp)
                if plan is not None:
                    teams, resident = plan
                    assert 1 <= teams <= FF.fft_smooth_max_teams(n)
                    assert SS._polish_smem_bytes(tp, hop, n, teams, resident) <= FF.MAX_SMEM
                else:
                    assert SS.kernel_covers("project", n, hop, tc, 3), (n, hop, tc)


def test_nothing_counted_on_the_cpu():
    PK.reset_launches()
    SS.reset_launches()
    w = pwin.gaussian_dgt_window(768, device="cpu")
    mag = torch.rand(2, 12, 385)
    PK.pghi_synthesize_fused(mag, torch.rand(2, 12, 385), 768, 192, w)
    PK.pghi_invert_fused(mag, pwin.dgt_gamma(768), 768, 192, w)
    _, prt = rt_pair(1200, 300, 0)
    gm, gp, _ = grid(1200, 300, 0, 1, seed=2)
    lo, hi = prt.gl_frozen(T_C)
    SS.gl_polish(torch.as_tensor(gm), torch.as_tensor(gp), None, prt.inv_window, prt.window, None, None, 1200,
                 300, prt.gl_context, lo, hi, 2)
    assert "pghi_synthesize:smooth" in PK.routes and "gl_polish:smooth" in SS.routes
    assert not any(PK.routes.values()) and not any(PK.launches.values())
    assert not any(SS.routes.values()) and not any(SS.launches.values())
